"""ray_tpu_torch.ops against ray_tpu.ops on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs as its own tests run it: Pallas in interpret mode off-TPU. The
port's wrappers take their plain PyTorch versions here because the tensors
lie on the CPU; the CUDA kernels are held against those plain versions on
the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu.ops.rmsnorm import rmsnorm as jax_rmsnorm
from ray_tpu.ops.rope import apply_rope as jax_apply_rope
from ray_tpu.ops.rope import rope_table as jax_rope_table
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_fwd
from ray_tpu_torch.ops.rope import apply_rope, rope_table

_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same f32 numpy values as a JAX array and a torch tensor of one
    dtype; both round f32 -> bf16 to nearest even, so the values agree."""
    jd, td = _DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_rmsnorm_matches_jax(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    before = rmsnorm_fwd.launches
    out = rmsnorm(tx, tw, 1e-5)
    ref = jax_rmsnorm(jx, jw, 1e-5)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    # f32: same arithmetic, sums in another order; bf16: one output ulp
    assert np.abs(_np(out) - _np(ref)).max() < tol
    assert rmsnorm_fwd.launches == before  # a CPU tensor never launches


def test_rope_table_matches_jax():
    cos, sin = rope_table(64, 32, 10000.0)
    jcos, jsin = jax_rope_table(64, 32, 10000.0)
    assert cos.dtype == torch.float32 and cos.shape == (64, 16)
    # f32 cos/sin of the same angles, up to an ulp of the libraries' math
    assert np.abs(cos.numpy() - np.asarray(jcos)).max() < 1e-5
    assert np.abs(sin.numpy() - np.asarray(jsin)).max() < 1e-5


@pytest.mark.parametrize(
    "offset", [0, 5, np.array([0, 3, 9], np.int32)], ids=["zero", "scalar", "per_row"]
)
def test_apply_rope_matches_jax(offset):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 6, 32)).astype(np.float32)
    cos, sin = rope_table(32, 32)
    jcos, jsin = jax_rope_table(32, 32)
    toff = torch.from_numpy(offset) if isinstance(offset, np.ndarray) else offset
    joff = jnp.asarray(offset) if isinstance(offset, np.ndarray) else offset
    out = apply_rope(torch.from_numpy(x), cos, sin, offset=toff)
    ref = jax_apply_rope(jnp.asarray(x), jcos, jsin, offset=joff)
    # f32 elementwise rotation of the same values
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 1e-5


def test_apply_rope_rotates_halves():
    """Position 1 of a unit vector on dim 0 moves to (cos, ..., sin at d/2):
    the halves rotate together, not interleaved pairs."""
    cos, sin = rope_table(4, 8)
    x = torch.zeros(1, 1, 2, 8)
    x[..., 0] = 1.0
    out = apply_rope(x, cos, sin)[0, 0, 1]
    assert torch.allclose(out[0], cos[1, 0]) and torch.allclose(out[4], sin[1, 0])
    assert out[1] == 0.0


# (b, h, hk, sq, sk, d, causal, dtype, jax block size or None)
_FLASH_CASES = {
    "causal": (2, 4, 4, 64, 64, 32, True, "f32", None),
    "non_causal": (2, 4, 4, 64, 64, 32, False, "f32", None),
    "gqa": (1, 4, 2, 48, 48, 64, True, "f32", None),
    "sq_lt_sk_top_left": (1, 2, 2, 32, 80, 32, True, "f32", None),
    "ragged": (1, 2, 2, 50, 50, 32, True, "f32", 16),
    # with 16-row q blocks and 8-key k blocks, the first 8 rows of every
    # q block see no key of the block after theirs: rows fully masked
    # inside a tile, which the online softmax must carry through
    "masked_rows_in_tile": (1, 2, 2, 32, 32, 32, True, "f32", (16, 8)),
    "bf16": (2, 4, 4, 64, 64, 128, True, "bf16", None),
}


@pytest.mark.parametrize("case", list(_FLASH_CASES))
def test_flash_attention_with_lse_matches_jax(case):
    b, h, hk, sq, sk, d, causal, dtype, blocks = _FLASH_CASES[case]
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    kw = {}
    if blocks is not None:
        bq, bk = (blocks, blocks) if isinstance(blocks, int) else blocks
        kw = dict(block_q=bq, block_k=bk)
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    jo, jlse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal, **kw)
    assert o.shape == (b, h, sq, d) and o.dtype == tq.dtype
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    # f32: the same online softmax in another summation order; bf16: the
    # output is rounded to bf16, so one ulp of values below 4
    o_tol, lse_tol = (2e-5, 2e-5) if dtype == "f32" else (2e-2, 1e-4)
    assert np.abs(_np(o) - _np(jo)).max() < o_tol
    assert np.abs(lse.numpy() - np.asarray(jlse)).max() < lse_tol
    if sq != sk and causal:
        # top-left alignment is not reference_attention's bottom-right one
        ref = tfa.reference_attention(tq, tk, tv, causal=True)
        assert np.abs(_np(o) - _np(ref)).max() > 0.1


def test_flash_fully_masked_row_gives_zero_and_neg_lse():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
               for _ in range(3))
    valid = torch.ones(4, 4, dtype=torch.bool)
    valid[2] = False
    o, lse = tfa._masked_attention(q, k, v, valid, 0.25)
    assert torch.all(o[0, 2] == 0.0)
    assert lse[0, 2].item() == pytest.approx(-1e30)
    assert torch.isfinite(o).all()


def test_reference_attention_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 2, 16, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 24, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 24, 32)).astype(np.float32)
    out = tfa.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    ref = jfa.reference_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    # plain f32 softmax attention on both sides
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 1e-5


def test_backward_raises_until_training_slice():
    x = torch.randn(2, 8, 32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention(x[None], x[None], x[None]).sum().backward()
    with pytest.raises(NotImplementedError, match="training slice"):
        rmsnorm(x, torch.ones(32), 1e-5).sum().backward()
