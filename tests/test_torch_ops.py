"""ray_tpu_torch.ops against ray_tpu.ops on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs as its own tests run it: Pallas in interpret mode off-TPU. The
port's wrappers take their plain PyTorch versions here because the tensors
lie on the CPU; the CUDA kernels are held against those plain versions on
the card by chip_smoke.py.
"""

import jax
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


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_rmsnorm_grads_match_jax(dtype, tol):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((3, 5, 64)).astype(np.float32)
    (jx, tx), (jw, tw), (jg, tg) = (_pair(a, dtype) for a in (x, w, g))
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm(a, b, 1e-5), jx, jw)
    jdx, jdw = vjp(jg)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    rmsnorm(tx, tw, 1e-5).backward(tg)
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype
    # f32: the same formula, sums in another order; bf16: both compute in
    # f32 and round once, so one bf16 ulp of dx (|dx| < 4) and of dw,
    # relative to dw's largest value (a sum over 15 rows)
    assert np.abs(_np(tx.grad) - _np(jdx)).max() < tol
    assert np.abs(_np(tw.grad) - _np(jdw)).max() < tol * max(1.0, np.abs(_np(jdw)).max())


def _jax_blocks(blocks):
    if blocks is None:
        return {}
    bq, bk = (blocks, blocks) if isinstance(blocks, int) else blocks
    return dict(block_q=bq, block_k=bk)


# (b, h, hk, sq, sk, d, causal, jax block sizes); 16-row JAX blocks make the
# Pallas side run several tiles and ragged last tiles
_GRAD_CASES = {
    "causal": (2, 2, 2, 48, 48, 32, True, 16),
    "non_causal": (2, 2, 2, 48, 48, 32, False, 16),
    "gqa": (1, 4, 2, 32, 32, 32, True, 16),
    "sq_lt_sk_top_left": (1, 2, 2, 24, 56, 32, True, 16),
    "sq_gt_sk_top_left": (1, 2, 2, 56, 24, 32, True, 16),
    "ragged": (1, 2, 2, 41, 41, 64, True, 16),
}


@pytest.mark.parametrize("case", list(_GRAD_CASES))
def test_flash_attention_grads_match_jax(case):
    b, h, hk, sq, sk, d, causal, blocks = _GRAD_CASES[case]
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)

    def jax_o(jq, jk, jv):
        return jfa.flash_attention_with_lse(jq, jk, jv, causal=causal, **_jax_blocks(blocks))[0]

    _, vjp = jax.vjp(jax_o, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    launches = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    tfa.flash_attention(tq, tk, tv, causal=causal).backward(torch.from_numpy(do))
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == launches  # CPU: plain
    for t, j in zip((tq, tk, tv), jgrads):
        assert t.grad.shape == t.shape
        # f32: the same blockwise recompute from lse in another summation
        # order; GQA sums dK/dV over the repeated heads on both sides
        assert np.abs(_np(t.grad) - _np(j)).max() < 1e-4


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_flash_bwd_plain_matches_jax_kernels(causal):
    """The plain flash_bwd_dq / flash_bwd_dkv against the reference's Pallas
    functions of the same names, given identical lse and delta."""
    bh, sq, sk, d = 3, 40, 40, 32
    rng = np.random.default_rng(9)
    q, do = (rng.standard_normal((bh, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((bh, sk, d)).astype(np.float32) for _ in range(2))
    kw = dict(sm_scale=d ** -0.5, causal=causal)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jlse = jfa._flash_forward(jq, jk, jv, kw["sm_scale"], causal, 16, 16)
    jdelta = jfa.attention_delta(jdo, jo)
    jdq = jfa.flash_bwd_dq(jq, jk, jv, jdo, jlse, jdelta, block_q=16, block_k=16, **kw)
    jdk, jdv = jfa.flash_bwd_dkv(jq, jk, jv, jdo, jlse, jdelta, block_q=16, block_k=16, **kw)
    lse = torch.from_numpy(np.array(jlse)[..., 0])
    delta = tfa.attention_delta(torch.from_numpy(do), torch.from_numpy(np.array(jo)))
    # delta: the same f32 row sums
    assert np.abs(delta.numpy() - np.asarray(jdelta)[..., 0]).max() < 1e-5
    args = [torch.from_numpy(a) for a in (q, k, v, do)] + [lse, delta]
    dq = tfa.flash_bwd_dq(*args, **kw)
    dk, dv = tfa.flash_bwd_dkv(*args, **kw)
    # f32: the same P, dP and dS, summed whole here and per 16-block there
    for t, j in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert t.dtype == torch.float32
        assert np.abs(_np(t) - _np(j)).max() < 1e-5


def test_lse_only_loss_gives_zero_grads():
    """Both packages drop the lse cotangent (the reference's ``do, _ = g``)."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal((1, 2, 24, 32)).astype(np.float32) for _ in range(3))
    jgrads = jax.grad(
        lambda a, b, c: jfa.flash_attention_with_lse(a, b, c, block_q=16, block_k=16)[1].sum(),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tfa.flash_attention_with_lse(tq, tk, tv)[1].sum().backward()
    for t, j in zip((tq, tk, tv), jgrads):
        assert not np.asarray(j).any()
        assert not t.grad.any()


def test_flash_core_gets_contiguous_rows_at_batch_one(monkeypatch):
    """A (1, s, h, d) projection transposed to (1, h, s, d) reshapes to a
    strided view; the kernels need contiguous rows, so the wrapper copies."""
    seen = []
    real = tfa.flash_attention_fwd

    def spy(q, k, v, **kw):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tfa, "flash_attention_fwd", spy)
    x = torch.randn(1, 16, 2, 32).transpose(1, 2)
    assert not x.reshape(2, 16, 32).is_contiguous()
    tfa.flash_attention(x, x, x)
    assert seen == [True]
