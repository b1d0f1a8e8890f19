"""What rounding P costs in the flash-attention forward, on the CPU.

The bf16/f16 forward kernel of ray_tpu_torch runs O += P V on the tensor
cores, so it rounds each 64-key tile's P to the input dtype first; the plain
version with ``round_p=True`` repeats that rounding in the kernel's order of
tiles, and chip_smoke.py holds the kernel to it tightly on the card. Here the
rounded plain version, on bf16/f16 inputs made with numpy from a seed, is
held to the reference's Pallas ``_flash_forward`` (interpret mode, 16-row
blocks) on f32 copies of the same values, at the tolerance chip_smoke.py uses
against the f32 plain version, element by element: the bound of that
rounding (``flash_fwd_rounding_bound``) plus the kernel's tight tolerance
against ``round_p=True`` (``flash_fwd_round_p_tolerance``); lse within 1e-4.
The tight tolerance itself is held to a P that moves by less than its
``rel`` before the rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
# (bh, sq, sk, d, causal); 16-row JAX blocks make the Pallas side run several
# tiles and ragged last tiles; 150 keys make the port's 64-key tiles rescale
# acc across three tiles, the last one ragged
_CASES = {
    "causal": (2, 48, 48, 32, True),
    "non_causal": (2, 48, 48, 64, False),
    "sq_lt_sk_top_left": (2, 24, 56, 32, True),
    "sq_gt_sk_top_left": (2, 56, 24, 64, True),
    "ragged": (2, 41, 41, 64, True),
    "d128": (1, 32, 32, 128, True),
    # ViT-B/16's encoder call: 196 patches + CLS, head_dim 64, bidirectional;
    # ragged last tiles on both sides (197 = 3 x 64 + 5)
    "vit": (1, 197, 197, 64, False),
    "three_key_tiles": (1, 24, 150, 32, False),
}


def _inputs(bh, sq, sk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((bh, sk, d)).astype(np.float32) for _ in range(2))
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v)]


def _jax_fwd(q, k, v, sm_scale, causal):
    """The reference's Pallas forward on f32 copies of the values of q, k, v:
    o and lse (bh, sq) as tensors."""
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    jo, jlse = jfa._flash_forward(jq, jk, jv, sm_scale, causal, 16, 16)
    return torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse)[..., 0])


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("case", list(_CASES))
def test_rounded_plain_fwd_within_rounding_bound_of_jax(case, dtype):
    bh, sq, sk, d, causal = _CASES[case]
    td = _DTYPES[dtype]
    q, k, v = _inputs(bh, sq, sk, d, td, seed=21)
    kw = dict(sm_scale=d ** -0.5, causal=causal)
    jo, jlse = _jax_fwd(q, k, v, **kw)
    o, lse = tfa.flash_attention_reference(q, k, v, **kw, round_p=True)
    unrounded, _ = tfa.flash_attention_reference(q, k, v, **kw)
    bound = tfa.flash_fwd_rounding_bound(q, k, v, **kw)
    assert o.dtype == td and o.shape == jo.shape and lse.shape == jlse.shape
    # the bound of rounding P to the dtype, plus f32 summation order and the
    # output's own rounding, element by element
    tol = tfa.flash_fwd_round_p_tolerance(q, k, v, **kw)
    assert bool(((o.float() - jo).abs() <= bound + tol).all())
    assert bool(bound.max() > 0)
    # lse is f32 on both sides and P's rounding does not reach it
    assert (lse - jlse).abs().max().item() < 1e-4
    # the rounding shows in the outputs: the check is not vacuous
    assert int((o != unrounded).sum()) > 0


@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_round_p_tolerance_covers_a_p_moved_within_rel(dtype):
    """Scores scaled by 1 + 1e-6 move P by less than the tolerance's ``rel``
    (2^-14) before the rounding, as the kernel's own f32 P may: round_p=True
    on them stays within the tolerance of round_p=True on the exact scale,
    though some P round to the other side."""
    bh, sq, sk, d, causal = _CASES["three_key_tiles"]
    q, k, v = _inputs(bh, sq, sk, d, _DTYPES[dtype], seed=23)
    scale = d ** -0.5
    o, _ = tfa.flash_attention_reference(q, k, v, sm_scale=scale, causal=causal, round_p=True)
    moved, _ = tfa.flash_attention_reference(
        q, k, v, sm_scale=scale * (1 + 1e-6), causal=causal, round_p=True
    )
    tol = tfa.flash_fwd_round_p_tolerance(q, k, v, sm_scale=scale, causal=causal)
    diff = (moved.float() - o.float()).abs()
    assert bool((diff <= tol).all())
    assert bool(diff.max() > 0)
    # tight: the typical tolerance is within 2% of a typical |o| (a step of
    # the dtype at |o| is 0.8% in bf16, 0.1% in f16)
    assert tol.median().item() <= 0.02 * o.float().abs().median().item()
    with pytest.raises(ValueError):
        tfa.flash_fwd_round_p_tolerance(q.float(), k.float(), v.float(), sm_scale=scale,
                                        causal=causal)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_round_p_is_identity_for_f32(causal):
    q, k, v = _inputs(2, 40, 150, 32, torch.float32, seed=22)
    kw = dict(sm_scale=32 ** -0.5, causal=causal)
    for a, b in zip(tfa.flash_attention_reference(q, k, v, **kw, round_p=True),
                    tfa.flash_attention_reference(q, k, v, **kw)):
        assert torch.equal(a, b)
    assert not tfa.flash_fwd_rounding_bound(q, k, v, **kw).any()
