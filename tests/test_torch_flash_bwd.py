"""What rounding P and dS costs in the flash-attention backward, on the CPU.

The bf16/f16 backward kernels of ray_tpu_torch run their second products on
the tensor cores, so they round P and dS to the input dtype first; the plain
versions with ``round_ps=True`` repeat that rounding, and chip_smoke.py holds
the kernels to them tightly on the card. Here the rounded plain versions, on
bf16/f16 inputs made with numpy from a seed, are held to the reference's
Pallas ``flash_bwd_dq`` / ``flash_bwd_dkv`` (interpret mode) on f32 copies of
the same values with the same lse and delta, at the tolerance chip_smoke.py
uses against the f32 plain version: the element-wise bound of that rounding
(``flash_bwd_rounding_bound``) plus one ulp of the dtype and 1e-4 of the
largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
# one ulp of a value in [1, 2)
_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
# (bh, sq, sk, d, causal); 16-row JAX blocks make the Pallas side run several
# tiles and ragged last tiles
_CASES = {
    "causal": (2, 48, 48, 32, True),
    "non_causal": (2, 48, 48, 64, False),
    "sq_lt_sk_top_left": (2, 24, 56, 32, True),
    "sq_gt_sk_top_left": (2, 56, 24, 64, True),
    "ragged": (2, 41, 41, 64, True),
    "d128": (1, 32, 32, 128, True),
}


def _inputs(bh, sq, sk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((bh, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((bh, sk, d)).astype(np.float32) for _ in range(2))
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]


def _jax_bwd(q, k, v, do, sm_scale, causal):
    """The reference's forward and backward Pallas kernels on f32 copies of
    the values of q, k, v, do: (dq, dk, dv) as tensors and lse, delta."""
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    kw = dict(sm_scale=sm_scale, causal=causal, block_q=16, block_k=16)
    jo, jlse = jfa._flash_forward(jq, jk, jv, sm_scale, causal, 16, 16)
    jdelta = jfa.attention_delta(jdo, jo)
    jdq = jfa.flash_bwd_dq(jq, jk, jv, jdo, jlse, jdelta, **kw)
    jdk, jdv = jfa.flash_bwd_dkv(jq, jk, jv, jdo, jlse, jdelta, **kw)
    grads = [torch.from_numpy(np.array(g)) for g in (jdq, jdk, jdv)]
    lse, delta = (torch.from_numpy(np.array(a)[..., 0]) for a in (jlse, jdelta))
    return grads, lse, delta


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("case", list(_CASES))
def test_rounded_plain_bwd_within_rounding_bound_of_jax(case, dtype):
    bh, sq, sk, d, causal = _CASES[case]
    td = _DTYPES[dtype]
    q, k, v, do = _inputs(bh, sq, sk, d, td, seed=11)
    kw = dict(sm_scale=d ** -0.5, causal=causal)
    jgrads, lse, delta = _jax_bwd(q, k, v, do, **kw)
    args = (q, k, v, do, lse, delta)
    rounded = [tfa.flash_bwd_dq_reference(*args, **kw, round_ps=True),
               *tfa.flash_bwd_dkv_reference(*args, **kw, round_ps=True)]
    plain = [tfa.flash_bwd_dq_reference(*args, **kw),
             *tfa.flash_bwd_dkv_reference(*args, **kw)]
    *bounds, _ = tfa.flash_bwd_rounding_bound(*args, **kw)
    changed = 0
    for out, unrounded, ref, bound in zip(rounded, plain, jgrads, bounds):
        assert out.dtype == td and out.shape == ref.shape
        # the bound of rounding P and dS to the dtype, plus f32 summation
        # order (1e-4 of the largest value) and the output's own rounding
        # (one ulp of the dtype at the largest value)
        tol = ref.abs().max().item() * (_ULP[td] + 1e-4)
        assert bool(((out.float() - ref).abs() <= bound + tol).all())
        changed += int((out != unrounded).sum())
    assert changed > 0  # the rounding shows in the outputs: the check is not vacuous


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_round_ps_is_identity_for_f32(causal):
    q, k, v, do = _inputs(2, 40, 56, 32, torch.float32, seed=12)
    kw = dict(sm_scale=32 ** -0.5, causal=causal)
    o, lse = tfa.flash_attention_reference(q, k, v, **kw)
    args = (q, k, v, do, lse, tfa.attention_delta(do, o))
    assert torch.equal(tfa.flash_bwd_dq_reference(*args, **kw, round_ps=True),
                       tfa.flash_bwd_dq_reference(*args, **kw))
    for a, b in zip(tfa.flash_bwd_dkv_reference(*args, **kw, round_ps=True),
                    tfa.flash_bwd_dkv_reference(*args, **kw)):
        assert torch.equal(a, b)
    *bounds, n_sub = tfa.flash_bwd_rounding_bound(*args, **kw)
    assert n_sub == 0 and all(not b.any() for b in bounds)
