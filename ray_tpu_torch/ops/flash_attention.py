"""Flash attention: the port of ray_tpu/ops/flash_attention.py.

Kernels (CUDA C++, sm_90a), one per Pallas TPU kernel of the reference:

- ``csrc/flash_attention.cu`` replaces ``_fwd_kernel`` (launched there by
  ``_flash_forward``): o and the per-row log-sum-exp;
- ``csrc/flash_attention_bwd.cu`` replaces ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel`` (launched by ``flash_bwd_dq`` and ``flash_bwd_dkv``):
  dQ, and dK with dV, recomputed blockwise from the saved lse.

Bytes bound the forward at the serving shapes; operations bound the backward
at the training shapes. The first versions run their products on f32 FMAs
(see the sources for the designs).

:func:`flash_attention_fwd`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`
are the wrappers over (batch*heads, seq, d): a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain PyTorch version of the same
function (:func:`flash_attention_reference`, :func:`flash_bwd_dq_reference`,
:func:`flash_bwd_dkv_reference`). Each wrapper's ``.launches`` counts its
kernel launches. ``lse`` and ``delta`` are (batch*heads, sq) f32; the
reference's trailing axis of 1 is a TPU layout.

Semantics follow the TPU kernels, not ``reference_attention``: causal
masking is TOP-LEFT aligned (``q_pos >= k_pos``), so with sq != sk it
differs from ``reference_attention``'s bottom-right ``tril(k=sk-sq)``.
Every row of a call sees key 0, so no row of the public API is fully
masked; the guard for one (``o = 0``, ``lse = -1e30``) is kept all the same.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .._internal import kernels

_NEG_INF = -1e30
_LIB = "flash_attention"
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
_BWD_LIB = "flash_attention_bwd"
_BWD_DQ_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
_BWD_DKV_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
_HEAD_DIMS = (32, 64, 128)
_BLOCK_Q = 64  # q rows (and keys) per CUDA tile, as in csrc/flash_attention*.cu


def _masked_attention(q, k, v, valid, sm_scale):
    """Softmax attention of (bh, sq, d) q over (bh, sk, d) k, v where
    ``valid`` (sq, sk) marks the visible keys; f32 throughout. A row with
    no visible key gives o = 0 and lse = -1e30 + log(1)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: o (bh, sq, d) in q's dtype and
    lse (bh, sq) in f32, top-left causal."""
    sq, sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    valid = q_pos >= k_pos if causal else torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    return _masked_attention(q, k, v, valid, sm_scale)


def _check_qkv(q, k, v):
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
            "need q (bh, sq, d) and k, v (bh, sk, d)"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share one dtype and one device")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if max(-(-sq // _BLOCK_Q), -(-sk // _BLOCK_Q)) > 65535:
        raise ValueError(f"sq={sq}, sk={sk} exceed the kernels' grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_layout(name, t)
    return bh, sq, sk, d


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return q.device.type


def _flash_cuda(q, k, v, sm_scale, causal):
    bh, sq, sk, d = _check_qkv(q, k, v)
    if sk == 0:
        raise ValueError("flash attention needs at least one key")
    code = kernels.dtype_code(q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh == 0 or sq == 0:
        return o, lse
    fn = kernels.function(_LIB, "rt_flash_attention_fwd", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, sq, sk, d, sm_scale, int(causal), code, kernels.stream_ptr(q.device),
    )
    kernels.check(_LIB, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward over q (bh, sq, d), k and v (bh, sk, d): o and lse (bh, sq)."""
    if _device_of(q) == "cpu":
        return flash_attention_reference(q, k, v, sm_scale=sm_scale, causal=causal)
    return _flash_cuda(q, k, v, sm_scale, causal)


flash_attention_fwd.launches = 0


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O): (bh, sq) f32, plain PyTorch as in the
    reference (plain XLA there)."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_probs_and_ds(q, k, v, do, lse, delta, sm_scale, causal):
    """P = exp(S - lse) with masked scores at -1e30 (not -inf: a row whose
    lse is -1e30 would give NaN), and dS = P (dP - delta) scale; f32."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, _NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, sm_scale: float, causal: bool):
    """Plain version of the dQ kernel: dQ = dS K, in q's dtype."""
    _, ds = _bwd_probs_and_ds(q, k, v, do, lse, delta, sm_scale, causal)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, sm_scale: float, causal: bool):
    """Plain version of the dK/dV kernel: dK = dS^T Q and dV = P^T dO, in
    k's and v's dtype."""
    p, ds = _bwd_probs_and_ds(q, k, v, do, lse, delta, sm_scale, causal)
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, do, lse, delta):
    bh, sq, sk, d = _check_qkv(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: got {tuple(do.shape)} {do.dtype} on {do.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (bh, sq) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(
                f"{name} must be ({bh}, {sq}) float32 on {q.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    kernels.check_layout("do", do)
    return bh, sq, sk, d


def flash_bwd_dq(q, k, v, do, lse, delta, *, sm_scale: float, causal: bool) -> torch.Tensor:
    """dQ (bh, sq, d) in q's dtype from q, do (bh, sq, d), k, v (bh, sk, d)
    and the forward's lse and :func:`attention_delta` (bh, sq) f32. Ring
    attention reuses it per ring step."""
    if _device_of(q) == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, sm_scale=sm_scale, causal=causal)
    bh, sq, sk, d = _check_bwd(q, k, v, do, lse, delta)
    code = kernels.dtype_code(q.dtype)
    if bh == 0 or sq == 0 or sk == 0:
        return torch.zeros_like(q)
    dq = torch.empty_like(q)
    fn = kernels.function(_BWD_LIB, "rt_flash_bwd_dq", _BWD_DQ_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), bh, sq, sk, d, sm_scale, int(causal), code,
        kernels.stream_ptr(q.device),
    )
    kernels.check(_BWD_LIB, err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(
    q, k, v, do, lse, delta, *, sm_scale: float, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV (bh, sk, d) in k's dtype; arguments as :func:`flash_bwd_dq`.
    Ring attention reuses it per ring step."""
    if _device_of(q) == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, sm_scale=sm_scale, causal=causal)
    bh, sq, sk, d = _check_bwd(q, k, v, do, lse, delta)
    code = kernels.dtype_code(q.dtype)
    if bh == 0 or sq == 0 or sk == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = kernels.function(_BWD_LIB, "rt_flash_bwd_dkv", _BWD_DKV_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d, sm_scale,
        int(causal), code, kernels.stream_ptr(q.device),
    )
    kernels.check(_BWD_LIB, err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class _FlashCore(torch.autograd.Function):
    """The reference's ``_flash_core`` custom VJP: the forward saves
    (q, k, v, o, lse); the backward computes delta and runs the dQ and the
    dK/dV kernels. The cotangent of lse is dropped, as the reference drops
    it (``do, _ = g``): a loss that reads only lse gets zero q, k and v
    gradients."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        o, lse = flash_attention_fwd(q, k, v, sm_scale=sm_scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(do, o)
        kw = dict(sm_scale=ctx.sm_scale, causal=ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over (batch, heads, seq, head_dim); also returns the per-row
    log-sum-exp (batch, heads, seq). Grouped-query attention repeats the kv
    heads."""
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    # the kernels take contiguous rows; a transposed (b=1) input reshapes to
    # a strided view, so copy where needed (a no-op otherwise)
    o, lse = _FlashCore.apply(
        *(t.reshape(b * h, -1, d).contiguous() for t in (q, k, v)), sm_scale, causal,
    )
    return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def flash_attention(q, k, v, **kwargs) -> torch.Tensor:
    return flash_attention_with_lse(q, k, v, **kwargs)[0]


def reference_attention(q, k, v, *, causal: bool = True, sm_scale=None):
    """Plain attention for correctness checks, as ray_tpu's: its causal mask
    is bottom-right aligned, ``tril(k=sk-sq)``."""
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
