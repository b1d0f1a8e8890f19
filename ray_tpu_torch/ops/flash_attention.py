"""Flash attention, forward half: the port of ray_tpu/ops/flash_attention.py.

Kernel: ``csrc/flash_attention.cu`` (CUDA C++, sm_90a) replaces the Pallas
TPU kernel ``_fwd_kernel`` of ray_tpu/ops/flash_attention.py, launched there
by ``_flash_forward``. Bytes bound it at the serving shapes; its first
version runs the products on f32 FMAs (see the source for the design).

:func:`flash_attention_fwd` is the wrapper over (batch*heads, seq, d):
a CUDA tensor launches the kernel (or raises), a CPU tensor runs
:func:`flash_attention_reference`, the plain PyTorch version of the same
function. ``flash_attention_fwd.launches`` counts kernel launches.

Semantics follow the TPU kernel, not ``reference_attention``: causal
masking is TOP-LEFT aligned (``q_pos >= k_pos``), so with sq != sk it
differs from ``reference_attention``'s bottom-right ``tril(k=sk-sq)``.
Every row of a call sees key 0, so no row of the public API is fully
masked; the guard for one (``o = 0``, ``lse = -1e30``) is kept all the same.

The backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) belong to
the training slice; differentiating through this module raises.
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
_HEAD_DIMS = (32, 64, 128)
_BLOCK_Q = 64  # q rows per CUDA block, as in csrc/flash_attention.cu


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
    """Plain version of the kernel: o (bh, sq, d) in q's dtype and lse
    (bh, sq) in f32, top-left causal."""
    sq, sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    valid = q_pos >= k_pos if causal else torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    return _masked_attention(q, k, v, valid, sm_scale)


def _flash_cuda(q, k, v, sm_scale, causal):
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
    if -(-sq // _BLOCK_Q) > 65535:
        raise ValueError(f"sq={sq} exceeds the kernel's grid")
    if sk == 0:
        raise ValueError("flash attention needs at least one key")
    code = kernels.dtype_code(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_layout(name, t)
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
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sm_scale=sm_scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return _flash_cuda(q, k, v, sm_scale, causal)


flash_attention_fwd.launches = 0


class _FlashCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        return flash_attention_fwd(q, k, v, sm_scale=sm_scale, causal=causal)

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash attention backward (_bwd_dq_kernel, _bwd_dkv_kernel) is "
            "not ported yet: it comes with the training slice of the port"
        )


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
    o, lse = _FlashCore.apply(
        q.reshape(b * h, sq, d), k.reshape(b * h, sk, d), v.reshape(b * h, sk, d),
        sm_scale, causal,
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
