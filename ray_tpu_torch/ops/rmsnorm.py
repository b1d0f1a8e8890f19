"""RMSNorm forward: the port of ray_tpu/ops/rmsnorm.py.

Kernel: ``csrc/rmsnorm.cu`` (CUDA C++, sm_90a) replaces the Pallas TPU
kernel ``_fwd_kernel`` of ray_tpu/ops/rmsnorm.py, launched there by
``_rmsnorm_fwd_impl``. It is bounded by bytes on the H100 (it reads x and w
once and writes once); see the source for the design.

:func:`rmsnorm_fwd` is the wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs :func:`rmsnorm_reference`, the plain PyTorch
version of the same arithmetic. ``rmsnorm_fwd.launches`` counts kernel
launches. The backward (plain XLA in ray_tpu) belongs to the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from .._internal import kernels

_LIB = "rmsnorm"
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
)


def rmsnorm_reference(x2: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version: statistics in f32, result in ``x2.dtype``."""
    x = x2.float()
    inv = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * inv * weight.float()).to(x2.dtype)


def _rmsnorm_cuda(x2: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    n, d = x2.shape
    if weight.shape != (d,) or weight.dtype != x2.dtype or weight.device != x2.device:
        raise ValueError(
            f"weight must be ({d},) {x2.dtype} on {x2.device}, got "
            f"{tuple(weight.shape)} {weight.dtype} on {weight.device}"
        )
    if d % 8:
        raise ValueError(f"rmsnorm kernel needs d % 8 == 0, got d={d}")
    code = kernels.dtype_code(x2.dtype)
    kernels.check_layout("x", x2)
    kernels.check_layout("weight", weight)
    out = torch.empty_like(x2)
    if n == 0:
        return out
    fn = kernels.function(_LIB, "rt_rmsnorm_fwd", _ARGTYPES)
    err = fn(
        x2.data_ptr(), weight.data_ptr(), out.data_ptr(), n, d, eps, code,
        kernels.stream_ptr(x2.device),
    )
    kernels.check(_LIB, err, "rmsnorm_fwd")
    rmsnorm_fwd.launches += 1
    return out


def rmsnorm_fwd(x2: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of a (rows, d) tensor with a (d,) weight of its dtype."""
    if x2.device.type == "cpu":
        return rmsnorm_reference(x2, weight, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x2.device}")
    return _rmsnorm_cuda(x2, weight, eps)


rmsnorm_fwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, eps):
        return rmsnorm_fwd(x2, weight, eps)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "rmsnorm backward is not ported yet: it comes with the training "
            "slice of the port"
        )


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; any leading shape."""
    shape = x.shape
    out = _RMSNorm.apply(x.reshape(-1, shape[-1]), weight, eps)
    return out.reshape(shape)
