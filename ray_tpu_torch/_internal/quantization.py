"""Int8 per-block symmetric quantization codec: the port of
ray_tpu/_internal/quantization.py, the wire format of the KV tier's
shipments, the weight plane's int8 chunks and the quantized collectives.

Format: a float tensor is flattened, zero-padded to a multiple of ``block``
elements and reshaped to ``(n_blocks, block)``. Each block carries one f32
scale ``max|x| / 127`` and ``block`` int8 codes ``clip(round(x / scale),
-127, 127)``; dequantization is ``q * scale``, truncated back to the
original element count, shape and dtype. The error of an element is at most
half a quantization step, ``scale / 2``.

Edge semantics, as the reference's: a zero scale (an all-zero block) is
replaced by 1 so the division is safe; NaN is excluded from the scale and
coded 0; +-inf is excluded from the scale and clipped to +-127.

Two implementations share the format bit for bit, as in the reference:

- :func:`quantize_np` / :func:`dequantize_np`, in numpy on the host;
- :func:`quantize_torch` / :func:`dequantize_torch` (the reference's
  ``quantize_jax`` / ``dequantize_jax``), in torch on the tensor's own
  device, so a tensor on the card is coded on the card.

Both take torch tensors (and ``quantize_np`` numpy arrays too): a bf16
tensor has no numpy form without ``ml_dtypes``, which the card's machine
lacks, so a :class:`QuantizedArray` records its dtype by torch's name
(``"bfloat16"``). Both compute in IEEE f32, divide ``amax / 127.0`` in f32
and round half to even (``np.rint``, ``torch.round``), so the codes and
scales of one input are equal on either path and either device.

The collectives carry an error-feedback residual across rounds: the part
of each round's compensated input that the codes did not carry
(:func:`ef_quantize_np` on the host, :func:`ef_quantize_torch` on the
tensor's device); :func:`quantized_wire_nbytes` is a coded tensor's analytic
wire size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

#: default elements per scale block: the scales cost ~1.6% of the codes
#: while an outlier spoils only its own block
DEFAULT_BLOCK = 256

#: float leaves smaller than this stay raw: at tiny sizes the scale overhead
#: eats the win and exactness is worth more
MIN_QUANT_BYTES = 64

#: dtypes eligible for quantization, by name
_QUANT_DTYPE_NAMES = frozenset({"float16", "float32", "float64", "bfloat16"})


def _dtype_name(dtype: Any) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``; numpy dtypes by their name."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


def _nbytes(arr: Any) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(getattr(arr, "nbytes", 0))


def is_quantizable(arr: Any, min_bytes: int = MIN_QUANT_BYTES) -> bool:
    """True when ``arr`` (a torch tensor or numpy array) is a float array
    worth encoding."""
    dtype = getattr(arr, "dtype", None)
    return (
        dtype is not None
        and _dtype_name(dtype) in _QUANT_DTYPE_NAMES
        and _nbytes(arr) >= min_bytes
    )


@dataclass(frozen=True)
class QuantizedArray:
    """One encoded tensor: int8 codes ``q`` (n_blocks, block) and f32
    ``scales`` (n_blocks,), numpy arrays or torch tensors on any device,
    with the original shape and dtype name. ``wire_nbytes`` and
    ``logical_nbytes`` are the two sides of the byte accounting."""

    q: Any
    scales: Any
    shape: Tuple[int, ...]
    dtype: str  # original dtype, torch's name, e.g. "bfloat16"
    block: int = DEFAULT_BLOCK

    @property
    def wire_nbytes(self) -> int:
        return _nbytes(self.q) + _nbytes(self.scales)

    @property
    def logical_nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * _torch_dtype(self.dtype).itemsize


# -- numpy path (host) ---------------------------------------------------------


def quantize_np(arr: Any, block: int = DEFAULT_BLOCK) -> QuantizedArray:
    """Encode on the host with numpy: codes and scales as numpy arrays.
    ``arr`` is a numpy array or a torch tensor (copied to the host)."""
    if isinstance(arr, torch.Tensor):
        orig_dtype = _dtype_name(arr.dtype)
        shape = tuple(arr.shape)
        flat = arr.detach().to("cpu", torch.float32).contiguous().numpy().ravel()
    else:
        a = np.asarray(arr)
        orig_dtype, shape = str(a.dtype), tuple(a.shape)
        flat = np.ascontiguousarray(a).astype(np.float32, copy=False).ravel()
    pad = (-flat.size) % block
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, block)
    finite = np.where(np.isfinite(blocks), blocks, np.float32(0.0))
    amax = np.abs(finite).max(axis=1) if blocks.size else np.zeros(0, np.float32)
    scales = (amax / np.float32(127.0)).astype(np.float32)
    safe = np.where(scales > 0.0, scales, np.float32(1.0))
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        q = blocks / safe[:, None]
    # NaN -> 0; +-inf survives the finite-masked scale, clip to the rails
    q = np.nan_to_num(q, nan=0.0, posinf=127.0, neginf=-127.0)
    q = np.clip(np.rint(q), -127, 127).astype(np.int8)
    return QuantizedArray(q=q, scales=scales, shape=shape, dtype=orig_dtype, block=block)


def dequantize_np(qa: QuantizedArray, dtype: Optional[str] = None) -> torch.Tensor:
    """Decode on the host to a torch CPU tensor of the original (or
    ``dtype``) type; the product runs in numpy f32."""
    n = 1
    for d in qa.shape:
        n *= int(d)
    q, scales = np.asarray(qa.q), np.asarray(qa.scales)
    flat = (q.astype(np.float32) * scales[:, None]).ravel()[:n]
    return torch.from_numpy(flat.reshape(qa.shape)).to(_torch_dtype(dtype or qa.dtype))


def ef_quantize_np(
    arr: Any, residual: Optional[np.ndarray], block: int = DEFAULT_BLOCK
) -> Tuple[QuantizedArray, np.ndarray]:
    """Error-feedback encode on the host: compensate with the carried f32
    ``residual``, quantize, and return (codes, new residual), the new
    residual being the local quantization error that the next round folds
    in. ``arr`` is a numpy array or a torch tensor (copied to the host).
    A non-finite new residual is dropped to 0 at those positions, so that
    one inf does not poison every later round."""
    if isinstance(arr, torch.Tensor):
        comp = arr.detach().to("cpu", torch.float32).contiguous().numpy()
    else:
        comp = np.asarray(arr).astype(np.float32, copy=False)
    if residual is not None:
        comp = comp + residual
    qa = quantize_np(comp, block)
    new_residual = comp - dequantize_np(qa, dtype="float32").numpy()
    if not np.isfinite(new_residual).all():
        new_residual = np.nan_to_num(new_residual, nan=0.0, posinf=0.0, neginf=0.0)
    return qa, new_residual


def quantized_wire_nbytes(nelems: int, block: int = DEFAULT_BLOCK) -> int:
    """Analytic wire size of a coded tensor: one byte per element of int8
    codes, padded to the block multiple, and four bytes per block of
    scales."""
    n_blocks = max(1, -(-nelems // block))
    return n_blocks * block + 4 * n_blocks


# -- torch path (the tensor's own device) ----------------------------------------


def quantize_torch(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """Encode on ``x``'s device: returns (q int8 (n_blocks, block), scales
    f32 (n_blocks,)), equal to :func:`quantize_np`'s bit for bit."""
    flat = x.detach().reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.view(-1, block)
    finite = torch.where(torch.isfinite(blocks), blocks, blocks.new_zeros(()))
    if blocks.numel():
        amax = finite.abs().amax(dim=1)
    else:
        amax = blocks.new_zeros(0)
    # a divisor tensor on amax's device: CUDA divides by a Python scalar as
    # a multiply by its reciprocal, which is not amax / 127 in f32
    scales = amax / amax.new_full((), 127.0)
    safe = torch.where(scales > 0.0, scales, scales.new_ones(()))
    q = torch.nan_to_num(blocks / safe[:, None], nan=0.0, posinf=127.0, neginf=-127.0)
    return q.round_().clamp_(-127, 127).to(torch.int8), scales


def dequantize_torch(q: torch.Tensor, scales: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Decode on ``q``'s device back to ``shape`` / ``dtype`` (a torch dtype
    or its name). Leading axes of ``q`` / ``scales`` beyond the (n_blocks,
    block) pair broadcast, as the reference's: a stacked [w, n_blocks,
    block] decodes to [w, *shape]."""
    if isinstance(dtype, str):
        dtype = _torch_dtype(dtype)
    n = 1
    for d in shape:
        n *= int(d)
    lead = tuple(q.shape[:-2])
    flat = (q.to(torch.float32) * scales[..., None]).reshape(*lead, -1)
    return flat[..., :n].reshape(*lead, *shape).to(dtype)


def ef_quantize_torch(x: torch.Tensor, residual: Optional[torch.Tensor],
                      block: int = DEFAULT_BLOCK):
    """The reference's on-device error-feedback step (``XlaGroup``'s
    quantized programs): ``comp = x + residual`` in f32, its codes and
    scales, and the new residual ``comp - dequantize(codes)``, all on
    ``x``'s device. Returns (comp, q, scales, new residual)."""
    comp = x.detach().to(torch.float32)
    if residual is not None:
        comp = comp + residual
    q, scales = quantize_torch(comp, block)
    own = dequantize_torch(q, scales, comp.shape, torch.float32)
    return comp, q, scales, comp - own
