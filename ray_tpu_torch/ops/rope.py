"""Rotary position embeddings: the port of ray_tpu/ops/rope.py.

Plain PyTorch, as the reference is plain jnp. The rotation is of the two
HALVES of the head dimension, (x[..., :d/2], x[..., d/2:]), as the reference
code does (its docstring's "pairs" wording does not match its code).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch


def rope_table(
    max_len: int, head_dim: int, theta: float = 10000.0, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin) tables of shape (max_len, head_dim // 2), f32."""
    freqs = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, freqs)
    return torch.cos(angles), torch.sin(angles)


def _rows(table: torch.Tensor, start: torch.Tensor, seq: int) -> torch.Tensor:
    """table[start : start + seq] for each start, with start clamped to
    [0, len - seq] as ``lax.dynamic_slice_in_dim`` clamps it."""
    start = start.clamp(0, table.shape[0] - seq)
    idx = start[..., None] + torch.arange(seq, device=table.device)
    return table[idx]


def apply_rope(
    x: torch.Tensor,  # (batch, heads, seq, head_dim)
    cos: torch.Tensor,
    sin: torch.Tensor,
    offset: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    """Rotate the halves of the last axis by the angle of each position.
    ``offset`` is the absolute position of x's first token; a (batch,)
    tensor gives each row its own offset (the continuous-batching decode
    case)."""
    seq = x.shape[-2]
    half = x.shape[-1] // 2
    if isinstance(offset, int):
        start = min(max(offset, 0), cos.shape[0] - seq)
        c = cos[start:start + seq][None, None]  # (1, 1, seq, half)
        s = sin[start:start + seq][None, None]
    elif offset.ndim == 1:
        c = _rows(cos, offset, seq)[:, None]  # (batch, 1, seq, half)
        s = _rows(sin, offset, seq)[:, None]
    else:
        c = _rows(cos, offset, seq)[None, None]
        s = _rows(sin, offset, seq)[None, None]
    x1 = x[..., :half]
    x2 = x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
