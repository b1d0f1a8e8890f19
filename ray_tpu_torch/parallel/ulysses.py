"""Ulysses sequence parallelism: the port of ray_tpu/parallel/ulysses.py.

The alternative to the ring (parallel/ring_attention.py) when the head
count divides over the group: one all-to-all re-splits q, k and v from
sequence shards (batch, heads, s_local, d) to head shards (batch,
heads / n, s, d), each rank runs full-sequence flash attention (K2, and
K3-K4 in the backward, through ``flash_attention``) on its heads, and the
inverse all-to-all restores the sequence split. The all-to-alls are
``collective/functional.py``'s, whose backward is the inverse all-to-all.
No model of the reference calls it; it is held at the op level.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..collective.functional import all_to_all
from ..ops.flash_attention import flash_attention


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group=None,
    sm_scale: Optional[float] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Attention over (batch, heads, s_local, head_dim) shards of a sequence
    split over ``group``'s ranks in rank order; returns this rank's rows.
    KV heads are repeated to the query heads first (GQA), and the head
    count must divide over the ranks (``ValueError``)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = 1 if group is None else group.world_size
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if q.shape[1] % n:
        raise ValueError(f"ulysses needs heads ({q.shape[1]}) divisible by the sequence-"
                         f"parallel ranks ({n})")
    if n == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    qg, kg, vg = (all_to_all(t, group, split_dim=1, concat_dim=2) for t in (q, k, v))
    out = flash_attention(qg, kg, vg, causal=causal, sm_scale=sm_scale)
    return all_to_all(out, group, split_dim=2, concat_dim=1)
