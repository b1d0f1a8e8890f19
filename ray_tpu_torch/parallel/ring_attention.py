"""Ring attention: the port of ray_tpu/parallel/ring_attention.py.

Causal attention with the sequence split over a group of ranks: rank r
holds positions [r * s_local, (r + 1) * s_local) of q, k and v, and
returns its rows of the output.

- Forward: the diagonal block is causal flash attention on the rank's own
  K/V (K2); then the K/V travel around the ring, n - 1 hops, one
  ``ring_shift`` of the group a hop (the reference's ``ppermute`` from rank
  i to i + 1). After hop s the rank holds rank (r - s) % n's K/V, which its
  queries see whole iff r >= s: a non-causal K2 call whose (o, lse) is
  merged into the running result by log-sum-exp weights in f32, ``o`` cast
  back to the input dtype after each merge (:func:`_merge`). A hop with
  nothing visible launches nothing: merging the reference's skip (o = 0,
  lse = -inf) leaves o and lse as they were, bit for bit, so the port
  leaves out the merge too. The next hop's shift is posted before this
  hop's kernels, so its transfer can run under them.
- Backward (the autograd Function's, step for step the reference's custom
  VJP): delta from the final o, once; the diagonal dQ (K3) and dK/dV (K4)
  causal; then the packet (q, dO, lse, delta, dQ) rotates n - 1 hops while
  K/V stay: after hop s the rank holds the packet of rank (r - s) % n,
  whose queries see its K/V iff s > r, and then adds non-causal K3 and K4
  contributions, dK and dV to its own, dQ into the packet. A last shift
  brings every dQ home (the reference rotates the whole packet; only dQ
  is read after it, and XLA drops the rest, so only dQ travels).
  dK, dV and dQ add up in the inputs' dtype, as the kernels return it.

Rank r launches r + 1 K2 calls and n - r K3 and K4 calls: the reference's
layout, which this port keeps (no load-balanced order). Every rank runs
the same shifts in the same order whatever it computes, so the ring never
waits on a branch only some ranks take (remat recomputes the forward,
shifts included, in the backward, on every rank alike).

Every block runs ``ops/flash_attention.py``'s wrappers on the flattened
(batch * heads, s_local, d) views: on a CUDA tensor they launch K2-K4 or
raise; on a CPU tensor they take the plain versions. GQA: the KV heads are
repeated to the query heads before the ring, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_fwd,
    flash_bwd_dkv,
    flash_bwd_dq,
)


def _merge(o1, lse1, o2, lse2):
    """Combine two partial attention results by their log-sum-exp: o
    (..., s, d) in o1's dtype, lse (..., s) f32, the sum in f32."""
    lse_max = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - lse_max)
    w2 = torch.exp(lse2 - lse_max)
    denom = w1 + w2
    lse_new = lse_max + torch.log(denom)
    o = o1.float() * (w1 / denom)[..., None] + o2.float() * (w2 / denom)[..., None]
    return o.to(o1.dtype), lse_new


def _ring_forward(q, k, v, group, sm_scale):
    """(o, lse) of this rank's queries over the K/V of every rank up to its
    own; q, k, v are (bh, s_local, d)."""
    n, me = group.world_size, group.rank
    pending = group.ring_shift([k, v])
    o, lse = flash_attention_fwd(q, k, v, sm_scale=sm_scale, causal=True)
    for s in range(1, n):
        k_s, v_s = pending.wait()  # rank (me - s) % n's
        if s < n - 1:
            pending = group.ring_shift([k_s, v_s])
        if me >= s:  # a strictly earlier rank: every key visible
            o_s, lse_s = flash_attention_fwd(q, k_s, v_s, sm_scale=sm_scale, causal=False)
            o, lse = _merge(o, lse, o_s, lse_s)
    return o, lse


def _ring_backward(q, k, v, o, lse, do, group, sm_scale):
    """(dq, dk, dv) of this rank's shards, every rank's queries' share of
    dk and dv included."""
    n, me = group.world_size, group.rank
    delta = attention_delta(do, o)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, sm_scale=sm_scale, causal=True)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, sm_scale=sm_scale, causal=True)
    packet = [q, do, lse, delta, dq]
    for s in range(1, n):
        packet = group.ring_shift(packet).wait()  # rank (me - s) % n's
        if s > me:  # that rank's queries see this rank's keys
            q_s, do_s, lse_s, delta_s, dq_s = packet
            dk_c, dv_c = flash_bwd_dkv(q_s, k, v, do_s, lse_s, delta_s, sm_scale=sm_scale,
                                       causal=False)
            dq_c = flash_bwd_dq(q_s, k, v, do_s, lse_s, delta_s, sm_scale=sm_scale,
                                causal=False)
            dk, dv = dk + dk_c, dv + dv_c
            packet[4] = dq_s + dq_c
    (dq,) = group.ring_shift([packet[4]]).wait()
    return dq, dk, dv


class _RingCore(torch.autograd.Function):
    """The reference's ``_ring_core``: the forward saves (q, k, v, o, lse)
    and the backward is :func:`_ring_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, group, sm_scale):
        o, lse = _ring_forward(q, k, v, group, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.sm_scale = group, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, o, lse, do.contiguous(), ctx.group, ctx.sm_scale)
        return dq, dk, dv, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group=None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention over (batch, heads, s_local, head_dim) shards of a
    sequence split over ``group``'s ranks in rank order (a ``GlooGroup`` or
    ``NcclGroup``); returns this rank's rows. KV heads fewer than the query
    heads are repeated first (GQA). With ``group=None`` or a group of one
    rank this is ``flash_attention(causal=True)``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if group is None or group.world_size == 1:
        return flash_attention(q, k, v, causal=True, sm_scale=sm_scale)
    b, h, s, d = q.shape
    if k.shape[1] != h:
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    o = _RingCore.apply(*(t.reshape(b * h, s, d).contiguous() for t in (q, k, v)), group,
                        sm_scale)
    return o.reshape(b, h, s, d)
