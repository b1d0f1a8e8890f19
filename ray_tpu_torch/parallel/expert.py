"""Expert parallelism: MoE gating, dispatch and combine; the port of
ray_tpu/parallel/expert.py.

GShard/Switch-style top-k routing with static capacity, so that every
shape is fixed by the token count alone:

- :func:`route` runs the gating loop once and returns, for each (token,
  choice), the expert, the slot in that expert's capacity, the kept flag and
  the renormalised weight (a :class:`Routing`), with the load-balancing
  auxiliary loss;
- :func:`top_k_gating` builds the reference's dense ``dispatch`` and
  ``combine`` (tokens, experts, capacity) tensors from that routing;
- :func:`moe_apply_gspmd` is the reference's dense path: one f32 einsum
  dispatches, the experts run on (E, C, d) slabs, one f32 einsum combines;
- :func:`moe_apply_indexed` computes the same function from the routing: a
  gather of the routed rows into the (E, C, d) slabs (zero rows for empty
  slots) and a weighted sum of each token's expert outputs in f32. It is
  what ``models/moe.py`` runs: at Mixtral's width the dense einsums are
  f32 GEMMs over (t, E, C) one-hot tensors, 1.37 TFLOP each a layer, where
  the gather and the sum move t·k rows.

The two paths agree exactly on the dispatch side: each slot holds at most
one token, so each slab row is a copy of one input row. On the combine side
each output sums at most k non-zero products (w · y); the indexed form
rounds each product and then adds them, while a GEMM may fuse one of them
into a multiply-add and round once. So for k = 2 the outputs agree to
within 2^-22 of the sum of |w · y| (three roundings at 2^-24), and are
equal wherever the GEMM also rounded each product.

``moe_dispatch`` / ``moe_combine``, the reference's explicit all_to_all
path, run at one rank, where the all_to_all is the identity; more ranks
wait for collectives over NCCL (ROADMAP item A.4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F


def expert_capacity(tokens: int, n_experts: int, capacity_factor: float,
                    k: int = 2) -> int:
    """Static per-expert token capacity (the GShard cap)."""
    return max(1, int(math.ceil(tokens * k * capacity_factor / n_experts)))


@dataclasses.dataclass
class Routing:
    """The routing of t tokens, k choices each. ``expert`` (t, k) int64 is
    the chosen expert, ``slot`` (t, k) int64 its running position in that
    expert (at or past ``capacity`` where dropped), ``keep`` (t, k) bool
    whether it fits, ``weight`` (t, k) f32 the gate renormalised over the
    kept choices (0 where dropped), ``aux_loss`` () f32 the Switch-style
    load-balance loss."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    aux_loss: torch.Tensor
    n_experts: int
    capacity: int


def route(router_logits: torch.Tensor, capacity: int, k: int = 2) -> Routing:
    """The reference's gating loop, in its order: tokens in flattened
    order; each pass takes every token's best remaining expert (the first
    index on ties, as ``jnp.argmax``), gives it the next free slot of that
    expert in token order, offset by the slots earlier passes KEPT, and
    masks that expert for the next pass even where the token was dropped;
    gates are renormalised over the kept choices by ``max(sum, 1e-9)``;
    ``frac_tokens`` counts the tokens dispatched to each expert after
    capacity."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    masked = probs
    filled = torch.zeros(e, dtype=torch.long, device=probs.device)
    expert_ids = torch.arange(e, device=probs.device)[:, None]
    experts, slots, keeps, gates = [], [], [], []
    for _ in range(k):
        idx = masked.argmax(dim=-1)
        gate = masked.gather(-1, idx[:, None])[:, 0]
        # (e, t), expert-major: the running count below is then a scan
        # along the inner axis (over the outer one, a (t, 8) scan took
        # 1.4 ms a call on the H100)
        chosen = idx[None, :] == expert_ids
        # each token's slot: the earlier tokens of this pass that chose the
        # same expert, after the slots that earlier passes kept
        slot = chosen.cumsum(dim=1).gather(0, idx[None, :])[0] - 1 + filled[idx]
        keep = slot < capacity
        filled = filled + (chosen & keep).sum(dim=1)
        masked = masked.masked_fill(chosen.t(), 0.0)
        experts.append(idx)
        slots.append(slot)
        keeps.append(keep)
        gates.append(gate * keep)
    keep = torch.stack(keeps, dim=1)
    kept_gate = torch.stack(gates, dim=1)
    weight = kept_gate / kept_gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    expert = torch.stack(experts, dim=1)
    # a token counts once for each expert it was dispatched to
    frac_tokens = (F.one_hot(expert, e) * keep[..., None]).amax(dim=1).float().mean(dim=0)
    aux_loss = e * torch.sum(frac_tokens * probs.mean(dim=0))
    return Routing(expert, torch.stack(slots, dim=1), keep, weight, aux_loss, e, capacity)


def top_k_gating(router_logits: torch.Tensor, capacity: int, k: int = 2):
    """The reference's dense form: ``dispatch`` (tokens, experts, capacity)
    f32, 1 where token t goes to expert e at slot c; ``combine`` the same
    with the renormalised gate weight; and the aux loss. Gradients reach
    the logits through ``combine`` and the aux loss, as in the reference."""
    r = route(router_logits, capacity, k)
    t = router_logits.shape[0]
    tok = torch.arange(t, device=r.keep.device)[:, None].expand_as(r.keep)[r.keep]
    at = (tok, r.expert[r.keep], r.slot[r.keep])
    shape = (t, r.n_experts, capacity)
    zeros = torch.zeros(shape, device=r.keep.device)
    dispatch = zeros.index_put(at, torch.ones_like(r.weight[r.keep]))
    combine = zeros.index_put(at, r.weight[r.keep])
    return dispatch, combine, r.aux_loss


def moe_apply_gspmd(
    x: torch.Tensor,  # (tokens, dim)
    dispatch: torch.Tensor,  # (tokens, E, C)
    combine: torch.Tensor,  # (tokens, E, C)
    expert_fn: Callable[[torch.Tensor], torch.Tensor],  # (E, C, d) -> (E, C, d_out)
) -> torch.Tensor:
    """The reference's dense path: einsum dispatch in f32, the experts on
    (E, C, d) slabs in ``x.dtype``, einsum combine in f32, the result in
    ``x.dtype``."""
    expert_inputs = torch.einsum("td,tec->ecd", x.float(), dispatch).to(x.dtype)
    expert_outputs = expert_fn(expert_inputs)
    return torch.einsum("ecd,tec->td", expert_outputs.float(), combine).to(x.dtype)


def moe_apply_indexed(
    x: torch.Tensor,  # (tokens, dim)
    routing: Routing,
    expert_fn: Callable[[torch.Tensor], torch.Tensor],  # (E, C, d) -> (E, C, d_out)
) -> torch.Tensor:
    """:func:`moe_apply_gspmd` from the routing instead of the dense
    tensors: the kept (token, choice) rows are copied into their slots of
    the (E, C, d) slabs, every other slot being zero; the experts run on the
    slabs; each token's outputs are gathered back from its slots, weighted
    in f32 and summed over its k choices. Fixed shapes, no host sync: the
    dropped choices write to a spare row past the slabs and gather with
    weight 0."""
    t, d = x.shape
    e, c = routing.n_experts, routing.capacity
    flat = routing.expert * c + routing.slot
    dest = torch.where(routing.keep, flat, e * c)  # (t, k)
    slabs = x.new_zeros(e * c + 1, d).index_put((dest,), x[:, None, :])[: e * c]
    y = expert_fn(slabs.view(e, c, d))
    # index_select: its backward adds each row's gradient into its one slot
    # (index_add); advanced indexing's backward sorts the indices first
    y = y.reshape(e * c, -1).index_select(0, torch.where(routing.keep, flat, 0).reshape(-1))
    out = (y.float() * routing.weight.reshape(-1, 1)).view(t, dest.shape[1], -1).sum(dim=1)
    return out.to(x.dtype)


# -- the explicit all_to_all path --------------------------------------------

_EP = (
    "moe_{} over {} ranks needs an all_to_all across them, which comes with "
    "collectives over NCCL (ROADMAP item A.4); at one rank it is the identity"
)


def _ranks(group) -> int:
    if group is None:
        return 1
    return torch.distributed.get_world_size(group)


def moe_dispatch(x: torch.Tensor, dispatch: torch.Tensor, group=None) -> torch.Tensor:
    """Local tokens -> this rank's local experts' slabs, (E_local, n * C,
    d). ``group`` is the expert-parallel process group (None: one rank).
    At one rank the all_to_all is the identity and this is the dense
    dispatch einsum; more ranks raise."""
    n = _ranks(group)
    if n != 1:
        raise NotImplementedError(_EP.format("dispatch", n))
    return torch.einsum("td,tec->ecd", x.float(), dispatch).to(x.dtype)


def moe_combine(y_local: torch.Tensor, combine: torch.Tensor, group=None) -> torch.Tensor:
    """Inverse of :func:`moe_dispatch`: local expert outputs (E_local, n *
    C, d_out) -> local tokens (tokens, d_out). One rank only, as there."""
    n = _ranks(group)
    if n != 1:
        raise NotImplementedError(_EP.format("combine", n))
    return torch.einsum("ecd,tec->td", y_local.float(), combine).to(y_local.dtype)
