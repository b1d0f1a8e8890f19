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

``moe_dispatch`` / ``moe_combine`` are the reference's explicit all_to_all
path over an expert-parallel process group: each rank holds E / n experts,
and one ``all_to_all_single`` carries every rank's slabs for them (the
reference's ``lax.all_to_all`` inside ``shard_map``). The model over a
mesh (``MoETransformer(config, mesh)``) takes the reference's GSPMD path
instead: :func:`route` over the data axes' group gives every rank the
global batch's routing for its tokens, and an ``ep`` rank runs its own
experts on its tokens' slots (``moe_apply_indexed(experts=)``), its partial
sum completed over ``ep`` and ``tp`` by the model (models/moe.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

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


def route(router_logits: torch.Tensor, capacity: int, k: int = 2, group=None,
          seq_shards: int = 1, rows: int = 1) -> Routing:
    """The reference's gating loop, in its order: tokens in flattened
    order; each pass takes every token's best remaining expert (the first
    index on ties, as ``jnp.argmax``), gives it the next free slot of that
    expert in token order, offset by the slots earlier passes KEPT, and
    masks that expert for the next pass even where the token was dropped;
    gates are renormalised over the kept choices by ``max(sum, 1e-9)``;
    ``frac_tokens`` counts the tokens dispatched to each expert after
    capacity.

    With ``group`` (the data axes' group of a mesh, with ``sp``: the loss
    axes' group) the logits are this rank's tokens of the global batch,
    and the routing is the global batch's, as the reference's GSPMD
    program computes it: ``capacity`` is the global batch's; a token's slot
    counts the earlier tokens of the global ``(b, s)`` order on every rank,
    from one all-gather of each rank's per-pass, per-expert counts (a
    pass's choices do not depend on the earlier passes' drops, so all
    passes' counts go at once); and the aux loss is the global one, ``E *
    sum(frac_tokens * frac_probs)`` over the global batch's means: every
    rank returns it, through ``sum_of_ranks`` of the rank's own term (its
    tokens' probabilities against the global ``frac_tokens``), so each
    rank's backward is its own tokens' share.

    The group's rank is ``shard * seq_shards + s``: a data shard, and the
    sequence shard ``s`` minor (``seq_shards`` = 1 without sequence
    parallelism, where a rank's tokens are one block of the global order).
    The rank holds ``rows`` rows of its data shard and in each row a
    contiguous slice of positions, so a token in row i comes after the
    earlier data shards' tokens, after every sequence shard's tokens of the
    shard's rows before i, and after sequence shards ``< s`` in row i: the
    counts are gathered per row (per rank where ``rows`` = 1)."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    masked = probs
    expert_ids = torch.arange(e, device=probs.device)[:, None]
    passes = []
    for _ in range(k):
        idx = masked.argmax(dim=-1)
        gate = masked.gather(-1, idx[:, None])[:, 0]
        # (e, t), expert-major: the running count below is then a scan
        # along the inner axis (over the outer one, a (t, 8) scan took
        # 1.4 ms a call on the H100)
        chosen = idx[None, :] == expert_ids
        masked = masked.masked_fill(chosen.t(), 0.0)
        passes.append((idx, gate, chosen))
    # each pass's choices of each expert, here and (over a group) everywhere
    totals = torch.stack([chosen.sum(dim=1) for _, _, chosen in passes])  # (k, e)
    offsets, n = None, 1
    if group is not None:
        offsets, totals = _global_counts(passes, group, seq_shards, rows)
        n = group.world_size
    filled = torch.zeros(e, dtype=torch.long, device=probs.device)
    slots, keeps, gates = [], [], []
    for i, (idx, gate, chosen) in enumerate(passes):
        # each token's slot: the earlier tokens of this pass that chose the
        # same expert (on other ranks too), after the slots that earlier
        # passes kept
        slot = chosen.cumsum(dim=1).gather(0, idx[None, :])[0] - 1 + filled[idx]
        if offsets is not None:
            slot = slot + offsets[i]
        keep = slot < capacity
        filled = filled + torch.minimum((capacity - filled).clamp_min(0), totals[i])
        slots.append(slot)
        keeps.append(keep)
        gates.append(gate * keep)
    keep = torch.stack(keeps, dim=1)
    kept_gate = torch.stack(gates, dim=1)
    weight = kept_gate / kept_gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    expert = torch.stack([idx for idx, _, _ in passes], dim=1)
    if group is None:
        # a token counts once for each expert it was dispatched to
        frac_tokens = (F.one_hot(expert, e) * keep[..., None]).amax(dim=1).float().mean(dim=0)
        aux_loss = e * torch.sum(frac_tokens * probs.mean(dim=0))
    else:
        from ..collective.functional import sum_of_ranks

        # the passes choose distinct experts for a token, so the kept count
        # is the number of tokens dispatched to each expert
        frac_tokens = filled.float() / (t * n)
        share = e * torch.sum(frac_tokens * (probs.sum(dim=0) / (t * n)))
        aux_loss = sum_of_ranks(share.reshape(1), group)[0]
    return Routing(expert, torch.stack(slots, dim=1), keep, weight, aux_loss, e, capacity)


def _global_counts(passes, group, seq_shards: int, rows: int):
    """(each pass's (t,) count of the tokens of other ranks that come before
    each of this rank's tokens and chose its expert, the global (k, e)
    totals), from one all-gather over ``group`` of each pass's choices of
    each expert in each of the rank's rows (see :func:`route`)."""
    e, t = passes[0][2].shape
    if t % rows:
        raise ValueError(f"{t} tokens are not {rows} rows of one length")
    counts = torch.stack([chosen.view(e, rows, t // rows).sum(dim=2) for _, _, chosen in passes])
    every = group.allgather_cat(counts[None], dim=0)
    every = every.view(-1, seq_shards, *counts.shape)  # (shards, seq shards, k, e, rows)
    shard, me = divmod(group.rank, seq_shards)
    mine = every[shard]
    others = mine.sum(dim=0) - mine[me]  # the other sequence shards' tokens of each row
    before = (every[:shard].sum(dim=(0, 1, 4))[..., None]  # the earlier data shards
              + others.cumsum(dim=-1) - others  # every shard's rows before the row
              + mine[:me].sum(dim=0))  # the earlier sequence shards in the row
    row = torch.arange(t, device=counts.device) // (t // rows)
    return ([before[i][idx, row] for i, (idx, _, _) in enumerate(passes)],
            every.sum(dim=(0, 1, 4)))


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
    experts: Optional[Tuple[int, int]] = None,
    weight: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """:func:`moe_apply_gspmd` from the routing instead of the dense
    tensors: the kept (token, choice) rows are copied into their slots of
    the (E, C, d) slabs, every other slot being zero; the experts run on the
    slabs; each token's outputs are gathered back from its slots, weighted
    in f32 and summed over its k choices. Fixed shapes, no host sync: the
    dropped choices write to a spare row past the slabs and gather with
    weight 0.

    ``experts = (e0, e1)`` runs experts [e0, e1) alone (an expert-parallel
    rank's): the slabs are theirs, (e1 - e0, C, d), the other experts'
    choices weigh 0, and the result is this rank's partial sum. ``weight``
    (t, k) stands for ``routing.weight`` (the gates as the caller passes
    them into the experts' region); ``dtype`` is the result's (default
    ``x.dtype``; a partial sum stays f32 until the ranks' are added)."""
    t, d = x.shape
    c = routing.capacity
    e0, e1 = (0, routing.n_experts) if experts is None else experts
    e = e1 - e0
    local = routing.keep
    if experts is not None:
        local = local & (routing.expert >= e0) & (routing.expert < e1)
    flat = (routing.expert - e0) * c + routing.slot
    dest = torch.where(local, flat, e * c)  # (t, k)
    slabs = x.new_zeros(e * c + 1, d).index_put((dest,), x[:, None, :])[: e * c]
    y = expert_fn(slabs.view(e, c, d))
    # index_select: its backward adds each row's gradient into its one slot
    # (index_add); advanced indexing's backward sorts the indices first
    y = y.reshape(e * c, -1).index_select(0, torch.where(local, flat, 0).reshape(-1))
    w = routing.weight if weight is None else weight
    if experts is not None:
        w = torch.where(local, w, 0.0)
    out = (y.float() * w.reshape(-1, 1)).view(t, dest.shape[1], -1).sum(dim=1)
    return out.to(x.dtype if dtype is None else dtype)


# -- the explicit all_to_all path --------------------------------------------


def _process_group(group):
    """A torch ProcessGroup, from itself or from a port collective group."""
    return getattr(group, "process_group", group)


class _AllToAll(torch.autograd.Function):
    """Chunk i of dim 0 to rank i; chunk j of the result from rank j. With
    equal chunks the exchange is its own adjoint, so the backward is the
    same exchange of the gradient (``lax.all_to_all``'s transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        torch.distributed.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return _AllToAll.apply(x, group)


def moe_dispatch(x: torch.Tensor, dispatch: torch.Tensor, group=None) -> torch.Tensor:
    """Local tokens -> this rank's local experts' slabs, (E_local, n * C,
    d): every rank's contribution to its experts, by source rank. ``group``
    is the expert-parallel process group (a torch ProcessGroup or a
    collective group; None: one rank, no exchange). x: (tokens_local, d);
    dispatch: (tokens_local, E_global, C)."""
    slabs = torch.einsum("td,tec->ecd", x.float(), dispatch).to(x.dtype)
    if group is None:
        return slabs
    pg = _process_group(group)
    n = torch.distributed.get_world_size(pg)
    e, c, d = slabs.shape
    if e % n:
        raise ValueError(f"experts ({e}) not divisible by the ep group ({n})")
    # split the expert dim across ranks; the source rank takes its place
    recv = _all_to_all(slabs.reshape(n, e // n, c, d), pg)
    return recv.transpose(0, 1).reshape(e // n, n * c, d)


def moe_combine(y_local: torch.Tensor, combine: torch.Tensor, group=None) -> torch.Tensor:
    """Inverse of :func:`moe_dispatch`: local expert outputs (E_local, n *
    C, d_out) -> local tokens (tokens_local, d_out), sending each source
    rank's slab home."""
    if group is not None:
        pg = _process_group(group)
        n = torch.distributed.get_world_size(pg)
        e_local, nc, d = y_local.shape
        slabs = y_local.reshape(e_local, n, nc // n, d).transpose(0, 1)
        y_local = _all_to_all(slabs, pg).reshape(n * e_local, nc // n, d)
    return torch.einsum("ecd,tec->td", y_local.float(), combine).to(y_local.dtype)
