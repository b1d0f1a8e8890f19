"""Differentiable collectives over a group of the port.

It has no reference file: XLA transposes the reference's collectives when it
differentiates a program (an all-reduce's cotangent is all-reduced, an
all-gather's is reduce-scattered), and ``GlooGroup`` / ``NcclGroup`` ops
have no autograd. These functions give them one: the sync-BN of
models/resnet.py, the gathered adapters of parallel/fsdp.py, the Ulysses
head/sequence swap of parallel/ulysses.py, and the sequence-parallel loss of
models/llama.py (:func:`sum_of_ranks`, whose backward is not the sum's
transpose).

They run on the groups' model ops (``allreduce_``, ``allgather_cat``,
``reducescatter_sum``, ``all_to_all``): no store read on the hot path and,
over NCCL, no wait, so the host runs ahead of the card.

Which op belongs where follows from what each rank's cotangent is, that
is, from what the ranks compute downstream of the op:

- :func:`all_reduce_sum`: each rank's downstream is its own (a sync-BN's
  statistics feed the rank's own rows), so the cotangents are summed too.
- :func:`all_gather_cat` (reduce-scatter backward): each rank's downstream
  is its own partial sum (an FSDP weight gathered for the rank's batch
  shard), so the rank's block gets the sum of the ranks' gradients.
- Megatron's pair, for ranks that compute one value alike (tensor and
  expert parallelism): :func:`copy_to_group` ("f": identity forward,
  all-reduce backward) where a replicated tensor enters a region split
  over the group (before a column-split product), so its gradient is the
  sum of the ranks' partial ones; :func:`sum_of_ranks` ("g": all-reduce
  forward, identity backward) where the region's partial sums leave it
  (after a row-split product), since every rank then holds and
  differentiates the same sum. The same ``sum_of_ranks`` makes a loss of
  data shards global: each rank's backward is its own term's.
- :func:`gather_from_group` (all-gather forward, slice backward): the
  column-split outputs of a region gathered for a downstream every rank
  computes alike (a ViT head's classes, vocab-split logits, a router's
  experts). Each rank's cotangent is then the whole gradient, and its
  block's is its slice; ``all_gather_cat`` there would sum the ranks'
  equal cotangents, world-size times the gradient.
"""

from __future__ import annotations

import torch


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.allreduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.allreduce_(grad.clone()), None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.allgather_cat(x, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reducescatter_sum(grad, dim=ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return group.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return ctx.group.all_to_all(grad.contiguous(), concat_dim, split_dim), None, None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.allreduce_(grad.clone()), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return group.allgather_cat(x.contiguous(), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.n
        return grad.narrow(ctx.dim, ctx.group.rank * n, n).contiguous(), None, None


class _SumOfRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.allreduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a new tensor); the
    backward all-reduces (SUM) the cotangent."""
    return _AllReduceSum.apply(x, group)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    backward sums the cotangent over the ranks and hands each its block
    (a reduce-scatter)."""
    return _AllGatherCat.apply(x, group, dim % x.dim())


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``x`` cut into even blocks along ``split_dim``, block j to rank j,
    the received blocks concatenated along ``concat_dim`` in rank order
    (``lax.all_to_all(..., tiled=True)``); the backward is the inverse
    all-to-all of the cotangent."""
    return _AllToAll.apply(x, group, split_dim % x.dim(), concat_dim % x.dim())


def sum_of_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` summed (a new tensor), for a value every rank then
    holds and differentiates alike, such as a loss each rank computes a
    term of: the backward hands each rank its cotangent unchanged, the
    gradient of the sum by its own term. (:func:`all_reduce_sum` would
    all-reduce the cotangent too and, since every rank seeds one, make each
    gradient world-size times too large.)"""
    return _SumOfRanks.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "f": ``x`` itself forward; the backward sums the
    cotangent over the ranks of ``group``. For a tensor every rank holds
    alike entering a region split over the group."""
    return _CopyToGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    backward hands each rank its own slice of its cotangent. For a
    downstream every rank of ``group`` computes alike (see the module
    docstring)."""
    return _GatherFromGroup.apply(x, group, dim % x.dim())
