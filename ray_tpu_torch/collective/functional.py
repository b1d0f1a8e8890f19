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
