"""Differentiable collectives over a group of the port.

It has no reference file: XLA transposes the reference's collectives when it
differentiates a program (an all-reduce's cotangent is all-reduced, an
all-gather's is reduce-scattered), and ``GlooGroup`` / ``NcclGroup`` ops
have no autograd. These two functions give them one, for the sync-BN of
models/resnet.py and the gathered adapters of parallel/fsdp.py.

Both run on the groups' model ops (``allreduce_``, ``allgather_cat``,
``reducescatter_sum``): no store read on the hot path and, over NCCL, no
wait, so the host runs ahead of the card.
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


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a new tensor); the
    backward all-reduces (SUM) the cotangent."""
    return _AllReduceSum.apply(x, group)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    backward sums the cotangent over the ranks and hands each its block
    (a reduce-scatter)."""
    return _AllGatherCat.apply(x, group, dim % x.dim())
