"""Pipeline parallelism: the port of ray_tpu/parallel/pipeline.py.

GPipe over a ``pp`` group (``Mesh.group("pp")``, or any ``GlooGroup`` /
``NcclGroup``): every rank holds one stage's parameters, and each
microbatch's activation hops to the next rank once a tick over
``n_micro + n_stages - 1`` ticks of fill, steady state and drain. At tick
t rank s runs its stage on microbatch ``t - s``: rank 0 takes it from the
microbatches, every other rank takes what the previous rank sent at tick
t - 1, and the last rank records its output. The output is valid on the
last rank and zeros elsewhere, as in the reference.

The reference is one jitted program: a ``lax.scan`` over the ticks, every
device running its stage at every tick (on the fill's zeros and the
drain's repeats too, whose results nothing reads) and one ``ppermute`` a
tick, and ``jax.grad`` transposes it. The port runs a process per rank
in PyTorch's eager autograd, so:

- a rank runs its stage only at the ticks that carry one of its
  microbatches (``0 <= t - s < n_micro``), and a hop moves only such an
  activation: rank s's send at tick t meets rank s + 1's receive at tick
  t + 1, so every pair of ranks sends and receives in microbatch order and
  a rank only ever waits on a higher rank, whatever the backend (rank 0
  receives nothing, the last rank sends nothing);
- the schedule is one ``torch.autograd.Function`` whose backward is the
  hops' transpose: in reverse tick order the last rank seeds each
  microbatch's cotangent from the output's, every rank backpropagates its
  stage and sends the cotangent of its input to the previous rank, and rank
  0 keeps it as the microbatches' gradient. A Function per hop would not
  do: off the last rank the output is zeros that no stage computed, so a
  loss there would never reach the rank's hops and its backward would
  leave the next rank's cotangents unreceived. Here the returned tensor is
  the Function's output on every rank, so ``loss.backward()`` on every
  rank (each rank's loss reading the returned tensor, as every device runs
  the reference's transposed program) gives each stage's parameter
  gradients and the microbatches' gradient, as ``jax.grad`` through the
  scan and the ``ppermute`` does.

The hops are the group's own ``send`` / ``recv``. The stage's activations
of every microbatch are kept until the backward, as GPipe keeps them.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.utils._pytree as pytree


def stage_index(group) -> int:
    """This rank's pipeline stage: its rank in the ``pp`` group."""
    return 0 if group is None else group.rank


def select_stage_params(stacked_params: Any, group) -> Any:
    """This rank's stage of a pytree of tensors stacked over stages (a
    leading axis of n_stages)."""
    i = stage_index(group)
    return pytree.tree_map(lambda p: p[i], stacked_params)


def _recv(group, src: int, like: torch.Tensor) -> torch.Tensor:
    got = group.recv(src)
    if not isinstance(got, torch.Tensor) or got.shape != like.shape or got.dtype != like.dtype:
        raise RuntimeError(f"pipeline hop: rank {src} sent {getattr(got, 'shape', got)!r}, "
                           f"not a {tuple(like.shape)} {like.dtype} activation")
    return got.to(like.device)


class _GPipe(torch.autograd.Function):
    """The forward schedule, and its transpose as the backward (see the
    module docstring). ``leaves`` are the stage parameters' tensors."""

    @staticmethod
    def forward(ctx, stage_fn, spec, group, microbatches, *leaves):
        n, me = group.world_size, group.rank
        n_micro = microbatches.shape[0]
        ctx.group, ctx.n_micro = group, n_micro
        ctx.like = microbatches[0]
        ctx.needs = [t.requires_grad for t in leaves]
        ctx.ticks = []  # (microbatch, input leaf, parameter leaves, output)
        outputs = torch.zeros_like(microbatches)
        for t in range(n_micro + n - 1):
            m = t - me
            if not 0 <= m < n_micro:
                continue  # no microbatch of this stage at this tick
            x = microbatches[m] if me == 0 else _recv(group, me - 1, ctx.like)
            x = x.detach().requires_grad_(True)
            params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
            with torch.enable_grad():
                y = stage_fn(pytree.tree_unflatten(params, spec), x)
            if y.shape != x.shape or y.dtype != x.dtype:
                raise ValueError(f"stage_fn must keep the activation's shape and dtype: "
                                 f"{tuple(x.shape)} {x.dtype} -> {tuple(y.shape)} {y.dtype}")
            if me < n - 1:
                group.send(y.detach(), me + 1)
            else:
                outputs[m] = y.detach()
            ctx.ticks.append((m, x, params, y))
        return outputs

    @staticmethod
    def backward(ctx, grad_outputs):
        group = ctx.group
        n, me = group.world_size, group.rank
        grads: List[Any] = [None] * len(ctx.needs)
        d_micro = torch.zeros((ctx.n_micro, *ctx.like.shape), dtype=ctx.like.dtype,
                              device=ctx.like.device)
        for m, x, params, y in reversed(ctx.ticks):
            g = grad_outputs[m] if me == n - 1 else _recv(group, me + 1, ctx.like)
            wrt = [x] + [p for p, need in zip(params, ctx.needs) if need]
            got = iter(torch.autograd.grad(y, wrt, g, allow_unused=True))
            dx = next(got)
            for i, need in enumerate(ctx.needs):
                if need:
                    dp = next(got)
                    if dp is not None:
                        grads[i] = dp if grads[i] is None else grads[i] + dp
            dx = torch.zeros_like(x) if dx is None else dx
            if me > 0:
                group.send(dx, me - 1)
            else:
                d_micro[m] = dx
        ctx.ticks = []
        return (None, None, None, d_micro, *grads)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,  # (n_micro, mb_size, ...) alike on every rank
    *,
    group,
) -> torch.Tensor:
    """Run ``y = stage_{n-1}(...stage_0(x))`` for each microbatch over the
    ranks of ``group`` (stage s on its rank s).

    ``stage_fn(stage_params, x) -> y`` must keep the activation's shape and
    dtype (equal widths between stages; pad stages otherwise).
    ``stage_params`` is this rank's stage's pytree of tensors (gradients
    reach those that require them). Every rank passes microbatches of one
    shape and dtype; only rank 0's values are read. Returns (n_micro,
    mb_size, ...) valid on the LAST rank (other ranks hold zeros); sum it
    over the group if every rank needs it. Every rank of the group calls
    it, and under autograd every rank calls ``backward`` on a loss that
    reads the returned tensor (see the module docstring). A group of one
    rank (or None) applies the stage to each microbatch in turn."""
    if group is None or group.world_size == 1:
        return torch.stack([stage_fn(stage_params, x) for x in microbatches])
    leaves, spec = pytree.tree_flatten(stage_params)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError("stage_params must be a pytree of tensors")
    return _GPipe.apply(stage_fn, spec, group, microbatches, *leaves)
