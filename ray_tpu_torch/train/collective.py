"""Train-worker collectives: the port of ray_tpu/train/collective.py.

``broadcast_from_rank_zero``, ``barrier``, ``allreduce`` and ``allgather``
carry small host-side values (configs, flags, metrics) over the run's gloo
control group. :func:`reduce_gradients` sums a gradient dict across the
gang over the run's tensor group (NCCL on the card) through the bucketized
:class:`~ray_tpu_torch.collective.GradientReduceScheduler`, built from the
context's knobs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from .. import collective as _collective
from .session import get_context


def _group() -> str:
    name = get_context().collective_group
    if not name:
        raise RuntimeError("no collective group for this training run: it runs one "
                           "worker in the caller's process")
    return name


def broadcast_from_rank_zero(data: Any = None) -> Any:
    """Every worker calls this; all return rank 0's value."""
    return _collective.broadcast(data, src_rank=0, group_name=_group())


def barrier() -> None:
    """Block until every training worker arrives."""
    _collective.barrier(group_name=_group())


def allreduce(value, op=None):
    """Sum (by default) a small host-side value across the workers."""
    kwargs = {} if op is None else {"op": op}
    return _collective.allreduce(value, group_name=_group(), **kwargs)


def allgather(value) -> list:
    return _collective.allgather(value, group_name=_group())


def gradient_scheduler():
    """This run's gradient scheduler over its tensor group, built on first
    use from the context's gang-uniform knobs (overlap, bucket_bytes,
    stale_grad) and cached on the context."""
    from ..collective.bucketizer import DEFAULT_BUCKET_BYTES
    from ..collective.scheduler import GradientReduceScheduler

    ctx = get_context()
    if not ctx.collective_tensor_group:
        raise RuntimeError("no tensor group for this training run: it runs one worker "
                           "in the caller's process")
    if ctx._grad_scheduler is None:
        ctx._grad_scheduler = GradientReduceScheduler(
            _collective.get_group(ctx.collective_tensor_group),
            bucket_bytes=ctx.collective_bucket_bytes or DEFAULT_BUCKET_BYTES,
            overlap=ctx.collective_overlap,
            stale_grad=ctx.collective_stale_grad,
        )
    return ctx._grad_scheduler


def reduce_gradients(grads: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    """Sum a gradient dict across the gang. At ``stale_grad=1``, the
    PREVIOUS step's sum (None on the first step: skip the update)."""
    return gradient_scheduler().step(grads)
