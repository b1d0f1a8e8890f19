"""ray_tpu_torch.collective: the port of ray_tpu.collective.

Groups are registered per process under a name, over the default
``torch.distributed`` process group (``init_process_group`` first), and
the module-level ops call the named group. Three backends:

- ``"nccl"``: :class:`NcclGroup`, CUDA tensors (the reference's ``"xla"``);
- ``"gloo"``: :class:`GlooGroup`, host tensors and Python objects (the
  reference's ``"gcs"`` / ``"cpu"``);
- ``"hier"``: :class:`HierarchicalGroup` (``slice_size=`` required,
  ``intra_backend="gloo"`` or ``"nccl"``): a reduce inside each slice,
  then between the slices' leaders over gloo, then a broadcast inside each
  slice.

``create_collective_group`` over actors is not ported: the port has no
actors yet (ROADMAP).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch.distributed as dist

from ..exceptions import CollectiveAbortedError
from ..util import events as _events
from .base import BaseGroup, ReduceOp, write_abort
from .bucketizer import DEFAULT_BUCKET_BYTES, BucketSpec, GradientBucketizer
from .gloo_group import GlooGroup
from .hierarchical import HierarchicalGroup
from .nccl_group import NcclGroup
from .scheduler import AsyncHandle, GradientReduceScheduler, PendingReduce

_groups: Dict[str, BaseGroup] = {}

_BACKENDS = {
    "nccl": NcclGroup,
    "gloo": GlooGroup,
    # two-tier intra-slice / inter-slice composition (requires slice_size=)
    "hier": HierarchicalGroup,
}


def _default_store():
    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: call torch.distributed.init_process_group "
            "before init_collective_group"
        )
    return dist.distributed_c10d._get_default_store()


def init_collective_group(world_size: int, rank: int, backend: str = "nccl",
                          group_name: str = "default", **kwargs) -> BaseGroup:
    """Make and register this rank's member of a group over all the
    default process group's ranks. Every rank calls it, in the same order
    as its other groups (each makes a new process group; a ``"hier"``
    group makes one for each slice, one for the leaders and a flat one).
    ``kwargs`` (``epoch``, ``quantized``, ``quant_block``; ``slice_size``
    and ``intra_backend`` for ``"hier"``) must be alike on every member."""
    store = _default_store()
    if group_name in _groups:
        raise ValueError(f"collective group {group_name!r} already exists")
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {sorted(_BACKENDS)}, got {backend!r}")
    if (world_size, rank) != (dist.get_world_size(), dist.get_rank()):
        raise ValueError(
            f"(world_size, rank) = {(world_size, rank)} but the default process group "
            f"has {(dist.get_world_size(), dist.get_rank())}"
        )
    group = _BACKENDS[backend](world_size, rank, group_name, store=store, **kwargs)
    _groups[group_name] = group
    _events.record_event(
        _events.COLLECTIVE_EPOCH, group=group_name, epoch=group.epoch,
        world_size=world_size, rank=rank, backend=backend, phase="formed",
    )
    return group


def get_group(group_name: str = "default") -> BaseGroup:
    group = _groups.get(group_name)
    if group is None:
        raise ValueError(
            f"no collective group {group_name!r} in this process; call "
            "init_collective_group first"
        )
    return group


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def destroy_collective_group(group_name: str = "default"):
    group = _groups.pop(group_name, None)
    if group is not None:
        group.destroy()


def abort_collective_group(group_name: str = "default", epoch: Optional[int] = None,
                           reason: str = "explicit abort") -> bool:
    """Abort the group's ops on every rank: each op of an epoch <= ``epoch``
    (default: the local member's, else 0), and each wait on one in flight,
    raises :class:`CollectiveAbortedError`. True if this call advanced the
    mark."""
    if epoch is None:
        local = _groups.get(group_name)
        epoch = local.epoch if local is not None else 0
    _events.record_event(_events.COLLECTIVE_EPOCH, group=group_name, epoch=epoch,
                         phase="aborted", reason=reason)
    return write_abort(_default_store(), group_name, epoch)


def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return get_group(group_name).allreduce(tensor, op)


def allgather(tensor, group_name: str = "default"):
    return get_group(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return get_group(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(tensor, src_rank)


def send(tensor, dst_rank: int, group_name: str = "default"):
    return get_group(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    return get_group(group_name).recv(src_rank)


def barrier(group_name: str = "default"):
    return get_group(group_name).barrier()


__all__ = [
    "BaseGroup", "ReduceOp", "GlooGroup", "NcclGroup", "HierarchicalGroup",
    "AsyncHandle", "PendingReduce", "GradientReduceScheduler",
    "GradientBucketizer", "BucketSpec", "DEFAULT_BUCKET_BYTES",
    "CollectiveAbortedError",
    "init_collective_group", "destroy_collective_group", "abort_collective_group",
    "get_group", "is_group_initialized",
    "allreduce", "allgather", "reducescatter", "broadcast",
    "send", "recv", "barrier",
]
