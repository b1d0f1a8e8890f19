"""Hierarchical multi-slice collective group: the port of
ray_tpu/collective/hierarchical.py.

A cluster's network is not flat: the links inside a node (NVLink between
its cards) are an order of magnitude faster than the network between
nodes. A flat W-rank reduce puts every rank's full payload on the slow
tier; the hierarchical schedule ships it twice over the fast tier and once
over the slow one:

    1. intra-slice reduce    (all ``slice_size`` members of each slice)
    2. inter-slice reduce    (one leader per slice, ``num_slices`` ranks)
    3. intra-slice broadcast (the leader fans the global result back out)

:class:`HierarchicalGroup` composes those phases from the port's groups
behind the unchanged :class:`~ray_tpu_torch.collective.base.BaseGroup`
interface: inside a slice an ``NcclGroup`` (``intra_backend="nccl"``, the
reference's ``"xla"``: CUDA tensors, a card a rank) or a ``GlooGroup``
(``"gloo"``, the reference's ``"gcs"``: host values, emulated topologies
in tests), between the slice leaders a ``GlooGroup``, and a flat
world-spanning ``GlooGroup`` for point-to-point. The overlapped scheduler
(collective/scheduler.py) therefore drives it as a flat group:
``allreduce_async`` takes the dispatcher-thread default, and each bucket's
three phases run behind one another in FIFO order.

Forming the sub-groups: the reference's meet by name in the GCS and only
their members make them. ``torch.distributed.new_group`` is collective over
the whole default group, so every rank forms every sub-group (each slice's,
the leaders', the flat one), in that order, and keeps those it is in;
:meth:`HierarchicalGroup.form` does the same for a group over some of the
default group's ranks, every process of the default group calling it.

Naming and abort contract: sub-groups are ``<name>:s<slice>`` (intra),
``<name>:x`` (inter leaders) and ``<name>:p2p`` (point-to-point), each
with ``parent_group=<name>``, so an abort written against the logical
name raises in any phase, on any member (each sub-group's ``check_abort``
reads the parent's mark too), and a caller waiting on an async op of the
group is released by it. Metrics are recorded by the sub-groups under
their own names; the hierarchical wrapper records nothing itself, so
``collective_summary()`` never counts a phase twice.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .base import BaseGroup, ReduceOp
from .gloo_group import GlooGroup

#: intra-slice backend choices; "nccl" needs a card a rank
_INTRA_BACKENDS = ("gloo", "nccl")


def _validate(world_size: int, slice_size: int, intra_backend: str) -> None:
    if slice_size <= 0:
        raise ValueError(f"slice_size must be positive, got {slice_size}")
    if world_size % slice_size != 0:
        raise ValueError(
            f"world_size={world_size} not divisible by "
            f"slice_size={slice_size}"
        )
    if intra_backend not in _INTRA_BACKENDS:
        raise ValueError(
            f"intra_backend must be one of {_INTRA_BACKENDS}, "
            f"got {intra_backend!r}"
        )


def _process_groups(world: List[int], slice_size: int, intra_backend: str):
    """(each slice's process group, the leaders', the flat one) over the
    default group's ranks ``world`` (member i is ``world[i]``): formed by
    every process of the default group, in this order, whether or not it
    is a member (a non-member's handles are placeholders)."""
    intra = [dist.new_group(ranks=world[s:s + slice_size], backend=intra_backend)
             for s in range(0, len(world), slice_size)]
    inter = dist.new_group(ranks=world[::slice_size], backend="gloo")
    return intra, inter, dist.new_group(ranks=world, backend="gloo")


class HierarchicalGroup(BaseGroup):
    backend = "hier"

    def __init__(
        self,
        world_size: int,
        rank: int,
        group_name: str,
        *,
        slice_size: int,
        epoch: int = 0,
        quantized: bool = False,
        quant_block: int = 0,
        intra_backend: str = "gloo",
        store=None,
        process_groups=None,
    ):
        super().__init__(world_size, rank, group_name, epoch=epoch,
                         quantized=quantized, quant_block=quant_block, store=store)
        _validate(world_size, slice_size, intra_backend)
        self.slice_size = slice_size
        self.num_slices = world_size // slice_size
        self.slice_id = rank // slice_size
        self.intra_rank = rank % slice_size
        self.is_leader = self.intra_rank == 0
        self.intra_backend = intra_backend
        if process_groups is None:  # every rank of the default group is a member
            process_groups = _process_groups(list(range(world_size)), slice_size, intra_backend)
        intra_pgs, inter_pg, p2p_pg = process_groups

        sub = dict(epoch=epoch, quantized=quantized, quant_block=quant_block, store=store,
                   parent_group=group_name)
        intra_cls = GlooGroup
        if intra_backend == "nccl":
            from .nccl_group import NcclGroup

            intra_cls = NcclGroup
        self._intra = intra_cls(slice_size, self.intra_rank, f"{group_name}:s{self.slice_id}",
                                process_group=intra_pgs[self.slice_id], **sub)
        # the inter-slice tier is the slow tier: host rendezvous over gloo,
        # leaders only (non-leaders never touch it)
        self._inter: Optional[GlooGroup] = None
        if self.is_leader:
            self._inter = GlooGroup(self.num_slices, self.slice_id, f"{group_name}:x",
                                    process_group=inter_pg, **sub)
        # point-to-point has no hierarchy to exploit; its own group keeps its
        # sequence out of the phase groups'
        self._p2p: Optional[GlooGroup] = GlooGroup(
            world_size, rank, f"{group_name}:p2p", process_group=p2p_pg,
            epoch=epoch, store=store, parent_group=group_name)

    @classmethod
    def form(cls, world_ranks: Sequence[int], group_name: str, *, slice_size: int,
             intra_backend: str = "gloo", **kwargs) -> Optional["HierarchicalGroup"]:
        """A group over some ranks of the default group: its member i is
        default rank ``world_ranks[i]``, in ascending order (a process
        group ranks its members so). Every process of the default group
        calls it, with the same arguments and in the same order as its other
        calls that form groups (``new_group`` is collective over the whole
        default group); a process outside ``world_ranks`` gets None."""
        world = [int(r) for r in world_ranks]
        if world != sorted(set(world)):
            raise ValueError(f"world_ranks must ascend without repeats, got {world}")
        _validate(len(world), slice_size, intra_backend)
        pgs = _process_groups(world, slice_size, intra_backend)
        me = dist.get_rank()
        if me not in world:
            return None
        return cls(len(world), world.index(me), group_name, slice_size=slice_size,
                   intra_backend=intra_backend, process_groups=pgs, **kwargs)

    # -- phase composition -------------------------------------------------

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """reduce-within, reduce-across, fan back out. Only the slice sums
        (num_slices contributions, not world_size) cross the slow tier."""
        partial = self._intra.allreduce(tensor, op)
        if self.num_slices == 1:
            return partial
        if self.is_leader:
            total = self._inter.allreduce(partial, op)
        else:
            total = partial  # placeholder; overwritten by the fan-out
        return self._intra.broadcast(total, src_rank=0)

    def allgather(self, tensor) -> List[Any]:
        """Gather within the slice, concatenate slice lists across leaders,
        fan the world-ordered list back out (global rank order: slices by
        slice_id, members by intra rank, exactly rank = slice*size+intra)."""
        if self.intra_backend == "nccl":
            return self._allgather_on_cards(tensor)
        local = self._intra.allgather(tensor)
        if self.num_slices == 1:
            return list(local)
        if self.is_leader:
            nested = self._inter.allgather(list(local))
            flat = [item for slice_items in nested for item in slice_items]
        else:
            flat = None
        return list(self._intra.broadcast(flat, src_rank=0))

    def _allgather_on_cards(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """The NCCL slice's form: a card group gathers and broadcasts
        tensors, not lists, so the slices' stacks travel whole."""
        local = self._intra.allgather(tensor)  # (slice_size * rows, ...)
        world = local
        if self.num_slices > 1:
            if self.is_leader:
                world = torch.cat(self._inter.allgather(local))
            else:
                world = local.new_empty((self.world_size * tensor.shape[0], *tensor.shape[1:]))
            world = self._intra.broadcast(world, src_rank=0)
        return list(world.chunk(self.world_size))

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """The allreduce, then this rank's ``np.array_split`` shard of the
        leading dimension (uneven lengths allowed)."""
        reduced = self.allreduce(tensor, op)
        if isinstance(reduced, torch.Tensor):
            return torch.tensor_split(reduced, self.world_size, dim=0)[self.rank]
        return np.array_split(np.asarray(reduced), self.world_size, axis=0)[self.rank]

    def broadcast(self, tensor, src_rank: int = 0):
        src_slice, src_intra = divmod(src_rank, self.slice_size)
        value = tensor
        if self.slice_id == src_slice and src_intra != 0:
            # hoist the payload to the source slice's leader first
            value = self._intra.broadcast(value, src_rank=src_intra)
        if self.num_slices > 1 and self.is_leader:
            value = self._inter.broadcast(value, src_rank=src_slice)
        if self.slice_size > 1:
            value = self._intra.broadcast(value, src_rank=0)
        return value

    def barrier(self):
        self._intra.barrier()
        if self.num_slices > 1:
            if self.is_leader:
                self._inter.barrier()
            # second intra pass so non-leaders also wait out the slow tier
            self._intra.barrier()

    # -- point-to-point ----------------------------------------------------

    def send(self, tensor, dst_rank: int):
        return self._p2p.send(tensor, dst_rank)

    def recv(self, src_rank: int):
        return self._p2p.recv(src_rank)

    def destroy(self):
        super().destroy()
        for sub in (self._intra, self._inter, self._p2p):
            if sub is not None:
                sub.destroy()
        self._intra = self._inter = self._p2p = None
