"""Collective group base: the port of ray_tpu/collective/base.py.

One five-op surface (allreduce, allgather, reducescatter, broadcast and
barrier, with send and recv) over two backends: ``GlooGroup`` (host tensors
and Python objects, the reference's ``GcsStoreGroup``) and ``NcclGroup``
(CUDA tensors, the reference's ``XlaGroup``). Every op records its bytes
and wall latency into ``util.metrics.record_collective``. Both groups also
give a model its collectives, ``allreduce_`` (SUM in place),
``allgather_cat`` (concatenated along a dim), ``reducescatter_sum`` (its
transpose: the sum, this rank's block along a dim), ``all_to_all`` (split
along one dim, the ranks' blocks concatenated along another) and
``ring_shift`` (each rank's tensors to the next rank, the previous rank's
back, posted at once: the ring attention's hop), with one contract and
none of the abort plane's store reads (over NCCL, no wait either);
collective/functional.py differentiates the first three and the
all-to-all.

The abort plane: ``abort_collective_group`` writes the aborted epoch under
``colabort:<group>`` in the process group's store, and every op of a group
of that epoch or older, and every wait on one of its async handles, raises
:class:`CollectiveAbortedError` (the reference keeps the same key in its
GCS KV).
"""

from __future__ import annotations

import enum
import time
from abc import ABC, abstractmethod
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._internal.quantization import DEFAULT_BLOCK
from ..exceptions import CollectiveAbortedError


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "prod"
    MIN = "min"
    MAX = "max"


def tensor_nbytes(tensor) -> int:
    """Payload size of a collective operand: ``numel * element_size`` of a
    tensor, ``nbytes`` of a numpy array, and the reference's estimates for
    other objects (8 bytes for a Python number, the length of a bytes
    object, else the size of its numpy form, else 0)."""
    if isinstance(tensor, torch.Tensor):
        return tensor.numel() * tensor.element_size()
    nbytes = getattr(tensor, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(tensor, (bytes, bytearray, memoryview)):
        return len(tensor)
    if isinstance(tensor, (int, float, bool, complex)):
        return 8
    try:
        return int(np.asarray(tensor).nbytes)
    except (TypeError, ValueError):
        return 0


def abort_key(group_name: str) -> str:
    return f"colabort:{group_name}"


def read_abort_epoch(store, group_name: str) -> int:
    """The latest aborted epoch of the group in ``store``, or -1."""
    key = abort_key(group_name)
    if not store.check([key]):
        return -1
    return int(store.get(key).decode())


def write_abort(store, group_name: str, epoch: int) -> bool:
    """Abort every epoch <= ``epoch`` of the group. Monotonic: an earlier
    mark is never lowered. True if this call advanced the mark."""
    if read_abort_epoch(store, group_name) >= epoch:
        return False
    store.set(abort_key(group_name), str(epoch).encode())
    return True


def ring_exchange(process_group, send: Sequence[torch.Tensor],
                  recv: Sequence[torch.Tensor]) -> list:
    """Post ``send`` to the next rank of ``process_group`` and ``recv``
    from the previous one, in one ``batch_isend_irecv``; the works."""
    world = dist.get_world_size(process_group)
    rank = dist.get_rank(process_group)
    nxt = dist.get_global_rank(process_group, (rank + 1) % world)
    prev = dist.get_global_rank(process_group, (rank - 1) % world)
    ops = [dist.P2POp(dist.isend, x, nxt, process_group) for x in send]
    ops += [dist.P2POp(dist.irecv, y, prev, process_group) for y in recv]
    return dist.batch_isend_irecv(ops)


class RingShift:
    """A posted :meth:`ring_shift`. ``wait()`` returns the previous rank's
    tensors, each on the device of the operand it replaces, and records the
    op (its latency from post to the end of the wait). Over gloo the wait
    blocks the host; over NCCL it only orders the current stream after the
    transfer."""

    def __init__(self, group: "BaseGroup", received: List[torch.Tensor], works: list,
                 devices: List[Optional[torch.device]], nbytes: int, start: float):
        self._group, self._received, self._works = group, received, works
        self._devices, self.nbytes, self._start = devices, nbytes, start

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        out = [r if d is None else r.to(d) for r, d in zip(self._received, self._devices)]
        self._group._record_op("ring_shift", self.nbytes, self._start)
        return out


class BaseGroup(ABC):
    #: backend tag on every recorded metric
    backend = "base"

    def __init__(self, world_size: int, rank: int, group_name: str,
                 epoch: int = 0, quantized: bool = False,
                 quant_block: int = 0, store=None, parent_group: Optional[str] = None):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        #: the logical group this one is a phase of (a hierarchical group's
        #: sub-group): an abort written against it aborts this one too
        self.parent_group = parent_group
        # bumped each time the gang re-forms; an abort targets every epoch
        # up to its own
        self.epoch = epoch
        # int8 transport with error feedback: a float operand of a SUM ships
        # as per-block int8 codes and f32 scales, and the residual of each
        # (op, shape, dtype) is carried into the next round. Part of the
        # group contract: every member sets it alike.
        self.quantized = quantized
        self.quant_block = quant_block or DEFAULT_BLOCK
        self._ef_residuals: dict = {}
        self._async_dispatcher = None
        #: the store that holds the abort mark (None: no abort plane)
        self.store = store

    def check_abort(self):
        """Raise :class:`CollectiveAbortedError` if this group's epoch was
        aborted, under its own name or its parent's. One store read (two
        with a parent); every op calls it before it starts."""
        if self.store is None:
            return
        for name in (self.group_name, self.parent_group):
            if name is not None and read_abort_epoch(self.store, name) >= self.epoch:
                from ..util import metrics

                metrics.record_collective_abort(self.group_name)
                raise CollectiveAbortedError(self.group_name, self.epoch,
                                             "group aborted" if name == self.group_name
                                             else f"parent group {name!r} aborted")

    def _record_op(self, op: str, nbytes: int, start: float,
                   wire_nbytes: Optional[int] = None):
        """Record one finished op: ``nbytes`` is the logical payload,
        ``wire_nbytes`` the coded size where the transport quantizes."""
        from ..util import metrics

        metrics.record_collective(
            op, self.backend, self.group_name, nbytes,
            time.perf_counter() - start, wire_nbytes=wire_nbytes,
        )

    @abstractmethod
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        ...

    def allreduce_async(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """Dispatch an allreduce without blocking; returns an
        :class:`~ray_tpu_torch.collective.scheduler.AsyncHandle` whose
        ``wait()`` gives the reduced tensor. By default the blocking
        ``allreduce`` runs on the group's one dispatcher thread, FIFO, so
        every rank's async ops meet in submission order. ``NcclGroup``
        launches on the card's streams instead."""
        return self._dispatcher().submit(lambda: self.allreduce(tensor, op), self)

    def _dispatcher(self):
        if self._async_dispatcher is None:
            from .scheduler import OpDispatcher

            self._async_dispatcher = OpDispatcher(self.group_name)
        return self._async_dispatcher

    @abstractmethod
    def allgather(self, tensor) -> List[Any]:
        ...

    @abstractmethod
    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """Input: the full tensor on each rank; returns this rank's reduced
        shard."""

    @abstractmethod
    def broadcast(self, tensor, src_rank: int = 0):
        ...

    @abstractmethod
    def send(self, tensor, dst_rank: int):
        ...

    @abstractmethod
    def recv(self, src_rank: int):
        ...

    @abstractmethod
    def barrier(self):
        ...

    def destroy(self):
        if self._async_dispatcher is not None:
            self._async_dispatcher.shutdown()
            self._async_dispatcher = None
