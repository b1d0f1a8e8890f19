"""Host collectives over gloo: the port of ray_tpu/collective/cpu_group.py.

``GlooGroup`` is the counterpart of the reference's ``GcsStoreGroup``, the
gloo role: host tensors and arbitrary Python objects, for the control plane
and for ranks that share a card. It runs over its own
``new_group(backend="gloo")``, so its ops never interleave with the default
group's or another group's.

Reductions follow the reference's ``_allreduce_impl`` step for step: every
rank receives every rank's contribution and reduces them in rank order
(``np.sum(axis=0)`` adds the rows in sequence), so each rank holds the same
bits as the reference. In a quantized group a float SUM ships as
:class:`~ray_tpu_torch._internal.quantization.QuantizedArray` codes with
error feedback: per-rank ``ef_quantize_np`` with the carried residual, each
rank's codes dequantized to f32, summed in rank order, cast once.
MIN, MAX and PRODUCT ship full width in every group, so they stay exact
(the reference's ``GcsStoreGroup`` codes them too, without feedback; its
``XlaGroup`` does not).

A CUDA operand is copied to the host, exchanged and reduced there, and the
result is returned on the operand's device: host staging is this backend's
nature, as the reference's ``np.asarray(tensor)`` is. A numpy array or a
Python number comes back as a numpy array.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._internal.quantization import (
    QuantizedArray,
    dequantize_np,
    ef_quantize_np,
    is_quantizable,
    quantize_np,
)
from .base import BaseGroup, ReduceOp, RingShift, ring_exchange, tensor_nbytes

_REDUCERS = {
    ReduceOp.SUM: torch.Tensor.add_,
    ReduceOp.PRODUCT: torch.Tensor.mul_,
    ReduceOp.MIN: lambda acc, x: torch.minimum(acc, x, out=acc),
    ReduceOp.MAX: lambda acc, x: torch.maximum(acc, x, out=acc),
}


def reduce_in_rank_order(parts: List[torch.Tensor], op: ReduceOp) -> torch.Tensor:
    """``parts[0] op parts[1] op ...``, left to right, in their dtype."""
    acc = parts[0].clone()
    for x in parts[1:]:
        _REDUCERS[op](acc, x)
    return acc


def _host(value):
    """(a CPU tensor of ``value``, the device to return it on or None for a
    numpy result)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu").contiguous(), value.device
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value))), None


def _back(t: torch.Tensor, device):
    return t.numpy() if device is None else t.to(device)


def _staged(value):
    """A CUDA tensor as a host copy, anything else as it is (objects)."""
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        return value.detach().to("cpu")
    return value


class GlooGroup(BaseGroup):
    backend = "gloo"

    def __init__(self, world_size: int, rank: int, group_name: str, *,
                 process_group=None, epoch: int = 0, quantized: bool = False,
                 quant_block: int = 0, store=None):
        super().__init__(world_size, rank, group_name, epoch=epoch,
                         quantized=quantized, quant_block=quant_block, store=store)
        self.process_group = (
            process_group if process_group is not None else dist.new_group(backend="gloo")
        )
        got = (dist.get_world_size(self.process_group), dist.get_rank(self.process_group))
        if got != (world_size, rank):
            raise ValueError(
                f"group {group_name!r}: (world_size, rank) = {(world_size, rank)} but "
                f"the process group has {got}"
            )

    def _global(self, rank: int) -> int:
        return dist.get_global_rank(self.process_group, rank)

    def _gather_objects(self, obj) -> List[Any]:
        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.process_group)
        return out

    def _allreduce_impl(self, x: torch.Tensor, op: ReduceOp, ef_op: str):
        """Exchange and reduce a host tensor; (reduced, wire bytes or None
        for full width)."""
        if self.quantized and op is ReduceOp.SUM and is_quantizable(x):
            key = (ef_op, tuple(x.shape), str(x.dtype))
            qa, self._ef_residuals[key] = ef_quantize_np(
                x, self._ef_residuals.get(key), self.quant_block
            )
            parts = [dequantize_np(v, dtype="float32") for v in self._gather_objects(qa)]
            return reduce_in_rank_order(parts, op).to(x.dtype), qa.wire_nbytes
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.process_group)
        return reduce_in_rank_order(parts, op), None

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        self.check_abort()
        start = time.perf_counter()
        x, device = _host(tensor)
        out, wire = self._allreduce_impl(x, op, "allreduce")
        self._record_op("allreduce", tensor_nbytes(out), start, wire_nbytes=wire)
        return _back(out, device)

    def allgather(self, tensor) -> List[Any]:
        """Every rank's value, in rank order: tensors (a CUDA one staged
        through the host and returned on its device) or any picklable
        object, unchanged. A quantized group codes a float tensor, without
        feedback (nothing accumulates), and decodes every entry."""
        self.check_abort()
        start = time.perf_counter()
        device = tensor.device if isinstance(tensor, torch.Tensor) else None
        payload, wire = _staged(tensor), None
        if self.quantized and is_quantizable(tensor):
            payload = quantize_np(payload, self.quant_block)
            wire = payload.wire_nbytes
        out = [
            dequantize_np(v) if isinstance(v, QuantizedArray) else v
            for v in self._gather_objects(payload)
        ]
        if device is not None:
            out = [v.to(device) if isinstance(v, torch.Tensor) else v for v in out]
        self._record_op("allgather", tensor_nbytes(tensor), start, wire_nbytes=wire)
        return out

    # -- a model's collectives (tensor parallelism) ------------------------
    # Full width with no abort-plane read; a CUDA operand is staged through
    # the host, as every op of this backend's.

    def _gather_host(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        x, _ = _host(tensor)
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.process_group)
        return parts

    def allreduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` summed over the ranks in rank order, in place; returns
        it."""
        start = time.perf_counter()
        tensor.copy_(reduce_in_rank_order(self._gather_host(tensor), ReduceOp.SUM))
        self._record_op("allreduce", tensor_nbytes(tensor), start)
        return tensor

    def allgather_cat(self, tensor: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``tensor`` concatenated along ``dim``, in rank order."""
        start = time.perf_counter()
        out = torch.cat(self._gather_host(tensor), dim=dim).to(tensor.device)
        self._record_op("allgather", tensor_nbytes(tensor), start)
        return out

    def reducescatter_sum(self, tensor: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``tensor`` summed in rank order, and this rank's even
        block of it along ``dim``: the transpose of :meth:`allgather_cat`.
        Each rank receives only the ranks' blocks of its own block (point to
        point) and adds them in rank order."""
        start = time.perf_counter()
        if tensor.shape[dim] % self.world_size:
            raise ValueError(f"reducescatter_sum over {self.world_size} ranks needs a dim "
                             f"they divide, got {tensor.shape[dim]}")
        x, _ = _host(tensor)
        parts = [p.contiguous() for p in x.chunk(self.world_size, dim=dim)]
        out = reduce_in_rank_order(self._exchange(parts), ReduceOp.SUM).to(tensor.device)
        self._record_op("reducescatter", tensor_nbytes(tensor), start)
        return out

    def _exchange(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """``parts[j]`` sent to rank j; the blocks received from the ranks,
        in rank order (this rank's own in its place), point to point: not
        every build's gloo has an all-to-all."""
        out = [parts[j] if j == self.rank else torch.empty_like(parts[self.rank])
               for j in range(self.world_size)]
        ops = []
        for j in range(self.world_size):
            if j != self.rank:
                peer = self._global(j)
                ops.append(dist.P2POp(dist.isend, parts[j], peer, self.process_group))
                ops.append(dist.P2POp(dist.irecv, out[j], peer, self.process_group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        return out

    def all_to_all(self, tensor: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``tensor`` cut into world-size even blocks along ``split_dim``,
        block j sent to rank j, and the blocks received from the ranks
        concatenated along ``concat_dim`` in rank order (``lax.all_to_all``
        with ``tiled=True``)."""
        start = time.perf_counter()
        if tensor.shape[split_dim] % self.world_size:
            raise ValueError(f"all_to_all over {self.world_size} ranks needs a dim they "
                             f"divide, got {tensor.shape[split_dim]}")
        x, _ = _host(tensor)
        parts = [p.contiguous() for p in x.chunk(self.world_size, dim=split_dim)]
        out = self._exchange(parts)
        self._record_op("all_to_all", tensor_nbytes(tensor), start)
        return torch.cat(out, dim=concat_dim).to(tensor.device)

    def ring_shift(self, tensors) -> RingShift:
        """Post the ring's hop: ``tensors`` go to rank + 1, and tensors of
        their shapes and dtypes come from rank - 1, all at once (a blocking
        send / recv ring would deadlock). CUDA operands are copied to the
        host here and the received ones back to their devices at
        ``wait()``. One rank receives its own tensors."""
        start = time.perf_counter()
        nbytes = sum(tensor_nbytes(t) for t in tensors)
        if self.world_size == 1:
            return RingShift(self, list(tensors), [], [None] * len(tensors), nbytes, start)
        send = [_host(t)[0] for t in tensors]
        recv = [torch.empty_like(x) for x in send]
        works = ring_exchange(self.process_group, send, recv)
        devices = [None if t.device.type == "cpu" else t.device for t in tensors]
        return RingShift(self, recv, works, devices, nbytes, start)

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """The allreduce, then this rank's ``np.array_split`` shard of the
        leading dimension (uneven lengths allowed: the first ``n % world``
        shards are one row longer)."""
        self.check_abort()
        start = time.perf_counter()
        x, device = _host(tensor)
        reduced, wire = self._allreduce_impl(x, op, "reducescatter")
        out = torch.tensor_split(reduced, self.world_size, dim=0)[self.rank].clone()
        self._record_op("reducescatter", tensor_nbytes(reduced), start, wire_nbytes=wire)
        return _back(out, device)

    def broadcast(self, tensor, src_rank: int = 0):
        """``src_rank``'s value on every rank: a tensor (returned on the
        caller's device when the caller passed a tensor) or any picklable
        object."""
        self.check_abort()
        start = time.perf_counter()
        box = [_staged(tensor) if self.rank == src_rank else None]
        dist.broadcast_object_list(box, src=self._global(src_rank), group=self.process_group)
        out = box[0]
        if isinstance(tensor, torch.Tensor) and isinstance(out, torch.Tensor):
            out = out.to(tensor.device)
        self._record_op("broadcast", tensor_nbytes(out), start)
        return out

    def send(self, tensor, dst_rank: int):
        self.check_abort()
        start = time.perf_counter()
        dist.send_object_list([_staged(tensor)], dst=self._global(dst_rank),
                              group=self.process_group)
        self._record_op("send", tensor_nbytes(tensor), start)

    def recv(self, src_rank: int):
        self.check_abort()
        start = time.perf_counter()
        box = [None]
        dist.recv_object_list(box, src=self._global(src_rank), group=self.process_group)
        self._record_op("recv", tensor_nbytes(box[0]), start)
        return box[0]

    def barrier(self):
        self.check_abort()
        start = time.perf_counter()
        dist.barrier(group=self.process_group)
        self._record_op("barrier", 0, start)

    def destroy(self):
        super().destroy()
        dist.destroy_process_group(self.process_group)
