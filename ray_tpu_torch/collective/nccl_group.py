"""Card collectives over NCCL: the port of ray_tpu/collective/xla_group.py.

``NcclGroup`` is the counterpart of the reference's ``XlaGroup``, the
tensor fast path: CUDA tensors only (a host operand raises; ``GlooGroup``
is the host backend), over its own ``new_group(backend="nccl")``.

- allreduce: SUM, MIN and MAX (PRODUCT raises, as the reference's does:
  it has no XLA collective);
- allgather concatenates the ranks' tensors along dim 0, as the
  reference's tiled ``all_gather``;
- reducescatter: SUM over a leading dimension the world size divides;
- broadcast, and send / recv as NCCL point-to-point;
- in a quantized group, allreduce, allgather and reducescatter of a float
  tensor run the reference's programs (:func:`quantized_allreduce`,
  :func:`quantized_allgather`, :func:`quantized_reducescatter`): quantize on
  the card, all_gather the int8 codes and the f32 scales, dequantize, sum in
  f32, cast. The error-feedback residual stays on the card. They are
  functions over any process group, so the CPU tests run the same code
  through gloo;
- ``allreduce_async`` launches the op on the card and returns a
  :class:`~ray_tpu_torch.collective.scheduler.DeviceHandle`: no helper
  thread, as the reference's jit dispatch needs none.

NCCL refuses two ranks on one card ("Duplicate GPU detected"), and so does
the port, before any process group is made: :func:`check_distinct_cards`.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .._internal.quantization import (
    dequantize_torch,
    ef_quantize_torch,
    is_quantizable,
    quantize_torch,
    quantized_wire_nbytes,
)
from .base import BaseGroup, ReduceOp, RingShift, ring_exchange, tensor_nbytes

_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX}


def check_distinct_cards(cards: Sequence[Optional[int]]) -> None:
    """Refuse NCCL for ranks that share a card (or sit on none)."""
    if any(c is None for c in cards):
        raise ValueError('backend="nccl" needs every rank on a card; use backend="gloo" '
                         "for ranks on the CPU")
    seen = {}
    for rank, card in enumerate(cards):
        if card in seen:
            raise ValueError(
                f'backend="nccl" cannot run ranks {seen[card]} and {rank} on one card '
                f"(cuda:{card}): NCCL needs a card per rank. Use backend=\"gloo\" for "
                "ranks that share a card"
            )
        seen[card] = rank


def _all_gather_tensor(out, x, group, async_op=False):
    """``all_gather_single`` where torch has it, else its older name."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    return fn(out, x, group=group, async_op=async_op)


def _gather_codes(q, scales, group):
    """Every rank's codes and scales, stacked: (w, n_blocks, block), (w, n_blocks)."""
    w = dist.get_world_size(group)
    # concatenated outputs (gloo takes no stacked form), viewed stacked
    qg = q.new_empty((w * q.shape[0], *q.shape[1:]))
    sg = scales.new_empty((w * scales.shape[0],))
    _all_gather_tensor(qg, q, group)
    _all_gather_tensor(sg, scales, group)
    return qg.view(w, *q.shape), sg.view(w, *scales.shape)


def quantized_allreduce(x: torch.Tensor, residual: Optional[torch.Tensor], block: int,
                        group) -> tuple:
    """The reference's ``_qallreduce``: ``comp = x + residual`` in f32,
    quantize, all_gather codes and scales, dequantize every rank's, sum them
    in f32, cast to ``x.dtype``. Returns (sum, new residual ``comp -
    dequantize(own codes)``)."""
    comp, q, scales, new_residual = ef_quantize_torch(x, residual, block)
    qg, sg = _gather_codes(q, scales, group)
    total = dequantize_torch(qg, sg, comp.shape, torch.float32).sum(dim=0)
    return total.to(x.dtype), new_residual


def quantized_allgather(x: torch.Tensor, block: int, group) -> torch.Tensor:
    """The reference's ``_qallgather``: every rank's tensor through the
    int8 codec (no feedback), concatenated along dim 0."""
    q, scales = quantize_torch(x, block)
    qg, sg = _gather_codes(q, scales, group)
    out = dequantize_torch(qg, sg, x.shape, x.dtype)
    return out.reshape((-1,) + tuple(x.shape[1:]))


def quantized_reducescatter(x: torch.Tensor, residual: Optional[torch.Tensor], block: int,
                            group) -> tuple:
    """The reference's ``_qreducescatter``: :func:`quantized_allreduce`'s
    sum, of which this rank keeps its slice of the leading dimension.
    Returns (shard, new residual of the full tensor)."""
    comp, q, scales, new_residual = ef_quantize_torch(x, residual, block)
    qg, sg = _gather_codes(q, scales, group)
    total = dequantize_torch(qg, sg, comp.shape, torch.float32).sum(dim=0)
    n = total.shape[0] // dist.get_world_size(group)
    rank = dist.get_rank(group)
    return total[rank * n:(rank + 1) * n].to(x.dtype), new_residual


def _synchronize():
    event = torch.cuda.Event()
    event.record()
    event.synchronize()


class NcclGroup(BaseGroup):
    backend = "nccl"

    def __init__(self, world_size: int, rank: int, group_name: str, *,
                 process_group=None, epoch: int = 0, quantized: bool = False,
                 quant_block: int = 0, store=None, parent_group: Optional[str] = None):
        super().__init__(world_size, rank, group_name, epoch=epoch,
                         quantized=quantized, quant_block=quant_block, store=store,
                         parent_group=parent_group)
        self.process_group = (
            process_group if process_group is not None else dist.new_group(backend="nccl")
        )
        got = (dist.get_world_size(self.process_group), dist.get_rank(self.process_group))
        if got != (world_size, rank):
            raise ValueError(
                f"group {group_name!r}: (world_size, rank) = {(world_size, rank)} but "
                f"the process group has {got}"
            )

    def _operand(self, tensor, op: Optional[ReduceOp] = None) -> torch.Tensor:
        self.check_abort()
        if not isinstance(tensor, torch.Tensor) or not tensor.is_cuda:
            where = tensor.device if isinstance(tensor, torch.Tensor) else type(tensor).__name__
            raise TypeError(
                f"NcclGroup takes CUDA tensors, got one on {where}; "
                'host values go through a backend="gloo" group'
            )
        if op is ReduceOp.PRODUCT:
            raise NotImplementedError("PRODUCT has no NCCL path here; use the gloo backend")
        return tensor.contiguous()

    def _use_quantized(self, x: torch.Tensor, op: Optional[ReduceOp] = None) -> bool:
        """Float operands of SUM (and of allgather); MIN and MAX stay exact."""
        return self.quantized and is_quantizable(x) and op in (None, ReduceOp.SUM)

    def _residual(self, op_name: str, x: torch.Tensor):
        key = (op_name, tuple(x.shape), str(x.dtype))
        return key, self._ef_residuals.get(key)

    def _wire(self, x: torch.Tensor) -> int:
        return quantized_wire_nbytes(x.numel(), self.quant_block)

    def _launch_allreduce(self, x: torch.Tensor, op: ReduceOp, async_op: bool):
        """(result, works, wire bytes or None)."""
        if self._use_quantized(x, op):
            key, res = self._residual("allreduce", x)
            out, self._ef_residuals[key] = quantized_allreduce(
                x, res, self.quant_block, self.process_group)
            return out, [], self._wire(x)
        out = x.clone()
        work = dist.all_reduce(out, op=_DIST_OPS[op], group=self.process_group,
                               async_op=async_op)
        return out, [work] if async_op else [], None

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        x = self._operand(tensor, op)
        start = time.perf_counter()
        out, _, wire = self._launch_allreduce(x, op, async_op=False)
        _synchronize()
        self._record_op("allreduce", tensor_nbytes(x), start, wire_nbytes=wire)
        return out

    def allreduce_async(self, tensor, op: ReduceOp = ReduceOp.SUM):
        from .scheduler import DeviceHandle

        x = self._operand(tensor, op)
        nbytes = tensor_nbytes(x)
        out, works, wire = self._launch_allreduce(x, op, async_op=True)

        def on_ready(latency_s: float):
            from ..util import metrics

            metrics.record_collective("allreduce", self.backend, self.group_name,
                                      nbytes, latency_s, wire_nbytes=wire)

        return DeviceHandle(out, works, on_ready=on_ready, group=self)

    def allgather(self, tensor) -> torch.Tensor:
        x = self._operand(tensor)
        start = time.perf_counter()
        if self._use_quantized(x):
            out = quantized_allgather(x, self.quant_block, self.process_group)
            wire = self._wire(x)
        else:
            out = x.new_empty((self.world_size * x.shape[0], *x.shape[1:]))
            _all_gather_tensor(out, x, self.process_group)
            wire = None
        _synchronize()
        self._record_op("allgather", tensor_nbytes(x), start, wire_nbytes=wire)
        return out

    # -- a model's collectives (tensor parallelism) ------------------------
    # No abort-plane read, no clone and no wait: NCCL orders each op on the
    # current stream, so the next kernel reads its result and the host runs
    # ahead. The recorded latency is the launch's host time. Full width
    # whatever ``quantized`` says: a forward pass carries no residual.

    def allreduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` summed over the ranks, in place; returns it."""
        start = time.perf_counter()
        dist.all_reduce(tensor, group=self.process_group)
        self._record_op("allreduce", tensor_nbytes(tensor), start)
        return tensor

    def allgather_cat(self, tensor: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``tensor`` concatenated along ``dim``, in rank order."""
        start = time.perf_counter()
        x = tensor.contiguous()
        out = x.new_empty((self.world_size * x.shape[0], *x.shape[1:]))
        _all_gather_tensor(out, x, self.process_group)
        self._record_op("allgather", tensor_nbytes(x), start)
        return torch.cat(out.chunk(self.world_size), dim=dim)

    def reducescatter_sum(self, tensor: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``tensor`` summed, and this rank's even block of it
        along ``dim``: the transpose of :meth:`allgather_cat`."""
        start = time.perf_counter()
        if tensor.shape[dim] % self.world_size:
            raise ValueError(f"reducescatter_sum over {self.world_size} ranks needs a dim "
                             f"they divide, got {tensor.shape[dim]}")
        x = tensor.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // self.world_size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=self.process_group)
        self._record_op("reducescatter", tensor_nbytes(tensor), start)
        return out.movedim(0, dim)

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
        parts = [p.contiguous() for p in tensor.chunk(self.world_size, dim=split_dim)]
        out = [torch.empty_like(p) for p in parts]
        dist.all_to_all(out, parts, group=self.process_group)
        self._record_op("all_to_all", tensor_nbytes(tensor), start)
        return torch.cat(out, dim=concat_dim)

    def ring_shift(self, tensors) -> RingShift:
        """Post the ring's hop: ``tensors`` go to rank + 1, and tensors of
        their shapes and dtypes come from rank - 1, in one NCCL group (a
        blocking send / recv ring would deadlock). ``wait()`` orders the
        current stream after it; the host does not wait. One rank receives
        its own tensors."""
        start = time.perf_counter()
        send = [t.contiguous() for t in tensors]
        nbytes = sum(tensor_nbytes(t) for t in send)
        if self.world_size == 1:
            return RingShift(self, send, [], [None] * len(send), nbytes, start)
        recv = [torch.empty_like(x) for x in send]
        works = ring_exchange(self.process_group, send, recv)
        return RingShift(self, recv, works, [None] * len(send), nbytes, start)

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        if op is not ReduceOp.SUM:
            raise NotImplementedError("reducescatter reduces with SUM only; use the gloo backend")
        x = self._operand(tensor, op)
        if x.shape[0] % self.world_size:
            raise ValueError(
                f"reducescatter over {self.world_size} ranks needs a leading dimension "
                f"they divide, got {x.shape[0]}; the gloo backend splits unevenly"
            )
        start = time.perf_counter()
        if self._use_quantized(x, op):
            key, res = self._residual("reducescatter", x)
            out, self._ef_residuals[key] = quantized_reducescatter(
                x, res, self.quant_block, self.process_group)
            wire = self._wire(x)
        else:
            out = x.new_empty((x.shape[0] // self.world_size, *x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, group=self.process_group)
            wire = None
        _synchronize()
        self._record_op("reducescatter", tensor_nbytes(x), start, wire_nbytes=wire)
        return out

    def broadcast(self, tensor, src_rank: int = 0):
        """``src_rank``'s tensor on every rank; every rank passes a tensor
        of its shape and dtype, as NCCL needs."""
        x = self._operand(tensor)
        start = time.perf_counter()
        out = x.clone()
        dist.broadcast(out, src=dist.get_global_rank(self.process_group, src_rank),
                       group=self.process_group)
        _synchronize()
        self._record_op("broadcast", tensor_nbytes(out), start)
        return out

    def send(self, tensor, dst_rank: int):
        """The tensor's shape and dtype go first, so :meth:`recv` needs no
        buffer."""
        x = self._operand(tensor)
        if self.world_size == 1:
            raise ValueError("send in a single-process group has no peer")
        start = time.perf_counter()
        dst = dist.get_global_rank(self.process_group, dst_rank)
        dist.send_object_list([(tuple(x.shape), x.dtype)], dst=dst, group=self.process_group)
        dist.send(x, dst=dst, group=self.process_group)
        self._record_op("send", tensor_nbytes(x), start)

    def recv(self, src_rank: int) -> torch.Tensor:
        self.check_abort()
        if self.world_size == 1:
            raise ValueError("recv in a single-process group has no peer")
        start = time.perf_counter()
        src = dist.get_global_rank(self.process_group, src_rank)
        header: List = [None]
        dist.recv_object_list(header, src=src, group=self.process_group)
        shape, dtype = header[0]
        out = torch.empty(shape, dtype=dtype, device=torch.cuda.current_device())
        dist.recv(out, src=src, group=self.process_group)
        self._record_op("recv", tensor_nbytes(out), start)
        return out

    def barrier(self):
        """A one-element allreduce on the card, waited for."""
        self.check_abort()
        start = time.perf_counter()
        x = torch.zeros(1, device=torch.cuda.current_device())
        dist.all_reduce(x, group=self.process_group)
        _synchronize()
        self._record_op("barrier", 0, start)

    def destroy(self):
        super().destroy()
        dist.destroy_process_group(self.process_group)
