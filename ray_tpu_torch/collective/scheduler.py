"""Overlapped gradient-reduction scheduler: the port of
ray_tpu/collective/scheduler.py, the one scheduling layer both backends sit
behind.

- :class:`AsyncHandle`: what ``allreduce_async`` returns. Dispatch does not
  block; ``wait()`` does, and raises
  :class:`~ray_tpu_torch.exceptions.CollectiveAbortedError` if the group was
  aborted while the op was in flight.
- :class:`OpDispatcher`: one background thread per group for backends whose
  ops block the host (``GlooGroup``). Its FIFO keeps the group's op order
  the same on every rank.
- :class:`DeviceHandle`: an op launched on the card (``NcclGroup``): the
  ``Work`` of an ``async_op=True`` collective, or an op already queued on
  the stream. ``wait()`` is ``work.wait()`` and then a CUDA event
  synchronised on the host, so that the latency recorded covers the
  transfer, as the reference's ``block_until_ready`` does.
- :class:`GradientReduceScheduler`: bucketizes a gradient dict
  (``collective/bucketizer.py``) and dispatches one async allreduce per
  bucket. ``stale_grad=1`` returns the previous step's reduced gradients,
  so this step's reduction runs under the next step's compute.

Every wait records the exposed/overlapped split through
``util.metrics.record_collective_overlap``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from .bucketizer import DEFAULT_BUCKET_BYTES, GradientBucketizer

#: the longest one bucket's wait may take
_HANDLE_TIMEOUT_S = 180.0
#: how often a blocked wait reads the abort mark
_ABORT_POLL_S = 0.25


class AsyncHandle:
    """Completion handle of one async op. After ``wait()``, ``exposed_s`` is
    the wall time the caller blocked and ``overlapped_s`` the rest of the
    op's latency, which ran under the caller's work."""

    def __init__(self):
        self.dispatched_at = time.perf_counter()
        self.completed_at: Optional[float] = None
        self.exposed_s = 0.0
        self.overlapped_s = 0.0

    def done(self) -> bool:
        raise NotImplementedError

    def wait(self, timeout: float = _HANDLE_TIMEOUT_S):
        raise NotImplementedError

    def _split(self, wait_start: float, wait_end: float):
        self.exposed_s = max(0.0, wait_end - wait_start)
        total = (self.completed_at or wait_end) - self.dispatched_at
        self.overlapped_s = max(0.0, total - self.exposed_s)


class CompletedHandle(AsyncHandle):
    """An op that blocked at dispatch (``overlap=False``): all of it was
    exposed."""

    def __init__(self, result: Any, blocked_s: float):
        super().__init__()
        self._result = result
        self.completed_at = self.dispatched_at
        self.exposed_s = max(0.0, blocked_s)

    def done(self) -> bool:
        return True

    def wait(self, timeout: float = _HANDLE_TIMEOUT_S):
        return self._result


class FutureHandle(AsyncHandle):
    """An op completed by the :class:`OpDispatcher`'s thread. ``group``,
    when given, is read for an abort while the caller waits."""

    def __init__(self, group=None):
        super().__init__()
        self._group = group
        self._event = threading.Event()
        self._result: Any = None
        self._exception: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, result: Any = None, exception: Optional[BaseException] = None):
        self._result = result
        self._exception = exception
        self.completed_at = time.perf_counter()
        self._event.set()

    def wait(self, timeout: float = _HANDLE_TIMEOUT_S):
        start = time.perf_counter()
        deadline = start + timeout
        while not self._event.wait(_ABORT_POLL_S):
            if self._group is not None:
                self._group.check_abort()
            if time.perf_counter() > deadline:
                raise TimeoutError("async collective op did not complete")
        self._split(start, time.perf_counter())
        if self._exception is not None:
            raise self._exception
        return self._result


class DeviceHandle(AsyncHandle):
    """An op launched on the card. ``works`` are the ``Work`` objects of
    its ``async_op=True`` collectives (none if the whole op is already
    queued on the current stream); ``on_ready(latency_s)`` records the op's
    metrics at completion, since dispatch must not block. ``group``, when
    given, is read for an abort before the wait."""

    def __init__(self, value: torch.Tensor, works: List[Any] = (),
                 on_ready: Optional[Callable[[float], None]] = None, group=None):
        super().__init__()
        self._value = value
        self._works = list(works)
        self._on_ready = on_ready
        self._group = group
        self._waited = False

    def done(self) -> bool:
        return self._waited or all(w.is_completed() for w in self._works)

    def wait(self, timeout: float = _HANDLE_TIMEOUT_S):
        start = time.perf_counter()
        if not self._waited:
            if self._group is not None:
                self._group.check_abort()
            for w in self._works:
                w.wait()
            if self._value.is_cuda:
                # work.wait() only orders the current stream after the
                # collective; the event makes the host wait for it too
                event = torch.cuda.Event()
                event.record()
                event.synchronize()
            end = time.perf_counter()
            self._waited = True
            self.completed_at = end
            self._split(start, end)
            if self._on_ready is not None:
                self._on_ready(end - self.dispatched_at)
        return self._value


class OpDispatcher:
    """One background thread per group. Ops run strictly FIFO, so as long
    as every rank submits its buckets in the same order, the group's op
    sequence stays aligned across ranks. An exception completes its handle
    exceptionally and the thread moves on."""

    def __init__(self, name: str):
        self._queue: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"col-dispatch:{name}")
        self._thread.start()

    def submit(self, fn: Callable[[], Any], group=None) -> FutureHandle:
        handle = FutureHandle(group)
        self._queue.put((fn, handle))
        return handle

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            fn, handle = item
            try:
                handle._complete(result=fn())
            except BaseException as e:  # noqa: BLE001 - handed to the waiter
                handle._complete(exception=e)

    def shutdown(self, timeout: float = 2.0):
        self._queue.put(None)
        self._thread.join(timeout=timeout)


class PendingReduce:
    """One gradient dict's buckets in flight; ``wait`` returns the reduced
    dict and records the exposed/overlapped split."""

    def __init__(self, handles: List[AsyncHandle], bucketizer: GradientBucketizer,
                 group_name: str):
        self._handles = handles
        self._bucketizer = bucketizer
        self._group_name = group_name

    def done(self) -> bool:
        return all(h.done() for h in self._handles)

    def wait(self) -> Dict[str, torch.Tensor]:
        from ..util import metrics

        results = []
        error: Optional[BaseException] = None
        for h in self._handles:
            try:
                results.append(h.wait())
            except BaseException as e:  # noqa: BLE001 - raised after the drain
                # drain the other handles so no op is left in flight, then
                # raise the first failure
                if error is None:
                    error = e
        exposed = sum(h.exposed_s for h in self._handles)
        overlapped = sum(h.overlapped_s for h in self._handles)
        metrics.record_collective_overlap(self._group_name, exposed, overlapped)
        if error is not None:
            raise error
        return self._bucketizer.unpack(results)


class GradientReduceScheduler:
    """Bucketized gradient allreduce over any group, overlapped or not.

    ``reduce(tree)`` dispatches one async allreduce per bucket and returns a
    :class:`PendingReduce` at once. ``step(tree)`` is the loop's call:

    - ``stale_grad=0``: dispatch and wait; the result is bit for bit that
      of the blocking path;
    - ``stale_grad=1``: the PREVIOUS step's reduced dict (None on the first
      call, where the caller skips the update), leaving this step's buckets
      in flight; :meth:`flush` waits out the last one.

    ``overlap=False`` blocks on each bucket's op at dispatch (the sync
    baseline) behind the same calls.
    """

    def __init__(self, group, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 overlap: bool = True, stale_grad: int = 0):
        if stale_grad not in (0, 1):
            raise ValueError(f"stale_grad must be 0 or 1, got {stale_grad}")
        self.group = group
        self.bucket_bytes = int(bucket_bytes)
        self.overlap = bool(overlap)
        self.stale_grad = int(stale_grad)
        self._bucketizer: Optional[GradientBucketizer] = None
        self._structure_key: Optional[tuple] = None
        self._pending: Optional[PendingReduce] = None

    @staticmethod
    def _structure_of(tree: Mapping[str, torch.Tensor]) -> tuple:
        return tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in tree.items()))

    def bucketizer_for(self, tree: Mapping[str, torch.Tensor]) -> GradientBucketizer:
        """The cached assignment for this structure, rebuilt only when the
        structure changes."""
        key = self._structure_of(tree)
        if self._bucketizer is None or key != self._structure_key:
            self._bucketizer = GradientBucketizer(tree, self.bucket_bytes)
            self._structure_key = key
        return self._bucketizer

    def reduce(self, tree: Mapping[str, torch.Tensor], op=None) -> PendingReduce:
        """Dispatch every bucket's allreduce without waiting for any."""
        from .base import ReduceOp

        reduce_op = op if op is not None else ReduceOp.SUM
        bucketizer = self.bucketizer_for(tree)
        handles: List[AsyncHandle] = []
        for flat in bucketizer.pack(tree):
            if self.overlap:
                handles.append(self.group.allreduce_async(flat, reduce_op))
            else:
                t0 = time.perf_counter()
                out = self.group.allreduce(flat, reduce_op)
                handles.append(CompletedHandle(out, time.perf_counter() - t0))
        return PendingReduce(handles, bucketizer, self.group.group_name)

    def step(self, tree: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        """This step's reduced gradients or, at ``stale_grad=1``, the
        previous step's (None on the first call)."""
        pending = self.reduce(tree)
        if self.stale_grad == 0:
            return pending.wait()
        prev, self._pending = self._pending, pending
        return prev.wait() if prev is not None else None

    def flush(self) -> Optional[Dict[str, torch.Tensor]]:
        """Wait out the delayed tail of the ``stale_grad`` pipeline; its
        reduced dict, or None if nothing was pending."""
        prev, self._pending = self._pending, None
        return prev.wait() if prev is not None else None
