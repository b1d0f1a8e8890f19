"""Dynamic request batching, ``@serve.batch``: the port of
ray_tpu/serve/batching.py, copied without departure.

Individual async calls accumulate into a list; the wrapped callable runs
once per batch (``async def fn(self, items: List)`` -> list of results, one
per caller) when the batch fills or the wait timeout fires.

Batching composes with ``@serve.multiplexed``: the pending queue is
partitioned by the caller's multiplexed model id, so one flush never mixes
requests for different models, and the batch task re-enters the model-id
context before running the handler.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
from typing import Any, Callable, Dict, List


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int, wait_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait_s = wait_s
        # model id -> [(item, future)]: per-model queues so a flush is
        # always single-model (the "" partition is the unmultiplexed path)
        self._pending: Dict[str, List[tuple]] = {}
        self._timers: Dict[str, asyncio.TimerHandle] = {}
        # strong refs: the loop only weakly references tasks, and a collected
        # batch task would strand every caller future in it
        self._tasks: set = set()

    async def submit(self, item: Any):
        from .multiplex import get_multiplexed_model_id

        model_id = get_multiplexed_model_id()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        pending = self._pending.setdefault(model_id, [])
        pending.append((item, fut))
        if len(pending) >= self._max:
            self._flush(model_id)
        elif model_id not in self._timers:
            self._timers[model_id] = loop.call_later(
                self._wait_s, self._flush, model_id
            )
        return await fut

    def _flush(self, model_id: str):
        timer = self._timers.pop(model_id, None)
        if timer is not None:
            timer.cancel()
        batch = self._pending.pop(model_id, None)
        if not batch:
            return
        task = asyncio.ensure_future(self._run(batch, model_id))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run(self, batch: List[tuple], model_id: str):
        from .multiplex import _set_multiplexed_model_id

        # this task copied whatever context ensure_future saw at flush time
        # (a timer callback or one arbitrary caller) — pin the batch's model
        # id so the handler's get_multiplexed_model_id()/get_model() work
        _set_multiplexed_model_id(model_id)
        items = [item for item, _f in batch]
        try:
            results = await self._fn(items)
            if results is None or len(results) != len(items):
                raise ValueError(
                    "@serve.batch function must return one result per input "
                    f"(got {None if results is None else len(results)} for "
                    f"{len(items)} inputs)"
                )
            for (_item, fut), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as e:  # noqa: BLE001 — error fans out to all callers
            for _item, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def batch(_fn=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: ``@serve.batch`` / ``@serve.batch(max_batch_size=32,
    batch_wait_timeout_s=0.05)`` on an async method taking a list."""

    def deco(fn):
        if not inspect.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async def function")
        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] == "self"
        attr = f"__serve_batch_queue_{fn.__name__}"

        if is_method:
            async def wrapper(self, item):
                q = getattr(self, attr, None)
                if q is None:
                    async def bound(items):
                        return await fn(self, items)

                    q = _BatchQueue(bound, max_batch_size, batch_wait_timeout_s)
                    setattr(self, attr, q)
                return await q.submit(item)
        else:
            state = {}

            async def wrapper(item):
                q = state.get("q")
                if q is None:
                    q = state["q"] = _BatchQueue(
                        fn, max_batch_size, batch_wait_timeout_s
                    )
                return await q.submit(item)

        return functools.wraps(fn)(wrapper)

    if _fn is not None:
        return deco(_fn)
    return deco
