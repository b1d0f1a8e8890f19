"""Event loop hosting.

The reference runs single-threaded asio io_contexts per component
(instrumented_io_context, GcsServerIoContextPolicy pins subsystems to named
contexts). Equivalent here: each component owns a named asyncio loop running
on a dedicated thread, and synchronous callers bridge in with
``run_coroutine_threadsafe``.

A copy of ``ray_tpu/_internal/event_loop.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
from typing import Any, Coroutine, Optional


class LoopThread:
    """An asyncio event loop running on a daemon thread."""

    def __init__(self, name: str):
        self.name = name
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.call_soon(self._started.set)
        self.loop.run_forever()

    def run(self, coro: Coroutine, timeout: Optional[float] = None) -> Any:
        """Run a coroutine on this loop from another thread, blocking."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise TimeoutError(f"{self.name}: coroutine timed out after {timeout}s")

    def spawn(self, coro: Coroutine) -> concurrent.futures.Future:
        """Fire-and-track a coroutine on this loop."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        if self.loop.is_running():
            self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
        if not self.loop.is_running():
            self.loop.close()


class BackgroundTasks:
    """Strong-ref registry for fire-and-forget asyncio tasks.

    A bare ``asyncio.ensure_future`` keeps no strong reference: the event
    loop may GC the task mid-flight and the side effect (an ack RPC, a
    deferred free) silently never happens. Every component that fires
    one-way work registers it here instead (the pattern previously copied
    in raylet/gcs/channel/core_worker)."""

    def __init__(self):
        self._tasks: set = set()

    def track(self, task: asyncio.Task) -> asyncio.Task:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def spawn(self, coro) -> asyncio.Task:
        return self.track(asyncio.ensure_future(coro))

    def cancel_all(self) -> None:
        for task in list(self._tasks):
            task.cancel()
        self._tasks.clear()

    def __len__(self) -> int:
        return len(self._tasks)


class PeriodicRunner:
    """Recurring callback on a loop; injectable/fakeable for tests
    (reference: common/asio PeriodicalRunner + fake_periodical_runner.h)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._tasks: list[asyncio.Task] = []
        self._stopped = False

    def run_every(self, period_s: float, fn, *args):
        async def _loop_fn():
            while not self._stopped:
                await asyncio.sleep(period_s)
                try:
                    res = fn(*args)
                    if asyncio.iscoroutine(res):
                        await res
                except asyncio.CancelledError:
                    return
                except Exception:
                    import logging

                    logging.getLogger(__name__).exception(
                        "periodic callback %r failed", fn
                    )

        task = self._loop.create_task(_loop_fn())
        self._tasks.append(task)
        return task

    def stop(self):
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
