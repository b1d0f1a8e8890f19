"""Process-global core-worker access.

Equivalent of the reference's global_worker (_private/worker.py): the one
CoreWorker instance of this process, plus the sync bridge used by the public
API. In the driver the CoreWorker runs on a dedicated LoopThread; in worker
processes it runs on the process main loop and this module is populated by
worker_main.

A copy of ``ray_tpu/_worker_api.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import threading
from typing import Optional

_lock = threading.Lock()
_core_worker = None
_config = None
_loop_thread = None  # LoopThread when we own the loop (driver mode)
_node = None  # in-process Node (driver started a local cluster)


def set_core_worker(worker, config, loop_thread=None, node=None):
    global _core_worker, _config, _loop_thread, _node
    with _lock:
        _core_worker = worker
        _config = config
        _loop_thread = loop_thread
        _node = node


def clear():
    global _core_worker, _config, _loop_thread, _node
    with _lock:
        _core_worker = None
        _config = None
        _loop_thread = None
        _node = None


def get_loop_thread():
    return _loop_thread


def maybe_get_core_worker():
    return _core_worker


def get_core_worker():
    if _core_worker is None:
        raise RuntimeError(
            "ray_tpu has not been initialized — call ray_tpu_torch.init() first"
        )
    return _core_worker


def get_config():
    return _config


def get_node():
    return _node


def is_initialized() -> bool:
    return _core_worker is not None


def run_on_worker_loop(coro, timeout=None):
    """Run a coroutine on the core worker's loop from sync code."""
    worker = get_core_worker()
    if _loop_thread is not None:
        return _loop_thread.run(coro, timeout)
    import asyncio
    import concurrent.futures

    loop = worker.loop
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is loop:
        raise RuntimeError(
            "blocking API called from the worker event loop; use the async API"
        )
    fut = asyncio.run_coroutine_threadsafe(coro, loop)
    try:
        return fut.result(timeout)
    except concurrent.futures.TimeoutError:
        fut.cancel()
        raise TimeoutError("operation timed out")
