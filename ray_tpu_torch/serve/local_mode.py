"""Local testing mode: the port of ray_tpu/serve/local_mode.py, copied
without departure.

``serve.run(app, _local_testing_mode=True)`` (or :func:`run_local`)
instantiates every deployment in the caller's process, with no cluster;
handles call the instances directly, and async methods (with the
``@serve.batch`` and ``@serve.multiplexed`` machinery) run on a private
event-loop thread.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Dict, Optional


class _LocalLoop:
    """One shared event-loop thread for all local replicas' async methods."""

    _instance: Optional["_LocalLoop"] = None

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        t = threading.Thread(
            target=self.loop.run_forever, name="serve-local", daemon=True
        )
        t.start()

    @classmethod
    def get(cls) -> "_LocalLoop":
        if cls._instance is None:
            cls._instance = _LocalLoop()
        return cls._instance

    def run(self, coro, timeout=None):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)


class LocalDeploymentResponse:
    """Mirror of DeploymentResponse for local mode: the request is already
    in flight (dispatched eagerly, like the real handle) and ``result``
    just waits."""

    def __init__(self, future, default_timeout_s: Optional[float] = None):
        self._future = future
        self._default_timeout_s = default_timeout_s

    def result(self, timeout_s: Optional[float] = None):
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        return self._future.result(timeout_s)


class LocalResponseGenerator:
    """Local-mode mirror of DeploymentResponseGenerator: drains a queue fed
    by the generator running on the local loop, so items arrive as produced."""

    _DONE = object()

    def __init__(self, queue):
        self._queue = queue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item


class LocalDeploymentHandle:
    """Calls the in-process instance directly (reference: the local-mode
    handle in local_testing_mode.py)."""

    def __init__(self, instances: Dict[str, Any], deployment: str,
                 method: str = "__call__", multiplexed_model_id: str = "",
                 stream: bool = False, prefix_affinity_tokens: int = 0,
                 timeout_s: Optional[float] = None):
        self._instances = instances
        self._deployment = deployment
        self._method = method
        self._multiplexed_model_id = multiplexed_model_id
        self._stream = stream
        # accepted for parity with DeploymentHandle.options so code under
        # test can set them unconditionally; with one in-process instance
        # there is nothing to bias, and timeout_s bounds the result() wait
        self._prefix_affinity_tokens = prefix_affinity_tokens
        self._timeout_s = timeout_s

    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                prefix_affinity_tokens: Optional[int] = None,
                timeout_s: Optional[float] = None):
        return LocalDeploymentHandle(
            self._instances,
            self._deployment,
            method_name if method_name is not None else self._method,
            multiplexed_model_id
            if multiplexed_model_id is not None
            else self._multiplexed_model_id,
            stream if stream is not None else self._stream,
            prefix_affinity_tokens
            if prefix_affinity_tokens is not None
            else self._prefix_affinity_tokens,
            timeout_s if timeout_s is not None else self._timeout_s,
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return LocalDeploymentHandle(
            self._instances, self._deployment, name,
            self._multiplexed_model_id, self._stream,
            self._prefix_affinity_tokens, self._timeout_s,
        )

    def _remote_stream(self, *args, **kwargs) -> "LocalResponseGenerator":
        import inspect
        import queue as queue_mod

        instance = self._instances[self._deployment]
        method = (
            instance
            if self._method == "__call__" and not hasattr(instance, "__call__")
            else getattr(instance, self._method)
        )
        out: queue_mod.Queue = queue_mod.Queue()
        loop = _LocalLoop.get().loop
        model_id = self._multiplexed_model_id

        _SENTINEL = object()

        async def drive():
            import contextvars

            try:
                if model_id:
                    from .multiplex import _set_multiplexed_model_id

                    _set_multiplexed_model_id(model_id)
                gen = method(*args, **kwargs)
                if inspect.isasyncgen(gen):
                    async for item in gen:
                        out.put(item)
                elif inspect.isgenerator(gen):
                    # sync generators step on a thread under the copied
                    # context (generator bodies see the context of each
                    # next(), so the model-id var must ride along); a
                    # blocking next() must not freeze the shared local loop
                    ctx = contextvars.copy_context()
                    while True:
                        item = await loop.run_in_executor(
                            None, lambda: ctx.run(next, gen, _SENTINEL)
                        )
                        if item is _SENTINEL:
                            break
                        out.put(item)
                else:
                    raise TypeError(
                        "stream=True requires a generator method; "
                        f"{self._method!r} returned {type(gen).__name__}"
                    )
            except Exception as e:  # noqa: BLE001 — relayed to the consumer
                out.put(e)
            finally:
                out.put(LocalResponseGenerator._DONE)

        asyncio.run_coroutine_threadsafe(drive(), loop)
        return LocalResponseGenerator(out)

    def remote(self, *args, **kwargs) -> LocalDeploymentResponse:
        if self._stream:
            return self._remote_stream(*args, **kwargs)
        import contextvars

        instance = self._instances[self._deployment]
        method = (
            instance
            if self._method == "__call__" and not hasattr(instance, "__call__")
            else getattr(instance, self._method)
        )
        model_id = self._multiplexed_model_id
        loop = _LocalLoop.get().loop

        async def invoke():
            if asyncio.iscoroutinefunction(method):
                if model_id:
                    from .multiplex import _set_multiplexed_model_id

                    # this task's context only — no leak across requests
                    _set_multiplexed_model_id(model_id)
                return await method(*args, **kwargs)
            # sync method: run on a thread (the loop must keep serving
            # concurrent requests, e.g. @serve.batch coalescing), inside a
            # context copy so the model-id var never leaks to later calls
            def call():
                if model_id:
                    from .multiplex import _set_multiplexed_model_id

                    _set_multiplexed_model_id(model_id)
                return method(*args, **kwargs)

            ctx = contextvars.copy_context()
            return await loop.run_in_executor(None, lambda: ctx.run(call))

        # eager dispatch, matching the real handle: fire-and-forget calls
        # still execute and concurrent requests actually overlap
        future = asyncio.run_coroutine_threadsafe(invoke(), loop)
        return LocalDeploymentResponse(
            future, default_timeout_s=self._timeout_s
        )


def run_local(app, name: str = "default") -> LocalDeploymentHandle:
    """Instantiate every deployment in-process and return the root handle."""
    from .api import Application, _BoundDeployment

    nodes = app._collect()
    instances: Dict[str, Any] = {}

    def resolve(obj):
        if isinstance(obj, Application):
            obj = obj.root
        if isinstance(obj, _BoundDeployment):
            return LocalDeploymentHandle(instances, obj.deployment.name)
        if isinstance(obj, tuple):
            return tuple(resolve(x) for x in obj)
        if isinstance(obj, list):
            return [resolve(x) for x in obj]
        if isinstance(obj, dict):
            return {k: resolve(v) for k, v in obj.items()}
        return obj

    for node in nodes:
        target = node.deployment._target
        args = resolve(node.init_args)
        kwargs = resolve(node.init_kwargs)
        if isinstance(target, type):
            instances[node.deployment.name] = target(*args, **kwargs)
        else:
            # function deployment: the "instance" is the function itself
            instances[node.deployment.name] = target
    return LocalDeploymentHandle(instances, app.root.deployment.name)
