"""Model multiplexing: the port of ray_tpu/serve/multiplex.py, copied
without departure.

The caller tags a request with a model id
(``handle.options(multiplexed_model_id="m1").remote(...)``); the replica's
``@serve.multiplexed`` loader keeps an LRU cache of loaded models (on the
card: a tensor dict in device memory), loading on a miss and evicting the
least recently used model beyond the cap. The replica binds the id to the
request's context (its task, or the thread that runs sync user code), where
:func:`get_multiplexed_model_id` reads it.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import inspect
from collections import OrderedDict
from typing import Any, Callable

_model_id_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ray_tpu_serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """Model id of the current request (reference:
    serve.get_multiplexed_model_id)."""
    return _model_id_ctx.get()


def _set_multiplexed_model_id(model_id: str):
    """Bind the model id in the CURRENT task's context. asyncio tasks copy
    the context at creation, so a task spawned to run work on behalf of
    tagged callers (replica request handling, @serve.batch's per-model
    batch task) must re-bind explicitly — setting here never leaks into the
    callers' contexts."""
    _model_id_ctx.set(model_id)


class _ModelCache:
    def __init__(self, loader: Callable, max_models: int):
        self._loader = loader
        self._max = max_models
        self._cache: "OrderedDict[str, Any]" = OrderedDict()
        self._loading: dict = {}  # model_id -> future (dedup concurrent loads)

    async def get(self, self_obj, model_id: str):
        if model_id in self._cache:
            self._cache.move_to_end(model_id)
            return self._cache[model_id]
        fut = self._loading.get(model_id)
        if fut is not None:
            return await fut
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._loading[model_id] = fut
        try:
            if self_obj is not None:
                model = await self._loader(self_obj, model_id)
            else:
                model = await self._loader(model_id)
            while len(self._cache) >= self._max:
                # Evict = drop our reference. In-flight requests still hold
                # theirs, so device buffers (tensors free on GC) are
                # released only when the last user finishes — calling a
                # finalizer here would free device memory mid-use and CPython would
                # run __del__ a second time at GC.
                self._cache.popitem(last=False)
            self._cache[model_id] = model
            fut.set_result(model)
            return model
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)
            raise
        finally:
            self._loading.pop(model_id, None)
            # consume the exception if nobody else awaited the future
            if fut.done() and fut.exception() is not None:
                fut.exception()


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator for an async model loader: ``@serve.multiplexed`` /
    ``@serve.multiplexed(max_num_models_per_replica=8)``
    ``async def get_model(self, model_id): ...`` (reference: serve.multiplexed)."""

    def deco(fn):
        if not inspect.iscoroutinefunction(fn):
            raise TypeError("@serve.multiplexed requires an async def loader")
        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] == "self"
        attr = f"__serve_multiplex_cache_{fn.__name__}"

        if is_method:
            async def wrapper(self, model_id: str = ""):
                model_id = model_id or get_multiplexed_model_id()
                if not model_id:
                    raise ValueError(
                        "no model id: pass one or set multiplexed_model_id "
                        "on the handle"
                    )
                cache = getattr(self, attr, None)
                if cache is None:
                    cache = _ModelCache(fn, max_num_models_per_replica)
                    setattr(self, attr, cache)
                return await cache.get(self, model_id)
        else:
            state: dict = {}

            async def wrapper(model_id: str = ""):
                model_id = model_id or get_multiplexed_model_id()
                if not model_id:
                    raise ValueError(
                        "no model id: pass one or set multiplexed_model_id "
                        "on the handle"
                    )
                cache = state.get("c")
                if cache is None:
                    cache = state["c"] = _ModelCache(
                        fn, max_num_models_per_replica
                    )
                return await cache.get(None, model_id)

        return functools.wraps(fn)(wrapper)

    if _fn is not None:
        return deco(_fn)
    return deco
