"""Actors.

Role-equivalent of the reference's actor layer (python/ray/actor.py):
``@remote`` on a class yields an ActorClass whose ``.remote(...)`` creates a
stateful worker-resident instance; the returned ActorHandle proxies method
calls as ordered actor tasks. Supports max_restarts/max_task_retries, named
and detached actors, max_concurrency, and handle serialization.

A copy of ``ray_tpu/actor.py`` (host code: the port imports nothing of
``ray_tpu``), without ``bind`` (compiled graphs are not ported) and without
the submission spans and serialization metrics (the runtime planes'
observability is not ported). The wrapper's ``__remote_wrapped__`` lets a
worker import the decorated object by its module-level name.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

from . import _worker_api
from ._internal import serialization
from ._internal.ids import ActorID
from .runtime.gcs import keys as gcs_keys
from ._internal.protocol import (
    DefaultSchedulingStrategy,
    FunctionDescriptor,
    TaskSpec,
    TaskType,
)
from .object_ref import ObjectRef
from .remote_function import (
    _normalize_runtime_env,
    build_resources,
    prepare_args,
)

_DEFAULT_ACTOR_OPTIONS = dict(
    num_cpus=1.0,
    resources=None,
    max_restarts=0,
    max_task_retries=0,
    max_concurrency=1,
    name=None,
    namespace="",
    lifetime=None,  # None | "detached"
    scheduling_strategy=None,
    label_selector=None,
    runtime_env=None,
)


def method(**options):
    """Per-method options, e.g. @ray_tpu_torch.method(num_returns=2)
    (reference: actor.py method decorator)."""

    def decorator(fn):
        fn.__ray_tpu_method_options__ = options
        return fn

    return decorator


class ActorClass:
    def __init__(self, cls, actor_options: Dict[str, Any]):
        self._cls = cls
        self._options = {**_DEFAULT_ACTOR_OPTIONS, **actor_options}
        self._pickled: Optional[bytes] = None
        self._hash: Optional[str] = None
        self._exported_for: Optional[int] = None
        self.__name__ = getattr(cls, "__name__", "ActorClass")

    @property
    def __remote_wrapped__(self):
        """The decorated class (a worker imports it through this wrapper)."""
        return self._cls

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()."
        )

    def options(self, **actor_options) -> "_BoundActorClass":
        return _BoundActorClass(self, {**self._options, **actor_options})

    def remote(self, *args, **kwargs) -> "ActorHandle":
        return self._remote(args, kwargs, self._options)

    def _ensure_exported(self, worker) -> str:
        if self._pickled is None:
            self._pickled = serialization.dumps(self._cls)
            self._hash = "cls_" + hashlib.sha1(self._pickled).hexdigest()
        if self._exported_for != id(worker):
            _worker_api.run_on_worker_loop(
                worker.client_pool.get(*worker.gcs_address).call(
                    "kv_put", gcs_keys.FUNCTION.key(self._hash), self._pickled, True
                )
            )
            self._exported_for = id(worker)
        return self._hash

    def _method_options(self) -> Dict[str, dict]:
        out = {}
        for name in dir(self._cls):
            if name.startswith("__"):
                continue
            attr = getattr(self._cls, name, None)
            if callable(attr):
                out[name] = dict(getattr(attr, "__ray_tpu_method_options__", {}))
        return out

    def _remote(self, args, kwargs, options) -> "ActorHandle":
        worker = _worker_api.get_core_worker()
        cls_hash = self._ensure_exported(worker)
        actor_id = ActorID.of(worker.job_id)
        task_args = prepare_args(worker, args, kwargs)
        detached = options.get("lifetime") == "detached"
        from .util.scheduling_strategies import to_protocol_strategy

        strategy = to_protocol_strategy(options.get("scheduling_strategy"))
        spec = TaskSpec(
            task_id=worker.next_task_id(),
            job_id=worker.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            function=FunctionDescriptor(
                module=getattr(self._cls, "__module__", "") or "",
                qualname=self.__name__,
                function_hash=cls_hash,
            ),
            args=task_args,
            num_returns=0,
            resources=build_resources(options),
            owner_worker_id=worker.worker_id,
            owner_address=worker.address,
            scheduling_strategy=strategy,
            label_selector=dict(options.get("label_selector") or {}),
            actor_id=actor_id,
            max_restarts=options["max_restarts"],
            max_task_retries=options["max_task_retries"],
            max_concurrency=options["max_concurrency"],
            namespace=options.get("namespace") or "",
            actor_name=options.get("name") or "",
            runtime_env=_normalize_runtime_env(options.get("runtime_env"), worker),
        )
        _worker_api.run_on_worker_loop(worker.create_actor(spec, detached))
        return ActorHandle(
            actor_id,
            self._method_options(),
            max_task_retries=options["max_task_retries"],
            _original=not detached,
        )


class _BoundActorClass:
    def __init__(self, base: ActorClass, options: Dict[str, Any]):
        self._base = base
        self._options = options

    def remote(self, *args, **kwargs) -> "ActorHandle":
        return self._base._remote(args, kwargs, self._options)

class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, options: dict):
        self._handle = handle
        self._name = name
        self._options = options

    def remote(self, *args, **kwargs):
        return self._handle._submit(self._name, args, kwargs, self._options)

    def options(self, **opts):
        return ActorMethod(self._handle, self._name, {**self._options, **opts})

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Actor method {self._name} cannot be called directly; use "
            f".{self._name}.remote()."
        )


class ActorHandle:
    def __init__(
        self,
        actor_id: ActorID,
        method_options: Dict[str, dict],
        max_task_retries: int = 0,
        _original: bool = False,
    ):
        self._actor_id = actor_id
        self._method_options = method_options
        self._max_task_retries = max_task_retries
        # The original handle (returned by .remote() in the creating process)
        # owns the actor's lifetime: when it is GC'd, a non-detached actor is
        # terminated (reference: actor.py handle-scope lifetime).
        self._original = _original

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        options = self._method_options.get(name, {})
        return ActorMethod(self, name, options)

    def _submit(self, method_name: str, args, kwargs, options: dict):
        worker = _worker_api.get_core_worker()
        task_args = prepare_args(worker, args, kwargs)
        num_returns = options.get("num_returns", 1)
        # actor streaming generators (reference: python/ray/actor.py:516-548):
        # yielded items become their own objects as they are produced, same
        # ObjectRefGenerator surface as task generators
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 0
        spec = TaskSpec(
            task_id=worker.next_task_id(),
            job_id=worker.job_id,
            task_type=TaskType.ACTOR_TASK,
            function=FunctionDescriptor(
                module="", qualname=method_name, function_hash=""
            ),
            args=task_args,
            num_returns=num_returns,
            resources={},
            owner_worker_id=worker.worker_id,
            owner_address=worker.address,
            actor_id=self._actor_id,
            max_task_retries=self._max_task_retries,
            is_streaming_generator=streaming,
        )
        return_ids = _worker_api.run_on_worker_loop(worker.submit_actor_task(spec))
        if streaming:
            from .object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id)
        refs = [ObjectRef(oid, worker.address) for oid in return_ids]
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:16]})"

    def __del__(self):
        if not getattr(self, "_original", False):
            return
        try:
            from . import _worker_api
        except ImportError:
            return
        worker = _worker_api.maybe_get_core_worker()
        if worker is None or worker.loop.is_closed():
            return
        import asyncio

        actor_id = self._actor_id
        try:
            worker.loop.call_soon_threadsafe(
                lambda: asyncio.ensure_future(worker.kill_actor(actor_id, True))
            )
        except RuntimeError:
            pass

    def __reduce__(self):
        return (
            _rebuild_handle,
            (self._actor_id, self._method_options, self._max_task_retries),
        )


def _rebuild_handle(actor_id, method_options, max_task_retries):
    handle = ActorHandle(actor_id, method_options, max_task_retries)
    worker = _worker_api.maybe_get_core_worker()
    if worker is not None:
        worker.loop.call_soon_threadsafe(worker.attach_actor, actor_id)
    return handle


def make_actor_class(cls, **actor_options) -> ActorClass:
    return ActorClass(cls, actor_options)
