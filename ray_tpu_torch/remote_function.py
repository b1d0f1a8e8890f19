"""@remote functions.

Role-equivalent of the reference's RemoteFunction (python/ray/remote_function.py):
a decorated function gains ``.remote(...)`` / ``.options(...)``; the pickled
definition ships once per process through the GCS function table and tasks are
submitted through the core worker.

A copy of ``ray_tpu/remote_function.py`` (host code: the port imports nothing of
``ray_tpu``), without ``bind`` (compiled graphs are not ported) and without
the submission spans and serialization metrics (the runtime planes'
observability is not ported). The wrapper's ``__remote_wrapped__`` lets a
worker import the decorated object by its module-level name.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

from . import _worker_api
from ._internal import args as arglib
from ._internal import serialization
from ._internal.ids import ObjectID
from .runtime.gcs import keys as gcs_keys
from ._internal.protocol import (
    DefaultSchedulingStrategy,
    FunctionDescriptor,
    TaskArg,
    TaskSpec,
    TaskType,
)
from .object_ref import ObjectRef

_DEFAULT_TASK_OPTIONS = dict(
    num_returns=1,
    num_cpus=1.0,
    resources=None,
    max_retries=3,
    retry_exceptions=False,
    scheduling_strategy=None,
    label_selector=None,
    runtime_env=None,
    name=None,
)


def build_resources(options: Dict[str, Any]) -> Dict[str, float]:
    resources = dict(options.get("resources") or {})
    num_cpus = options.get("num_cpus")
    if num_cpus is None:
        num_cpus = 1.0
    if num_cpus:
        resources["CPU"] = float(num_cpus)
    num_tpus = options.get("num_tpus")
    if num_tpus:
        resources["TPU"] = float(num_tpus)
    num_gpus = options.get("num_gpus")
    if num_gpus:
        resources["GPU"] = float(num_gpus)
    from .runtime.raylet.resources import check_instance_demand

    check_instance_demand(resources)
    return resources


def _normalize_runtime_env(runtime_env, worker):
    """Package + validate a runtime_env option at submission time, merging
    the job-level default under it (reference: runtime-env upload in
    remote_function/_private + JobConfig default merging)."""
    job_env = getattr(worker, "job_runtime_env", None)
    if job_env:
        merged = dict(job_env)
        merged.update(runtime_env or {})
        env_vars = {**(job_env.get("env_vars") or {}),
                    **((runtime_env or {}).get("env_vars") or {})}
        if env_vars:
            merged["env_vars"] = env_vars
        runtime_env = merged
    if not runtime_env:
        return None
    from ._internal.runtime_env import normalize_cached

    return normalize_cached(runtime_env, worker)


def prepare_args(worker, args: tuple, kwargs: dict) -> List[TaskArg]:
    """Flatten into TaskArgs: slot 0 is the pickled structure, the rest are
    top-level by-reference args, then pin-only entries for refs nested
    inside containers (nested-ref containment, reference_counter.h:44 — the
    owner keeps them alive for the task's flight; the executor resolves them
    from the structure and registers as their borrower on deserialize)."""
    structure, extracted = arglib.flatten(args, kwargs)
    with serialization.collect_refs() as nested:
        packed = serialization.pack(structure)
    task_args = [TaskArg(value=packed)]
    for ref in extracted:
        owner = ref.owner_address or worker.address
        task_args.append(TaskArg(object_id=ref.id, owner_address=owner))
    for ref in nested:
        owner = ref.owner_address or worker.address
        task_args.append(
            TaskArg(object_id=ref.id, owner_address=owner, nested=True)
        )
    return task_args


class RemoteFunction:
    def __init__(self, function, task_options: Dict[str, Any]):
        self._function = function
        self._options = {**_DEFAULT_TASK_OPTIONS, **task_options}
        self._pickled: Optional[bytes] = None
        self._hash: Optional[str] = None
        # processes in which the definition has been exported
        self._exported_for: Optional[int] = None
        self.__name__ = getattr(function, "__name__", "remote_function")
        self.__doc__ = getattr(function, "__doc__", None)

    @property
    def __remote_wrapped__(self):
        """The decorated function (a worker imports it through this wrapper)."""
        return self._function

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Remote function {self.__name__} cannot be called directly; use "
            f"{self.__name__}.remote()."
        )

    def options(self, **task_options) -> "_BoundRemoteFunction":
        merged = {**self._options, **task_options}
        return _BoundRemoteFunction(self, merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    # -- internals ---------------------------------------------------------

    def _ensure_exported(self, worker) -> str:
        if self._pickled is None:
            self._pickled = serialization.dumps(self._function)
            self._hash = hashlib.sha1(self._pickled).hexdigest()
        if self._exported_for != id(worker):
            _worker_api.run_on_worker_loop(
                worker.client_pool.get(*worker.gcs_address).call(
                    "kv_put", gcs_keys.FUNCTION.key(self._hash), self._pickled, True
                )
            )
            self._exported_for = id(worker)
        return self._hash

    def _remote(self, args: tuple, kwargs: dict, options: Dict[str, Any]):
        worker = _worker_api.get_core_worker()
        fn_hash = self._ensure_exported(worker)
        task_args = prepare_args(worker, args, kwargs)
        num_returns = options["num_returns"]
        # streaming generators: yielded items become their own objects as
        # they are produced (reference: num_returns="streaming" ->
        # ObjectRefGenerator, _private/object_ref_generator.py:32)
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 0
        from .util.scheduling_strategies import to_protocol_strategy

        strategy = to_protocol_strategy(options.get("scheduling_strategy"))
        pg_id = None
        bundle_index = -1
        from ._internal.protocol import PlacementGroupSchedulingStrategy

        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg_id = strategy.placement_group_id
            bundle_index = strategy.bundle_index
        spec = TaskSpec(
            task_id=worker.next_task_id(),
            job_id=worker.job_id,
            task_type=TaskType.NORMAL_TASK,
            function=FunctionDescriptor(
                module=getattr(self._function, "__module__", "") or "",
                qualname=self.__name__,
                function_hash=fn_hash,
            ),
            args=task_args,
            num_returns=num_returns,
            resources=build_resources(options),
            owner_worker_id=worker.worker_id,
            owner_address=worker.address,
            scheduling_strategy=strategy,
            label_selector=dict(options.get("label_selector") or {}),
            max_retries=options["max_retries"],
            retry_exceptions=bool(options["retry_exceptions"]),
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle_index,
            is_streaming_generator=streaming,
            runtime_env=_normalize_runtime_env(options.get("runtime_env"), worker),
        )
        return_ids = _worker_api.run_on_worker_loop(worker.submit_task(spec))
        if streaming:
            from .object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id)
        refs = [ObjectRef(oid, worker.address) for oid in return_ids]
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs


class _BoundRemoteFunction:
    """Result of fn.options(...): only exposes .remote()."""

    def __init__(self, base: RemoteFunction, options: Dict[str, Any]):
        self._base = base
        self._options = options
        self.__name__ = base.__name__

    def remote(self, *args, **kwargs):
        return self._base._remote(args, kwargs, self._options)

def make_remote_function(function, **task_options) -> RemoteFunction:
    return RemoteFunction(function, task_options)
