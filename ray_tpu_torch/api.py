"""Public API.

Role-equivalent of the reference's top-level API (_private/worker.py:
ray.init :1432, ray.get :2863, ray.put :3010, ray.wait :3079, ray.remote
:3564, ray.kill :3259, ray.cancel :3290, ray.get_actor :3224, ray.shutdown).

A copy of ``ray_tpu/api.py`` (host code: the port imports nothing of
``ray_tpu``), with three changes: ``init(num_gpus=)`` takes the place of
``init(num_tpus=)`` (the card is the node's ``GPU`` resource; an explicit 0
opts out of the GPU plugin); ``ray://`` client mode and the dashboard are
not ported; the task-submission spans are not recorded.
"""

from __future__ import annotations

import atexit
import inspect
import logging
import sys
from typing import Any, Dict, List, Optional, Sequence, Union

from . import _worker_api
from ._internal.config import Config
from ._internal.event_loop import LoopThread
from .actor import ActorHandle, make_actor_class
from .object_ref import ObjectRef
from .remote_function import make_remote_function
from .runtime.node import Node
from .runtime.worker.core_worker import CoreWorker, WorkerMode

logger = logging.getLogger(__name__)


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    object_store_memory: Optional[int] = None,
    namespace: str = "",
    runtime_env: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    _system_config: Optional[Dict[str, Any]] = None,
):
    """Start (or connect to) a cluster and attach this process as the driver.

    With no ``address`` a local single-node cluster is started in-process:
    GCS + raylet on a background loop thread, workers as subprocesses
    (reference: ray.init starting head processes via Node, _private/node.py).
    ``address`` may be "host:port" of an existing GCS to connect as a
    driver. ``num_gpus`` overrides the detected card count; 0 opts out.
    """
    if _worker_api.is_initialized():
        if ignore_reinit_error:
            return _worker_api.get_node()
        raise RuntimeError("ray_tpu_torch.init() called twice; shutdown() first")

    config = Config()
    config.apply_overrides(_system_config)
    if config.cluster_auth_token:
        from ._internal.rpc import set_auth_token

        set_auth_token(config.cluster_auth_token)
    if config.testing_rpc_failure:
        import json

        from ._internal.rpc import set_rpc_chaos

        set_rpc_chaos(json.loads(config.testing_rpc_failure))
    from ._internal.rpc import configure_circuit_breaker

    configure_circuit_breaker(
        config.rpc_breaker_threshold, config.rpc_breaker_cooldown_s
    )

    node = None
    if address is None:
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        if num_gpus is not None:
            res["GPU"] = float(num_gpus)
        # accelerator plugin detection (reference: the AcceleratorManager
        # registry folding every family's detection into node resources,
        # _private/accelerators/accelerator.py:18). An explicit ZERO opts
        # out of that plugin wholesale: num_gpus=0 means "not a GPU node";
        # an explicit nonzero count overrides only the count.
        from ._internal.accelerators import detect_node_accelerators

        detected_res, detected_labels = detect_node_accelerators(
            exclude={k for k, v in res.items() if v == 0}
        )
        for key, value in detected_res.items():
            res.setdefault(key, value)
        labels = {**detected_labels, **(labels or {})}
        node = Node(
            config,
            head=True,
            resources=res,
            labels=labels,
            object_store_memory=object_store_memory,
        )
        gcs_address = node.gcs_address
        raylet_address = node.raylet_address
        loop_thread = node.loop_thread
    else:
        host, port = address.rsplit(":", 1)
        gcs_address = (host, int(port))
        loop_thread = LoopThread("ray_tpu_torch-driver")
        raylet_address = _find_raylet(loop_thread, gcs_address)

    worker = CoreWorker(
        WorkerMode.DRIVER, config, gcs_address, raylet_address, loop_thread.loop
    )
    loop_thread.run(worker.start(), timeout=30)
    if address is not None and config.chaos_poll_period_s > 0:
        # address-mode drivers have no raylet poller in-process: poll the
        # cluster chaos-mesh spec themselves (local mode rides the raylet's)
        import asyncio as _asyncio

        from .util import chaosnet as _chaosnet

        async def _start_chaos_poll():
            _asyncio.ensure_future(
                _chaosnet.poll_loop(
                    worker.client_pool.get(*gcs_address),
                    period_s=config.chaos_poll_period_s,
                )
            )

        loop_thread.run(_start_chaos_poll(), timeout=5)
    loop_thread.run(worker.register_driver_job({"namespace": namespace}), timeout=30)
    # job-level default runtime env, merged under per-task envs (reference:
    # ray.init(runtime_env=...) becoming the JobConfig default)
    worker.job_runtime_env = dict(runtime_env) if runtime_env else None
    if log_to_driver and config.log_to_driver:
        my_job = worker.job_id.hex()

        def _filtered_echo(record: dict, _job=my_job):
            # echo only this driver's job (records carry the leasing job's
            # id; un-attributed output — prestart/setup chatter — is shown)
            if record.get("job_id") and record["job_id"] != _job:
                return
            _print_worker_logs(record)

        loop_thread.run(
            worker.subscribe_worker_logs(_filtered_echo), timeout=30
        )
    _worker_api.set_core_worker(worker, config, loop_thread=loop_thread, node=node)
    atexit.register(_atexit_shutdown)
    return node


def _print_worker_logs(record: dict):
    """Driver-side echo of worker output (reference: the driver's log
    streaming with ``(pid=..., ip=...)`` prefixes)."""
    import sys

    prefix = f"(pid={record.get('pid')}, ip={record.get('ip')})"
    if sys.stderr.isatty():
        prefix = f"\x1b[36m{prefix}\x1b[0m"
    out = "".join(f"{prefix} {line}\n" for line in record.get("lines", ()))
    sys.stderr.write(out)
    sys.stderr.flush()


def _find_raylet(loop_thread, gcs_address):
    async def _lookup():
        from ._internal.node_lookup import find_raylet_address
        from ._internal.rpc import RpcClient

        client = RpcClient(*gcs_address, name="init-lookup")
        try:
            return await find_raylet_address(client)
        finally:
            await client.close()

    return loop_thread.run(_lookup(), timeout=30)


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:
        pass


def shutdown():
    """Tear down the driver connection and any locally started cluster."""
    if not _worker_api.is_initialized():
        return
    worker = _worker_api.get_core_worker()
    node = _worker_api.get_node()
    loop_thread = _worker_api.get_loop_thread()
    try:
        _worker_api.run_on_worker_loop(worker.shutdown(), timeout=10)
    except Exception:
        pass
    if node is not None:
        node.stop()  # owns (and stops) the loop thread
    elif loop_thread is not None:
        # client / address-connect modes own their loop thread; stop it or
        # repeated init/shutdown cycles leak a daemon thread each
        try:
            loop_thread.stop()
        except Exception:
            pass
    # the weight plane's cached publishers and subscribers hold refs and pins
    # of the dying cluster: the next init() starts without them (a process
    # that never imported the plane has none, and does not import torch here)
    weights = sys.modules.get(__package__ + ".weights")
    if weights is not None:
        weights._reset_for_shutdown()
    # injected RPC chaos is process-global; it must not outlive the cluster
    # that configured it (later init()s in the same process would inherit it)
    from ._internal.rpc import set_rpc_chaos
    from .util import chaosnet, fencing

    set_rpc_chaos({})
    chaosnet.reset()
    fencing.set_fenced(False)
    _worker_api.clear()


def is_initialized() -> bool:
    return _worker_api.is_initialized()


def remote(*args, **options):
    """``@remote`` / ``@remote(**options)`` for functions and classes."""

    def wrap(target):
        if inspect.isclass(target):
            return make_actor_class(target, **options)
        return make_remote_function(target, **options)

    if len(args) == 1 and not options and callable(args[0]):
        return wrap(args[0])
    if args:
        raise TypeError("remote() takes keyword options only, e.g. @remote(num_cpus=2)")
    return wrap


def put(value: Any) -> ObjectRef:
    worker = _worker_api.get_core_worker()
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    object_id = _worker_api.run_on_worker_loop(worker.put(value))
    return ObjectRef(object_id, worker.address)


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    worker = _worker_api.get_core_worker()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRefs, got {type(r)}")
    values = _worker_api.run_on_worker_loop(
        worker.get_objects(ref_list, timeout), timeout=None
    )
    return values[0] if single else values


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    worker = _worker_api.get_core_worker()
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    return _worker_api.run_on_worker_loop(
        worker.wait(refs, num_returns, timeout, fetch_local)
    )


def kill(actor: ActorHandle, *, no_restart: bool = True):
    worker = _worker_api.get_core_worker()
    _worker_api.run_on_worker_loop(worker.kill_actor(actor._actor_id, no_restart))


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Best-effort cancellation (reference: ray.cancel). Pending tasks are
    failed with TaskCancelledError; running tasks are not interrupted unless
    force-killed in later rounds."""
    worker = _worker_api.get_core_worker()
    from ._internal import serialization
    from .exceptions import TaskCancelledError

    task_id = ref.id.task_id()

    async def _cancel():
        spec = worker._pending_tasks.get(task_id)
        if spec is not None:
            worker._fail_task(spec, TaskCancelledError(task_id))

    _worker_api.run_on_worker_loop(_cancel())


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    worker = _worker_api.get_core_worker()
    info = _worker_api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call(
            "get_actor_by_name", name, namespace
        )
    )
    if info is None:
        raise ValueError(f"actor {name!r} not found in namespace {namespace!r}")
    from .actor import _rebuild_handle

    return _rebuild_handle(info.actor_id, {}, 0)


# -- cluster introspection --------------------------------------------------


def nodes() -> List[dict]:
    worker = _worker_api.get_core_worker()
    infos = _worker_api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call("get_all_nodes")
    )
    return [
        {
            "NodeID": n.node_id.hex(),
            "Alive": n.alive,
            "Resources": n.resources_total,
            "Labels": n.labels,
            "Address": n.address,
            "IsHead": n.is_head,
        }
        for n in infos
    ]


def cluster_resources() -> Dict[str, float]:
    worker = _worker_api.get_core_worker()
    return _worker_api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call("cluster_resources")
    )


def available_resources() -> Dict[str, float]:
    worker = _worker_api.get_core_worker()
    return _worker_api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call(
            "cluster_available_resources"
        )
    )
