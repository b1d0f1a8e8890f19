"""Serve public API: the port of ray_tpu/serve/api.py.

``@serve.deployment`` wraps a class or function into a :class:`Deployment`;
``.bind()`` builds the application graph; :func:`run` ships it to the
``ServeController`` actor (named, restartable) and returns a handle once
every deployment is healthy; :func:`start` brings up the controller and
the HTTP proxies.

Copied from the reference, with these departures:

- a deployment's callable travels by reference (its module and name; the
  port has no cloudpickle, ROADMAP kept item 35). A module-level
  ``@serve.deployment class X`` binds ``X`` to the :class:`Deployment`,
  which the port's serialization unwraps to the class, as it unwraps a
  ``@remote`` wrapper; a deployment defined in ``__main__``, inside a
  function or as a lambda raises a ``ValueError`` naming it at ``bind()``;
- there is no gRPC ingress: the card's machine has no ``grpcio``, so
  ``start(grpc_port=...)`` raises ``NotImplementedError`` and
  ``grpc_proxy_address`` / ``grpc_call`` are not exported;
- the HTTP proxy is the port's standard-library server
  (:mod:`.proxy`), not aiohttp.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional

from .. import api as ray_api
from .._internal import serialization
from .autoscale import AutoscalePolicy
from .config import (
    ApplicationStatus,
    AutoscalingConfig,
    DeploymentConfig,
    RequestRouterConfig,
)
from .controller import CONTROLLER_NAME, ServeController
from .handle import DeploymentHandle

_state: Dict[str, Any] = {
    "controller": None, "proxy": None, "proxies": [], "ingress": {},
}


class Application:
    """A bound deployment graph rooted at the ingress deployment."""

    def __init__(self, root: "_BoundDeployment"):
        self.root = root

    def _collect(self) -> List["_BoundDeployment"]:
        seen: Dict[str, _BoundDeployment] = {}

        def walk(node):
            if isinstance(node, Application):
                node = node.root
            if isinstance(node, _BoundDeployment):
                if node.deployment.name not in seen:
                    seen[node.deployment.name] = node
                    for a in list(node.init_args) + list(
                        node.init_kwargs.values()
                    ):
                        walk(a)
            elif isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
            elif isinstance(node, dict):
                for x in node.values():
                    walk(x)

        walk(self.root)
        return list(seen.values())


class _BoundDeployment:
    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


class Deployment:
    def __init__(self, target, config: DeploymentConfig):
        self._target = target
        self._config = config

    @property
    def __deployment_target__(self):
        """The class or function this deployment serves: what the port's
        serialization unpickles a reference to this name as."""
        return self._target

    @property
    def name(self) -> str:
        return self._config.name

    def options(self, **overrides) -> "Deployment":
        import dataclasses

        cfg = dataclasses.replace(self._config)
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown deployment option {k!r}")
            setattr(cfg, k, v)
        return Deployment(self._target, cfg)

    def bind(self, *args, **kwargs) -> Application:
        # a replica imports the callable by its module and name: refuse one
        # it cannot import now, with its name, not in the replica later
        serialization.dumps(self._target)
        return Application(_BoundDeployment(self, args, kwargs))


def deployment(_target=None, **options):
    """@serve.deployment / @serve.deployment(num_replicas=2, ...)"""

    def wrap(target):
        if isinstance(options.get("autoscaling_config"), dict):
            options["autoscaling_config"] = AutoscalingConfig(
                **options["autoscaling_config"]
            )
        if isinstance(options.get("request_router_config"), dict):
            options["request_router_config"] = RequestRouterConfig(
                **options["request_router_config"]
            )
        if isinstance(options.get("autoscale_policy"), dict):
            options["autoscale_policy"] = AutoscalePolicy(
                **options["autoscale_policy"]
            )
        cfg = DeploymentConfig(
            name=options.pop("name", None) or target.__name__, **options
        )
        return Deployment(target, cfg)

    if _target is not None:
        return wrap(_target)
    return wrap


def ingress(asgi_app):
    """Mount an ASGI app as a deployment's HTTP interface (reference:
    @serve.ingress, serve/api.py:181 — FastAPI apps become deployments).

    ``asgi_app`` is any ASGI-3 callable ``async app(scope, receive, send)``
    (FastAPI/Starlette instances qualify). The decorated class gains an
    ``__asgi__`` streaming method: the HTTP proxy forwards (scope, body) to
    it and relays the ASGI send-events back as they are produced, so
    streaming responses reach the client incrementally. The deployment
    instance is exposed to the app at ``scope["ray_tpu.replica"]``."""

    def decorator(cls):
        if not inspect.isclass(cls):
            raise TypeError("@serve.ingress decorates a deployment class")
        cls.__ray_tpu_asgi_app__ = staticmethod(asgi_app)

        async def __asgi__(self, scope: dict, body: bytes):
            import asyncio

            app = self.__ray_tpu_asgi_app__
            queue: asyncio.Queue = asyncio.Queue()
            _DONE = object()
            scope = dict(scope)
            scope["ray_tpu.replica"] = self
            body_sent = False

            async def receive():
                nonlocal body_sent
                if not body_sent:
                    body_sent = True
                    return {
                        "type": "http.request",
                        "body": body or b"",
                        "more_body": False,
                    }
                # block forever: an eager http.disconnect makes Starlette's
                # listen_for_disconnect cancel StreamingResponses mid-stream.
                # Disconnect propagation is the proxy's job; if the app
                # parks a task here it is cancelled in the finally below.
                await asyncio.Event().wait()

            async def send(event):
                await queue.put(event)

            async def run_app():
                try:
                    await app(scope, receive, send)
                except Exception as e:  # noqa: BLE001 — relayed to the proxy
                    await queue.put({"type": "asgi.error", "error": repr(e)})
                finally:
                    await queue.put(_DONE)

            task = asyncio.ensure_future(run_app())
            try:
                while True:
                    event = await queue.get()
                    if event is _DONE:
                        break
                    yield event
            finally:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass

        cls.__asgi__ = __asgi__
        return cls

    return decorator


# -- controller / proxy management -------------------------------------------


def _default_num_proxies() -> int:
    """One proxy per alive node (the reference's proxy placement); at
    least one. Falls back to 1 when node state is unavailable."""
    try:
        return max(
            1, sum(1 for n in ray_api.nodes() if n.get("Alive", True))
        )
    except Exception:
        return 1


def _register_proxy(controller, p, proxy_id: str):
    """Fetch the proxy's identity and enter it into the controller's
    inventory (GCS ``proxy:`` registry) so drains/chaos/CLI see it."""
    info = ray_api.get(p.describe.remote())
    ray_api.get(controller.register_proxy.remote(proxy_id, info, p))


def start(
    *,
    http_host: str = "127.0.0.1",
    http_port: int = 8000,
    proxy: bool = True,
    grpc_port: Optional[int] = None,
    num_proxies: Optional[int] = None,
    num_grpc_proxies: int = 1,
):
    """Start (or connect to) the Serve control plane: a named, restartable
    controller actor plus ``num_proxies`` HTTP proxy actors (default: one
    per alive node) sharing ``http_port`` through SO_REUSEPORT. A
    ``grpc_port`` raises ``NotImplementedError``: the port has no gRPC
    ingress (the card's machine has no ``grpcio``)."""
    if grpc_port is not None:
        raise NotImplementedError(
            "serve.start(grpc_port=...) is not ported: the gRPC ingress needs "
            "grpcio, which the card's machine does not have; use the HTTP "
            "proxy or a DeploymentHandle"
        )
    del num_grpc_proxies  # accepted for the reference's signature
    if _state["controller"] is None:
        try:
            controller = ray_api.get_actor(CONTROLLER_NAME)
        except ValueError:
            # restartable: on crash the GCS re-creates it and __init__
            # recovers goal state from the KV checkpoint, re-adopting live
            # replicas
            Controller = ray_api.remote(
                num_cpus=0, name=CONTROLLER_NAME, max_restarts=-1
            )(ServeController)
            controller = Controller.remote()
            ray_api.get(controller.ping.remote())
        _state["controller"] = controller
    if proxy and not _state["proxies"]:
        from .proxy import HTTPProxy

        n = num_proxies if num_proxies else _default_num_proxies()
        reuse = n > 1
        Proxy = ray_api.remote(num_cpus=0)(HTTPProxy)
        started = []
        for i in range(n):
            proxy_id = f"http#{i}"
            p = Proxy.remote(
                _state["controller"], http_host, http_port, proxy_id, reuse
            )
            ray_api.get(p.ping.remote())
            started.append((proxy_id, p))
        for proxy_id, p in started:
            _register_proxy(_state["controller"], p, proxy_id)
        _state["proxies"] = [p for _, p in started]
        _state["proxy"] = _state["proxies"][0]
    return _state["controller"]


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: Optional[str] = None,
    _blocking: bool = True,
    _proxy: bool = True,
    _local_testing_mode: bool = False,
) -> DeploymentHandle:
    """Deploy an application and wait until it is RUNNING (reference:
    serve.run serve/api.py:681). ``_local_testing_mode=True`` runs every
    deployment in-process with no cluster (reference:
    serve/_private/local_testing_mode.py)."""
    if _local_testing_mode:
        from .local_mode import run_local

        return run_local(app, name)
    controller = start(proxy=_proxy)
    nodes = app._collect()
    ingress_name = app.root.deployment.name
    payload = []
    for node in nodes:
        cfg = node.deployment._config
        import dataclasses

        cfg = dataclasses.replace(cfg)
        if route_prefix is not None and node is app.root:
            cfg.route_prefix = route_prefix
        # ingress/streaming/ASGI detection: the proxy needs to know how to
        # talk to the app root (reference: the proxy always speaks ASGI to
        # ingress replicas, proxy.py:805; here plain JSON deployments keep
        # the request/response path and generator/ASGI roots stream)
        target = node.deployment._target
        cfg.asgi = cfg.asgi or getattr(
            target, "__ray_tpu_asgi_app__", None
        ) is not None
        call = target if not inspect.isclass(target) else getattr(
            target, "__call__", None
        )
        cfg.stream = cfg.stream or (
            call is not None
            and (
                inspect.isgeneratorfunction(call)
                or inspect.isasyncgenfunction(call)
            )
        )
        if node is app.root:
            cfg.ingress = True
        # nested bound deployments become handles at replica init time
        init_args = _replace_bound(node.init_args, controller, name)
        init_kwargs = _replace_bound(node.init_kwargs, controller, name)
        payload.append(
            dict(
                config=cfg,
                cls_bytes=serialization.dumps(node.deployment._target),
                init_args=init_args,
                init_kwargs=init_kwargs,
            )
        )
    ray_api.get(controller.deploy_application.remote(name, payload))
    _state["ingress"][name] = ingress_name
    handle = DeploymentHandle(controller, name, ingress_name)
    if _blocking:
        _wait_healthy(name)
    return handle


def _replace_bound(obj, controller, app_name):
    if isinstance(obj, Application):
        obj = obj.root
    if isinstance(obj, _BoundDeployment):
        return DeploymentHandle(controller, app_name, obj.deployment.name)
    if isinstance(obj, tuple):
        return tuple(_replace_bound(x, controller, app_name) for x in obj)
    if isinstance(obj, list):
        return [_replace_bound(x, controller, app_name) for x in obj]
    if isinstance(obj, dict):
        return {k: _replace_bound(v, controller, app_name) for k, v in obj.items()}
    return obj


def _wait_healthy(app_name: str, timeout_s: float = 60.0):
    import time

    controller = _state["controller"]
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        st = ray_api.get(controller.status.remote())
        app = st.get(app_name)
        if app is not None and app.status == "RUNNING":
            return
        time.sleep(0.2)
    raise TimeoutError(f"application {app_name!r} not healthy in {timeout_s}s")


def status() -> Dict[str, ApplicationStatus]:
    controller = _require_controller()
    return ray_api.get(controller.status.remote())


def get_app_handle(name: str = "default", _controller=None) -> DeploymentHandle:
    controller = _controller or _require_controller()
    ingress = _state["ingress"].get(name)
    if ingress is None:
        table = ray_api.get(controller.get_routing_table.remote(name))
        if not table:
            raise ValueError(f"no application named {name!r}")
        ingress = next(iter(table.keys()))
    return DeploymentHandle(controller, name, ingress)


def get_deployment_handle(
    deployment_name: str, app_name: str = "default"
) -> DeploymentHandle:
    return DeploymentHandle(_require_controller(), app_name, deployment_name)


def delete(name: str = "default"):
    controller = _require_controller()
    ray_api.get(controller.delete_application.remote(name))
    _state["ingress"].pop(name, None)


def shutdown():
    controller = _state["controller"]
    if controller is not None:
        try:
            ray_api.get(controller.shutdown.remote(), timeout=30)
            ray_api.kill(controller)
        except Exception:
            pass
    for p in list(_state.get("proxies") or []):
        try:
            ray_api.kill(p)
        except Exception:
            pass
    _state.update(controller=None, proxy=None, proxies=[], ingress={})


def _require_controller():
    if _state["controller"] is None:
        try:
            _state["controller"] = ray_api.get_actor(CONTROLLER_NAME)
        except ValueError:
            raise RuntimeError("serve is not running; call serve.run first")
    return _state["controller"]
