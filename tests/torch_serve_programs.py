"""The programs that tests/test_torch_serve.py and
tests/test_torch_serve_streaming.py run against both serve packages.

Each ``prog_*`` takes the runtime package (``ray_tpu`` or
``ray_tpu_torch``), runs one program of tests/test_serve.py,
tests/test_serve_ft.py or tests/test_serve_streaming.py through its
``serve``, and returns a plain value that the two runtimes must agree on.
The deployments are plain classes and functions defined here at the top
level, and each program wraps them with its package's
``serve.deployment``: the port's replicas import a callable by its module
and name (they have no cloudpickle), so this module imports nothing of
either package at its top. ``@serve.batch``, ``@serve.multiplexed`` and
``@serve.ingress`` are applied lazily, inside the replica, with the serve
package of the runtime initialized there (:func:`_serve`); a local-mode
program names its package with :func:`_use`.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import sys
import time
import urllib.error
import urllib.request

_local = {"serve": None}
#: the port of this process's HTTP proxy: ``run_programs`` starts it on a
#: free one (the reference's tests, which may run beside these, take 8000)
_http = {"port": 8000}


def _base() -> str:
    return f"http://127.0.0.1:{_http['port']}"


def _use(serve):
    """Name the serve package of a program that runs in this process (local
    mode), for the lazy decorators."""
    _local["serve"] = serve


def _serve():
    """The serve package of this process: a local-mode program's, else that
    of the runtime initialized here (a replica's)."""
    if _local["serve"] is not None:
        return _local["serve"]
    for name in ("ray_tpu_torch", "ray_tpu"):
        api = sys.modules.get(name + "._worker_api")
        if api is not None and api.is_initialized():
            return importlib.import_module(name + ".serve")
    raise RuntimeError("no serve package in this process")


def _batch(**kw):
    """``@serve.batch(**kw)`` of :func:`_serve`'s package, applied at the
    first call on each instance."""
    def deco(fn):
        attr = "_batched_" + fn.__name__

        async def wrapper(self, item):
            real = self.__dict__.get(attr)
            if real is None:
                real = self.__dict__[attr] = _serve().batch(**kw)(fn)
            return await real(self, item)

        wrapper.__name__ = fn.__name__
        return wrapper
    return deco


def _multiplexed(**kw):
    """``@serve.multiplexed(**kw)`` of :func:`_serve`'s package, applied at
    the first call on each instance."""
    def deco(fn):
        attr = "_mux_" + fn.__name__

        async def wrapper(self, model_id: str = ""):
            real = self.__dict__.get(attr)
            if real is None:
                real = self.__dict__[attr] = _serve().multiplexed(**kw)(fn)
            return await real(self, model_id)

        wrapper.__name__ = fn.__name__
        return wrapper
    return deco


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)
    return None


# -- deployments --------------------------------------------------------------


class Greeter:
    def __call__(self, name):
        return f"hello {name}"


def square(x):
    return x * x


class WhoAmI:
    def __init__(self):
        self.pid = os.getpid()

    def __call__(self, _):
        return self.pid


class Adder:
    def __init__(self, increment):
        self.increment = increment

    def __call__(self, x):
        return x + self.increment


class Chain:
    def __init__(self, adder):
        self.adder = adder

    def __call__(self, x):
        return self.adder.remote(x).result(timeout_s=30) * 10


class Multi:
    def __call__(self, x):
        return ("call", x)

    def other(self, x):
        return ("other", x)


class Configurable:
    def __init__(self):
        self.threshold = None

    def reconfigure(self, config):
        self.threshold = config["threshold"]

    def __call__(self, _):
        return self.threshold


class Fragile:
    def __call__(self, x):
        if x == "die":
            os._exit(1)
        return "alive"


class Echo:
    def __call__(self, body):
        return {"echo": body}

    def shout(self, payload):
        return str(payload).upper()


class Slow:
    def __call__(self, _):
        time.sleep(1.5)
        return "done"


class Temp:
    def __call__(self, _):
        return 1


class Batcher:
    @_batch(max_batch_size=4, batch_wait_timeout_s=0.2)
    async def handle(self, items):
        return [{"v": i * 2, "batch": len(items)} for i in items]

    async def __call__(self, x):
        return await self.handle(x)


class BadBatch:
    @_batch(max_batch_size=2, batch_wait_timeout_s=0.05)
    async def handle(self, items):
        raise RuntimeError("batch exploded")

    async def __call__(self, x):
        return await self.handle(x)


class MultiModel:
    def __init__(self):
        self.loads = []

    @_multiplexed(max_num_models_per_replica=2)
    async def get_model(self, model_id):
        self.loads.append(model_id)
        return {"id": model_id}

    async def __call__(self, _x):
        model = await self.get_model()
        return {"served_by": model["id"], "ctx": _serve().get_multiplexed_model_id(),
                "loads": list(self.loads)}


class Which:
    def __call__(self, request):
        return os.getpid()


class MuxBatcher:
    @_multiplexed(max_num_models_per_replica=2)
    async def get_model(self, model_id):
        return {"id": model_id}

    @_batch(max_batch_size=4, batch_wait_timeout_s=0.2)
    async def handle(self, items):
        model = await self.get_model()
        ctx = _serve().get_multiplexed_model_id()
        return [{"v": i, "model": model["id"], "ctx": ctx, "batch": len(items)}
                for i in items]

    async def __call__(self, x):
        return await self.handle(x)


class Doubler:
    def __call__(self, x):
        return x * 2


class Gateway:
    def __init__(self, doubler):
        self.doubler = doubler

    def __call__(self, x):
        return self.doubler.remote(x).result() + 1

    async def aecho(self, x):
        return x


class Batched:
    @_batch(max_batch_size=4, batch_wait_timeout_s=0.02)
    async def __call__(self, items):
        return [i + 100 for i in items]

    @_multiplexed(max_num_models_per_replica=2)
    async def get_model(self, model_id: str):
        return {"id": model_id}

    async def which_model(self):
        model = await self.get_model()
        return model["id"]


class IntAdder:
    def __call__(self, x):
        assert isinstance(x, int), f"chained arg not resolved: {x!r}"
        return x + 1


class PidEcho:
    def __call__(self, x):
        return ("pid", os.getpid(), x)


class SlowDouble:
    def __call__(self, x):
        time.sleep(0.8)
        return x * 2


class Steady:
    def __call__(self, x):
        time.sleep(0.5)
        return x + 100


class Svc:
    def __call__(self, x):
        return x


class Busy:
    def __call__(self, x):
        time.sleep(3.0)
        return x


class Stuck:
    def __call__(self, x):
        time.sleep(5.0)
        return x


class Flaky:
    def __call__(self, n):
        yield "first"
        raise ValueError("boom mid-stream")


class LocalGreeter:
    def __call__(self, name):
        return f"hi {name}"

    def stream_n(self, n):
        for i in range(n):
            yield i


class Streamer:
    def __call__(self, n):
        for i in range(n):
            if i > 0:
                time.sleep(1.5)
            yield {"chunk": i}


class AsyncStreamer:
    async def __call__(self, n):
        for i in range(n):
            await asyncio.sleep(0.01)
            yield i * 10


class NotAGen:
    def __call__(self, x):
        return x


class SlowTokens:
    def __call__(self, body):
        for i in range(3):
            if i > 0:
                time.sleep(1.5)
            yield {"token": i}


class SSEGen:
    def __call__(self, body):
        yield {"a": 1}
        yield {"a": 2}


class LocalGen:
    def __call__(self, n):
        for i in range(n):
            yield i + 100


class Work:
    def __call__(self, payload):
        time.sleep(0.15)
        return len(payload.get("token_ids", []))


async def _toy_asgi_app(scope, receive, send):
    """tests/test_serve_streaming.py's hand-written ASGI-3 app."""
    assert scope["type"] == "http"
    path = scope["path"]
    if path == "/hello":
        msg = await receive()
        body = msg.get("body", b"")
        replica = scope.get("ray_tpu.replica")
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"content-type", b"application/json"),
                                (b"x-served-by", b"asgi")]})
        await send({"type": "http.response.body", "body": json.dumps({
            "echo": body.decode() if body else "", "method": scope["method"],
            "has_replica": replica is not None}).encode()})
    elif path == "/stream":
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"content-type", b"text/plain")]})
        for i in range(3):
            await send({"type": "http.response.body", "body": f"part{i};".encode(),
                        "more_body": True})
            await asyncio.sleep(0.01)
        await send({"type": "http.response.body", "body": b"done"})
    else:
        await send({"type": "http.response.start", "status": 404, "headers": []})
        await send({"type": "http.response.body", "body": b"nope"})


_asgi_impls: dict = {}


class ASGIApp:
    """``@serve.ingress(_toy_asgi_app)`` of the replica's package: the app
    sits where ingress puts it, and ``__asgi__`` runs the package's own
    relay (built once per process from ``serve.ingress``)."""

    __ray_tpu_asgi_app__ = staticmethod(_toy_asgi_app)

    async def __asgi__(self, scope: dict, body: bytes):
        serve = _serve()
        impl = _asgi_impls.get(serve.__name__)
        if impl is None:
            impl = _asgi_impls[serve.__name__] = serve.ingress(_toy_asgi_app)(
                type("_Ingress", (), {})).__asgi__
        async for event in impl(self, scope, body):
            yield event


# -- helpers ----------------------------------------------------------------------


def _sub(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _testing(rt):
    return _sub(rt, "testing")


def _wait_replicas(rt, app, n, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        rows = [r for r in _testing(rt).list_serve_replicas(app)
                if r["state"] == "RUNNING" and r["pid"]]
        if len(rows) == n:
            return rows
        time.sleep(0.1)
    raise TimeoutError(f"{app}: never reached {n} RUNNING replicas with pids")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _post(url, data, headers=None, timeout=30):
    req = urllib.request.Request(url, data=data, headers=headers or {}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


# -- tests/test_serve.py ---------------------------------------------------------


def prog_basic_deployment_and_handle(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(Greeter).bind(), name="greet", _proxy=False)
    out = handle.remote("tpu").result(timeout_s=30)
    st = serve.status()["greet"]
    return out, st.status, st.deployments["Greeter"].status


def prog_function_deployment(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(square).bind(), name="sq", _proxy=False)
    return handle.remote(7).result(timeout_s=30)


def prog_multi_replica_load_balancing(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(WhoAmI, num_replicas=2).bind(), name="who",
                       _proxy=False)
    return len({handle.remote(None).result(timeout_s=30) for _ in range(20)})


def prog_composition_nested_handles(rt):
    serve = rt.serve
    app = serve.deployment(Chain).bind(serve.deployment(Adder).bind(3))
    handle = serve.run(app, name="chain", _proxy=False)
    return handle.remote(4).result(timeout_s=30)


def prog_method_routing(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(Multi).bind(), name="multi", _proxy=False)
    return [handle.remote(1).result(timeout_s=30),
            handle.other.remote(2).result(timeout_s=30)]


def prog_user_config_reconfigure(rt):
    """Re-deploying the same deployment name with a new user_config pushes
    it to the live replica (the reference test renames a second class to
    the first's name; one class does the same here)."""
    serve = rt.serve
    handle = serve.run(serve.deployment(Configurable, user_config={"threshold": 1}).bind(),
                       name="cfg", _proxy=False)
    first = handle.remote(None).result(timeout_s=30)
    serve.run(serve.deployment(Configurable, user_config={"threshold": 5}).bind(),
              name="cfg", _proxy=False)
    deadline = time.time() + 20
    while time.time() < deadline:
        if handle.remote(None).result(timeout_s=30) == 5:
            break
        time.sleep(0.3)
    return first, handle.remote(None).result(timeout_s=30)


def prog_replica_failure_recovery(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(Fragile).bind(), name="fragile", _proxy=False)
    first = handle.remote("ok").result(timeout_s=30)
    try:
        handle.remote("die").result(timeout_s=10)
    except Exception:
        pass
    deadline = time.time() + 60
    ok = False
    while time.time() < deadline:
        try:
            if handle.remote("ok").result(timeout_s=10) == "alive":
                ok = True
                break
        except Exception:
            time.sleep(0.5)
    return first, ok


def prog_http_proxy_end_to_end(rt):
    serve = rt.serve
    serve.run(serve.deployment(Echo).bind(), name="echo_app", route_prefix="/echo")
    deadline = time.time() + 30
    result = None
    while time.time() < deadline:
        try:
            with _post(f"{_base()}/echo", json.dumps({"msg": "hi"}).encode(),
                       {"Content-Type": "application/json"}, timeout=10) as resp:
                result = json.loads(resp.read())
            break
        except Exception:
            time.sleep(0.5)
    with urllib.request.urlopen(f"{_base()}/-/healthz", timeout=10) as resp:
        health = json.loads(resp.read())["status"]
    return result, health


def prog_autoscaling_up_and_down(rt):
    serve = rt.serve
    dep = serve.deployment(
        Slow,
        autoscaling_config=dict(min_replicas=1, max_replicas=3, target_ongoing_requests=1,
                                upscale_delay_s=0.5, downscale_delay_s=2.0),
        max_ongoing_requests=10,
    )
    handle = serve.run(dep.bind(), name="auto", _proxy=False)

    def n_running():
        st = serve.status()["auto"].deployments["Slow"]
        return sum(1 for r in st.replicas if r.state == "RUNNING")

    start = n_running()
    responses = [handle.remote(None) for _ in range(12)]
    deadline = time.time() + 45
    scaled = False
    while time.time() < deadline:
        if n_running() >= 2:
            scaled = True
            break
        responses.extend(handle.remote(None) for _ in range(3))
        time.sleep(0.5)
    for r in responses:
        try:
            r.result(timeout_s=60)
        except Exception:
            pass
    deadline = time.time() + 60
    downscaled = False
    while time.time() < deadline:
        if n_running() <= 2:
            downscaled = True
            break
        time.sleep(0.5)
    return start, scaled, downscaled


def prog_delete_application(rt):
    serve = rt.serve
    serve.run(serve.deployment(Temp).bind(), name="temp", _proxy=False)
    before = "temp" in serve.status()
    serve.delete("temp")
    return before, "temp" in serve.status()


def prog_serve_batch_accumulates(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(Batcher).bind(), name="batch-app", _proxy=False)
    responses = [handle.remote(i) for i in range(8)]
    results = [r.result(timeout_s=60) for r in responses]
    serve.delete("batch-app")
    return [r["v"] for r in results], max(r["batch"] for r in results) >= 2


def prog_serve_batch_error_propagates(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(BadBatch).bind(), name="badbatch-app",
                       _proxy=False)
    raised = _raised(lambda: handle.remote(1).result(timeout_s=60))
    serve.delete("badbatch-app")
    return raised is not None and "batch exploded" in raised[1]


def prog_serve_multiplexed_lru(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(MultiModel).bind(), name="mux-app", _proxy=False)

    def ask(m):
        return handle.options(multiplexed_model_id=m).remote(0).result(timeout_s=60)

    r1 = ask("m1")
    ask("m2")
    r3 = ask("m1")
    ask("m3")
    r5 = ask("m2")
    serve.delete("mux-app")
    return (r1["served_by"], r1["ctx"], r3["loads"].count("m1"), r5["loads"].count("m2"),
            r5["loads"])


def prog_prefix_affinity_routes_same_prompt_to_same_replica(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(Which, num_replicas=2).bind(),
                       name="affinity-app", _proxy=False)
    affine = handle.options(prefix_affinity_tokens=8)
    prompt = {"token_ids": [5, 6, 7, 8, 9, 10, 11, 12], "max_new_tokens": 2}
    pids = {affine.remote(dict(prompt)).result(timeout_s=60) for _ in range(6)}
    longer = {"token_ids": prompt["token_ids"] + [99, 98], "max_new_tokens": 2}
    colocated = affine.remote(longer).result(timeout_s=60) in pids
    serve.delete("affinity-app")
    return len(pids), colocated


def prog_serve_batch_composes_with_multiplex(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(MuxBatcher).bind(), name="muxbatch-app",
                       _proxy=False)
    responses = [(f"m{1 + i % 2}",
                  handle.options(multiplexed_model_id=f"m{1 + i % 2}").remote(i))
                 for i in range(8)]
    results = [(m, r.result(timeout_s=60)) for m, r in responses]
    serve.delete("muxbatch-app")
    return ([(out["v"], out["model"] == m, out["ctx"] == m) for m, out in results],
            max(out["batch"] for _m, out in results) >= 2)


def prog_response_chaining(rt):
    serve = rt.serve
    serve.run(serve.deployment(Doubler).bind(), name="chain_doubler", _proxy=False)
    serve.run(serve.deployment(IntAdder).bind(), name="chain_adder", _proxy=False)
    try:
        doubler = serve.get_app_handle("chain_doubler")
        adder = serve.get_app_handle("chain_adder")
        return adder.remote(doubler.remote(20)).result(timeout_s=60)
    finally:
        serve.delete("chain_doubler")
        serve.delete("chain_adder")


def prog_controller_crash_recovery(rt):
    import signal

    serve = rt.serve
    node = _sub(rt, "_worker_api").get_node()
    serve.start(proxy=False)
    handle = serve.run(serve.deployment(PidEcho, num_replicas=2, name="Echo").bind(),
                       name="crashapp", _proxy=False)
    first = handle.remote(1).result(timeout_s=60)[2]

    def replica_ids():
        st = serve.status()["crashapp"]
        return sorted(r.replica_id for dep in st.deployments.values()
                      for r in dep.replicas if r.state == "RUNNING")

    before = replica_ids()
    ctrl_pids = [lease.worker.pid for lease in node.raylet._leases.values()
                 if getattr(lease.spec, "actor_name", None) == "SERVE_CONTROLLER"]
    os.kill(ctrl_pids[0], signal.SIGKILL)
    during = [handle.remote(i).result(timeout_s=60)[2] for i in range(10)]
    deadline = time.time() + 120
    after = None
    while time.time() < deadline:
        try:
            after = replica_ids()
            if after == before:
                break
        except Exception:
            pass
        time.sleep(0.5)
    serve.delete("crashapp")
    return first, len(before), len(ctrl_pids), during, after == before


# -- tests/test_serve_ft.py -------------------------------------------------------


def prog_kill_replica_mid_request_failover(rt):
    serve = rt.serve
    counters = _sub(rt, "util.metrics").serve_ft_counters
    handle = serve.run(serve.deployment(SlowDouble, num_replicas=2).bind(), name="killapp",
                       _proxy=False)
    _wait_replicas(rt, "killapp", 2)
    before = counters()["retries"]
    responses = [handle.remote(i) for i in range(8)]
    time.sleep(0.3)
    rid, pid = _testing(rt).kill_serve_replica("killapp")
    results = sorted(r.result(timeout_s=30) for r in responses)
    return rid is not None and bool(pid), results, counters()["retries"] > before


def prog_drain_on_scale_down_zero_dropped(rt):
    serve = rt.serve
    dep = serve.deployment(Steady, num_replicas=2, graceful_shutdown_timeout_s=10.0)
    handle = serve.run(dep.bind(), name="drainapp", _proxy=False)
    _wait_replicas(rt, "drainapp", 2)
    responses = [handle.remote(i) for i in range(10)]
    time.sleep(0.2)
    serve.run(dep.options(num_replicas=1).bind(), name="drainapp", _proxy=False,
              _blocking=False)
    results = sorted(r.result(timeout_s=30) for r in responses)
    return results, len(_wait_replicas(rt, "drainapp", 1))


def prog_drain_replica_replacement(rt):
    serve = rt.serve
    serve.run(serve.deployment(Svc, num_replicas=2).bind(), name="drainone", _proxy=False)
    rows = _wait_replicas(rt, "drainone", 2)
    victim = rows[0]["replica_id"]
    controller = rt.get_actor("SERVE_CONTROLLER")
    acked = rt.get(controller.drain_replica.remote("drainone", victim), timeout=10)
    deadline = time.time() + 30
    while time.time() < deadline:
        rows = _wait_replicas(rt, "drainone", 2)
        if all(r["replica_id"] != victim for r in rows):
            return acked, True
        time.sleep(0.1)
    return acked, False


def prog_shed_under_overload(rt):
    serve = rt.serve
    exceptions = _sub(rt, "exceptions")
    dep = serve.deployment(Busy, max_ongoing_requests=1, max_queued_requests=1,
                           request_router_config={"retry_backpressure": False})
    handle = serve.run(dep.bind(), name="shedapp", _proxy=False)
    _wait_replicas(rt, "shedapp", 1)
    fillers = [handle.remote(i) for i in range(2)]
    time.sleep(0.5)
    t0 = time.time()
    try:
        handle.remote(99).result(timeout_s=10)
        shed = None
    except exceptions.BackPressureError as e:
        shed = ("BackPressureError", e.retry_after_s > 0)
    elapsed = time.time() - t0
    return shed, elapsed < 1.0, sorted(f.result(timeout_s=30) for f in fillers)


def prog_dead_on_arrival_rejected_by_replica(rt):
    serve = rt.serve
    exceptions = _sub(rt, "exceptions")
    serve.run(serve.deployment(Svc, name="Echo").bind(), name="doaapp", _proxy=False)
    _wait_replicas(rt, "doaapp", 1)
    controller = rt.get_actor("SERVE_CONTROLLER")
    table = rt.get(controller.get_routing_table.remote("doaapp"))
    _rid, replica, _q = table["Echo"]["replicas"][0]
    try:
        rt.get(replica.handle_request.remote(
            "__call__", (1,), {}, {"deadline_ts": time.time() - 5.0}), timeout=10)
        doa = False
    except Exception as e:  # noqa: BLE001
        doa = isinstance(getattr(e, "cause", e), exceptions.DeadlineExceededError)
    metrics = rt.get(replica.get_metrics.remote(), timeout=10)
    return doa, metrics["doa_total"] >= 1


def prog_caller_deadline_bounds_result(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(Stuck).bind(), name="deadlineapp", _proxy=False)
    _wait_replicas(rt, "deadlineapp", 1)
    t0 = time.time()
    try:
        handle.options(timeout_s=0.5).remote(1).result()
        timed_out = False
    except TimeoutError:
        timed_out = True
    return timed_out, time.time() - t0 < 3.0


class _BoomMethod:
    def remote(self, *a, **k):
        raise ConnectionError("controller unreachable")


class _DeadController:
    def __getattr__(self, name):
        return _BoomMethod()


def prog_stale_routing_table_failover(rt):
    serve = rt.serve
    Router = _sub(rt, "serve.handle").Router
    serve.run(serve.deployment(Svc, name="Ok").bind(), name="staleapp", _proxy=False)
    _wait_replicas(rt, "staleapp", 1)
    controller = rt.get_actor("SERVE_CONTROLLER")
    router = Router(controller, "staleapp")
    rid, _ = router.pick("Ok")
    router._controller = _DeadController()
    router._refresh(force=True)
    rid2, replica = router.pick("Ok", force_refresh=True)
    value = rt.get(replica.handle_request.remote("__call__", (7,), {}, {}), timeout=10)
    fresh = _raised(lambda: Router(_DeadController(), "staleapp").pick("Ok"))
    return rid is not None, rid2 == rid, value, fresh is not None


def prog_stream_error_closes_generator(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(Flaky).bind(), name="flakystream", _proxy=False)
    _wait_replicas(rt, "flakystream", 1)
    gen = handle.options(stream=True).remote(2)
    first = next(gen)
    err = _raised(lambda: next(gen))
    try:
        next(gen)
        stopped = False
    except StopIteration:
        stopped = True
    return first, err is not None and "boom mid-stream" in err[1], stopped


# -- local mode (no cluster) ---------------------------------------------------------


def prog_local_testing_mode_no_cluster(rt):
    serve = rt.serve
    app = serve.deployment(Gateway).bind(serve.deployment(Doubler).bind())
    handle = serve.run(app, _local_testing_mode=True)
    return handle.remote(10).result(), handle.options(method_name="aecho").remote("hi").result()


def prog_local_testing_mode_batching_and_multiplex(rt):
    serve = rt.serve
    _use(serve)
    try:
        handle = serve.run(serve.deployment(Batched).bind(), _local_testing_mode=True)
        rs = [handle.remote(i) for i in range(4)]
        out = [r.result(5) for r in rs]
        model = (handle.options(multiplexed_model_id="m7", method_name="which_model")
                 .remote().result(5))
        return out, model
    finally:
        _use(None)


def prog_local_mode_parity_new_knobs(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(LocalGreeter, name="Greeter").bind(), name="localft",
                       _local_testing_mode=True)
    h = handle.options(timeout_s=5.0, prefix_affinity_tokens=4)
    return h.remote("x").result(), list(h.options(method_name="stream_n", stream=True).remote(3))


def prog_local_mode_streaming(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(LocalGen).bind(), name="lm", _local_testing_mode=True)
    return list(handle.options(stream=True).remote(3))


# -- tests/test_serve_streaming.py -----------------------------------------------------


def prog_handle_streaming_first_item_before_completion(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(Streamer).bind(), name="stream1", _proxy=False)
    gen = handle.options(stream=True).remote(3)
    kind = type(gen).__name__
    t0 = time.time()
    first = next(gen)
    first_latency = time.time() - t0
    return kind, first, first_latency < 1.4, list(gen)


def prog_handle_streaming_async_generator(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(AsyncStreamer).bind(), name="stream2", _proxy=False)
    return list(handle.options(stream=True).remote(4))


def prog_handle_streaming_non_generator_errors(rt):
    serve = rt.serve
    handle = serve.run(serve.deployment(NotAGen).bind(), name="stream3", _proxy=False)
    err = _raised(lambda: list(handle.options(stream=True).remote(1)))
    return err is not None and "generator" in err[1]


def prog_http_streaming_ndjson(rt):
    serve = rt.serve
    serve.run(serve.deployment(SlowTokens).bind(), name="htstream")
    t0 = time.time()
    with _post(f"{_base()}/htstream", json.dumps({}).encode()) as resp:
        ctype = resp.headers.get("Content-Type", "").startswith("application/x-ndjson")
        first_line = resp.readline()
        first_latency = time.time() - t0
        rest = [ln for ln in resp.read().splitlines() if ln.strip()]
    return (ctype, json.loads(first_line), first_latency < 1.4,
            [json.loads(ln) for ln in rest])


def prog_http_streaming_sse(rt):
    serve = rt.serve
    serve.run(serve.deployment(SSEGen).bind(), name="ssestream")
    with _post(f"{_base()}/ssestream", b"{}",
               {"Accept": "text/event-stream"}) as resp:
        ctype = resp.headers.get("Content-Type", "").startswith("text/event-stream")
        payload = resp.read().decode()
    return ctype, [json.loads(line[len("data: "):]) for line in payload.splitlines()
                   if line.startswith("data: ")]


def prog_asgi_ingress_end_to_end(rt):
    serve = rt.serve
    serve.run(serve.deployment(ASGIApp).bind(), name="asgiapp")
    with _post(f"{_base()}/asgiapp/hello", b"ping") as resp:
        hello = (resp.status, resp.headers["x-served-by"], json.loads(resp.read()))
    with urllib.request.urlopen(f"{_base()}/asgiapp/stream", timeout=30) as resp:
        streamed = resp.read().decode()
    try:
        urllib.request.urlopen(f"{_base()}/asgiapp/missing", timeout=30)
        missing = None
    except urllib.error.HTTPError as e:
        missing = e.code
    return hello, streamed, missing


# -- running the programs ---------------------------------------------------------------


def run_one(prog, rt):
    """``prog(rt)``, or what it raised (a failing program fails its own
    test)."""
    try:
        return prog(rt)
    except Exception as e:  # noqa: BLE001
        return ("raised", type(e).__name__, str(e)[:300])


def delete_apps(rt):
    """Delete every app, as the reference tests' autouse fixture does."""
    try:
        for app in list(rt.serve.status().keys()):
            rt.serve.delete(app)
    except Exception:  # noqa: BLE001 - as the reference's fixture
        pass


def run_programs(names, port_extra=None, num_cpus=8, http=False):
    """Each named program against ray_tpu, then against ray_tpu_torch, each
    on a single-node cluster of ``num_cpus`` CPUs and 4 ``TPU`` units shut
    down before the next starts; ``port_extra(rt)`` runs last on the port's
    cluster (under ``"extra"``). With ``http``, each cluster's serve starts
    its proxy on a free port first. No program touches jax, so the
    reference's workers are started without tests/conftest.py's platform
    pin, which would have them import it."""
    out = {}
    pinned = os.environ.pop("RAY_TPU_JAX_PLATFORM", None)
    try:
        for key, name in (("ref", "ray_tpu"), ("port", "ray_tpu_torch")):
            rt = importlib.import_module(name)
            importlib.import_module(name + ".serve")
            importlib.import_module(name + ".testing")
            rt.init(num_cpus=num_cpus, resources={"TPU": 4})
            try:
                if http:
                    _http["port"] = _free_port()
                    rt.serve.start(http_port=_http["port"])
                res = {}
                for prog_name in names:
                    res[prog_name] = run_one(SERVE_PROGRAMS[prog_name], rt)
                    delete_apps(rt)
                if key == "port" and port_extra is not None:
                    res["extra"] = port_extra(rt)
                out[key] = res
            finally:
                try:
                    rt.serve.shutdown()
                finally:
                    rt.shutdown()
    finally:
        if pinned is not None:
            os.environ["RAY_TPU_JAX_PLATFORM"] = pinned
    return out


SERVE_PROGRAMS = {
    name: fn for name, fn in globals().items()
    if name.startswith("prog_") and fn.__module__ == __name__
}


class CardReport:
    """What a replica's lease and its request thread say of the card: the
    lease's GPU ids and the thread's current CUDA device."""

    def __call__(self, _):
        import torch

        return _serve_runtime().get_gpu_ids(), torch.cuda.current_device(), os.getpid()


def _serve_runtime():
    return sys.modules[_serve().__name__.rsplit(".", 1)[0]]


class CardActor:
    """An actor's lease and its executor thread's current CUDA device."""

    def device(self):
        import torch

        return _serve_runtime().get_gpu_ids(), torch.cuda.current_device()


def adapter_source(adapter_id: str):
    """An ``AdapterConfig.source`` for the tiny f32 model at max_seq_len 64
    (n_kv_heads 2, rank 4): a nested numpy adapter tree in the reference's
    form, drawn from a seed named by the id, so that every replica and the
    in-process reference build the same one."""
    import numpy as np

    from ray_tpu_torch.lora import adapter_target_paths
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(max_seq_len=64, n_kv_heads=2)
    rng = np.random.default_rng(sum(adapter_id.encode()))
    tree: dict = {}
    for path, d_in, d_out in adapter_target_paths(cfg):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {
            "lora_a": rng.normal(0.0, 0.5, (d_in, 4)).astype(np.float32),
            "lora_b": rng.normal(0.0, 0.5, (4, d_out)).astype(np.float32),
        }
    return tree


def replica_calls(rt, app, deployment, method, *args):
    """``method(*args)`` on every RUNNING replica of a deployment, through
    each replica's own actor (a handle would route to one of them)."""
    controller = rt.get_actor("SERVE_CONTROLLER")
    table = rt.get(controller.get_routing_table.remote(app), timeout=10)
    return {rid: rt.get(replica.handle_request.remote(method, args, {}, {}), timeout=60)
            for rid, replica, _q in table[deployment]["replicas"]}
