"""The programs that tests/test_torch_runtime.py and
tests/test_torch_device_objects.py run against both runtimes.

Each ``prog_*`` takes the runtime package (``ray_tpu`` or
``ray_tpu_torch``), runs one program of ``tests/test_core_api.py`` or
``tests/test_device_objects.py`` through it, and returns a plain value that
the two runtimes must agree on. The remote functions and classes are
defined here at the top level, undecorated, and each program wraps them with
its runtime's ``remote``: the port's workers import a callable by its
module and name (they have no cloudpickle), so this module imports nothing
of either package, nor torch or jax, at its top. Code that runs inside a
worker finds its runtime with :func:`_rt` and its array library (torch
under the port, jax.numpy under the reference) with :func:`_lib`.
"""

from __future__ import annotations

import importlib
import sys
import time

import numpy as np


def _rt():
    """The runtime package initialized in this process."""
    for name in ("ray_tpu_torch", "ray_tpu"):
        api = sys.modules.get(name + "._worker_api")
        if api is not None and api.is_initialized():
            return sys.modules[name]
    raise RuntimeError("no runtime is initialized in this process")


def _sub(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _lib():
    """torch in a port process, jax.numpy in a reference one."""
    if _rt().__name__ == "ray_tpu_torch":
        import torch

        return torch
    import jax.numpy as jnp

    return jnp


def _device_transport(fn):
    """``@method(tensor_transport="device")`` of either runtime: both read
    these options from the method (this module imports neither)."""
    fn.__ray_tpu_method_options__ = {"tensor_transport": "device"}
    return fn


# -- remote bodies ---------------------------------------------------------------


def add(a, b):
    return a + b


def sq(x):
    return x * x


def total(*xs):
    return sum(xs)


def make_ones():
    return np.ones((512, 512))


def consume(a):
    return float(a.sum())


def boom():
    raise ValueError("kaboom")


def three():
    return 1, 2, 3


def fast():
    return 1


def slow():
    time.sleep(30)
    return 2


def inner(x):
    return x + 1


def outer(x):
    rt = _rt()
    return rt.get(rt.remote(inner).remote(x)) * 10


class Counter:
    def __init__(self, start=0):
        self.v = start

    def inc(self, n=1):
        self.v += n
        return self.v


class Crashy:
    def fail(self):
        raise RuntimeError("actor method failed")

    def ok(self):
        return "fine"


class Registry:
    def whoami(self):
        return "registry"


class Store:
    def __init__(self):
        self.v = {}

    def set(self, k, v):
        self.v[k] = v
        return True

    def get(self, k):
        return self.v.get(k)


def writer(store):
    return _rt().get(store.set.remote("x", 42))


class Victim:
    def ping(self):
        return "pong"


def where():
    """This worker's view of its lease and of what it has imported."""
    import os

    rt = _rt()
    mods = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "cloudpickle", "ray_tpu", "torch"))
    return {"pid": os.getpid(), "gpu_ids": rt.get_gpu_ids(), "modules": mods}


class Where:
    def where(self):
        return where()

    def device(self):
        import torch

        return where()["gpu_ids"], torch.cuda.current_device()


# -- tests/test_core_api.py's programs -----------------------------------------------


def prog_task_roundtrip(rt):
    return rt.get(rt.remote(add).remote(1, 2), timeout=120)


def prog_task_graph_by_ref(rt):
    refs = [rt.remote(sq).remote(i) for i in range(8)]
    return rt.get(rt.remote(total).remote(*refs), timeout=120)


def prog_put_get_small_and_large(rt):
    small = rt.put({"a": 1})
    arr = np.arange(300_000, dtype=np.float32)  # > 100KB -> the shared store
    got = rt.get(rt.put(arr), timeout=60)
    return rt.get(small, timeout=60), bool(np.array_equal(got, arr)), got.dtype.str


def prog_plasma_task_returns(rt):
    ref = rt.remote(make_ones).remote()
    return rt.get(rt.remote(consume).remote(ref), timeout=120)


def prog_error_propagation(rt):
    try:
        rt.get(rt.remote(max_retries=0)(boom).remote(), timeout=120)
    except rt.exceptions.TaskError as e:
        return type(e).__name__, type(e.cause).__name__, "kaboom" in str(e)
    return "no error"


def prog_num_returns(rt):
    a, b, c = rt.remote(num_returns=3)(three).remote()
    return rt.get([a, b, c], timeout=120)


def prog_nested_tasks(rt):
    return rt.get(rt.remote(outer).remote(3), timeout=120)


def prog_actor_basic_and_ordering(rt):
    c = rt.remote(Counter).remote(100)
    return rt.get([c.inc.remote() for _ in range(10)], timeout=120)


def prog_actor_exceptions(rt):
    a = rt.remote(Crashy).remote()
    try:
        rt.get(a.fail.remote(), timeout=120)
        raised = "no error"
    except rt.exceptions.TaskError as e:
        raised = type(e).__name__
    return raised, rt.get(a.ok.remote(), timeout=120)  # the actor survives


def prog_named_actor_get_actor(rt):
    original = rt.remote(Registry).options(name="reg1").remote()
    handle = rt.get_actor("reg1")
    out = rt.get(handle.whoami.remote(), timeout=120)
    del original  # handle GC terminates the non-detached actor
    return out


def prog_actor_handle_passing(rt):
    s = rt.remote(Store).remote()
    ok = rt.get(rt.remote(writer).remote(s), timeout=120)
    return ok, rt.get(s.get.remote("x"), timeout=120)


def prog_kill_actor(rt):
    v = rt.remote(Victim).remote()
    first = rt.get(v.ping.remote(), timeout=120)
    rt.kill(v)
    try:
        rt.get(v.ping.remote(), timeout=120)
        after = "no error"
    except rt.exceptions.ActorDiedError as e:
        after = type(e).__name__
    return first, after


def prog_cluster_resources(rt):
    total_ = rt.cluster_resources()
    return total_["CPU"], total_["TPU"], len(rt.nodes())


def prog_placement_group_bundles(rt):
    pg_mod = _sub(rt, "util.placement_group")
    strategies = _sub(rt, "util.scheduling_strategies")
    pg = pg_mod.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    ready = pg.wait(60)
    out = [
        rt.get(rt.remote(add).options(
            scheduling_strategy=strategies.PlacementGroupSchedulingStrategy(pg, i)
        ).remote(i, 10), timeout=120)
        for i in range(pg.bundle_count)
    ]
    info = pg.info()
    pg_mod.remove_placement_group(pg)  # give the bundles' CPUs back
    return ready, pg.bundle_count, out, info.strategy.name, [dict(b.resources) for b in info.bundles]


def prog_wait(rt):
    f, s = rt.remote(fast).remote(), rt.remote(slow).remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=60)
    return ready == [f] and not_ready == [s]


# -- tests/test_device_objects.py's programs -------------------------------------------


class Producer:
    @_device_transport
    def make(self, n):
        lib = _lib()
        return {"w": lib.arange(n, dtype=lib.float32), "step": 3}

    @_device_transport
    def double_local(self, ref):
        # the ref resolves zero-copy from this actor's own device store
        return {k: v * 2 if hasattr(v, "shape") else v for k, v in ref.items()}

    def scalar(self):
        return 42

    @_device_transport
    def same_storage(self, ref, ref_id):
        """Whether a resolved argument is the stored tensor itself."""
        dev = _sub(_rt(), "experimental.device_objects")
        return ref["w"].data_ptr() == dev._store[ref_id]["w"].data_ptr()

    def stored(self):
        return len(_sub(_rt(), "experimental.device_objects")._store)


class Consumer:
    @_device_transport
    def total(self, tree):
        # the tree arrives resolved (fetched from the producer worker)
        return float(tree["w"].sum()) + tree["step"]


class NestedConsumer:
    @_device_transport
    def sum_nested(self, payload):
        tree = payload["inner"][0]
        return float(tree["w"].sum())


def prog_device_ref_roundtrip(rt):
    dev = _sub(rt, "experimental")
    # both actors first, so that their workers start together
    p, c = rt.remote(Producer).remote(), rt.remote(Consumer).remote()
    ref = rt.get(p.make.remote(8))
    # the consumer on another worker fetches the payload worker to worker
    return isinstance(ref, dev.DeviceObjectRef), "arrays" in ref.spec, rt.get(c.total.remote(ref))


def prog_local_zero_copy_and_chaining(rt):
    dev = _sub(rt, "experimental")
    p, c = rt.remote(Producer).remote(), rt.remote(Consumer).remote()
    ref = rt.get(p.make.remote(4))
    ref2 = rt.get(p.double_local.remote(ref))
    return isinstance(ref2, dev.DeviceObjectRef), rt.get(c.total.remote(ref2))


def prog_scalar_results_pass_through(rt):
    p = rt.remote(Producer).remote()
    return rt.get(p.scalar.remote())


def prog_driver_side_get_and_free(rt):
    dev = _sub(rt, "experimental")
    p = rt.remote(Producer).remote()
    ref = rt.get(p.make.remote(5))
    tree = dev.device_get(ref, to_device=False)
    freed = dev.free_device_object(ref)
    try:
        dev.device_get(ref, to_device=False)
        after = "no error"
    except KeyError as e:
        after = type(e).__name__
    return float(tree["w"].sum()), tree["step"], freed, after


def prog_device_put_from_driver(rt, ones):
    dev = _sub(rt, "experimental")
    value = {"x": ones}
    ref = dev.device_put_object(value)
    tree = dev.device_get(ref, to_device=False)  # a local hit: the very pytree
    # an actor doubles the driver-owned object (the worker fetches from the
    # driver); the driver fetches the doubled result back from the worker
    p = rt.remote(Producer).remote()  # the handle outlives the fetch-back
    ref2 = rt.get(p.double_local.remote(ref))
    tree2 = dev.device_get(ref2, to_device=False)
    return tree is value, tuple(tree["x"].shape), float(tree2["x"].sum())


def prog_nested_refs_resolve(rt):
    p, n = rt.remote(Producer).remote(), rt.remote(NestedConsumer).remote()
    r1 = rt.get(p.make.remote(3))
    return rt.get(n.sum_nested.remote({"inner": [r1]}))


DEVICE_PROGRAMS = {
    name: globals()[name] for name in (
        "prog_device_ref_roundtrip", "prog_local_zero_copy_and_chaining",
        "prog_scalar_results_pass_through", "prog_driver_side_get_and_free",
        "prog_device_put_from_driver", "prog_nested_refs_resolve")
}


def identity(x):
    return x


#: in the order they run: ``prog_wait`` leaves a task sleeping, so it is last
CORE_PROGRAMS = {
    name: fn for name, fn in list(globals().items()) if name.startswith("prog_")
    and name != "prog_wait" and name not in DEVICE_PROGRAMS
}
CORE_PROGRAMS["prog_wait"] = prog_wait
