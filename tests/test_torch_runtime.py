"""The port's runtime core (ray_tpu_torch: init, remote, get, put, wait,
kill, get_actor, placement groups) against ray_tpu's.

Every program of tests/test_core_api.py, and a placement group's bundles,
runs against ``ray_tpu`` and then against ``ray_tpu_torch``
(tests/torch_runtime_programs.py), each on a single-node cluster of 4 CPUs
and 4 ``TPU`` custom units, one cluster per runtime for the whole file and
never both at once; the two runtimes' results must be equal, and equal to
what test_core_api.py asserts. The port's own rules are checked on the
port's cluster: its workers import no jax, cloudpickle or ray_tpu, a
CPU-only worker no torch; a GPU demand on a node without a card fails
instead of waiting; a callable a worker cannot import is refused at
``.remote()``. Then, on their own: the accelerator plugin against the
reference's on the same environments, lease binding on a fake two-card
node (kept item 34), callables by reference (35), tensors as raw bytes
(36) and GPU detection where /proc hides the card (37).
"""

from __future__ import annotations

import importlib
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch  # the real torch, cached before any test puts the fake one on the path

import ray_tpu_torch
import torch_runtime_programs as P

_HERE = Path(__file__).resolve().parent

#: what tests/test_core_api.py asserts of each program
EXPECTED = {
    "prog_task_roundtrip": 3,
    "prog_task_graph_by_ref": sum(i * i for i in range(8)),
    "prog_put_get_small_and_large": ({"a": 1}, True, "<f4"),
    "prog_plasma_task_returns": 512.0 * 512,
    "prog_error_propagation": ("TaskError", "ValueError", True),
    "prog_num_returns": [1, 2, 3],
    "prog_nested_tasks": 40,
    "prog_actor_basic_and_ordering": list(range(101, 111)),
    "prog_actor_exceptions": ("TaskError", "fine"),
    "prog_named_actor_get_actor": "registry",
    "prog_actor_handle_passing": (True, 42),
    "prog_kill_actor": ("pong", "ActorDiedError"),
    "prog_cluster_resources": (4.0, 4.0, 1),
    "prog_placement_group_bundles": (True, 2, [10, 11], "PACK", [{"CPU": 1.0}, {"CPU": 1.0}]),
    "prog_wait": True,
}


def _run(prog, rt):
    try:
        return prog(rt)
    except Exception as e:  # noqa: BLE001 - one failing program fails its own test
        return ("raised", type(e).__name__, str(e)[:300])


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)
    return None


def _port_checks(rt):
    """The port's own rules, on its cluster (a node detected without a
    card: the tests run on the CPU)."""
    out = {"cpu_worker": rt.get(rt.remote(P.where).remote(), timeout=120)}
    out["gpu_task"] = _raises(lambda: rt.get(
        rt.remote(num_gpus=1)(P.add).remote(1, 2), timeout=60))
    gpu_actor = rt.remote(num_gpus=1)(P.Where).remote()
    out["gpu_actor"] = _raises(lambda: rt.get(gpu_actor.where.remote(), timeout=60))

    def nested():
        return 1

    out["nested"] = _raises(lambda: rt.remote(nested).remote())
    out["lambda"] = _raises(lambda: rt.remote(lambda: 1).remote())
    in_main = type(P.add)(P.add.__code__, {}, "in_main")
    in_main.__module__, in_main.__qualname__ = "__main__", "in_main"
    out["main"] = _raises(lambda: rt.remote(in_main).remote())
    return out


@pytest.fixture(scope="module")
def runs():
    """Every program against ray_tpu, then against ray_tpu_torch; each
    cluster is shut down before the next starts."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # no program touches jax: the reference's workers need not import it
        # at their start (tests/conftest.py's pin)
        mp.delenv("RAY_TPU_JAX_PLATFORM", raising=False)
        for key, name in (("ref", "ray_tpu"), ("port", "ray_tpu_torch")):
            rt = importlib.import_module(name)
            rt.init(num_cpus=4, resources={"TPU": 4})
            try:
                if key == "port":
                    out["port_checks"] = _port_checks(rt)
                out[key] = {prog_name: _run(prog, rt)
                            for prog_name, prog in P.CORE_PROGRAMS.items()}
            finally:
                rt.shutdown()
    return out


@pytest.mark.parametrize("name", list(P.CORE_PROGRAMS))
def test_program_matches_reference(runs, name):
    assert runs["ref"][name] == EXPECTED[name]
    assert runs["port"][name] == runs["ref"][name]


def test_port_worker_imports_no_jax_cloudpickle_ray_tpu_or_torch(runs):
    """A worker that ran a CPU task holds none of jax, flax, cloudpickle,
    ray_tpu or torch in sys.modules."""
    assert runs["port_checks"]["cpu_worker"]["modules"] == []
    assert runs["port_checks"]["cpu_worker"]["gpu_ids"] == []


def test_gpu_demand_without_a_card_fails_not_waits(runs):
    """No node has a GPU: a num_gpus=1 task raises TaskUnschedulableError and
    a num_gpus=1 actor dies unschedulable (ray_tpu would leave both waiting),
    never a run on the CPU."""
    name, msg = runs["port_checks"]["gpu_task"]
    assert name == "TaskUnschedulableError" and "GPU" in msg
    name, msg = runs["port_checks"]["gpu_actor"]
    assert name == "ActorDiedError" and "ActorUnschedulableError" in msg and "GPU" in msg


def test_unimportable_callables_raise_at_remote(runs):
    checks = runs["port_checks"]
    assert checks["nested"][0] == "ValueError" and "nested" in checks["nested"][1]
    assert "inside a function" in checks["nested"][1]
    assert checks["lambda"][0] == "ValueError" and "<lambda>" in checks["lambda"][1]
    assert checks["main"][0] == "ValueError" and "__main__.in_main" in checks["main"][1]


# -- accelerators against the reference's plugin -------------------------------------


def _accs():
    from ray_tpu._internal import accelerators as ref
    from ray_tpu_torch._internal import accelerators as port

    return ref, port


@pytest.mark.parametrize("mask,count", [("0,1,2", 3), ("", 0), ("-1", 0), ("2,3", 2)])
def test_gpu_count_from_the_mask_matches_reference(monkeypatch, mask, count):
    ref, port = _accs()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", mask)
    assert port.GpuAcceleratorManager.get_current_node_num_accelerators() == count
    assert ref.GpuAcceleratorManager.get_current_node_num_accelerators() == count
    assert port.detect_node_accelerators()[0].get("GPU", 0.0) == float(count)
    # num_gpus=0 opts out of the plugin wholesale, as num_tpus=0 does
    assert "GPU" not in port.detect_node_accelerators(exclude={"GPU"})[0]


@pytest.mark.parametrize("mask,ids", [("2,3", [0, 1]), ("2,3", [1]), (None, [0, 1]),
                                      ("5", [0]), ("2,3", [2])])
def test_binding_remaps_through_parent_mask_as_reference(monkeypatch, mask, ids):
    """The card a worker binds to is the physical device the reference's
    visibility env would grant: under an inherited mask, CUDA numbers the
    mask's devices by position, so logical id i is cuda:i and physical
    mask[i]; an id past the mask is dropped, as in the reference, and
    refused for binding."""
    ref, port = _accs()
    if mask is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", mask)
    want = ref.GpuAcceleratorManager.get_visibility_env(ids)
    assert port.GpuAcceleratorManager.get_visibility_env(ids) == want
    physical = [p for p in want["CUDA_VISIBLE_DEVICES"].split(",") if p]
    visible = (mask or "").split(",") if mask else None
    for i in ids:
        if visible is not None and i >= len(visible):
            with pytest.raises(ValueError, match="past"):
                port.cuda_index(i)
            continue
        idx = port.cuda_index(i)
        assert (visible[idx] if visible else str(idx)) == physical[ids.index(i)]


def test_plugins_fold_and_fault_isolate_as_reference(monkeypatch):
    """A registered plugin's count, labels and extra resources land in the
    node's detection, a throwing one contributes nothing, in both
    registries alike."""
    ref, port = _accs()

    def plugins(acc):
        class FakeNpu(acc.AcceleratorManager):
            get_resource_name = staticmethod(lambda: "NPU")
            get_current_node_num_accelerators = staticmethod(lambda: 3)
            get_current_node_labels = staticmethod(lambda: {"ray.io/npu-flavor": "test"})
            get_current_node_additional_resources = staticmethod(lambda: {"NPU-head": 1.0})

        class Broken(acc.AcceleratorManager):
            get_resource_name = staticmethod(lambda: "BROKEN")
            get_current_node_num_accelerators = staticmethod(lambda: 1)

            @staticmethod
            def get_current_node_labels():
                raise RuntimeError("metadata server down")

        return FakeNpu, Broken

    monkeypatch.setattr(ref.TpuAcceleratorManager, "detect_num_chips", staticmethod(lambda: 0))
    results = []
    for acc in (ref, port):
        monkeypatch.setattr(acc.GpuAcceleratorManager, "get_current_node_num_accelerators",
                            staticmethod(lambda: 0))
        added = plugins(acc)
        for cls in added:
            acc.register_accelerator_manager(cls)
        try:
            results.append(acc.detect_node_accelerators())
        finally:
            for cls in added:
                acc._ACCELERATOR_MANAGERS.remove(cls)
    assert results[0] == results[1] == ({"NPU": 3.0, "NPU-head": 1.0},
                                        {"ray.io/npu-flavor": "test"})
    assert {m.get_resource_name() for m in port.all_accelerator_managers()} == {"GPU"}


def test_gpu_detection_finds_a_card_proc_hides(monkeypatch):
    """Kept item 37: with no mask and /proc/driver/nvidia hidden, the port
    counts through torch and then nvidia-smi, never 0 for a present card;
    the reference reports 0 there."""
    ref, port = _accs()
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(port.glob, "glob", lambda pattern: [])
    monkeypatch.setattr(ref.glob, "glob", lambda pattern: [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port.GpuAcceleratorManager.get_current_node_num_accelerators() == 1
    assert port.last_gpu_source == "torch"
    assert ref.GpuAcceleratorManager.get_current_node_num_accelerators() == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(port, "_nvidia_smi_count", lambda: 4)
    assert port.GpuAcceleratorManager.get_current_node_num_accelerators() == 4
    assert port.last_gpu_source == "nvidia-smi"
    monkeypatch.setattr(port, "_nvidia_smi_count", lambda: 0)
    assert port.GpuAcceleratorManager.get_current_node_num_accelerators() == 0
    assert port.last_gpu_source == ""


# -- lease binding on a fake two-card node ----------------------------------------------


def test_two_gpu_leases_bind_two_cards(monkeypatch):
    """Kept item 34: on a node detected with two cards (CUDA_VISIBLE_DEVICES
    0,1), two num_gpus=1 actors and a num_gpus=1 task get GPU ids [0] and
    [1], and each worker's get_gpu_ids(), runtime context and
    torch.cuda.current_device() on its executor thread say so (the workers
    import a two-card stand-in for torch: a CPU build of torch has no CUDA).
    ray_tpu drops the lease's ids, so both would run on card 0."""
    import ray_tpu_torch as rt

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    monkeypatch.syspath_prepend(str(_HERE / "torch_fake_cuda"))
    rt.init(num_cpus=4)
    try:
        assert rt.cluster_resources()["GPU"] == 2.0
        actors = [rt.remote(num_gpus=1)(P.Where).remote() for _ in range(2)]
        got = sorted(rt.get([a.device.remote() for a in actors], timeout=120))
        assert got == [([0], 0), ([1], 1)]
        pids = {rt.get(a.where.remote(), timeout=60)["pid"] for a in actors}
        assert len(pids) == 2
        del actors
        task = rt.get(rt.remote(num_gpus=1)(P.where).remote(), timeout=120)
        assert task["gpu_ids"] in ([0], [1]) and "torch" in task["modules"]
        assert rt.get_gpu_ids() == []  # the driver holds no lease
    finally:
        rt.shutdown()


# -- serialization: callables by reference, tensors as raw bytes ----------------------


def test_callables_travel_by_reference_and_the_rpc_plane_has_no_fallback():
    """Kept item 35: a module-level function pickles as its module and name
    (a @remote wrapper bound to the name unwraps on the other side); a
    nested, lambda or __main__ callable raises a ValueError that names it;
    the RPC plane raises where the reference would fall back to cloudpickle,
    and refuses a legacy v1 (raw pickle) frame."""
    from ray_tpu_torch._internal import rpc, serialization
    from ray_tpu_torch.exceptions import RpcError

    blob = serialization.dumps(P.add)
    assert b"torch_runtime_programs" in blob and len(blob) < 200
    assert serialization.loads(blob) is P.add
    for wrapper in (decorated_square, DecoratedCounter):
        inner = wrapper.__remote_wrapped__
        assert serialization.loads(serialization.dumps(inner)) is inner

    def nested():
        pass

    for fn, words in ((nested, "inside a function"), (lambda: 0, "lambda")):
        with pytest.raises(ValueError, match=words):
            serialization.dumps(fn)
        with pytest.raises(ValueError, match=words):
            rpc._encode_frame((1, "m", (fn,), {}))
    with pytest.raises(ValueError, match="tuple"):
        rpc._encode_frame((1, "m", (_Unpicklable(),), {}))
    assert "fallback_cloudpickle" not in rpc.frame_stats()
    with pytest.raises(RpcError, match="not a v2 frame"):
        rpc._decode_body(pickle.dumps((1, True, None), protocol=5))
    parts = rpc._encode_frame((1, True, "ok"))
    assert rpc._decode_body(b"".join(bytes(p) for p in parts)[4:]) == (1, True, "ok")


@ray_tpu_torch.remote
def decorated_square(x):
    return x * x


@ray_tpu_torch.remote
class DecoratedCounter(P.Counter):
    pass


class _Unpicklable:
    def __reduce__(self):
        raise TypeError("cannot pickle this")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64,
                                   torch.bool, torch.uint8])
def test_a_tensor_crosses_as_a_cpu_tensor_with_raw_bytes(dtype):
    """Kept item 36: a tensor's bytes go out of band as one buffer of
    exactly its size (never torch.save), and it comes back a CPU tensor of
    its dtype and shape with the same bytes, owning its memory; a
    non-contiguous view crosses as its contiguous copy, a 0-d and an empty
    tensor inline."""
    from ray_tpu_torch._internal import serialization

    g = torch.Generator().manual_seed(0)
    base = (torch.randn(64, 48, generator=g) * 100).to(dtype)
    for t in (base, base.t(), base[::2, 3:], base[0, 0], base[:0]):
        meta, bufs = serialization.serialize(t)
        nbytes = t.numel() * t.element_size()
        if nbytes >= serialization._OOB_THRESHOLD:
            assert [b.nbytes for b in bufs] == [nbytes]
        assert b"torch.save" not in meta and b"_rebuild_tensor_v2" not in meta
        back = serialization.unpack(serialization.pack(t))
        assert back.device.type == "cpu" and back.dtype == t.dtype
        assert back.shape == t.shape and back.is_contiguous()
        assert torch.equal(back.view(torch.uint8) if back.dim() and back.numel() else back,
                           t.contiguous().view(torch.uint8) if t.dim() and t.numel() else t)
        back.add_(1) if dtype != torch.bool else back.logical_not_()  # it owns its memory


def test_numpy_and_nested_values_keep_the_reference_wire_format():
    """The object plane's wire format is the reference's: a numpy array's
    buffer goes out of band and the packed bytes unpack in ray_tpu too."""
    from ray_tpu._internal import serialization as ref
    from ray_tpu_torch._internal import serialization as port

    value = {"a": np.arange(1000, dtype=np.float64), "b": [1, "x", (2.5, None)]}
    packed = port.pack(value)
    for unpack in (port.unpack, ref.unpack):
        back = unpack(packed)
        np.testing.assert_array_equal(back["a"], value["a"])
        assert back["b"] == value["b"]
    meta, bufs = port.serialize(value)
    assert [b.nbytes for b in bufs] == [8000]
    assert port.packed_size(meta, bufs) == len(packed)
