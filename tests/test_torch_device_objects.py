"""The port's device objects (ray_tpu_torch.experimental) against
ray_tpu's, and tensors through the object plane.

The six programs of tests/test_device_objects.py run against ``ray_tpu``
(jax arrays) and then against ``ray_tpu_torch`` (CPU tensors), each on a
single-node cluster of 8 CPUs for the whole file, never both at once
(tests/torch_runtime_programs.py); fetches ask for host values
(``to_device=False``: the tests run without a card) and the results must be equal,
and equal to what test_device_objects.py asserts. Then, on the port's
cluster: a local hit is the stored tensor itself (same ``data_ptr``),
``free`` empties the owner's store, ``device_get(to_device=True)`` raises
without a card, and a bf16, a non-contiguous and a 0-d tensor go through
``put`` / ``get`` and through a task bit for bit, arriving as CPU tensors.
"""

from __future__ import annotations

import importlib
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import torch_runtime_programs as P

#: what tests/test_device_objects.py asserts of each program
EXPECTED = {
    "prog_device_ref_roundtrip": (True, True, float(sum(range(8))) + 3),
    "prog_local_zero_copy_and_chaining": (True, float(sum(range(4)) * 2) + 3),
    "prog_scalar_results_pass_through": 42,
    "prog_driver_side_get_and_free": (float(sum(range(5))), 3, True, "KeyError"),
    "prog_device_put_from_driver": (True, (3, 3), 18.0),
    "prog_nested_refs_resolve": float(sum(range(3))),
}


def _run(name, rt):
    prog = P.DEVICE_PROGRAMS[name]
    try:
        if name == "prog_device_put_from_driver":
            if rt.__name__ == "ray_tpu":
                import jax.numpy as jnp

                return prog(rt, jnp.ones((3, 3)))
            return prog(rt, torch.ones(3, 3))
        return prog(rt)
    except Exception as e:  # noqa: BLE001 - one failing program fails its own test
        return ("raised", type(e).__name__, str(e)[:300])


def _tensors():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(96, 80, generator=g)
    return {
        "bf16": base.to(torch.bfloat16),
        "non_contiguous": base.t()[::2],
        "scalar": base[3, 4].clone(),
        "int8_empty": torch.zeros(0, 5, dtype=torch.int8),
    }


def _port_extras(rt):
    dev = importlib.import_module("ray_tpu_torch.experimental")
    out = {}
    p = rt.remote(P.Producer).remote()
    ref = rt.get(p.make.remote(6))
    out["same_storage"] = rt.get(p.same_storage.remote(ref, ref.id))
    before = rt.get(p.stored.remote())
    out["freed"] = dev.free_device_object(ref)
    out["stored"] = (before, rt.get(p.stored.remote()))
    ref = rt.get(p.make.remote(2))
    try:
        dev.device_get(ref, to_device=True)
        out["to_device"] = "no error"
    except RuntimeError as e:
        out["to_device"] = str(e)
    tensors = _tensors()
    out["put_get"] = {k: rt.get(rt.put(t), timeout=60) for k, t in tensors.items()}
    out["task"] = {k: rt.get(rt.remote(P.identity).remote(t), timeout=60)
                   for k, t in tensors.items()}
    return out


@pytest.fixture(scope="module")
def runs():
    """The six programs against ray_tpu, then against ray_tpu_torch, three
    at a time (each starts two actors, whose workers import jax or torch:
    about 3 s each); each cluster is shut down before the next starts. The
    reference's workers import jax when a program first needs it (on the
    CPU: JAX_PLATFORMS=cpu), not at their start."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("RAY_TPU_JAX_PLATFORM", raising=False)
        mp.setenv("JAX_PLATFORMS", "cpu")
        for key, name in (("ref", "ray_tpu"), ("port", "ray_tpu_torch")):
            rt = importlib.import_module(name)
            rt.init(num_cpus=8)
            try:
                with ThreadPoolExecutor(3) as pool:
                    out[key] = dict(zip(P.DEVICE_PROGRAMS, pool.map(
                        lambda prog: _run(prog, rt), P.DEVICE_PROGRAMS)))
                if key == "port":
                    out["extras"] = _port_extras(rt)
            finally:
                rt.shutdown()
    return out


@pytest.mark.parametrize("name", list(P.DEVICE_PROGRAMS))
def test_program_matches_reference(runs, name):
    assert runs["ref"][name] == EXPECTED[name]
    assert runs["port"][name] == runs["ref"][name]


def test_local_hit_is_the_stored_tensor_and_free_empties_the_store(runs):
    extras = runs["extras"]
    assert extras["same_storage"] is True
    assert extras["freed"] is True
    before, after = extras["stored"]
    assert after == before - 1


def test_device_get_to_device_raises_without_a_card(runs):
    assert "no CUDA device" in runs["extras"]["to_device"]


@pytest.mark.parametrize("how", ["put_get", "task"])
def test_tensors_through_put_get_and_a_task_bit_for_bit(runs, how):
    for key, want in _tensors().items():
        got = runs["extras"][how][key]
        assert got.device.type == "cpu" and got.dtype == want.dtype, key
        assert got.shape == want.shape and got.is_contiguous(), key
        assert torch.equal(got, want), key
