"""The port's serve control plane (ray_tpu_torch.serve) against
ray_tpu.serve.

Every program of tests/test_serve.py (tests/torch_serve_programs.py; those
of tests/test_serve_ft.py run in tests/test_torch_serve_ft.py) runs against ``ray_tpu`` and then against
``ray_tpu_torch``, each on a single-node cluster of 8 CPUs, one cluster per
runtime for the whole file and never both at once, with the apps deleted
between programs as the reference tests' fixture does; the local-mode
programs run with no cluster. The two runtimes' results must be equal, and
equal to what the reference tests assert. The reference's gRPC test
becomes a check that the port's ``start(grpc_port=...)`` raises (the card's
machine has no grpcio). Then, on the port alone: a deployment defined where
a replica cannot import it.
"""

from __future__ import annotations

import importlib
import pytest

import torch_serve_programs as P

#: what tests/test_serve.py asserts of each program
EXPECTED = {
    "prog_basic_deployment_and_handle": ("hello tpu", "RUNNING", "HEALTHY"),
    "prog_function_deployment": 49,
    "prog_multi_replica_load_balancing": 2,
    "prog_composition_nested_handles": 70,
    "prog_method_routing": [("call", 1), ("other", 2)],
    "prog_user_config_reconfigure": (1, 5),
    "prog_replica_failure_recovery": ("alive", True),
    "prog_http_proxy_end_to_end": ({"result": {"echo": {"msg": "hi"}}}, "ok"),
    "prog_autoscaling_up_and_down": (1, True, True),
    "prog_delete_application": (True, False),
    "prog_serve_batch_accumulates": ([2 * i for i in range(8)], True),
    "prog_serve_batch_error_propagates": True,
    "prog_serve_multiplexed_lru": ("m1", "m1", 1, 2, ["m1", "m2", "m3", "m2"]),
    "prog_prefix_affinity_routes_same_prompt_to_same_replica": (1, True),
    "prog_serve_batch_composes_with_multiplex": ([(i, True, True) for i in range(8)], True),
    "prog_response_chaining": 41,
    "prog_controller_crash_recovery": (1, 2, 1, list(range(10)), True),
}
LOCAL = {
    "prog_local_testing_mode_no_cluster": (21, "hi"),
    "prog_local_testing_mode_batching_and_multiplex": ([100, 101, 102, 103], "m7"),
}


def _port_extra(rt):
    return {"grpc": P._raised(lambda: rt.serve.start(proxy=False, grpc_port=0))}


@pytest.fixture(scope="module")
def runs():
    out = P.run_programs(list(EXPECTED), port_extra=_port_extra, http=True)
    for key, name in (("ref", "ray_tpu"), ("port", "ray_tpu_torch")):
        rt = importlib.import_module(name)
        out[key].update({prog: P.run_one(P.SERVE_PROGRAMS[prog], rt) for prog in LOCAL})
    return out


@pytest.mark.parametrize("name", list(EXPECTED) + list(LOCAL))
def test_program_matches_reference(runs, name):
    want = EXPECTED.get(name, LOCAL.get(name))
    assert runs["ref"][name] == want
    assert runs["port"][name] == runs["ref"][name]


def test_prefix_affinity_key_matches_reference():
    """tests/test_serve.py::test_prefix_affinity_key_stability on both
    packages' keys, which must be equal key for key."""
    from ray_tpu.serve.handle import _prefix_affinity_key as ref_key
    from ray_tpu_torch.serve.handle import _prefix_affinity_key as port_key

    req = {"token_ids": list(range(40)), "max_new_tokens": 4}
    cases = [((req,), {}, 16), ((), {"request": dict(req)}, 16),
             (({"token_ids": list(range(16)) + [999]},), {}, 16),
             (({"token_ids": [7] * 16},), {}, 16), (({"prompt": "hello world"},), {}, 8),
             ((42, "x"), {}, 8)]
    got = [port_key(*c) for c in cases]
    assert got == [ref_key(*c) for c in cases]
    assert got[0] is not None and got[0] == got[1] == got[2] != got[3]
    assert got[4] is not None and got[5] is None


def test_grpc_ingress_raises_on_the_port(runs):
    """The reference's test_grpc_ingress: the port has no gRPC proxy (no
    grpcio on the card's machine), and start(grpc_port=...) says so rather
    than ignoring the port."""
    name, msg = runs["port"]["extra"]["grpc"]
    assert name == "NotImplementedError" and "grpcio" in msg


def test_unimportable_deployment_raises_at_bind():
    """Kept item 35 for deployments: a replica imports its callable by
    module and name, so one defined inside a function, as a lambda or in
    __main__ raises a ValueError naming it at bind(), not in a replica; a
    module-level one pickles by reference even where its name is bound to
    the Deployment."""
    from ray_tpu_torch import serve
    from ray_tpu_torch._internal import serialization

    class Nested:
        def __call__(self, x):
            return x

    for target, words in ((Nested, "inside a function"), (lambda x: x, "lambda")):
        with pytest.raises(ValueError, match=words):
            serve.deployment(target).bind()
    in_main = type(P.square)(P.square.__code__, {}, "in_main")
    in_main.__module__, in_main.__qualname__ = "__main__", "in_main"
    with pytest.raises(ValueError, match="__main__.in_main"):
        serve.deployment(in_main).bind()
    cls = P.Greeter
    P.Greeter = serve.deployment(cls)  # as a module-level @serve.deployment binds it
    try:
        blob = serialization.dumps(cls)
        assert b"torch_serve_programs" in blob and serialization.loads(blob) is cls
        assert serialization._unwrap(P.Greeter) is cls
    finally:
        P.Greeter = cls
