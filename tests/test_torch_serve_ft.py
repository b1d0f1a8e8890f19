"""Serving fault tolerance of the port's serve control plane against
ray_tpu.serve: every program of tests/test_serve_ft.py
(tests/torch_serve_programs.py) against ``ray_tpu`` and then
``ray_tpu_torch``, one single-node cluster of 8 CPUs per runtime for the
whole file and never both at once; the local-mode one with no cluster.
Failover of in-flight requests off a killed replica, drain on scale-down
and on request, shedding with ``BackPressureError``, dead-on-arrival
rejection, the caller's deadline, routing from a stale table when the
controller is gone, and a stream that fails midway. The results must be
equal, and equal to what the reference test asserts.
"""

from __future__ import annotations

import importlib

import pytest

import torch_serve_programs as P

#: what tests/test_serve_ft.py asserts of each program
EXPECTED = {
    "prog_kill_replica_mid_request_failover": (True, [i * 2 for i in range(8)], True),
    "prog_drain_on_scale_down_zero_dropped": ([i + 100 for i in range(10)], 1),
    "prog_drain_replica_replacement": (True, True),
    "prog_shed_under_overload": (("BackPressureError", True), True, [0, 1]),
    "prog_dead_on_arrival_rejected_by_replica": (True, True),
    "prog_caller_deadline_bounds_result": (True, True),
    "prog_stale_routing_table_failover": (True, True, 7, True),
    "prog_stream_error_closes_generator": ("first", True, True),
}
LOCAL = {
    "prog_local_mode_parity_new_knobs": ("hi x", [0, 1, 2]),
}


@pytest.fixture(scope="module")
def runs():
    out = P.run_programs(list(EXPECTED))
    for key, name in (("ref", "ray_tpu"), ("port", "ray_tpu_torch")):
        rt = importlib.import_module(name)
        out[key].update({prog: P.run_one(P.SERVE_PROGRAMS[prog], rt) for prog in LOCAL})
    return out


@pytest.mark.parametrize("name", list(EXPECTED) + list(LOCAL))
def test_program_matches_reference(runs, name):
    want = EXPECTED.get(name, LOCAL.get(name))
    assert runs["ref"][name] == want
    assert runs["port"][name] == runs["ref"][name]
