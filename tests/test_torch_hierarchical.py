"""``HierarchicalGroup`` (backend ``"hier"``) against the reference's
semantics, on the CPU.

Four spawned gloo ranks (a ``TCPStore`` on port 0 in this process), each
forming two hierarchical groups in one order: 2 slices of 2 (the
reference's emulated topology, ``tests/test_overlap.py:384-440``) and 1
slice of 4. Held, on both: the values the reference's tests assert
(``allreduce`` of r + 1 is 10.0, ``allgather`` of 11 r is ``[0, 11, 22,
33]``, ``broadcast`` of 100 + r from rank 3 is 103, the
``GradientReduceScheduler``'s overlapped reduce of ones is 4.0), each
against the flat gloo group's sum (exact: integer-valued), ``reducescatter``
as ``np.array_split`` of the sum (uneven rows), ``send`` / ``recv`` across
slices, the three validation errors, metrics recorded by the sub-groups
only, and an abort of the logical name that releases a member waiting in
the inter-slice phase.

The children import this module by name, so it imports neither ``jax`` nor
``ray_tpu`` at its top.
"""

import datetime
import multiprocessing
import os
import queue
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch import collective as col
from ray_tpu_torch.collective import HierarchicalGroup
from ray_tpu_torch.collective.scheduler import GradientReduceScheduler
from ray_tpu_torch.exceptions import CollectiveAbortedError
from ray_tpu_torch.util import metrics

_DEADLINE_S = 60.0
_WORLD = 4


def _child(fn, rank, port, results, hard_exit):
    store = dist.TCPStore("127.0.0.1", port, _WORLD + 1, is_master=False,
                          timeout=datetime.timedelta(seconds=_DEADLINE_S))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=_WORLD,
                            timeout=datetime.timedelta(seconds=_DEADLINE_S))
    try:
        results.put((rank, fn(rank), None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, None, traceback.format_exc()))
    if hard_exit:
        # a member's dispatcher thread may still sit in an aborted op: leave
        # without tearing the groups down (the peers' sockets close with us)
        results.close()
        results.join_thread()
        os._exit(0)
    dist.destroy_process_group()


def _run(fn, hard_exit=False):
    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, _WORLD + 1, is_master=True, wait_for_workers=False)
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, store.port, results, hard_exit),
                         daemon=True) for r in range(_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + _DEADLINE_S
    out, errors = {}, {}
    try:
        while len(out) + len(errors) < _WORLD and time.monotonic() < deadline:
            try:
                rank, value, err = results.get(timeout=0.5)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            (errors if err else out)[rank] = err or value
    finally:
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    if errors or len(out) < _WORLD:
        pytest.fail(f"ranks failed (exit codes {[p.exitcode for p in procs]}):\n"
                    + "\n".join(f"rank {r}:\n{e}" for r, e in sorted(errors.items())))
    return [out[r] for r in range(_WORLD)]


def _ops(rank):
    flat = col.init_collective_group(_WORLD, rank, backend="gloo", group_name="flat")
    rng = np.random.default_rng(rank)
    ints = torch.from_numpy(rng.integers(-1000, 1000, (10, 3)).astype(np.float32))
    out = {}
    for name, size in (("hier2x2", 2), ("hier1x4", 4)):
        g = col.init_collective_group(_WORLD, rank, backend="hier", group_name=name,
                                      slice_size=size)
        assert isinstance(g, HierarchicalGroup)
        res = dict(slices=(g.num_slices, g.slice_id, g.intra_rank, g.is_leader))
        res["allreduce"] = np.asarray(g.allreduce(np.asarray([float(rank + 1)])))
        res["allgather"] = g.allgather(rank * 11)
        res["broadcast"] = g.broadcast(100 + rank, src_rank=3)
        res["sum"] = g.allreduce(ints).numpy()
        res["flat_sum"] = flat.allreduce(ints).numpy()
        res["reducescatter"] = g.reducescatter(ints).numpy()
        res["tensors"] = [t.numpy() for t in g.allgather(ints[:2])]
        sched = GradientReduceScheduler(g, bucket_bytes=512, overlap=True)
        grads = {"k": torch.full((64,), 1.0), "b": torch.arange(8, dtype=torch.float32)}
        res["scheduled"] = {k: v.numpy() for k, v in sched.reduce(grads).wait().items()}
        if rank == 0:
            g.send({"from": 0, "to": 3}, 3)
            res["recv"] = g.recv(3)
        elif rank == 3:
            res["recv"] = g.recv(0)
            g.send(torch.arange(3) + 30, 0)
        g.barrier()
        out[name] = res
    # a group over some of the default group's ranks, formed by all of them
    sub = HierarchicalGroup.form([1, 3], "sub", slice_size=1)
    out["sub"] = None if sub is None else (sub.rank, float(sub.allreduce(torch.tensor(
        [float(rank)]))[0]), sub.allgather(rank))
    if sub is not None:
        sub.destroy()
    hist = metrics._ensure_collective_metrics()["latency"]
    at = hist._tag_keys.index("group")
    out["metric_groups"] = sorted({k[at] for k in hist._counts})
    for name in ("hier2x2", "hier1x4", "flat"):
        col.destroy_collective_group(name)
    return out


@pytest.fixture(scope="module")
def hier_run():
    return _run(_ops)


@pytest.mark.parametrize("name", ["hier2x2", "hier1x4"])
def test_reference_values(hier_run, name):
    """The reference tests' values: allreduce 10.0, allgather [0, 11, 22,
    33], broadcast from rank 3 103, the scheduler's overlapped reduce 4.0
    (and b x 4), on every rank."""
    for rank, out in enumerate(hier_run):
        res = out[name]
        np.testing.assert_array_equal(res["allreduce"], [10.0])
        assert list(res["allgather"]) == [0, 11, 22, 33]
        assert res["broadcast"] == 103
        np.testing.assert_array_equal(res["scheduled"]["k"], np.full((64,), 4.0))
        np.testing.assert_array_equal(res["scheduled"]["b"], np.arange(8) * 4.0)
        size = 2 if name == "hier2x2" else 4
        assert res["slices"] == (4 // size, rank // size, rank % size, rank % size == 0)


@pytest.mark.parametrize("name", ["hier2x2", "hier1x4"])
def test_sums_gathers_and_shards_against_the_flat_group(hier_run, name):
    """The allreduce equals the flat gloo group's sum exactly (integer
    values); reducescatter is ``np.array_split`` of it (rows 3, 3, 2, 2);
    a tensor allgather is the world-ordered list."""
    for rank, out in enumerate(hier_run):
        res = out[name]
        np.testing.assert_array_equal(res["sum"], res["flat_sum"])
        np.testing.assert_array_equal(res["reducescatter"],
                                      np.array_split(res["flat_sum"], _WORLD, axis=0)[rank])
        for r, t in enumerate(res["tensors"]):
            np.testing.assert_array_equal(
                t, np.random.default_rng(r).integers(-1000, 1000, (10, 3))[:2])


def test_send_recv_and_metrics(hier_run):
    """send / recv across slices through the flat sub-group; every metric
    is a sub-group's (``<name>:s<i>``, ``:x``, ``:p2p``), none the logical
    group's."""
    for name in ("hier2x2", "hier1x4"):
        assert hier_run[3][name]["recv"] == {"from": 0, "to": 3}
        np.testing.assert_array_equal(hier_run[0][name]["recv"].numpy(), [30, 31, 32])
    for out in hier_run:
        groups = out["metric_groups"]
        assert "hier2x2" not in groups and "hier1x4" not in groups
        assert "hier2x2:x" in groups or not out["hier2x2"]["slices"][3]
        assert any(g.startswith("hier2x2:s") for g in groups)


def test_form_over_some_ranks(hier_run):
    """``HierarchicalGroup.form([1, 3], slice_size=1)``, called by all four
    ranks: ranks 1 and 3 (member ranks 0 and 1, two slices of one) sum and
    gather; ranks 0 and 2 get None; world ranks out of order raise."""
    assert hier_run[0]["sub"] is None and hier_run[2]["sub"] is None
    assert hier_run[1]["sub"] == (0, 4.0, [1, 3])
    assert hier_run[3]["sub"] == (1, 4.0, [1, 3])
    with pytest.raises(ValueError, match="ascend"):
        HierarchicalGroup.form([3, 1], "bad", slice_size=1)


def test_validation_errors_are_the_references():
    with pytest.raises(ValueError, match="slice_size must be positive"):
        HierarchicalGroup(4, 0, "bad", slice_size=0)
    with pytest.raises(ValueError, match="not divisible by slice_size=3"):
        HierarchicalGroup(4, 0, "bad", slice_size=3)
    with pytest.raises(ValueError, match="intra_backend must be one of"):
        HierarchicalGroup(4, 0, "bad", slice_size=2, intra_backend="xla")


def _abort(rank):
    """Ranks 0 and 1 start an allreduce; rank 0 (slice 0's leader) passes
    the intra phase and waits in the inter phase for slice 1's leader,
    which never comes; rank 3 then aborts the logical name. Both waits
    raise; so does a later op on any sub-group."""
    g = col.init_collective_group(_WORLD, rank, backend="hier", group_name="hier-abort",
                                  slice_size=2)
    g.barrier()
    out = {}
    if rank in (0, 1):
        handle = g.allreduce_async(torch.ones(4))
    dist.barrier()  # every rank is past the submit
    if rank == 3:
        time.sleep(1.0)  # rank 0 is in the inter phase by now
        out["advanced"] = col.abort_collective_group("hier-abort", reason="test")
        dist.send(torch.ones(1), dst=2)  # the mark is written
    if rank in (0, 1):
        t0 = time.perf_counter()
        try:
            handle.wait(timeout=30)
            out["released"] = "completed"
        except CollectiveAbortedError as e:
            out["released"] = "aborted"
            out["message"] = str(e)
        out["wait_s"] = time.perf_counter() - t0
    if rank == 2:
        dist.recv(torch.empty(1), src=3)
        try:
            g._intra.allreduce(torch.ones(2))
            out["sub_op"] = "ran"
        except CollectiveAbortedError:
            out["sub_op"] = "aborted"
    # no rank leaves (closing its sockets, which fails the peers' stuck
    # ops) before ranks 0 and 1 have seen the abort
    dist.barrier()
    return out


def test_abort_of_the_logical_name_releases_a_waiting_member():
    outs = _run(_abort, hard_exit=True)
    assert outs[3]["advanced"] is True
    for rank in (0, 1):
        assert outs[rank]["released"] == "aborted", outs[rank]
        assert outs[rank]["wait_s"] < 20
    assert outs[2]["sub_op"] == "aborted"
