"""ray_tpu_torch.collective against ray_tpu.collective, on the CPU.

- The bucketizer against the reference's ``GradientBucketizer`` over the
  nested tree of the same arrays: the port's flat dict is keyed by the
  reference's ``_path_str`` strings.
- The scheduler against the reference's cases in ``tests/test_overlap.py``,
  over the same loopback group (a world of one whose allreduce multiplies
  by a factor).
- ``GlooGroup`` at 2 and 4 ranks in spawned processes (gloo, a ``TCPStore``
  on port 0 in this process): every op against numpy, and the quantized
  allreduce against the reference's own formula (``ef_quantize_np``,
  ``dequantize_np``, ``np.sum(axis=0)``) bit for bit over 10 rounds.
- ``NcclGroup``'s quantized programs, run through gloo at 4 ranks, against
  ``XlaGroup(quantized=True)`` over 4 virtual CPU devices.
- ``moe_dispatch`` / ``moe_combine`` at 2 ranks against the reference's
  ``shard_map`` over 2 virtual devices.

Every spawned group is joined within ``_DEADLINE_S``; past it the children
are killed and the test fails (their stderr is the test's captured
output). The children import this module by name, so it imports neither
``jax`` nor ``ray_tpu`` at its top: the tests that need them import them
inside.
"""

import datetime
import multiprocessing
import queue
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch import collective as col
from ray_tpu_torch.collective import ReduceOp
from ray_tpu_torch.collective.base import BaseGroup, tensor_nbytes
from ray_tpu_torch.collective.bucketizer import GradientBucketizer
from ray_tpu_torch.collective.nccl_group import check_distinct_cards
from ray_tpu_torch.collective.scheduler import GradientReduceScheduler
from ray_tpu_torch.exceptions import CollectiveAbortedError
from ray_tpu_torch.util import metrics

_DEADLINE_S = 60.0
_QBLOCK = 64
_ROUNDS = 10
F32_EPS = np.finfo(np.float32).eps


# -- spawned ranks -------------------------------------------------------------


def _child(fn, rank, world, port, args, results):
    store = dist.TCPStore("127.0.0.1", port, world + 1, is_master=False,
                          timeout=datetime.timedelta(seconds=_DEADLINE_S))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=_DEADLINE_S))
    try:
        results.put((rank, fn(rank, world, *args), None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned gloo ranks; their
    results by rank. Fails the test on an error, a death or the deadline."""
    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, world + 1, is_master=True, wait_for_workers=False)
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, world, store.port, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + _DEADLINE_S
    out, errors = {}, {}
    try:
        while len(out) + len(errors) < world and time.monotonic() < deadline:
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
    if errors or len(out) < world:
        codes = [p.exitcode for p in procs]
        pytest.fail(f"ranks failed (exit codes {codes}, missing "
                    f"{sorted(set(range(world)) - set(out) - set(errors))}):\n"
                    + "\n".join(f"rank {r}:\n{e}" for r, e in sorted(errors.items())))
    assert not any(p.is_alive() for p in procs)
    return [out[r] for r in range(world)]


# -- bucketizer ----------------------------------------------------------------


def _nested_tree():
    """A nested tree (the reference's form) of mixed sizes and dtypes."""
    rng = np.random.default_rng(3)
    return {
        "dense0": {"kernel": rng.standard_normal((32, 16)).astype(np.float32),
                   "bias": rng.standard_normal(16).astype(np.float32)},
        "dense1": {"kernel": rng.standard_normal((16, 8)).astype(np.float32)},
        "big": rng.standard_normal(1024).astype(np.float32),  # 4 KiB
        "half": {"a": rng.standard_normal(40).astype(np.float16),
                 "b": rng.standard_normal(24).astype(np.float16)},
        "steps": np.array([3, 4], np.int64),
        "scalar": np.float32(0.125),
    }


def _flat(tree, prefix=""):
    """The port's flat dict, keyed by the reference's path strings."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.asarray(v).copy())
    return out


@pytest.mark.parametrize("bucket_bytes", [1, 64, 700, 2048, 4096, 1 << 20])
def test_bucketizer_matches_reference(bucket_bytes):
    from ray_tpu.collective.bucketizer import GradientBucketizer as RefBucketizer

    tree = _nested_tree()
    ref = RefBucketizer(tree, bucket_bytes=bucket_bytes)
    port = GradientBucketizer(_flat(tree), bucket_bytes=bucket_bytes)
    assert [(b.index, b.paths, b.shapes, b.dtype, b.nbytes) for b in port.buckets] == [
        (b.index, b.paths, b.shapes, b.dtype, b.nbytes) for b in ref.buckets]


def test_bucketizer_oversized_leaf_and_dtype_mix():
    tree = {"big": torch.zeros(1024), "s1": torch.zeros(16), "s2": torch.zeros(16),
            "h": torch.zeros(8, dtype=torch.float16), "i": torch.zeros(8, dtype=torch.int32)}
    b = GradientBucketizer(tree, bucket_bytes=4096)
    by_paths = {s.paths: s for s in b.buckets}
    # the oversized leaf closes a bucket of its own; buckets never mix dtypes
    assert by_paths[("big",)].nbytes == 4096
    assert ("h",) in by_paths and ("i",) in by_paths and ("s1", "s2") in by_paths
    assert {s.dtype for s in b.buckets} == {"float32", "float16", "int32"}


def test_bucketizer_is_insertion_order_invariant():
    tree = _flat(_nested_tree())
    reordered = dict(reversed(list(tree.items())))
    a, b = GradientBucketizer(tree, 700), GradientBucketizer(reordered, 700)
    assert a.signature() == b.signature()
    for x, y in zip(a.pack(tree), b.pack(reordered)):
        assert torch.equal(x, y)


def test_bucketizer_pack_unpack_round_trip_is_bit_exact():
    tree = _flat(_nested_tree())
    b = GradientBucketizer(tree, bucket_bytes=700)
    packed = b.pack(tree)
    assert all(t.dim() == 1 for t in packed) and len(packed) == b.num_buckets
    back = b.unpack(packed)
    assert list(back) == list(tree)  # the order of the tree it was built from
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(back[k], v)
        # a view of its bucket, not a copy
        assert any(back[k].untyped_storage().data_ptr() == p.untyped_storage().data_ptr()
                   for p in packed)
    with pytest.raises(ValueError, match="leaves"):
        b.pack({"just": torch.ones(3)})
    with pytest.raises(ValueError, match="bucket arrays"):
        b.unpack([])


# -- scheduler (the reference's cases, tests/test_overlap.py) ------------------


class _LoopbackGroup(BaseGroup):
    """A world of one whose allreduce multiplies by ``factor``, with an
    optional delay per op (a rendezvous's latency)."""

    backend = "fake"

    def __init__(self, factor=3.0, op_delay=0.0, name="loop"):
        super().__init__(1, 0, name)
        self.factor = factor
        self.op_delay = op_delay
        self.calls = 0

    def allreduce(self, tensor, op=ReduceOp.SUM):
        self.calls += 1
        if self.op_delay:
            time.sleep(self.op_delay)
        return tensor * self.factor

    def allgather(self, tensor):
        return [tensor]

    def reducescatter(self, tensor, op=ReduceOp.SUM):
        return tensor * self.factor

    def broadcast(self, tensor, src_rank=0):
        return tensor

    def send(self, tensor, dst_rank):
        raise NotImplementedError

    def recv(self, src_rank):
        raise NotImplementedError

    def barrier(self):
        pass


def _grad_tree(scale=1.0):
    return {
        "dense0/kernel": torch.full((32, 16), scale),
        "dense0/bias": torch.arange(16, dtype=torch.float32) * scale,
        "dense1/kernel": torch.full((16, 8), 2.0 * scale),
        "steps": torch.tensor([3], dtype=torch.int64),
    }


def test_scheduler_overlapped_matches_sync_exactly():
    grads = _grad_tree(scale=1.5)
    sync_group, over_group = _LoopbackGroup(), _LoopbackGroup()
    sync = GradientReduceScheduler(sync_group, bucket_bytes=512, overlap=False).step(grads)
    over = GradientReduceScheduler(over_group, bucket_bytes=512, overlap=True).step(grads)
    assert sync_group.calls == over_group.calls > 1
    for k in grads:
        assert torch.equal(sync[k], over[k])
        assert torch.equal(sync[k], grads[k] * 3.0)
    over_group.destroy()


def test_scheduler_stale_grad_pipeline():
    group = _LoopbackGroup(factor=2.0)
    sched = GradientReduceScheduler(group, bucket_bytes=512, overlap=True, stale_grad=1)
    g1, g2 = _grad_tree(1.0), _grad_tree(10.0)
    assert sched.step(g1) is None  # the first step: nothing reduced yet
    out1 = sched.step(g2)  # the first step's gradients
    tail = sched.flush()  # the second step's delayed reduction
    for k in g1:
        assert torch.equal(out1[k], g1[k] * 2.0) and torch.equal(tail[k], g2[k] * 2.0)
    assert sched.flush() is None
    with pytest.raises(ValueError, match="stale_grad"):
        GradientReduceScheduler(group, stale_grad=2)
    group.destroy()


def test_scheduler_rebuilds_bucketizer_on_structure_change():
    sched = GradientReduceScheduler(_LoopbackGroup(), bucket_bytes=512)
    b1 = sched.bucketizer_for(_grad_tree())
    assert sched.bucketizer_for(_grad_tree(scale=2.0)) is b1  # cached
    assert sched.bucketizer_for({"other": torch.ones(4)}) is not b1


def test_scheduler_records_overlap_split():
    group = _LoopbackGroup(op_delay=0.02, name="ovl-metrics-port")
    sched = GradientReduceScheduler(group, bucket_bytes=512, overlap=True)
    pending = sched.reduce(_grad_tree())
    time.sleep(0.2)  # the "backward" that covers the reduction
    pending.wait()
    summary = metrics.collective_overlap_summary()["ovl-metrics-port"]
    assert summary["overlapped_s"] > 0
    # the emulated compute covers the rendezvous: mostly hidden
    assert summary["overlap_fraction"] > 0.5
    # the sync path on the same group records exposed time only
    GradientReduceScheduler(group, bucket_bytes=512, overlap=False).step(_grad_tree())
    after = metrics.collective_overlap_summary()["ovl-metrics-port"]
    assert after["exposed_s"] > summary["exposed_s"]
    assert after["overlapped_s"] == summary["overlapped_s"]
    group.destroy()


def test_tensor_nbytes_of_tensors_arrays_and_objects():
    assert tensor_nbytes(torch.zeros(3, 4, dtype=torch.bfloat16)) == 24
    assert tensor_nbytes(np.zeros(5, np.float64)) == 40
    assert tensor_nbytes(b"abc") == 3 and tensor_nbytes(7) == 8 and tensor_nbytes(2.5) == 8
    assert tensor_nbytes([1.0, 2.0]) == 16


def test_registry_needs_a_process_group_and_nccl_needs_a_card_per_rank():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        col.init_collective_group(1, 0, backend="gloo", group_name="nope")
    with pytest.raises(ValueError, match='backend="gloo"'):
        check_distinct_cards([0, 0])
    with pytest.raises(ValueError, match='backend="gloo"'):
        check_distinct_cards([None, None])
    check_distinct_cards([0, 1, 2])


# -- GlooGroup at 2 and 4 ranks ------------------------------------------------


def _gloo_inputs(world):
    rng = np.random.default_rng(100 + world)
    return dict(
        x=rng.standard_normal((world, 37, 5)).astype(np.float32),
        uneven=rng.standard_normal((world, 7, 3)).astype(np.float32),
        rounds=rng.standard_normal((_ROUNDS, world, 300)).astype(np.float32),
        rs_rounds=rng.standard_normal((3, world, 9, 40)).astype(np.float32),
        ints=rng.integers(-50, 50, (world, 11)).astype(np.int64),
    )


def _gloo_ops(rank, world, data):
    """Every op of a plain and a quantized GlooGroup, and the abort."""
    x = torch.from_numpy(data["x"][rank])
    g = col.init_collective_group(world, rank, backend="gloo", group_name="ops")
    out = {op.name: g.allreduce(x, op).numpy() for op in ReduceOp}
    out["numpy_sum"] = g.allreduce(data["ints"][rank])  # numpy in, numpy out
    out["float_sum"] = g.allreduce(float(rank) + 0.5)
    out["allgather"] = [t.numpy() for t in g.allgather(x)]
    out["allgather_obj"] = g.allgather({"rank": rank, "tag": "x" * rank})
    out["reducescatter"] = g.reducescatter(torch.from_numpy(data["uneven"][rank])).numpy()
    out["broadcast"] = g.broadcast(x, src_rank=world - 1).numpy()
    out["broadcast_obj"] = g.broadcast({"from": rank} if rank == 1 else None, src_rank=1)
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    if rank % 2 == 0:
        g.send({"to": nxt, "from": rank}, nxt)
        out["recv"] = g.recv(prv)
    else:
        out["recv"] = g.recv(prv)
        g.send({"to": nxt, "from": rank}, nxt)
    g.barrier()
    out["async"] = g.allreduce_async(x).wait().numpy()
    out["summary"] = metrics.collective_summary()

    q = col.init_collective_group(world, rank, backend="gloo", group_name="q",
                                  quantized=True, quant_block=_QBLOCK)
    out["q_rounds"] = [q.allreduce(torch.from_numpy(r[rank])).numpy() for r in data["rounds"]]
    out["q_rs_rounds"] = [q.reducescatter(torch.from_numpy(r[rank])).numpy()
                          for r in data["rs_rounds"]]
    out["q_min"] = q.allreduce(x, ReduceOp.MIN).numpy()
    out["q_max"] = q.allreduce(x, ReduceOp.MAX).numpy()
    out["q_summary"] = metrics.collective_summary()

    a = col.init_collective_group(world, rank, backend="gloo", group_name="abort-me")
    a.barrier()
    if rank == 0:
        out["abort_advanced"] = col.abort_collective_group("abort-me", reason="test")
    dist.barrier()  # the mark is written before any rank looks
    try:
        a.allreduce(x)
        out["aborted"] = False
    except CollectiveAbortedError:
        out["aborted"] = True
    try:
        a.allreduce_async(x).wait()
        out["async_aborted"] = False
    except CollectiveAbortedError:
        out["async_aborted"] = True
    for name in ("ops", "q", "abort-me"):
        col.destroy_collective_group(name)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def gloo_run(request):
    world = request.param
    data = _gloo_inputs(world)
    return world, data, run_ranks(_gloo_ops, world, data)


def test_gloo_allreduce_ops_equal_numpy(gloo_run):
    world, data, outs = gloo_run
    x = data["x"]
    # np.sum over axis 0 adds the ranks' rows in sequence, as the group does
    want = {"SUM": np.sum(x, axis=0), "PRODUCT": np.prod(x, axis=0),
            "MIN": np.min(x, axis=0), "MAX": np.max(x, axis=0)}
    for out in outs:
        for op, w in want.items():
            np.testing.assert_array_equal(out[op], w, err_msg=op)  # exact
        np.testing.assert_array_equal(out["async"], want["SUM"])
        np.testing.assert_array_equal(out["numpy_sum"], data["ints"].sum(axis=0))
        assert isinstance(out["numpy_sum"], np.ndarray)
        assert out["float_sum"] == sum(r + 0.5 for r in range(world))


def test_gloo_allgather_broadcast_send_recv(gloo_run):
    world, data, outs = gloo_run
    for rank, out in enumerate(outs):
        for r in range(world):
            np.testing.assert_array_equal(out["allgather"][r], data["x"][r])
        assert out["allgather_obj"] == [{"rank": r, "tag": "x" * r} for r in range(world)]
        np.testing.assert_array_equal(out["broadcast"], data["x"][world - 1])
        assert out["broadcast_obj"] == {"from": 1}
        assert out["recv"] == {"to": rank, "from": (rank - 1) % world}


def test_gloo_uneven_reducescatter_is_array_split(gloo_run):
    world, data, outs = gloo_run
    shards = np.array_split(np.sum(data["uneven"], axis=0), world, axis=0)
    assert len({s.shape[0] for s in shards}) == 2  # 7 rows: uneven at 2 and 4
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["reducescatter"], shards[rank])


def test_gloo_quantized_allreduce_is_the_reference_formula_bit_for_bit(gloo_run):
    from ray_tpu._internal.quantization import dequantize_np as ref_dequantize
    from ray_tpu._internal.quantization import ef_quantize_np as ref_ef_quantize

    world, data, outs = gloo_run

    def reference_rounds(rounds, shard=None):
        residuals = [None] * world
        wants = []
        for t in range(len(rounds)):
            deq = []
            for r in range(world):
                qa, residuals[r] = ref_ef_quantize(rounds[t][r], residuals[r], _QBLOCK)
                deq.append(ref_dequantize(qa, dtype="float32"))
            wants.append(np.sum(deq, axis=0).astype(np.float32))
        return wants

    wants = reference_rounds(data["rounds"])
    rs_wants = reference_rounds(data["rs_rounds"])
    for rank, out in enumerate(outs):
        for t in range(_ROUNDS):
            np.testing.assert_array_equal(out["q_rounds"][t], wants[t], err_msg=f"round {t}")
        for t, want in enumerate(rs_wants):
            np.testing.assert_array_equal(out["q_rs_rounds"][t],
                                          np.array_split(want, world, axis=0)[rank])
    # the feedback works: the codec's error does not accumulate
    exact = data["rounds"].sum(axis=(0, 1))
    got = np.sum(outs[0]["q_rounds"], axis=0)
    step = np.abs(data["rounds"]).max() / 127
    assert np.abs(got - exact).max() < world * step


def test_gloo_quantized_group_keeps_min_max_exact_and_counts_wire_bytes(gloo_run):
    world, data, outs = gloo_run
    for out in outs:
        np.testing.assert_array_equal(out["q_min"], np.min(data["x"], axis=0))
        np.testing.assert_array_equal(out["q_max"], np.max(data["x"], axis=0))
        plain, quant = out["summary"], out["q_summary"]
        # the plain group: wire = logical
        assert plain["allreduce"]["wire_bytes"] == plain["allreduce"]["bytes"]
        assert plain["allreduce"]["count"] == 7  # four ops, numpy, float, async
        # ten quantized rounds of 300 f32: 5 blocks of 64 codes + 5 scales each
        added = {k: quant["allreduce"][k] - plain["allreduce"][k] for k in ("bytes", "wire_bytes")}
        full = 2 * 37 * 5 * 4  # MIN and MAX ship full width
        assert added["bytes"] == _ROUNDS * 300 * 4 + full
        assert added["wire_bytes"] == _ROUNDS * (5 * _QBLOCK + 5 * 4) + full


def test_gloo_abort_fails_ops_and_waits(gloo_run):
    _, _, outs = gloo_run
    assert outs[0]["abort_advanced"] is True
    assert all(out["aborted"] and out["async_aborted"] for out in outs)


# -- NcclGroup's quantized programs against XlaGroup ---------------------------


def _nccl_programs(rank, world, rounds, gather_x, rs_x):
    from ray_tpu_torch.collective.nccl_group import (
        NcclGroup,
        quantized_allgather,
        quantized_allreduce,
        quantized_reducescatter,
    )

    pg = dist.group.WORLD
    residual, outs, residuals = None, [], []
    for t in range(len(rounds)):
        out, residual = quantized_allreduce(torch.from_numpy(rounds[t][rank:rank + 1]),
                                            residual, _QBLOCK, pg)
        outs.append(out.numpy())
        residuals.append(residual.numpy())
    gathered = quantized_allgather(torch.from_numpy(gather_x[rank:rank + 1]), _QBLOCK, pg)
    shard, _ = quantized_reducescatter(torch.from_numpy(rs_x[rank]), None, _QBLOCK, pg)
    group = NcclGroup(world, rank, "nccl-on-gloo", process_group=pg)
    try:
        group.allreduce(torch.ones(4))
        refused = None
    except TypeError as e:
        refused = str(e)
    return dict(outs=outs, residuals=residuals, gathered=gathered.numpy(),
                shard=shard.numpy(), refused=refused)


def _block_amax(rows):
    """Each element's block's largest magnitude, per row of (world, n)."""
    w, n = rows.shape
    pad = (-n) % _QBLOCK
    blocks = np.abs(np.pad(rows, ((0, 0), (0, pad)))).reshape(w, -1, _QBLOCK)
    return np.repeat(blocks.max(axis=2), _QBLOCK, axis=1)[:, :n]


def test_nccl_quantized_programs_match_xla_group():
    import jax

    from ray_tpu.collective.xla_group import XlaGroup

    world = 4
    rng = np.random.default_rng(21)
    rounds = (rng.standard_normal((_ROUNDS, world, 200)) * np.linspace(0.1, 3, 200)
              ).astype(np.float32)
    gather_x = rng.standard_normal((world, 150)).astype(np.float32)
    rs_x = rng.standard_normal((world, 8, 30)).astype(np.float32)
    outs = run_ranks(_nccl_programs, world, rounds, gather_x, rs_x)

    xla = XlaGroup(1, 0, "q-xla", devices=jax.devices()[:world], quantized=True,
                   quant_block=_QBLOCK)
    prev_res = np.zeros((world, 200), np.float32)
    for t in range(_ROUNDS):
        want = np.asarray(xla.allreduce(rounds[t]))  # row r: rank r's contribution
        want_res = np.asarray(xla._ef_residuals[("allreduce", (world, 200), "float32")])
        # a dequantized element is its code times its block's scale, and
        # the scale (amax / 127) moves by an ulp of the block's largest
        # |x + residual| when the carried residuals part by a rounding
        # step; XLA may also fuse q * scale into the subtraction and add
        # the ranks' rows in another order. So the residuals agree within
        # 4 ulps of the block's amax, and the sums within 4 ulps of the
        # ranks' amaxes summed.
        amax = _block_amax(rounds[t] + prev_res)
        for rank, out in enumerate(outs):
            assert out["outs"][t].shape == (1, 200)
            assert np.all(np.abs(out["outs"][t][0] - want[0])
                          <= 4 * F32_EPS * amax.sum(axis=0)), f"round {t}"
            assert np.all(np.abs(out["residuals"][t][0] - want_res[rank])
                          <= 4 * F32_EPS * amax[rank]), f"round {t} residual"
        prev_res = want_res
    want_gather = np.asarray(xla.allgather(gather_x))
    gather_amax = _block_amax(gather_x)
    for rank, out in enumerate(outs):
        # no sum, but XLA may divide amax by 127 as a multiply by 1/127, an
        # ulp off the port's f32 division: within 2 ulps of the block's amax
        assert np.all(np.abs(out["gathered"] - want_gather) <= 2 * F32_EPS * gather_amax)
        assert "CUDA tensors" in out["refused"] and 'backend="gloo"' in out["refused"]
    # every rank's full tensor through the reference's codec, summed, then
    # rank r's rows (its _qreducescatter program takes one replicated input,
    # so it cannot stand for four ranks' different ones)
    from ray_tpu._internal.quantization import dequantize_jax, quantize_jax

    total = np.sum([np.asarray(dequantize_jax(*quantize_jax(rs_x[r], _QBLOCK), rs_x[r].shape,
                                              np.float32)) for r in range(world)], axis=0)
    amax = _block_amax(rs_x.reshape(world, -1)).reshape(rs_x.shape)
    for rank, out in enumerate(outs):
        rows = slice(rank * 2, rank * 2 + 2)
        # the same codes; the ranks' rows added in another order
        assert np.all(np.abs(out["shard"] - total[rows]) <= 4 * F32_EPS * amax.sum(axis=0)[rows])


# -- expert parallelism at 2 ranks ---------------------------------------------


def _moe_ranks(rank, world, x, logits, w, cap):
    from ray_tpu_torch.parallel import expert as texp

    t = x.shape[0] // world
    e_local = w.shape[0] // world
    xs = torch.from_numpy(x[rank * t:(rank + 1) * t]).requires_grad_(True)
    dispatch, combine, _ = texp.top_k_gating(
        torch.from_numpy(logits[rank * t:(rank + 1) * t]), cap, k=2)
    slabs = texp.moe_dispatch(xs, dispatch, group=dist.group.WORLD)
    y = torch.bmm(slabs, torch.from_numpy(w[rank * e_local:(rank + 1) * e_local]))
    out = texp.moe_combine(y, combine, group=dist.group.WORLD)
    out.sum().backward()
    return dict(slabs=slabs.detach().numpy(), out=out.detach().numpy(),
                grad=xs.grad.numpy())


def test_moe_dispatch_and_combine_at_two_ranks_match_reference():
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from ray_tpu._internal.jax_compat import shard_map
    from ray_tpu.parallel import expert as jexp
    from ray_tpu_torch.parallel import expert as texp

    world, t, e, d = 2, 16, 4, 8
    rng = np.random.default_rng(9)
    x = rng.standard_normal((world * t, d)).astype(np.float32)
    logits = rng.standard_normal((world * t, e)).astype(np.float32)
    w = (rng.standard_normal((e, d, d)) / np.sqrt(d)).astype(np.float32)
    cap = texp.expert_capacity(t, e, 1.0, 2)
    mesh = Mesh(np.array(jax.devices()[:world]), ("ep",))

    def local(x_, lg_, w_):
        dispatch, combine, _ = jexp.top_k_gating(lg_, cap, k=2)
        slabs = jexp.moe_dispatch(x_, dispatch, axis_name="ep")
        return slabs, jexp.moe_combine(jax.numpy.matmul(slabs, w_), combine, axis_name="ep")

    spec = P("ep")
    sharded = shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                        out_specs=(spec, spec), check_vma=False)

    @jax.jit
    def forward_and_grad(x_):
        (slabs_, out_), vjp = jax.vjp(lambda v: sharded(v, logits, w), x_)
        return slabs_, out_, vjp((jax.numpy.zeros_like(slabs_), jax.numpy.ones_like(out_)))[0]

    jslabs, jout, jgrad = forward_and_grad(x)
    outs = run_ranks(_moe_ranks, world, x, logits, w, cap)
    e_local = e // world
    for rank, out in enumerate(outs):
        assert out["slabs"].shape == (e_local, world * cap, d)
        # copies of input rows through the exchange: equal
        np.testing.assert_array_equal(out["slabs"], np.asarray(jslabs)[rank * e_local:
                                                                       (rank + 1) * e_local])
        rows = slice(rank * t, (rank + 1) * t)
        # f32 products and sums of two terms, in each framework's order
        np.testing.assert_allclose(out["out"], np.asarray(jout)[rows], rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["grad"], np.asarray(jgrad)[rows], rtol=0, atol=1e-6)
