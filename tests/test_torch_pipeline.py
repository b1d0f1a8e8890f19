"""``parallel.pipeline_apply`` (GPipe over a ``pp`` group) against the
reference's, on the CPU.

Four spawned gloo ranks (a ``TCPStore`` on port 0 in this process), the
``pp`` group of a ``pp=4`` mesh (``Mesh.form_groups``):

- the reference test's case (``tests/test_parallel_ext.py:146-172``): 4
  stages scaling by 2, 3, 5 and 7, 6 microbatches of 8; the output summed
  over the group is ``xs * 210`` within rtol 1e-5, and is zeros before the
  sum on every rank but the last;
- a stage with parameters, ``tanh(x @ W_s)`` in f32 (5 microbatches of
  3 x 8, so the stages' 8 ticks hold a fill and a drain): the last rank's
  output, each stage's gradient of ``sum(out * c)`` and the microbatches'
  gradient against ``jax.grad`` of the reference's ``pipeline_apply``
  under ``shard_map`` on the 4-device host mesh (each device's gradient
  of its own loss, as every rank's ``backward`` is), within 1e-5 of the
  largest |value|; the reference's gradients are themselves held to
  ``jax.grad`` of the four stages composed in one function.

The children import this module by name, so it imports neither ``jax`` nor
``ray_tpu`` at its top.
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

from ray_tpu_torch.parallel import pipeline_apply, select_stage_params, stage_index
from ray_tpu_torch.parallel.mesh import make_mesh

_DEADLINE_S = 60.0
_WORLD = 4
_SCALES = np.array([2.0, 3.0, 5.0, 7.0], np.float32)
_MICRO, _ROWS, _WIDTH = 5, 3, 8


def _scaling_inputs():
    return np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)


def _dense_inputs():
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((_MICRO, _ROWS, _WIDTH)).astype(np.float32)
    w = (rng.standard_normal((_WORLD, _WIDTH, _WIDTH)) / np.sqrt(_WIDTH)).astype(np.float32)
    c = rng.standard_normal((_MICRO, _ROWS, _WIDTH)).astype(np.float32)
    return xs, w, c


def _child(rank, port, results):
    store = dist.TCPStore("127.0.0.1", port, _WORLD + 1, is_master=False,
                          timeout=datetime.timedelta(seconds=_DEADLINE_S))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=_WORLD,
                            timeout=datetime.timedelta(seconds=_DEADLINE_S))
    try:
        results.put((rank, _stages(rank), None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _stages(rank):
    torch.set_num_threads(1)
    mesh = make_mesh(devices=["cpu"] * _WORLD, pp=_WORLD, fsdp=1).form_groups("gloo")
    group = mesh.group("pp")
    out = {"stage": stage_index(group)}
    # the reference test's case
    xs = torch.from_numpy(_scaling_inputs())
    scale = select_stage_params(torch.from_numpy(_SCALES), group)
    y = pipeline_apply(lambda p, x: x * p, scale, xs, group=group)
    out["scaled_local"] = y.numpy()
    out["scaled"] = group.allreduce(y).numpy()
    # a stage with parameters, forward and backward
    xs, w, c = (torch.from_numpy(a) for a in _dense_inputs())
    xs.requires_grad_(True)
    weight = select_stage_params(w, group).clone().requires_grad_(True)
    y = pipeline_apply(lambda p, x: torch.tanh(x @ p), weight, xs, group=group)
    (y * c).sum().backward()
    out.update(dense=y.detach().numpy(), dw=weight.grad.numpy(), dxs=xs.grad.numpy())
    return out


@pytest.fixture(scope="module")
def pipeline_run():
    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, _WORLD + 1, is_master=True, wait_for_workers=False)
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, store.port, results), daemon=True)
             for r in range(_WORLD)]
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


def _reference_dense():
    """The reference's output, each device's stage gradient and microbatch
    gradient (stacked by device), and the composed function's gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from ray_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    xs, w, c = (jnp.asarray(a) for a in _dense_inputs())
    mesh = Mesh(np.array(jax.devices()[:_WORLD]), ("pp",))

    def body(xs, w, c):
        def local(xs, w):
            out = jax_pipeline_apply(lambda p, x: jnp.tanh(x @ p), w[0], xs, axis_name="pp")
            return jnp.sum(out * c), out

        (dxs, dw), out = jax.grad(local, argnums=(0, 1), has_aux=True)(xs, w)
        return out[None], dw, dxs[None]

    run = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("pp"), P()),
                            out_specs=(P("pp"), P("pp"), P("pp")), check_vma=False))
    out, dw, dxs = run(xs, w, c)

    def composed(xs, w):
        y = xs
        for s in range(_WORLD):
            y = jnp.tanh(y @ w[s])
        return jnp.sum(y * c)

    cdxs, cdw = jax.grad(composed, argnums=(0, 1))(xs, w)
    return dict(out=np.asarray(out), dw=np.asarray(dw), dxs=np.asarray(dxs),
                composed_dw=np.asarray(cdw), composed_dxs=np.asarray(cdxs))


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{what}: max abs err {err}"


def test_four_stages_scale_by_210(pipeline_run):
    """The reference test: the output summed over the group is xs * 210 on
    every rank (rtol 1e-5); before the sum, the last rank holds it and the
    others zeros."""
    xs = _scaling_inputs()
    for rank, out in enumerate(pipeline_run):
        assert out["stage"] == rank
        np.testing.assert_allclose(out["scaled"], xs * 210.0, rtol=1e-5)
        if rank == _WORLD - 1:
            np.testing.assert_allclose(out["scaled_local"], xs * 210.0, rtol=1e-5)
        else:
            assert not out["scaled_local"].any()


def test_output_and_gradients_match_jax_grad_of_the_reference(pipeline_run):
    """The last rank's output and zeros elsewhere, each stage's weight
    gradient and each rank's microbatch gradient (rank 0's the whole, the
    others' 0) against ``jax.grad`` of the reference's pipeline under
    ``shard_map``, within 1e-5 of the largest |value|."""
    ref = _reference_dense()
    _close(ref["dw"], ref["composed_dw"], 1e-5, "the reference against the composition")
    _close(ref["dxs"][0], ref["composed_dxs"], 1e-5, "the reference's dxs")
    for rank, out in enumerate(pipeline_run):
        if rank == _WORLD - 1:
            _close(out["dense"], ref["out"][rank], 1e-5, "output")
        else:
            assert not out["dense"].any() and not ref["out"][rank].any()
        _close(out["dw"], ref["dw"][rank], 1e-5, f"stage {rank} weight gradient")
        if rank == 0:
            _close(out["dxs"], ref["dxs"][0], 1e-5, "microbatch gradient")
        else:
            assert not out["dxs"].any() and not ref["dxs"][rank].any()


def test_one_rank_applies_the_stage_in_turn_and_shapes_are_kept():
    """A group of one (or None) applies the stage to each microbatch; a
    stage that changes the activation's shape raises (the reference's scan
    carries one shape)."""
    xs = torch.from_numpy(_scaling_inputs())
    y = pipeline_apply(lambda p, x: x * p, torch.tensor(3.0), xs, group=None)
    assert torch.equal(y, xs * 3.0)

    class _LastOfTwo:  # rank 1 of 2, whose previous rank sends zeros
        world_size, rank = 2, 1

        def recv(self, src):
            return torch.zeros(8)

    with pytest.raises(ValueError, match="keep the activation"):
        pipeline_apply(lambda p, x: x[:4] * p, torch.tensor(1.0), torch.zeros(2, 8),
                       group=_LastOfTwo())
