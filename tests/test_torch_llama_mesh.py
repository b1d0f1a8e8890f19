"""The Llama over a mesh of the port against the reference's, on the CPU.

The reference's Llama runs under any mesh of its axes: GSPMD splits the
heads, the MLP and the vocabulary over ``tp`` by the rule table, the batch
over the data axes, and the ring over ``sp``
(``ray_tpu/models/llama.py:248-261``); its own check is
tests/test_parallel.py's loss at ``make_mesh(dp=1, fsdp=2, sp=2, tp=2)``.
The port runs one gang of eight spawned gloo ranks
(``train.DataParallelTrainer``) in rounds: that mesh on all eight, with
remat (every block, its gathers and its ring run again in the backward);
then ``tp=2 x fsdp=2`` and ``dp=2 x fsdp=2`` on four ranks each; then
``sp=2 x dp=2`` on four, ``tp=2`` and ``sp=2`` on two each.

``LlamaConfig.tiny(n_kv_heads=2, lora_rank=4)`` in f32 (GQA: 4 query heads
over 2 KV heads, so one KV head a rank at ``tp=2``) with the reference's
tree filled from a numpy seed (``lora_b`` too, or every ``lora_a``
gradient would be 0), carried over by ``params_from_jax``, and a global
batch of 4 x 32 tokens. Each rank reports its logits, its loss, its LoRA
gradient blocks (after ``model.fsdp.sync_gradients``), its blocks' shapes
and the full adapters ``model.fsdp.full_state`` gathers, held against the
reference's ``jax.value_and_grad`` of ``next_token_loss(config, mesh,
merge_lora(base, lora), tokens)`` jitted on the 8-device host mesh
(GSPMD gives one function on any mesh, so its numbers are every
sub-mesh's). Tolerances, relative to the largest |value| of the whole
tensor: logits 1e-5, the loss 1e-5, LoRA gradients 1e-4. The ranks that
hold one block hold one gradient, bit for bit.

The loop: its own worker (``llama_lora.train_loop_per_worker``, what
``make_trainer`` runs) on four ranks at ``tp=2 x fsdp=2`` and at
``dp=2 x fsdp=2``, 3 steps in f32 activations, against the one-rank
``fit()`` on the same rows concatenated (the data shards' rows in shard
order), which tests/test_torch_train.py holds against optax.

The workers import this module by name, so it imports neither ``jax`` nor
``ray_tpu`` at its top.
"""

import dataclasses
import multiprocessing
import os
import pickle
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import train
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel.mesh import BATCH_AXES, make_mesh
from ray_tpu_torch.train.examples import llama_lora

_DEADLINE_S = 150.0
_RANKS = 8
_TOKENS = (4, 32)
_ROUNDS = [
    [("fsdp2_sp2_tp2", {"fsdp": 2, "sp": 2, "tp": 2}, list(range(8)), True)],
    [("tp2_fsdp2", {"fsdp": 2, "tp": 2}, [0, 1, 2, 3], False),
     ("dp2_fsdp2", {"dp": 2, "fsdp": 2}, [4, 5, 6, 7], False)],
    [("sp2_dp2", {"dp": 2, "sp": 2, "fsdp": 1}, [0, 1, 2, 3], False),
     ("tp2", {"tp": 2, "fsdp": 1}, [4, 5], False), ("sp2", {"sp": 2, "fsdp": 1}, [6, 7], False)],
]
_MESHES = {name: (axes, ranks, remat) for rnd in _ROUNDS for name, axes, ranks, remat in rnd}
_LOOP = {"model": "tiny", "device": "cpu", "seq": 16, "epochs": 3, "steps_per_epoch": 1,
         "batch_per_worker": 1}
_LAYOUTS = {"tp2_fsdp2": {"tp": 2, "fsdp": 2}, "dp2_fsdp2": {"dp": 2, "fsdp": 2}}
_LR = 1e-4


def _tiny(remat=False):
    return tllama.LlamaConfig.tiny(n_kv_heads=2, lora_rank=4, dtype=torch.float32, remat=remat)


def _tokens(seed=51):
    return np.random.default_rng(seed).integers(0, 256, _TOKENS).astype(np.int64)


def _mesh_loop(config):
    """Each round: form every mesh's groups (all ranks, one order), then on
    the rank's own mesh: logits, loss, the synced gradients, the full
    adapters."""
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.train import collective as tcol

    torch.set_num_threads(1)
    rank = train.get_context().world_rank
    tokens = torch.from_numpy(_tokens())
    for rnd in _ROUNDS:
        own = None
        for name, axes, ranks, remat in rnd:
            if len(ranks) == _RANKS:
                mesh = tcol.gang_mesh("cpu", **axes)
            else:
                mesh = make_mesh(devices=["cpu"] * len(ranks), **axes).form_groups(
                    "gloo", world_ranks=ranks, name=name)
            if mesh is not None:
                own = name, mesh, remat
        if own is None:
            continue
        name, mesh, remat = own
        tcfg = _tiny(remat)
        params = params_from_jax(config["params"], tcfg, device="cpu")
        model, lora, _ = llama_lora.lora_model(tcfg, params, mesh=mesh)
        n = mesh.axes_size(BATCH_AXES)
        shard = mesh.axes_index(BATCH_AXES)
        rows = slice(shard * _TOKENS[0] // n, (shard + 1) * _TOKENS[0] // n)
        with torch.no_grad():
            logits = model(tokens[rows])
        loss = tllama.next_token_loss(tcfg, model, tokens[rows])
        loss.backward()
        model.fsdp.sync_gradients(model.named_parameters())
        train.report({"rank": rank, "mesh": name, "mesh_rank": mesh.rank, "rows": rows,
                      "logits": logits.numpy(), "loss": loss.item(),
                      "grads": {n_: p.grad.numpy().copy() for n_, p in lora.items()},
                      "full": {n_: t.numpy().copy()
                               for n_, t in model.fsdp.full_state(lora).items()},
                      "block_shapes": {n_: tuple(p.shape) for n_, p in model.named_parameters()}})


def _reference_tree(jcfg):
    """The reference's tree of ``jcfg`` filled from a numpy seed: norms in
    [0.5, 1.5], ``lora_b`` 0.05 x N(0, 1), the rest N(0, 1 / fan_in)."""
    import jax

    from ray_tpu.models.llama import init_params
    from ray_tpu.parallel.sharding import unbox_params

    shapes = jax.eval_shape(lambda r: unbox_params(init_params(jcfg, r)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(50)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key.endswith("norm"):
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif key == "lora_b":
                out[key] = (0.05 * rng.standard_normal(val.shape)).astype(np.float32)
            else:
                fan_in = int(np.prod(val.shape[:-1]))
                out[key] = (rng.standard_normal(val.shape) / np.sqrt(fan_in)).astype(np.float32)
        return out

    return fill(shapes)


@pytest.fixture(scope="module")
def mesh_run():
    """The gang's reports, and the reference's logits, loss and LoRA
    gradients on the target mesh, computed while the gang runs."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.llama import Llama as JaxLlama
    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.models.llama import init_params as jax_init_params
    from ray_tpu.models.llama import next_token_loss as jax_next_token_loss
    from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ray_tpu.parallel.sharding import param_shardings as jax_param_shardings
    from ray_tpu.train.lora import merge_lora, split_lora
    from ray_tpu_torch.models.convert import _flatten

    jcfg = JaxLlamaConfig.tiny(n_kv_heads=2, lora_rank=4, dtype=jnp.float32)
    params = _reference_tree(jcfg)
    box = []
    with tempfile.TemporaryDirectory() as storage:
        trainer = train.DataParallelTrainer(
            _mesh_loop, train_loop_config={"params": params},
            scaling_config=train.ScalingConfig(_RANKS, {"CPU": 1}),
            run_config=train.RunConfig(name="llama-mesh", storage_path=storage),
            backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)))
        thread = threading.Thread(target=lambda: box.append(trainer.fit()), daemon=True)
        thread.start()

        mesh = jax_make_mesh(8, fsdp=2, sp=2, tp=2)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        base, lora = split_lora(jparams)
        tokens = jnp.asarray(_tokens(), jnp.int32)
        logits = jax.jit(lambda p, t: JaxLlama(jcfg, mesh).apply({"params": p}, t))(
            jparams, tokens)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda lp, t: jax_next_token_loss(jcfg, mesh, merge_lora(base, lp), t)))(lora, tokens)
        reference = dict(logits=np.asarray(logits), loss=float(loss),
                         grads={".".join(k): np.asarray(v) for k, v in grads.items()},
                         lora={".".join(k): np.asarray(v) for k, v in lora.items()})
        shardings = jax_param_shardings(mesh, jax_init_params(jcfg, jax.random.PRNGKey(0)))
        specs = {k: tuple(v.spec) for k, v in _flatten(shardings).items()}
        thread.join(_DEADLINE_S)
        if thread.is_alive():
            for child in multiprocessing.active_children():
                child.kill()
            thread.join(10)
            pytest.fail(f"fit() did not finish in {_DEADLINE_S} s; its workers were killed")
    assert not multiprocessing.active_children()
    result = box[0]
    assert result.error is None, result.error
    reports = {}
    for m in result.metrics_history:
        reports.setdefault(m["mesh"], {})[m["mesh_rank"]] = m
    for name, (axes, ranks, _) in _MESHES.items():
        assert sorted(reports[name]) == list(range(len(ranks))), name
    return reports, reference, specs


def _close(got, want, rel, what, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _layout(name):
    from ray_tpu_torch.parallel.sharding import param_shardings

    axes, ranks, _ = _MESHES[name]
    mesh = make_mesh(devices=["cpu"] * len(ranks), **axes)
    return mesh, param_shardings(mesh, tllama.param_shapes(_tiny()))


def test_parameter_specs_are_the_references(mesh_run):
    """Every parameter's spec on the target mesh, the LoRA factors' with
    them (``wq``/``wk``/``wv`` ``lora_b`` and ``wo`` ``lora_a`` over
    ``tp``), is the reference's ``param_shardings``'."""
    _, _, specs = mesh_run
    _, shardings = _layout("fsdp2_sp2_tp2")
    assert sorted(shardings) == sorted(specs)
    for name, sharding in shardings.items():
        got, want = tuple(sharding.spec), specs[name]
        n = max(len(got), len(want))
        assert got + (None,) * (n - len(got)) == want + (None,) * (n - len(want)), name
    assert tuple(shardings["layer_0.attn.wq.lora_b"].spec) == (None, "tp")
    assert tuple(shardings["layer_0.attn.wo.lora_a"].spec) == ("tp", None)


@pytest.mark.parametrize("name", list(_MESHES))
def test_logits_loss_and_gradients_match_the_reference(mesh_run, name):
    """Each rank's logits are its rows and its sequence shard of the
    reference's, its loss the global batch's, and its LoRA gradient blocks
    the reference's gradients' blocks; the ranks holding one block hold one
    gradient, bit for bit (a factor replicated over ``tp`` gets its whole
    gradient on each ``tp`` rank through the pair around its rank-r
    product; none is reduced over ``tp``)."""
    reports, ref, _ = mesh_run
    axes, _, _ = _MESHES[name]
    mesh, shardings = _layout(name)
    s = _TOKENS[1] // axes.get("sp", 1)
    held = {}
    for r, m in reports[name].items():
        seq = slice(mesh.coords(r)["sp"] * s, (mesh.coords(r)["sp"] + 1) * s)
        _close(m["logits"], ref["logits"][m["rows"], seq], 1e-5, f"{name} rank {r} logits",
               np.abs(ref["logits"]).max())
        assert abs(m["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]), (name, r)
        assert sorted(m["grads"]) == sorted(ref["grads"])
        for pname, g in m["grads"].items():
            want = ref["grads"][pname]
            index = shardings[pname].index(want.shape, r)
            assert g.shape == want[index].shape == m["block_shapes"][pname], pname
            _close(g, want[index], 1e-4, f"{name} rank {r} {pname}", np.abs(want).max())
            key = (pname, tuple((i.start, i.stop) for i in index))
            if key in held:
                np.testing.assert_array_equal(g, held[key], err_msg=f"{name} {pname}")
            held[key] = g


@pytest.mark.parametrize("name", list(_MESHES))
def test_full_adapters_are_gathered_over_fsdp_and_tp(mesh_run, name):
    """``model.fsdp.full_state`` of the adapters gives every rank the whole
    factors, gathered over ``fsdp`` and ``tp`` alike: the reference's
    values, exactly (a checkpoint holds whole adapters)."""
    reports, ref, _ = mesh_run
    for m in reports[name].values():
        assert sorted(m["full"]) == sorted(ref["lora"])
        for pname, t in m["full"].items():
            np.testing.assert_array_equal(t, ref["lora"][pname], err_msg=f"{name} {pname}")


def test_blocks_are_the_rule_tables_share(mesh_run):
    """At fsdp=2 x sp=2 x tp=2 a rank holds exactly the rule table's share:
    a quarter of every kernel, of ``embed`` and of ``lm_head`` (fsdp x tp),
    half of each norm (fsdp) and of each LoRA factor (fsdp or tp); ``sp``
    splits no parameter."""
    reports, _, _ = mesh_run
    shapes = tllama.param_shapes(_tiny())
    for m in reports["fsdp2_sp2_tp2"].values():
        assert sorted(m["block_shapes"]) == sorted(shapes)
        for pname, shape in m["block_shapes"].items():
            share = int(np.prod(shape)) / int(np.prod(shapes[pname]))
            half = pname.endswith(("norm", "lora_a", "lora_b"))
            assert share == (0.5 if half else 0.25), pname


# -- the loop -----------------------------------------------------------------


def _f32_loop(config):
    """The loop's own worker, ``llama_lora.train_loop_per_worker``, with its
    model's activations in f32."""
    model_config = llama_lora.model_config
    llama_lora.model_config = lambda c: dataclasses.replace(model_config(c), dtype=torch.float32)
    try:
        llama_lora.train_loop_per_worker(config)
    finally:
        llama_lora.model_config = model_config


def _loop_trainer(num_workers, config, name, storage, resources_per_worker=None,
                  backend_config=None):
    """``llama_lora.make_trainer``'s TorchTrainer over :func:`_f32_loop`."""
    return train.TorchTrainer(
        _f32_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers, resources_per_worker),
        run_config=train.RunConfig(name=name, storage_path=storage),
        backend_config=backend_config)


def _shard_rows(cfg, n, batch, epoch, step, device):
    """The rows the loop's data shards 0..n-1 draw at one step, in order."""
    return torch.cat([_STEP_TOKENS(cfg, batch, epoch, step, d, device) for d in range(n)])


_STEP_TOKENS = llama_lora.step_tokens


@pytest.fixture(scope="module")
def loop_runs():
    """The loop at both layouts on four spawned ranks each (at once), and
    the one-rank ``fit()`` in this process on the data shards' rows
    concatenated, for each (:func:`_f32_loop`)."""
    with tempfile.TemporaryDirectory() as storage:
        trainers = []
        for name, axes in _LAYOUTS.items():
            trainers.append(_loop_trainer(
                4, {**_LOOP, **axes}, f"loop-{name}", storage, {"CPU": 1},
                train.TorchConfig(timeout_s=int(_DEADLINE_S))))
        box = {}
        threads = [threading.Thread(target=lambda n=n, t=t: box.__setitem__(n, t.fit()),
                                    daemon=True) for n, t in zip(_LAYOUTS, trainers)]
        start = time.monotonic()
        for thread in threads:
            thread.start()
        singles = {}
        for name, axes in _LAYOUTS.items():
            n = axes.get("dp", 1) * axes["fsdp"]
            one = _loop_trainer(1, {**_LOOP, "batch_per_worker": n}, f"one-{name}", storage)
            llama_lora.step_tokens = (
                lambda c, b, e, s, r, dev, n=n: _shard_rows(c, n, b // n, e, s, dev))
            try:
                singles[name] = one.fit()
            finally:
                llama_lora.step_tokens = _STEP_TOKENS
        for thread in threads:
            thread.join(max(0.0, start + _DEADLINE_S - time.monotonic()))
        if any(thread.is_alive() for thread in threads):
            for child in multiprocessing.active_children():
                child.kill()
            for thread in threads:
                thread.join(10)
            pytest.fail(f"fit() did not finish in {_DEADLINE_S} s; its workers were killed")
        assert not multiprocessing.active_children()
        out = {}
        for name in _LAYOUTS:
            for result in (box[name], singles[name]):
                assert result.error is None, result.error
            adapters = []
            for result in (box[name], singles[name]):
                with open(os.path.join(result.checkpoint.path, "lora.pkl"), "rb") as f:
                    adapters.append({k: v.numpy() for k, v in pickle.load(f)["lora"].items()})
            out[name] = dict(reports=box[name].metrics_history,
                             single=singles[name].metrics_history, adapters=adapters)
    return out


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_loop_trains_over_the_mesh_as_one_rank(loop_runs, name):
    """The loop's worker on four ranks at the layout: each step's loss is the
    same on every rank and is the one-rank run's on the data shards' rows
    concatenated (f32 activations: 1e-5 relative, a sum in another order);
    the checkpoint's adapters, whole, are that run's within Adam's bound
    (an element moves about lr a step whatever its gradient's size, so a
    near-zero gradient whose sign the rounding flips parts the two by up to
    2 lr a step; 99% of the elements within 1e-3 lr). The one-rank run
    draws the rows of each data shard by the shard's index, so the ranks of
    a ``tp`` group drew one shard's rows (seeded by the world rank, as the
    reference seeds, they would draw two, and the loss would part)."""
    run = loop_runs[name]
    axes = _LAYOUTS[name]
    mesh = make_mesh(devices=["cpu"] * 4, **axes)
    by_epoch = {}
    for m in run["reports"]:
        by_epoch.setdefault(m["epoch"], {})[m["rank"]] = m
    single = {m["epoch"]: m["loss"] for m in run["single"]}
    assert sorted(by_epoch) == sorted(single) == [0, 1, 2]
    for epoch, ranks in by_epoch.items():
        assert sorted(ranks) == [0, 1, 2, 3]
        losses = {m["loss"] for m in ranks.values()}
        assert len(losses) == 1, (epoch, losses)
        assert abs(losses.pop() - single[epoch]) <= 1e-5 * abs(single[epoch])
    if axes.get("tp", 1) > 1:  # each tp pair one shard
        assert [mesh.axes_index(BATCH_AXES, r) for r in range(4)] == [0, 0, 1, 1]
    got, want = run["adapters"]
    assert sorted(got) == sorted(want)
    steps = len(single)
    diffs = np.concatenate([np.abs(got[k] - v).ravel() for k, v in want.items()])
    assert diffs.max() <= 2 * steps * _LR
    assert np.quantile(diffs, 0.99) <= 1e-3 * _LR
    tcfg = llama_lora.model_config(_LOOP)
    _, start = train.split_lora(tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                                                   device="cpu"))
    moved = np.concatenate([np.abs(got[k] - v.numpy()).ravel() for k, v in start.items()])
    assert np.median(moved) >= 0.5 * _LR  # the steps moved the adapters
