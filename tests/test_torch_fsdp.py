"""FSDP training of the port against the reference, on the CPU.

The reference's LoRA loop lays its parameters out on an ``{"fsdp": n}``
mesh through ``param_shardings`` and steps under GSPMD
(``ray_tpu/train/examples/llama_lora.py:56-68``). The port runs n spawned
gloo ranks (``resources_per_worker={"CPU": 1}``), each holding its block of
every parameter the rule table sends to ``fsdp`` (parallel/fsdp.py):

- ``param_shardings``: each parameter's spec and each rank's block against
  the reference's ``param_shardings`` and ``addressable_shards`` on host
  meshes of fsdp=2 and fsdp=4, exactly;
- the tiny f32 LoRA model (2 layers, rank 4, remat) at fsdp=2 (3 steps)
  and fsdp=4 (1 step), batch 1 a rank, against the reference's jitted step
  on the global batch, its parameters placed by ``param_shardings`` on the
  same mesh: every rank's blocks at the start equal the reference's
  shards, and after the steps the adapters within Adam's bound (as
  tests/test_torch_train_dp.py: an element moves about lr a step whatever
  its gradient's size, so a near-zero gradient whose sign the f32 rounding
  flips parts the two by up to 2 lr a step; 99% of the elements agree
  within 1e-3 lr);
- the blocks' sharded checkpoint restored at fsdp=1 and fsdp=4;
- the loop's own ``make_trainer(num_workers=2)``: every rank reports the
  reference's loss over the concatenated batch (the fault it repairs: each
  rank reported its own); the loop's mesh takes ``tp`` and ``dp x fsdp``
  (trained in tests/test_torch_llama_mesh.py), and what still raises.

The FSDP model is the Llama over the fsdp mesh (``lora_model(mesh=)``):
its loss is the global batch's on every rank, and the steps complete the
gradients with ``llama_lora.mesh_gradients``.

The workers import this module by name, so it imports neither ``jax`` nor
``ray_tpu`` at its top.
"""

import json
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
from ray_tpu_torch.collective.base import BaseGroup, ReduceOp
from ray_tpu_torch.parallel import sharding as tsh
from ray_tpu_torch.parallel.mesh import make_mesh
from ray_tpu_torch.train import collective as tcol
from ray_tpu_torch.train.examples import llama_lora

_DEADLINE_S = 150.0
_LR = 1e-4
_CPU = {"CPU": 1}
_STEPS = {2: 3, 4: 1}


class _Fits:
    """``fit()`` of each trainer, all at once in threads; :meth:`results`
    joins them within the deadline, and past it kills every worker and
    fails."""

    def __init__(self, *trainers):
        self._results = [None] * len(trainers)
        self._start = time.monotonic()
        self._threads = [threading.Thread(target=self._run, args=(i, t), daemon=True)
                         for i, t in enumerate(trainers)]
        for thread in self._threads:
            thread.start()

    def _run(self, i, trainer):
        self._results[i] = trainer.fit()

    def results(self):
        for thread in self._threads:
            thread.join(max(0.0, self._start + _DEADLINE_S - time.monotonic()))
        if any(thread.is_alive() for thread in self._threads):
            for child in multiprocessing.active_children():
                child.kill()
            for thread in self._threads:
                thread.join(10)
            pytest.fail(f"fit() did not finish in {_DEADLINE_S} s; its workers were killed")
        assert not multiprocessing.active_children()
        return self._results


def _trainer(loop, workers, config, storage, name):
    return train.DataParallelTrainer(
        loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(workers, _CPU),
        run_config=train.RunConfig(name=name, storage_path=storage),
        backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)))


def _tiny_config():
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(dtype=torch.float32, lora_rank=4, remat=True)


def _fsdp_loop(config):
    """Each rank: its blocks of the reference's parameters, the steps on its
    row of each global batch, the full adapters after each, and a sharded
    checkpoint of its adapter blocks."""
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel.fsdp import FSDP
    from ray_tpu_torch.train.lora import split_lora

    torch.set_num_threads(1)
    ctx = train.get_context()
    r, world = ctx.world_rank, ctx.world_size
    tcfg = _tiny_config()
    mesh = tcol.gang_mesh("cpu", fsdp=world)
    fsdp = FSDP.for_llama(tcfg, mesh.bind(r, {"fsdp": tcol.tensor_group()}))
    blocks = fsdp.shard_params(params_from_jax(config["params"], tcfg, device="cpu"))
    train.report({"rank": r, "blocks": {k: v.numpy().copy() for k, v in blocks.items()}})
    model, lora, optimizer = llama_lora.lora_model(tcfg, blocks, lr=_LR, mesh=fsdp.mesh)
    base, _ = split_lora(dict(model.named_parameters()))
    reduce = llama_lora.mesh_gradients(model)
    b = config["batch"]
    for step, tokens in enumerate(config["tokens"]):
        loss = llama_lora.lora_train_step(model, optimizer,
                                          torch.from_numpy(tokens[r * b:(r + 1) * b]).long(),
                                          reduce)
        full = fsdp.full_state(lora)
        train.report({"rank": r, "step": step, "loss": float(loss),
                      "adapters": {k: v.numpy().copy() for k, v in full.items()},
                      "own": {k: p.detach().numpy().copy() for k, p in lora.items()}})
    train.save_sharded(config["ckpt"], {"lora": dict(lora)},
                       {"lora": {n: fsdp.shardings[n] for n in lora}})
    train.report({"rank": r, "base_bytes": sum(p.numel() * p.element_size()
                                                for p in base.values()),
                  "sharded": sorted(fsdp.sharded)})


def _jax_mesh(n):
    from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(num_devices=n, fsdp=n, tp=1)


def _reference_tree():
    """The reference's tiny f32 tree at PRNGKey(0), boxed and unboxed as
    numpy, ``lora_b`` drawn from a seed (at 0 every ``lora_a`` gradient
    would be 0), as tests/test_torch_train_dp.py."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.models.llama import init_params as jax_init_params
    from ray_tpu.parallel.sharding import unbox_params

    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4)
    boxed = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, unbox_params(boxed))
    rng = np.random.default_rng(12)
    for layer in (v for k, v in params.items() if k.startswith("layer_")):
        for proj in layer["attn"].values():
            proj["lora_b"] = 0.05 * rng.standard_normal(proj["lora_b"].shape).astype(np.float32)
    return jcfg, boxed, params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bounds(index, shape):
    return [sl.indices(n)[:2] for sl, n in zip(index, shape)]


@pytest.fixture(scope="module")
def fsdp_runs():
    """The port's gangs at fsdp=2 and 4 and the reference's FSDP steps on
    the same meshes, computed while the gangs run."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding as JaxNamedSharding
    from jax.sharding import PartitionSpec as JaxP

    from ray_tpu.models.llama import next_token_loss as jax_next_token_loss
    from ray_tpu.parallel.sharding import param_shardings as jax_param_shardings
    from ray_tpu.train.lora import merge_lora as jax_merge_lora
    from ray_tpu.train.lora import split_lora as jax_split_lora

    jcfg, boxed, params = _reference_tree()
    rng = np.random.default_rng(14)
    storage = tempfile.TemporaryDirectory()
    configs = {}
    for n, steps in _STEPS.items():
        configs[n] = {"params": params, "batch": 1,
                      "tokens": [rng.integers(0, jcfg.vocab_size, (n, 16)).astype(np.int32)
                                 for _ in range(steps)],
                      "ckpt": os.path.join(storage.name, f"ckpt-{n}")}
    fits = _Fits(*(_trainer(_fsdp_loop, n, configs[n], storage.name, f"fsdp-{n}")
                   for n in _STEPS))
    reference = {}
    for n in _STEPS:
        mesh = _jax_mesh(n)
        shardings = jax_param_shardings(mesh, boxed)
        placed = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params), shardings)
        base_p, lora_p = jax_split_lora(placed)
        tx = optax.adamw(_LR)
        state = jax.jit(tx.init)(lora_p)

        @jax.jit
        def train_step(lp, s, tok, base_p=base_p, mesh=mesh, tx=tx):
            loss, grads = jax.value_and_grad(
                lambda p: jax_next_token_loss(jcfg, mesh, jax_merge_lora(base_p, p), tok))(lp)
            updates, s = tx.update(grads, s, lp)
            return optax.apply_updates(lp, updates), s, loss

        batch = JaxNamedSharding(mesh, JaxP(("dcn", "dp", "fsdp")))
        steps = []
        for tok in configs[n]["tokens"]:
            lora_p, state, loss = train_step(lora_p, state, jax.device_put(jnp.asarray(tok), batch))
            steps.append((lora_p, float(loss)))
        reference[n] = dict(shardings=shardings, placed=placed, steps=steps)
    runs = dict(zip(_STEPS, fits.results()))
    for n, result in runs.items():
        assert result.error is None, result.error
    yield runs, reference, configs
    storage.cleanup()


def _reports(result, key):
    return [m for m in result.metrics_history if key in m]


@pytest.mark.parametrize("n", [2, 4])
def test_param_shardings_match_reference(n):
    """Every Llama parameter's spec, and each rank's block (bounds and
    values), against the reference's on an fsdp=n host mesh."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.sharding import param_shardings as jax_param_shardings

    _, boxed, params = _reference_tree()
    jshard = _flat(jax_param_shardings(_jax_mesh(n), boxed))
    placed = _flat(jax.device_put(jax.tree_util.tree_map(jnp.asarray, params),
                                  jax_param_shardings(_jax_mesh(n), boxed)))
    flat = _flat(params)
    mesh = make_mesh(devices=["cpu"] * n, fsdp=n)
    mine = tsh.param_shardings(mesh, {k: torch.from_numpy(np.array(v)) for k, v in flat.items()})
    assert sorted(mine) == sorted(jshard)
    assert tsh.param_shardings(mesh, params).keys() == params.keys()  # nested in, nested out
    split = 0
    for name, s in mine.items():
        assert tuple(s.spec) == tuple(jshard[name].spec), name
        shards = sorted(placed[name].addressable_shards, key=lambda sh: sh.device.id)
        full = torch.from_numpy(np.array(flat[name]))
        for rank, shard in enumerate(shards):
            shape = flat[name].shape
            assert _bounds(s.index(shape, rank), shape) == _bounds(shard.index, shape), name
            np.testing.assert_array_equal(s.shard(full, rank).numpy(), np.asarray(shard.data))
        split += bool(s.slices(flat[name].shape))
    # the base and the adapter matrices with an embed axis split; the
    # adapters' rank x heads factors do not
    assert split == len(flat) - 2 * 4
    assert tsh.param_shardings(mesh, {"stem_conv.kernel": torch.zeros(4, 3, 7, 7)})[
        "stem_conv.kernel"].spec == tsh.P()


def test_fsdp_blocks_are_the_reference_shards(fsdp_runs):
    """At the start, every rank holds exactly the reference's shard on its
    device, and nothing of a parameter it does not hold a block of."""
    runs, reference, _ = fsdp_runs
    for n, result in runs.items():
        placed = _flat(reference[n]["placed"])
        for m in _reports(result, "blocks"):
            for name, block in m["blocks"].items():
                shard = [s for s in placed[name].addressable_shards if s.device.id == m["rank"]]
                np.testing.assert_array_equal(block, np.asarray(shard[0].data))


@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_steps_match_reference_on_the_global_batch(fsdp_runs, n):
    runs, reference, _ = fsdp_runs
    steps = {}
    for m in _reports(runs[n], "step"):
        steps.setdefault(m["step"], {})[m["rank"]] = m
    assert sorted(steps) == list(range(_STEPS[n]))
    for s, (jlora, jloss) in enumerate(reference[n]["steps"]):
        ranks = steps[s]
        assert sorted(ranks) == list(range(n))
        jflat = {".".join(k): np.asarray(v) for k, v in jlora.items()}  # split_lora's paths
        # every rank reports the gang's loss: the global batch's, an f32
        # forward of the same weights summed in another order
        assert all(m["loss"] == ranks[0]["loss"] for m in ranks.values())
        assert abs(ranks[0]["loss"] - jloss) <= 1e-5 * abs(jloss)
        diffs = np.concatenate([np.abs(ranks[0]["adapters"][k] - v).ravel()
                                for k, v in jflat.items()])
        assert diffs.max() <= 2 * (s + 1) * _LR
        assert np.quantile(diffs, 0.99) <= 1e-3 * _LR
        # each rank's own blocks are its block of the reference's adapters
        # (the blocks' bounds are the reference's: test_param_shardings_...)
        layout = tsh.param_shardings(make_mesh(devices=["cpu"] * n, fsdp=n), jflat)
        for r, m in ranks.items():
            for name, own in m["own"].items():
                want = jflat[name][layout[name].index(jflat[name].shape, r)]
                assert own.shape == want.shape, name
                assert np.abs(own - want).max() <= 2 * (s + 1) * _LR
            for name, a in m["adapters"].items():
                np.testing.assert_array_equal(a, ranks[0]["adapters"][name])
    moved = np.concatenate([
        np.abs(steps[len(steps) - 1][0]["adapters"][k] - np.asarray(v)).ravel()
        for k, v in _flat(reference[n]["placed"]).items() if "lora" in k])
    # the comparison is not of unmoved weights: Adam's first step moves an
    # element by about lr
    assert np.median(moved) >= 0.5 * _LR


def test_fsdp_rank_stores_its_block_of_the_base(fsdp_runs):
    runs, _, configs = fsdp_runs
    full = sum(v.nbytes for k, v in _flat(configs[2]["params"]).items() if "lora" not in k)
    for n, result in runs.items():
        ends = _reports(result, "base_bytes")
        assert len(ends) == n
        for m in ends:
            assert m["base_bytes"] * n == full
            # per layer 2 norms, 7 kernels and 4 embed-axis adapters; embed,
            # lm_head and final_norm
            assert len(m["sharded"]) == 2 * (2 + 7 + 4) + 3


def test_sharded_checkpoint_restores_onto_other_meshes(fsdp_runs):
    """fsdp=2's adapter blocks, restored whole (fsdp=1) and as fsdp=4's
    blocks, equal the full adapters the gang gathered, bit for bit."""
    from ray_tpu_torch.parallel.fsdp import FSDP

    runs, _, configs = fsdp_runs
    last = [m for m in _reports(runs[2], "step") if m["step"] == _STEPS[2] - 1][0]
    want = last["adapters"]
    got = train.restore_sharded(configs[2]["ckpt"])["lora"]
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name])
    mesh = make_mesh(devices=["cpu"] * 4, fsdp=4)

    class _Four:  # the fsdp group FSDP reads its size from
        world_size = 4

    for rank in range(4):
        layout = FSDP.for_llama(_tiny_config(), mesh.bind(rank, {"fsdp": _Four()}))
        target = {"lora": {n: torch.empty(0) for n in want}}
        shardings = {"lora": {n: layout.shardings[n] for n in want}}
        blocks = train.restore_sharded(configs[2]["ckpt"], target=target,
                                       shardings=shardings)["lora"]
        for name, t in blocks.items():
            np.testing.assert_array_equal(
                t.numpy(), layout.shardings[name].shard(torch.from_numpy(want[name])).numpy())
    with open(os.path.join(configs[2]["ckpt"], "sharded_state", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    # each block was written once, by its rank: two files for the split
    # adapters, rank 0's alone for the replicated ones
    wq_a = leaves["lora/layer_0.attn.wq.lora_a"]
    assert wq_a["spec"] == ["fsdp", None] and [s["rank"] for s in wq_a["shards"]] == [0, 1]
    assert [s["rank"] for s in leaves["lora/layer_0.attn.wq.lora_b"]["shards"]] == [0]


def test_tensor_parallel_training_raises(tmp_path):
    """The loop's mesh takes ``tp`` and ``dp`` x ``fsdp`` now (trained in
    tests/test_torch_llama_mesh.py); what still raises: a layout that is not
    the world's ranks and ``pp`` at the model (and the quantized knob where
    the loss axes are not the whole gang:
    ``test_mesh_gradients_take_the_runs_knobs``)."""
    from ray_tpu_torch.models.llama import Llama

    assert llama_lora.mesh_axes({"tp": 2}, 2) == {"dp": 1, "fsdp": 1, "tp": 2}
    assert llama_lora.mesh_axes({"dp": 2, "fsdp": 2}, 4) == {"dp": 2, "fsdp": 2, "tp": 1}
    assert llama_lora.mesh_axes({"tp": 2, "fsdp": 2}, 4) == {"dp": 1, "fsdp": 2, "tp": 2}
    assert llama_lora.mesh_axes({}, 4) == {"dp": 1, "fsdp": 4, "tp": 1}
    assert llama_lora.mesh_axes({"dp": 4}, 4) == {"dp": 4, "fsdp": 1, "tp": 1}
    with pytest.raises(ValueError, match="is not the 4 ranks"):
        llama_lora.mesh_axes({"tp": 2, "fsdp": 4}, 4)
    with pytest.raises(NotImplementedError, match="item 33"):
        Llama(_tiny_config(), make_mesh(devices=["cpu"] * 2, pp=2, fsdp=1).bind(0))


class _TimesGroup(BaseGroup):
    """A one-rank tensor group whose sum multiplies by 3 (a stand-in for
    the run's group: what went through it shows)."""

    backend = "fake"

    def __init__(self, name):
        super().__init__(1, 0, name)
        self.calls = 0

    def allreduce(self, tensor, op=ReduceOp.SUM):
        self.calls += 1
        return tensor * 3.0

    def allgather(self, tensor):
        return [tensor]

    def reducescatter(self, tensor, op=ReduceOp.SUM):
        return tensor * 3.0

    def broadcast(self, tensor, src_rank=0):
        return tensor

    def send(self, tensor, dst_rank):
        raise NotImplementedError

    def recv(self, src_rank):
        raise NotImplementedError

    def barrier(self):
        pass


def test_mesh_gradients_take_the_runs_knobs(tmp_path):
    """The mesh's gradient hook (``llama_lora.mesh_gradients``) where the
    loss axes are the whole gang (every tp = 1 layout, here one rank) sums
    through the run's own scheduler, with the trainer's knobs: overlap,
    256-byte buckets and stale_grad=1 (the first step skips its update, the
    next applies the first's sums, ``flush`` the last's), quantized too.
    Where the loss axes are not the whole gang (here a world of two around
    a one-rank mesh), the quantized knob raises: that group does not
    quantize."""
    from ray_tpu_torch import collective
    from ray_tpu_torch.models.llama import init_params, next_token_loss
    from ray_tpu_torch.train import session

    tcfg = _tiny_config()
    mesh = make_mesh(devices=["cpu"], fsdp=1).bind(0)
    model, _, _ = llama_lora.lora_model(
        tcfg, init_params(tcfg, torch.Generator().manual_seed(0), device="cpu"), mesh=mesh)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 16)))

    def grads():
        model.zero_grad(set_to_none=True)
        next_token_loss(tcfg, model, tokens).backward()
        return tcol.gradients(model)

    name = "mesh-knobs"
    group = collective._groups[name] = _TimesGroup(name)
    context = dict(world_rank=0, local_rank=0, node_rank=0, local_world_size=1,
                   experiment_name="knobs", run_dir=str(tmp_path),
                   collective_tensor_group=name, collective_quantized=True)
    session.set_context(session.TrainContext(
        world_size=1, collective_overlap=True, collective_bucket_bytes=256,
        collective_stale_grad=1, **context))
    try:
        hook = llama_lora.mesh_gradients(model)
        assert hook.scheduler is tcol.gradient_scheduler()
        assert hook.scheduler.overlap and hook.scheduler.bucket_bytes == 256
        first = grads()
        want = {k: 3.0 * g for k, g in first.items()}
        assert hook(first) is None  # in flight
        second = grads()
        got = hook(second)
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        want = {k: 3.0 * g for k, g in second.items()}
        got = hook.flush()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        assert group.calls > 2  # several buckets a step
        session.set_context(session.TrainContext(world_size=2, **context))
        with pytest.raises(NotImplementedError, match="quantized gradient sums"):
            llama_lora.mesh_gradients(model)
    finally:
        session.set_context(None)
        collective.destroy_collective_group(name)


def test_process_local_batch_and_tree_shardings():
    mesh = make_mesh(devices=["cpu"] * 4, dp=2, fsdp=2).bind(3)
    local = np.arange(6).reshape(3, 2)
    out = tsh.process_local_batch(mesh, local)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), local)  # a rank's rows are its shard
    tree = tsh.tree_shardings(mesh, {"w": ("embed", "mlp"), "inner": {"b": ("batch",)}})
    assert tree["w"].spec == tsh.P("fsdp", "tp")
    assert tree["inner"]["b"].spec == tsh.P(("dcn", "dp", "fsdp"))
    assert _bounds(tree["inner"]["b"].index((8,)), (8,)) == [(6, 8)]


@pytest.mark.parametrize("layout", [{}, {"dp": 2}], ids=["fsdp", "replicated"])
def test_gang_reports_the_global_batch_loss(tmp_path, layout):
    """The repaired fault: two ranks on their own tokens (the loop's
    ``step_tokens``, seeded by rank) each report the reference's loss over
    the concatenated batch, within the f32 rounding of a mean of two
    means, where each used to report its own batch's; at the default mesh
    (FSDP at fsdp=2) and with every parameter replicated (``dp=2``)."""
    import jax.numpy as jnp

    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.models.llama import next_token_loss as jax_next_token_loss
    from ray_tpu_torch.models.llama import init_params, next_token_loss

    config = {"model": "tiny", "device": "cpu", "seq": 16, "epochs": 1, "steps_per_epoch": 1,
              "batch_per_worker": 2, **layout}
    trainer = llama_lora.make_trainer(
        num_workers=2, resources_per_worker=_CPU, train_config=config,
        backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)))
    trainer.run_config = train.RunConfig(name="llama-lora-loss", storage_path=str(tmp_path))
    fits = _Fits(trainer)
    tcfg = llama_lora.model_config(config)
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    device = torch.device("cpu")
    tokens = [llama_lora.step_tokens(tcfg, 2, 0, 0, r, device) for r in range(2)]
    with torch.no_grad():
        own = [float(next_token_loss(tcfg, params, t)) for t in tokens]
    tree = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(t.numpy())
    jcfg = JaxLlamaConfig.tiny(max_seq_len=16, lora_rank=4)
    both = jnp.asarray(torch.cat(tokens).numpy().astype(np.int32))
    want = float(jax_next_token_loss(jcfg, None, tree, both))
    # the reference and the port in bf16 activations: each logit rounded to
    # bf16 by each side from f32 values that differ in their last bits,
    # which moves the mean NLL by about 5e-5 of itself on these tokens
    tol = 2e-4 * abs(want)
    assert abs(own[0] - own[1]) > 10 * tol  # a rank's own loss would fail
    result = fits.results()[0]
    assert result.error is None, result.error
    reported = [m["loss"] for m in result.metrics_history]
    assert len(reported) == 2 and reported[0] == reported[1]
    assert abs(reported[0] - (own[0] + own[1]) / 2) <= 4 * 2 ** -24 * abs(want)
    assert abs(reported[0] - want) <= tol
    with open(os.path.join(result.checkpoint.path, "lora.pkl"), "rb") as f:
        state = pickle.load(f)
    assert sorted(state["lora"]) == sorted(n for n in params if "lora" in n)
    assert all(state["lora"][n].shape == params[n].shape for n in state["lora"])
