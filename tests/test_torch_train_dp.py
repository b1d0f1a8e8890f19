"""ray_tpu_torch.train's multi-worker path against ray_tpu.train, on the CPU.

The ports of the reference's ``tests/test_train.py`` and
``tests/test_overlap.py`` train-plane cases run ``fit()`` over gangs of
spawned workers on the CPU (``resources_per_worker={"CPU": 1}``, gloo), and
the slice as a whole runs the tiny f32 ``llama_lora`` step at 2 ranks, batch
1 each, against the reference's ``jax.value_and_grad`` + ``optax.adamw``
step on the concatenated batch of 2.

Every ``fit()`` runs under ``_fit``: past ``_DEADLINE_S`` its workers are
killed and the test fails (their stderr is the test's captured output). The
workers import this module by name, so it imports neither ``jax`` nor
``ray_tpu`` at its top, and the loops they run are defined here at module
level.
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
import torch.distributed as dist

from ray_tpu_torch import train
from ray_tpu_torch.train import collective as tcol
from ray_tpu_torch.train.examples import llama_lora

_DEADLINE_S = 60.0
_LR = 1e-4
_CPU = {"CPU": 1}


class _Fits:
    """``fit()`` of each trainer, all at once in threads, so that the
    caller can compute meanwhile; :meth:`results` joins them within the
    deadline, and past it kills every worker and fails."""

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
        assert not multiprocessing.active_children()  # shutdown left no process
        return self._results


def _fit(trainer):
    return _Fits(trainer).results()[0]


def _trainer(loop, workers, name, storage, config=None, max_failures=0, **knobs):
    return train.DataParallelTrainer(
        loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(workers, _CPU),
        run_config=train.RunConfig(name=name, storage_path=storage,
                                   failure_config=train.FailureConfig(max_failures)),
        backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)), **knobs,
    )


# -- the train plane (the reference's tests/test_train.py) --------------------


def _context_loop(config):
    ctx = train.get_context()
    got = tcol.broadcast_from_rank_zero({"value": ctx.get_world_rank() * 10 + 7})
    tcol.barrier()
    ranks = tcol.allgather(ctx.get_world_rank())
    total = tcol.allreduce(float(ctx.get_world_rank()))
    train.report({"rank": ctx.get_world_rank(), "world_size": ctx.get_world_size(),
                  "bcast": got["value"], "ranks": sorted(ranks), "total": float(total),
                  "device": str(torch.tensor(0.0).device)})


def test_context_ranks_and_collective(tmp_path):
    result = _fit(_trainer(_context_loop, 3, "ctx", str(tmp_path)))
    assert result.error is None
    by_rank = {m["rank"]: m for m in result.metrics_history}
    assert set(by_rank) == {0, 1, 2}
    for m in by_rank.values():
        assert m["world_size"] == 3
        assert m["bcast"] == 7  # rank 0's value everywhere
        assert m["ranks"] == [0, 1, 2]
        assert m["total"] == 3.0
    assert result.metrics["rank"] == 0  # the controller reads rank 0's last report


def _ddp_loop(config):
    ctx = train.get_context()
    t = torch.ones(2) * (ctx.get_world_rank() + 1)
    dist.all_reduce(t)
    grads = {"w": torch.full((32,), ctx.get_world_rank() + 1.0),
             "b": torch.arange(5, dtype=torch.float32) * (ctx.get_world_rank() + 1)}
    out = tcol.reduce_gradients(grads)
    sched = tcol.gradient_scheduler()
    train.report({"sum": float(t[0]), "rank": ctx.get_world_rank(), "w": float(out["w"][0]),
                  "b": out["b"].tolist(), "overlap": sched.overlap,
                  "bucket_bytes": sched.bucket_bytes, "stale_grad": sched.stale_grad,
                  "buckets": sched.bucketizer_for(grads).num_buckets})


@pytest.fixture(scope="module")
def ddp_run():
    with tempfile.TemporaryDirectory() as storage:
        trainer = train.TorchTrainer(
            _ddp_loop, scaling_config=train.ScalingConfig(2, _CPU),
            run_config=train.RunConfig(name="torch", storage_path=storage),
            overlap=True, bucket_bytes=256,
        )
        return _fit(trainer)


def test_torch_trainer_ddp(ddp_run):
    """TorchTrainer with 2 workers takes TorchConfig() (gloo on the CPU):
    the loop's own ``dist.all_reduce`` sums over the gang."""
    assert ddp_run.error is None
    assert ddp_run.metrics["sum"] == 3.0  # 1 + 2
    assert {m["rank"] for m in ddp_run.metrics_history} == {0, 1}


def test_train_session_reduce_gradients_knobs(ddp_run):
    for m in ddp_run.metrics_history:
        assert m["w"] == 3.0  # 1 + 2
        assert m["b"] == [3.0 * i for i in range(5)]
        assert m["overlap"] is True and m["bucket_bytes"] == 256 and m["stale_grad"] == 0
        assert m["buckets"] == 1  # "b" (20 B) then "w" (128 B): under 256 B


def _ckpt_train_loop(config):
    ctx = train.get_context()
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            with open(os.path.join(d, "state.json")) as f:
                start = json.load(f)["epoch"] + 1
    for epoch in range(start, config["epochs"]):
        if config.get("fail_at") == epoch and ctx.get_world_rank() == 0:
            marker = os.path.join(ctx.get_storage_path(), "failed_once")
            if not os.path.exists(marker):  # fail on the first attempt only
                open(marker, "w").close()
                raise RuntimeError("injected failure")
        if ctx.get_world_rank() == 0:
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"epoch": epoch}, f)
                train.report({"epoch": epoch},
                             checkpoint=train.Checkpoint.from_directory(d))
        else:
            train.report({"epoch": epoch})


def test_failure_policy_restart_resumes_from_checkpoint(tmp_path):
    result = _fit(_trainer(_ckpt_train_loop, 2, "resume", str(tmp_path),
                           {"epochs": 6, "fail_at": 3}, max_failures=1))
    assert result.error is None
    assert result.metrics["epoch"] == 5
    # rank 0 ran epochs 0-2, failed at 3, and the restarted gang resumed
    # from epoch 2's checkpoint: epoch 2 appears once in rank 0's history
    epochs = [m["epoch"] for m in result.metrics_history if m["_world_rank"] == 0]
    assert epochs.count(2) == 1 and epochs[-1] == 5
    with open(os.path.join(result.checkpoint.path, "state.json")) as f:
        assert json.load(f)["epoch"] == 5
    # the restarted gang numbered its reports after the first attempt's, so
    # no checkpoint directory of that attempt was written over
    indices = [m["_report_index"] for m in result.metrics_history if m["_world_rank"] == 0]
    assert indices == sorted(set(indices))


def _dying_loop(config):
    """Rank 1 dies in every attempt, but only after rank 0 has reported: the
    controller stops the gang at the first exit it sees, so a report rank 0
    had not sent by then would be lost. Rank 0 leaves a marker after its
    report, which rank 1 takes (so the next attempt's rank 1 waits again)."""
    ctx = train.get_context()
    train.report({"rank": ctx.get_world_rank()})
    marker = os.path.join(ctx.get_storage_path(), "rank0_reported")
    if ctx.get_world_rank() == 0:
        open(marker, "w").close()
        return
    deadline = time.monotonic() + _DEADLINE_S
    while not os.path.exists(marker) and time.monotonic() < deadline:
        time.sleep(0.01)
    os.remove(marker)
    os._exit(3)


def test_failure_policy_exhausted(tmp_path):
    """A worker that dies in every attempt: after max_failures restarts the
    error lands in Result.error, and each attempt's reports were kept."""
    result = _fit(_trainer(_dying_loop, 2, "fail", str(tmp_path), max_failures=1))
    assert isinstance(result.error, train.worker_group.WorkerDiedError)
    assert "rank 1" in str(result.error) and "code 3" in str(result.error)
    assert [m["rank"] for m in result.metrics_history].count(0) == 2  # two attempts


def _fails_once_loop(config):
    marker = os.path.join(train.get_context().get_storage_path(), "failed_once")
    if not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("injected failure")
    train.report({"attempt": 2})


def test_in_process_worker_is_retried_alike(tmp_path):
    """One worker with no backend runs in this process; FailureConfig
    retries it as it restarts a gang."""
    run = train.RunConfig(name="retry", storage_path=str(tmp_path),
                          failure_config=train.FailureConfig(max_failures=1))
    result = train.TorchTrainer(_fails_once_loop, run_config=run).fit()
    assert result.error is None and result.metrics == {"attempt": 2}
    run = train.RunConfig(name="no-retry", storage_path=str(tmp_path))
    result = train.TorchTrainer(_fails_once_loop, run_config=run).fit()
    assert isinstance(result.error, RuntimeError)


def test_exception_in_a_worker_lands_in_result(tmp_path):
    result = _fit(_trainer(_always_fail, 1, "boom", str(tmp_path)))
    assert isinstance(result.error, ValueError) and "boom" in str(result.error)


def _always_fail(config):
    raise ValueError("boom")


def test_closure_loop_raises_at_fit(tmp_path):
    """The loop is pickled by reference (no cloudpickle): a closure is
    refused before anything spawns, not inside a worker."""
    def loop(config):
        train.report({"x": 1})

    with pytest.raises(ValueError, match="closure or a lambda"):
        _trainer(loop, 2, "closure", str(tmp_path)).fit()
    with pytest.raises(ValueError, match="closure or a lambda"):
        _trainer(lambda c: None, 2, "lambda", str(tmp_path)).fit()
    with pytest.raises(ValueError, match="train_loop_config"):
        _trainer(_always_fail, 2, "cfg", str(tmp_path), {"lock": threading.Lock()}).fit()
    assert not multiprocessing.active_children()
    assert not os.path.exists(os.path.join(tmp_path, "closure"))


def test_a_gang_needs_torch_config(tmp_path):
    with pytest.raises(TypeError, match="TorchConfig"):
        train.DataParallelTrainer(_always_fail, backend_config=train.BackendConfig(),
                                  run_config=train.RunConfig(storage_path=str(tmp_path))).fit()
    assert train.TorchConfig().resolve(on_card=True) == "nccl"
    assert train.TorchConfig().resolve(on_card=False) == "gloo"
    assert train.TorchConfig("gloo").resolve(on_card=True) == "gloo"
    with pytest.raises(ValueError, match="backend"):
        train.TorchConfig("mpi")


def test_elastic_failure_config_raises():
    with pytest.raises(NotImplementedError, match="weight plane"):
        train.FailureConfig(elastic=True)
    with pytest.raises(ValueError):
        train.FailureConfig(min_workers=0)


# -- the slice: llama_lora at 2 ranks against the reference --------------------


def _lora_dp_loop(config):
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.llama import LlamaConfig

    ctx = train.get_context()
    tcfg = LlamaConfig.tiny(dtype=torch.float32, lora_rank=4, remat=True)
    model, lora, optimizer = llama_lora.lora_model(
        tcfg, params_from_jax(config["params"], tcfg, device="cpu"), lr=_LR)
    reduce = llama_lora.data_parallel_mean(ctx.world_size)
    b, r = config["batch"], ctx.get_world_rank()
    for step, tokens in enumerate(config["tokens"]):
        loss = llama_lora.lora_train_step(
            model, optimizer, torch.from_numpy(tokens[r * b:(r + 1) * b]).long(), reduce)
        train.report({"step": step, "loss": float(loss), "rank": r,
                      "adapters": {k: p.detach().numpy().copy() for k, p in lora.items()}})


def _tiny_jax_params(jcfg):
    """The reference's tiny tree at PRNGKey(0), lora_b drawn from a seed
    (at 0 every lora_a gradient would be 0), as tests/test_torch_train.py."""
    import jax

    from ray_tpu.models.llama import init_params as jax_init_params
    from ray_tpu.parallel.sharding import unbox_params

    params = jax.tree_util.tree_map(
        np.asarray, unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(12)
    for layer in (v for k, v in params.items() if k.startswith("layer_")):
        for proj in layer["attn"].values():
            proj["lora_b"] = 0.05 * rng.standard_normal(proj["lora_b"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def lora_dp():
    """Two steps of the port at 2 ranks (batch 1 each), plain and at
    stale_grad=1, and of the reference on the batch of 2."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.models.llama import next_token_loss as jax_next_token_loss
    from ray_tpu.train.lora import merge_lora as jax_merge_lora
    from ray_tpu.train.lora import split_lora as jax_split_lora

    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4)
    jparams = _tiny_jax_params(jcfg)
    rng = np.random.default_rng(14)
    tokens = [rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32) for _ in range(2)]
    config = {"params": jparams, "tokens": tokens, "batch": 1}
    storage = tempfile.TemporaryDirectory()
    # both runs go on while the reference computes
    fits = _Fits(*(_trainer(_lora_dp_loop, 2, f"lora-dp-{stale}", storage.name, config,
                            stale_grad=stale, overlap=bool(stale)) for stale in (0, 1)))
    base_p, lora_p = jax_split_lora(jax.tree_util.tree_map(jnp.asarray, jparams))
    start = jax.tree_util.tree_map(np.asarray, lora_p)
    tx = optax.adamw(_LR)
    state = tx.init(lora_p)

    @jax.jit
    def train_step(lp, s, tok):
        loss, grads = jax.value_and_grad(
            lambda p: jax_next_token_loss(jcfg, None, jax_merge_lora(base_p, p), tok))(lp)
        updates, s = tx.update(grads, s, lp)
        return optax.apply_updates(lp, updates), s, loss

    reference = []
    for tok in tokens:
        lora_p, state, jloss = train_step(lora_p, state, jnp.asarray(tok))
        reference.append((jax.tree_util.tree_map(np.asarray, lora_p), float(jloss)))
    runs = dict(enumerate(fits.results()))
    storage.cleanup()
    return runs, reference, start


def _by_step(result):
    steps = {}
    for m in result.metrics_history:
        steps.setdefault(m["step"], {})[m["rank"]] = m
    return [steps[s] for s in sorted(steps)]


def test_lora_dp_ranks_stay_bit_identical(lora_dp):
    runs, _, _ = lora_dp
    for stale, result in runs.items():
        assert result.error is None
        for step in _by_step(result):
            assert set(step) == {0, 1}
            for name, a in step[0]["adapters"].items():
                np.testing.assert_array_equal(a, step[1]["adapters"][name])


def test_lora_dp_step_matches_reference_on_the_global_batch(lora_dp):
    runs, reference, start = lora_dp
    for n, (step, (jlora, jloss)) in enumerate(zip(_by_step(runs[0]), reference)):
        # each rank's loss is its own batch's mean: their mean is the global
        # batch's, an f32 forward of the same weights summed in another order
        loss = (step[0]["loss"] + step[1]["loss"]) / 2
        assert abs(loss - jloss) <= 1e-5 * abs(jloss)
        diffs = np.concatenate([
            np.abs(step[0]["adapters"][".".join(k)] - np.asarray(v)).ravel()
            for k, v in jlora.items()])
        # Adam moves an element by about lr * g / |g| a step; where a
        # gradient is as small as the rounding difference its sign can flip,
        # so n + 1 steps bound any element by 2 (n + 1) lr, while 99% of the
        # elements agree within 1e-3 lr
        assert diffs.max() <= 2 * (n + 1) * _LR
        assert np.quantile(diffs, 0.99) <= 1e-3 * _LR
    moved = np.concatenate([
        np.abs(_by_step(runs[0])[-1][0]["adapters"][".".join(k)] - v).ravel()
        for k, v in start.items()])
    assert np.median(moved) >= _LR  # the comparison is not of unmoved weights


def test_lora_dp_stale_grad_skips_the_first_update(lora_dp):
    """At stale_grad=1 the first step skips the update; the second applies
    the first step's reduced gradients to the unmoved adapters, which is
    the plain run's first step bit for bit."""
    runs, _, start = lora_dp
    plain, stale = _by_step(runs[0]), _by_step(runs[1])
    for name, a in stale[0][0]["adapters"].items():
        np.testing.assert_array_equal(a, start[tuple(name.split("."))])
        np.testing.assert_array_equal(stale[1][0]["adapters"][name], plain[0][0]["adapters"][name])


def test_two_worker_fit_reports_and_checkpoints_every_adapter(tmp_path):
    """train_loop_per_worker on 2 workers at stale_grad=1 and one step: the
    step skips its update, and the loop applies the flushed gradients
    after it, so lora_b (0 at init) has moved in the checkpoint."""
    from ray_tpu_torch.models.llama import init_params

    trainer = llama_lora.make_trainer(
        num_workers=2, resources_per_worker=_CPU,
        backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)),
        train_config={"model": "tiny", "device": "cpu", "seq": 16, "epochs": 1,
                      "steps_per_epoch": 1, "batch_per_worker": 1},
        overlap=True, stale_grad=1,
    )
    trainer.run_config = train.RunConfig(name="llama-lora-dp", storage_path=str(tmp_path))
    result = _fit(trainer)
    assert result.error is None
    assert {m["rank"] for m in result.metrics_history} == {0, 1}
    assert all(np.isfinite(m["loss"]) for m in result.metrics_history)
    with open(os.path.join(result.checkpoint.path, "lora.pkl"), "rb") as f:
        state = pickle.load(f)
    tcfg = llama_lora.model_config({"model": "tiny", "seq": 16})
    _, lora = train.split_lora(init_params(tcfg, device="cpu"))
    assert sorted(state["lora"]) == sorted(lora) and state["epoch"] == 0
    assert any(bool((t != 0).any()) for n, t in state["lora"].items() if n.endswith("lora_b"))
