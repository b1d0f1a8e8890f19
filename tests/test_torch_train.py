"""ray_tpu_torch.train against ray_tpu.train on the CPU.

The reference's LoRA step (train/examples/llama_lora.py: ``jax.value_and_grad``
of ``next_token_loss`` over the adapters, ``optax.adamw``) is rebuilt here on
the tiny Llama's PRNGKey(0) weights, carried into the port by
params_from_jax, and both sides take the same numpy tokens. The port runs
the plain versions of its kernels, because the tensors lie on the CPU.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.models.llama import next_token_loss as jax_next_token_loss
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu.train.lora import merge_lora as jax_merge_lora
from ray_tpu.train.lora import split_lora as jax_split_lora
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import LlamaConfig, init_params
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import rmsnorm as trms
from ray_tpu_torch.train import (
    RunConfig,
    ScalingConfig,
    TorchConfig,
    TorchTrainer,
    lora_label_fn,
    merge_lora,
    split_lora,
)
from ray_tpu_torch.train.examples import llama_lora

_LR = 1e-4


def test_split_merge_lora_round_trip():
    params = init_params(LlamaConfig.tiny(n_layers=1, lora_rank=4), device="cpu")
    base, lora = split_lora(params)
    assert sorted(lora) == sorted(
        f"layer_0.attn.{p}.{ab}" for p in ("wq", "wk", "wv", "wo") for ab in ("lora_a", "lora_b")
    )
    assert not set(base) & set(lora) and "embed" in base
    merged = merge_lora(base, lora)
    assert merged.keys() == params.keys() and all(merged[k] is params[k] for k in params)
    labels = lora_label_fn(params)
    assert {k for k, v in labels.items() if v == "lora"} == set(lora)
    with pytest.raises(KeyError, match="both"):
        merge_lora(params, lora)


def _tiny_jax_params(jcfg):
    params = jax.tree_util.tree_map(
        np.asarray, unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    )
    rng = np.random.default_rng(12)
    for layer in (v for k, v in params.items() if k.startswith("layer_")):
        for proj in layer["attn"].values():
            # lora_b = 0 would leave every lora_a gradient at exactly 0
            proj["lora_b"] = 0.05 * rng.standard_normal(proj["lora_b"].shape).astype(np.float32)
    return params


def test_lora_train_steps_match_optax_adamw():
    """Three of the port's steps against three of the reference's, built as
    llama_lora.py builds its ``train_step``."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4)
    tcfg = LlamaConfig.tiny(dtype=torch.float32, lora_rank=4, remat=True)
    jparams = _tiny_jax_params(jcfg)
    model, lora, optimizer = llama_lora.lora_model(
        tcfg, params_from_jax(jparams, tcfg, device="cpu"), lr=_LR
    )
    start = {k: p.detach().clone() for k, p in lora.items()}
    base_p, lora_p = jax_split_lora(jax.tree_util.tree_map(jnp.asarray, jparams))
    tx = optax.adamw(_LR)
    state = tx.init(lora_p)

    @jax.jit
    def train_step(lp, s, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: jax_next_token_loss(jcfg, None, jax_merge_lora(base_p, p), tokens)
        )(lp)
        updates, s = tx.update(grads, s, lp)
        return optax.apply_updates(lp, updates), s, loss

    rng = np.random.default_rng(13)
    for _ in range(3):
        tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
        lora_p, state, jloss = train_step(lora_p, state, jnp.asarray(tokens))
        loss = llama_lora.lora_train_step(model, optimizer, torch.from_numpy(tokens).long())
        # f32 forward of the same weights, summed in another order
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    # Adam moves an element by about lr * g / |g| per step, so where a
    # gradient is as small as the frameworks' rounding difference its sign
    # can differ and the two updates part by up to 2 lr: 3 steps bound any
    # element's difference by 6 lr. Elements with a real gradient agree far
    # closer: 99% of them within 1e-3 lr.
    diffs = np.concatenate([
        np.abs(lora[".".join(k)].detach().numpy() - np.asarray(v)).ravel()
        for k, v in lora_p.items()
    ])
    assert diffs.max() <= 6 * _LR
    assert np.quantile(diffs, 0.99) <= 1e-3 * _LR
    moved = torch.cat([(p.detach() - start[k]).abs().ravel() for k, p in lora.items()])
    assert moved.median().item() >= _LR  # the comparison is not of unmoved weights
    # the update is AdamW with optax's decay of 1e-4, not torch's 0.01
    assert optimizer.param_groups[0]["weight_decay"] == 1e-4


def _count_calls(monkeypatch):
    calls = dict.fromkeys(("rmsnorm_fwd", "flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 0)
    for module, name in ((trms, "rmsnorm_fwd"), (tfa, "flash_attention_fwd"),
                         (tfa, "flash_bwd_dq"), (tfa, "flash_bwd_dkv")):
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_step_calls_each_kernel_wrapper_per_layer(monkeypatch, remat):
    """The per-step launch counts chip_smoke.py demands on the card: with
    remat every block's RMSNorms and flash forward run twice."""
    cfg = LlamaConfig.tiny(lora_rank=4, max_seq_len=16, remat=remat)
    model, _, optimizer = llama_lora.lora_model(cfg, init_params(cfg, device="cpu"))
    calls = _count_calls(monkeypatch)
    llama_lora.lora_train_step(model, optimizer, torch.randint(0, 256, (2, 16)))
    n, passes = cfg.n_layers, 2 if remat else 1
    assert calls == {"rmsnorm_fwd": 2 * n * passes + 1, "flash_attention_fwd": n * passes,
                     "flash_bwd_dq": n, "flash_bwd_dkv": n}


class _Recorder:
    def __init__(self):
        self.reports, self.results = [], []

    def on_report(self, report):
        self.reports.append(report)

    def after_run(self, result):
        self.results.append(result)


def test_fit_tiny_on_cpu_reports_and_checkpoints(tmp_path):
    recorder = _Recorder()
    config = {"model": "tiny", "seq": 16, "epochs": 2, "steps_per_epoch": 2, "device": "cpu"}
    result = TorchTrainer(
        llama_lora.train_loop_per_worker, train_loop_config=config,
        run_config=RunConfig(name="lora", storage_path=str(tmp_path), callbacks=[recorder]),
    ).fit()
    assert result.error is None
    assert [m["epoch"] for m in result.metrics_history] == [0, 1]
    assert all(np.isfinite(m["loss"]) and m["rank"] == 0 for m in result.metrics_history)
    assert result.metrics == {k: result.metrics_history[-1][k] for k in ("epoch", "loss", "rank")}
    assert len(recorder.reports) == 2 and recorder.results == [result]
    assert result.path == os.path.join(str(tmp_path), "lora")
    assert result.checkpoint.path == os.path.join(result.path, "checkpoint_000001")
    with open(os.path.join(result.path, "checkpoint_manifest.json")) as f:
        manifest = json.load(f)
    assert [e["index"] for e in manifest["checkpoints"]] == [0, 1]
    assert [e["metrics"]["epoch"] for e in manifest["checkpoints"]] == [0, 1]
    assert manifest["latest"] == result.checkpoint.path
    assert all(os.path.isdir(e["path"]) for e in manifest["checkpoints"])
    restored = result.checkpoint.to_directory(str(tmp_path / "restored"))
    with open(os.path.join(restored, "lora.pkl"), "rb") as f:
        state = pickle.load(f)
    cfg = llama_lora.model_config(config)
    _, lora = split_lora(init_params(cfg, device="cpu"))
    assert state["epoch"] == 1 and state["lora"].keys() == lora.keys()
    assert all(t.dtype == cfg.param_dtype and t.device.type == "cpu" for t in state["lora"].values())
    # lora_b starts at zero and has been trained
    assert any(t.any() for k, t in state["lora"].items() if k.endswith("lora_b"))


def test_fit_error_lands_in_result(tmp_path, monkeypatch):
    """The loop defaults to the card; with none, fit() returns the error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    result = TorchTrainer(
        llama_lora.train_loop_per_worker, train_loop_config={"model": "tiny"},
        run_config=RunConfig(name="nocard", storage_path=str(tmp_path)),
    ).fit()
    assert isinstance(result.error, RuntimeError) and "no CUDA device" in str(result.error)
    assert result.metrics == {} and result.checkpoint is None


def test_more_than_one_worker_raises():
    """More workers are accepted (tests/test_torch_train_dp.py runs them);
    what cannot run raises from fit() before anything spawns: NCCL for two
    ranks on one card, and a card past the host's."""
    assert llama_lora.make_trainer(num_workers=2).scaling_config.num_workers == 2
    with pytest.raises(ValueError):
        ScalingConfig(num_workers=0)
    assert llama_lora.make_trainer().scaling_config.num_workers == 1
    shared = TorchTrainer(llama_lora.train_loop_per_worker,
                          scaling_config=ScalingConfig(2, {"GPU": 0.5}),
                          backend_config=TorchConfig(backend="nccl"))
    with pytest.raises(ValueError, match='backend="gloo"'):
        shared.fit()
    assert ScalingConfig(4, {"GPU": 0.5}).worker_cards() == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="2 card"):
        ScalingConfig(3, {"GPU": 0.5}).check_cards(1)
