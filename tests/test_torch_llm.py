"""ray_tpu_torch.llm against ray_tpu.llm on the CPU, and the port's guards.

Both engines run the same tiny Llama (the reference's PRNGKey(0) weights,
carried across by params_from_jax) in float32, so that greedy argmax ties
in bf16 cannot split the two token streams: greedy tokens must be equal.
Temperature sampling draws other bits in PyTorch than in JAX, so it is held
to reproducibility within the port only.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._internal import serialization
from ray_tpu.exceptions import MeshValidationError as JaxMeshValidationError
from ray_tpu.llm import GenerationRequest as JaxRequest
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm.serving import _LLMReplica
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch._internal.device import resolve_device
from ray_tpu_torch.exceptions import MeshValidationError
from ray_tpu_torch.llm import (
    AdapterConfig,
    GenerationRequest,
    LLMConfig,
    LLMEngine,
    LLMPredictor,
    LLMServer,
)
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import LlamaConfig, param_shapes
from ray_tpu_torch.models.moe import MoEConfig

_REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxLlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32, n_kv_heads=2)
    tcfg = LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32, n_kv_heads=2)
    jparams = unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu"
    )
    return (
        JaxEngine(jcfg, jparams, max_batch_size=2),
        LLMEngine(tcfg, tparams, max_batch_size=2, device="cpu"),
    )


def _run_both(engines, prompts, max_new=5, eos=None):
    jax_engine, engine = engines
    ref = jax_engine.generate(
        [JaxRequest(token_ids=p, max_new_tokens=max_new, eos_token_id=eos) for p in prompts]
    )
    out = engine.generate(
        [GenerationRequest(token_ids=p, max_new_tokens=max_new, eos_token_id=eos)
         for p in prompts]
    )
    return ref, out


_PROMPTS = {
    "one_prompt": [[3, 14, 15, 92, 65, 35]],
    # three rows with max_batch_size=2: two groups of one length
    "same_length_batch": [[1, 2, 3, 4], [9, 8, 7, 6], [5, 5, 5, 5]],
    "mixed_lengths": [[1, 2], [3, 4, 5, 6], [7, 8], [9, 10, 11, 12]],
}


@pytest.mark.parametrize("case", list(_PROMPTS))
def test_greedy_tokens_match_jax(engines, case):
    ref, out = _run_both(engines, _PROMPTS[case])
    for r, o in zip(ref, out):
        assert o.token_ids == r.token_ids
        assert o.num_prompt_tokens == r.num_prompt_tokens
        assert o.finished_reason == r.finished_reason


def test_eos_stops_like_jax(engines):
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6]]
    free, _ = _run_both(engines, prompts, max_new=6)
    eos = free[0].token_ids[2]  # row 0 meets it at its third token
    ref, out = _run_both(engines, prompts, max_new=6, eos=eos)
    assert out[0].finished_reason == "eos" and out[0].token_ids[-1] == eos
    for r, o in zip(ref, out):
        assert (o.token_ids, o.finished_reason) == (r.token_ids, r.finished_reason)


def test_max_seq_len_guard(engines):
    jax_engine, engine = engines
    long = list(range(60))
    with pytest.raises(ValueError, match="max_seq_len"):
        jax_engine.generate([JaxRequest(token_ids=long, max_new_tokens=5)])
    with pytest.raises(ValueError, match="max_seq_len"):
        engine.generate([GenerationRequest(token_ids=long, max_new_tokens=5)])
    with pytest.raises(ValueError, match="max_seq_len"):
        next(engine.generate_stream(GenerationRequest(token_ids=long, max_new_tokens=5)))


def test_generate_stream_equals_generate_and_jax(engines):
    jax_engine, engine = engines
    prompt = [7, 1, 7, 2, 9]
    batch = engine.generate([GenerationRequest(token_ids=prompt, max_new_tokens=6)])[0]
    items = list(engine.generate_stream(GenerationRequest(token_ids=prompt, max_new_tokens=6)))
    ref = list(jax_engine.generate_stream(JaxRequest(token_ids=prompt, max_new_tokens=6)))
    assert items[:-1] == batch.token_ids == items[-1].token_ids
    assert items[:-1] == ref[:-1]


def test_temperature_sampling_is_reproducible(engines):
    _, engine = engines
    params = engine._params
    cfg = engine._cfg
    reqs = [GenerationRequest(token_ids=[1, 2, 3], max_new_tokens=8, temperature=1.0)] * 2

    def run(seed):
        e = LLMEngine(cfg, params, seed=seed, device="cpu")
        return [r.token_ids for r in e.generate(reqs)]

    first = run(7)
    assert first == run(7)
    assert first != run(8)
    assert all(0 <= t < cfg.vocab_size for row in first for t in row)


def test_server_answers_like_replica():
    """The whole slice: the reference's replica and the port's server, on
    the same weights, give the same response dicts, streamed or not."""
    jcfg = JaxLLMConfig(model_id="llama-tiny", max_seq_len=64, seed=0,
                        model_kwargs={"dtype": jnp.float32})
    tcfg = LLMConfig(model_id="llama-tiny", max_seq_len=64, seed=0,
                     model_kwargs={"dtype": torch.float32})
    jparams = unbox_params(
        jax_init_params(jcfg.build_model_config(), jax.random.PRNGKey(0))
    )
    replica = _LLMReplica(jcfg, params_blob=serialization.dumps(jparams))
    server = LLMServer(
        tcfg,
        params=params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams),
            tcfg.build_model_config(), device="cpu",
        ),
        device="cpu",
    )
    request = {"token_ids": [5, 6, 7, 8], "max_new_tokens": 4}
    assert server(request) == replica(request)
    streamed = list(server.stream(request))
    assert streamed == list(replica.stream(request))
    assert server(dict(request, stream=True)) == streamed[-1]


# id: (config, what the port does with it). The adapter cases construct
# since adapters are ported: beside a draft as in the reference, and
# without a KV pool refused with the reference's ValueError. The MoE family
# constructs since the MoE model is ported, and builds the reference's
# MoEConfig ("moe"); serving it is refused (test_moe_is_not_served). The KV
# tier and disaggregated roles are ported: over a KV pool they construct
# ("tier"), without one they are refused with the reference's ValueError.
# A tensor-parallel mesh constructs ("tp"), with adapters, the KV tier or
# roles beside it as the reference's; a sequence-parallel one waits for a
# later slice
_LATER_SLICES = {
    # the paged engine and the cluster KV tier over it
    "kv_cache_blocks": (dict(kv_cache_blocks=16, kv_tier=True), "tier"),
    "mesh": (dict(mesh={"tp": 2}), "tp"),
    "tensor_parallel_size": (dict(tensor_parallel_size=2), "tp"),
    "sequence_parallel_size": (dict(sequence_parallel_size=2), NotImplementedError),
    "adapters_with_tp": (
        dict(tensor_parallel_size=2, kv_cache_blocks=16, adapters={"max_live": 2}), "tp"
    ),
    "kv_tier_with_tp": (dict(tensor_parallel_size=2, kv_cache_blocks=16, kv_tier=True), "tp"),
    "roles_with_tp": (
        dict(tensor_parallel_size=2, kv_cache_blocks=16, roles={"prefill": 1, "decode": 1}),
        "tp",
    ),
    "draft_model": (
        dict(draft_model="llama-tiny", kv_cache_blocks=16, adapters={"max_live": 2}), None
    ),
    "adapters": (dict(adapters={"max_live": 2}), ValueError),
    "roles": (dict(roles={"prefill": 1, "decode": 1}), ValueError),
    "kv_tier": (dict(kv_tier=True), ValueError),
    "model_family": (dict(model_family="moe"), "moe"),
    # the serve control plane (ported: the deployment's fields construct,
    # "serve"), and the weight plane
    "num_replicas": (dict(num_replicas=2), "serve"),
    "autoscaling_config": (dict(autoscaling_config={"min_replicas": 1}), "serve"),
    "autoscale_policy": (dict(autoscale_policy={"min_replicas": 1}), "serve"),
    "quantized": (dict(quantized=True), NotImplementedError),
}


@pytest.mark.parametrize("case", list(_LATER_SLICES))
def test_later_slice_features_raise(case):
    kwargs, raises = _LATER_SLICES[case]
    if raises is NotImplementedError:
        with pytest.raises(NotImplementedError, match="slice"):
            LLMConfig(**kwargs)
    elif raises is ValueError:
        with pytest.raises(ValueError, match="kv_cache_blocks"):
            JaxLLMConfig(**kwargs)
        with pytest.raises(ValueError, match="kv_cache_blocks"):
            LLMConfig(**kwargs)
    elif raises == "tp":
        cfg, ref = LLMConfig(**kwargs), JaxLLMConfig(**kwargs)
        assert cfg.effective_parallelism() == ref.effective_parallelism() == (2, 1)
        assert (cfg.kv_tier, cfg.roles, cfg.kv_cache_blocks) == (
            ref.kv_tier, ref.roles, ref.kv_cache_blocks)
        assert (dataclasses.asdict(cfg.adapters) if cfg.adapters else None) == (
            dataclasses.asdict(ref.adapters) if ref.adapters else None)
    elif raises == "tier":
        cfg, ref = LLMConfig(**kwargs), JaxLLMConfig(**kwargs)
        assert (cfg.kv_tier, cfg.kv_cache_blocks, cfg.kv_ship_codec) == (
            ref.kv_tier, ref.kv_cache_blocks, ref.kv_ship_codec) == (True, 16, "raw")
    elif raises == "serve":
        cfg, ref = LLMConfig(**kwargs), JaxLLMConfig(**kwargs)
        assert (cfg.num_replicas, cfg.autoscaling_config, cfg.autoscale_policy) == (
            ref.num_replicas, ref.autoscaling_config, ref.autoscale_policy)
    elif raises == "moe":
        for model_id in ("moe-tiny", "mixtral-8x7b"):
            got = LLMConfig(model_id=model_id, **kwargs).build_model_config()
            want = JaxLLMConfig(model_id=model_id, **kwargs).build_model_config()
            assert isinstance(got, MoEConfig)
            assert _fields(got) == _fields(want)
    else:
        cfg, ref = LLMConfig(**kwargs), JaxLLMConfig(**kwargs)
        assert isinstance(cfg.adapters, AdapterConfig)
        assert dataclasses.asdict(cfg.adapters) == dataclasses.asdict(ref.adapters)
        assert (cfg.spec_tokens, cfg.kv_cache_blocks) == (ref.spec_tokens, ref.kv_cache_blocks)


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(draft_model="llama-tiny"), "kv_cache_blocks"),
        (dict(prefill_chunk_tokens=256), "kv_cache_blocks"),
        (dict(spec_tokens=4, kv_cache_blocks=32), "draft_model"),
        (dict(prefill_chunk_tokens=-1, kv_cache_blocks=32), "prefill_chunk_tokens"),
        (dict(adapters={"max_live": 2}), "kv_cache_blocks"),
        (dict(adapters={"max_live": 0}, kv_cache_blocks=32), "max_live"),
        (dict(adapters={"source": "s3://x"}, kv_cache_blocks=32), "source"),
    ],
    ids=["spec_without_pool", "chunked_without_pool", "spec_without_draft",
         "negative_chunk", "adapters_without_pool", "adapters_no_slot", "adapters_bad_source"],
)
def test_paged_feature_guards_like_reference(kwargs, match):
    with pytest.raises(ValueError, match=match):
        JaxLLMConfig(**kwargs)
    with pytest.raises(ValueError, match=match):
        LLMConfig(**kwargs)


@pytest.mark.parametrize(
    "kwargs, error",
    [
        (dict(mesh={"dp": 4}), "mesh"),
        (dict(mesh={"tp": 0}), "mesh"),
        (dict(mesh={"tp": "2"}), "mesh"),
        (dict(mesh={"tp": 2, "sp": -1}), "mesh"),
        (dict(kv_ship_codec="fp8"), ValueError),
        (dict(roles={"prefill": 1, "decode": 1, "router": 1}), ValueError),
        (dict(roles={"prefill": 0, "decode": 1}), ValueError),
        (dict(roles={"prefill": 1}), ValueError),
    ],
    ids=["mesh_axis_dp", "mesh_tp_0", "mesh_tp_str", "mesh_sp_negative", "kv_ship_codec",
         "roles_key", "roles_zero", "roles_missing"],
)
def test_config_checks_like_reference(kwargs, error):
    """The reference's checks of values run before any not-ported raise:
    the same error class and message on both sides."""
    if error == "mesh":
        ref_error, error = JaxMeshValidationError, MeshValidationError
    else:
        ref_error = error
    with pytest.raises(ref_error) as ref:
        JaxLLMConfig(**kwargs)
    with pytest.raises(error) as got:
        LLMConfig(**kwargs)
    assert str(got.value) == str(ref.value)
    assert issubclass(MeshValidationError, ValueError)


def test_every_reference_config_field_is_a_port_field():
    """A config written for ray_tpu reads the same: every field of the
    reference's LLMConfig and LlamaConfig is accepted, with its default
    (dtypes are torch's in the port), but resources_per_replica's: a port
    replica serves on the card, so it asks for one (kept item 38)."""
    ref_defaults, port_defaults = JaxLLMConfig(), LLMConfig()
    for name in (f.name for f in dataclasses.fields(JaxLLMConfig)):
        assert hasattr(port_defaults, name), name
        if name == "resources_per_replica":
            assert port_defaults.resources_per_replica == {"CPU": 1.0, "GPU": 1.0}
            assert ref_defaults.resources_per_replica == {"TPU": 0.0, "CPU": 1.0}
            continue
        assert getattr(port_defaults, name) == getattr(ref_defaults, name), name
    ref_model, port_model = JaxLlamaConfig(), LlamaConfig()
    for name in (f.name for f in dataclasses.fields(JaxLlamaConfig)):
        assert hasattr(port_model, name), name
        if name not in ("dtype", "param_dtype"):
            assert getattr(port_model, name) == getattr(ref_model, name), name
    LLMConfig(prefix_affinity_tokens=8, resources_per_replica={"GPU": 1.0}, kv_ship_codec="int8")
    # scan_layers builds the same (unstacked) model
    scanned = LLMConfig(model_kwargs={"scan_layers": True}).build_model_config()
    assert scanned.scan_layers and param_shapes(scanned) == param_shapes(
        dataclasses.replace(scanned, scan_layers=False))


def test_draft_config_like_reference():
    kw = dict(draft_model="llama-tiny", kv_cache_blocks=32, max_seq_len=96,
              draft_model_kwargs={"n_layers": 1})
    cfg, ref = LLMConfig(**kw), JaxLLMConfig(**kw)
    assert cfg.spec_tokens == ref.spec_tokens == 4
    draft, ref_draft = cfg.build_draft_model_config(), ref.build_draft_model_config()
    assert (draft.n_layers, draft.dim, draft.vocab_size, draft.max_seq_len) == (
        ref_draft.n_layers, ref_draft.dim, ref_draft.vocab_size, ref_draft.max_seq_len
    ) == (1, 128, 256, 96)
    assert LLMConfig().build_draft_model_config() is None


def _fields(config):
    """A model config's fields, dtypes by name (jnp's or torch's)."""
    def name(v):
        if isinstance(v, torch.dtype):
            return str(v).replace("torch.", "")
        return jnp.dtype(v).name if isinstance(v, type) else v

    return {k: name(v) for k, v in dataclasses.asdict(config).items()}


def test_moe_is_not_served():
    """The reference has no MoE decode path: its replica fails while it
    builds Llama weights from a MoEConfig. The port refuses the config with
    a ValueError before any weight is drawn."""
    kwargs = dict(model_family="moe", model_id="moe-tiny", max_seq_len=32)
    with pytest.raises(AttributeError, match="scan_layers"):
        _LLMReplica(JaxLLMConfig(**kwargs))
    with pytest.raises(ValueError, match="no MoE decode path"):
        LLMServer(LLMConfig(**kwargs), device="cpu")
    with pytest.raises(ValueError, match="no MoE decode path"):
        LLMServer(LLMConfig(kv_cache_blocks=4, **kwargs), device="cpu")
    with pytest.raises(ValueError, match="no MoE decode path"):
        LLMPredictor(LLMConfig(**kwargs), device="cpu")


def test_build_model_config_tiny_suffix_rule():
    tiny = LLMConfig(model_id="llama-tiny", max_seq_len=128).build_model_config()
    full = LLMConfig(model_id="llama2-7b", model_kwargs={"n_layers": 2}).build_model_config()
    ref = JaxLLMConfig(model_id="llama2-7b", model_kwargs={"n_layers": 2}).build_model_config()
    assert (tiny.dim, tiny.max_seq_len) == (128, 128)
    assert (full.dim, full.n_heads, full.intermediate, full.vocab_size, full.max_seq_len) == (
        ref.dim, ref.n_heads, ref.intermediate, ref.vocab_size, ref.max_seq_len
    )


def test_port_imports_neither_jax_nor_ray_tpu():
    """Import every module of the package in a fresh interpreter: none of them
    brings in JAX, ray_tpu, gymnasium, ml_dtypes or cloudpickle (which the
    card's machine lacks). The walk includes the parallel package, the MoE
    model, the observability plane (util), the KV tier with what it
    imports, every RLlib algorithm, DreamerV3 included, FSDP, the
    differentiable collectives, the sharded checkpoint, ring and Ulysses
    attention, and the runtime core (its GCS, raylet, core worker, RPC
    plane and device objects)."""
    code = (
        "import importlib, pkgutil, sys, ray_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'ray_tpu', 'gymnasium',\n"
        "                                    'ml_dtypes', 'cloudpickle', 'aiohttp', 'grpc',\n"
        "                                    'fastapi', 'starlette'))\n"
        "need = {'ray_tpu_torch.parallel.expert', 'ray_tpu_torch.models.moe',\n"
        "        'ray_tpu_torch.util.metrics', 'ray_tpu_torch.util.tracing',\n"
        "        'ray_tpu_torch.util.events', 'ray_tpu_torch.kvtier.tier',\n"
        "        'ray_tpu_torch.kvtier.shipping', 'ray_tpu_torch.kvtier.fingerprint',\n"
        "        'ray_tpu_torch.runtime.gcs.kvtier_registry', 'ray_tpu_torch.weights.manifest',\n"
        "        'ray_tpu_torch._internal.quantization', 'ray_tpu_torch._internal.serialization',\n"
        "        'ray_tpu_torch._internal.transfer', 'ray_tpu_torch.rllib.dqn',\n"
        "        'ray_tpu_torch.rllib.sac', 'ray_tpu_torch.rllib.impala', 'ray_tpu_torch.rllib.bc',\n"
        "        'ray_tpu_torch.rllib.offline', 'ray_tpu_torch.rllib.multi_agent',\n"
        "        'ray_tpu_torch.rllib.multi_agent_env', 'ray_tpu_torch.rllib.dreamer',\n"
        "        'ray_tpu_torch.parallel.fsdp', 'ray_tpu_torch.collective.functional',\n"
        "        'ray_tpu_torch.train.sharded_checkpoint', 'ray_tpu_torch.parallel.ring_attention',\n"
        "        'ray_tpu_torch.parallel.ulysses', 'ray_tpu_torch.api',\n"
        "        'ray_tpu_torch.runtime.worker.core_worker', 'ray_tpu_torch.runtime.raylet.raylet',\n"
        "        'ray_tpu_torch.runtime.gcs.server', 'ray_tpu_torch._internal.rpc',\n"
        "        'ray_tpu_torch.experimental.device_objects'}\n"
        "print(len(mods), bad, sorted(need - set(mods)))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # every module was walked, rllib's, parallel's, the MoE model's, util's
    # and the KV tier's included
    assert int(proc.stdout.split()[0]) >= 60 and proc.stdout.rstrip().endswith("[] []")


def test_port_sources_name_neither_jax_nor_ray_tpu():
    """No import of jax, flax, optax, ray_tpu, ml_dtypes, cloudpickle,
    aiohttp, grpc, fastapi or starlette anywhere, lazy ones included (the
    card's machine has none of the last six), and of gymnasium nowhere but
    in rllib/env.py's lazy ``make_env`` of a string id. The scan covers
    every module, DreamerV3's, the converters', the runtime core's and the
    serve control plane's included (the reference's RPC plane, object plane
    and GCS records use cloudpickle, its HTTP proxy aiohttp and its gRPC
    proxy grpc; the port's use none)."""
    import ast

    offenders, scanned = [], set()
    pkg = _REPO / "ray_tpu_torch"
    for path in pkg.rglob("*.py"):
        if path.relative_to(pkg).parts[0] == "_build":  # build outputs
            continue
        rel = path.relative_to(pkg).as_posix()
        scanned.add(rel)
        banned = ("jax", "flax", "optax", "ray_tpu", "ml_dtypes", "cloudpickle",
                  "aiohttp", "grpc", "fastapi", "starlette")
        if rel != "rllib/env.py":
            banned += ("gymnasium",)
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    assert offenders == []
    assert {"rllib/dreamer.py", "rllib/sac.py", "models/convert.py", "parallel/fsdp.py",
            "collective/functional.py", "train/sharded_checkpoint.py", "_internal/rpc.py",
            "_internal/serialization.py", "runtime/worker/core_worker.py",
            "runtime/gcs/actor_manager.py", "runtime/gcs/placement_groups.py",
            "runtime/gcs/server.py", "experimental/device_objects.py", "serve/proxy.py",
            "serve/api.py", "serve/controller.py", "serve/replica.py"} <= scanned


def test_no_card_means_error_not_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(LLMConfig(model_id="llama-tiny", max_seq_len=32))
    assert resolve_device("cpu") == torch.device("cpu")


def test_no_card_means_error_on_the_paged_server(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLMConfig(model_id="llama-tiny", max_seq_len=32, kv_cache_blocks=4,
                    kv_block_size=8, draft_model="llama-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(cfg)
    params = {"w": torch.zeros(1)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(cfg, params=params)
    server = LLMServer(cfg, device="cpu")
    assert server.engine._device == torch.device("cpu")
    assert server.kvcache_stats()["capacity"] == 4
