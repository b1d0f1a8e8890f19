"""ray_tpu_torch.llm against ray_tpu.llm on the CPU, and the port's guards.

Both engines run the same tiny Llama (the reference's PRNGKey(0) weights,
carried across by params_from_jax) in float32, so that greedy argmax ties
in bf16 cannot split the two token streams: greedy tokens must be equal.
Temperature sampling draws other bits in PyTorch than in JAX, so it is held
to reproducibility within the port only.
"""

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
from ray_tpu.llm import GenerationRequest as JaxRequest
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm.serving import _LLMReplica
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch._internal.device import resolve_device
from ray_tpu_torch.llm import GenerationRequest, LLMConfig, LLMEngine, LLMServer
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import LlamaConfig

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


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(kv_cache_blocks=16),
        dict(mesh={"tp": 2}),
        dict(tensor_parallel_size=2),
        dict(draft_model="llama-tiny"),
        dict(adapters={"max_live": 2}),
        dict(roles={"prefill": 1, "decode": 1}),
        dict(kv_tier=True),
        dict(model_family="moe"),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_later_slice_features_raise(kwargs):
    with pytest.raises(NotImplementedError, match="slice"):
        LLMConfig(**kwargs)


def test_build_model_config_tiny_suffix_rule():
    tiny = LLMConfig(model_id="llama-tiny", max_seq_len=128).build_model_config()
    full = LLMConfig(model_id="llama2-7b", model_kwargs={"n_layers": 2}).build_model_config()
    ref = JaxLLMConfig(model_id="llama2-7b", model_kwargs={"n_layers": 2}).build_model_config()
    assert (tiny.dim, tiny.max_seq_len) == (128, 128)
    assert (full.dim, full.n_heads, full.intermediate, full.vocab_size, full.max_seq_len) == (
        ref.dim, ref.n_heads, ref.intermediate, ref.vocab_size, ref.max_seq_len
    )


def test_port_imports_neither_jax_nor_ray_tpu():
    """Import every module of the package in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys, ray_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'ray_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 23  # every module was walked


def test_port_sources_name_neither_jax_nor_ray_tpu():
    """No import of jax, flax, optax or ray_tpu anywhere, lazy ones included."""
    import ast

    offenders = []
    pkg = _REPO / "ray_tpu_torch"
    for path in pkg.rglob("*.py"):
        if path.relative_to(pkg).parts[0] == "_build":  # build outputs
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [
                f"{path.name}: {n}" for n in names
                if n.split(".")[0] in ("jax", "flax", "optax", "ray_tpu")
            ]
    assert offenders == []


def test_no_card_means_error_not_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(LLMConfig(model_id="llama-tiny", max_seq_len=32))
    assert resolve_device("cpu") == torch.device("cpu")
