"""ray_tpu_torch.models against ray_tpu.models.llama on the CPU.

The reference initialises a tiny Llama under PRNGKey(0); its weights are
carried into the port by params_from_jax, and both run the same numpy
tokens. The JAX full forward reaches the Pallas flash kernel in interpret
mode; the port's reaches the plain version of its CUDA kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.llama import Llama as JaxLlama
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.models.llama import next_token_loss as jax_next_token_loss
from ray_tpu.models.llama import nll_from_logits as jax_nll
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    build_llama,
    init_params,
    new_cache,
    next_token_loss,
    nll_from_logits,
)
from ray_tpu_torch.train.examples.llama_lora import lora_model

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _configs(**kw):
    """The same tiny config on both sides; kw in JAX dtypes."""
    jcfg = JaxLlamaConfig.tiny(**kw)
    tkw = {k: _TORCH_DTYPE.get(v, v) for k, v in kw.items()}
    return jcfg, LlamaConfig.tiny(**tkw)


def _jax_params(jcfg):
    params = unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


_FORWARD_CASES = {
    # f32 everywhere: the same arithmetic up to summation order
    "f32": (dict(dtype=jnp.float32), 1e-4),
    "f32_gqa": (dict(dtype=jnp.float32, n_kv_heads=2), 1e-4),
    "f32_lora": (dict(dtype=jnp.float32, lora_rank=4), 1e-4),
    # bf16 activations: the frameworks round at other places (matmul
    # accumulation, silu); a few bf16 ulps of logits below 1 in magnitude
    "bf16": (dict(), 2e-2),
}


@pytest.mark.parametrize("case", list(_FORWARD_CASES))
def test_full_forward_matches_jax(case):
    kw, tol = _FORWARD_CASES[case]
    jcfg, tcfg = _configs(**kw)
    jparams = _jax_params(jcfg)
    if "lora_rank" in kw:
        # lora_b starts at zero; give it values so the adapter path counts
        rng = np.random.default_rng(5)
        for name in ("wq", "wk", "wv", "wo"):
            leaf = jparams["layer_0"]["attn"][name]
            leaf["lora_b"] = 0.05 * rng.standard_normal(leaf["lora_b"].shape).astype(np.float32)
    tokens = _tokens((2, 24))
    ref = JaxLlama(jcfg).apply({"params": jparams}, jnp.asarray(tokens))
    model = build_llama(tcfg, params_from_jax(jparams, tcfg, device="cpu"))
    with torch.inference_mode():
        out = model(torch.from_numpy(tokens).long())
    assert out.dtype == tcfg.dtype and out.shape == (2, 24, tcfg.vocab_size)
    assert np.abs(_np(out) - _np(ref)).max() < tol


def test_decode_prefill_and_steps_match_jax():
    jcfg, tcfg = _configs(dtype=jnp.float32, n_kv_heads=2, max_seq_len=32)
    jparams = _jax_params(jcfg)
    jmodel = JaxLlama(jcfg, decode=True)
    model = build_llama(tcfg, params_from_jax(jparams, tcfg, device="cpu"))
    prompt = _tokens((2, 7), seed=1)
    steps = [_tokens((2, 1), seed=10 + i) for i in range(3)]

    logits, vars_out = jmodel.apply(
        {"params": jparams}, jnp.asarray(prompt), mutable=["cache"]
    )
    jcache = vars_out["cache"]
    jlogits = [logits]
    for tok in steps:
        logits, vars_out = jmodel.apply(
            {"params": jparams, "cache": jcache}, jnp.asarray(tok), mutable=["cache"]
        )
        jcache = vars_out["cache"]
        jlogits.append(logits)

    cache = new_cache(tcfg, 2, "cpu")
    with torch.inference_mode():
        tlogits = [model(torch.from_numpy(prompt).long(), cache)]
        tlogits += [model(torch.from_numpy(t).long(), cache) for t in steps]

    for t, j in zip(tlogits, jlogits):
        # f32 cache path on both sides
        assert np.abs(_np(t) - _np(j)).max() < 1e-4
    for i in range(tcfg.n_layers):
        jl = jcache[f"layer_{i}"]["attn"]
        np.testing.assert_array_equal(cache[i].cache_index.numpy(), np.asarray(jl["cache_index"]))
        assert cache[i].cache_index.dtype == torch.int32
        assert np.abs(cache[i].cached_key.numpy() - np.asarray(jl["cached_key"])).max() < 1e-4
        assert np.abs(cache[i].cached_value.numpy() - np.asarray(jl["cached_value"])).max() < 1e-4


def test_cache_insert_clamps_like_dynamic_update_slice():
    _, tcfg = _configs(dtype=jnp.float32, max_seq_len=8, n_layers=1)
    model = build_llama(tcfg, init_params(tcfg, device="cpu"))
    cache = new_cache(tcfg, 1, "cpu")
    cache[0].cache_index.fill_(7)  # a 3-token write from 7 starts at 5
    with torch.inference_mode():
        out = model(torch.tensor([[1, 2, 3]]), cache)
    assert torch.isfinite(out).all()
    assert cache[0].cache_index.item() == 10
    assert (cache[0].cached_key[0, :, 5:8] != 0).any(dim=-1).all()
    assert (cache[0].cached_key[0, :, :5] == 0).all()


def test_params_from_jax_rejects_bad_trees():
    jcfg, tcfg = _configs(n_layers=1)
    good = _jax_params(jcfg)
    assert set(params_from_jax(good, tcfg, device="cpu")) == set(
        init_params(tcfg, device="cpu")
    )

    missing = jax.tree_util.tree_map(lambda x: x, good)
    del missing["layer_0"]["mlp"]["w_up"]
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(missing, tcfg, device="cpu")

    extra = jax.tree_util.tree_map(lambda x: x, good)
    extra["layer_0"]["attn"]["bias"] = np.zeros(4, np.float32)
    with pytest.raises(KeyError, match="does not know"):
        params_from_jax(extra, tcfg, device="cpu")

    wrong = jax.tree_util.tree_map(lambda x: x, good)
    wrong["lm_head"] = wrong["lm_head"].T
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(wrong, tcfg, device="cpu")

    # the stacked scan_layers layout is unstacked first, then checked alike
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(
            {"layers": {"block": {"attn_norm": np.ones((1, 128), np.float32)}}},
            tcfg, device="cpu",
        )
    with pytest.raises(KeyError, match="does not know"):
        params_from_jax({"layers": {"other": np.ones((1, 128), np.float32)}}, tcfg, device="cpu")
    both = jax.tree_util.tree_map(lambda x: x, good)
    both["layers"] = {"block": {"attn_norm": np.ones((1, 128), np.float32)}}
    with pytest.raises(KeyError, match="both stacked and per layer"):
        params_from_jax(both, tcfg, device="cpu")


def test_init_params_follows_reference_initialisers():
    jcfg, tcfg = _configs(n_layers=1, lora_rank=4)
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ref = _jax_params(jcfg)
    ref_flat = {
        ".".join(str(getattr(p, "key", p)) for p in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref)
    }
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: v.shape for k, v in ref_flat.items()
    }
    assert all(v.dtype == torch.float32 for v in params.values())
    assert torch.all(params["layer_0.attn_norm"] == 1.0)
    assert torch.all(params["layer_0.attn.wq.lora_b"] == 0.0)
    # normal(0.02) and lecun-normal std 1/sqrt(fan_in), to sampling error
    assert abs(params["embed"].std().item() - 0.02) < 1e-3
    assert abs(params["layer_0.mlp.w_down.kernel"].std().item() - 256 ** -0.5) < 3e-3
    again = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_nll_from_logits_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32)
    tokens = rng.integers(0, 50, (2, 9)).astype(np.int32)
    out = nll_from_logits(torch.from_numpy(logits), torch.from_numpy(tokens))
    ref = jax_nll(jnp.asarray(logits), jnp.asarray(tokens))
    assert abs(out.item() - float(ref)) < 1e-5


def _nonzero_lora_b(jparams, seed=11):
    """lora_b starts at zero, where every lora_a gradient is exactly 0; give
    each a small random value so both adapter halves are tested."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                fill(val)
            elif key == "lora_b":
                tree[key] = 0.05 * rng.standard_normal(val.shape).astype(np.float32)

    fill(jparams)
    return jparams


def _port_lora_grads(tcfg, params, tokens):
    model, lora, _ = lora_model(tcfg, params)
    loss = next_token_loss(tcfg, model, torch.from_numpy(tokens).long())
    loss.backward()
    return loss.item(), {n: p.grad for n, p in lora.items()}


def _rel_err(a, b):
    return np.abs(_np(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def test_lora_grads_match_jax_grad():
    jcfg, tcfg = _configs(dtype=jnp.float32, lora_rank=4)
    jparams = _nonzero_lora_b(_jax_params(jcfg))
    tokens = _tokens((2, 24), seed=2)
    from ray_tpu.train.lora import merge_lora as jax_merge, split_lora as jax_split

    jbase, jlora = jax_split(jparams)
    jloss, jgrads = jax.value_and_grad(
        lambda lp: jax_next_token_loss(jcfg, None, jax_merge(jbase, lp), jnp.asarray(tokens))
    )(jlora)
    params = params_from_jax(jparams, tcfg, device="cpu")
    loss, grads = _port_lora_grads(tcfg, params, tokens)
    assert set(grads) == {".".join(k) for k in jgrads}
    # the state-dict form reads the same loss from a frozen model
    with torch.no_grad():
        assert next_token_loss(tcfg, params, torch.from_numpy(tokens).long()).item() == loss
    # f32 on both sides, the same arithmetic in another summation order:
    # 1e-4 relative, of the loss and of each adapter's largest gradient
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    for key, jg in jgrads.items():
        assert _rel_err(grads[".".join(key)], jg) < 1e-4, key


def test_stacked_scan_layers_tree_converts_and_remat_keeps_grads():
    import dataclasses

    # the port has no scan_layers field: its loop with per-block
    # checkpointing stands in for the reference's scan
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4, scan_layers=True, remat=True)
    _, tcfg = _configs(dtype=jnp.float32, lora_rank=4, remat=True)
    jparams = _nonzero_lora_b(_jax_params(jcfg))
    assert jparams["layers"]["block"]["attn"]["wq"]["lora_a"].shape[0] == jcfg.n_layers
    params = params_from_jax(jparams, tcfg, device="cpu")
    tokens = _tokens((2, 16), seed=3)
    jloss = jax_next_token_loss(jcfg, None, jparams, jnp.asarray(tokens))
    assert tcfg.remat
    loss, grads = _port_lora_grads(tcfg, params, tokens)
    # f32 loss of the same weights: the reference scans, the port loops
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    plain_loss, plain = _port_lora_grads(dataclasses.replace(tcfg, remat=False), params, tokens)
    # remat recomputes the same blocks from the same inputs: equal up to f32
    # reassociation inside the recompute
    assert abs(loss - plain_loss) <= 1e-6 * abs(plain_loss)
    for name, g in grads.items():
        assert torch.allclose(g, plain[name], rtol=0, atol=1e-6 * plain[name].abs().max().item())
