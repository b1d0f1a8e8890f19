"""The port's LLM deployment (``ray_tpu_torch.llm.build_llm_deployment``
over ``ray_tpu_torch.serve``) against the reference's replica.

Tiny f32 Llama weights (n_kv_heads 2), drawn by the JAX package under
PRNGKey(0) and carried over by ``models/convert.py`` ``params_from_jax``,
reach every replica as ``params_blob`` (the port's parameter dict through
its ``serialization.dumps``). The reference's ``_LLMReplica``, in process
on the same weights, gives the tokens and the KV counts to hold the
deployment to. One port cluster of CPU replicas (``device="cpu"``, one CPU
each) serves: two replicas through the handle; ``autoscaling_config``
with ``min_replicas=2``; prefix affinity with the exact hit count of the
reference's one replica; an adapter named by ``multiplexed_model_id``; a
token stream; one tensor-parallel replica (tp=2 over gloo ranks) against
the tp=1 tokens. Then, in process: the role graph in local mode against
the reference's ``run_local`` of its own (tests/test_kvtier.py), the
refusals, and ``LLMPredictor(params_blob=)`` against the reference's.
Greedy tokens are compared exactly; counts exactly.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_programs as P
from ray_tpu._internal import serialization as ref_serialization
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm.batch import LLMPredictor as JaxPredictor
from ray_tpu.llm.serving import _LLMReplica as JaxReplica
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch._internal import serialization
from ray_tpu_torch.llm import LLMConfig, LLMPredictor, build_llm_deployment
from ray_tpu_torch.llm.serving import LLMServer, _LLMReplica, publish_llm_weights
from ray_tpu_torch.models.convert import params_from_jax

KW = dict(model_id="llama-tiny", max_seq_len=64, seed=0, max_new_tokens=6,
          kv_cache_blocks=32, kv_block_size=8, max_batch_size=4)
PROMPTS = [list(range(5, 24)), list(range(100, 111)), [7, 3, 9, 1, 4], list(range(30, 47))]
PREFIX = list(range(200, 216))  # two blocks of 8
AFFINE = [PREFIX + [50 + 5 * i + j for j in range(5)] for i in range(4)]
ADAPTERS = dict(max_live=2, slot_rank=4, alpha=8.0, source=P.adapter_source)


def _cfgs(**kw):
    jcfg = JaxLLMConfig(**KW, **kw, model_kwargs={"dtype": jnp.float32, "n_kv_heads": 2})
    tcfg = LLMConfig(**KW, **kw, resources_per_replica={"CPU": 1.0},
                     model_kwargs={"dtype": torch.float32, "n_kv_heads": 2})
    return jcfg, tcfg


def _req(tokens, **kw):
    return {"token_ids": list(tokens), "max_new_tokens": 6, **kw}


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jparams = unbox_params(jax_init_params(jcfg.build_model_config(), jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg.build_model_config(), device="cpu")
    return dict(jblob=ref_serialization.dumps(jparams), tparams=tparams,
                blob=serialization.dumps(tparams))


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's replica in process: tokens of every prompt, the KV
    hits of the affine sequence, and an adapter's tokens."""
    jcfg, _ = _cfgs()
    replica = JaxReplica(jcfg, params_blob=weights["jblob"])
    out = {"tokens": [replica(_req(p))["token_ids"] for p in PROMPTS]}
    before = replica.kvcache_stats()["prefix_hit_tokens"]
    out["affine"] = [replica(_req(p))["token_ids"] for p in AFFINE]
    out["affine_hits"] = replica.kvcache_stats()["prefix_hit_tokens"] - before
    jcfg_a, _ = _cfgs(adapters=ADAPTERS)
    with_adapters = JaxReplica(jcfg_a, params_blob=weights["jblob"])
    out["adapter"] = with_adapters(_req(PROMPTS[0], adapter_id="t1"))["token_ids"]
    out["stream"] = list(replica.stream(_req(PROMPTS[1])))
    return out


def _running(rt, app):
    return [r for r in rt.testing.list_serve_replicas(app) if r["state"] == "RUNNING"]


@pytest.fixture(scope="module")
def cluster(weights):
    """Every deployment of the file, one after another, on one port
    cluster."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.testing  # noqa: F401 - rt.testing

    serve = rt.serve
    blob = weights["blob"]
    out = {}
    rt.init(num_cpus=8)
    try:
        # two replicas through the handle, then prefix affinity on them
        _, tcfg = _cfgs(num_replicas=2)
        handle = serve.run(build_llm_deployment(tcfg, params_blob=blob, name="fused",
                                                device="cpu"), name="fused", _proxy=False)
        out["fused_running"] = len(_running(rt, "fused"))
        out["fused"] = [handle.remote(_req(p)).result(timeout_s=120)["token_ids"]
                        for p in PROMPTS]
        out["mesh"] = list(P.replica_calls(rt, "fused", "fused", "mesh_info").values())
        before = P.replica_calls(rt, "fused", "fused", "kvcache_stats")
        affine = handle.options(prefix_affinity_tokens=8)
        out["affine"] = [affine.remote(_req(p)).result(timeout_s=120)["token_ids"]
                         for p in AFFINE]
        after = P.replica_calls(rt, "fused", "fused", "kvcache_stats")
        out["affine_hits"] = {rid: after[rid]["prefix_hit_tokens"]
                              - before[rid]["prefix_hit_tokens"] for rid in after}
        out["affine_requests"] = {rid: after[rid]["requests"] - before[rid]["requests"]
                                  for rid in after}
        stream = handle.options(stream=True, method_name="stream").remote(_req(PROMPTS[1]))
        out["stream"] = list(stream)
        serve.delete("fused")

        # the queue autoscaler at min_replicas=2
        _, tcfg = _cfgs(autoscaling_config={"min_replicas": 2, "max_replicas": 3})
        handle = serve.run(build_llm_deployment(tcfg, params_blob=blob, name="auto",
                                                device="cpu"), name="auto", _proxy=False)
        deadline = time.time() + 60
        while len(_running(rt, "auto")) < 2 and time.time() < deadline:
            time.sleep(0.2)
        out["auto_running"] = len(_running(rt, "auto"))
        out["auto"] = [handle.remote(_req(p)).result(timeout_s=120)["token_ids"]
                       for p in PROMPTS[:2]]
        serve.delete("auto")

        # an adapter named by the multiplexed model id
        _, tcfg = _cfgs(adapters=ADAPTERS)
        handle = serve.run(build_llm_deployment(tcfg, params_blob=blob, name="lora",
                                                device="cpu"), name="lora", _proxy=False)
        out["adapter"] = handle.options(multiplexed_model_id="t1").remote(
            _req(PROMPTS[0])).result(timeout_s=120)["token_ids"]
        out["adapter_base"] = handle.remote(_req(PROMPTS[0])).result(timeout_s=120)["token_ids"]
        out["adapter_stats"] = list(P.replica_calls(rt, "lora", "lora", "adapters_stats")
                                    .values())[0]
        serve.delete("lora")

        # one tensor-parallel replica: two gloo ranks on the CPU
        _, tcfg = _cfgs(tensor_parallel_size=2)
        handle = serve.run(build_llm_deployment(tcfg, params_blob=blob, name="tp",
                                                device="cpu"), name="tp", _proxy=False)
        out["tp"] = [handle.remote(_req(p)).result(timeout_s=120)["token_ids"]
                     for p in PROMPTS]
        out["tp_mesh"] = list(P.replica_calls(rt, "tp", "tp", "mesh_info").values())[0]
        serve.delete("tp")
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    return out


def test_two_replicas_give_the_reference_tokens(cluster, reference):
    assert cluster["fused_running"] == 2
    assert cluster["fused"] == reference["tokens"]
    # each replica's mesh card: one CPU device, no card memory, its KV pool
    for mesh in cluster["mesh"]:
        assert (mesh["tag"], mesh["num_devices"], mesh["per_device_hbm_bytes"]) == (
            "tp=1", 1, [None])
        assert mesh["kv_pool_bytes_per_device"] > 0


def test_autoscaling_reaches_min_replicas(cluster, reference):
    assert cluster["auto_running"] == 2
    assert cluster["auto"] == reference["tokens"][:2]


def test_prefix_affinity_gives_the_exact_hit_count(cluster, reference):
    """Four serial requests sharing a 16-token prefix, routed with
    prefix_affinity_tokens=8 over empty queues: all land on the ring's
    replica, which computes the prefix once, so the deployment's hits are
    the one reference replica's, 16 x 3."""
    assert cluster["affine"] == reference["affine"]
    assert sorted(cluster["affine_requests"].values()) == [0, 4]
    assert sum(cluster["affine_hits"].values()) == reference["affine_hits"] == 48


def test_stream_gives_the_reference_items(cluster, reference):
    assert cluster["stream"] == reference["stream"]


def test_adapter_named_by_multiplexed_model_id(cluster, reference):
    """serve's multiplexed model id reaches the replica's request thread,
    where the server reads it as the request's adapter: the reference's
    tokens for adapter t1, not the base model's."""
    assert cluster["adapter"] == reference["adapter"]
    assert cluster["adapter_base"] == reference["tokens"][0] != cluster["adapter"]
    assert cluster["adapter_stats"]["slots_pinned"] == 0


def test_tensor_parallel_replica_matches_tp1(cluster, reference):
    assert cluster["tp"] == reference["tokens"]
    assert (cluster["tp_mesh"]["tag"], cluster["tp_mesh"]["num_devices"]) == ("tp=2", 2)


def test_roles_in_local_mode_match_reference(weights):
    """tests/test_kvtier.py's run_local of roles={"prefill": 1, "decode":
    1} on both packages, each with a shared LocalTierBackend: the
    disaggregated tokens equal the fused ones and the reference's, the
    decode side adopts what the prefill side shipped (the same counts) and
    computes no prefill token."""
    from ray_tpu.kvtier import LocalTierBackend as JaxBackend
    from ray_tpu.llm.serving import build_llm_deployment as jax_build
    from ray_tpu.serve.local_mode import run_local as jax_run_local
    from ray_tpu_torch.kvtier import LocalTierBackend
    from ray_tpu_torch.serve.local_mode import run_local

    roles = {"prefill": 1, "decode": 1}
    jcfg, tcfg = _cfgs(roles=roles)
    request = _req(list(range(1, 21)))
    jd = jax_run_local(jax_build(jcfg, params_blob=weights["jblob"],
                                 tier_backend=JaxBackend()), name="disagg")
    td = run_local(build_llm_deployment(tcfg, params_blob=weights["blob"],
                                        tier_backend=LocalTierBackend(), device="cpu"),
                   name="disagg")
    tf = run_local(build_llm_deployment(dataclasses.replace(tcfg, roles=None),
                                        params_blob=weights["blob"], device="cpu"),
                   name="fused")
    got, want = td.remote(dict(request)).result(), jd.remote(dict(request)).result()
    assert got == want
    assert got["token_ids"] == tf.remote(dict(request)).result()["token_ids"]
    decode = td._instances["llama-tiny-decode"]
    jdecode = jd._instances["llama-tiny-decode"]
    stats, jstats = decode.kvcache_stats(), jdecode.kvcache_stats()
    keys = ("adopted_blocks", "prefill_tokens_computed", "prefix_hit_tokens", "requests")
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["adopted_blocks"] >= 2 and stats["prefill_tokens_computed"] == 0
    assert decode.kvtier_stats()["role"] == "decode"
    assert td._instances["llama-tiny-prefill"].kvtier_stats()["role"] == "prefill"


def test_refusals_name_their_items(weights):
    """Roles over a cluster need GcsTierBackend (ROADMAP A item 15); the
    weight plane (item 16) and tokenizers raise; a replica whose lease
    names no card, not given device="cpu", raises instead of running on
    card 0 or the CPU."""
    _, tcfg = _cfgs(roles={"prefill": 1, "decode": 1})
    with pytest.raises(NotImplementedError, match="item 15"):
        build_llm_deployment(tcfg, params_blob=weights["blob"], device="cpu")
    _, plain = _cfgs()
    with pytest.raises(NotImplementedError, match="item 16"):
        publish_llm_weights(plain, weights["tparams"])
    with pytest.raises(NotImplementedError, match="item 16"):
        _LLMReplica(plain, weights_name="w", device="cpu")
    with pytest.raises(NotImplementedError, match="download"):
        _LLMReplica(plain, tokenizer_name="t", device="cpu")
    with pytest.raises(RuntimeError, match="names 0 card"):
        _LLMReplica(plain, params_blob=weights["blob"])
    server = LLMServer(plain, params=weights["tparams"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        server.reload_weights()
    assert server.warmup()["weights_version"] is None
    server.reconfigure({"weights_version": 3})  # ignored, as the reference's without a plane


def test_predictor_takes_params_blob_as_reference(weights):
    jcfg, tcfg = _cfgs()
    batch = {"token_ids": PROMPTS}
    want = JaxPredictor(jcfg, params_blob=weights["jblob"])(batch)["generated"]
    got = LLMPredictor(tcfg, params_blob=weights["blob"], device="cpu")(batch)["generated"]
    assert got == want
    with pytest.raises(NotImplementedError, match="item 16"):
        LLMPredictor(tcfg, weights_name="w", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        LLMPredictor(tcfg, params=weights["tparams"], params_blob=weights["blob"], device="cpu")
