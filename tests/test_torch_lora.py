"""ray_tpu_torch's multi-tenant LoRA plane against ray_tpu's on the CPU.

Both sides run the tiny Llama (2 layers) in float32 on the reference's
PRNGKey(0) weights, carried across by params_from_jax, with rank-4 adapters
drawn from numpy seeds at a scale that moves the tiny model's argmaxes, so
every tenant's greedy trajectory is its own. At temperature 0 every token
must be equal; the adapter store's counters, the KV cache's counters and
the slot bank's rows must be equal exactly.

Every engine test sends the SAME prompt to several tenants: the prefix
cache salts its keys per tenant, and a single call site that missed the
salt would let one tenant reuse another's K/V and split the tokens.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._internal import serialization
from ray_tpu.kvcache import KVCacheManager as JaxKVCacheManager
from ray_tpu.llm import GenerationRequest as JaxRequest
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMPredictor as JaxPredictor
from ray_tpu.llm.engine import ContinuousBatchingEngine as JaxCBEngine
from ray_tpu.llm.serving import _LLMReplica
from ray_tpu.lora import AdapterStore as JaxAdapterStore
from ray_tpu.lora import adapter_target_paths as jax_target_paths
from ray_tpu.models.llama import Llama as JaxLlama
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import LoRADense as JaxLoRADense
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch.exceptions import BackPressureError
from ray_tpu_torch.kvcache import KVCacheManager
from ray_tpu_torch.llm import (
    ContinuousBatchingEngine,
    GenerationRequest,
    LLMConfig,
    LLMEngine,
    LLMPredictor,
    LLMServer,
)
from ray_tpu_torch.lora import AdapterStore, adapter_target_paths, publish_adapter
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import (
    PROJECTIONS,
    LlamaConfig,
    LoRADense,
    build_llama,
    gather_adapters,
)

MAX_SEQ, BS, SLOTS, RANK, ALPHA = 64, 8, 4, 4, 8.0
PROMPT = list(range(5, 24))  # 19 tokens: two full blocks and 3
OTHER = list(range(100, 111))
TENANTS = ("t1", "t2", "t3")


def _cfgs(**kw):
    return (JaxLlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=jnp.float32, n_kv_heads=2, **kw),
            LlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=torch.float32, n_kv_heads=2, **kw))


def _tree(cfg, seed, rank=RANK, scale=0.5, skip=()):
    """A nested adapter tree with numpy leaves (the reference's form), in
    train/lora.py's leaf naming; projections in ``skip`` are left out."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, d_in, d_out in jax_target_paths(cfg):
        if "/".join(path) in skip:
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {
            "lora_a": rng.normal(0.0, scale, (d_in, rank)).astype(np.float32),
            "lora_b": rng.normal(0.0, scale, (rank, d_out)).astype(np.float32),
        }
    return tree


def _flat_dotted(tree, prefix=""):
    """The port's flat form of a tree: dotted keys, torch leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(v)
    return out


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jdcfg, tdcfg = _cfgs(n_layers=1)
    jparams = unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    drand = unbox_params(jax_init_params(jdcfg, jax.random.PRNGKey(1)))
    trees = {t: _tree(jcfg, seed) for seed, t in enumerate(TENANTS, start=1)}

    def port(p, cfg):
        return params_from_jax(jax.tree_util.tree_map(np.asarray, p), cfg, device="cpu")

    return dict(jcfg=jcfg, tcfg=tcfg, jdcfg=jdcfg, tdcfg=tdcfg, jparams=jparams,
                tparams=port(jparams, tcfg), jdrand=drand, tdrand=port(drand, tdcfg),
                trees=trees)


def _stores(models, max_live=3, prewarm=TENANTS, source=None, jdtype=jnp.float32,
            tdtype=torch.float32):
    ref = JaxAdapterStore(models["jcfg"], max_live=max_live, rank=RANK, alpha=ALPHA,
                          source=source, param_dtype=jdtype)
    port = AdapterStore(models["tcfg"], max_live=max_live, rank=RANK, alpha=ALPHA,
                        source=source, param_dtype=tdtype, device="cpu")
    for t in prewarm:
        ref.prewarm(t, models["trees"][t])
        port.prewarm(t, models["trees"][t])
    return ref, port


def _stats(store):
    """stats() without the attach time, a wall-clock reading."""
    return {k: v for k, v in store.stats().items() if k != "last_attach_ms"}


# ---------------------------------------------------------------------------
# the store


def test_target_paths_match_reference(models):
    assert adapter_target_paths(models["tcfg"]) == jax_target_paths(models["jcfg"])
    with pytest.raises(NotImplementedError, match="weight plane"):
        publish_adapter("p", "t1", models["trees"]["t1"])


# each op: (what, adapter id, lease name); every op runs on both stores and
# their stats and lease slots must then be equal
_SEQUENCES = {
    "acquire_hit": (3, [("acquire", "t1", "a"), ("acquire", "t1", "b"), ("release", None, "a"),
                        ("acquire", "t2", "c"), ("release", None, "b"), ("release", None, "c")]),
    "lru_evict": (2, [("acquire", "t1", "a"), ("acquire", "t2", "b"), ("release", None, "b"),
                      ("release", None, "a"), ("acquire", "t3", "c"), ("acquire", "t2", "d")]),
    "all_pinned_gives_none": (2, [("acquire", "t1", "a"), ("acquire", "t2", "b"),
                                  ("none", "t3", None), ("release", None, "a"),
                                  ("acquire", "t3", "c")]),
    "failed_refill_rolls_back": (2, [("acquire", "t1", "a"), ("acquire", "t2", "b"),
                                     ("release", None, "b"), ("raises", "boom", RuntimeError),
                                     ("acquire", "t3", "c"), ("release", None, "c"),
                                     ("raises", "unknown", KeyError)]),
    "rank_mismatch": (2, [("acquire", "t1", "a"), ("raises", "rank2", ValueError),
                          ("acquire", "t1", "b")]),
    "idempotent_release": (2, [("acquire", "t1", "a"), ("release", None, "a"),
                               ("release", None, "a"), ("release_none", None, None),
                               ("acquire", "t1", "b")]),
}


@pytest.mark.parametrize("case", list(_SEQUENCES))
def test_store_sequences_match_reference(models, case):
    max_live, ops = _SEQUENCES[case]
    jcfg = models["jcfg"]
    trees = dict(models["trees"], rank2=_tree(jcfg, 9, rank=2))

    def source(aid):
        if aid == "boom":
            raise RuntimeError("refill failed")
        return trees[aid]  # KeyError for an unknown adapter

    stores = _stores(models, max_live=max_live, prewarm=(), source=source)
    leases = [{}, {}]
    for what, aid, arg in ops:
        for store, mine in zip(stores, leases):
            if what == "acquire":
                mine[arg] = store.acquire(aid)
                assert mine[arg] is not None
            elif what == "none":
                assert store.acquire(aid) is None
            elif what == "raises":
                with pytest.raises(arg):
                    store.acquire(aid)
            elif what == "release":
                store.release(mine[arg])
            else:
                store.release(None)
        assert _stats(stores[1]) == _stats(stores[0]), (case, what, aid)
        assert {k: v.slot for k, v in leases[1].items()} == \
            {k: v.slot for k, v in leases[0].items()}
    if case == "rank_mismatch":
        with pytest.raises(ValueError, match="slot_rank"):
            stores[1].acquire("x", tree=trees["rank2"])


@pytest.mark.parametrize("form", ["nested", "flat_dotted", "params_root", "missing_wv"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slot_rows_equal_reference_bank_rows(models, form, dtype):
    """A normalized slot row, lora_b pre-scaled by alpha/rank in f32 and
    cast to the bank's dtype, equals the reference's bank row exactly; the
    port also takes its own flat form (split_lora's, a TorchTrainer LoRA
    checkpoint's), and a missing projection is a zero row."""
    jcfg = models["jcfg"]
    skip = ("layer_1/attn/wv",) if form == "missing_wv" else ()
    tree = _tree(jcfg, 5, skip=skip)
    port_tree = {"flat_dotted": _flat_dotted(tree), "params_root": {"params": tree}}.get(form, tree)
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref, port = _stores(models, max_live=2, prewarm=(), jdtype=jdtype, tdtype=tdtype)
    lr, lp = ref.acquire("x", tree=tree), port.acquire("x", tree=port_tree)
    assert lr.slot == lp.slot
    bank = port.bank()
    for i in range(jcfg.n_layers):
        for name in PROJECTIONS:
            for factor in ("lora_a", "lora_b"):
                want = np.asarray(ref.bank()[f"layer_{i}"]["attn"][name][factor][lr.slot]
                                  .astype(jnp.float32))
                got = bank[name][factor][i, lp.slot].float().numpy()
                np.testing.assert_array_equal(got, want)
                if form == "missing_wv" and (i, name) == (1, "wv"):
                    assert not got.any()
    for name in PROJECTIONS:  # the last row, slot -1's, stays zero
        assert not bank[name]["lora_a"][:, -1].any() and not bank[name]["lora_b"][:, -1].any()


# ---------------------------------------------------------------------------
# the batched gather and the model


def test_lora_dense_gather_matches_reference():
    rng = np.random.default_rng(3)
    n, d_in, d_out = 3, 16, 24
    x = rng.normal(size=(3, 5, d_in)).astype(np.float32)
    w = rng.normal(size=(d_in, d_out)).astype(np.float32)
    bank_a = rng.normal(size=(n, d_in, RANK)).astype(np.float32)
    bank_b = rng.normal(size=(n, RANK, d_out)).astype(np.float32)
    slots = [2, -1, 0]
    ref = JaxLoRADense(features=d_out, logical_axes=("embed", "heads"), rank=0, alpha=ALPHA,
                       param_dtype=jnp.float32, dtype=jnp.float32).apply(
        {"params": {"base": {"kernel": w}}}, jnp.asarray(x),
        {"lora_a": jnp.asarray(bank_a), "lora_b": jnp.asarray(bank_b)},
        jnp.asarray(slots, jnp.int32))
    # the port's bank: one layer, the zero row last
    zero = lambda t: torch.cat([torch.from_numpy(t), torch.zeros_like(torch.from_numpy(t[:1]))])  # noqa: E731
    bank = {p: {"lora_a": zero(bank_a)[None], "lora_b": zero(bank_b)[None]} for p in PROJECTIONS}
    rows = gather_adapters(bank, slots, torch.float32, torch.device("cpu"))
    dense = LoRADense(d_in, d_out, 0, ALPHA, torch.float32, torch.float32)
    dense.base.kernel.data = torch.from_numpy(w)
    got = dense(torch.from_numpy(x), (rows["wq"][0][0], rows["wq"][1][0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # the base row is exactly the base output
    assert torch.equal(got[1], dense(torch.from_numpy(x))[1])
    with pytest.raises(ValueError, match="adapter slots"):
        gather_adapters(bank, [3], torch.float32, torch.device("cpu"))


def test_llama_logits_with_mixed_slots_match_reference(models):
    ref_store, port_store = _stores(models)
    slots = [port_store.acquire(t).slot for t in TENANTS] + [-1]
    assert slots == [ref_store.acquire(t).slot for t in TENANTS] + [-1]
    tokens = np.random.default_rng(4).integers(0, 256, (4, 12))
    ref = JaxLlama(models["jcfg"]).apply({"params": models["jparams"]}, jnp.asarray(tokens),
                                         ref_store.bank(), jnp.asarray(slots, jnp.int32))
    model = build_llama(models["tcfg"], models["tparams"])
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), None, port_store.bank(), slots)
        base = model(torch.from_numpy(tokens))
        # the same adapters as static LoRADense weights, one model a tenant
        static_cfg = dataclasses.replace(models["tcfg"], lora_rank=RANK, lora_alpha=ALPHA)
        for row, t in enumerate(TENANTS):
            lora = {k.replace("/", "."): v for k, v in _flat_dotted(models["trees"][t]).items()}
            static = build_llama(static_cfg, {**models["tparams"], **lora})
            want = static(torch.from_numpy(tokens[row:row + 1]))[0]
            # f32 on both paths, scale applied before or after the product
            assert torch.allclose(got[row], want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    assert torch.equal(got[3], base[3])  # a base row adds exactly zero
    assert all((got[r] - base[r]).abs().max() > 0.1 for r in range(3))


# ---------------------------------------------------------------------------
# the engines


def _requests(cls, store, tenants, prompts, max_new=8):
    """One request per (tenant, prompt), each stamped with its lease's slot
    (the leases are released by the caller)."""
    reqs, leases = [], []
    for t, p in zip(tenants, prompts):
        lease = store.acquire(t) if t is not None else None
        leases.append(lease)
        reqs.append(cls(token_ids=list(p), max_new_tokens=max_new, adapter_id=t,
                        adapter_slot=lease.slot if lease else -1))
    return reqs, leases


_ENGINES = {"paged": {}, "chunked": {"prefill_chunk_tokens": 8}, "spec": {"spec_tokens": 3}}
# the same prompt across tenants and the base, twice: the second wave hits
# each key space's cached prefix
_WAVE = (["t1", "t2", None, "t3", "t1"], [PROMPT, PROMPT, PROMPT, PROMPT, OTHER])


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_engine_matches_reference_across_tenants(models, kind):
    kw = dict(_ENGINES[kind])
    outs, stats, stores = [], [], _stores(models)
    for side, (eng_cls, kv_cls, req_cls, store) in enumerate((
        (JaxCBEngine, JaxKVCacheManager, JaxRequest, stores[0]),
        (ContinuousBatchingEngine, KVCacheManager, GenerationRequest, stores[1]),
    )):
        p, extra = ("jparams", "jdrand", "jcfg", "jdcfg"), {}
        if side == 1:
            p, extra = ("tparams", "tdrand", "tcfg", "tdcfg"), {"device": "cpu"}
        if kind == "spec":
            extra["draft"] = (models[p[3]], models[p[1]])
        kv = kv_cls(num_blocks=48, block_size=BS)
        eng = eng_cls(models[p[2]], models[p[0]], num_slots=SLOTS, kv_cache=kv, seed=7,
                      adapter_store=store, **kw, **extra)
        got = []
        for _ in range(2):
            reqs, leases = _requests(req_cls, store, *_WAVE)
            got.append([r.token_ids for r in eng.generate(reqs)])
            for lease in leases:
                store.release(lease)
        outs.append(got)
        stats.append(kv.stats())
        if side == 1:
            assert eng.num_active == 0 and kv.blocks_in_use == kv.stats()["index_nodes"]
    assert outs[1] == outs[0]
    for key in ("requests", "hits", "prefix_hit_tokens", "prefill_tokens_computed",
                "blocks_in_use", "index_nodes"):
        assert stats[1][key] == stats[0][key], key
    # 4 key spaces (t1, t2, t3, base) share no prefix: the second wave hits
    # PROMPT's two blocks in each of them, and OTHER's one block in t1's
    assert stats[1]["prefix_hit_tokens"] == 4 * 16 + 8
    first = outs[1][0]
    assert first[0] != first[2] and first[0] != first[1]  # adapters move the tokens
    assert outs[1][1] == first  # hits give the same tokens


def test_mixed_batch_equals_each_tenant_alone(models):
    """A mixed batch on the paged engine, each row against its tenant
    served alone through the dense engine with the same store (the dense
    engine's adapter path), and against LLMEngine without a store for the
    base rows."""
    _, store = _stores(models)
    tenants, prompts = ["t1", None, "t2", "t3", "t2", None], [PROMPT, PROMPT, PROMPT, OTHER,
                                                             OTHER, OTHER]
    eng = ContinuousBatchingEngine(models["tcfg"], models["tparams"], num_slots=SLOTS,
                                   kv_cache=KVCacheManager(48, BS), adapter_store=store,
                                   device="cpu")
    reqs, leases = _requests(GenerationRequest, store, tenants, prompts, 10)
    mixed = [r.token_ids for r in eng.generate(reqs)]
    dense = LLMEngine(models["tcfg"], models["tparams"], adapter_store=store, device="cpu")
    alone = [dense.generate([r])[0].token_ids for r in reqs]
    streamed = list(dense.generate_stream(reqs[2]))[:-1]
    for lease in leases:
        store.release(lease)
    assert mixed == alone and streamed == alone[2]
    plain = LLMEngine(models["tcfg"], models["tparams"], device="cpu")
    assert plain.generate([reqs[1]])[0].token_ids == mixed[1]
    assert store.stats()["slots_pinned"] == 0


def test_base_only_calls_skip_the_adapter_path(models, monkeypatch):
    """A call whose rows are all base is the call of an engine without a
    store: the bank is never read."""
    _, store = _stores(models)
    eng = ContinuousBatchingEngine(models["tcfg"], models["tparams"], num_slots=2,
                                   kv_cache=KVCacheManager(16, BS), adapter_store=store,
                                   device="cpu")
    reads = []
    monkeypatch.setattr(store, "bank", lambda: reads.append(1) or AdapterStore.bank(store))
    eng.generate([GenerationRequest(token_ids=OTHER, max_new_tokens=4)])
    assert reads == []
    reqs, leases = _requests(GenerationRequest, store, ["t1"], [OTHER], 4)
    eng.generate(reqs)
    store.release(leases[0])
    assert len(reads) == eng.forward_calls - 4  # every call of the adapter request
    # a row that names a slot on an engine without a store is refused, not
    # served by the base model
    plain = ContinuousBatchingEngine(models["tcfg"], models["tparams"], num_slots=2,
                                     device="cpu")
    with pytest.raises(ValueError, match="no adapter_store"):
        plain.generate([GenerationRequest(token_ids=OTHER, max_new_tokens=2, adapter_slot=0)])


# ---------------------------------------------------------------------------
# the server and the batch predictor


def _source(models):
    return lambda aid: models["trees"][aid]


def test_server_with_adapters_answers_like_replica(models):
    kw = dict(model_id="llama-tiny", max_seq_len=MAX_SEQ, seed=0, kv_cache_blocks=32,
              kv_block_size=BS, max_batch_size=2)
    adapters = dict(max_live=2, slot_rank=RANK, alpha=ALPHA, source=_source(models))
    jcfg = JaxLLMConfig(**kw, adapters=adapters, model_kwargs={"dtype": jnp.float32, "n_kv_heads": 2})
    tcfg = LLMConfig(**kw, adapters=adapters, model_kwargs={"dtype": torch.float32, "n_kv_heads": 2})
    replica = _LLMReplica(jcfg, params_blob=serialization.dumps(models["jparams"]))
    server = LLMServer(tcfg, params=models["tparams"], device="cpu")
    # t3 evicts t1 (max_live 2); t1 then refills cold
    for aid in ("t1", "t2", None, "t3", "t1"):
        request = {"token_ids": PROMPT, "max_new_tokens": 5, "adapter_id": aid}
        assert server(request) == replica(request), aid
        assert _stats(server.adapter_store) == _stats(replica._adapter_store), aid
    request = {"token_ids": PROMPT, "max_new_tokens": 5, "adapter_id": "t2"}
    assert list(server.stream(request)) == list(replica.stream(request))
    assert server.adapters_stats()["slots_pinned"] == 0
    ref_stats, stats = replica.kvcache_stats(), server.kvcache_stats()
    for key in ("requests", "hits", "prefix_hit_tokens", "prefill_tokens_computed",
                "blocks_in_use", "index_nodes"):
        assert stats[key] == ref_stats[key], key
    with pytest.raises(ValueError, match="adapter plane"):
        LLMServer(LLMConfig(**kw), device="cpu")({"token_ids": PROMPT, "adapter_id": "t1"})


def test_predictor_per_row_adapters_match_reference(models):
    kw = dict(model_id="llama-tiny", max_seq_len=MAX_SEQ, max_new_tokens=6, kv_cache_blocks=16,
              max_batch_size=4)
    adapters = dict(max_live=2, slot_rank=RANK, alpha=ALPHA, source=_source(models))
    jcfg = JaxLLMConfig(**kw, adapters=adapters, model_kwargs={"dtype": jnp.float32, "n_kv_heads": 2})
    tcfg = LLMConfig(**kw, adapters=adapters, model_kwargs={"dtype": torch.float32, "n_kv_heads": 2})
    ref = JaxPredictor(jcfg, params_blob=serialization.dumps(models["jparams"]))
    pred = LLMPredictor(tcfg, params=models["tparams"], device="cpu")
    batch = {"token_ids": [PROMPT, PROMPT, OTHER, PROMPT, OTHER],
             "adapter_id": ["t1", None, "t2", "t2", ""]}
    want, got = ref(batch), pred(batch)
    assert got["generated"] == want["generated"]
    assert got["generated"][0] != got["generated"][1]
    assert _stats(pred.adapter_store) == _stats(ref._adapter_store)
    assert pred.adapter_store.stats()["slots_pinned"] == 0
    too_many = {"token_ids": [OTHER] * 3, "adapter_id": list(TENANTS)}
    for p in (ref, pred):
        with pytest.raises(RuntimeError, match="max_live"):
            p(too_many)
    assert _stats(pred.adapter_store) == _stats(ref._adapter_store)
    # params_blob is read as the reference reads it (tests/
    # test_torch_llm_deployment.py); weights_name rides the weight plane
    with pytest.raises(NotImplementedError, match="weight plane"):
        LLMPredictor(tcfg, device="cpu", weights_name="x")


# ---------------------------------------------------------------------------
# backpressure and threads


def test_backpressure_after_acquire_timeout(models):
    cfg = LLMConfig(model_id="llama-tiny", max_seq_len=MAX_SEQ, kv_cache_blocks=16,
                    kv_block_size=BS, model_kwargs={"dtype": torch.float32, "n_kv_heads": 2},
                    adapters=dict(max_live=1, slot_rank=RANK, alpha=ALPHA,
                                  source=_source(models), acquire_timeout_s=0.2))
    server = LLMServer(cfg, params=models["tparams"], device="cpu")
    pinned = server.adapter_store.acquire("t1")
    t0 = time.monotonic()
    with pytest.raises(BackPressureError, match="slots pinned"):
        server({"token_ids": OTHER, "max_new_tokens": 2, "adapter_id": "t2"})
    assert time.monotonic() - t0 >= 0.2
    server.adapter_store.release(pinned)
    out = server({"token_ids": OTHER, "max_new_tokens": 2, "adapter_id": "t2"})
    assert len(out["token_ids"]) == 2
    assert server.adapters_stats()["resident"] == ["t2"]


def test_cold_attach_does_not_stall_decodes(models):
    """A cold attach (a slow refill, then the write of its slot's rows) on
    one thread while another steps the pool: every step emits one token,
    the steps go on while the attach holds the store's lock, and the
    tokens are those of the same request served with no attach at all."""
    entered, release = threading.Event(), threading.Event()

    def slow_source(aid):
        entered.set()
        release.wait(timeout=30)  # an attach in flight, under the store's lock
        return models["trees"]["t3"]

    _, store = _stores(models, max_live=2, prewarm=("t1",), source=slow_source)
    eng = ContinuousBatchingEngine(models["tcfg"], models["tparams"], num_slots=2,
                                   kv_cache=KVCacheManager(16, BS), seed=0,
                                   adapter_store=store, device="cpu")
    reqs, leases = _requests(GenerationRequest, store, ["t1"], [PROMPT], 30)
    want = LLMEngine(models["tcfg"], models["tparams"], adapter_store=store,
                     device="cpu").generate(reqs)[0].token_ids
    rid = eng.add_request(reqs[0])
    eng.step()
    slot = next(iter(eng._slots.values()))
    got = []
    attach = threading.Thread(target=lambda: got.append(store.acquire("cold")))
    attach.start()
    assert entered.wait(timeout=30)
    for _ in range(5):  # the attach holds the store's lock all along
        before = len(slot.generated)
        eng.step()
        assert len(slot.generated) == before + 1, "decode gapped"
    release.set()  # the refill returns; its slot's rows are written meanwhile
    while attach.is_alive() and len(slot.generated) < 29:
        before = len(slot.generated)
        eng.step()
        assert len(slot.generated) == before + 1, "decode gapped"
    attach.join(timeout=30)
    assert not attach.is_alive() and got and got[0] is not None
    assert eng.run_until_complete()[rid].token_ids == want
    store.release(got[0])
    store.release(leases[0])
    assert store.stats()["resident"] == ["cold", "t1"]


@pytest.mark.parametrize("where", ["pending", "prefilling", "slot"])
def test_cancel_drops_a_request_wherever_it_is(models, where):
    """cancel() drops a pending request, a chunked prefill in progress or a
    decoding row: the engine holds no trace of it and no KV pin, and the
    other request's tokens are those it gets alone."""
    kv = KVCacheManager(16, BS)
    eng = ContinuousBatchingEngine(models["tcfg"], models["tparams"], num_slots=1,
                                   kv_cache=kv, seed=0, prefill_chunk_tokens=8, device="cpu")
    reqs = [GenerationRequest(token_ids=PROMPT, max_new_tokens=6),
            GenerationRequest(token_ids=OTHER, max_new_tokens=4)]
    rids = [eng.add_request(r) for r in reqs]
    eng.step()  # the first prompt is 8 of 19 tokens in; the second waits
    assert list(eng._prefilling) == [0] and len(eng._pending) == 1
    if where == "slot":
        while not eng._slots:
            eng.step()
    gone = 1 if where == "pending" else 0
    leases = [slot.lease for slot in eng._slots.values()] + [
        st["lease"] for st in eng._prefilling.values()]
    eng.cancel(rids[gone])
    assert eng.num_active == 1
    assert all(lease.closed for lease in leases) == (where != "pending")
    kept = 1 - gone
    out = eng.run_until_complete()
    alone = LLMEngine(models["tcfg"], models["tparams"], device="cpu").generate([reqs[kept]])
    assert list(out) == [rids[kept]] and out[rids[kept]].token_ids == alone[0].token_ids
    assert eng.num_active == 0 and kv.blocks_in_use == kv.stats()["index_nodes"]


def test_closed_stream_is_cancelled_before_its_slot_is_reused(models):
    """A tenant closes its stream after one token. Its request must leave
    the pool before the adapter lease is released: the store may then
    evict the slot and write another tenant's adapter into it in place, and
    a request still decoding there would compute (and cache, under the
    first tenant's salted keys) K/V with the other tenant's adapter."""
    kw = dict(model_id="llama-tiny", max_seq_len=MAX_SEQ, seed=0, kv_cache_blocks=32,
              kv_block_size=BS, max_batch_size=2,
              model_kwargs={"dtype": torch.float32, "n_kv_heads": 2},
              adapters=dict(max_live=1, slot_rank=RANK, alpha=ALPHA, source=_source(models)))
    server = LLMServer(LLMConfig(**kw), params=models["tparams"], device="cpu")
    fresh = LLMServer(LLMConfig(**kw), params=models["tparams"], device="cpu")
    items = server.stream({"token_ids": PROMPT, "max_new_tokens": 20, "adapter_id": "t1"})
    first = next(items)["token_id"]
    items.close()
    assert server.engine.num_active == 0
    assert server.adapters_stats()["slots_pinned"] == 0
    stats = server.kvcache_stats()
    assert stats["blocks_in_use"] == stats["index_nodes"]
    # t2 evicts t1 from the one slot and is written into it in place
    server({"token_ids": OTHER, "max_new_tokens": 3, "adapter_id": "t2"})
    assert server.adapters_stats()["evictions"] == 1
    cont = fresh({"token_ids": PROMPT, "max_new_tokens": 20, "adapter_id": "t1"})["token_ids"]
    assert cont[0] == first
    for n in (1, 5, 13):  # follow-ups that extend the streamed text
        request = {"token_ids": PROMPT + cont[:n], "max_new_tokens": 4, "adapter_id": "t1"}
        assert server(request) == fresh(request), n


def test_no_card_means_error_for_the_store_and_the_predictor(models, monkeypatch):
    """The store and the predictor default to the card: without one they
    raise, they do not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdapterStore(models["tcfg"], max_live=2, rank=RANK)
    cfg = LLMConfig(model_id="llama-tiny", max_seq_len=MAX_SEQ, kv_cache_blocks=4,
                    adapters={"max_live": 2, "slot_rank": RANK})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMPredictor(cfg, params=models["tparams"])
    assert AdapterStore(models["tcfg"], max_live=2, rank=RANK, device="cpu").device.type == "cpu"
