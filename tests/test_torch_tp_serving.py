"""The port's tensor-parallel serving (ray_tpu_torch.parallel and
llm/tp_ranks.py) against ray_tpu's (tests/test_tp_serving.py), on the CPU.

Both sides take the reference test's inputs: ``LlamaConfig.tiny(max_seq_len
=128)`` with the reference's ``PRNGKey(0)`` weights (carried over by
``params_from_jax`` and sliced per rank by the plan), 32 KV blocks of 16, 4
slots, seed 7, prompts of 17/33/21 tokens and then a warm one of 32 shared +
5 tokens. Activations are f32 on both sides, as in test_torch_llm.py, so
that greedy argmax ties in bf16 cannot split the token streams.

The port's tp=2 servers are two gloo ranks on the CPU: this process is rank
0 and rank 1 is spawned. A process holds one such server at a time (it
forms the process's default process group), so the dense server lives in
its own test and the paged one is built once for the rest of the module;
every child process is joined within ``_DEADLINE_S`` when a server closes.
Variants (chunked prefill, speculation, prefill logits) run on every rank
of the paged server through ``TPRanks.run``. The reference's tp=2 runs on
two of the host devices that conftest makes.
"""

import multiprocessing
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu import exceptions as jax_exceptions
from ray_tpu.kvcache import KVCacheManager as JaxKVCacheManager
from ray_tpu.llm.engine import ContinuousBatchingEngine as JaxCBEngine
from ray_tpu.llm.engine import GenerationRequest as JaxRequest
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.plan import DEFAULT_LLM_RULES as JAX_RULES
from ray_tpu.parallel.plan import PartitionPlan as JaxPlan
from ray_tpu.parallel.plan import match_partition_rules as jax_match_partition_rules
from ray_tpu.parallel.sharding import logical_to_spec as jax_logical_to_spec
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch.exceptions import MeshValidationError
from ray_tpu_torch.kvcache import KVCacheManager
from ray_tpu_torch.llm import ContinuousBatchingEngine, GenerationRequest, LLMConfig, LLMServer
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import Llama, LlamaConfig, param_shapes
from ray_tpu_torch.parallel import (
    DEFAULT_LLM_RULES,
    KV_SPEC,
    PartitionPlan,
    local_batch_size,
    logical_to_spec,
    make_mesh,
    match_partition_rules,
    validate_mesh_for_model,
)
from ray_tpu_torch.util import metrics, tracing

_DEADLINE_S = 60.0
_SEED = 7
_BLOCKS, _BLOCK = 32, 16
_NEW = 8
_CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    """Two CPU ranks on this host: one intra-op thread each (a spawned CPU
    rank takes rank 0's count), else the idle threads of one rank spin
    beside the other's compute and a step takes twenty times as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _EARLIER_CHILDREN.update(multiprocessing.active_children())
    yield
    torch.set_num_threads(threads)


def _jax_flat(tree, sep="."):
    return {sep.join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}


def _prompts():
    rng = np.random.RandomState(0)
    prompts = [list(map(int, rng.randint(0, 256, size=n))) for n in (17, 33, 21)]
    warm = prompts[1][:32] + list(map(int, rng.randint(0, 256, size=5)))
    return prompts, warm


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxLlamaConfig.tiny(max_seq_len=128, dtype=jnp.float32)
    jparams = unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = LlamaConfig.tiny(max_seq_len=128, dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's tp=2 paged engine and tp=2 dense engine, and their
    tokens for the cold prompts and the warm one, with the paged KV
    manager's stats around the warm request."""
    jcfg, jparams, _, _ = weights
    plan = JaxPlan.for_model(jcfg, 2)
    kv = JaxKVCacheManager(num_blocks=_BLOCKS, block_size=_BLOCK, plan=plan)
    paged = JaxCBEngine(jcfg, jparams, plan.mesh, num_slots=4, kv_cache=kv, seed=_SEED,
                        plan=plan)
    dense = JaxEngine(jcfg, jparams, plan.mesh, max_batch_size=4, seed=_SEED, plan=plan)
    prompts, warm = _prompts()

    def run(engine, ps):
        return [r.token_ids for r in engine.generate(
            [JaxRequest(list(p), max_new_tokens=_NEW) for p in ps])]

    out = {"paged": run(paged, prompts), "dense": run(dense, prompts)}
    s0 = kv.stats()
    out["paged_warm"] = run(paged, [warm])[0]
    out["warm_stats"] = (s0, kv.stats())
    out["dense_warm"] = run(dense, [warm])[0]
    # the prefill logits of the first prompt, on the paged engine's program
    out["logits"] = np.asarray(paged._prefill(
        paged._params, jnp.asarray([prompts[0]], jnp.int32))[0])
    out["stats"] = kv.stats()
    return out


#: child processes of this one from before the module's tests (other test
#: files run by the same worker may have left some)
_EARLIER_CHILDREN = set()


def _join_children():
    """Every child process a server of this module started, joined within
    the deadline."""
    ours = set(multiprocessing.active_children()) - _EARLIER_CHILDREN
    for p in ours:
        p.join(_DEADLINE_S)
    left = set(multiprocessing.active_children()) - _EARLIER_CHILDREN
    assert not left, f"child processes left: {left}"


def _server(tparams, **kw):
    cfg = LLMConfig(model_id="llama-tiny", max_seq_len=128, max_batch_size=4, seed=_SEED,
                    tensor_parallel_size=2, model_kwargs={"dtype": torch.float32}, **kw)
    return LLMServer(cfg, params=tparams, devices=_CPU2, tp_backend="gloo")


@pytest.fixture(scope="module")
def paged(weights):
    """ONE tp=2 paged server over two gloo ranks, shared by the tests below
    (tests that need fresh KV state read stats() deltas)."""
    server = _server(weights[3], kv_cache_blocks=_BLOCKS, kv_block_size=_BLOCK)
    yield server
    server.close()
    _join_children()


def _ask(server, prompt, **kw):
    return server({"token_ids": list(prompt), "max_new_tokens": _NEW, **kw})["token_ids"]


# -- the plan ----------------------------------------------------------------


def test_rule_table_and_rank_shards_match_reference(weights):
    """For every parameter name (LoRA factors and GQA included) the port's
    spec is the reference's, and each rank's slices equal the reference's
    ``shard_params`` shard on that rank's device exactly."""
    lcfg = JaxLlamaConfig.tiny(max_seq_len=128, lora_rank=4, n_kv_heads=2)
    shapes = unbox_params(jax.eval_shape(lambda: jax_init_params(lcfg, jax.random.PRNGKey(3))))
    want = {k: tuple(v) for k, v in _jax_flat(jax_match_partition_rules(JAX_RULES, shapes)).items()}
    lora_shapes = param_shapes(LlamaConfig.tiny(max_seq_len=128, lora_rank=4, n_kv_heads=2))
    got = {k: tuple(v) for k, v in match_partition_rules(DEFAULT_LLM_RULES, lora_shapes).items()}
    assert got == want
    assert any("lora_b" in k and "tp" in v for k, v in got.items())

    jcfg, jparams, tcfg, tparams = weights
    jplan = JaxPlan.for_model(jcfg, 2)
    plan = PartitionPlan.for_model(tcfg, 2, devices=_CPU2, backend="gloo")
    devices = list(jplan.mesh.devices.flat)
    sharded = _jax_flat(jplan.shard_params(jparams))
    for rank in range(2):
        mine = plan.shard_params(tparams, rank)
        assert {k: v.shape for k, v in mine.items()} == dict(param_shapes(tcfg, plan))
        for name, leaf in sharded.items():
            shard = next(s for s in leaf.addressable_shards if s.device == devices[rank])
            np.testing.assert_array_equal(mine[name].numpy(), np.asarray(shard.data), name)
    # the model's own widths at tp=2 are the plan's slices
    with torch.device("meta"):
        model = Llama(tcfg, plan=plan, group=object())
    assert {k: v.shape for k, v in model.state_dict().items()} == dict(param_shapes(tcfg, plan))


def test_bank_cache_and_logical_specs_match_reference():
    jcfg = JaxLlamaConfig.tiny(max_seq_len=128)
    jplan = JaxPlan.for_model(jcfg, 2)
    plan = PartitionPlan.for_model(LlamaConfig.tiny(max_seq_len=128), 2, devices=_CPU2)
    bank = {f"layer_{i}": {"attn": {p: {"lora_a": jnp.zeros((3, 128, 4)),
                                         "lora_b": jnp.zeros((3, 4, 128))}
                                    for p in ("wq", "wk", "wv", "wo")}} for i in range(2)}
    want = {k: tuple(v) for k, v in _jax_flat(
        jax.tree.map(lambda s: s.spec, jplan.lora_bank_shardings(bank))).items()}
    got = {k: tuple(v) for k, v in plan.lora_bank_shardings(
        jax.tree_util.tree_map(np.asarray, bank)).items()}
    assert got == want
    assert tuple(plan.kv_sharding()) == tuple(jplan.kv_sharding().spec) == tuple(KV_SPEC)
    cache = {"key": torch.zeros(2, 1, 4, 8, 32), "index": torch.zeros(2, 1)}
    assert {k: tuple(v) for k, v in plan.cache_shardings(cache).items()} == {
        "key": (None, None, "tp", None, None), "index": ()}
    for axes in [("batch", "seq", "embed"), ("embed", "mlp"), ("vocab", None), ()]:
        assert tuple(logical_to_spec(axes)) == tuple(jax_logical_to_spec(axes))
    assert plan.describe() == jplan.describe() == "tp=2"
    assert plan.mesh_shape() == jplan.mesh_shape() == {"tp": 2}
    assert local_batch_size(make_mesh(4, fsdp=2, tp=2, devices=["cpu"] * 4), 8) == 4


@pytest.mark.parametrize("args", [(3, 8), (0, 8), (8, 8, 4, 4)],
                         ids=["tp_3_of_8", "tp_0", "heads_not_divisible"])
def test_mesh_validation_typed_errors(args):
    from ray_tpu.parallel.plan import validate_mesh_for_model as jax_validate

    with pytest.raises(jax_exceptions.MeshValidationError) as ref:
        jax_validate(*args)
    with pytest.raises(MeshValidationError) as err:
        validate_mesh_for_model(*args)
    assert str(err.value) == str(ref.value)
    # typed and picklable: a replica's errors cross process boundaries
    clone = pickle.loads(pickle.dumps(err.value))
    assert isinstance(clone, MeshValidationError) and isinstance(clone, ValueError)
    assert str(clone) == str(err.value)


def test_kv_heads_per_rank_shapes_attention_cache_and_pools():
    """The plan's KV head slice is what the attention, the decode cache and
    the block pools of a rank are built with, and query heads keep whole
    GQA groups."""
    from ray_tpu_torch.models.llama import new_cache

    cfg = LlamaConfig.tiny(max_seq_len=128, dtype=torch.float32)
    plan = PartitionPlan.for_model(cfg, 2, devices=_CPU2)
    hk = plan.kv_heads_per_rank(cfg.n_kv_heads)
    assert hk == cfg.n_kv_heads // 2
    with torch.device("meta"):
        attn = Llama(cfg, plan=plan, group=object()).layer_0.attn
    assert (attn.n_kv_heads, attn.n_heads) == (hk, hk * cfg.n_heads // cfg.n_kv_heads)
    assert new_cache(cfg, 3, "cpu", plan).key.shape[2] == hk
    kv = KVCacheManager(_BLOCKS, _BLOCK, plan=plan)
    kv.initialize_for(cfg, "cpu")
    assert kv.pool_accounting()["heads_per_device"] == hk


def test_plan_for_model_validates_like_reference():
    with pytest.raises(jax_exceptions.MeshValidationError):
        JaxPlan.for_model(JaxLlamaConfig.tiny(), 3)
    with pytest.raises(MeshValidationError):  # 3 does not divide 8 devices
        PartitionPlan.for_model(LlamaConfig.tiny(), 3, devices=["cpu"] * 8)
    with pytest.raises(MeshValidationError, match="devices=.*cpu|divide"):
        # one card asked for two ranks: tp does not divide the device count
        PartitionPlan.for_model(LlamaConfig.tiny(), 2, devices=[0])
    # a serving plan refuses sp > 1 on purpose (ROADMAP kept item 32)
    with pytest.raises(NotImplementedError, match="kept item 32"):
        PartitionPlan.for_model(LlamaConfig.tiny(), 2, 2, devices=["cpu"] * 4)


def test_vocab_not_divisible_raises_like_reference():
    """The reference's shard_params refuses a vocabulary tp does not divide
    (JAX's ``device_put`` of an uneven NamedSharding); so does the port."""
    embed = np.zeros((255, 128), np.float32)
    with pytest.raises(ValueError, match="divisible by 2, but it is equal to 255") as ref:
        JaxPlan.for_model(JaxLlamaConfig.tiny(vocab_size=255), 2).shard_params({"embed": embed})
    plan = PartitionPlan.for_model(LlamaConfig.tiny(vocab_size=255), 2, devices=_CPU2)
    with pytest.raises(ValueError, match="divisible by 2, but it is equal to 255") as err:
        plan.shard_params({"embed": torch.from_numpy(embed)})
    assert str(err.value).split("implies")[1] == str(ref.value).split("implies")[1]
    with pytest.raises(ValueError, match="divisible by 2, but it is equal to 255"):
        LLMServer(LLMConfig(model_id="llama-tiny", tensor_parallel_size=2,
                            model_kwargs={"vocab_size": 255}), devices=_CPU2, tp_backend="gloo")
    assert not dist.is_initialized()
    _join_children()


# -- serving -----------------------------------------------------------------


def _stream_lockstep(server, prompt, want):
    """A stream closed early, then a whole one: the ranks stay in step."""
    stream = server.stream({"token_ids": prompt, "max_new_tokens": _NEW})
    assert next(stream)["token_id"] == want[0]
    stream.close()
    assert _ask(server, prompt, stream=True) == want


def test_tp2_dense_matches_reference(weights, reference):
    """The dense engine at tp=2 (LLMServer without a KV pool): the
    reference's tp=2 LLMEngine's greedy tokens, cold and warm, through
    ``generate`` and streams."""
    prompts, warm = _prompts()
    server = _server(weights[3])
    try:
        assert [_ask(server, p) for p in prompts] == reference["dense"] == reference["paged"]
        assert _ask(server, warm) == reference["dense_warm"] == reference["paged_warm"]
        _stream_lockstep(server, warm, reference["dense_warm"])
        assert server.kvcache_stats() is None and server.engine._mesh_tag == "tp=2"
    finally:
        server.close()
    assert not dist.is_initialized()
    _join_children()


def test_tp2_paged_matches_reference(paged, reference):
    """The acceptance bar: greedy tokens of the tp=2 paged server equal the
    reference's tp=2 paged engine, cold and warm, with the warm request's
    KV stats deltas (32 hit, 5 computed) equal too."""
    prompts, warm = _prompts()
    assert [_ask(paged, p) for p in prompts] == reference["paged"]
    s0 = paged.kvcache_stats()
    assert _ask(paged, warm) == reference["paged_warm"]
    s1 = paged.kvcache_stats()
    r0, r1 = reference["warm_stats"]
    for key in ("prefix_hit_tokens", "prefill_tokens_computed", "hits", "misses"):
        assert s1[key] - s0[key] == r1[key] - r0[key], key
    assert s1["prefix_hit_tokens"] - s0["prefix_hit_tokens"] == 32
    assert s1["prefill_tokens_computed"] - s0["prefill_tokens_computed"] == len(warm) - 32
    _stream_lockstep(paged, warm, reference["paged_warm"])


def test_kv_pools_sharded_with_per_device_accounting(paged, reference):
    stats = paged.kvcache_stats()
    want = reference["stats"]
    for key in ("mesh", "num_devices", "heads_per_device", "kv_pool_bytes_total",
                "kv_pool_bytes_per_device", "capacity", "block_size"):
        assert stats[key] == want[key], key
    assert stats["mesh"] == "tp=2" and stats["heads_per_device"] == 2
    assert stats["kv_pool_bytes_per_device"] * 2 == stats["kv_pool_bytes_total"]
    assert paged.engine._kv.pool_accounting()["kv_pool_bytes_per_device"] == sum(
        p.numel() * p.element_size() for p in (paged.engine._kv._pool_k, paged.engine._kv._pool_v))
    # every rank's pool holds its 2 of the 4 KV heads
    assert paged.ranks.run(_pool_shape) == [(2, _BLOCKS, 2, _BLOCK, 32)] * 2


def _pool_shape(engine):
    return tuple(engine._kv._pool_k.shape)


def test_spans_and_metrics_carry_mesh_tag(paged):
    _, warm = _prompts()
    tracing.enable_tracing()
    tracing.clear_spans()
    try:
        ctx = tracing.new_trace_context()
        with tracing.request_span("test.request", ctx):
            _ask(paged, list(range(3, 40)), max_new_tokens=2)
        spans = [s for s in tracing.get_spans() if s["trace_id"] == ctx["trace_id"]]
        tagged = [s for s in spans if s["name"] in ("engine.prefill", "engine.decode")]
        assert {s["name"] for s in tagged} == {"engine.prefill", "engine.decode"}
        assert all(s["args"]["mesh"] == "tp=2" for s in tagged)
    finally:
        tracing._enabled = False
        tracing.clear_spans()
    text = metrics.render_prometheus([metrics.local_payload()])
    for name in ("kvcache_prefix_hit_tokens_total", "kvcache_ttft_ms_count",
                 "serve_itl_seconds_count", "kvcache_blocks_in_use"):
        assert any(line.startswith(name) and 'mesh="tp=2"' in line
                   for line in text.splitlines()), name


def _variant_tokens(engine, kind, prompts):
    """On every rank: a fresh engine of ``kind`` over this rank's slices and
    plan, its greedy tokens and speculative counts."""
    cfg, params = engine._cfg, engine._params
    kw = {"prefill_chunk_tokens": 64} if kind == "chunked" else {
        "draft": (cfg, params), "spec_tokens": 4}
    eng = ContinuousBatchingEngine(cfg, params, num_slots=4, seed=_SEED, device="cpu",
                                   kv_cache=KVCacheManager(_BLOCKS, _BLOCK),
                                   plan=engine._plan, **kw)
    out = [r.token_ids for r in eng.generate(
        [GenerationRequest(list(p), max_new_tokens=_NEW) for p in prompts])]
    return out, eng.spec_proposed, eng.spec_accepted


@pytest.mark.parametrize("kind", ["chunked", "spec"])
def test_chunked_and_speculative_at_tp2(paged, reference, kind):
    """Chunked prefill (64 tokens a step) and speculation with the target
    as its own draft (sharded under the same plan: acceptance 1) give the
    reference's greedy tokens on every rank."""
    prompts, warm = _prompts()
    results = paged.ranks.run(_variant_tokens, kind, prompts + [warm])
    assert results[0] == results[1]
    tokens, proposed, accepted = results[0]
    assert tokens == reference["paged"] + [reference["paged_warm"]]
    if kind == "spec":
        assert proposed > 0 and accepted == proposed


def _prefill_logits(engine, prompt):
    logits, _ = engine._prefill(torch.tensor([prompt]))
    return logits.numpy()


def test_prefill_logits_match_reference(paged, reference):
    """Every rank holds the same, replicated logits (the lm_head slices'
    all-gather), and they match the reference's tp=2 prefill within f32
    rounding: both sum the same products in other orders (logits of the
    tiny model are of size ~1, and f32 holds ~7 digits)."""
    prompts, _ = _prompts()
    rank0, rank1 = paged.ranks.run(_prefill_logits, prompts[0])
    np.testing.assert_array_equal(rank0, rank1)
    assert rank0.shape == reference["logits"].shape == (1, 256)
    np.testing.assert_allclose(rank0, reference["logits"], rtol=0, atol=2e-5)


def _model_collectives(engine, prompt):
    """On every rank: the collectives one prefill records, by op."""
    before = metrics.collective_summary()
    engine._prefill(torch.tensor([prompt]))
    after = metrics.collective_summary()
    return {op: after[op]["count"] - before.get(op, {}).get("count", 0.0) for op in after
            if after[op]["count"] != before.get(op, {}).get("count", 0.0)}


def test_model_call_makes_two_collectives_a_layer_and_two_more(paged):
    """A model call's collectives: an allreduce after each wo and each
    w_down, one after the masked embedding, and the logits' all-gather, on
    every rank; none of them reads the abort plane's store."""
    prompts, _ = _prompts()
    n_layers = paged.engine._cfg.n_layers
    want = {"allreduce": 2 * n_layers + 1, "allgather": 1}
    assert paged.ranks.run(_model_collectives, prompts[0]) == [want, want]


class _NoStore:
    """A store that fails every read: the model's ops must make none."""

    def check(self, keys):
        raise AssertionError(f"the abort plane was read: {keys}")

    get = check


def _group_contract(engine):
    """On every rank: the model's two group ops on rank-dependent values."""
    group, rank = engine._plan.group, engine._plan.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    reduced = x.clone()
    store, group.store = group.store, _NoStore()
    try:
        same = group.allreduce_(reduced) is reduced
        gathered = group.allgather_cat(x, dim=-1)
    finally:
        group.store = store
    return same, reduced.numpy(), gathered.numpy()


def test_group_model_ops_one_contract(paged):
    """``allreduce_`` sums in place and ``allgather_cat`` concatenates along
    the dim in rank order, the same on every rank."""
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for same, reduced, gathered in paged.ranks.run(_group_contract):
        assert same
        np.testing.assert_array_equal(reduced, 3 * base)
        np.testing.assert_array_equal(gathered, np.concatenate([base, 2 * base], axis=-1))


def _forge(engine):
    """Rank 1 brings 1 + each token of a pooled step to the host from now
    on (after that sample a step makes no collective, so rank 1 is back
    waiting for commands when rank 0 stops)."""
    if engine._plan.rank == 0:
        return
    sync = engine._host_sync
    engine._host_sync = lambda x: sync(x + 1 if x.numel() == engine._num_slots else x)


def test_agreement_check_fires_on_forged_divergence(paged):
    """A rank that samples differently stops the ranks: rank 0 raises a
    RuntimeError naming the step, and refuses every later request."""
    paged.ranks.run(_forge)
    with pytest.raises(RuntimeError, match=r"disagree at engine step \d+ .*rank 1 has"):
        _ask(paged, list(range(5, 30)))
    with pytest.raises(RuntimeError, match="stopped"):
        _ask(paged, list(range(5, 30)))


def test_close_leaves_no_child_and_no_process_group(paged):
    paged.close()
    paged.close()  # idempotent
    assert not dist.is_initialized()
    _join_children()


def test_nccl_refuses_cpu_ranks_before_any_spawn():
    with pytest.raises(ValueError, match="gloo"):
        LLMServer(LLMConfig(model_id="llama-tiny", tensor_parallel_size=2),
                  devices=_CPU2, tp_backend="nccl")
    assert not set(multiprocessing.active_children()) - _EARLIER_CHILDREN
