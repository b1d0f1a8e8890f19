"""ray_tpu_torch's ContinuousBatchingEngine against ray_tpu's on the CPU.

Both sides run the tiny Llama in float32 on the reference's PRNGKey(0)
weights, carried across by params_from_jax, so that greedy argmax ties in
bf16 cannot split the token streams: at temperature 0 every token must be
equal, and the paged path's prefix-hit and computed-token counts must equal
the reference's. Each side runs the same requests in the same order, so
their KV pools hold the same prefixes whatever order the tests run in.

The engines are module-scoped (JAX compiles per engine and per shape) and
the prompts come from one set of lengths.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._internal import serialization
from ray_tpu.kvcache import KVCacheManager as JaxKVCacheManager
from ray_tpu.llm import GenerationRequest as JaxRequest
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm.engine import ContinuousBatchingEngine as JaxCBEngine
from ray_tpu.llm.serving import _LLMReplica
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch.kvcache import KVCacheManager
from ray_tpu_torch.llm import (
    ContinuousBatchingEngine,
    GenerationRequest,
    LLMConfig,
    LLMEngine,
    LLMServer,
)
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import LlamaConfig

MAX_SEQ, BS, SLOTS = 64, 8, 4
# one set of prompt lengths: 19 (2 blocks + 3), 11 (1 block + 3), 5
LONG = list(range(5, 24))
MID = list(range(100, 111))
SHORT = [3, 1, 4, 1, 5]
SHARED = LONG[:16] + [77, 78, 79]  # LONG's two full blocks + its own tail


def _cfgs(**kw):
    return (JaxLlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=jnp.float32, n_kv_heads=2, **kw),
            LlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=torch.float32, n_kv_heads=2, **kw))


def _to_port(jparams, tcfg):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    """The target, and for speculation: the target with layer 1 zeroed to an
    exact identity (wo and w_down = 0 leave the residual stream as it is),
    its layer 0 packaged as a 1-layer draft that IS that target (acceptance
    1 by construction), and a random 1-layer draft (acceptance near 0)."""
    jcfg, tcfg = _cfgs()
    jdcfg, tdcfg = _cfgs(n_layers=1)
    jparams = unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    zeroed = jax.tree_util.tree_map(lambda x: x, jparams)
    l1 = zeroed["layer_1"]
    l1["attn"]["wo"]["base"]["kernel"] = jnp.zeros_like(l1["attn"]["wo"]["base"]["kernel"])
    l1["mlp"]["w_down"]["kernel"] = jnp.zeros_like(l1["mlp"]["w_down"]["kernel"])
    dsame = {k: zeroed[k] for k in ("embed", "final_norm", "layer_0", "lm_head")}
    drand = unbox_params(jax_init_params(jdcfg, jax.random.PRNGKey(1)))
    jax_side = dict(cfg=jcfg, dcfg=jdcfg, params=jparams, zeroed=zeroed,
                    dsame=dsame, drand=drand)
    port_side = {k: (_to_port(v, tdcfg if k in ("dsame", "drand") else tcfg)
                     if isinstance(v, dict) else None)
                 for k, v in jax_side.items()}
    port_side.update(cfg=tcfg, dcfg=tdcfg)
    return jax_side, port_side


def _pair(models, params="params", num_blocks=32, seed=7, draft=None, **kw):
    """A reference engine and a port engine on the same weights (and
    ``draft`` weights), each over its own KV manager of ``num_blocks``
    blocks (None: the dense pool)."""
    (j, t), out = models, []
    for side, eng_cls, mgr_cls, extra in (
        (j, JaxCBEngine, JaxKVCacheManager, {}),
        (t, ContinuousBatchingEngine, KVCacheManager, {"device": "cpu"}),
    ):
        kv = None if num_blocks is None else mgr_cls(num_blocks=num_blocks, block_size=BS)
        if draft is not None:
            extra = dict(extra, draft=(side["dcfg"], side[draft]))
        out.append((eng_cls(side["cfg"], side[params], num_slots=SLOTS, kv_cache=kv,
                            seed=seed, **kw, **extra), kv))
    return out


def _req_cls(engine):
    return JaxRequest if isinstance(engine, JaxCBEngine) else GenerationRequest


@pytest.fixture(scope="module")
def paged(models):
    return _pair(models)


@pytest.fixture(scope="module")
def dense_port(models):
    _, t = models
    return LLMEngine(t["cfg"], t["params"], max_batch_size=SLOTS, device="cpu")


def _reqs(prompts, cls, max_new=8, **kw):
    return [cls(token_ids=list(p), max_new_tokens=max_new, **kw) for p in prompts]


def _both(pair, prompts, max_new=8, **kw):
    """Generate on the reference and the port; returns both results."""
    (je, _), (te, _) = pair
    return (je.generate(_reqs(prompts, JaxRequest, max_new, **kw)),
            te.generate(_reqs(prompts, GenerationRequest, max_new, **kw)))


def _assert_same(ref, out):
    for r, o in zip(ref, out):
        assert (o.token_ids, o.num_prompt_tokens, o.finished_reason) == (
            r.token_ids, r.num_prompt_tokens, r.finished_reason)


def _no_pins_left(engine, kv):
    assert engine.num_active == 0 and not engine._slots
    assert kv.blocks_in_use == kv.stats()["index_nodes"]


# ---------------------------------------------------------------------------
# the paged engine


def test_mixed_lengths_match_reference_and_dense(paged, dense_port):
    ref, out = _both(paged, [LONG, MID, SHORT])
    _assert_same(ref, out)
    _assert_same(dense_port.generate(_reqs([LONG, MID, SHORT], GenerationRequest)), out)
    _no_pins_left(*paged[1])


def test_shared_prefix_hits_like_reference(paged):
    deltas = []
    for eng, kv in paged:
        before = kv.stats()
        first = eng.generate(_reqs([LONG], _req_cls(eng)))
        mid = kv.stats()
        out = eng.generate(_reqs([SHARED], _req_cls(eng)))
        after = kv.stats()
        deltas.append((
            first[0].token_ids, out[0].token_ids,
            after["prefix_hit_tokens"] - mid["prefix_hit_tokens"],
            after["prefill_tokens_computed"] - mid["prefill_tokens_computed"],
            after["prefix_hit_tokens"] - before["prefix_hit_tokens"],
            after["prefill_tokens_computed"] - before["prefill_tokens_computed"],
        ))
    assert deltas[1] == deltas[0]
    # the shared request is served its two cached 8-token blocks
    assert deltas[1][2:4] == (16, len(SHARED) - 16)


def test_eos_and_slot_reuse_leave_nothing_behind(paged):
    prompt = list(range(40, 59))  # 19 tokens
    ref_free, _ = _both(paged, [prompt], max_new=6)
    eos = ref_free[0].token_ids[1]
    ref, out = _both(paged, [prompt, SHORT], max_new=6, eos_token_id=eos)
    _assert_same(ref, out)
    assert out[0].finished_reason == "eos" and out[0].token_ids == ref_free[0].token_ids[:2]
    for eng, kv in paged:
        _no_pins_left(eng, kv)


def test_generate_stream_equals_generate(paged):
    (je, _), (te, _) = paged
    ref = je.generate([JaxRequest(token_ids=MID, max_new_tokens=7)])[0]
    items = list(te.generate_stream(GenerationRequest(token_ids=MID, max_new_tokens=7)))
    assert items[:-1] == items[-1].token_ids == ref.token_ids
    assert te.generate([GenerationRequest(token_ids=MID, max_new_tokens=7)])[0].token_ids \
        == ref.token_ids


def test_two_threads_generate_at_once(paged):
    (je, _), (te, kv) = paged
    prompts = [[LONG, SHORT], [MID, SHARED]]
    want = [je.generate(_reqs(p, JaxRequest, 10)) for p in prompts]
    got, errors = [None, None], []

    def run(i):
        try:
            got[i] = te.generate(_reqs(prompts[i], GenerationRequest, 10))
        except Exception as exc:  # reported below, with the thread's own error
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and errors == []
    for w, g in zip(want, got):
        _assert_same(w, g)
    assert not te._finished_buf
    _no_pins_left(te, kv)


def test_request_sent_while_another_thread_steps_is_admitted(paged):
    """A caller that steps the engine in a loop must not keep the others
    out: a short request sent while another thread steps a long one is
    admitted at one of that thread's next steps and returns first."""
    _, (te, kv) = paged
    order, errors = [], []

    def run(name, request):
        try:
            te.generate([request])
            order.append(name)
        except Exception as exc:  # reported below, with the thread's own error
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(
        "long", GenerationRequest(token_ids=LONG, max_new_tokens=44)))]
    threads[0].start()
    deadline = time.monotonic() + 60
    while not te._slots and time.monotonic() < deadline:
        time.sleep(0.001)
    threads.append(threading.Thread(target=run, args=(
        "short", GenerationRequest(token_ids=SHORT, max_new_tokens=2))))
    threads[1].start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and errors == []
    assert order == ["short", "long"]
    _no_pins_left(te, kv)


def test_callers_in_threads_keep_the_pool_full(paged):
    """As many threads as slots, each sending two requests one after the
    other (a serving replica's thread pool): the pool must run as one batch,
    in about the steps two full waves need. When every caller steps under
    one lock, the thread that holds it takes it back at once and the others'
    requests trickle in (on the H100, 152 steps where 62 would do)."""
    _, (te, kv) = paged
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, 5).tolist() for _ in range(2 * SLOTS)]
    want = [r.token_ids for r in LLMEngine(te._cfg, te._params, device="cpu").generate(
        _reqs(prompts, GenerationRequest, 12))]
    calls = te.forward_calls
    with ThreadPoolExecutor(SLOTS) as pool:
        got = list(pool.map(
            lambda p: te.generate([GenerationRequest(token_ids=p, max_new_tokens=12)])[0],
            prompts))
    assert [r.token_ids for r in got] == want
    # one prefill per (5-token, uncached) prompt; the first token comes
    # from it, so two full waves need 2 * 11 = 22 decode steps. A caller
    # whose first request finished may be scheduled late and send its
    # second a step or more behind the others, so the bound sits between
    # that and the single-lock design, which took 69-82 steps here
    decode_steps = te.forward_calls - calls - len(prompts)
    assert decode_steps <= 40, decode_steps
    _no_pins_left(te, kv)


def test_free_row_index_past_max_seq_len_stays_in_bounds(paged):
    """A slot retired near max_seq_len stays free while another request
    decodes for longer than the positions left to it: its stale row keeps
    decoding garbage at an index past the end, which the RoPE rows and the
    cache write must clamp (an out-of-range gather would raise here, and
    be a device-side assert on the card)."""
    (je, _), (te, _) = paged
    near_end = list(range(60, 79))  # 19 prompt + 44 new: retires at index 62
    outs = []
    for eng in (je, te):
        cls = _req_cls(eng)
        first = eng.generate([cls(token_ids=SHORT, max_new_tokens=2),
                              cls(token_ids=near_end, max_new_tokens=44)])
        # SHORT takes slot 0 again; the near-end row (slot 1) stays free
        then = eng.generate([cls(token_ids=SHORT, max_new_tokens=40)])
        outs.append([r.token_ids for r in first + then])
    assert outs[1] == outs[0]
    assert int(te._cache.index[0, 1]) > MAX_SEQ
    assert (te._cache.index == te._cache.index[0]).all()  # every layer alike


def test_memory_gated_admission(models):
    """A pool of 2 blocks holds one 17-token prompt's blocks at a time: the
    second request waits (FIFO, no error) until the first retires."""
    pair = _pair(models, num_blocks=2, seed=3)
    seen = []
    for eng, kv in pair:
        cls = _req_cls(eng)
        r1 = eng.add_request(cls(token_ids=list(range(5, 22)), max_new_tokens=4))
        r2 = eng.add_request(cls(token_ids=list(range(60, 77)), max_new_tokens=4))
        eng.step()
        blocked = (kv.stats()["admission_blocked"], eng.num_active, len(eng._slots))
        results = eng.run_until_complete()
        seen.append((blocked, [results[r1].token_ids, results[r2].token_ids],
                     kv.stats()["admission_blocked"], eng.num_active))
    assert seen[1] == seen[0]
    assert seen[1][0][0] >= 1 and seen[1][0][1:] == (2, 1)


def test_dense_pool_matches_reference(models):
    """kv_cache=None: the dense per-slot pool, no prefix reuse."""
    ref, out = _both(_pair(models, num_blocks=None), [LONG, MID, SHORT])
    _assert_same(ref, out)


def test_temperature_sampling_is_reproducible(models):
    _, t = models
    reqs = _reqs([LONG, SHORT], GenerationRequest, 8, temperature=1.0)

    def run(seed, **kw):
        e = ContinuousBatchingEngine(t["cfg"], t["params"], num_slots=SLOTS, seed=seed,
                                     kv_cache=KVCacheManager(16, BS), device="cpu", **kw)
        return [r.token_ids for r in e.generate(reqs)]

    first = run(7)
    assert first == run(7) and first != run(8)
    spec = dict(draft=(t["dcfg"], t["drand"]), spec_tokens=3)
    assert run(7, **spec) == run(7, **spec)  # the rejection-sampling path
    assert all(0 <= tok < t["cfg"].vocab_size for row in first for tok in row)


# ---------------------------------------------------------------------------
# speculative decoding


@pytest.fixture(scope="module")
def spec(models):
    """The reference's speculative engine (target and draft swapped between
    cases) and the port's, one per case: the random draft proposes for the
    full target (rejections and rollbacks every step, in both layers), the
    identical draft for the target with layer 1 zeroed (acceptance 1)."""
    (je, _), (te_rand, kv_rand) = _pair(models, draft="drand", spec_tokens=4)
    _, (te_same, kv_same) = _pair(models, params="zeroed", draft="dsame", spec_tokens=4)
    return je, {"drand": ("params", te_rand, kv_rand), "dsame": ("zeroed", te_same, kv_same)}


# each case its own prompts: the reference's one engine keeps one KV pool
# across both targets, so no cached block may be shared between the cases
SPEC_PROMPTS = {"drand": [LONG, SHORT], "dsame": [list(range(30, 49)), [2, 7, 1, 8, 2]]}


@pytest.mark.parametrize("draft", ["drand", "dsame"])
def test_spec_matches_reference(models, spec, draft):
    jax_side, port_side = models
    je, ports = spec
    target, te, kv = ports[draft]
    je.swap_params(jax_side[target])
    je._draft.swap_params(jax_side[draft])
    baseline = kv.blocks_in_use
    prompts = SPEC_PROMPTS[draft]
    ref = je.generate(_reqs(prompts, JaxRequest, 14))
    out = te.generate(_reqs(prompts, GenerationRequest, 14))
    _assert_same(ref, out)
    # greedy speculation is the target's greedy trajectory: the port's own
    # non-speculative engine on the same target agrees
    plain = ContinuousBatchingEngine(
        port_side["cfg"], port_side[target], num_slots=SLOTS, device="cpu")
    _assert_same(plain.generate(_reqs(prompts, GenerationRequest, 14)), out)
    if draft == "dsame":
        assert te.spec_accepted == te.spec_proposed > 0
    else:
        assert 0 <= te.spec_accepted < te.spec_proposed
    # the rollback moved every layer of both pools to the same positions
    for pool in (te._cache, te._draft_cache):
        assert torch.equal(pool.index, te._cache.index[:1].expand_as(pool.index))
    # rejected proposals strand no block: what is left is what the index
    # holds of the new sequences
    _no_pins_left(te, kv)
    assert kv.blocks_in_use >= baseline


def test_spec_guards(models, spec):
    _, ports = spec
    _, te, _ = ports["drand"]
    with pytest.raises(ValueError, match="spec_tokens"):
        te.add_request(GenerationRequest(token_ids=[1] * 40, max_new_tokens=22))
    _, t = models
    short_draft = LlamaConfig.tiny(max_seq_len=32, dtype=torch.float32, n_kv_heads=2,
                                   n_layers=1)
    with pytest.raises(ValueError, match="max_seq_len"):
        ContinuousBatchingEngine(t["cfg"], t["params"], draft=(short_draft, t["drand"]),
                                 spec_tokens=4, device="cpu")


# ---------------------------------------------------------------------------
# chunked prefill


@pytest.fixture(scope="module")
def chunked(models):
    return _pair(models, prefill_chunk_tokens=8)


def test_chunked_matches_reference_and_unchunked(chunked, dense_port):
    ref, out = _both(chunked, [LONG, MID])
    _assert_same(ref, out)
    _assert_same(dense_port.generate(_reqs([LONG, MID], GenerationRequest)), out)


def test_chunked_prefill_with_prefix_hit(chunked):
    deltas = []
    for eng, kv in chunked:
        cls = _req_cls(eng)
        first = eng.generate([cls(token_ids=LONG, max_new_tokens=4)])
        before = kv.stats()
        again = eng.generate([cls(token_ids=SHARED, max_new_tokens=4)])
        after = kv.stats()
        deltas.append((first[0].token_ids, again[0].token_ids,
                       after["prefix_hit_tokens"] - before["prefix_hit_tokens"],
                       after["prefill_tokens_computed"] - before["prefill_tokens_computed"]))
    assert deltas[1] == deltas[0] and deltas[1][2:] == (16, 3)


def test_chunked_decodes_do_not_stall(chunked):
    """While a long prompt advances chunk by chunk, the in-flight request
    emits one token EVERY step and no step computes more prefill tokens than
    the budget."""
    _, (te, kv) = chunked
    short = te.add_request(GenerationRequest(token_ids=SHORT, max_new_tokens=30))
    te.step()  # SHORT prefills (one chunk) and decodes its first token
    te.step()
    slot = next(iter(te._slots.values()))
    assert slot.request_id == short
    te.add_request(GenerationRequest(token_ids=list(range(1, 49)), max_new_tokens=4))
    prefilling_steps = 0
    for _ in range(40):
        before = len(slot.generated) if slot.request_id in (
            s.request_id for s in te._slots.values()) else None
        te.step()
        assert te.last_step_prefill_tokens <= 8
        if te._prefilling and before is not None:
            prefilling_steps += 1
            assert len(slot.generated) == before + 1
        if te.num_active == 0:
            break
    assert prefilling_steps >= 5  # 48 tokens at 8 a step
    _no_pins_left(te, kv)


# ---------------------------------------------------------------------------
# the server


def test_paged_server_answers_like_replica():
    """The whole slice: the reference's replica and the port's server with
    the same paged config (and chunked prefill) on the same weights give the
    same response dicts, streamed or not, and the same cache counters."""
    kw = dict(model_id="llama-tiny", max_seq_len=MAX_SEQ, seed=0, kv_cache_blocks=16,
              kv_block_size=BS, max_batch_size=2, prefill_chunk_tokens=16)
    jcfg = JaxLLMConfig(**kw, model_kwargs={"dtype": jnp.float32})
    tcfg = LLMConfig(**kw, model_kwargs={"dtype": torch.float32})
    jparams = unbox_params(jax_init_params(jcfg.build_model_config(), jax.random.PRNGKey(0)))
    replica = _LLMReplica(jcfg, params_blob=serialization.dumps(jparams))
    server = LLMServer(tcfg, params=_to_port(jparams, tcfg.build_model_config()),
                       device="cpu")
    for request in ({"token_ids": LONG, "max_new_tokens": 5},
                    {"token_ids": SHARED, "max_new_tokens": 5}):
        assert server(request) == replica(request)
        assert list(server.stream(request)) == list(replica.stream(request))
    ref_stats, stats = replica.kvcache_stats(), server.kvcache_stats()
    for key in ("requests", "hits", "prefix_hit_tokens", "prefill_tokens_computed",
                "blocks_in_use", "index_nodes"):
        assert stats[key] == ref_stats[key], key
    assert set(stats) == set(ref_stats)


# ---------------------------------------------------------------------------
# the law of speculative sampling at temperature > 0

# the 0.999 quantile of chi-square with 7 degrees of freedom
# (scipy.stats.chi2.ppf(0.999, 7)): a right law fails 1 seed in 1000
_CHI2_7_999 = 24.322


def _first_token_law(target, draft, temp, rows=20_000, seed=0):
    """speculative_accept at k=1 over ``rows`` identical rows of one
    (target, draft) pair of 8-way logits: the emitted first token's counts,
    its probability under softmax(target / temp), and the acceptance."""
    from ray_tpu_torch.llm.engine import speculative_accept

    gen = torch.Generator().manual_seed(seed)
    t = torch.as_tensor(target, dtype=torch.float32)
    d = torch.as_tensor(draft, dtype=torch.float32)
    temps = torch.full((rows,), temp)
    # the draft proposes from its own law, as _propose does
    proposal = torch.multinomial(torch.softmax(d / temp, -1).expand(rows, -1), 1,
                                 replacement=True, generator=gen)
    # position 1's logits (the bonus after an accepted proposal) are those
    # of position 0 here: only the first emitted token is held to the law
    tl = t.expand(rows, 2, -1)
    emitted, counts = speculative_accept(tl, d.expand(rows, 1, -1), proposal, temps, gen)
    freq = torch.bincount(emitted[:, 0], minlength=t.numel()).double()
    law = torch.softmax(t.double() / temp, -1)
    return freq, law, (counts == 2).double().mean().item()


@pytest.mark.parametrize("temp", [1.0, 0.7])
def test_speculative_sampling_keeps_the_target_law(temp):
    """Rejection sampling with the residual correction must emit the
    target's law, whatever the draft: with a draft far from the target, the
    first emitted token's frequencies over 20,000 rows agree with
    softmax(target / T) within the 0.999 chi-square bound (7 degrees of
    freedom); and a draft equal to the target accepts every proposal."""
    rng = np.random.default_rng(12)
    target = rng.normal(0.0, 1.5, 8)
    draft = rng.normal(0.0, 1.5, 8)
    freq, law, acceptance = _first_token_law(target, draft, temp)
    expected = law * freq.sum()
    chi2 = ((freq - expected) ** 2 / expected).sum().item()
    assert chi2 < _CHI2_7_999, (chi2, freq.tolist(), expected.tolist())
    assert 0.0 < acceptance < 1.0  # both branches ran: accepts and residual draws
    # the proposals alone follow the draft's law, which the test must tell
    # apart from the target's: the bound has power here
    d_law = torch.softmax(torch.as_tensor(draft, dtype=torch.float64) / temp, -1)
    assert (((d_law - law) * freq.sum()) ** 2 / expected).sum().item() > 10 * _CHI2_7_999
    _, _, same = _first_token_law(target, target, temp, rows=2_000)
    assert same == 1.0
