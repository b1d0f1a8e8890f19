"""ray_tpu_torch.util (metrics, tracing, events) against ray_tpu.util on the CPU.

The metric types, rollups and Prometheus text are driven with the same
calls in both packages and must give equal snapshots and equal results,
byte for byte for the text, on each other's payloads. Then the tiny f32
Llama runs through the reference's ContinuousBatchingEngine and the port's
with the same requests (paged, chunked, speculative, blocked, multi-tenant):
the counter deltas, the TTFT and ITL observation counts per tag, the events
(without their time and process) and the spans under one request_span must
be equal. Every comparison is exact: the counts are integers, and where a
value is a clock (TTFT, ITL, attach time, span times), only its count or
presence is compared.

Both registries are process-global, so every check takes deltas.
"""

import collections
import json
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.kvcache import KVCacheManager as JaxKVCacheManager
from ray_tpu.llm import GenerationRequest as JaxRequest
from ray_tpu.llm.engine import ContinuousBatchingEngine as JaxCBEngine
from ray_tpu.lora import AdapterStore as JaxAdapterStore
from ray_tpu.lora import adapter_target_paths as jax_target_paths
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu.util import events as jevents
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch import rllib
from ray_tpu_torch.kvcache import KVCacheManager
from ray_tpu_torch.llm import ContinuousBatchingEngine, GenerationRequest
from ray_tpu_torch.lora import AdapterStore
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.util import events, metrics, tracing

MAX_SEQ, BS, SLOTS, RANK, ALPHA = 64, 8, 4, 4, 8.0
LONG = list(range(5, 24))  # 19 tokens: two full blocks and 3
MID = list(range(100, 111))
SHORT = [3, 1, 4, 1, 5]
SHARED = LONG[:16] + [77, 78, 79]  # LONG's two blocks + its own tail
TENANTS = ("t1", "t2", "t3")
# the events the engines, the KV managers and the stores record
ENGINE_EVENTS = {"engine_admission_blocked", "admission_blocked", "adapter_cold_attach",
                 "adapter_evict"}
SPAN_IDS = ("trace_id", "span_id", "parent_id")


# ---------------------------------------------------------------------------
# metric types, rollups and the Prometheus text


def _drive_types(mod, seed):
    """The same inc / set / observe sequence, with tags, default tags,
    bound handles and exemplars, on one package's types."""
    rng = np.random.default_rng(seed)
    c = mod.Counter(f"obs_parity_{seed}_total", "a counter", tag_keys=("a", "b"))
    g = mod.Gauge(f"obs_parity_{seed}_gauge", "a gauge", tag_keys=("a",))
    h = mod.Histogram(f"obs_parity_{seed}_ms", "a histogram", boundaries=[4, 0.5, 1, 2],
                      tag_keys=("a",))
    c.set_default_tags({"b": "x"})
    bc, bg, bh = c.bind(a="1"), g.bind(a="2"), h.bind(a="3")
    for i, v in enumerate(rng.exponential(1.5, 40).tolist()):
        c.inc(v, {"a": str(i % 3)})
        bc.inc()
        g.set(v, {"a": str(i % 2)})
        bg.set(-v)
        h.observe(v, {"a": str(i % 2)}, exemplar=f"trace{i}" if i % 5 == 0 else None)
        bh.observe(2 * v)
    return [m._snapshot() for m in (c, g, h)]


def _no_exemplar_times(snaps):
    out = json.loads(json.dumps(snaps))
    for s in out:
        for per_tag in s.get("exemplars", {}).values():
            for ex in per_tag.values():
                ex.pop("ts")
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_types_snapshot_like_reference(seed):
    port, ref = _drive_types(metrics, seed), _drive_types(jmetrics, seed)
    # exact: the same float operations in the same order; the exemplars'
    # wall-clock stamps are left out
    assert _no_exemplar_times(port) == _no_exemplar_times(ref)
    assert port[2]["boundaries"] == [0.5, 1, 2, 4]


def _record_families(mod, seed):
    """One sequence of records into every family both packages share."""
    rng = np.random.default_rng(seed)
    for v in rng.exponential(0.02, 30).tolist():
        mod.record_kvcache_ttft(v, hit=v > 0.02, tier="local" if v > 0.02 else "miss")
        mod.record_serve_itl(v / 10, n=int(v * 200) % 3 + 1)
        mod.record_adapter_cold_attach(v)
    mod.record_kvcache_prefill(48, 13)
    mod.record_kvcache_eviction(2)
    mod.record_kvcache_blocked()
    mod.set_kvcache_blocks(7, 32)
    mod.record_spec_tokens(12, 9)
    mod.record_adapter_hit()
    mod.record_adapter_evict()
    mod.set_adapter_slots_live(3)
    mod.record_step_breakdown("obs_test", 0.25, 0.0, 0.125)
    mod.record_events_dropped(2)


def _payloads():
    """This process's payload of each package, through JSON as a pushed
    payload travels: the port's (no worker: gauges without a worker label)
    and the reference's under a worker id."""
    port = metrics.local_payload()
    with jmetrics._registry_lock:
        snaps = [m._snapshot() for m in jmetrics._registry.values()]
    ref = {"worker_id": "a1b2c3d4e5f60718", "node_id": "", "pid": os.getpid(),
           "ts": time.time(), "metrics": snaps}
    return json.loads(json.dumps(port)), json.loads(json.dumps(ref))


def test_rollups_and_prometheus_text_match_reference():
    _record_families(metrics, 3)
    _record_families(jmetrics, 3)
    port, ref = _payloads()
    names = {s["name"] for s in port["metrics"]}
    assert {"kvcache_ttft_ms", "serve_itl_seconds", "adapter_cold_attach_seconds",
            "step_time_seconds", "events_dropped_total"} <= names
    for payloads in ([port], [ref], [port, ref]):
        text = metrics.render_prometheus(payloads)
        assert text == jmetrics.render_prometheus(payloads)  # byte for byte
        for summary in ("kvcache_summary", "llm_summary", "adapter_summary"):
            assert getattr(metrics, summary)(payloads) == getattr(jmetrics, summary)(payloads)
        for name, tags in (("kvcache_ttft_ms", {"cache": "hit"}), ("serve_itl_seconds", None),
                           ("adapter_cold_attach_seconds", {"mesh": "tp=1"})):
            m = metrics.merged_histogram(payloads, name, tags)
            assert m == jmetrics.merged_histogram(payloads, name, tags) and m["count"] > 0
            for q in (0.5, 0.99):
                assert metrics._scaled_quantile(m, q, 1e3) == jmetrics._scaled_quantile(m, q, 1e3)
    rng = np.random.default_rng(4)
    for _ in range(50):
        bounds = np.cumsum(rng.uniform(0.1, 5, 6)).tolist()
        counts = rng.integers(0, 4, 7).tolist()
        for q in (0.0, 0.25, 0.5, 0.99, 1.0):
            assert metrics.quantile_from_buckets(bounds, counts, q) == \
                jmetrics.quantile_from_buckets(bounds, counts, q)
    assert metrics._escape_label_value('a"b\\c\nd') == jmetrics._escape_label_value('a"b\\c\nd')


def test_events_and_names_match_reference(monkeypatch):
    assert events.registered_event_names() == jevents.registered_event_names()
    # the ring keeps the newest cap events and counts the ones it dropped
    seen = []
    for mod, mmod in ((events, metrics), (jevents, jmetrics)):
        monkeypatch.setattr(mod, "_events_cap", 3)
        mod.clear_events()
        dropped0 = mmod.events_dropped_total()
        for i in range(5):
            mod.record_event(mod.ADAPTER_EVICT, adapter_id=f"a{i}", slot=i)
        got = mod.get_events(mod.ADAPTER_EVICT)
        assert all(e["pid"] == os.getpid() and e["ts"] > 0 for e in got)
        seen.append(([{k: v for k, v in e.items() if k not in ("ts", "pid")} for e in got],
                     mmod.events_dropped_total() - dropped0))
        mod.clear_events()
    assert seen[0] == seen[1]
    assert seen[0][1] == 2 and [e["slot"] for e in seen[0][0]] == [2, 3, 4]
    events.dump_events("obs test")  # records its marker, pushes nothing
    assert events.get_events(events.WORKER_DEATH)[-1]["reason"] == "obs test"
    events.clear_events()


def _span_tree(spans, trace_id):
    """The spans of one trace as a multiset of (span, parent span), each
    span as (name, category, attributes without ids)."""
    mine = [s for s in spans if s["trace_id"] == trace_id]
    by_id = {s["span_id"]: s for s in mine}

    def key(s):
        args = {k: v for k, v in s["args"].items() if k not in SPAN_IDS}
        return (s["name"], s["cat"], json.dumps(args, sort_keys=True))

    return collections.Counter(
        (key(s), key(by_id[s["parent_id"]]) if s["parent_id"] in by_id else None)
        for s in mine
    )


@pytest.fixture
def traced(monkeypatch):
    """Tracing on in both packages, their span buffers empty; off again
    (as the environment says) afterwards."""
    for mod in (tracing, jtracing):
        monkeypatch.setattr(mod, "_enabled", True)
        mod.clear_spans()
    # the reference's span pusher trims pushed spans when a cluster runs
    monkeypatch.setattr(jtracing, "flush_spans", lambda: None)
    yield
    for mod in (tracing, jtracing):
        mod.clear_spans()


def test_span_api_matches_reference(traced, tmp_path):
    trees = []
    for mod in (tracing, jtracing):
        ctx = mod.new_trace_context()
        with mod.request_span("req", ctx, deployment="d") as req_ctx:
            assert mod.current_context() == req_ctx
            with mod.trace_span("outer", k=1):
                with mod.trace_span("inner"):
                    pass
            child = mod.child_context(req_ctx)
            sid = mod.emit_span("emitted", child, time.time(), 0.001, n=2)
            mod.emit_closed_span("closed", child, req_ctx, time.time(), 0.002, x="y")
        assert sid and mod.emit_span("rootless", None, time.time(), 0.0) is not None
        spans = mod.get_spans()
        trees.append(_span_tree(spans, ctx["trace_id"]))
        assert all(s["ph"] == "X" and s["dur"] >= 0 for s in spans)
        mod.export_spans(str(tmp_path / f"{mod.__name__}.json"))
        exported = json.loads((tmp_path / f"{mod.__name__}.json").read_text())
        assert len(exported["traceEvents"]) == len(spans)
    assert trees[0] == trees[1] and sum(trees[0].values()) == 5
    task_events = [{"name": "f", "task_id": "t1", "ts_running": 1.0, "ts_finished": 1.5,
                    "node_id": "n", "worker_pid": 7, "state": "FINISHED"},
                   {"name": "g", "task_id": "t2"}]
    assert tracing.build_chrome_trace(task_events) == jtracing.build_chrome_trace(task_events)
    dup = [{"span_id": "s1", "name": "a"}, {"span_id": "s1", "name": "b"}, {"name": "c"}]
    assert tracing.merge_span_events([], dup, dup) == jtracing.merge_span_events([], dup, dup)


# ---------------------------------------------------------------------------
# the engines' records against the reference's


def _cfgs(**kw):
    return (JaxLlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=jnp.float32, n_kv_heads=2, **kw),
            LlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=torch.float32, n_kv_heads=2, **kw))


def _adapter_tree(cfg, seed):
    rng = np.random.default_rng(seed)
    tree = {}
    for path, d_in, d_out in jax_target_paths(cfg):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {"lora_a": rng.normal(0.0, 0.5, (d_in, RANK)).astype(np.float32),
                          "lora_b": rng.normal(0.0, 0.5, (RANK, d_out)).astype(np.float32)}
    return tree


@pytest.fixture(scope="module")
def models():
    """The target; for speculation the target with layer 1 zeroed to an
    identity, whose layer 0 as a 1-layer draft IS that target (acceptance
    1), and a random 1-layer draft; the tenants' adapters."""
    jcfg, tcfg = _cfgs()
    jdcfg, tdcfg = _cfgs(n_layers=1)
    jparams = unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    zeroed = jax.tree_util.tree_map(lambda x: x, jparams)
    l1 = zeroed["layer_1"]
    l1["attn"]["wo"]["base"]["kernel"] = jnp.zeros_like(l1["attn"]["wo"]["base"]["kernel"])
    l1["mlp"]["w_down"]["kernel"] = jnp.zeros_like(l1["mlp"]["w_down"]["kernel"])
    jax_side = dict(params=jparams, zeroed=zeroed,
                    dsame={k: zeroed[k] for k in ("embed", "final_norm", "layer_0", "lm_head")},
                    drand=unbox_params(jax_init_params(jdcfg, jax.random.PRNGKey(1))))
    port_side = {k: params_from_jax(jax.tree_util.tree_map(np.asarray, v),
                                    tdcfg if k in ("dsame", "drand") else tcfg, device="cpu")
                 for k, v in jax_side.items()}
    jax_side.update(cfg=jcfg, dcfg=jdcfg)
    port_side.update(cfg=tcfg, dcfg=tdcfg)
    trees = {t: _adapter_tree(jcfg, seed) for seed, t in enumerate(TENANTS, start=1)}
    return jax_side, port_side, trees


# case -> (engine arguments, KV blocks, waves of (tenant, prompt, max_new))
_CASES = {
    "paged": ({}, 32, [[(None, LONG, 6), (None, MID, 6), (None, SHORT, 6)],
                       [(None, SHARED, 6)]]),
    "chunked": ({"prefill_chunk_tokens": 8}, 32,
                [[(None, LONG, 6), (None, MID, 6), (None, SHORT, 6)], [(None, SHARED, 6)]]),
    "spec_same_draft": ({"draft": "dsame", "params": "zeroed", "spec_tokens": 3}, 32,
                        [[(None, LONG, 9), (None, SHORT, 7)], [(None, SHARED, 9)]]),
    "spec_random_draft": ({"draft": "drand", "spec_tokens": 3}, 32,
                          [[(None, LONG, 9), (None, SHORT, 7)], [(None, SHARED, 9)]]),
    # 2 blocks hold one 17-token prompt's blocks: the second waits, then
    # evicts the first one's committed blocks
    "blocked": ({}, 2, [[(None, list(range(5, 22)), 4), (None, list(range(60, 77)), 4)]]),
    # a store of 2 slots and 3 tenants: the second wave evicts both, and
    # its second request of t3 hits
    "adapters": ({"store": True}, 48, [[("t1", LONG, 5), ("t2", LONG, 5), (None, LONG, 5)],
                                       [("t3", LONG, 5), ("t1", MID, 5), ("t3", MID, 5)]]),
}


def _engine(side, models, kw, num_blocks):
    (j, t, trees), kw = models, dict(kw)
    m, eng_cls, kv_cls, store_cls, extra = (
        (j, JaxCBEngine, JaxKVCacheManager, JaxAdapterStore, {}) if side == "ref" else
        (t, ContinuousBatchingEngine, KVCacheManager, AdapterStore, {"device": "cpu"}))
    store = None
    if kw.pop("store", False):
        store = store_cls(m["cfg"], max_live=2, rank=RANK, alpha=ALPHA,
                          source=trees.__getitem__, **extra)
    if "draft" in kw:
        kw["draft"] = (m["dcfg"], m[kw["draft"]])
    params = m[kw.pop("params", "params")]
    engine = eng_cls(m["cfg"], params, num_slots=SLOTS, seed=7, adapter_store=store,
                     kv_cache=kv_cls(num_blocks=num_blocks, block_size=BS), **kw, **extra)
    return engine, store


def _hist_counts(hist):
    with hist._lock:
        return {k: sum(v) for k, v in hist._counts.items()}


def _readings(mod):
    return dict(
        kvcache=mod.kvcache_counters(), llm=mod.llm_counters(), adapter=mod.adapter_counters(),
        ttft=_hist_counts(mod._ensure_kvcache_metrics()["ttft"]),
        itl=_hist_counts(mod._ensure_llm_metrics()["itl"]),
    )


def _delta(after, before):
    out = {}
    for key, now in after.items():
        was = before[key]
        out[key] = {k: v - was.get(k, 0) for k, v in now.items() if v != was.get(k, 0)}
    return out


def _run_case(side, models, case):
    kw, num_blocks, waves = _CASES[case]
    mod, tmod, emod, req_cls = (
        (jmetrics, jtracing, jevents, JaxRequest) if side == "ref" else
        (metrics, tracing, events, GenerationRequest))
    engine, store = _engine(side, models, kw, num_blocks)
    before, t0 = _readings(mod), time.time()
    ctx = tmod.new_trace_context()
    tokens = []
    with tmod.request_span("test.request", ctx):
        for wave in waves:
            leases = [store.acquire(t) if t else None for t, _, _ in wave]
            reqs = [req_cls(token_ids=list(p), max_new_tokens=n, adapter_id=t,
                            adapter_slot=lease.slot if lease else -1)
                    for (t, p, n), lease in zip(wave, leases)]
            tokens.append([r.token_ids for r in engine.generate(reqs)])
            for lease in leases:
                if lease is not None:
                    store.release(lease)
    evs = [{k: v for k, v in e.items() if k not in ("ts", "pid", "attach_ms")}
           for e in emod.get_events() if e["ts"] >= t0 and e["name"] in ENGINE_EVENTS]
    spec = (engine.spec_proposed, engine.spec_accepted) if side == "port" and "draft" in kw else None
    return dict(tokens=tokens, deltas=_delta(_readings(mod), before), events=evs,
                spans=_span_tree(tmod.get_spans(), ctx["trace_id"]),
                kv=engine._kv.stats(), store=store.stats() if store else None, spec=spec)


@pytest.mark.parametrize("case", list(_CASES))
def test_engine_records_match_reference(models, traced, case):
    ref, port = _run_case("ref", models, case), _run_case("port", models, case)
    assert port["tokens"] == ref["tokens"]
    # exact: counter deltas, TTFT / ITL observations per tag, events (their
    # time, process and attach time left out) and the request's span tree
    assert port["deltas"] == ref["deltas"]
    assert port["events"] == ref["events"]
    assert port["spans"] == ref["spans"]
    d, kv = port["deltas"], port["kv"]
    # the registry agrees with the engine's and the manager's own counters
    assert d["kvcache"].get("prefix_hit_tokens", 0) == kv["prefix_hit_tokens"]
    assert d["kvcache"].get("prefill_tokens_computed", 0) == kv["prefill_tokens_computed"]
    assert d["kvcache"].get("evictions", 0) == kv["evictions"]
    assert d["kvcache"].get("admission_blocked", 0) == kv["admission_blocked"]
    ttft = d["ttft"]
    assert sum(ttft.values()) == kv["requests"]
    assert ttft.get(("hit", "tp=1", "local"), 0) == kv["hits"]
    assert ttft.get(("miss", "tp=1", "miss"), 0) == kv["misses"]
    # one ITL observation per token after a request's first; a verify
    # step records one per token it landed, also past a row's stop
    n_tokens = sum(len(t) for wave in port["tokens"] for t in wave)
    n_requests = sum(len(wave) for wave in port["tokens"])
    itl = d["itl"].get(("tp=1",), 0)
    assert itl == d["llm"]["itl_observations"]
    assert itl == n_tokens - n_requests if port["spec"] is None else itl >= n_tokens - n_requests
    names = collections.Counter(span[0][0] for span in port["spans"].elements())
    assert names["test.request"] == 1 and names["engine.queue_wait"] == n_requests
    assert names["engine.prefill"] == names["engine.decode"] == names["kvcache.acquire"] \
        == n_requests
    assert names["kvcache.assemble"] >= (kv["hits"] > 0)
    if port["spec"] is not None:
        proposed, accepted = port["spec"]
        assert d["llm"] == dict(d["llm"], spec_proposed_tokens=proposed,
                                spec_accepted_tokens=accepted)
        assert (accepted == proposed) == (case == "spec_same_draft")
    if case == "blocked":
        # the manager's event at every failed acquire, the engine's once
        names = [e["name"] for e in port["events"]]
        assert names[:2] == ["admission_blocked", "engine_admission_blocked"]
        assert names.count("engine_admission_blocked") == 1
        assert names.count("admission_blocked") == kv["admission_blocked"]
        assert d["kvcache"]["evictions"] >= 1
    if case == "adapters":
        st = port["store"]
        assert d["adapter"] == {"adapter_hits": st["hits"],
                                "adapter_cold_attaches": st["cold_attaches"],
                                "adapter_evictions": st["evictions"]}
        assert (st["hits"], st["cold_attaches"], st["evictions"]) == (1, 4, 2)
        assert [(e["name"], e["adapter_id"]) for e in port["events"]] == [
            ("adapter_cold_attach", "t1"), ("adapter_cold_attach", "t2"), ("adapter_evict", "t1"),
            ("adapter_cold_attach", "t3"), ("adapter_evict", "t2"), ("adapter_cold_attach", "t1")]


def test_untraced_requests_record_no_span(models):
    """With tracing off and no request context, the engine records its
    metrics and no span."""
    assert not tracing.is_tracing_enabled()
    tracing.clear_spans()
    engine, _ = _engine("port", models, {}, 16)
    itl0 = metrics.llm_counters()["itl_observations"]
    engine.generate([GenerationRequest(token_ids=MID, max_new_tokens=4)])
    assert tracing.get_spans() == [] and not engine._req_trace and not engine._enqueue_ts
    assert metrics.llm_counters()["itl_observations"] - itl0 == 3


def test_a_failing_record_is_raised_not_swallowed(models, monkeypatch):
    """The port calls its metrics directly: a record that fails is a bug
    the caller sees. (The reference wraps every record in try/except,
    because its metrics module imports its runtime.)"""
    def broken(*args, **kwargs):
        raise RuntimeError("record failed")

    engine, _ = _engine("port", models, {}, 16)
    monkeypatch.setattr(metrics, "record_serve_itl", broken)
    with pytest.raises(RuntimeError, match="record failed"):
        engine.generate([GenerationRequest(token_ids=SHORT, max_new_tokens=3)])
    monkeypatch.setattr(jmetrics, "record_serve_itl", broken)
    ref, _ = _engine("ref", models, {}, 16)
    assert len(ref.generate([JaxRequest(token_ids=SHORT, max_new_tokens=3)])[0].token_ids) == 3


# ---------------------------------------------------------------------------
# PPO, the device profile and device memory


def test_ppo_train_records_the_rllib_step_breakdown():
    algo = (rllib.PPOConfig().environment(rllib.CartPoleEnv)
            .env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=16)
            .debugging(seed=0).build(device="cpu"))
    seconds = metrics._ensure_step_metrics()["seconds"]
    for it in range(2):
        result = algo.train()
        eff = metrics.scaling_efficiency("rllib")
        with seconds._lock:
            parts = {k[1]: v for k, v in seconds._values.items() if k[0] == "rllib"}
        # no collectives yet: compute is the whole step past the idle gap
        assert parts["collective"] == 0.0 and 0.0 < eff <= 1.0
        # components sum to the total (tolerance: one f64 rounding of a sum)
        assert math.isclose(parts["compute"] + parts["collective"] + parts["idle"],
                            parts["total"], rel_tol=1e-12)
        assert parts["compute"] >= result["time_this_iter_s"] > 0
        assert (parts["idle"] == 0.0) == (it == 0)
    assert set(algo.timers) == {"sample_s", "postprocess_s", "learn_s"}
    algo.stop()


def test_device_profile_writes_a_chrome_trace_with_the_region(tmp_path):
    """The counterpart of the reference's XPlane test: on the CPU the
    profile holds host activity, and the annotated region."""
    x = torch.ones(64, 64)
    with tracing.device_profile(str(tmp_path)):
        with tracing.annotate_device_trace("obs.region"):
            (x @ x).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "obs.region" in names and "aten::mm" in names
    with tracing.device_trace(str(tmp_path / "again")) as log_dir:
        x.sum()
    assert log_dir == str(tmp_path / "again") and list((tmp_path / "again").glob("*.json"))


def test_device_trace_needs_a_log_dir():
    """Kept item 12: the log directory is required. The reference defaults
    it to a fixed /tmp path (its TPU profiler's), which the port does not
    carry."""
    with pytest.raises(TypeError):
        tracing.device_trace()
    with pytest.raises(TypeError):
        tracing.start_device_trace()


def test_start_stop_device_trace_writes_one_trace_and_one_at_a_time(tmp_path):
    x = torch.ones(32, 32)
    assert tracing.start_device_trace(str(tmp_path / "a")) == str(tmp_path / "a")
    try:
        with pytest.raises(RuntimeError, match="already open"):
            tracing.start_device_trace(str(tmp_path / "b"))
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.device_trace(str(tmp_path / "c")):
                pass
        with tracing.annotate_device_trace("obs.open_trace"):
            (x @ x).sum()
    finally:
        tracing.stop_device_trace()
    files = list((tmp_path / "a").glob("*.pt.trace.json"))
    assert len(files) == 1 and not (tmp_path / "b").exists()
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "obs.open_trace" in names
    with pytest.raises(RuntimeError, match="no device trace"):
        tracing.stop_device_trace()
    # closed: a new one may start
    with tracing.device_trace(str(tmp_path / "d")):
        x.sum()
    assert len(list((tmp_path / "d").glob("*.pt.trace.json"))) == 1


def test_device_memory_without_a_card_is_empty_and_starts_nothing():
    assert not torch.cuda.is_initialized()
    assert metrics.sample_device_memory() == {}
    payload = metrics.local_payload()  # samples device memory first, as the pusher does
    assert not torch.cuda.is_initialized()
    assert all(s["name"] != "tpu_hbm_used_bytes" or not s["values"]
               for s in payload["metrics"])


def test_train_reports_mark_the_train_step_breakdown(tmp_path):
    """session.report marks a step boundary, as the reference's does: from
    the second report on, the train gauges hold the interval."""
    from ray_tpu_torch.train.session import TrainContext

    ctx = TrainContext(world_rank=0, local_rank=0, node_rank=0, world_size=1,
                       local_world_size=1, experiment_name="obs", run_dir=str(tmp_path))
    seconds = metrics._ensure_step_metrics()["seconds"]
    ctx.report({"step": 0})
    time.sleep(0.01)
    ctx.report({"step": 1})
    with seconds._lock:
        parts = {k[1]: v for k, v in seconds._values.items() if k[0] == "train"}
    # a report-to-report interval is all compute (no collectives, idle
    # unknown): at least the 10 ms slept
    assert parts["total"] == parts["compute"] >= 0.01 and parts["idle"] == 0.0
    assert metrics.scaling_efficiency("train") == 1.0
