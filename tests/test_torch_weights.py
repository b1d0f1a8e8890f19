"""The port's weight plane (ray_tpu_torch.weights) against ray_tpu.weights.

Every program of tests/test_weights.py but the train callback's (ROADMAP A
item 18) and the slow RLlib put-once guard runs against ``ray_tpu`` and
then against ``ray_tpu_torch``, the leaves drawn by numpy and handed to the
port as torch tensors: the main programs on one single-node cluster per
runtime for the whole file (never both at once), then the three that need
a cluster of their own (a GCS restart, a lease heartbeat, a small store)
one at a time. The two runtimes' results must be equal, and equal to what
the reference's tests assert. Without a cluster: chunk boundaries, leaf
wire bytes and int8 codes against the reference's ``chunk_pytree`` on the
same leaves, bit for bit; the registry's scenarios and the binomial tree,
reply for reply; the store's weight pins. The consumers, on the port's
cluster: an LLM deployment with ``weights_name`` hot-reloaded through two
versions and an int8 one (tiny f32 Llama weights drawn by the JAX package
and carried over by ``params_from_jax``; tokens after each reload equal to
an in-process server's over the same parameters, and the reference's
replica on its own cluster serving the same tokens for the raw versions),
``LLMPredictor(weights_name=)``, ``publish_adapter`` with a
``source="weights:<prefix>"`` store, and PPO with
``use_weight_plane=True``, raw and quantized.
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np
import pytest
import torch

MODEL_KW = dict(model_id="llama-tiny", max_seq_len=64, max_new_tokens=4, seed=0)
PROMPT = [1, 2, 3, 4, 9, 17]
NEW = 4


def _is_port(rt) -> bool:
    return rt.__name__ == "ray_tpu_torch"


def _leaf(rt, a: np.ndarray):
    return torch.from_numpy(np.ascontiguousarray(a)) if _is_port(rt) else a


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _params(rt, scale=1.0, n=200_000):
    return {
        "bias": _leaf(rt, np.full(16, scale, np.float32)),
        "dense": {"w": _leaf(rt, np.arange(n, dtype=np.float32) * scale)},
    }


def _gcs_call(rt, method, *args):
    api = importlib.import_module(rt.__name__ + "._worker_api")
    worker = api.get_core_worker()
    return api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call(method, *args, timeout=10.0))


# -- the programs of tests/test_weights.py, on either runtime -----------------


def prog_publish_fetch_versions_and_staleness(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    metrics = importlib.import_module(rt.__name__ + ".util.metrics")
    pub = w.WeightPublisher("t/model")
    v1 = pub.publish(_params(rt, 1.0))
    sub = w.WeightSubscriber("t/model")
    version, got = sub.get()
    first = (v1, version, np.array_equal(_np(got["dense"]["w"]),
                                         _np(_params(rt, 1.0)["dense"]["w"])), sub.staleness())
    v2 = pub.publish(_params(rt, 2.0))
    behind = (v2, sub.staleness(), metrics.weights_staleness("t/model"))
    version, got = sub.get()
    out = first + behind + (version, np.array_equal(_np(got["bias"]), np.full(16, 2.0, np.float32)),
                            sub.staleness())
    sub.release()
    return out


def prog_multi_chunk_publish(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    pub = w.WeightPublisher("t/chunky", chunk_size=256 * 1024)
    params = {f"layer{i}": _leaf(rt, np.full(100_000, i, np.float32)) for i in range(4)}
    pub.publish(params)
    rows = {r["name"]: r for r in _gcs_call(rt, "weights_list")}
    sub = w.WeightSubscriber("t/chunky")
    _, got = sub.get()
    equal = all(np.array_equal(_np(got[f"layer{i}"]), _np(params[f"layer{i}"])) for i in range(4))
    sub.release()
    return rows["t/chunky"]["num_chunks"], equal


def prog_weight_handle_resolve(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    handle = w.publish("t/handle", _params(rt, 3.0))
    resolved = w.resolve(handle)
    return (isinstance(handle, w.WeightHandle), handle.version,
            np.array_equal(_np(resolved["bias"]), np.full(16, 3.0, np.float32)),
            w.resolve({"plain": 1}))


def prog_prefetch_adopts_instantly(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    pub = w.WeightPublisher("t/prefetch")
    pub.publish(_params(rt, 1.0))
    sub = w.WeightSubscriber("t/prefetch")
    sub.get()
    pub.publish(_params(rt, 2.0))
    prefetched = sub.prefetch(block=True)
    pulls = sub.chunk_pulls
    version, got = sub.get()  # served from the prefetched pin, no refetch
    out = (prefetched, version, np.array_equal(_np(got["bias"]), np.full(16, 2.0, np.float32)),
           sub.chunk_pulls - pulls)
    sub.release()
    return out


def prog_superseded_version_gc_waits_for_pinned_reader(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    pub = w.WeightPublisher("t/gc")
    pub.publish(_params(rt, 1.0))
    sub = w.WeightSubscriber("t/gc")
    version, _ = sub.get()
    pub.publish(_params(rt, 2.0))  # v1 pinned: not tombstoned
    resolved = _gcs_call(rt, "weights_get", "t/gc", 1)
    out = [version, resolved is not None and resolved["version"], 1 in pub._held]
    version, _ = sub.get()  # moving to head unpins v1: tombstoned and released
    out += [version, _gcs_call(rt, "weights_get", "t/gc", 1)]
    pub.collect()
    out += [1 in pub._held, 2 in pub._held]
    sub.release()
    return out


def prog_release_unpins_and_head_survives(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    pub = w.WeightPublisher("t/rel")
    pub.publish(_params(rt, 1.0))
    with w.WeightSubscriber("t/rel") as sub:
        sub.get()
    sub2 = w.WeightSubscriber("t/rel")
    version, _ = sub2.get()
    sub2.release()
    return version


def prog_publish_drains_subscriber_unpinned_versions(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    pub = w.WeightPublisher("t/drain")
    pub.publish(_params(rt, 1.0))
    sub = w.WeightSubscriber("t/drain")
    sub.get()
    pub.publish(_params(rt, 2.0))
    held = 1 in pub._held
    sub.get()
    pub.publish(_params(rt, 3.0))  # the reply delivers the queued release
    out = (held, 1 in pub._held, 2 in pub._held, 3 in pub._held)
    sub.release()
    return out


def prog_resolve_falls_back_to_head_after_gc(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    handle1 = w.publish("t/fb", _params(rt, 1.0))
    w.publish("t/fb", _params(rt, 2.0))  # no pins: v1 tombstones now
    t0 = time.monotonic()
    value = w.resolve(handle1)
    fast = time.monotonic() - t0 < 10.0
    sub = w.WeightSubscriber("t/fb")
    try:
        sub.get(1, timeout=30.0)
        raised = None
    except KeyError:
        raised = "KeyError"
    sub.release()
    return fast, np.array_equal(_np(value["bias"]), np.full(16, 2.0, np.float32)), raised


def prog_prefetch_result_losing_race_is_released(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    pv = importlib.import_module(rt.__name__ + ".weights.subscriber")._PinnedVersion
    pub = w.WeightPublisher("t/race")
    pub.publish(_params(rt, 1.0))
    sub = w.WeightSubscriber("t/race")
    sub.get()
    pub.publish(_params(rt, 2.0))
    sub.get()
    stale_offered = sub._offer_prefetched(1, pv(1, {"w": 0}, None, []))
    after_stale = dict(sub._prefetched)
    fresh_offered = sub._offer_prefetched(3, pv(3, {"w": 1}, None, []))
    out = (stale_offered, after_stale, fresh_offered, 3 in sub._prefetched)
    sub.release()
    return out


def prog_version_bytes(rt):
    """The registry's row and the subscriber's pull counts of one raw and
    one int8 version of the same leaves: chunk counts and logical bytes
    equal across the runtimes; the int8 wire bytes under half the raw."""
    w = importlib.import_module(rt.__name__ + ".weights")
    leaves = {f"l{i}": _leaf(rt, np.random.default_rng(i).standard_normal(65_536)
                             .astype(np.float32)) for i in range(3)}
    pub = w.WeightPublisher("t/bytes", chunk_size=300_000)
    rows = []
    for quantized in (False, True):
        pub.publish(leaves, quantized=quantized)
        row = {r["name"]: r for r in _gcs_call(rt, "weights_list")}["t/bytes"]
        rows.append((row["codec"], row["num_chunks"], row["total_bytes"]))
    sub = w.WeightSubscriber("t/bytes")
    sub.get()
    wire = sub.wire_bytes_pulled
    out = rows + [sub.chunk_pulls, sub.bytes_pulled, wire < 0.3 * sub.bytes_pulled]
    sub.release()
    return out


PROGRAMS = {name: fn for name, fn in dict(globals()).items() if name.startswith("prog_")}

#: what tests/test_weights.py asserts of each program (None: a new program,
#: held between the runtimes only)
EXPECTED = {
    "prog_publish_fetch_versions_and_staleness": (1, 1, True, 0, 2, 1, 1.0, 2, True, 0),
    "prog_multi_chunk_publish": (4, True),
    "prog_weight_handle_resolve": (True, 1, True, {"plain": 1}),
    "prog_prefetch_adopts_instantly": (2, 2, True, 0),
    "prog_superseded_version_gc_waits_for_pinned_reader": [1, 1, True, 2, None, False, True],
    "prog_release_unpins_and_head_survives": 1,
    "prog_publish_drains_subscriber_unpinned_versions": (True, False, True, True),
    "prog_resolve_falls_back_to_head_after_gc": (True, True, "KeyError"),
    "prog_prefetch_result_losing_race_is_released": (False, {}, True, True),
    "prog_version_bytes": None,
}


# -- the programs with a cluster of their own ---------------------------------


def own_registry_gc_survives_gcs_restart(rt, tmp):
    node = rt.init(num_cpus=2, _system_config={"gcs_storage_path": os.path.join(tmp, "gcs.db")})
    try:
        w = importlib.import_module(rt.__name__ + ".weights")
        pub = w.WeightPublisher("t/ft")
        pub.publish(_params(rt, 1.0))
        pub.publish(_params(rt, 5.0))  # supersedes and tombstones v1 (no pins)
        node.kill_gcs_for_testing()
        node.restart_gcs_for_testing()
        sub = w.WeightSubscriber("t/ft")
        version, got = sub.get(timeout=60)
        rows = {r["name"]: r for r in _gcs_call(rt, "weights_list")}
        out = (version, np.array_equal(_np(got["bias"]), np.full(16, 5.0, np.float32)),
               _gcs_call(rt, "weights_get", "t/ft", 1), rows["t/ft"]["head"])
        sub.release()
        return out
    finally:
        rt.shutdown()


def own_pin_lease_heartbeat_keeps_idle_reader_alive(rt, tmp):
    node = rt.init(num_cpus=2)
    try:
        w = importlib.import_module(rt.__name__ + ".weights")
        pub = w.WeightPublisher("t/lease")
        pub.publish(_params(rt, 1.0))
        sub = w.WeightSubscriber("t/lease")
        sub.get()
        pub.publish(_params(rt, 2.0))  # v1 superseded but pinned
        model = node.gcs.weight_registry._models["t/lease"]
        # age the registry lease and the subscriber's stamp far past the window
        model.pins[1][sub.reader_id] = time.time() - 100 * 600
        sub._current.pinned_at = 0.0
        behind = sub.staleness()  # heartbeats the v1 pin
        fresh = model.pins[1][sub.reader_id] > time.time() - 60
        pub.collect()  # a GC pass: v1 survives, its lease is fresh again
        out = (behind, fresh, _gcs_call(rt, "weights_get", "t/lease", 1) is not None)
        sub.release()
        return out
    finally:
        rt.shutdown()


def own_spill_pressure_during_inflight_subscribe(rt, tmp):
    rt.init(num_cpus=2, object_store_memory=24 * 1024 * 1024,
            _system_config={"object_transfer_native_enabled": False})
    try:
        w = importlib.import_module(rt.__name__ + ".weights")
        api = importlib.import_module(rt.__name__ + "._worker_api")
        pub = w.WeightPublisher("t/spill")
        pub.publish({"w": _leaf(rt, np.ones(1_000_000, np.float32))})  # a 4 MB chunk
        sub = w.WeightSubscriber("t/spill")
        _, got = sub.get()
        node = api.get_node()
        chunk_ids = {c.object_id for c in sub._current.manifest.chunks}
        filler = [rt.put(_leaf(rt, np.full(1_000_000, i, np.float32))) for i in range(8)]
        spilled = set(getattr(node.raylet, "_spilled", {}))
        out = (not (spilled & chunk_ids), np.array_equal(_np(got["w"]),
                                                         np.ones(1_000_000, np.float32)))
        del filler
        sub.release()
        return out
    finally:
        rt.shutdown()


OWN = {
    "own_registry_gc_survives_gcs_restart": (2, True, None, 2),
    "own_pin_lease_heartbeat_keeps_idle_reader_alive": (1, True, True),
    "own_spill_pressure_during_inflight_subscribe": (True, True),
}


def _run(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - one failing program fails its own test
        return ("raised", type(e).__name__, str(e)[:300])


# -- the consumers --------------------------------------------------------------


def _jax_params(seed):
    import jax
    import jax.numpy as jnp

    from ray_tpu.llm import LLMConfig as JaxLLMConfig
    from ray_tpu.models.llama import init_params
    from ray_tpu.parallel.sharding import unbox_params

    jcfg = JaxLLMConfig(**MODEL_KW, resources_per_replica={"CPU": 1.0},
                        model_kwargs={"dtype": jnp.float32})
    return jcfg, unbox_params(init_params(jcfg.build_model_config(), jax.random.PRNGKey(seed)))


def _port_config(**kw):
    from ray_tpu_torch.llm import LLMConfig

    return LLMConfig(**MODEL_KW, resources_per_replica={"CPU": 1.0},
                     model_kwargs={"dtype": torch.float32}, **kw)


def _port_params(jparams):
    import jax

    from ray_tpu_torch.models.convert import params_from_jax

    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           _port_config().build_model_config(), device="cpu")


def ref_llm_hot_reload(rt):
    """The reference's replica subscribed to the weight plane on its own
    cluster: tokens of v1 (PRNGKey(0)) and, after reload_weights, v2
    (PRNGKey(1))."""
    from ray_tpu import serve, weights
    from ray_tpu.llm.serving import build_llm_deployment

    jcfg, p0 = _jax_params(0)
    _, p1 = _jax_params(1)
    weights.publish("t/llm", p0)
    handle = serve.run(build_llm_deployment(jcfg, weights_name="t/llm"), name="llm-wp",
                       route_prefix=None)
    req = {"token_ids": PROMPT, "max_new_tokens": NEW}
    out = [handle.remote(req).result(timeout_s=120)["token_ids"]]
    weights.publish("t/llm", p1)
    info = handle.reload_weights.remote().result(timeout_s=120)
    out.append(handle.remote(req).result(timeout_s=120)["token_ids"])
    return out, (info["version"], info["staleness"])


def port_llm_hot_reload(rt):
    """The port's deployment through the same versions, then an int8 v3
    through reconfigure; beside it an in-process server over the same
    parameters, swapped to each version (v3: the driver's own decode of the
    published chunks)."""
    from ray_tpu_torch import serve, weights
    from ray_tpu_torch.llm import LLMServer, build_llm_deployment
    from ray_tpu_torch.llm.serving import publish_llm_weights
    from ray_tpu_torch.weights import assemble_pytree, chunk_pytree

    _, p0 = _jax_params(0)
    _, p1 = _jax_params(1)
    t0, t1 = _port_params(p0), _port_params(p1)
    cfg = _port_config()
    publish_llm_weights(cfg, t0, weights_name="t/llm")
    handle = serve.run(build_llm_deployment(cfg, weights_name="t/llm", device="cpu"),
                       name="llm-wp", route_prefix=None)
    local = LLMServer(cfg, params=t0, device="cpu")
    req = {"token_ids": PROMPT, "max_new_tokens": NEW}
    out = {"tokens": [], "local": [], "info": [], "digest": []}

    def wave():
        out["tokens"].append(handle.remote(req).result(timeout_s=120)["token_ids"])
        out["local"].append(local(dict(req))["token_ids"])
        info = handle.weights_info.remote(True).result(timeout_s=60)
        out["digest"].append(info.pop("digest"))
        out["info"].append(info)

    wave()
    publish_llm_weights(cfg, t1, weights_name="t/llm")
    out["reload"] = handle.reload_weights.remote().result(timeout_s=120)
    local.engine.swap_params(t1)
    wave()
    qcfg = _port_config(quantized=True)
    publish_llm_weights(qcfg, t1, weights_name="t/llm")
    blob, chunks, _ = chunk_pytree(t1, 1 << 30, codec="int8")
    decoded = assemble_pytree(blob, chunks, "cpu")
    handle.options(method_name="reconfigure").remote({"weights_version": None}).result(
        timeout_s=120)
    local.engine.swap_params(decoded)
    wave()
    out["rows"] = {r["name"]: r for r in weights.list_models()}["t/llm"]
    from ray_tpu_torch.llm.serving import params_digest

    out["want_digest"] = [params_digest(t0), params_digest(t1), params_digest(decoded)]
    out["decoded"], out["t1"] = decoded, t1
    return out


def port_predictor(rt):
    from ray_tpu_torch import weights
    from ray_tpu_torch.llm import LLMPredictor

    _, p0 = _jax_params(0)
    t0 = _port_params(p0)
    weights.publish("t/predictor", t0)
    batch = {"token_ids": [PROMPT, [5, 6, 7]]}
    got = LLMPredictor(_port_config(), weights_name="t/predictor", device="cpu")(batch)
    want = LLMPredictor(_port_config(), params=t0, device="cpu")(batch)
    return got["generated"], want["generated"]


def port_adapter(rt):
    """One tenant published int8 under a prefix; a store refilling from
    ``weights:<prefix>`` and a store prewarmed with the driver's decode of
    the same chunks: their bank rows, bit for bit."""
    from ray_tpu_torch.lora import AdapterStore, publish_adapter
    from ray_tpu_torch.weights import assemble_pytree, chunk_pytree

    mcfg = _port_config().build_model_config()
    rng = np.random.default_rng(7)
    tree = {f"layer_{i}": {"attn": {
        proj: {"lora_a": torch.from_numpy(rng.standard_normal((mcfg.dim, 4)).astype(np.float32)),
               "lora_b": torch.from_numpy(rng.standard_normal((4, mcfg.dim)).astype(np.float32)
                                          * 0.1)}
        for proj in ("wq", "wo")}} for i in range(mcfg.n_layers)}
    tree["layer_0"]["attn"]["wq"]["kernel"] = torch.zeros(3)  # not an adapter leaf: dropped
    handle = publish_adapter("t/lora", "tenant", tree)
    plane = AdapterStore(mcfg, max_live=2, rank=4, alpha=8.0, source="weights:t/lora",
                         device="cpu")
    lease = plane.acquire("tenant")
    only = {k: {"attn": {p: {f: t for f, t in v.items() if f.startswith("lora")}
                         for p, v in layer["attn"].items()}} for k, layer in tree.items()}
    blob, chunks, _ = chunk_pytree(only, 1 << 30, codec="int8")
    decoded = assemble_pytree(blob, chunks, "cpu")
    warm = AdapterStore(mcfg, max_live=2, rank=4, alpha=8.0, device="cpu")
    warm.prewarm("tenant", decoded)
    wlease = warm.acquire("tenant")
    same = all(torch.equal(plane.bank()[p][f][:, lease.slot], warm.bank()[p][f][:, wlease.slot])
               for p in plane.bank() for f in plane.bank()[p])
    differs = not torch.equal(decoded["layer_0"]["attn"]["wq"]["lora_a"],
                              only["layer_0"]["attn"]["wq"]["lora_a"])
    return handle.version, plane.stats()["cold_attaches"], same, differs


def port_rllib(rt, quantized):
    """PPO with the weight plane, two iterations: head >= 1; each runner's
    parameters against the learner's published copy (raw: bit for bit;
    int8: within half a quantization step of each block)."""
    from ray_tpu_torch._internal.quantization import is_quantizable, quantize_np
    from ray_tpu_torch.rllib import algorithm, env
    from ray_tpu_torch.weights import list_models

    name = f"t/ppo-{int(quantized)}"
    cfg = (algorithm.PPOConfig().environment(env.CartPoleEnv)
           .env_runners(num_env_runners=2, num_envs_per_env_runner=1,
                        rollout_fragment_length=16)
           .weight_sync(use_weight_plane=True, weight_plane_name=name, quantized=quantized))
    algo = cfg.build(device="cpu")
    try:
        results = [algo.train() for _ in range(2)]
        published = algo._broadcaster._cached
        worst = 0.0
        for runner in algo.runners:
            for key, got in runner.model.state_dict().items():
                want = published[key].float()
                err = (got.float() - want).abs()
                if quantized and is_quantizable(want):
                    # half a step of each block, and the f32 rounding of q * scale
                    qa = quantize_np(want)
                    half = np.repeat(qa.scales * (0.5 + 2.0 ** -20), 256)[:want.numel()]
                    worst = max(worst, float((err - torch.from_numpy(half).reshape(
                        want.shape)).max()))
                else:
                    worst = max(worst, float(err.max()))
        head = {r["name"]: r for r in list_models()}[name]["head"]
        return (results[0]["num_env_steps_sampled"] > 0, results[1]["training_iteration"],
                head >= 1, worst <= 0.0)
    finally:
        algo.stop()


# -- the runs ------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for key, name in (("ref", "ray_tpu"), ("port", "ray_tpu_torch")):
        rt = importlib.import_module(name)
        importlib.import_module(name + ".serve")
        rt.init(num_cpus=6)
        res = {}
        try:
            for prog, fn in PROGRAMS.items():
                res[prog] = _run(fn, rt)
            if key == "ref":
                res["llm"] = _run(ref_llm_hot_reload, rt)
            else:
                res["llm"] = _run(port_llm_hot_reload, rt)
                res["predictor"] = _run(port_predictor, rt)
                res["adapter"] = _run(port_adapter, rt)
                res["rllib"] = [_run(port_rllib, rt, q) for q in (False, True)]
        finally:
            try:
                rt.serve.shutdown()
            finally:
                rt.shutdown()
        for prog, fn in OWN.items():
            res[prog] = _run(globals()[prog], rt, str(tmp_path_factory.mktemp(f"{key}-{prog}")))
        out[key] = res
    return out


@pytest.mark.parametrize("name", list(EXPECTED) + list(OWN))
def test_program_matches_reference(runs, name):
    want = EXPECTED.get(name, OWN.get(name))
    if want is not None:
        assert runs["ref"][name] == want
    assert runs["port"][name] == runs["ref"][name]


def test_chunk_boundaries_wire_bytes_and_int8_codes_match_reference():
    """``chunk_pytree`` on the same leaves (f32, f64, an int32 scalar, a
    tiny float leaf that stays raw): the same chunks (leaves a chunk, their
    logical and wire bytes), and the int8 codes and scales bit for bit."""
    from ray_tpu.weights.manifest import chunk_pytree as ref_chunk
    from ray_tpu_torch._internal.quantization import QuantizedArray
    from ray_tpu_torch.weights.manifest import (
        assemble_pytree, chunk_pytree, leaf_logical_nbytes, leaf_wire_nbytes)
    from ray_tpu.weights.manifest import leaf_logical_nbytes as ref_logical
    from ray_tpu.weights.manifest import leaf_wire_nbytes as ref_wire

    rng = np.random.default_rng(3)
    leaves = {"a": np.arange(1000, dtype=np.float32), "b": np.ones((100, 10), np.float64),
              "c": np.int32(7), "d": rng.standard_normal((64, 33)).astype(np.float32),
              "e": rng.standard_normal(8).astype(np.float32)}
    port = {k: torch.from_numpy(np.asarray(v)) for k, v in leaves.items()}
    for codec, size in (("raw", 5000), ("int8", 5000), ("int8", 1 << 20)):
        _, want, want_total = ref_chunk(leaves, size, codec=codec)
        blob, got, total = chunk_pytree(port, size, codec=codec)
        assert total == want_total
        assert [len(c) for c in got] == [len(c) for c in want]
        for gc, wc in zip(got, want):
            assert [leaf_logical_nbytes(x) for x in gc] == [ref_logical(x) for x in wc]
            assert [leaf_wire_nbytes(x) for x in gc] == [ref_wire(x) for x in wc]
            for g, w in zip(gc, wc):
                if isinstance(g, QuantizedArray):
                    assert np.array_equal(_np(g.q), w.q) and np.array_equal(_np(g.scales),
                                                                            w.scales)
                else:
                    assert np.array_equal(_np(g), np.asarray(w))
        back = assemble_pytree(blob, got)
        if codec == "raw":
            assert all(np.array_equal(_np(back[k]), np.asarray(leaves[k])) for k in leaves)
    assert total == 4000 + 8000 + 4 + 64 * 33 * 4 + 32


def test_manifest_blob_and_reshard():
    """``Manifest`` round-trips through its blob; ``reshard`` takes a device,
    a pytree of devices or a callable giving them."""
    from ray_tpu_torch.weights import ChunkInfo, Manifest, reshard

    m = Manifest(name="m", version=3, treedef_blob=b"x",
                 chunks=[ChunkInfo(b"id", ("h", 1), 10, 2, "int8", 40)], total_bytes=40,
                 codec="int8", wire_bytes=10)
    assert Manifest.from_blob(m.to_blob()) == m
    tree = {"a": torch.ones(2, dtype=torch.float64), "b": [torch.zeros(1), 5]}
    for device in ("cpu", torch.device("cpu"), lambda v: "cpu",
                   {"a": "cpu", "b": ["cpu", None]}):
        out = reshard(tree, device)
        assert torch.equal(out["a"], tree["a"]) and out["b"][1] == 5
    assert reshard(tree, None) is tree
    from ray_tpu.weights import broadcast as ref_bcast
    from ray_tpu.weights.manifest import ChunkInfo as RefChunkInfo
    from ray_tpu_torch.weights import broadcast

    rows = [(b"a", ("h", 1), 10, 2, "int8", 40), (b"b", ("h", 1), 7, 1, "raw", 0)]
    got = [ChunkInfo(*r) for r in rows]
    want = [RefChunkInfo(*r) for r in rows]
    assert (broadcast.version_wire_bytes(got), broadcast.version_logical_bytes(got)) == (
        ref_bcast.version_wire_bytes(want), ref_bcast.version_logical_bytes(want)) == (17, 47)


def test_binomial_tree_and_registry_scenarios_match_reference():
    """tests/test_weights.py's registry units (the release queue, the
    publish reply's queued releases, lease expiry, tree pruning) and the
    tree's shape, reply for reply on both registries."""
    from ray_tpu._internal.config import Config as RefConfig
    from ray_tpu.runtime.gcs import weight_registry as ref_reg
    from ray_tpu_torch._internal.config import Config
    from ray_tpu_torch.runtime.gcs import weight_registry as port_reg

    assert [port_reg._tree_parent(p) for p in range(64)] == [
        ref_reg._tree_parent(p) for p in range(64)]
    assert [port_reg._tree_depth(n) for n in range(1, 64)] == [
        ref_reg._tree_depth(n) for n in range(1, 64)]

    class _Gcs:
        def __init__(self, config_cls, **over):
            self.storage = type("S", (), {"put": lambda *a: None, "delete": lambda *a: None,
                                          "get_all": lambda *a: {}})()
            self.publisher = type("P", (), {"publish": lambda *a: None})()
            self.config = config_cls()
            for k, v in over.items():
                setattr(self.config, k, v)

    def scenario(mod, config_cls):
        out = []
        reg = mod.GcsWeightRegistry(_Gcs(config_cls))
        out.append(reg.publish("m", b"m1"))
        reg.pin("m", 1, "reader-a")
        out.append(reg.publish("m", b"m2"))
        reg.unpin("m", 1, "reader-a")
        out += [reg.get("m", 1), reg.collect("m"), reg.collect("m")]
        reg.pin("m", 2, "r")
        out.append(reg.publish("m", b"m3"))
        reg.unpin("m", 2, "r")
        out.append(reg.publish("m", b"m4"))
        lease = mod.GcsWeightRegistry(_Gcs(config_cls, weights_pin_lease_s=0.05))
        lease.publish("m", b"m1")
        lease.pin("m", 1, "dead-reader")
        lease.publish("m", b"m2")
        out.append(lease.get("m", 1) is not None)
        time.sleep(0.06)
        out += [lease.collect("m"), lease.get("m", 1)]
        tree = mod.GcsWeightRegistry(_Gcs(config_cls))
        tree.publish("m", b"m1")
        a, b, c = ("n1", 1), ("n2", 1), ("n3", 1)
        out += [tree.plan("m", a), tree.plan("m", b), tree.plan("m", c)]
        tree.on_node_death(a)
        out += [tree.plan("m", b), tree.plan("m", c)]
        tree.report_fallback("m", b)
        out.append(tree.plan("m", c))
        tree.report_fallback("m", b)
        out.append(tree.plan("m", c))
        return out

    got, want = scenario(port_reg, Config), scenario(ref_reg, RefConfig)
    assert got == want
    assert want[3]["released"] == [1] and want[-1]["position"] == 0


def test_store_weight_pin_exempt_from_spill_and_eviction():
    """tests/test_weights.py's unit on the port's store: a weight-pinned
    object is neither spillable nor evictable until unpinned."""
    from ray_tpu_torch._internal.ids import ObjectID
    from ray_tpu_torch.exceptions import ObjectStoreFullError
    from ray_tpu_torch.runtime.object_store.store import ObjectStore

    store = ObjectStore(capacity_bytes=1000, session_id="wpin")
    chunk = ObjectID.from_random()
    store.create_and_write(chunk, b"w" * 400)
    store.pin_primary(chunk)
    assert store.lru_spillable() == chunk
    assert store.pin_weight(chunk)
    assert store.lru_spillable() is None
    other = ObjectID.from_random()
    store.create_and_write(other, b"o" * 400)
    with pytest.raises(ObjectStoreFullError):
        store.create(ObjectID.from_random(), 900)
    assert store.contains(chunk)
    assert store.free_if_unpinned(chunk) is False
    store.unpin_weight(chunk)
    assert store.lru_spillable() == chunk
    store.shutdown()


def test_llm_serve_hot_reload(runs):
    """A deployment with ``weights_name`` serves v1, then v2 after
    ``reload_weights`` and the int8 v3 after ``reconfigure``: each wave's
    tokens equal the in-process server's over the same parameters, and the
    raw waves the reference's replica's; each replica digest is the
    driver's, bit for bit; the registry's last version is int8."""
    ref_tokens, ref_info = runs["ref"]["llm"]
    got = runs["port"]["llm"]
    assert got["tokens"] == got["local"]
    assert got["tokens"][:2] == ref_tokens and ref_info == (2, 0)
    assert got["reload"] == {"version": 2, "staleness": 0}
    assert [i["version"] for i in got["info"]] == [1, 2, 3]
    assert [i["codec"] for i in got["info"]] == ["raw", "raw", "int8"]
    assert [i["staleness"] for i in got["info"]] == [0, 0, 0]
    assert [i["chunk_pulls"] for i in got["info"]] == [1, 2, 3]
    assert got["digest"] == got["want_digest"]
    assert got["rows"]["head"] == 3 and got["rows"]["codec"] == "int8"
    assert got["info"][2]["wire_bytes_pulled"] - got["info"][1]["wire_bytes_pulled"] < 0.3 * (
        got["info"][2]["bytes_pulled"] - got["info"][1]["bytes_pulled"])


def test_llm_reload_logits_match_reference():
    """The weights a reload swaps in give the reference's f32 logits: the
    port's model over v2 carried by ``params_from_jax`` against the JAX
    model over PRNGKey(1), within 1e-5."""
    from ray_tpu.models.llama import Llama as JaxLlama
    from ray_tpu_torch.llm import LLMServer

    jcfg, p1 = _jax_params(1)
    import jax.numpy as jnp

    want = np.asarray(JaxLlama(jcfg.build_model_config()).apply(
        {"params": p1}, jnp.asarray([PROMPT])))
    server = LLMServer(_port_config(), params=_port_params(_jax_params(0)[1]), device="cpu")
    server.engine.swap_params(_port_params(p1))
    from ray_tpu_torch.models.llama import build_llama

    got = build_llama(server.engine._cfg, server.engine._params)(torch.tensor([PROMPT]))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)


def test_predictor_takes_weights_name(runs):
    got, want = runs["port"]["predictor"]
    assert got == want and len(got) == 2


def test_publish_adapter_refills_slot_from_weights(runs):
    version, cold, same, differs = runs["port"]["adapter"]
    assert (version, cold, same, differs) == (1, 1, True, True)


@pytest.mark.parametrize("quantized", [False, True], ids=["raw", "int8"])
def test_rllib_weight_plane_mode(runs, quantized):
    assert runs["port"]["rllib"][int(quantized)] == (True, 2, True, True)


def test_swap_params_reads_only_the_new_weights():
    """``swap_params`` on both engines: the next requests give a fresh
    server's tokens over the new weights (the paged engine's cached
    prefixes, K/V of the old weights, are dropped first, and so are never
    hit), and the engine lets go of the old tensors."""
    import gc
    import weakref

    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.llama import init_params

    mcfg = _port_config().build_model_config()
    prompt = list(range(3, 30))
    req = {"token_ids": prompt, "max_new_tokens": NEW}
    for paged in (False, True):
        kw = dict(kv_cache_blocks=16, kv_block_size=8) if paged else {}
        old = init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
        new = init_params(mcfg, torch.Generator().manual_seed(1), device="cpu")
        server = LLMServer(_port_config(**kw), params=old, device="cpu")
        probe = weakref.ref(old["embed"])
        before = server(dict(req))["token_ids"]
        del old
        server.engine.swap_params(new)
        gc.collect()
        assert probe() is None  # the old weights are freed
        fresh = LLMServer(_port_config(**kw), params=new, device="cpu")
        assert server(dict(req))["token_ids"] == fresh(dict(req))["token_ids"] != before
        if paged:
            stats = server.kvcache_stats()
            assert stats["prefix_hit_tokens"] == 0 and stats["evictions"] == 3
            assert stats["index_nodes"] == 3  # the second request's own blocks
    with pytest.raises(ValueError, match="engine on"):
        server.engine.swap_params({k: v.to("meta") for k, v in new.items()})


def test_shipment_of_other_weights_is_a_recompute():
    """A decode side keyed by another weights version (mid-rollout) does
    not adopt the shipment: a counted recompute."""
    from ray_tpu_torch.kvtier import KVTierClient, LocalTierBackend
    from ray_tpu_torch.util import metrics

    backend = LocalTierBackend()
    payload = {"blocks": [torch.ones(2, 8, 2, 4)], "tail": None}
    v1 = KVTierClient("m@w:v1", backend, 8, holder_id="p", device="cpu")
    ship = v1.ship_direct(list(range(8)), payload, 1, first_token=3)
    same = KVTierClient("m@w:v1", backend, 8, holder_id="d1", device="cpu")
    other = KVTierClient("m@w:v2", backend, 8, holder_id="d2", device="cpu")
    before = metrics.kvtier_counters()
    assert torch.equal(same.fetch_shipment(ship)["blocks"][0], payload["blocks"][0])
    assert other.fetch_shipment(ship) is None
    after = metrics.kvtier_counters()
    assert (after["peer_pull"] - before["peer_pull"], after["recompute"] - before["recompute"]) == (
        1.0, 1.0)
