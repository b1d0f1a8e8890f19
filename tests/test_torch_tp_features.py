"""The serving features of a tensor-parallel replica (adapters, the KV tier,
disaggregated roles, ``LLMPredictor``) against ray_tpu's under its tp=2
plan, on the CPU.

Both sides take the reference's ``PRNGKey(0)`` weights of
``LlamaConfig.tiny(max_seq_len=128)`` (carried over by ``params_from_jax``
and sliced per rank by the plan), f32 activations (so that greedy argmax
ties in bf16 cannot split the token streams, as in test_torch_llm.py),
rank-4 adapters from numpy seeds at a scale that moves the tiny model's
argmaxes, blocks of 8 tokens and prompts with and without a tail. The
reference serves through ``_LLMReplica`` at ``tensor_parallel_size=2`` on
two of the host devices conftest makes; the port through
``LLMServer(tensor_parallel_size=2, devices=["cpu", "cpu"],
tp_backend="gloo")``, this process rank 0 and rank 1 spawned. A process
holds one such server at a time: the fused one is built once for the module
and closed by the disaggregation test, which then builds its role servers
one after the other. Every child process is joined within ``_DEADLINE_S``.
Greedy tokens, store and KV counters must be equal; copied values (bank
rows, a row's payload gathered over the ranks) equal exactly.
"""

import multiprocessing
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu._internal import serialization as jserialization
from ray_tpu.kvcache import KVCacheManager as JaxKVCacheManager
from ray_tpu.kvtier import KVShipment as JaxKVShipment
from ray_tpu.kvtier import LocalTierBackend as JaxLocalTierBackend
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMPredictor as JaxPredictor
from ray_tpu.llm.serving import _LLMReplica
from ray_tpu.lora import adapter_target_paths as jax_target_paths
from ray_tpu.models.llama import Llama as JaxLlama
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu.util import metrics as jmetrics
from ray_tpu.weights import manifest as jmanifest
from ray_tpu_torch.kvtier import KVShipment, LocalTierBackend, block_fingerprints, decode_payload
from ray_tpu_torch.llm import LLMConfig, LLMPredictor, LLMServer
from ray_tpu_torch.llm.serving import _DisaggIngress
from ray_tpu_torch.models.convert import cache_from_jax, params_from_jax
from ray_tpu_torch.models.llama import PROJECTIONS, DecodeCache, LlamaConfig
from ray_tpu_torch.util import metrics
from ray_tpu_torch.weights import manifest

_DEADLINE_S = 60.0
_CPU2 = ["cpu", "cpu"]
_SEED, _BLOCKS, _BLOCK, _NEW = 7, 32, 8, 6
_RANK, _ALPHA, _LIVE = 4, 8.0, 3
_TENANTS = ("t1", "t2", "t3", "t4")
_PROMPT = list(range(5, 32))  # 27 tokens: 3 blocks and a tail of 3
_KW = dict(model_id="llama-tiny", max_seq_len=128, max_batch_size=4, seed=_SEED,
           max_new_tokens=_NEW, kv_cache_blocks=_BLOCKS, kv_block_size=_BLOCK)

#: child processes of this one from before the module's tests
_EARLIER_CHILDREN = set()


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    """One intra-op thread a CPU rank (see test_torch_tp_serving.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _EARLIER_CHILDREN.update(multiprocessing.active_children())
    yield
    torch.set_num_threads(threads)


def _join_children():
    ours = set(multiprocessing.active_children()) - _EARLIER_CHILDREN
    for p in ours:
        p.join(_DEADLINE_S)
    left = set(multiprocessing.active_children()) - _EARLIER_CHILDREN
    assert not left, f"child processes left: {left}"


def _tree(cfg, seed, rank=_RANK):
    rng = np.random.default_rng(seed)
    tree = {}
    for path, d_in, d_out in jax_target_paths(cfg):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {
            "lora_a": rng.normal(0.0, 0.5, (d_in, rank)).astype(np.float32),
            "lora_b": rng.normal(0.0, 0.5, (rank, d_out)).astype(np.float32),
        }
    return tree


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxLlamaConfig.tiny(max_seq_len=128, dtype=jnp.float32)
    jparams = unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = LlamaConfig.tiny(max_seq_len=128, dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    trees = {t: _tree(jcfg, seed) for seed, t in enumerate(_TENANTS, start=1)}
    return dict(jcfg=jcfg, jparams=jparams, tcfg=tcfg, tparams=tparams, trees=trees,
                blob=jserialization.dumps(jparams))


def _configs(weights, **kw):
    """The reference's and the port's LLMConfig of the same fields."""
    return (JaxLLMConfig(**_KW, **kw, model_kwargs={"dtype": jnp.float32}),
            LLMConfig(**_KW, **kw, model_kwargs={"dtype": torch.float32}))


def _replica(weights, cfg, **kw):
    return _LLMReplica(cfg, params_blob=weights["blob"], **kw)


def _server(weights, cfg, **kw):
    if cfg.effective_parallelism()[0] > 1:
        return LLMServer(cfg, params=weights["tparams"], devices=_CPU2, tp_backend="gloo", **kw)
    return LLMServer(cfg, params=weights["tparams"], device="cpu", **kw)


@pytest.fixture(scope="module")
def fused(weights):
    """The tp=2 fused replica of each package, on the KV tier of its own
    ``LocalTierBackend`` and with an adapter store of 3 slots filled from a
    callable source, built once: (reference, port, their backends)."""
    adapters = {"max_live": _LIVE, "slot_rank": _RANK, "alpha": _ALPHA,
                "source": weights["trees"].__getitem__}
    jcfg, cfg = _configs(weights, tensor_parallel_size=2, kv_tier=True, adapters=adapters)
    jbackend, backend = JaxLocalTierBackend(), LocalTierBackend()
    ref = _replica(weights, jcfg, tier_backend=jbackend)
    port = _server(weights, cfg, tier_backend=backend)
    yield ref, port, jbackend, backend
    port.close()
    _join_children()


def _ask(server, prompt, aid=None, **kw):
    return server({"token_ids": list(prompt), "max_new_tokens": _NEW, "adapter_id": aid,
                   **kw})["token_ids"]


def _store_stats(server):
    return {k: v for k, v in server.adapters_stats().items() if k != "last_attach_ms"}


# -- the slot bank -------------------------------------------------------------


def _bank_rows(engine, slot):
    """On every rank: its bank's row ``slot``, by projection and factor."""
    bank = engine._adapter_store.bank()
    return {(proj, factor): bank[proj][factor][:, slot].numpy().copy()
            for proj in PROJECTIONS for factor in ("lora_a", "lora_b")}


def _assert_bank_rows_are_reference_shards(ref, port, aid):
    """Each rank's bank row of ``aid`` equals the reference's shard of its
    bank on that rank's device, exactly (the same f32 copies of the tree,
    lora_b scaled by alpha/rank in f32 on both sides)."""
    slot = port.adapter_store._slot_of[aid]
    jstore = ref._adapter_store
    assert jstore._slot_of[aid] == slot
    devices = list(ref._plan.mesh.devices.flat)
    h = 4 * 32  # n_heads * head_dim of the tiny model
    for rank, rows in enumerate(port.ranks.run(_bank_rows, slot)):
        for (proj, factor), got in rows.items():
            for layer in range(got.shape[0]):
                leaf = jstore.bank()[f"layer_{layer}"]["attn"][proj][factor]
                shard = next(s for s in leaf.addressable_shards if s.device == devices[rank])
                np.testing.assert_array_equal(got[layer], np.asarray(shard.data)[slot],
                                              err_msg=f"rank {rank} {proj} {factor}")
        # sharded alongside the base kernels: wq/wk/wv lora_b on the output
        # (head) dim, wo lora_a on the input dim, the rest replicated
        assert rows[("wq", "lora_b")].shape == (2, _RANK, h // 2)
        assert rows[("wq", "lora_a")].shape == (2, 128, _RANK)
        assert rows[("wo", "lora_a")].shape == (2, h // 2, _RANK)
        assert rows[("wo", "lora_b")].shape == (2, _RANK, 128)


def test_bank_slices_are_the_reference_shards(fused, weights):
    """(1) A prewarmed adapter: each rank's bank holds the reference's
    ``addressable_shards`` of ``AdapterStore(plan=)`` on that rank's device;
    the stores' counters and tags are equal."""
    ref, port, _, _ = fused
    for server in (ref, port):
        server._adapter_store.prewarm("t1", weights["trees"]["t1"])
    _assert_bank_rows_are_reference_shards(ref, port, "t1")
    assert _store_stats(port) == {k: v for k, v in ref.adapters_stats().items()
                                  if k != "last_attach_ms"}
    assert port.adapters_stats()["mesh"] == "tp=2"


def _echo(engine, arr):
    """On every rank: its rank and what it was sent."""
    return engine._plan.rank, arr


def test_large_commands_and_replies_travel_in_pieces(fused):
    """The store refuses a value over 8 MiB (a 7B rank-16 adapter's slices
    are 25 MB a rank): a command and a reply of 9 MiB arrive whole."""
    _, port, _, _ = fused
    arr = np.random.default_rng(0).integers(0, 255, 9 << 20, dtype=np.uint8)
    for rank, (got_rank, got) in enumerate(port.ranks.run(_echo, arr)):
        assert got_rank == rank
        np.testing.assert_array_equal(got, arr)


def _wave(server, tenants, prompt):
    """The same prompt for each tenant, one thread each: (tokens by
    tenant, KV counter deltas)."""
    before = server.kvcache_stats()
    out = {}

    def one(aid):
        out[aid] = _ask(server, prompt, aid)

    threads = [threading.Thread(target=one, args=(aid,)) for aid in tenants]
    for t in threads:
        t.start()
    for t in threads:
        t.join(_DEADLINE_S)
    after = server.kvcache_stats()
    return out, {k: after[k] - before[k] for k in ("prefix_hit_tokens",
                                                   "prefill_tokens_computed")}


def test_mixed_adapters_match_reference(fused):
    """(2) The base model and three tenants on one prompt, from four
    threads and then again: the tp=2 server's greedy tokens are the
    reference's tp=2 ``ContinuousBatchingEngine(plan=, adapter_store=)``'s,
    every tenant's its own, and the salted prefix accounting is equal (one
    miss a key space, then hits)."""
    ref, port, _, _ = fused
    tenants = (None, "t1", "t2", "t3")
    for _ in range(2):
        (want, jd), (got, d) = [_wave(s, tenants, _PROMPT) for s in (ref, port)]
        assert got == want and d == jd
        assert len({tuple(v) for v in got.values()}) == len(tenants)
    assert d == {"prefix_hit_tokens": 4 * 24, "prefill_tokens_computed": 4 * 3}
    assert port.adapters_stats()["slots_pinned"] == 0
    assert port.ranks.failed is None


def test_cold_attach_while_stepping_then_evict_and_reattach(fused, weights):
    """(3) With t1, t2, t3 resident (t1 the oldest), t4 attaches cold from
    the source while a base stream steps the pool (the slices reach rank 1
    through the store between the stream's steps), evicting t1; then t1
    comes back, evicting t2. Tokens, counters and every rank's bank rows
    against the reference's."""
    ref, port, _, _ = fused
    for server in (ref, port):  # the LRU order: t1, t2, t3
        for aid in ("t1", "t2", "t3"):
            server._adapter_store.release(server._adapter_store.acquire(aid))
    long_new = 40
    want_stream = _ask(ref, _PROMPT, max_new_tokens=long_new)
    seen, first = [], threading.Event()

    def stream():
        for item in port.stream({"token_ids": _PROMPT, "max_new_tokens": long_new}):
            if "token_id" in item:
                seen.append(item["token_id"])
                first.set()

    t = threading.Thread(target=stream)
    t.start()
    assert first.wait(_DEADLINE_S)
    at_start = len(seen)
    lease = port.adapter_store.acquire("t4")
    at_end = len(seen)
    t.join(_DEADLINE_S)
    assert at_end < long_new  # the stream was still stepping when t4 had attached
    assert seen == want_stream and at_start >= 1
    port.adapter_store.release(lease)
    ref._adapter_store.release(ref._adapter_store.acquire("t4"))
    for aid in ("t4", "t1"):
        assert _ask(port, _PROMPT, aid) == _ask(ref, _PROMPT, aid)
        _assert_bank_rows_are_reference_shards(ref, port, aid)
    stats = _store_stats(port)
    assert stats == {k: v for k, v in ref.adapters_stats().items() if k != "last_attach_ms"}
    assert stats["resident"] == ["t1", "t3", "t4"] and stats["evictions"] >= 2
    assert port.ranks.failed is None


def _bank_snapshot(engine):
    return {(proj, factor): t.numpy().copy()
            for proj, pair in engine._adapter_store.bank().items() for factor, t in pair.items()}


def test_failed_load_leaves_every_rank_s_bank_as_it_was(fused, weights):
    """(7) An adapter the source does not know (the source raises) and one
    of the wrong rank (the store refuses it) attach nowhere: every rank's
    bank is as it was, the store's counters are the reference's (the slot
    taken goes back to the free list, an eviction made for it stands), and
    the replica serves on."""
    ref, port, _, _ = fused
    banks = port.ranks.run(_bank_snapshot)
    bad = _tree(weights["jcfg"], 9, rank=_RANK + 1)
    for side in (ref, port):
        with pytest.raises(KeyError, match="nope"):
            side._adapter_store.acquire("nope")
        with pytest.raises(ValueError, match="shape"):
            side._adapter_store.acquire("t9", tree=bad)
    after = port.ranks.run(_bank_snapshot)
    for rank, (b0, b1) in enumerate(zip(banks, after)):
        for key in b0:
            np.testing.assert_array_equal(b0[key], b1[key], err_msg=f"rank {rank} {key}")
    stats = _store_stats(port)
    assert stats == {k: v for k, v in ref.adapters_stats().items() if k != "last_attach_ms"}
    assert stats["slots_free"] == 1 and stats["cold_attaches"] == 5
    assert _ask(port, _PROMPT, "t3") == _ask(ref, _PROMPT, "t3")


def test_attaches_from_threads_while_stepping(fused):
    """A stress of the attach command beside the steps: three threads send
    requests naming four tenants over three slots (cold attaches and
    evictions on the callers' threads, each publishing its slices between
    the stepping thread's steps) under a short switch interval; every
    answer is the reference's tokens for its tenant and the ranks never
    disagree."""
    ref, port, _, _ = fused
    want = {aid: _ask(ref, _PROMPT, aid) for aid in _TENANTS}
    got, errors = [], []

    def client(k):
        try:
            for j in range(2):
                aid = _TENANTS[(k + j) % len(_TENANTS)]
                got.append((aid, _ask(port, _PROMPT, aid)))
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(_DEADLINE_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(got) == 6 and all(tokens == want[aid] for aid, tokens in got)
    assert port.ranks.failed is None and port.adapters_stats()["slots_pinned"] == 0


# -- the KV tier ---------------------------------------------------------------


def _registered_payload(backend, shipment_cls, prompt, fetch):
    fps = block_fingerprints(prompt, _BLOCK)
    got = backend.resolve("llama-tiny", fps[::-1])
    assert got is not None and got["fp"] == fps[-1]
    ship = shipment_cls.from_blob(got["blob"])
    return ship, fetch(ship)


def _tier_round(server, fresh, prompt, counters):
    """The tp=2 server computes ``prompt`` and exports it; a fresh tp=1
    server on the same tier pulls it: (tokens of both, counter deltas)."""
    c0 = counters()
    out = (_ask(server, prompt), _ask(fresh, prompt))
    c1 = counters()
    return out, {k: c1[k] - c0[k] for k in c1}


def test_tp2_export_pulled_at_tp1_matches_reference(fused, weights):
    """(4) The tp=2 fused server exports a 27-token prompt (3 blocks and a
    tail) to its tier; a fresh tp=1 server on the same tier serves it with
    0 prefill tokens. Tokens and the tier and KV counter deltas equal the
    reference's; the shipment carries all 4 KV heads, its K/V within f32
    rounding of the reference's (each side computed its own prefill: the
    tiny model's K/V are of size ~1 and f32 holds ~7 digits)."""
    ref, port, jbackend, backend = fused
    prompt = list(range(40, 67))
    jcfg, cfg = _configs(weights, kv_tier=True)
    jfresh = _replica(weights, jcfg, tier_backend=jbackend)
    fresh = _server(weights, cfg, tier_backend=backend)
    want, jd = _tier_round(ref, jfresh, prompt, lambda: {
        **jmetrics.kvtier_counters(), **jmetrics.kvcache_counters()})
    got, d = _tier_round(port, fresh, prompt, lambda: {
        **metrics.kvtier_counters(), **metrics.kvcache_counters()})
    assert got == want and got[0] == got[1]
    assert d == jd
    assert fresh.kvcache_stats()["prefill_tokens_computed"] == 0
    assert fresh.kvcache_stats()["adopted_blocks"] == 3
    ship, payload = _registered_payload(backend, KVShipment, prompt,
                                        lambda s: backend.fetch_payload(s, ("local", 0), "cpu"))
    jship, jpayload = _registered_payload(jbackend, JaxKVShipment, prompt,
                                          lambda s: jbackend.fetch_payload(s, ("local", 0)))
    assert (ship.nblocks, ship.tail_len, ship.logical_bytes) == (
        jship.nblocks, jship.tail_len, jship.logical_bytes) == (3, 3, ship.logical_bytes)
    assert payload["blocks"][0].shape == (3, 2, 4, _BLOCK, 32)
    # 2e-5: f32 rounding of K/V of size ~1 that each side computed itself
    _assert_payload_maps(payload, jpayload, 27, atol=2e-5)


def _payload_leaves(payload):
    """(layer, 0 for K / 1 for V) -> (blocks, tail) of the port's payload."""
    n_layers = payload["blocks"][0].shape[1]
    return {(layer, kv): (payload["blocks"][kv][:, layer],
                          payload["tail"][2 * layer + kv] if payload["tail"] else None)
            for layer in range(n_layers) for kv in (0, 1)}


def _assert_payload_maps(got, want, ntokens, atol=0.0):
    """The port's payload against the reference's, leaf by leaf: the
    reference's leaves of a 2-layer row are (layer 0 K, V, layer 1 K, V)."""
    leaves = _payload_leaves(got)
    order = [(layer, kv) for layer in range(2) for kv in (0, 1)]
    for i, key in enumerate(order):
        blocks, tail = leaves[key]
        np.testing.assert_allclose(blocks.numpy(), np.asarray(want["blocks"][i]), rtol=0,
                                   atol=atol)
        if ntokens % _BLOCK:
            np.testing.assert_allclose(tail.numpy(), np.asarray(want["tail"][i]), rtol=0,
                                       atol=atol)
        else:
            assert tail is None and want["tail"] is None


def _gather_row(engine, key, value, index, ntokens):
    """On every rank: its heads of a full-head row, extracted and gathered
    to rank 0, then scattered back. Returns (rank 0's gathered payload or
    None, whether the scattered payload is this rank's own extract)."""
    plan, kv = engine._plan, engine._kv
    row = DecodeCache(plan.kv_head_shard(key, 2).clone(), plan.kv_head_shard(value, 2).clone(),
                      index.clone())
    mine = kv.extract_row_payload(row, ntokens)
    full = kv.gather_payload(mine)
    back = kv.scatter_payload(full, ntokens // kv.block_size, ntokens)
    same = all(torch.equal(a[0], b[0]) and (a[1] is None or torch.equal(a[1], b[1]))
               for a, b in zip(_payload_leaves(back).values(), _payload_leaves(mine).values()))
    return full, same


@pytest.mark.parametrize("ntokens", [27, 24, 5], ids=["blocks_and_tail", "blocks", "tail"])
def test_gathered_payload_is_the_reference_s_under_its_plan(fused, weights, ntokens):
    """One prefill row of the reference's model, carried over whole: its
    heads split over the ranks, extracted and gathered to rank 0 through
    the group, is the reference's ``extract_row_payload`` of the row under
    its tp=2 plan, exactly for raw, and with equal int8 codes (so equal
    dequantized values, group by group); scattered back, each rank gets
    its own heads."""
    ref, port, _, _ = fused
    jcfg, jparams, tcfg = weights["jcfg"], weights["jparams"], weights["tcfg"]
    _, v = JaxLlama(jcfg, None, decode=True).apply(
        {"params": jparams}, jnp.asarray([list(range(50, 77))]), mutable=["cache"])
    jrow = jax.device_put(v["cache"], ref._plan.cache_shardings(v["cache"]))
    want = JaxKVCacheManager(16, _BLOCK, plan=ref._plan).extract_row_payload(jrow, ntokens)
    row = cache_from_jax(jax.tree_util.tree_map(np.asarray, v["cache"]), tcfg, "cpu")
    (got, same0), (none, same1) = port.ranks.run(_gather_row, row.key, row.value, row.index,
                                                 ntokens)
    assert none is None and same0 and same1
    _assert_payload_maps(got, want, ntokens)
    blob, chunks, _ = manifest.chunk_pytree(got, 1 << 22, "int8")
    jblob, jchunks, _ = jmanifest.chunk_pytree(want, 1 << 22, "int8")
    _assert_payload_maps(decode_payload(blob, chunks), jmanifest.assemble_pytree(jblob, jchunks),
                         ntokens)


# -- disaggregated roles across layouts ----------------------------------------


def _handoff(ingress, decode, prompts):
    """Each prompt through the ingress: (tokens, the decode side's prefill
    tokens computed and blocks adopted)."""
    s0 = decode.kvcache_stats()
    out = [ingress({"token_ids": p, "max_new_tokens": _NEW})["token_ids"] for p in prompts]
    s1 = decode.kvcache_stats()
    return out, (s1["prefill_tokens_computed"] - s0["prefill_tokens_computed"],
                 s1["adopted_blocks"] - s0["adopted_blocks"])


def test_disaggregation_across_layouts(fused, weights):
    """(5) ``_DisaggIngress`` over a tp=2 prefill server and a tp=1 decode
    server, then over a tp=1 prefill server and a tp=2 decode server (the
    fused server closed first: one tensor-parallel server a process): the
    reference's tp=2 fused tokens, and the decode side computes no prefill
    token and adopts every shipped block (a shipment carries all KV heads
    whatever the layout)."""
    ref, port, _, _ = fused
    port.close()
    assert not dist.is_initialized()
    _join_children()
    prompts = [list(range(70, 97)), list(range(100, 116))]  # 3 blocks + 3, 2 blocks
    want = [_ask(ref, p) for p in prompts]
    roles = {"prefill": 1, "decode": 1}
    for pre_tp, dec_tp in ((2, 1), (1, 2)):
        backend = LocalTierBackend()
        _, pre_cfg = _configs(weights, roles=roles, tensor_parallel_size=pre_tp)
        _, dec_cfg = _configs(weights, roles=roles, tensor_parallel_size=dec_tp)
        pre = _server(weights, pre_cfg, role="prefill", tier_backend=backend)
        dec = _server(weights, dec_cfg, role="decode", tier_backend=backend)
        try:
            got, (computed, adopted) = _handoff(_DisaggIngress(pre, dec), dec, prompts)
            assert got == want, (pre_tp, dec_tp)
            assert (computed, adopted) == (0, 3 + 2), (pre_tp, dec_tp)
            assert pre.kvtier_stats()["role"] == "prefill"
            assert dec.kvtier_stats()["role"] == "decode"
        finally:
            pre.close()
            dec.close()
        assert not dist.is_initialized()
        _join_children()


# -- LLMPredictor --------------------------------------------------------------


def test_predictor_ignores_tensor_parallel_size(weights):
    """(6) As the reference's, ``LLMPredictor`` reads no
    ``tensor_parallel_size``: one engine on one device, no rank spawned,
    the reference's greedy tokens."""
    jcfg, cfg = _configs(weights, tensor_parallel_size=2)
    batch = {"token_ids": [_PROMPT, list(range(60, 80)), list(range(1, 9))]}
    want = JaxPredictor(jcfg, params_blob=weights["blob"])(batch)["generated"]
    pred = LLMPredictor(cfg, params=weights["tparams"], device="cpu")
    assert pred(batch)["generated"] == want
    assert pred._engine._plan is None and not dist.is_initialized()
    assert not set(multiprocessing.active_children()) - _EARLIER_CHILDREN
