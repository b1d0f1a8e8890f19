"""ray_tpu_torch.kvtier and disaggregated prefill/decode against ray_tpu's on
the CPU.

The same inputs go through both packages: token lists and tensors from
numpy seeds, registry operation sequences, and the tiny Llama (block 8) on
the reference's PRNGKey(0) weights carried across by params_from_jax, in
float32 on both sides so that greedy argmax ties in bf16 cannot split the
token streams. Fingerprints, registry replies and int8 codes must be equal
exactly; K/V that is only copied (extract, adopt, build) is equal exactly
(the cache-parity tolerance of test_torch_kvcache.py, 0); greedy tokens and
the tier and KV-cache counter deltas of every engine scenario of
tests/test_kvtier.py must be equal. The int8 path is held to the
reference's int8 path (its dequantized K/V and its tokens), not to the raw
tokens: the reference's own raw-vs-int8 token check fails.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu._internal import quantization as jquant
from ray_tpu._internal import serialization as jserialization
from ray_tpu.kvcache import KVCacheManager as JaxKVCacheManager
from ray_tpu.kvtier import KVShipment as JaxKVShipment
from ray_tpu.kvtier import KVTierClient as JaxKVTierClient
from ray_tpu.kvtier import LocalTierBackend as JaxLocalTierBackend
from ray_tpu.kvtier import block_fingerprints as jax_block_fingerprints
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm.engine import ContinuousBatchingEngine as JaxCBEngine
from ray_tpu.llm.engine import GenerationRequest as JaxRequest
from ray_tpu.llm.serving import _LLMReplica
from ray_tpu.models.llama import Llama as JaxLlama
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu.util import metrics as jmetrics
from ray_tpu.weights import manifest as jmanifest
from ray_tpu_torch._internal import quantization as quant
from ray_tpu_torch.kvcache import KVCacheManager
from ray_tpu_torch.kvtier import (
    GcsTierBackend,
    KVShipment,
    KVTierClient,
    LocalTierBackend,
    block_fingerprints,
    decode_payload,
)
from ray_tpu_torch.llm import LLMConfig, LLMServer
from ray_tpu_torch.llm.engine import ContinuousBatchingEngine, GenerationRequest
from ray_tpu_torch.llm.serving import _DisaggIngress
from ray_tpu_torch.models.convert import cache_from_jax, params_from_jax
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.util import events, metrics
from ray_tpu_torch.weights import manifest

BLOCK = 8
MAX_SEQ = 128


# ---------------------------------------------------------------- fingerprints


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fingerprints_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        toks = rng.integers(0, 40_000, int(rng.integers(0, 80))).tolist()
        bs = int(rng.choice([1, 3, 8, 16, 32]))
        assert block_fingerprints(toks, bs) == jax_block_fingerprints(toks, bs)
    # full blocks only, 32 hex characters, chained
    a = list(range(1, 25))
    b = list(a)
    b[10] = 99
    fa, fb = block_fingerprints(a, 8), block_fingerprints(b, 8)
    assert len(block_fingerprints(a[:20], 8)) == 2 and all(len(f) == 32 for f in fa)
    assert fa[0] == fb[0] and fa[1] != fb[1] and fa[2] != fb[2]
    for side in (block_fingerprints, jax_block_fingerprints):
        with pytest.raises(ValueError, match="block_size"):
            side(a, 0)


# ------------------------------------------------------------ registry protocol
# Each scenario of the reference's TestKVTierRegistry, run on each side's
# registry; every reply (and the final stats) must be equal.


def _reg_register(reg, fps, holder="h1", model="m"):
    return reg.register(
        model, fps, holder, ("node", 1), b"blob",
        meta={"nblocks": len(fps), "wire_bytes": 10, "logical_bytes": 20},
    )


def _sc_resolve_longest_first(reg):
    out = [_reg_register(reg, ["aa", "bb", "cc"])]
    for model, fps in (("m", ["cc", "bb", "aa"]), ("m", ["zz", "bb"]), ("m", ["zz"]),
                       ("other-model", ["cc"])):
        out.append(reg.resolve(model, fps))
    return out


def _sc_takeover(reg):
    out = [_reg_register(reg, ["aa", "bb"], holder="h1"),
           _reg_register(reg, ["aa", "bb", "cc"], holder="h2")]
    return out + [reg.resolve("m", ["bb"]), reg.collect("h1")]


def _sc_capacity_lru_skips_leased(reg):
    e1 = _reg_register(reg, ["aa"], holder="h1")["entry_id"]
    out = [e1, reg.lease(e1, "pull-1"), _reg_register(reg, ["bb"], holder="h1"),
           _reg_register(reg, ["cc"], holder="h2"), reg.resolve("m", ["aa"]),
           reg.resolve("m", ["bb"]), reg.collect("h1"), reg.release(e1, "pull-1"),
           _reg_register(reg, ["dd"], holder="h2")]
    return out + [reg.resolve("m", ["cc"]), reg.resolve("m", ["aa"])]


def _sc_notices_drained_once(reg):
    return [_reg_register(reg, ["aa"], holder="h1"), _reg_register(reg, ["bb"], holder="h1"),
            reg.collect("h1")]


def _sc_holder_evict_ownership(reg):
    e1 = _reg_register(reg, ["aa"], holder="h1")["entry_id"]
    return [reg.evict([e1], holder_id="h2"), reg.resolve("m", ["aa"]),
            reg.evict([e1], holder_id="h1"), reg.resolve("m", ["aa"]), reg.collect("h1")]


def _sc_node_death(reg):
    out = [_reg_register(reg, ["aa"], holder="h1"),
           reg.register("m", ["bb"], "h2", ("other", 2), b"x", meta={})]
    reg.on_node_death(("node", 1))
    return out + [reg.resolve("m", ["aa"]), reg.resolve("m", ["bb"])]


def _sc_lease_gone(reg):
    e1 = _reg_register(reg, ["aa"], holder="h1")["entry_id"]
    return [reg.evict([e1], holder_id="h1"), reg.lease(e1, "pull-1"), reg.release(e1, "x")]


_SCENARIOS = {
    "resolve_longest_first": (_sc_resolve_longest_first, 4096),
    "fingerprint_takeover": (_sc_takeover, 4096),
    "capacity_lru_skips_leased": (_sc_capacity_lru_skips_leased, 2),
    "notices_drained_once": (_sc_notices_drained_once, 1),
    "holder_evict_ownership": (_sc_holder_evict_ownership, 4096),
    "node_death_sweeps": (_sc_node_death, 4096),
    "lease_on_gone_entry": (_sc_lease_gone, 4096),
}


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_registry_replies_equal_reference(name):
    scenario, cap = _SCENARIOS[name]
    got_reg = LocalTierBackend(max_entries=cap).registry
    want_reg = JaxLocalTierBackend(max_entries=cap).registry
    assert scenario(got_reg) == scenario(want_reg)
    assert got_reg.stats() == want_reg.stats()
    assert got_reg._gcs._kv == want_reg._gcs._kv  # the mirrored kvtier: keys


# ----------------------------------------------------------------- int8 codec


def _codec_input(rng, n, dtype):
    x = (rng.standard_normal(n) * rng.uniform(0.01, 100.0)).astype(np.float32)
    if n > 8:
        x[:4] = [np.nan, np.inf, -np.inf, 0.0]
    if n >= 512:
        x[256:512] = 0.0  # an all-zero block: scale 0 -> 1
    t = torch.from_numpy(x).to(dtype)
    ref_in = t.float().numpy()
    if dtype == torch.bfloat16:
        ref_in = ref_in.astype(ml_dtypes.bfloat16)
    return t, ref_in


@pytest.mark.parametrize("n", [1, 7, 256, 1000, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_codec_bit_equal_to_reference(dtype, n):
    t, ref_in = _codec_input(np.random.default_rng(n), n, dtype)
    want = jquant.quantize_np(ref_in)
    got = quant.quantize_np(t)
    q, scales = quant.quantize_torch(t)
    for codes, sc in ((got.q, got.scales), (q.numpy(), scales.numpy())):
        assert np.array_equal(codes, want.q)
        # scales bit for bit (0 and a NaN-free f32 everywhere)
        assert np.array_equal(np.asarray(sc).view(np.uint32), want.scales.view(np.uint32))
    assert got.shape == tuple(t.shape) and got.dtype == str(t.dtype).replace("torch.", "")
    assert got.wire_nbytes == want.wire_nbytes and got.logical_nbytes == want.logical_nbytes
    ref_out = np.asarray(jquant.dequantize_np(want)).astype(np.float32)
    for out in (quant.dequantize_np(got), quant.dequantize_torch(q, scales, t.shape, t.dtype)):
        assert out.dtype == t.dtype and tuple(out.shape) == tuple(t.shape)
        assert np.array_equal(out.float().numpy(), ref_out)
    # the error bound: half a quantization step of the element's block, plus
    # the f32 rounding of q * scale (a tie x / scale = k + 1/2 reaches it)
    x = t.float()
    finite = torch.isfinite(x)
    step = torch.repeat_interleave(scales, 256)[: t.numel()]
    err = (quant.dequantize_torch(q, scales, t.shape, torch.float32) - x).abs()
    assert bool((err <= step / 2 + x.abs() * 2.0 ** -23)[finite].all())
    assert quant.is_quantizable(t) == jquant.is_quantizable(ref_in)


def test_stacked_dequantize_broadcasts_like_reference():
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((3, 100)).astype(np.float32) for _ in range(2)]
    q = np.stack([jquant.quantize_np(x).q for x in xs])
    s = np.stack([jquant.quantize_np(x).scales for x in xs])
    want = np.asarray(jquant.dequantize_jax(jnp.asarray(q), jnp.asarray(s), (3, 100), jnp.float32))
    got = quant.dequantize_torch(torch.from_numpy(q), torch.from_numpy(s), (3, 100),
                                 torch.float32)
    assert tuple(got.shape) == (2, 3, 100) and np.array_equal(got.numpy(), want)


# ------------------------------------------------------------------ chunking


def _mixed_tree(rng):
    """Leaves of every kind a chunk meets: large f32 and bf16, an int leaf,
    a leaf under MIN_QUANT_BYTES, an empty (0, ...) leaf, and None."""
    spec = [((64, 33), np.float32), ((3, 8, 32), "bf16"), ((40,), np.int32),
            ((5,), np.float32), ((0, 4, 8), np.float32), ((7, 129), "bf16")]
    ref_leaves, leaves = [], []
    for shape, dt in spec:
        x = rng.standard_normal(shape).astype(np.float32)
        if dt == np.int32:
            x = (x * 100).astype(np.int32)
            ref, t = x, torch.from_numpy(x)
        elif dt == "bf16":
            t = torch.from_numpy(x).to(torch.bfloat16)
            ref = t.float().numpy().astype(ml_dtypes.bfloat16)
        else:
            ref, t = x, torch.from_numpy(x)
        ref_leaves.append(ref)
        leaves.append(t)
    return ({"a": ref_leaves[:3], "b": {"c": ref_leaves[3:], "d": None}},
            {"a": leaves[:3], "b": {"c": leaves[3:], "d": None}})


@pytest.mark.parametrize("chunk_size", [1, 3000, 10_000, 1 << 22])
@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_chunk_pytree_counts_equal_reference(codec, chunk_size):
    ref_tree, tree = _mixed_tree(np.random.default_rng(chunk_size))
    _, want_chunks, want_total = jmanifest.chunk_pytree(ref_tree, chunk_size, codec=codec)
    blob, chunks, total = manifest.chunk_pytree(tree, chunk_size, codec=codec)
    assert total == want_total
    assert [len(c) for c in chunks] == [len(c) for c in want_chunks]
    for got_c, want_c in zip(chunks, want_chunks):
        assert manifest.chunk_logical_bytes(got_c) == jmanifest.chunk_logical_bytes(want_c)
        assert ([manifest.leaf_wire_nbytes(v) for v in got_c]
                == [jmanifest.leaf_wire_nbytes(v) for v in want_c])
    # assembled: raw leaves equal, int8 leaves equal to the reference's decode
    got = manifest.assemble_pytree(blob, chunks)
    want = jmanifest.assemble_pytree(*jmanifest.chunk_pytree(ref_tree, chunk_size, codec)[:2])
    assert got["b"]["d"] is None
    got_leaves = [got["a"][i] for i in range(3)] + got["b"]["c"]
    want_leaves = list(want["a"]) + list(want["b"]["c"])
    for g, w in zip(got_leaves, want_leaves):
        assert np.array_equal(g.float().numpy(), np.asarray(w).astype(np.float32))
    with pytest.raises(ValueError, match="codec"):
        manifest.chunk_pytree(tree, chunk_size, codec="fp4")


# ------------------------------------------------- the KV manager's shipments


def _cfgs(**kw):
    return (JaxLlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=jnp.float32, **kw),
            LlamaConfig.tiny(max_seq_len=MAX_SEQ, dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


ROW_PROMPT = list(range(50, 77))  # 27 tokens: 3 blocks + a tail of 3


@pytest.fixture(scope="module")
def prefilled(models):
    """ROW_PROMPT's prefill cache row from the reference's decode-mode Llama,
    as its pytree and as the port's DecodeCache."""
    jcfg, jparams, tcfg, _ = models
    _, v = JaxLlama(jcfg, None, decode=True).apply(
        {"params": jparams}, jnp.asarray([ROW_PROMPT]), mutable=["cache"])
    jrow = v["cache"]
    return jrow, cache_from_jax(jax.tree_util.tree_map(np.asarray, jrow), tcfg, "cpu")


def _reference_leaf_map(jrow):
    """(layer, 0 for K / 1 for V) of each KV leaf of the reference's cache
    row, in its leaf order (flax sorts layer names: layer_10 before
    layer_2)."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jrow)[0]:
        if np.ndim(leaf) >= 3:
            keys = [p.key for p in path]
            layer = int(keys[0].split("_")[1])
            out.append((layer, 0 if keys[-1] == "cached_key" else 1))
    return out


def _assert_payload_maps(got, want, leaf_map, ntokens):
    """The port's payload against the reference's, leaf by leaf through
    the layout map; tolerance 0 (copies of the same f32 values)."""
    nb = ntokens // BLOCK
    assert len(want["blocks"]) == len(leaf_map) == 2 * got["blocks"][0].shape[1]
    for (layer, kv), w in zip(leaf_map, want["blocks"]):
        g = got["blocks"][kv][:, layer]  # (nb, hk, bs, d)
        assert tuple(g.shape) == np.shape(w) and g.shape[0] == nb
        assert np.array_equal(g.numpy(), np.asarray(w))
    if ntokens % BLOCK == 0:
        assert got["tail"] is None and want["tail"] is None
        return
    for (layer, kv), w in zip(leaf_map, want["tail"]):
        g = got["tail"][2 * layer + kv]
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_extract_row_payload_equals_reference(models, prefilled):
    jrow, row = prefilled
    jm, m = JaxKVCacheManager(16, BLOCK), KVCacheManager(16, BLOCK)
    leaf_map = _reference_leaf_map(jrow)
    for n in (27, 24, 5):  # blocks and a tail, blocks only, a tail only
        _assert_payload_maps(m.extract_row_payload(row, n), jm.extract_row_payload(jrow, n),
                             leaf_map, n)
    assert m.ready and jm.ready


def test_payload_layout_map_at_eleven_layers():
    """flax orders layers by name (layer_0, layer_1, layer_10, layer_2,
    ...): the map holds at a depth where that order differs from the
    port's layer order. The rows are random K/V (extraction only copies)."""
    L, hk, d = 11, 2, 16
    _, tcfg = _cfgs(n_layers=L, n_kv_heads=hk, n_heads=hk, dim=hk * d)
    rng = np.random.default_rng(11)
    jrow = {f"layer_{i}": {"attn": {
        "cached_key": rng.standard_normal((1, hk, MAX_SEQ, d)).astype(np.float32),
        "cached_value": rng.standard_normal((1, hk, MAX_SEQ, d)).astype(np.float32),
        "cache_index": np.array([21], np.int32)}} for i in range(L)}
    leaf_map = _reference_leaf_map(jrow)
    assert [layer for layer, _ in leaf_map[::2]] == sorted(range(L), key=lambda i: f"layer_{i}")
    got = KVCacheManager(8, BLOCK).extract_row_payload(cache_from_jax(jrow, tcfg, "cpu"), 21)
    _assert_payload_maps(got, JaxKVCacheManager(8, BLOCK).extract_row_payload(jrow, 21),
                         leaf_map, 21)


def test_adopt_then_assemble_gives_back_the_blocks(models, prefilled):
    jrow, row = prefilled
    _, _, tcfg, _ = models
    payload = KVCacheManager(16, BLOCK).extract_row_payload(row, 27)
    jpayload = JaxKVCacheManager(16, BLOCK).extract_row_payload(jrow, 27)
    m, jm = KVCacheManager(4, BLOCK), JaxKVCacheManager(4, BLOCK)
    with pytest.raises(RuntimeError, match="initialized"):
        m.adopt_blocks(ROW_PROMPT, payload["blocks"], 3)
    m.initialize_for(tcfg, "cpu")
    jm.initialize(jrow)
    assert m.ready and tuple(m._pool_k.shape) == (2, 4, 4, BLOCK, 32)
    # 2 of 3 blocks first, then all 3 (2 present, 1 new); a 4-block pool
    # with one block taken by another prompt's lease stops the walk at 3
    got = [m.adopt_blocks(ROW_PROMPT, payload["blocks"], 2),
           m.adopt_blocks(ROW_PROMPT, payload["blocks"], 3)]
    want = [jm.adopt_blocks(ROW_PROMPT, jpayload["blocks"], 2),
            jm.adopt_blocks(ROW_PROMPT, jpayload["blocks"], 3)]
    assert got == want == [2, 3]
    assert m.stats()["adopted_blocks"] == jm.stats()["adopted_blocks"] == 3
    lease = m.acquire(ROW_PROMPT)
    assert lease.num_cached_tokens == 24
    back = m.assemble(lease)
    for got_t, want_t in ((back.key, row.key), (back.value, row.value)):
        assert torch.equal(got_t[:, :, :, :24], want_t[:, :, :, :24])
    m.release(lease)
    # an adopted block is referenced by the index alone, so the LRU can
    # evict it once no lease pins it (kept item 14). The reference's keeps
    # its allocation reference as well: its adopted blocks are never
    # evicted, and a pool full of them refuses the next prompt
    held = m.acquire(list(range(900, 918)))  # 2 blocks: the free one, one evicted
    assert held is not None and m.stats()["evictions"] == 1
    m.release(held)
    assert jm.acquire(list(range(900, 918))) is None
    assert jm.stats()["evictions"] == 0 and jm.stats()["admission_blocked"] == 1


def _index_blocks(m):
    """Block ids of every node reachable from the radix root."""
    out, stack = [], list(m._index.root.children.values())
    while stack:
        node = stack.pop()
        out.append(node.block_id)
        stack.extend(node.children.values())
    return out


def _assert_pool_whole(m):
    """With no lease open, the allocated blocks are exactly the index's,
    each once, each referenced by the index alone."""
    bids = _index_blocks(m)
    assert len(bids) == len(set(bids)) == m._index.num_nodes
    assert m._alloc.num_allocated == len(bids)
    assert all(m._alloc.refcount(b) == 1 for b in bids)


@pytest.mark.parametrize("present", [0, 1], ids=["new_chain", "present_prefix"])
def test_adopt_never_evicts_its_own_chain(models, prefilled, present):
    """A 4-block pool whose only evictable leaves are the chain being
    adopted: the walk stops where the free blocks run out, and every block
    stays reachable from the root."""
    _, row = prefilled
    _, _, tcfg, _ = models
    payload = KVCacheManager(16, BLOCK).extract_row_payload(row, 27)
    m = KVCacheManager(4, BLOCK)
    m.initialize_for(tcfg, "cpu")
    if present:
        assert m.adopt_blocks(ROW_PROMPT, payload["blocks"], 1) == 1
    # another prompt's lease pins every other block of the pool
    lease = m.acquire(list(range(900, 900 + (3 if present else 2) * BLOCK)))
    assert lease is not None and m._alloc.num_free == (0 if present else 2)
    got = m.adopt_blocks(ROW_PROMPT, payload["blocks"], 3)
    assert got == (1 if present else 2)
    assert m.stats()["evictions"] == 0
    assert m.stats()["adopted_blocks"] == (1 if present else 2)
    m.release(lease)
    _assert_pool_whole(m)
    assert m.cached_blocks(ROW_PROMPT) == got
    back = m.acquire(ROW_PROMPT)
    assert back.num_cached_tokens == got * BLOCK
    rows = m.assemble(back)
    assert torch.equal(rows.key[:, :, :, :got * BLOCK], row.key[:, :, :, :got * BLOCK])
    m.release(back)
    # nothing leaked: a prompt as long as the pool still fits
    full = m.acquire(list(range(700, 700 + 4 * BLOCK + 1)))
    assert full is not None and full.cacheable is not False
    m.release(full)


def test_adopt_of_a_bad_payload_leaves_pool_and_index_as_they_were(models, prefilled):
    _, row = prefilled
    _, _, tcfg, _ = models
    payload = KVCacheManager(16, BLOCK).extract_row_payload(row, 27)
    m = KVCacheManager(8, BLOCK)
    m.initialize_for(tcfg, "cpu")
    assert m.adopt_blocks(ROW_PROMPT, payload["blocks"], 1) == 1
    bad = [b[:, :, :, :BLOCK - 1] for b in payload["blocks"]]
    with pytest.raises(RuntimeError):
        m.adopt_blocks(ROW_PROMPT, bad, 3)
    _assert_pool_whole(m)
    assert m.cached_blocks(ROW_PROMPT) == 1 and m.stats()["adopted_blocks"] == 1


def test_tier_client_runs_on_the_card_unless_told(models):
    """None means the card, as every entry point of the port: without one
    the client refuses, and an engine refuses a client on another device."""
    _, _, tcfg, tparams = models
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KVTierClient(model="m", backend=LocalTierBackend(), block_size=BLOCK)
    tier = KVTierClient(model="m", backend=LocalTierBackend(), block_size=BLOCK,
                        device="meta")
    with pytest.raises(ValueError, match="kv tier on meta, engine on cpu"):
        ContinuousBatchingEngine(tcfg, tparams, num_slots=2,
                                 kv_cache=KVCacheManager(16, BLOCK), kv_tier=tier,
                                 device="cpu")


def test_build_row_equals_the_prefilled_row(models, prefilled):
    jrow, row = prefilled
    _, _, tcfg, _ = models
    for n in (27, 24, 3):
        m, jm = KVCacheManager(8, BLOCK), JaxKVCacheManager(8, BLOCK)
        payload = m.extract_row_payload(row, n)
        built = m.build_row(payload, n)
        jbuilt = cache_from_jax(jax.tree_util.tree_map(
            np.asarray, jm.build_row(jm.extract_row_payload(jrow, n), n)), tcfg, "cpu")
        for x, y in ((built.key, jbuilt.key), (built.value, jbuilt.value),
                     (built.index, jbuilt.index)):
            assert torch.equal(x, y)
        assert torch.equal(built.key[:, :, :, :n], row.key[:, :, :, :n])
        assert not built.key[:, :, :, n:].any() and built.index.tolist() == [[n]] * 2
    with pytest.raises(RuntimeError, match="initialized"):
        KVCacheManager(8, BLOCK).build_row(payload, 3)


# ---------------------------------------------------------- engine scenarios
# Each scenario of tests/test_kvtier.py runs on both packages: greedy tokens
# and counter deltas must be equal.


class _Side:
    """One package's engine, tier and counter API."""

    def __init__(self, is_ref, models):
        jcfg, jparams, tcfg, tparams = models
        self.is_ref = is_ref
        self.cfg, self.params = (jcfg, jparams) if is_ref else (tcfg, tparams)
        self.backend_cls = JaxLocalTierBackend if is_ref else LocalTierBackend
        self.shipment_cls = JaxKVShipment if is_ref else KVShipment
        self.metrics = jmetrics if is_ref else metrics

    def engine(self, backend=None, holder=None, codec="raw", num_blocks=64,
               model="LlamaConfig"):
        tier = None
        if backend is not None:
            if self.is_ref:
                tier = JaxKVTierClient(model=model, backend=backend, block_size=BLOCK,
                                       codec=codec, holder_id=holder)
            else:
                tier = KVTierClient(model=model, backend=backend, block_size=BLOCK,
                                    codec=codec, holder_id=holder, device="cpu")
        if self.is_ref:
            return JaxCBEngine(self.cfg, self.params, num_slots=4,
                               kv_cache=JaxKVCacheManager(num_blocks, BLOCK), seed=7,
                               kv_tier=tier), tier
        return ContinuousBatchingEngine(
            self.cfg, self.params, num_slots=4, kv_cache=KVCacheManager(num_blocks, BLOCK),
            seed=7, kv_tier=tier, device="cpu"), tier

    def req(self, prompt, n=8):
        cls = JaxRequest if self.is_ref else GenerationRequest
        return cls(token_ids=list(prompt), max_new_tokens=n, temperature=0.0)

    def counters(self):
        return {**self.metrics.kvtier_counters(), **self.metrics.kvcache_counters()}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _both(models, scenario):
    out = [scenario(_Side(is_ref, models)) for is_ref in (True, False)]
    assert out[1] == out[0]
    return out[1]


def _scale_up(side):
    backend = side.backend_cls()
    warm, _ = side.engine(backend, "warm-replica")
    prompt = list(range(1, 25))
    base = warm.generate_one(side.req(prompt)).token_ids
    fresh, _ = side.engine(backend, "scale-up")
    c0 = side.counters()
    out = fresh.generate_one(side.req(prompt)).token_ids
    return base, out, _delta(side.counters(), c0), fresh._kv.stats()["adopted_blocks"]


def test_scale_up_first_request_zero_prefill(models):
    base, out, d, adopted = _both(models, _scale_up)
    assert out == base
    assert d["prefill_tokens_computed"] == 0 and adopted == 3
    assert (d["hit"], d["peer_pull"], d["recompute"]) == (1, 1, 0)
    assert d["transfer_wire_bytes"] == d["transfer_logical_bytes"] == 2 * 2 * 24 * 4 * 32 * 4


def _partial_pull(side):
    backend = side.backend_cls()
    warm, _ = side.engine(backend, "warm")
    shared = list(range(1, 17))
    warm.generate_one(side.req(shared))
    fresh, _ = side.engine(backend, "fresh")
    longer = shared + list(range(40, 50))
    c0 = side.counters()
    out = fresh.generate_one(side.req(longer)).token_ids
    d = _delta(side.counters(), c0)
    return out, warm.generate_one(side.req(longer)).token_ids, d


def test_partial_prefix_pull_then_suffix_prefill(models):
    out, warm_out, d = _both(models, _partial_pull)
    assert out == warm_out
    assert d["peer_pull"] == 1 and d["prefill_tokens_computed"] == 10


def _disagg(side):
    backend = side.backend_cls()
    pre, _ = side.engine(backend, "prefill-replica")
    dec, dec_tier = side.engine(backend, "decode-replica")
    out = []
    for prompt in (list(range(50, 77)), [1, 2, 3]):
        shipment = pre.prefill_only(side.req(prompt))
        shipment = side.shipment_cls.from_blob(shipment.to_blob())
        payload = dec_tier.fetch_shipment(shipment)
        c0 = side.counters()
        got = dec.generate_one(side.req(prompt), shipment=(shipment, payload)).token_ids
        d = _delta(side.counters(), c0)
        fused = pre.generate_one(side.req(prompt)).token_ids
        out.append((got, fused, d["prefill_tokens_computed"], shipment.nblocks,
                    shipment.tail_len, shipment.logical_bytes, shipment.wire_bytes,
                    len(shipment.chunks)))
    return out


def test_disagg_handoff_matches_fused(models):
    out = _both(models, _disagg)
    for got, fused, computed, _, _, logical, wire, _ in out:
        assert got == fused and computed == 0 and wire == logical
    # the 27-token prompt ships 3 blocks and a tail of 3; the 3-token one
    # a zero-block leaf and its tail
    assert [r[3:5] for r in out] == [(3, 3), (0, 3)]


def _int8(side):
    backend = side.backend_cls()
    pre, _ = side.engine(backend, "pre8", codec="int8")
    dec, dec_tier = side.engine(backend, "dec8", codec="int8")
    prompt = list(range(3, 35))  # 4 full blocks, no tail
    shipment = pre.prefill_only(side.req(prompt))
    c0 = side.counters()
    payload = dec_tier.fetch_shipment(shipment)
    d = _delta(side.counters(), c0)
    out = dec.generate_one(side.req(prompt), shipment=(shipment, payload)).token_ids
    return shipment, payload, d, out


def test_int8_adoption_matches_reference_int8(models):
    (jship, jpayload, jd, jout), (ship, payload, d, out) = [
        _int8(_Side(is_ref, models)) for is_ref in (True, False)]
    assert ship.codec == "int8" and ship.nblocks == 4 and ship.tail_len == 0
    assert (ship.logical_bytes, ship.wire_bytes) == (jship.logical_bytes, jship.wire_bytes)
    assert ship.wire_bytes <= 0.51 * ship.logical_bytes
    assert d == jd and 0 < d["transfer_wire_bytes"] <= 0.51 * d["transfer_logical_bytes"]
    # dequantized K/V against the reference's, through the layout map. Each
    # side coded its own prefill's K/V, which differ from the other's in the
    # last f32 bits, so next to a rounding tie a code may differ by one: at
    # most one quantization step, max|x| / 127 of the leaf. On the same K/V
    # the two decodes are equal (test_int8_codes_of_one_row_equal_reference)
    leaf_map = [(layer, kv) for layer in range(2) for kv in (0, 1)]
    for (layer, kv), w in zip(leaf_map, jpayload["blocks"]):
        g, w = payload["blocks"][kv][:, layer].numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= np.abs(w).max() / 127 * (1 + 1e-6)
    # greedy tokens equal the reference engine's int8 adoption
    assert out == jout


def test_int8_codes_of_one_row_equal_reference(models, prefilled):
    """One prefill row's K/V, int8-coded by each side, decode equal: the
    blocks, and a tail of odd length (hk * tail * d = 384, not a multiple
    of 256) whose per-layer leaves keep each 256-element group over the
    reference's elements."""
    jrow, row = prefilled
    payload = KVCacheManager(16, BLOCK).extract_row_payload(row, 27)
    jpayload = JaxKVCacheManager(16, BLOCK).extract_row_payload(jrow, 27)
    blob, chunks, _ = manifest.chunk_pytree(payload, 1 << 22, "int8")
    jblob, jchunks, _ = jmanifest.chunk_pytree(jpayload, 1 << 22, "int8")
    _assert_payload_maps(decode_payload(blob, chunks), jmanifest.assemble_pytree(jblob, jchunks),
                         _reference_leaf_map(jrow), 27)


def _dead_holder(side):
    backend = side.backend_cls()
    warm, _ = side.engine(backend, "doomed")
    prompt = list(range(1, 25))
    base = warm.generate_one(side.req(prompt)).token_ids
    shipment = warm.prefill_only(side.req(prompt))
    backend.kill_holder("doomed")
    fresh, fresh_tier = side.engine(backend, "survivor")
    c0 = side.counters()
    fetched = fresh_tier.fetch_shipment(shipment)
    out = fresh.generate_one(side.req(prompt), shipment=None).token_ids
    d = _delta(side.counters(), c0)
    return fetched, base, out, d


def test_dead_holder_falls_back_to_recompute(models):
    fetched, base, out, d = _both(models, _dead_holder)
    assert fetched is None and out == base
    assert (d["recompute"], d["peer_pull"], d["prefill_tokens_computed"]) == (2, 0, 24)


# ---------------------------------------------------------- serve-level roles


def test_serve_disagg_roles_match_reference(models):
    """LLMServer(role=) + _DisaggIngress against the reference's replicas
    with roles (the ingress's two calls), and both against a fused server."""
    jcfg_m, jparams, _, tparams = models
    kw = dict(model_id="llama-tiny", max_seq_len=MAX_SEQ, max_new_tokens=6,
              kv_cache_blocks=64, kv_block_size=BLOCK)
    jcfg = JaxLLMConfig(**kw, roles={"prefill": 1, "decode": 1},
                        model_kwargs={"dtype": jnp.float32})
    tcfg = LLMConfig(**kw, roles={"prefill": 1, "decode": 1},
                     model_kwargs={"dtype": torch.float32})
    blob = jserialization.dumps(jparams)
    jbackend, backend = JaxLocalTierBackend(), LocalTierBackend()
    jpre, jdec = (_LLMReplica(jcfg, params_blob=blob, role=r, tier_backend=jbackend)
                  for r in ("prefill", "decode"))
    pre, dec = (LLMServer(tcfg, params=tparams, device="cpu", role=r, tier_backend=backend)
                for r in ("prefill", "decode"))
    ingress = _DisaggIngress(pre, dec)
    fused = LLMServer(dataclasses.replace(tcfg, roles=None), params=tparams, device="cpu")
    for prompt in (list(range(1, 21)), [7, 8, 9]):
        request = {"token_ids": prompt, "max_new_tokens": 6}
        c0 = metrics.kvcache_counters()
        got = ingress(dict(request))
        computed = metrics.kvcache_counters()["prefill_tokens_computed"] - c0[
            "prefill_tokens_computed"]
        want = jdec.decode_shipped(dict(request), jpre.prefill(dict(request)))
        assert got == want == fused(dict(request))
        assert computed == len(prompt)  # on the prefill side only
        assert list(ingress.stream(dict(request)))[-1] == got
    assert dec.kvcache_stats()["adopted_blocks"] == jdec.kvcache_stats()["adopted_blocks"] == 2
    assert dec.kvtier_stats()["role"] == "decode" and pre.kvtier_stats()["role"] == "prefill"
    assert fused.kvtier_stats() is None
    # no tier: the prefill side declines and the decode side computes
    plain = LLMServer(dataclasses.replace(tcfg, roles=None), params=tparams, device="cpu")
    assert plain.prefill({"token_ids": [1, 2, 3]}) is None
    assert plain.decode_shipped({"token_ids": [1, 2, 3], "max_new_tokens": 2}, None)[
        "token_ids"] == fused({"token_ids": [1, 2, 3], "max_new_tokens": 2})["token_ids"]


def test_role_servers_need_a_backend_and_a_pool(models):
    _, _, _, tparams = models
    cfg = LLMConfig(model_id="llama-tiny", max_seq_len=MAX_SEQ, kv_cache_blocks=8,
                    kv_block_size=BLOCK, model_kwargs={"dtype": torch.float32})
    # without a tier_backend a role server builds the cluster's backend,
    # which needs the runtime: it raises outside one and builds inside
    with pytest.raises(RuntimeError, match="init"):
        LLMServer(cfg, params=tparams, device="cpu", role="prefill")
    with pytest.raises(RuntimeError, match="init"):
        GcsTierBackend()
    import ray_tpu_torch as rt

    rt.init(num_cpus=1)
    try:
        server = LLMServer(cfg, params=tparams, device="cpu", role="prefill")
        assert isinstance(server._kv_tier.backend, GcsTierBackend)
        assert server.kvtier_stats()["registry"]["entries"] == 0
    finally:
        rt.shutdown()
    with pytest.raises(ValueError, match="role"):
        LLMServer(cfg, params=tparams, device="cpu", role="verify")
    with pytest.raises(ValueError, match="kv_cache_blocks"):
        LLMServer(dataclasses.replace(cfg, kv_cache_blocks=None), params=tparams,
                  device="cpu", role="decode", tier_backend=LocalTierBackend())


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(roles={"prefill": 1, "decode": 1}), "kv_cache_blocks"),
        (dict(roles={"prefill": 1}, kv_cache_blocks=64), "positive int"),
        (dict(roles={"prefill": 1, "verify": 1}, kv_cache_blocks=64), "roles keys"),
        (dict(kv_ship_codec="fp4", kv_cache_blocks=64), "kv_ship_codec"),
        (dict(kv_tier=True), "kv_cache_blocks"),
    ],
    ids=["roles_without_pool", "roles_missing_decode", "roles_key", "codec", "tier_without_pool"],
)
def test_llm_config_validation_like_reference(kwargs, match):
    with pytest.raises(ValueError, match=match) as want:
        JaxLLMConfig(**kwargs)
    with pytest.raises(ValueError, match=match) as got:
        LLMConfig(**kwargs)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the records


_SUMMARY_PAYLOAD = [{
    "metrics": [
        {"name": "kvtier_hit_total", "tag_keys": ["model"], "values": {'["m"]': 3.0}},
        {"name": "kvtier_peer_pull_total", "tag_keys": ["model"], "values": {'["m"]': 2.0}},
        {"name": "kvtier_recompute_total", "tag_keys": ["model"], "values": {'["m"]': 1.0}},
        {"name": "kvtier_transfer_bytes_total", "tag_keys": ["model", "kind"],
         "values": {'["m", "logical"]': 1000.0, '["m", "wire"]': 260.0}},
        {"name": "kvcache_ttft_ms", "tag_keys": ["cache", "mesh", "tier"],
         "boundaries": [1, 10, 100],
         "counts": {'["hit", "tp=1", "peer"]': [0, 2, 0, 0],
                    '["miss", "tp=1", "miss"]': [0, 0, 1, 0]},
         "values": {'["hit", "tp=1", "peer"]': 12.0, '["miss", "tp=1", "miss"]': 80.0}},
    ],
}]


def test_kvtier_summary_on_the_reference_payload():
    out = metrics.kvtier_summary(_SUMMARY_PAYLOAD)
    assert out == jmetrics.kvtier_summary(_SUMMARY_PAYLOAD)
    assert (out["hit"], out["peer_pull"], out["recompute"]) == (3.0, 2.0, 1.0)
    assert out["transfer_bytes"] == {"logical": 1000.0, "wire": 260.0}
    peer = out["ttft_ms_by_tier"]["peer"]
    assert peer["count"] == 2.0 and peer["mean_ms"] == 6.0
    assert out["ttft_ms_by_tier"]["miss"]["count"] == 1.0
    # the port's own payload rolls up its counters
    c = metrics.kvtier_counters()
    mine = metrics.kvtier_summary([metrics.local_payload()])
    assert (mine["hit"], mine["peer_pull"], mine["recompute"]) == (
        c["hit"], c["peer_pull"], c["recompute"])
    assert mine["transfer_bytes"]["wire"] == c["transfer_wire_bytes"]
    with pytest.raises(ValueError, match="outcome"):
        metrics.record_kvtier("miss")


def test_exports_record_kv_shipped_and_evictions_kvtier_evict(models):
    side = _Side(False, models)
    backend = LocalTierBackend(max_entries=1)
    eng, tier = side.engine(backend, "h", model="events-model")
    eng.generate_one(side.req(list(range(1, 17)), n=2))
    eng.generate_one(side.req(list(range(101, 117)), n=2))  # evicts the first entry
    shipped = [e for e in events.get_events(events.KV_SHIPPED)
               if e["model"] == "events-model"]
    assert [(e["nblocks"], e["first_token"], e["codec"]) for e in shipped] == [
        (2, True, "raw")] * 2
    evicted = [e for e in events.get_events(events.KVTIER_EVICT)
               if e["model"] == "events-model"]
    assert [(e["entry_id"], e["holder_id"]) for e in evicted] == [
        (shipped[0]["entry_id"], "h")]
    assert tier.stats()["exported_entries"] == 1
    tier.close()
    assert tier.stats()["registry"]["entries"] == 0


# -------------------------------------- kept item 13: the tier's own errors


def test_a_corrupt_payload_raises_not_recomputes(models):
    """A fault of the tier's own decode propagates (the reference turns it
    into a recompute); a dead holder is still a recompute."""
    for is_ref in (True, False):
        side = _Side(is_ref, models)
        backend = side.backend_cls()
        warm, _ = side.engine(backend, "warm")
        prompt = list(range(1, 25))
        warm.generate_one(side.req(prompt))
        shipment = warm.prefill_only(side.req(prompt))
        _, puller = side.engine(backend, "puller")
        corrupt = dataclasses.replace(shipment, treedef_blob=b"not a pickle")
        for oid in list(backend._store):
            backend._store[oid] = backend._store[oid][:1]  # a leaf short
        c0 = side.counters()
        if is_ref:
            assert puller.fetch_shipment(corrupt) is None
            assert puller.pull(prompt) is None
            assert _delta(side.counters(), c0)["recompute"] == 2
        else:
            with pytest.raises(pickle.UnpicklingError):
                puller.fetch_shipment(corrupt)
            with pytest.raises(Exception) as err:
                puller.pull(prompt)
            assert not isinstance(err.value, AssertionError)
            d = _delta(side.counters(), c0)
            assert (d["recompute"], d["peer_pull"]) == (0, 0)
            assert backend.stats()["leased_entries"] == 0  # the lease was released
