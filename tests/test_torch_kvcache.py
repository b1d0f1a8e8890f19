"""ray_tpu_torch.kvcache against ray_tpu.kvcache on the CPU.

The bookkeeping halves (BlockAllocator, PrefixIndex) are driven through the
same random operation sequences as the reference's classes, and every
observable (free list, refcounts, matches, evictions) must be equal. The
KVCacheManager of each side is given the same cache row, a JAX prefill of
the tiny Llama (float32) carried across by ``cache_from_jax``, and runs the
same lease sequence: counters must be equal and K/V exactly equal (a commit
and an assemble only copy values, so the tolerance is 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.kvcache import BlockAllocator as JaxBlockAllocator
from ray_tpu.kvcache import KVCacheManager as JaxKVCacheManager
from ray_tpu.kvcache import PrefixIndex as JaxPrefixIndex
from ray_tpu.models.llama import Llama as JaxLlama
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_tpu.models.llama import init_params as jax_init_params
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch.kvcache import BlockAllocator, KVCacheManager, PrefixIndex
from ray_tpu_torch.models.convert import cache_from_jax
from ray_tpu_torch.models.llama import LlamaConfig

# ---------------------------------------------------------------------------
# BlockAllocator and PrefixIndex: the same operations, the same state


def _drive(alloc_cls, index_cls, seed):
    """A random sequence of allocator and index operations (allocate, ref,
    release, copy-on-write, insert along a prompt, evict); returns every
    result and, after each operation, the free list, the refcounts, the
    index's counters and a match."""
    rng = np.random.default_rng(seed)
    alloc = alloc_cls(6)
    index = index_cls(2, alloc)
    # a 3-token alphabet, so that prompts share prefixes
    prompts = [rng.integers(0, 3, 8).tolist() for _ in range(4)]
    held, trace = [], []
    for _ in range(80):
        op = int(rng.integers(0, 6))
        if op == 0:
            bid = alloc.allocate()
            trace.append(("allocate", bid))
            if bid is not None:
                held.append(bid)
        elif op == 1 and held:
            bid = held[int(rng.integers(len(held)))]
            trace.append(("ref", bid, alloc.ref(bid)))
            held.append(bid)
        elif op == 2 and held:
            bid = held.pop(int(rng.integers(len(held))))
            trace.append(("release", bid, alloc.release(bid)))
        elif op == 3 and held:
            i = int(rng.integers(len(held)))
            new = alloc.copy_on_write(
                held[i], copy_fn=lambda s, d: trace.append(("copy", s, d))
            )
            trace.append(("cow", held[i], new))
            if new is not None:
                held[i] = new
        elif op == 4:
            toks = prompts[int(rng.integers(len(prompts)))]
            nodes = index.match(toks, 4)
            bid = alloc.allocate() if len(nodes) < 4 else None
            if bid is not None:
                parent = nodes[-1] if nodes else index.root
                i = len(nodes)
                index.insert_child(parent, tuple(toks[2 * i:2 * i + 2]), bid)
                alloc.release(bid)  # the index holds the only reference
            trace.append(("insert", [n.block_id for n in nodes], bid))
        else:
            trace.append(("evict", index.evict_lru(int(rng.integers(1, 3)))))
        trace.append((
            list(alloc._free), list(alloc._refcounts), alloc.num_free,
            index.num_nodes, index.num_evictions,
            [n.block_id for n in index.match(prompts[0], 4)],
        ))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_and_index_follow_the_reference(seed):
    ref = _drive(JaxBlockAllocator, JaxPrefixIndex, seed)
    assert _drive(BlockAllocator, PrefixIndex, seed) == ref
    # the sequence reached every operation and both outcomes of eviction
    ops = {step[0] for step in ref if isinstance(step[0], str)}
    assert ops == {"allocate", "ref", "release", "cow", "copy", "insert", "evict"}


@pytest.mark.parametrize(
    "misuse",
    [
        lambda cls, a, i: a.release(a.allocate()) + a.release(0),  # release a free block
        lambda cls, a, i: a.ref(1),  # ref a free block
        lambda cls, a, i: a.copy_on_write(1),  # COW a free block
        lambda cls, a, i: cls(0),  # an empty pool
        lambda cls, a, i: i.insert_child(i.root, (1,), a.allocate()),  # short key
    ],
    ids=["release_free", "ref_free", "cow_free", "no_blocks", "short_key"],
)
def test_misuse_raises_like_the_reference(misuse):
    for alloc_cls, index_cls in ((JaxBlockAllocator, JaxPrefixIndex),
                                 (BlockAllocator, PrefixIndex)):
        alloc = alloc_cls(2)
        with pytest.raises(ValueError):
            misuse(alloc_cls, alloc, index_cls(2, alloc))


# ---------------------------------------------------------------------------
# KVCacheManager: the same rows, the same leases, the same K/V


S, BS = 32, 8  # max_seq_len, block_size
PROMPTS = {  # two prompts of one length: one JAX prefill compile
    "a": list(range(1, 21)),
    "b": list(range(101, 121)),
}


@pytest.fixture(scope="module")
def rows():
    """Each prompt's prefill cache row from the reference's decode-mode
    Llama (1 row, K/V (1, hk, S, d) per layer), as a pytree and as the
    port's DecodeCache."""
    jcfg = JaxLlamaConfig.tiny(max_seq_len=S, dtype=jnp.float32, n_kv_heads=2)
    tcfg = LlamaConfig.tiny(max_seq_len=S, dtype=torch.float32, n_kv_heads=2)
    params = unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    model = JaxLlama(jcfg, None, decode=True)
    out = {}
    for name, toks in PROMPTS.items():
        _, v = model.apply({"params": params}, jnp.asarray([toks]), mutable=["cache"])
        out[name] = v["cache"]
    return tcfg, out


def _port_row(tcfg, jrow):
    return cache_from_jax(jax.tree_util.tree_map(np.asarray, jrow), tcfg, "cpu")


def _sides(rows):
    """(manager class, row of a prompt in that side's layout, assembled row
    in the port's layout) for the reference and the port."""
    tcfg, jrows = rows
    return [
        (JaxKVCacheManager, lambda n: jrows[n], lambda r: _port_row(tcfg, r)),
        (KVCacheManager, lambda n: _port_row(tcfg, jrows[n]), lambda r: r),
    ]


def _assert_rows_equal(a, b):
    # tolerance 0: both sides copy the same f32 values
    for x, y in ((a.key, b.key), (a.value, b.value), (a.index, b.index)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def test_cache_from_jax_maps_layers_by_name(rows):
    tcfg, jrows = rows
    row = _port_row(tcfg, jrows["a"])
    for i in range(tcfg.n_layers):
        jl = jrows["a"][f"layer_{i}"]["attn"]
        assert np.array_equal(row[i].cached_key.numpy(), np.asarray(jl["cached_key"]))
        assert np.array_equal(row[i].cached_value.numpy(), np.asarray(jl["cached_value"]))
        assert row[i].cache_index.tolist() == [len(PROMPTS["a"])]
    with pytest.raises(KeyError, match="layer"):
        cache_from_jax({"layer_0": jrows["a"]["layer_0"]}, tcfg, "cpu")


def test_commit_then_assemble_matches_reference(rows):
    tcfg, jrows = rows
    toks = PROMPTS["a"]  # 2 full blocks + a tail of 4
    out = []
    for mgr_cls, row, to_port in _sides(rows):
        m = mgr_cls(num_blocks=4, block_size=BS)
        lease = m.acquire(toks)
        assert lease.num_cached_tokens == 0 and len(lease.reserved) == 2
        assert m.commit(lease, toks, row("a")) == 2
        m.release(lease)
        again = m.acquire(toks)
        assert again.num_cached_tokens == 16
        out.append(to_port(m.assemble(again)))
        m.release(again)
        assert m.blocks_in_use == m.stats()["index_nodes"] == 2
    _assert_rows_equal(out[0], out[1])
    # the cached region is the prefilled row's, zeros past it
    full = _port_row(tcfg, jrows["a"])
    assert torch.equal(out[1].key[:, :, :, :16], full.key[:, :, :, :16])
    assert torch.equal(out[1].value[:, :, :, :16], full.value[:, :, :, :16])
    assert not out[1].key[:, :, :, 16:].any() and not out[1].value[:, :, :, 16:].any()
    assert out[1].index.tolist() == [[16]] * tcfg.n_layers


def test_acquire_never_matches_whole_prompt(rows):
    toks = PROMPTS["a"][:16]  # exactly 2 blocks
    for mgr_cls, row, _ in _sides(rows):
        m = mgr_cls(num_blocks=4, block_size=BS)
        lease = m.acquire(toks)
        m.commit(lease, toks, row("a"))
        first_block = lease.pinned[0]
        m.release(lease)
        again = m.acquire(toks)
        # at least one token must be prefilled for first-token logits
        assert again.num_cached_tokens == 8 and again.block_ids == [first_block]
        assert m.cached_blocks(toks) == 1
        m.release(again)


def test_backpressure_blocks_then_resumes(rows):
    stats = []
    for mgr_cls, row, _ in _sides(rows):
        m = mgr_cls(num_blocks=2, block_size=BS)
        holder = m.acquire(PROMPTS["a"][:16])
        m.commit(holder, PROMPTS["a"][:16], row("a"))  # pool full, pinned
        assert m.acquire(PROMPTS["b"][:16]) is None  # the admission gate
        assert m.stats()["admission_blocked"] == 1
        m.release(holder)  # the blocks become evictable
        resumed = m.acquire(PROMPTS["b"][:16])
        assert resumed is not None and len(resumed.reserved) == 2
        m.commit(resumed, PROMPTS["b"][:16], row("b"))
        m.release(resumed)
        stats.append(m.stats())
    assert stats[1] == stats[0]
    assert stats[1]["evictions"] == 2 and stats[1]["blocks_in_use"] == 2


def test_oversized_prompt_degrades_to_uncacheable(rows):
    toks = list(range(32))  # 4 blocks > capacity
    for mgr_cls, row, _ in _sides(rows):
        m = mgr_cls(num_blocks=2, block_size=BS)
        lease = m.acquire(toks)
        assert lease is not None and lease.cacheable is False
        assert m.commit(lease, toks, row("a")) == 0
        assert m.extend(lease, 2) == 0
        m.release(lease)
        assert m.blocks_in_use == 0


def test_update_block_cow_keeps_shared_prefix(rows):
    tcfg, jrows = rows
    toks = PROMPTS["a"][:16]
    out = []
    for mgr_cls, row, to_port in _sides(rows):
        m = mgr_cls(num_blocks=4, block_size=BS)
        lease = m.acquire(toks)
        m.commit(lease, toks, row("a"))
        shared = lease.pinned[0]
        # the index holds a reference too, so the block is shared: COW copies
        new_id = m.update_block(shared, row("b"), tok_offset=0)
        assert new_id is not None and new_id != shared
        lease.pinned[lease.pinned.index(shared)] = new_id
        m.release(lease)
        again = m.acquire(toks + [0])
        out.append(to_port(m.assemble(again)))
        m.release(again)
        assert m.blocks_in_use == 2
    _assert_rows_equal(out[0], out[1])
    # the index's blocks still hold prompt a's K/V, not b's
    full = _port_row(tcfg, jrows["a"])
    assert torch.equal(out[1].key[:, :, :, :16], full.key[:, :, :, :16])


def test_extend_and_tail_commit_are_best_effort(rows):
    for mgr_cls, row, _ in _sides(rows):
        m = mgr_cls(num_blocks=4, block_size=BS)
        lease = m.acquire(PROMPTS["a"][:16])  # 2 blocks reserved
        assert m.extend(lease, 3) == 2  # only 2 left
        assert m.blocks_in_use == 4
        m.commit(lease, PROMPTS["a"][:16], row("a"))
        # the 2 extended blocks take the next 2 full blocks (decode tail)
        longer = PROMPTS["a"] + list(range(200, 212))
        assert m.commit(lease, longer, row("a"), pin=False) == 2
        m.release(lease)
        assert m.extend(lease, 2) == 0  # closed lease: no leak
        assert m.blocks_in_use == m.stats()["index_nodes"] == 4


def test_stats_match_reference(rows):
    stats = []
    for mgr_cls, row, _ in _sides(rows):
        m = mgr_cls(num_blocks=4, block_size=BS)
        before = m.stats()
        lease = m.acquire(PROMPTS["a"])
        m.record_prefill(0, 20)
        m.commit(lease, PROMPTS["a"], row("a"))
        m.release(lease)
        hit = m.acquire(PROMPTS["a"])
        m.record_prefill(hit.num_cached_tokens, 20 - hit.num_cached_tokens)
        m.release(hit)
        stats.append((before, m.stats()))
    assert stats[1] == stats[0]
    assert stats[1][1]["kv_pool_bytes_total"] > 0 and stats[1][1]["heads_per_device"] == 2
    assert (stats[1][1]["hits"], stats[1][1]["prefix_hit_tokens"]) == (1, 16)
