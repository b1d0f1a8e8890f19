"""KVCacheManager: paged KV pool + prefix reuse behind a lease API.

The port of ray_tpu/kvcache/manager.py. The manager owns two pooled device
tensors, K and V, each ``(n_layers, num_blocks, n_kv_heads, block_size,
head_dim)`` in the cache dtype on the device of the first row committed,
and wires the logical halves together: the refcounted
:class:`~ray_tpu_torch.kvcache.block_allocator.BlockAllocator` and the
:class:`~ray_tpu_torch.kvcache.prefix_index.PrefixIndex` radix tree. The
engine talks to it through four calls:

- ``acquire(token_ids)``: longest-prefix match and admission gate. Matched
  blocks are pinned and the blocks the prompt will need are *reserved* up
  front (evicting LRU leaves as needed); if the pool cannot cover the
  prompt, every ref is rolled back and ``None`` is returned, so the engine
  keeps the request pending: backpressure instead of running out of memory.
- ``assemble(lease)``: gather the matched block chain into a fresh 1-row
  :class:`~ray_tpu_torch.models.llama.DecodeCache` whose write position is
  the cached length; the engine then prefills only the uncached suffix.
- ``commit(lease, token_ids, cache_row)``: copy full blocks out of a
  prefilled or decoded row into pool blocks and insert them into the radix
  tree.
- ``release(lease)``: drop the request's pins; blocks whose only remaining
  reference is the index become LRU-evictable.

Blocks in the index are immutable: only *full* blocks are ever committed,
so shared prefixes never see partial writes. ``update_block`` exposes the
copy-on-write path (shared block -> fresh copy) for callers that do mutate
per-request state in place.

The layers are stacked in one tensor (the cache layout of models/llama.py),
so a commit, a copy-on-write copy or an assembly is two or three device ops
for the whole model, not a few per layer. The KV tier's shipment interop
(``extract_row_payload``, ``adopt_blocks``, ``build_row``; see "Tier
shipment interop" below) moves a prefix out of a row and into the pool or a
row, likewise a few ops for all layers. Under a tensor-parallel plan (``plan=``, or ``adopt_plan`` before the pools
are shaped) each rank's manager holds its heads-slice of every block
(parallel/plan.py ``KV_SPEC``), shaped from that rank's cache rows: the
allocator and the radix index are the same on every rank, because every
rank runs the same admission decisions in lockstep (llm/tp_ranks.py).
``stats()`` keeps the reference's counters and keys; the same events go to the process's metrics (``util/metrics``:
prefix hits and computed tokens, evictions, blocked admissions, the block
gauges) and a blocked admission to its flight recorder (``util/events``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from .._internal.device import MESH_TAG
from ..models.llama import DecodeCache
from ..util import events as _events
from ..util import metrics as _metrics
from .block_allocator import BlockAllocator
from .prefix_index import PrefixIndex


@dataclasses.dataclass
class KVCacheLease:
    """One request's claim on the pool: matched chain + reserved blocks."""

    num_cached_tokens: int
    block_ids: List[int]  # matched prefix chain, root-to-leaf order
    reserved: List[int]  # pre-allocated for the prompt's uncached blocks
    pinned: List[int]  # every block this lease holds a reference on
    cacheable: bool = True  # False: prompt exceeds pool, serve hits only
    closed: bool = False


class KVCacheManager:
    def __init__(self, num_blocks: int, block_size: int = 32, plan=None):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self._block_size = int(block_size)
        self._alloc = BlockAllocator(num_blocks)
        self._index = PrefixIndex(self._block_size, self._alloc)
        # tensor-parallel partition plan: this rank's pools hold its
        # heads-slice of every block
        self._plan = plan
        self._mesh_tag = plan.describe() if plan is not None else MESH_TAG
        # device state, shaped from the first committed cache row
        self._pool_k: Optional[torch.Tensor] = None
        self._pool_v: Optional[torch.Tensor] = None
        self._max_seq_len = 0
        self._stats: Dict[str, int] = {
            "requests": 0,
            "hits": 0,
            "misses": 0,
            "prefix_hit_tokens": 0,
            "prefill_tokens_computed": 0,
            "admission_blocked": 0,
            "adopted_blocks": 0,
        }

    def adopt_plan(self, plan) -> None:
        """Late plan wiring (the engine passes its plan at construction).
        Must land before the first commit shapes the pools; afterwards the
        layouts would disagree, so a late adopt is an error."""
        if self._plan is plan or plan is None:
            return
        if self._pool_k is not None:
            raise RuntimeError(
                "adopt_plan() after the block pools were initialized; "
                "construct the KVCacheManager with plan= instead"
            )
        self._plan = plan
        self._mesh_tag = plan.describe()

    # -- accounting ----------------------------------------------------------

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def ready(self) -> bool:
        """True once the block pools are shaped (first commit, or
        ``initialize`` / ``initialize_for``); adopt_blocks and build_row
        need it."""
        return self._pool_k is not None

    def cached_blocks(self, token_ids: Sequence[int]) -> int:
        """Leading full blocks the index already holds for this prompt
        (capped like acquire: the last prompt token is never matched).
        Takes no references."""
        plen = len(token_ids)
        max_blocks = (plen - 1) // self._block_size if plen else 0
        return len(self._index.match(token_ids, max_blocks))

    @property
    def capacity(self) -> int:
        return self._alloc.capacity

    @property
    def blocks_in_use(self) -> int:
        return self._alloc.num_allocated

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._stats)
        out.update(
            capacity=self._alloc.capacity,
            block_size=self._block_size,
            blocks_in_use=self._alloc.num_allocated,
            blocks_free=self._alloc.num_free,
            evictions=self._index.num_evictions,
            index_nodes=self._index.num_nodes,
            mesh=self._mesh_tag,
            num_devices=self._plan.num_devices if self._plan is not None else 1,
        )
        out.update(self.pool_accounting())
        return out

    def pool_accounting(self) -> Dict[str, Any]:
        """Per-device block-pool accounting, as the reference's: each rank
        holds its heads-slice of every block, so the replica's pools are
        ``tp`` times this rank's and a device holds ``heads / tp`` heads:
        the numbers an operator needs to size ``num_blocks`` against device
        memory. Zeros before the first commit shapes the pools."""
        if self._pool_k is None:
            return {
                "kv_pool_bytes_total": 0,
                "kv_pool_bytes_per_device": 0,
                "heads_per_device": 0,
            }
        local = sum(p.numel() * p.element_size() for p in (self._pool_k, self._pool_v))
        # KV_SPEC splits the heads over tp: the tp ranks' slices make up the
        # replica's pools
        tp = self._plan.tp if self._plan is not None else 1
        ndev = self._plan.num_devices if self._plan is not None else 1
        return {
            "kv_pool_bytes_total": local * tp,
            "kv_pool_bytes_per_device": local * tp // ndev,
            "heads_per_device": self._pool_k.shape[2],
        }

    # -- lease lifecycle -----------------------------------------------------

    def acquire(self, token_ids: Sequence[int]) -> Optional[KVCacheLease]:
        """Match + admission gate. None == not enough blocks: the caller
        must keep the request queued and retry after a release."""
        plen = len(token_ids)
        # never match the whole prompt: at least one token must be
        # prefilled to produce the first-token logits
        max_blocks = (plen - 1) // self._block_size if plen else 0
        matched = self._index.match(token_ids, max_blocks)
        lease = KVCacheLease(
            num_cached_tokens=len(matched) * self._block_size,
            block_ids=[n.block_id for n in matched],
            reserved=[],
            pinned=[],
        )
        for node in matched:
            self._alloc.ref(node.block_id)
            lease.pinned.append(node.block_id)
        needed = plen // self._block_size - len(matched)
        if needed > self._alloc.capacity - len(matched):
            # the prompt can never fit alongside its own matched chain:
            # degrade to an uncacheable lease (hits still served) rather
            # than deadlocking admission forever
            lease.cacheable = False
            return lease
        for _ in range(needed):
            bid = self._allocate_or_evict()
            if bid is None:
                self.release(lease)
                self._stats["admission_blocked"] += 1
                self._record_blocked()
                return None
            lease.reserved.append(bid)
        return lease

    def release(self, lease: KVCacheLease) -> None:
        """Drop every reference the lease holds (idempotent)."""
        if lease.closed:
            return
        lease.closed = True
        for bid in lease.pinned:
            self._alloc.release(bid)
        for bid in lease.reserved:
            self._alloc.release(bid)
        lease.pinned = []
        lease.reserved = []
        self._update_gauges()

    def extend(self, lease: KVCacheLease, n_blocks: int) -> int:
        """Best-effort lease extension: reserve up to ``n_blocks`` more pool
        blocks for decode-tail commits (an accepted speculative run can
        cross several block boundaries in one engine step). Returns how many
        were obtained: on pool pressure the tail simply goes uncached;
        reserved blocks that never get committed are returned by release()
        like any other."""
        if lease.closed or lease.cacheable is False:
            return 0
        got = 0
        for _ in range(max(int(n_blocks), 0)):
            bid = self._allocate_or_evict()
            if bid is None:
                break
            lease.reserved.append(bid)
            got += 1
        return got

    # -- device state --------------------------------------------------------

    def initialize(self, cache_row: DecodeCache) -> None:
        """Shape the block pools from a 1-row cache (no-op after the first
        call): the row's layers, heads, head_dim, dtype and device."""
        if self._pool_k is not None:
            return
        n_layers, rows, heads, seq_len, head_dim = cache_row.key.shape
        if rows != 1:
            raise ValueError(f"initialize() takes a 1-row cache, got {rows} rows")
        self._shape_pools(n_layers, heads, seq_len, head_dim,
                          cache_row.key.dtype, cache_row.key.device)

    def initialize_for(self, model_config, device) -> None:
        """Shape the block pools from the model config, before any prefill
        (no-op once shaped): a scale-up replica's first request can arrive
        by the tier before it has computed anything. The reference shapes
        them from ``eval_shape`` of its prefill program."""
        if self._pool_k is not None:
            return
        c = model_config
        heads = (c.n_kv_heads if self._plan is None
                 else self._plan.kv_heads_per_rank(c.n_kv_heads))
        self._shape_pools(c.n_layers, heads, c.max_seq_len, c.head_dim,
                          c.dtype, torch.device(device))

    def _shape_pools(self, n_layers, heads, seq_len, head_dim, dtype, device) -> None:
        if seq_len < self._block_size:
            raise ValueError(
                f"block_size {self._block_size} exceeds max_seq_len {seq_len}"
            )
        self._max_seq_len = seq_len
        shape = (n_layers, self._alloc.capacity, heads, self._block_size, head_dim)
        self._pool_k = torch.zeros(shape, dtype=dtype, device=device)
        self._pool_v = torch.zeros(shape, dtype=dtype, device=device)

    def assemble(self, lease: KVCacheLease) -> DecodeCache:
        """Gather the lease's matched chain into a fresh 1-row cache: the
        chain's K/V in order, zeros past it, and every layer's write
        position at the cached token count, ready for the engine to decode
        the uncached suffix into."""
        if self._pool_k is None:
            raise RuntimeError("assemble() before any commit")
        n = len(lease.block_ids)
        if n == 0:
            raise ValueError("assemble() on a lease with no cached blocks")
        n_layers, _, heads, bs, head_dim = self._pool_k.shape
        device = self._pool_k.device
        bids = torch.tensor(lease.block_ids, device=device)
        out = []
        for pool in (self._pool_k, self._pool_v):
            row = torch.zeros(
                (n_layers, 1, heads, self._max_seq_len, head_dim),
                dtype=pool.dtype, device=device,
            )
            # (L, n, hk, bs, d) -> the row's first n*bs positions
            row[:, 0, :, :n * bs].unflatten(2, (n, bs)).copy_(
                pool.index_select(1, bids).transpose(1, 2)
            )
            out.append(row)
        index = torch.full(
            (n_layers, 1), lease.num_cached_tokens, dtype=torch.int32, device=device
        )
        return DecodeCache(out[0], out[1], index)

    # -- commit --------------------------------------------------------------

    def commit(
        self,
        lease: KVCacheLease,
        token_ids: Sequence[int],
        cache_row: DecodeCache,
        pin: bool = True,
    ) -> int:
        """Walk/extend the radix tree with every full block of
        ``token_ids``, copying missing blocks out of ``cache_row`` (whose
        K/V must cover the sequence). Reserved blocks are consumed first;
        past the reservation (decode tail at retire) allocation is
        best-effort: on exhaustion the tail simply is not cached. With
        ``pin``, blocks touched are pinned into the lease so they survive
        until release. Returns the number of newly committed blocks."""
        if lease.cacheable is False:
            return 0
        self.initialize(cache_row)
        written: List[int] = []
        offsets: List[int] = []
        node = self._index.root
        for i in range(len(token_ids) // self._block_size):
            key = tuple(
                int(t)
                for t in token_ids[
                    i * self._block_size : (i + 1) * self._block_size
                ]
            )
            child = self._index.child(node, key)
            if child is None:
                if lease.reserved:
                    bid = lease.reserved.pop(0)
                else:
                    bid = self._allocate_or_evict()
                    if bid is None:
                        break
                written.append(bid)
                offsets.append(i * self._block_size)
                child = self._index.insert_child(node, key, bid)
                if pin:
                    lease.pinned.append(bid)  # reservation ref becomes pin
                else:
                    self._alloc.release(bid)
            else:
                self._index.touch(child)
                if pin and child.block_id not in lease.pinned:
                    self._alloc.ref(child.block_id)
                    lease.pinned.append(child.block_id)
            node = child
        self._write_blocks(written, cache_row, offsets)
        self._update_gauges()
        return len(written)

    def update_block(self, block_id: int, cache_row: DecodeCache, tok_offset: int):
        """Overwrite one block from ``cache_row`` at ``tok_offset``,
        copy-on-write when the block is shared. The caller must own a
        reference on ``block_id``; that reference moves to the returned
        block id. None == pool exhausted mid-COW."""
        new_id = self._alloc.copy_on_write(block_id, copy_fn=self._copy_block)
        if new_id is None:
            return None
        self._write_blocks([new_id], cache_row, [tok_offset])
        return new_id

    def _write_blocks(self, bids: List[int], cache_row: DecodeCache,
                      offsets: List[int]) -> None:
        """Copy the block_size tokens of ``cache_row`` from each offset into
        the pool block of the same rank: one gather and one scatter per
        pool for all blocks and layers. An offset is clamped to [0,
        max_seq_len - block_size], as the reference's dynamic slice clamps
        its start."""
        if not bids:
            return
        bs = self._block_size
        device = self._pool_k.device
        starts = [min(max(int(o), 0), self._max_seq_len - bs) for o in offsets]
        pos = torch.tensor(
            [s + j for s in starts for j in range(bs)], device=device
        )
        dst = torch.tensor(bids, device=device)
        for pool, src in ((self._pool_k, cache_row.key), (self._pool_v, cache_row.value)):
            # (L, hk, m*bs, d) -> (L, m, hk, bs, d)
            blocks = src[:, 0].index_select(2, pos).unflatten(2, (len(bids), bs))
            pool[:, dst] = blocks.transpose(1, 2).to(pool.dtype)

    def _copy_block(self, src: int, dst: int) -> None:
        for pool in (self._pool_k, self._pool_v):
            pool[:, dst].copy_(pool[:, src])

    def _allocate_or_evict(self) -> Optional[int]:
        bid = self._alloc.allocate()
        while bid is None:
            if not self._index.evict_lru(1):
                return None
            _metrics.record_kvcache_eviction(1, mesh=self._mesh_tag)
            bid = self._alloc.allocate()
        return bid

    # -- tier shipment interop ----------------------------------------------
    #
    # The KV tier ships committed prefixes between replicas as a payload
    # pytree of tensors (on the cache's device; the tier's encode moves them
    # to the host):
    #
    #   {"blocks": [K, V], each (nblocks, n_layers, n_kv_heads, block_size,
    #               head_dim): block b, layer l is blocks[.][b, l];
    #    "tail": [K_0, V_0, K_1, V_1, ..., K_{L-1}, V_{L-1}], each
    #            (n_kv_heads, tail_len, head_dim), or None without a tail}
    #
    # The reference's payload has one leaf per layer and K/V, (nblocks, hk,
    # bs, d) blocks and (hk, tail_len, d) tails, in flax's name order
    # (layer_0, layer_1, layer_10, ..., layer_2). The int8 codec codes each
    # leaf in 256-element groups from its start. A (block, layer) slab here
    # is hk * bs * d elements, a whole number of groups whenever that is a
    # multiple of 256 (7B at block 32: 131,072; the tiny test model at block
    # 8: 1,024), so every group of a blocks leaf covers the elements of one
    # group of the reference's leaf, and codes, scales and dequantized K/V
    # are equal. The tail stays one leaf per layer, as the reference's: its
    # slab hk * tail_len * d need not be a multiple of 256.
    #
    # extract_row_payload builds the payload from a request's 1-row cache,
    # adopt_blocks lands shipped blocks in the pool and the radix index (so
    # later LOCAL requests hit them), and build_row turns a full payload
    # back into a 1-row cache, so the decode engine starts without running
    # prefill. The engine calls them in admission, on the thread that steps
    # it, never inside the pooled decode forward.

    def extract_row_payload(self, cache_row: DecodeCache, ntokens: int):
        """The first ``ntokens`` tokens of a 1-row cache's K/V as a shipment
        payload (the layout above): one gather copy per pool for the blocks
        and one for the tail, on the cache's device."""
        if self._pool_k is None:
            self.initialize(cache_row)
        bs = self._block_size
        nblocks = ntokens // bs
        tail_len = ntokens - nblocks * bs
        blocks, tail = [], []
        for src in (cache_row.key, cache_row.value):
            x = src[:, 0]  # (L, hk, S, d)
            # (L, hk, nb*bs, d) -> (nb, L, hk, bs, d)
            blocks.append(
                x[:, :, :nblocks * bs].unflatten(2, (nblocks, bs))
                .permute(2, 0, 1, 3, 4).clone(memory_format=torch.contiguous_format)
            )
            if tail_len:
                tail.append(x[:, :, nblocks * bs:ntokens].clone(
                    memory_format=torch.contiguous_format).unbind(0))
        return {
            "blocks": blocks,
            # per layer: K_0, V_0, K_1, V_1, ...
            "tail": [t for kv in zip(*tail) for t in kv] if tail else None,
        }

    def adopt_blocks(self, token_ids: Sequence[int], block_leaves, nblocks: int) -> int:
        """Admit shipped blocks into the pool and the radix index. Walks the
        first ``nblocks`` full-block keys of ``token_ids``: blocks the index
        already holds are touched (a shipped copy never overwrites a live
        shared block), missing ones get a fresh pool slot. Allocation
        failure stops the walk: partial adoption in chain order keeps the
        prefix property, and the un-adopted rest is recomputed (admission
        backpressure, not an error). The walked chain is pinned while the
        new blocks are allocated, so the walk never evicts a node of its own
        chain. Once a key is missing, every later key is missing too, so the
        new blocks are one run of the shipment: they land with one copy to
        the pool's device and one scatter per pool, and enter the index only
        after it. An adopted block is then referenced by the index alone, so
        it is evictable like a committed one (the reference's keeps its
        allocation reference too, so it is never evicted). Returns how many
        leading blocks the index holds afterwards."""
        if self._pool_k is None:
            raise RuntimeError("adopt_blocks() before the pools are initialized")
        bs = self._block_size
        keys = [tuple(int(t) for t in token_ids[i * bs:(i + 1) * bs])
                for i in range(nblocks)]
        node = self._index.root
        chain = []
        for key in keys:
            child = self._index.child(node, key)
            if child is None:
                break
            self._index.touch(child)
            chain.append(child)
            node = child
        first = len(chain)
        pinned = [n.block_id for n in chain]
        for bid in pinned:
            self._alloc.ref(bid)
        dst: List[int] = []
        try:
            for _ in range(first, nblocks):
                bid = self._allocate_or_evict()
                if bid is None:
                    break
                # the allocation's reference is the pin
                pinned.append(bid)
                dst.append(bid)
            if dst:
                device = self._pool_k.device
                dst_t = torch.tensor(dst, device=device)
                for pool, leaf in zip((self._pool_k, self._pool_v), block_leaves):
                    # (m, L, hk, bs, d) -> (L, m, hk, bs, d)
                    src = leaf[first:first + len(dst)].to(
                        device=device, dtype=pool.dtype, non_blocking=True)
                    pool[:, dst_t] = src.transpose(0, 1)
                for key, bid in zip(keys[first:], dst):
                    node = self._index.insert_child(node, key, bid)
                self._stats["adopted_blocks"] += len(dst)
        finally:
            # the index keeps its own reference, as after commit(pin=False);
            # a block that never entered it goes back to the free list
            for bid in pinned:
                self._alloc.release(bid)
        present = first + len(dst)
        self._update_gauges()
        return present

    def build_row(self, payload, ntokens: int) -> DecodeCache:
        """A FULL shipment payload (blocks and tail covering exactly
        ``ntokens``) as a fresh 1-row cache whose write position is past the
        whole prompt: the zero-prefill decode entry point."""
        if self._pool_k is None:
            raise RuntimeError("build_row() before the pools are initialized")
        bs = self._block_size
        nblocks = ntokens // bs
        tail_len = ntokens - nblocks * bs
        n_layers, _, heads, _, head_dim = self._pool_k.shape
        device = self._pool_k.device
        out = []
        for i, (pool, blocks) in enumerate(zip((self._pool_k, self._pool_v),
                                                payload["blocks"])):
            row = torch.zeros((n_layers, 1, heads, self._max_seq_len, head_dim),
                              dtype=pool.dtype, device=device)
            if nblocks:
                # (nb, L, hk, bs, d) -> the row's first nb*bs positions
                row[:, 0, :, :nblocks * bs].unflatten(2, (nblocks, bs)).copy_(
                    blocks.to(device, non_blocking=True).permute(1, 2, 0, 3, 4)
                )
            if tail_len:
                tail = torch.stack(payload["tail"][i::2])  # (L, hk, tail, d)
                row[:, 0, :, nblocks * bs:ntokens].copy_(tail.to(device, non_blocking=True))
            out.append(row)
        index = torch.full((n_layers, 1), ntokens, dtype=torch.int32, device=device)
        return DecodeCache(out[0], out[1], index)

    # Under a tensor-parallel plan each rank's rows and pools hold its KV
    # heads, while a shipment carries every head whatever the layout (the
    # reference brings its sharded row to the host whole), so that a tp=2
    # side and a tp=1 side interoperate. The two calls below move a payload
    # between the two forms through the plan's group; every rank of the
    # replica calls them at the same point, on the thread that steps it.
    # Without a plan of tp > 1 they return the payload as it is.

    def gather_payload(self, payload):
        """Every rank's payload of its heads (:meth:`extract_row_payload`)
        gathered to rank 0 along the heads axis, in rank order (the head
        order of ``PartitionPlan.kv_head_shard``): the all-heads payload on
        rank 0, None on the other ranks."""
        plan = self._plan
        if plan is None or plan.tp == 1:
            return payload
        group, parts = plan.group, _payload_parts(payload)
        if plan.rank != 0:
            for t, _ in parts:
                group.send(t, 0)
            return None
        return _payload_from_parts(
            [torch.cat([t] + [group.recv(r).to(t.device) for r in range(1, plan.num_devices)],
                       dim=axis) for t, axis in parts])

    def scatter_payload(self, payload, nblocks: int, ntokens: int):
        """Rank 0's all-heads ``payload`` (None on the other ranks), cut to
        its first ``nblocks`` blocks and, where ``ntokens`` passes them, the
        tail: this rank's heads of it, each other rank's sent to it from
        rank 0. ``nblocks`` and ``ntokens`` are the same on every rank."""
        plan = self._plan
        if plan is None or plan.tp == 1:
            return payload
        group, tail = plan.group, ntokens > nblocks * self._block_size
        if plan.rank != 0:
            device = plan.device()
            return _payload_from_parts(
                [group.recv(0).to(device) for _ in range(4 if tail else 2)])
        parts = _payload_parts({"blocks": [b[:nblocks] for b in payload["blocks"]],
                                "tail": payload["tail"] if tail else None})
        for r in range(1, plan.num_devices):
            for t, axis in parts:
                group.send(plan.kv_head_shard(t, axis, r).clone(
                    memory_format=torch.contiguous_format), r)
        return _payload_from_parts([plan.kv_head_shard(t, axis) for t, axis in parts])

    # -- counters and metrics ------------------------------------------------

    def record_prefill(self, hit_tokens: int, computed_tokens: int) -> None:
        """Called by the engine after each admission prefill."""
        self._stats["requests"] += 1
        self._stats["hits" if hit_tokens else "misses"] += 1
        self._stats["prefix_hit_tokens"] += hit_tokens
        self._stats["prefill_tokens_computed"] += computed_tokens
        _metrics.record_kvcache_prefill(hit_tokens, computed_tokens, mesh=self._mesh_tag)
        self._update_gauges()

    def _record_blocked(self) -> None:
        _metrics.record_kvcache_blocked(mesh=self._mesh_tag)
        _events.record_event(
            _events.ADMISSION_BLOCKED,
            blocks_free=self._alloc.num_free,
            blocked_total=self._stats["admission_blocked"],
        )

    def _update_gauges(self) -> None:
        _metrics.set_kvcache_blocks(
            self._alloc.num_allocated, self._alloc.capacity, mesh=self._mesh_tag
        )


def _payload_parts(payload) -> List[tuple]:
    """A shipment payload as (tensor, heads axis) parts: the K and V blocks
    leaves, then, with a tail, every layer's K tail stacked and its V tail
    stacked."""
    parts = [(b, 2) for b in payload["blocks"]]
    if payload["tail"]:
        parts += [(torch.stack(payload["tail"][kv::2]), 1) for kv in (0, 1)]
    return parts


def _payload_from_parts(parts: List[torch.Tensor]):
    """The inverse of :func:`_payload_parts`."""
    tail = None
    if len(parts) == 4:
        tail = [t for kv in zip(parts[2].unbind(0), parts[3].unbind(0)) for t in kv]
    return {"blocks": parts[:2], "tail": tail}
