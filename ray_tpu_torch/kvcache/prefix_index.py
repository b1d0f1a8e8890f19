"""Token-radix tree mapping prompt prefixes to KV block chains.

A copy of ray_tpu/kvcache/prefix_index.py, behaviour unchanged (the port
imports nothing of ray_tpu).

The tree is block-granular (reference analogue: vLLM/SGLang prefix caching):
each edge is keyed by the tuple of ``block_size`` token ids that fill one KV
block, so a path from the root spells out a prompt prefix in whole blocks
and the nodes along it name the pooled device blocks holding that prefix's
K/V. Matching a new prompt is a walk from the root; every matched node's
block can be gathered into the slot row instead of re-prefilled.

Eviction is LRU over *unreferenced leaves*: a node is evictable only when
it has no children (evicting an interior node would orphan its subtree's
prefixes) and its block's only remaining reference is the index itself
(allocator refcount 1 — no active request pins it). Evicting a leaf can
expose its parent as the next evictable leaf, so chains drain naturally
under repeated eviction.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .block_allocator import BlockAllocator

TokenKey = Tuple[int, ...]


class RadixNode:
    """One committed KV block: edge key is the block's token ids."""

    __slots__ = ("key", "block_id", "parent", "children", "last_used")

    def __init__(
        self,
        key: Optional[TokenKey],
        block_id: Optional[int],
        parent: Optional["RadixNode"],
    ):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children: Dict[TokenKey, "RadixNode"] = {}
        self.last_used = 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"RadixNode(block={self.block_id}, children={len(self.children)})"


class PrefixIndex:
    """Radix tree over block-sized token keys with LRU leaf eviction."""

    def __init__(self, block_size: int, allocator: BlockAllocator):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self._block_size = int(block_size)
        self._alloc = allocator
        self.root = RadixNode(None, None, None)
        # logical clock for LRU ordering; monotonic, never wraps in practice
        self._clock = 0
        self._num_nodes = 0
        self._evictions = 0

    # -- accounting ----------------------------------------------------------

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    @property
    def num_evictions(self) -> int:
        return self._evictions

    # -- lookup / insert -----------------------------------------------------

    def _key_at(self, tokens: Sequence[int], block_index: int) -> TokenKey:
        start = block_index * self._block_size
        return tuple(int(t) for t in tokens[start : start + self._block_size])

    def match(self, tokens: Sequence[int], max_blocks: int) -> List[RadixNode]:
        """Longest-prefix match: nodes for the leading full blocks of
        ``tokens`` already in the tree, capped at ``max_blocks``."""
        limit = min(max_blocks, len(tokens) // self._block_size)
        node = self.root
        matched: List[RadixNode] = []
        for i in range(limit):
            child = node.children.get(self._key_at(tokens, i))
            if child is None:
                break
            self.touch(child)
            matched.append(child)
            node = child
        return matched

    def child(self, node: RadixNode, key: TokenKey) -> Optional[RadixNode]:
        return node.children.get(key)

    def insert_child(
        self, node: RadixNode, key: TokenKey, block_id: int
    ) -> RadixNode:
        """Attach a committed block under ``node``; the index takes its own
        reference so the block survives until evicted."""
        if key in node.children:
            raise ValueError(f"duplicate child key under block {node.block_id}")
        if len(key) != self._block_size:
            raise ValueError(
                f"key length {len(key)} != block_size {self._block_size}"
            )
        child = RadixNode(key, block_id, node)
        node.children[key] = child
        self._alloc.ref(block_id)
        self._num_nodes += 1
        self.touch(child)
        return child

    def touch(self, node: RadixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    # -- eviction ------------------------------------------------------------

    def _evictable_leaves(self) -> List[RadixNode]:
        out: List[RadixNode] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (
                node is not self.root
                and not node.children
                and self._alloc.refcount(node.block_id) == 1
            ):
                out.append(node)
        return out

    def clear(self) -> int:
        """Drop every node, each releasing the index's reference on its block
        (a block a lease still holds stays with the lease; the others return
        to the free list), counted as evictions. Returns the number dropped."""
        dropped = 0
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            node.children, node.parent = {}, None
            self._alloc.release(node.block_id)
            dropped += 1
        self.root.children = {}
        self._num_nodes = 0
        self._evictions += dropped
        return dropped

    def evict_lru(self, num_blocks: int = 1) -> int:
        """Evict up to ``num_blocks`` least-recently-used unreferenced
        leaves, releasing their blocks to the free list. Returns the number
        actually freed (0 when every leaf is pinned)."""
        freed = 0
        while freed < num_blocks:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_used)
            del victim.parent.children[victim.key]
            victim.parent = None
            self._alloc.release(victim.block_id)
            self._num_nodes -= 1
            self._evictions += 1
            freed += 1
        return freed
