"""KV-cache plane: the paged, prefix-reusing device cache for LLM serving.

The port of ray_tpu/kvcache. The dense per-engine KV pool (``num_slots x
max_seq_len``) reserves device memory for the worst case and re-prefills
identical system prompts on every request. This package is the subsystem
that replaces it (reference analogues: vLLM's BlockSpaceManager + prefix
caching):

- :mod:`.block_allocator`: refcounted fixed-size block pool with
  copy-on-write semantics and free-list accounting (pure bookkeeping; it
  never touches device memory).
- :mod:`.prefix_index`: token-radix tree mapping prompt prefixes (at block
  granularity) to block chains, with LRU eviction of unreferenced leaves.
- :mod:`.manager`: :class:`KVCacheManager`, the device-facing facade: it
  owns the pooled device tensors, serves longest-prefix matches, assembles
  cached blocks into a slot row, commits new blocks after prefill/decode,
  and gates admission on free blocks (backpressure instead of running out
  of memory).
"""

from .block_allocator import BlockAllocator
from .manager import KVCacheLease, KVCacheManager
from .prefix_index import PrefixIndex

__all__ = [
    "BlockAllocator",
    "KVCacheLease",
    "KVCacheManager",
    "PrefixIndex",
]
