"""Refcounted fixed-size KV block pool: free-list + copy-on-write bookkeeping.

A copy of ray_tpu/kvcache/block_allocator.py, behaviour unchanged (the port
imports nothing of ray_tpu). This is the logical half of the paged KV cache
(reference analogue: vLLM's ``BlockAllocator``): block ids index into the
pooled device tensors owned by
:class:`~ray_tpu_torch.kvcache.manager.KVCacheManager`, but the allocator
itself is pure Python bookkeeping, so refcount/COW/free-list behaviour is
unit-testable without a device.

Refcount conventions used by the rest of the plane:

- ``allocate()`` returns a block with refcount 1, owned by the caller
  (typically a :class:`~ray_tpu_torch.kvcache.manager.KVCacheLease`
  reservation).
- The prefix index takes its own ``ref()`` when a block is inserted, and
  ``release()``s it on eviction.
- Active requests pin the blocks they read or wrote with ``ref()`` and
  release them when the request retires; a block whose only remaining
  reference is the index (refcount 1) is eviction-eligible.
"""

from __future__ import annotations

from typing import Callable, List, Optional


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` equally sized KV blocks."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self._num_blocks = int(num_blocks)
        # LIFO free list: recently released blocks are reused first, which
        # keeps the hot end of the pooled device tensors dense.
        self._free: List[int] = list(range(self._num_blocks - 1, -1, -1))
        self._refcounts: List[int] = [0] * self._num_blocks

    # -- accounting ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._num_blocks

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return self._num_blocks - len(self._free)

    def refcount(self, block_id: int) -> int:
        return self._refcounts[block_id]

    # -- allocate / ref / release --------------------------------------------

    def allocate(self) -> Optional[int]:
        """Pop a free block (refcount becomes 1), or None when exhausted."""
        if not self._free:
            return None
        block_id = self._free.pop()
        self._refcounts[block_id] = 1
        return block_id

    def ref(self, block_id: int) -> int:
        """Add a reference to a live block; returns the new refcount."""
        if self._refcounts[block_id] <= 0:
            raise ValueError(f"ref() on free block {block_id}")
        self._refcounts[block_id] += 1
        return self._refcounts[block_id]

    def release(self, block_id: int) -> int:
        """Drop one reference; the block returns to the free list at zero."""
        rc = self._refcounts[block_id]
        if rc <= 0:
            raise ValueError(f"release() on free block {block_id}")
        rc -= 1
        self._refcounts[block_id] = rc
        if rc == 0:
            self._free.append(block_id)
        return rc

    # -- copy-on-write -------------------------------------------------------

    def copy_on_write(
        self,
        block_id: int,
        copy_fn: Optional[Callable[[int, int], None]] = None,
    ) -> Optional[int]:
        """Make ``block_id`` safely writable by the caller.

        A shared block (refcount > 1) cannot be mutated in place without
        corrupting the other readers, so COW allocates a fresh block,
        invokes ``copy_fn(src, dst)`` (the manager's block copy) to
        duplicate the payload, and moves one of the caller's references to
        the new block. An exclusively held block (refcount 1) is returned
        unchanged. Returns None when a copy is needed but the pool is
        exhausted.
        """
        rc = self._refcounts[block_id]
        if rc <= 0:
            raise ValueError(f"copy_on_write() on free block {block_id}")
        if rc == 1:
            return block_id
        new_id = self.allocate()
        if new_id is None:
            return None
        if copy_fn is not None:
            copy_fn(block_id, new_id)
        self.release(block_id)
        return new_id

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"BlockAllocator(capacity={self._num_blocks}, "
            f"free={self.num_free}, allocated={self.num_allocated})"
        )
