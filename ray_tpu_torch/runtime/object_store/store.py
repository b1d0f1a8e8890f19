"""Node-local shared-memory object store.

Role-equivalent of the reference's Plasma store (src/ray/object_manager/plasma/
store.h — mmap arenas + dlmalloc, create/seal/get/release lifecycle, LRU
eviction, embedded in the raylet). Here: the raylet embeds an ``ObjectStore``
whose objects live in named POSIX shared memory (`/dev/shm`), one segment per
object; workers on the node attach segments by name for zero-copy reads.
Control messages (create/seal/get/release/free) travel over the raylet's RPC
endpoint rather than a dedicated unix socket.

The store tracks per-object reader counts (pins) and evicts sealed,
unpinned objects LRU when a create would exceed capacity (reference:
eviction_policy.h). Spilling hooks onto the eviction path.

A copy of ``ray_tpu/runtime/object_store/store.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field
from multiprocessing import shared_memory
from typing import Dict, List, Optional

from ..._internal.ids import ObjectID
from ...exceptions import ObjectStoreFullError

logger = logging.getLogger(__name__)


class _Segment(shared_memory.SharedMemory):
    """SharedMemory with store-owned lifetime.

    On Python 3.12 even *attaching* registers a segment with the
    multiprocessing resource tracker, which then unlinks it when the attaching
    process exits — fatal for a store whose segments outlive readers. Every
    segment is therefore unregistered at construction and unlinked explicitly
    via shm_unlink (never through the tracker). The finalizer also swallows
    BufferError: zero-copy numpy views may still alias the mapping at
    interpreter teardown.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(self._name, "shared_memory")
        except Exception:
            pass

    def unlink(self):
        import _posixshmem

        _posixshmem.shm_unlink(self._name)

    def __del__(self):
        try:
            super().__del__()
        except BufferError:
            pass


@dataclass
class _Entry:
    object_id: ObjectID
    segment_name: str
    size: int
    shm: shared_memory.SharedMemory
    sealed: bool = False
    pin_count: int = 0
    last_access: float = field(default_factory=time.time)
    seal_waiters: List[asyncio.Event] = field(default_factory=list)
    # objects pinned as primary copies (owned here) are never evicted until freed
    primary: bool = False
    # weight-plane pins (refcounted): chunks of a pinned model version are
    # exempt from LRU eviction AND from spill selection while any subscriber
    # holds the version — a reader-side guarantee that survives between the
    # fetch that landed the chunk and the get that maps it
    weight_pins: int = 0


class ObjectStore:
    """Server side, embedded in the raylet process."""

    def __init__(self, capacity_bytes: int, session_id: str):
        self.capacity = capacity_bytes
        self.session_id = session_id
        self._entries: Dict[ObjectID, _Entry] = {}
        self._used = 0
        self._seq = 0

    # -- lifecycle ---------------------------------------------------------

    def create(self, object_id: ObjectID, size: int) -> str:
        """Allocate a segment; returns its name. Caller writes then seals."""
        if object_id in self._entries:
            return self._entries[object_id].segment_name
        if size > self.capacity:
            raise ObjectStoreFullError(
                f"object of {size} bytes exceeds store capacity {self.capacity}"
            )
        self._evict_until(size)
        name = f"rtt_{self.session_id}_{self._seq}"
        self._seq += 1
        shm = _Segment(create=True, size=max(size, 1), name=name)
        self._entries[object_id] = _Entry(object_id, name, size, shm)
        self._used += size
        return name

    def seal(self, object_id: ObjectID):
        entry = self._entries.get(object_id)
        if entry is None:
            raise KeyError(f"seal of unknown object {object_id}")
        entry.sealed = True
        entry.last_access = time.time()
        for ev in entry.seal_waiters:
            ev.set()
        entry.seal_waiters.clear()

    def create_and_write(self, object_id: ObjectID, data: bytes | memoryview) -> str:
        """Server-local put (used when objects arrive via RPC transfer)."""
        name = self.create(object_id, len(data))
        entry = self._entries[object_id]
        entry.shm.buf[: len(data)] = data
        self.seal(object_id)
        return name

    def contains(self, object_id: ObjectID) -> bool:
        e = self._entries.get(object_id)
        return e is not None and e.sealed

    async def get(self, object_id: ObjectID, timeout: Optional[float] = None):
        """Wait until sealed; returns (segment_name, size). Pins the object."""
        entry = self._entries.get(object_id)
        if entry is None:
            return None
        if not entry.sealed:
            ev = asyncio.Event()
            entry.seal_waiters.append(ev)
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                return None
            entry = self._entries.get(object_id)
            if entry is None:
                return None
        entry.pin_count += 1
        entry.last_access = time.time()
        return entry.segment_name, entry.size

    def release(self, object_id: ObjectID):
        entry = self._entries.get(object_id)
        if entry is not None and entry.pin_count > 0:
            entry.pin_count -= 1

    def pin_primary(self, object_id: ObjectID):
        """Mark as the primary copy — protected from eviction until freed
        (reference: primary-copy pinning in LocalObjectManager)."""
        entry = self._entries.get(object_id)
        if entry is not None:
            entry.primary = True

    def pin_weight(self, object_id: ObjectID) -> bool:
        """Refcounted weight-plane pin: exempts the object from eviction and
        from spill selection until the matching unpin_weight."""
        entry = self._entries.get(object_id)
        if entry is None:
            return False
        entry.weight_pins += 1
        return True

    def unpin_weight(self, object_id: ObjectID):
        entry = self._entries.get(object_id)
        if entry is not None and entry.weight_pins > 0:
            entry.weight_pins -= 1

    def free(self, object_id: ObjectID):
        entry = self._entries.pop(object_id, None)
        if entry is not None:
            self._used -= entry.size
            try:
                entry.shm.unlink()
            except FileNotFoundError:
                pass
            try:
                entry.shm.close()
            except BufferError:
                # a served memoryview still aliases the mapping; the unlink
                # above already reclaimed the name, mapping dies with readers
                pass

    def free_if_unpinned(self, object_id: ObjectID):
        """True = freed now, False = pinned, None = wasn't present (a
        concurrent free already removed it — callers spilling must not
        record a spill copy for a vanished object)."""
        entry = self._entries.get(object_id)
        if entry is None:
            return None
        if entry.pin_count > 0 or entry.weight_pins > 0:
            return False
        self.free(object_id)
        return True

    def read_local(self, object_id: ObjectID) -> Optional[memoryview]:
        """Zero-copy view for in-process readers (the raylet's own transfers)."""
        entry = self._entries.get(object_id)
        if entry is None or not entry.sealed:
            return None
        entry.last_access = time.time()
        return entry.shm.buf[: entry.size]

    def write_view(self, object_id: ObjectID) -> memoryview:
        """Writable view of an unsealed object for in-raylet transfers."""
        entry = self._entries[object_id]
        return entry.shm.buf[: entry.size]

    # -- eviction ----------------------------------------------------------

    def _evict_until(self, need: int):
        if self._used + need <= self.capacity:
            return
        victims = sorted(
            (
                e
                for e in self._entries.values()
                if e.sealed
                and e.pin_count == 0
                and not e.primary
                and e.weight_pins == 0
            ),
            key=lambda e: e.last_access,
        )
        for entry in victims:
            if self._used + need <= self.capacity:
                return
            logger.debug("evicting %s (%d bytes)", entry.object_id, entry.size)
            self.free(entry.object_id)
        if self._used + need > self.capacity:
            raise ObjectStoreFullError(
                f"cannot allocate {need} bytes: {self._used}/{self.capacity} used, "
                "all remaining objects pinned"
            )

    def lru_spillable(self) -> Optional[ObjectID]:
        """Least-recently-used primary copy eligible for spilling
        (sealed, unpinned; primaries are exempt from plain eviction).
        Weight-pinned chunks are NOT spillable: an in-flight subscribe
        reading them zero-copy must never race a spill-then-free."""
        victims = [
            e
            for e in self._entries.values()
            if e.sealed
            and e.pin_count == 0
            and e.primary
            and e.weight_pins == 0
        ]
        if not victims:
            return None
        return min(victims, key=lambda e: e.last_access).object_id

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "used": self._used,
            "num_objects": len(self._entries),
        }

    def shutdown(self):
        for oid in list(self._entries):
            self.free(oid)


class StoreClient:
    """Client side, used by workers/driver to read and write segments
    (reference: plasma/client.h — mmap'd client). Two segment-ref forms:
    a bare shm name (python per-segment store) and ``arena:<path>:<offset>``
    (native C++ arena store — the whole arena file is mmapped once and
    sliced, the client analogue of plasma's single shared mapping)."""

    def __init__(self):
        self._attached: Dict[str, shared_memory.SharedMemory] = {}
        self._arenas: Dict[str, "mmap.mmap"] = {}

    def _arena_view(self, path: str, offset: int, length: int):
        import mmap as mmap_mod

        mm = self._arenas.get(path)
        if mm is None:
            fd = os.open(path, os.O_RDWR)
            try:
                mm = mmap_mod.mmap(fd, 0)
            finally:
                os.close(fd)
            self._arenas[path] = mm
        return memoryview(mm)[offset : offset + length]

    def _view(self, segment_ref: str, size: int):
        if segment_ref.startswith("arena:"):
            _, path, offset = segment_ref.rsplit(":", 2)
            return self._arena_view(path, int(offset), size)
        shm = self._attached.get(segment_ref)
        if shm is None:
            shm = _Segment(name=segment_ref)
            self._attached[segment_ref] = shm
        return shm.buf[:size]

    def write(self, segment_ref: str, meta: bytes, bufs, packed_size: int):
        from ..._internal import serialization

        if segment_ref.startswith("arena:"):
            view = self._view(segment_ref, packed_size)
            serialization.pack_into(meta, bufs, view)
            return
        shm = _Segment(name=segment_ref)
        try:
            serialization.pack_into(meta, bufs, shm.buf[:packed_size])
        finally:
            shm.close()

    def read(self, segment_ref: str, size: int):
        """Returns a memoryview aliasing shared memory. The mapping stays
        attached; numpy arrays deserialized from it alias the store
        (zero-copy get)."""
        return self._view(segment_ref, size)

    def detach(self, segment_ref: str):
        if segment_ref.startswith("arena:"):
            return  # arena mapping is shared across objects; keep it
        shm = self._attached.pop(segment_ref, None)
        if shm is not None:
            try:
                shm.close()
            except BufferError:
                # a deserialized array still aliases the buffer; leave attached
                self._attached[segment_ref] = shm

    def close(self):
        for name in list(self._attached):
            self.detach(name)
        for path, mm in list(self._arenas.items()):
            try:
                mm.close()
            except (BufferError, ValueError):
                pass  # zero-copy arrays may still alias the mapping
        self._arenas.clear()
