"""Native-arena object store: Python lifecycle over the C++ core.

Role-equivalent of the reference's plasma store embedding
(src/ray/object_manager/plasma/store.h inside the raylet): allocation, pin
counts, primary-copy protection, and LRU eviction run in C++
(_native/store.cc) over ONE file-backed mmap arena; this wrapper adds the
async seal-waiting the raylet RPC layer needs and mirrors true (unpadded)
object sizes. Segment references are ``arena:<path>:<offset>`` strings that
clients resolve by mmapping the arena once (the zero-copy equivalent of
plasma's fd-passing, fling.cc).

A copy of ``ray_tpu/runtime/object_store/native_store.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import mmap
import os
from typing import Dict, List, Optional

from ..._internal.ids import ObjectID
from ...exceptions import ObjectStoreFullError

logger = logging.getLogger(__name__)


class FetchInFlightError(ObjectStoreFullError):
    """A native transfer-plane fetch of this object is mid-stream: the C++
    arena entry exists but the python mirrors don't yet. Transient — the
    caller should back off briefly and retry rather than spill."""


class NativeObjectStore:
    def __init__(self, capacity_bytes: int, session_id: str, lib):
        self.capacity = capacity_bytes
        self.session_id = session_id
        self._lib = lib
        self.arena_path = f"/dev/shm/rtt_arena_{session_id}"
        self._h = lib.rt_store_open(self.arena_path.encode(), capacity_bytes)
        if self._h < 0:
            raise RuntimeError(f"rt_store_open failed for {self.arena_path}")
        # raylet-local read/write mapping of the same arena
        self._fd = os.open(self.arena_path, os.O_RDWR)
        self._mm = mmap.mmap(self._fd, capacity_bytes)
        # python-side mirrors: true sizes + seal waiters
        self._sizes: Dict[ObjectID, int] = {}
        self._offsets: Dict[ObjectID, int] = {}
        self._sealed: Dict[ObjectID, bool] = {}
        self._waiters: Dict[ObjectID, List[asyncio.Event]] = {}
        # objects whose bytes rt_transfer_fetch is streaming into the arena
        # right now (C++ entry exists, python mirrors pending adopt_fetched)
        self._fetching: set = set()
        # weight-plane pins held as C++ reader pins (see pin_weight)
        self._weight_pins: Dict[ObjectID, int] = {}

    # -- helpers -------------------------------------------------------------

    def _key(self, object_id: ObjectID) -> bytes:
        return object_id.hex().encode()

    def _segment_ref(self, offset: int) -> str:
        return f"arena:{self.arena_path}:{offset}"

    def _gc_mirrors(self, object_id: ObjectID):
        self._sizes.pop(object_id, None)
        self._offsets.pop(object_id, None)
        self._sealed.pop(object_id, None)

    def _sync_evicted(self):
        """Drop python mirrors for objects the C++ LRU evicted."""
        for oid in list(self._sealed):
            if self._sealed[oid] and not self._lib.rt_contains(
                self._h, self._key(oid)
            ):
                self._gc_mirrors(oid)

    # -- lifecycle (same interface as the python ObjectStore) ---------------

    def create(self, object_id: ObjectID, size: int) -> str:
        # drop mirrors for anything the C++ LRU evicted FIRST: the fast path
        # below must never hand out an offset whose block was reallocated
        self._sync_evicted()
        if object_id in self._offsets:
            return self._segment_ref(self._offsets[object_id])
        # pass the TRUE size: rt_create pads the allocation itself and
        # records true_size for the transfer plane's payload header
        off = self._lib.rt_create(self._h, self._key(object_id), size)
        if off == -2:  # raced: already created
            off = self._offsets.get(object_id)
            if off is None:
                if object_id in self._fetching:
                    # a native pull is streaming the same object in; its
                    # mirrors land via adopt_fetched on this event loop
                    raise FetchInFlightError(
                        f"native fetch of {object_id} in flight"
                    )
                raise KeyError(f"create race lost for {object_id}")
            return self._segment_ref(off)
        if off < 0:
            raise ObjectStoreFullError(
                f"cannot allocate {size} bytes "
                f"({self._lib.rt_used(self._h)}/{self.capacity} used, "
                "remaining objects pinned)"
            )
        self._sync_evicted()
        self._offsets[object_id] = off
        self._sizes[object_id] = size
        self._sealed[object_id] = False
        return self._segment_ref(off)

    def seal(self, object_id: ObjectID):
        if self._lib.rt_seal(self._h, self._key(object_id)) != 0:
            raise KeyError(f"seal of unknown object {object_id}")
        self._sealed[object_id] = True
        for ev in self._waiters.pop(object_id, []):
            ev.set()

    def create_and_write(self, object_id: ObjectID, data) -> str:
        ref = self.create(object_id, len(data))
        off = self._offsets[object_id]
        self._mm[off : off + len(data)] = data
        self.seal(object_id)
        return ref

    def write_view(self, object_id: ObjectID) -> memoryview:
        """Writable view for in-raylet transfers (pull path)."""
        off = self._offsets[object_id]
        size = self._sizes[object_id]
        return memoryview(self._mm)[off : off + size]

    def contains(self, object_id: ObjectID) -> bool:
        return bool(self._lib.rt_contains(self._h, self._key(object_id)))

    async def get(self, object_id: ObjectID, timeout: Optional[float] = None):
        """Wait until sealed; returns (segment_ref, size). Pins the object."""
        if object_id not in self._sealed and not self.contains(object_id):
            return None
        if not self._sealed.get(object_id, True):
            ev = asyncio.Event()
            self._waiters.setdefault(object_id, []).append(ev)
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                return None
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rt_get(
            self._h, self._key(object_id), ctypes.byref(off), ctypes.byref(size)
        )
        if rc != 0:
            return None
        true_size = self._sizes.get(object_id, size.value)
        return self._segment_ref(off.value), true_size

    def release(self, object_id: ObjectID):
        self._lib.rt_release(self._h, self._key(object_id))

    def pin_primary(self, object_id: ObjectID):
        self._lib.rt_pin_primary(self._h, self._key(object_id))

    def pin_weight(self, object_id: ObjectID) -> bool:
        """Weight-plane pin over the C++ core: implemented as a held reader
        pin (rt_get bumps the pin count the C++ eviction and lru_spillable
        paths already respect), released by unpin_weight."""
        if not self.contains(object_id):
            return False
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rt_get(
            self._h, self._key(object_id), ctypes.byref(off), ctypes.byref(size)
        )
        if rc != 0:
            return False
        self._weight_pins[object_id] = self._weight_pins.get(object_id, 0) + 1
        return True

    def unpin_weight(self, object_id: ObjectID):
        held = self._weight_pins.get(object_id, 0)
        if held <= 0:
            return
        if held == 1:
            self._weight_pins.pop(object_id, None)
        else:
            self._weight_pins[object_id] = held - 1
        self._lib.rt_release(self._h, self._key(object_id))

    def free(self, object_id: ObjectID):
        self._lib.rt_free(self._h, self._key(object_id))
        self._gc_mirrors(object_id)

    def free_if_unpinned(self, object_id: ObjectID):
        """True = freed now, False = pinned, None = wasn't present (a
        concurrent free already removed it — callers spilling must not
        record a spill copy for a vanished object)."""
        rc = self._lib.rt_free_if_unpinned(self._h, self._key(object_id))
        if rc == -2:
            return False
        if rc == -1:
            self._gc_mirrors(object_id)
            return None
        self._gc_mirrors(object_id)
        return True

    def read_local(self, object_id: ObjectID) -> Optional[memoryview]:
        if not self.contains(object_id):
            return None
        off = self._offsets.get(object_id)
        size = self._sizes.get(object_id)
        if off is None or size is None:
            return None
        return memoryview(self._mm)[off : off + size]

    # -- C++ transfer plane (reference role: ObjectManager push/pull) --------

    def transfer_serve(self, token: str = "", host: str = "") -> Optional[int]:
        """Start the native TCP transfer server over this arena; returns the
        bound port (None on failure). ``host`` should be the address the
        raylet control plane serves on (empty = loopback) so the payload
        plane is never reachable more widely than the RPC plane."""
        port = self._lib.rt_transfer_serve(
            self._h, token.encode(), 0, host.encode()
        )
        if port <= 0:
            return None
        self._transfer_port = port
        return port

    def transfer_fetch_raw(
        self, object_id: ObjectID, host: str, port: int, token: str = ""
    ):
        """Pull ``object_id`` from a peer's transfer server straight into
        this arena (blocking — run in a thread). Returns (rc, off, size);
        rc 0 means the bytes are in the arena but NOT yet sealed — call
        ``adopt_fetched`` from the event-loop thread (seal notifies
        asyncio waiters, which is not thread-safe from here)."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rt_transfer_fetch(
            self._h, host.encode(), port, self._key(object_id),
            token.encode(), ctypes.byref(off), ctypes.byref(size),
        )
        return rc, off.value, size.value

    def begin_fetch(self, object_id: ObjectID):
        self._fetching.add(object_id)

    def end_fetch(self, object_id: ObjectID):
        self._fetching.discard(object_id)

    def adopt_fetched(self, object_id: ObjectID, off: int, size: int):
        """Record mirrors + seal for an object rt_transfer_fetch landed."""
        self._offsets[object_id] = off
        self._sizes[object_id] = size
        self._sealed[object_id] = False
        self.seal(object_id)

    def transfer_stop(self):
        port = getattr(self, "_transfer_port", None)
        if port is not None:
            self._lib.rt_transfer_stop(port)
            self._transfer_port = None

    def lru_spillable(self) -> Optional[ObjectID]:
        """Least-recently-used primary copy eligible for spilling."""
        buf = ctypes.create_string_buffer(64)
        if not self._lib.rt_lru_spillable(self._h, buf, 64):
            return None
        hex_id = buf.value.decode()
        for oid in self._offsets:
            if oid.hex() == hex_id:
                return oid
        return None

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "used": int(self._lib.rt_used(self._h)),
            "num_objects": int(self._lib.rt_num_objects(self._h)),
            "native": True,
        }

    def shutdown(self):
        # stop the transfer server BEFORE unmapping: a handler thread
        # streaming from the arena must not outlive the mapping
        self.transfer_stop()
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass
        try:
            os.close(self._fd)
        except OSError:
            pass
        self._lib.rt_store_close(self._h)
        self._sizes.clear()
        self._offsets.clear()
        self._sealed.clear()


#: which store the last ``create_object_store`` made: "native" (the C++
#: arena) or "python" (its fallback); the chip script fails on "python"
store_kind = ""


def create_object_store(capacity_bytes: int, session_id: str):
    """Factory: native C++ arena when the toolchain/lib is available,
    otherwise the pure-python per-segment store."""
    from ..._native.lib import load
    from .store import ObjectStore

    global store_kind
    lib = load()
    if lib is not None:
        try:
            store = NativeObjectStore(capacity_bytes, session_id, lib)
            store_kind = "native"
            return store
        except Exception:
            logger.exception("native store init failed; using python store")
    store_kind = "python"
    return ObjectStore(capacity_bytes, session_id)
