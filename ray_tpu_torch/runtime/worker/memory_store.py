"""In-process memory store for small objects and object-availability futures.

Role-equivalent of the reference's CoreWorkerMemoryStore
(core_worker/store_provider/memory_store/memory_store.h): holds inlined task
results at or below max_direct_call_object_size without a shared-memory round
trip, and provides async futures that ``get`` waits on.

A copy of ``ray_tpu/runtime/worker/memory_store.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..._internal.ids import NodeID, ObjectID


@dataclass
class ObjectEntry:
    # exactly one of (value, error) is set once available; in_plasma means the
    # payload lives in a node object store instead
    value: Optional[bytes] = None
    error: Optional[bytes] = None
    in_plasma: bool = False
    size: int = 0
    # node addresses (raylet RPC addresses) holding a plasma copy
    locations: List[Tuple[str, int]] = field(default_factory=list)
    primary_node: Optional[Tuple[str, int]] = None
    available: asyncio.Event = field(default_factory=asyncio.Event)

    def is_available(self) -> bool:
        return self.available.is_set()


class MemoryStore:
    def __init__(self):
        self._objects: Dict[ObjectID, ObjectEntry] = {}

    def entry(self, object_id: ObjectID) -> ObjectEntry:
        e = self._objects.get(object_id)
        if e is None:
            e = ObjectEntry()
            self._objects[object_id] = e
        return e

    def get_if_exists(self, object_id: ObjectID) -> Optional[ObjectEntry]:
        return self._objects.get(object_id)

    def put_value(self, object_id: ObjectID, value: bytes):
        e = self.entry(object_id)
        e.value = value
        e.size = len(value)
        e.available.set()

    def put_error(self, object_id: ObjectID, error: bytes):
        e = self.entry(object_id)
        e.error = error
        e.available.set()

    def put_plasma(self, object_id: ObjectID, size: int, node_address):
        e = self.entry(object_id)
        e.in_plasma = True
        e.size = size
        if node_address not in e.locations:
            e.locations.append(node_address)
        if e.primary_node is None:
            e.primary_node = node_address
        e.available.set()

    def add_location(self, object_id: ObjectID, node_address):
        e = self.entry(object_id)
        if node_address not in e.locations:
            e.locations.append(node_address)

    def reset_pending(self, object_id: ObjectID):
        """Clear a failed result so a retry can refill it."""
        e = self._objects.get(object_id)
        if e is not None:
            self._objects[object_id] = ObjectEntry()

    async def wait_available(
        self, object_id: ObjectID, timeout: Optional[float] = None
    ) -> Optional[ObjectEntry]:
        e = self.entry(object_id)
        if e.is_available():
            return e
        try:
            await asyncio.wait_for(e.available.wait(), timeout)
        except asyncio.TimeoutError:
            return None
        return self._objects.get(object_id, e)

    def delete(self, object_id: ObjectID) -> Optional[ObjectEntry]:
        return self._objects.pop(object_id, None)

    def __len__(self):
        return len(self._objects)
