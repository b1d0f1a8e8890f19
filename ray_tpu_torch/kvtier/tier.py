"""KVTierClient: replica-side access to the cluster KV prefix tier. The port
of ray_tpu/kvtier/tier.py.

Holder side: ``export_and_register`` encodes a committed prefix payload,
stores the chunks through the backend, and registers the fingerprint chain
with the tier registry. The client holds the chunks until the registry's
LRU evicts the entry (the notice is drained on the next register /
collect).

Puller side: ``pull`` resolves a prompt's fingerprint chain longest-first,
leases the winning entry against eviction, fetches the payload from the
holder, and decodes it onto the client's ``device``. The ways a tier can
fail a request degrade to ``None``, which the engine treats as
*recompute*: a resolve miss, a lease conflict, an entry of our own (the
local radix index serves those), and a dead holder (``DeadHolderError``).
Each records its outcome. A tier problem can slow a request but never
fail it.

Unlike the reference, ``pull`` and ``fetch_shipment`` catch only
``DeadHolderError``: the reference also turns every other exception of the
fetch and decode into a recompute, so a fault of the tier's own code (a
corrupt payload, a decode bug) would pass as a slow request. Here it
propagates to the caller.

Backends: :class:`LocalTierBackend`, the reference's clusterless backend:
the registry's real logic (``runtime/gcs/kvtier_registry.py``) in process
over an inline chunk store, with a ``kill_holder`` switch that simulates a
killed peer, so two engines in one process are two replicas in every way
but the byte transport. :class:`GcsTierBackend`, the cluster's: the GCS's
registry and chunks in the object store, pulled from the holder's node.
"""

from __future__ import annotations

import dataclasses
import threading
import types
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .._internal.device import DeviceLike, resolve_device
from .._internal.transfer import DeadHolderError
from ..runtime.gcs.kvtier_registry import GcsKVTierRegistry
from ..util import events as _events
from ..util import metrics as _metrics
from ..weights.manifest import ChunkInfo, chunk_logical_bytes
from .fingerprint import block_fingerprints
from .shipping import DEFAULT_CHUNK_SIZE, KVShipment, decode_payload, encode_payload


@dataclasses.dataclass
class PulledPrefix:
    """Result of a successful peer pull: the decoded payload plus how much
    of OUR prompt it covers. ``exact`` means the shipment covers the whole
    prompt token for token and carries the first sampled token: the
    zero-prefill fast path."""

    shipment: KVShipment
    payload: Any
    matched_blocks: int
    exact: bool


class KVTierClient:
    """One replica's tier client. ``device`` is where pulled and fetched
    payloads are decoded, the engine's device (default: the card)."""

    def __init__(self, model: str, backend, block_size: int,
                 codec: str = "raw",
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 holder_id: Optional[str] = None,
                 device: DeviceLike = None):
        self.model = model
        self.backend = backend
        self.block_size = int(block_size)
        self.codec = codec
        self.chunk_size = chunk_size
        self.holder_id = holder_id or uuid.uuid4().hex[:12]
        self.device = resolve_device(device)
        # tail fingerprint -> entry_id: what this replica already shipped
        # (re-registering an identical prefix would churn the registry)
        self._registered: Dict[str, int] = {}
        self._exports: Dict[int, Any] = {}  # entry_id -> backend handle
        # unregistered directed-handoff exports: a bounded FIFO, so the
        # chunks outlive the prefill->decode fetch without a release call;
        # overflow drops the oldest
        self._direct: List[Any] = []
        self._direct_max = 64

    # -- holder side -------------------------------------------------------

    def should_export(self, token_ids, nblocks: int) -> bool:
        """Cheap pre-check: would export_and_register register anything?
        Lets the engine skip the extraction for prefixes this replica
        already shipped."""
        if nblocks <= 0:
            return False
        fps = block_fingerprints(token_ids, self.block_size)[:nblocks]
        return bool(fps) and fps[-1] not in self._registered

    def _encode(self, token_ids, payload, nblocks: int, first_token: Optional[int]):
        treedef_blob, values, logical, wire = encode_payload(
            payload, self.codec, self.chunk_size
        )
        shipment = KVShipment(
            model=self.model,
            token_ids=[int(t) for t in token_ids],
            block_size=self.block_size,
            nblocks=nblocks,
            codec=self.codec,
            treedef_blob=treedef_blob,
            chunks=[],
            first_token=first_token,
            logical_bytes=logical,
            wire_bytes=wire,
        )
        return shipment, values

    def _register(self, shipment: KVShipment, handle, tail_fp: str) -> None:
        reply = self.backend.register(shipment, self.holder_id)
        entry_id = int(reply["entry_id"])
        self._registered[tail_fp] = entry_id
        self._exports[entry_id] = handle
        _events.record_event(
            _events.KV_SHIPPED,
            model=self.model, entry_id=entry_id,
            nblocks=shipment.nblocks, ntokens=shipment.ntokens,
            codec=self.codec,
            logical_bytes=shipment.logical_bytes,
            wire_bytes=shipment.wire_bytes,
            first_token=shipment.first_token is not None,
        )
        self._drain(reply.get("released") or ())

    def export_and_register(self, token_ids, payload, nblocks: int,
                            first_token: Optional[int] = None) -> Optional[KVShipment]:
        """Ship a committed prefix into the tier; returns the shipment, or
        None when there is nothing to register (no full blocks, or already
        shipped)."""
        if nblocks <= 0:
            return None
        fps = block_fingerprints(token_ids, self.block_size)[:nblocks]
        if not fps or fps[-1] in self._registered:
            return None
        shipment, values = self._encode(token_ids, payload, nblocks, first_token)
        shipment, handle = self.backend.export(shipment, values, self.holder_id)
        self._register(shipment, handle, fps[-1])
        return shipment

    def ship_direct(self, token_ids, payload, nblocks: int,
                    first_token: Optional[int] = None) -> KVShipment:
        """Directed prefill->decode handoff: ALWAYS export (the consumer
        needs this request's tail and first token even when the prefix
        entry exists); register it as a tier entry too when the fingerprint
        chain is new, else park the chunks in the bounded direct FIFO."""
        shipment, values = self._encode(token_ids, payload, nblocks, first_token)
        shipment, handle = self.backend.export(shipment, values, self.holder_id)
        fps = shipment.fingerprints()
        if fps and fps[-1] not in self._registered:
            self._register(shipment, handle, fps[-1])
        else:
            self._direct.append(handle)
            while len(self._direct) > self._direct_max:
                self.backend.drop(self._direct.pop(0))
        return shipment

    def collect(self) -> int:
        """Drain pending eviction notices (register also drains); returns
        the number of entries dropped."""
        reply = self.backend.collect(self.holder_id)
        return self._drain(reply.get("released") or ())

    def _drain(self, released) -> int:
        n = 0
        for entry_id in released:
            handle = self._exports.pop(int(entry_id), None)
            if handle is None:
                continue
            self.backend.drop(handle)
            n += 1
            _events.record_event(
                _events.KVTIER_EVICT,
                model=self.model, entry_id=int(entry_id), holder_id=self.holder_id,
            )
        if n:
            self._registered = {
                fp: eid for fp, eid in self._registered.items() if eid in self._exports
            }
        return n

    def close(self):
        """Deregister and free everything this replica shipped."""
        if self._exports:
            self.backend.evict(list(self._exports), self.holder_id)
            for handle in self._exports.values():
                self.backend.drop(handle)
            self._exports.clear()
            self._registered.clear()
        while self._direct:
            self.backend.drop(self._direct.pop())

    # -- puller side -------------------------------------------------------

    def pull(self, token_ids, min_blocks: int = 0) -> Optional[PulledPrefix]:
        """The local-miss path: resolve -> lease -> fetch -> decode.
        ``min_blocks`` is how many leading blocks the caller's LOCAL index
        already covers: an entry no deeper than that is a local hit, not a
        tier event, so it is skipped without counters or transfer. None ==
        serve locally / recompute (the counters record which)."""
        fps = block_fingerprints(token_ids, self.block_size)
        if not fps:
            return None
        resolved = self.backend.resolve(self.model, list(reversed(fps)))
        if resolved is None:
            _metrics.record_kvtier("recompute")
            return None
        if resolved.get("holder_id") == self.holder_id:
            # our own entry: the local radix index is the fast path for
            # these; a pull through the store would be a pointless copy
            return None
        matched = fps.index(resolved["fp"]) + 1
        if matched <= min_blocks:
            return None  # the local index already covers it
        _metrics.record_kvtier("hit")
        shipment = KVShipment.from_blob(resolved["blob"])
        lease_id = uuid.uuid4().hex[:12]
        entry_id = int(resolved["entry_id"])
        if not self.backend.lease(entry_id, lease_id):
            _metrics.record_kvtier("recompute")
            return None
        try:
            payload = self.backend.fetch_payload(
                shipment, tuple(resolved["holder"]), self.device
            )
        except DeadHolderError:
            _metrics.record_kvtier("recompute")
            return None
        finally:
            self.backend.release_lease(entry_id, lease_id)
        _metrics.record_kvtier("peer_pull")
        _metrics.record_kvtier_transfer(shipment.logical_bytes, shipment.wire_bytes)
        prompt = [int(t) for t in token_ids]
        exact = (
            matched == len(fps)
            and shipment.first_token is not None
            and shipment.ntokens == len(prompt)
            and list(shipment.token_ids) == prompt
        )
        return PulledPrefix(shipment=shipment, payload=payload,
                            matched_blocks=matched, exact=exact)

    def fetch_shipment(self, shipment: KVShipment) -> Optional[Any]:
        """Directed handoff (ingress prefill->decode): fetch a known
        shipment's payload from its holder, decoded onto ``device``. None
        == recompute: a dead holder, or a shipment of another model key
        (K/V of other weights, as a hot reload leaves mid-rollout)."""
        if shipment.model != self.model:
            _metrics.record_kvtier("recompute")
            return None
        try:
            payload = self.backend.fetch_payload(
                shipment, self.backend.holder_of(shipment), self.device
            )
        except DeadHolderError:
            _metrics.record_kvtier("recompute")
            return None
        _metrics.record_kvtier("peer_pull")
        _metrics.record_kvtier_transfer(shipment.logical_bytes, shipment.wire_bytes)
        return payload

    def stats(self) -> dict:
        return {
            "holder_id": self.holder_id,
            "exported_entries": len(self._exports),
            "registry": self.backend.stats(),
        }


# -- backends ----------------------------------------------------------------


class GcsTierBackend:
    """The cluster backend: GCS registry calls, and chunks in the object
    store through the shared transfer layer (``_internal/transfer.py``).
    It runs in a process of an initialized runtime (a replica, a driver):
    built anywhere else it raises, where the reference's fails at its first
    call.

    Its calls block on the core worker's event loop, so they are made from
    a thread that is not that loop (a replica's request thread is one).
    ``fetch_payload`` first probes the process that exported the chunks
    (their owner), then pulls with ``require_source=True``: a dead owner, a
    holder node that fails its reachability probe or no longer holds a
    chunk raises :class:`DeadHolderError`, which the client counts as a
    recompute. The reference probes the holder's node alone, and reads a
    copy of a dead owner's chunks that an earlier pull left in the
    reader's store."""

    def __init__(self):
        from .. import _worker_api

        if not _worker_api.is_initialized():
            raise RuntimeError(
                "GcsTierBackend needs the runtime: call ray_tpu_torch.init() "
                "first (or pass tier_backend=kvtier.LocalTierBackend() to share a "
                "tier between servers in one process)"
            )

    @staticmethod
    def _worker():
        from .. import _worker_api

        return _worker_api.get_core_worker()

    def _call(self, method: str, *args):
        from .. import _worker_api

        worker = self._worker()
        return _worker_api.run_on_worker_loop(
            worker.client_pool.get(*worker.gcs_address).call(method, *args)
        )

    def export(self, shipment: KVShipment, chunk_values: List[list],
               holder_id: str) -> Tuple[KVShipment, Any]:
        from .. import _worker_api
        from .._internal import transfer
        from ..object_ref import ObjectRef

        worker = self._worker()
        stored = _worker_api.run_on_worker_loop(
            transfer.put_chunks(worker, chunk_values, pin=True))
        infos, refs, oids = [], [], []
        for value, (oid, size) in zip(chunk_values, stored):
            refs.append(ObjectRef(oid, worker.address))
            oids.append(oid)
            infos.append(ChunkInfo(
                object_id=oid,
                owner_address=tuple(worker.address),
                size=size,
                num_leaves=len(value),
                codec=shipment.codec,
                logical_size=chunk_logical_bytes(value),
            ))
        shipment.chunks = infos
        return shipment, (refs, oids)

    def register(self, shipment: KVShipment, holder_id: str) -> dict:
        worker = self._worker()
        return self._call(
            "kvtier_register", shipment.model, shipment.fingerprints(),
            holder_id, tuple(worker.raylet_address), shipment.to_blob(),
            {
                "nblocks": shipment.nblocks,
                "wire_bytes": shipment.wire_bytes,
                "logical_bytes": shipment.logical_bytes,
            },
        )

    def resolve(self, model: str, fps: List[str]) -> Optional[dict]:
        return self._call("kvtier_resolve", model, fps)

    def lease(self, entry_id: int, lease_id: str) -> bool:
        return bool(self._call("kvtier_lease", entry_id, lease_id))

    def release_lease(self, entry_id: int, lease_id: str) -> None:
        self._call("kvtier_release", entry_id, lease_id)

    def evict(self, entry_ids: List[int], holder_id: str) -> None:
        self._call("kvtier_evict", list(entry_ids), holder_id)

    def collect(self, holder_id: str) -> dict:
        return self._call("kvtier_collect", holder_id)

    def fetch_payload(self, shipment: KVShipment, holder,
                      device: DeviceLike = None) -> Any:
        """The shipment's payload from ``holder`` (its raylet's address),
        decoded onto ``device``; DeadHolderError when the holder is gone."""
        import asyncio

        from .. import _worker_api
        from .._internal import transfer

        worker = self._worker()

        async def _fetch():
            # the exporting process owns the chunks: once it is gone its
            # registry entries are stale and its chunks lost, even where a
            # pulled copy survives in a store. A call, not a connect probe: a
            # cached connection to a dead process still looks connected
            owners = {tuple(c.owner_address): c.object_id for c in shipment.chunks}
            for owner, oid in owners.items():
                try:
                    await worker.client_pool.get(*owner).call(
                        "get_object_locations", oid, timeout=transfer.HOLDER_PROBE_S)
                except Exception as e:  # noqa: BLE001 - any failure: the owner is gone
                    raise DeadHolderError(f"the holder process {owner} is gone: {e}") from e
            return list(await asyncio.gather(*[
                transfer.fetch_chunk(worker, chunk, tuple(holder),
                                     probe_source=True, require_source=True)
                for chunk in shipment.chunks
            ]))

        values = _worker_api.run_on_worker_loop(_fetch())
        return decode_payload(shipment.treedef_blob, values, device)

    def holder_of(self, shipment: KVShipment):
        """The exporting worker's address (the chunks' owner): its node
        serves the pull."""
        return tuple(shipment.chunks[0].owner_address) if shipment.chunks else None

    def drop(self, handle) -> None:
        from .. import _worker_api
        from .._internal import transfer

        refs, oids = handle
        worker = _worker_api.maybe_get_core_worker()
        if worker is not None:
            _worker_api.run_on_worker_loop(transfer.unpin_chunks(worker, oids))
        refs.clear()  # dropping the refs is the free

    def stats(self) -> dict:
        return self._call("kvtier_stats")


class _LocalGcsShim:
    """Just enough of a GCS server for GcsKVTierRegistry to run in process."""

    class _NullPublisher:
        def publish(self, *_a, **_k):
            pass

    def __init__(self, max_entries: int, lease_s: float):
        self._kv: Dict[str, bytes] = {}
        self.config = types.SimpleNamespace(
            kvtier_max_entries=max_entries, kvtier_lease_s=lease_s
        )
        self.publisher = self._NullPublisher()


class LocalTierBackend:
    """Clusterless backend: the real registry logic and an inline chunk
    store (the encoded host tensors themselves). Shared by every engine in
    one process, so two in-process "replicas" run the register / resolve /
    lease / evict protocol the cluster runs; only the byte transport is
    inline."""

    def __init__(self, max_entries: int = 4096, lease_s: float = 60.0):
        self._lock = threading.Lock()
        self.registry = GcsKVTierRegistry(_LocalGcsShim(max_entries, lease_s))
        self._store: Dict[bytes, list] = {}  # oid -> chunk leaf values
        self._chunk_holder: Dict[bytes, str] = {}
        self._dead: set = set()  # holder_ids "killed" by kill_holder

    def kill_holder(self, holder_id: str) -> None:
        """Simulate a killed holder: its chunks vanish, its registry entries
        remain (stale, the state a real kill leaves until the death sweep
        runs), so pulls take the dead-holder path."""
        with self._lock:
            self._dead.add(holder_id)
            for oid, hid in list(self._chunk_holder.items()):
                if hid == holder_id:
                    self._store.pop(oid, None)

    def export(self, shipment: KVShipment, chunk_values: List[list],
               holder_id: str) -> Tuple[KVShipment, Any]:
        infos, oids = [], []
        with self._lock:
            for value in chunk_values:
                oid = uuid.uuid4().bytes[:8]
                self._store[oid] = value
                self._chunk_holder[oid] = holder_id
                oids.append(oid)
                infos.append(ChunkInfo(
                    object_id=oid,
                    owner_address=("local", 0),
                    size=chunk_logical_bytes(value),
                    num_leaves=len(value),
                    codec=shipment.codec,
                    logical_size=chunk_logical_bytes(value),
                ))
        shipment.chunks = infos
        return shipment, oids

    def register(self, shipment: KVShipment, holder_id: str) -> dict:
        with self._lock:
            return self.registry.register(
                shipment.model, shipment.fingerprints(), holder_id,
                ("local", 0), shipment.to_blob(),
                {
                    "nblocks": shipment.nblocks,
                    "wire_bytes": shipment.wire_bytes,
                    "logical_bytes": shipment.logical_bytes,
                },
            )

    def resolve(self, model: str, fps: List[str]) -> Optional[dict]:
        with self._lock:
            return self.registry.resolve(model, fps)

    def lease(self, entry_id: int, lease_id: str) -> bool:
        with self._lock:
            return self.registry.lease(entry_id, lease_id)

    def release_lease(self, entry_id: int, lease_id: str) -> None:
        with self._lock:
            self.registry.release(entry_id, lease_id)

    def evict(self, entry_ids: List[int], holder_id: str) -> None:
        with self._lock:
            self.registry.evict(list(entry_ids), holder_id)

    def collect(self, holder_id: str) -> dict:
        with self._lock:
            return self.registry.collect(holder_id)

    def fetch_payload(self, shipment: KVShipment, holder,
                      device: DeviceLike = None) -> Any:
        """The shipment's payload, decoded onto ``device``; DeadHolderError
        when a chunk's holder is gone."""
        with self._lock:
            values = []
            for chunk in shipment.chunks:
                hid = self._chunk_holder.get(chunk.object_id)
                if hid in self._dead or chunk.object_id not in self._store:
                    raise DeadHolderError(f"holder of chunk {chunk.object_id!r} is gone")
                values.append(self._store[chunk.object_id])
        return decode_payload(shipment.treedef_blob, values, device)

    def holder_of(self, shipment: KVShipment):
        return ("local", 0)

    def drop(self, handle) -> None:
        with self._lock:
            for oid in handle:
                self._store.pop(oid, None)
                self._chunk_holder.pop(oid, None)

    def stats(self) -> dict:
        with self._lock:
            return self.registry.stats()
