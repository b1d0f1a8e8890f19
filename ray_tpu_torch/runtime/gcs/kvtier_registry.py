"""GCS KV-prefix tier registry: the control plane of cluster-wide KV reuse.
A copy of ray_tpu/runtime/gcs/kvtier_registry.py (host code; the port
imports nothing of ray_tpu), which ``kvtier.LocalTierBackend`` runs in
process until the port has a GCS.

Maps prefix-block **fingerprints** (a running hash over full committed KV
blocks, computed replica-side) to **holder entries**: which replica holds
the shipped chunks for that prefix, plus the opaque shipment descriptor the
puller needs to fetch and adopt them. A replica that commits a cacheable
prefix registers it; ANY replica, a fresh scale-up that has computed
nothing included, resolves its prompt's fingerprint chain longest-first
and peer-pulls instead of recomputing.

Protocol invariants:

- One entry covers one longest prefix; every shorter full-block prefix of
  it gets its own fingerprint pointer at the same entry, so resolve is a
  single longest-first lookup walk, not a tree search.
- **Leases** are refcounts with expiry (``kvtier_lease_s``): a puller
  leases the entry before fetching so LRU eviction cannot free the source
  chunks mid-pull; a crashed puller's lease lapses instead of pinning the
  entry forever.
- **Eviction is a notice, not an RPC**: over-capacity LRU eviction (and
  fingerprint takeover by a fresher entry) queues the evicted entry ids on
  a per-holder ``released`` list, drained by the holder's next register /
  collect call, so a notice can never vanish into a reply nobody reads.
  Holder-initiated eviction (the replica's own radix LRU dropped the
  underlying blocks) deregisters immediately via ``evict``.
- Holder-node death sweeps every entry the node held: a dead holder's
  chunks are gone with it, and leaving the pointers up would cost every
  future resolver a reachability probe.

The fingerprint pointers and entry descriptors are mirrored into the GCS
internal KV (``gcs._kv``) under the ``kvtier:`` prefix, as the reference's
``keys.KVTIER`` names them, so the key space stays enumerable.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


def _kvtier_key(*parts) -> str:
    """``kvtier:<part>:...``, the reference's ``keys.KVTIER.key``."""
    return ":".join(("kvtier", *(str(p) for p in parts)))


class _Entry:
    __slots__ = (
        "entry_id", "model", "holder_id", "holder_address", "fps",
        "blob", "nblocks", "wire_bytes", "logical_bytes",
        "leases", "last_used", "created_at",
    )

    def __init__(self, entry_id: int, model: str, holder_id: str,
                 holder_address: Tuple[str, int], fps: List[str],
                 blob: bytes, meta: dict):
        self.entry_id = entry_id
        self.model = model
        self.holder_id = holder_id
        self.holder_address = holder_address
        self.fps = fps  # every full-block prefix fingerprint this covers
        self.blob = blob  # opaque shipment descriptor (client-decoded)
        self.nblocks = int(meta.get("nblocks", len(fps)))
        self.wire_bytes = int(meta.get("wire_bytes", 0))
        self.logical_bytes = int(meta.get("logical_bytes", 0))
        self.leases: Dict[str, float] = {}  # lease_id -> taken-at ts
        self.last_used = time.monotonic()
        self.created_at = time.time()


class GcsKVTierRegistry:
    def __init__(self, gcs: Any):
        self._gcs = gcs
        self._next_id = 1
        self._entries: Dict[int, _Entry] = {}
        # (model, fp) -> entry_id; later registrations take over a
        # fingerprint (fresher holder wins; the old entry keeps serving its
        # other fps until evicted)
        self._fp_index: Dict[Tuple[str, str], int] = {}
        # holder_id -> entry ids evicted out from under it, drained by the
        # holder's next register/collect (weight-plane released contract)
        self._released: Dict[str, List[int]] = {}
        self._stats = {
            "registers": 0, "resolves": 0, "resolve_hits": 0,
            "resolve_misses": 0, "evictions": 0, "lease_conflicts": 0,
            "dead_holder_sweeps": 0,
        }

    # -- KV mirror ---------------------------------------------------------

    def _kv_put(self, key: str, value: bytes):
        self._gcs._kv[key] = value

    def _kv_del(self, key: str):
        self._gcs._kv.pop(key, None)

    def _mirror_entry(self, entry: _Entry):
        self._kv_put(
            _kvtier_key("entry", entry.entry_id),
            json.dumps({
                "model": entry.model,
                "holder_id": entry.holder_id,
                "holder": list(entry.holder_address),
                "nblocks": entry.nblocks,
                "wire_bytes": entry.wire_bytes,
                "logical_bytes": entry.logical_bytes,
                "fps": entry.fps,
            }).encode(),
        )
        for fp in entry.fps:
            if self._fp_index.get((entry.model, fp)) == entry.entry_id:
                self._kv_put(
                    _kvtier_key("fp", entry.model, fp),
                    str(entry.entry_id).encode(),
                )

    def _unmirror_entry(self, entry: _Entry):
        self._kv_del(_kvtier_key("entry", entry.entry_id))
        for fp in entry.fps:
            if self._fp_index.get((entry.model, fp)) is None:
                self._kv_del(_kvtier_key("fp", entry.model, fp))

    # -- register / resolve ------------------------------------------------

    def register(self, model: str, fps: List[str], holder_id: str,
                 holder_address, blob: bytes,
                 meta: Optional[dict] = None) -> dict:
        """Register one prefix entry; returns the assigned entry id plus
        every entry id of THIS holder freed since its last drain."""
        entry = _Entry(
            self._next_id, model, holder_id,
            tuple(holder_address), list(fps), blob, dict(meta or {}),
        )
        self._next_id += 1
        self._entries[entry.entry_id] = entry
        for fp in entry.fps:
            prev = self._fp_index.get((model, fp))
            self._fp_index[(model, fp)] = entry.entry_id
            if prev is not None and prev != entry.entry_id:
                prev_entry = self._entries.get(prev)
                if prev_entry is not None:
                    prev_entry.fps = [f for f in prev_entry.fps if f != fp]
                    if not prev_entry.fps:
                        self._evict_entry(prev_entry, notify=True)
        self._mirror_entry(entry)
        self._stats["registers"] += 1
        self._enforce_capacity()
        return {
            "entry_id": entry.entry_id,
            "released": self._drain_released(holder_id),
        }

    def resolve(self, model: str, fps: List[str]) -> Optional[dict]:
        """Look up candidate fingerprints in the caller's order (send them
        longest-first); the first registered one wins. Returns the entry
        descriptor + holder, or None (recompute)."""
        self._stats["resolves"] += 1
        for i, fp in enumerate(fps):
            entry_id = self._fp_index.get((model, fp))
            if entry_id is None:
                continue
            entry = self._entries.get(entry_id)
            if entry is None:
                continue
            entry.last_used = time.monotonic()
            self._stats["resolve_hits"] += 1
            return {
                "fp": fp,
                "fp_rank": i,
                "entry_id": entry.entry_id,
                "holder_id": entry.holder_id,
                "holder": tuple(entry.holder_address),
                "blob": entry.blob,
            }
        self._stats["resolve_misses"] += 1
        return None

    # -- leases ------------------------------------------------------------

    def lease(self, entry_id: int, lease_id: str) -> bool:
        """Refcount the entry against eviction for the pull's duration;
        False when the entry is already gone (puller recomputes)."""
        entry = self._entries.get(entry_id)
        if entry is None:
            self._stats["lease_conflicts"] += 1
            return False
        entry.leases[lease_id] = time.time()
        return True

    def release(self, entry_id: int, lease_id: str) -> bool:
        entry = self._entries.get(entry_id)
        if entry is None:
            return False
        entry.leases.pop(lease_id, None)
        return True

    def _reap_expired_leases(self, entry: _Entry):
        ttl = getattr(self._gcs.config, "kvtier_lease_s", 60.0)
        if not ttl or ttl <= 0:
            return
        now = time.time()
        for lease_id, ts in list(entry.leases.items()):
            if now - ts > ttl:
                entry.leases.pop(lease_id, None)

    # -- eviction ----------------------------------------------------------

    def evict(self, entry_ids: List[int], holder_id: Optional[str] = None) -> int:
        """Holder-initiated deregistration (its radix LRU dropped the
        underlying blocks, or the replica is shutting down). No notice is
        queued back at the initiator."""
        n = 0
        for entry_id in entry_ids:
            entry = self._entries.get(entry_id)
            if entry is None:
                continue
            if holder_id is not None and entry.holder_id != holder_id:
                continue  # only the holder may deregister its entries
            self._evict_entry(entry, notify=False)
            n += 1
        return n

    def collect(self, holder_id: str) -> dict:
        """Holder-side drain: entry ids evicted out from under this holder
        since the last drain (register also drains)."""
        return {"released": self._drain_released(holder_id)}

    def _drain_released(self, holder_id: str) -> List[int]:
        return self._released.pop(holder_id, [])

    def _evict_entry(self, entry: _Entry, notify: bool):
        self._entries.pop(entry.entry_id, None)
        for fp in entry.fps:
            if self._fp_index.get((entry.model, fp)) == entry.entry_id:
                self._fp_index.pop((entry.model, fp), None)
        self._unmirror_entry(entry)
        self._stats["evictions"] += 1
        if notify:
            self._released.setdefault(entry.holder_id, []).append(
                entry.entry_id
            )
        self._gcs.publisher.publish(
            "kvtier", ("evicted", entry.model, entry.entry_id)
        )

    def _enforce_capacity(self):
        cap = getattr(self._gcs.config, "kvtier_max_entries", 4096)
        if cap <= 0 or len(self._entries) <= cap:
            return
        # oldest-used first; leased entries are skipped (a puller is mid-
        # transfer), so the tier may transiently exceed cap under load
        for entry in sorted(self._entries.values(),
                            key=lambda e: e.last_used):
            if len(self._entries) <= cap:
                break
            self._reap_expired_leases(entry)
            if entry.leases:
                continue
            self._evict_entry(entry, notify=True)

    def on_node_death(self, node_address) -> None:
        """Sweep every entry held on a dead node: its plasma chunks died
        with it, and stale pointers cost every resolver a 2 s probe."""
        node = tuple(node_address)
        dead = [e for e in self._entries.values()
                if tuple(e.holder_address) == node]
        for entry in dead:
            self._evict_entry(entry, notify=False)
        if dead:
            self._stats["dead_holder_sweeps"] += len(dead)
            logger.info(
                "kv tier: swept %d entries of dead holder node %s",
                len(dead), node,
            )

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        per_model: Dict[str, int] = {}
        leased = 0
        wire = logical = 0
        for entry in self._entries.values():
            per_model[entry.model] = per_model.get(entry.model, 0) + 1
            if entry.leases:
                leased += 1
            wire += entry.wire_bytes
            logical += entry.logical_bytes
        return {
            "entries": len(self._entries),
            "fingerprints": len(self._fp_index),
            "leased_entries": leased,
            "pinned_wire_bytes": wire,
            "pinned_logical_bytes": logical,
            "per_model": per_model,
            "pending_notices": sum(len(v) for v in self._released.values()),
            **self._stats,
        }
