"""GCS weight registry: the control plane of the weight plane.

Durable directory of named models with monotonically versioned manifests
(role analogue of the actor directory, but for model state): publishers
register a new manifest per publish and get back the assigned version;
subscribers resolve head (or a pinned version), take version pins that
block garbage collection, and receive broadcast-tree positions so chunk
pulls fan out node-to-node instead of hammering the publisher.

GC mirrors the actor-tombstone compaction pattern (actor_manager.py
_mark_dead): a superseded version with no pinned readers is compacted to a
tombstone — manifest deleted from storage, a tiny marker written instead —
and queued on a per-model ``released`` list. Only the PUBLISHER drains
``released`` (through its publish reply or an explicit weights_collect):
subscriber unpins trigger GC but never consume the queue, so a release
produced by a late unpin is delivered on the publisher's next
publish/collect instead of vanishing into a reply nobody reads.
Head versions are never GC'd.

Pins are leases, not permanent marks: a pin older than
``weights_pin_lease_s`` is reaped during GC, so a crashed reader (whose
restart pins under a fresh reader_id) cannot block tombstoning forever.
Live subscribers refresh their pins as a heartbeat (weights_pin is
idempotent and re-timestamps). Pins are NOT persisted: after a GCS restart
superseded versions survive until the next publish/unpin/collect cycle
re-judges them, so readers that re-pin promptly keep their version.

A copy of ``ray_tpu/runtime/gcs/weight_registry.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Set, Tuple, TYPE_CHECKING

if TYPE_CHECKING:
    from .server import GcsServer
    from .store import StoreClient

logger = logging.getLogger(__name__)


class _Model:
    __slots__ = (
        "name", "head", "versions", "meta", "pins", "released",
        "tombstones", "subscriber_nodes", "fallback_reports",
    )

    def __init__(self, name: str):
        self.name = name
        self.head: int = 0  # 0 = nothing published yet
        # version -> opaque manifest blob (serialized client-side; the
        # registry never decodes it, so manifest evolution is client-only)
        self.versions: Dict[int, bytes] = {}
        # version -> {"total_bytes": int, "num_chunks": int, "ts": float}
        self.meta: Dict[int, dict] = {}
        # version -> reader_id -> pin timestamp (a lease: reaped when older
        # than weights_pin_lease_s; re-pinning refreshes it)
        self.pins: Dict[int, Dict[str, float]] = {}
        # tombstoned versions whose chunks the publisher may free, drained
        # ONLY by the publisher (publish reply / weights_collect)
        self.released: List[int] = []
        self.tombstones: Set[int] = set()
        # broadcast-tree membership: raylet addresses in first-subscribe
        # order; a node's index is its stable tree position. Pruned on node
        # death and on repeated child fallback reports.
        self.subscriber_nodes: List[Tuple[str, int]] = []
        # node -> count of children that gave up waiting on it as a parent
        self.fallback_reports: Dict[Tuple[str, int], int] = {}


def _tree_parent(position: int) -> Optional[int]:
    """Binomial broadcast tree over subscriber positions: position 0 seeds
    from the publisher; every other position's parent clears its highest
    set bit (children of 0 are 1, 2, 4, 8, ...)."""
    if position <= 0:
        return None
    return position - (1 << (position.bit_length() - 1))


def _tree_depth(num_nodes: int) -> int:
    """Hops from the publisher to the deepest subscriber node: 1 for the
    seed plus the longest clear-highest-bit chain, i.e. the max popcount of
    any position < num_nodes — which is ``num_nodes.bit_length()`` total."""
    if num_nodes <= 0:
        return 0
    return num_nodes.bit_length()


class GcsWeightRegistry:
    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        self._models: Dict[str, _Model] = {}

    # -- persistence -------------------------------------------------------

    def _persist_version(self, model: _Model, version: int):
        try:
            self._gcs.storage.put(
                "weights", f"{model.name}:{version}", model.versions[version]
            )
            self._gcs.storage.put(
                "weights_meta",
                model.name,
                str(model.head).encode(),
            )
        except Exception:
            logger.exception(
                "failed to persist weights %s:%d", model.name, version
            )

    def restore_from(self, storage: "StoreClient"):
        """Reload manifests + heads after a GCS restart: the head version of
        every model stays resolvable; superseded-but-unGC'd versions come
        back resident and are re-judged on the next publish/unpin."""
        for key in storage.get_all("weight_tombstones"):
            name, _, v = key.rpartition(":")
            model = self._models.setdefault(name, _Model(name))
            try:
                model.tombstones.add(int(v))
            except ValueError:
                logger.exception("dropping unreadable weight tombstone %s", key)
        for key, raw in storage.get_all("weights").items():
            name, _, v = key.rpartition(":")
            try:
                version = int(v)
            except ValueError:
                logger.exception("dropping unreadable weight record %s", key)
                continue
            model = self._models.setdefault(name, _Model(name))
            model.versions[version] = raw
            model.head = max(model.head, version)
        for name, raw in storage.get_all("weights_meta").items():
            model = self._models.setdefault(name, _Model(name))
            try:
                model.head = max(model.head, int(raw))
            except ValueError:
                pass
        if self._models:
            logger.info(
                "restored %d weight model(s): %s",
                len(self._models),
                {m.name: m.head for m in self._models.values()},
            )

    # -- publish / resolve -------------------------------------------------

    def publish(
        self, name: str, manifest_blob: bytes, meta: Optional[dict] = None
    ) -> dict:
        """Register a new version; returns the assigned version, every
        version whose chunks the publisher may now free, and the live set
        (so the publisher can reconcile refs held for versions the registry
        no longer lists — e.g. released-lists lost with a GCS restart)."""
        model = self._models.setdefault(name, _Model(name))
        model.head += 1
        version = model.head
        model.versions[version] = manifest_blob
        model.meta[version] = {**(meta or {}), "ts": time.time()}
        self._persist_version(model, version)
        self._gc_superseded(model)
        self._gcs.publisher.publish("weights", ("published", name, version))
        return {
            "version": version,
            "released": self._drain_released(model),
            "live": sorted(model.versions),
        }

    def get(self, name: str, version: Optional[int] = None) -> Optional[dict]:
        model = self._models.get(name)
        if model is None or model.head == 0:
            return None
        v = model.head if version is None else version
        blob = model.versions.get(v)
        if blob is None:
            return None
        return {"version": v, "manifest": blob, "head": model.head}

    def head(self, name: str) -> Optional[int]:
        model = self._models.get(name)
        return model.head if model is not None and model.head else None

    # -- pins + GC ---------------------------------------------------------

    def pin(self, name: str, version: int, reader_id: str) -> bool:
        model = self._models.get(name)
        if model is None or version not in model.versions:
            return False
        model.pins.setdefault(version, {})[reader_id] = time.time()
        return True

    def unpin(self, name: str, version: int, reader_id: str) -> bool:
        """Drop one reader's pin and re-judge GC. Deliberately does NOT
        drain ``released``: the caller is a subscriber, and a release
        drained into a reply the subscriber ignores is lost forever — the
        publisher would hold the version's chunk refs (and their store
        weight-pins) for the rest of the run. Tombstoned versions stay
        queued for the publisher's next publish/collect drain."""
        model = self._models.get(name)
        if model is None:
            return False
        readers = model.pins.get(version)
        if readers is not None:
            readers.pop(reader_id, None)
            if not readers:
                model.pins.pop(version, None)
        self._gc_superseded(model)
        return True

    def collect(self, name: str) -> dict:
        """Publisher-side GC poll: versions safe to free now, plus the set
        still live (a publisher also drops refs for anything it holds that
        the registry no longer lists — covers released-lists lost with a
        GCS restart). Runs a GC pass first so expired pin leases are reaped
        even when no publish/unpin has happened since they lapsed."""
        model = self._models.get(name)
        if model is None:
            return {"released": [], "live": []}
        self._gc_superseded(model)
        return {
            "released": self._drain_released(model),
            "live": sorted(model.versions),
        }

    def _reap_expired_pins(self, model: _Model):
        """Expire pin leases older than weights_pin_lease_s: a crashed or
        partitioned reader must not block tombstoning forever (its restart
        pins under a fresh reader_id, so its old pin is unreachable). Live
        readers refresh their leases via pin() heartbeats."""
        lease = getattr(self._gcs.config, "weights_pin_lease_s", 0.0)
        if not lease or lease <= 0:
            return
        now = time.time()
        for version, readers in list(model.pins.items()):
            expired = [r for r, ts in readers.items() if now - ts > lease]
            for reader_id in expired:
                readers.pop(reader_id, None)
                logger.warning(
                    "weights %s v%d: reaping expired pin lease of reader %s",
                    model.name, version, reader_id,
                )
            if not readers:
                model.pins.pop(version, None)

    def _gc_superseded(self, model: _Model):
        self._reap_expired_pins(model)
        for version in sorted(model.versions):
            if version >= model.head:
                continue  # head is never GC'd
            if model.pins.get(version):
                continue  # pinned readers block the tombstone
            model.versions.pop(version, None)
            model.meta.pop(version, None)
            model.tombstones.add(version)
            model.released.append(version)
            try:
                self._gcs.storage.delete("weights", f"{model.name}:{version}")
                self._gcs.storage.put(
                    "weight_tombstones", f"{model.name}:{version}", b"1"
                )
            except Exception:
                logger.exception(
                    "failed to compact weights %s:%d", model.name, version
                )
            self._gcs.publisher.publish(
                "weights", ("tombstoned", model.name, version)
            )

    def _drain_released(self, model: _Model) -> List[int]:
        released, model.released = model.released, []
        return released

    # -- broadcast-tree planning ------------------------------------------

    def plan(self, name: str, node_address) -> dict:
        """Assign (or look up) a node's position in the model's binomial
        broadcast tree. Parent ``None`` means "pull from the publisher" —
        only the seed (position 0) does, which is what makes publisher
        upload volume O(1) in subscriber-node count."""
        model = self._models.setdefault(name, _Model(name))
        node = tuple(node_address)
        try:
            position = model.subscriber_nodes.index(node)
        except ValueError:
            position = len(model.subscriber_nodes)
            model.subscriber_nodes.append(node)
        parent_pos = _tree_parent(position)
        depth = _tree_depth(len(model.subscriber_nodes))
        return {
            "position": position,
            "parent": (
                model.subscriber_nodes[parent_pos]
                if parent_pos is not None
                else None
            ),
            "num_nodes": len(model.subscriber_nodes),
            "depth": depth,
        }

    def on_node_death(self, node_address) -> None:
        """Drop a dead node from every model's broadcast tree so children
        stop burning weights_prefer_wait_s per chunk on an unreachable
        parent, and subscriber_nodes stays bounded under autoscaling churn.
        Positions are recomputed from list order on each plan() call, so
        removal reparents affected children on their next fetch."""
        node = tuple(node_address)
        for model in self._models.values():
            self._prune_node(model, node)

    def report_fallback(self, name: str, node_address) -> None:
        """A child reports that it gave up waiting on ``node_address`` as
        its broadcast parent (unreachable, or never produced a chunk within
        the wait budget). Health checks catch dead *nodes*; this catches
        hung-but-connectable ones. Two independent reports prune the node —
        a live node that was merely slow simply re-subscribes and is
        re-appended at a fresh position on its next plan()."""
        model = self._models.get(name)
        if model is None:
            return
        node = tuple(node_address)
        if node not in model.subscriber_nodes:
            return
        count = model.fallback_reports.get(node, 0) + 1
        if count >= 2:
            self._prune_node(model, node)
        else:
            model.fallback_reports[node] = count

    def _prune_node(self, model: _Model, node: Tuple[str, int]):
        if node in model.subscriber_nodes:
            model.subscriber_nodes.remove(node)
            logger.info(
                "weights %s: pruned node %s from broadcast tree (%d left)",
                model.name, node, len(model.subscriber_nodes),
            )
        model.fallback_reports.pop(node, None)

    # -- introspection (state API / CLI) -----------------------------------

    def list_models(self) -> List[dict]:
        out = []
        for model in self._models.values():
            if model.head == 0:
                continue
            head_meta = model.meta.get(model.head, {})
            out.append(
                {
                    "name": model.name,
                    "head": model.head,
                    "versions": sorted(model.versions),
                    "pinned": {
                        v: sorted(readers)
                        for v, readers in model.pins.items()
                        if readers
                    },
                    "tombstoned": len(model.tombstones),
                    "subscriber_nodes": len(model.subscriber_nodes),
                    "tree_depth": _tree_depth(len(model.subscriber_nodes)),
                    "total_bytes": head_meta.get("total_bytes"),
                    "num_chunks": head_meta.get("num_chunks"),
                    # chunk codec + encoded size of the head version: how
                    # `ray_tpu list weights` shows whether a model rides
                    # the wire compressed (wire < total => int8 codec)
                    "codec": head_meta.get("codec", "raw"),
                    "wire_bytes": head_meta.get("wire_bytes"),
                }
            )
        return out
