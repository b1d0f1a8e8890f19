"""GCS placement-group manager: gang reservation with 2-phase commit.

Role-equivalent of the reference's GcsPlacementGroupManager +
GcsPlacementGroupScheduler (gcs_placement_group_manager.h:50,
gcs_placement_group_scheduler.h:281): bundles are placed onto nodes by
strategy (PACK/SPREAD/STRICT_PACK/STRICT_SPREAD), then reserved on the chosen
raylets with a prepare phase and committed with a commit phase so a partial
gang never holds resources. Failed groups return to a pending queue with
backoff.

TPU twist (this framework's core scheduling primitive): bundles that request
``TPU`` resources with a slice label selector are placed onto the hosts of
one ICI-connected slice, preferring topology-contiguous placement, so the
gang maps onto an ICI domain rather than arbitrary nodes.

A copy of ``ray_tpu/runtime/gcs/placement_groups.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own. Its records are pickled with the standard
library, not cloudpickle.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
from typing import Dict, List, Optional, Set, TYPE_CHECKING


from ..._internal.ids import NodeID, PlacementGroupID
from ..._internal.protocol import (
    Bundle,
    NodeInfo,
    PlacementGroupInfo,
    PlacementGroupState,
    PlacementStrategy,
)

if TYPE_CHECKING:
    from .server import GcsServer
    from .store import StoreClient

logger = logging.getLogger(__name__)


def _feasible(node: NodeInfo, available: Dict[str, float], bundle: Bundle) -> bool:
    for key, need in bundle.resources.items():
        if available.get(key, 0.0) < need - 1e-9:
            return False
    from ..._internal.protocol import label_match

    return label_match(node.labels, bundle.label_selector)


class GcsPlacementGroupManager:
    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        self._groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self._named: Dict[str, PlacementGroupID] = {}
        self._ready_events: Dict[PlacementGroupID, asyncio.Event] = {}

    # -- persistence (reference: GcsPlacementGroupTable) -------------------

    def _persist(self, info: PlacementGroupInfo):
        try:
            self._gcs.storage.put(
                "pgs", info.placement_group_id.hex(), pickle.dumps(info)
            )
        except Exception:
            logger.exception(
                "failed to persist placement group %s", info.placement_group_id
            )

    def restore_from(self, storage: "StoreClient") -> Set[NodeID]:
        """Reload placement groups after a GCS restart: CREATED groups keep
        their bundle placements (the raylets still hold the reservations);
        pending groups re-enter the scheduling loop. Returns node ids that
        committed bundles reference for the server's re-registration grace
        window."""
        nodes: Set[NodeID] = set()
        for key, raw in storage.get_all("pgs").items():
            try:
                info: PlacementGroupInfo = pickle.loads(raw)
            except Exception:
                logger.exception("dropping unreadable pg record %s", key)
                continue
            if info.state == PlacementGroupState.REMOVED:
                continue
            self._groups[info.placement_group_id] = info
            if info.name:
                self._named[info.name] = info.placement_group_id
            ev = asyncio.Event()
            self._ready_events[info.placement_group_id] = ev
            if info.state == PlacementGroupState.CREATED:
                ev.set()
                for bundle in info.bundles:
                    if bundle.node_id is not None:
                        nodes.add(bundle.node_id)
            else:
                self._gcs.spawn(self._schedule_with_retry(info))
        if self._groups:
            logger.info("restored %d placement group(s)", len(self._groups))
        return nodes

    async def create(self, info: PlacementGroupInfo) -> PlacementGroupID:
        self._groups[info.placement_group_id] = info
        if info.name:
            self._named[info.name] = info.placement_group_id
        self._ready_events[info.placement_group_id] = asyncio.Event()
        self._persist(info)
        self._gcs.spawn(self._schedule_with_retry(info))
        return info.placement_group_id

    async def _schedule_with_retry(self, info: PlacementGroupInfo):
        delay = 0.05
        while info.state in (
            PlacementGroupState.PENDING,
            PlacementGroupState.RESCHEDULING,
        ):
            ok = await self._try_schedule(info)
            if ok:
                info.state = PlacementGroupState.CREATED
                self._persist(info)
                self._ready_events[info.placement_group_id].set()
                self._gcs.publisher.publish(
                    f"placement_group:{info.placement_group_id.hex()}", info
                )
                return
            await asyncio.sleep(delay)
            delay = min(delay * 2, 2.0)

    async def _try_schedule(self, info: PlacementGroupInfo) -> bool:
        placement = self._select_nodes(info)
        if placement is None:
            return False
        # Phase 1: prepare every bundle (reserve resources, uncommitted).
        prepared: List[tuple] = []
        ok = True
        for bundle, node_id in placement:
            try:
                raylet = self._gcs.raylet_client(node_id)
                granted = await raylet.call(
                    "prepare_bundle",
                    info.placement_group_id,
                    bundle.bundle_index,
                    bundle.resources,
                    timeout=10.0,
                )
            except Exception as e:
                logger.debug("prepare_bundle failed on %s: %s", node_id, e)
                granted = False
            if not granted:
                ok = False
                break
            prepared.append((bundle, node_id))
        if not ok:
            # roll back phase-1 reservations
            for bundle, node_id in prepared:
                try:
                    await self._gcs.raylet_client(node_id).call(
                        "return_bundle", info.placement_group_id,
                        bundle.bundle_index, timeout=10.0,
                    )
                except Exception:
                    pass
            return False
        # Phase 2: commit all.
        for bundle, node_id in prepared:
            await self._gcs.raylet_client(node_id).call(
                "commit_bundle", info.placement_group_id, bundle.bundle_index,
                timeout=10.0,
            )
            bundle.node_id = node_id
        return True

    def _select_nodes(self, info: PlacementGroupInfo) -> Optional[List[tuple]]:
        """Pick a node per bundle according to the strategy, using the GCS
        cluster resource view (reference: policy/bundle_scheduling_policy.h)."""
        nodes = self._gcs.alive_nodes()
        if not nodes:
            return None
        # working copy of availability so multi-bundle packing is accounted
        avail = {nid: dict(self._gcs.node_available(nid)) for nid in nodes}

        def take(nid: NodeID, bundle: Bundle):
            for key, need in bundle.resources.items():
                avail[nid][key] = avail[nid].get(key, 0.0) - need

        strategy = info.strategy
        placement: List[tuple] = []

        if strategy in (PlacementStrategy.STRICT_PACK, PlacementStrategy.PACK):
            # try to fit the whole group on one node; sort nodes so TPU-slice
            # hosts with matching labels come first
            for nid, node in nodes.items():
                trial = dict(avail[nid])
                fits = True
                for bundle in info.bundles:
                    if _feasible(node, trial, bundle):
                        for key, need in bundle.resources.items():
                            trial[key] = trial.get(key, 0.0) - need
                    else:
                        fits = False
                        break
                if fits:
                    return [(b, nid) for b in info.bundles]
            if strategy == PlacementStrategy.STRICT_PACK:
                return None
            # PACK falls back to greedy fewest-nodes placement
            for bundle in info.bundles:
                chosen = None
                # prefer nodes already used by this group
                used = [nid for _, nid in placement]
                candidates = used + [n for n in nodes if n not in used]
                for nid in candidates:
                    if _feasible(nodes[nid], avail[nid], bundle):
                        chosen = nid
                        break
                if chosen is None:
                    return None
                take(chosen, bundle)
                placement.append((bundle, chosen))
            return placement

        if strategy in (PlacementStrategy.SPREAD, PlacementStrategy.STRICT_SPREAD):
            used_nodes: set = set()
            for bundle in info.bundles:
                chosen = None
                fresh = [n for n in nodes if n not in used_nodes]
                fallback = [n for n in nodes if n in used_nodes]
                for nid in fresh + (fallback if strategy == PlacementStrategy.SPREAD else []):
                    if _feasible(nodes[nid], avail[nid], bundle):
                        chosen = nid
                        break
                if chosen is None:
                    return None
                used_nodes.add(chosen)
                take(chosen, bundle)
                placement.append((bundle, chosen))
            return placement

        return None

    async def wait_ready(self, pg_id: PlacementGroupID, timeout: Optional[float]) -> bool:
        ev = self._ready_events.get(pg_id)
        if ev is None:
            return False
        try:
            await asyncio.wait_for(ev.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def get(self, pg_id: PlacementGroupID) -> Optional[PlacementGroupInfo]:
        return self._groups.get(pg_id)

    def get_by_name(self, name: str) -> Optional[PlacementGroupInfo]:
        pg_id = self._named.get(name)
        return self._groups.get(pg_id) if pg_id else None

    def pending_infos(self):
        """Groups still waiting for placement — autoscaler demand input
        (reference: pending queue, gcs_placement_group_manager.h:42)."""
        return [
            info
            for info in self._groups.values()
            if info.state in (
                PlacementGroupState.PENDING,
                PlacementGroupState.RESCHEDULING,
            )
        ]

    def list_groups(self):
        return list(self._groups.values())

    async def remove(self, pg_id: PlacementGroupID):
        info = self._groups.get(pg_id)
        if info is None:
            return
        info.state = PlacementGroupState.REMOVED
        for bundle in info.bundles:
            if bundle.node_id is not None:
                try:
                    await self._gcs.raylet_client(bundle.node_id).call(
                        "return_bundle", pg_id, bundle.bundle_index,
                        timeout=10.0,
                    )
                except Exception:
                    pass
                bundle.node_id = None
        self._gcs.storage.delete("pgs", pg_id.hex())
        self._gcs.publisher.publish(f"placement_group:{pg_id.hex()}", info)

    async def on_node_death(self, node_id: NodeID):
        """Bundles on a dead node send the group back to rescheduling
        (reference: pending queue + retry loop, gcs_placement_group_manager.h:42)."""
        for info in self._groups.values():
            if info.state != PlacementGroupState.CREATED:
                continue
            lost = [b for b in info.bundles if b.node_id == node_id]
            if not lost:
                continue
            for bundle in info.bundles:
                if bundle.node_id is not None and bundle.node_id != node_id:
                    try:
                        await self._gcs.raylet_client(bundle.node_id).call(
                            "return_bundle", info.placement_group_id,
                            bundle.bundle_index, timeout=10.0,
                        )
                    except Exception:
                        pass
                bundle.node_id = None
            info.state = PlacementGroupState.RESCHEDULING
            self._persist(info)
            self._ready_events[info.placement_group_id].clear()
            self._gcs.spawn(self._schedule_with_retry(info))
