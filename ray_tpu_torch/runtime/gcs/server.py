"""Global Control Service.

Role-equivalent of the reference's GCS server (src/ray/gcs/gcs_server.h:98):
one logical process on the head node composing node membership, internal KV,
pubsub, the actor directory/scheduler, the placement-group manager, job
accounting, cluster resource views, and raylet health checking. Every other
component finds the cluster through this service's address.

Storage is pluggable (reference: store_client/): the working set stays in
plain dicts for O(1) serving, with write-through to a ``StoreClient``. With
``gcs_storage_path`` configured the sqlite WAL backend makes actors, PGs,
jobs, and the internal KV survive a GCS restart; raylets re-register when
their resource report lands on a GCS that does not know them (reference:
NotifyGCSRestart, node_manager.proto:426).

A copy of ``ray_tpu/runtime/gcs/server.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own. Its records are pickled with the standard
library, not cloudpickle.
"""

from __future__ import annotations

import asyncio
import json
import logging
import pickle
import time
from typing import Dict, List, Optional, Tuple


from ..._internal.config import Config
from ..._internal.event_loop import BackgroundTasks, PeriodicRunner
from ..._internal.ids import ActorID, JobID, NodeID, PlacementGroupID, WorkerID
from ..._internal.protocol import (
    label_match,
    ActorInfo,
    ActorState,
    NodeInfo,
    PlacementGroupInfo,
    TaskSpec,
)
from ..._internal.rpc import ClientPool, RpcClient, RpcServer
from ...util.events import NODE_SUSPECT, record_event
from . import keys as gcs_keys
from .actor_manager import GcsActorManager
from .placement_groups import GcsPlacementGroupManager
from .pubsub import Publisher
from .store import StoreClient, make_store
from .kvtier_registry import GcsKVTierRegistry
from .timeseries_store import GcsTimeseriesStore
from .weight_registry import GcsWeightRegistry

logger = logging.getLogger(__name__)


class GcsServer:
    def __init__(self, config: Config, storage: Optional[StoreClient] = None):
        self.config = config
        self.server = RpcServer("gcs")
        self.publisher = Publisher()
        self.client_pool = ClientPool("gcs-out")
        self.storage = storage or make_store(config.gcs_storage_path)
        self.actor_manager = GcsActorManager(self)
        self.pg_manager = GcsPlacementGroupManager(self)
        self.weight_registry = GcsWeightRegistry(self)
        self.kvtier_registry = GcsKVTierRegistry(self)
        self.timeseries = GcsTimeseriesStore(self)

        self._nodes: Dict[NodeID, NodeInfo] = {}
        self._node_available: Dict[NodeID, Dict[str, float]] = {}
        self._node_last_seen: Dict[NodeID, float] = {}
        # SUSPECT: reports stopped (age > suspect_after_s) and an active
        # raylet probe ran — between ALIVE and DEAD. Suspect nodes get no
        # new leases and serve replaces their replicas; the state clears on
        # the node's next report. Value: when suspicion started.
        self._node_suspect: Dict[NodeID, float] = {}
        # versioned delta sync (reference: RaySyncer ray_syncer.h:89): the
        # last applied per-raylet report version; a mismatched base on an
        # incoming delta triggers a resync (raylet re-sends a full snapshot)
        self._node_sync_versions: Dict[NodeID, int] = {}
        self._kv: Dict[str, bytes] = {}
        self._jobs: Dict[JobID, dict] = {}
        self._next_job = 1
        # task-event store (reference: GcsTaskManager, gcs_task_manager.h:97):
        # latest state per task, bounded
        self._task_events: Dict[str, dict] = {}
        self._task_events_order: List[str] = []
        self._task_events_cap = 10000
        # span store: finished spans streamed from every traced process so
        # worker spans outlive their process and join the cluster timeline
        # (capped like task events; tracing off -> nothing ever arrives)
        self._spans: List[dict] = []
        self._spans_cap = 50000
        # flight-recorder event store (util/events.py): every process's
        # structured-event ring is streamed here continuously, so the
        # cluster copy survives a SIGKILL of the recording process and
        # `ray_tpu events` can post-mortem a dead replica
        self._events: List[dict] = []
        self._events_cap = 50000
        # store-side truncation counter (the process-local twin is the
        # events_dropped_total metric): how many events this store evicted
        self._events_dropped = 0
        # autoscaler state (reference: GcsAutoscalerStateManager)
        self._node_demands: Dict[NodeID, list] = {}
        self._autoscaling_state: Optional[dict] = None
        self._runner: Optional[PeriodicRunner] = None
        self.address: Optional[Tuple[str, int]] = None
        # Nodes referenced by restored actors/PGs that have not re-registered
        # yet: given one health-check window to come back, then declared dead
        # (their raylets may have died with the previous GCS).
        self._restored_nodes_pending: Dict[NodeID, float] = {}
        # Background scheduling loops (actor/PG placement): tracked so stop()
        # cancels them — a killed-and-restarted GCS must not leave zombie
        # schedulers from the old instance double-creating actors.
        self._bg = BackgroundTasks()
        self._stopped = False

    def spawn(self, coro):
        """ensure_future with lifecycle tracking; no-op after stop()."""
        if self._stopped:
            coro.close()
            return None
        return self._bg.spawn(coro)

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self._restore_state()
        self.server.register_service(self)
        self.server.register("subscribe", self._handle_subscribe)
        self.server.register("subscriber_poll", self._handle_subscriber_poll)
        bound = await self.server.start(host, port)
        self.address = (host, bound)
        self._runner = PeriodicRunner(asyncio.get_event_loop())
        self._runner.run_every(self.config.health_check_period_s, self._health_check)
        logger.info("GCS listening on %s:%s", host, bound)
        return self.address

    async def stop(self):
        self._stopped = True
        self._bg.cancel_all()
        if self._runner:
            self._runner.stop()
        await self.server.stop()
        await self.client_pool.close_all()
        self.storage.close()

    # -- persistence -------------------------------------------------------

    def _restore_state(self):
        """Reload durable tables on startup (reference: the GCS table
        reload path in gcs_server.cc + gcs_init_data.h). With the in-memory
        backend every table is empty and this is a no-op."""
        self._kv = self.storage.get_all("kv")
        for key, raw in self.storage.get_all("jobs").items():
            try:
                self._jobs[JobID.from_hex(key)] = pickle.loads(raw)
            except Exception:
                logger.exception("dropping unreadable job record %s", key)
        raw_next = self.storage.get("meta", "next_job")
        if raw_next is not None:
            self._next_job = int(raw_next)
        restored_nodes = set()
        restored_nodes |= self.actor_manager.restore_from(self.storage)
        restored_nodes |= self.pg_manager.restore_from(self.storage)
        self.weight_registry.restore_from(self.storage)
        self.timeseries.restore_from(self.storage)
        if restored_nodes:
            deadline = time.time() + self.config.health_check_timeout_s
            self._restored_nodes_pending = {
                nid: deadline for nid in restored_nodes
            }
            logger.info(
                "GCS restored state referencing %d node(s); waiting for "
                "re-registration", len(restored_nodes),
            )

    def _persist_job(self, job_id: JobID):
        job = self._jobs.get(job_id)
        if job is not None:
            self.storage.put("jobs", job_id.hex(), pickle.dumps(job))

    # -- helpers -----------------------------------------------------------

    def raylet_client(self, node_id: NodeID) -> RpcClient:
        node = self._nodes[node_id]
        return self.client_pool.get(*node.address)

    def alive_nodes(self) -> Dict[NodeID, NodeInfo]:
        return {nid: n for nid, n in self._nodes.items() if n.alive}

    def node_available(self, node_id: NodeID) -> Dict[str, float]:
        avail = self._node_available.get(node_id)
        if avail is not None:
            return avail
        node = self._nodes.get(node_id)
        return dict(node.resources_total) if node else {}

    async def lease_worker_for_task(self, spec: TaskSpec):
        """Lease a worker for a GCS-scheduled task (actor creation), walking
        the spillback chain (reference: GcsActorScheduler leasing from
        raylets)."""
        nodes = self.alive_nodes()
        # prefer nodes that can fit the request right now
        candidates = sorted(
            nodes,
            key=lambda nid: -sum(
                min(self.node_available(nid).get(k, 0.0), v)
                for k, v in spec.resources.items()
            )
            if spec.resources
            else 0,
        )
        for nid in candidates:
            node = nodes[nid]
            if nid in self._node_suspect and len(candidates) > 1:
                # A partitioned-but-not-yet-dead node must not receive the
                # very replacements its suspicion triggered; with no other
                # candidate it stays eligible (better a suspect lease than
                # an unschedulable actor).
                continue
            feasible = all(
                node.resources_total.get(k, 0.0) >= v - 1e-9
                for k, v in spec.resources.items()
            ) and label_match(node.labels, spec.label_selector)
            if not feasible:
                continue
            raylet = self.raylet_client(nid)
            try:
                reply = await raylet.call("request_worker_lease", spec, timeout=30.0)
            except Exception as e:
                logger.debug("lease from %s failed: %s", nid, e)
                continue
            if reply.get("granted"):
                return (nid, reply["worker_id"], reply["worker_address"], reply["lease_id"],
                        reply.get("instances", {}).get("GPU", []))
            # spillback or rejection: try the next candidate
        return None

    # -- node table --------------------------------------------------------

    async def handle_register_node(
        self, info: NodeInfo, live_worker_ids=None, actor_workers=None
    ):
        self._nodes[info.node_id] = info
        self._node_last_seen[info.node_id] = time.time()
        self._node_suspect.pop(info.node_id, None)
        self._restored_nodes_pending.pop(info.node_id, None)
        self.publisher.publish("node", ("alive", info))
        # Re-registration after a GCS restart: name the actor workers this
        # raylet still runs whose actors have moved on — e.g. the node missed
        # the grace window, its actors restarted elsewhere, and now two
        # incarnations would run side effects. Computed BEFORE reconcile so
        # current records are compared, then vanished workers are failed.
        stale_workers = []
        if actor_workers:
            for worker_id, actor_id in actor_workers.items():
                actor = self.actor_manager.get(actor_id)
                if actor is not None:
                    if (
                        actor.state == ActorState.DEAD
                        or actor.worker_id != worker_id
                    ):
                        stale_workers.append(worker_id)
                elif self.actor_manager.is_tombstoned(actor_id):
                    # terminally dead, record compacted to a tombstone
                    stale_workers.append(worker_id)
                # unknown with no tombstone: a blank (in-memory) GCS restart
                # — judging the worker stale here would SIGKILL every live
                # actor in the cluster on a transient GCS bounce
        self.actor_manager.reconcile_node(info.node_id, live_worker_ids)
        logger.info(
            "node %s registered: %s labels=%s", info.node_id, info.resources_total,
            info.labels,
        )
        return {"ok": True, "stale_workers": stale_workers}

    async def handle_unregister_node(self, node_id: NodeID):
        await self._mark_node_dead(node_id, "drained")
        return True

    async def handle_get_all_nodes(self) -> List[NodeInfo]:
        return list(self._nodes.values())

    async def handle_get_node_states(self) -> Dict[str, str]:
        """Three-valued liveness per node: ALIVE | SUSPECT | DEAD, keyed by
        node-id hex. SUSPECT (reports stopped, probe ran) is what the serve
        controller keys replica replacement on before the full dead window
        elapses."""
        out: Dict[str, str] = {}
        for node_id, node in self._nodes.items():
            if not node.alive:
                out[node_id.hex()] = "DEAD"
            elif node_id in self._node_suspect:
                out[node_id.hex()] = "SUSPECT"
            else:
                out[node_id.hex()] = "ALIVE"
        return out

    async def handle_chaos_fetch(self) -> Optional[bytes]:
        """Raw chaos-mesh spec for pollers (util/chaosnet.py). The method
        name is chaos-EXEMPT in the RPC layer on both sides: clearing a
        partition must propagate through the partition being cleared."""
        return self._kv.get(gcs_keys.CHAOS_NET_SPEC)

    async def handle_report_resources_delta(
        self,
        node_id: NodeID,
        version: int,
        base_version: Optional[int],
        changed: Optional[Dict[str, float]] = None,
        removed: Optional[list] = None,
        demands: Optional[list] = None,
    ):
        """Versioned, delta-suppressed resource view from each raylet (role
        of RaySyncer RESOURCE_VIEW streams, ray_syncer.h:89): steady-state
        reports carry no payload (pure liveness heartbeat); a change ships
        only the touched resource keys against the last acked version;
        ``base_version=None`` is a full snapshot (registration or resync).
        A base mismatch (GCS restart, lost report) returns ``resync`` and
        the raylet re-sends a snapshot. Applied views are re-broadcast to
        subscribed raylets for spillback decisions; ``demands`` carries the
        raylet's queued lease requests for the autoscaler (reference:
        GcsAutoscalerStateManager, gcs_autoscaler_state_manager.h:41)."""
        if node_id not in self._nodes:
            # this GCS restarted and does not know the reporter: tell the
            # raylet to re-register (reference: NotifyGCSRestart /
            # RegisterNodeAgain, node_manager.proto:426)
            return "unknown_node"
        self._node_last_seen[node_id] = time.time()
        if self._node_suspect.pop(node_id, None) is not None:
            logger.info("node %s reporting again; suspicion cleared", node_id)
        if base_version is None:
            # full snapshot
            avail = dict(changed or {})
            self._node_available[node_id] = avail
            self._node_sync_versions[node_id] = version
            if demands is not None:
                self._node_demands[node_id] = demands
            self.publisher.publish("resource_view", (node_id, avail))
            return {"ack": version}
        if self._node_sync_versions.get(node_id) != base_version:
            return {"resync": True}
        if version != base_version:
            self._node_sync_versions[node_id] = version
            if demands is not None:
                self._node_demands[node_id] = demands
            if changed or removed:
                avail = dict(self._node_available.get(node_id, {}))
                for key, value in (changed or {}).items():
                    avail[key] = value
                for key in removed or ():
                    avail.pop(key, None)
                self._node_available[node_id] = avail
                # demands-only deltas feed the autoscaler, not the
                # resource_view fan-out — broadcasting an unchanged
                # availability map per period would re-create the very
                # O(nodes x rate) cost delta sync removes
                self.publisher.publish("resource_view", (node_id, avail))
        return {"ack": version}

    async def handle_get_cluster_resource_state(self) -> dict:
        """Autoscaler view of the cluster (reference:
        GetClusterResourceState RPC, protobuf/autoscaler.proto:187)."""
        nodes = []
        for node_id, info in self._nodes.items():
            nodes.append(
                {
                    "node_id": node_id,
                    "alive": info.alive,
                    "is_head": info.is_head,
                    "resources_total": dict(info.resources_total),
                    "available": dict(self._node_available.get(node_id, {})),
                    "labels": dict(info.labels),
                }
            )
        demands = []
        for node_demands in self._node_demands.values():
            demands.extend(node_demands)
        pending_pgs = [
            {
                "pg_id": info.placement_group_id,
                "strategy": info.strategy,
                "bundles": [dict(b.resources) for b in info.bundles],
            }
            for info in self.pg_manager.pending_infos()
        ]
        return {
            "nodes": nodes,
            "pending_demands": demands,
            "pending_placement_groups": pending_pgs,
        }

    async def handle_report_autoscaling_state(self, state: dict):
        """Autoscaler posts its view for observability (reference:
        ReportAutoscalingState RPC, autoscaler.proto:199)."""
        self._autoscaling_state = state
        return True

    async def handle_get_autoscaling_state(self):
        return self._autoscaling_state

    async def _health_check(self):
        """Mark nodes dead when they stop reporting (reference:
        GcsHealthCheckManager, gcs_health_check_manager.h:45)."""
        now = time.time()
        for node_id, node in list(self._nodes.items()):
            if not node.alive:
                continue
            last = self._node_last_seen.get(node_id, now)
            age = now - last
            if age > self.config.health_check_timeout_s:
                await self._mark_node_dead(node_id, "health check timed out")
            elif (
                age > self.config.suspect_after_s
                and node_id not in self._node_suspect
            ):
                # reports stopped: probe the raylet actively instead of
                # sitting out the rest of the dead window passively
                self._node_suspect[node_id] = now
                self.spawn(self._probe_node(node_id, age))
        # Nodes referenced by restored state that never re-registered: their
        # raylets died with the previous GCS — fail their actors/bundles.
        for node_id, deadline in list(self._restored_nodes_pending.items()):
            if now > deadline and node_id not in self._nodes:
                self._restored_nodes_pending.pop(node_id, None)
                logger.warning(
                    "restored node %s never re-registered; declaring dead",
                    node_id,
                )
                # synthesize the dead broadcast _mark_node_dead would have
                # sent: surviving raylets must drop the node from their
                # cluster views or spillback keeps targeting it. Only the
                # node_id survived the restart, so the stub carries that.
                self.publisher.publish(
                    "node",
                    (
                        "dead",
                        NodeInfo(
                            node_id=node_id,
                            address=("", 0),
                            object_store_address="",
                            resources_total={},
                            alive=False,
                        ),
                    ),
                )
                await self.actor_manager.on_node_death(node_id)
                await self.pg_manager.on_node_death(node_id)
        # telemetry evaluation rides the health cadence so alerts resolve
        # and retention reaps even when no worker is pushing series
        self.timeseries.evaluate(now, force=True)

    async def _probe_node(self, node_id: NodeID, report_age_s: float):
        """Active liveness probe of a node whose reports stopped (reference:
        GcsHealthCheckManager's grpc health checks — ours layers on top of
        the passive report age). Confirms the SUSPECT transition: if a
        report raced in while probing, suspicion clears silently; otherwise
        the node is recorded SUSPECT with the probe verdict (reachable =
        control plane asymmetric, likely a directional partition; not
        reachable = node fully gone, the dead window will catch it)."""
        node = self._nodes.get(node_id)
        if node is None or not node.alive:
            self._node_suspect.pop(node_id, None)
            return
        reachable = False
        try:
            await self.client_pool.get(*node.address).call(
                "ping", timeout=max(self.config.health_check_period_s, 1.0)
            )
            reachable = True
        except Exception:
            pass
        if node_id not in self._node_suspect:
            return  # a report landed while probing
        age = time.time() - self._node_last_seen.get(node_id, 0.0)
        if age <= self.config.suspect_after_s:
            self._node_suspect.pop(node_id, None)
            return
        logger.warning(
            "node %s SUSPECT: no report for %.1fs, raylet %s",
            node_id, age, "reachable" if reachable else "unreachable",
        )
        record_event(
            NODE_SUSPECT,
            node=node_id.hex(),
            report_age_s=round(report_age_s, 3),
            reachable=reachable,
        )
        self.publisher.publish("node", ("suspect", node))

    async def _mark_node_dead(self, node_id: NodeID, reason: str):
        node = self._nodes.get(node_id)
        if node is None or not node.alive:
            return
        node.alive = False
        self._node_suspect.pop(node_id, None)
        self._node_available.pop(node_id, None)
        # invalidate the delta-sync stream: if this raylet was only
        # partitioned and reports again, a base-version match would apply
        # its delta onto the now-empty availability dict and publish a
        # partial view forever — a popped version forces a resync/snapshot
        self._node_sync_versions.pop(node_id, None)
        logger.warning("node %s dead: %s", node_id, reason)
        self._reap_node_metrics(node_id)
        self._abort_member_groups(node_hex=node_id.hex(), reason=reason)
        self.publisher.publish("node", ("dead", node))
        self.weight_registry.on_node_death(node.address)
        self.kvtier_registry.on_node_death(node.address)
        await self.actor_manager.on_node_death(node_id)
        await self.pg_manager.on_node_death(node_id)

    # -- workers -----------------------------------------------------------

    async def handle_report_worker_death(self, worker_id: WorkerID, reason: str):
        # synthetic flight-recorder marker: the dead worker can't dump its
        # own ring (SIGKILL), but its continuously pushed events are already
        # here — this stitches the death cause into the same event stream
        self.append_synthetic_event(
            "worker_death", worker_id=worker_id.hex(), reason=reason
        )
        await self.actor_manager.on_worker_death(worker_id, reason)
        # reap the dead worker's pushed metrics snapshot, or its series
        # would live in every /metrics scrape forever
        self._drop_metrics_key(gcs_keys.METRICS.key(worker_id.hex()))
        # abort any collective group the dead worker was a member of, so
        # surviving ranks blocked in a rendezvous unblock within ~1 s
        # instead of burning the full timeout (covers raylet
        # connection-loss AND memory-monitor recall kills — both land here)
        self._abort_member_groups(worker_hex=worker_id.hex(), reason=reason)
        return True

    def _abort_member_groups(self, *, worker_hex: str = None,
                             node_hex: str = None, reason: str = ""):
        """Scan ``colmember:<group>:<epoch>:<rank>`` registrations and write
        ``colabort:<group>`` (ascii epoch, monotonic max) for every group
        the dead worker/node belonged to. Plain-ascii value on purpose: the
        server writes it without the client serialization module, and any
        client can parse it with int()."""
        for key in [k for k in self._kv
                    if gcs_keys.COLLECTIVE_MEMBER.matches(k)]:
            try:
                payload = json.loads(self._kv[key])
            except Exception:
                continue
            if not isinstance(payload, dict):
                continue
            if worker_hex is not None and payload.get("worker_id") != worker_hex:
                continue
            if node_hex is not None and payload.get("node_id") != node_hex:
                continue
            # group names may themselves contain ':' — epoch and rank are
            # always the last two segments
            parts = gcs_keys.COLLECTIVE_MEMBER.rsplit_tail(key, 2)
            if len(parts) != 3:
                continue
            group, epoch_s, _rank = parts
            try:
                epoch = int(epoch_s)
            except ValueError:
                continue
            abort_key = gcs_keys.COLLECTIVE_ABORT.key(group)
            prev = self._kv.get(abort_key)
            try:
                prev_epoch = int(prev.decode()) if prev is not None else -1
            except (ValueError, UnicodeDecodeError):
                prev_epoch = -1
            if epoch > prev_epoch:
                value = str(epoch).encode()
                self._kv[abort_key] = value
                self.storage.put("kv", abort_key, value)
                logger.warning(
                    "collective group %r epoch %d aborted: member rank %s "
                    "died (%s)", group, epoch, _rank, reason,
                )
            # the registration served its purpose; drop it so a later
            # unrelated death doesn't rescan a dead member
            self._kv.pop(key, None)
            try:
                self.storage.delete("kv", key)
            except Exception:
                pass

    def _drop_metrics_key(self, key: str):
        if self._kv.pop(key, None) is not None:
            try:
                self.storage.delete("kv", key)
            except Exception:
                pass

    def _reap_node_metrics(self, node_id: NodeID):
        """Drop metrics snapshots pushed by workers of a dead node: every
        push is tagged with the pusher's node identity (util/metrics), so a
        node death reaps all of its workers' series at once."""
        want = node_id.hex()
        for key in [k for k in self._kv if gcs_keys.METRICS.matches(k)]:
            try:
                payload = json.loads(self._kv[key])
            except Exception:
                continue
            if isinstance(payload, dict) and payload.get("node_id") == want:
                self._drop_metrics_key(key)

    # -- internal KV (reference: GcsInternalKVManager) ---------------------

    async def handle_kv_put(self, key: str, value: bytes, overwrite: bool = True):
        if not overwrite and key in self._kv:
            return False
        self._kv[key] = value
        self.storage.put("kv", key, value)
        return True

    async def handle_kv_get(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)

    async def handle_kv_multi_get(self, keys: List[str]):
        return {k: self._kv.get(k) for k in keys}

    async def handle_kv_del(self, key: str):
        self.storage.delete("kv", key)
        return self._kv.pop(key, None) is not None

    async def handle_kv_exists(self, key: str):
        return key in self._kv

    async def handle_kv_keys(self, prefix: str = ""):
        return [k for k in self._kv if k.startswith(prefix)]

    # -- pubsub ------------------------------------------------------------

    async def _handle_subscribe(self, subscriber_id: str, channel: str):
        self.publisher.subscribe(subscriber_id, channel)
        return True

    async def _handle_subscriber_poll(self, subscriber_id: str):
        return await self.publisher.poll(subscriber_id, timeout=30.0)

    async def handle_publish(self, channel: str, message):
        self.publisher.publish(channel, message)
        return True

    # -- jobs --------------------------------------------------------------

    # -- task events (reference: TaskEventBuffer -> GcsTaskManager ->
    # state API `ray list tasks`) -----------------------------------------

    _TASK_STATE_RANK = {
        "PENDING": 0,
        "RUNNING": 1,
        "FINISHED": 2,
        "FAILED": 2,
    }

    async def handle_report_task_events(self, events: List[dict]):
        for ev in events:
            tid = ev["task_id"]
            # keep a per-state timestamp so the timeline view can compute
            # durations (reference: per-state ts in GcsTaskManager events
            # feeding `ray timeline` chrome traces)
            if ev.get("state") and "ts" in ev:
                ev = {**ev, f"ts_{ev['state'].lower()}": ev["ts"]}
            cur = self._task_events.get(tid)
            if cur is None:
                self._task_events[tid] = dict(ev)
                self._task_events_order.append(tid)
                if len(self._task_events_order) > self._task_events_cap:
                    drop = self._task_events_order.pop(0)
                    self._task_events.pop(drop, None)
            else:
                # events arrive from different processes on independent
                # flush cadences: never let a late RUNNING (executor) regress
                # a FINISHED/FAILED (owner) state, and never let a stale
                # duplicate flush flip one terminal state into the other —
                # terminal->different-terminal only applies with a newer
                # attempt number
                new_state = ev.get("state")
                if new_state is not None:
                    new_attempt = ev.get("attempt", 0)
                    cur_attempt = cur.get("attempt", 0)
                    if new_attempt < cur_attempt:
                        # an older attempt's event (late flush from a worker
                        # the task was retried away from): its state/node/
                        # worker describe the wrong attempt and must not
                        # overwrite anything — but attempt-invariant fields
                        # the record still lacks (name/type/job_id, carried
                        # only by the owner's PENDING event) are kept
                        for k, v in ev.items():
                            if (
                                k
                                not in (
                                    "state",
                                    "attempt",
                                    "error",
                                    "ts",
                                    "node_id",
                                    "worker_pid",
                                )
                                and k not in cur
                            ):
                                cur[k] = v
                        continue
                    if new_attempt == cur_attempt:
                        new_rank = self._TASK_STATE_RANK.get(new_state, 0)
                        cur_rank = self._TASK_STATE_RANK.get(
                            cur.get("state"), 0
                        )
                        regress = new_rank < cur_rank
                        terminal_flip = (
                            new_rank == 2
                            and cur_rank == 2
                            and new_state != cur.get("state")
                        )
                        if regress or terminal_flip:
                            # same attempt, stale ordering (executor's
                            # RUNNING flush landing after the owner's
                            # terminal event): keep the terminal state but
                            # merge the metadata only the executor knows
                            # (node_id/worker_pid)
                            ev = {
                                k: v
                                for k, v in ev.items()
                                if k
                                not in ("state", "attempt", "error", "ts")
                            }
                    # new_attempt > cur_attempt: newer attempt wins outright
                cur.update(ev)
        return True

    async def handle_list_task_events(
        self, filters: Optional[dict] = None, limit: int = 1000
    ):
        out = []
        for tid in reversed(self._task_events_order):
            ev = self._task_events[tid]
            if filters and any(ev.get(k) != v for k, v in filters.items()):
                continue
            out.append(dict(ev))
            if len(out) >= limit:
                break
        return out

    # -- span store (cluster-wide tracing; see util/tracing.py) ------------

    async def handle_report_spans(self, spans: List[dict]):
        self._spans.extend(spans)
        if len(self._spans) > self._spans_cap:
            del self._spans[: len(self._spans) - self._spans_cap]
        return True

    async def handle_list_spans(self, limit: int = 100000):
        return self._spans[-limit:]

    # -- flight-recorder event store (see util/events.py) ------------------

    def _trim_events(self):
        if len(self._events) > self._events_cap:
            drop = len(self._events) - self._events_cap
            del self._events[:drop]
            self._events_dropped += drop

    def append_synthetic_event(self, name: str, **fields):
        """Server-originated flight-recorder entry (worker deaths, straggler
        verdicts, alert transitions): the source process can't or won't push
        one, so the store stitches it into the same stream itself."""
        ev = {"ts": time.time(), "pid": None, "name": str(name),
              "synthetic": True}
        ev.update(fields)
        self._events.append(ev)
        self._trim_events()

    async def handle_report_events(self, events: List[dict]):
        self._events.extend(events)
        self._trim_events()
        return True

    async def handle_list_events(
        self, limit: int = 1000, name: Optional[str] = None,
        since: Optional[float] = None,
    ):
        events = self._events
        if name is not None:
            events = [e for e in events if e.get("name") == name]
        if since is not None:
            events = [e for e in events if e.get("ts", 0) >= since]
        return events[-limit:]

    async def handle_events_stats(self):
        """Truncation accounting for /api/events: how much history the
        store itself has already forgotten."""
        return {
            "stored": len(self._events),
            "cap": self._events_cap,
            "dropped_total": self._events_dropped,
        }

    # -- telemetry time-series plane (see util/timeseries.py) --------------

    async def handle_ts_push(self, payload: dict) -> int:
        return self.timeseries.push(payload)

    async def handle_ts_query(
        self, name: Optional[str] = None, labels: Optional[dict] = None,
        since: Optional[float] = None, worker_id: Optional[str] = None,
        limit_points: int = 500,
    ):
        return self.timeseries.query(
            name=name, labels=labels, since=since, worker_id=worker_id,
            limit_points=limit_points,
        )

    async def handle_ts_list(self):
        return self.timeseries.list_series()

    async def handle_alerts_snapshot(self):
        return self.timeseries.alerts_snapshot()

    async def handle_alerts_set_rule(self, rule: dict):
        return self.timeseries.set_rule(rule)

    async def handle_alerts_delete_rule(self, name: str) -> bool:
        return self.timeseries.delete_rule(name)

    async def handle_straggler_verdicts(self):
        self.timeseries.evaluate()
        return self.timeseries.straggler_detector.verdicts()

    async def handle_register_job(self, metadata: dict) -> JobID:
        job_id = JobID.from_int(self._next_job)
        self._next_job += 1
        self._jobs[job_id] = {"metadata": metadata, "start_time": time.time()}
        self.storage.put("meta", "next_job", str(self._next_job).encode())
        self._persist_job(job_id)
        self.publisher.publish("job", ("started", job_id))
        return job_id

    async def handle_finish_job(self, job_id: JobID):
        job = self._jobs.get(job_id)
        if job is not None:
            job["end_time"] = time.time()
            self._persist_job(job_id)
        await self.actor_manager.on_job_finished(job_id)
        self.publisher.publish("job", ("finished", job_id))
        return True

    async def handle_list_jobs(self):
        return dict(self._jobs)

    # -- actors ------------------------------------------------------------

    async def handle_register_actor(self, spec: TaskSpec, detached: bool) -> ActorInfo:
        return await self.actor_manager.register_actor(spec, detached)

    async def handle_get_actor(self, actor_id: ActorID) -> Optional[ActorInfo]:
        return self.actor_manager.get(actor_id)

    async def handle_get_actor_by_name(self, name: str, namespace: str):
        return self.actor_manager.get_by_name(name, namespace)

    async def handle_list_actors(self):
        return self.actor_manager.list_actors()

    async def handle_kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        await self.actor_manager.kill_actor(actor_id, no_restart)
        return True

    # -- weight plane (ray_tpu.weights registry) ---------------------------

    async def handle_weights_publish(
        self, name: str, manifest_blob: bytes, meta: Optional[dict] = None
    ):
        return self.weight_registry.publish(name, manifest_blob, meta)

    async def handle_weights_get(self, name: str, version: Optional[int] = None):
        return self.weight_registry.get(name, version)

    async def handle_weights_head(self, name: str):
        return self.weight_registry.head(name)

    async def handle_weights_pin(self, name: str, version: int, reader_id: str):
        return self.weight_registry.pin(name, version, reader_id)

    async def handle_weights_unpin(self, name: str, version: int, reader_id: str):
        return self.weight_registry.unpin(name, version, reader_id)

    async def handle_weights_collect(self, name: str):
        return self.weight_registry.collect(name)

    async def handle_weights_plan(self, name: str, node_address):
        return self.weight_registry.plan(name, node_address)

    async def handle_weights_report_fallback(self, name: str, node_address):
        self.weight_registry.report_fallback(name, node_address)
        return True

    async def handle_weights_list(self):
        return self.weight_registry.list_models()

    # -- KV prefix tier (ray_tpu.kvtier registry) --------------------------

    async def handle_kvtier_register(
        self, model: str, fps: List[str], holder_id: str, holder_address,
        blob: bytes, meta: Optional[dict] = None
    ):
        return self.kvtier_registry.register(
            model, fps, holder_id, holder_address, blob, meta
        )

    async def handle_kvtier_resolve(self, model: str, fps: List[str]):
        return self.kvtier_registry.resolve(model, fps)

    async def handle_kvtier_lease(self, entry_id: int, lease_id: str):
        return self.kvtier_registry.lease(entry_id, lease_id)

    async def handle_kvtier_release(self, entry_id: int, lease_id: str):
        return self.kvtier_registry.release(entry_id, lease_id)

    async def handle_kvtier_evict(
        self, entry_ids: List[int], holder_id: Optional[str] = None
    ):
        return self.kvtier_registry.evict(entry_ids, holder_id)

    async def handle_kvtier_collect(self, holder_id: str):
        return self.kvtier_registry.collect(holder_id)

    async def handle_kvtier_stats(self):
        return self.kvtier_registry.stats()

    # -- placement groups --------------------------------------------------

    async def handle_create_placement_group(self, info: PlacementGroupInfo):
        return await self.pg_manager.create(info)

    async def handle_remove_placement_group(self, pg_id: PlacementGroupID):
        await self.pg_manager.remove(pg_id)
        return True

    async def handle_get_placement_group(self, pg_id: PlacementGroupID):
        return self.pg_manager.get(pg_id)

    async def handle_get_placement_group_by_name(self, name: str):
        return self.pg_manager.get_by_name(name)

    async def handle_pg_wait_ready(self, pg_id: PlacementGroupID, timeout=None):
        return await self.pg_manager.wait_ready(pg_id, timeout)

    async def handle_list_placement_groups(self):
        return self.pg_manager.list_groups()

    # -- cluster info ------------------------------------------------------

    async def handle_cluster_resources(self):
        total: Dict[str, float] = {}
        for node in self.alive_nodes().values():
            for k, v in node.resources_total.items():
                total[k] = total.get(k, 0.0) + v
        return total

    async def handle_cluster_available_resources(self):
        avail: Dict[str, float] = {}
        for nid in self.alive_nodes():
            for k, v in self.node_available(nid).items():
                avail[k] = avail.get(k, 0.0) + v
        return avail
