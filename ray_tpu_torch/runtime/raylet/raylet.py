"""Raylet: the per-node daemon.

Role-equivalent of the reference's NodeManager (src/ray/raylet/node_manager.h:133)
plus the embedded object store and the two-level scheduler:

- worker-lease protocol: owners request a leased worker for a task; the raylet
  grants locally, queues, or replies with a spillback target chosen from its
  cluster resource view (reference: ClusterLeaseManager/LocalLeaseManager +
  hybrid_scheduling_policy.h)
- placement-group bundle prepare/commit/return (2-phase commit participant,
  reference: HandlePrepareBundleResources node_manager.h:584)
- node-local shared-memory object store service + node-to-node chunked object
  pulls (reference: ObjectManager/PullManager, object_manager.h:128)
- worker pool management and worker-death detection via connection loss
  (reference: HandleClientConnectionError node_manager.h:332)
- periodic resource-view reports to the GCS (role of RaySyncer)

A copy of ``ray_tpu/runtime/raylet/raylet.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own. A task demanding a device no node has gets
an ``unschedulable`` reply (the port has no autoscaler to wait for).
"""

from __future__ import annotations

import asyncio
import itertools
import os
import logging
import tempfile
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

from ..._internal.config import Config
from ..._internal.event_loop import BackgroundTasks, PeriodicRunner
from ..._internal.ids import NodeID, ObjectID, PlacementGroupID, UniqueID, WorkerID
from ..._internal.protocol import (
    label_match,
    NodeInfo,
    PlacementGroupSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
    SpreadSchedulingStrategy,
    TaskSpec,
)
from ..._internal.rpc import ClientPool, RpcServer, retry_call
from ...exceptions import NodeFencedError, ObjectStoreFullError
from ...util import chaosnet
from ...util.events import NODE_FENCED, NODE_UNFENCED, record_event
from ..gcs.pubsub import SubscriberClient
from ..object_store import spill_storage
from ..object_store.native_store import create_object_store
from .memory_monitor import (
    GroupByOwnerWorkerKillingPolicy,
    KillCandidate,
    MemoryMonitor,
    RetriableLIFOWorkerKillingPolicy,
)
from .resources import Allocation, LocalResourceManager, unschedulable_devices
from .worker_pool import WorkerHandle, WorkerPool

logger = logging.getLogger(__name__)

# Per-location connect bound for object pulls: long enough for a loaded
# peer to accept a TCP connection, short enough that a dead holder does
# not stall the get (the caller falls through to the next holder or to
# lineage reconstruction).
_PULL_CONNECT_PROBE_S = 2.0


class Lease:
    __slots__ = (
        "lease_id", "worker", "allocation", "spec", "granted_at",
        "reusable", "renewed_at",
    )

    def __init__(self, lease_id, worker: WorkerHandle, allocation: Allocation,
                 spec, reusable: bool = False):
        self.lease_id = lease_id
        self.worker = worker
        self.allocation = allocation
        self.spec = spec
        self.granted_at = time.time()
        # owner may cache this lease and reuse it across tasks; the raylet
        # can recall it with a revoke_lease RPC to the owner (TTL accounting
        # below; reference: worker lease reuse + lease reclamation)
        self.reusable = reusable
        self.renewed_at = self.granted_at


class Raylet:
    def __init__(
        self,
        config: Config,
        gcs_address: Tuple[str, int],
        resources: Dict[str, float],
        labels: Dict[str, str],
        session_id: str,
        is_head: bool = False,
        object_store_memory: Optional[int] = None,
    ):
        self.config = config
        self.node_id = NodeID.from_random()
        self.gcs_address = gcs_address
        self.session_id = session_id
        self.is_head = is_head
        self.server = RpcServer(f"raylet-{self.node_id.hex()[:6]}")
        # chaos_src tags every outgoing call with this node's identity so
        # directional partition rules (src=<node-hex>) can match
        self.client_pool = ClientPool(
            "raylet-out", chaos_src=self.node_id.hex()
        )
        self.resources = LocalResourceManager(resources, labels)
        self.store = create_object_store(
            object_store_memory or config.object_store_memory,
            f"{session_id}_{self.node_id.hex()[:6]}",
        )
        self.worker_pool: Optional[WorkerPool] = None
        self.address: Optional[Tuple[str, int]] = None

        self._leases: Dict[UniqueID, Lease] = {}
        # spilled primary copies: object id -> file path (reference: N14)
        self._spilled: Dict[ObjectID, str] = {}
        # owner-freed objects still pinned by zero-copy readers: freed for
        # real when the last reader releases (see handle_free_objects)
        self._deferred_frees: set = set()
        # unmet demands for the autoscaler: task_id -> (resources, selector, ts)
        self._infeasible_demands: Dict[TaskID, tuple] = {}
        self._restore_locks: Dict[ObjectID, asyncio.Lock] = {}
        # background spill deletions: the loop keeps only weak task refs,
        # so untracked fire-and-forget tasks can be GC'd mid-flight
        self._bg = BackgroundTasks()
        self._restore_lock_holds: Dict[ObjectID, int] = {}
        self._lease_seq = itertools.count()
        # scheduling-class FIFO queues of pending lease requests
        # (reference: scheduling classes, scheduling_class_util.h)
        self._queues: Dict[tuple, deque] = defaultdict(deque)
        self._dispatch_wakeup = asyncio.Event()
        self._dispatch_task: Optional[asyncio.Task] = None
        # cluster view for spillback: node_id -> NodeInfo / availability
        self._cluster_nodes: Dict[NodeID, NodeInfo] = {}
        self._cluster_available: Dict[NodeID, Dict[str, float]] = {}
        self._subscriber: Optional[SubscriberClient] = None
        self._runner: Optional[PeriodicRunner] = None
        # versioned delta sync state (reference: ray_syncer.h:89)
        self._sync_version = 0
        self._acked_avail: Optional[Dict[str, float]] = None
        self._acked_demands: Optional[list] = None
        self._needs_full_sync = True
        self._stopped = False
        # OOM defense (reference: MemoryMonitor + WorkerKillingPolicy)
        self.memory_monitor = MemoryMonitor(config.memory_usage_threshold)
        self._kill_policy = (
            RetriableLIFOWorkerKillingPolicy()
            if config.worker_killing_policy == "retriable_lifo"
            else GroupByOwnerWorkerKillingPolicy()
        )
        self._oom_kills = 0
        self._last_oom_kill_ts = 0.0
        # native transfer plane counters (observability + tests)
        self._native_pulls = 0
        # chunk-serve accounting for the weight-plane broadcast proofs:
        # object -> number of complete python-path transfers served FROM this
        # node (counted at offset 0), plus total payload bytes out. The O(1)
        # publisher-upload test reads these via the transfer_stats RPC.
        self._fetch_serves: Dict[ObjectID, int] = {}
        self._fetch_bytes_out = 0
        self._transfer_port: Optional[int] = None
        # peer address -> (port or None, probe-expiry timestamp)
        self._peer_transfer_ports: Dict[tuple, tuple] = {}
        self._pull_locks: Dict[ObjectID, asyncio.Lock] = {}
        self._pull_lock_holds: Dict[ObjectID, int] = {}
        # worker pid -> hex job id of its most recent lease (log attribution)
        self._worker_job: Dict[int, str] = {}
        # lease ids with a revoke_lease RPC in flight to their owner
        self._revoking: set = set()
        # split-brain fencing: set when GCS contact is lost past
        # fence_after_s — new leases are refused (NodeFencedError) and
        # resident workers are told to fence; cleared on the next
        # successful report
        self._fenced = False
        self._last_gcs_ok = time.time()

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self.server.register_service(self)
        self.server.on_connection_lost(self._on_connection_lost)
        bound = await self.server.start(host, port)
        self.address = (host, bound)
        self._loop = asyncio.get_event_loop()
        # session log dir (reference: per-session /tmp/ray/session_*/logs)
        import tempfile

        self.log_dir = os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch",
            f"session_{self.session_id}", "logs",
        )
        os.makedirs(self.log_dir, exist_ok=True)
        # native transfer plane: serve this arena over TCP so peers pull
        # bulk bytes via the C++ path instead of chunked python RPC
        if hasattr(self.store, "transfer_serve"):
            self._transfer_port = self.store.transfer_serve(
                self.config.cluster_auth_token, host=host
            )
        # the auth token ships to workers via env, NOT the --config argv JSON
        # (argv is world-readable through /proc/<pid>/cmdline). The key is
        # OMITTED — an empty value would overwrite the env-provided token in
        # the worker's Config.from_json.
        import json as _json

        cfg_dict = _json.loads(self.config.to_json())
        cfg_dict.pop("cluster_auth_token", None)
        self.worker_pool = WorkerPool(
            self.node_id,
            lambda: self.address[1],
            self.gcs_address,
            self.session_id,
            self.config.max_workers_per_node,
            _json.dumps(cfg_dict),
            auth_token=self.config.cluster_auth_token,
            log_dir=self.log_dir,
            log_sink=self._worker_log_sink,
        )
        gcs = self.client_pool.get(*self.gcs_address)
        info = self._node_info()
        await retry_call(gcs, "register_node", info, attempts=3, timeout=10.0)
        self._last_gcs_ok = time.time()
        self._cluster_nodes[self.node_id] = info
        # cluster view subscription
        self._subscriber = SubscriberClient(
            self.client_pool.get(*self.gcs_address), f"raylet-{self.node_id.hex()}"
        )
        await self._subscriber.subscribe("node", self._on_node_event)
        await self._subscriber.subscribe("resource_view", self._on_resource_view)
        # periodic resource reports double as liveness heartbeats
        self._runner = PeriodicRunner(asyncio.get_event_loop())
        self._runner.run_every(
            max(self.config.health_check_period_s / 2, 0.1), self._report_resources
        )
        if self.config.chaos_poll_period_s > 0:
            self._runner.run_every(
                self.config.chaos_poll_period_s, self._poll_chaos
            )
        self._runner.run_every(5.0, self._reap_idle_workers)
        if self.config.lease_ttl_s > 0:
            self._runner.run_every(
                max(self.config.lease_ttl_s / 2, 1.0), self._check_lease_ttls
            )
        if self.config.memory_monitor_refresh_s > 0:
            self._runner.run_every(
                self.config.memory_monitor_refresh_s, self._check_memory
            )
        self._dispatch_task = asyncio.ensure_future(self._dispatch_loop())
        if self.config.prestart_workers:
            self.worker_pool.prestart(self.config.prestart_workers)
        logger.info("raylet %s on %s", self.node_id, self.address)
        return self.address

    async def stop(self):
        self._stopped = True
        if self._runner:
            self._runner.stop()
        if self._subscriber:
            await self._subscriber.close()
        if self._dispatch_task:
            self._dispatch_task.cancel()
        if self.worker_pool:
            self.worker_pool.shutdown()
        self.store.shutdown()
        await self.server.stop()
        await self.client_pool.close_all()

    async def _report_resources(self):
        """Versioned delta report (reference: RaySyncer ray_syncer.h:89):
        steady state sends an empty heartbeat against the acked version;
        changes send only the touched keys; registration/resync sends a full
        snapshot. The GCS acks the applied version — O(changes), not
        O(nodes x report rate), on the wire and in GCS work."""
        avail = self.resources.available_float()
        demands = self._pending_demands()
        gcs = self.client_pool.get(*self.gcs_address)
        if self._needs_full_sync or self._acked_avail is None:
            self._sync_version += 1
            payload = dict(
                version=self._sync_version, base_version=None,
                changed=avail, demands=demands,
            )
        else:
            changed = {
                k: v for k, v in avail.items()
                if self._acked_avail.get(k) != v
            }
            removed = [k for k in self._acked_avail if k not in avail]
            demands_changed = demands != self._acked_demands
            base = self._sync_version
            if changed or removed or demands_changed:
                self._sync_version += 1
            payload = dict(
                version=self._sync_version, base_version=base,
                changed=changed or None, removed=removed or None,
                demands=demands if demands_changed else None,
            )
        try:
            reply = await gcs.call(
                "report_resources_delta", self.node_id, timeout=5.0, **payload
            )
        except Exception:
            since_ok = time.time() - self._last_gcs_ok
            if (
                not self._fenced
                and self.config.fence_after_s > 0
                and since_ok > self.config.fence_after_s
            ):
                self._set_fenced(
                    True,
                    f"no successful GCS report for {since_ok:.1f}s",
                )
            return
        self._last_gcs_ok = time.time()
        if self._fenced:
            self._set_fenced(False, "")
        if reply == "unknown_node":
            # the GCS restarted and lost the node table: re-register,
            # reporting which workers are still alive so restored actor
            # records can be reconciled (reference: raylet reconnect on
            # NotifyGCSRestart, node_manager.proto:426)
            self._needs_full_sync = True
            await self._reregister_with_gcs()
            return
        if isinstance(reply, dict) and reply.get("resync"):
            self._needs_full_sync = True
            return
        self._needs_full_sync = False
        self._acked_avail = avail
        self._acked_demands = demands

    def _set_fenced(self, fenced: bool, reason: str):
        """Flip the split-brain fence. Fenced raylets refuse new leases and
        tell their resident workers to fence (replica admission and
        collective ticks read the worker-local flag); the GCS may already be
        restarting this node's actors elsewhere, so running new work here
        risks two live incarnations."""
        self._fenced = fenced
        if fenced:
            logger.warning("node %s FENCED: %s", self.node_id, reason)
            record_event(
                NODE_FENCED, node=self.node_id.hex(), reason=reason
            )
        else:
            logger.warning(
                "node %s unfenced: GCS contact restored", self.node_id
            )
            record_event(NODE_UNFENCED, node=self.node_id.hex())
        self._bg.spawn(self._notify_workers_fenced(fenced, reason))

    async def _notify_workers_fenced(self, fenced: bool, reason: str):
        if self.worker_pool is None:
            return
        for handle in list(self.worker_pool._registered.values()):
            try:
                worker = self.client_pool.get(*handle.address)
                await worker.call_oneway(
                    "set_fenced", fenced, self.node_id.hex(), reason
                )
            except Exception:
                pass  # best-effort; the worker may be mid-death

    async def _poll_chaos(self):
        """Pick up the cluster-wide chaos-mesh spec from the GCS KV. The
        fetch rides the chaos-EXEMPT chaos_fetch RPC so clearing a partition
        propagates through the partition it clears."""
        await chaosnet.poll_once(self.client_pool.get(*self.gcs_address))

    def _node_info(self) -> NodeInfo:
        return NodeInfo(
            node_id=self.node_id,
            address=self.address,
            object_store_address=self.store.session_id,
            resources_total=self.resources.total_float(),
            labels=dict(self.resources.labels),
            is_head=self.is_head,
        )

    async def _reregister_with_gcs(self):
        logger.warning(
            "GCS does not know node %s (restart?); re-registering", self.node_id
        )
        gcs = self.client_pool.get(*self.gcs_address)
        live_workers = (
            list(self.worker_pool._registered.keys())
            if self.worker_pool is not None
            else []
        )
        # which live workers host which actors: the restarted GCS reconciles
        # these against its restored directory and names the stale ones —
        # e.g. this node missed the re-registration grace window and its
        # actors were already restarted elsewhere; the old incarnations must
        # not keep running side effects
        actor_workers = {
            lease.worker.worker_id: lease.spec.actor_id
            for lease in self._leases.values()
            if getattr(lease.spec, "actor_id", None) is not None
        }
        try:
            reply = await retry_call(
                gcs, "register_node", self._node_info(), live_workers,
                actor_workers, attempts=3, timeout=10.0,
            )
        except Exception:
            logger.exception("re-registration with GCS failed; will retry")
            return
        stale = reply.get("stale_workers") if isinstance(reply, dict) else None
        for worker_id in stale or []:
            handle = (
                self.worker_pool._registered.get(worker_id)
                if self.worker_pool is not None
                else None
            )
            if handle is not None:
                logger.warning(
                    "killing stale actor worker %s (pid %s): its actor moved "
                    "on while this node was out of contact", worker_id,
                    handle.pid,
                )
                try:
                    os.kill(handle.pid, 9)
                except ProcessLookupError:
                    pass

    def _pending_demands(self) -> List[dict]:
        """Aggregate queued lease requests into resource-demand buckets for
        the autoscaler (reference: SchedulerResourceReporter feeding
        GcsAutoscalerStateManager's cluster resource state)."""
        buckets: Dict[tuple, dict] = {}

        def add(resources, selector):
            key = (
                tuple(sorted(resources.items())),
                tuple(sorted((selector or {}).items())),
            )
            entry = buckets.get(key)
            if entry is None:
                buckets[key] = entry = {
                    "resources": dict(resources),
                    "label_selector": dict(selector or {}),
                    "count": 0,
                }
            entry["count"] += 1

        for queue in self._queues.values():
            for spec, fut, _reusable in queue:
                if not fut.done():
                    add(spec.resources, spec.label_selector)
        now = time.time()
        for task_id, (resources, selector, ts) in list(
            self._infeasible_demands.items()
        ):
            if now - ts > 5.0:  # owner stopped retrying (done or gone)
                del self._infeasible_demands[task_id]
                continue
            add(resources, selector)
        return list(buckets.values())

    def _reap_idle_workers(self):
        self.worker_pool.reap_idle(
            keep=self.config.prestart_workers,
            idle_kill_s=self.config.idle_worker_kill_s,
        )

    # -- cluster view ------------------------------------------------------

    async def _check_memory(self):
        """OOM defense tick (reference: NodeManager memory-monitor callback
        + WorkerKillingPolicy): above the usage threshold, kill the leased
        worker the policy picks; the owner sees a worker crash and retries
        if the task is retriable."""
        if not self._leases or not self.memory_monitor.is_over_threshold():
            return
        # cooldown: reclaim after SIGKILL lags behind the next tick, and
        # back-to-back kills would drain the node before pressure clears
        # (reference: kill-in-progress gating in the memory-monitor callback)
        now = time.time()
        if now - self._last_oom_kill_ts < self.config.oom_kill_cooldown_s:
            return
        candidates = []
        for lease in self._leases.values():
            spec = lease.spec
            retriable = (
                spec.max_restarts != 0
                if spec.actor_id is not None
                else spec.max_retries > 0
            )
            candidates.append(
                KillCandidate(
                    lease_id=lease.lease_id,
                    worker_id=lease.worker.worker_id,
                    pid=lease.worker.pid,
                    owner_id=spec.owner_worker_id,
                    retriable=retriable,
                    started_at=lease.granted_at,
                )
            )
        victim = self._kill_policy.select(candidates)
        if victim is None:
            return
        used, total = self.memory_monitor.usage()
        self._oom_kills += 1
        self._last_oom_kill_ts = now
        logger.warning(
            "memory pressure (%.0f/%.0f MB): killing worker %s (pid %s, "
            "retriable=%s) to reclaim memory",
            used / 1e6, total / 1e6, victim.worker_id, victim.pid,
            victim.retriable,
        )
        handle = self.worker_pool.on_worker_dead(victim.worker_id)
        try:
            os.kill(victim.pid, 9)
        except ProcessLookupError:
            pass
        # free the lease now — the kill is deliberate, no need to wait for
        # the connection-loss callback (which becomes a no-op: the handle is
        # already deregistered)
        for lease_id, lease in list(self._leases.items()):
            if lease.worker.worker_id == victim.worker_id:
                self.resources.release(lease.allocation)
                del self._leases[lease_id]
                if lease.reusable:
                    # tell the owner its cached lease is gone so the cache
                    # drops it now instead of on the next failed push
                    try:
                        owner = self.client_pool.get(*lease.spec.owner_address)
                        self._bg.spawn(
                            owner.call_oneway("revoke_lease", lease_id)
                        )
                    except Exception:
                        pass
        self._dispatch_wakeup.set()
        if handle is not None:
            try:
                gcs = self.client_pool.get(*self.gcs_address)
                await gcs.call(
                    "report_worker_death",
                    victim.worker_id,
                    f"killed by memory monitor: node memory {used}/{total} "
                    f"exceeded threshold "
                    f"{self.memory_monitor.usage_threshold:.2f}",
                    timeout=5.0,
                )
            except Exception:
                pass

    def _on_node_event(self, channel, message):
        kind, info = message
        if kind == "alive":
            self._cluster_nodes[info.node_id] = info
        elif kind == "dead":
            self._cluster_nodes.pop(info.node_id, None)
            self._cluster_available.pop(info.node_id, None)
        # "suspect" keeps the node in the view: it may still recover, and
        # evicting it here would orphan its entry forever (no re-"alive"
        # publish follows a cleared suspicion)

    def _on_resource_view(self, channel, message):
        node_id, available = message
        self._cluster_available[node_id] = available
        self._dispatch_wakeup.set()  # infeasible tasks may now be spillable

    # -- worker registration / death --------------------------------------

    async def handle_register_worker(
        self, worker_id: WorkerID, address: Tuple[str, int], pid: int,
        env_key: str = ""
    ):
        self.worker_pool.on_worker_registered(worker_id, address, pid, env_key)
        return {"node_id": self.node_id, "store_session": self.store.session_id}

    async def _on_connection_lost(self, peer_meta):
        worker_id = peer_meta.get("worker_id")
        if worker_id is None:
            return
        handle = self.worker_pool.on_worker_dead(worker_id)
        if handle is None:
            return
        logger.warning("worker %s (pid %s) died", worker_id, handle.pid)
        # free any leases held by the dead worker
        for lease_id, lease in list(self._leases.items()):
            if lease.worker.worker_id == worker_id:
                self.resources.release(lease.allocation)
                del self._leases[lease_id]
                if lease.reusable:
                    # drop the owner's cached copy promptly (it would also
                    # self-heal on the next failed push)
                    try:
                        owner = self.client_pool.get(*lease.spec.owner_address)
                        self._bg.spawn(
                            owner.call_oneway("revoke_lease", lease_id)
                        )
                    except Exception:
                        pass
        self._dispatch_wakeup.set()
        try:
            gcs = self.client_pool.get(*self.gcs_address)
            await gcs.call(
                "report_worker_death", worker_id, "connection lost",
                timeout=5.0,
            )
        except Exception:
            pass

    # -- lease protocol ----------------------------------------------------

    async def handle_request_worker_lease(self, spec: TaskSpec,
                                          reusable: bool = False):
        """Grant a worker locally, queue, or spill to another node.
        ``reusable`` marks the grant as cacheable by the owner (lease reuse);
        the raylet may recall it later via revoke_lease."""
        if self._fenced:
            # split-brain guard: the GCS may be restarting this node's work
            # elsewhere — granting here could produce two live incarnations
            raise NodeFencedError(self.node_id.hex(), "raylet lost GCS contact")
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._queues[spec.scheduling_class()].append((spec, fut, reusable))
        self._dispatch_wakeup.set()
        return await fut

    async def handle_return_worker(self, lease_id, worker_failed: bool = False):
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return False
        self.resources.release(lease.allocation)
        if not worker_failed:
            self.worker_pool.push(lease.worker)
        self._dispatch_wakeup.set()
        return True

    # -- lease revocation (the raylet side of lease reuse: TTL accounting +
    # recall of owner-cached leases under resource pressure) ---------------

    def _maybe_revoke_idle_lease(self, lease: Optional[Lease] = None):
        """Fire one revoke_lease RPC at the owner of a reusable lease
        (oldest first when unspecified). The owner releases the lease if it
        is idle in its cache — its return_worker then frees the resources
        and wakes dispatch — or answers False (in use), which renews the
        lease's TTL clock."""
        if lease is None:
            candidates = [
                l for l in self._leases.values()
                if l.reusable and l.lease_id not in self._revoking
            ]
            if not candidates:
                return
            lease = min(candidates, key=lambda l: l.renewed_at)
        elif lease.lease_id in self._revoking:
            return
        self._revoking.add(lease.lease_id)
        self._bg.spawn(self._revoke_lease(lease))

    async def _revoke_lease(self, lease: Lease):
        try:
            owner = self.client_pool.get(*lease.spec.owner_address)
            released = await owner.call(
                "revoke_lease", lease.lease_id, timeout=5.0
            )
            if released:
                return  # owner's return_worker does the cleanup
            # in use: the owner is actively reusing it — renew the clock
            live = self._leases.get(lease.lease_id)
            if live is not None:
                live.renewed_at = time.time()
        except Exception:
            # owner unreachable (crashed / shut down): force-reclaim so a
            # dead owner can never pin a worker and its resources forever
            live = self._leases.pop(lease.lease_id, None)
            if live is not None:
                logger.warning(
                    "force-reclaiming lease %s from unreachable owner %s",
                    live.lease_id, live.spec.owner_address,
                )
                self.resources.release(live.allocation)
                self.worker_pool.push(live.worker)
                self._dispatch_wakeup.set()
        finally:
            self._revoking.discard(lease.lease_id)

    async def _check_lease_ttls(self):
        """Periodic TTL backstop: probe reusable leases older than
        lease_ttl_s. Owners actively reusing a lease answer the probe with
        "busy", which renews it; leaked leases (crashed or wedged owners)
        get reclaimed."""
        ttl = self.config.lease_ttl_s
        if ttl <= 0:
            return
        now = time.time()
        for lease in list(self._leases.values()):
            if lease.reusable and now - lease.renewed_at > ttl:
                self._maybe_revoke_idle_lease(lease)

    async def _dispatch_loop(self):
        """Single dispatch loop draining per-class FIFO queues (reference:
        ClusterLeaseManager::ScheduleAndGrantLeases)."""
        while not self._stopped:
            await self._dispatch_wakeup.wait()
            self._dispatch_wakeup.clear()
            progress = True
            while progress:
                progress = False
                for cls, queue in list(self._queues.items()):
                    if not queue:
                        del self._queues[cls]
                        continue
                    spec, fut, reusable = queue[0]
                    if fut.done():
                        queue.popleft()
                        progress = True
                        continue
                    decision = await self._try_dispatch(spec, reusable)
                    if decision is None:
                        continue  # head-of-line waits; other classes proceed
                    queue.popleft()
                    if not fut.done():
                        fut.set_result(decision)
                    progress = True

    async def _try_dispatch(self, spec: TaskSpec,
                            reusable: bool = False) -> Optional[dict]:
        """Returns a reply dict, or None to keep the request queued."""
        strategy = spec.scheduling_strategy
        bundle = None
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg_id = strategy.placement_group_id
            index = strategy.bundle_index
            if index == -1:
                index = self._find_bundle(pg_id, spec.resources)
                if index is None:
                    return {"granted": False, "reason": "no bundle with capacity"}
            if not self.resources.has_bundle(pg_id, index):
                return {"granted": False, "reason": "bundle not on this node"}
            if not self.resources.bundle_can_allocate(pg_id, index, spec.resources):
                return None  # wait for bundle capacity
            bundle = (pg_id, index)
        elif isinstance(strategy, NodeAffinitySchedulingStrategy):
            if strategy.node_id != self.node_id:
                target = self._cluster_nodes.get(strategy.node_id)
                if target is not None:
                    return {"granted": False, "spillback": (target.node_id, target.address)}
                if not strategy.soft:
                    return {"granted": False, "reason": "affinity node not alive"}
        else:
            if not self.resources.feasible(spec.resources, spec.label_selector):
                return self._spillback_or_reject(spec)
            if isinstance(strategy, SpreadSchedulingStrategy):
                target = self._pick_spread_target(spec)
                if target is not None and target[0] != self.node_id:
                    return {"granted": False, "spillback": target}
            if not self.resources.pool.can_allocate(spec.resources):
                # feasible but busy: hybrid policy — spill if a remote node
                # has free capacity now, else queue locally. Before queuing,
                # try to recall an owner-cached idle lease: its resources
                # may be all that stands between this request and a grant.
                target = self._pick_remote_with_capacity(spec)
                if target is not None:
                    return {"granted": False, "spillback": target}
                self._maybe_revoke_idle_lease()
                return None

        allocation = self.resources.allocate(spec.resources, bundle=bundle)
        if allocation is None:
            return None
        from ..._internal.runtime_env import env_key as _env_key

        worker = await self.worker_pool.pop(
            timeout=60.0,
            env_key=_env_key(spec.runtime_env),
            runtime_env=spec.runtime_env,
        )
        if worker is None:
            self.resources.release(allocation)
            return {"granted": False, "reason": "no worker available"}
        lease_id = UniqueID.from_random()
        self._leases[lease_id] = Lease(
            lease_id, worker, allocation, spec, reusable=reusable
        )
        # job attribution for the log plane: output from this worker belongs
        # to the leasing job from here on (reference: per-job workers)
        job = getattr(spec, "job_id", None)
        if job is not None:
            self._worker_job[worker.pid] = job.hex()
        return {
            "granted": True,
            "lease_id": lease_id,
            "worker_id": worker.worker_id,
            "worker_address": worker.address,
            "node_id": self.node_id,
            "instances": allocation.instance_ids,
        }

    def _find_bundle(self, pg_id: PlacementGroupID, demand) -> Optional[int]:
        for (bpg, index) in self.resources._committed:
            if bpg == pg_id and self.resources.bundle_can_allocate(bpg, index, demand):
                return index
        return None

    def _spillback_or_reject(self, spec: TaskSpec) -> dict:
        """Task infeasible on this node: find a feasible node in the cluster
        view (reference: spillback in ClusterLeaseManager)."""
        for node_id, info in self._cluster_nodes.items():
            if node_id == self.node_id or not info.alive:
                continue
            feasible = all(
                info.resources_total.get(k, 0.0) >= v - 1e-9
                for k, v in spec.resources.items()
            ) and label_match(info.labels, spec.label_selector)
            if feasible:
                return {"granted": False, "spillback": (node_id, info.address)}
        # Remember the unmet demand so the autoscaler sees it even though the
        # owner polls (each retry refreshes the TTL; reference: infeasible
        # tasks stay queued and are reported as pending demand).
        self._infeasible_demands[spec.task_id] = (
            dict(spec.resources),
            dict(spec.label_selector or {}),
            time.time(),
        )
        reply = {"granted": False, "infeasible": True,
                 "reason": f"no node satisfies {spec.resources} {spec.label_selector}"}
        missing = unschedulable_devices(
            spec.resources,
            [self.resources.pool.total_float()]
            + [info.resources_total for info in self._cluster_nodes.values() if info.alive])
        if missing:
            # no autoscaler in the port: a device no node has fails the task
            # instead of waiting for one (never a run without the device)
            reply["unschedulable"] = (
                f"the task needs {missing} and no node of the cluster has one")
        return reply

    def _pick_remote_with_capacity(self, spec: TaskSpec) -> Optional[tuple]:
        best = None
        best_score = None
        for node_id, info in self._cluster_nodes.items():
            if node_id == self.node_id or not info.alive:
                continue
            if not label_match(info.labels, spec.label_selector):
                continue
            avail = self._cluster_available.get(node_id)
            if avail is None:
                continue
            if all(avail.get(k, 0.0) >= v - 1e-9 for k, v in spec.resources.items()):
                score = sum(avail.values())
                if best_score is None or score > best_score:
                    best, best_score = (node_id, info.address), score
        return best

    def _pick_spread_target(self, spec: TaskSpec) -> Optional[tuple]:
        """SPREAD strategy: round-robin over feasible nodes by least load."""
        candidates = []
        for node_id, info in self._cluster_nodes.items():
            if not info.alive:
                continue
            if not all(
                info.resources_total.get(k, 0.0) >= v - 1e-9
                for k, v in spec.resources.items()
            ):
                continue
            avail = self._cluster_available.get(node_id, info.resources_total)
            used = sum(
                info.resources_total.get(k, 0.0) - avail.get(k, 0.0)
                for k in info.resources_total
            )
            candidates.append((used, node_id, info.address))
        if not candidates:
            return None
        candidates.sort(key=lambda c: (c[0], c[1]))
        _, node_id, address = candidates[0]
        return (node_id, address)

    # -- placement group bundles ------------------------------------------

    async def handle_prepare_bundle(
        self, pg_id: PlacementGroupID, index: int, resources: Dict[str, float]
    ) -> bool:
        ok = self.resources.prepare_bundle(pg_id, index, resources)
        if not ok:
            # an owner-cached idle lease may be holding exactly the capacity
            # this bundle needs: recall one so the GCS's scheduling retry
            # (backoff loop in placement_groups.py) can succeed
            self._maybe_revoke_idle_lease()
        return ok

    async def handle_commit_bundle(self, pg_id: PlacementGroupID, index: int) -> bool:
        ok = self.resources.commit_bundle(pg_id, index)
        self._dispatch_wakeup.set()
        return ok

    async def handle_return_bundle(self, pg_id: PlacementGroupID, index: int):
        self.resources.return_bundle(pg_id, index)
        self._dispatch_wakeup.set()
        return True

    # -- object store service ---------------------------------------------

    async def handle_store_create(self, object_id: ObjectID, size: int):
        try:
            return {
                "ok": True,
                "segment": await self._create_with_spill(object_id, size),
            }
        except ObjectStoreFullError as e:
            return {"ok": False, "error": str(e)}

    # -- spilling (reference: LocalObjectManager::SpillObjects
    # raylet/local_object_manager.h:115 + external storage
    # _private/external_storage.py FileSystemStorage) -----------------------

    def _spill_dir(self) -> str:
        path = os.path.join(
            tempfile.gettempdir(),
            f"ray_tpu_torch_spill_{self.session_id}_{self.node_id.hex()[:6]}")
        os.makedirs(path, exist_ok=True)
        return path

    def _spill_ref(self, object_id: ObjectID) -> str:
        """Where a spilled copy lives: node-local disk by default, or an
        external object store when ``spill_storage_uri`` is configured
        (reference: _private/external_storage.py:399 — the S3/GCS tier)."""
        uri = self.config.spill_storage_uri
        if uri:
            return (
                f"{uri.rstrip('/')}/"
                f"{self.session_id}_{self.node_id.hex()[:6]}/{object_id.hex()}"
            )
        return os.path.join(self._spill_dir(), object_id.hex())

    async def _create_with_spill(self, object_id: ObjectID, size: int) -> str:
        """store.create, spilling LRU primary copies to disk under memory
        pressure instead of failing."""
        if size > self.store.capacity:
            # reject up front — spilling the whole store could never help
            raise ObjectStoreFullError(
                f"object of {size} bytes exceeds store capacity "
                f"{self.store.capacity}"
            )
        from ..object_store.native_store import FetchInFlightError

        tried: set = set()
        deadline = time.time() + 30.0
        while True:
            try:
                return self.store.create(object_id, size)
            except FetchInFlightError:
                # transient: a native pull of the same object is mid-stream;
                # once it adopts, create() dedups onto the landed copy.
                # Spilling could never help here.
                if time.time() > deadline:
                    raise
                await asyncio.sleep(0.02)
            except ObjectStoreFullError:
                victim = self.store.lru_spillable()
                if victim is None or victim == object_id or victim in tried:
                    raise
                tried.add(victim)
                await self._spill_object(victim)

    async def _spill_object(self, object_id: ObjectID):
        view = self.store.read_local(object_id)
        if view is None:
            return  # vanished (freed/evicted) — space may already be back
        path = self._spill_ref(object_id)
        # copy out, then write off-loop: disk/network I/O on the event loop
        # would stall heartbeats and lease dispatch (reference: spill
        # workers are separate IO processes, worker_pool.h io worker pool)
        data = bytes(view)
        del view
        try:
            await asyncio.to_thread(spill_storage.write, path, data)
        except Exception:
            logger.exception("spill write failed for %s; skipping", object_id)
            return
        # a reader may have pinned the object during the await; freeing then
        # would reallocate a block a live zero-copy view still aliases.
        # freed is None when the object vanished during the write (a
        # concurrent free already ran) — recording a spill copy then would
        # resurrect a freed object on a later stale get
        freed = self.store.free_if_unpinned(object_id)
        if freed is not True:
            await asyncio.to_thread(spill_storage.delete, path)
            return
        self._spilled[object_id] = path
        logger.info("spilled %s (%d bytes) to %s", object_id, len(data), path)

    async def _restore_spilled(self, object_id: ObjectID) -> bool:
        """Bring a spilled object back into the arena (reference:
        AsyncRestoreSpilledObject, local_object_manager.h:127).

        Restores are serialized per object id: two concurrent gets both see
        the id in _spilled, the first restore deletes the spill file, and an
        unserialized second restore would FileNotFoundError even though the
        object is now in the store."""
        lock = self._restore_locks.setdefault(object_id, asyncio.Lock())
        self._restore_lock_holds[object_id] = (
            self._restore_lock_holds.get(object_id, 0) + 1
        )
        try:
            async with lock:
                if self.store.contains(object_id):
                    return True  # a concurrent restore won
                path = self._spilled.get(object_id)
                if path is None:
                    return self.store.contains(object_id)
                try:
                    data = await asyncio.to_thread(spill_storage.read, path)
                except spill_storage.SpillStorageError:
                    # transient backend failure: the blob is still there —
                    # keep the pointer and let the caller retry
                    logger.warning("spill restore of %s failed transiently",
                                   object_id)
                    return False
                except OSError:
                    # copy vanished (concurrent free / external cleanup)
                    self._spilled.pop(object_id, None)
                    return self.store.contains(object_id)
                await self._create_with_spill(object_id, len(data))
                self.store.write_view(object_id)[: len(data)] = data
                self.store.seal(object_id)
                self.store.pin_primary(object_id)  # restored copy stays primary
                self._spilled.pop(object_id, None)
                await asyncio.to_thread(spill_storage.delete, path)
                return True
        finally:
            # drop the per-object lock only when no other coroutine is
            # holding or waiting on it, tracked with an explicit counter
            # (asyncio.Lock has no public waiter count)
            holds = self._restore_lock_holds.get(object_id, 1) - 1
            if holds <= 0:
                self._restore_lock_holds.pop(object_id, None)
                self._restore_locks.pop(object_id, None)
            else:
                self._restore_lock_holds[object_id] = holds

    async def handle_store_seal(self, object_id: ObjectID, is_primary: bool = False):
        self.store.seal(object_id)
        if is_primary:
            self.store.pin_primary(object_id)
        return True

    async def handle_store_contains(self, object_id: ObjectID):
        return self.store.contains(object_id)

    async def handle_store_get(
        self,
        object_id: ObjectID,
        owner_address: Optional[Tuple[str, int]] = None,
        timeout: Optional[float] = None,
        prefer_source: Optional[Tuple[str, int]] = None,
    ):
        """Local get; pulls from a remote node when the object isn't here
        (reference: PullManager). ``prefer_source`` names the peer to pull
        from first — the weight plane routes each node at its broadcast-tree
        parent so a shard leaves the publisher once, not once per node."""
        if self.store.contains(object_id):
            result = await self.store.get(object_id, timeout=0.1)
            if result is not None:
                return {"ok": True, "segment": result[0], "size": result[1]}
        if object_id in self._spilled:
            try:
                restored = await self._restore_spilled(object_id)
            except ObjectStoreFullError:
                restored = False
            if restored:
                result = await self.store.get(object_id, timeout=1.0)
                if result is not None:
                    return {"ok": True, "segment": result[0], "size": result[1]}
            else:
                # arena is full of pinned readers: serve the payload inline
                # from the spill file (a copy) rather than failing the get —
                # the object is durably here, only zero-copy is impossible
                path = self._spilled.get(object_id)
                if path is not None:
                    try:
                        data = await asyncio.to_thread(spill_storage.read, path)
                        return {"ok": True, "data": data}
                    except (OSError, spill_storage.SpillStorageError):
                        pass  # raced with restore, or transient backend error
        if owner_address is not None:
            pulled = await self._pull_object(
                object_id, owner_address, prefer_source
            )
            if pulled:
                result = await self.store.get(object_id, timeout=1.0)
                if result is not None:
                    return {"ok": True, "segment": result[0], "size": result[1]}
        result = await self.store.get(object_id, timeout=timeout)
        if result is None:
            return {"ok": False}
        return {"ok": True, "segment": result[0], "size": result[1]}

    async def handle_store_release(self, object_id: ObjectID):
        self.store.release(object_id)
        if object_id in self._deferred_frees:
            # the owner freed this object while a zero-copy reader held a
            # pin; now that the pin count may have dropped, retry
            if self.store.free_if_unpinned(object_id) is not False:
                self._deferred_frees.discard(object_id)
        return True

    async def handle_free_objects(self, object_ids: List[ObjectID]):
        for oid in object_ids:
            # NEVER free a block a concurrent zero-copy reader still pins —
            # the allocator would hand the space to the next create and the
            # reader's live numpy views would silently change contents.
            # Pinned objects free later, on the releasing store_release.
            if self.store.free_if_unpinned(oid) is False:
                self._deferred_frees.add(oid)
            path = self._spilled.pop(oid, None)
            if path is not None:
                self._bg.spawn(asyncio.to_thread(spill_storage.delete, path))
        return True

    async def handle_fetch_object(self, object_id: ObjectID, offset: int, length: int):
        """Serve one chunk of a local object to a pulling peer (reference:
        ObjectManager::Push chunking).

        A spilled primary copy is still durably here — the owner's location
        table lists this node — so serve chunks straight from the spill file
        rather than returning None (which would surface as ObjectLostError
        at the puller)."""
        view = self.store.read_local(object_id)
        if view is None:
            path = self._spilled.get(object_id)
            if path is not None:
                try:
                    total, chunk = await asyncio.to_thread(
                        spill_storage.read_range, path, offset, length
                    )
                    self._note_fetch_served(object_id, offset, len(chunk))
                    return {"total": total, "data": chunk}
                except (OSError, spill_storage.SpillStorageError):
                    pass  # spill copy raced with restore/free, or transient
            # a concurrent restore may have just completed (and popped the
            # _spilled entry + deleted the file): retry the store before
            # declaring the object absent
            view = self.store.read_local(object_id)
            if view is None:
                return None
        total = len(view)
        chunk = bytes(view[offset : offset + length])
        self._note_fetch_served(object_id, offset, len(chunk))
        return {"total": total, "data": chunk}

    def _note_fetch_served(self, object_id: ObjectID, offset: int, nbytes: int):
        if offset == 0:
            self._fetch_serves[object_id] = (
                self._fetch_serves.get(object_id, 0) + 1
            )
        self._fetch_bytes_out += nbytes

    async def handle_transfer_stats(self):
        """Per-node transfer accounting: python-path serves per object,
        payload bytes out, and native-plane pull count. The weight-plane
        multi-node test asserts each chunk is served from the publisher node
        at most once regardless of subscriber count."""
        return {
            "fetch_serves": {
                oid.hex(): n for oid, n in self._fetch_serves.items()
            },
            "fetch_bytes_out": self._fetch_bytes_out,
            "native_pulls": self._native_pulls,
        }

    async def handle_store_pin_weight(self, object_id: ObjectID) -> bool:
        """Weight-plane pin (refcounted): exempts a local chunk copy from
        eviction and spill selection until the matching unpin."""
        pin = getattr(self.store, "pin_weight", None)
        return bool(pin(object_id)) if pin is not None else False

    async def handle_store_unpin_weight(self, object_id: ObjectID) -> bool:
        unpin = getattr(self.store, "unpin_weight", None)
        if unpin is not None:
            unpin(object_id)
        return True

    async def handle_transfer_info(self):
        """Advertise the native transfer-plane port (None = python path)."""
        return {"port": self._transfer_port}

    async def _native_pull(self, object_id: ObjectID, node_address) -> bool:
        """Try the C++ transfer plane: one TCP stream straight into the
        local arena. False = not attempted / failed (caller falls back to
        the chunked-RPC pull)."""
        if not self.config.object_transfer_native_enabled:
            return False
        if self._transfer_port is None or not hasattr(
            self.store, "transfer_fetch_raw"
        ):
            return False
        key = tuple(node_address)
        cached = self._peer_transfer_ports.get(key)
        # a failed probe is retried after a grace period (the peer may have
        # just been starting up), not cached forever
        if cached is not None and (
            cached[0] is not None or time.time() < cached[1]
        ):
            port = cached[0]
        else:
            try:
                peer = self.client_pool.get(*node_address)
                info = await peer.call("transfer_info", timeout=5.0)
                port = (info or {}).get("port")
            except Exception:
                port = None
            self._peer_transfer_ports[key] = (port, time.time() + 30.0)
        if port is None:
            return False
        self.store.begin_fetch(object_id)
        try:
            rc, off, size = await asyncio.to_thread(
                self.store.transfer_fetch_raw,
                object_id, node_address[0], port,
                self.config.cluster_auth_token,
            )
            if rc == 0:
                self.store.adopt_fetched(object_id, off, size)
                self._native_pulls += 1
                return True
        finally:
            self.store.end_fetch(object_id)
        if rc == -4:  # already present (raced with another pull)
            return self.store.contains(object_id)
        if rc in (-1, -5):
            # connect/protocol/auth failure: the peer may have restarted on
            # a new port (or with a new token) — drop the cache entry so the
            # next pull re-probes instead of paying this again
            self._peer_transfer_ports.pop(key, None)
        return False

    async def _pull_object(
        self, object_id: ObjectID, owner_address, prefer_source=None
    ) -> bool:
        """Ask the owner where the object lives, then pull it — C++
        transfer plane first, chunked RPC as the fallback (reference:
        PullManager + ObjectManager::Push).

        Serialized per object: the native fetch creates the C++ arena entry
        before the python mirrors exist, so a concurrent pull of the SAME
        object would see an inconsistent half-created state (the chunked
        path's mirror-first ordering tolerated this; the native path does
        not)."""
        lock = self._pull_locks.setdefault(object_id, asyncio.Lock())
        # hold-counted cleanup: Lock.locked() is False the instant release()
        # runs even with waiters still queued, so a holder's `finally` could
        # delete the entry out from under them and a third pull would mint a
        # fresh lock — two pulls of the same object running "locked"
        self._pull_lock_holds[object_id] = (
            self._pull_lock_holds.get(object_id, 0) + 1
        )
        try:
            async with lock:
                if self.store.contains(object_id):
                    return True  # a concurrent pull already landed it
                return await self._pull_object_locked(
                    object_id, owner_address, prefer_source
                )
        finally:
            holds = self._pull_lock_holds[object_id] - 1
            if holds:
                self._pull_lock_holds[object_id] = holds
            else:
                del self._pull_lock_holds[object_id]
                if self._pull_locks.get(object_id) is lock:
                    del self._pull_locks[object_id]

    async def _pull_object_locked(
        self, object_id: ObjectID, owner_address, prefer_source=None
    ) -> bool:
        try:
            owner = self.client_pool.get(*owner_address)
            loc = await owner.call(
                "get_object_locations", object_id, timeout=10.0
            )
        except Exception as e:
            logger.debug("pull: owner lookup failed for %s: %s", object_id, e)
            return False
        if prefer_source is not None:
            # topology-aware pull (weight plane): try the named peer first
            # even if the owner's location table hasn't caught up with it yet
            # (the caller verified the peer holds the object; registration
            # with the owner is asynchronous). Other holders stay as
            # fallbacks so a dead parent cannot wedge the pull.
            prefer = tuple(prefer_source)
            loc = [prefer] + [
                n for n in (loc or ()) if tuple(n) != prefer
            ]
        if not loc:
            return False
        for node_address in loc:
            if tuple(node_address) == tuple(self.address):
                continue
            # Reachability gate: a dead holder refuses connects instantly,
            # but the client's connect-retry window would eat seconds per
            # attempt (native probe + chunked fallback) before the caller
            # can move on to reconstruction. Bound the connect here; the
            # transfer itself stays unbounded (big objects take long
            # legitimately).
            try:
                peer = self.client_pool.get(*node_address)
                await asyncio.wait_for(
                    peer._ensure_connected(), _PULL_CONNECT_PROBE_S
                )
            except Exception as e:
                logger.debug(
                    "pull of %s: holder %s unreachable (%s), trying next",
                    object_id, node_address, e,
                )
                continue
            try:
                if await self._native_pull(object_id, node_address):
                    try:
                        owner = self.client_pool.get(*owner_address)
                        await owner.call_oneway(
                            "add_object_location", object_id, self.address
                        )
                    except Exception:
                        pass
                    return True
            except Exception as e:
                logger.debug(
                    "native pull of %s failed: %s (falling back)",
                    object_id, e,
                )
            try:
                peer = self.client_pool.get(*node_address)
                chunk_size = self.config.object_transfer_chunk_size
                first = await peer.call(
                    "fetch_object", object_id, 0, chunk_size, timeout=30.0
                )
                if first is None:
                    continue
                total = first["total"]
                segment = await self._create_with_spill(object_id, total)
                view = self.store.write_view(object_id)
                view[: len(first["data"])] = first["data"]
                offset = len(first["data"])
                while offset < total:
                    part = await peer.call(
                        "fetch_object", object_id, offset, chunk_size,
                        timeout=30.0,
                    )
                    if part is None:
                        break
                    data = part["data"]
                    if not data:
                        # peer returned an empty chunk (e.g. a concurrent
                        # restore/re-spill rewrote the file under the read);
                        # looping again with the same offset would busy-spin
                        break
                    view[offset : offset + len(data)] = data
                    offset += len(data)
                if offset >= total:
                    self.store.seal(object_id)
                    # tell the owner this node now holds a copy
                    try:
                        owner = self.client_pool.get(*owner_address)
                        await owner.call_oneway(
                            "add_object_location", object_id, self.address
                        )
                    except Exception:
                        pass
                    return True
                self.store.free(object_id)
            except Exception as e:
                logger.debug("pull of %s from %s failed: %s", object_id, node_address, e)
        return False

    # -- worker logs (reference: log_monitor.py + `ray logs`) --------------

    def _worker_log_sink(self, record: dict):
        """Called from log-pump threads: ship a batch of worker output lines
        to the GCS "logs" pubsub channel for driver echo."""
        if self._stopped:
            return
        record = dict(
            record, ip=self.address[0], node_id=self.node_id.hex(),
            job_id=self._worker_job.get(record.get("pid"), ""),
        )
        asyncio.run_coroutine_threadsafe(self._publish_logs(record), self._loop)

    async def _publish_logs(self, record: dict):
        try:
            gcs = self.client_pool.get(*self.gcs_address)
            await gcs.call_oneway("publish", "logs", record)
        except Exception:
            pass  # log echo is best-effort; never destabilize the raylet

    async def handle_list_logs(self) -> List[str]:
        """List log files in this node's session log dir (`ray logs`)."""
        try:
            return sorted(os.listdir(self.log_dir))
        except OSError:
            return []

    async def handle_read_log(self, name: str, tail: int = 1000) -> str:
        """Return the last ``tail`` lines of one session log file. The name
        is basename-sanitized — this RPC must not become a file-read oracle."""
        path = os.path.join(self.log_dir, os.path.basename(name))
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 4 * 1024 * 1024))
                data = f.read()
        except OSError:
            return ""
        lines = data.decode("utf-8", errors="replace").splitlines()
        return "\n".join(lines[-tail:])

    # -- misc --------------------------------------------------------------

    async def handle_ping(self):
        return {"node_id": self.node_id, "time": time.time()}

    async def handle_get_node_info(self):
        return {
            "node_id": self.node_id,
            "address": self.address,
            "resources_total": self.resources.total_float(),
            "resources_available": self.resources.available_float(),
            "labels": dict(self.resources.labels),
            "store": self.store.stats(),
            "transfer_port": self._transfer_port,
            "native_pulls": self._native_pulls,
            "num_workers": self.worker_pool.num_total if self.worker_pool else 0,
        }

    async def handle_drain(self):
        """Graceful drain (reference: HandleDrainRaylet node_manager.h:313)."""
        gcs = self.client_pool.get(*self.gcs_address)
        await gcs.call("unregister_node", self.node_id, timeout=10.0)
        return True



