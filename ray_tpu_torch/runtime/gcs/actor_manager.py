"""GCS actor management: directory, scheduling, restart-on-failure.

Role-equivalent of the reference's GcsActorManager + GcsActorScheduler
(src/ray/gcs/gcs_actor_manager.h:93, gcs_actor_scheduler.h:108): actors are
registered centrally, scheduled by leasing a worker from a raylet, restarted
subject to ``max_restarts`` when their worker or node dies, and their
addresses are published on the ``actor:*`` pubsub channel so callers can
re-resolve after restarts.

A copy of ``ray_tpu/runtime/gcs/actor_manager.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own. Its records are pickled with the standard
library, not cloudpickle; an actor needing a device no node has dies at once
(``ActorUnschedulableError``) instead of waiting for an autoscaler.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
from typing import Dict, Optional, Set, TYPE_CHECKING


from ..._internal.ids import ActorID, NodeID, WorkerID
from ..._internal.protocol import ActorInfo, ActorState, TaskSpec
from ...exceptions import ActorUnschedulableError
from ..raylet.resources import unschedulable_devices
from . import keys as gcs_keys

if TYPE_CHECKING:
    from .server import GcsServer
    from .store import StoreClient

logger = logging.getLogger(__name__)


class GcsActorManager:
    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        self._actors: Dict[ActorID, ActorInfo] = {}
        # (namespace, name) -> actor_id
        self._named: Dict[tuple, ActorID] = {}
        # node_id -> set of actor ids placed there
        self._by_node: Dict[NodeID, set] = {}
        self._by_worker: Dict[WorkerID, ActorID] = {}
        # terminally-dead actor ids (compacted durable records): consulted
        # when a re-registering raylet asks whether its actor workers are
        # stale after a GCS restart
        self._tombstones: Set[ActorID] = set()

    # -- persistence (reference: GcsActorTable on the store client) --------

    def _persist(self, info: ActorInfo):
        try:
            self._gcs.storage.put(
                "actors", info.actor_id.hex(), pickle.dumps(info)
            )
        except Exception:
            logger.exception("failed to persist actor %s", info.actor_id)

    def restore_from(self, storage: "StoreClient") -> Set[NodeID]:
        """Reload the actor directory after a GCS restart. ALIVE actors keep
        their addresses (their workers are expected to still run); PENDING/
        RESTARTING actors get their scheduling loop kicked again. Returns the
        node ids that restored ALIVE actors reference so the server can
        grace-period them (reference: gcs_actor_manager.cc Initialize())."""
        nodes: Set[NodeID] = set()
        for key in storage.get_all("actor_tombstones"):
            try:
                self._tombstones.add(ActorID.from_hex(key))
            except Exception:
                logger.exception("dropping unreadable tombstone %s", key)
        for key, raw in storage.get_all("actors").items():
            try:
                info: ActorInfo = pickle.loads(raw)
            except Exception:
                logger.exception("dropping unreadable actor record %s", key)
                continue
            self._actors[info.actor_id] = info
            if info.name and info.state != ActorState.DEAD:
                self._named[(info.namespace, info.name)] = info.actor_id
            if info.state == ActorState.ALIVE:
                if info.node_id is not None:
                    self._by_node.setdefault(info.node_id, set()).add(
                        info.actor_id
                    )
                    nodes.add(info.node_id)
                if info.worker_id is not None:
                    self._by_worker[info.worker_id] = info.actor_id
            elif info.state in (
                ActorState.PENDING_CREATION,
                ActorState.RESTARTING,
            ):
                self._gcs.spawn(self._schedule(info))
        if self._actors:
            logger.info("restored %d actor record(s)", len(self._actors))
        return nodes

    def reconcile_node(self, node_id: NodeID, live_worker_ids):
        """A raylet (re-)registered, reporting which workers it still runs:
        ALIVE actors bound to vanished workers on that node died while the
        GCS was away — put them through the normal failure path."""
        if live_worker_ids is None:
            return
        live = set(live_worker_ids)
        for actor_id in list(self._by_node.get(node_id, ())):
            info = self._actors.get(actor_id)
            if (
                info is not None
                and info.state == ActorState.ALIVE
                and info.worker_id is not None
                and info.worker_id not in live
            ):
                self._by_worker.pop(info.worker_id, None)
                self._gcs.spawn(
                    self._handle_actor_failure(
                        actor_id, "worker lost while GCS was down"
                    )
                )

    # -- registration / scheduling ----------------------------------------

    async def register_actor(self, spec: TaskSpec, detached: bool) -> ActorInfo:
        actor_id = spec.actor_id
        name_key = (spec.namespace, spec.actor_name)
        if spec.actor_name:
            existing_id = self._named.get(name_key)
            if existing_id is not None:
                existing = self._actors.get(existing_id)
                if existing is not None and existing.state != ActorState.DEAD:
                    raise ValueError(
                        f"Actor name {spec.actor_name!r} already taken in "
                        f"namespace {spec.namespace!r}"
                    )
        info = ActorInfo(
            actor_id=actor_id,
            job_id=spec.job_id,
            name=spec.actor_name,
            namespace=spec.namespace,
            state=ActorState.PENDING_CREATION,
            max_restarts=spec.max_restarts,
            creation_spec=spec,
            detached=detached,
            owner_address=spec.owner_address,
        )
        self._actors[actor_id] = info
        if spec.actor_name:
            self._named[name_key] = actor_id
        self._persist(info)
        self._gcs.spawn(self._schedule(info))
        return info

    async def _schedule(self, info: ActorInfo):
        """Lease a worker for the actor and push its creation task."""
        spec = info.creation_spec
        delay = 0.05
        while info.state in (ActorState.PENDING_CREATION, ActorState.RESTARTING):
            missing = unschedulable_devices(
                spec.resources,
                [n.resources_total for n in self._gcs.alive_nodes().values()])
            if missing:
                # no autoscaler in the port: an actor needing a device no node
                # has dies at once instead of waiting for one
                await self._mark_dead(info, (
                    f"ActorUnschedulableError: the actor needs {missing} and no "
                    "node of the cluster has one"))
                return
            grant = None
            try:
                grant = await self._gcs.lease_worker_for_task(spec)
            except Exception as e:
                logger.debug("actor %s lease failed: %s", info.actor_id, e)
            if grant is None:
                await asyncio.sleep(delay)
                delay = min(delay * 2, 2.0)
                continue
            node_id, worker_id, worker_addr, lease_id, gpu_ids = grant
            try:
                raylet = self._gcs.raylet_client(node_id)
                worker_client = self._gcs.client_pool.get(*worker_addr)
                # bound to the lease's card (a GPU worker's first lease pays
                # the torch import and the CUDA context)
                await worker_client.call("create_actor", spec, gpu_ids, timeout=120.0)
            except ActorUnschedulableError as e:
                await self._mark_dead(info, f"ActorUnschedulableError: {e}")
                try:
                    await raylet.call_oneway("return_worker", lease_id, True)
                except Exception:
                    pass
                return
            except Exception as e:
                logger.warning("actor %s creation push failed: %s", info.actor_id, e)
                try:
                    await raylet.call_oneway("return_worker", lease_id, True)
                except Exception:
                    pass
                await asyncio.sleep(delay)
                delay = min(delay * 2, 2.0)
                continue
            info.state = ActorState.ALIVE
            info.address = worker_addr
            info.node_id = node_id
            info.worker_id = worker_id
            self._by_node.setdefault(node_id, set()).add(info.actor_id)
            self._by_worker[worker_id] = info.actor_id
            self._persist(info)
            self._publish(info)
            logger.info("actor %s alive on %s", info.actor_id, worker_addr)
            return

    def _publish(self, info: ActorInfo):
        self._gcs.publisher.publish(
            gcs_keys.ACTOR_CHANNEL.key(info.actor_id.hex()), info
        )

    # -- queries -----------------------------------------------------------

    def is_tombstoned(self, actor_id: ActorID) -> bool:
        return actor_id in self._tombstones

    def get(self, actor_id: ActorID) -> Optional[ActorInfo]:
        return self._actors.get(actor_id)

    def get_by_name(self, name: str, namespace: str) -> Optional[ActorInfo]:
        actor_id = self._named.get((namespace, name))
        info = self._actors.get(actor_id) if actor_id else None
        if info is not None and info.state == ActorState.DEAD:
            # a dead actor's name is free again (reference: named-actor
            # lookup misses after death); callers re-create under the name
            return None
        return info

    def list_actors(self):
        return list(self._actors.values())

    # -- failure handling --------------------------------------------------

    async def on_worker_death(self, worker_id: WorkerID, reason: str):
        actor_id = self._by_worker.pop(worker_id, None)
        if actor_id is not None:
            await self._handle_actor_failure(actor_id, f"worker died: {reason}")

    async def on_node_death(self, node_id: NodeID):
        for actor_id in list(self._by_node.pop(node_id, ())):
            await self._handle_actor_failure(actor_id, "node died")

    async def _handle_actor_failure(self, actor_id: ActorID, reason: str):
        info = self._actors.get(actor_id)
        if info is None or info.state == ActorState.DEAD:
            return
        if info.node_id is not None:
            self._by_node.get(info.node_id, set()).discard(actor_id)
        unlimited = info.max_restarts == -1
        if info.state == ActorState.ALIVE and (
            unlimited or info.num_restarts < info.max_restarts
        ):
            info.num_restarts += 1
            info.state = ActorState.RESTARTING
            info.address = None
            self._persist(info)
            self._publish(info)
            logger.info(
                "restarting actor %s (%d/%s): %s",
                actor_id, info.num_restarts,
                "inf" if unlimited else info.max_restarts, reason,
            )
            self._gcs.spawn(self._schedule(info))
        else:
            await self._mark_dead(info, reason)

    async def _mark_dead(self, info: ActorInfo, reason: str):
        info.state = ActorState.DEAD
        info.death_cause = reason
        info.address = None
        # DEAD is terminal (no restart path leads out of it): compact the
        # full durable record to a tiny tombstone, or the actors table grows
        # without bound and every GCS restart reloads all historical dead
        # actors. The tombstone (vs outright deletion) lets a restarted GCS
        # still judge a re-registering raylet's worker for this actor stale
        # — a zombie incarnation must not keep running side effects.
        self._tombstones.add(info.actor_id)
        try:
            self._gcs.storage.delete("actors", info.actor_id.hex())
            self._gcs.storage.put(
                "actor_tombstones", info.actor_id.hex(), b"1"
            )
        except Exception:
            logger.exception("failed to compact dead actor %s", info.actor_id)
        self._publish(info)

    async def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        info = self._actors.get(actor_id)
        if info is None:
            return
        if no_restart:
            # pre-mark dead so the death report doesn't trigger a restart
            prev_addr, prev_worker = info.address, info.worker_id
            await self._mark_dead(info, "killed via kill()")
            if prev_worker is not None:
                self._by_worker.pop(prev_worker, None)
            if prev_addr is not None:
                try:
                    await self._gcs.client_pool.get(*prev_addr).call_oneway("exit_worker")
                except Exception:
                    pass
        elif info.address is not None:
            try:
                await self._gcs.client_pool.get(*info.address).call_oneway("exit_worker")
            except Exception:
                pass

    async def on_job_finished(self, job_id):
        """Non-detached actors die with their job (reference: actor lifetime)."""
        for info in list(self._actors.values()):
            if info.job_id == job_id and not info.detached and info.state != ActorState.DEAD:
                await self.kill_actor(info.actor_id)
