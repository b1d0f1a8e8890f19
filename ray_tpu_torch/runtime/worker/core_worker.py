"""CoreWorker: the per-process runtime for drivers and workers.

Role-equivalent of the reference's CoreWorker (src/ray/core_worker/
core_worker.h:167) and its satellites:

- ownership + reference counting for objects this process created
  (reference: reference_counter.h — local refs and submitted-task refs here;
  the full borrower protocol is tracked per-ref owner address)
- in-process memory store for small results (memory_store.h)
- normal-task submission via raylet worker leases with spillback-following and
  retries (normal_task_submitter.h)
- actor-task submission with per-caller sequence numbers, client-side queueing
  while the actor is pending/restarting (actor_task_submitter.h)
- the execution side: function-table resolution, ordered actor queues,
  result serialization with the small/large split (task_receiver.h)

Every CoreWorker runs an RpcServer: owners serve object metadata/value
requests on it; executors additionally serve push_task/create_actor/actor_task.

The port of ``ray_tpu/runtime/worker/core_worker.py`` (host code: the port
imports nothing of ``ray_tpu``). It departs from the reference in these
ways:

- a task or actor runs on the card its lease names: the owner passes the
  lease's GPU ids with ``push_task`` and the GCS with ``create_actor``, and
  the worker binds ``torch.cuda`` to that card before user code runs (on
  every executor thread: CUDA's current device is a thread's own);
  ``get_gpu_ids()`` reports them. The reference drops the lease's ids;
- a task demanding a device no node has fails with
  ``TaskUnschedulableError`` instead of waiting for an autoscaler;
- device objects hold torch tensors (``experimental.device_objects``);
- the compiled-graph and collective-group actor hooks, the post-mortem
  debugger, the task spans and the runtime planes' metrics are not ported.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import enum
import logging
import os
import sys
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..._internal import serialization
from ..._internal.config import Config
from ..._internal.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    UniqueID,
    WorkerID,
)
from ..._internal.protocol import (
    ActorInfo,
    ActorState,
    DefaultSchedulingStrategy,
    FunctionDescriptor,
    PlacementGroupSchedulingStrategy,
    ReturnObject,
    TaskArg,
    TaskReply,
    TaskSpec,
    TaskType,
)
from ..._internal.rpc import ClientPool, RpcClient, RpcServer
from ...exceptions import (
    ActorDiedError,
    ActorUnschedulableError,
    GetTimeoutError,
    ObjectLostError,
    RpcError,
    TaskCancelledError,
    TaskError,
    TaskUnschedulableError,
    WorkerCrashedError,
)
from ...object_ref import ObjectRef
from ..gcs import keys as gcs_keys
from ..gcs.pubsub import SubscriberClient
from ..object_store.store import StoreClient
from .memory_store import MemoryStore

logger = logging.getLogger(__name__)

# Connect bound when probing a spillback lease target (see
# _acquire_lease_loop): long enough for a loaded raylet to accept a TCP
# connection, short enough that a stale redirect to a dead raylet does
# not stall the submission pipeline.
_LEASE_CONNECT_PROBE_S = 2.0


class WorkerMode(enum.Enum):
    DRIVER = 0
    WORKER = 1


class _ActorClientState:
    """Client-side view of one actor (reference: ActorTaskSubmitter state)."""

    __slots__ = (
        "actor_id", "state", "address", "seq", "queue", "death_cause",
        "incarnation", "reconciling", "creation_arg_pins", "unresolved",
    )

    def __init__(self, actor_id: ActorID):
        self.actor_id = actor_id
        self.state = ActorState.PENDING_CREATION
        self.address: Optional[Tuple[str, int]] = None
        self.seq = 0
        # tasks parked while the actor is pending/restarting
        self.queue: deque = deque()
        self.death_cause = ""
        # creation-arg submitted-ref pins, held for the actor's LIFETIME:
        # restarts re-run __init__ from the stored spec, so its by-ref args
        # (top-level and nested) must stay fetchable until the actor is
        # terminally DEAD (reference: actor creation spec retention +
        # reference_counter.h:44 contained-in refs)
        self.creation_arg_pins: Optional[List[ObjectID]] = None
        # which restart generation our sequence numbering belongs to: the
        # executor's per-caller counters die with its process, so the queue
        # renumbers from 0 exactly once per new incarnation
        self.incarnation = -1
        # a GCS re-poll loop runs while calls are parked (missed/raced
        # pubsub edges must not strand the queue forever)
        self.reconciling = False
        # call future -> (incarnation, seq) for every unresolved call; the
        # min over the current incarnation is the sequence watermark sent
        # with each push so the executor can skip seqs this client
        # abandoned (dropped send + no resend = a hole its in-order queue
        # would otherwise park behind forever)
        self.unresolved: Dict[asyncio.Future, Tuple[int, int]] = {}


class _StreamState:
    """Owner-side progress of one streaming-generator task."""

    __slots__ = ("reported", "total", "error", "next_read", "event")

    def __init__(self):
        self.reported: set = set()  # indices whose objects have arrived
        self.total: Optional[int] = None  # set at end-of-stream
        self.error: Optional[bytes] = None
        self.next_read = 0
        self.event = asyncio.Event()

    def pulse(self):
        self.event.set()


class CoreWorker:
    def __init__(
        self,
        mode: WorkerMode,
        config: Config,
        gcs_address: Tuple[str, int],
        raylet_address: Tuple[str, int],
        loop: asyncio.AbstractEventLoop,
        job_id: Optional[JobID] = None,
    ):
        self.mode = mode
        self.config = config
        self.gcs_address = gcs_address
        self.raylet_address = raylet_address
        self.loop = loop
        self.worker_id = WorkerID.from_random()
        self.job_id = job_id or JobID.nil()
        self.node_id: Optional[NodeID] = None

        self.server = RpcServer(f"worker-{self.worker_id.hex()[:6]}")
        self.client_pool = ClientPool(
            "worker-out", register_meta={"worker_id": self.worker_id}
        )
        self.memory_store = MemoryStore()
        self.store_client = StoreClient()
        self.address: Optional[Tuple[str, int]] = None

        # ownership / ref counting (owner side)
        self._local_refs: Dict[ObjectID, int] = defaultdict(int)
        self._submitted_refs: Dict[ObjectID, int] = defaultdict(int)
        self._owned: set = set()
        self._ref_lock = threading.Lock()
        # borrower protocol (reference: reference_counter.h:44 borrower
        # registration + WaitForRefRemoved): owner side tracks which remote
        # workers hold a deserialized copy of an owned ref and defers the
        # free until every borrower unregisters (or a liveness probe prunes
        # a dead one); borrower side remembers which ids it borrowed so it
        # can unregister on its last local decref and answer probes.
        self._borrowers: Dict[ObjectID, set] = defaultdict(set)
        self._borrower_probe_tasks: Dict[ObjectID, asyncio.Task] = {}
        self._borrowed_owner: Dict[ObjectID, Tuple[str, int]] = {}
        # strong refs for fire-and-forget protocol RPCs (a bare
        # ensure_future can be GC'd mid-flight)
        from ..._internal.event_loop import BackgroundTasks

        self._bg = BackgroundTasks()

        # task bookkeeping
        self._current_task_id = TaskID.of(self.job_id)
        self._put_index = 0
        self._task_index = 0
        self._pending_tasks: Dict[TaskID, TaskSpec] = {}
        self._task_done_events: Dict[TaskID, asyncio.Event] = {}
        self._task_event_buffer: List[dict] = []
        self._event_flush_task: Optional[asyncio.Task] = None

        # worker-lease reuse (reference: lease caching per SchedulingKey in
        # normal_task_submitter.h): scheduling-class key -> idle granted
        # leases kept warm for worker_lease_idle_ttl_s. _lease_waiters counts
        # in-flight request_worker_lease calls per key so a finishing task
        # returns its worker to the raylet (which holds the queued requests)
        # instead of parking it locally where no one would take it.
        self._lease_cache: Dict[tuple, List[dict]] = {}
        self._lease_waiters: Dict[tuple, int] = defaultdict(int)
        self._lease_reaper_task: Optional[asyncio.Task] = None

        # actor submission state
        self._actors: Dict[ActorID, _ActorClientState] = {}
        self._subscriber: Optional[SubscriberClient] = None
        # parked-queue GCS re-poll loops, cancelled at shutdown
        self._reconciler_tasks: set = set()

        # streaming generators (owner side): task_id -> stream progress
        # (reference: ObjectRefStream, task_manager.h:67)
        self._streams: Dict[TaskID, _StreamState] = {}

        # lineage (owner side; reference: ObjectRecoveryManager,
        # object_recovery_manager.h:41 + TaskManager lineage pinning): the
        # creating spec is retained per plasma-stored return of a retriable
        # normal task so a lost copy can be rebuilt by re-execution. Lineage
        # holds a submitted-ref pin on the task's by-ref args, keeping them
        # materialized (or themselves reconstructable) for transitive
        # recovery.
        self._lineage: Dict[ObjectID, TaskSpec] = {}
        self._lineage_arg_pins: Dict[ObjectID, List[ObjectID]] = {}
        self._reconstructing: Dict[TaskID, asyncio.Future] = {}
        self._reconstruct_budget: Dict[TaskID, int] = {}

        # execution side
        self._function_cache: Dict[str, Callable] = {}
        self._actor_instance: Any = None
        self._actor_spec: Optional[TaskSpec] = None
        self._actor_semaphore: Optional[asyncio.Semaphore] = None
        self._executor_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        # the card of this worker's current lease: its GPU instance ids and
        # the torch.cuda index they bind to (None: no GPU lease, torch never
        # imported for it)
        self.gpu_ids: List[int] = []
        self._cuda_index: Optional[int] = None
        # per-caller ordered queues for actor tasks
        self._caller_expected_seq: Dict[WorkerID, int] = defaultdict(int)
        self._caller_parked: Dict[WorkerID, Dict[int, tuple]] = defaultdict(dict)
        # completed replies by (caller, seq) for duplicate-delivery dedup
        # (bounded by entries and bytes; insertion-ordered dict = LRU window)
        self._caller_replies: Dict[WorkerID, Dict[int, tuple]] = defaultdict(dict)
        # in-flight executions by (caller, seq): duplicates share the outcome
        self._caller_inflight: Dict[WorkerID, Dict[int, asyncio.Future]] = (
            defaultdict(dict)
        )
        # highest sequence watermark seen per caller: every seq below it is
        # resolved caller-side, so a sub-watermark seq that never arrived
        # is never coming and must be skipped, not waited on
        self._caller_watermark: Dict[WorkerID, int] = defaultdict(int)
        self._execution_lock = asyncio.Lock()
        self._exit_requested = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self, host: str = "127.0.0.1"):
        self._register_handlers()
        port = await self.server.start(host, 0)
        self.address = (host, port)
        self._subscriber = SubscriberClient(
            self.client_pool.get(*self.gcs_address),
            f"worker-{self.worker_id.hex()}",
        )
        self._event_flush_task = asyncio.ensure_future(self._flush_task_events())
        return self.address

    async def subscribe_worker_logs(self, callback):
        """Echo worker output to this process (reference:
        ray.init(log_to_driver=True) — the driver subscribes to the log
        channel and prints lines the per-node log monitors publish).
        ``callback`` receives {"pid", "ip", "node_id", "lines": [...]}."""
        await self._subscriber.subscribe(
            "logs", lambda _channel, record: callback(record)
        )

    # -- task events (reference: TaskEventBuffer, task_event_buffer.h:297) --

    def record_task_event(self, task_id, **fields):
        ev = {"task_id": task_id.hex(), "ts": time.time(), **fields}
        self._task_event_buffer.append(ev)

    async def _flush_task_events(self):
        while True:
            await asyncio.sleep(1.0)
            if not self._task_event_buffer:
                continue
            batch, self._task_event_buffer = self._task_event_buffer, []
            try:
                gcs = self.client_pool.get(*self.gcs_address)
                await gcs.call_oneway("report_task_events", batch)
            except Exception:
                pass  # events are best-effort observability

    def _register_handlers(self):
        s = self.server
        # owner services
        s.register("get_object", self._handle_get_object)
        s.register("get_object_locations", self._handle_get_object_locations)
        s.register("add_object_location", self._handle_add_object_location)
        s.register("wait_object", self._handle_wait_object)
        s.register("decref", self._handle_decref)
        # borrower protocol (reference: reference_counter.h:44)
        s.register("register_borrower", self._handle_register_borrower)
        s.register("unregister_borrower", self._handle_unregister_borrower)
        s.register("check_borrow", self._handle_check_borrow)
        # streaming generator item delivery (reference:
        # ReportGeneratorItemReturns RPC, core_worker.proto:507)
        s.register("report_generator_item", self._handle_report_generator_item)
        # borrower-triggered lineage recovery (reference:
        # object_recovery_manager.h:41 — owner re-executes the creating task)
        s.register("reconstruct_object", self._handle_reconstruct_object)
        # executor services
        s.register("push_task", self._handle_push_task)
        s.register("create_actor", self._handle_create_actor)
        s.register("actor_task", self._handle_actor_task)
        s.register("exit_worker", self._handle_exit_worker)
        s.register("ping", self._handle_ping)
        # split-brain fence fan-out from this worker's raylet
        s.register("set_fenced", self._handle_set_fenced)
        # raylet-initiated recall of a cached worker lease (resource
        # pressure / TTL backstop)
        s.register("revoke_lease", self._handle_revoke_lease)
        # device objects (reference: RDT / GPU object manager, P13)
        from ...experimental import device_objects

        s.register("fetch_device_object", device_objects.handle_fetch)
        s.register("free_device_object", device_objects.handle_free)

    async def connect_to_raylet(self):
        raylet = self.client_pool.get(*self.raylet_address)
        reply = await raylet.call(
            "register_worker", self.worker_id, self.address, os.getpid(),
            os.environ.get("RAY_TPU_ENV_KEY", ""),
        )
        self.node_id = reply["node_id"]
        # tag outgoing RPCs with this node's identity so directional chaos
        # partition rules (src=<node-hex>) can match this worker's traffic
        self.client_pool.set_chaos_src(self.node_id.hex())
        return reply

    async def register_driver_job(self, metadata: dict) -> JobID:
        gcs = self.client_pool.get(*self.gcs_address)
        self.job_id = await gcs.call("register_job", metadata)
        self._current_task_id = TaskID.of(self.job_id)
        return self.job_id

    async def shutdown(self):
        if self.mode == WorkerMode.DRIVER and not self.job_id.is_nil():
            try:
                gcs = self.client_pool.get(*self.gcs_address)
                await gcs.call("finish_job", self.job_id, timeout=5.0)
            except Exception:
                pass
        try:
            await asyncio.wait_for(self._flush_lease_cache(), timeout=5.0)
        except Exception:
            pass
        if self._event_flush_task:
            self._event_flush_task.cancel()
        for task in list(self._reconciler_tasks):
            task.cancel()
        for task in list(self._borrower_probe_tasks.values()):
            task.cancel()
        if self._subscriber:
            await self._subscriber.close()
        await self.server.stop()
        await self.client_pool.close_all()
        self.store_client.close()
        self._executor_pool.shutdown(wait=False)

    # ------------------------------------------------------------------
    # reference counting (owner side; reference: reference_counter.h)
    # ------------------------------------------------------------------

    def register_ref(self, ref: ObjectRef):
        new_borrow = False
        with self._ref_lock:
            self._local_refs[ref.id] += 1
            # a deserialized ref owned elsewhere makes this process a
            # borrower: tell the owner so it defers the free until we drop
            # our last local ref (reference: borrower registration on
            # deserialize, reference_counter.h:44)
            if (
                ref.owner_address is not None
                and self.address is not None
                and not self._is_self(ref.owner_address)
                and ref.id not in self._owned
                and ref.id not in self._borrowed_owner
            ):
                self._borrowed_owner[ref.id] = tuple(ref.owner_address)
                new_borrow = True
        if new_borrow and not self.loop.is_closed():
            try:
                self.loop.call_soon_threadsafe(
                    self._send_borrow_rpc, "register_borrower",
                    tuple(ref.owner_address), ref.id,
                )
            except RuntimeError:
                pass

    def _send_borrow_rpc(self, method: str, owner_addr, object_id: ObjectID,
                         borrower_addr=None):
        """Fire-and-forget borrower-protocol RPC (loop thread only).
        borrower_addr defaults to this process; pass another worker's
        address to register a THIRD party (reply-borne forwarding)."""
        try:
            client = self.client_pool.get(*owner_addr)
            self._bg.spawn(
                client.call_oneway(
                    method, object_id, borrower_addr or self.address
                )
            )
        except Exception:
            pass

    def unregister_ref(self, ref: ObjectRef):
        """Called from ObjectRef.__del__ — possibly on any thread."""
        with self._ref_lock:
            self._local_refs[ref.id] -= 1
            should_check = self._local_refs[ref.id] <= 0
        if should_check and not self.loop.is_closed():
            try:
                self.loop.call_soon_threadsafe(self._maybe_free, ref.id)
            except RuntimeError:
                pass

    def _maybe_free(self, object_id: ObjectID):
        with self._ref_lock:
            if (
                self._local_refs.get(object_id, 0) > 0
                or self._submitted_refs.get(object_id, 0) > 0
            ):
                return
            owned = object_id in self._owned
            if owned and self._borrowers.get(object_id):
                # remote borrowers still hold the ref: defer the free and
                # keep ownership state; the unregister handler (or the
                # liveness probe pruning a dead borrower) re-runs this
                self._ensure_borrower_probe(object_id)
                return
            self._local_refs.pop(object_id, None)
            self._submitted_refs.pop(object_id, None)
            self._owned.discard(object_id)
            self._borrowers.pop(object_id, None)
            borrowed_from = self._borrowed_owner.pop(object_id, None)
        if borrowed_from is not None and not owned:
            # we were a borrower: release our registration with the owner
            self._send_borrow_rpc(
                "unregister_borrower", borrowed_from, object_id
            )
        if not owned:
            return
        entry = self.memory_store.delete(object_id)
        if entry is not None and entry.in_plasma and entry.locations:
            for node_address in entry.locations:
                try:
                    client = self.client_pool.get(*node_address)
                    asyncio.ensure_future(client.call_oneway("free_objects", [object_id]))
                except Exception:
                    pass
        # out-of-scope object needs no lineage; releasing its arg pins may
        # cascade-free upstream objects whose only consumer this lineage was
        self._lineage.pop(object_id, None)
        pins = self._lineage_arg_pins.pop(object_id, None)
        if pins:
            self._release_for_task(pins)

    def _pin_task_args(self, spec: TaskSpec) -> List[ObjectID]:
        """Pin a task's by-ref args until the call completes. Without this a
        GC'd submitter-side ObjectRef can free the arg out of the memory
        store before the executor fetches it and the call hangs (reference:
        ReferenceCounter submitted-task references, reference_counter.h:44).
        Pair with _release_for_task when the task reaches a terminal state."""
        arg_ids = [a.object_id for a in spec.args if a.object_id is not None]
        self._retain_for_task(arg_ids)
        return arg_ids

    def _retain_for_task(self, object_ids: List[ObjectID]):
        with self._ref_lock:
            for oid in object_ids:
                self._submitted_refs[oid] += 1

    def _release_for_task(self, object_ids: List[ObjectID]):
        with self._ref_lock:
            for oid in object_ids:
                self._submitted_refs[oid] -= 1
        for oid in object_ids:
            self._maybe_free(oid)

    # ------------------------------------------------------------------
    # put / get / wait
    # ------------------------------------------------------------------

    def next_put_id(self) -> ObjectID:
        self._put_index += 1
        return ObjectID.for_put(self._current_task_id, self._put_index)

    async def put(self, value: Any, object_id: Optional[ObjectID] = None) -> ObjectID:
        meta, bufs = serialization.serialize(value)
        object_id, _ = await self.put_serialized(meta, bufs, object_id)
        return object_id

    async def put_serialized(
        self,
        meta: bytes,
        bufs,
        object_id: Optional[ObjectID] = None,
        force_plasma: bool = False,
    ):
        """Put an already-serialized value; returns (object_id, packed size).
        Split out of put() so the weight plane can serialize once, learn the
        exact chunk size for its manifest, and store without re-serializing.
        ``force_plasma`` routes even small values through the shared store —
        weight chunks must be node-shareable (and peer-pullable) regardless
        of size."""
        object_id = object_id or self.next_put_id()
        size = serialization.packed_size(meta, bufs)
        self._owned.add(object_id)
        if not force_plasma and size <= self.config.max_direct_call_object_size:
            packed = bytearray(size)
            serialization.pack_into(meta, bufs, memoryview(packed))
            self.memory_store.put_value(object_id, bytes(packed))
        else:
            await self._put_plasma(object_id, meta, bufs, size, primary=True)
        return object_id, size

    async def _put_plasma(self, object_id, meta, bufs, size, primary: bool):
        raylet = self.client_pool.get(*self.raylet_address)
        reply = await raylet.call("store_create", object_id, size)
        if not reply["ok"]:
            raise ObjectLostError(object_id, reply.get("error", "store create failed"))
        self.store_client.write(reply["segment"], meta, bufs, size)
        await raylet.call("store_seal", object_id, primary)
        self.memory_store.put_plasma(object_id, size, self.raylet_address)

    async def get_objects(
        self, refs: List[ObjectRef], timeout: Optional[float] = None
    ) -> List[Any]:
        deadline = time.monotonic() + timeout if timeout is not None else None
        results = await asyncio.gather(
            *[self._get_one(ref, deadline) for ref in refs]
        )
        return list(results)

    async def _get_one(self, ref: ObjectRef, deadline: Optional[float]):
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GetTimeoutError(f"get timed out on {ref}")
            entry = self.memory_store.get_if_exists(ref.id)
            if entry is not None and entry.is_available():
                return await self._materialize(ref, entry)
            if ref.id in self._owned or self._is_self(ref.owner_address):
                entry = await self.memory_store.wait_available(
                    ref.id, timeout=remaining
                )
                if entry is None:
                    raise GetTimeoutError(f"get timed out on {ref}")
                return await self._materialize(ref, entry)
            # borrowed ref: ask the owner
            value = await self._get_from_owner(ref, remaining)
            if value is not _PENDING:
                return value
            await asyncio.sleep(0.01)

    def _is_self(self, address) -> bool:
        return address is not None and tuple(address) == tuple(self.address or ())

    # ------------------------------------------------------------------
    # lineage reconstruction (reference: object_recovery_manager.h:41)
    # ------------------------------------------------------------------

    async def _reconstruct_object(self, object_id: ObjectID) -> bool:
        """Re-execute the task that created ``object_id`` to rebuild its lost
        value, bounded by the task's max_retries. Concurrent requests for any
        return of the same task share one re-execution. Transitively-lost
        args recover through the same path: the re-executed task's arg fetch
        fails on its executor, which asks this owner to reconstruct them."""
        spec = self._lineage.get(object_id)
        if spec is None:
            return False
        existing = self._reconstructing.get(spec.task_id)
        if existing is not None:
            return await asyncio.shield(existing)
        budget = self._reconstruct_budget.setdefault(
            spec.task_id, max(spec.max_retries, 1)
        )
        if budget <= 0:
            return False
        self._reconstruct_budget[spec.task_id] = budget - 1
        fut: asyncio.Future = self.loop.create_future()
        self._reconstructing[spec.task_id] = fut
        try:
            logger.warning(
                "reconstructing object %s by re-executing task %s (%s)",
                object_id, spec.task_id, spec.function.qualname,
            )
            for oid in spec.return_object_ids():
                self.memory_store.reset_pending(oid)
            done = asyncio.Event()
            self._task_done_events[spec.task_id] = done
            self._launch_task(spec)
            await done.wait()
            entry = self.memory_store.get_if_exists(object_id)
            ok = (
                entry is not None
                and entry.is_available()
                and entry.error is None
            )
            fut.set_result(ok)
            return ok
        except Exception:
            logger.exception("reconstruction of %s failed", object_id)
            if not fut.done():
                fut.set_result(False)
            return False
        finally:
            self._reconstructing.pop(spec.task_id, None)
            if not fut.done():
                fut.set_result(False)

    async def _handle_reconstruct_object(self, object_id: ObjectID) -> bool:
        """Borrower-triggered recovery: only the owner holds lineage."""
        return await self._reconstruct_object(object_id)

    async def _materialize(self, ref: ObjectRef, entry) -> Any:
        if entry.error is not None:
            raise serialization.unpack(entry.error)
        if entry.value is not None:
            return serialization.unpack(entry.value)
        if entry.in_plasma:
            return await self._read_plasma(ref, entry.size)
        raise ObjectLostError(ref.id, "entry empty")

    async def _read_plasma(self, ref: ObjectRef, size: int, prefer_source=None):
        raylet = self.client_pool.get(*self.raylet_address)
        owner_addr = ref.owner_address if not self._is_self(ref.owner_address) else (
            self.address
        )
        attempts = 0
        while True:
            reply = await raylet.call(
                "store_get", ref.id, owner_addr, None, prefer_source,
                timeout=self.config.rpc_call_timeout_s,
            )
            if reply["ok"]:
                break
            # every copy is gone (node death, unspilled eviction): try
            # lineage reconstruction — re-execute the creating task
            # (reference: ObjectRecoveryManager, object_recovery_manager.h:41)
            recovered = False
            if attempts < 3:
                if ref.id in self._owned or self._is_self(ref.owner_address):
                    recovered = await self._reconstruct_object(ref.id)
                elif ref.owner_address is not None:
                    # borrower: only the owner holds the lineage spec
                    try:
                        recovered = await self.client_pool.get(
                            *ref.owner_address
                        ).call("reconstruct_object", ref.id)
                    except Exception:
                        # transient owner RPC failure (likely riding out the
                        # same node-death event): back off and retry instead
                        # of declaring a reconstructable object lost
                        attempts += 1
                        await asyncio.sleep(0.5)
                        continue
            if not recovered:
                raise ObjectLostError(ref.id, "object not found in any store")
            attempts += 1
            # a nondeterministic re-execution may return a small value
            # inline instead of via plasma
            entry = self.memory_store.get_if_exists(ref.id)
            if entry is not None and entry.value is not None:
                return serialization.unpack(entry.value)
        if reply.get("data") is not None:
            # spilled object served inline (arena full of pinned readers):
            # plain copy, no pin to manage
            return serialization.unpack(reply["data"])
        view = self.store_client.read(reply["segment"], reply["size"])
        # the pin must outlive every zero-copy array aliasing the mapping:
        # the arena store reuses blocks in place after eviction/spill, so an
        # early release would let a live numpy view silently change contents
        object_id = ref.id
        loop = self.loop
        client_pool = self.client_pool
        raylet_address = self.raylet_address

        def _release_pin():
            try:
                if loop.is_closed():
                    return
                loop.call_soon_threadsafe(
                    lambda: asyncio.ensure_future(
                        client_pool.get(*raylet_address).call_oneway(
                            "store_release", object_id
                        )
                    )
                )
            except RuntimeError:
                pass  # interpreter/loop teardown

        return serialization.unpack_with_release(view, _release_pin)

    async def _get_from_owner(self, ref: ObjectRef, timeout: Optional[float]):
        owner = self.client_pool.get(*ref.owner_address)
        try:
            reply = await owner.call(
                "get_object", ref.id, min(timeout, 10.0) if timeout else 10.0
            )
        except RpcError:
            raise ObjectLostError(ref.id, "owner died") from None
        if reply.get("pending"):
            return _PENDING
        if "error" in reply:
            raise serialization.unpack(reply["error"])
        if "value" in reply:
            # cache small values locally to skip future owner RPCs
            self.memory_store.put_value(ref.id, reply["value"])
            return serialization.unpack(reply["value"])
        if "plasma" in reply:
            self.memory_store.put_plasma(ref.id, reply["plasma"], None)
            entry = self.memory_store.get_if_exists(ref.id)
            return await self._read_plasma(ref, entry.size)
        raise ObjectLostError(ref.id, f"owner reply malformed: {reply}")

    async def wait(
        self,
        refs: List[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
        fetch_local: bool = True,
    ):
        pending = {ref: asyncio.ensure_future(self._wait_one(ref)) for ref in refs}
        ready: List[ObjectRef] = []
        deadline = time.monotonic() + timeout if timeout is not None else None
        while len(ready) < num_returns and pending:
            remaining = None
            if deadline is not None:
                remaining = max(deadline - time.monotonic(), 0)
                if remaining == 0:
                    break
            done, _ = await asyncio.wait(
                pending.values(),
                timeout=remaining,
                return_when=asyncio.FIRST_COMPLETED,
            )
            if not done:
                break
            for ref in list(pending):
                if pending[ref].done():
                    pending.pop(ref)
                    ready.append(ref)
        for fut in pending.values():
            fut.cancel()
        not_ready = [r for r in refs if r not in ready]
        # preserve input order
        ready_sorted = [r for r in refs if r in ready][:num_returns]
        not_ready += [r for r in refs if r in ready and r not in ready_sorted]
        return ready_sorted, [r for r in refs if r not in ready_sorted]

    async def _wait_one(self, ref: ObjectRef):
        if ref.id in self._owned or self._is_self(ref.owner_address):
            await self.memory_store.wait_available(ref.id, timeout=None)
            return
        owner = self.client_pool.get(*ref.owner_address)
        while True:
            reply = await owner.call("wait_object", ref.id, 10.0)
            if reply:
                return

    def as_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(
            self._get_one(ref, None), self.loop
        )

    # ------------------------------------------------------------------
    # owner service handlers
    # ------------------------------------------------------------------

    async def _handle_get_object(self, object_id: ObjectID, timeout: float):
        entry = await self.memory_store.wait_available(object_id, timeout=timeout)
        if entry is None or not entry.is_available():
            return {"pending": True}
        if entry.error is not None:
            return {"error": entry.error}
        if entry.value is not None:
            return {"value": entry.value}
        return {"plasma": entry.size, "locations": entry.locations}

    async def _handle_get_object_locations(self, object_id: ObjectID):
        entry = self.memory_store.get_if_exists(object_id)
        if entry is None:
            return []
        return list(entry.locations)

    async def _handle_add_object_location(self, object_id: ObjectID, node_address):
        self.memory_store.add_location(object_id, tuple(node_address))
        return True

    async def _handle_wait_object(self, object_id: ObjectID, timeout: float):
        entry = await self.memory_store.wait_available(object_id, timeout=timeout)
        return entry is not None and entry.is_available()

    async def _handle_decref(self, object_id: ObjectID):
        self._maybe_free(object_id)
        return True

    # -- borrower protocol (owner side) ------------------------------------

    async def _handle_register_borrower(self, object_id: ObjectID, addr):
        with self._ref_lock:
            if object_id in self._owned:
                self._borrowers[object_id].add(tuple(addr))
                return True
        # already freed: the borrower's get will miss and fall back to
        # lineage reconstruction if available
        return False

    async def _handle_unregister_borrower(self, object_id: ObjectID, addr):
        with self._ref_lock:
            holders = self._borrowers.get(object_id)
            if holders is not None:
                holders.discard(tuple(addr))
                empty = not holders
            else:
                empty = False
        if empty:
            self._maybe_free(object_id)
        return True

    async def _handle_check_borrow(self, object_id: ObjectID) -> bool:
        """Liveness probe from an owner: does this process still hold a
        local reference to the borrowed id? (the long-poll analogue of
        WaitForRefRemoved, crash-tolerant because the OWNER polls)"""
        with self._ref_lock:
            return object_id in self._borrowed_owner

    def _ensure_borrower_probe(self, object_id: ObjectID):
        """While a free is deferred on borrowers, periodically verify each
        borrower is alive and still holding; prune dead ones so a crashed
        borrower can never pin an object forever."""
        if object_id in self._borrower_probe_tasks:
            return
        task = asyncio.ensure_future(self._probe_borrowers(object_id))
        self._borrower_probe_tasks[object_id] = task

    _BORROWER_PROBE_MISSES = 3

    async def _probe_borrowers(self, object_id: ObjectID):
        # a borrower is pruned only after N CONSECUTIVE failed probes — one
        # timed-out RPC (long GC pause, transient connection break) must not
        # free an object a live borrower still holds
        misses: Dict[tuple, int] = {}
        try:
            while True:
                await asyncio.sleep(self.config.borrower_probe_interval_s)
                with self._ref_lock:
                    addrs = list(self._borrowers.get(object_id, ()))
                if not addrs:
                    break
                for addr in addrs:
                    holding = False
                    try:
                        holding = await self.client_pool.get(*addr).call(
                            "check_borrow", object_id, timeout=5.0
                        )
                    except Exception:  # dead/unreachable borrower
                        holding = False
                    key = tuple(addr)
                    if holding:
                        misses.pop(key, None)
                        continue
                    misses[key] = misses.get(key, 0) + 1
                    if misses[key] >= self._BORROWER_PROBE_MISSES:
                        with self._ref_lock:
                            holders = self._borrowers.get(object_id)
                            if holders is not None:
                                holders.discard(key)
                with self._ref_lock:
                    empty = not self._borrowers.get(object_id)
                if empty:
                    self._maybe_free(object_id)
                    break
        finally:
            self._borrower_probe_tasks.pop(object_id, None)

    async def _handle_ping(self):
        return {"worker_id": self.worker_id}

    async def _handle_set_fenced(self, fenced: bool, node_id: str = "",
                                 reason: str = ""):
        """Raylet fan-out of the split-brain fence: replica admission and
        collective abort checks in this process read the flag locally."""
        from ...util import fencing

        fencing.set_fenced(fenced, node_id, reason)
        return True

    # ------------------------------------------------------------------
    # task submission (reference: normal_task_submitter.h)
    # ------------------------------------------------------------------

    def next_task_id(self) -> TaskID:
        self._task_index += 1
        return TaskID.of(self.job_id)

    async def submit_task(self, spec: TaskSpec) -> List[ObjectID]:
        """Register the pending task and launch the async submission pipeline.
        Return object ids are immediately valid futures in the memory store."""
        return self._launch_task(spec)

    def _launch_task(self, spec: TaskSpec) -> List[ObjectID]:
        """Bookkeeping + pipeline launch, shared by first submission and
        lineage re-execution (_reconstruct_object)."""
        return_ids = spec.return_object_ids()
        for oid in return_ids:
            self._owned.add(oid)
            self.memory_store.entry(oid)  # create pending entry
        if spec.is_streaming_generator:
            self._streams[spec.task_id] = _StreamState()
        self._pending_tasks[spec.task_id] = spec
        arg_ids = self._pin_task_args(spec)
        self.record_task_event(
            spec.task_id,
            state="PENDING",
            name=spec.function.qualname,
            type="NORMAL_TASK",
            job_id=spec.job_id.hex(),
        )
        asyncio.ensure_future(self._submit_pipeline(spec, arg_ids))
        return return_ids

    async def _submit_pipeline(self, spec: TaskSpec, arg_ids: List[ObjectID]):
        try:
            await self._resolve_dependencies(spec)
            attempts = spec.max_retries + 1
            last_error: Optional[Exception] = None
            for attempt in range(max(attempts, 1)):
                try:
                    done = await self._submit_once(spec, attempt)
                    if done:
                        return
                except TaskUnschedulableError:
                    raise  # no retry makes a missing device appear
                except Exception as e:  # noqa: BLE001
                    last_error = e
                    logger.warning(
                        "task %s attempt %d failed: %s", spec.task_id, attempt, e
                    )
                await asyncio.sleep(self.config.task_retry_delay_s * (attempt + 1))
            err = last_error or WorkerCrashedError(
                f"task {spec.task_id} failed after {attempts} attempts"
            )
            self._fail_task(spec, err, attempt=attempts - 1)
        except Exception as e:  # noqa: BLE001
            self._fail_task(spec, e)
        finally:
            self._release_for_task(arg_ids)
            self._pending_tasks.pop(spec.task_id, None)
            ev = self._task_done_events.pop(spec.task_id, None)
            if ev:
                ev.set()

    async def _resolve_dependencies(self, spec: TaskSpec):
        """Inline small owned args once available (reference:
        LocalDependencyResolver)."""
        for arg in spec.args:
            if arg.object_id is None or getattr(arg, "nested", False):
                continue
            if self._is_self(arg.owner_address) or arg.object_id in self._owned:
                entry = await self.memory_store.wait_available(arg.object_id, None)
                if entry.error is not None:
                    raise serialization.unpack(entry.error)
                if entry.value is not None:
                    arg.value = entry.value
                    arg.object_id = None
                    arg.owner_address = None
                # plasma-resident args stay by-reference

    async def _submit_once(self, spec: TaskSpec, attempt: int) -> bool:
        """One lease + push attempt. Returns True when the task reached a
        terminal state (success or non-retriable failure).

        With lease reuse on, the lease comes from the per-scheduling-class
        cache when a warm one exists (zero lease RPCs), and on success goes
        back into the cache instead of being returned — the steady-state
        cost of a same-shape task stream is one push_task RPC per task."""
        cache_key = self._lease_cache_key(spec)
        grant = self._take_cached_lease(cache_key)
        from_cache = grant is not None
        if grant is None:
            grant = await self._acquire_lease(
                spec, reusable=cache_key is not None
            )
        while True:
            try:
                worker = self.client_pool.get(*grant["worker_address"])
                reply: TaskReply = await worker.call(
                    "push_task", spec, attempt,
                    grant.get("instances", {}).get("GPU", []), timeout=None
                )
                break
            except RpcError as e:
                self._bg.spawn(self._return_lease(grant, worker_failed=True))
                if from_cache:
                    # stale cached lease (worker died or was revoked under
                    # us): not the task's fault — re-acquire fresh without
                    # burning a retry attempt
                    from_cache = False
                    grant = await self._acquire_lease(
                        spec, reusable=cache_key is not None
                    )
                    continue
                raise WorkerCrashedError(str(e)) from None
        # the worker is idle again (push_task replies after execution): park
        # the lease for the next same-class task unless peers of this class
        # are already queued at the raylet — then hand the worker back so the
        # raylet's FIFO (which may include other owners) gets it now
        if cache_key is not None and not self._lease_waiters.get(cache_key):
            self._park_lease(cache_key, grant)
        else:
            self._bg.spawn(self._return_lease(grant, worker_failed=False))
        if reply.error is not None:
            # the failed executor may still have stashed an arg ref — even
            # one that will be retried elsewhere keeps its borrow
            self._register_reply_borrowers(reply)
            if reply.retriable_failure and attempt < spec.max_retries:
                return False
            err_obj = serialization.unpack(reply.error)
            if not isinstance(err_obj, Exception):
                err_obj = TaskError(spec.function.qualname, str(err_obj))
            if spec.retry_exceptions and attempt < spec.max_retries:
                return False
            self._fail_task(spec, err_obj, attempt=attempt)
            return True
        self._process_reply(spec, reply, attempt=attempt)
        return True

    # -- lease cache (reference: per-SchedulingKey worker lease reuse in
    # normal_task_submitter.h; the owner side of the lease TTL protocol) ----

    def _lease_cache_key(self, spec: TaskSpec) -> Optional[tuple]:
        """Cache key for reusable leases, or None when this spec's lease
        must not be reused (strategy pins placement decisions per task)."""
        if not self.config.lease_reuse_enabled:
            return None
        if type(spec.scheduling_strategy) is not DefaultSchedulingStrategy:
            return None
        from ..._internal.runtime_env import env_key

        return (spec.scheduling_class(), env_key(spec.runtime_env))

    def _take_cached_lease(self, cache_key: Optional[tuple]) -> Optional[dict]:
        if cache_key is None:
            return None
        grants = self._lease_cache.get(cache_key)
        if not grants:
            return None
        grant = grants.pop()  # LIFO: warmest worker first
        if not grants:
            del self._lease_cache[cache_key]
        return grant

    def _park_lease(self, cache_key: tuple, grant: dict):
        grant["parked_at"] = time.monotonic()
        self._lease_cache.setdefault(cache_key, []).append(grant)
        if self._lease_reaper_task is None or self._lease_reaper_task.done():
            self._lease_reaper_task = asyncio.ensure_future(
                self._reap_idle_leases()
            )

    async def _reap_idle_leases(self):
        """Return cached leases that sat idle past worker_lease_idle_ttl_s;
        exits when the cache drains (restarted on the next park)."""
        ttl = max(self.config.worker_lease_idle_ttl_s, 0.02)
        while self._lease_cache:
            await asyncio.sleep(ttl / 2)
            now = time.monotonic()
            for key, grants in list(self._lease_cache.items()):
                keep = [g for g in grants if now - g["parked_at"] < ttl]
                for g in grants:
                    if now - g["parked_at"] >= ttl:
                        self._bg.spawn(self._return_lease(g, False))
                if keep:
                    self._lease_cache[key] = keep
                else:
                    self._lease_cache.pop(key, None)

    async def _return_lease(self, grant: dict, worker_failed: bool):
        try:
            raylet = self.client_pool.get(*grant["raylet_address"])
            await raylet.call(
                "return_worker", grant["lease_id"], worker_failed,
                timeout=self.config.rpc_call_timeout_s,
            )
        except Exception:
            pass

    async def _handle_revoke_lease(self, lease_id) -> bool:
        """Raylet recalls a lease (resource pressure / TTL backstop): release
        it if it is sitting idle in the cache; answer False when it is in
        use (or already gone) — the raylet treats that as a renewal."""
        for key, grants in list(self._lease_cache.items()):
            for g in grants:
                if g["lease_id"] == lease_id:
                    grants.remove(g)
                    if not grants:
                        self._lease_cache.pop(key, None)
                    await self._return_lease(g, False)
                    return True
        return False

    async def _flush_lease_cache(self):
        """Shutdown path: hand every cached lease back to its raylet."""
        if self._lease_reaper_task is not None:
            self._lease_reaper_task.cancel()
        grants = [g for gs in self._lease_cache.values() for g in gs]
        self._lease_cache.clear()
        if grants:
            await asyncio.gather(
                *[self._return_lease(g, False) for g in grants],
                return_exceptions=True,
            )

    async def _acquire_lease(self, spec: TaskSpec, reusable: bool = False) -> dict:
        """Request a worker lease, following spillback redirects (reference:
        RequestNewWorkerIfNeeded + spillback handling)."""
        target = self.raylet_address
        if isinstance(spec.scheduling_strategy, PlacementGroupSchedulingStrategy):
            bundle_node = await self._bundle_node_address(spec.scheduling_strategy)
            if bundle_node is not None:
                target = bundle_node
        spillbacks = 0
        infeasible_warned = False
        cache_key = self._lease_cache_key(spec) if reusable else None
        if cache_key is not None:
            self._lease_waiters[cache_key] += 1
        try:
            return await self._acquire_lease_loop(
                spec, target, spillbacks, infeasible_warned, reusable
            )
        finally:
            if cache_key is not None:
                self._lease_waiters[cache_key] -= 1
                if self._lease_waiters[cache_key] <= 0:
                    self._lease_waiters.pop(cache_key, None)

    async def _acquire_lease_loop(
        self, spec: TaskSpec, target, spillbacks, infeasible_warned, reusable
    ) -> dict:
        while True:
            raylet = self.client_pool.get(*target)
            if tuple(target) != tuple(self.raylet_address):
                # A spillback redirect can point at a raylet that just
                # died (the redirecting raylet's cluster view is stale).
                # Probe reachability with a short bound instead of paying
                # the full connect-retry window and burning a task retry
                # attempt; the local raylet re-routes once its view
                # catches up.
                try:
                    await asyncio.wait_for(
                        raylet._ensure_connected(), _LEASE_CONNECT_PROBE_S
                    )
                except Exception:
                    logger.debug(
                        "lease for %s: spillback target %s unreachable, "
                        "returning to local raylet", spec.task_id, target,
                    )
                    target = self.raylet_address
                    await asyncio.sleep(0.5)
                    continue
            reply = await raylet.call(
                "request_worker_lease", spec, reusable, timeout=None
            )
            if reply.get("granted"):
                reply["raylet_address"] = target
                return reply
            if "spillback" in reply:
                spillbacks += 1
                if spillbacks > self.config.max_lease_spillback:
                    raise WorkerCrashedError(
                        f"lease for {spec.task_id} spilled back too many times"
                    )
                _, target = reply["spillback"]
                continue
            if reply.get("unschedulable"):
                raise TaskUnschedulableError(spec.function.qualname, reply["unschedulable"])
            if reply.get("infeasible"):
                if not infeasible_warned:
                    logger.warning(
                        "task %s is infeasible: %s — waiting for cluster to change",
                        spec.task_id, reply.get("reason"),
                    )
                    infeasible_warned = True
                await asyncio.sleep(1.0)
                continue
            # transient rejection (e.g. no worker): brief backoff then retry
            await asyncio.sleep(0.05)

    async def _bundle_node_address(self, strategy: PlacementGroupSchedulingStrategy):
        gcs = self.client_pool.get(*self.gcs_address)
        for _ in range(600):
            info = await gcs.call("get_placement_group", strategy.placement_group_id)
            if info is None:
                raise ValueError(
                    f"placement group {strategy.placement_group_id} does not exist"
                )
            bundles = info.bundles
            if strategy.bundle_index >= 0:
                bundles = [info.bundles[strategy.bundle_index]]
            for bundle in bundles:
                if bundle.node_id is not None:
                    node = await self._node_address(bundle.node_id)
                    if node is not None:
                        return node
            await asyncio.sleep(0.1)
        return None

    async def _node_address(self, node_id: NodeID):
        gcs = self.client_pool.get(*self.gcs_address)
        nodes = await gcs.call("get_all_nodes")
        for n in nodes:
            if n.node_id == node_id and n.alive:
                return n.address
        return None

    def _register_reply_borrowers(self, reply: TaskReply):
        """Register the executor as a borrower of args it kept, BEFORE the
        submitted-task pins release (callers guarantee ordering), so an arg
        stashed in actor state survives the owner dropping its own handle
        (reference: reply-borne borrower accounting, reference_counter.h:44).
        Ids this process does not own are forwarded to their true owner —
        a submitter that is itself only a borrower must not swallow them."""
        if not reply.borrowed_refs:
            return
        addr, held = reply.borrowed_refs
        forward = []
        with self._ref_lock:
            for oid in held:
                if oid in self._owned:
                    self._borrowers[oid].add(tuple(addr))
                else:
                    owner_addr = self._borrowed_owner.get(oid)
                    if owner_addr is not None:
                        forward.append((owner_addr, oid))
        for owner_addr, oid in forward:
            self._send_borrow_rpc(
                "register_borrower", owner_addr, oid, borrower_addr=addr
            )

    def _process_reply(self, spec: TaskSpec, reply: TaskReply, attempt: int = 0):
        self._register_reply_borrowers(reply)
        for ret in reply.returns:
            if ret.value is not None:
                self.memory_store.put_value(ret.object_id, ret.value)
            elif ret.in_plasma:
                node_addr = ret.node_id
                self.memory_store.put_plasma(ret.object_id, ret.size, node_addr)
        if (
            spec.task_type == TaskType.NORMAL_TASK
            and spec.max_retries > 0
            and not spec.is_streaming_generator
        ):
            for ret in reply.returns:
                if ret.in_plasma and ret.object_id not in self._lineage:
                    self._lineage[ret.object_id] = spec
                    arg_ids = [
                        a.object_id for a in spec.args if a.object_id is not None
                    ]
                    if arg_ids:
                        self._lineage_arg_pins[ret.object_id] = arg_ids
                        self._retain_for_task(arg_ids)
        if reply.num_streamed is not None:
            state = self._streams.get(spec.task_id)
            if state is not None:
                state.total = reply.num_streamed
                state.pulse()
        self.record_task_event(spec.task_id, state="FINISHED", attempt=attempt)

    def _fail_task(self, spec: TaskSpec, error: Exception, attempt: int = 0):
        packed = serialization.pack(error)
        for oid in spec.return_object_ids():
            self.memory_store.put_error(oid, packed)
        stream = self._streams.get(spec.task_id)
        if stream is not None:
            stream.error = packed
            stream.pulse()
        self.record_task_event(
            spec.task_id, state="FAILED", error=type(error).__name__,
            attempt=attempt,
        )

    # -- streaming generators (owner side) ---------------------------------

    async def _handle_report_generator_item(
        self, task_id: TaskID, index: int, value: Optional[bytes],
        size: int = 0, in_plasma: bool = False, node_addr=None,
    ):
        object_id = ObjectID.for_task_return(task_id, index)
        if value is not None:
            self.memory_store.put_value(object_id, value)
        else:
            self.memory_store.put_plasma(object_id, size, node_addr)
        self._owned.add(object_id)
        state = self._streams.get(task_id)
        if state is not None:
            state.reported.add(index)
            state.pulse()
            return True
        # stream already dropped/terminated (state is created at submit
        # time, so None means the consumer abandoned it): free the item
        # we just stored, or a still-producing generator pins every
        # remaining yield for the process lifetime. _maybe_free respects
        # live ObjectRefs, so re-reports of already-read items survive.
        # False tells the executor nobody is listening — it closes the
        # user generator instead of producing items into the void.
        self._maybe_free(object_id)
        return False

    async def next_stream_item(self, task_id: TaskID) -> Optional[ObjectRef]:
        """Next ObjectRef of a streaming task, in yield order; None at
        end-of-stream (reference: TryReadObjectRefStream, core_worker.h:306).
        Items already yielded remain readable even if the task later fails —
        the error surfaces when reading PAST the last delivered item."""
        state = self._streams.get(task_id)
        if state is None:
            return None
        while True:
            if state.next_read in state.reported:
                i = state.next_read
                state.next_read += 1
                return ObjectRef(
                    ObjectID.for_task_return(task_id, i), self.address
                )
            if state.error is not None:
                # terminal: drop the stream so an abandoned/failed stream
                # doesn't pin its state for the process lifetime
                self._streams.pop(task_id, None)
                self._free_unread_stream_items(task_id, state)
                raise serialization.unpack(state.error)
            if state.total is not None and state.next_read >= state.total:
                self._streams.pop(task_id, None)
                return None
            state.event.clear()
            await state.event.wait()

    def drop_stream(self, task_id: TaskID):
        """Consumer abandoned the generator: release owner-side stream
        bookkeeping (called from ObjectRefGenerator.__del__)."""
        state = self._streams.pop(task_id, None)
        if state is not None:
            self._free_unread_stream_items(task_id, state)

    def _free_unread_stream_items(self, task_id: TaskID, state: "_StreamState"):
        """Indices reported but never read have no ObjectRef driving their
        refcount: free them explicitly, or an abandoned/failed half-consumed
        stream pins its objects for the process lifetime."""
        for index in state.reported:
            if index >= state.next_read:
                self._maybe_free(ObjectID.for_task_return(task_id, index))

    # ------------------------------------------------------------------
    # actor submission (reference: actor_task_submitter.h)
    # ------------------------------------------------------------------

    async def create_actor(self, spec: TaskSpec, detached: bool) -> ActorID:
        state = _ActorClientState(spec.actor_id)
        state.creation_arg_pins = self._pin_task_args(spec)
        self._actors[spec.actor_id] = state
        await self._subscriber.subscribe(
            gcs_keys.ACTOR_CHANNEL.key(spec.actor_id.hex()), self._on_actor_update
        )
        gcs = self.client_pool.get(*self.gcs_address)
        info: ActorInfo = await gcs.call("register_actor", spec, detached)
        state.state = info.state
        state.incarnation = getattr(info, "num_restarts", 0)
        if info.address:
            state.address = info.address
        return spec.actor_id

    def attach_actor(self, actor_id: ActorID, info: Optional[ActorInfo] = None):
        """Track an actor this process did not create (get_actor / handle
        deserialization)."""
        if actor_id in self._actors:
            return
        state = _ActorClientState(actor_id)
        if info is not None:
            state.state = info.state
            state.address = info.address
            state.death_cause = info.death_cause
            state.incarnation = getattr(info, "num_restarts", 0)
        self._actors[actor_id] = state

        async def _sub():
            await self._subscriber.subscribe(
                gcs_keys.ACTOR_CHANNEL.key(actor_id.hex()), self._on_actor_update
            )
            # re-fetch after subscribing to close the startup race
            gcs = self.client_pool.get(*self.gcs_address)
            latest = await gcs.call("get_actor", actor_id)
            if latest is not None:
                self._apply_actor_info(latest)

        asyncio.ensure_future(_sub())

    def _on_actor_update(self, channel, info: ActorInfo):
        self._apply_actor_info(info)

    def _apply_actor_info(self, info: ActorInfo):
        state = self._actors.get(info.actor_id)
        if state is None:
            return
        incarnation = getattr(info, "num_restarts", 0)
        if info.state != ActorState.DEAD:
            # Staleness guard: a get_actor snapshot can race a fresher pubsub
            # update (the awaited RPC returns state captured before the edge
            # was published). Applying the stale RESTARTING over a newer
            # ALIVE clears state.address with no later pubsub edge to undo
            # it, parking calls forever. GCS state is ordered by
            # (num_restarts, aliveness); never go backwards. DEAD is
            # terminal and always applies.
            stale = incarnation < state.incarnation or (
                incarnation == state.incarnation
                and info.state != ActorState.ALIVE
                and state.state == ActorState.ALIVE
                and state.address is not None
            )
            if stale:
                return
        state.state = info.state
        state.death_cause = info.death_cause
        if info.state == ActorState.DEAD and state.creation_arg_pins:
            # terminal: no restart will re-run __init__, creation args may go
            pins, state.creation_arg_pins = state.creation_arg_pins, None
            self._release_for_task(pins)
        if info.state == ActorState.ALIVE and info.address is not None:
            state.address = info.address
            # New incarnation ONLY: the executor's per-caller sequence
            # counters died with its process, so renumber the parked queue
            # from 0 in FIFO order. A repeated ALIVE for the same
            # incarnation (pubsub + get_actor race) must NOT renumber —
            # calls already delivered under this numbering would collide.
            if incarnation != state.incarnation:
                state.incarnation = incarnation
                for i, (spec, _fut) in enumerate(state.queue):
                    spec.sequence_number = i
                    spec.sequence_incarnation = incarnation
                    state.unresolved[_fut] = (incarnation, i)
                state.seq = len(state.queue)
            asyncio.ensure_future(self._flush_actor_queue(state))
        elif info.state == ActorState.DEAD:
            state.address = None
            while state.queue:
                spec, fut = state.queue.popleft()
                if not fut.done():
                    fut.set_exception(
                        ActorDiedError(info.actor_id, state.death_cause or "dead")
                    )
        else:
            state.address = None

    async def _flush_actor_queue(self, state: _ActorClientState):
        while state.queue and state.address is not None:
            spec, fut = state.queue.popleft()
            asyncio.ensure_future(self._push_actor_task(state, spec, fut))

    def _ensure_actor_reconciler(self, state: _ActorClientState):
        """Poll GCS while calls sit parked: pubsub is the fast path for
        actor-state edges, but a dropped or raced ALIVE edge must not
        strand the queue forever (reference: actor_task_submitter.h's
        fallback resolution through the GCS client). The staleness guard
        in _apply_actor_info makes re-applying snapshots safe."""
        if state.reconciling:
            return
        state.reconciling = True

        async def _reconcile():
            delay = 0.5
            try:
                while (
                    state.queue
                    and state.address is None
                    and state.state != ActorState.DEAD
                ):
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 5.0)
                    try:
                        gcs = self.client_pool.get(*self.gcs_address)
                        info = await gcs.call("get_actor", state.actor_id)
                    except Exception:
                        continue
                    if info is not None:
                        self._apply_actor_info(info)
            except asyncio.CancelledError:
                pass
            finally:
                state.reconciling = False

        task = asyncio.ensure_future(_reconcile())
        self._reconciler_tasks.add(task)
        task.add_done_callback(self._reconciler_tasks.discard)

    async def submit_actor_task(self, spec: TaskSpec) -> List[ObjectID]:
        state = self._actors.get(spec.actor_id)
        if state is None:
            self.attach_actor(spec.actor_id)
            state = self._actors[spec.actor_id]
        return_ids = spec.return_object_ids()
        for oid in return_ids:
            self._owned.add(oid)
            self.memory_store.entry(oid)
        if spec.is_streaming_generator:
            # actor streaming generators share the task-side stream machinery
            # (reference: actor.py:516-548 — same ObjectRefGenerator surface);
            # item delivery and end-of-stream reporting are caller-agnostic
            self._streams[spec.task_id] = _StreamState()
        arg_ids = self._pin_task_args(spec)
        spec.sequence_number = state.seq
        spec.sequence_incarnation = state.incarnation
        state.seq += 1
        fut: asyncio.Future = self.loop.create_future()
        state.unresolved[fut] = (
            spec.sequence_incarnation, spec.sequence_number
        )
        fut.add_done_callback(lambda f: state.unresolved.pop(f, None))
        if state.state == ActorState.DEAD:
            fut.set_exception(ActorDiedError(spec.actor_id, state.death_cause))
        elif state.address is None:
            state.queue.append((spec, fut))
            self._ensure_actor_reconciler(state)
        else:
            asyncio.ensure_future(self._push_actor_task(state, spec, fut))
        asyncio.ensure_future(self._finish_actor_task(spec, fut, arg_ids))
        return return_ids

    async def _push_actor_task(self, state, spec: TaskSpec, fut: asyncio.Future):
        # Re-read the address HERE, not at scheduling time: this coroutine is
        # ensure_future-ed while the actor looks ALIVE, but a death report
        # can land before it runs, clearing state.address. Dereferencing the
        # stale None raised TypeError (not RpcError), killed this task, and
        # orphaned ``fut`` — the call then hung forever (the exact chaos-test
        # failure mode: kill #2 racing the restart flush of kill #1).
        addr = state.address
        if addr is None:
            if state.state == ActorState.DEAD:
                if not fut.done():
                    fut.set_exception(
                        ActorDiedError(spec.actor_id, state.death_cause or "dead")
                    )
            else:
                state.queue.append((spec, fut))
                self._ensure_actor_reconciler(state)
            return
        try:
            # stamp at SEND time (not submit): resolutions between submit
            # and a recover-resend must lift the watermark with them
            cur = spec.sequence_incarnation
            spec.sequence_watermark = min(
                (s for f, (inc, s) in state.unresolved.items()
                 if inc == cur and not f.done()),
                default=spec.sequence_number,
            )
            worker = self.client_pool.get(*addr)
            reply = await worker.call("actor_task", spec, timeout=None)
            if not fut.done():
                fut.set_result(reply)
        except RpcError:
            try:
                await self._recover_actor_push(state, spec, fut)
            except Exception as e:  # noqa: BLE001 — never orphan the future
                if not fut.done():
                    fut.set_exception(e)
        except Exception as e:  # noqa: BLE001 — never orphan the call future:
            # an unexpected error here would leave the caller's get() hanging
            if not fut.done():
                fut.set_exception(e)

    async def _recover_actor_push(
        self, state, spec: TaskSpec, fut: asyncio.Future
    ):
        """Connection to the actor's worker failed: consult GCS, then retry,
        park, or fail the call (reference: actor_task_submitter.h's
        DisconnectRpcClient -> resolve-actor-state flow)."""
        # actor may be restarting: check authoritative state
        gcs = self.client_pool.get(*self.gcs_address)
        try:
            info = await gcs.call("get_actor", spec.actor_id)
        except Exception:
            info = None
        if info is not None and info.state in (
            ActorState.RESTARTING,
            ActorState.PENDING_CREATION,
            ActorState.ALIVE,
        ):
            if self._actor_retries_allowed(spec):
                self._apply_actor_info(info)
                alive_now = (
                    state.state == ActorState.ALIVE
                    and state.address is not None
                )
                if (
                    alive_now
                    and spec.sequence_incarnation == state.incarnation
                ):
                    # same incarnation the seq was issued under and the
                    # executor lives: resend the ORIGINAL seq — the
                    # client can't know whether the lost call executed.
                    # Never executed -> runs in order; executed with the
                    # reply lost -> the executor dedups by seq (see
                    # _handle_actor_task). Backoff first: when GCS has
                    # not yet observed the worker's death it still
                    # reports ALIVE at the old address, and an immediate
                    # resend spins connect-fail cycles that burn the
                    # whole max_task_retries budget in milliseconds —
                    # faster than any death report can land.
                    await asyncio.sleep(0.2)
                    asyncio.ensure_future(
                        self._push_actor_task(state, spec, fut)
                    )
                elif alive_now:
                    # issued under a DEAD incarnation, and the new
                    # executor's numbering is already live (its renumber
                    # pass happened before this failure surfaced): take
                    # a fresh seq in the current generation
                    spec.sequence_number = state.seq
                    spec.sequence_incarnation = state.incarnation
                    state.seq += 1
                    state.unresolved[fut] = (
                        spec.sequence_incarnation, spec.sequence_number
                    )
                    asyncio.ensure_future(
                        self._push_actor_task(state, spec, fut)
                    )
                else:
                    # restart in progress: park IN SUBMISSION ORDER — later
                    # calls may have parked directly while this one was in
                    # flight, and the ALIVE renumber pass stamps fresh seqs
                    # front-to-back, so a tail append would execute the
                    # recovered call out of order
                    key = (spec.sequence_incarnation, spec.sequence_number)
                    q = state.queue
                    idx = len(q)
                    for i, (parked_spec, _) in enumerate(q):
                        if (
                            parked_spec.sequence_incarnation,
                            parked_spec.sequence_number,
                        ) > key:
                            idx = i
                            break
                    q.insert(idx, (spec, fut))
                    self._ensure_actor_reconciler(state)
                return
        if info is not None:
            # apply even (especially) a DEAD snapshot: keeping a stale ALIVE
            # address would make every later submit push to the dead address
            # and pay a GCS round-trip per call; applying flips the fast-fail
            # DEAD path on and records the real death cause
            self._apply_actor_info(info)
        if not fut.done():
            fut.set_exception(
                ActorDiedError(
                    spec.actor_id, state.death_cause or "connection lost"
                )
            )

    def _actor_retries_allowed(self, spec: TaskSpec) -> bool:
        if spec.max_task_retries == 0:
            return False
        if spec.max_task_retries > 0:
            spec.max_task_retries -= 1
        return True

    async def _finish_actor_task(
        self, spec: TaskSpec, fut: asyncio.Future, arg_ids: List[ObjectID]
    ):
        # borrower registration must precede the pin release (the finally) or
        # the free could race an executor-stashed arg ref; the finally also
        # guarantees the release when reply post-processing itself raises
        # (e.g. an error payload whose exception class can't unpickle here)
        try:
            try:
                reply: TaskReply = await fut
            except Exception as e:  # noqa: BLE001
                self._fail_task(spec, e)
                return
            try:
                if reply.error is not None:
                    # a method can stash an arg ref and THEN raise: the
                    # error reply still carries the borrow piggyback
                    self._register_reply_borrowers(reply)
                    err = serialization.unpack(reply.error)
                    if not isinstance(err, Exception):
                        err = TaskError(spec.function.qualname, str(err))
                    self._fail_task(spec, err)
                else:
                    self._process_reply(spec, reply)
            except Exception as e:  # noqa: BLE001 — malformed reply
                self._fail_task(spec, e)
        finally:
            self._release_for_task(arg_ids)

    async def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        gcs = self.client_pool.get(*self.gcs_address)
        await gcs.call("kill_actor", actor_id, no_restart)
        if no_restart:
            # The GCS has marked the actor DEAD before replying, but the
            # caller's local view is updated by an async pubsub edge — a
            # submission issued right after kill() returns can race the
            # SIGKILL to the still-running executor and succeed. Apply DEAD
            # locally now so post-kill calls fail deterministically (the
            # pubsub edge that follows is terminal and idempotent).
            state = self._actors.get(actor_id)
            if state is not None:
                state.state = ActorState.DEAD
                state.death_cause = "killed via kill()"
                state.address = None
                while state.queue:
                    _spec, fut = state.queue.popleft()
                    if not fut.done():
                        fut.set_exception(
                            ActorDiedError(actor_id, state.death_cause)
                        )

    # ------------------------------------------------------------------
    # execution side (reference: task_execution/, task_receiver.h)
    # ------------------------------------------------------------------

    async def _load_function(self, descriptor: FunctionDescriptor):
        fn = self._function_cache.get(descriptor.function_hash)
        if fn is None:
            gcs = self.client_pool.get(*self.gcs_address)
            raw = await gcs.call(
                "kv_get", gcs_keys.FUNCTION.key(descriptor.function_hash)
            )
            if raw is None:
                raise TaskError(
                    descriptor.qualname, "function definition not found in GCS"
                )
            fn = serialization.loads(raw)
            self._function_cache[descriptor.function_hash] = fn
        return fn

    async def _handle_push_task(self, spec: TaskSpec, attempt: int = 0,
                                gpu_ids=()) -> TaskReply:
        """Execute a normal task, on the card its lease names, and reply
        with its returns."""
        try:
            await self._bind_lease(gpu_ids)
        except Exception as e:  # noqa: BLE001
            return self._error_reply(spec, e)
        prev_task = self._current_task_id
        self._current_task_id = spec.task_id
        self.record_task_event(
            spec.task_id, state="RUNNING", attempt=attempt,
            node_id=self.node_id.hex() if self.node_id else "",
            worker_pid=os.getpid(),
        )
        try:
            fn = await self._load_function(spec.function)
            args, kwargs = await self._unflatten(spec)
            if spec.is_streaming_generator:
                coro = self._run_streaming_generator(fn, args, kwargs, spec)
                args = kwargs = None  # this frame outlives the stream
                return await coro
            try:
                result = await self._run_user_code(fn, args, kwargs, spec)
            except Exception as e:  # noqa: BLE001
                return self._error_reply(spec, e)
            # drop the execution frame's own holds on deserialized arg refs
            # BEFORE computing the reply's borrowed_refs: only refs user
            # code actually stashed should register as borrows
            args = kwargs = None
            return await self._build_reply(spec, result)
        except Exception as e:  # noqa: BLE001 — system error: retriable
            logger.exception("system error executing %s", spec.task_id)
            return TaskReply(
                task_id=spec.task_id,
                returns=[],
                error=serialization.pack(e),
                borrowed_refs=self._held_arg_refs(spec),
                retriable_failure=True,
            )
        finally:
            self._current_task_id = prev_task

    async def _unflatten(self, spec: TaskSpec) -> tuple:
        """Reconstruct (args, kwargs): TaskArg[0] carries the pickled
        structure with _ArgPlaceholder markers; the rest are by-ref values."""
        from ..._internal.args import ArgPlaceholder, reconstruct

        structure = serialization.unpack(spec.args[0].value)
        resolved = []
        for arg in spec.args[1:]:
            if getattr(arg, "nested", False):
                continue  # pin-only entry; the ref lives in the structure
            if arg.value is not None:
                resolved.append(serialization.unpack(arg.value))
            else:
                ref = ObjectRef(arg.object_id, arg.owner_address, _register=False)
                resolved.append(await self._get_one(ref, None))
        return reconstruct(structure, resolved)

    async def _run_streaming_generator(
        self, fn, args, kwargs, spec: TaskSpec
    ) -> TaskReply:
        """Drive a user generator, shipping each yielded item to the owner
        as its own object as soon as it exists (reference: the streaming-
        generator execution path reporting via ReportGeneratorItemReturns).
        Items stream while the generator is still running — the consumer
        overlaps with production."""
        _SENTINEL = object()
        try:
            gen = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            return self._error_reply(spec, e)
        args = kwargs = None  # only gen (and user stashes) hold refs now
        if not hasattr(gen, "__next__") and not hasattr(gen, "__anext__"):
            return self._error_reply(
                spec,
                TypeError(
                    'num_returns="streaming" requires a generator function'
                ),
            )
        owner = self.client_pool.get(*spec.owner_address)
        count = 0
        while True:
            try:
                if hasattr(gen, "__anext__"):
                    try:
                        item = await gen.__anext__()
                    except StopAsyncIteration:
                        break
                else:
                    item = await self._run_traced(
                        lambda: next(gen, _SENTINEL)
                    )
                    if item is _SENTINEL:
                        break
            except Exception as e:  # noqa: BLE001 — generator raised mid-stream
                reply = self._error_reply(spec, e)
                reply.num_streamed = count
                return reply
            object_id = ObjectID.for_task_return(spec.task_id, count)
            meta, bufs = serialization.serialize(item)
            size = serialization.packed_size(meta, bufs)
            if size <= self.config.max_direct_call_object_size:
                packed = bytearray(size)
                serialization.pack_into(meta, bufs, memoryview(packed))
                consumer_alive = await owner.call(
                    "report_generator_item", spec.task_id, count,
                    bytes(packed), size, False, None,
                )
            else:
                await self._put_plasma(
                    object_id, meta, bufs, size, primary=True
                )
                consumer_alive = await owner.call(
                    "report_generator_item", spec.task_id, count,
                    None, size, True, self.raylet_address,
                )
            count += 1
            if consumer_alive is False:
                # the owner dropped the stream (consumer closed/abandoned
                # the ObjectRefGenerator — e.g. an HTTP client disconnected
                # mid-stream): stop driving and close the user generator so
                # its finally blocks run and it stops burning compute
                close = getattr(gen, "aclose", None) or getattr(
                    gen, "close", None
                )
                if close is not None:
                    try:
                        result = close()
                        if asyncio.iscoroutine(result):
                            await result
                    except Exception:  # noqa: BLE001
                        pass
                break
        # the exhausted generator's closure still pins the deserialized
        # args; drop it so borrowed_refs reflects only user-stashed refs
        del gen
        return TaskReply(
            task_id=spec.task_id, returns=[], error=None, num_streamed=count,
            borrowed_refs=self._held_arg_refs(spec),
        )

    def _run_traced(self, fn):
        """run_in_executor with the caller's contextvars copied across, on
        the card of this worker's lease: CUDA's current device is a
        thread's own, so each executor call sets it before user code runs."""
        ctx = contextvars.copy_context()
        idx = self._cuda_index
        if idx is not None:
            import torch

            inner = fn

            def fn():
                torch.cuda.set_device(idx)
                return inner()

        return self.loop.run_in_executor(self._executor_pool, ctx.run, fn)

    async def _bind_lease(self, gpu_ids) -> None:
        """Bind this worker to the card its lease names (the reference drops
        the lease's device ids, so every GPU worker of a host lands on card
        0). GPU ids bind ``torch.cuda`` to the first one, on this loop's
        thread (coroutine code) and, through ``_run_traced``, on every
        executor thread; no ids drop the binding, and torch is never
        imported for them. A lease naming a card that torch cannot see
        raises: a GPU demand never runs without its card."""
        gpu_ids = [int(i) for i in gpu_ids]
        if gpu_ids:
            from ..._internal.accelerators import cuda_index

            idx = cuda_index(gpu_ids[0])
            if idx != self._cuda_index:
                # the torch import and the card's context take seconds: off
                # this loop, which must keep answering the raylet's pings
                await self.loop.run_in_executor(None, _open_card, idx)
                import torch

                torch.cuda.set_device(idx)
            self._cuda_index = idx
        else:
            self._cuda_index = None
        self.gpu_ids = gpu_ids

    async def _run_user_code(self, fn, args, kwargs, spec: TaskSpec):
        if asyncio.iscoroutinefunction(fn):
            return await fn(*args, **kwargs)

        return await self._run_traced(lambda: fn(*args, **kwargs))

    def _error_reply(self, spec: TaskSpec, exc: Exception) -> TaskReply:
        err = TaskError.from_exception(spec.function.qualname, exc)
        try:
            packed = serialization.pack(err)
        except Exception:
            # unpicklable cause: ship the traceback text only
            err.cause = None
            packed = serialization.pack(err)
        return TaskReply(
            task_id=spec.task_id,
            returns=[],
            error=packed,
            borrowed_refs=self._held_arg_refs(spec),
            retriable_failure=False,
        )

    async def _build_reply(self, spec: TaskSpec, result) -> TaskReply:
        if spec.num_returns == 1:
            results = [result]
        elif spec.num_returns == 0:
            results = []
        else:
            results = list(result)
            if len(results) != spec.num_returns:
                return self._error_reply(
                    spec,
                    ValueError(
                        f"task returned {len(results)} values, expected "
                        f"{spec.num_returns}"
                    ),
                )
        returns = []
        for index, value in enumerate(results):
            object_id = ObjectID.for_task_return(spec.task_id, index)
            meta, bufs = serialization.serialize(value)
            size = serialization.packed_size(meta, bufs)
            if size <= self.config.max_direct_call_object_size:
                packed = bytearray(size)
                serialization.pack_into(meta, bufs, memoryview(packed))
                returns.append(
                    ReturnObject(object_id=object_id, value=bytes(packed), size=size)
                )
            else:
                await self._put_plasma(object_id, meta, bufs, size, primary=True)
                returns.append(
                    ReturnObject(
                        object_id=object_id,
                        in_plasma=True,
                        node_id=self.raylet_address,
                        size=size,
                    )
                )
        return TaskReply(
            task_id=spec.task_id, returns=returns, error=None,
            borrowed_refs=self._held_arg_refs(spec),
        )

    def _held_arg_refs(self, spec: TaskSpec) -> Optional[tuple]:
        """By-ref args this executor still holds at reply time (user code
        stashed the deserialized ObjectRef, e.g. in actor state)."""
        held = []
        with self._ref_lock:
            for a in spec.args:
                if (
                    a.object_id is not None
                    and self._local_refs.get(a.object_id, 0) > 0
                    and a.object_id in self._borrowed_owner
                ):
                    held.append(a.object_id)
        if not held:
            return None
        return (self.address, held)

    # -- actor execution ---------------------------------------------------

    async def _handle_create_actor(self, spec: TaskSpec, gpu_ids=()):
        try:
            await self._bind_lease(gpu_ids)
        except Exception as e:  # noqa: BLE001
            raise ActorUnschedulableError(str(e)) from None
        gcs = self.client_pool.get(*self.gcs_address)
        raw = await gcs.call(
            "kv_get", gcs_keys.FUNCTION.key(spec.function.function_hash)
        )
        if raw is None:
            raise RuntimeError("actor class not found in GCS function table")
        cls = serialization.loads(raw)
        args, kwargs = await self._unflatten(spec)
        if spec.max_concurrency > 1:
            self._executor_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=spec.max_concurrency
            )
        instance = await self._run_traced(lambda: cls(*args, **kwargs))
        self._actor_instance = instance
        self._actor_spec = spec
        return True

    def _release_runnable(self, caller) -> int:
        """Advance the caller's expected seq past watermark-abandoned holes
        (seqs the caller resolved without a resend — their sends were
        dropped mid-flight and will never arrive) and wake the parked task
        that becomes runnable, if any. Arrived tasks are never skipped:
        they sit in the inflight map until they reply."""
        expected = self._caller_expected_seq[caller]
        wm = self._caller_watermark[caller]
        inflight = self._caller_inflight[caller]
        while expected < wm and expected not in inflight:
            expected += 1
        self._caller_expected_seq[caller] = expected
        ev = self._caller_parked[caller].pop(expected, None)
        if ev is not None:
            ev.set()
        return expected

    async def _handle_actor_task(self, spec: TaskSpec) -> TaskReply:
        """Per-caller in-order execution (reference: ActorSchedulingQueue
        sequencing by client seq-no). A retried call arrives with its
        ORIGINAL seq (the client cannot know whether the lost RPC executed);
        stale seqs answer from the reply cache instead of re-executing."""
        caller = spec.owner_worker_id
        seq = spec.sequence_number
        inflight = self._caller_inflight[caller]
        existing = inflight.get(seq)
        if existing is not None:
            # duplicate delivery racing the ORIGINAL (connection died while
            # the call executes; the client resent): share its outcome —
            # re-executing here is the double-apply this dedup exists to
            # prevent. shield(): this duplicate's cancellation must not
            # cancel the original execution.
            return await asyncio.shield(existing)
        wm = getattr(spec, "sequence_watermark", 0)
        if wm > self._caller_watermark[caller]:
            self._caller_watermark[caller] = wm
        expected = self._release_runnable(caller)
        if seq < expected:
            # duplicate delivery after completion: reply was lost in flight
            # (reference: the dedup the executor does by seq-no). Serve the
            # cached reply.
            cached = self._caller_replies[caller].get(seq)
            if cached is not None:
                return cached[0]
            return self._error_reply(
                spec,
                RuntimeError(
                    f"duplicate actor task seq {seq} "
                    f"(expected {expected}) with evicted reply"
                ),
            )
        fut: asyncio.Future = self.loop.create_future()
        inflight[seq] = fut
        try:
            if seq != expected:
                # park until predecessors arrive
                parked = self._caller_parked[caller]
                ev = asyncio.Event()
                parked[seq] = ev
                await ev.wait()

            def _advance():
                # never rewind: with watermark skips in play, expected may
                # already be past seq + 1 when this task finishes
                if seq + 1 > self._caller_expected_seq[caller]:
                    self._caller_expected_seq[caller] = seq + 1
                self._release_runnable(caller)

            def _cache_reply(reply: TaskReply):
                size = sum(
                    len(r.value) if r.value is not None else 64
                    for r in reply.returns
                )
                replies = self._caller_replies[caller]
                replies[seq] = (reply, size)
                # bound by entries AND bytes: dedup only needs a short
                # window, not an unbounded payload pin. Never evict down to
                # zero: a single reply over the byte budget must stay
                # cached until the next one lands, or a duplicate delivery
                # after a lost reply gets "evicted reply" instead of the
                # result — breaking exactly-once precisely for
                # large-payload methods.
                total = sum(s for _r, s in replies.values())
                while len(replies) > 1 and (
                    len(replies) > 64 or total > 4 * 1024 * 1024
                ):
                    _k, (_r, s) = next(iter(replies.items()))
                    replies.pop(_k)
                    total -= s

            max_conc = (
                self._actor_spec.max_concurrency if self._actor_spec else 1
            )
            if max_conc > 1:
                # concurrent actor (reference: async/threaded actors via
                # OutOfOrderActorSchedulingQueue): ordering guarantees start
                # order only — release the next task as soon as this one
                # begins; a semaphore caps in-flight executions
                if self._actor_semaphore is None:
                    self._actor_semaphore = asyncio.Semaphore(max_conc)
                _advance()
                async with self._actor_semaphore:
                    reply = await self._execute_actor_task(spec)
                    _cache_reply(reply)
                    fut.set_result(reply)
                    return reply
            try:
                reply = await self._execute_actor_task(spec)
                _cache_reply(reply)
                fut.set_result(reply)
                return reply
            finally:
                _advance()
        finally:
            inflight.pop(seq, None)
            if not fut.done():
                # execution path failed before producing a reply: unblock
                # any duplicate awaiting the shared outcome
                fut.set_exception(
                    RuntimeError("actor task aborted before completion")
                )
                # the exception is consumed by duplicates if any; otherwise
                # mark it retrieved
                fut.exception()

    async def _execute_actor_task(self, spec: TaskSpec) -> TaskReply:
        if self._actor_instance is None:
            return self._error_reply(spec, RuntimeError("actor not initialized"))
        method = getattr(self._actor_instance, spec.function.qualname, None)
        if method is None:
            return self._error_reply(
                spec, AttributeError(f"actor has no method {spec.function.qualname}")
            )
        try:
            args, kwargs = await self._unflatten(spec)
        except Exception as e:  # noqa: BLE001
            return self._error_reply(spec, e)
        if spec.is_streaming_generator:
            # the bound method drives the same item-shipping loop as task
            # generators; the seq slot is held until the generator finishes,
            # preserving sequential actor semantics while the CONSUMER
            # overlaps via item-level delivery
            coro = self._run_streaming_generator(method, args, kwargs, spec)
            args = kwargs = None  # this frame outlives the stream
            return await coro
        # tensor_transport="device": DeviceObjectRef args resolve to their
        # on-device pytrees; results with tensors park in the device store
        # (reference: @ray.method(tensor_transport=...), P13). Resolution
        # runs on the executor thread: remote fetches block on RPCs that
        # this loop must keep servicing.
        method_opts = getattr(method, "__ray_tpu_method_options__", {})
        device_transport = method_opts.get("tensor_transport") == "device"
        if device_transport:
            from ...experimental import device_objects

            try:
                args, kwargs = await self._run_traced(
                    lambda: device_objects.resolve_args(
                        args, kwargs, to_device=self._cuda_index is not None)
                )
            except Exception as e:  # noqa: BLE001
                return self._error_reply(spec, e)
        max_conc = self._actor_spec.max_concurrency if self._actor_spec else 1
        try:
            if asyncio.iscoroutinefunction(method):
                result = await method(*args, **kwargs)
            elif max_conc > 1:
                result = await self._run_traced(
                    lambda: method(*args, **kwargs)
                )
            else:
                async with self._execution_lock:
                    result = await self._run_traced(
                        lambda: method(*args, **kwargs)
                    )
        except Exception as e:  # noqa: BLE001
            return self._error_reply(spec, e)
        if device_transport:
            from ...experimental import device_objects

            result = device_objects.wrap_result(result)
        # only user-stashed refs should survive into borrowed_refs
        args = kwargs = None
        return await self._build_reply(spec, result)

    async def _handle_exit_worker(self):
        self._exit_requested = True
        self.loop.call_later(0.05, os._exit, 0)
        return True


def _open_card(idx: int) -> None:
    """Import torch and create the context of card ``idx`` (on a thread of
    the caller's choosing); raises where torch sees no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"this worker's lease names card {idx}, but torch sees no CUDA device "
            "in this process")
    torch.cuda.set_device(idx)
    torch.cuda.init()


_PENDING = object()
