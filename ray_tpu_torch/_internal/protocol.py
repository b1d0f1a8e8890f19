"""Wire-level data types shared by every component.

Equivalent of the reference's protobuf message layer (src/ray/protobuf/*.proto
— TaskSpec in common.proto, actor/node/PG tables in gcs.proto). Python
dataclasses pickled by the RPC layer stand in for protobufs; the field names
deliberately mirror the reference messages so the mapping is auditable.

A copy of ``ray_tpu/_internal/protocol.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)

Address = Tuple[str, int]  # (host, port)


def label_match(labels: Dict[str, str], selector: Dict[str, Any]) -> bool:
    """Selector semantics: value may be a string (equality) or a list
    (membership) — reference: label_selector.h 'in' operators."""
    for key, want in selector.items():
        have = labels.get(key)
        if isinstance(want, (list, tuple, set)):
            if have not in want:
                return False
        elif have != want:
            return False
    return True


# ---------------------------------------------------------------------------
# Scheduling strategies (reference: util/scheduling_strategies.py)
# ---------------------------------------------------------------------------


@dataclass
class DefaultSchedulingStrategy:
    pass


@dataclass
class SpreadSchedulingStrategy:
    pass


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: NodeID = None
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group_id: PlacementGroupID = None
    bundle_index: int = -1
    capture_child_tasks: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    hard: Dict[str, List[str]] = field(default_factory=dict)
    soft: Dict[str, List[str]] = field(default_factory=dict)


SchedulingStrategy = Any  # union of the above


# ---------------------------------------------------------------------------
# Task / actor specs
# ---------------------------------------------------------------------------


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


@dataclass
class FunctionDescriptor:
    """Identifies a remote function/class; the pickled definition is shipped
    through the GCS function table once per job (reference: FunctionManager)."""

    module: str
    qualname: str
    function_hash: str  # key into the GCS function table


@dataclass
class TaskArg:
    """Either an inlined serialized value or an ObjectID reference."""

    object_id: Optional[ObjectID] = None
    value: Optional[bytes] = None  # packed serialization
    # owner address for by-reference args, so the executor can fetch/subscribe
    owner_address: Optional[Address] = None
    # nested-ref containment (reference: reference_counter.h:44 contained-in
    # accounting): a ref serialized INSIDE a container arg, listed here
    # pin-only so the owner keeps it alive while the task is in flight; the
    # executor resolves it from the pickled structure, not from this entry
    nested: bool = False


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function: FunctionDescriptor
    args: List[TaskArg]
    num_returns: int
    resources: Dict[str, float]
    # owner of the returned objects (= submitting worker)
    owner_worker_id: WorkerID = None
    owner_address: Address = None
    scheduling_strategy: SchedulingStrategy = field(
        default_factory=DefaultSchedulingStrategy
    )
    label_selector: Dict[str, str] = field(default_factory=dict)
    max_retries: int = 3
    retry_exceptions: bool = False
    # actor creation
    actor_id: Optional[ActorID] = None
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    namespace: str = ""
    actor_name: str = ""
    # actor call: position in the per-caller ordered stream, and which
    # restart generation that numbering belongs to (a retry must not carry
    # an old generation's seq to a fresh executor)
    sequence_number: int = 0
    sequence_incarnation: int = 0
    # lowest seq the caller has NOT yet resolved at send time: every seq
    # below it is done caller-side and will never be (re)sent, so the
    # executor may skip such a seq that never arrived (a send dropped by a
    # partition leaves a hole the in-order queue would otherwise wait on
    # forever)
    sequence_watermark: int = 0
    # placement group this task is bound to
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    # streaming generator support
    is_streaming_generator: bool = False
    runtime_env: Optional[Dict[str, Any]] = None
    # distributed tracing: the submitter's active span context
    # ({trace_id, span_id}), restored around execution so driver->task->
    # nested-task span chains link across processes (reference: the
    # OpenTelemetry context injected into task metadata by tracing_helper)
    trace_context: Optional[Dict[str, str]] = None

    def scheduling_class(self) -> tuple:
        """Tasks with identical resource shapes share a FIFO dispatch queue
        (reference: scheduling_class_util.h)."""
        return (
            tuple(sorted(self.resources.items())),
            tuple(sorted(self.label_selector.items())),
            self.placement_group_id,
        )

    def return_object_ids(self) -> List[ObjectID]:
        return [
            ObjectID.for_task_return(self.task_id, i) for i in range(self.num_returns)
        ]


# ---------------------------------------------------------------------------
# Node / resource state (reference: gcs.proto GcsNodeInfo, NodeResources)
# ---------------------------------------------------------------------------


@dataclass
class NodeInfo:
    node_id: NodeID
    address: Address  # raylet RPC address
    object_store_address: str  # shm segment name
    resources_total: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    is_head: bool = False
    start_time: float = field(default_factory=time.time)
    # TPU topology: slice name -> list of chip indices on this host
    tpu_slice_name: Optional[str] = None
    tpu_worker_id: Optional[int] = None


@dataclass
class WorkerInfo:
    worker_id: WorkerID
    node_id: NodeID
    address: Address  # worker RPC endpoint
    pid: int = 0


# ---------------------------------------------------------------------------
# Actor table (reference: gcs.proto ActorTableData)
# ---------------------------------------------------------------------------


class ActorState(enum.Enum):
    DEPENDENCIES_UNREADY = 0
    PENDING_CREATION = 1
    ALIVE = 2
    RESTARTING = 3
    DEAD = 4


@dataclass
class ActorInfo:
    actor_id: ActorID
    job_id: JobID
    name: str
    namespace: str
    state: ActorState
    address: Optional[Address] = None
    node_id: Optional[NodeID] = None
    worker_id: Optional[WorkerID] = None
    num_restarts: int = 0
    max_restarts: int = 0
    creation_spec: Optional[TaskSpec] = None
    death_cause: str = ""
    detached: bool = False
    owner_address: Optional[Address] = None


# ---------------------------------------------------------------------------
# Placement groups (reference: gcs.proto PlacementGroupTableData)
# ---------------------------------------------------------------------------


class PlacementStrategy(enum.Enum):
    PACK = 0
    SPREAD = 1
    STRICT_PACK = 2
    STRICT_SPREAD = 3


class PlacementGroupState(enum.Enum):
    PENDING = 0
    CREATED = 1
    REMOVED = 2
    RESCHEDULING = 3


@dataclass
class Bundle:
    bundle_index: int
    resources: Dict[str, float]
    label_selector: Dict[str, str] = field(default_factory=dict)
    node_id: Optional[NodeID] = None  # filled once committed


@dataclass
class PlacementGroupInfo:
    placement_group_id: PlacementGroupID
    name: str
    strategy: PlacementStrategy
    bundles: List[Bundle]
    state: PlacementGroupState = PlacementGroupState.PENDING
    creator_job_id: Optional[JobID] = None


# ---------------------------------------------------------------------------
# Task replies
# ---------------------------------------------------------------------------


@dataclass
class ReturnObject:
    object_id: ObjectID
    # inline value (small objects, reference: max_direct_call_object_size)
    value: Optional[bytes] = None
    # or: stored in the shm store of this node
    in_plasma: bool = False
    node_id: Optional[NodeID] = None
    size: int = 0


@dataclass
class TaskReply:
    task_id: TaskID
    returns: List[ReturnObject]
    error: Optional[bytes] = None  # packed TaskError
    # worker asks owner to retry (system failure, not user exception)
    retriable_failure: bool = False
    # streaming generator tasks: total items yielded (reference: the
    # end-of-stream accounting behind ObjectRefStream, task_manager.h:67)
    num_streamed: Optional[int] = None
    # borrower piggyback (reference: borrowed-refs accounting returned with
    # the task reply, reference_counter.h:44): (executor_address, [ids]) of
    # by-ref args the executor STILL holds at reply time (e.g. stashed in
    # actor state). The owner registers these borrowers before releasing its
    # submitted-task pins, closing the register-vs-unpin race.
    borrowed_refs: Optional[tuple] = None
