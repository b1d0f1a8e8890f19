"""The exceptions of the port: a copy of ray_tpu/exceptions.py.

The runtime's failures travel through object values: a failed task stores
its exception as the value of its returns, so ``get`` re-raises at the
caller with the remote traceback attached. The classes, bases and messages
are the reference's (``TaskUnschedulableError`` is the port's own), so
that a caller catching ``ValueError`` around an ``LLMConfig`` or retrying
on ``BackPressureError`` behaves the same against either package (the port
imports nothing of ray_tpu).
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    Stored as the value of all of the task's return objects; re-raised by
    ``get`` at the caller (reference: exceptions.py RayTaskError which wraps
    the cause and remote traceback).
    """

    def __init__(self, function_name: str, traceback_str: str, cause: Exception | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"Task {function_name} failed:\n{traceback_str}")

    @classmethod
    def from_exception(cls, function_name: str, exc: Exception) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, tb, exc)

    def __reduce__(self):
        # custom __init__ signature needs explicit reconstruction args; the
        # cause travels too so callers can except the original type
        return (_rebuild_task_error, (self.function_name, self.traceback_str, self.cause))


def _rebuild_task_error(function_name, traceback_str, cause):
    return TaskError(function_name, traceback_str, cause)


class ActorError(RayTpuError):
    """Base for actor-related failures."""


class ActorDiedError(ActorError):
    """The actor died before or while executing the task (reference:
    exceptions.py RayActorError)."""

    def __init__(self, actor_id=None, reason: str = "actor died"):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id} unavailable: {reason}")

    def __reduce__(self):
        return (type(self), (self.actor_id, self.reason))


class ActorUnschedulableError(ActorError):
    pass


class TaskUnschedulableError(RayTpuError):
    """A task demands a device resource (``GPU``) that no node of the
    cluster has (reference: ray.exceptions.TaskUnschedulableError). The
    port has no autoscaler to add such a node, so the task fails at once,
    never runs without the device, and is not retried; ``ray_tpu`` leaves
    such a task waiting."""

    def __init__(self, function_name: str = "", reason: str = ""):
        self.function_name = function_name
        self.reason = reason
        super().__init__(f"task {function_name} is unschedulable: {reason}")

    def __reduce__(self):
        return (type(self), (self.function_name, self.reason))


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died (reference:
    exceptions.py WorkerCrashedError). Retriable."""


class NodeDiedError(RayTpuError):
    pass


class ObjectLostError(RayTpuError):
    """Object's value was lost (all copies gone / owner died) and could not be
    reconstructed from lineage (reference: exceptions.py ObjectLostError)."""

    def __init__(self, object_id=None, reason: str = "object lost"):
        self.object_id = object_id
        self.reason = reason
        super().__init__(f"Object {object_id} lost: {reason}")

    def __reduce__(self):
        return (type(self), (self.object_id, self.reason))


class OwnerDiedError(ObjectLostError):
    pass


class ObjectStoreFullError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")

    def __reduce__(self):
        return (type(self), (self.task_id,))


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupSchedulingError(RayTpuError):
    pass


class CollectiveAbortedError(RayTpuError):
    """An in-flight collective op was aborted because a group member died
    (or the group was explicitly aborted). Retryable: the gang re-forms at a
    new group epoch and the caller re-enters the op from its last published
    training state."""

    def __init__(self, group_name: str = "", epoch: int = 0,
                 reason: str = "group member died"):
        self.group_name = group_name
        self.epoch = epoch
        self.reason = reason
        super().__init__(
            f"collective group {group_name!r} epoch {epoch} aborted: {reason}"
        )

    def __reduce__(self):
        return (type(self), (self.group_name, self.epoch, self.reason))


class BackPressureError(RayTpuError):
    """A replica refused a request because its admission queue is full
    (reference: serve/exceptions.py BackPressureError). Raised fast, before
    the request is accepted, so callers get a typed 503-style rejection in
    milliseconds instead of a 60 s timeout pileup. Retryable on another
    replica."""

    def __init__(self, replica_id: str = "", ongoing: int = 0,
                 queued: int = 0, retry_after_s: float = 0.1):
        self.replica_id = replica_id
        self.ongoing = ongoing
        self.queued = queued
        self.retry_after_s = retry_after_s
        super().__init__(
            f"replica {replica_id!r} shed request: {ongoing} ongoing, "
            f"{queued} queued (queue cap reached); retry after "
            f"{retry_after_s}s"
        )

    def __reduce__(self):
        return (type(self), (self.replica_id, self.ongoing, self.queued,
                             self.retry_after_s))


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's end-to-end deadline passed. Raised by the replica for
    dead-on-arrival work (deadline already expired when the request was
    admitted) and by the handle when the retry budget runs out. Not
    retryable: the caller has already stopped waiting."""

    def __init__(self, deployment: str = "", elapsed_s: float = 0.0,
                 timeout_s: float = 0.0, where: str = "replica"):
        self.deployment = deployment
        self.elapsed_s = elapsed_s
        self.timeout_s = timeout_s
        self.where = where
        super().__init__(
            f"request to {deployment!r} exceeded its {timeout_s}s deadline "
            f"({elapsed_s:.3f}s elapsed, detected at {where})"
        )

    def __reduce__(self):
        return (type(self), (self.deployment, self.elapsed_s,
                             self.timeout_s, self.where))


class ReplicaDrainingError(RayTpuError):
    """The target replica is DRAINING and no longer admits new requests
    (the routing table was stale). Retryable: the handle force-refreshes
    and resubmits to a replica that is still RUNNING."""

    def __init__(self, replica_id: str = ""):
        self.replica_id = replica_id
        super().__init__(
            f"replica {replica_id!r} is draining and rejects new requests"
        )

    def __reduce__(self):
        return (type(self), (self.replica_id,))


class NodeFencedError(RayTpuError):
    """The node is fenced: its raylet lost contact with the GCS for longer
    than the liveness window and stopped granting leases / admitting serve
    work, so the cluster's view (which may have replaced this node's
    actors/replicas elsewhere) cannot split-brain against local execution.
    Retryable: the handle fails over to a replica on a healthy node, and the
    node unfences itself when GCS contact resumes."""

    def __init__(self, node_id: str = "", reason: str = "gcs unreachable"):
        self.node_id = node_id
        self.reason = reason
        super().__init__(
            f"node {node_id!r} is fenced ({reason}); rejecting new work"
        )

    def __reduce__(self):
        return (type(self), (self.node_id, self.reason))


class MeshValidationError(RayTpuError, ValueError):
    """A replica's parallelism config cannot map onto its devices or its
    model, e.g. an ``LLMConfig.mesh`` axis other than ``tp``/``sp`` or a
    size that is not a positive int. Raised at construction, before any
    weight is placed."""


class RpcError(RayTpuError):
    """Transport-level RPC failure."""


class PendingCallsLimitExceeded(RayTpuError):
    pass
