"""The exceptions the port raises: copies of ray_tpu/exceptions.py's.

Only the classes the ported paths raise are here, with the reference's
bases and messages, so that a caller catching ``ValueError`` around an
``LLMConfig`` or retrying on ``BackPressureError`` behaves the same against
either package (the port imports nothing of ray_tpu).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


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


class MeshValidationError(RayTpuError, ValueError):
    """A replica's parallelism config cannot map onto its devices or its
    model, e.g. an ``LLMConfig.mesh`` axis other than ``tp``/``sp`` or a
    size that is not a positive int. Raised at construction, before any
    weight is placed."""


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
