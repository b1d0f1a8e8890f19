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
