"""Unique identifiers for cluster entities.

Equivalent in spirit to the reference's binary ID types (src/ray/common/id.h):
JobID, TaskID, ObjectID(ObjectRef), ActorID, NodeID, WorkerID, PlacementGroupID.
We keep the same derivation property the reference has — object ids are derived
from the id of the task that creates them plus a return-index — so ownership and
lineage can be reconstructed from an id alone.

Representation: raw bytes wrapped in small value types; hex for display.

A copy of ``ray_tpu/_internal/ids.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import os

_NIL = b"\x00"


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = id_bytes

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(_NIL * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == _NIL * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class UniqueID(BaseID):
    SIZE = 16


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(cls.SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._bytes, "little")


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    """Actor id embeds the job id in its last 4 bytes."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE :])


class PlacementGroupID(BaseID):
    SIZE = 16


class TaskID(BaseID):
    """Task id; embeds job id like the reference so lineage is traceable."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "TaskID":
        return cls(os.urandom(cls.SIZE - JobID.SIZE) + job_id.binary())

    @classmethod
    def for_actor_task(cls, job_id: JobID, actor_id: ActorID, seq: int) -> "TaskID":
        head = actor_id.binary()[:8] + seq.to_bytes(4, "little")
        return cls(head + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE :])


class ObjectID(BaseID):
    """Object id = task id + 4-byte return index (reference: id.h ObjectID).

    Derivability lets any process recover "which task produced this object"
    for lineage reconstruction without a directory lookup.
    """

    SIZE = TaskID.SIZE + 4

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # puts use the high bit of the index to avoid colliding with returns
        return cls(task_id.binary() + (put_index | 0x8000_0000).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[TaskID.SIZE :], "little") & 0x7FFF_FFFF

    def is_put(self) -> bool:
        return bool(int.from_bytes(self._bytes[TaskID.SIZE :], "little") & 0x8000_0000)
