"""OOM defense: system memory monitor + worker-killing policy.

Role-equivalent of the reference's MemoryMonitor (src/ray/common/
memory_monitor.h:52) and the worker-killing policies
(src/ray/raylet/worker_killing_policy.h:33,
worker_killing_policy_group_by_owner.h:87): the raylet polls system (or
cgroup) memory; above the usage threshold it kills the leased worker whose
loss is cheapest — retriable tasks first, grouped by submitting owner so a
fan-out caller loses one of many tasks rather than a lone task dying, and
the most recently started task within the group (least progress lost).

A copy of ``ray_tpu/runtime/raylet/memory_monitor.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger(__name__)

_CGROUP_V2 = "/sys/fs/cgroup"
_PROC_MEMINFO = "/proc/meminfo"


class MemoryMonitor:
    """Reads used/total memory from cgroup v2 limits when the process runs
    inside a limited cgroup, else from /proc/meminfo (reference:
    memory_monitor.cc GetMemoryBytes with the same cgroup-first order).

    ``usage_fn`` injects a fake reading for tests (reference: the fake
    memory monitors under src/mock)."""

    def __init__(
        self,
        usage_threshold: float = 0.95,
        min_memory_free_bytes: int = -1,
        usage_fn: Optional[Callable[[], Tuple[int, int]]] = None,
    ):
        self.usage_threshold = usage_threshold
        self.min_memory_free_bytes = min_memory_free_bytes
        self._usage_fn = usage_fn or self.system_memory

    @staticmethod
    def _cgroup_memory() -> Optional[Tuple[int, int]]:
        cur, maxf = (
            os.path.join(_CGROUP_V2, "memory.current"),
            os.path.join(_CGROUP_V2, "memory.max"),
        )
        try:
            with open(maxf) as f:
                raw = f.read().strip()
            if raw == "max":  # unlimited cgroup: fall through to meminfo
                return None
            total = int(raw)
            with open(cur) as f:
                used = int(f.read().strip())
            # memory.current counts reclaimable page cache; subtract the
            # inactive file cache so file-heavy workloads (e.g. the spill
            # path) don't read as pressure (reference: memory_monitor.cc
            # subtracts inactive_file for exactly this reason)
            try:
                with open(os.path.join(_CGROUP_V2, "memory.stat")) as f:
                    for line in f:
                        if line.startswith("inactive_file "):
                            used = max(used - int(line.split()[1]), 0)
                            break
            except (OSError, ValueError):
                pass
            return used, total
        except (OSError, ValueError):
            return None

    @staticmethod
    def _meminfo_memory() -> Tuple[int, int]:
        total = available = 0
        with open(_PROC_MEMINFO) as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    available = int(line.split()[1]) * 1024
        return total - available, total

    @classmethod
    def system_memory(cls) -> Tuple[int, int]:
        """(used_bytes, total_bytes), cgroup-limited when applicable."""
        return cls._cgroup_memory() or cls._meminfo_memory()

    def usage(self) -> Tuple[int, int]:
        return self._usage_fn()

    def is_over_threshold(self) -> bool:
        used, total = self.usage()
        if total <= 0:
            return False
        threshold_bytes = total * self.usage_threshold
        if self.min_memory_free_bytes >= 0:
            # reference: min_memory_free_bytes overrides the fraction when
            # it implies an earlier trigger on huge-memory hosts
            threshold_bytes = min(
                threshold_bytes, total - self.min_memory_free_bytes
            )
        return used > threshold_bytes


@dataclass
class KillCandidate:
    """One leased worker the policy may choose to kill."""

    lease_id: object
    worker_id: object
    pid: int
    owner_id: object  # submitting worker (task owner)
    retriable: bool
    started_at: float = field(default_factory=time.time)


class GroupByOwnerWorkerKillingPolicy:
    """reference: GroupByOwnerIdWorkerKillingPolicy
    (worker_killing_policy_group_by_owner.h:87). Selection order:

    1. retriable tasks before non-retriable (a retried task re-runs; a
       non-retriable one surfaces an error to the user),
    2. within the same retriability, the task whose owner has the MOST
       running tasks on this node (a fan-out loses 1/N of its work),
    3. within the group, the last-started task (least progress lost).
    """

    def select(self, candidates: List[KillCandidate]) -> Optional[KillCandidate]:
        if not candidates:
            return None
        group_sizes: dict = {}
        for c in candidates:
            key = (c.retriable, c.owner_id)
            group_sizes[key] = group_sizes.get(key, 0) + 1
        return max(
            candidates,
            key=lambda c: (
                c.retriable,
                group_sizes[(c.retriable, c.owner_id)],
                c.started_at,
            ),
        )


class RetriableLIFOWorkerKillingPolicy:
    """reference: the default RetriableLIFOWorkerKillingPolicy
    (worker_killing_policy.h): retriable first, newest first."""

    def select(self, candidates: List[KillCandidate]) -> Optional[KillCandidate]:
        if not candidates:
            return None
        return max(candidates, key=lambda c: (c.retriable, c.started_at))
