"""Worker-side training session: the port of ray_tpu/train/session.py.

Inside ``train_loop_per_worker`` the loop asks for its rank and world size
and reports metrics and checkpoints; the controller drains the reports. Each
report marks a step boundary of the ``train`` step breakdown
(``util/metrics`` ``StepBreakdown``), as the reference's does. The
reference's step-time series waits for the port's telemetry stream, and its
collective and dataset-shard fields for the slices that bring them.
"""

from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..util.metrics import StepBreakdown
from .checkpoint import Checkpoint


@dataclass
class TrainingReport:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    index: int
    world_rank: int


@dataclass
class TrainContext:
    world_rank: int
    local_rank: int
    node_rank: int
    world_size: int
    local_world_size: int
    experiment_name: str
    run_dir: str
    latest_checkpoint: Optional[Checkpoint] = None

    _reports: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _report_count: int = 0
    # report-to-report step telemetry (the scaling-efficiency gauge)
    _step_breakdown: StepBreakdown = field(default_factory=lambda: StepBreakdown(role="train"))

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_storage_path(self) -> str:
        return self.run_dir

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
        """Queue metrics for the controller. A reported checkpoint directory
        is copied into the run's storage as ``checkpoint_{index:06d}``."""
        index = self._report_count
        self._report_count += 1
        self._step_breakdown.mark()
        persisted: Optional[Checkpoint] = None
        if checkpoint is not None:
            dest = os.path.join(self.run_dir, f"checkpoint_{index:06d}")
            if os.path.abspath(checkpoint.path) != dest:
                os.makedirs(dest, exist_ok=True)
                shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
            persisted = Checkpoint(dest)
            self.latest_checkpoint = persisted
        with self._lock:
            self._reports.append(
                TrainingReport(dict(metrics), persisted, index, self.world_rank)
            )

    def drain_reports(self):
        with self._lock:
            out, self._reports = self._reports, []
        return out


_context: Optional[TrainContext] = None


def set_context(ctx: Optional[TrainContext]):
    global _context
    _context = ctx


def get_context() -> TrainContext:
    if _context is None:
        raise RuntimeError("ray_tpu_torch.train.get_context() called outside a training worker")
    return _context


def in_session() -> bool:
    return _context is not None


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    get_context().report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().latest_checkpoint
