"""Train configuration: the port of ray_tpu/train/config.py, with the fields
the port's trainer reads.

The reference's ``use_tpu``, ``topology``, ``accelerator_type`` and
``placement_strategy`` choose TPU slices and have no counterpart here;
``FailureConfig`` (gang restarts, elastic resizes) comes with the control
plane. The port runs one worker in the caller's process:
``num_workers > 1`` needs the NCCL collectives slice and raises.
"""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ScalingConfig:
    """How many training workers. ``resources_per_worker`` keeps the
    reference's signature; the one worker runs in the caller's process,
    on the caller's resources, so nothing reads it yet."""

    num_workers: int = 1
    resources_per_worker: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {self.num_workers}")
        if self.num_workers > 1:
            raise NotImplementedError(
                f"num_workers={self.num_workers} is not ported yet: more than "
                "one worker comes with the collectives (NCCL) slice of the "
                "PyTorch port"
            )


@dataclass
class CheckpointConfig:
    """Checkpoint policy. Every reported checkpoint is kept; the
    reference's top-K retention (``num_to_keep``, ``checkpoint_score_*``)
    is ported with the first path that sets it."""


def _default_storage_path() -> str:
    return os.environ.get(
        "RAY_TPU_STORAGE_PATH",
        os.path.join(os.path.expanduser("~"), "ray_tpu_results"),
    )


@dataclass
class RunConfig:
    """Where results and checkpoints go: ``storage_path/name``. Each of
    ``callbacks`` may define ``on_report(report)`` and ``after_run(result)``."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    callbacks: List[Any] = field(default_factory=list)

    def __post_init__(self):
        if self.storage_path is None:
            self.storage_path = _default_storage_path()
        if self.name is None:
            self.name = f"train_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"

    @property
    def run_dir(self) -> str:
        return os.path.join(self.storage_path, self.name)
