"""Train configuration: the port of ray_tpu/train/config.py, with the fields
the port's trainer reads.

The reference's ``use_tpu``, ``topology``, ``accelerator_type`` and
``placement_strategy`` choose TPU slices and have no counterpart here. One
worker with no backend runs in the caller's process; more workers (or a
``TorchConfig``) run as a gang of spawned processes, one card each by
default (``ScalingConfig.worker_cards``).
"""

from __future__ import annotations

import math
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ScalingConfig:
    """How many training workers and what each one holds.

    ``resources_per_worker={"GPU": g}`` places rank r on ``cuda:floor(r *
    g)``: ``g = 1`` (the default) gives each rank a card, ``g = 0.5`` two
    ranks a card (Ray's fractional GPU). A ``resources_per_worker`` without
    a ``"GPU"`` key (``{"CPU": 1}``) puts the workers on the CPU."""

    num_workers: int = 1
    resources_per_worker: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {self.num_workers}")
        if self.gpu_share < 0:
            raise ValueError(f"resources_per_worker['GPU'] must be >= 0, got {self.gpu_share}")

    @property
    def gpu_share(self) -> float:
        if self.resources_per_worker is None:
            return 1.0
        return float(self.resources_per_worker.get("GPU", 0.0))

    def worker_cards(self) -> List[Optional[int]]:
        """The card index of each rank, or None for each when the workers
        are on the CPU. Does not look for the cards: see
        :meth:`check_cards`."""
        g = self.gpu_share
        if g == 0:
            return [None] * self.num_workers
        return [math.floor(r * g) for r in range(self.num_workers)]

    def check_cards(self, device_count: int) -> None:
        """Raise if a rank's card is past ``device_count``."""
        cards = [c for c in self.worker_cards() if c is not None]
        if cards and max(cards) >= device_count:
            raise ValueError(
                f"{self.num_workers} workers at {self.gpu_share} GPU each need "
                f"{max(cards) + 1} card(s); this host has {device_count}"
            )


@dataclass
class CheckpointConfig:
    """Top-K checkpoint retention: keep at most ``num_to_keep`` checkpoints
    (None keeps all), the best by ``checkpoint_score_attribute`` of their
    reported metrics under ``checkpoint_score_order``, else the newest. The
    latest checkpoint is always kept."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive")


@dataclass
class FailureConfig:
    """Worker-group failure policy: on a worker's exception or death the
    controller terminates the gang and restarts it from the latest
    checkpoint, up to ``max_failures`` times (``-1``: forever; ``0``, the
    default: the first failure ends the run in ``Result.error``). The
    reference's elastic resize (``elastic=True``, ``min_workers``) keeps the
    survivors and re-forms the group at a smaller size; it needs the weight
    plane, and raises."""

    max_failures: int = 0
    elastic: bool = False
    min_workers: int = 1

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.elastic:
            raise NotImplementedError(
                "FailureConfig(elastic=True) is not ported: an elastic resize restores "
                "the survivors from the weight plane (ROADMAP, not yet placed)"
            )


def _default_storage_path() -> str:
    return os.environ.get(
        "RAY_TPU_STORAGE_PATH",
        os.path.join(os.path.expanduser("~"), "ray_tpu_results"),
    )


@dataclass
class RunConfig:
    """Where results and checkpoints go: ``storage_path/name``, and how
    failures are handled. Each of ``callbacks`` may define
    ``on_report(report)`` and ``after_run(result)``."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    callbacks: List[Any] = field(default_factory=list)

    def __post_init__(self):
        if self.storage_path is None:
            self.storage_path = _default_storage_path()
        if self.name is None:
            self.name = f"train_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"

    @property
    def run_dir(self) -> str:
        return os.path.join(self.storage_path, self.name)
