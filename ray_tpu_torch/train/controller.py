"""Train controller: the port of ray_tpu/train/controller.py, for one worker.

The reference's controller brings up a worker group of actors, bootstraps
the backend, polls the workers and restarts or resizes the gang on failure.
The port runs ONE worker in the caller's process: it sets the session
context, calls the loop, and drains the reports into a :class:`Result`.
Actors, worker groups and the failure policy come with the control-plane
slice. As in the reference, an exception in the loop lands in
``Result.error``; it is not raised.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from . import session
from .checkpoint import Checkpoint, CheckpointManager
from .config import RunConfig
from .session import TrainContext, TrainingReport

logger = logging.getLogger(__name__)


@dataclass
class Result:
    """What fit() returns (reference: ray.train.Result)."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    path: str = ""
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)


class TrainController:
    def __init__(
        self,
        train_fn: Callable,
        train_fn_config: Optional[dict],
        run_config: RunConfig,
    ):
        self._train_fn = train_fn
        self._train_fn_config = train_fn_config
        self._run_config = run_config
        self._checkpoints = CheckpointManager(run_config.run_dir)
        self._metrics_history: List[Dict[str, Any]] = []

    def run(self) -> Result:
        run_dir = self._run_config.run_dir
        os.makedirs(run_dir, exist_ok=True)
        ctx = TrainContext(
            world_rank=0, local_rank=0, node_rank=0, world_size=1, local_world_size=1,
            experiment_name=self._run_config.name, run_dir=run_dir,
        )
        if session.in_session():
            raise RuntimeError("fit() called from inside a training loop")
        session.set_context(ctx)
        error: Optional[Exception] = None
        try:
            self._train_fn(self._train_fn_config if self._train_fn_config is not None else {})
        except Exception as e:  # the loop's failure is the run's result
            logger.exception("train loop failed")
            error = e
        finally:
            session.set_context(None)
        for report in ctx.drain_reports():
            self._process_report(report)
        result = Result(
            metrics=self._latest_metrics(),
            checkpoint=self._checkpoints.latest_checkpoint,
            error=error,
            path=run_dir,
            metrics_history=list(self._metrics_history),
        )
        for cb in self._run_config.callbacks:
            if hasattr(cb, "after_run"):
                cb.after_run(result)
        return result

    def _process_report(self, report: TrainingReport):
        if report.metrics:
            entry = dict(report.metrics)
            entry["_world_rank"] = report.world_rank
            entry["_report_index"] = report.index
            self._metrics_history.append(entry)
        if report.checkpoint is not None:
            self._checkpoints.register(report.checkpoint, report.index, report.metrics)
        for cb in self._run_config.callbacks:
            if hasattr(cb, "on_report"):
                cb.on_report(report)

    def _latest_metrics(self) -> Dict[str, Any]:
        if not self._metrics_history:
            return {}
        return {k: v for k, v in self._metrics_history[-1].items() if not k.startswith("_")}
