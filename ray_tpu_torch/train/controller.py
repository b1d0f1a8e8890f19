"""Train controller: the port of ray_tpu/train/controller.py.

One worker with no backend config runs in the caller's process: the
controller sets the session context, with the checkpoint to resume from
(this controller's latest, else the run directory's manifest, as the
reference's ``_push_resume`` does on every attempt), calls the loop, and
drains the reports.

Otherwise the loop runs on a gang of spawned workers
(:class:`~ray_tpu_torch.train.worker_group.WorkerGroup`). An attempt:

1. brings up the worker group, rank r on ``ScalingConfig.worker_cards()[r]``;
2. runs the backend's ``on_start`` (``init_process_group`` in every worker
   over the controller's store);
3. gives each worker its context and registers the run's collective groups
   there: a gloo control group (the context's ``collective_group``) and the
   gradients' tensor group (``collective_tensor_group``, of the backend's
   kind);
4. pushes the resume checkpoint (in the context);
5. starts the loop and polls the workers, registering every rank's
   reports and checkpoints as they arrive.

On a worker's exception or death the controller terminates the gang, and
restarts it from the latest checkpoint up to ``FailureConfig.max_failures``
times (-1: forever); the in-process worker is retried alike. After the last
failure the error lands in ``Result.error``, as in the reference; it is not
raised. A configuration that cannot run (a loop that cannot be sent to a
worker, NCCL for ranks that share a card, a card that is not there) raises
from ``fit()`` before anything spawns.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from . import session
from .backend import TorchConfig
from .checkpoint import Checkpoint, CheckpointManager, load_latest_checkpoint
from .config import RunConfig, ScalingConfig
from .session import TrainContext, TrainingReport
from .worker_group import WorkerDiedError, WorkerGroup, check_importable

logger = logging.getLogger(__name__)

#: how long the controller waits for a worker's message before it looks for
#: dead workers
_POLL_S = 0.1


@dataclass
class Result:
    """What fit() returns (reference: ray.train.Result)."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    path: str = ""
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)


def _register_groups(tensor_backend: str):
    """In each worker: the run's control and tensor groups, by the names
    and knobs of its context."""
    from .. import collective

    ctx = session.get_context()
    collective.init_collective_group(
        ctx.world_size, ctx.world_rank, backend="gloo",
        group_name=ctx.collective_group, epoch=ctx.collective_epoch,
    )
    collective.init_collective_group(
        ctx.world_size, ctx.world_rank, backend=tensor_backend,
        group_name=ctx.collective_tensor_group, epoch=ctx.collective_epoch,
        quantized=ctx.collective_quantized,
    )


class TrainController:
    def __init__(
        self,
        train_fn: Callable,
        train_fn_config: Optional[dict],
        run_config: RunConfig,
        scaling_config: Optional[ScalingConfig] = None,
        backend_config: Optional[TorchConfig] = None,
        quantized: bool = False,
        overlap: bool = False,
        bucket_bytes: Optional[int] = None,
        stale_grad: int = 0,
    ):
        self._train_fn = train_fn
        self._train_fn_config = train_fn_config if train_fn_config is not None else {}
        self._run_config = run_config
        self._scaling = scaling_config or ScalingConfig()
        if backend_config is not None and not isinstance(backend_config, TorchConfig):
            raise TypeError(
                f"a worker gang forms torch.distributed: backend_config must be a "
                f"TorchConfig, got {type(backend_config).__name__}"
            )
        # one worker with no backend: the loop runs in this process
        self._in_process = backend_config is None and self._scaling.num_workers == 1
        self._backend_config = backend_config or TorchConfig()
        self._quantized = quantized
        self._overlap = overlap
        self._bucket_bytes = bucket_bytes
        self._stale_grad = stale_grad
        self._checkpoints = CheckpointManager(
            run_config.run_dir, run_config.checkpoint_config
        )
        self._metrics_history: List[Dict[str, Any]] = []
        self._failures = 0
        # a restarted attempt numbers its reports after every report seen,
        # so its checkpoint directories never overwrite an earlier attempt's
        self._next_report_index = 0

    def _plan_gang(self):
        """(cards by rank, tensor backend), refusing what cannot run."""
        import torch

        from ..collective.nccl_group import check_distinct_cards

        check_importable(self._train_fn, self._train_fn_config)
        cards = self._scaling.worker_cards()
        backend = self._backend_config.resolve(on_card=cards[0] is not None)
        if backend == "nccl":
            check_distinct_cards(cards)
        if cards[0] is not None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass resources_per_worker={'CPU': 1} "
                    "to run the workers on the CPU"
                )
            self._scaling.check_cards(torch.cuda.device_count())
        return cards, backend

    def run(self) -> Result:
        if session.in_session():
            raise RuntimeError("fit() called from inside a training loop")
        plan = None if self._in_process else self._plan_gang()
        run_dir = self._run_config.run_dir
        os.makedirs(run_dir, exist_ok=True)
        max_failures = self._run_config.failure_config.max_failures
        while True:
            error = self._run_in_process() if plan is None else self._run_gang(*plan)
            if error is None:
                break
            self._failures += 1
            if 0 <= max_failures < self._failures:
                break
            logger.warning("train attempt %d failed (%s); restarting from the latest "
                           "checkpoint", self._failures, error)
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

    def _resume(self) -> Optional[Checkpoint]:
        return self._checkpoints.latest_checkpoint or load_latest_checkpoint(
            self._run_config.run_dir)

    def _run_in_process(self) -> Optional[Exception]:
        ctx = TrainContext(
            world_rank=0, local_rank=0, node_rank=0, world_size=1, local_world_size=1,
            experiment_name=self._run_config.name, run_dir=self._run_config.run_dir,
            latest_checkpoint=self._resume(), _report_count=self._next_report_index,
        )
        session.set_context(ctx)
        error: Optional[Exception] = None
        try:
            self._train_fn(self._train_fn_config)
        except Exception as e:  # the loop's failure is the attempt's result
            logger.exception("train loop failed")
            error = e
        finally:
            session.set_context(None)
        for report in ctx.drain_reports():
            self._process_report(report)
        return error

    def _run_fields(self, rank: int, n: int) -> dict:
        # attempt-scoped group names: a restarted gang forms new groups
        group = f"train:{self._run_config.name}:{self._failures}"
        return dict(
            world_rank=rank, local_rank=rank, node_rank=0, world_size=n,
            local_world_size=n, experiment_name=self._run_config.name,
            run_dir=self._run_config.run_dir, collective_group=group,
            collective_tensor_group=f"{group}:tensor", collective_epoch=0,
            collective_quantized=self._quantized, collective_overlap=self._overlap,
            collective_bucket_bytes=self._bucket_bytes,
            collective_stale_grad=self._stale_grad, latest_checkpoint=self._resume(),
            _report_count=self._next_report_index,
        )

    def _run_gang(self, cards, tensor_backend: str) -> Optional[Exception]:
        wg = WorkerGroup(cards)
        backend = self._backend_config.backend()
        try:
            wg.start()
            backend.on_start(wg)
            wg.set_contexts([self._run_fields(r, wg.num_workers) for r in range(wg.num_workers)])
            wg.execute(_register_groups, tensor_backend)
            wg.start_training(self._train_fn, self._train_fn_config)
            error = self._poll_until_done(wg)
            if error is None:
                backend.on_shutdown(wg)
            return error
        except Exception as e:  # a worker failed while the gang came up
            logger.exception("train worker group failed")
            return e
        finally:
            wg.shutdown()

    def _poll_until_done(self, wg: WorkerGroup) -> Optional[Exception]:
        done = set()
        while len(done) < wg.num_workers:
            for kind, rank, payload in wg.poll(_POLL_S):
                if kind == "report":
                    self._process_report(payload)
                elif kind == "done":
                    done.add(rank)
                elif kind == "error":
                    return payload
            gone = [(r, code) for r, code in wg.exited() if r not in done]
            if gone:
                # what a dead worker sent before it died is still registered
                for kind, _, payload in wg.poll(_POLL_S):
                    if kind == "report":
                        self._process_report(payload)
                rank, code = gone[0]
                return WorkerDiedError(f"train worker rank {rank} exited with code {code}")
        return None

    def _process_report(self, report: TrainingReport):
        self._next_report_index = max(self._next_report_index, report.index + 1)
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
        """The last report of rank 0, else of any rank."""
        entries = [e for e in self._metrics_history if e.get("_world_rank") == 0]
        entries = entries or self._metrics_history
        if not entries:
            return {}
        return {k: v for k, v in entries[-1].items() if not k.startswith("_")}
