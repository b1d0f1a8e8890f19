"""Trainers: the port of ray_tpu/train/trainer.py.

``DataParallelTrainer(train_loop_per_worker, ...).fit()`` runs the loop
through the :class:`TrainController` and returns a :class:`Result`: one
worker with no ``backend_config`` in the caller's process, else a gang of
spawned workers over ``backend_config`` (``TorchConfig()`` by default).
:class:`TorchTrainer` is the port's counterpart of the reference's
``JaxTrainer``: the loop it runs is PyTorch on the card. (The reference's
own ``TorchTrainer``, which only names a backend, has no separate
counterpart.)

The collective knobs reach every worker's context and, through it, the
gradient scheduler of ``train.collective.reduce_gradients``:
``quantized`` (int8 transport with error feedback for the gradient group),
``overlap`` (async bucketized allreduces), ``bucket_bytes`` and
``stale_grad`` (1: apply the previous step's reduced gradients, so this
step's reduction runs under the next step).
"""

from __future__ import annotations

from typing import Callable, Optional

from .backend import TorchConfig
from .config import RunConfig, ScalingConfig
from .controller import Result, TrainController


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend_config: Optional[TorchConfig] = None,
        quantized: bool = False,
        overlap: bool = False,
        bucket_bytes: Optional[int] = None,
        stale_grad: int = 0,
    ):
        self._train_loop = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config
        self.quantized = quantized
        self.overlap = overlap
        self.bucket_bytes = bucket_bytes
        self.stale_grad = stale_grad

    def fit(self) -> Result:
        return TrainController(
            self._train_loop, self._train_loop_config, self.run_config,
            scaling_config=self.scaling_config, backend_config=self.backend_config,
            quantized=self.quantized, overlap=self.overlap,
            bucket_bytes=self.bucket_bytes, stale_grad=self.stale_grad,
        ).run()


class TorchTrainer(DataParallelTrainer):
    """The PyTorch trainer (reference: ``JaxTrainer``, v2/jax/jax_trainer.py):
    one worker in the caller's process by default, ``TorchConfig()`` for
    more."""
