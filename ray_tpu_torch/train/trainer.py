"""Trainers: the port of ray_tpu/train/trainer.py.

``DataParallelTrainer(train_loop_per_worker, ...).fit()`` runs the loop
through the :class:`TrainController` and returns a :class:`Result`.
:class:`TorchTrainer` is the port's counterpart of the reference's
``JaxTrainer``: the loop it runs is PyTorch on the card. (The reference's
own ``TorchTrainer``, which only names a backend, has no separate
counterpart.)
"""

from __future__ import annotations

from typing import Callable, Optional

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
    ):
        self._train_loop = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()

    def fit(self) -> Result:
        # ScalingConfig allows one worker only, and it runs in this process
        return TrainController(self._train_loop, self._train_loop_config, self.run_config).run()


class TorchTrainer(DataParallelTrainer):
    """The PyTorch trainer (reference: ``JaxTrainer``, v2/jax/jax_trainer.py)."""
