"""ray_tpu_torch.train: the port of ray_tpu.train, one worker on one card.

``TorchTrainer(train_loop_per_worker, train_loop_config=...).fit()`` runs
the loop in the caller's process with a session context (``get_context``,
``report``, ``get_checkpoint``) and returns a ``Result``. The LoRA fine-tune
of Llama is ``train.examples.llama_lora``.
"""

from .checkpoint import Checkpoint, CheckpointManager, load_latest_checkpoint
from .config import CheckpointConfig, RunConfig, ScalingConfig
from .controller import Result, TrainController
from .lora import lora_label_fn, merge_lora, split_lora
from .session import get_checkpoint, get_context, in_session, report
from .trainer import DataParallelTrainer, TorchTrainer

__all__ = [
    "Checkpoint",
    "CheckpointManager",
    "CheckpointConfig",
    "load_latest_checkpoint",
    "RunConfig",
    "ScalingConfig",
    "Result",
    "TrainController",
    "DataParallelTrainer",
    "TorchTrainer",
    "split_lora",
    "merge_lora",
    "lora_label_fn",
    "get_context",
    "get_checkpoint",
    "in_session",
    "report",
]
