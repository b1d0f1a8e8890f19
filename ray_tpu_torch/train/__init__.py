"""ray_tpu_torch.train: the port of ray_tpu.train.

``TorchTrainer(train_loop_per_worker, train_loop_config=...).fit()`` runs
the loop with a session context (``get_context``, ``report``,
``get_checkpoint``) and returns a ``Result``: one worker in the caller's
process by default, or a data-parallel gang of spawned workers, one card
each (``ScalingConfig(num_workers=n)``, ``TorchConfig``), whose gradients
meet in ``train.collective.reduce_gradients``. The LoRA fine-tune of Llama
is ``train.examples.llama_lora`` (FSDP over a gang by default, as the
reference's mesh), the ResNet one ``train.examples.resnet`` (sync-BN);
``save_sharded`` / ``restore_sharded`` / ``ShardedCheckpointWriter`` write
each rank's blocks of a state and lay them onto any mesh.
"""

from . import collective
from .backend import BackendConfig, TorchConfig
from .checkpoint import Checkpoint, CheckpointManager, load_latest_checkpoint
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from .controller import Result, TrainController
from .lora import lora_label_fn, merge_lora, split_lora
from .session import get_checkpoint, get_context, in_session, report
from .sharded_checkpoint import ShardedCheckpointWriter, restore_sharded, save_sharded
from .trainer import DataParallelTrainer, TorchTrainer

__all__ = [
    "BackendConfig",
    "TorchConfig",
    "Checkpoint",
    "CheckpointManager",
    "CheckpointConfig",
    "FailureConfig",
    "load_latest_checkpoint",
    "RunConfig",
    "ScalingConfig",
    "Result",
    "TrainController",
    "DataParallelTrainer",
    "TorchTrainer",
    "collective",
    "split_lora",
    "merge_lora",
    "lora_label_fn",
    "get_context",
    "get_checkpoint",
    "in_session",
    "report",
    "ShardedCheckpointWriter",
    "restore_sharded",
    "save_sharded",
]
