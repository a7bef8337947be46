"""ray_tpu_torch.train — distributed training on the card.

Public surface mirrors ``ray.train``: trainers + ScalingConfig/RunConfig +
session (``report``/``get_context``/``get_checkpoint``) + ``Checkpoint``.

Counterpart of ``ray_tpu/train/__init__.py``, with ``TorchTrainer`` and
``TorchConfig`` in place of ``JaxTrainer`` and ``JaxConfig``.
"""

from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import BackendExecutor, TrainingFailedError
from ray_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    Checkpoint,
    CheckpointManager,
    load_pytree,
    restore_pytree,
    save_pytree,
)
from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.session import (
    TrainContext,
    TrainingResult,
    get_checkpoint,
    get_context,
    report,
)
from ray_tpu_torch.train.trainer import DataParallelTrainer, Result, TorchTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup

__all__ = [
    "Backend",
    "BackendConfig",
    "TorchConfig",
    "BackendExecutor",
    "TrainingFailedError",
    "Checkpoint",
    "CheckpointManager",
    "AsyncCheckpointer",
    "save_pytree",
    "load_pytree",
    "restore_pytree",
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "TrainContext",
    "TrainingResult",
    "report",
    "get_context",
    "get_checkpoint",
    "DataParallelTrainer",
    "TorchTrainer",
    "Result",
    "WorkerGroup",
]
