"""Trainers — ``DataParallelTrainer`` / ``TorchTrainer`` and ``Result``.

Analog of the reference's ``python/ray/train/base_trainer.py`` (``BaseTrainer``
:111, ``fit`` :567) + ``data_parallel_trainer.py`` (``training_loop`` :420).
The port's copy of ``ray_tpu/train/trainer.py``, with ``TorchTrainer`` in
place of ``JaxTrainer``. Differences by design:

- The reference's ``fit`` routes through Tune as a single trial
  (``base_trainer.py:580 as_trainable``); here ``fit`` drives the
  BackendExecutor directly, and ``as_trainable()`` exposes the same wrapper
  for the Tune layer to consume — same layering, inverted default.
- ``TorchTrainer`` IS the data-parallel trainer with the torch backend:
  intra-worker parallelism (the mesh) is the model's business, inter-worker
  setup (the torch process group) is the backend's.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import BackendExecutor, TrainingFailedError
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.session import TrainingResult


@dataclass
class Result:
    """Reference: ``python/ray/air/result.py``."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    best_checkpoints: List = field(default_factory=list)
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    path: str = ""


class DataParallelTrainer:
    """SPMD trainer: run ``train_loop_per_worker`` on N ranked workers.

    Reference: ``train/data_parallel_trainer.py``. Restart-on-failure follows
    the reference's whole-group model (``backend_executor.py`` — any worker
    failure tears down and restarts the group from the last checkpoint;
    SURVEY §3.4 step 6), which is also the right call for a torch process
    group: its world is fixed when it is formed.
    """

    _backend_config_cls = BackendConfig

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self._backend_config_cls()
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    # -- the e2e entry point -------------------------------------------------
    def fit(self) -> Result:
        name = self.run_config.name or "train_run"
        storage = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_results"
        )
        run_dir = os.path.join(storage, name)
        ckpt_manager = CheckpointManager(run_dir, self.run_config.checkpoint_config)

        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        resume = self.resume_from_checkpoint
        last_error: Optional[BaseException] = None

        while True:
            executor = BackendExecutor(
                backend_config=self.backend_config,
                scaling_config=self.scaling_config,
                experiment_name=name,
            )
            try:
                executor.start()
                executor.start_training(
                    self.train_loop_per_worker, self.train_loop_config, checkpoint=resume
                )
                metrics_history: List[Dict] = []
                final_metrics: Dict = {}
                while True:
                    results = executor.get_next_results()
                    if results is None:
                        break
                    final_metrics = results[0].metrics
                    metrics_history.append(final_metrics)
                    ckpt = next((r.checkpoint for r in results if r.checkpoint), None)
                    if ckpt is not None:
                        ckpt_manager.register(ckpt, final_metrics)
                executor.finish_training()
                return Result(
                    metrics=final_metrics,
                    checkpoint=ckpt_manager.latest_checkpoint,
                    best_checkpoints=ckpt_manager.checkpoints(),
                    metrics_history=metrics_history,
                    path=run_dir,
                )
            except TrainingFailedError as e:
                last_error = e
                attempt += 1
                if max_failures >= 0 and attempt > max_failures:
                    return Result(
                        metrics={},
                        checkpoint=ckpt_manager.latest_checkpoint,
                        best_checkpoints=ckpt_manager.checkpoints(),
                        error=e,
                        path=run_dir,
                    )
                resume = ckpt_manager.latest_checkpoint or self.resume_from_checkpoint
            finally:
                executor.shutdown()

    # -- Tune integration (reference: base_trainer.py:819 as_trainable) ------
    def as_trainable(self) -> Callable[[Dict], Dict]:
        """A function trainable: Tune calls it with a config override."""

        def trainable(config: Dict) -> Dict:
            trainer = type(self)(
                self.train_loop_per_worker,
                train_loop_config={**self.train_loop_config, **config},
                backend_config=self.backend_config,
                scaling_config=self.scaling_config,
                run_config=self.run_config,
                resume_from_checkpoint=self.resume_from_checkpoint,
            )
            result = trainer.fit()
            if result.error:
                raise result.error
            return result.metrics

        return trainable


class TorchTrainer(DataParallelTrainer):
    """The data-parallel trainer with ``TorchConfig`` (reference:
    ``ray.train.torch.TorchTrainer``): a process group across the workers,
    NCCL when they hold the card."""

    _backend_config_cls = TorchConfig
