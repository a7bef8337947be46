"""Run/scaling configuration dataclasses.

Analog of the reference's ``python/ray/air/config.py`` (``ScalingConfig``,
``RunConfig``, ``FailureConfig``, ``CheckpointConfig``).

The port's copy of ``ray_tpu/train/config.py``, with the card as the
accelerator: a worker claims ``gpus_per_worker`` of ``GPU`` (``use_gpu``
claims one). ``use_tpu`` and ``tpus_per_worker`` are kept as aliases of
them, as the runtime keeps ``num_tpus`` as an alias of ``num_gpus``.
``topology`` named a TPU slice's head resource; the port has no slices and
raises on it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    """Reference: ``air/config.py ScalingConfig``."""

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 0.0
    cpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # The JAX package's slice-head resource; refused here (see __post_init__).
    topology: Optional[str] = None
    # Per-worker runtime environment (env_vars apply at process SPAWN).
    runtime_env: Optional[Dict[str, Any]] = None
    # Aliases of use_gpu / gpus_per_worker (the JAX package's names).
    use_tpu: bool = False
    tpus_per_worker: float = 0.0

    def __post_init__(self):
        if self.topology is not None:
            raise ValueError(
                f"topology={self.topology!r} names a TPU slice's head "
                f"resource; the port runs on GPUs and has no slices: use "
                f"num_workers with use_gpu / gpus_per_worker")

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            res = dict(self.resources_per_worker)
            res.setdefault("CPU", self.cpus_per_worker)
            return res
        res: Dict[str, float] = {"CPU": self.cpus_per_worker}
        gpus = self.gpus_per_worker or self.tpus_per_worker
        if self.use_gpu or self.use_tpu or gpus:
            res["GPU"] = gpus or 1.0
        return res


@dataclass
class FailureConfig:
    """Reference: ``air/config.py FailureConfig``."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Reference: ``air/config.py CheckpointConfig`` (keep-top-k)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # "max" | "min"


@dataclass
class RunConfig:
    """Reference: ``air/config.py RunConfig``."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 0
