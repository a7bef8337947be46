"""Trial state (reference: ``python/ray/tune/experiment/trial.py``).

The port's copy of ``ray_tpu/tune/experiment.py``.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


class TrialStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"
    STOPPED = "STOPPED"  # early-stopped by a scheduler


@dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = TrialStatus.PENDING
    last_result: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    error: Optional[str] = None
    latest_checkpoint: Optional[Checkpoint] = None
    restore_checkpoint: Optional[Checkpoint] = None  # set by PBT exploit
    restarts: int = 0
    resources: Dict[str, float] = field(default_factory=dict)

    @property
    def training_iteration(self) -> int:
        return int(self.last_result.get("training_iteration", 0))

    def is_finished(self) -> bool:
        return self.status in (TrialStatus.TERMINATED, TrialStatus.ERROR, TrialStatus.STOPPED)
