"""Per-worker training session — ``report``/``get_context``.

Analog of the reference's ``python/ray/train/_internal/session.py``
(``_TrainSession`` :109, ``report`` :661): the user's train loop calls
``ray_tpu_torch.train.report(metrics, checkpoint=)``; results flow through a queue
to the driver, which gates each round (every worker reports once per round —
the same rendezvous semantics the reference enforces).

The port's copy of ``ray_tpu/train/session.py``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class TrainingResult:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint] = None
    world_rank: int = 0


class TrainContext:
    """What ``get_context()`` returns inside a train loop (reference:
    ``ray.train.get_context`` → ``TrainContext``)."""

    def __init__(
        self,
        *,
        world_rank: int,
        world_size: int,
        local_rank: int,
        local_world_size: int,
        node_rank: int,
        trial_name: str = "",
        experiment_name: str = "",
        devices: Optional[List] = None,
        result_queue: Optional[queue.Queue] = None,
        checkpoint: Optional[Checkpoint] = None,
        stop_event: Optional[threading.Event] = None,
        report_fn=None,  # overrides the queue path (Tune's per-report hook)
    ):
        self._report_fn = report_fn
        self._world_rank = world_rank
        self._world_size = world_size
        self._local_rank = local_rank
        self._local_world_size = local_world_size
        self._node_rank = node_rank
        self._trial_name = trial_name
        self._experiment_name = experiment_name
        self._devices = devices or []
        self._result_queue = result_queue
        self._checkpoint = checkpoint
        self._stop_event = stop_event or threading.Event()

    def get_world_rank(self) -> int:
        return self._world_rank

    def get_world_size(self) -> int:
        return self._world_size

    def get_local_rank(self) -> int:
        return self._local_rank

    def get_local_world_size(self) -> int:
        return self._local_world_size

    def get_node_rank(self) -> int:
        return self._node_rank

    def get_trial_name(self) -> str:
        return self._trial_name

    def get_experiment_name(self) -> str:
        return self._experiment_name

    def get_devices(self) -> List:
        return self._devices

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._checkpoint

_ctx = threading.local()


def set_context(context: Optional[TrainContext]) -> None:
    _ctx.value = context


def get_context() -> TrainContext:
    ctx = getattr(_ctx, "value", None)
    if ctx is None:
        # Outside a train loop: a degenerate single-worker context, matching
        # the reference's behavior of making train code runnable standalone.
        ctx = TrainContext(
            world_rank=0, world_size=1, local_rank=0, local_world_size=1, node_rank=0
        )
    return ctx


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) for this round.

    Reference semantics (``session.py:661``): acts as a barrier round — the
    driver collects one report per worker before proceeding.
    """
    ctx = get_context()
    result = TrainingResult(
        metrics=dict(metrics), checkpoint=checkpoint, world_rank=ctx._world_rank
    )
    if getattr(ctx, "_report_fn", None) is not None:
        ctx._report_fn(result)
        return
    if ctx._result_queue is None:
        return  # standalone mode: no-op
    ctx._result_queue.put(result)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().get_checkpoint()
