"""BackendExecutor — drives a training run over a WorkerGroup.

Analog of the reference's ``python/ray/train/_internal/backend_executor.py``
(``BackendExecutor`` :65 — ``start`` :121 spawns the group + backend hooks,
``start_training`` :427 launches the user loop on every worker, rank mapping
:347, ``get_next_results`` :541 gathers one report per worker per round).

Results stream from worker actors to the driver through a ``_ResultCollector``
actor (the in-runtime equivalent of the reference's per-worker result queues),
so report rounds are a strict barrier: the driver blocks until every live
worker has reported round N before handing results to the trainer.

The port's copy of ``ray_tpu/train/backend_executor.py``, but for one
change: the collector is created in ``start`` and is up before the loops
start (see ``start``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import ActorError, TaskError
from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainContext, TrainingResult, set_context
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingFailedError(RuntimeError):
    pass


class _ResultCollectorImpl:
    """Collects per-round reports and the final status of every rank."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.rounds: List[Dict[int, dict]] = []
        self.finished: Dict[int, Optional[str]] = {}

    def push(self, rank: int, round_index: int, metrics: dict, checkpoint_path: Optional[str]):
        while len(self.rounds) <= round_index:
            self.rounds.append({})
        self.rounds[round_index][rank] = {
            "metrics": metrics,
            "checkpoint_path": checkpoint_path,
        }
        return True

    def finish(self, rank: int, error: Optional[str] = None):
        self.finished[rank] = error
        return True

    def poll(self, round_index: int):
        """(round_payload|None, finished_map)."""
        if round_index < len(self.rounds) and len(self.rounds[round_index]) >= self.world_size:
            return self.rounds[round_index], dict(self.finished)
        return None, dict(self.finished)


def _worker_train_main(
    train_fn: Callable,
    config: Dict,
    rank: int,
    world_size: int,
    local_rank: int,
    local_world_size: int,
    node_rank: int,
    collector,
    checkpoint_dir: Optional[str],
    experiment_name: str,
):
    """Executed inside each TrainWorker actor: set up the session context,
    run the user loop, stream ``report`` rounds to the collector."""
    import queue as _q

    q: _q.Queue = _q.Queue()
    ctx = TrainContext(
        world_rank=rank,
        world_size=world_size,
        local_rank=local_rank,
        local_world_size=local_world_size,
        node_rank=node_rank,
        experiment_name=experiment_name,
        result_queue=q,
        checkpoint=Checkpoint(checkpoint_dir) if checkpoint_dir else None,
    )
    set_context(ctx)

    error: Optional[str] = None
    pump_done = threading.Event()

    def pump():
        i = 0
        while True:
            try:
                item: TrainingResult = q.get(timeout=0.05)
            except _q.Empty:
                if pump_done.is_set() and q.empty():
                    return
                continue
            ckpt_path = item.checkpoint.path if item.checkpoint else None
            ray_tpu_torch.get(collector.push.remote(rank, i, item.metrics, ckpt_path))
            i += 1

    pump_thread = threading.Thread(target=pump, daemon=True)
    pump_thread.start()
    try:
        train_fn(config) if _accepts_arg(train_fn) else train_fn()
    except BaseException as e:  # noqa: BLE001 - report any failure to driver
        error = f"{type(e).__name__}: {e}"
    finally:
        pump_done.set()
        pump_thread.join()
        set_context(None)
        ray_tpu_torch.get(collector.finish.remote(rank, error))
    if error is not None:
        raise RuntimeError(error)
    return True


def _accepts_arg(fn: Callable) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    required = [
        p
        for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]
    return len(required) >= 1


class BackendExecutor:
    def __init__(
        self,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        experiment_name: str = "train",
    ):
        self.backend_config = backend_config or TorchConfig()
        self.scaling_config = scaling_config or ScalingConfig()
        self.experiment_name = experiment_name
        self.backend: Backend = self.backend_config.backend_cls()()
        self.worker_group: Optional[WorkerGroup] = None
        self._collector = None
        self._run_refs: List = []
        self._round = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        sc = self.scaling_config
        # The collector's process starts beside the workers' (on a cluster a
        # cold one imports torch for seconds): created later, a loop's first
        # reports would queue on it, and die with a worker that dies first.
        collector_cls = ray_tpu_torch.remote(_ResultCollectorImpl)
        self._collector = collector_cls.options(num_cpus=0).remote(sc.num_workers)
        self.worker_group = WorkerGroup(
            sc.num_workers,
            resources_per_worker=sc.worker_resources(),
            placement_strategy=sc.placement_strategy,
            runtime_env=sc.runtime_env,
        )
        self.backend.on_start(self.worker_group, self.backend_config)

    def start_training(
        self,
        train_fn: Callable,
        config: Optional[Dict] = None,
        checkpoint: Optional[Checkpoint] = None,
    ) -> None:
        assert self.worker_group is not None, "call start() first"
        wg = self.worker_group
        self.backend.on_training_start(wg, self.backend_config)
        # Up before any loop reports (a round trip; it started in start()).
        ray_tpu_torch.get(self._collector.poll.remote(0))
        self._round = 0

        by_node = wg.group_workers_by_node()
        node_rank_of: Dict[str, int] = {n: i for i, n in enumerate(by_node)}
        local_rank: Dict[int, int] = {}
        for node, ranks in by_node.items():
            for j, r in enumerate(sorted(ranks)):
                local_rank[r] = j

        self._run_refs = [
            wg.execute_single_async(
                i,
                _worker_train_main,
                train_fn,
                dict(config or {}),
                i,
                wg.num_workers,
                local_rank[i],
                len(by_node[wg.metadatas[i].node_id]),
                node_rank_of[wg.metadatas[i].node_id],
                self._collector,
                checkpoint.path if checkpoint else None,
                self.experiment_name,
            )
            for i in range(wg.num_workers)
        ]

    # -- result streaming ---------------------------------------------------
    def get_next_results(self, timeout: Optional[float] = None) -> Optional[List[TrainingResult]]:
        """Block until every worker reports the current round (list of
        TrainingResult, rank-ordered), or all workers finish (None).

        Raises TrainingFailedError if any worker errored."""
        assert self._collector is not None
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            payload, finished = ray_tpu_torch.get(self._collector.poll.remote(self._round))
            if payload is not None:
                self._round += 1
                return [
                    TrainingResult(
                        metrics=payload[r]["metrics"],
                        checkpoint=(
                            Checkpoint(payload[r]["checkpoint_path"])
                            if payload[r]["checkpoint_path"]
                            else None
                        ),
                        world_rank=r,
                    )
                    for r in sorted(payload)
                ]
            errors = {r: e for r, e in finished.items() if e}
            if errors:
                self._maybe_raise_worker_errors()
                raise TrainingFailedError(f"worker(s) failed: {errors}")
            if len(finished) >= (self.worker_group.num_workers if self.worker_group else 0):
                return None
            # A worker PROCESS that died (kill -9, OOM, node loss) never
            # reaches the collector's finish() — its run ref resolves to an
            # ActorError instead. Without this probe the round barrier
            # blocks forever on a dead rank (the reference's BackendExecutor
            # polls worker health the same way, backend_executor.py:121).
            self._raise_if_worker_died()
            if deadline and time.monotonic() > deadline:
                raise TimeoutError("timed out waiting for training results")
            time.sleep(0.01)

    def _raise_if_worker_died(self) -> None:
        self._probe_run_refs(wait_timeout=0)

    def _probe_run_refs(self, wait_timeout: float) -> None:
        """Raise TrainingFailedError if any completed run ref errored."""
        done, _ = ray_tpu_torch.wait(self._run_refs,
                               num_returns=len(self._run_refs),
                               timeout=wait_timeout)
        for ref in done:
            try:
                ray_tpu_torch.get(ref, timeout=5)
            except Exception as e:  # noqa: BLE001 — actor/worker death
                raise TrainingFailedError(
                    f"train worker died mid-round: {e}") from e

    def _maybe_raise_worker_errors(self):
        self._probe_run_refs(wait_timeout=5)

    def finish_training(self) -> List[Any]:
        return ray_tpu_torch.get(self._run_refs)

    def shutdown(self) -> None:
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group, self.backend_config)
            finally:
                self.worker_group.shutdown()
                self.worker_group = None
        if self._collector is not None:
            try:
                ray_tpu_torch.kill(self._collector)
            except Exception:
                pass
            self._collector = None
