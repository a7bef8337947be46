"""WorkerGroup — the actor group a trainer runs on.

Analog of the reference's ``python/ray/train/_internal/worker_group.py``
(``WorkerGroup`` — spawn N actors with per-worker resources, execute functions
on all of them, gather results). Workers are placed through a placement group
built from the ScalingConfig (reference: trial PG from ``ScalingConfig`` —
SURVEY §3.4 step 1), so PACK/SPREAD semantics apply.

The port's copy of ``ray_tpu/train/worker_group.py``: ``GPU`` (``TPU`` its
alias) maps to ``num_gpus``, and a worker's metadata carries its pid (a
process group is per process: the backend needs to know which workers
share one).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import PlacementGroupSchedulingStrategy, placement_group
from ray_tpu_torch.core.object_ref import ObjectRef


@dataclass
class WorkerMetadata:
    node_id: str
    hostname: str
    pid: int = 0


class _TrainWorkerImpl:
    """The per-rank actor. Executes arbitrary functions in-place (the
    reference's ``RayTrainWorker``)."""

    def __init__(self, rank: int):
        self.rank = rank
        self._state: Dict[str, Any] = {}

    def metadata(self) -> WorkerMetadata:
        ctx = ray_tpu_torch.get_runtime_context()
        return WorkerMetadata(
            node_id=ctx.node_id.hex() if ctx.node_id else "",
            hostname=socket.gethostname(), pid=os.getpid(),
        )

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def put_state(self, key: str, value: Any) -> None:
        self._state[key] = value

    def get_state(self, key: str) -> Any:
        return self._state.get(key)


def resource_options(resources: Dict[str, float]) -> Dict[str, Any]:
    """Actor options for a resource dict: ``CPU`` → ``num_cpus``, ``GPU``
    (or its alias ``TPU``) → ``num_gpus``, the rest as custom resources."""
    res = dict(resources)
    if "GPU" in res and "TPU" in res:
        raise ValueError(f"{resources}: TPU is an alias of GPU; give one")
    opts: Dict[str, Any] = {}
    if "CPU" in res:
        opts["num_cpus"] = res.pop("CPU")
    for name in ("GPU", "TPU"):
        if name in res:
            opts["num_gpus"] = res.pop(name)
    if res:
        opts["resources"] = res
    return opts


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        *,
        resources_per_worker: Optional[Dict[str, float]] = None,
        placement_strategy: str = "PACK",
        max_restarts: int = 0,
        runtime_env: Optional[Dict[str, Any]] = None,
    ):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker or {"CPU": 1.0})
        self._pg = placement_group(
            [dict(self.resources_per_worker) for _ in range(num_workers)],
            strategy=placement_strategy,
        )
        self._pg.wait()
        worker_cls = ray_tpu_torch.remote(**{"max_restarts": max_restarts})(_TrainWorkerImpl)
        extra: Dict[str, Any] = {}
        if runtime_env:
            extra["runtime_env"] = runtime_env
        self.workers = [
            worker_cls.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self._pg, placement_group_bundle_index=i
                ),
                **resource_options(self.resources_per_worker),
                **extra,
            ).remote(i)
            for i in range(num_workers)
        ]
        self.metadatas: List[WorkerMetadata] = ray_tpu_torch.get(
            [w.metadata.remote() for w in self.workers]
        )

    # -- execution ----------------------------------------------------------
    def execute_async(self, fn: Callable, *args, **kwargs) -> List[ObjectRef]:
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_single_async(self, rank: int, fn: Callable, *args, **kwargs) -> ObjectRef:
        return self.workers[rank].execute.remote(fn, *args, **kwargs)

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(self.execute_single_async(rank, fn, *args, **kwargs))

    def group_workers_by_node(self) -> Dict[str, List[int]]:
        by_node: Dict[str, List[int]] = {}
        for i, md in enumerate(self.metadatas):
            by_node.setdefault(md.node_id, []).append(i)
        return by_node

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        try:
            ray_tpu_torch.remove_placement_group(self._pg)
        except Exception:
            pass
