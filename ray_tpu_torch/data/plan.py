"""Logical plan + rule-based optimizer.

Analog of the reference's ``python/ray/data/_internal/logical/``
(``LogicalPlan`` ``interfaces/logical_plan.py:5``, operators under
``operators/``, fusion rules in ``optimizers.py``): a Dataset holds an
immutable operator DAG; execution first optimizes it (map-chain fusion — the
rule that matters: fused maps run as ONE task per block, halving object-store
traffic) then hands it to the streaming executor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class LogicalOp:
    name: str = "op"

    def __init__(self, inputs: List["LogicalOp"]):
        self.inputs = inputs


class Read(LogicalOp):
    """Leaf: produces blocks from read tasks (one per file/fragment)."""

    name = "Read"

    def __init__(self, read_tasks: List[Callable[[], Any]], num_rows: Optional[int] = None,
                 ray_remote_args: Optional[Dict[str, Any]] = None):
        super().__init__([])
        self.read_tasks = read_tasks
        self.num_rows = num_rows
        self.ray_remote_args = dict(ray_remote_args or {})


class InputData(LogicalOp):
    """Leaf: pre-materialized blocks (from_items / from_pandas / refs)."""

    name = "InputData"

    def __init__(self, block_refs: List[Any], num_rows: Optional[int] = None):
        super().__init__([])
        self.block_refs = block_refs
        self.num_rows = num_rows


class MapBlocks(LogicalOp):
    """block -> block transform (map_batches / map / filter / flat_map all
    lower to this; fusable)."""

    name = "MapBlocks"

    def __init__(
        self,
        input_op: LogicalOp,
        fn: Callable,
        *,
        label: str = "Map",
        compute: str = "tasks",           # "tasks" | "actors"
        num_cpus: float = 1.0,
        concurrency: Optional[int] = None,
        ray_remote_args: Optional[Dict[str, Any]] = None,
    ):
        super().__init__([input_op])
        self.fn = fn
        self.label = label
        self.compute = compute
        self.num_cpus = num_cpus
        self.concurrency = concurrency
        self.ray_remote_args = dict(ray_remote_args or {})


class AllToAll(LogicalOp):
    """Barrier op: consumes all input blocks, emits new blocks
    (sort / shuffle / repartition / groupby)."""

    name = "AllToAll"

    def __init__(self, input_op: LogicalOp, fn: Callable[[List[Any]], List[Any]], label: str):
        super().__init__([input_op])
        self.fn = fn  # (all_block_refs) -> new_block_refs (driver-side orchestration)
        self.label = label


class Union(LogicalOp):
    name = "Union"

    def __init__(self, inputs: List[LogicalOp]):
        super().__init__(list(inputs))


class Limit(LogicalOp):
    name = "Limit"

    def __init__(self, input_op: LogicalOp, n: int):
        super().__init__([input_op])
        self.n = n


@dataclass
class LogicalPlan:
    dag: LogicalOp

    def optimized(self) -> "LogicalPlan":
        return LogicalPlan(_fuse_maps(self.dag))


def _fuse_maps(op: LogicalOp) -> LogicalOp:
    """Fuse chains of MapBlocks into one (reference:
    ``OperatorFusionRule`` in ``_internal/logical/rules/operator_fusion.py``).
    Only same-compute ("tasks") stages with the same task options fuse;
    actor pools keep their own op."""
    op_inputs = [_fuse_maps(i) for i in op.inputs]
    op.inputs = op_inputs
    if (
        isinstance(op, MapBlocks)
        and op.compute == "tasks"
        and len(op_inputs) == 1
        and isinstance(op_inputs[0], MapBlocks)
        and op_inputs[0].compute == "tasks"
        and op.ray_remote_args == op_inputs[0].ray_remote_args
    ):
        inner = op_inputs[0]
        outer_fn, inner_fn = op.fn, inner.fn

        def fused(block, _inner=inner_fn, _outer=outer_fn):
            return _outer(_inner(block))

        merged = MapBlocks(
            inner.inputs[0],
            fused,
            label=f"{inner.label}->{op.label}",
            compute="tasks",
            num_cpus=max(op.num_cpus, inner.num_cpus),
            concurrency=op.concurrency or inner.concurrency,
            ray_remote_args=op.ray_remote_args,
        )
        return merged
    return op
