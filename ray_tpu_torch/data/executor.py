"""Streaming executor — pull-based block pipeline over runtime tasks.

Analog of the reference's ``python/ray/data/_internal/execution/``
(``StreamingExecutor`` ``streaming_executor.py:51``, operators under
``operators/``, backpressure policies): the optimized plan compiles to a
chain of generators over block refs. Task map stages keep at most
``max_in_flight`` tasks outstanding (backpressure: a stage only submits when
the consumer pulls), so a Dataset never materializes fully unless an
all-to-all barrier requires it. ``compute="actors"`` runs an AUTOSCALING
actor pool (least-loaded dispatch, ``concurrency=(min, max)``, backlog-driven
scale-up, drain-time retirement — the ``ActorPoolMapOperator`` analog) whose
outstanding cap grows with the pool: ``max(2·actors, max_in_flight)``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.plan import (
    AllToAll,
    InputData,
    Limit,
    LogicalOp,
    LogicalPlan,
    MapBlocks,
    Read,
    Union,
)

DEFAULT_MAX_IN_FLIGHT = 8
# Default object-plane budget for one streaming execution (all stages
# combined). The window of each stage adapts to measured block sizes so a
# pipeline of 100MB blocks holds far fewer in flight than one of 100KB
# blocks (reference: resource-budgeted operator scheduling,
# streaming_executor_state.py:494 + backpressure_policy/).
DEFAULT_MEMORY_BUDGET = 512 * 1024 * 1024


class _MemoryBudget:
    """Adaptive per-stage windows from a shared byte budget.

    Block sizes are learned online: sealed blocks register their size in
    the GCS object directory; inline-small blocks fall back to the running
    estimate. Each stage's window = share of the remaining budget divided
    by the size estimate, clamped to [1, max_in_flight]."""

    def __init__(self, total_bytes: int, max_in_flight: int):
        self.total = total_bytes
        self.max_in_flight = max_in_flight
        self._avg = 1 * 1024 * 1024  # prior: 1MB blocks
        self._samples = 0
        self._seen = 0
        self.stages = 1

    def note_block(self, ref) -> None:
        # Size probes are a GCS RPC — sample the first blocks to learn the
        # shape, then only every 32nd, so the estimate stays fresh without
        # a control-plane round trip per block on the streaming hot path.
        self._seen += 1
        if self._samples >= 8 and self._seen % 32 != 0:
            return
        size = _ref_size(ref)
        if size is None or size <= 0:
            return
        self._samples += 1
        alpha = max(0.1, 1.0 / self._samples)
        self._avg = (1 - alpha) * self._avg + alpha * size

    def window(self) -> int:
        per_stage = self.total / max(1, self.stages)
        return max(1, min(self.max_in_flight, int(per_stage // self._avg)))

    @property
    def avg_block_bytes(self) -> float:
        return self._avg


def _ref_size(ref) -> Optional[int]:
    """Size of a sealed block from the object directory (None if the block
    is inline-owned/unsealed — those are sub-100KiB by construction)."""
    try:
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        locations = rt._gcs_rpc.call("locate_object", ref.id.binary())
        for _node, _addr, size in locations:
            if size:
                return int(size)
    except Exception:  # noqa: BLE001 — in-process runtime / GCS miss
        return None
    return None


def _run_read_task(task: Callable):
    return task()


def _apply_map(fn: Callable, block):
    return fn(block)


class _MapActorImpl:
    """Reusable map worker (reference: ``ActorPoolMapOperator``)."""

    def __init__(self, fn_ctor: Optional[Callable] = None):
        self._state = fn_ctor() if fn_ctor is not None else None

    def apply(self, fn: Callable, block):
        if self._state is not None:
            return fn(self._state, block)
        return fn(block)


def execute_streaming(
    plan: LogicalPlan, *, max_in_flight: int = DEFAULT_MAX_IN_FLIGHT,
    memory_budget: int = DEFAULT_MEMORY_BUDGET,
    _stats: Optional[Dict[str, Any]] = None,
) -> Iterator[Any]:
    """Yield block refs as they become available. ``memory_budget`` bounds
    the object-plane bytes the whole pipeline holds in flight (adaptive
    per-stage windows; ``max_in_flight`` is the hard task-count cap)."""
    dag = plan.optimized().dag
    budget = _MemoryBudget(memory_budget, max_in_flight)
    budget.stages = _count_windowed_stages(dag)
    if _stats is not None:
        _stats["budget"] = budget
        _stats.setdefault("max_pending", 0)
    return _compile(dag, max_in_flight, budget, _stats)


def _count_windowed_stages(op: LogicalOp) -> int:
    n = 1 if isinstance(op, (Read, MapBlocks)) else 0
    return n + sum(_count_windowed_stages(i) for i in op.inputs)


def _note_pending(stats: Optional[Dict[str, Any]], n: int) -> None:
    if stats is not None and n > stats.get("max_pending", 0):
        stats["max_pending"] = n


def _compile(op: LogicalOp, max_in_flight: int, budget: _MemoryBudget,
             stats: Optional[Dict[str, Any]] = None) -> Iterator[Any]:
    if isinstance(op, InputData):
        return iter(list(op.block_refs))
    if isinstance(op, Read):
        read_remote = ray_tpu_torch.remote(_run_read_task)
        if op.ray_remote_args:
            read_remote = read_remote.options(**op.ray_remote_args)

        def gen_read() -> Iterator[Any]:
            pending: deque = deque()
            tasks = iter(op.read_tasks)
            exhausted = False
            while True:
                while not exhausted and len(pending) < budget.window():
                    t = next(tasks, None)
                    if t is None:
                        exhausted = True
                        break
                    pending.append(read_remote.remote(t))
                _note_pending(stats, len(pending))
                if not pending:
                    return
                ref = pending.popleft()
                budget.note_block(ref)
                yield ref

        return gen_read()
    if isinstance(op, MapBlocks):
        upstream = _compile(op.inputs[0], max_in_flight, budget, stats)
        if op.compute == "actors":
            return _actor_map(op, upstream, max_in_flight)
        map_remote = ray_tpu_torch.remote(_apply_map).options(
            num_cpus=op.num_cpus, **op.ray_remote_args)

        def gen_map() -> Iterator[Any]:
            pending: deque = deque()
            exhausted = False
            while True:
                cap = op.concurrency or budget.window()
                while not exhausted and len(pending) < cap:
                    ref = next(upstream, None)
                    if ref is None:
                        exhausted = True
                        break
                    pending.append(map_remote.remote(op.fn, ref))
                _note_pending(stats, len(pending))
                if not pending:
                    return
                ref = pending.popleft()
                budget.note_block(ref)
                yield ref

        return gen_map()
    if isinstance(op, AllToAll):
        upstream = _compile(op.inputs[0], max_in_flight, budget, stats)

        def gen_barrier() -> Iterator[Any]:
            all_refs = list(upstream)
            yield from op.fn(all_refs)

        return gen_barrier()
    if isinstance(op, Union):
        streams = [_compile(i, max_in_flight, budget, stats)
                   for i in op.inputs]

        def gen_union() -> Iterator[Any]:
            for s in streams:
                yield from s

        return gen_union()
    if isinstance(op, Limit):
        upstream = _compile(op.inputs[0], max_in_flight, budget, stats)

        def gen_limit() -> Iterator[Any]:
            from ray_tpu_torch.data.block import BlockAccessor

            remaining = op.n
            for ref in upstream:
                if remaining <= 0:
                    return
                block = ray_tpu_torch.get(ref)
                acc = BlockAccessor(block)
                if acc.num_rows() <= remaining:
                    remaining -= acc.num_rows()
                    yield ray_tpu_torch.put(block)
                else:
                    yield ray_tpu_torch.put(acc.slice(0, remaining))
                    remaining = 0

        return gen_limit()
    raise TypeError(f"unknown logical op {type(op)}")


def _actor_map(op: MapBlocks, upstream: Iterator[Any], max_in_flight: int) -> Iterator[Any]:
    """Autoscaling actor pool (reference: ``ActorPoolMapOperator`` with the
    autoscaling policy of ``_internal/execution/autoscaler``): ``compute=
    "actors"`` with ``concurrency=(min, max)`` starts ``min`` actors, adds
    one whenever every actor already has ≥2 blocks in flight (backlog), and
    retires the emptiest actors once the input is exhausted and the backlog
    drains below the pool size. A plain int pins the pool size."""
    conc = op.concurrency
    if isinstance(conc, (tuple, list)):
        min_actors, max_actors = int(conc[0]), int(conc[1])
    else:
        min_actors = max_actors = int(conc or 2)
    actor_cls = ray_tpu_torch.remote(_MapActorImpl)

    def spawn():
        return actor_cls.options(num_cpus=op.num_cpus).remote()

    actors: list = [spawn() for _ in range(max(1, min_actors))]
    # submitted-not-yet-yielded per actor (the executor's load signal)
    load: dict = {id(a): 0 for a in actors}
    # Refs YIELDED to the consumer whose tasks may still be running: killing
    # an actor drains its mailbox into ActorDiedError, which would poison
    # these (never-yielded pending refs are abandoned with the stream, so
    # they need no drain). Pruned via zero-timeout waits so the list stays
    # ~max_in_flight long and completed blocks aren't pinned forever.
    yielded: dict = {id(a): [] for a in actors}

    def _prune(actor) -> None:
        refs = yielded.get(id(actor))
        if refs:
            try:
                _, not_ready = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                            timeout=0)
                yielded[id(actor)] = not_ready
            except Exception:  # noqa: BLE001
                pass

    def _safe_kill(actor) -> None:
        _prune(actor)
        refs = yielded.pop(id(actor), [])
        if refs:
            try:
                ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=60.0)
            except Exception:  # noqa: BLE001
                pass
        try:
            ray_tpu_torch.kill(actor)
        except Exception:  # noqa: BLE001
            pass

    def gen() -> Iterator[Any]:
        pending: deque = deque()  # (ref, actor)
        exhausted = False
        try:
            while True:
                while not exhausted and len(pending) < max(
                        2 * len(actors), max_in_flight):
                    ref = next(upstream, None)
                    if ref is None:
                        exhausted = True
                        break
                    target = min(actors, key=lambda a: load[id(a)])
                    if load[id(target)] >= 2 and len(actors) < max_actors:
                        target = spawn()
                        actors.append(target)
                        load[id(target)] = 0
                        yielded[id(target)] = []
                    out_ref = target.apply.remote(op.fn, ref)
                    load[id(target)] += 1
                    pending.append((out_ref, target))
                if not pending:
                    return
                out, actor = pending.popleft()
                load[id(actor)] -= 1
                _prune(actor)
                if id(actor) in yielded:
                    yielded[id(actor)].append(out)
                # Retire surplus idle actors while the tail drains.
                if exhausted and len(actors) > min_actors:
                    idle = [a for a in actors if load[id(a)] == 0]
                    for a in idle[:len(actors) - max(1, min_actors)]:
                        actors.remove(a)
                        load.pop(id(a), None)
                        _safe_kill(a)
                yield out
        finally:
            for a in actors:
                _safe_kill(a)

    return gen()
