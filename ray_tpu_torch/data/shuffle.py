"""Push-based shuffle — pipelined map/merge exchange.

Analog of the reference's push-based shuffle scheduler
(``python/ray/data/_internal/planner/exchange/
push_based_shuffle_task_scheduler.py``): instead of every reducer pulling
ALL map partials at the end (a P×M memory spike and zero overlap), mappers
run in bounded **rounds** and each round's partials are immediately **merged
into the running reducer state** — merge work overlaps the next map round,
and peak reducer memory is (merged block + one round's partials) regardless
of how many input blocks exist. That is what lets a shuffle of a
larger-than-memory dataset stream through a small cluster.

Used by ``Dataset.random_shuffle`` and ``Dataset.repartition``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor


def _merge_blocks(*parts: Block) -> Block:
    return BlockAccessor.concat([p for p in parts if p is not None])


def _merge_and_permute(seed: Optional[int], *parts: Block) -> Block:
    table = BlockAccessor.concat([p for p in parts if p is not None])
    rng = np.random.default_rng(seed)
    perm = rng.permutation(table.num_rows)
    return BlockAccessor(table).take(list(perm))


def _final_concat(seed: Optional[int], *parts: Block) -> Block:
    return _merge_blocks(*parts)


def push_based_shuffle(
    input_refs: Sequence[Any],
    *,
    num_partitions: int,
    map_fn: Callable[..., Any],       # (block, P, round_seed) -> P partials
    final_fn: Callable[..., Block] = _final_concat,  # (seed, *parts) -> Block
    maps_per_round: Optional[int] = None,
    seed: Optional[int] = None,
    map_args: Optional[Sequence[tuple]] = None,  # extra per-ref args
) -> List[Any]:
    """Run the pipelined exchange; returns ``num_partitions`` block refs.

    Schedule per round r (reference's merge-factor pipeline):
      1. launch ``maps_per_round`` map tasks → P partials each;
      2. for every partition p, launch ``merge(prev_merged[p], *round_p)``;
      3. the merged refs feed round r+1 while its maps already run.
    The final round's merge applies ``final_fn`` (e.g. permute for
    random_shuffle) instead of plain concat.
    """
    P = num_partitions
    refs = list(input_refs)
    if not refs:
        return []
    R = maps_per_round or max(2, P)
    map_remote = ray_tpu_torch.remote(map_fn).options(num_returns=P)
    merge_remote = ray_tpu_torch.remote(_merge_blocks)
    final_remote = ray_tpu_torch.remote(final_fn)

    merged: List[Any] = [None] * P
    indexed = list(enumerate(refs))
    rounds = [indexed[i:i + R] for i in range(0, len(indexed), R)]
    for r, round_refs in enumerate(rounds):
        # 1. map this round
        round_parts: List[List[Any]] = [[] for _ in range(P)]
        for idx, ref in round_refs:
            s = None if seed is None else seed + idx
            extra = map_args[idx] if map_args is not None else ()
            out = map_remote.remote(ref, P, s, *extra)
            if P == 1:
                out = [out]
            for p, part in enumerate(out):
                round_parts[p].append(part)
        last = r == len(rounds) - 1
        # 2. merge into the running state (overlaps next round's maps)
        for p in range(P):
            prior = [merged[p]] if merged[p] is not None else []
            if last:
                fs = None if seed is None else seed + 7919 * p
                merged[p] = final_remote.remote(fs, *(prior + round_parts[p]))
            else:
                merged[p] = merge_remote.remote(*(prior + round_parts[p]))
    return merged


def shuffle_map_split(block: Block, P: int, seed: Optional[int]):
    """Random-partition mapper for random_shuffle."""
    acc = BlockAccessor(block)
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, P, acc.num_rows())
    parts = [acc.take(list(np.nonzero(assignment == p)[0])) for p in range(P)]
    return tuple(parts) if P > 1 else parts[0]


def repartition_map_split(block: Block, P: int, seed: Optional[int],
                          offset: int, bounds: Sequence[int]):
    """Order-preserving splitter for repartition.

    The block covers global rows [offset, offset+rows); each output p owns
    the global range [bounds[p], bounds[p+1]) — this block contributes the
    intersection, so concatenating per-partition partials in input order
    reproduces the original global row order exactly.
    """
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    parts = []
    for p in range(P):
        lo = max(0, min(rows, bounds[p] - offset))
        hi = max(0, min(rows, bounds[p + 1] - offset))
        parts.append(block.slice(lo, max(0, hi - lo)))
    return tuple(parts) if P > 1 else parts[0]


def block_num_rows(block: Block) -> int:
    return BlockAccessor(block).num_rows()
