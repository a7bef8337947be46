"""Dataset — lazy, streaming, distributed columnar data.

Analog of the reference's ``python/ray/data/dataset.py`` (5,142 lines) +
``read_api.py`` + shuffle scheduling (``_internal/planner/exchange/``): a
Dataset wraps a LogicalPlan over block refs; transforms append logical ops;
consumption triggers streaming execution. Shuffle/sort/repartition use the
two-stage map/reduce exchange over tasks+objects the reference uses
(``push_based_shuffle_task_scheduler.py`` — simplified to its pull-based
variant here).
"""

from __future__ import annotations

import builtins
import functools
import glob as _glob
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Union as TUnion

import numpy as np
import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch.data.block import Batch, Block, BlockAccessor, Row
from ray_tpu_torch.data.executor import execute_streaming
from ray_tpu_torch.data.plan import (
    AllToAll,
    InputData,
    Limit,
    LogicalPlan,
    MapBlocks,
    Read,
    Union,
)

DEFAULT_BATCH_SIZE = 1024


class Dataset:
    def __init__(self, plan: LogicalPlan):
        self._plan = plan

    # ------------------------------------------------------------------ meta
    def __repr__(self):
        return f"Dataset(plan={self._plan.dag.name})"

    def schema(self) -> Optional[pa.Schema]:
        for ref in execute_streaming(self._plan):
            block = ray_tpu_torch.get(ref)
            if block.num_rows:
                return block.schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def count(self) -> int:
        n = 0
        for ref in execute_streaming(self._plan):
            n += BlockAccessor(ray_tpu_torch.get(ref)).num_rows()
        return n

    def num_blocks(self) -> int:
        return sum(1 for _ in execute_streaming(self._plan))

    def size_bytes(self) -> int:
        return sum(
            BlockAccessor(ray_tpu_torch.get(r)).size_bytes() for r in execute_streaming(self._plan)
        )

    # ------------------------------------------------------------ transforms
    def _append(self, op) -> "Dataset":
        return Dataset(LogicalPlan(op))

    def map_batches(
        self,
        fn: Callable[[Batch], TUnion[Batch, pa.Table]],
        *,
        batch_format: str = "numpy",
        compute: str = "tasks",
        concurrency: Optional[int] = None,
        num_cpus: float = 1.0,
        ray_remote_args: Optional[Dict[str, Any]] = None,
        **_ignored,
    ) -> "Dataset":
        def transform(block: Block) -> Block:
            acc = BlockAccessor(block)
            if batch_format == "numpy":
                out = fn(acc.to_numpy())
            elif batch_format == "pandas":
                out = fn(acc.to_pandas())
            elif batch_format in ("pyarrow", "arrow"):
                out = fn(block)
            else:
                raise ValueError(f"unknown batch_format {batch_format}")
            return BlockAccessor.batch_to_block(out)

        return self._append(
            MapBlocks(
                self._plan.dag, transform, label="MapBatches",
                compute=compute, num_cpus=num_cpus, concurrency=concurrency,
                ray_remote_args=ray_remote_args,
            )
        )

    def map(self, fn: Callable[[Row], Row], **kw) -> "Dataset":
        def transform(block: Block) -> Block:
            rows = [fn(r) for r in BlockAccessor(block).iter_rows()]
            return BlockAccessor.from_items(rows)

        return self._append(MapBlocks(self._plan.dag, transform, label="Map"))

    def flat_map(self, fn: Callable[[Row], List[Row]], **kw) -> "Dataset":
        def transform(block: Block) -> Block:
            rows: List[Row] = []
            for r in BlockAccessor(block).iter_rows():
                rows.extend(fn(r))
            return BlockAccessor.from_items(rows)

        return self._append(MapBlocks(self._plan.dag, transform, label="FlatMap"))

    def filter(self, fn: Callable[[Row], bool], **kw) -> "Dataset":
        def transform(block: Block) -> Block:
            acc = BlockAccessor(block)
            keep = [i for i, r in enumerate(acc.iter_rows()) if fn(r)]
            return acc.take(keep)

        return self._append(MapBlocks(self._plan.dag, transform, label="Filter"))

    def select_columns(self, cols: List[str], **kw) -> "Dataset":
        return self._append(
            MapBlocks(self._plan.dag, lambda b: BlockAccessor(b).select(cols), label="Select")
        )

    def drop_columns(self, cols: List[str], **kw) -> "Dataset":
        def transform(block: Block) -> Block:
            keep = [c for c in block.column_names if c not in cols]
            return block.select(keep)

        return self._append(MapBlocks(self._plan.dag, transform, label="Drop"))

    def add_column(self, name: str, fn: Callable[[Batch], np.ndarray], **kw) -> "Dataset":
        def transform(block: Block) -> Block:
            col = fn(BlockAccessor(block).to_numpy())
            return block.append_column(name, pa.array(np.asarray(col)))

        return self._append(MapBlocks(self._plan.dag, transform, label="AddColumn"))

    def limit(self, n: int) -> "Dataset":
        return self._append(Limit(self._plan.dag, n))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._append(Union([self._plan.dag] + [o._plan.dag for o in others]))

    # ------------------------------------------------------------ all-to-all
    def repartition(self, num_blocks: int) -> "Dataset":
        """Order-preserving push-based exchange: a metadata pass computes
        global row offsets, mappers slice each block against the global
        output boundaries, and partials merge in input order — rows keep
        their global order (``data/shuffle.py``)."""

        def do(all_refs: List[Any]) -> List[Any]:
            from ray_tpu_torch.data.shuffle import (
                block_num_rows,
                push_based_shuffle,
                repartition_map_split,
            )

            count_remote = ray_tpu_torch.remote(block_num_rows)
            counts = ray_tpu_torch.get([count_remote.remote(r) for r in all_refs])
            total = sum(counts)
            P = max(1, num_blocks)
            bounds = [p * total // P for p in builtins.range(P + 1)]
            offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
            return push_based_shuffle(
                all_refs, num_partitions=P, map_fn=repartition_map_split,
                map_args=[(int(o), bounds) for o in offsets],
            )

        return self._append(AllToAll(self._plan.dag, do, "Repartition"))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Push-based shuffle exchange (reference:
        ``_internal/planner/exchange/push_based_shuffle_task_scheduler.py``):
        mappers random-partition each block; partials merge into the running
        reducer state round by round, so peak reducer memory is one merged
        block + one round of partials — not all M map outputs at once."""

        def do(all_refs: List[Any]) -> List[Any]:
            from ray_tpu_torch.data.shuffle import (
                _merge_and_permute,
                push_based_shuffle,
                shuffle_map_split,
            )

            return push_based_shuffle(
                all_refs, num_partitions=max(1, len(all_refs)),
                map_fn=shuffle_map_split, final_fn=_merge_and_permute,
                seed=seed,
            )

        return self._append(AllToAll(self._plan.dag, do, "RandomShuffle"))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        def do(all_refs: List[Any]) -> List[Any]:
            blocks = [ray_tpu_torch.get(r) for r in all_refs]
            table = BlockAccessor.concat(blocks)
            order = "descending" if descending else "ascending"
            out = table.sort_by([(key, order)])
            return [ray_tpu_torch.put(out)]

        return self._append(AllToAll(self._plan.dag, do, "Sort"))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        refs = list(execute_streaming(self._plan))
        shards: List[List[Any]] = [[] for _ in builtins.range(n)]
        if equal:
            blocks = [ray_tpu_torch.get(r) for r in refs]
            table = BlockAccessor.concat(blocks)
            rows = table.num_rows - table.num_rows % n
            per = rows // n
            for i in builtins.range(n):
                shards[i].append(ray_tpu_torch.put(table.slice(i * per, per)))
        else:
            for i, r in enumerate(refs):
                shards[i % n].append(r)
        return [Dataset(LogicalPlan(InputData(s))) for s in shards]

    def zip(self, other: "Dataset") -> "Dataset":
        def do(all_refs: List[Any]) -> List[Any]:
            left = BlockAccessor.concat([ray_tpu_torch.get(r) for r in all_refs])
            right = BlockAccessor.concat(
                [ray_tpu_torch.get(r) for r in execute_streaming(other._plan)]
            )
            if left.num_rows != right.num_rows:
                raise ValueError("zip requires equal row counts")
            cols = {c: left.column(c) for c in left.column_names}
            for c in right.column_names:
                name = c if c not in cols else f"{c}_1"
                cols[name] = right.column(c)
            return [ray_tpu_torch.put(pa.table(cols))]

        return self._append(AllToAll(self._plan.dag, do, "Zip"))

    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        def transform(block: Block) -> Block:
            acc = BlockAccessor(block)
            rng = np.random.default_rng(seed)
            mask = rng.random(acc.num_rows()) < fraction
            return acc.take(list(np.nonzero(mask)[0]))

        return self._append(MapBlocks(self._plan.dag, transform, label="Sample"))

    # ----------------------------------------------------------- consumption
    def iter_blocks(self) -> Iterator[Block]:
        for ref in execute_streaming(self._plan):
            yield ray_tpu_torch.get(ref)

    def iter_rows(self) -> Iterator[Row]:
        for block in self.iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def iter_batches(
        self,
        *,
        batch_size: int = DEFAULT_BATCH_SIZE,
        batch_format: str = "numpy",
        drop_last: bool = False,
    ) -> Iterator[TUnion[Batch, pa.Table]]:
        from ray_tpu_torch.data.iterator import batches_from_blocks

        yield from batches_from_blocks(
            self.iter_blocks(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last)

    def take(self, n: int = 20) -> List[Row]:
        out: List[Row] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Row]:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def to_pandas(self):
        return BlockAccessor.concat(list(self.iter_blocks())).to_pandas()

    def to_arrow(self) -> pa.Table:
        return BlockAccessor.concat(list(self.iter_blocks()))

    def materialize(self) -> "Dataset":
        refs = list(execute_streaming(self._plan))
        return Dataset(LogicalPlan(InputData(refs)))

    def iterator(self):
        from ray_tpu_torch.data.iterator import DataIterator

        return DataIterator(self)

    def streaming_split(self, n: int, *, equal: bool = False):
        """N iterators over ONE coordinated streaming execution with
        DYNAMIC block assignment (work stealing) — not a static split
        (reference: _internal/iterator/stream_split_iterator.py).
        ``equal=True`` keeps consumers within one block of each other."""
        from ray_tpu_torch.data.stream_split import make_stream_split

        return make_stream_split(self._plan, n, equal)

    # ---------------------------------------------------------------- writes
    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            if block.num_rows:
                pq.write_table(block, os.path.join(path, f"part-{i:05d}.parquet"))

    def write_csv(self, path: str) -> None:
        import pyarrow.csv as pcsv

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            if block.num_rows:
                pcsv.write_csv(block, os.path.join(path, f"part-{i:05d}.csv"))

    def write_json(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        import json

        for i, block in enumerate(self.iter_blocks()):
            if block.num_rows:
                with open(os.path.join(path, f"part-{i:05d}.jsonl"), "w") as f:
                    for row in BlockAccessor(block).iter_rows():
                        f.write(json.dumps(_jsonable(row)) + "\n")

    # ------------------------------------------------------------ aggregates
    def sum(self, on: str):
        return self._agg("sum", on)

    def min(self, on: str):
        return self._agg("min", on)

    def max(self, on: str):
        return self._agg("max", on)

    def mean(self, on: str):
        import pyarrow.compute as pc

        total, count = 0.0, 0
        for block in self.iter_blocks():
            if block.num_rows:
                total += pc.sum(block.column(on)).as_py() or 0
                count += block.num_rows
        return total / count if count else None

    def std(self, on: str):
        vals = np.concatenate(
            [BlockAccessor(b).to_numpy([on])[on] for b in self.iter_blocks() if b.num_rows]
        )
        return float(np.std(vals, ddof=1))

    def _agg(self, op: str, on: str):
        import pyarrow.compute as pc

        vals = []
        for block in self.iter_blocks():
            if block.num_rows:
                vals.append(getattr(pc, op)(block.column(on)).as_py())
        if not vals:
            return None
        if op == "sum":
            return sum(vals)
        return max(vals) if op == "max" else min(vals)


def _jsonable(row: Row) -> Row:
    out = {}
    for k, v in row.items():
        if isinstance(v, (np.generic,)):
            v = v.item()
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[k] = v
    return out


def _format_batch(block: Block, batch_format: str):
    acc = BlockAccessor(block)
    if batch_format == "numpy":
        return acc.to_numpy()
    if batch_format == "pandas":
        return acc.to_pandas()
    if batch_format in ("pyarrow", "arrow"):
        return block
    raise ValueError(f"unknown batch_format {batch_format}")


class GroupedData:
    """Reference: ``python/ray/data/grouped_data.py``."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _grouped(self) -> Dict[Any, pa.Table]:
        table = self._ds.to_arrow()
        import pyarrow.compute as pc

        keys = table.column(self._key).to_pylist()
        idx_by_key: Dict[Any, List[int]] = {}
        for i, k in enumerate(keys):
            idx_by_key.setdefault(k, []).append(i)
        return {k: table.take(pa.array(ix)) for k, ix in sorted(idx_by_key.items(), key=lambda kv: str(kv[0]))}

    def count(self) -> Dataset:
        rows = [
            {self._key: k, "count()": t.num_rows} for k, t in self._grouped().items()
        ]
        return from_items(rows)

    def _agg(self, op: str, on: str, label: str) -> Dataset:
        import pyarrow.compute as pc

        rows = []
        for k, t in self._grouped().items():
            rows.append({self._key: k, label: getattr(pc, op)(t.column(on)).as_py()})
        return from_items(rows)

    def sum(self, on: str) -> Dataset:
        return self._agg("sum", on, f"sum({on})")

    def min(self, on: str) -> Dataset:
        return self._agg("min", on, f"min({on})")

    def max(self, on: str) -> Dataset:
        return self._agg("max", on, f"max({on})")

    def mean(self, on: str) -> Dataset:
        return self._agg("mean", on, f"mean({on})")

    def map_groups(self, fn: Callable[[pa.Table], Any]) -> Dataset:
        outs = []
        for _, t in self._grouped().items():
            out = fn(t)
            outs.append(BlockAccessor.batch_to_block(out))
        refs = [ray_tpu_torch.put(b) for b in outs]
        return Dataset(LogicalPlan(InputData(refs)))


# ---------------------------------------------------------------------------
# read_api (reference: python/ray/data/read_api.py)
# ---------------------------------------------------------------------------

def from_items(items: List[Any], *, override_num_blocks: Optional[int] = None) -> Dataset:
    n_blocks = override_num_blocks or max(1, min(len(items) // 1000, 64)) if items else 1
    chunks = np.array_split(np.arange(len(items)), n_blocks)
    refs = [
        ray_tpu_torch.put(BlockAccessor.from_items([items[i] for i in chunk]))
        for chunk in chunks
        if len(chunk)
    ] or [ray_tpu_torch.put(BlockAccessor.from_items([]))]
    return Dataset(LogicalPlan(InputData(refs, num_rows=len(items))))


def range(n: int, *, override_num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    n_blocks = override_num_blocks or max(1, min(n // 50_000, 64))
    bounds = np.linspace(0, n, n_blocks + 1, dtype=np.int64)

    def make_task(lo: int, hi: int):
        def read():
            return BlockAccessor.from_numpy({"id": np.arange(lo, hi, dtype=np.int64)})

        return read

    tasks = [make_task(int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    return Dataset(LogicalPlan(Read(tasks, num_rows=n)))


def from_pandas(df) -> Dataset:
    return Dataset(LogicalPlan(InputData([ray_tpu_torch.put(BlockAccessor.from_pandas(df))])))


def from_numpy(arr: TUnion[np.ndarray, Dict[str, np.ndarray]]) -> Dataset:
    return Dataset(LogicalPlan(InputData([ray_tpu_torch.put(BlockAccessor.from_numpy(arr))])))


def from_arrow(table: pa.Table) -> Dataset:
    return Dataset(LogicalPlan(InputData([ray_tpu_torch.put(table)])))


def _expand_paths(paths: TUnion[str, List[str]], suffix: str) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(_glob.glob(os.path.join(p, f"*{suffix}"))))
        elif "*" in p:
            files.extend(sorted(_glob.glob(p)))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no files match {paths}")
    return files


def read_parquet(paths: TUnion[str, List[str]], *,
                 ray_remote_args: Optional[Dict[str, Any]] = None,
                 **kw) -> Dataset:
    """One read task a file; ``ray_remote_args`` are the read tasks'
    options (e.g. a ``scheduling_strategy``), as in the reference."""
    files = _expand_paths(paths, ".parquet")

    def make_task(f: str):
        def read():
            import pyarrow.parquet as pq

            return pq.read_table(f)

        return read

    return Dataset(LogicalPlan(Read([make_task(f) for f in files],
                                    ray_remote_args=ray_remote_args)))


def read_csv(paths: TUnion[str, List[str]], **kw) -> Dataset:
    files = _expand_paths(paths, ".csv")

    def make_task(f: str):
        def read():
            import pyarrow.csv as pcsv

            return pcsv.read_csv(f)

        return read

    return Dataset(LogicalPlan(Read([make_task(f) for f in files])))


def read_json(paths: TUnion[str, List[str]], **kw) -> Dataset:
    files = _expand_paths(paths, ".jsonl")

    def make_task(f: str):
        def read():
            import json

            with open(f) as fh:
                rows = [json.loads(line) for line in fh if line.strip()]
            return BlockAccessor.from_items(rows)

        return read

    return Dataset(LogicalPlan(Read([make_task(f) for f in files])))


def read_numpy(paths: TUnion[str, List[str]], **kw) -> Dataset:
    files = _expand_paths(paths, ".npy")

    def make_task(f: str):
        def read():
            return BlockAccessor.from_numpy(np.load(f))

        return read

    return Dataset(LogicalPlan(Read([make_task(f) for f in files])))
