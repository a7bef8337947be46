"""Blocks — the unit of data movement (Arrow tables in the object store).

Analog of the reference's block model (``python/ray/data/block.py``,
``_internal/arrow_block.py``): a Dataset is a list of object-store refs to
Arrow tables; ``BlockAccessor`` is the typed facade over a block. Arrow
columns convert to numpy for the card's ingest path (host numpy → a pinned
copy → one ``non_blocking`` upload, ``iterator.iter_torch_batches``).

Counterpart of ``ray_tpu/data/block.py``. ``from_numpy`` and
``batch_to_block`` also take torch tensors, as the JAX package's take JAX
arrays: a CPU tensor goes through ``.numpy()``, a CUDA tensor is copied to
the host first, and a bf16 tensor raises ``TypeError`` (numpy and pyarrow
have no bfloat16).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import pyarrow as pa

Block = pa.Table
Row = Dict[str, Any]
Batch = Dict[str, np.ndarray]


def _host_array(v) -> np.ndarray:
    """A column value as a host numpy array; torch tensors by their host
    copy (torch is imported only when the value is one)."""
    if type(v).__module__.startswith("torch"):
        import torch

        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                raise TypeError(
                    "a bfloat16 tensor cannot become a block column: numpy "
                    "and pyarrow have no bfloat16 (cast it to float32 first)")
            return v.detach().cpu().numpy()
    return np.asarray(v)


class BlockAccessor:
    """Reference: ``python/ray/data/block.py BlockAccessor``."""

    def __init__(self, block: Block):
        self._table = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_items(items: List[Any]) -> Block:
        if items and isinstance(items[0], Mapping):
            cols: Dict[str, List] = {}
            for it in items:
                for k, v in it.items():
                    cols.setdefault(k, []).append(v)
            arrays: Dict[str, Any] = {}
            for k, vals in cols.items():
                # MULTI-dim ndarray cells with a uniform shape become a
                # tensor column (reference: ArrowTensorArray) — plain
                # pa.table rejects them. 1-D cells stay list<T> as before:
                # a per-block uniform/ragged switch would give blocks of
                # the same column incompatible schemas and break concat.
                if (vals and isinstance(vals[0], np.ndarray)
                        and vals[0].ndim >= 2
                        and all(isinstance(v, np.ndarray)
                                and v.shape == vals[0].shape
                                and v.dtype == vals[0].dtype
                                for v in vals)):
                    arrays[k] = pa.FixedShapeTensorArray.from_numpy_ndarray(
                        np.ascontiguousarray(np.stack(vals)))
                else:
                    arrays[k] = vals
            return pa.table(arrays)
        return pa.table({"item": list(items)})

    @staticmethod
    def from_pandas(df) -> Block:
        return pa.Table.from_pandas(df, preserve_index=False)

    @staticmethod
    def from_numpy(data: Union[np.ndarray, Dict[str, np.ndarray]]) -> Block:
        if not isinstance(data, Mapping):
            data = {"data": data}
        cols = {}
        for k, v in data.items():
            v = _host_array(v)
            if v.ndim > 1:
                # Tensor column with shape preserved in the schema
                # (reference: ArrowTensorArray extension type). pyarrow
                # rejects degenerate strides (e.g. the 0-stride leading axis
                # of arr[None, ...] views), which ascontiguousarray does NOT
                # normalize for size-1 dims — copy restores standard strides.
                v = np.ascontiguousarray(v)
                if v.strides[0] < max(v.strides):
                    v = v.copy()
                cols[k] = pa.FixedShapeTensorArray.from_numpy_ndarray(v)
            else:
                cols[k] = pa.array(v)
        return pa.table(cols)

    @staticmethod
    def batch_to_block(batch: Union[Batch, "pa.Table", Any]) -> Block:
        if isinstance(batch, pa.Table):
            return batch
        if isinstance(batch, dict):
            return BlockAccessor.from_numpy(batch)
        if type(batch).__module__.startswith("torch"):
            return BlockAccessor.from_numpy(batch)
        try:
            import pandas as pd

            if isinstance(batch, pd.DataFrame):
                return BlockAccessor.from_pandas(batch)
        except ImportError:
            pass
        raise TypeError(f"cannot convert {type(batch)} to a block")

    # -- accessors -----------------------------------------------------------
    def num_rows(self) -> int:
        return self._table.num_rows

    def size_bytes(self) -> int:
        return self._table.nbytes

    def schema(self) -> pa.Schema:
        return self._table.schema

    def slice(self, start: int, end: int) -> Block:
        return self._table.slice(start, end - start)

    def take(self, indices: List[int]) -> Block:
        # Typed: an empty list would make a null-typed array, which
        # pyarrow's take refuses (a shuffle partition a block misses).
        return self._table.take(pa.array(indices, type=pa.int64()))

    def to_arrow(self) -> pa.Table:
        return self._table

    def to_pandas(self):
        return self._table.to_pandas()

    def to_numpy(self, columns: Optional[List[str]] = None) -> Batch:
        cols = columns or self._table.column_names
        return {c: self._column_to_numpy(c) for c in cols}

    def _column_to_numpy(self, name: str) -> np.ndarray:
        col = self._table.column(name)
        if isinstance(col.type, pa.FixedShapeTensorType):
            return col.combine_chunks().to_numpy_ndarray()
        try:
            return col.to_numpy(zero_copy_only=False)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            return np.asarray(col.to_pylist())

    def iter_rows(self) -> Iterable[Row]:
        # to_pylist flattens tensor-extension columns; restore their shapes.
        tensor_shapes = {
            f.name: tuple(f.type.shape)
            for f in self._table.schema
            if isinstance(f.type, pa.FixedShapeTensorType)
        }
        for batch in self._table.to_batches():
            for row in batch.to_pylist():
                for name, shape in tensor_shapes.items():
                    if row.get(name) is not None:
                        row[name] = np.asarray(row[name]).reshape(shape)
                yield row

    def select(self, columns: List[str]) -> Block:
        return self._table.select(columns)

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks if b is not None and b.num_rows >= 0]
        if not blocks:
            return pa.table({})
        try:
            return pa.concat_tables(blocks, promote_options="default")
        except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
            # Schema clash — typically tensor columns whose per-block
            # shapes differ (e.g. images of mixed sizes: each block
            # inferred its own fixed_shape_tensor type). Demote tensor
            # columns to list<...> so the union is representable; cells
            # keep their values (to_pylist), shapes are no longer carried
            # by the schema.
            demoted = []
            for b in blocks:
                cols = {}
                for name in b.column_names:
                    col = b.column(name)
                    if isinstance(col.type, pa.FixedShapeTensorType):
                        cols[name] = pa.array(
                            [v.tolist() if v is not None else None
                             for v in col.combine_chunks().to_numpy_ndarray()])
                    else:
                        cols[name] = col
                demoted.append(pa.table(cols))
            return pa.concat_tables(demoted, promote_options="default")

    def sample(self, n: int, seed: Optional[int] = None) -> Block:
        rng = np.random.default_rng(seed)
        n = min(n, self.num_rows())
        idx = rng.choice(self.num_rows(), size=n, replace=False)
        return self.take(list(idx))
