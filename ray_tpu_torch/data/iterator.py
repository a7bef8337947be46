"""DataIterator — per-rank Train ingest.

Analog of the reference's ``python/ray/data/iterator.py`` (``DataIterator``,
``iter_torch_batches``), and the counterpart of ``ray_tpu/data/iterator.py``,
whose ``iter_jax_batches`` becomes ``iter_torch_batches``: host numpy
batches copied to the card (no framework tensors in the object store),
optionally laid out on the consumer's mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np


def batches_from_blocks(blocks, *, batch_size: int,
                        batch_format: str = "numpy",
                        drop_last: bool = False) -> Iterator[Any]:
    """Re-batch a stream of pyarrow blocks into fixed-size batches (the
    carry/slice loop shared by Dataset.iter_batches and the coordinated
    streaming-split iterators)."""
    from ray_tpu_torch.data.block import BlockAccessor
    from ray_tpu_torch.data.dataset import _format_batch

    carry = None
    for block in blocks:
        if carry is not None and carry.num_rows:
            block = BlockAccessor.concat([carry, block])
            carry = None
        acc = BlockAccessor(block)
        n = acc.num_rows()
        pos = 0
        while n - pos >= batch_size:
            yield _format_batch(acc.slice(pos, pos + batch_size),
                                batch_format)
            pos += batch_size
        if pos < n:
            carry = acc.slice(pos, n)
    if carry is not None and carry.num_rows and not drop_last:
        yield _format_batch(carry, batch_format)


class TorchBatchesMixin:
    """``iter_torch_batches`` over any ``iter_batches`` implementation."""

    def iter_torch_batches(
        self,
        *,
        batch_size: int = 1024,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Any = "cuda",
        pin_memory: Optional[bool] = None,
        non_blocking: bool = True,
        sharding: Optional[Tuple[Any, Sequence[Any]]] = None,
        drop_last: bool = True,
        collate_fn: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None,
    ) -> Iterator[Any]:
        """Numpy batches → tensors on ``device`` (the card by default).

        ``dtypes`` maps a column to the torch dtype it arrives as (cast on
        the device, after the upload: int32 tokens cross as int32 and reach
        the embedding as int64). For a CUDA device each column is copied
        once into a pinned buffer from torch's caching host allocator, which
        keeps the buffer until the ``non_blocking`` upload reading it has
        finished; a column never reaches ``torch.from_numpy`` uncopied, so
        no tensor outlives the block it came from. ``sharding`` is a
        ``(DeviceMesh, placements)`` pair: each column is laid out with
        ``distribute_tensor`` on that mesh, so every rank holds the global
        batch as the JAX package's single process does under a
        ``NamedSharding``."""
        import torch

        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "iter_torch_batches: no CUDA device is available; pass "
                "device=\"cpu\" to take the batches on the host")
        if pin_memory is None:
            pin_memory = dev.type == "cuda"
        if pin_memory and dev.type != "cuda":
            raise ValueError("iter_torch_batches: pin_memory is for a CUDA "
                             f"device, not {dev}")
        if sharding is not None:
            from torch.distributed.tensor import distribute_tensor

            mesh, placements = sharding
            if torch.device(mesh.device_type).type != dev.type:
                raise ValueError(
                    f"iter_torch_batches: the mesh is on {mesh.device_type} "
                    f"but device={device!r}")
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            if collate_fn is not None:
                yield collate_fn(batch)
                continue
            out = {}
            for k, v in batch.items():
                t = _to_device(torch, v, dev, pin_memory, non_blocking)
                want = dtypes.get(k) if dtypes else None
                if want is not None and t.dtype != want:
                    t = t.to(want)
                if sharding is not None:
                    t = distribute_tensor(t, mesh, list(placements))
                out[k] = t
            yield out


def _to_device(torch, v: np.ndarray, dev, pin_memory: bool,
               non_blocking: bool):
    """One column onto ``dev``: a copy of the host array (pinned when asked),
    then one upload. A list column (an object array of equal-length rows)
    is stacked first."""
    v = np.asarray(v)
    if v.dtype == object:
        v = np.stack(v)
    if pin_memory:
        host = torch.empty(v.shape, dtype=_torch_dtype(torch, v.dtype),
                           pin_memory=True)
        host.numpy()[...] = v
        return host.to(dev, non_blocking=non_blocking)
    host = torch.from_numpy(np.array(v, copy=True))
    return host if dev.type == "cpu" else host.to(dev)


def _torch_dtype(torch, dtype: np.dtype):
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class DataIterator(TorchBatchesMixin):
    def __init__(self, dataset):
        self._ds = dataset

    def iter_batches(self, **kw) -> Iterator[Dict[str, np.ndarray]]:
        return self._ds.iter_batches(**kw)

    def iter_rows(self):
        return self._ds.iter_rows()

    def materialize(self):
        return self._ds.materialize()

    def stats(self) -> str:
        return f"DataIterator over {self._ds!r}"
