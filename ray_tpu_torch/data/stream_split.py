"""Coordinated streaming split — N consumers over ONE executing pipeline.

Analog of the reference's
``python/ray/data/_internal/iterator/stream_split_iterator.py``: a
coordinator actor owns the streaming execution and assigns output blocks to
consumers DYNAMICALLY on demand (first-come-first-served work stealing), so
a slow Train rank doesn't strand blocks pre-assigned to it the way a static
``split()`` does. Every block goes to exactly one consumer.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor


class _SplitCoordinatorImpl:
    """Owns one streaming execution; hands each output block to whichever
    consumer asks next. ``equal=True`` throttles a consumer that runs more
    than one block ahead of the most-behind ACTIVE consumer (ranks that
    called ``finish`` stop counting, so stragglers can't wedge the rest)."""

    def __init__(self, plan, n: int, equal: bool):
        from ray_tpu_torch.data.executor import execute_streaming

        self._it: Iterator[Any] = execute_streaming(plan)
        self._n = n
        self._equal = equal
        self._counts = [0] * n
        self._active = [True] * n
        self._lock = threading.Lock()

    def get_next(self, idx: int) -> Optional[list]:
        """Next block for consumer ``idx`` (boxed so the ref rides the
        borrower protocol), or None at end of stream."""
        with self._lock:
            if self._equal:
                floor = min(
                    (c for c, a in zip(self._counts, self._active) if a),
                    default=self._counts[idx])
                if self._counts[idx] - floor > 1:
                    return ["__wait__"]
            ref = next(self._it, None)
            if ref is None:
                self._active[idx] = False
                return None
            self._counts[idx] += 1
            return [ref]

    def finish(self, idx: int) -> bool:
        with self._lock:
            self._active[idx] = False
        return True

    def counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)


from ray_tpu_torch.data.iterator import TorchBatchesMixin


class StreamSplitDataIterator(TorchBatchesMixin):
    """One consumer's view of a coordinated split (duck-types
    ``DataIterator``)."""

    def __init__(self, coordinator, idx: int):
        self._coord = coordinator
        self._idx = idx

    # Max seconds to sit behind the equal-split throttle before giving up —
    # a peer that crashed (or stopped iterating) without finish() must not
    # wedge healthy consumers forever.
    EQUAL_WAIT_TIMEOUT_S = 300.0

    # -- block stream --------------------------------------------------------
    def iter_blocks(self) -> Iterator[pa.Table]:
        import time as _time

        throttle_since = None
        while True:
            box = ray_tpu_torch.get(self._coord.get_next.remote(self._idx),
                              timeout=600)
            if box is None:
                return
            if box[0] == "__wait__":  # equal-split throttle
                now = _time.time()
                throttle_since = throttle_since or now
                if now - throttle_since > self.EQUAL_WAIT_TIMEOUT_S:
                    raise TimeoutError(
                        f"streaming split {self._idx} throttled for "
                        f"{self.EQUAL_WAIT_TIMEOUT_S}s behind a consumer "
                        "that stopped iterating (call finish() on ranks "
                        "that end early)")
                _time.sleep(0.02)
                continue
            throttle_since = None
            yield ray_tpu_torch.get(box[0], timeout=600)

    def iter_batches(self, *, batch_size: int = 1024,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        from ray_tpu_torch.data.iterator import batches_from_blocks

        return batches_from_blocks(self.iter_blocks(), batch_size=batch_size,
                                   batch_format=batch_format,
                                   drop_last=drop_last)

    def iter_rows(self):
        for block in self.iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def finish(self) -> None:
        """This rank is done consuming (frees the equal-split throttle)."""
        ray_tpu_torch.get(self._coord.finish.remote(self._idx), timeout=60)

    def stats(self) -> str:
        return f"StreamSplitDataIterator(split={self._idx})"


def make_stream_split(plan, n: int, equal: bool) -> List[StreamSplitDataIterator]:
    coord_cls = ray_tpu_torch.remote(_SplitCoordinatorImpl)
    coordinator = coord_cls.options(num_cpus=0).remote(plan, n, equal)
    return [StreamSplitDataIterator(coordinator, i) for i in range(n)]
