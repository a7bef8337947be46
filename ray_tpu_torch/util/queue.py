"""Distributed Queue — an actor-backed FIFO shared across tasks/actors.

Analog of the reference's ``python/ray/util/queue.py`` (same surface:
put/get with block/timeout, put_nowait/get_nowait, qsize/empty/full,
put_nowait_batch/get_nowait_batch, shutdown).

The port's copy of ``ray_tpu/util/queue.py``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._q: deque = deque()

    def qsize(self) -> int:
        return len(self._q)

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self._q) >= self.maxsize:
            return False
        self._q.append(item)
        return True

    def put_batch(self, items: List[Any]) -> bool:
        if self.maxsize > 0 and len(self._q) + len(items) > self.maxsize:
            return False
        self._q.extend(items)
        return True

    def get(self):
        if not self._q:
            return False, None
        return True, self._q.popleft()

    def get_batch(self, n: int):
        if len(self._q) < n:
            return False, None
        return True, [self._q.popleft() for _ in range(n)]


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        cls = ray_tpu_torch.remote(_QueueActor)
        self.maxsize = maxsize
        self.actor = cls.options(**(actor_options or {"num_cpus": 0})).remote(maxsize)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def put(self, item, block: bool = True, timeout: Optional[float] = None) -> None:
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            if ray_tpu_torch.get(self.actor.put.remote(item)):
                return
            if not block:
                raise Full
            if deadline is not None and time.monotonic() > deadline:
                raise Full
            time.sleep(0.005)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(self.actor.put_batch.remote(list(items))):
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None):
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get.remote())
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() > deadline:
                raise Empty
            time.sleep(0.005)

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        ok, items = ray_tpu_torch.get(self.actor.get_batch.remote(num_items))
        if not ok:
            raise Empty
        return items

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass
