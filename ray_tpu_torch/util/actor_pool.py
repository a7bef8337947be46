"""ActorPool — load-balanced work over a fixed set of actors.

Analog of the reference's ``python/ray/util/actor_pool.py`` (same method
surface: submit / get_next / get_next_unordered / map / map_unordered /
has_next / push / pop_idle).

The port's copy of ``ray_tpu/util/actor_pool.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending = []  # (fn, value) waiting for an idle actor

    # -- submission ----------------------------------------------------------
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending.append((fn, value))

    def _drain_pending(self) -> None:
        while self._pending and self._idle:
            fn, value = self._pending.pop(0)
            self.submit(fn, value)

    # -- retrieval -----------------------------------------------------------
    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending)

    def get_next(self, timeout: float | None = None) -> Any:
        if self._next_return_index not in self._index_to_future:
            if not self.has_next():
                raise StopIteration("no more results")
        while self._next_return_index not in self._index_to_future:
            self._drain_pending()
        ref = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        value = ray_tpu_torch.get(ref, timeout=timeout)
        self._return_actor(ref)
        return value

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        if not self.has_next():
            raise StopIteration("no more results")
        self._drain_pending()
        refs = list(self._future_to_actor)
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        for idx, f in list(self._index_to_future.items()):
            if f is ref:
                del self._index_to_future[idx]
        value = ray_tpu_torch.get(ref)
        self._return_actor(ref)
        return value

    def _return_actor(self, ref) -> None:
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None:
            self._idle.append(actor)
            self._drain_pending()

    # -- bulk ----------------------------------------------------------------
    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- membership ----------------------------------------------------------
    def push(self, actor: Any) -> None:
        self._idle.append(actor)
        self._drain_pending()

    def pop_idle(self) -> Any | None:
        return self._idle.pop() if self._idle else None

    def has_free(self) -> bool:
        return bool(self._idle)
