"""@serve.batch — request batching for the card.

The port's copy of ``ray_tpu/serve/batching.py``: queue individual calls,
flush when ``max_batch_size`` accumulate or ``batch_wait_timeout_s``
elapses, run the wrapped function ONCE on the list, scatter results — on
the card, the difference between matmuls of batch 1 and batch 32.

The batch window is paced by ONE reusable Event-paced flusher thread per
batcher (not a fresh ``time.sleep`` thread per window): ``stop()`` /
``serve.shutdown()`` skip the window immediately instead of waiting it out,
and an idle flusher exits after a short grace so an abandoned batcher pins
no thread.
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Callable, List, Optional


def _wait_slice() -> float:
    """internal_wait_timeout_s, with its default as the fallback."""
    try:
        from ray_tpu_torch.core.config import config

        return config().internal_wait_timeout_s
    except Exception:  # noqa: BLE001 — config unavailable mid-teardown
        return 60.0


# Live batchers, for serve.shutdown() to stop their flusher threads. Weak:
# a dropped @batch function must stay collectable.
_batchers: "weakref.WeakSet[_Batcher]" = weakref.WeakSet()
_batchers_lock = threading.Lock()


def shutdown_all() -> None:
    """Stop every batcher's flusher thread (serve.shutdown calls this).
    Queued items are flushed, not dropped; a later submit restarts the
    flusher."""
    with _batchers_lock:
        live = list(_batchers)
    for b in live:
        b.stop()


class _Pending:
    __slots__ = ("value", "event", "result", "error")

    def __init__(self, value):
        self.value = value
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._flusher: Optional[threading.Thread] = None
        self._wake = threading.Event()  # new work for an idle flusher
        self._stop = threading.Event()  # skip the window and exit
        with _batchers_lock:
            _batchers.add(self)

    def submit(self, instance, value):
        p = _Pending(value)
        flush_now = False
        with self._lock:
            self._queue.append(p)
            if len(self._queue) >= self.max_batch_size:
                flush_now = True
            elif self._flusher is None or not self._flusher.is_alive():
                self._stop.clear()  # restart after a previous stop()
                self._wake.clear()
                self._flusher = threading.Thread(
                    target=self._run, args=(instance,), daemon=True
                )
                self._flusher.start()
            else:
                self._wake.set()
        if flush_now:
            self._flush(instance)
        # Timed slices with self-healing instead of an untimed park: if the
        # flusher thread died (teardown, a killed worker) the batch would
        # otherwise wait forever — re-flush inline. A legitimately slow
        # batch fn (p dequeued, result pending) just keeps waiting.
        interval = max(self.timeout_s * 2, 0.05)
        while not p.event.wait(timeout=interval):
            interval = _wait_slice()
            with self._lock:
                stuck = p in self._queue and (
                    self._flusher is None or not self._flusher.is_alive())
            if stuck:
                self._flush(instance)
        if p.error is not None:
            raise p.error
        return p.result

    def _run(self, instance):
        """Reusable window pacer: wait out one batch window (Event-paced —
        stop() skips it), flush, then park for more work; exit after an idle
        grace so an abandoned batcher leaks no thread."""
        grace = min(max(self.timeout_s * 5, 0.05), 1.0)
        while not self._stop.is_set():
            self._stop.wait(timeout=self.timeout_s)  # the batch window
            self._flush(instance)
            if self._stop.is_set():
                break
            woke = self._wake.wait(timeout=grace)
            self._wake.clear()
            if woke:
                continue
            with self._lock:
                if self._queue:
                    continue  # arrived between the timeout and the lock
                if self._flusher is threading.current_thread():
                    self._flusher = None
                return
        # Stopping: flush whatever queued so waiters aren't stranded.
        self._flush(instance)
        with self._lock:
            if self._flusher is threading.current_thread():
                self._flusher = None

    def stop(self) -> None:
        """Skip any in-progress window, flush, and join the flusher."""
        with self._lock:
            t = self._flusher
        self._stop.set()
        self._wake.set()
        if (t is not None and t.is_alive()
                and t is not threading.current_thread()):
            t.join(timeout=5.0)

    def _flush(self, instance):
        with self._lock:
            batch, self._queue = self._queue, []
        if not batch:
            return
        from ray_tpu_torch.core.metrics_export import (metrics_enabled,
                                                 serve_batch_hist)

        if metrics_enabled():
            serve_batch_hist().observe(len(batch))
        values = [p.value for p in batch]
        try:
            results = (
                self.fn(instance, values) if instance is not None else self.fn(values)
            )
            if len(results) != len(values):
                raise ValueError(
                    f"batch fn returned {len(results)} results for {len(values)} inputs"
                )
            for p, r in zip(batch, results):
                p.result = r
        except BaseException as e:  # noqa: BLE001
            for p in batch:
                p.error = e
        finally:
            for p in batch:
                p.event.set()


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 10,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorator: the wrapped fn receives a LIST of inputs and must return a
    list of equal length (reference: ``serve/batching.py``)."""

    def decorate(fn):
        batcher = _Batcher(fn, max_batch_size, batch_wait_timeout_s)

        @functools.wraps(fn)
        def wrapper(*args):
            if len(args) == 2:  # bound method: (self, value)
                return batcher.submit(args[0], args[1])
            return batcher.submit(None, args[0])

        wrapper._batcher = batcher
        return wrapper

    if _fn is not None:
        return decorate(_fn)
    return decorate
