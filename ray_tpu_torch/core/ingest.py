"""Non-blocking observability ingest — staging queue for GCS reports.

``report_metrics`` / task-event appends / trace-span batches used to be
applied inline inside their RPC handlers: a slow aggregator (or a burst of
spans) parked GCS handler-pool threads mid-apply, and once the pool was
exhausted a concurrent ``request_lease`` queued behind telemetry. Here the
handler only enqueues (a deque append under one small lock) and returns;
one dedicated ``gcs-ingest`` thread drains the queue and applies to the
store. The queue is BOUNDED: overflow is dropped and counted — lagging
observability must degrade observability, never scheduling (the pattern of
the reference's ``task_event_buffer.cc`` bounded buffers).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, Tuple

from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("gcs_ingest")


class ObservabilityIngest:
    """Bounded staging queue + dedicated drain thread for store appends."""

    def __init__(self, apply: Callable[[str, tuple], None], maxlen: int):
        # apply(kind, args) performs the actual store write; exceptions are
        # swallowed per item so one malformed report can't kill the drain.
        self._apply = apply
        self._maxlen = max(1, int(maxlen))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._stopped = False
        self.dropped = 0     # items discarded because the queue was full
        self._submitted = 0  # items accepted
        self._drained = 0    # items applied (or failed) by the drain thread
        self._thread = threading.Thread(
            target=self._drain_loop, name="gcs-ingest", daemon=True)
        self._thread.start()

    def submit(self, kind: str, args: tuple) -> bool:
        """Enqueue one report; False (and a drop count bump) when full."""
        with self._lock:
            if self._stopped:
                return False
            if len(self._queue) >= self._maxlen:
                self.dropped += 1
                return False
            self._queue.append((kind, args))
            self._submitted += 1
            self._cv.notify()
            return True

    def _drain_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._stopped:
                    self._cv.wait(timeout=1.0)
                if self._stopped and not self._queue:
                    return
                batch = list(self._queue)
                self._queue.clear()
            for kind, args in batch:
                try:
                    self._apply(kind, args)
                except Exception:  # noqa: BLE001 — one bad report is dropped
                    logger.exception("ingest apply failed for %s", kind)
                with self._lock:
                    self._drained += 1
                    self._cv.notify_all()

    def flush(self, timeout: float = 2.0) -> bool:
        """Barrier: wait until everything accepted so far has been applied.
        Readers call this for read-your-writes (a test records an event
        then immediately queries it)."""
        import time

        deadline = time.monotonic() + timeout
        with self._lock:
            target = self._submitted
            while self._drained < target and not self._stopped:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=min(remaining, 0.05))
            return self._drained >= target

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"queued": len(self._queue), "dropped": self.dropped,
                    "submitted": self._submitted, "drained": self._drained}

    def stop(self) -> None:
        """Drain what's queued, then join the thread (GCS shutdown)."""
        with self._lock:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
