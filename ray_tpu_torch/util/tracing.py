"""Request tracing — span contexts and span emission.

Counterpart of ``ray_tpu/util/tracing.py``: a (trace_id, span_id, sampled)
triple rides a context variable, instrumented code paths (the serve
engines' admission, prefill and decode-chunk spans) emit span events under
an explicit context, and :func:`span` opens a user span.

Cost model: with ``trace_enabled=0`` every potential span costs one flag
check. With tracing on, head-based sampling (``trace_sample_rate``) is
decided ONCE where the trace root is stamped and the decision is carried in
the context — children of an unsampled root emit nothing, so a trace is
either fully collected or not at all.

Export: a span goes to the sink :func:`set_sink` installed, if any;
otherwise into a bounded in-module buffer that a due or explicit
:func:`flush` ships as one batch to the runtime's GCS task-event stream
(``ray_tpu_torch.init``), where ``timeline(trace_id)`` reads it back. With no
runtime up the batch is dropped, logged at debug level, as the JAX module
does. Spans carry the runtime's node id as their ``node_id`` (the process id
with no runtime).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
import uuid
from typing import Callable, Iterator, Optional, Tuple

# contextvars, not threading.local: async actor methods run as tasks on a
# shared event loop, where thread-locals leak between interleaved
# coroutines — each asyncio task gets its own contextvars copy.
_CTX: contextvars.ContextVar[Optional[Tuple[str, str, bool]]] = \
    contextvars.ContextVar("ray_tpu_trace_ctx", default=None)


# Cached ``config`` accessor: these run per-request on the serve hot path,
# where a sys.modules lookup per call is measurable.
_config_fn: Optional[Callable] = None


def _cfg() -> Callable:
    global _config_fn
    if _config_fn is None:
        from ray_tpu_torch.core.config import config as _config

        _config_fn = _config
    return _config_fn


def trace_enabled() -> bool:
    """Master gate — the one flag check every potential span costs when
    tracing is off."""
    try:
        config = _cfg()
        return bool(config().trace_enabled)
    except ValueError:  # a malformed env override: trace nothing
        return False


def current_context() -> Optional[Tuple[str, str, bool]]:
    """(trace_id, span_id, sampled) active in this context, or None."""
    return _CTX.get()


def set_context(ctx: Optional[tuple]) -> None:
    # Accept (trace_id, span_id) pairs: absent a carried decision the
    # trace counts as sampled.
    if ctx is not None and len(ctx) < 3:
        ctx = (ctx[0], ctx[1], True)
    _CTX.set(ctx)


def is_sampled() -> bool:
    """True iff a context is active AND its root sampled this trace."""
    ctx = _CTX.get()
    return bool(ctx is not None and ctx[2])


# Dedicated PRNG for span ids: uuid4 costs ~1.5µs of os.urandom per id and
# a traced serve request mints half a dozen — a seeded Mersenne generator is
# ~10x cheaper and ids need uniqueness, not cryptographic strength. The pid
# check reseeds forked children so parent and child streams diverge.
_rand = random.Random(uuid.uuid4().int)
_rand_pid = os.getpid()


def _new_id() -> str:
    global _rand_pid
    pid = os.getpid()
    if pid != _rand_pid:
        _rand_pid = pid
        _rand.seed(uuid.uuid4().int ^ pid)
    return f"{_rand.getrandbits(64):016x}"


def new_span_id() -> str:
    """A fresh span id — for callers that pre-allocate a span's identity
    (install it as the parent of nested work) and emit() it at finish."""
    return _new_id()


def _decide_sampled() -> bool:
    """Head-based sampling decision — made exactly once, at a trace root."""
    try:
        config = _cfg()
        rate = float(config().trace_sample_rate)
    except ValueError:  # a malformed env override: the default rate
        rate = 1.0
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return _rand.random() < rate


def new_root_context() -> Optional[Tuple[str, str, bool]]:
    """Stamp a fresh trace root: None when tracing is gated off, else a
    (trace_id, root_span_id, sampled) triple with the sampling decision
    baked in. The caller owns installing/restoring it via set_context."""
    if not trace_enabled():
        return None
    return (_new_id(), _new_id(), _decide_sampled())


def child_context(ctx: Tuple[str, str, bool], span_id: str) -> Tuple[str, str, bool]:
    """Context for work nested under ``span_id`` of ``ctx``'s trace."""
    return (ctx[0], span_id, ctx[2])


def _runtime():
    """The runtime, or None when none is up."""
    from ray_tpu_torch.core import runtime as _rt_mod

    return _rt_mod._global_runtime


def _node_id() -> str:
    """The runtime's node id when one is attached (timeline lanes then group
    spans by node like task events); the process id otherwise. Read per
    emit: ``current_node_id`` depends on the executing thread (a worker
    thread reports the virtual node it runs on)."""
    rt = _runtime()
    if rt is not None:
        return rt.current_node_id.hex()
    return f"pid-{os.getpid()}"


# ====================== batched span export ======================

# Per-process sink override: worker processes point this at their
# _TaskEventBuffer.record so spans ride the existing batched
# record_task_events notify pipeline instead of per-span RPCs.
_SINK: Optional[Callable[[dict], None]] = None


def set_sink(sink: Optional[Callable[[dict], None]]) -> None:
    global _SINK
    _SINK = sink


class _SpanBuffer:
    """Batched export: spans accumulate locally and ship as one batch when
    the buffer fills or goes stale — checked at emit time (no flusher
    thread to leak) plus an explicit :func:`flush`."""

    FLUSH_MAX = 64
    FLUSH_INTERVAL_S = 0.5
    MAX_BUFFER = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._buf: list = []
        self._last_flush = time.monotonic()

    def record(self, event: dict) -> None:
        with self._lock:
            if len(self._buf) < self.MAX_BUFFER:
                self._buf.append(event)
            due = (len(self._buf) >= self.FLUSH_MAX
                   or time.monotonic() - self._last_flush
                   >= self.FLUSH_INTERVAL_S)
            if not due:
                return
            batch, self._buf = self._buf, []
            self._last_flush = time.monotonic()
        _ship(batch)

    def flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
            self._last_flush = time.monotonic()
        if batch:
            _ship(batch)


_BUFFER = _SpanBuffer()


def _ship(batch: list, runtime=None) -> None:
    """Ship a batch into the GCS task-event stream of ``runtime`` (else of
    the runtime that is up) in one call; with no runtime the batch is
    dropped, logged at debug level."""
    rt = runtime if runtime is not None else _runtime()
    if rt is None:
        from ray_tpu_torch.utils.logging import get_logger

        get_logger("tracing").debug(
            "dropped %d span(s): no runtime to ship them to", len(batch))
        return
    record_batch = getattr(rt.gcs, "record_task_events", None)
    if record_batch is not None:
        record_batch(batch)
    else:
        for event in batch:
            rt.gcs.record_task_event(event)


def _record(event: dict, runtime=None) -> None:
    if runtime is not None:
        # An explicit runtime (a driver's CoreWorker, a test's sink) gets
        # the span now: the caller named the destination.
        _ship([event], runtime)
        return
    if _SINK is not None:
        try:
            _SINK(event)
        except Exception:  # noqa: BLE001 — tracing must never break work
            from ray_tpu_torch.utils.logging import get_logger, log_swallowed

            log_swallowed(get_logger("tracing"), "span sink")
        return
    _BUFFER.record(event)


def flush() -> None:
    """Ship any buffered spans now (see :func:`_ship`)."""
    _BUFFER.flush()


# ====================== span emission ======================

def emit(name: str, ctx: Optional[tuple], *,
         duration: float, end_time: Optional[float] = None,
         parent_span_id: Optional[str] = None,
         span_id: Optional[str] = None,
         attrs: Optional[dict] = None) -> Optional[str]:
    """Emit one finished span under an EXPLICIT context — for code that
    tracks many concurrent requests on one thread (the LLM engine's slot
    loop, DAG stage loops), where the ambient contextvar belongs to a
    different request than the span being recorded.

    ``ctx`` is a (trace_id, span_id, sampled) triple; the span parents to
    ``ctx``'s span unless ``parent_span_id`` overrides. Returns the new
    span id, or None when the trace is unsampled / ctx is absent."""
    if ctx is None or (len(ctx) > 2 and not ctx[2]):
        return None
    sid = span_id or _new_id()
    now = end_time if end_time is not None else time.time()
    event = {
        "task_id": sid,
        "name": name,
        "state": "FINISHED",
        "kind": "span",
        "time": now,
        "duration": max(0.0, float(duration)),
        "trace_id": ctx[0],
        "parent_span_id": (parent_span_id if parent_span_id is not None
                           else ctx[1]),
        "node_id": _node_id(),
    }
    if attrs:
        event["attrs"] = attrs
    _record(event)
    return sid


@contextlib.contextmanager
def span(name: str, *, runtime=None,
         attrs: Optional[dict] = None) -> Iterator[Tuple[str, str]]:
    """Open a user span: child of the active context (a fresh trace root
    otherwise, with the head-based sampling decision made here). Work
    inside inherits the span as parent. The span event is recorded —
    unless the root decided not to sample, in which case the context still
    propagates (children inherit the negative decision) but nothing is
    emitted."""
    parent = current_context()
    if parent is not None:
        trace_id, sampled = parent[0], (len(parent) < 3 or parent[2])
    else:
        trace_id = _new_id()
        sampled = trace_enabled() and _decide_sampled()
    span_id = _new_id()
    set_context((trace_id, span_id, sampled))
    # Duration comes from the monotonic clock (immune to NTP steps /
    # wall-clock adjustments mid-span); the event timestamp stays wall time
    # so spans line up with the engines' emitted spans.
    started_mono = time.monotonic()
    try:
        yield (trace_id, span_id)
    finally:
        set_context(parent)
        if sampled:
            event = {
                "task_id": span_id,
                "name": name,
                "state": "FINISHED",
                "kind": "span",
                "time": time.time(),
                "duration": time.monotonic() - started_mono,
                "trace_id": trace_id,
                "parent_span_id": parent[1] if parent else None,
                "node_id": _node_id(),
            }
            if attrs:
                event["attrs"] = attrs
            try:
                _record(event, runtime)
            except Exception:  # noqa: BLE001 — tracing must never break work
                from ray_tpu_torch.utils.logging import (get_logger,
                                                         log_swallowed)

                log_swallowed(get_logger("tracing"), "span finalize")


def context_for_spec() -> Optional[Tuple[str, str, bool]]:
    """What a submitting call should stamp into the TaskSpec."""
    return current_context()
