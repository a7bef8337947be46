"""Per-process metrics exporter + built-in framework metrics.

Counterpart of ``ray_tpu/core/metrics_export.py``: the :func:`metrics_enabled`
gate, the process-wide metric cache (:func:`gauge`, :func:`counter`), the
built-in constructors (task phases and states, gang placement, serve), and
the :class:`MetricsExporter` thread that snapshots this process's
:mod:`ray_tpu_torch.util.metrics` registry every ``metrics_export_interval_s``
and ships it to the runtime's GCS aggregator (:func:`cluster_histogram`
reads it back). Each built-in metric is created lazily, once per process,
under the same name, description and tag keys as the JAX package's, so one
exposition reads the same from either package. The default collectors
mirror the RPC, object-pull and collective stats into gauges at export
ticks.

Every ``observe`` at a hot path is gated on :func:`metrics_enabled` so
``metrics_export_enabled=0`` reduces instrumentation to one flag check.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.util import metrics as um
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("metrics")

# Latency-style histogram bounds (seconds): 100us .. 60s, exponential.
_LATENCY_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0)

# Batch-size histogram bounds (items per @serve.batch flush).
_BATCH_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

_metrics_lock = threading.Lock()
_metric_cache: Dict[str, um.Metric] = {}


def metrics_enabled() -> bool:
    """Gate for every built-in hot-path observation."""
    try:
        return bool(config().metrics_export_enabled)
    except ValueError:  # a malformed env override: observe nothing
        return False


def _metric(cls, name: str, desc: str = "", **kwargs) -> um.Metric:
    """Process-wide singleton per metric name (a second instance of the
    same name would duplicate series in the exposition)."""
    with _metrics_lock:
        m = _metric_cache.get(name)
        if m is None:
            m = cls(name, desc, **kwargs)
            _metric_cache[name] = m
        return m


def gauge(name: str, desc: str = "", tag_keys=()) -> um.Gauge:
    """Cached process-wide Gauge — for collectors mirroring ad-hoc stats."""
    return _metric(um.Gauge, name, desc, tag_keys=tag_keys)


def counter(name: str, desc: str = "", tag_keys=()) -> um.Counter:
    """Cached process-wide Counter — for collectors mirroring monotonic
    ad-hoc totals (inc by positive delta only)."""
    return _metric(um.Counter, name, desc, tag_keys=tag_keys)


def mirror_stats_gauge(name: str, desc: str, stats: Dict[str, float]) -> None:
    """Mirror an ad-hoc stats dict into one gauge with a ``counter`` tag per
    key — the shared shape of every stats-dict collector."""
    g = gauge(name, desc, tag_keys=("counter",))
    for key, val in stats.items():
        g.set(float(val), {"counter": key})


def gang_placement_hist() -> um.Histogram:
    """Gang placement latency, reserve→commit, tagged by planner path
    (``gang`` atomic block reservation vs ``2pc`` legacy per-bundle)."""
    return _metric(
        um.Histogram, "ray_tpu_gang_placement_s",
        "Placement-group gang placement latency (reserve to commit)",
        boundaries=_LATENCY_BOUNDS, tag_keys=("path",))


def gang_preemptions_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_gang_preemptions_total",
                   "Gangs revoked to make room for higher gang_priority "
                   "capacity (serve SLO pressure)")


def task_phase_hist() -> um.Histogram:
    return _metric(
        um.Histogram, "ray_tpu_task_phase_s",
        "Task lifecycle phase durations (queued/args_fetch/execute/total)",
        boundaries=_LATENCY_BOUNDS, tag_keys=("phase",))


def tasks_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_tasks_total",
                   "Tasks executed, by terminal state",
                   tag_keys=("state",))


def serve_request_hist() -> um.Histogram:
    return _metric(
        um.Histogram, "ray_tpu_serve_request_latency_s",
        "Serve replica request latency", boundaries=_LATENCY_BOUNDS,
        tag_keys=("deployment",))


def dag_tick_hist() -> um.Histogram:
    return _metric(
        um.Histogram, "ray_tpu_dag_tick_s",
        "Compiled-DAG tick latency (execute write to result fetch)",
        boundaries=_LATENCY_BOUNDS)


def serve_batch_hist() -> um.Histogram:
    return _metric(um.Histogram, "ray_tpu_serve_batch_size",
                   "Serve @batch flush sizes", boundaries=_BATCH_BOUNDS)


def rl_env_steps_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_rl_env_steps_total",
                   "Environment steps consumed by RL training")


def rl_learner_idle_hist() -> um.Histogram:
    return _metric(
        um.Histogram, "ray_tpu_rl_learner_idle_s",
        "Time the RL learner waits for a sample batch per consume "
        "(sum/total-time is the sampling-bound fraction)",
        boundaries=_LATENCY_BOUNDS)


def serve_ttft_hist() -> um.Histogram:
    return _metric(
        um.Histogram, "ray_tpu_serve_ttft_s",
        "LLM serving time-to-first-token (request submit to first token), "
        "phase-split: total | queued | prefill | decode | spec "
        "(spec = the fused propose+verify dispatch of the first chunk, "
        "speculative engines only)",
        boundaries=_LATENCY_BOUNDS, tag_keys=("deployment", "phase"))


def serve_tokens_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_serve_tokens_total",
                   "LLM serving decoded tokens delivered to requests",
                   tag_keys=("deployment",))


def serve_kv_hit_tokens_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_serve_kv_hit_tokens_total",
                   "Prompt tokens served from the paged KV prefix cache "
                   "(prefill FLOPs avoided)",
                   tag_keys=("deployment",))


def serve_spec_proposed_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_serve_spec_proposed_total",
                   "Draft tokens proposed by speculative decoding",
                   tag_keys=("deployment",))


def serve_spec_accepted_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_serve_spec_accepted_total",
                   "Draft tokens accepted by the target model's "
                   "speculative verify",
                   tag_keys=("deployment",))


def serve_spec_accept_ratio() -> um.Gauge:
    return _metric(um.Gauge, "ray_tpu_serve_spec_accept_ratio",
                   "Cumulative speculative-decoding acceptance ratio "
                   "(accepted / proposed draft tokens)",
                   tag_keys=("deployment",))


def serve_shed_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_serve_shed_total",
                   "Requests shed by serve admission control, by class "
                   "(saturated=admission queues over limit, quota=tenant "
                   "over its per-tenant cap)",
                   tag_keys=("deployment", "reason"))


def observe_shed(deployment: str, reason: str) -> None:
    """Count one shed request (an engine's Saturated raise)."""
    flightrec.record("serve", deployment, f"shed {reason}")
    if metrics_enabled():
        serve_shed_total().inc(1, {"deployment": deployment,
                                   "reason": reason})


def serve_kv_block_occupancy() -> um.Gauge:
    return _metric(um.Gauge, "ray_tpu_serve_kv_block_occupancy",
                   "Paged KV pool blocks by state "
                   "(active=pinned, cached=prefix-reusable, free)",
                   tag_keys=("deployment", "state"))


def serve_kv_tier_hits_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_serve_kv_tier_hits_total",
                   "Prompt tokens served warm by KV source: local=this "
                   "engine's prefix cache, store=fetched from the cluster "
                   "KV tier's spilled objects, migrated=chains shipped in "
                   "by a draining replica",
                   tag_keys=("deployment", "source"))


def serve_kv_tier_spill_bytes_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_serve_kv_tier_spill_bytes_total",
                   "KV bytes spilled to the cluster tier's object store "
                   "(chain publishes from the engine retire path)",
                   tag_keys=("deployment",))


def serve_kv_tier_fetch_bytes_total() -> um.Counter:
    return _metric(um.Counter, "ray_tpu_serve_kv_tier_fetch_bytes_total",
                   "KV bytes fetched back from the cluster tier on a "
                   "directory hit (prefill recompute avoided)",
                   tag_keys=("deployment",))


def serve_kv_spilled_blocks() -> um.Gauge:
    return _metric(um.Gauge, "ray_tpu_serve_kv_spilled_blocks",
                   "KV blocks this engine currently has published in the "
                   "cluster tier (directory entries it holds a ref on)",
                   tag_keys=("deployment",))


def cluster_histogram(name: str, tags: Dict[str, str]) -> Optional[dict]:
    """Cluster-merged cumulative histogram from the GCS aggregator —
    ``{"bounds", "buckets", "sum", "count"}`` summed across every live
    process's series matching ``tags`` (see
    :meth:`~ray_tpu_torch.util.metrics.MetricsAggregator.histogram_merged`).
    None when no runtime is up or nothing matching has been reported yet:
    callers treat the signal as absent, never as zero."""
    from ray_tpu_torch.core.exceptions import RuntimeNotInitializedError
    from ray_tpu_torch.core.runtime import get_runtime

    try:
        rt = get_runtime()
    except RuntimeNotInitializedError:
        return None
    return rt.gcs.metrics_histogram(name, dict(tags))


# Precomputed tag keys for the per-task hot path (one merge/validate/sort
# per phase name per process instead of per task execution).
_phase_keys: Dict[str, tuple] = {}
_state_keys: Dict[str, tuple] = {}


def observe_task_phases(phases: Dict[str, float],
                        ok: bool = True) -> None:
    """Record one task execution's phase durations (the runtime's execute
    paths call this with whatever phases they could stamp)."""
    if not metrics_enabled():
        return
    h = task_phase_hist()
    for phase, dur in phases.items():
        if dur is not None and dur >= 0:
            key = _phase_keys.get(phase)
            if key is None:
                key = _phase_keys[phase] = h.tag_key({"phase": phase})
            h.observe_key(dur, key)
    state = "FINISHED" if ok else "FAILED"
    skey = _state_keys.get(state)
    if skey is None:
        skey = _state_keys[state] = tasks_total().tag_key({"state": state})
    tasks_total().inc_key(1, skey)


# ---------------------------------------------------------------------------
# Default collectors: mirror existing ad-hoc stats into gauges at export time
# ---------------------------------------------------------------------------

_default_collectors_installed = False


def _collect_rpc_send_stats() -> None:
    from ray_tpu_torch.core import rpc

    mirror_stats_gauge(
        "ray_tpu_rpc_send",
        "RPC frame-send counters (frames/syscalls/bytes/batches + "
        "frames_per_syscall)", rpc.send_stats())


def _collect_pull_stats() -> None:
    from ray_tpu_torch.core import object_transfer

    mirror_stats_gauge(
        "ray_tpu_object_pull",
        "Object-plane pull counters (bytes/chunks/reassigned "
        "ranges/failed sources)", object_transfer.pull_stats())


def _collect_collective_stats() -> None:
    # Only where a collective group lives: the module is in sys.modules
    # then (importing it here would pull the parallel package into every
    # process that exports metrics).
    collectives = sys.modules.get("ray_tpu_torch.parallel.collectives")
    if collectives is None:
        return
    groups = collectives.all_group_stats()
    if not groups:
        return
    g = _metric(um.Gauge, "ray_tpu_collective_bytes",
                "Per-group collective byte counters by traffic kind",
                tag_keys=("group", "counter"))
    for name, st in groups.items():
        for key, val in st.items():
            g.set(float(val), {"group": name, "counter": key})


def ensure_default_collectors() -> None:
    """Install the process-wide collectors exactly once."""
    global _default_collectors_installed
    with _metrics_lock:
        if _default_collectors_installed:
            return
        _default_collectors_installed = True
    um.register_collector(_collect_rpc_send_stats)
    um.register_collector(_collect_pull_stats)
    um.register_collector(_collect_collective_stats)


# ---------------------------------------------------------------------------
# The exporter thread
# ---------------------------------------------------------------------------


class MetricsExporter:
    """Ships this process's registry to the GCS every export interval.

    ``report`` is ``callable(node_id, component, pid, snapshot)`` — an RPC
    notify for a cluster's processes, a direct aggregator call for the GCS
    and the in-process runtime. Failures are swallowed and
    retried next tick: reports are stateless (each carries the full
    snapshot), so a missed tick costs nothing but freshness.
    """

    def __init__(self, report: Callable[[str, str, int, list], None],
                 node_id: str, component: str,
                 collectors: Optional[List[Callable[[], None]]] = None):
        self._report = report
        self._node_id = node_id
        self._component = component
        self._collectors = list(collectors or [])
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsExporter":
        if not metrics_enabled():
            return self
        ensure_default_collectors()
        self._thread = threading.Thread(
            target=self._loop, name=f"metrics-export-{self._component}",
            daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _interval() -> float:
        return max(0.05, float(config().metrics_export_interval_s))

    def _loop(self) -> None:
        # First flush immediately: a short-lived process must appear in the
        # exposition without surviving a full interval. Then re-read the
        # interval every tick (tests shrink the cadence via env).
        self.flush()
        while not self._stop.wait(self._interval()):
            self.flush()

    def flush(self) -> None:
        """One export tick (also called directly by readers that want this
        process's own series fresh)."""
        if not metrics_enabled():
            return
        try:
            for fn in self._collectors:
                try:
                    fn()
                except Exception:  # noqa: BLE001 — a collector must never
                    log_swallowed(logger, "metrics collector")  # kill the tick
            snapshot = um.snapshot_registry()
            self._report(self._node_id, self._component, os.getpid(),
                         snapshot)
        except Exception:  # noqa: BLE001 — retried next tick
            log_swallowed(logger, "metrics export tick")

    def stop(self) -> None:
        """Join the exporter thread (with timeout), then ship the last
        partial interval's observations. Idempotent."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)
            if thread.is_alive():
                logger.warning("metrics exporter did not stop in 2s "
                               "(flush in flight); skipping final flush")
                return
            self.flush()
