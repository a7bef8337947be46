"""Built-in framework metrics: the serve engines' instances.

Counterpart of ``ray_tpu/core/metrics_export.py``, the part used in-process:
the :func:`metrics_enabled` gate, the process-wide metric cache
(:func:`gauge`, :func:`counter`) and the serve constructors the engines
observe through. Each built-in metric is created lazily, once per process,
under the same name, description and tag keys as the JAX package's, so one
exposition reads the same from either package.

The per-process ``MetricsExporter`` thread, the default stats collectors and
``cluster_histogram`` ship to or read from the GCS, which comes with the
core runtime (ROADMAP Queue 1); until then the series stay in this
process's :mod:`ray_tpu_torch.util.metrics` registry.

Every ``observe`` at a hot path is gated on :func:`metrics_enabled` so
``metrics_export_enabled=0`` reduces instrumentation to one flag check.
"""

from __future__ import annotations

import threading
from typing import Dict

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.util import metrics as um

# Latency-style histogram bounds (seconds): 100us .. 60s, exponential.
_LATENCY_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0)

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
