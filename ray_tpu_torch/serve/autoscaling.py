"""SLO-driven serve autoscaling policy.

The port's copy of ``ray_tpu/serve/autoscaling.py``: ongoing-requests
tracking extended past ongoing-requests tracking into a
latency-objective control loop. The controller feeds each deployment's
:class:`SLOPolicy` a :class:`DeploymentSignals` snapshot built from the
replica ``get_state`` poll (ongoing / queue depth / engine slots / KV
blocks) plus the cluster metrics rollup's TTFT histogram, and the policy
returns the desired replica count.

Design properties the tests pin down:

- **Pure + injected time.** ``desired(current, sig, now)`` has no clocks or
  globals; unit tests drive it deterministically with synthetic timestamps.
- **Target tracking on max-pressure.** Pressure is the worst of the
  per-replica ratios (ongoing, queue depth, engine-slot / KV occupancy) vs
  their targets; desired = ceil(current * pressure), clamped to
  [min_replicas, max_replicas].
- **TTFT-violation override.** When the rollup p99 TTFT breaches
  ``ttft_p99_slo_s``, scale up by at least one replica even if utilization
  looks fine — latency is the objective, the ratios only its proxy.
- **Hysteresis + cooldown, no flapping.** A dead-band around pressure 1.0
  plus up/downscale delays: upscale waits ``upscale_delay_s`` since the
  last resize, downscale requires the low-pressure condition to HOLD for
  ``downscale_delay_s`` (a single quiet sample never kills a replica).
- **Scale-to-min on idle.** Fully idle for ``idle_timeout_s`` jumps
  straight to ``min_replicas`` instead of stepping down one at a time.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.serve.config import AutoscalingConfig
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.utils.logging import get_logger

__all__ = ["DeploymentSignals", "GangPreemption", "SLOPolicy", "TTFTRollup"]

logger = get_logger("serve_autoscaling")

# Serve's preemption class: placement groups created with a lower
# ``gang_priority`` (RL/Tune training gangs default to 0) may be revoked
# when a latency-SLO breach needs replica capacity the cluster can't place.
SERVE_GANG_PRIORITY = 100


@dataclass
class DeploymentSignals:
    """One deployment's load snapshot, as the controller sees it.

    ``ongoing`` is the handle-side EWMA of in-flight requests;
    ``queue_depth`` / ``slots_busy`` / ``slots_total`` / ``kv_*`` come from
    the replica ``get_state`` poll (engine ``stats()``); ``ttft_p99_s`` is
    the windowed cluster-rollup quantile (None when no traffic landed in
    the window or metrics are disabled).
    """

    replicas: int
    ongoing: float = 0.0
    queue_depth: float = 0.0
    slots_busy: float = 0.0
    slots_total: float = 0.0
    kv_active: float = 0.0
    kv_total: float = 0.0
    ttft_p99_s: Optional[float] = None

    def idle(self) -> bool:
        return (self.ongoing <= 0.0 and self.queue_depth <= 0.0
                and self.slots_busy <= 0.0)


class SLOPolicy:
    """Per-deployment scaling decision state machine (see module docs)."""

    def __init__(self, config: AutoscalingConfig):
        self.config = config
        self._last_resize_t: float = float("-inf")
        # When the downscale condition FIRST became continuously true;
        # None while pressure is normal/high.
        self._low_since: Optional[float] = None
        # When the deployment FIRST became continuously idle.
        self._idle_since: Optional[float] = None
        # Drain-by-migration pacing (cluster KV tier): retire at most ONE
        # replica per downscale decision so each victim gets a migration
        # target and the controller never drains two replicas into each
        # other. Set by the controller when the tier is on; the
        # downscale_delay_s cooldown then paces the steps.
        self.drain_single_step: bool = False

    # -- signal math ----------------------------------------------------------

    def pressure(self, sig: DeploymentSignals) -> float:
        """Worst per-replica load ratio vs its target. 1.0 = exactly at
        target; >1 wants more replicas, <1 wants fewer."""
        c = self.config
        n = max(1, sig.replicas)
        ratios = [sig.ongoing / (n * c.target_ongoing_requests)]
        if c.target_queue_depth > 0:
            ratios.append(sig.queue_depth / (n * c.target_queue_depth))
        if sig.slots_total > 0:
            ratios.append(
                (sig.slots_busy / sig.slots_total) / c.target_kv_utilization)
        if sig.kv_total > 0:
            ratios.append(
                (sig.kv_active / sig.kv_total) / c.target_kv_utilization)
        return max(ratios)

    def ttft_violated(self, sig: DeploymentSignals) -> bool:
        c = self.config
        return (c.ttft_p99_slo_s is not None
                and sig.ttft_p99_s is not None
                and sig.ttft_p99_s > c.ttft_p99_slo_s)

    # -- decision -------------------------------------------------------------

    def desired(self, current: int, sig: DeploymentSignals,
                now: Optional[float] = None) -> int:
        """Desired replica count for this evaluation. Stateful only in the
        cooldown/hold timers; everything else derives from ``sig``."""
        if now is None:
            now = time.monotonic()
        c = self.config
        lo, hi = c.min_replicas, c.max_replicas
        current = max(lo, min(hi, current))

        # Idle tracking: fully quiet for idle_timeout_s -> min_replicas.
        if sig.idle():
            if self._idle_since is None:
                self._idle_since = now
            if (now - self._idle_since >= c.idle_timeout_s
                    and current > lo):
                self._low_since = None
                self._last_resize_t = now
                if self.drain_single_step:
                    return max(lo, current - 1)
                return lo
        else:
            self._idle_since = None

        p = self.pressure(sig)
        violated = self.ttft_violated(sig)

        if p > 1.0 + c.hysteresis or violated:
            self._low_since = None
            if now - self._last_resize_t < c.upscale_delay_s:
                return current
            target = min(hi, max(1, math.ceil(current * p)))
            if violated:
                # Latency breach: grow by at least one even when the
                # utilization ratios sit inside the dead-band.
                target = max(target, current + 1)
            target = min(hi, target)
            if target > current:
                self._last_resize_t = now
                return target
            return current

        if p < 1.0 - c.hysteresis and current > lo:
            # Low pressure must HOLD for downscale_delay_s before a replica
            # is retired, and resizes themselves are rate-limited.
            if self._low_since is None:
                self._low_since = now
            held = now - self._low_since >= c.downscale_delay_s
            cooled = now - self._last_resize_t >= c.downscale_delay_s
            if held and cooled:
                target = max(lo, min(current, math.ceil(current * p)))
                if target == current:
                    target = current - 1
                if self.drain_single_step:
                    target = max(target, current - 1)
                target = max(lo, target)
                if target < current:
                    self._last_resize_t = now
                    self._low_since = now
                    return target
            return current

        # Dead-band: inside the hysteresis window, hold steady.
        self._low_since = None
        return current


class GangPreemption:
    """SLO-pressure capacity reclaim: when the policy wants replicas the
    cluster may not be able to place, revoke lower-class gangs through the
    control plane's block-revocation path (``preempt_gangs``).

    Pure decision state like :class:`SLOPolicy` — injected time, injected
    ``preempt`` callable (the runtime RPC in production, a stub in tests).
    Rate-limited per deployment so one sustained breach doesn't strip every
    training gang in the cluster on consecutive control ticks; gated by
    ``gang_preemption_enabled``.
    """

    def __init__(self, preempt, priority: int = SERVE_GANG_PRIORITY,
                 min_interval_s: float = 5.0):
        self.preempt = preempt  # (resources, count, min_priority) -> int
        self.priority = priority
        self.min_interval_s = min_interval_s
        self._last: Dict[str, float] = {}

    def maybe_reclaim(self, deployment: str, shape: Dict[str, float],
                      count: int, now: Optional[float] = None) -> int:
        if count <= 0 or self.preempt is None:
            return 0
        if not config().gang_preemption_enabled:
            return 0
        if now is None:
            now = time.monotonic()
        if now - self._last.get(deployment, float("-inf")) < self.min_interval_s:
            return 0
        self._last[deployment] = now
        try:
            n = int(self.preempt(dict(shape), int(count), self.priority))
        except Exception:  # noqa: BLE001 — reclaim is advisory, never fatal
            logger.exception("gang preemption call failed for %s", deployment)
            return 0
        if n:
            flightrec.record("serve", deployment,
                             f"gang.preempt reclaimed {n} gang(s) "
                             f"for {count} x {shape}")
            logger.warning(
                "SLO pressure on %s: preempted %d lower-priority gang(s) "
                "to place %d replica(s) of %s", deployment, n, count, shape)
        return n


class TTFTRollup:
    """Rate-limited, delta-windowed p99 reader over the cluster metrics
    rollup's cumulative TTFT histogram.

    The exporter ships CUMULATIVE bucket counts; a raw quantile over them
    answers "p99 since process start", which never recovers after one bad
    burst. This reader keeps the previous snapshot per deployment and
    computes the quantile over the bucket DELTAS — p99 of the last window
    only — re-reading the rollup at most every ``min_interval_s``.
    """

    def __init__(self, min_interval_s: float = 1.0):
        self.min_interval_s = min_interval_s
        # deployment -> (read_time, buckets, count)
        self._prev: Dict[str, tuple] = {}
        self._value: Dict[str, Optional[float]] = {}

    def p99(self, deployment: str,
            now: Optional[float] = None) -> Optional[float]:
        if now is None:
            now = time.monotonic()
        prev = self._prev.get(deployment)
        if prev is not None and now - prev[0] < self.min_interval_s:
            return self._value.get(deployment)

        from ray_tpu_torch.core.metrics_export import cluster_histogram
        from ray_tpu_torch.util.metrics import histogram_quantile

        snap = cluster_histogram(
            "ray_tpu_serve_ttft_s",
            {"deployment": deployment, "phase": "total"})
        if snap is None:
            self._prev[deployment] = (now, None, 0)
            self._value[deployment] = None
            return None

        buckets, count = list(snap["buckets"]), int(snap["count"])
        if prev is not None and prev[1] is not None \
                and len(prev[1]) == len(buckets) and count >= prev[2]:
            delta = [max(0, b - pb) for b, pb in zip(buckets, prev[1])]
        else:
            # First read (or exporter restart reset the counters): the
            # cumulative histogram IS the window.
            delta = buckets
        self._prev[deployment] = (now, buckets, count)
        self._value[deployment] = histogram_quantile(
            0.99, snap["bounds"], delta)
        return self._value[deployment]
