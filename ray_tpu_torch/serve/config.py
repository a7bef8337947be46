"""Serve configuration schemas.

The port's copy of ``ray_tpu/serve/config.py``: plain dataclasses with the
JAX package's fields, defaults and validation (``__post_init__``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Reference: ``serve/config.py AutoscalingConfig`` — replicas scale on
    ongoing-requests-per-replica (``autoscaling_policy.py``), extended here
    with SLO-driven signals the controller's :class:`SLOPolicy` consumes:
    queue/KV pressure targets, a p99-TTFT objective, idle scale-to-min, and
    a hysteresis dead-band so small load wiggles don't flap replicas."""

    min_replicas: int = 1
    max_replicas: int = 10
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0
    # SLO-driven signals (serve/autoscaling.py). Queue depth / KV occupancy
    # are pressure targets per replica; ttft_p99_slo_s is an override — when
    # the cluster-rollup p99 TTFT breaches it, scale up even if the pressure
    # ratios look fine (latency is the objective, utilization the proxy).
    target_queue_depth: float = 4.0
    target_kv_utilization: float = 0.85
    ttft_p99_slo_s: Optional[float] = None
    # Fully idle (no ongoing, no queue, no busy slots) this long -> jump
    # straight to min_replicas instead of stepping down one at a time.
    idle_timeout_s: float = 10.0
    # Dead-band around pressure 1.0: scale up only above 1+hysteresis, down
    # only below 1-hysteresis. Prevents flapping at the boundary.
    hysteresis: float = 0.1

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError("need 0 <= min_replicas <= max_replicas")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")
        if self.target_queue_depth <= 0:
            raise ValueError("target_queue_depth must be > 0")
        if not (0.0 < self.target_kv_utilization <= 1.0):
            raise ValueError("target_kv_utilization must be in (0, 1]")
        if self.ttft_p99_slo_s is not None and self.ttft_p99_slo_s <= 0:
            raise ValueError("ttft_p99_slo_s must be > 0")
        if self.idle_timeout_s < 0:
            raise ValueError("idle_timeout_s must be >= 0")
        if not (0.0 <= self.hysteresis < 1.0):
            raise ValueError("hysteresis must be in [0, 1)")


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    user_config: Optional[Dict] = None
    health_check_period_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    # Replica actor thread pool: >1 runs requests concurrently inside ONE
    # replica (threaded actor) — required for engines that batch concurrent
    # streams (serve/llm.py continuous batching).
    max_concurrency: int = 1
    # Per-tenant admission quotas: tenant name -> max concurrently-admitted
    # requests from that tenant through one handle process ("*" = default
    # for unlisted tenants). Over-quota submits shed with
    # Saturated(reason="quota") BEFORE touching any replica, so one noisy
    # tenant can't consume another tenant's queue slots.
    tenant_quotas: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")
        if self.max_ongoing_requests <= 0:
            raise ValueError("max_ongoing_requests must be > 0")
        if self.max_concurrency <= 0:
            raise ValueError("max_concurrency must be > 0")
        if self.tenant_quotas is not None:
            for tenant, quota in self.tenant_quotas.items():
                if quota < 0:
                    raise ValueError(
                        f"tenant_quotas[{tenant!r}] must be >= 0")
