"""Per-tenant admission quotas for serve handles.

The port's copy of ``ray_tpu/serve/admission.py``.

Layered ON TOP of the replica-queue shed (:class:`Saturated` with
``reason="saturated"`` from the router/engine): quotas bound how many
requests each tenant may have concurrently admitted THROUGH ONE HANDLE
PROCESS, so a single noisy tenant saturates its own quota instead of every
replica's admission queue, and the other tenants' SLO attainment holds.

Quotas come from ``DeploymentConfig.tenant_quotas`` (tenant name -> max
in-flight; ``"*"`` is the default for unlisted tenants) and flow to handles
through the controller snapshot, so ``serve.run`` updates apply live.
Enforcement is per client process by design — the ledger sits in front of
the router, shedding BEFORE any replica RPC, which keeps the hot path
lock-cheap and needs no cross-client coordination; cluster-exact global
quotas would need a shared counter on the data plane.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.serve.errors import Saturated

__all__ = ["TenantAdmission"]


class TenantAdmission:
    """In-flight-per-tenant ledger with quota enforcement.

    ``acquire`` returns an idempotent release callable the response object
    invokes on completion (success, error, or generator close) — the same
    finish path that decrements the router's ongoing count. A resubmit
    after a replica death does NOT re-acquire: the tenant's admission
    survives the retry.
    """

    def __init__(self, quotas: Optional[Dict[str, float]] = None):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._quotas: Optional[Dict[str, float]] = (
            dict(quotas) if quotas else None)

    def update(self, quotas: Optional[Dict[str, float]]) -> None:
        """Adopt a new quota table (controller snapshot refresh). In-flight
        counts carry over; only the limits change."""
        with self._lock:
            self._quotas = dict(quotas) if quotas else None

    def quota_for(self, tenant: Optional[str]) -> Optional[float]:
        q = self._quotas
        if q is None or tenant is None:
            return None
        if tenant in q:
            return q[tenant]
        return q.get("*")

    def in_flight(self, tenant: str) -> int:
        with self._lock:
            return self._counts.get(tenant, 0)

    def acquire(self, tenant: Optional[str],
                deployment: str = "") -> Optional[Callable[[], None]]:
        """Admit one request for ``tenant``; returns the release callable,
        or None when no quota applies (nothing to release). Raises
        :class:`Saturated` with ``reason="quota"`` when the tenant is at
        its limit — ``retry_after_s`` estimates the drain time of the
        overage at one admitted-item service time per slot."""
        quota = self.quota_for(tenant)
        if quota is None:
            return None
        with self._lock:
            cur = self._counts.get(tenant, 0)
            if cur + 1 > quota:
                overage = cur + 1 - quota
                raise Saturated(
                    f"deployment {deployment}: tenant {tenant!r} has {cur} "
                    f"requests in flight (quota {quota:g})",
                    reason="quota",
                    retry_after_s=overage
                    * config().serve_retry_after_item_s)
            self._counts[tenant] = cur + 1

        released = [False]

        def release() -> None:
            with self._lock:
                if released[0]:
                    return
                released[0] = True
                left = self._counts.get(tenant, 0) - 1
                if left > 0:
                    self._counts[tenant] = left
                else:
                    self._counts.pop(tenant, None)

        return release
