"""Autoscaler — demand-driven cluster sizing (v2 shape).

Analog of the reference's autoscaler v2 (``python/ray/autoscaler/v2/
autoscaler.py:42`` + ``scheduler.py`` bin-packing + ``instance_manager``;
SURVEY §7: "build the v2 shape only"): a reconcile loop reads pending
resource demand from the runtime (parked infeasible work), bin-packs it onto
configured node types, launches through the provider, retries the parked
work, and terminates nodes idle past the timeout (respecting min_workers).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeInstance, NodeProvider, NodeType
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("autoscaler")


@dataclass
class AutoscalerConfig:
    node_types: List[NodeType] = field(default_factory=list)
    idle_timeout_s: float = 60.0
    update_interval_s: float = 0.1
    max_launch_batch: int = 8


def _fits(resources: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(resources.get(k, 0.0) >= v for k, v in demand.items())


def bin_pack(
    demands: List[Dict[str, float]], node_types: List[NodeType],
    existing: Dict[str, int],
    pending_capacity: Optional[List[Dict[str, float]]] = None,
) -> Dict[str, int]:
    """Choose node launches covering ``demands`` (reference:
    ``resource_demand_scheduler.py`` first-fit-decreasing). Returns
    node_type -> count to launch, respecting max_workers.
    ``pending_capacity``: resources of launches already in flight (cloud
    nodes still booting) — credited against demand so a slow boot doesn't
    trigger a duplicate VM on every reconcile tick."""
    to_launch: Dict[str, int] = {}
    # virtual free capacity of planned launches (incl. in-flight boots)
    planned: List[Dict[str, float]] = [dict(c) for c in pending_capacity or ()]
    for demand in sorted(demands, key=lambda d: -sum(d.values())):
        placed = False
        for cap in planned:
            if _fits(cap, demand):
                for k, v in demand.items():
                    cap[k] -= v
                placed = True
                break
        if placed:
            continue
        for nt in node_types:
            count = existing.get(nt.name, 0) + to_launch.get(nt.name, 0)
            if count >= nt.max_workers:
                continue
            if _fits(nt.resources, demand):
                to_launch[nt.name] = to_launch.get(nt.name, 0) + 1
                cap = dict(nt.resources)
                for k, v in demand.items():
                    cap[k] -= v
                planned.append(cap)
                placed = True
                break
        if not placed:
            logger.warning("demand %s unsatisfiable by any node type", demand)
    return to_launch


class _NodeResourceView:
    """Duck-types the scheduler's NodeResources for the busy check."""

    class _Set:
        def __init__(self, d):
            self._d = dict(d)

        def to_dict(self):
            return dict(self._d)

    def __init__(self, state: Dict):
        self.total = self._Set(state["total"])
        self.available = self._Set(state["available"])


class GcsAutoscalerView:
    """Runtime adapter for a MULTIPROCESS cluster: demand and per-node
    resource state come from the GCS over RPC (the reference's
    gcs_autoscaler_state_manager report), so the same Autoscaler loop
    drives a live cluster of real daemon processes."""

    def __init__(self, core=None):
        from ray_tpu_torch.core.runtime import get_runtime

        self._core = core or get_runtime()
        self.autoscaling_enabled = False
        self.scheduler = self  # node_resources lives here

    def pending_resource_demands(self) -> List[Dict[str, float]]:
        return self._core._gcs_rpc.call("pending_resource_demands",
                                        timeout=30.0)

    def pending_block_capacity(self) -> List[Dict[str, float]]:
        """Outstanding capacity-block grants (granted to a daemon, not yet
        carved into running leases) — credited as pending capacity so a
        block in flight doesn't double-launch a node."""
        try:
            return self._core._gcs_rpc.call("pending_block_capacity",
                                            timeout=30.0)
        except Exception:  # noqa: BLE001 — older GCS without the RPC
            return []

    def retry_infeasible(self) -> None:
        # Queued lease requests wake on the GCS scheduler CV when the new
        # node registers — nothing to do driver-side.
        return None

    def node_resources(self, node_id):
        state = self._core._gcs_rpc.call(
            "node_resource_state", node_id.binary(), timeout=30.0)
        return _NodeResourceView(state) if state else None


class Autoscaler:
    def __init__(
        self,
        provider: NodeProvider,
        config: AutoscalerConfig,
        runtime=None,
    ):
        from ray_tpu_torch.core.runtime import get_runtime

        self.provider = provider
        self.config = config
        self.runtime = runtime or get_runtime()
        self._types = {nt.name: nt for nt in config.node_types}
        self._idle_since: Dict[str, float] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self.runtime.autoscaling_enabled = True
        self._running = True
        self._satisfy_min_workers()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)
        self.runtime.autoscaling_enabled = False

    def _loop(self) -> None:
        while self._running:
            try:
                self.update()
            except Exception:
                logger.exception("autoscaler update failed")
            time.sleep(self.config.update_interval_s)

    # -- one reconcile pass (reference: autoscaler.py:374 update()) ----------
    def update(self) -> None:
        demands = self.runtime.pending_resource_demands()
        existing: Dict[str, int] = {}
        pending_capacity: List[Dict[str, float]] = []
        for inst in self.provider.non_terminated_nodes():
            existing[inst.node_type] = existing.get(inst.node_type, 0) + 1
            if inst.status == "PENDING":
                # Still booting: its capacity is on the way — count it so a
                # slow cloud boot doesn't launch a duplicate every tick.
                pending_capacity.append(dict(inst.resources))
        # Granted-but-unadopted capacity blocks (batched daemon leases) are
        # capacity already carved out of the cluster for queued work: credit
        # them too, or each outstanding block reads as unmet demand and
        # double-launches a node. getattr: older runtimes lack the hook.
        block_capacity = getattr(self.runtime, "pending_block_capacity", None)
        if block_capacity is not None:
            try:
                pending_capacity.extend(
                    dict(c) for c in block_capacity() or ())
            except Exception:  # noqa: BLE001 — advisory credit only
                logger.debug("pending_block_capacity read failed",
                             exc_info=True)

        if demands:
            launches = bin_pack(demands, list(self._types.values()), existing,
                                pending_capacity=pending_capacity)
            launched = 0
            for type_name, count in launches.items():
                for _ in range(min(count, self.config.max_launch_batch)):
                    self.provider.create_node(self._types[type_name])
                    launched += 1
            if launched:
                logger.info("launched %d nodes for %d demands", launched, len(demands))
                self.runtime.retry_infeasible()

        self._terminate_idle(existing)

    def _satisfy_min_workers(self) -> None:
        existing: Dict[str, int] = {}
        for inst in self.provider.non_terminated_nodes():
            existing[inst.node_type] = existing.get(inst.node_type, 0) + 1
        for nt in self._types.values():
            for _ in range(max(0, nt.min_workers - existing.get(nt.name, 0))):
                self.provider.create_node(nt)

    def _terminate_idle(self, existing: Dict[str, int]) -> None:
        now = time.monotonic()
        for inst in list(self.provider.non_terminated_nodes()):
            if inst.node_id is None:
                continue
            nt = self._types.get(inst.node_type)
            if nt and existing.get(inst.node_type, 0) <= nt.min_workers:
                continue
            if self._node_busy(inst):
                self._idle_since.pop(inst.instance_id, None)
                continue
            first_idle = self._idle_since.setdefault(inst.instance_id, now)
            if now - first_idle >= self.config.idle_timeout_s:
                logger.info("terminating idle node %s", inst.instance_id)
                self.provider.terminate_node(inst)
                self._idle_since.pop(inst.instance_id, None)
                existing[inst.node_type] = existing.get(inst.node_type, 1) - 1

    def _node_busy(self, inst: NodeInstance) -> bool:
        """A node is busy while any of its resources are allocated."""
        nr = self.runtime.scheduler.node_resources(inst.node_id)
        if nr is None:
            return False
        total = nr.total.to_dict()
        avail = nr.available.to_dict()
        return any(avail.get(k, 0.0) < v for k, v in total.items())
