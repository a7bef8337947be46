"""Cluster scheduling policies — node selection for tasks/actors/bundles.

Analog of the reference's scheduler stack
(``src/ray/raylet/scheduling/cluster_resource_scheduler.cc:141
GetBestSchedulableNode`` with pluggable policies under
``scheduling/policy/``): hybrid (default), spread, node-affinity, node-label,
and the bundle policies used for placement groups
(``bundle_scheduling_policy.cc`` — PACK/SPREAD/STRICT_PACK/STRICT_SPREAD).

The hybrid policy follows the reference's documented design
(``hybrid_scheduling_policy.h:28-48``): score each node by critical-resource
utilization, truncated to 0 below ``scheduler_spread_threshold`` so lightly
loaded nodes tie; prefer available (can run now) over merely feasible; pick
randomly among the top-k tied best to avoid herd behavior.

The port's copy of ``ray_tpu/core/scheduler.py``.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import NodeID
from ray_tpu_torch.core.resources import NodeResources, ResourceSet, topology_of
from ray_tpu_torch.core.task_spec import (
    DefaultSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SchedulingStrategy,
    SpreadSchedulingStrategy,
)


class ClusterResourceScheduler:
    """Tracks every node's load and answers 'which node should run this?'."""

    def __init__(self):
        self._lock = threading.Lock()
        self._nodes: Dict[NodeID, NodeResources] = {}
        self._spread_rr = 0  # round-robin cursor for the spread policy

    # -- membership -----------------------------------------------------------

    def add_node(self, node_id: NodeID, resources: NodeResources) -> None:
        with self._lock:
            self._nodes[node_id] = resources

    def remove_node(self, node_id: NodeID) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def node_resources(self, node_id: NodeID) -> Optional[NodeResources]:
        with self._lock:
            return self._nodes.get(node_id)

    def nodes(self) -> Dict[NodeID, NodeResources]:
        with self._lock:
            return dict(self._nodes)

    def available_resources(self) -> Dict[str, float]:
        with self._lock:
            total = ResourceSet()
            for nr in self._nodes.values():
                total = total + nr.available
            return total.to_dict()

    # -- allocation ------------------------------------------------------------

    def try_allocate(self, node_id: NodeID, request: ResourceSet) -> bool:
        with self._lock:
            nr = self._nodes.get(node_id)
            if nr is None or not nr.can_fit(request):
                return False
            nr.allocate(request)
            return True

    def release(self, node_id: NodeID, request: ResourceSet) -> None:
        with self._lock:
            nr = self._nodes.get(node_id)
            if nr is not None:
                nr.release(request)

    def any_can_fit(self, request: ResourceSet) -> bool:
        """True iff some node could run ``request`` RIGHT NOW. The wake
        filter for shape-indexed lease waiters — ``best_node`` is the wrong
        predicate there (it also returns feasible-but-busy nodes)."""
        with self._lock:
            return any(nr.can_fit(request) for nr in self._nodes.values())

    # -- gang planning ---------------------------------------------------------

    def node_slice(self, node_id: NodeID) -> str:
        """The ICI slice a node belongs to (singleton slice if unlabeled)."""
        with self._lock:
            nr = self._nodes.get(node_id)
            if nr is None:
                return f"solo:{node_id}"
            return topology_of(nr.labels, fallback=str(node_id))[1]

    def plan_gang(
        self,
        requests: List[ResourceSet],
        topology_aware: bool = True,
        strict_slice: bool = False,
    ) -> Optional[List[NodeID]]:
        """Plan nodes for a multi-bundle gang, minimizing cross-tier edges.

        Pure planning over a snapshot of current availability — the caller
        commits with per-bundle ``try_allocate`` (rolling back on a lost
        race). Topology-aware mode packs the whole gang into ONE slice when
        any slice has room (zero DCN edges), otherwise spills greedily onto
        the fewest slices, preferring pods already used. ``strict_slice``
        makes single-slice fit a hard requirement (STRICT_PACK-of-slices).
        Blind mode first-fits over utilization-sorted nodes — one linear
        pass instead of the per-bundle best-node scan the 2PC path does.

        Returns one node per request (in request order) or None.
        """
        with self._lock:
            free: Dict[NodeID, Dict[str, int]] = {
                nid: dict(nr.available._fixed) for nid, nr in self._nodes.items()
            }
            topo = {
                nid: topology_of(nr.labels, fallback=str(nid))
                for nid, nr in self._nodes.items()
            }

        def fits(pool: Dict[str, int], req: ResourceSet) -> bool:
            return all(pool.get(k, 0) >= v for k, v in req._fixed.items())

        def take(pool: Dict[str, int], req: ResourceSet) -> None:
            for k, v in req._fixed.items():
                pool[k] = pool.get(k, 0) - v

        # First-fit-decreasing order: big bundles place first, so a gang of
        # mixed shapes packs onto the fewest nodes.
        order = sorted(
            range(len(requests)),
            key=lambda i: -sum(requests[i]._fixed.values()),
        )

        def pack_into(node_ids: List[NodeID], idxs: List[int],
                      pools: Dict[NodeID, Dict[str, int]],
                      out: Dict[int, NodeID]) -> List[int]:
            """FFD the bundles ``idxs`` onto ``node_ids``; mutates pools/out,
            returns the indices that did not fit."""
            ranked = sorted(
                node_ids, key=lambda n: -sum(max(0, v) for v in pools[n].values())
            )
            left: List[int] = []
            for i in idxs:
                for nid in ranked:
                    if fits(pools[nid], requests[i]):
                        take(pools[nid], requests[i])
                        out[i] = nid
                        break
                else:
                    left.append(i)
            return left

        if not topology_aware:
            out: Dict[int, NodeID] = {}
            if pack_into(list(free.keys()), order, free, out):
                return None
            return [out[i] for i in range(len(requests))]

        # Group nodes by slice; remember each slice's pod for spill scoring.
        slices: Dict[str, List[NodeID]] = {}
        slice_pod: Dict[str, str] = {}
        for nid, (pod, slice_id, _tier) in topo.items():
            slices.setdefault(slice_id, []).append(nid)
            slice_pod[slice_id] = pod

        def slice_free(sid: str) -> int:
            return sum(
                sum(max(0, v) for v in free[n].values()) for n in slices[sid]
            )

        # Pass 1 — best-fit single slice: among slices that hold the whole
        # gang, take the one with the least spare capacity (keeps big slices
        # open for bigger gangs). Zero cross-tier edges by construction.
        for sid in sorted(slices, key=slice_free):
            pools = {n: dict(free[n]) for n in slices[sid]}
            out = {}
            if not pack_into(slices[sid], order, pools, out):
                return [out[i] for i in range(len(requests))]
        if strict_slice:
            return None

        # Pass 2 — forced spill: repeatedly give the slice that absorbs the
        # most remaining bundles everything it can hold (fewest, most skewed
        # slice groups → fewest cross-slice bundle pairs), preferring pods
        # the gang already landed in so spill stays pod-local.
        remaining = list(order)
        out = {}
        used_pods: set = set()
        while remaining:
            best_sid, best_left, best_pools, best_out = None, None, None, None
            for sid in slices:
                pools = {n: dict(free[n]) for n in slices[sid]}
                trial_out: Dict[int, NodeID] = {}
                left = pack_into(slices[sid], remaining, pools, trial_out)
                if not trial_out:
                    continue
                better = (
                    best_left is None
                    or len(left) < len(best_left)
                    or (len(left) == len(best_left)
                        and slice_pod[sid] in used_pods
                        and slice_pod[best_sid] not in used_pods)
                )
                if better:
                    best_sid, best_left = sid, left
                    best_pools, best_out = pools, trial_out
            if best_sid is None:
                return None  # nothing can take even one more bundle
            for n, pool in best_pools.items():
                free[n] = pool
            out.update(best_out)
            used_pods.add(slice_pod[best_sid])
            remaining = best_left
        return [out[i] for i in range(len(requests))]

    # -- node selection --------------------------------------------------------

    def best_node(
        self,
        request: ResourceSet,
        strategy: SchedulingStrategy | None = None,
        preferred_node: NodeID | None = None,
    ) -> Optional[NodeID]:
        """GetBestSchedulableNode analog. Returns None if infeasible cluster-wide."""
        strategy = strategy or DefaultSchedulingStrategy()
        with self._lock:
            if isinstance(strategy, NodeAffinitySchedulingStrategy):
                nr = self._nodes.get(strategy.node_id)
                if nr is not None and nr.is_feasible(request):
                    # Feasible-but-busy queues on the pinned node rather than
                    # failing (matches hybrid fallback behavior).
                    return strategy.node_id
                if not strategy.soft:
                    return None
                return self._hybrid_locked(request, preferred_node)
            if isinstance(strategy, NodeLabelSchedulingStrategy):
                return self._label_locked(request, strategy)
            if isinstance(strategy, SpreadSchedulingStrategy):
                return self._spread_locked(request)
            if isinstance(strategy, PlacementGroupSchedulingStrategy):
                # PG bundles carry their own node binding; resolved by the
                # PlacementGroupManager before reaching here.
                return self._hybrid_locked(request, preferred_node)
            return self._hybrid_locked(request, preferred_node)

    def _hybrid_locked(
        self, request: ResourceSet, preferred_node: NodeID | None
    ) -> Optional[NodeID]:
        cfg = config()
        available: List[tuple] = []  # (score, is_not_preferred, node_id)
        feasible: List[NodeID] = []
        for node_id, nr in self._nodes.items():
            if not nr.is_feasible(request):
                continue
            feasible.append(node_id)
            if nr.can_fit(request):
                util = nr.critical_utilization()
                score = 0.0 if util < cfg.scheduler_spread_threshold else util
                available.append((score, node_id != preferred_node, node_id))
        if available:
            available.sort(key=lambda t: (t[0], t[1]))
            best_score = available[0][0]
            tied = [t for t in available if t[0] == best_score]
            top_k = max(1, int(len(tied) * cfg.scheduler_top_k_fraction))
            return random.choice(tied[:top_k])[2]
        if feasible:
            # Feasible but not currently available: queue on the least loaded.
            return min(feasible, key=lambda n: self._nodes[n].critical_utilization())
        return None

    def _spread_locked(self, request: ResourceSet) -> Optional[NodeID]:
        ids = sorted(self._nodes.keys())
        if not ids:
            return None
        n = len(ids)
        for i in range(n):
            node_id = ids[(self._spread_rr + i) % n]
            if self._nodes[node_id].can_fit(request):
                self._spread_rr = (self._spread_rr + i + 1) % n
                return node_id
        for i in range(n):
            node_id = ids[(self._spread_rr + i) % n]
            if self._nodes[node_id].is_feasible(request):
                return node_id
        return None

    def _label_locked(
        self, request: ResourceSet, strategy: NodeLabelSchedulingStrategy
    ) -> Optional[NodeID]:
        def matches(nr: NodeResources, constraints: Dict[str, object]) -> bool:
            for key, want in constraints.items():
                have = nr.labels.get(key)
                if isinstance(want, (list, tuple, set)):
                    if have not in want:
                        return False
                elif have != want:
                    return False
            return True

        hard_ok = [
            nid
            for nid, nr in self._nodes.items()
            if nr.is_feasible(request) and matches(nr, strategy.hard)
        ]
        if not hard_ok:
            return None
        soft_ok = [
            nid
            for nid in hard_ok
            if matches(self._nodes[nid], strategy.soft)
            and self._nodes[nid].can_fit(request)
        ]
        pool = soft_ok or [n for n in hard_ok if self._nodes[n].can_fit(request)] or hard_ok
        return min(pool, key=lambda n: self._nodes[n].critical_utilization())
