"""Placement groups — gang resource reservation with topology strategies.

Analog of the reference's placement groups
(``python/ray/util/placement_group.py:41,145``; 2PC scheduling in
``src/ray/gcs/gcs_server/gcs_placement_group_scheduler.h:113-115`` and bundle
policies in ``src/ray/raylet/scheduling/policy/bundle_scheduling_policy.cc`` —
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD). In-process the two-phase
prepare/commit collapses to an atomic multi-node allocation with rollback on
partial failure — the same all-or-nothing contract. Tasks/actors scheduled
into a bundle draw from the bundle's reservation (per-bundle admission
control, the analog of the reference's ``CPU_group_<pgid>`` shadow
resources).

The port's copy of ``ray_tpu/core/placement_group.py``, the in-process
manager; a STRICT_PACK group over ``{"GPU": k}`` bundles claims k cards of
one node. ``DistributedPlacementGroup`` is the GCS-backed handle of the
multiprocess cluster.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.core.exceptions import RayTpuError
from ray_tpu_torch.core.ids import NodeID, PlacementGroupID
from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.core.runtime import Runtime, get_runtime
from ray_tpu_torch.core.task_spec import PlacementGroupSchedulingStrategy


class PlacementGroupError(RayTpuError):
    pass


@dataclass
class Bundle:
    index: int
    resources: Dict[str, float]
    node_id: Optional[NodeID] = None
    # Admission accounting: how much of the reservation is currently unused.
    available: ResourceSet = field(default_factory=lambda: ResourceSet({}))


@dataclass
class PlacementGroupState:
    pg_id: PlacementGroupID
    bundles: List[Bundle]
    strategy: str
    name: str = ""
    state: str = "PENDING"  # PENDING | CREATED | REMOVED | PREEMPTED
    ready_event: threading.Event = field(default_factory=threading.Event)
    waiters: List[Callable[[], None]] = field(default_factory=list)
    # Preemption class: higher-priority capacity demand may revoke lower.
    gang_priority: int = 0
    seq: int = 0  # creation order; newest-first victim pick within a class
    # Retry index: the DISTINCT bundle shapes (and, for STRICT_PACK, the
    # single-node total) this group needs. retry_pending's wake filter —
    # a release that leaves some shape unfittable can't have unblocked us.
    distinct_shapes: List[ResourceSet] = field(default_factory=list)
    total_shape: Optional[ResourceSet] = None


class PlacementGroupManager:
    """Reserves bundle resources on nodes; resolves PG-scheduled work.

    One lock guards the group table and all placement decisions — placement
    retries run on worker threads after every resource release, so racing
    placements of the same PENDING group must serialize.
    """

    def __init__(self, runtime: Runtime):
        self.runtime = runtime
        self._lock = threading.RLock()
        self.groups: Dict[PlacementGroupID, PlacementGroupState] = {}
        self._seq = 0
        # Shape-filter effectiveness counters, same shape as the GCS lease
        # plane's wake index: a "skip" is a pending group NOT re-placed on
        # a release because some bundle shape still fits nowhere.
        self.wake_stats = {"wakes": 0, "skips": 0}

    def create(self, bundles: List[Dict[str, float]], strategy: str,
               name: str = "", gang_priority: int = 0) -> PlacementGroupState:
        pg_id = PlacementGroupID.from_random()
        distinct: Dict[tuple, ResourceSet] = {}
        total = ResourceSet({})
        for b in bundles:
            rs = ResourceSet(b)
            distinct[tuple(sorted(b.items()))] = rs
            total = total + rs
        state = PlacementGroupState(
            pg_id=pg_id,
            bundles=[Bundle(i, dict(b)) for i, b in enumerate(bundles)],
            strategy=strategy,
            name=name,
            gang_priority=int(gang_priority),
            distinct_shapes=list(distinct.values()),
            total_shape=total if strategy == "STRICT_PACK" else None,
        )
        with self._lock:
            self._seq += 1
            state.seq = self._seq
            self.groups[pg_id] = state
            self._try_place_locked(state)
        self._flush_waiters(state)
        return state

    def _flush_waiters(self, state: PlacementGroupState) -> None:
        if state.state != "CREATED":
            return
        with self._lock:
            waiters, state.waiters = state.waiters, []
        for cb in waiters:
            cb()

    def _try_place_locked(self, state: PlacementGroupState) -> None:
        """Atomic prepare+commit across nodes with rollback (the in-process
        collapse of the reference's 2PC — gcs_placement_group_scheduler.h)."""
        sched = self.runtime.scheduler
        placed: List[tuple] = []  # (node_id, ResourceSet)

        def commit():
            if state.state != "PENDING":
                # Removed while this retry was mid-flight (the 2PC race):
                # committing would strand the reservations forever — undo.
                rollback()
                return
            for b in state.bundles:
                b.available = ResourceSet(b.resources)
            state.state = "CREATED"
            state.ready_event.set()

        def rollback():
            for node_id, rs in placed:
                sched.release(node_id, rs)
            for b in state.bundles:
                b.node_id = None

        nodes = sched.nodes()
        node_ids = sorted(nodes.keys())
        strategy = state.strategy

        if strategy in ("STRICT_PACK", "PACK"):
            # Try to land every bundle on a single node first.
            total = ResourceSet({})
            for b in state.bundles:
                total = total + ResourceSet(b.resources)
            for node_id in node_ids:
                if nodes[node_id].can_fit(total) and sched.try_allocate(node_id, total):
                    placed.append((node_id, total))
                    for b in state.bundles:
                        b.node_id = node_id
                    commit()
                    return
            if strategy == "STRICT_PACK":
                return  # stays PENDING until feasible
            # PACK falls back to any placement (greedy best-effort).

        if strategy in ("STRICT_SPREAD", "SPREAD", "PACK"):
            used_nodes: set = set()
            ok = True
            for b in state.bundles:
                rs = ResourceSet(b.resources)
                choice = None
                for node_id in node_ids:
                    if strategy == "STRICT_SPREAD" and node_id in used_nodes:
                        continue
                    if sched.try_allocate(node_id, rs):
                        choice = node_id
                        break
                if choice is None:
                    ok = False
                    break
                placed.append((choice, rs))
                b.node_id = choice
                used_nodes.add(choice)
            if ok:
                commit()
            else:
                rollback()
            return

        raise PlacementGroupError(f"unknown strategy {strategy}")

    def _could_place_locked(self, g: PlacementGroupState) -> bool:
        """Cheap necessary condition before the full 2PC attempt: every
        distinct bundle shape must fit on SOME node right now (and, for
        STRICT_PACK, the summed total on one node). A CPU release storm
        then never walks a TPU gang's full placement loop."""
        sched = self.runtime.scheduler
        if g.total_shape is not None:
            return sched.any_can_fit(g.total_shape)
        return all(sched.any_can_fit(s) for s in g.distinct_shapes)

    def retry_pending(self) -> None:
        flushed: List[PlacementGroupState] = []
        with self._lock:
            for g in self.groups.values():
                if g.state != "PENDING":
                    continue
                if not self._could_place_locked(g):
                    self.wake_stats["skips"] += 1
                    continue
                self.wake_stats["wakes"] += 1
                self._try_place_locked(g)
                if g.state == "CREATED":
                    flushed.append(g)
        for g in flushed:
            self._flush_waiters(g)

    def preempt_lower(self, resources: Dict[str, float], count: int = 1,
                      min_priority: int = 0) -> int:
        """Revoke gangs of strictly lower ``gang_priority`` until ``count``
        units of ``resources`` could be placed (in-process analog of the
        GCS ``preempt_gangs`` RPC). Lowest class first, newest first within
        a class. Returns the number of groups preempted."""
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.util import flightrec

        if not config().gang_preemption_enabled:
            return 0
        sched = self.runtime.scheduler
        request = ResourceSet(resources)
        count = max(1, int(count))
        preempted = 0
        with self._lock:
            def can_fit_all() -> bool:
                got: List[NodeID] = []
                for _ in range(count):
                    nid = sched.best_node(request)
                    if nid is None or not sched.try_allocate(nid, request):
                        break
                    got.append(nid)
                for nid in got:
                    sched.release(nid, request)
                return len(got) >= count

            if can_fit_all():
                return 0
            victims = sorted(
                (g for g in self.groups.values()
                 if g.state == "CREATED" and g.gang_priority < min_priority),
                key=lambda g: (g.gang_priority, -g.seq))
            for g in victims:
                g.state = "PREEMPTED"
                for b in g.bundles:
                    if b.node_id is not None:
                        sched.release(b.node_id, ResourceSet(b.resources))
                        b.node_id = None
                flightrec.record("pg", g.pg_id.hex()[:16],
                                 f"gang.preempt prio={g.gang_priority}")
                preempted += 1
                if can_fit_all():
                    break
        if preempted:
            from ray_tpu_torch.core.metrics_export import (gang_preemptions_total,
                                                     metrics_enabled)
            if metrics_enabled():
                gang_preemptions_total().inc(preempted)
            self.runtime._on_resources_freed()
        return preempted

    def when_ready(self, pg_id: PlacementGroupID, callback: Callable[[], None]) -> bool:
        """Run callback once the group is CREATED (now, or on placement).

        Returns False if the group is removed/unknown (caller should error).
        """
        with self._lock:
            state = self.groups.get(pg_id)
            if state is None or state.state in ("REMOVED", "PREEMPTED"):
                return False
            if state.state == "PENDING":
                state.waiters.append(callback)
                return True
        callback()
        return True

    def remove(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            state = self.groups.get(pg_id)
            if state is None or state.state == "REMOVED":
                return
            if state.state == "CREATED":
                freed: Dict[NodeID, ResourceSet] = {}
                for b in state.bundles:
                    if b.node_id is not None:
                        rs = freed.get(b.node_id, ResourceSet({}))
                        freed[b.node_id] = rs + ResourceSet(b.resources)
                for node_id, rs in freed.items():
                    self.runtime.scheduler.release(node_id, rs)
            state.state = "REMOVED"
        self.runtime._on_resources_freed()

    # -- bundle admission (shadow-resource analog) ----------------------------

    def _bundle_for(self, strategy: PlacementGroupSchedulingStrategy) -> Optional[Bundle]:
        pg = strategy.placement_group
        if pg is None:
            return None
        state = self.groups.get(pg.id)
        if state is None or state.state != "CREATED":
            return None
        idx = max(0, strategy.placement_group_bundle_index)
        if idx >= len(state.bundles):
            return None
        return state.bundles[idx]

    def acquire_from_bundle(
        self, strategy: PlacementGroupSchedulingStrategy, request: ResourceSet
    ) -> bool:
        with self._lock:
            bundle = self._bundle_for(strategy)
            if bundle is None:
                return False
            if not request.is_subset_of(bundle.available):
                return False
            bundle.available = bundle.available - request
            return True

    def release_to_bundle(
        self, strategy: PlacementGroupSchedulingStrategy, request: ResourceSet
    ) -> None:
        with self._lock:
            bundle = self._bundle_for(strategy)
            if bundle is not None:
                bundle.available = bundle.available + request

    def resolve_node(self, strategy: PlacementGroupSchedulingStrategy) -> Optional[NodeID]:
        with self._lock:
            bundle = self._bundle_for(strategy)
            return bundle.node_id if bundle is not None else None

    def group_state(self, pg_id: PlacementGroupID) -> Optional[str]:
        with self._lock:
            state = self.groups.get(pg_id)
            return state.state if state else None


class PlacementGroup:
    """User-facing handle (reference: util/placement_group.py:41)."""

    def __init__(self, pg_id: PlacementGroupID):
        self._id = pg_id

    @property
    def id(self) -> PlacementGroupID:
        return self._id

    def _state(self) -> PlacementGroupState:
        mgr = _manager()
        state = mgr.groups.get(self._id)
        if state is None:
            raise PlacementGroupError(f"placement group {self._id} not found")
        return state

    def ready(self, timeout: float | None = None) -> bool:
        return self._state().ready_event.wait(timeout)

    def wait(self, timeout: float | None = None) -> bool:
        return self.ready(timeout)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return [dict(b.resources) for b in self._state().bundles]

    @property
    def bundle_count(self) -> int:
        return len(self._state().bundles)

    def bundle_node_ids(self) -> List[Optional[NodeID]]:
        return [b.node_id for b in self._state().bundles]

    def __reduce__(self):
        return (PlacementGroup, (self._id,))


def _manager() -> PlacementGroupManager:
    rt = get_runtime()
    if rt._pg_manager is None:
        rt._pg_manager = PlacementGroupManager(rt)
    return rt._pg_manager


class DistributedPlacementGroup(PlacementGroup):
    """PG handle backed by the GCS server (multiprocess runtime); creation
    is synchronous-on-reserve there, so ``ready`` reduces to a table check."""

    def _info(self) -> dict:
        info = get_runtime().get_placement_group(self._id)
        if info is None:
            raise PlacementGroupError(f"placement group {self._id} not found")
        return info

    def ready(self, timeout: float | None = None) -> bool:
        """Block until the group is CREATED (e.g. re-placed after a node
        death set it RESCHEDULING), matching the base handle's
        ready_event.wait semantics."""
        import time as _time

        deadline = None if timeout is None else _time.time() + timeout
        while True:
            if self._info()["state"] == "CREATED":
                return True
            if deadline is not None and _time.time() >= deadline:
                return False
            _time.sleep(0.1)

    def wait(self, timeout: float | None = None) -> bool:
        return self.ready(timeout)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return [dict(b["resources"]) for b in self._info()["bundles"]]

    @property
    def bundle_count(self) -> int:
        return len(self._info()["bundles"])

    def bundle_node_ids(self) -> List[Optional[NodeID]]:
        return [b["node_id"] for b in self._info()["bundles"]]

    def __reduce__(self):
        return (DistributedPlacementGroup, (self._id,))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    gang_priority: int = 0,
) -> PlacementGroup:
    """Create a placement group (reference: util/placement_group.py:145).

    ``gang_priority`` is the preemption class: under SLO pressure, serve
    autoscaling may revoke groups of strictly lower priority (see
    ``gang_preemption_enabled``). Default 0 = preemptible by anything.
    """
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"invalid strategy {strategy}")
    if not bundles:
        raise ValueError("bundles must be non-empty")
    rt = get_runtime()
    if hasattr(rt, "create_placement_group"):  # multiprocess CoreWorker
        pg_id = PlacementGroupID.from_random()
        rt.create_placement_group(pg_id, bundles, strategy, name,
                                  gang_priority=gang_priority)
        return DistributedPlacementGroup(pg_id)
    state = _manager().create(bundles, strategy, name,
                              gang_priority=gang_priority)
    return PlacementGroup(state.pg_id)


def remove_placement_group(pg: PlacementGroup) -> None:
    rt = get_runtime()
    if hasattr(rt, "remove_placement_group"):
        rt.remove_placement_group(pg.id)
        return
    _manager().remove(pg.id)


def placement_group_table() -> Dict[str, dict]:
    mgr = _manager()
    return {
        pg_id.hex(): {
            "state": st.state,
            "strategy": st.strategy,
            "name": st.name,
            "bundles": [
                {"resources": b.resources, "node_id": b.node_id.hex() if b.node_id else None}
                for b in st.bundles
            ],
        }
        for pg_id, st in mgr.groups.items()
    }
