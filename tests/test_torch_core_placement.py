"""The in-process half of ``tests/test_gang_scheduling.py`` on the port: the
topology vocabulary, ``ClusterResourceScheduler.plan_gang`` (the ICI-locality
planner) and the in-process ``PlacementGroupManager`` (retry shape filter,
the remove/commit race, preemption), plus placement groups that host actors
on the card's ``GPU`` resource through the runtime. The GCS gang path, the
simulated cluster and serve preemption come with the multiprocess cluster.
"""

import contextlib
import os

import pytest

import ray_tpu_torch

from ray_tpu_torch.core.config import Config, set_config
from ray_tpu_torch.core.ids import NodeID
from ray_tpu_torch.core.resources import (NodeResources, ResourceSet,
                                    cross_tier_edges, topology_labels,
                                    topology_of)
from ray_tpu_torch.core.scheduler import ClusterResourceScheduler

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


@contextlib.contextmanager
def _cfg(**flags):
    """Env-backed config override, restored on exit (the port's table goes
    back to resolving the env at each read, its state with no runtime up)."""
    old = {}
    for k, v in flags.items():
        key = f"RAY_TPU_{k.upper()}"
        old[key] = os.environ.get(key)
        os.environ[key] = str(v)
    set_config(Config())
    try:
        yield
    finally:
        for key, v in old.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        set_config(None)  # back to resolving the env at each read


# ====================== topology vocabulary ======================


def test_cross_tier_edges_counts_dcn_pairs():
    # All in one slice: every pair rides ICI.
    assert cross_tier_edges(["s0", "s0", "s0", "s0"]) == 0
    # 2+2 split: 6 total pairs, 2 intra -> 4 cross.
    assert cross_tier_edges(["s0", "s0", "s1", "s1"]) == 4
    # Fully scattered: every pair crosses.
    assert cross_tier_edges(["s0", "s1", "s2"]) == 3
    assert cross_tier_edges([]) == 0
    assert cross_tier_edges(["s0"]) == 0


def test_topology_of_labels_and_solo_fallback():
    pod, sl, tier = topology_of(topology_labels("podA", "slice3"))
    assert (pod, sl, tier) == ("podA", "slice3", "ici")
    # Unlabeled node: its own singleton slice, so a topology-aware plan
    # never assumes two unlabeled nodes share ICI.
    pod, sl, tier = topology_of({}, fallback="n42")
    assert (pod, sl) == ("pod0", "solo:n42")


# ====================== plan_gang (ICI-locality planner) ======================


def _topo_sched(slices, cpus=16):
    """slices: {slice_id: (pod, n_nodes)} -> (scheduler, {slice: [node_ids]})."""
    sched = ClusterResourceScheduler()
    by_slice = {}
    for slice_id, (pod, n) in slices.items():
        for _ in range(n):
            nid = NodeID.from_random()
            sched.add_node(nid, NodeResources(
                ResourceSet({"CPU": float(cpus)}),
                labels=topology_labels(pod, slice_id)))
            by_slice.setdefault(slice_id, []).append(nid)
    return sched, by_slice


def test_plan_gang_fits_single_slice_zero_edges():
    sched, by_slice = _topo_sched({"s0": ("p0", 4), "s1": ("p0", 4)})
    plan = sched.plan_gang([ResourceSet({"CPU": 8})] * 8)  # 64 CPU = 1 slice
    assert plan is not None and len(plan) == 8
    assert cross_tier_edges([sched.node_slice(n) for n in plan]) == 0


def test_plan_gang_best_fit_prefers_tightest_slice():
    # s0 is smaller but big enough: best-fit must take it, keeping the
    # large slice open for larger gangs.
    sched, by_slice = _topo_sched({"s0": ("p0", 2), "s1": ("p0", 8)})
    plan = sched.plan_gang([ResourceSet({"CPU": 16})] * 2)
    assert plan is not None
    assert set(plan) == set(by_slice["s0"])


def test_plan_gang_forced_spill_minimal_edges():
    # Gang of 6 full hosts > any slice (4 hosts) -> must spill, but onto
    # exactly TWO slices (4+2), not three: 8 cross edges, the minimum.
    sched, _ = _topo_sched({"s0": ("p0", 4), "s1": ("p0", 4),
                            "s2": ("p1", 4)})
    plan = sched.plan_gang([ResourceSet({"CPU": 16})] * 6)
    assert plan is not None
    slices = [sched.node_slice(n) for n in plan]
    assert len(set(slices)) == 2
    assert cross_tier_edges(slices) == 4 * 2  # 4-host group x 2-host group


def test_plan_gang_spill_prefers_used_pod():
    # Both spill candidates can absorb the remainder equally; the one in
    # the pod the gang already landed in must win (spill stays pod-local).
    sched, by_slice = _topo_sched({"s0": ("pA", 4), "s1": ("pA", 4),
                                   "s2": ("pB", 4)})
    plan = sched.plan_gang([ResourceSet({"CPU": 16})] * 6)
    pods = {topology_of({"topo.pod": "pA"} if n in by_slice["s0"] + by_slice["s1"]
                        else {"topo.pod": "pB"})[0] for n in plan}
    assert pods == {"pA"}


def test_plan_gang_strict_slice_requires_single_slice():
    sched, _ = _topo_sched({"s0": ("p0", 2), "s1": ("p0", 2)})
    reqs = [ResourceSet({"CPU": 16})] * 3  # 3 hosts > any one slice
    assert sched.plan_gang(reqs, strict_slice=True) is None
    # Relaxed (PACK) spills instead of failing.
    assert sched.plan_gang(reqs, strict_slice=False) is not None


def test_plan_gang_blind_ignores_slices():
    sched, _ = _topo_sched({"s0": ("p0", 2), "s1": ("p0", 2)})
    plan = sched.plan_gang([ResourceSet({"CPU": 16})] * 4,
                           topology_aware=False)
    assert plan is not None and len(plan) == 4
    # And None when the gang simply cannot fit.
    assert sched.plan_gang([ResourceSet({"CPU": 16})] * 5,
                           topology_aware=False) is None


def test_plan_gang_is_pure_planning():
    sched, _ = _topo_sched({"s0": ("p0", 2)})
    before = sched.available_resources()
    assert sched.plan_gang([ResourceSet({"CPU": 4})] * 2) is not None
    assert sched.available_resources() == before


class _StubRuntime:
    def __init__(self):
        self.scheduler = ClusterResourceScheduler()
        self.freed = 0

    def _on_resources_freed(self):
        self.freed += 1


def _manager(rt):
    from ray_tpu_torch.core.placement_group import PlacementGroupManager
    return PlacementGroupManager(rt)


def test_retry_pending_shape_filter_skips_unfittable():
    rt = _StubRuntime()
    nid = NodeID.from_random()
    rt.scheduler.add_node(nid, NodeResources(ResourceSet({"CPU": 4})))
    mgr = _manager(rt)
    # A GPU gang can never fit on this CPU node: stays PENDING.
    gpu = mgr.create([{"GPU": 4.0}], "PACK")
    assert gpu.state == "PENDING"
    mgr.retry_pending()
    assert mgr.wake_stats == {"wakes": 0, "skips": 1}
    # A CPU release storm keeps skipping it (no full placement walk)...
    for _ in range(3):
        mgr.retry_pending()
    assert mgr.wake_stats["skips"] == 4 and mgr.wake_stats["wakes"] == 0
    # ...until a GPU node joins: one wake, group placed.
    rt.scheduler.add_node(NodeID.from_random(),
                          NodeResources(ResourceSet({"GPU": 8})))
    mgr.retry_pending()
    assert gpu.state == "CREATED"
    assert mgr.wake_stats["wakes"] == 1


def test_retry_pending_strict_pack_uses_total_shape():
    rt = _StubRuntime()
    rt.scheduler.add_node(NodeID.from_random(),
                          NodeResources(ResourceSet({"CPU": 4})))
    rt.scheduler.add_node(NodeID.from_random(),
                          NodeResources(ResourceSet({"CPU": 4})))
    mgr = _manager(rt)
    # Each bundle fits SOME node, but the STRICT_PACK total (6 CPU) fits
    # none -> the total-shape filter skips without attempting.
    g = mgr.create([{"CPU": 3.0}, {"CPU": 3.0}], "STRICT_PACK")
    assert g.state == "PENDING"
    mgr.retry_pending()
    assert mgr.wake_stats["skips"] == 1 and mgr.wake_stats["wakes"] == 0


def test_manager_remove_during_retry_rolls_back():
    """The 2PC race the commit guard closes: a group removed while its
    retry is mid-flight must not strand reservations."""
    rt = _StubRuntime()
    mgr = _manager(rt)
    g = mgr.create([{"CPU": 2.0}], "PACK")  # no nodes: PENDING
    assert g.state == "PENDING"
    g.state = "REMOVED"  # remove() won the race mid-retry
    rt.scheduler.add_node(NodeID.from_random(),
                          NodeResources(ResourceSet({"CPU": 4})))
    with mgr._lock:
        mgr._try_place_locked(g)  # the in-flight retry commits...
    # ...and the guard rolled it back: nothing stays allocated.
    assert rt.scheduler.available_resources()["CPU"] == 4.0
    assert all(b.node_id is None for b in g.bundles)


def test_manager_preempt_lower_orders_and_frees():
    with _cfg(gang_preemption_enabled=1):
        rt = _StubRuntime()
        for _ in range(2):
            rt.scheduler.add_node(NodeID.from_random(),
                                  NodeResources(ResourceSet({"CPU": 8})))
        mgr = _manager(rt)
        old = mgr.create([{"CPU": 8.0}], "PACK", gang_priority=0)
        new = mgr.create([{"CPU": 8.0}], "PACK", gang_priority=0)
        assert old.state == new.state == "CREATED"
        assert mgr.preempt_lower({"CPU": 8.0}, count=1, min_priority=100) == 1
        assert new.state == "PREEMPTED" and old.state == "CREATED"
        assert rt.scheduler.available_resources()["CPU"] == 8.0
        assert rt.freed == 1
        # when_ready on a preempted group refuses (caller recreates).
        assert mgr.when_ready(new.pg_id, lambda: None) is False


# ====================== through the runtime ======================


@pytest.fixture
def runtime_two_nodes():
    """2 virtual nodes, 2 CPU + 1 GPU each."""
    ray_tpu_torch.init(resources={"CPU": 2, "GPU": 1}, num_nodes=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_bundle_hosts_gpu_actor_and_remove_frees(runtime_two_nodes):
    rt = runtime_two_nodes
    pg = rt.placement_group([{"GPU": 1, "CPU": 1}], strategy="STRICT_PACK")
    assert pg.ready(timeout=10)
    assert rt.available_resources()["GPU"] == 1.0

    @rt.remote(num_gpus=1)
    class Holder:
        def node(self):
            return rt.get_runtime_context().node_id

    strategy = rt.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    h = Holder.options(scheduling_strategy=strategy).remote()
    assert rt.get(h.node.remote(), timeout=10) == pg.bundle_node_ids()[0]
    # The actor rides the bundle's reservation: nothing more is taken.
    assert rt.available_resources()["GPU"] == 1.0
    rt.kill(h)
    rt.remove_placement_group(pg)
    assert rt.available_resources()["GPU"] == 2.0
    table = rt.placement_group_table()[pg.id.hex()]
    assert table["state"] == "REMOVED"


def test_strict_spread_gpu_bundles_land_on_distinct_nodes(runtime_two_nodes):
    rt = runtime_two_nodes
    pg = rt.placement_group([{"GPU": 1}, {"GPU": 1}], strategy="STRICT_SPREAD")
    assert pg.ready(timeout=10)
    nodes = pg.bundle_node_ids()
    assert len(set(nodes)) == 2
    # A third whole card does not exist: the next group stays pending.
    pg2 = rt.placement_group([{"GPU": 1}], strategy="PACK")
    assert not pg2.ready(timeout=0.2)
    rt.remove_placement_group(pg)
    assert pg2.ready(timeout=10)


def test_runtime_preempt_gangs_revokes_lower_priority(runtime_two_nodes):
    from ray_tpu_torch.core.runtime import get_runtime

    rt = runtime_two_nodes
    low = rt.placement_group([{"GPU": 1}, {"GPU": 1}], strategy="SPREAD",
                             gang_priority=0)
    assert low.ready(timeout=10)
    assert rt.available_resources().get("GPU", 0) == 0
    assert get_runtime().preempt_gangs({"GPU": 1.0}, count=1,
                                       min_priority=10) == 1
    assert rt.available_resources()["GPU"] == 2.0
    assert rt.placement_group_table()[low.id.hex()]["state"] == "PREEMPTED"
