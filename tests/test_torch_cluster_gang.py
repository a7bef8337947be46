"""The GCS half of ``tests/test_gang_scheduling.py`` on the port: atomic gang
commit over pinned capacity blocks in the port's ``GcsService``, driven
through its simulated cluster (``ray_tpu_torch.core.sim_cluster``) — no
partial gangs, no orphaned blocks after a member daemon's SIGKILL,
STRICT_PACK in one slice, the legacy path with gang scheduling off,
preemption classes, the create/remove tombstone race, the serve autoscaler's
preemption gate, the harness's determinism and its watchdog. The card's
``GPU`` stands where the JAX tests name ``TPU``. The planner and the
in-process manager are ``test_torch_core_placement.py``.
"""

import contextlib
import os
import threading
import time

import pytest

from ray_tpu_torch.core.config import Config, set_config
from ray_tpu_torch.core.ids import NodeID, PlacementGroupID


@contextlib.contextmanager
def _cfg(**flags):
    """Env-backed config override, restored on exit."""
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
        set_config(None)


def _wait_for(predicate, timeout=60.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False



# ====================== GCS gang path (SimCluster) ======================


def _sim(n, **kw):
    from ray_tpu_torch.core.sim_cluster import SimCluster
    kw.setdefault("heartbeat", False)
    return SimCluster(n, **kw)


def _gang_blocks(svc, pg_id=None):
    return [b for b in svc._blocks.values()
            if b.pg_id is not None and (pg_id is None or b.pg_id == pg_id)]


def test_gang_commit_creates_pinned_blocks_and_remove_revokes():
    with _cfg(gang_scheduling_enabled=1, health_check_period_s=3600):
        cluster = _sim(8)  # one 8-node slice (hosts_per_slice=16 default)
        try:
            svc = cluster.svc
            total = svc.cluster_resources()["CPU"]
            pg = cluster.create_gang([{"CPU": 4.0}] * 4, strategy="PACK")
            assert svc.get_placement_group(pg)["state"] == "CREATED"
            blocks = _gang_blocks(svc, pg)
            assert blocks and sum(b.total for b in blocks) == 4
            # Daemon-side: the pushed blocks are pinned (idle-TTL exempt).
            adopted = [d for d in cluster.daemons if d.lease_table.stats()]
            assert adopted
            for d in adopted:
                assert all(st["pinned"]
                           for st in d.lease_table.stats().values())
                assert d.lease_table.sweep_idle(0.0) == []  # pinned: no sweep
            cluster.remove_gang(pg)
            assert not _gang_blocks(svc)
            assert svc.cluster_resources()["CPU"] == total
            assert all(st["revoked"] for d in cluster.daemons
                       for st in d.lease_table.stats().values())
        finally:
            cluster.shutdown()


def test_gang_atomicity_no_partial_on_infeasible():
    with _cfg(gang_scheduling_enabled=1, health_check_period_s=3600):
        cluster = _sim(4, cpus_per_node=8)
        try:
            svc = cluster.svc
            before = svc.cluster_resources()["CPU"]
            with pytest.raises(TimeoutError):
                # 5 full hosts on a 4-host cluster: must time out with
                # NOTHING reserved, not 4 bundles placed and one stuck.
                cluster.create_gang([{"CPU": 8.0}] * 5, timeout=0.3)
            assert svc.cluster_resources()["CPU"] == before
            assert not _gang_blocks(svc)
        finally:
            cluster.shutdown()


def test_gang_survives_member_daemon_sigkill():
    """A gang member's daemon dies mid-life: its cap-N blocks must be
    forgotten (not orphaned), the gang reschedules, and cluster capacity
    reconverges to the surviving nodes' total."""
    with _cfg(gang_scheduling_enabled=1, health_check_period_s=3600):
        cluster = _sim(6, cpus_per_node=8)
        try:
            svc = cluster.svc
            pg = cluster.create_gang([{"CPU": 8.0}] * 4)
            victim_node = cluster.gang_nodes(pg)[0]
            victim_idx = next(i for i, d in enumerate(cluster.daemons)
                              if d.node_id == victim_node)
            cluster.kill_node(victim_idx)  # SIGKILL posture, declared dead
            # No orphaned blocks on the dead node.
            assert all(b.node_id != victim_node for b in svc._blocks.values())
            # The gang re-placed onto survivors (2 spare hosts remain).
            assert _wait_for(lambda: svc.get_placement_group(pg)["state"]
                             == "CREATED", timeout=10)
            assert victim_node not in cluster.gang_nodes(pg)
            # Capacity reconverges: 5 surviving hosts, 4 reserved.
            avail = svc.scheduler.available_resources().get("CPU", 0)
            assert avail == 8.0
        finally:
            cluster.shutdown()


def test_gang_strict_pack_lands_in_one_slice():
    with _cfg(gang_scheduling_enabled=1, sim_hosts_per_slice=4,
              health_check_period_s=3600):
        cluster = _sim(12)  # 3 slices of 4
        try:
            pg = cluster.create_gang([{"CPU": 16.0}] * 4,
                                     strategy="STRICT_PACK")
            assert cluster.gang_cross_tier_edges(pg) == 0
            assert len(set(cluster.gang_nodes(pg))) == 4
        finally:
            cluster.shutdown()


def test_gang_disabled_reproduces_legacy_placement():
    with _cfg(gang_scheduling_enabled=0, health_check_period_s=3600):
        cluster = _sim(4, cpus_per_node=16)
        try:
            svc = cluster.svc
            # Legacy STRICT_PACK = strict ONE NODE (not one slice).
            pg = cluster.create_gang([{"CPU": 8.0}] * 2,
                                     strategy="STRICT_PACK")
            assert len(set(cluster.gang_nodes(pg))) == 1
            # And the legacy path mints no gang blocks.
            assert not _gang_blocks(svc)
        finally:
            cluster.shutdown()


def test_preemption_class_ordering_and_floor():
    with _cfg(gang_scheduling_enabled=1, health_check_period_s=3600):
        cluster = _sim(8, cpus_per_node=8)
        try:
            svc = cluster.svc
            low_old = cluster.create_gang([{"CPU": 8.0}] * 2, gang_priority=0)
            low_new = cluster.create_gang([{"CPU": 8.0}] * 2, gang_priority=0)
            mid = cluster.create_gang([{"CPU": 8.0}] * 2, gang_priority=50)
            high = cluster.create_gang([{"CPU": 8.0}] * 2, gang_priority=100)
            # Cluster full; serve (class 100) needs 2 hosts.
            n = svc.preempt_gangs({"CPU": 8.0}, count=2, min_priority=100)
            assert n == 1
            # Victim = lowest class, NEWEST first; >=min_priority untouched.
            assert svc.get_placement_group(low_new)["state"] == "PREEMPTED"
            assert svc.get_placement_group(low_old)["state"] == "CREATED"
            assert svc.get_placement_group(mid)["state"] == "CREATED"
            assert svc.get_placement_group(high)["state"] == "CREATED"
            assert not _gang_blocks(svc, low_new)  # blocks revoked
            # A lease against the preempted group fails FAST.
            from ray_tpu_torch.core.task_spec import \
                PlacementGroupSchedulingStrategy
            with pytest.raises(RuntimeError, match="preempted"):
                svc.request_lease(
                    {"CPU": 1.0},
                    PlacementGroupSchedulingStrategy(
                        placement_group=low_new,
                        placement_group_bundle_index=0),
                    timeout=5.0)
            # Enough capacity already free: preemption is a no-op.
            assert svc.preempt_gangs({"CPU": 8.0}, count=2,
                                     min_priority=100) == 0
        finally:
            cluster.shutdown()


def test_preemption_disabled_by_flag():
    with _cfg(gang_scheduling_enabled=1, gang_preemption_enabled=0,
              health_check_period_s=3600):
        cluster = _sim(2, cpus_per_node=8)
        try:
            cluster.create_gang([{"CPU": 8.0}] * 2, gang_priority=0)
            assert cluster.svc.preempt_gangs({"CPU": 8.0}, count=1,
                                             min_priority=100) == 0
        finally:
            cluster.shutdown()


def test_create_remove_race_tombstone_no_leak():
    """remove_placement_group racing a blocked create: the create must NOT
    commit afterwards (a gang nobody can ever remove again = leaked
    capacity). The tombstone fails it cleanly once capacity arrives."""
    with _cfg(gang_scheduling_enabled=1, health_check_period_s=3600):
        from ray_tpu_torch.core.gcs_server import GcsService
        svc = GcsService()
        try:
            pg_id = PlacementGroupID.from_random()
            err = []
            t = threading.Thread(
                target=lambda: err.append(
                    _raises(lambda: svc.create_placement_group(
                        pg_id, "", [{"CPU": 4.0}] * 2, "PACK",
                        timeout=30.0))))
            t.start()  # no nodes yet: parks in the retry loop
            _wait_for(lambda: t.is_alive(), timeout=5)
            time.sleep(0.1)
            svc.remove_placement_group(pg_id)  # unknown pg -> tombstone
            # Capacity arrives; the parked create wakes, sees the
            # tombstone, and fails instead of committing.
            svc.register_node(NodeID.from_random(), "127.0.0.1:0",
                              {"CPU": 64.0}, {})
            t.join(timeout=10)
            assert not t.is_alive()
            assert isinstance(err[0], RuntimeError)
            assert pg_id not in svc._pgs
            assert not _gang_blocks(svc)
            assert svc.scheduler.available_resources()["CPU"] == 64.0
        finally:
            svc.shutdown()


def _raises(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 — the exception IS the result
        return e


def test_gang_preemption_rate_limit_and_gate():
    from ray_tpu_torch.serve.autoscaling import SERVE_GANG_PRIORITY, GangPreemption

    calls = []

    def preempt(shape, count, min_priority):
        calls.append((shape, count, min_priority))
        return 1

    with _cfg(gang_preemption_enabled=1):
        gp = GangPreemption(preempt, min_interval_s=10.0)
        assert gp.maybe_reclaim("d", {"GPU": 4.0}, 2, now=100.0) == 1
        assert calls == [({"GPU": 4.0}, 2, SERVE_GANG_PRIORITY)]
        # Within the window: rate-limited, no second strip.
        assert gp.maybe_reclaim("d", {"GPU": 4.0}, 2, now=105.0) == 0
        # Another deployment has its own window.
        assert gp.maybe_reclaim("e", {"GPU": 4.0}, 1, now=105.0) == 1
        # Past the window: allowed again.
        assert gp.maybe_reclaim("d", {"GPU": 4.0}, 1, now=111.0) == 1
        assert len(calls) == 3
        # count<=0 never calls out.
        assert gp.maybe_reclaim("d", {"GPU": 4.0}, 0, now=200.0) == 0
    with _cfg(gang_preemption_enabled=0):
        gp = GangPreemption(preempt)
        assert gp.maybe_reclaim("d", {"GPU": 4.0}, 2, now=300.0) == 0
        assert len(calls) == 3
    # A raising preempt callable is advisory: swallowed, returns 0.
    with _cfg(gang_preemption_enabled=1):
        gp = GangPreemption(lambda *a: 1 / 0)
        assert gp.maybe_reclaim("d", {"GPU": 4.0}, 1, now=400.0) == 0


# ====================== sim harness determinism / watchdog ======================


def _digest_run(n, seed):
    with _cfg(gang_scheduling_enabled=1, health_check_period_s=3600):
        cluster = _sim(n, seed=seed)
        try:
            digests = []
            for k in range(6):
                pg = cluster.create_gang([{"CPU": 4.0}] * 8,
                                         gang_priority=k % 3)
                digests.append(cluster.placement_digest(pg))
                digests.append(str(cluster.gang_cross_tier_edges(pg)))
            return "|".join(digests)
        finally:
            cluster.shutdown()


def test_sim_determinism_smoke():
    # CI smoke at 48 nodes: same seed -> identical placements; different
    # seed -> different node identities (the shuffle matters).
    assert _digest_run(48, seed=7) == _digest_run(48, seed=7)
    assert _digest_run(48, seed=7) != _digest_run(48, seed=8)


@pytest.mark.slow
def test_sim_determinism_300_nodes():
    assert _digest_run(300, seed=7) == _digest_run(300, seed=7)


def test_sim_watchdog_detects_silent_heartbeat_stop():
    from ray_tpu_torch.core.sim_cluster import wait_for
    with _cfg(health_check_period_s=0.1, health_check_failure_threshold=3,
              sim_heartbeat_period_s=0.05):
        cluster = _sim(8, heartbeat=True)
        try:
            victim = cluster.daemons[3]
            assert wait_for(
                lambda: cluster.svc.heartbeat(victim.node_id) == "ok",
                timeout=10.0)
            cluster.stop_heartbeat(3)
            t0 = time.monotonic()
            assert wait_for(
                lambda: victim.node_id in cluster.svc._dead_nodes,
                timeout=15.0)
            # period * threshold = 0.3s budget; detection well under 5s.
            assert time.monotonic() - t0 < 10.0
            # The dead node left the scheduler; survivors keep placing.
            pg = cluster.create_gang([{"CPU": 4.0}] * 2)
            assert victim.node_id not in cluster.gang_nodes(pg)
        finally:
            cluster.shutdown()
