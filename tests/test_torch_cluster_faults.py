"""JAX's ``tests/test_multiprocess.py`` on the port, second half: GCS
restart and head-disk loss, node death, lineage recovery, the owner-free
protocol, runtime env, log aggregation, the memory monitor and nested
tasks over real ``ray_tpu_torch`` Cluster processes. The collectives tests
(``test_gloo_collectives_across_processes``,
``test_ring_collectives_full_surface``) are in
``test_torch_collectives_cluster.py``."""

import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.core import runtime as runtime_mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_per_process():
    """Every process a Cluster starts inherits the environment: one torch
    thread each, so parallel test workers do not oversubscribe the host."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def mp_cluster():
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    yield cluster
    cluster.shutdown()


@pytest.fixture
def driver(mp_cluster):
    core = connect(mp_cluster.gcs_address)
    yield core
    core.shutdown()
    runtime_mod._global_runtime = None


def _wait_for(predicate, timeout=60.0, interval=0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


# ====================== fault tolerance ======================


def test_gcs_restart_preserves_state(tmp_path):
    """Head restart: KV + detached actor survive via snapshot + re-adoption
    (gcs_server.cc:523-524 Redis persistence analog)."""
    snapshot = str(tmp_path / "gcs.snap")
    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 2},
                      snapshot_path=snapshot)
    try:
        core = connect(cluster.gcs_address)
        try:
            core.gcs.kv_put("persisted-key", b"persisted-value")

            @ray_tpu_torch.remote(lifetime="detached", name="durable", max_restarts=1)
            class Durable:
                def __init__(self):
                    self.pid = os.getpid()

                def ping(self):
                    return os.getpid()

            a = Durable.remote()
            p1 = ray_tpu_torch.get(a.ping.remote(), timeout=60)
            # Force a snapshot before the kill.
            core._gcs_rpc.call("snapshot_now")

            cluster.kill_gcs()
            time.sleep(0.5)
            cluster.restart_gcs()
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None

        core2 = connect(cluster.gcs_address)
        try:
            # KV survived the head restart.
            assert core2.gcs.kv_get("persisted-key") == b"persisted-value"
            # The daemon re-registered and the GCS re-adopted the LIVE
            # detached actor (same process, no restart).
            assert _wait_for(
                lambda: core2._gcs_rpc.call("get_named_actor", "durable")
                is not None,
                timeout=30,
            )
            b = ray_tpu_torch.get_actor("durable")
            p2 = ray_tpu_torch.get(b.ping.remote(), timeout=60)
            assert p2 == p1
        finally:
            core2.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_node_death_actor_restart_elsewhere():
    """kill -9 a node daemon: health check marks the node dead and the actor
    restarts on a surviving node (gcs_health_check_manager.h:39 +
    gcs_actor_manager restart ladder)."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote(max_restarts=1)
            class Survivor:
                def pid(self):
                    return os.getpid()

            a = Survivor.remote()
            p1 = ray_tpu_torch.get(a.pid.remote(), timeout=60)
            info = core._gcs_rpc.call("get_actor_info", a.actor_id)
            idx = next(i for i, h in enumerate(cluster.nodes)
                       if h.node_id == info["node_id"])
            cluster.kill_node(idx)
            p2 = ray_tpu_torch.get(a.pid.remote(), timeout=150)
            assert p2 != p1
            info2 = core._gcs_rpc.call("get_actor_info", a.actor_id)
            assert info2["node_id"] != info["node_id"]
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_dynamic_generator_error_surfaces(driver):
    """A failed dynamic-generator task must raise at iteration, not yield an
    empty stream."""

    @ray_tpu_torch.remote(num_returns="dynamic", max_retries=0)
    def bad_gen():
        yield 1
        raise ValueError("gen kaboom")

    gen = bad_gen.remote()
    with pytest.raises(ValueError, match="gen kaboom"):
        for ref in gen:
            ray_tpu_torch.get(ref, timeout=60)


def test_dynamic_generator_success(driver):
    @ray_tpu_torch.remote(num_returns="dynamic")
    def gen(n):
        for i in range(n):
            yield i * i

    vals = [ray_tpu_torch.get(r, timeout=60) for r in gen.remote(4)]
    assert vals == [0, 1, 4, 9]


def test_placement_group_rescheduled_after_node_death():
    """A PG bundle whose node dies is re-placed on a surviving node
    (gcs_placement_group_manager re-queue analog)."""
    from ray_tpu_torch.core.placement_group import placement_group

    cluster = Cluster(num_nodes=3, resources_per_node={"CPU": 1})
    try:
        core = connect(cluster.gcs_address)
        try:
            pg = placement_group([{"CPU": 1}, {"CPU": 1}],
                                 strategy="STRICT_SPREAD")
            assert pg.ready(timeout=30)
            victim_node = pg.bundle_node_ids()[0]
            idx = next(i for i, h in enumerate(cluster.nodes)
                       if h.node_id == victim_node)
            cluster.kill_node(idx)
            # Health check marks the node dead, then the bundle re-places on
            # the spare node.
            assert _wait_for(
                lambda: not core.gcs.nodes[victim_node].alive, timeout=30
            ), "node death not detected"
            assert _wait_for(
                lambda: victim_node not in pg.bundle_node_ids()
                and pg.ready(timeout=1), timeout=60
            ), "PG was not re-placed"
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_lineage_object_recovery():
    """Kill the node holding a task's output: get() transparently resubmits
    the creating task (object_recovery_manager.h:41 analog)."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            def make_blob(tag):
                # Big enough to never ride inline in the reply (so the
                # driver holds no copy — only the shm replica exists).
                return np.full(200_000, tag, np.float64)

            ref = make_blob.remote(7.0)
            # Wait until sealed, find which node holds it.
            assert _wait_for(
                lambda: core._gcs_rpc.call("locate_object", ref.id.binary()),
                timeout=60)
            locs = core._gcs_rpc.call("locate_object", ref.id.binary())
            holder = locs[0][0]
            # Drop any driver-local cached value so get() must fetch.
            with core._cache_lock:
                core._cache.pop(ref.id, None)
            idx = next(i for i, h in enumerate(cluster.nodes)
                       if h.node_id == holder)
            cluster.kill_node(idx)
            # Wait for the control plane to drop the dead node's locations.
            assert _wait_for(
                lambda: not core._gcs_rpc.call(
                    "locate_object", ref.id.binary()),
                timeout=30)
            out = ray_tpu_torch.get(ref, timeout=120)
            assert float(out[0]) == 7.0 and out.shape == (200_000,)
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_refcount_owner_free_protocol():
    """Property test of the local refcounter: frees fire exactly when an
    OWNED id's local+submitted counts both reach zero; borrowed ids never
    free (reference_count.h:61 simplification)."""
    import random

    from ray_tpu_torch.core.core_worker import _LocalRefCounter
    from ray_tpu_torch.core.ids import ObjectID

    class FakeCore:
        def __init__(self):
            self.freed = []

        def _free_object(self, oid):
            self.freed.append(oid)

    rng = random.Random(0)
    for trial in range(50):
        core = FakeCore()
        rc = _LocalRefCounter(core)
        ids = [ObjectID.for_put() for _ in range(4)]
        owned = set(rng.sample(ids, 2))
        for oid in owned:
            rc.set_owned(oid)
        counts = {oid: [0, 0] for oid in ids}  # [local, submitted]
        ops = []
        for _ in range(60):
            oid = rng.choice(ids)
            kind = rng.randrange(4)
            if kind == 0:
                rc.add_local_reference(oid)
                counts[oid][0] += 1
            elif kind == 1 and counts[oid][0] > 0:
                rc.remove_local_reference(oid)
                counts[oid][0] -= 1
            elif kind == 2:
                rc.add_submitted_task_reference(oid)
                counts[oid][1] += 1
            elif kind == 3 and counts[oid][1] > 0:
                rc.remove_submitted_task_reference(oid)
                counts[oid][1] -= 1
            ops.append((oid, kind))
        # Drain all remaining refs.
        for oid in ids:
            for _ in range(counts[oid][0]):
                rc.remove_local_reference(oid)
            for _ in range(counts[oid][1]):
                rc.remove_submitted_task_reference(oid)
        freed = set(core.freed)
        assert freed == owned, (trial, freed, owned)
        # Never double-freed.
        assert len(core.freed) == len(freed)


def test_runtime_env_env_vars(driver):
    """Per-task/actor env_vars apply at worker process SPAWN (fresh process,
    never returned to the vanilla pool)."""

    @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_FLAG": "hello-env"}})
    def read_env():
        import os

        return os.environ.get("MY_FLAG"), os.getpid()

    @ray_tpu_torch.remote
    def read_plain():
        import os

        return os.environ.get("MY_FLAG"), os.getpid()

    val, env_pid = ray_tpu_torch.get(read_env.remote(), timeout=120)
    assert val == "hello-env"
    val2, plain_pid = ray_tpu_torch.get(read_plain.remote(), timeout=120)
    assert val2 is None  # vanilla pool never contaminated
    assert env_pid != plain_pid


def test_worker_log_aggregation():
    """Worker prints land in per-worker session logs, stream through the
    GCS "logs" channel, and mirror to the driver (log_monitor.py analog)."""
    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            captured = []
            core.start_log_mirroring(
                sink=lambda entry, line: captured.append((entry["worker"], line)))

            @ray_tpu_torch.remote
            def chatty():
                print("hello-from-worker-log")
                return 1

            assert ray_tpu_torch.get(chatty.remote(), timeout=120) == 1
            assert _wait_for(
                lambda: any("hello-from-worker-log" in line
                            for _, line in captured),
                timeout=30,
            ), captured
            # Raw tail RPC (state API path) sees it too.
            tails = core._daemons.get(cluster.nodes[0].address).call(
                "tail_worker_logs", timeout=10)
            assert any("hello-from-worker-log" in text
                       for text in tails.values())
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_memory_monitor_kills_newest_task_worker():
    """OOM policy: above the usage threshold the daemon kills the newest
    busy TASK worker (retriable-FIFO analog); parked actors survive."""
    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 2},
                      system_config={"memory_monitor_threshold": 0.0001,
                                     "memory_monitor_period_s": 0.2})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            class Bystander:
                def ping(self):
                    return "alive"

            b = Bystander.remote()
            assert ray_tpu_torch.get(b.ping.remote(), timeout=120) == "alive"

            @ray_tpu_torch.remote(max_retries=0)
            def hog():
                time.sleep(10.0)
                return "survived"

            ref = hog.remote()
            with pytest.raises(Exception, match="worker died|WorkerDied"):
                ray_tpu_torch.get(ref, timeout=120)
            # The actor was never a kill candidate.
            assert ray_tpu_torch.get(b.ping.remote(), timeout=60) == "alive"
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_nested_tasks_no_deadlock_when_fully_leased():
    """Blocked-worker release: outer tasks saturate every CPU lease, then
    each spawns an inner task and blocks in get() — without releasing the
    outer leases this deadlocks; with the protocol it completes."""
    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            def inner(x):
                return x * 10

            @ray_tpu_torch.remote
            def outer(x):
                return ray_tpu_torch.get(inner.remote(x), timeout=150) + 1

            # 2 CPUs, 2 outer tasks -> both leases taken before either
            # inner can schedule.
            refs = [outer.remote(i) for i in range(2)]
            assert sorted(ray_tpu_torch.get(refs, timeout=240)) == [1, 11]
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_gcs_head_disk_loss_restores_from_mirror(tmp_path):
    """Head-DISK-loss recovery: snapshots are MIRRORED to node daemons
    each tick; a fresh GCS whose local snapshot is gone restores from any
    surviving daemon (the external-store role Redis plays in the
    reference, gcs_server.cc:523-524)."""
    snapshot = str(tmp_path / "gcs.snap")
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2},
                      snapshot_path=snapshot)
    try:
        core = connect(cluster.gcs_address)
        try:
            core.gcs.kv_put("mirrored-key", b"mirrored-value")
            core.gcs.kv_put("mirrored-key-2", b"v2")
            core._gcs_rpc.call("snapshot_now")  # writes local + mirrors
            # A daemon holds the mirror.
            assert _wait_for(
                lambda: any(
                    core._daemons.get(n.address).call("fetch_gcs_snapshot",
                                                      timeout=10)
                    for n in cluster.nodes),
                timeout=30)
            mirror_node = next(
                n for n in cluster.nodes
                if core._daemons.get(n.address).call("fetch_gcs_snapshot",
                                                     timeout=10))

            cluster.kill_gcs()
            os.remove(snapshot)  # the head's DISK is gone
            time.sleep(0.5)
            cluster.restart_gcs(restore_from=mirror_node.address)
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None

        core2 = connect(cluster.gcs_address)
        try:
            assert core2.gcs.kv_get("mirrored-key") == b"mirrored-value"
            assert core2.gcs.kv_get("mirrored-key-2") == b"v2"
        finally:
            core2.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()
