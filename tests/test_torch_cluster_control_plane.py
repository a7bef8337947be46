"""Sharded control plane — capacity blocks, sharded tables, ingest plane.

Covers the round-8 control-plane split: batched daemon-local scheduling
leases (one GCS hop grants a revocable capacity BLOCK; per-task leases are
carved at the node daemon), hash-sharded GCS tables (object directory /
pubsub / KV in independent lock domains), and the non-blocking
observability ingest queue (a slow aggregator may lag telemetry but can
never stall a lease grant).

JAX's ``tests/test_control_plane.py`` on the port's ``ray_tpu_torch`` GCS,
node daemons and lease table, with the card's ``GPU`` where the JAX tests
name ``TPU``. The daemon-SIGKILL test gets a cluster of its own
(``fresh_block_cluster``) instead of the module's shared one: on the shared
cluster it can ask for its 2-CPU block before the previous test's driver
has handed its CPUs back.
"""

import contextlib
import os
import threading
import time

import pytest

from ray_tpu_torch.core.config import Config, config, set_config
from ray_tpu_torch.core.ids import NodeID
from ray_tpu_torch.core.lease_table import (LocalLeaseTable, block_of,
                                      is_block_lease)
from ray_tpu_torch.core.rpc import RpcClient, RpcServer

import torch_threads  # noqa: F401,E402  (one torch thread a test process)
from torch_time_limit import time_limit  # noqa: E402


@contextlib.contextmanager
def _cfg(**flags):
    """Env-backed config override, restored on exit (the same resolution
    path a real process uses: RAY_TPU_<NAME> before defaults)."""
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


def _wait_for(predicate, timeout=60.0, interval=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


# ====================== local lease table (daemon side) ======================


def test_local_lease_table_carve_release_sweep():
    t = LocalLeaseTable()
    t.adopt("cap-1", {"CPU": 1}, 3)
    ids = [t.carve("cap-1") for _ in range(3)]
    assert all(ids) and len(set(ids)) == 3
    assert all(is_block_lease(i) and block_of(i) == "cap-1" for i in ids)
    assert t.carve("cap-1") is None  # exhausted
    assert t.release(ids[0]) is True
    assert t.free_units("cap-1") == 1
    # Idle sweep only reaps blocks past the TTL; fresh activity protects it.
    assert t.sweep_idle(10.0) == []
    time.sleep(0.05)
    swept = t.sweep_idle(0.01)
    assert swept == [("cap-1", 1)]
    assert t.free_units("cap-1") == 0
    # GCS rejected the return (e.g. restart): unsweep puts the unit back.
    t.unsweep("cap-1", 1)
    assert t.free_units("cap-1") == 1


def test_local_lease_table_revoke_vs_release_no_double_free():
    """GCS revocation racing a lease release: the released unit is
    DISCARDED, never re-carved — the GCS already re-granted that capacity
    elsewhere, so re-carving it here would double-spend the resources."""
    t = LocalLeaseTable()
    t.adopt("cap-7", {"CPU": 1}, 2)
    a = t.carve("cap-7")
    b = t.carve("cap-7")
    t.revoke("cap-7")
    assert t.carve("cap-7") is None  # revoked blocks grant nothing
    assert t.release(a) is True  # lease known; its unit is DISCARDED
    assert t.free_units("cap-7") == 0  # ...not freed for re-carving
    assert t.carve("cap-7") is None
    assert t.release(b) is True
    # Fully drained revoked block is forgotten entirely.
    assert t.stats() == {}
    assert t.release(a) is False  # double release of a dead lease: no-op


def test_local_lease_table_adopt_on_first_touch():
    """The carve-side adopt hint: a daemon that never saw the GCS's adopt
    push (lost notify) still serves carves — the first carve carries the
    block's shape and size inline."""
    t = LocalLeaseTable()
    lease = t.carve("cap-9", shape={"CPU": 1}, total=2)
    assert lease == "cap-9#1" or lease.startswith("cap-9#")
    assert t.carve("cap-9") is not None
    assert t.carve("cap-9") is None
    assert t.carve("cap-404") is None  # unknown block, no hint: refused


# ====================== batched grants (GCS side) ======================


def _fresh_service(**flags):
    """In-process GcsService under a config override; no real daemons run
    at the fake node addresses, so grant pushes are silently swallowed
    (the carve-side adopt hint covers real clusters)."""
    from ray_tpu_torch.core.gcs_server import GcsService

    ctx = _cfg(**flags) if flags else contextlib.nullcontext()
    return ctx, GcsService


def test_lease_batch_grant_and_partial_return():
    ctx, GcsService = _fresh_service()
    with ctx:
        svc = GcsService()
        try:
            svc.register_node(NodeID.from_random(), "127.0.0.1:1",
                              {"CPU": 4}, {})
            block_id, node_id, addr, granted = svc.request_lease_batch(
                {"CPU": 1}, None, count=10, timeout=5.0, _client_id="c1")
            # Partial grant: the node holds 4 units, not 10.
            assert granted == 4 and block_id.startswith("cap-")
            assert svc.available_resources().get("CPU", 0) == 0
            # Daemon ships back 2 idle units.
            assert svc.return_block_capacity(block_id, 2) is True
            assert svc.available_resources().get("CPU", 0) == 2
            # Over-return clamps to what's still out.
            assert svc.return_block_capacity(block_id, 99) is True
            assert svc.available_resources().get("CPU", 0) == 4
            # Fully-returned block is gone; further returns say so.
            assert svc.return_block_capacity(block_id, 1) is False
        finally:
            svc.shutdown()


def test_lease_batch_rejects_placement_group_strategy():
    from ray_tpu_torch.core.task_spec import PlacementGroupSchedulingStrategy

    ctx, GcsService = _fresh_service()
    with ctx:
        svc = GcsService()
        try:
            svc.register_node(NodeID.from_random(), "127.0.0.1:1",
                              {"CPU": 4}, {})
            with pytest.raises(ValueError):
                svc.request_lease_batch(
                    {"CPU": 1},
                    PlacementGroupSchedulingStrategy("pg", None), count=2)
        finally:
            svc.shutdown()


def test_block_reclaim_on_client_death_no_double_free():
    """Client dies holding a capacity block the daemon partially returned:
    the GCS reclaims exactly total-returned units — both orderings of
    (daemon return x client-death reclaim) end at full availability."""
    ctx, GcsService = _fresh_service()
    with ctx:
        svc = GcsService()
        try:
            svc.register_node(NodeID.from_random(), "127.0.0.1:1",
                              {"CPU": 4}, {})
            block_id, _n, _a, granted = svc.request_lease_batch(
                {"CPU": 1}, None, count=4, timeout=5.0, _client_id="dead-1")
            assert granted == 4
            svc.return_block_capacity(block_id, 1)  # daemon sweep first
            svc.on_client_closed("dead-1")  # then the client dies
            assert svc.available_resources().get("CPU", 0) == 4
            # The reclaim consumed the block: a late daemon return is
            # refused (the daemon then revokes its local record).
            assert svc.return_block_capacity(block_id, 1) is False
        finally:
            svc.shutdown()


def test_pending_demands_visible_while_batch_waits():
    """The incrementally-maintained demand list (autoscaler feed) shows a
    waiting batch request's shape, and clears when the wait ends."""
    ctx, GcsService = _fresh_service()
    with ctx:
        svc = GcsService()  # no nodes: everything waits
        try:
            done = threading.Event()

            def ask():
                with contextlib.suppress(TimeoutError):
                    svc.request_lease_batch({"GPU": 8}, None, count=4,
                                            timeout=1.5)
                done.set()

            threading.Thread(target=ask, daemon=True).start()
            assert _wait_for(
                lambda: {"GPU": 8.0} in svc.pending_resource_demands()
                or {"GPU": 8} in svc.pending_resource_demands(), timeout=5)
            assert done.wait(timeout=10)
            assert svc.pending_resource_demands() == []
        finally:
            svc.shutdown()


def test_shape_indexed_wakeups_skip_unfit_shapes():
    """S1: releases of one resource shape must not wake waiters parked on
    a shape no node can fit — the old notify_all() thundering herd."""
    ctx, GcsService = _fresh_service()
    with ctx:
        svc = GcsService()
        try:
            cpu_node = NodeID.from_random()
            svc.register_node(cpu_node, "127.0.0.1:1", {"CPU": 4}, {})
            got = {}

            def want_tpu():
                with contextlib.suppress(TimeoutError):
                    got["r"] = svc.request_lease({"GPU": 8}, None,
                                                 timeout=30.0)

            t = threading.Thread(target=want_tpu, daemon=True)
            t.start()
            assert _wait_for(lambda: svc.wake_stats() is not None
                             and bool(svc._shape_waiters), timeout=5)
            # CPU lease churn: grants + releases while the GPU waiter parks.
            for _ in range(5):
                lease_id, _n, _a = svc.request_lease({"CPU": 1}, None,
                                                     timeout=5.0)
                svc.release_lease(lease_id)
            stats = svc.wake_stats()
            assert stats["skips"] >= 5, stats  # GPU shape never notified
            assert "r" not in got
            # A GPU node registering wakes everyone (membership events use
            # the wake-all path) and the waiter completes.
            svc.register_node(NodeID.from_random(), "127.0.0.1:2",
                              {"GPU": 8}, {})
            t.join(timeout=10)
            assert not t.is_alive() and "r" in got
        finally:
            svc.shutdown()


# ====================== sharded tables ======================


def test_shard_routing_stable_and_single_shard_compat():
    from ray_tpu_torch.core.gcs_shards import shard_index

    assert shard_index("chan", 1) == 0
    assert shard_index(b"\x00" * 28, 1) == 0
    # crc32 routing is process-independent: pin a few known routes so a
    # refactor to seeded hash() (restart-unstable) fails loudly.
    assert shard_index("chan", 8) == shard_index("chan", 8)
    for key in (b"a" * 28, b"b" * 28, "node", "object_locations"):
        assert 0 <= shard_index(key, 8) < 8


def test_sharded_directory_and_pubsub_round_trip():
    """Locations, lineage GC, filtered subscribes and channel polls behave
    identically at gcs_shards=4 — sharding moves lock domains, not
    semantics."""
    ctx, GcsService = _fresh_service(gcs_shards=4)
    with ctx:
        assert config().gcs_shards == 4
        svc = GcsService()
        try:
            node = NodeID.from_random()
            svc.register_node(node, "127.0.0.1:1", {"CPU": 4}, {})
            oids = [bytes([i]) * 24 + b"\x00" * 4 for i in range(16)]
            for oid in oids:
                svc.add_object_location(oid, node, 100 + oid[0])
            for oid in oids:
                locs = svc.locate_object(oid)
                assert [(n, a, s) for n, a, s in locs] == [
                    (node, "127.0.0.1:1", 100 + oid[0])]
            batch = svc.locate_object_batch(oids)
            assert len(batch) == 16 and all(len(b) == 1 for b in batch)
            svc.remove_object_location(oids[0], node)
            assert svc.locate_object(oids[0]) == []
            # Filtered subscribe wakes only on its oid, across shards.
            target = oids[5]
            cur, _ = svc.subscribe_object_locations(None, 0.1, [target])
            done = {}

            def park():
                done["r"] = svc.subscribe_object_locations(cur, 10.0,
                                                           [target])

            t = threading.Thread(target=park, daemon=True)
            t.start()
            time.sleep(0.2)
            svc._publish("object_locations", (oids[7], node, "a", 1))
            time.sleep(0.2)
            assert "r" not in done
            svc._publish("object_locations", (target, node, "a", 1))
            t.join(timeout=5)
            assert [m[0] for m in done["r"][1]] == [target]
        finally:
            svc.shutdown()


def test_kv_sharding_and_snapshot_across_shard_counts():
    """KV routes to gcs_shards independent lock domains; a snapshot taken
    at one shard count restores at another (restart with a new config)."""
    from ray_tpu_torch.core.gcs import GlobalControlStore

    with _cfg(gcs_shards=4):
        store = GlobalControlStore()
        assert store.kv_shard_count() == 4
        for i in range(32):
            store.kv_put(f"k{i}", f"v{i}".encode(), namespace="ns")
        store.kv_put("k0", b"x", namespace="other")
        assert store.kv_get("k7", namespace="ns") == b"v7"
        assert sorted(store.kv_keys(namespace="ns")) == sorted(
            f"k{i}" for i in range(32))
        store.kv_del("k0", namespace="ns")
        assert store.kv_get("k0", namespace="ns") is None
        dump = store.kv_dump()
    with _cfg(gcs_shards=2):
        store2 = GlobalControlStore()
        assert store2.kv_shard_count() == 2
        store2.kv_load(dump)
        assert store2.kv_get("k7", namespace="ns") == b"v7"
        assert store2.kv_get("k0", namespace="other") == b"x"
        assert store2.kv_get("k0", namespace="ns") is None


# ====================== observability ingest plane ======================


def test_slow_aggregator_cannot_stall_lease_grants():
    """THE regression this plane exists for: a slow metrics apply used to
    park GCS handler threads until the pool starved and request_lease
    queued behind telemetry. With the ingest queue, reports land in the
    staging deque and the handler returns; a lease grant through the SAME
    4-thread server stays fast while the aggregator crawls."""
    ctx, GcsService = _fresh_service()
    with ctx:
        svc = GcsService()
        server = RpcServer(svc, max_workers=4, name="gcs-lag")
        try:
            svc.register_node(NodeID.from_random(), "127.0.0.1:1",
                              {"CPU": 4}, {})
            orig = svc.store.report_metrics
            svc.store.report_metrics = (
                lambda *a, **k: (time.sleep(0.5), orig(*a, **k)))
            flood = RpcClient(server.address)
            lease = RpcClient(server.address)
            try:
                for i in range(12):  # 6s of serialized apply work staged
                    flood.notify("report_metrics", "n", "comp", i, [])
                t0 = time.monotonic()
                lease_id, _n, _a = lease.call(
                    "request_lease", {"CPU": 1}, None, 10.0, timeout=10.0)
                elapsed = time.monotonic() - t0
                assert elapsed < 2.0, (
                    f"lease grant took {elapsed:.2f}s behind telemetry")
                lease.notify("release_lease", lease_id)
                # notify() is fire-and-forget: on a loaded box the flood
                # frames may still be in the conn loop when the grant
                # returns — poll until the staging deque has seen them.
                deadline = time.monotonic() + 20.0
                while time.monotonic() < deadline:
                    stats = lease.call("ingest_stats")
                    if stats["submitted"] >= 12:
                        break
                    time.sleep(0.1)
                assert stats["submitted"] >= 12
            finally:
                flood.close()
                lease.close()
        finally:
            server.stop()
            svc.shutdown()


def test_ingest_queue_bounded_drops_counted():
    ctx, GcsService = _fresh_service(gcs_ingest_queue_max=4)
    with ctx:
        svc = GcsService()
        try:
            orig = svc.store.report_metrics
            svc.store.report_metrics = (
                lambda *a, **k: (time.sleep(0.2), orig(*a, **k)))
            for i in range(64):
                svc.report_metrics("n", "comp", i, [])
            stats = svc.ingest_stats()
            assert stats["dropped"] > 0
            assert stats["submitted"] + stats["dropped"] == 64
        finally:
            svc.shutdown()


def test_ingest_read_your_writes_and_inline_fallback():
    """Readers see staged events (flush barrier), and disabling the plane
    reproduces the old inline-apply behavior exactly."""
    ctx, GcsService = _fresh_service()
    with ctx:
        svc = GcsService()
        try:
            svc.record_task_event({"task_id": "t1", "state": "RUNNING",
                                   "ts": 1.0})
            events = svc.task_events()
            assert any(e.get("task_id") == "t1" for e in events)
        finally:
            svc.shutdown()
    ctx, GcsService = _fresh_service(gcs_ingest_async_enabled=0)
    with ctx:
        svc = GcsService()
        try:
            assert svc._ingest is None
            svc.record_task_event({"task_id": "t2", "state": "RUNNING",
                                   "ts": 1.0})
            assert any(e.get("task_id") == "t2" for e in svc.task_events())
            assert svc.ingest_stats() == {"queued": 0, "dropped": 0,
                                          "submitted": 0, "drained": 0}
        finally:
            svc.shutdown()


# ====================== multiprocess: blocks across real daemons ======================


@pytest.fixture(scope="module")
def block_cluster():
    from ray_tpu_torch.core.cluster import Cluster

    with time_limit(120, "the module's cluster start"):
        cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    yield cluster
    cluster.shutdown()


@pytest.fixture
def fresh_block_cluster():
    from ray_tpu_torch.core.cluster import Cluster

    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    yield cluster
    cluster.shutdown()


def test_capacity_block_protocol_end_to_end(block_cluster):
    """Raw protocol drive: GCS batch grant -> daemon carve -> worker runs
    -> return -> daemon idle sweep ships capacity back to the GCS."""
    gcs = RpcClient(block_cluster.gcs_address)
    daemon = None
    try:
        block_id, node_id, addr, granted = gcs.call(
            "request_lease_batch", {"CPU": 1}, None, 2, 30.0, timeout=35.0)
        assert granted == 2
        daemon = RpcClient(addr)
        got1 = daemon.call("lease_worker_block", block_id, {"CPU": 1}, 2,
                           timeout=60.0)
        got2 = daemon.call("lease_worker_block", block_id, {"CPU": 1}, 2,
                           timeout=60.0)
        assert got1 and got2
        assert is_block_lease(got1[0]) and block_of(got1[0]) == block_id
        # Block exhausted: a third carve is refused locally.
        assert daemon.call("lease_worker_block", block_id, {"CPU": 1}, 2,
                           timeout=10.0) is None
        for got in (got1, got2):
            daemon.notify("return_leased_worker", got[1])
        # Freed units idle past the TTL; the daemon sweep returns them and
        # the GCS sees full availability with the block retired.
        assert _wait_for(
            lambda: gcs.call("available_resources").get("CPU", 0) == 4.0,
            timeout=30)
        assert gcs.call("return_block_capacity", block_id, 1) is False
    finally:
        if daemon is not None:
            daemon.close()
        gcs.close()


def test_lease_worker_block_n_carves_batch_in_one_hop(block_cluster):
    """The n-carve RPC returns up to n (lease, worker) pairs in ONE daemon
    round trip, short-returns under pool pressure instead of stalling, and
    reports exhaustion as an empty list."""
    gcs = RpcClient(block_cluster.gcs_address)
    daemon = None
    try:
        block_id, _nid, addr, granted = gcs.call(
            "request_lease_batch", {"CPU": 1}, None, 2, 30.0, timeout=35.0)
        assert granted == 2
        daemon = RpcClient(addr)
        grants = []
        deadline = time.time() + 60.0
        while len(grants) < 2 and time.time() < deadline:
            # Short batches are legal (slow worker spawn): keep asking for
            # the remainder, as the client's carve loop does.
            grants += daemon.call("lease_worker_block_n", block_id,
                                  {"CPU": 1}, 2, 4, timeout=70.0)
        assert len(grants) == 2
        leases = {g[0] for g in grants}
        assert len(leases) == 2
        assert all(is_block_lease(lid) and block_of(lid) == block_id
                   for lid in leases)
        # Exhausted block: the n-carve reports it as an empty batch.
        assert daemon.call("lease_worker_block_n", block_id, {"CPU": 1},
                           2, 4, timeout=10.0) == []
        for g in grants:
            daemon.notify("return_leased_worker", g[1])
        assert _wait_for(
            lambda: gcs.call("available_resources").get("CPU", 0) == 4.0,
            timeout=30)
    finally:
        if daemon is not None:
            daemon.close()
        gcs.close()


def test_lease_requester_pool_bounded_under_burst(block_cluster):
    """S2: a burst far wider than the cluster spawns at most
    lease_requester_threads concurrent lease-req pool threads (the old
    transport spun one thread per queued task, up to 64 per key)."""
    import ray_tpu_torch
    from ray_tpu_torch.core import runtime as runtime_mod
    from ray_tpu_torch.core.cluster import connect

    core = connect(block_cluster.gcs_address)
    try:
        @ray_tpu_torch.remote
        def nap():
            time.sleep(0.2)
            return os.getpid()

        refs = [nap.remote() for _ in range(40)]
        peak = 0
        deadline = time.time() + 5.0
        while time.time() < deadline:
            n = sum(1 for t in threading.enumerate()
                    if t.name.startswith("lease-req"))
            peak = max(peak, n)
            time.sleep(0.02)
        assert peak <= config().lease_requester_threads, peak
        assert peak >= 1  # the pool did engage
        pids = ray_tpu_torch.get(refs, timeout=120)
        assert len(pids) == 40
    finally:
        core.shutdown()
        runtime_mod._global_runtime = None


def test_daemon_sigkill_holding_block_reclaims_capacity(fresh_block_cluster):
    """kill -9 the daemon holding a live capacity block: node-death
    handling drops the node AND its blocks in one motion — no resources
    leak, and a late return for the dead block is refused."""
    gcs = RpcClient(fresh_block_cluster.gcs_address)
    try:
        block_id, node_id, addr, granted = gcs.call(
            "request_lease_batch", {"CPU": 1}, None, 2, 30.0, timeout=35.0)
        assert granted == 2
        idx = next(i for i, h in enumerate(fresh_block_cluster.nodes)
                   if h.address == addr)
        fresh_block_cluster.kill_node(idx)
        # Death detection drops the node's 2 CPUs and its block; the
        # survivor's 2 CPUs are all that remain — and all of them free.
        assert _wait_for(
            lambda: gcs.call("available_resources").get("CPU", 0) == 2.0
            and gcs.call("cluster_resources").get("CPU", 0) == 2.0,
            timeout=60)
        assert gcs.call("return_block_capacity", block_id, 1) is False
    finally:
        gcs.close()
