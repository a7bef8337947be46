"""The port's node liveness under load (ROADMAP Queue 3): the GCS must keep
a node alive while its handler pool is taken by calls that block.

The GCS runs every RPC on a pool of 128 threads, and some calls wait there
for a long time (a lease request waits up to its timeout for capacity, a
long poll for news). With the pool full, a daemon's heartbeat queued
behind them, its 5 s call timed out, and the GCS declared the node dead
within the 5 s threshold (``health_check_period_s`` 1.0 x
``health_check_failure_threshold`` 5, JAX's values, unchanged here). The
heartbeat now runs on its connection's reader thread under a lock of its
own.

The GCS's own stall is the other way to lose a live node: when the GCS
process is held (a starved host, the GIL, SIGSTOP), heartbeats that arrive
meanwhile sit unread, and its health loop, waking after the stall, used to
read every stamp as stale. A tick that wakes more than a period late now
re-bases the stamps by its lateness."""

import os
import signal
import threading
import time

import pytest

from ray_tpu_torch.core.cluster import Cluster
from ray_tpu_torch.core.rpc import RpcClient

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

GCS_POOL = 128          # gcs_server.main's RpcServer(max_workers=128)


@pytest.fixture(autouse=True)
def _one_torch_thread_per_process(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_saturated_handler_pool_does_not_kill_live_nodes():
    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 2})
    gcs = RpcClient(cluster.gcs_address)
    try:
        def infeasible_lease():
            try:    # no node has 100 CPUs: waits out its 10 s on the pool
                gcs.call("request_lease", {"CPU": 100.0}, None, 10.0,
                         timeout=30)
            except TimeoutError:
                pass

        threads = [threading.Thread(target=infeasible_lease, daemon=True)
                   for _ in range(GCS_POOL + 12)]
        for t in threads:
            t.start()
        time.sleep(8.0)         # past the 5 s death threshold, pool full
        nodes = gcs.call("list_nodes", timeout=30)
        assert [n["alive"] for n in nodes] == [True], nodes
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        nodes = gcs.call("list_nodes", timeout=30)
        assert [n["alive"] for n in nodes] == [True], nodes
    finally:
        gcs.close()
        cluster.shutdown()


def _alive(gcs):
    return [n["alive"] for n in gcs.call("list_nodes", timeout=30)]


def test_gcs_stall_keeps_live_nodes_but_a_silent_daemon_still_dies():
    # A host-wide stall: the daemons freeze first (so no heartbeat is left
    # in flight), then the GCS for 8 s, past the 5 s death threshold; the
    # GCS resumes first and its health loop wakes before any daemon can
    # speak. Every heartbeat age it reads is the stall's.
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 1})
    gcs = RpcClient(cluster.gcs_address)
    daemons = [h.proc.pid for h in cluster.nodes]
    try:
        assert _alive(gcs) == [True, True]
        for pid in daemons:
            os.kill(pid, signal.SIGSTOP)
        try:
            time.sleep(0.3)
            os.kill(cluster.gcs_proc.pid, signal.SIGSTOP)
            try:
                time.sleep(8.0)
            finally:
                os.kill(cluster.gcs_proc.pid, signal.SIGCONT)
            time.sleep(1.0)
        finally:
            for pid in daemons:
                os.kill(pid, signal.SIGCONT)
        time.sleep(2.0)         # two health periods after the stall
        assert _alive(gcs) == [True, True]
        stats = gcs.call("health_loop_stats", timeout=30)
        assert stats["late_ticks"] >= 1 and stats["worst_late_s"] > 5.0, stats
        with open(stats["stacks_path"]) as f:   # the threads as it resumed
            assert "--- health tick" in f.read() and cluster.gcs_proc.poll() \
                is None

        # A daemon that is itself silent is still declared dead, within the
        # threshold (5 periods) and a few ticks.
        victim = cluster.nodes[1].proc
        os.kill(victim.pid, signal.SIGSTOP)
        try:
            t0 = time.monotonic()
            while _alive(gcs) != [True, False]:
                assert time.monotonic() - t0 < 12.0, _alive(gcs)
                time.sleep(0.2)
        finally:
            os.kill(victim.pid, signal.SIGCONT)
        assert time.monotonic() - t0 > 4.0
    finally:
        gcs.close()
        cluster.shutdown()
