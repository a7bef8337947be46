"""The port's node liveness under load (ROADMAP Queue 3): the GCS must keep
a node alive while its handler pool is taken by calls that block.

The GCS runs every RPC on a pool of 128 threads, and some calls wait there
for a long time (a lease request waits up to its timeout for capacity, a
long poll for news). With the pool full, a daemon's heartbeat queued
behind them, its 5 s call timed out, and the GCS declared the node dead
within the 5 s threshold (``health_check_period_s`` 1.0 x
``health_check_failure_threshold`` 5, JAX's values, unchanged here). The
heartbeat now runs on its connection's reader thread under a lock of its
own."""

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
