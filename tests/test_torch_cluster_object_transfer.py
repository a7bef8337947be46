"""Chunked node-to-node object transfer + daemon-side spill.

Round-3 object plane (reference: ``object_manager.cc:812`` chunked
push/pull, ``pull_manager.cc:801`` budgeted pulls,
``local_object_manager.cc:110`` spill): big objects cross nodes as bounded
chunk frames, land in the puller's shm arena and register as NEW locations
(broadcast fan-out), and objects larger than the arena live on the spill
shelf — so a 1 GiB-class object moves with bounded memory on both sides.

JAX's ``tests/test_object_transfer.py`` on a ``ray_tpu_torch`` Cluster.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.core import runtime as runtime_mod


def _wait_for(predicate, timeout=60.0, interval=0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def two_nodes():
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    core = connect(cluster.gcs_address)
    yield cluster, core
    core.shutdown()
    runtime_mod._global_runtime = None
    cluster.shutdown()


def test_chunked_pull_cross_node_registers_new_location(two_nodes):
    cluster, core = two_nodes
    # ~24 MB > pull_chunk_size (8 MB): crosses as a chunk pipeline.
    arr = np.arange(3_000_000, dtype=np.float64)
    ref = ray_tpu_torch.put(arr)
    origin_locs = core._gcs_rpc.call("locate_object", ref.id.binary())
    assert len(origin_locs) == 1
    origin_node = origin_locs[0][0]
    other = next(h for h in cluster.nodes if h.node_id != origin_node)

    @ray_tpu_torch.remote(scheduling_strategy=ray_tpu_torch.NodeAffinitySchedulingStrategy(
        node_id=other.node_id, soft=False))
    def consume(a):
        return float(a.sum())

    assert ray_tpu_torch.get(consume.remote(ref), timeout=300) == float(arr.sum())
    # The puller sealed its copy into the second node's arena and registered
    # the replica — the broadcast-tree property.
    assert _wait_for(lambda: len(
        core._gcs_rpc.call("locate_object", ref.id.binary())) >= 2, timeout=30)


def test_object_larger_than_arena_spills_and_crosses_nodes():
    """An object bigger than the WHOLE shm arena: put spills chunk-wise to
    the daemon's disk shelf; a consumer on another node chunk-pulls it back
    out of the spill file."""
    cluster = Cluster(
        num_nodes=2, resources_per_node={"CPU": 2},
        system_config={"object_store_memory": 16 * 1024 * 1024},
    )
    try:
        core = connect(cluster.gcs_address)
        try:
            arr = np.arange(5_000_000, dtype=np.float64)  # ~40 MB > 16 MB arena
            ref = ray_tpu_torch.put(arr)
            locs = core._gcs_rpc.call("locate_object", ref.id.binary())
            assert len(locs) == 1
            origin_node = locs[0][0]
            # Replica actually lives on the spill shelf, not in shm.
            meta = core._daemons.get(locs[0][1]).call(
                "object_meta", ref.id.binary())
            assert meta is not None and meta["where"] == "spill", meta
            # Drop the driver's cached value: the consumer must pull bytes.
            with core._cache_lock:
                core._cache.pop(ref.id, None)
            other = next(h for h in cluster.nodes
                         if h.node_id != origin_node)

            @ray_tpu_torch.remote(
                scheduling_strategy=ray_tpu_torch.NodeAffinitySchedulingStrategy(
                    node_id=other.node_id, soft=False))
            def consume(a):
                return float(a[0]), float(a[-1]), int(a.shape[0])

            first, last, n = ray_tpu_torch.get(consume.remote(ref), timeout=300)
            assert (first, last, n) == (0.0, 4_999_999.0, 5_000_000)
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_broadcast_fans_out_across_nodes():
    cluster = Cluster(num_nodes=4, resources_per_node={"CPU": 1})
    try:
        core = connect(cluster.gcs_address)
        try:
            arr = np.ones(2_500_000)  # ~20 MB
            ref = ray_tpu_torch.put(arr)

            @ray_tpu_torch.remote(
                scheduling_strategy=ray_tpu_torch.SpreadSchedulingStrategy())
            def consume(a):
                return float(a.sum())

            out = ray_tpu_torch.get([consume.remote(ref) for _ in range(4)],
                              timeout=600)
            assert out == [2_500_000.0] * 4
            # More than one node ended up holding a replica.
            assert _wait_for(lambda: len(core._gcs_rpc.call(
                "locate_object", ref.id.binary())) >= 2, timeout=30)
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()
