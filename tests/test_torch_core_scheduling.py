"""The port's runtime (``ray_tpu_torch``) through ``tests/test_core_scheduling.py``, with
the card (``GPU``) where the JAX package names TPU chips.

Scheduler + placement group tests — the reference's
``cluster_task_manager_test.cc`` / ``scheduling_policy_test.cc`` concerns
exercised through the Python surface on a multi-virtual-node cluster."""

import time

import pytest

import ray_tpu_torch


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_cluster():
    """4 virtual nodes, 2 CPU + 4 GPU each."""
    ray_tpu_torch.init(resources={"CPU": 2, "GPU": 4}, num_nodes=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_spread_strategy(ray_start_cluster):
    rt = ray_start_cluster

    @rt.remote(scheduling_strategy="SPREAD", num_cpus=1)
    def where():
        return rt.get_runtime_context().node_id.hex()

    nodes = set(rt.get([where.remote() for _ in range(8)]))
    assert len(nodes) >= 3  # 4 nodes; spread should hit most of them


def test_node_affinity(ray_start_cluster):
    rt = ray_start_cluster
    target = rt.nodes()[2]["NodeID"]
    from ray_tpu_torch.core.ids import NodeID

    @rt.remote(scheduling_strategy=rt.NodeAffinitySchedulingStrategy(node_id=NodeID.from_hex(target)))
    def where():
        return rt.get_runtime_context().node_id.hex()

    assert rt.get(where.remote()) == target


def test_placement_group_strict_pack(ray_start_cluster):
    rt = ray_start_cluster
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
    assert pg.ready(timeout=5)
    node_ids = pg.bundle_node_ids()
    assert node_ids[0] == node_ids[1]


def test_placement_group_strict_spread(ray_start_cluster):
    rt = ray_start_cluster
    pg = rt.placement_group([{"CPU": 1}] * 4, strategy="STRICT_SPREAD")
    assert pg.ready(timeout=5)
    node_ids = pg.bundle_node_ids()
    assert len(set(node_ids)) == 4


def test_placement_group_task_lands_on_bundle(ray_start_cluster):
    rt = ray_start_cluster
    pg = rt.placement_group([{"CPU": 1, "GPU": 2}], strategy="PACK")
    assert pg.ready(timeout=5)

    @rt.remote(
        scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0
        )
    )
    def where():
        return rt.get_runtime_context().node_id.hex()

    assert rt.get(where.remote()) == pg.bundle_node_ids()[0].hex()


def test_placement_group_reserves_resources(ray_start_cluster):
    rt = ray_start_cluster
    before = rt.available_resources().get("GPU", 0)
    pg = rt.placement_group([{"GPU": 4}], strategy="PACK")
    assert pg.ready(timeout=5)
    assert rt.available_resources().get("GPU", 0) == before - 4
    rt.remove_placement_group(pg)
    assert rt.available_resources().get("GPU", 0) == before


def test_gpu_node_gang_reservation(ray_start_cluster):
    """A STRICT_PACK GPU bundle gang = the atomic claim of one node's cards."""
    rt = ray_start_cluster
    pg = rt.placement_group([{"GPU": 4}], strategy="STRICT_PACK")
    assert pg.ready(timeout=5)
    # A second whole-node claim must land on a different node.
    pg2 = rt.placement_group([{"GPU": 4}], strategy="STRICT_PACK")
    assert pg2.ready(timeout=5)
    assert pg.bundle_node_ids()[0] != pg2.bundle_node_ids()[0]


def test_node_death_fails_actors(ray_start_cluster):
    rt = ray_start_cluster
    from ray_tpu_torch.core.runtime import get_runtime

    @rt.remote(num_cpus=1)
    class Pinned:
        def node(self):
            return rt.get_runtime_context().node_id

    actors = [Pinned.remote() for _ in range(4)]
    nodes_of = [rt.get(a.node.remote()) for a in actors]
    victim = nodes_of[0]
    get_runtime().remove_node(victim)
    time.sleep(0.3)
    dead = alive = 0
    for a, n in zip(actors, nodes_of):
        try:
            rt.get(a.node.remote(), timeout=5)
            alive += 1
        except rt.ActorError:
            dead += 1
    assert dead >= 1
    assert dead + alive == 4


def test_cluster_resources_sum(ray_start_cluster):
    rt = ray_start_cluster
    total = rt.cluster_resources()
    assert total["CPU"] == 8  # 4 nodes x 2
    assert total["GPU"] == 16  # 4 nodes x 4


def test_state_api_lists_and_summaries(ray_start_cluster):
    """``tests/test_util_and_state.py::TestStateApi`` on the port."""
    from ray_tpu_torch.util import state

    rt = ray_start_cluster

    @rt.remote
    def f(x):
        return x

    @rt.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    rt.get([f.remote(i) for i in range(3)] + [a.ping.remote()])

    nodes = state.list_nodes()
    assert len(nodes) == 4 and all(n["state"] == "ALIVE" for n in nodes)
    actors = state.list_actors()
    assert any(x["class_name"] == "A" for x in actors)
    tasks = state.list_tasks()
    assert any(t["name"].endswith("f") for t in tasks)
    assert state.summarize_tasks().get("FINISHED", 0) >= 3
    summary = state.cluster_summary()
    assert summary["alive_nodes"] == 4
    assert summary["resources_total"]["GPU"] == 16
    assert state.list_placement_groups() == []
