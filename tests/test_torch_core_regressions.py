"""The port's runtime (``ray_tpu_torch``) through ``tests/test_core_regressions.py``, with
the card (``GPU``) where the JAX package names TPU chips.

Regression tests for review findings on the core runtime."""

import time

import pytest

import ray_tpu_torch

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


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


def test_retry_does_not_leak_resources(ray_start_regular):
    """Failed attempts must release their CPU allocation."""
    rt = ray_start_regular
    counter = {"n": 0}

    @rt.remote(num_cpus=4, max_retries=3, retry_exceptions=True)
    def flaky():
        counter["n"] += 1
        if counter["n"] < 4:
            raise RuntimeError("transient")
        return "done"

    assert rt.get(flaky.remote()) == "done"
    # All 4 CPUs must be free again after the retries.
    deadline = time.time() + 5
    while time.time() < deadline:
        if rt.available_resources().get("CPU", 0) == 4:
            break
        time.sleep(0.05)
    assert rt.available_resources().get("CPU", 0) == 4


def test_actor_call_before_creation_completes(ray_start_regular):
    """Method calls during slow creation buffer, not error."""
    rt = ray_start_regular

    @rt.remote
    class Slow:
        def __init__(self):
            time.sleep(0.5)
            self.ready = True

        def check(self):
            return self.ready

    s = Slow.remote()
    # Submit immediately — creation still running.
    assert rt.get(s.check.remote(), timeout=10) is True


def test_actor_ordering_with_pending_deps(ray_start_regular):
    """A later no-dep call must not overtake an earlier call blocked on deps."""
    rt = ray_start_regular

    @rt.remote
    def slow_value():
        time.sleep(0.5)
        return 42

    @rt.remote
    class Box:
        def __init__(self):
            self.v = None

        def set(self, v):
            self.v = v

        def get_v(self):
            return self.v

    b = Box.remote()
    b.set.remote(slow_value.remote())  # dep resolves in ~0.5s
    # Submitted after set(): must observe the set value.
    assert rt.get(b.get_v.remote(), timeout=10) == 42


def test_pending_placement_group_eventually_places(ray_start_regular):
    """A PG created while resources are busy places once they free."""
    rt = ray_start_regular

    @rt.remote(num_gpus=8)
    def hog():
        time.sleep(1.0)
        return 1

    h = hog.remote()
    time.sleep(0.2)
    pg = rt.placement_group([{"GPU": 8}], strategy="STRICT_PACK")
    assert not pg.ready(timeout=0.1)  # resources still held
    assert rt.get(h) == 1
    assert pg.ready(timeout=5)


def test_actor_in_placement_group_bundle(ray_start_regular):
    """An actor using a PG bundle must not double-allocate chip resources."""
    rt = ray_start_regular
    pg = rt.placement_group([{"GPU": 8, "CPU": 1}], strategy="STRICT_PACK")
    assert pg.ready(timeout=5)

    @rt.remote(num_gpus=8)
    class SliceActor:
        def ping(self):
            return "ok"

    a = SliceActor.options(
        scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0
        )
    ).remote()
    assert rt.get(a.ping.remote(), timeout=10) == "ok"


def test_restart_preserves_call_ordering(ray_start_regular):
    """Sequence tracking survives actor restart."""
    rt = ray_start_regular

    @rt.remote(max_restarts=2)
    class P:
        def ping(self):
            return "alive"

    p = P.remote()
    for _ in range(3):
        assert rt.get(p.ping.remote(), timeout=10) == "alive"
    rt.kill(p, no_restart=False)
    time.sleep(0.3)
    for _ in range(3):
        assert rt.get(p.ping.remote(), timeout=10) == "alive"


def test_put_copies_numpy_buffer(ray_start_regular):
    """Mutating an array after put must not mutate the stored object."""
    import numpy as np

    rt = ray_start_regular
    arr = np.zeros(1000, dtype=np.float64)
    ref = rt.put(arr)
    arr[:] = 99.0
    stored = rt.get(ref)
    assert stored.sum() == 0.0


def test_hard_node_affinity_queues_when_busy(ray_start_cluster):
    """Hard affinity to a busy-but-feasible node queues instead of failing."""
    rt = ray_start_cluster
    from ray_tpu_torch.core.ids import NodeID

    target = NodeID.from_hex(rt.nodes()[0]["NodeID"])

    @rt.remote(num_cpus=2, scheduling_strategy=rt.NodeAffinitySchedulingStrategy(node_id=target))
    def busy():
        time.sleep(0.5)
        return rt.get_runtime_context().node_id.hex()

    a = busy.remote()
    b = busy.remote()  # node busy now; must queue, not fail
    assert rt.get([a, b], timeout=15) == [target.hex(), target.hex()]
