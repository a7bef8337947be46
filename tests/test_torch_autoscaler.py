"""JAX's autoscaler tests on the port, and ``bin_pack`` against JAX's.

``tests/test_autoscaler.py``'s bin-packing, its three tests on the
in-process runtime with ``FakeNodeProvider`` and its live-cluster test
(``LocalDaemonNodeProvider`` launching a real ``ray_tpu_torch.core.
node_daemon`` over ``GcsAutoscalerView``; idle timeout 1.5 s here, 8 s in
JAX's) run on ``ray_tpu_torch.autoscaler``. The GCE TPU-pod provider and
its ``gcloud`` test have no counterpart in the port, by design: the port
makes no cloud VMs. ``bin_pack``'s launch choices equal JAX's on drawn
demands, node types, node counts and in-flight capacity.
"""

import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_tpu.autoscaler import NodeType as JaxNodeType
from ray_tpu.autoscaler import bin_pack as jax_bin_pack

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    FakeNodeProvider,
    NodeType,
    bin_pack,
)

import torch_threads  # noqa: F401,E402  (one torch thread a test process)
from torch_time_limit import time_limit  # noqa: E402


@pytest.fixture
def ray_start_regular():
    ray_tpu.init(resources={"CPU": 4})
    yield ray_tpu
    ray_tpu.shutdown()


class TestBinPack:
    def test_packs_multiple_demands_per_node(self):
        nt = NodeType("cpu4", {"CPU": 4}, max_workers=10)
        launches = bin_pack([{"CPU": 1}] * 4, [nt], {})
        assert launches == {"cpu4": 1}

    def test_spills_to_second_node(self):
        nt = NodeType("cpu4", {"CPU": 4}, max_workers=10)
        launches = bin_pack([{"CPU": 3}, {"CPU": 3}], [nt], {})
        assert launches == {"cpu4": 2}

    def test_respects_max_workers(self):
        nt = NodeType("cpu1", {"CPU": 1}, max_workers=2)
        launches = bin_pack([{"CPU": 1}] * 5, [nt], {"cpu1": 1})
        assert launches == {"cpu1": 1}

    def test_picks_matching_type(self):
        cpu = NodeType("cpu", {"CPU": 8}, max_workers=4)
        gpu = NodeType("gpu", {"CPU": 4, "GPU": 4}, max_workers=4)
        launches = bin_pack([{"GPU": 4}], [cpu, gpu], {})
        assert launches == {"gpu": 1}


_KEYS = ("CPU", "GPU", "mem")
_shape = st.dictionaries(st.sampled_from(_KEYS),
                         st.sampled_from([0.5, 1.0, 2.0, 3.0, 4.0]),
                         min_size=1, max_size=3)


@settings(max_examples=150, deadline=None)
@given(demands=st.lists(_shape, max_size=12),
       types=st.lists(st.tuples(_shape, st.integers(0, 4)), min_size=1,
                      max_size=3),
       existing=st.lists(st.integers(0, 3), min_size=3, max_size=3),
       in_flight=st.lists(_shape, max_size=3))
def test_bin_pack_chooses_as_jax(demands, types, existing, in_flight):
    mine = [NodeType(f"t{i}", dict(r), max_workers=m)
            for i, (r, m) in enumerate(types)]
    theirs = [JaxNodeType(f"t{i}", dict(r), max_workers=m)
              for i, (r, m) in enumerate(types)]
    have = {f"t{i}": n for i, n in enumerate(existing[:len(types)])}
    got = bin_pack([dict(d) for d in demands], mine, dict(have),
                   pending_capacity=[dict(c) for c in in_flight])
    want = jax_bin_pack([dict(d) for d in demands], theirs, dict(have),
                        pending_capacity=[dict(c) for c in in_flight])
    assert got == want


class TestAutoscalerE2E:
    def test_upscale_unparks_infeasible_task(self, ray_start_regular):
        provider = FakeNodeProvider()
        asc = Autoscaler(
            provider,
            AutoscalerConfig(
                node_types=[NodeType("big", {"CPU": 2, "bignode": 1},
                                     max_workers=2)],
                update_interval_s=0.05,
            ),
        )
        asc.start()
        try:
            @ray_tpu.remote(resources={"bignode": 0.5})
            def needs_big():
                return "ran-on-big"

            # infeasible on the base cluster; autoscaler must add a node
            result = ray_tpu.get(needs_big.remote(), timeout=30)
            assert result == "ran-on-big"
            assert len(provider.non_terminated_nodes()) >= 1
        finally:
            asc.stop()

    def test_min_workers_satisfied_at_start(self, ray_start_regular):
        provider = FakeNodeProvider()
        asc = Autoscaler(
            provider,
            AutoscalerConfig(
                node_types=[NodeType("warm", {"CPU": 1}, min_workers=2,
                                     max_workers=4)],
                update_interval_s=0.05,
            ),
        )
        asc.start()
        try:
            assert len(provider.non_terminated_nodes()) == 2
        finally:
            asc.stop()

    def test_idle_nodes_terminated(self, ray_start_regular):
        provider = FakeNodeProvider()
        asc = Autoscaler(
            provider,
            AutoscalerConfig(
                node_types=[NodeType("burst", {"CPU": 2, "burst": 2},
                                     max_workers=2)],
                update_interval_s=0.05,
                idle_timeout_s=0.3,
            ),
        )
        asc.start()
        try:
            @ray_tpu.remote(resources={"burst": 1})
            def burst_work():
                return 1

            assert ray_tpu.get(burst_work.remote(), timeout=30) == 1
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if len(provider.non_terminated_nodes()) == 0:
                    break
                time.sleep(0.05)
            assert len(provider.non_terminated_nodes()) == 0, \
                "idle node not reclaimed"
        finally:
            asc.stop()


class TestLiveClusterAutoscaling:
    """The autoscaler drives a LIVE multiprocess cluster: scale-up launches
    a real node-daemon process; scale-down SIGTERMs it."""

    def test_infeasible_task_triggers_daemon_launch_and_runs(
            self, monkeypatch):
        from ray_tpu_torch.autoscaler import (GcsAutoscalerView,
                                              LocalDaemonNodeProvider)
        from ray_tpu_torch.core import runtime as runtime_mod
        from ray_tpu_torch.core.cluster import Cluster, connect

        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        with time_limit(120, "the cluster start"):
            cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 1})
        provider = None
        try:
            core = connect(cluster.gcs_address)
            try:
                provider = LocalDaemonNodeProvider(cluster.gcs_address)
                scaler = Autoscaler(
                    provider,
                    AutoscalerConfig(
                        node_types=[NodeType("big", {"CPU": 4},
                                             max_workers=2)],
                        idle_timeout_s=1.5,
                        update_interval_s=0.25,
                    ),
                    runtime=GcsAutoscalerView(core),
                )
                scaler.start()
                try:
                    @ray_tpu.remote(num_cpus=4)
                    def needs_big():
                        import os

                        return os.getpid()

                    # Infeasible on the 1-CPU cluster until the autoscaler
                    # launches the 4-CPU daemon.
                    pid = ray_tpu.get(needs_big.remote(), timeout=240)
                    assert pid > 0
                    assert len(provider.non_terminated_nodes()) >= 1
                    # Scale-down: the added node idles past the timeout and
                    # is terminated (SIGTERM to the daemon process).
                    deadline = time.time() + 60
                    while time.time() < deadline:
                        if not provider.non_terminated_nodes():
                            break
                        time.sleep(0.5)
                    assert not provider.non_terminated_nodes(), \
                        "idle daemon never terminated"
                finally:
                    scaler.stop()
            finally:
                core.shutdown()
                runtime_mod._global_runtime = None
        finally:
            if provider is not None:
                provider.shutdown()
            cluster.shutdown()


def test_no_cloud_provider_in_the_port():
    import ray_tpu_torch.autoscaler as mine

    assert "TPUPodNodeProvider" not in mine.__all__
    assert not hasattr(mine, "TPUPodNodeProvider")
