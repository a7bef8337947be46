"""JAX's compiled-DAG tests that start a multi-process ``Cluster``
(``tests/test_dag.py``) on the port, with the port's own across processes.

Stages run in worker processes of a port ``Cluster`` (a GCS process, node
daemons and workers): the compiled path against plain actor calls, the
worker-side channel lifecycle, socket edges across two daemons, device
channels carrying tensors between worker processes (``channel_device=
"cpu"`` here, where there is no card) and ``channel_type="auto"`` picking
shm for every edge of one host. Each test starts and stops its own
cluster, as JAX's do; every wait has a timeout of its own.
"""

import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.dag import InputNode


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_per_process():
    """Every process a Cluster starts inherits the environment: one torch
    thread each, so parallel test workers do not oversubscribe the host."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def test_compiled_beats_rpc_latency_multiprocess():
    """The point of aDAG: per-call overhead well under actor-task RPC.

    Measured on the MULTIPROCESS runtime — the channel path bypasses
    spec pickling, per-call RPC, and result sealing. (In-process actor
    calls are already ~100µs thread handoffs; the win is cross-process.)
    """
    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            class Echo:
                def apply(self, x):
                    return x

            e = Echo.remote()
            ray_tpu_torch.get(e.apply.remote(0), timeout=120)  # warm worker
            n = 50

            e2 = Echo.remote()
            ray_tpu_torch.get(e2.apply.remote(0), timeout=120)
            compiled = e2.apply.bind(InputNode()).experimental_compile()
            try:
                assert compiled.execute(41).get(timeout=60) == 41  # warm
                # The n calls of each path in turns of 10, so that both
                # see the same neighbours' load: under a parallel test
                # run the load moves within seconds, and two windows one
                # after the other compare the load, not the paths.
                plain = fast = 0.0
                for turn in range(0, n, 10):
                    t0 = time.perf_counter()
                    for i in range(turn, turn + 10):
                        ray_tpu_torch.get(e.apply.remote(i), timeout=60)
                    t1 = time.perf_counter()
                    for i in range(turn, turn + 10):
                        assert compiled.execute(i).get(timeout=60) == i
                    plain += t1 - t0
                    fast += time.perf_counter() - t1
                plain, fast = plain / n, fast / n
            finally:
                compiled.teardown()
            # Round 3's direct task transport cut plain actor RPC from
            # ~5ms to well under 1ms, so the old 2× margin is no longer
            # guaranteed on a loaded 1-core CI box — the property that
            # matters is that the channel path still wins at all.
            assert fast < plain, (fast, plain)
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


class TestWorkerChannelLifecycle:
    def test_worker_detaches_channel_fds_on_loop_exit(self):
        """The worker-side leak fix: a stage worker's attached channel
        endpoints (mmap + backing fd per channel) are closed when its
        resident loop exits at teardown — previously every compiled DAG
        leaked two fds per stage worker, forever."""
        cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 3})
        try:
            core = connect(cluster.gcs_address)
            try:
                @ray_tpu_torch.remote
                class Probe:
                    def apply(self, x):
                        return x

                    def chan_fds(self):
                        import os as _os

                        n = 0
                        for fd in _os.listdir("/proc/self/fd"):
                            try:
                                tgt = _os.readlink(f"/proc/self/fd/{fd}")
                            except OSError:
                                continue
                            if "rtpu-chan" in tgt or "rtpu-schan" in tgt \
                                    or "rtpu-devchan" in tgt:
                                n += 1
                        return n

                a, b = Probe.remote(), Probe.remote()
                ray_tpu_torch.get([a.apply.remote(0), b.apply.remote(0)],
                            timeout=120)
                for _round in range(2):  # repeated compiles must not accrete
                    dag = b.apply.bind(a.apply.bind(InputNode()))
                    compiled = dag.experimental_compile()
                    try:
                        assert compiled.execute(7).get(timeout=60) == 7
                    finally:
                        compiled.teardown()
                # The loops exited and detached: no channel-backed fds
                # survive in either stage worker.
                assert ray_tpu_torch.get(a.chan_fds.remote(), timeout=60) == 0
                assert ray_tpu_torch.get(b.chan_fds.remote(), timeout=60) == 0
            finally:
                core.shutdown()
                runtime_mod._global_runtime = None
        finally:
            cluster.shutdown()


@pytest.mark.slow
def test_socket_dag_burst_pipelining_multidaemon():
    """Cross-daemon compiled DAG over FORCED socket channels: a burst
    submitted ahead of any fetch pipelines through the windowed acks
    and drains FIFO (the per-frame-ack design serialized this)."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            class AddOne:
                def apply(self, x):
                    return x + 1

            @ray_tpu_torch.remote
            class Double:
                def apply(self, x):
                    return x * 2

            a, d = AddOne.remote(), Double.remote()
            ray_tpu_torch.get([a.apply.remote(0), d.apply.remote(0)],
                        timeout=120)
            dag = d.apply.bind(a.apply.bind(InputNode()))
            compiled = dag.experimental_compile(channel_type="socket")
            try:
                refs = [compiled.execute(i) for i in range(12)]
                assert [r.get(timeout=60) for r in refs] == \
                    [(i + 1) * 2 for i in range(12)]
            finally:
                compiled.teardown()
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()

def test_compiled_dag_over_sockets_multiprocess():
    """A 2-stage compiled DAG with FORCED socket channels across real
    worker processes: same results as the shm path."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            class AddOne:
                def apply(self, x):
                    return x + 1

            @ray_tpu_torch.remote
            class Double:
                def apply(self, x):
                    return x * 2

            a, d = AddOne.remote(), Double.remote()
            ray_tpu_torch.get([a.apply.remote(0), d.apply.remote(0)],
                        timeout=120)
            dag = d.apply.bind(a.apply.bind(InputNode()))
            compiled = dag.experimental_compile(channel_type="socket")
            try:
                for i in range(8):
                    assert compiled.execute(i).get(timeout=60) == (i + 1) * 2
            finally:
                compiled.teardown()
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_device_channels_carry_tensors_between_worker_processes():
    """A 2-stage compiled DAG over device channels whose stages are worker
    processes: each stage gets a torch tensor (bf16 included) on the
    channel's device, bit for bit, and the driver gets the last stage's
    tensor back."""
    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            class Stage:
                def __init__(self, k):
                    self.k = k

                def apply(self, x):
                    import os

                    import torch

                    assert isinstance(x, torch.Tensor), type(x)
                    assert x.device.type == "cpu"
                    return (x * self.k).to(x.dtype), os.getpid()

                def pid(self):
                    import os

                    return os.getpid()

                def first(self, pair):
                    return pair[0]

            a, b = Stage.remote(3), Stage.remote(1)
            pids = ray_tpu_torch.get([a.pid.remote(), b.pid.remote()],
                                     timeout=120)
            assert len(set(pids)) == 2
            with InputNode() as inp:
                dag = b.first.bind(a.apply.bind(inp))
            compiled = dag.experimental_compile(channel_type="device",
                                                channel_device="cpu",
                                                channel_slots=2)
            try:
                for dtype in (torch.bfloat16, torch.float32):
                    x = (torch.arange(4096, dtype=torch.float32) / 7.0
                         ).reshape(64, 64).to(dtype)
                    refs = [compiled.execute(x + i) for i in range(6)]
                    for i, ref in enumerate(refs):
                        out = ref.get(timeout=60)
                        assert out.dtype == dtype and out.device.type == "cpu"
                        assert torch.equal(out, ((x + i) * 3).to(dtype))
            finally:
                compiled.teardown()
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_auto_channels_pick_shm_on_one_host():
    """``channel_type="auto"`` chooses per edge: on one host (two daemons,
    one machine) every edge is an shm ring, none a socket."""
    from ray_tpu_torch.dag import Channel, SocketChannel

    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 1})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            class AddOne:
                def apply(self, x):
                    return x + 1

            nodes = cluster.nodes
            a, d = (AddOne.options(
                scheduling_strategy=ray_tpu_torch.NodeAffinitySchedulingStrategy(
                    node_id=n.node_id)).remote() for n in nodes)
            ray_tpu_torch.get([a.apply.remote(0), d.apply.remote(0)],
                              timeout=120)
            compiled = d.apply.bind(a.apply.bind(InputNode())
                                    ).experimental_compile()
            try:
                kinds = {type(ch) for ch in compiled._channels.values()}
                assert kinds == {Channel}, kinds
                assert SocketChannel not in kinds
                assert [compiled.execute(i).get(timeout=60)
                        for i in range(4)] == [2, 3, 4, 5]
            finally:
                compiled.teardown()
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()
