"""JAX's cross-process collectives tests on the port, and the port's
schedules held to JAX's.

``test_gloo_collectives_across_processes`` and
``test_ring_collectives_full_surface`` are JAX's two collectives tests of
``tests/test_multiprocess.py`` on a port ``Cluster``. Then the same seeded
inputs go through the ring (flat) and the hierarchical schedule on a
``Cluster`` of each package, 2 nodes x 2 ranks: the results must be equal,
for every reduce op, reducescatter and allgather. Last, bf16 torch tensors
(2 ranks per node) through the hierarchical allreduce: the f32 sum of the
bf16 words rounded once. Each test starts and stops its own clusters, and
every wait has a timeout of its own.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.cluster import Cluster, connect

OPS = ("sum", "prod", "min", "max", "mean")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_per_process():
    """Every process a Cluster starts inherits the environment: one torch
    thread each, so parallel test workers do not oversubscribe the host."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def test_gloo_collectives_across_processes():
    """Eager collectives with the cross-process ("gloo") backend: 3 actor
    PROCESSES rendezvous through the GCS KV and exchange via rank 0's hub
    (the ray.util.collective gloo-group analog)."""
    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 3})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            class Member:
                def __init__(self, rank, world):
                    from ray_tpu_torch.parallel import collectives as c

                    c.init_collective_group(world, rank, backend="gloo",
                                            group_name="xp")
                    self.rank = rank
                    self.world = world

                def round_trip(self):
                    import numpy as np

                    from ray_tpu_torch.parallel import collectives as c

                    total = c.allreduce(np.array([self.rank + 1.0]),
                                        group_name="xp")
                    gathered = c.allgather(np.array([self.rank]),
                                           group_name="xp")
                    root = c.broadcast(
                        np.array([42.0]) if self.rank == 0 else None,
                        src_rank=0, group_name="xp")
                    return (float(total[0]),
                            [int(g[0]) for g in gathered],
                            float(root[0]),
                            os.getpid())

                def p2p(self):
                    import numpy as np

                    from ray_tpu_torch.parallel import collectives as c

                    if self.rank == 0:
                        c.send(np.array([7.0]), dst_rank=2, group_name="xp")
                        return None
                    if self.rank == 2:
                        got = c.recv(0, group_name="xp", timeout=60)
                        return float(got[0])
                    return None

            world = 3
            members = [Member.options(num_cpus=1).remote(r, world)
                       for r in range(world)]
            # All ranks must run the collective concurrently.
            results = ray_tpu_torch.get(
                [m.round_trip.remote() for m in members], timeout=180)
            pids = {r[3] for r in results}
            assert len(pids) == world, "members must be distinct processes"
            for total, gathered, root, _pid in results:
                assert total == 6.0          # 1 + 2 + 3
                assert gathered == [0, 1, 2]
                assert root == 42.0
            p2p = ray_tpu_torch.get([m.p2p.remote() for m in members], timeout=120)
            assert p2p[2] == 7.0
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_ring_collectives_full_surface():
    """The hubless ring backend across 4 actor processes: allreduce
    (sum/mean/scalar), reducescatter, alltoall, broadcast from a nonzero
    root, barrier, and back-to-back rounds (tag isolation between ops)."""
    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            class Member:
                def __init__(self, rank, world):
                    from ray_tpu_torch.parallel import collectives as c

                    c.init_collective_group(world, rank, backend="gloo",
                                            group_name="ring4")
                    self.rank = rank
                    self.world = world

                def rounds(self):
                    import numpy as np

                    from ray_tpu_torch.parallel import collectives as c

                    out = {}
                    base = np.arange(8.0) + self.rank
                    out["sum"] = c.allreduce(base, group_name="ring4")
                    out["mean"] = c.allreduce(base, op="mean",
                                              group_name="ring4")
                    out["scalar"] = c.allreduce(np.float64(self.rank + 1),
                                                group_name="ring4")
                    rs = c.reducescatter(np.arange(8.0) + self.rank,
                                         group_name="ring4")
                    out["rs"] = rs
                    a2a = c.alltoall(np.arange(8.0) * (self.rank + 1),
                                     group_name="ring4")
                    out["a2a"] = a2a
                    out["bcast"] = c.broadcast(
                        np.array([9.0, 9.5]) if self.rank == 2 else None,
                        src_rank=2, group_name="ring4")
                    c.barrier(group_name="ring4")
                    # second back-to-back allreduce: tags must not collide
                    out["sum2"] = c.allreduce(np.ones(3) * self.rank,
                                              group_name="ring4")
                    return out

            world = 4
            members = [Member.options(num_cpus=1).remote(r, world)
                       for r in range(world)]
            results = ray_tpu_torch.get([m.rounds.remote() for m in members],
                                  timeout=240)
            import numpy as np

            expect_sum = np.sum([np.arange(8.0) + r for r in range(world)],
                                axis=0)
            for rank, out in enumerate(results):
                np.testing.assert_allclose(out["sum"], expect_sum)
                np.testing.assert_allclose(out["mean"], expect_sum / world)
                assert out["scalar"] == sum(range(1, world + 1))
                np.testing.assert_allclose(
                    out["rs"], np.array_split(expect_sum, world)[rank])
                expect_a2a = np.concatenate(
                    [np.array_split(np.arange(8.0) * (s + 1), world)[rank]
                     for s in range(world)])
                np.testing.assert_allclose(out["a2a"], expect_a2a)
                np.testing.assert_allclose(out["bcast"], [9.0, 9.5])
                np.testing.assert_allclose(out["sum2"],
                                           np.ones(3) * sum(range(world)))
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def _schedule_inputs(rank, n=3001):
    rng = np.random.default_rng(100 + rank)
    return 1.0 + rng.standard_normal(n) * 0.01


def _owned(value):
    """``value`` with every array copied out of the arena (a ``get`` may
    return views into it, and the arena goes with its cluster)."""
    if isinstance(value, np.ndarray):
        return np.array(value, copy=True)
    if isinstance(value, (list, tuple)):
        return type(value)(_owned(v) for v in value)
    if isinstance(value, dict):
        return {k: _owned(v) for k, v in value.items()}
    return value


def _schedules(rt_mod, cluster_mod, pkg):
    """Every op through the hierarchical and the flat schedule, plus a
    reducescatter and an allgather, on a 2-node x 2-rank ``Cluster`` of
    ``pkg`` ("ray_tpu" or "ray_tpu_torch"): {(group, what): per-rank
    results}."""
    cluster = cluster_mod.Cluster(num_nodes=2,
                                  resources_per_node={"CPU": 2})
    try:
        core = cluster_mod.connect(cluster.gcs_address)
        try:
            @rt_mod.remote
            class Member:
                def __init__(self, rank, world, pkg):
                    self.rank, self.world, self.pkg = rank, world, pkg

                def _c(self):
                    import importlib

                    return importlib.import_module(
                        self.pkg + ".parallel.collectives")

                def join(self, group, hier):
                    import importlib

                    cfg = importlib.import_module(self.pkg + ".core.config")
                    cfg.set_config(cfg.Config(
                        {"collective_hierarchy_enabled": hier,
                         "collective_segment_size": 4096}))
                    self._c().init_collective_group(
                        self.world, self.rank, backend="gloo",
                        group_name=group)
                    return True

                def run(self, group, x):
                    c = self._c()
                    out = {op: c.allreduce(x, op=op, group_name=group)
                           for op in ("sum", "prod", "min", "max", "mean")}
                    out["rs"] = c.reducescatter(x, op="sum",
                                                group_name=group)
                    out["ag"] = c.allgather(x[:5], group_name=group)
                    out["stats"] = c.get_group_stats(group)
                    return out

            nodes = cluster.nodes
            members = [Member.options(
                num_cpus=1,
                scheduling_strategy=rt_mod.NodeAffinitySchedulingStrategy(
                    node_id=nodes[r // 2].node_id)).remote(r, 4, pkg)
                for r in range(4)]
            got = {}
            for group, hier in (("hier", True), ("flat", False)):
                rt_mod.get([m.join.remote(group, hier) for m in members],
                           timeout=120)
                got[group] = _owned(rt_mod.get(
                    [m.run.remote(group, _schedule_inputs(r))
                     for r, m in enumerate(members)], timeout=120))
            return got
        finally:
            core.shutdown()
            rt_mod.core.runtime._global_runtime = None
    finally:
        cluster.shutdown()


def test_ring_and_hierarchical_schedules_match_jax():
    """The same seeded f64 inputs through JAX's schedules and the port's:
    every op, reducescatter and allgather give equal results, bit for bit,
    and each package took the schedule asked for."""
    import ray_tpu
    import ray_tpu.core.cluster as jcluster
    import ray_tpu.core.runtime  # noqa: F401 — _schedules resets it
    import ray_tpu_torch.core.cluster as tcluster

    theirs = _schedules(ray_tpu, jcluster, "ray_tpu")
    ours = _schedules(ray_tpu_torch, tcluster, "ray_tpu_torch")
    for group in ("hier", "flat"):
        for rank in range(4):
            o, t = ours[group][rank], theirs[group][rank]
            for what in OPS + ("rs",):
                assert o[what].dtype == t[what].dtype
                np.testing.assert_array_equal(o[what], t[what],
                                              err_msg=f"{group} {what}")
            for a, b in zip(o["ag"], t["ag"]):
                np.testing.assert_array_equal(a, b)
        rounds = "hier_rounds" if group == "hier" else "flat_rounds"
        assert sum(r["stats"][rounds] for r in ours[group]) == 4 * len(OPS)
        assert [r["stats"] for r in ours[group]] == \
            [r["stats"] for r in theirs[group]]
    exp = np.sum([_schedule_inputs(r) for r in range(4)], axis=0)
    np.testing.assert_allclose(ours["hier"][0]["sum"], exp, rtol=1e-12)


def test_bf16_tensors_through_the_hierarchical_allreduce():
    """bf16 torch tensors on 2 nodes x 2 ranks: the hierarchical allreduce
    returns a bf16 tensor equal to the f32 reduction of the same bf16
    values rounded once, for sum and mean, on every rank."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            @ray_tpu_torch.remote
            class Member:
                def __init__(self, rank):
                    from ray_tpu_torch.parallel import collectives as c

                    c.init_collective_group(4, rank, backend="gloo",
                                            group_name="bf")
                    self.rank = rank

                def run(self, x):
                    from ray_tpu_torch.parallel import collectives as c

                    return (c.allreduce(x, group_name="bf"),
                            c.allreduce(x, op="mean", group_name="bf"),
                            c.get_group_stats("bf"))

            import torch

            nodes = cluster.nodes
            xs = [torch.from_numpy(_schedule_inputs(r, 700_001)
                                   ).to(torch.bfloat16) for r in range(4)]
            members = [Member.options(
                num_cpus=1,
                scheduling_strategy=ray_tpu_torch.NodeAffinitySchedulingStrategy(
                    node_id=nodes[r // 2].node_id)).remote(r)
                for r in range(4)]
            outs = ray_tpu_torch.get(
                [m.run.remote(xs[r]) for r, m in enumerate(members)],
                timeout=120)
            f32 = torch.stack([x.float() for x in xs])
            want_sum = f32.sum(0).to(torch.bfloat16)
            want_mean = (f32.sum(0) / 4).to(torch.bfloat16)
            for s, m, stats in outs:
                assert s.dtype == m.dtype == torch.bfloat16
                assert torch.equal(s, want_sum) and torch.equal(m, want_mean)
            assert sum(st["hier_rounds"] for _, _, st in outs) == 8
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()
