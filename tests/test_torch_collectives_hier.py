"""JAX's topology-aware collectives tests (``tests/test_collectives_hier.py``)
on the port: the two-level schedule of ``ray_tpu_torch.parallel.
collectives`` — intra-node shm reduce at a leader, segmented pipelined ring
between node leaders, shm-key fan-out — plus the in-place reduction kernels
and the flat-ring equivalence contract, each as JAX's test runs it.

Real process boundaries throughout: every cross-process case runs member
ACTORS on a multi-node port :class:`Cluster` (distinct daemons, distinct
node stores), pinned per node with NodeAffinity so the rank→store grouping
is deterministic. Each test starts and stops its own cluster, and every
wait has a timeout of its own.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.cluster import Cluster, connect

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_per_process():
    """Every process a Cluster starts inherits the environment: one torch
    thread each, so parallel test workers do not oversubscribe the host."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


OPS = ("sum", "prod", "min", "max", "mean")
_NP_OPS = {"sum": np.sum, "prod": np.prod, "min": np.min, "max": np.max,
           "mean": np.mean}


def _rank_input(rank: int, n: int) -> np.ndarray:
    # Values near 1 so prod stays finite at any size; distinct per rank so
    # min/max/broadcast orderings are actually exercised. Keep in sync with
    # Member._inp below (duplicated because the member class must pickle
    # self-contained by value into worker processes).
    return 1.0 + ((np.arange(n) * 13 + rank * 7) % 5) * (0.01 * (rank + 1))


def _expected(op: str, world: int, n: int) -> np.ndarray:
    return _NP_OPS[op](np.stack([_rank_input(r, n) for r in range(world)]),
                       axis=0)


def _member_cls():
    @ray_tpu_torch.remote
    class Member:
        def __init__(self, rank, world):
            self.rank = rank
            self.world = world

        @staticmethod
        def _inp(rank, n):
            import numpy as np

            return 1.0 + ((np.arange(n) * 13 + rank * 7) % 5) * (
                0.01 * (rank + 1))

        def store(self):
            import os

            return os.environ.get("RAY_TPU_STORE_NAME", "")

        def join(self, group, hier=None, segment=None, timeout=None):
            overrides = {}
            if hier is not None:
                overrides["collective_hierarchy_enabled"] = hier
            if segment is not None:
                overrides["collective_segment_size"] = segment
            if timeout is not None:
                overrides["collective_timeout_s"] = timeout
            if overrides:
                from ray_tpu_torch.core.config import Config, set_config

                set_config(Config(overrides))
            from ray_tpu_torch.parallel import collectives as c

            c.init_collective_group(self.world, self.rank, backend="gloo",
                                    group_name=group)
            return True

        def allreduce(self, group, op, n):
            from ray_tpu_torch.parallel import collectives as c

            return c.allreduce(self._inp(self.rank, n), op=op,
                               group_name=group)

        def allreduce_guarded(self, group, op, n):
            from ray_tpu_torch.parallel import collectives as c

            try:
                c.allreduce(self._inp(self.rank, n), op=op, group_name=group)
                return "ok"
            except Exception as e:  # noqa: BLE001 — the NAME is the assert
                return type(e).__name__

        def surface(self, group):
            import numpy as np

            from ray_tpu_torch.parallel import collectives as c

            out = {}
            base = np.arange(8.0) + self.rank
            out["bcast"] = c.broadcast(
                np.array([9.0, 9.5]) if self.rank == 1 else None,
                src_rank=1, group_name=group)
            out["gather"] = c.allgather(np.arange(4.0) * (self.rank + 1),
                                        group_name=group)
            out["rs"] = c.reducescatter(base, op="mean", group_name=group)
            out["a2a"] = c.alltoall(np.arange(8.0) * (self.rank + 1),
                                    group_name=group)
            c.barrier(group_name=group)
            out["scalar"] = float(c.allreduce(np.float64(self.rank + 1),
                                              group_name=group))
            # F-contiguous input: the leader's promoted/accumulated buffer
            # must stay attached to its flattened ring view.
            out["fcontig"] = c.allreduce(
                (np.arange(12.0).reshape(3, 4) * (self.rank + 1)).T,
                group_name=group)
            if self.rank == 0:
                c.send(np.array([7.5]), dst_rank=self.world - 1,
                       group_name=group)
            if self.rank == self.world - 1:
                out["p2p"] = float(c.recv(0, group_name=group)[0])
            return out

        def stats(self, group):
            from ray_tpu_torch.parallel import collectives as c

            return c.get_group_stats(group)

        def die(self):
            import os

            os._exit(1)

    return Member


def _spawn(cluster, world):
    """``world`` members, pinned CONTIGUOUSLY across the cluster's nodes
    (rank r on node r*nodes//world) so the store grouping is deterministic:
    2 nodes × 4 ranks → ranks (0,1) share node 0's store, (2,3) node 1's."""
    Member = _member_cls()
    nodes = cluster.nodes
    members = []
    for r in range(world):
        node = nodes[r * len(nodes) // world]
        members.append(Member.options(
            num_cpus=1,
            scheduling_strategy=ray_tpu_torch.NodeAffinitySchedulingStrategy(
                node_id=node.node_id)).remote(r, world))
    return members


def _require_stores(members, expect_distinct):
    stores = ray_tpu_torch.get([m.store.remote() for m in members], timeout=120)
    if not all(stores):
        pytest.skip("native shm store unavailable on this host")
    assert len(set(stores)) == expect_distinct, stores
    return stores


# ====================== in-place reduction kernels ======================


def test_inplace_reduce_kernels_match_numpy_and_do_not_mutate():
    from ray_tpu_torch.parallel.collectives import _REDUCE_OPS

    for dtype in (np.float64, np.float32, np.int32):
        arrs = [(np.arange(6) % 4 + 1).astype(dtype) * (r + 1)
                for r in range(3)]
        keep = [a.copy() for a in arrs]
        for op in OPS:
            ours = _REDUCE_OPS[op](arrs)
            ref = _NP_OPS[op](np.stack(arrs), axis=0)
            # Same dtype promotion as the old stack-then-reduce path
            # (sum/prod widen sub-word ints, mean of ints is float64).
            assert ours.dtype == ref.dtype, (op, dtype, ours.dtype, ref.dtype)
            np.testing.assert_allclose(ours, ref)
        for a, k in zip(arrs, keep):  # inputs never mutated
            np.testing.assert_array_equal(a, k)
    # 0-d contract (scalar allreduce rides through atleast_1d + reshape).
    assert float(_REDUCE_OPS["mean"]([np.float64(1.0), np.float64(3.0)])) == 2.0
    # float16 mean keeps np.mean's float32 intermediate: accumulating many
    # f16 contributions must not round per step.
    f16 = [np.full(64, 0.1, dtype=np.float16) for _ in range(32)]
    ours = _REDUCE_OPS["mean"](f16)
    ref = np.mean(np.stack(f16), axis=0)
    assert ours.dtype == np.float16
    np.testing.assert_array_equal(ours, ref)


def test_store_open_failure_keeps_shared_topology():
    """A rank whose own store failed to open publishes "" and loses only
    its shm TRANSPORT — its topology (and therefore its schedule and tag
    space) must still come from the shared KV-rendezvoused stores list, or
    it would run the flat ring against peers running the hierarchy."""
    from ray_tpu_torch.parallel.collectives import _DistributedGroup, _MemberService

    stores = ["s", "s", "s", None]  # rank 3's open failed -> published ""
    svc_ok = _MemberService()
    svc_ok.shm = object()
    g_ok = _DistributedGroup(4, 0, ["a"] * 4, svc_ok, None,
                             stores=list(stores), hierarchy=True)
    g_bad = _DistributedGroup(4, 3, ["a"] * 4, _MemberService(), None,
                              stores=list(stores), hierarchy=True)
    assert g_ok._topo.nodes == g_bad._topo.nodes == [[0, 1, 2], [3]]
    assert g_ok._use_hier() and g_bad._use_hier()
    assert g_bad._shm is None  # transport gated, schedule shared
    # Segmentation policy agrees pairwise: rank 3's hops cross stores from
    # BOTH ends' perspective.
    assert g_ok._chunk_segments(3, 10, 8) == g_bad._chunk_segments(0, 10, 8)


def test_local_backend_reduce_ops_in_process(ray_start_regular):
    """The hub ``exchange`` path reduces through the same in-place kernels."""
    import threading

    from ray_tpu_torch.parallel import collectives as col

    world = 3
    results = {}

    def member(rank):
        col.init_collective_group(world, rank, backend="local",
                                  group_name="ipk")
        results[rank] = {
            op: col.allreduce(_rank_input(rank, 32), op=op, group_name="ipk")
            for op in OPS}

    threads = [threading.Thread(target=member, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for op in OPS:
        exp = _expected(op, world, 32)
        for rank in range(world):
            np.testing.assert_allclose(results[rank][op], exp)
    col.destroy_collective_group("ipk")


# ====================== two-level schedule ======================


def test_hier_2x2_allreduce_matches_flat_and_oracle():
    """2 nodes × 2 ranks: the hierarchical schedule must (a) produce
    allclose results to the flat ring for all five ops, (b) actually take
    the two-level path, and (c) move fewer cross-store (DCN-analog) bytes
    than the topology-blind ring."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 4})
    try:
        core = connect(cluster.gcs_address)
        try:
            members = _spawn(cluster, 4)
            stores = _require_stores(members, expect_distinct=2)
            assert stores[0] == stores[1] and stores[2] == stores[3]
            ray_tpu_torch.get([m.join.remote("hg", hier=True) for m in members],
                        timeout=180)
            ray_tpu_torch.get([m.join.remote("fg", hier=False) for m in members],
                        timeout=180)
            n = 8192
            for op in OPS:
                h = ray_tpu_torch.get(
                    [m.allreduce.remote("hg", op, n) for m in members],
                    timeout=180)
                f = ray_tpu_torch.get(
                    [m.allreduce.remote("fg", op, n) for m in members],
                    timeout=180)
                exp = _expected(op, 4, n)
                for rank in range(4):
                    np.testing.assert_allclose(h[rank], exp, rtol=1e-10)
                    np.testing.assert_allclose(f[rank], h[rank], rtol=1e-10)
            hs = ray_tpu_torch.get([m.stats.remote("hg") for m in members],
                             timeout=60)
            fs = ray_tpu_torch.get([m.stats.remote("fg") for m in members],
                             timeout=60)
            assert sum(s["hier_rounds"] for s in hs) == 4 * len(OPS)
            assert sum(s["hier_rounds"] for s in fs) == 0
            assert sum(s["flat_rounds"] for s in fs) == 4 * len(OPS)
            hier_cross = sum(s["bytes_cross_store"] for s in hs)
            flat_cross = sum(s["bytes_cross_store"] for s in fs)
            assert 0 < hier_cross < flat_cross, (hier_cross, flat_cross)
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_hier_2x2_full_surface():
    """Broadcast from a NON-LEADER root, allgather, reducescatter (mean),
    alltoall, barrier, scalar allreduce and p2p — all on one hierarchical
    2×2 group, back to back (tag isolation between schedules)."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            members = _spawn(cluster, 4)
            _require_stores(members, expect_distinct=2)
            ray_tpu_torch.get([m.join.remote("sf", hier=True) for m in members],
                        timeout=180)
            results = ray_tpu_torch.get([m.surface.remote("sf") for m in members],
                                  timeout=180)
            world = 4
            expect_rs = np.mean(
                np.stack([np.arange(8.0) + r for r in range(world)]), axis=0)
            for rank, out in enumerate(results):
                np.testing.assert_allclose(out["bcast"], [9.0, 9.5])
                for r in range(world):
                    np.testing.assert_allclose(out["gather"][r],
                                               np.arange(4.0) * (r + 1))
                np.testing.assert_allclose(
                    out["rs"], np.array_split(expect_rs, world)[rank])
                expect_a2a = np.concatenate(
                    [np.array_split(np.arange(8.0) * (s + 1), world)[rank]
                     for s in range(world)])
                np.testing.assert_allclose(out["a2a"], expect_a2a)
                assert out["scalar"] == sum(range(1, world + 1))
                np.testing.assert_allclose(
                    out["fcontig"],
                    np.arange(12.0).reshape(3, 4).T
                    * sum(range(1, world + 1)))
            assert results[world - 1]["p2p"] == 7.5
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_segmented_ring_uneven_sizes():
    """Segment-pipelined ring correctness for sizes that divide evenly by
    neither the segment size nor the world size — including chunks smaller
    than one segment and EMPTY ring chunks (n < world) — on both the flat
    4-ring and the hierarchical 2-leader ring (tiny 4 KiB segments force
    many-segment pipelines)."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 4})
    try:
        core = connect(cluster.gcs_address)
        try:
            members = _spawn(cluster, 4)
            _require_stores(members, expect_distinct=2)
            ray_tpu_torch.get(
                [m.join.remote("sh", hier=True, segment=4096)
                 for m in members], timeout=180)
            ray_tpu_torch.get(
                [m.join.remote("sfl", hier=False, segment=4096)
                 for m in members], timeout=180)
            for group in ("sh", "sfl"):
                for n in (1, 3, 1003, 100003):
                    for op in ("sum", "mean"):
                        got = ray_tpu_torch.get(
                            [m.allreduce.remote(group, op, n)
                             for m in members], timeout=180)
                        exp = _expected(op, 4, n)
                        for rank in range(4):
                            np.testing.assert_allclose(got[rank], exp,
                                                       rtol=1e-10)
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_leader_failure_surfaces_clean_error_on_all_ranks():
    """Kill the node-0 leader mid-group: every surviving rank's allreduce
    must raise within ~collective_timeout_s (set to 4s through the new
    knob), not hang for the old hardcoded 120s."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            members = _spawn(cluster, 4)
            _require_stores(members, expect_distinct=2)
            ray_tpu_torch.get([m.join.remote("lf", hier=True, timeout=4.0)
                         for m in members], timeout=180)
            # Warm round proves the group works before the failure.
            warm = ray_tpu_torch.get(
                [m.allreduce.remote("lf", "sum", 1024) for m in members],
                timeout=180)
            np.testing.assert_allclose(warm[0], _expected("sum", 4, 1024))
            try:
                ray_tpu_torch.get(members[0].die.remote(), timeout=60)
            except Exception:  # noqa: BLE001 — worker death IS the point
                pass
            t0 = time.monotonic()
            errs = ray_tpu_torch.get(
                [m.allreduce_guarded.remote("lf", "sum", 200_000)
                 for m in members[1:]], timeout=120)
            elapsed = time.monotonic() - t0
            assert all(e != "ok" for e in errs), errs
            # Fail-fast contract of collective_timeout_s: nowhere near the
            # old 120s default.
            assert elapsed < 60, elapsed
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_asymmetric_nodes_two_plus_one():
    """Mixed-store group with UNEQUAL node sizes (2 ranks on node 0, a solo
    leader on node 1): the solo leader has no intra-node phase but still
    runs the leaders ring; results match the oracle for every op, and
    broadcast works from a rank on the multi-rank node."""
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            Member = _member_cls()
            nodes = cluster.nodes
            placement = [0, 0, 1]  # ranks 0,1 -> node 0; rank 2 solo
            members = [Member.options(
                num_cpus=1,
                scheduling_strategy=ray_tpu_torch.NodeAffinitySchedulingStrategy(
                    node_id=nodes[placement[r]].node_id)).remote(r, 3)
                for r in range(3)]
            _require_stores(members, expect_distinct=2)
            ray_tpu_torch.get([m.join.remote("asym", hier=True) for m in members],
                        timeout=180)
            for op in OPS:
                got = ray_tpu_torch.get(
                    [m.allreduce.remote("asym", op, 777) for m in members],
                    timeout=180)
                exp = _expected(op, 3, 777)
                for rank in range(3):
                    np.testing.assert_allclose(got[rank], exp, rtol=1e-10)
            results = ray_tpu_torch.get([m.surface.remote("asym") for m in members],
                                  timeout=180)
            for out in results:
                np.testing.assert_allclose(out["bcast"], [9.0, 9.5])
                # Solo leader + F-contiguous input: its astype'd accumulator
                # feeds the leaders ring through a reshape(-1) VIEW.
                np.testing.assert_allclose(
                    out["fcontig"], np.arange(12.0).reshape(3, 4).T * 6)
            assert results[2]["p2p"] == 7.5
            stats = ray_tpu_torch.get([m.stats.remote("asym") for m in members],
                                timeout=60)
            assert sum(s["hier_rounds"] for s in stats) > 0
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


@pytest.mark.slow
def test_four_solo_nodes_degenerate_to_flat():
    """4 nodes × 1 rank: hierarchy enabled but every node is a singleton —
    the schedule must degenerate to the flat segmented ring (no two-level
    rounds) and still be correct."""
    cluster = Cluster(num_nodes=4, resources_per_node={"CPU": 1})
    try:
        core = connect(cluster.gcs_address)
        try:
            members = _spawn(cluster, 4)
            _require_stores(members, expect_distinct=4)
            ray_tpu_torch.get([m.join.remote("solo", hier=True) for m in members],
                        timeout=180)
            got = ray_tpu_torch.get(
                [m.allreduce.remote("solo", "sum", 5000) for m in members],
                timeout=180)
            exp = _expected("sum", 4, 5000)
            for rank in range(4):
                np.testing.assert_allclose(got[rank], exp, rtol=1e-10)
            stats = ray_tpu_torch.get([m.stats.remote("solo") for m in members],
                                timeout=60)
            assert sum(s["hier_rounds"] for s in stats) == 0
            assert sum(s["flat_rounds"] for s in stats) == 4
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()
