"""JAX's eager-collectives tests of ``tests/test_parallel.py`` on the port,
and the port's reductions held to the JAX package's on the same inputs.

The ``local`` backend from real actors of the in-process runtime, p2p,
back-to-back rounds, the broadcast tree's ack accounting, and
``backend="device"`` — here with co-located CPU tensors, the device the
ranks' tensors share (ranks on distinct CUDA devices raise: the port runs
on one card). Then every reduce op and dtype through JAX's
``_reduce_inplace`` and the port's, exact for f32, f64 and integers; bf16
within world × 2^-8 relative of JAX's (the port carries bf16 as 16-bit
words, accumulates in f32 and rounds once; JAX rounds per add).
"""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.parallel import collectives as jcol
from ray_tpu_torch.parallel import collectives as col

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

OPS = ("sum", "prod", "min", "max", "mean")


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _run_ranks(world, fn, timeout=120):
    """``fn(rank)`` on one daemon thread per rank; returns {rank: result}
    and fails on a hung rank or any rank's error."""
    results, errors = {}, []

    def member(rank):
        try:
            results[rank] = fn(rank)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((rank, e))

    threads = [threading.Thread(target=member, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    # daemon=True: a wedged member must FAIL here, not hang interpreter
    # exit at threading._shutdown.
    assert not any(t.is_alive() for t in threads), "member thread hung"
    return results, errors


# ====================== JAX's tests ======================


def test_collectives_between_actors(ray_start_regular):
    """The eager collective contract, exercised from real actors."""
    rt = ray_start_regular
    world = 4

    @rt.remote(max_concurrency=1)
    class Rank:
        def __init__(self, rank):
            self.rank = rank
            col.init_collective_group(world, rank, backend="local",
                                      group_name="g1")

        def do_allreduce(self):
            return col.allreduce(np.full(4, self.rank + 1.0), op="sum",
                                 group_name="g1")

        def do_broadcast(self):
            return col.broadcast(np.arange(3.0) if self.rank == 0 else None,
                                 0, "g1")

        def do_allgather(self):
            return col.allgather(np.full(2, float(self.rank)), "g1")

        def do_reducescatter(self):
            return col.reducescatter(np.arange(8.0), op="sum",
                                     group_name="g1")

        def do_alltoall(self):
            return col.alltoall(np.full(4, float(self.rank)), "g1")

    ranks = [Rank.remote(i) for i in range(world)]
    out = rt.get([r.do_allreduce.remote() for r in ranks], timeout=60)
    for o in out:
        np.testing.assert_array_equal(o, np.full(4, 1.0 + 2 + 3 + 4))
    out = rt.get([r.do_broadcast.remote() for r in ranks], timeout=60)
    for o in out:
        np.testing.assert_array_equal(o, np.arange(3.0))
    out = rt.get([r.do_allgather.remote() for r in ranks], timeout=60)
    for o in out:
        assert len(o) == world
        np.testing.assert_array_equal(o[2], np.full(2, 2.0))
    out = rt.get([r.do_reducescatter.remote() for r in ranks], timeout=60)
    np.testing.assert_array_equal(out[1],
                                  np.array([2.0 * world * 1, 3.0 * world]))
    out = rt.get([r.do_alltoall.remote() for r in ranks], timeout=60)
    np.testing.assert_array_equal(out[3], np.array([0.0, 1.0, 2.0, 3.0]))
    col.destroy_collective_group("g1")


def test_collectives_send_recv(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class Peer:
        def __init__(self, rank):
            col.init_collective_group(2, rank, group_name="p2p")
            self.rank = rank

        def send_it(self):
            col.send(np.array([7.0, 8.0]), dst_rank=1, group_name="p2p")
            return True

        def recv_it(self):
            return col.recv(src_rank=0, group_name="p2p", timeout=10)

    a, b = Peer.remote(0), Peer.remote(1)
    r = b.recv_it.remote()
    rt.get(a.send_it.remote(), timeout=30)
    np.testing.assert_array_equal(rt.get(r, timeout=30),
                                  np.array([7.0, 8.0]))
    col.destroy_collective_group("p2p")


class TestCollectiveRoundStress:
    def test_back_to_back_allreduce_rounds(self, ray_start_regular):
        """Regression: a fast rank re-entering round k+1 while a straggler
        withdraws from round k must not corrupt slots (mixed-epoch race)."""

        @ray_tpu_torch.remote
        class Member:
            def __init__(self, rank, world):
                col.init_collective_group(world, rank, group_name="stress")
                self.rank = rank

            def run_rounds(self, n):
                out = []
                for i in range(n):
                    # different shape per round: mixing rounds would blow up
                    shape = (2 + i % 3, 4)
                    val = np.full(shape, float(self.rank + 1))
                    out.append(float(col.allreduce(
                        val, group_name="stress").sum()))
                return out

        world = 3
        members = [Member.remote(r, world) for r in range(world)]
        results = ray_tpu_torch.get(
            [m.run_rounds.remote(40) for m in members], timeout=120)
        assert results[0] == results[1] == results[2]
        # sum of (1+2+3) over each round's element count
        expected = [6.0 * ((2 + i % 3) * 4) for i in range(40)]
        assert results[0] == expected
        col.destroy_collective_group("stress")


def test_device_backend_allreduce_stays_on_device():
    """backend="device": each rank's torch tensor is reduced on the device
    the ranks' tensors share, and each rank's result stays a tensor on
    that device (here the CPU, the one device this host has)."""
    world = 4

    def member(rank):
        col.init_collective_group(world, rank, backend="device",
                                  group_name="dev-g")
        x = torch.full((8,), float(rank + 1))
        return col.allreduce(x, op="sum", group_name="dev-g")

    results, errors = _run_ranks(world, member)
    assert not errors, errors
    expect = float(sum(range(1, world + 1)))  # 1+2+3+4
    for rank in range(world):
        out = results[rank]
        assert isinstance(out, torch.Tensor)
        assert out.device == torch.device("cpu")
        assert torch.equal(out, torch.full((8,), expect))
    col.destroy_collective_group("dev-g")


def test_device_backend_mean_and_colocated_fallback():
    world = 2

    def member(rank):
        col.init_collective_group(world, rank, backend="device",
                                  group_name="dev-co")
        x = torch.full((4,), float(rank))
        return col.allreduce(x, op="mean", group_name="dev-co")

    results, errors = _run_ranks(world, member)
    assert not errors, errors
    for rank in range(world):
        assert torch.equal(results[rank], torch.full((4,), 0.5))
    col.destroy_collective_group("dev-co")


def test_device_backend_from_actors(ray_start_regular):
    """backend="device" through REAL actors (in-process runtime: actors
    share the process and their tensors share its device)."""
    rt = ray_start_regular
    world = 4

    @rt.remote(max_concurrency=1)
    class DeviceRank:
        def __init__(self, rank):
            self.rank = rank
            col.init_collective_group(world, rank, backend="device",
                                      group_name="adev")

        def reduce(self):
            x = torch.full((16,), float(self.rank + 1))
            out = col.allreduce(x, op="sum", group_name="adev")
            return out, out.device == x.device

    ranks = [DeviceRank.remote(i) for i in range(world)]
    results = rt.get([r.reduce.remote() for r in ranks], timeout=300)
    expect = torch.full((16,), float(sum(range(1, world + 1))))
    for out, on_own_device in results:
        assert torch.equal(out, expect)
        assert on_own_device
    col.destroy_collective_group("adev")


class TestBroadcastSubtreeAcks:
    """_broadcast republisher ack accounting: a non-root rank that
    publishes the payload to shm must expect acks from its binomial
    SUBTREE only — publishing with consumers=n-1 would leave shm_done
    forever short of zero and leak the backing object."""

    def test_subtree_consumer_counts(self):
        f = col._DistributedGroup._bc_subtree_consumers

        def children(rel, n):
            out, k = [], 1
            while k < n:  # mirrors _broadcast's child enumeration
                if rel < k and rel + k < n:
                    out.append(rel + k)
                k *= 2
            return out

        for n in range(1, 33):
            # Root's subtree covers the whole tree: n-1 descendants.
            assert f(0, n) == n - 1
            for r in range(n):
                # Recursive consistency: my acks = each child's delivery
                # plus everything that child forwards.
                assert f(r, n) == sum(1 + f(c, n) for c in children(r, n))
        # Spot checks in the n=8 binomial tree: 1 -> {3, 5}, 3 -> {7}.
        assert f(1, 8) == 3
        assert f(2, 8) == 1  # 2 -> {6}
        assert f(4, 8) == 0  # leaf

    def test_republisher_publishes_with_subtree_count(self):
        """Rank 1 of 4 (src=0) receives by socket (root's publish failed),
        republishes to shm for its children: consumers must equal its
        subtree size (1 = rank 3), not n-1 = 3."""
        DG = col._DistributedGroup
        g = object.__new__(DG)
        g.world_size = 4
        g.rank = 1
        g._addrs = {i: f"addr{i}" for i in range(4)}
        g._stores = {i: "storeA" for i in range(4)}
        g._all_same_store = True
        g._shm = object()  # only truthiness is checked on this path

        published = {}

        def publish(arr, consumers):
            published["consumers"] = consumers
            return b"k" * 16

        g._publish_shm = publish

        class _Fut:
            def result(self, timeout=None):
                return True

        sent = []

        class _Peer:
            def call_async(self, method, *args):
                sent.append((method, args))
                return _Fut()

        class _Peers:
            def get(self, addr):
                return _Peer()

        g._peers = _Peers()
        payload = np.ones(DG.SHM_MIN_BYTES // 8 + 16, dtype=np.float64)
        g._service = None  # not used on this path
        g._recv = lambda tag, timeout=120.0: payload  # socket delivery
        out = g._broadcast(seq=9, value=None, src=0)
        assert np.array_equal(out, payload)
        assert published["consumers"] == DG._bc_subtree_consumers(1, 4) == 1
        # The forward to the child went by shm key.
        assert sent and sent[0][0] == "deliver_shm"


# ====================== the port's rules ======================


def test_device_backend_distinct_cuda_devices_raise(monkeypatch):
    """Ranks whose tensors sit on distinct CUDA devices: every rank raises
    NotImplementedError naming the one-card record (here the devices are
    reported, not real: this host has no card), and the group stays
    usable for a round on one device afterwards."""
    world = 2
    monkeypatch.setattr(col, "_tensor_device",
                        lambda t: torch.device("cuda", int(t[0].item())))

    def member(rank):
        col.init_collective_group(world, rank, backend="device",
                                  group_name="dev-x")
        try:
            col.allreduce(torch.full((4,), float(rank)), group_name="dev-x")
        except NotImplementedError as e:
            return str(e)
        return "reduced"

    results, errors = _run_ranks(world, member, timeout=30)
    assert not errors, errors
    for msg in results.values():
        assert "one card" in msg and "cuda:0" in msg and "cuda:1" in msg
    monkeypatch.setattr(col, "_tensor_device", lambda t: t.device)

    def again(rank):
        col.init_collective_group(world, rank, backend="device",
                                  group_name="dev-x")
        return col.allreduce(torch.full((4,), 1.0), group_name="dev-x")

    results, errors = _run_ranks(world, again, timeout=30)
    assert not errors and all(torch.equal(o, torch.full((4,), 2.0))
                              for o in results.values())
    col.destroy_collective_group("dev-x")


def test_xla_backend_names_the_mesh():
    with pytest.raises(RuntimeError, match="ray_tpu_torch/parallel/mesh.py"):
        col.init_collective_group(2, 0, backend="xla", group_name="x")


def test_bf16_tensors_through_the_local_backend():
    """A bf16 torch tensor crosses the host backend as its 16-bit words and
    comes back a bf16 tensor: the sum rounds once from f32; broadcast,
    allgather, alltoall and p2p move the words bit for bit."""
    world = 3
    xs = [torch.tensor([1.0, 2.0 ** -9, -3.5, 1e30], dtype=torch.bfloat16)
          * (r + 1) for r in range(world)]

    def member(rank):
        col.init_collective_group(world, rank, group_name="bf")
        out = {"sum": col.allreduce(xs[rank], group_name="bf"),
               "bcast": col.broadcast(xs[rank], 2, "bf"),
               "gather": col.allgather(xs[rank], "bf"),
               "a2a": col.alltoall(torch.arange(6, dtype=torch.bfloat16)
                                   + rank, "bf")}
        if rank == 0:
            col.send(xs[0], 1, "bf")
        if rank == 1:
            out["p2p"] = col.recv(0, "bf", timeout=30)
        return out

    results, errors = _run_ranks(world, member)
    assert not errors, errors
    want = torch.stack([x.float() for x in xs]).sum(0).to(torch.bfloat16)
    for rank, out in results.items():
        assert out["sum"].dtype == torch.bfloat16
        assert torch.equal(out["sum"], want)
        assert torch.equal(out["bcast"], xs[2])
        assert all(torch.equal(g, x) for g, x in zip(out["gather"], xs))
        # Rank r gets chunk r (2 elements) of every sender s's arange+s.
        assert torch.equal(out["a2a"], torch.tensor(
            [2 * rank + j + s for s in range(world) for j in range(2)],
            dtype=torch.bfloat16))
    assert torch.equal(results[1]["p2p"], xs[0])
    col.destroy_collective_group("bf")


def test_bf16_words_round_like_torch():
    """The host rounding (f32 → bf16 words) is torch's, NaN and infinities
    included, and widening is exact."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 1e3,
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38, 1e-40,
                  1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -9], np.float32)])
    ours = torch.from_numpy(col._f32_to_bf16(x).view(np.int16)).view(
        torch.bfloat16)
    theirs = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(ours.view(torch.int16)[~torch.isnan(theirs)],
                       theirs.view(torch.int16)[~torch.isnan(theirs)])
    assert torch.isnan(ours).eq(torch.isnan(theirs)).all()
    back = col._bf16_to_f32(col._to_numpy(theirs))
    assert np.array_equal(back, theirs.float().numpy(), equal_nan=True)


# ====================== against the JAX package ======================


def _inputs(dtype, world=4, n=257, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        return [rng.integers(1, 5, n).astype(dtype) for _ in range(world)]
    return [(1.0 + rng.standard_normal(n) * 0.05).astype(dtype)
            for _ in range(world)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.int8, np.uint8])
@pytest.mark.parametrize("op", OPS)
def test_reduce_kernels_match_jax_exactly(op, dtype):
    arrs = _inputs(dtype)
    keep = [a.copy() for a in arrs]
    ours = col._reduce_inplace(op, arrs)
    theirs = jcol._reduce_inplace(op, arrs)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)
    for a, k in zip(arrs, keep):  # inputs never mutated
        np.testing.assert_array_equal(a, k)


@pytest.mark.parametrize("op", OPS)
def test_bf16_reduce_within_world_steps_of_jax(op):
    """JAX reduces ml_dtypes bf16 arrays with numpy ufuncs, rounding per
    add (its mean accumulates in f64); the port widens the same bf16 words
    to f32 and rounds once: the two agree within world × 2^-8 relative."""
    world = 4
    f32 = _inputs(np.float32, world)
    jax_in = [a.astype(ml_dtypes.bfloat16) for a in f32]
    port_in = [col._to_numpy(torch.from_numpy(a).to(torch.bfloat16))
               for a in f32]
    for j, p in zip(jax_in, port_in):  # the same bf16 inputs
        assert np.array_equal(j.view(np.uint16), p.view(np.uint16))
    theirs = jcol._reduce_inplace(op, jax_in).astype(np.float64)
    ours = col._from_host(col._reduce_inplace(op, port_in))
    assert ours.dtype == torch.bfloat16
    ours = ours.double().numpy()
    np.testing.assert_allclose(ours, theirs, rtol=world * 2.0 ** -8,
                               atol=0)
    # The port's own reference: the f32 reduction rounded once.
    exact = {"sum": np.sum, "prod": np.prod, "min": np.min,
             "max": np.max, "mean": np.mean}[op](
        np.stack([col._bf16_to_f32(p) for p in port_in]), axis=0)
    want = torch.from_numpy(exact.astype(np.float32)).to(torch.bfloat16)
    assert np.array_equal(ours, want.double().numpy())


@pytest.mark.parametrize("op", OPS)
def test_local_backend_matches_jax(op):
    """The ``local`` backend of each package on the same seeded inputs,
    f64 and int32: equal results."""
    world = 3

    for dtype in (np.float64, np.int32):
        arrs = _inputs(dtype, world, n=64, seed=3)

        def port(rank, arrs=arrs):
            col.init_collective_group(world, rank, group_name=f"x-{op}")
            return col.allreduce(arrs[rank], op=op, group_name=f"x-{op}")

        def jax(rank, arrs=arrs):
            jcol.init_collective_group(world, rank, group_name=f"x-{op}")
            return jcol.allreduce(arrs[rank], op=op, group_name=f"x-{op}")

        ours, e1 = _run_ranks(world, port)
        theirs, e2 = _run_ranks(world, jax)
        assert not e1 and not e2, (e1, e2)
        for r in range(world):
            assert ours[r].dtype == theirs[r].dtype
            np.testing.assert_array_equal(ours[r], theirs[r])
        col.destroy_collective_group(f"x-{op}")
        jcol.destroy_collective_group(f"x-{op}")
