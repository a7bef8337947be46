"""JAX's compiled-DAG tests (``tests/test_dag.py``) on the port, in process.

Channels (the shm ring, sockets, device channels), the compiled DAG on the
in-process runtime (chains, fan-out/fan-in, multi-output, constants, error
passthrough, burst pipelining, teardown under load, partial gathers and
rolled-back input writes, the tick histogram and spans), each as JAX's
test runs it, on ``ray_tpu_torch``. The tests that start a multi-process
``Cluster`` are in ``test_torch_dag_cluster.py``.

Where the port differs by design the test says so: a ``DeviceChannel``
carries torch tensors (bf16 too) and lands them on the device it was
given — ``"cpu"`` here, where there is no card; with no card and no device
given it raises instead of landing on the CPU.
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.dag import (Channel, ChannelClosed, ChannelTimeout,
                               InputNode, MultiOutputNode)


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


class TestChannel:
    def test_write_read_roundtrip(self):
        ch = Channel(capacity=1 << 16)
        try:
            ch.write({"x": 1, "y": [1, 2, 3]})
            assert ch.read(timeout=5) == {"x": 1, "y": [1, 2, 3]}
        finally:
            ch.destroy()

    def test_backpressure_blocks_second_write(self):
        # slots=1 restores the strict capacity-1 lock-step channel.
        ch = Channel(capacity=1 << 16, slots=1)
        try:
            ch.write(1)
            with pytest.raises(ChannelTimeout):
                ch.write(2, timeout=0.2)
            assert ch.read(timeout=5) == 1
            ch.write(2)  # now the slot is free
            assert ch.read(timeout=5) == 2
        finally:
            ch.destroy()

    def test_ring_pipelines_n_writes_then_backpressures(self):
        ch = Channel(capacity=1 << 16, slots=4)
        try:
            for i in range(4):  # the whole ring fills without a reader
                ch.write(i, timeout=5)
            with pytest.raises(ChannelTimeout):
                ch.write(99, timeout=0.2)  # slot 0 still unacked
            assert ch.read(timeout=5) == 0  # one ack frees one slot
            ch.write(4, timeout=5)
            assert [ch.read(timeout=5) for _ in range(4)] == [1, 2, 3, 4]
        finally:
            ch.destroy()

    def test_ring_fifo_across_wraparound(self):
        ch = Channel(capacity=1 << 16, slots=3)
        try:
            out = []
            for i in range(11):  # > 3 full ring revolutions
                ch.write(i, timeout=5)
                out.append(ch.read(timeout=5))
            assert out == list(range(11))
        finally:
            ch.destroy()

    def test_cross_attach_by_name(self):
        ch = Channel(capacity=1 << 16)
        try:
            reader = Channel(ch.name, capacity=1 << 16, create=False)
            ch.write("hello")
            assert reader.read(timeout=5) == "hello"
        finally:
            ch.destroy()


class TestCompiledDAG:
    def test_two_stage_chain_matches_plain_calls(self, ray_start_regular):
        @ray_tpu_torch.remote
        class Doubler:
            def apply(self, x):
                return x * 2

        @ray_tpu_torch.remote
        class AddTen:
            def apply(self, x):
                return x + 10

        a, b = Doubler.remote(), AddTen.remote()
        dag = b.apply.bind(a.apply.bind(InputNode()))
        compiled = dag.experimental_compile()
        try:
            for i in range(20):
                assert compiled.execute(i).get(timeout=30) == i * 2 + 10
        finally:
            compiled.teardown()

    def test_pipelined_executes(self, ray_start_regular):
        """Multiple in-flight executes drain FIFO."""

        @ray_tpu_torch.remote
        class Sq:
            def apply(self, x):
                return x * x

        s = Sq.remote()
        compiled = s.apply.bind(InputNode()).experimental_compile()
        try:
            refs = [compiled.execute(i) for i in range(3)]
            assert [r.get(timeout=30) for r in refs] == [0, 1, 4]
        finally:
            compiled.teardown()

    def test_stage_error_propagates(self, ray_start_regular):
        @ray_tpu_torch.remote
        class Fragile:
            def apply(self, x):
                if x == 13:
                    raise ValueError("unlucky")
                return x

        f = Fragile.remote()
        compiled = f.apply.bind(InputNode()).experimental_compile()
        try:
            assert compiled.execute(1).get(timeout=30) == 1
            with pytest.raises(RuntimeError, match="unlucky"):
                compiled.execute(13).get(timeout=30)
            # The loop survives the error.
            assert compiled.execute(2).get(timeout=30) == 2
        finally:
            compiled.teardown()

class TestFanOutFanIn:
    """Graph shapes beyond linear chains (reference: multi-arg bind +
    MultiOutputNode in python/ray/dag)."""

    def test_diamond_matches_plain_calls(self, ray_start_regular):
        """input → pre → (left, right) → merge: per-edge channels, fan-out
        broadcast, fan-in gather — result identical to the task path."""

        @ray_tpu_torch.remote
        class Pre:
            def apply(self, x):
                return x + 1

        @ray_tpu_torch.remote
        class Left:
            def apply(self, x):
                return x * 2

        @ray_tpu_torch.remote
        class Right:
            def apply(self, x):
                return x * 3

        @ray_tpu_torch.remote
        class Merge:
            def apply(self, a, b):
                return (a, b)

        pre, lt, rt, mg = Pre.remote(), Left.remote(), Right.remote(), Merge.remote()
        with InputNode() as inp:
            p = pre.apply.bind(inp)
            dag = mg.apply.bind(lt.apply.bind(p), rt.apply.bind(p))
        compiled = dag.experimental_compile()
        try:
            for i in range(10):
                assert compiled.execute(i).get(timeout=30) == \
                    ((i + 1) * 2, (i + 1) * 3)
        finally:
            compiled.teardown()

    def test_multi_output_node_yields_tuples(self, ray_start_regular):
        @ray_tpu_torch.remote
        class Double:
            def apply(self, x):
                return x * 2

        @ray_tpu_torch.remote
        class Square:
            def apply(self, x):
                return x * x

        d, s = Double.remote(), Square.remote()
        with InputNode() as inp:
            dag = MultiOutputNode([d.apply.bind(inp), s.apply.bind(inp)])
        compiled = dag.experimental_compile()
        try:
            refs = [compiled.execute(i) for i in range(6)]
            assert [r.get(timeout=30) for r in refs] == \
                [(i * 2, i * i) for i in range(6)]
        finally:
            compiled.teardown()

    def test_constant_bind_args(self, ray_start_regular):
        @ray_tpu_torch.remote
        class AffineOp:
            def apply(self, x, scale, offset):
                return x * scale + offset

        a = AffineOp.remote()
        compiled = a.apply.bind(InputNode(), 10, 7).experimental_compile()
        try:
            assert compiled.execute(3).get(timeout=30) == 37
        finally:
            compiled.teardown()

    def test_fan_in_error_passes_through_merge(self, ray_start_regular):
        """An upstream failure forwards through downstream stages so the
        driver sees the ORIGINATING stage's error, and the DAG survives."""

        @ray_tpu_torch.remote
        class Fragile:
            def apply(self, x):
                if x == 13:
                    raise ValueError("unlucky-upstream")
                return x

        @ray_tpu_torch.remote
        class Stable:
            def apply(self, x):
                return x

        @ray_tpu_torch.remote
        class Merge:
            def apply(self, a, b):
                return a + b

        f, s, m = Fragile.remote(), Stable.remote(), Merge.remote()
        with InputNode() as inp:
            dag = m.apply.bind(f.apply.bind(inp), s.apply.bind(inp))
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(1).get(timeout=30) == 2
            with pytest.raises(RuntimeError, match="unlucky-upstream"):
                compiled.execute(13).get(timeout=30)
            assert compiled.execute(2).get(timeout=30) == 4
        finally:
            compiled.teardown()


class TestBurstPipelining:
    def test_burst_fifo_and_index_mapping(self, ray_start_regular):
        """>1 tick in flight per edge: a burst submitted before any fetch
        drains FIFO, and DAGRef index→result mapping holds under
        out-of-order gets."""

        @ray_tpu_torch.remote
        class Sq:
            def apply(self, x):
                return x * x

        s = Sq.remote()
        compiled = s.apply.bind(InputNode()).experimental_compile(
            channel_slots=4)
        try:
            # 8 in flight = the full pipeline capacity at slots=4 (input
            # ring + output ring); a capacity-1 design would deadlock here
            # because execute() #2 already needs the driver to fetch.
            refs = [compiled.execute(i) for i in range(8)]
            # Fetch out of order: late index first forces the FIFO drain
            # to buffer earlier results; each ref must still map to ITS
            # tick.
            assert refs[7].get(timeout=30) == 49
            assert refs[0].get(timeout=30) == 0
            assert [refs[i].get(timeout=30) for i in (6, 3, 5)] == \
                [36, 9, 25]
            assert [r.get(timeout=30) for r in refs] == \
                [i * i for i in range(8)]
        finally:
            compiled.teardown()

    def test_teardown_under_load(self, ray_start_regular):
        """Teardown with unfetched in-flight ticks: the drain must let the
        stage loops exit on the pill (no mid-read unlink), leaving the
        loop refs completed."""

        @ray_tpu_torch.remote
        class Slowish:
            def apply(self, x):
                time.sleep(0.005)
                return x

        s = Slowish.remote()
        compiled = s.apply.bind(InputNode()).experimental_compile(
            channel_slots=4)
        refs = [compiled.execute(i) for i in range(4)]
        assert refs[0].get(timeout=30) == 0
        compiled.teardown()  # 3 ticks never fetched
        # The resident loops saw the pill and exited cleanly.
        assert ray_tpu_torch.get(compiled._loop_refs, timeout=30) == ["closed"]
        with pytest.raises(RuntimeError, match="torn down"):
            compiled.execute(99)

    def test_partial_multi_output_gather_survives_timeout(
            self, ray_start_regular):
        """A get() that times out after consuming SOME leaves of a
        MultiOutputNode tick must not lose them: the retry resumes at the
        first unread leaf and every later tick's tuple stays aligned."""

        @ray_tpu_torch.remote
        class Fast:
            def apply(self, x):
                return ("fast", x)

        @ray_tpu_torch.remote
        class Slow:
            def apply(self, x):
                time.sleep(0.4)
                return ("slow", x)

        f, s = Fast.remote(), Slow.remote()
        with InputNode() as inp:
            dag = MultiOutputNode([f.apply.bind(inp), s.apply.bind(inp)])
        compiled = dag.experimental_compile()
        try:
            ref0 = compiled.execute(0)
            # Fast's leaf is consumed, then Slow's read times out.
            with pytest.raises(ChannelTimeout):
                ref0.get(timeout=0.1)
            ref1 = compiled.execute(1)
            assert ref0.get(timeout=30) == (("fast", 0), ("slow", 0))
            assert ref1.get(timeout=30) == (("fast", 1), ("slow", 1))
        finally:
            compiled.teardown()

    def test_partial_input_write_rolls_back_on_timeout(
            self, ray_start_regular):
        """execute() hitting backpressure on ONE fan-out input edge must
        publish to NO edge: without the two-phase commit the fast sibling
        edge runs a tick ahead and every later merge mixes ticks."""

        @ray_tpu_torch.remote
        class Fast:
            def apply(self, x):
                return x

        @ray_tpu_torch.remote
        class Slow:
            def apply(self, x):
                time.sleep(0.25)
                return x

        @ray_tpu_torch.remote
        class Merge:
            def apply(self, a, b):
                assert a == b, (a, b)  # tick alignment invariant
                return a

        f, s, m = Fast.remote(), Slow.remote(), Merge.remote()
        with InputNode() as inp:
            # Fast bound FIRST: its input edge is written before Slow's,
            # which is the order that desyncs without rollback.
            dag = m.apply.bind(f.apply.bind(inp), s.apply.bind(inp))
        compiled = dag.experimental_compile(channel_slots=1)
        try:
            refs = [compiled.execute(i, timeout=10) for i in range(2)]
            # Slow is busy with tick 0, its 1-slot input ring holds tick 1
            # -> this execute must time out WITHOUT feeding Fast's edge.
            with pytest.raises(ChannelTimeout):
                compiled.execute(99, timeout=0.1)
            assert [r.get(timeout=30) for r in refs] == [0, 1]
            # Post-timeout ticks stay aligned (Merge asserts a == b).
            refs2 = [compiled.execute(i, timeout=30) for i in (5, 6)]
            assert [r.get(timeout=30) for r in refs2] == [5, 6]
        finally:
            compiled.teardown()

    def test_dag_tick_histogram_records(self, ray_start_regular):
        from ray_tpu_torch.core.metrics_export import dag_tick_hist

        @ray_tpu_torch.remote
        class Echo:
            def apply(self, x):
                return x

        e = Echo.remote()
        compiled = e.apply.bind(InputNode()).experimental_compile()
        try:
            before = sum(dag_tick_hist()._totals.values())
            for i in range(5):
                assert compiled.execute(i).get(timeout=30) == i
            after = sum(dag_tick_hist()._totals.values())
            assert after - before == 5
        finally:
            compiled.teardown()


class TestCompiledDAGValidation:
    def test_same_actor_twice_rejected(self, ray_start_regular):
        @ray_tpu_torch.remote
        class A:
            def f(self, x):
                return x

            def g(self, x):
                return x

        a = A.remote()
        dag = a.g.bind(a.f.bind(InputNode()))
        with pytest.raises(ValueError, match="DISTINCT actors"):
            dag.experimental_compile()

    def test_bytes_payload_round_trips(self, ray_start_regular):
        @ray_tpu_torch.remote
        class Rev:
            def apply(self, b):
                return b[::-1]

        r = Rev.remote()
        compiled = r.apply.bind(InputNode()).experimental_compile()
        try:
            assert compiled.execute(b"\x00abc\xff").get(timeout=30) == b"\xffcba\x00"
        finally:
            compiled.teardown()

    def test_async_actor_rejected_at_compile(self, ray_start_regular):
        @ray_tpu_torch.remote
        class Async:
            async def apply(self, x):
                return x

        a = Async.remote()
        with pytest.raises(TypeError, match="async actors"):
            a.apply.bind(InputNode()).experimental_compile()


class TestSocketChannels:
    """Cross-node DAG channels (reference: experimental/channel.py:51 —
    aDAG channels run cross-node; shm cannot)."""

    def test_socket_channel_roundtrip_and_backpressure(self, ray_start_regular):
        import threading

        from ray_tpu_torch.dag.channel import ChannelClosed, SocketChannel

        ch = SocketChannel()
        reader_out = []

        def consume():
            try:
                while True:
                    reader_out.append(ch_reader.read(timeout=30))
            except ChannelClosed:
                reader_out.append("closed")

        # distinct endpoint objects, attached by name (as pickling would)
        ch_reader = SocketChannel(ch.name, create=False)
        t = threading.Thread(target=consume)
        t.start()
        for i in range(5):
            ch.write({"i": i}, timeout=30)
        ch.close()
        t.join(timeout=30)
        assert reader_out == [{"i": 0}, {"i": 1}, {"i": 2}, {"i": 3},
                              {"i": 4}, "closed"]

    def test_windowed_acks_pipeline_writes(self, ray_start_regular):
        """Credit-based flow control: the writer runs a full window of
        frames ahead of the reader's acks (the capacity-1 design stalled
        on an ack round-trip per frame), then blocks on credit
        exhaustion."""
        import threading

        from ray_tpu_torch.dag.channel import SocketChannel

        ch = SocketChannel(window=4)
        ch_reader = SocketChannel(ch.name, create=False)
        started = threading.Event()

        def accept_only():
            # Bind the reader role (so the writer can connect) but DON'T
            # read yet — no acks flow.
            ch_reader._become_reader(timeout=30)
            started.set()

        t = threading.Thread(target=accept_only)
        t.start()
        try:
            # A full window of writes completes with ZERO acks on the wire.
            for i in range(4):
                ch.write({"i": i}, timeout=10)
            started.wait(10)
            # The 5th blocks on credit exhaustion...
            with pytest.raises(ChannelTimeout):
                ch.write({"i": 4}, timeout=0.3)
            # ...until the reader drains one frame (one ack = one credit).
            assert ch_reader.read(timeout=10) == {"i": 0}
            ch.write({"i": 4}, timeout=10)
            assert [ch_reader.read(timeout=10) for _ in range(4)] == \
                [{"i": i} for i in range(1, 5)]
        finally:
            t.join(timeout=10)
            ch.destroy()
            ch_reader.destroy()


class TestDeviceChannel:
    """The device tier: torch tensors cross as raw bytes and land on the
    channel's device (``"cpu"`` here); the deferred ack keeps a slot until
    its copy has landed."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.int64, torch.bool])
    def test_tensor_roundtrip_lands_on_device(self, dtype):
        from ray_tpu_torch.dag.device_channel import DeviceChannel

        ch = DeviceChannel(capacity=8 * 1024 * 1024, device="cpu")
        try:
            src = (torch.arange(1024, dtype=torch.float32) * 1.37 - 300.0
                   ).reshape(32, 32).to(dtype)
            ch.write(src)
            out = ch.read()
            assert isinstance(out, torch.Tensor)
            assert out.dtype == dtype and out.shape == src.shape
            assert out.device.type == "cpu"
            assert torch.equal(out, src)  # bit for bit, bf16 included
            # A non-contiguous view and a 0-d tensor travel too.
            ch.write(src.t())
            assert torch.equal(ch.read(), src.t())
            ch.write(src[0, 0])
            assert torch.equal(ch.read(), src[0, 0])
        finally:
            ch.destroy()

    def test_ping_pong_double_buffering(self):
        from ray_tpu_torch.dag.device_channel import DeviceChannel

        ch = DeviceChannel(capacity=1024 * 1024, device="cpu")
        try:
            # TWO writes proceed without any read — the ping-pong slots
            # are the double buffer (a single-slot channel would block).
            ch.write(torch.full((8,), 1.0))
            ch.write(torch.full((8,), 2.0))
            a = ch.read()
            b = ch.read()
            assert float(a[0]) == 1.0 and float(b[0]) == 2.0
            # Third write only lands after slot 0 was acked (it was).
            ch.write(torch.full((8,), 3.0))
            assert float(ch.read()[0]) == 3.0
        finally:
            ch.destroy()

    def test_control_payloads_and_close(self):
        from ray_tpu_torch.dag.channel import ChannelClosed
        from ray_tpu_torch.dag.device_channel import DeviceChannel

        ch = DeviceChannel(capacity=1024 * 1024, device="cpu")
        try:
            ch.write({"lr": 0.1, "step": 3})  # not a tensor: pickled path
            assert ch.read() == {"lr": 0.1, "step": 3}
            arr = np.arange(6.0)  # numpy too takes the pickled path
            ch.write(arr)
            np.testing.assert_array_equal(ch.read(), arr)
            ch.close()
            with pytest.raises(ChannelClosed):
                ch.read()
        finally:
            ch.destroy()

    def test_no_card_and_no_device_raises(self, monkeypatch):
        """The port's rule: a reader with no device given lands on the
        current CUDA device, and with no card it raises — it never lands
        on the CPU quietly."""
        from ray_tpu_torch.dag.device_channel import DeviceChannel

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ch = DeviceChannel(capacity=1024 * 1024)
        try:
            ch.write({"control": 1})  # control payloads need no device
            assert ch.read() == {"control": 1}
            ch.write(torch.ones(4))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ch.read()
        finally:
            ch.destroy()

    def test_oversized_tensor_refused(self):
        from ray_tpu_torch.dag.device_channel import DeviceChannel

        ch = DeviceChannel(capacity=1024, device="cpu")
        try:
            with pytest.raises(ValueError, match="exceeds device-channel"):
                ch.write(torch.zeros(1024))
            ch.write(torch.zeros(8))  # the failed write left the slot free
            assert torch.equal(ch.read(), torch.zeros(8))
        finally:
            ch.destroy()

    def test_compiled_dag_over_device_channels(self, ray_start_regular):
        """Two actor stages exchanging tensors over device channels: each
        stage's method receives a torch tensor on the channel's device and
        the pipeline result matches the plain call chain, bf16 included."""

        @ray_tpu_torch.remote
        class Scale:
            def __init__(self, k):
                self.k = k

            def apply(self, x):
                assert isinstance(x, torch.Tensor), type(x)
                assert x.device.type == "cpu"
                return self.k * x

        a = Scale.remote(2.0)
        b = Scale.remote(10.0)
        with InputNode() as inp:
            dag = b.apply.bind(a.apply.bind(inp))
        compiled = dag.experimental_compile(channel_type="device",
                                            channel_device="cpu")
        try:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.arange(8, dtype=dtype)
                for i in range(4):
                    out = compiled.execute(x + i).get(timeout=60)
                    assert out.dtype == dtype
                    assert torch.equal(out, (x + i) * 2.0 * 10.0)
        finally:
            compiled.teardown()


class TestDagTracing:
    """JAX's ``tests/test_tracing.py::TestDagTracing`` on the port."""

    def test_tick_spans_under_sampled_caller(self, ray_start_regular):
        from ray_tpu_torch.core.runtime import get_runtime
        from ray_tpu_torch.util import tracing

        def _span_events(events, name):
            return [e for e in events
                    if e.get("kind") == "span" and e.get("name") == name]

        @ray_tpu_torch.remote
        class Doubler:
            def apply(self, x):
                return x * 2

        d = Doubler.remote()
        compiled = d.apply.bind(InputNode()).experimental_compile()
        try:
            # Untraced executes (no ambient context) emit nothing — the
            # µs-scale tick path stays span-free.
            assert compiled.execute(3).get(timeout=30) == 6
            tracing.flush()
            base = len(_span_events(
                get_runtime().gcs.task_events(), "dag.tick"))

            with tracing.span("driver") as (trace_id, _sid):
                assert compiled.execute(5).get(timeout=30) == 10
            tracing.flush()

            events = get_runtime().gcs.trace(trace_id)
            ticks = _span_events(events, "dag.tick")
            stages = _span_events(events, "dag.stage:apply")
            assert len(ticks) == 1 and len(stages) == 1
            # Stage spans parent to their tick; the tick to the caller.
            assert stages[0]["parent_span_id"] == ticks[0]["task_id"]
            all_ticks = _span_events(
                get_runtime().gcs.task_events(), "dag.tick")
            assert len(all_ticks) == base + 1
        finally:
            compiled.teardown()


def _diamond_outputs(rt, input_node_cls, multi_cls, xs):
    """input -> pre -> (left, right) -> merge, plus a MultiOutputNode of
    the two branches, on ``rt``'s in-process runtime: the outputs of every
    tick of each DAG."""
    rt.init(resources={"CPU": 8})
    try:
        @rt.remote
        class Pre:
            def apply(self, x):
                return x * 1.5 + 1.0

        @rt.remote
        class Left:
            def apply(self, x):
                return np.sin(x)

        @rt.remote
        class Right:
            def apply(self, x, k):
                return x ** 2 - k

        @rt.remote
        class Merge:
            def apply(self, a, b):
                return (float((a + b).sum()), a - b)

        pre, lt, rgt, mg = (Pre.remote(), Left.remote(), Right.remote(),
                            Merge.remote())
        with input_node_cls() as inp:
            p = pre.apply.bind(inp)
            dag = mg.apply.bind(lt.apply.bind(p), rgt.apply.bind(p, 3.0))
        compiled = dag.experimental_compile(channel_slots=2)
        try:
            outs = [r.get(timeout=30)
                    for r in [compiled.execute(x) for x in xs]]
        finally:
            compiled.teardown()
        a, b = Left.remote(), Right.remote()
        with input_node_cls() as inp:
            dag2 = multi_cls([a.apply.bind(inp), b.apply.bind(inp, 1.0)])
        compiled = dag2.experimental_compile()
        try:
            outs += [compiled.execute(x).get(timeout=30) for x in xs]
        finally:
            compiled.teardown()
        return outs
    finally:
        rt.shutdown()


def test_diamond_matches_jax_runtime():
    """One diamond DAG under each package's in-process runtime (JAX's
    ``ray_tpu.init``, then the port's) on the same seeded inputs: equal
    outputs, tick for tick."""
    import ray_tpu
    from ray_tpu.dag import InputNode as JaxInputNode
    from ray_tpu.dag import MultiOutputNode as JaxMultiOutputNode

    xs = [np.random.default_rng(i).standard_normal(64) for i in range(6)]
    theirs = _diamond_outputs(ray_tpu, JaxInputNode, JaxMultiOutputNode, xs)
    ours = _diamond_outputs(ray_tpu_torch, InputNode, MultiOutputNode, xs)
    assert len(ours) == len(theirs) == 12
    for o, t in zip(ours, theirs):
        assert len(o) == len(t) == 2
        for a, b in zip(o, t):
            np.testing.assert_array_equal(a, b)
