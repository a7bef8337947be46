"""Control-plane fast path regression tests.

Covers the four guarantees of the coalescing/cached-encoding RPC layer:

(a) frames written through the coalescing sender decode identically to
    singleton sends — property-style round trip over mixed small / large /
    out-of-band frames;
(b) a blocking call on a freshly submitted request is never delayed by the
    coalescing window;
(c) the cached task-spec encoding invalidates when the actor handle or the
    resource spec changes (content-addressed digests);
(d) batched (coalesced) task-finish reports resolve every inlined return
    exactly once.

JAX's ``tests/test_rpc_fastpath.py`` on the port's ``ray_tpu_torch.core.rpc``
and its cached spec encoding.
"""

import random
import socket
import threading
import time

import numpy as np
import pytest

from ray_tpu_torch.core import rpc, serialization
from ray_tpu_torch.core.ids import ActorID, JobID, TaskID
from ray_tpu_torch.core.rpc import (RpcClient, RpcServer, _dumps_frame,
                              _FrameSender, _LEN, _recv_frame, _SockReader)
from ray_tpu_torch.core.task_spec import (SpecCacheMiss, SpecEncoder,
                                    SpecTemplateStore, TaskArg, TaskOptions,
                                    TaskSpec, TaskType, spec_var_fields)

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


# ---------------------------------------------------------------------------
# (a) coalesced frames decode identically to singletons
# ---------------------------------------------------------------------------


def _mixed_messages(seed: int, n: int):
    """Mixed small / large / out-of-band message population."""
    rng = random.Random(seed)
    msgs = []
    for i in range(n):
        pick = rng.random()
        if pick < 0.4:
            data = {"i": i, "s": "x" * rng.randrange(0, 200)}
        elif pick < 0.7:
            data = list(range(rng.randrange(0, 64)))
        elif pick < 0.9:
            # Above OOB_MIN_BYTES: stripped from the pickle stream and
            # streamed raw after the wrapper frame.
            data = np.arange(rng.randrange(40_000, 80_000), dtype=np.float64)
        else:
            data = b"y" * rng.randrange(300_000, 400_000)
        msgs.append(("req", i, "echo", data))
    return msgs


def _roundtrip_through_sender(msgs, window_s):
    """Write every message through ONE _FrameSender over a socketpair
    (coalescing on), read them back with the framed receiver."""
    a, b = socket.socketpair()
    try:
        sender = _FrameSender(a, window_s=window_s)
        got = []
        done = threading.Event()

        def read_loop():
            reader = _SockReader(b)
            try:
                for _ in msgs:
                    got.append(_recv_frame(reader))
            finally:
                done.set()

        t = threading.Thread(target=read_loop, daemon=True)
        t.start()
        for m in msgs:
            frame, bufs, raws = _dumps_frame(m)
            sender.send([_LEN.pack(len(frame)), frame, *bufs], raws,
                        urgent=False)
        sender.flush()
        assert done.wait(30), "receiver did not drain all frames"
        return got
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("window_s", [0.0, 0.002])
def test_coalesced_frames_decode_identically(window_s):
    msgs = _mixed_messages(seed=7, n=60)
    got = _roundtrip_through_sender(msgs, window_s)
    assert len(got) == len(msgs)
    for sent, rec in zip(msgs, got):
        assert rec[0] == sent[0] and rec[1] == sent[1] and rec[2] == sent[2]
        sd, rd = sent[3], rec[3]
        if isinstance(sd, np.ndarray):
            assert np.array_equal(np.asarray(rd), sd)
        elif isinstance(sd, (bytes, bytearray)):
            assert bytes(rd) == bytes(sd)
        else:
            assert rd == sd


def test_concurrent_senders_coalesce_without_corruption():
    """Many threads hammering one sender: frames interleave atomically (no
    torn frames), every frame arrives exactly once, and at least some
    syscalls carried more than one frame."""
    a, b = socket.socketpair()
    try:
        rpc.reset_send_stats()
        sender = _FrameSender(a, window_s=0.0)
        n_threads, per_thread = 8, 40
        total = n_threads * per_thread
        got = []
        done = threading.Event()

        def read_loop():
            reader = _SockReader(b)
            for _ in range(total):
                got.append(_recv_frame(reader))
            done.set()

        # The batching assertion needs the senders to overlap; on a loaded
        # host, threads left to themselves often ran their sends one after
        # another. So they start together on a barrier, and the reader
        # starts only once they are under way, behind small socket buffers:
        # the first drainer blocks in sendmsg while the others queue.
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        start = threading.Barrier(n_threads + 1)
        reader = threading.Thread(target=read_loop, daemon=True)

        def send_many(tid):
            start.wait(30)
            for i in range(per_thread):
                m = ("note", 0, "m", (tid, i, "p" * (i % 50)))
                frame, bufs, raws = _dumps_frame(m)
                sender.send([_LEN.pack(len(frame)), frame, *bufs], raws,
                            urgent=False)

        threads = [threading.Thread(target=send_many, args=(t,), daemon=True)
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        start.wait(30)
        time.sleep(0.2)
        reader.start()
        for t in threads:
            t.join(30)
        assert done.wait(30)
        seen = {d[3][:2] for d in got}
        assert len(seen) == total  # every frame exactly once, none torn
        stats = rpc.send_stats()
        assert stats["frames"] >= total
        assert stats["syscalls"] < stats["frames"]  # some batching happened
    finally:
        a.close()
        b.close()


def test_raw_release_fires_exactly_once_through_sender():
    """Raw release hooks fire exactly once after the coalesced write."""
    a, b = socket.socketpair()
    try:
        sender = _FrameSender(a, window_s=0.0)
        fired = []
        payload = np.arange(100_000, dtype=np.float64)  # > OOB_MIN_BYTES
        raw = rpc.Raw(payload, release=lambda: fired.append(1))
        frame, bufs, raws = _dumps_frame(("note", 0, "m", raw))
        assert raws, "Raw wrapper should have been collected"
        got = []

        def read_loop():
            got.append(_recv_frame(_SockReader(b)))

        t = threading.Thread(target=read_loop, daemon=True)
        t.start()
        sender.send([_LEN.pack(len(frame)), frame, *bufs], raws)
        t.join(15)
        assert fired == [1]
        assert np.array_equal(
            np.frombuffer(got[0][3], dtype=np.float64), payload)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# (b) blocking calls never wait on the coalescing window
# ---------------------------------------------------------------------------


class _Echo:
    def echo(self, x):
        return x

    def ping(self):
        return "pong"


def test_blocking_call_not_delayed_by_window():
    """Even with an absurd window forced on and the connection marked hot,
    urgent request frames and the pre-wait flush keep blocking calls fast."""
    server = RpcServer(_Echo(), name="win")
    client = RpcClient(server.address)
    try:
        client.call("ping", timeout=10)  # connect + warm
        # Force a huge window on the CLIENT's sender and mark it hot, as if
        # heavy coalescing had just happened.
        sender = client._sender
        sender._window = 0.5
        sender._hot_until = time.monotonic() + 60.0
        t0 = time.perf_counter()
        for _ in range(5):
            assert client.call("echo", 1, timeout=10) == 1
        elapsed = time.perf_counter() - t0
        assert elapsed < 0.4, (
            f"blocking calls took {elapsed:.3f}s — delayed by the window")
    finally:
        client.close()
        server.stop()


def test_flush_releases_window_wait():
    """A non-urgent frame sitting in a window wait goes out immediately on
    flush() rather than after the full window."""
    a, b = socket.socketpair()
    try:
        sender = _FrameSender(a, window_s=5.0)
        sender._hot_until = time.monotonic() + 60.0  # arm the window
        # Prime: a first frame makes the NEXT drain see a hot connection.
        frame, _, _ = _dumps_frame(("note", 0, "warm", None))
        sender.send([_LEN.pack(len(frame)), frame], urgent=False)
        reader = _SockReader(b)
        _recv_frame(reader)

        got = []
        done = threading.Event()

        def read_one():
            got.append(_recv_frame(reader))
            done.set()

        threading.Thread(target=read_one, daemon=True).start()
        frame, _, _ = _dumps_frame(("note", 0, "slow", 42))
        t = threading.Thread(
            target=lambda: sender.send([_LEN.pack(len(frame)), frame],
                                       urgent=False), daemon=True)
        t0 = time.perf_counter()
        t.start()
        time.sleep(0.05)  # let it enter the window wait
        sender.flush()
        assert done.wait(3), "flush did not release the window wait"
        assert time.perf_counter() - t0 < 2.0  # far below the 5s window
        assert got[0][3] == 42
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# (c) cached task-spec encoding + invalidation
# ---------------------------------------------------------------------------


def _make_spec(options=None, caller="caller-1", actor=None, seq=0,
               args=(3,)):
    job = JobID.from_int(1)
    return TaskSpec(
        task_id=TaskID.for_task(job),
        job_id=job,
        task_type=TaskType.ACTOR_TASK if actor is not None
        else TaskType.NORMAL_TASK,
        function_id="fn:f:abcd",
        function_name="f",
        args=[TaskArg(value=a) for a in args],
        kwargs={},
        options=options or TaskOptions(),
        actor_id=actor,
        actor_method="m" if actor is not None else None,
        sequence_number=seq,
        caller_id=caller,
        owner_addr="127.0.0.1:1",
    )


def test_spec_roundtrip_and_template_memo():
    opts = TaskOptions(resources={"CPU": 1.0})
    enc = SpecEncoder(cap=16)
    store = SpecTemplateStore(cap=16)
    s1 = _make_spec(options=opts, seq=1)
    s2 = _make_spec(options=opts, seq=2, args=(99,))
    d1, t1 = enc.encode_template(s1)
    d2, _t2 = enc.encode_template(s2)
    assert d1 == d2  # same callable -> same template
    assert enc.encode_hits == 1 and enc.encode_misses == 1
    store.register(d1, t1)
    for s in (s1, s2):
        dec = store.decode((d1, enc.encode_vars(s)))
        assert dec.sequence_number == s.sequence_number
        assert dec.args[0].value == s.args[0].value
        assert dec.options.resources == {"CPU": 1.0}
        assert dec.function_id == s.function_id
        assert dec.owner_addr == s.owner_addr
        # Full fidelity against the legacy whole-spec pickle.
        legacy = serialization.loads(serialization.dumps(s))
        assert spec_var_fields(dec) == spec_var_fields(legacy)


def test_spec_cache_invalidates_on_resource_change():
    enc = SpecEncoder(cap=16)
    d1, _ = enc.encode_template(
        _make_spec(options=TaskOptions(resources={"CPU": 1.0})))
    d2, t2 = enc.encode_template(
        _make_spec(options=TaskOptions(resources={"CPU": 2.0})))
    assert d1 != d2, "changed resource spec must change the digest"
    store = SpecTemplateStore(cap=16)
    store.register(d2, t2)
    dec = store.decode(
        (d2, enc.encode_vars(
            _make_spec(options=TaskOptions(resources={"CPU": 2.0})))))
    assert dec.options.resources == {"CPU": 2.0}


def test_spec_cache_invalidates_on_actor_handle_change():
    enc = SpecEncoder(cap=16)
    opts = TaskOptions()
    a1 = ActorID(b"\x01" * 16)
    a2 = ActorID(b"\x02" * 16)
    d1, _ = enc.encode_template(_make_spec(options=opts, actor=a1))
    d2, _ = enc.encode_template(_make_spec(options=opts, actor=a2))
    assert d1 != d2, "a different actor must change the digest"
    # Same actor, different handle (caller_id) -> also a fresh digest.
    d3, _ = enc.encode_template(
        _make_spec(options=opts, actor=a1, caller="caller-2"))
    assert d3 != d1


def test_spec_store_miss_raises_and_legacy_bytes_pass_through():
    store = SpecTemplateStore(cap=4)
    enc = SpecEncoder(cap=4)
    spec = _make_spec()
    with pytest.raises(SpecCacheMiss):
        store.decode((b"\x00" * 16, enc.encode_vars(spec)))
    dec = store.decode(serialization.dumps(spec))
    assert dec.function_name == "f" and dec.args[0].value == 3


def test_spec_store_eviction_is_bounded():
    store = SpecTemplateStore(cap=4)
    enc = SpecEncoder(cap=64)
    digests = []
    for i in range(8):
        s = _make_spec(options=TaskOptions(resources={"CPU": float(i + 1)}))
        d, t = enc.encode_template(s)
        store.register(d, t)
        digests.append((d, s))
    # Oldest evicted -> SpecCacheMiss; newest still decode.
    with pytest.raises(SpecCacheMiss):
        store.decode((digests[0][0], enc.encode_vars(digests[0][1])))
    d, s = digests[-1]
    assert store.decode((d, enc.encode_vars(s))).options.resources == {
        "CPU": 8.0}


# ---------------------------------------------------------------------------
# (d) batched finish reports resolve every inlined return exactly once
# ---------------------------------------------------------------------------


class _SlowStart:
    """Handler whose replies are released in a burst, forcing the server's
    reply sender to coalesce many small finish reports."""

    def __init__(self):
        self.gate = threading.Event()

    def open_gate(self):
        self.gate.set()
        return True

    def finish(self, i):
        self.gate.wait(20)
        return {"i": i, "value": i * 2}


def test_batched_finish_reports_resolve_exactly_once():
    handler = _SlowStart()
    server = RpcServer(handler, name="batch", max_workers=32)
    client = RpcClient(server.address)
    try:
        n = 24
        counts = [0] * n
        futs = [client.call_async("finish", i) for i in range(n)]
        for i, f in enumerate(futs):
            f.add_done_callback(
                lambda fut, i=i: counts.__setitem__(i, counts[i] + 1))
        # Release all handlers at once: their replies land on the reply
        # sender back-to-back and coalesce into scatter-gather batches.
        assert client.call("open_gate", timeout=10) is True
        for i, f in enumerate(futs):
            assert f.result(timeout=30) == {"i": i, "value": i * 2}
        time.sleep(0.1)
        assert counts == [1] * n, "every reply must resolve exactly once"
    finally:
        client.close()
        server.stop()


def test_rpc_send_stats_shape():
    stats = rpc.send_stats()
    for key in ("frames", "syscalls", "bytes", "frames_per_syscall"):
        assert key in stats


def test_lazy_lineage_rebuild_does_not_leak_arg_refs():
    """Cached-template tasks rebuild their lineage pickle lazily INSIDE
    _package_results's collecting_refs scope; the rebuild must use a
    private collection scope so the spec's argument refs are never
    registered as contained-in-return (they would pin the caller as a
    borrower of refs the return value doesn't hold)."""
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_ref import ObjectRef
    from ray_tpu_torch.core.worker_main import _lineage_bytes

    ref = ObjectRef(ObjectID.nil(), owner_hint="127.0.0.1:9")
    spec = _make_spec(args=({"nested": ref},))
    with serialization.collecting_refs() as outer:
        blob = _lineage_bytes(spec)
    assert outer == [], "lineage rebuild leaked arg refs into outer scope"
    # Sanity: the same dump WITHOUT the private scope does collect — the
    # guard above is meaningful.
    with serialization.collecting_refs() as outer2:
        serialization.dumps(spec)
    assert outer2, "expected the unshielded dump to collect the nested ref"
    # And the blob still round-trips to a full spec.
    dec = serialization.loads(blob)
    assert dec.args[0].value["nested"].id == ref.id


def test_strict_serial_admission_tolerates_long_execution():
    """Strict serial ordering holds the admission cursor for a call's whole
    runtime; a successor's starvation deadline must treat an EXECUTING
    predecessor as progress (a legitimately slow method is not a lost
    sequence number) — while a true gap still times out."""
    from ray_tpu_torch.core.ids import ActorID as AID
    from ray_tpu_torch.core.worker_main import WorkerService, _ActorState

    state = _ActorState(AID.nil(), object(), max_concurrency=1)
    svc = object.__new__(WorkerService)  # only _admit_in_order is used

    s0 = _make_spec(seq=0)
    s1 = _make_spec(seq=1)
    # A real pipelined client reports its lowest UNACKED seq: s0 is still
    # executing (unacked), so window_min must be 0 — the transport-less
    # default (own seq) would wrongly fast-forward admission past s0.
    s1.window_min = 0
    # seq0 admitted without bumping (strict): cursor held, executing marked.
    svc._admit_in_order(state, s0, bump=False)
    assert state.executing.get(s0.caller_id) == 0

    errors, done = [], threading.Event()

    def successor():
        try:
            # Far below the wall time we hold seq0 "executing": would raise
            # TimeoutError without the executing-progress rule.
            svc._admit_in_order(state, s1, timeout=1.2)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
        finally:
            done.set()

    t = threading.Thread(target=successor, daemon=True)
    t.start()
    time.sleep(2.5)  # longer than the successor's starvation timeout
    assert not done.is_set(), "successor should still be waiting on seq0"
    # seq0 "finishes": clear executing, bump, notify (run_actor_task's
    # strict finally).
    with state.cv:
        del state.executing[s0.caller_id]
        state.next_seq[s0.caller_id] = 1
        state.cv.notify_all()
    assert done.wait(10) and not errors, errors

    # True gap (nothing executing, cursor stuck): times out.
    s3 = _make_spec(seq=3)
    s3.window_min = 1  # seqs 1-2 claimed outstanding but never arrive
    with pytest.raises(TimeoutError):
        svc._admit_in_order(state, s3, timeout=1.0)
