"""Direct task transport — lease reuse, owner-served objects, crash reclaim.

The round-3 hot-path redesign (reference:
``src/ray/core_worker/transport/direct_task_transport.cc:24,197,241``):
clients lease a worker from the daemon once per scheduling key, push tasks
straight to the worker process (the daemon is out of the request AND reply
path), keep the leased worker across tasks while demand continues, and
release after the idle TTL. Inline-small objects are served by their OWNER's
in-process store (``ownership_based_object_directory.cc`` analog) without a
daemon seal.

JAX's ``tests/test_direct_transport.py`` on the port's runtime and ``Cluster``. The module
is pickled by value (``cloudpickle.register_pickle_by_value``): the
cluster's workers cannot import it.
"""

import os
import signal
import subprocess
import sys
import time

import cloudpickle
import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.rpc import RpcClient

import torch_threads  # noqa: F401,E402  (one torch thread a test process)
from torch_time_limit import time_limit  # noqa: E402

cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def mp_cluster():
    with time_limit(120, "the module's cluster start"):
        cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    yield cluster
    cluster.shutdown()


@pytest.fixture
def driver(mp_cluster):
    core = connect(mp_cluster.gcs_address)
    yield core
    core.shutdown()
    runtime_mod._global_runtime = None


def _wait_for(predicate, timeout=60.0, interval=0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def test_sequential_tasks_reuse_leased_worker(driver):
    """Back-to-back tasks of one scheduling key run on the SAME worker
    process without a per-task GCS lease round trip (worker-lease reuse,
    direct_task_transport.cc:197 OnWorkerIdle)."""

    @ray_tpu.remote
    def pid():
        return os.getpid()

    first = ray_tpu.get(pid.remote(), timeout=120)
    # Let any OTHER hot leases (prior tests / warmup) expire: afterwards
    # exactly one worker is leased by the first call and every back-to-back
    # call reuses it (inter-call gap << idle TTL).
    time.sleep(1.5)
    first = ray_tpu.get(pid.remote(), timeout=60)
    pids = {ray_tpu.get(pid.remote(), timeout=60) for _ in range(10)}
    assert pids == {first}


def test_idle_lease_released_after_ttl(driver, mp_cluster):
    """A leased worker's resources return to the cluster after the idle TTL
    (no demand → no held lease)."""

    @ray_tpu.remote
    def nop():
        return None

    ray_tpu.get(nop.remote(), timeout=120)
    gcs = RpcClient(mp_cluster.gcs_address)
    try:
        assert _wait_for(
            lambda: gcs.call("available_resources").get("CPU", 0) == 4.0,
            timeout=15)
    finally:
        gcs.close()


def test_driver_kill9_reclaims_leases_and_workers(mp_cluster):
    """kill -9 a driver holding reused leases: the GCS releases its
    connection-scoped leases and the daemons kill its directly-leased
    workers (the reference ties leases to the gRPC channel)."""
    script = f"""
import os, time
os.environ["JAX_PLATFORMS"] = "cpu"
import ray_tpu_torch as ray_tpu
from ray_tpu_torch.core.cluster import connect

core = connect({mp_cluster.gcs_address!r})

@ray_tpu.remote
def spin():
    time.sleep(600)

for _ in range(3):
    spin.remote()
print("SUBMITTED", flush=True)
time.sleep(600)
"""
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, cwd=os.path.dirname(
                                os.path.dirname(os.path.abspath(__file__))))
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if b"SUBMITTED" in line:
                break
        else:
            pytest.fail("driver never submitted")
        gcs = RpcClient(mp_cluster.gcs_address)
        try:
            # Leases actually held by the spinning tasks.
            assert _wait_for(
                lambda: gcs.call("available_resources").get("CPU", 4.0) <= 1.0,
                timeout=60)
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10)
            # Conn-scoped lease release + daemon worker reclaim.
            assert _wait_for(
                lambda: gcs.call("available_resources").get("CPU", 0) == 4.0,
                timeout=60)
        finally:
            gcs.close()
    finally:
        if proc.poll() is None:
            proc.kill()


def test_owner_served_small_objects_cross_process(driver):
    """Inline-small task returns have no daemon replica — a ref passed to a
    task on another process resolves through the OWNER's service."""

    @ray_tpu.remote
    def make():
        return {"k": 42}

    ref = make.remote()
    assert ray_tpu.get(ref, timeout=120) == {"k": 42}
    # No GCS location row (the object lives in the owner's cache only).
    assert driver._gcs_rpc.call("locate_object", ref.id.binary()) == []

    @ray_tpu.remote
    def use(d):
        return d["k"] + 1

    assert ray_tpu.get(use.remote(ref), timeout=120) == 43


def test_owner_served_put_cross_process(driver):
    """Small put() objects are owner-served too."""
    ref = ray_tpu.put([1, 2, 3])
    assert driver._gcs_rpc.call("locate_object", ref.id.binary()) == []

    @ray_tpu.remote
    def total(xs):
        return sum(xs)

    assert ray_tpu.get(total.remote(ref), timeout=120) == 6


def test_streaming_generator_items_arrive_before_completion(driver):
    """Generator items are pushed to the owner AS PRODUCED
    (core_worker.cc:3199 analog): the first item is observable while the
    task is still running — round 2 buffered the whole stream until
    task completion."""

    @ray_tpu.remote(num_returns="streaming")
    def ticker():
        for i in range(4):
            yield i
            time.sleep(1.0)

    gen = ticker.remote()
    t0 = time.time()
    it = iter(gen)
    first_ref = next(it)
    first = ray_tpu.get(first_ref, timeout=120)
    first_latency = time.time() - t0
    rest = [ray_tpu.get(r, timeout=120) for r in it]
    total = time.time() - t0
    assert first == 0 and rest == [1, 2, 3]
    # The task runs ~4s; the first item must arrive well before the end.
    assert first_latency < total - 1.5, (first_latency, total)


def test_streaming_generator_error_surfaces_mid_stream(driver):
    @ray_tpu.remote(num_returns="streaming", max_retries=0)
    def bad():
        yield 1
        raise ValueError("stream kaboom")

    refs = list(bad.remote())
    assert ray_tpu.get(refs[0], timeout=120) == 1
    with pytest.raises(ValueError, match="stream kaboom"):
        ray_tpu.get(refs[1], timeout=120)


def test_streaming_error_reply_ahead_of_its_item_keeps_the_item(driver):
    """Item reports and the task's error reply reach the owner over
    different connections. When the reply lands first, the error must
    still be sealed after every item yielded before it: the reply lists
    their ids, and the late report only delivers the payload. (Sealing the
    error at the gap-free prefix lost item 0 and raised at ``refs[0]``.)"""
    from types import SimpleNamespace

    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.core.core_worker import _OwnerService, _PendingTask
    from ray_tpu_torch.core.exceptions import TaskError
    from ray_tpu_torch.core.ids import ObjectID, TaskID

    core = driver
    task_id = TaskID(os.urandom(TaskID.SIZE))
    spec = SimpleNamespace(task_id=task_id,
                           options=SimpleNamespace(num_returns="streaming"))
    item0 = ObjectID.for_task_return(task_id, 0)
    reply = {"ok": False, "generator_items": [item0.binary()]}
    core._merge_streamed(spec, reply)
    core._record_task_error(spec, _PendingTask([]), TaskError.from_exception(
        "bad", ValueError("stream kaboom")))
    _OwnerService(core).report_generator_item(
        task_id.binary(), 0, item0.binary(),
        serialization.serialize(1).to_bytes())
    refs = [core.next_generator_item(task_id, i) for i in range(2)]
    assert core.next_generator_item(task_id, 2) is None
    assert ray_tpu.get(refs[0], timeout=30) == 1
    with pytest.raises(ValueError, match="stream kaboom"):
        ray_tpu.get(refs[1], timeout=30)


def test_streaming_error_is_sealed_after_the_streamed_items(driver):
    """A failed generator's worker seals the error under the index after
    the items it streamed, where the owner seals it. Sealed under index 0,
    as before, it shadowed item 0 (whose value rides the owner's report): a
    get of item 0 that located the sealed error first raised."""

    @ray_tpu.remote(num_returns="streaming", max_retries=0)
    def bad():
        yield 1
        raise ValueError("stream kaboom")

    refs = list(bad.remote())
    assert len(refs) == 2
    daemons = [RpcClient(n["Address"]) for n in ray_tpu.nodes()
               if n["Alive"]]
    try:
        def sealed(ref):
            return any(d.call("has_object", ref.id.binary(), timeout=10.0)
                       for d in daemons)

        assert _wait_for(lambda: sealed(refs[1]), timeout=30.0, interval=0.05)
        assert not sealed(refs[0])
        assert ray_tpu.get(refs[0], timeout=60) == 1
    finally:
        for d in daemons:
            d.close()


def test_streaming_generator_backpressure_bounds_producer(driver, mp_cluster):
    """A fast producer stalls once it runs a full window ahead of a slow
    consumer (reference: _generator_backpressure_num_objects)."""

    @ray_tpu.remote(num_returns="streaming")
    def firehose(n):
        for i in range(n):
            yield i

    # window (64) * 3 items: producer must block on the progress probe
    # until the consumer advances; the stream still completes correctly.
    gen = firehose.remote(192)
    seen = []
    for ref in gen:
        seen.append(ray_tpu.get(ref, timeout=120))
    assert seen == list(range(192))


def test_serve_streams_tokens_cross_process(driver):
    """Serve's streaming handle rides the incremental generator path on the
    MULTIPROCESS runtime: tokens reach the client while the replica is
    still generating (the reference's Serve token streaming over
    streaming-generator returns)."""
    from ray_tpu_torch import serve

    @serve.deployment
    def tokens(x):
        for i in range(3):
            yield {"tok": i}
            time.sleep(0.8)

    h = serve.run(tokens.bind(), name="stream-mp")
    try:
        t0 = time.time()
        arrivals = []
        for chunk in h.options(stream=True).remote({"n": 3}):
            arrivals.append((chunk, time.time() - t0))
        assert [c["tok"] for c, _ in arrivals] == [0, 1, 2]
        # First token observable before the replica finished (~2.4s run).
        assert arrivals[0][1] < arrivals[-1][1] - 0.7, arrivals
    finally:
        serve.shutdown()


def test_admit_in_order_pipelined_races():
    """Unit-level: the server's admission protocol under a pipelined client.

    Pool threads can reach _admit_in_order in ANY arrival order; the
    window_min baseline (task_spec.py window_min) must still admit strictly
    by sequence number, never rewind the cursor, and fast-forward past
    client-side-dropped seqs (reference contract:
    sequential_actor_submit_queue.cc)."""
    import threading

    from ray_tpu_torch.core.ids import ActorID, JobID, TaskID
    from ray_tpu_torch.core.task_spec import TaskOptions, TaskSpec, TaskType
    from ray_tpu_torch.core.worker_main import WorkerService, _ActorState

    aid = ActorID.from_random()
    state = _ActorState(aid, object(), max_concurrency=1)
    svc = WorkerService.__new__(WorkerService)  # only _admit_in_order used

    def spec(seq, window_min):
        return TaskSpec(
            task_id=TaskID.for_task(JobID.from_int(1), aid),
            job_id=JobID.from_int(1), task_type=TaskType.ACTOR_TASK,
            function_id="f", function_name="A", args=[], kwargs={},
            options=TaskOptions(), actor_id=aid, actor_method="m",
            sequence_number=seq, caller_id="h1", window_min=window_min)

    admitted = []
    lock = threading.Lock()

    def admit(seq, wm):
        svc._admit_in_order(state, spec(seq, wm), timeout=10.0)
        with lock:
            admitted.append(seq)

    # Burst 0..7 (window_min=0) arriving in a hostile order: later seqs
    # first. Each runs on its own thread like the server's pool.
    order = [3, 1, 7, 0, 5, 2, 6, 4]
    threads = [threading.Thread(target=admit, args=(s, 0)) for s in order]
    for t in threads:
        t.start()
        time.sleep(0.02)  # force distinct arrival times in the worst order
    for t in threads:
        t.join(timeout=30)
    assert admitted == list(range(8)), admitted

    # Fresh incarnation mid-stream: first arrival is seq 11 but the
    # handle's lowest outstanding is 10 -> 11 must wait for 10.
    state2 = _ActorState(aid, object(), max_concurrency=1)
    admitted.clear()
    def admit2(seq, wm):
        svc._admit_in_order(state2, spec(seq, wm), timeout=10.0)
        with lock:
            admitted.append(seq)
    t11 = threading.Thread(target=admit2, args=(11, 10))
    t10 = threading.Thread(target=admit2, args=(10, 10))
    t11.start(); time.sleep(0.05); t10.start()
    t11.join(timeout=30); t10.join(timeout=30)
    assert admitted == [10, 11], admitted

    # Client dropped seq 12 before sending (serialization failure):
    # seq 13 carries window_min=13 and must not starve behind the gap.
    t13 = threading.Thread(target=admit2, args=(13, 13))
    t13.start(); t13.join(timeout=30)
    assert admitted == [10, 11, 13], admitted


def test_admit_interior_gap_with_skip():
    """An interior dropped seq (older calls still in flight) is closed by
    the skip_actor_seq control message, not window_min."""
    import threading

    from ray_tpu_torch.core.ids import ActorID, JobID, TaskID
    from ray_tpu_torch.core.task_spec import TaskOptions, TaskSpec, TaskType
    from ray_tpu_torch.core.worker_main import WorkerService, _ActorState

    aid = ActorID.from_random()
    state = _ActorState(aid, object(), max_concurrency=1)
    svc = WorkerService.__new__(WorkerService)
    svc._actors_lock = threading.Lock()
    svc._actors = {aid: state}

    def spec(seq, wm):
        return TaskSpec(
            task_id=TaskID.for_task(JobID.from_int(1), aid),
            job_id=JobID.from_int(1), task_type=TaskType.ACTOR_TASK,
            function_id="f", function_name="A", args=[], kwargs={},
            options=TaskOptions(), actor_id=aid, actor_method="m",
            sequence_number=seq, caller_id="h", window_min=wm)

    admitted = []
    lock = threading.Lock()

    def admit(seq, wm):
        svc._admit_in_order(state, spec(seq, wm), timeout=10.0)
        with lock:
            admitted.append(seq)

    # seq 0 admitted; seq 1 in flight (slow); seq 2 dropped client-side;
    # seq 3 sent with window_min=1 (1 still outstanding).
    admit(0, 0)
    t3 = threading.Thread(target=admit, args=(3, 1))
    t3.start()
    time.sleep(0.1)
    svc.skip_actor_seq(aid.binary(), "h", 2)   # client reports the gap
    t1 = threading.Thread(target=admit, args=(1, 1))
    t1.start()
    t1.join(timeout=30)
    t3.join(timeout=30)
    assert admitted == [0, 1, 3], admitted


def test_unpicklable_actor_arg_does_not_wedge_handle(driver):
    """A call with an unserializable argument fails cleanly AND later calls
    on the same handle still run (interior-gap skip end-to-end)."""
    import threading as _threading

    @ray_tpu.remote
    class Echo:
        def val(self, x):
            return x if not hasattr(x, "acquire") else "lock"

    e = Echo.remote()
    assert ray_tpu.get(e.val.remote(1), timeout=120) == 1
    bad = e.val.remote(_threading.Lock())  # cannot pickle
    with pytest.raises(Exception):
        ray_tpu.get(bad, timeout=60)
    # handle must not be wedged behind the dropped seq
    assert ray_tpu.get(e.val.remote(2), timeout=60) == 2
    assert ray_tpu.get([e.val.remote(i) for i in range(3, 8)],
                       timeout=60) == list(range(3, 8))
