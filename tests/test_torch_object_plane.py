"""Parallel object-plane read path: batched multi-ref get, multi-source
striped pulls, and location-push wakeups — plus the memory-store LRU /
restore-capacity satellites.

Reference analogs: the owner-resolved batched get of
``core_worker.cc`` ``GetObjects``, chunked multi-source pulls of
``pull_manager.cc``, and the object-location pubsub of
``ownership_based_object_directory.cc``.

JAX's ``tests/test_object_plane.py`` on the port's runtime and ``Cluster``. The module
is pickled by value (``cloudpickle.register_pickle_by_value``): the
cluster's workers cannot import it.
"""

import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.core.config import Config, set_config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import MemoryStore
from ray_tpu_torch.core.serialization import serialize

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture
def fresh_config():
    """Install a pristine Config for store unit tests; restore after."""
    def install(**overrides):
        set_config(Config(overrides))

    install()
    yield install
    set_config(Config())


@pytest.fixture
def two_nodes():
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    core = connect(cluster.gcs_address)
    yield cluster, core
    core.shutdown()
    runtime_mod._global_runtime = None
    cluster.shutdown()


@ray_tpu.remote
class _Owner:
    """Holds small objects in ITS in-process store (owner-served fetches)
    and seals payloads under caller-chosen ids at a chosen time."""

    def make(self, n, size):
        import os

        return [ray_tpu.put(os.urandom(size)) for _ in range(n)]

    def make_tagged(self, tags):
        return {t: ray_tpu.put(f"value-{t}".encode()) for t in tags}

    def seal_after(self, oid_bytes, delay, size):
        from ray_tpu_torch.core.runtime import get_runtime

        payload = serialize(b"s" * size).to_bytes()
        time.sleep(delay)
        get_runtime().seal_payload(ObjectID(oid_bytes), payload)
        return time.monotonic()

    def seal_replica(self, ref_list):
        """Seal a replica of an EXISTING object on this actor's node."""
        from ray_tpu_torch.core.runtime import get_runtime

        value = ray_tpu.get(ref_list[0])
        get_runtime().seal_serialized(ref_list[0].id, serialize(value))
        return True


# ====================== batched get ======================


def test_batched_get_preserves_caller_order_with_mixed_refs(two_nodes):
    _cluster, core = two_nodes
    owner = _Owner.remote()
    tags = [f"t{i}" for i in range(8)]
    remote_refs = ray_tpu.get(owner.make_tagged.remote(tags), timeout=120)
    local_ref = ray_tpu.put(b"local-hit")

    @ray_tpu.remote
    def produce():
        return b"task-return"

    task_ref = produce.remote()
    # Mixed batch: cache hits, owner-served misses (dropped below), a
    # pending task return, and DUPLICATES — values must come back in
    # caller order.
    batch = [remote_refs["t3"], local_ref, remote_refs["t0"], task_ref,
             remote_refs["t3"], remote_refs["t7"], local_ref]
    with core._cache_lock:
        for r in remote_refs.values():
            core._cache.pop(r.id, None)
    values = ray_tpu.get(batch, timeout=120)
    assert values == [b"value-t3", b"local-hit", b"value-t0",
                      b"task-return", b"value-t3", b"value-t7",
                      b"local-hit"]


def test_batched_get_uses_one_locate_round_trip(two_nodes):
    _cluster, core = two_nodes
    # Node-sealed (non-inline) objects so resolution needs locations.
    refs = [ray_tpu.put(np.arange(40_000) + i) for i in range(6)]

    @ray_tpu.remote
    def touch(x):
        return float(x[0])

    ray_tpu.get([touch.remote(r) for r in refs], timeout=120)
    with core._cache_lock:
        for r in refs:
            core._cache.pop(r.id, None)
    before = core.get_stats()["locate_calls"]
    out = ray_tpu.get(refs, timeout=120)
    assert [int(v[0]) for v in out] == list(range(6))
    # ONE locate_object_batch call resolved all six misses.
    assert core.get_stats()["locate_calls"] - before == 1


def test_batched_get_first_error_in_caller_order(two_nodes):
    _cluster, _core = two_nodes

    @ray_tpu.remote
    def boom_value():
        raise ValueError("first in caller order")

    @ray_tpu.remote
    def boom_type():
        raise TypeError("second in caller order")

    @ray_tpu.remote
    def ok():
        return 1

    err1, err2 = boom_value.remote(), boom_type.remote()
    good = [ok.remote() for _ in range(3)]
    with pytest.raises(ValueError, match="first in caller order"):
        ray_tpu.get([good[0], err1, good[1], err2, good[2]], timeout=120)
    # A batch whose only failure comes later still raises that one.
    with pytest.raises(TypeError, match="second in caller order"):
        ray_tpu.get([good[0], good[1], err2], timeout=120)


def test_batched_get_timeout_still_raises(two_nodes):
    _cluster, _core = two_nodes
    never = ObjectRef(ObjectID.for_put())  # nothing will ever seal this
    ok = ray_tpu.put(b"x")
    t0 = time.time()
    with pytest.raises(ray_tpu.GetTimeoutError):
        ray_tpu.get([ok, never], timeout=1.0)
    assert time.time() - t0 < 30.0


def test_task_with_many_ref_args_resolves_concurrently(two_nodes):
    _cluster, core = two_nodes
    owner = _Owner.remote()
    refs = ray_tpu.get(owner.make.remote(6, 2048), timeout=120)
    with core._cache_lock:
        for r in refs:
            core._cache.pop(r.id, None)

    @ray_tpu.remote
    def concat(*parts):
        return sum(len(p) for p in parts)

    assert ray_tpu.get(concat.remote(*refs), timeout=120) == 6 * 2048


def test_dependency_error_propagates_through_batched_args(two_nodes):
    _cluster, _core = two_nodes

    @ray_tpu.remote
    def boom():
        raise RuntimeError("dep failed")

    @ray_tpu.remote
    def ok():
        return 2

    @ray_tpu.remote
    def add(a, b):
        return a + b

    with pytest.raises(RuntimeError, match="dep failed"):
        ray_tpu.get(add.remote(ok.remote(), boom.remote()), timeout=120)


# ====================== multi-source striped pulls ======================


def _make_two_replica_object(cluster, core, n_doubles):
    """A node-sealed object with a second replica sealed on node 1."""
    arr = np.arange(n_doubles, dtype=np.float64)
    ref = ray_tpu.put(arr)
    origin = core._gcs_rpc.call("locate_object", ref.id.binary())[0][0]
    other = next(h for h in cluster.nodes if h.node_id != origin)

    @ray_tpu.remote(scheduling_strategy=ray_tpu.NodeAffinitySchedulingStrategy(
        node_id=other.node_id, soft=False))
    def seal_replica(ref_list):
        from ray_tpu_torch.core.runtime import get_runtime

        value = ray_tpu.get(ref_list[0])
        get_runtime().seal_serialized(ref_list[0].id, serialize(value))
        return True

    assert ray_tpu.get(seal_replica.remote([ref]), timeout=300)
    deadline = time.time() + 60
    while time.time() < deadline:
        if len(core._gcs_rpc.call("locate_object", ref.id.binary())) >= 2:
            break
        time.sleep(0.2)
    locs = core._gcs_rpc.call("locate_object", ref.id.binary())
    assert len(locs) >= 2, locs
    return arr, ref, other


def test_multi_source_pull_completes_and_matches(two_nodes):
    cluster, core = two_nodes
    # ~24 MB: above stripe_min_size (16 MB) -> striped across 2 replicas.
    arr, ref, _other = _make_two_replica_object(cluster, core, 3_000_000)
    with core._cache_lock:
        core._cache.pop(ref.id, None)
    out = ray_tpu.get(ref, timeout=300)
    assert isinstance(out, np.ndarray)
    assert out.shape == arr.shape and out[0] == 0.0
    assert float(out.sum()) == float(arr.sum())


def test_stripe_reassigns_ranges_when_a_replica_daemon_dies(two_nodes):
    cluster, core = two_nodes
    arr, ref, other = _make_two_replica_object(cluster, core, 3_000_000)
    # Kill the replica daemon AFTER location registration: the GCS health
    # check hasn't noticed yet, so the stripe opens against BOTH sources
    # and the dead one's ranges must reassign to the survivor.
    idx = next(i for i, h in enumerate(cluster.nodes)
               if h.node_id == other.node_id)
    cluster.kill_node(idx)
    core._daemons.invalidate(other.address)
    assert len(core._gcs_rpc.call("locate_object", ref.id.binary())) >= 2
    with core._cache_lock:
        core._cache.pop(ref.id, None)
    out = ray_tpu.get(ref, timeout=300)
    assert float(out.sum()) == float(arr.sum())


def test_pull_into_multi_reassigns_and_aborts(two_nodes):
    """PullManager-level: a dead source's ranges reassign to the survivor;
    with NO live source the pull aborts (returns False)."""
    from ray_tpu_torch.core.object_transfer import PullManager

    cluster, core = two_nodes
    arr, ref, _other = _make_two_replica_object(cluster, core, 3_000_000)
    locs = core._gcs_rpc.call("locate_object", ref.id.binary())
    addrs = [a for _n, a, _s in locs]
    size = serialize(arr).framed_size()
    pull = PullManager(core._daemons)
    pull._stripe_min = 0  # force striping regardless of size

    dest = bytearray(size)
    assert pull.pull_into_multi(addrs + ["127.0.0.1:9"], ref.id.binary(),
                                size, dest)  # dead third source: survivors
    from ray_tpu_torch.core.serialization import deserialize, SerializedObject

    out = deserialize(SerializedObject.from_bytes(bytes(dest)))
    assert float(out.sum()) == float(arr.sum())
    # A REACHABLE source that doesn't hold the object (stale location)
    # answers chunk requests with None — its claimed ranges must requeue
    # to the real holder, not vanish (a lost range deadlocks the pull).
    solo = np.arange(3_000_000, dtype=np.float64) * 2.0
    solo_ref = ray_tpu.put(solo)  # sealed on the driver's node only
    solo_size = serialize(solo).framed_size()
    holder = [a for _n, a, _s in core._gcs_rpc.call(
        "locate_object", solo_ref.id.binary())]
    objectless = [a for a in addrs if a not in holder]
    assert objectless, "need one daemon without the replica"
    dest2 = bytearray(solo_size)
    assert pull.pull_into_multi(objectless + holder, solo_ref.id.binary(),
                                solo_size, dest2)
    out2 = deserialize(SerializedObject.from_bytes(bytes(dest2)))
    assert float(out2.sum()) == float(solo.sum())
    # No source holds the object at all -> clean abort, not a hang.
    stale = bytearray(1024)
    assert not pull.pull_into_multi(addrs, ObjectID.for_put().binary(),
                                    1024, stale)
    # All sources dead -> full abort, not a hang.
    assert not pull.pull_into_multi(["127.0.0.1:9", "127.0.0.1:11"],
                                    ref.id.binary(), size, bytearray(size))


# ====================== location-push wakeups ======================


def test_sealed_late_get_wakes_on_push_not_poll(two_nodes, monkeypatch):
    cluster, core = two_nodes
    # The owner seals on the other node: a seal into this node's arena is
    # found by the get's local probe, with no location needed.
    other = next(h for h in cluster.nodes
                 if h.node_id != core.current_node_id)
    owner = _Owner.options(
        scheduling_strategy=ray_tpu.NodeAffinitySchedulingStrategy(
            node_id=other.node_id, soft=False)).remote()
    ray_tpu.get(owner.make.remote(1, 8), timeout=120)  # actor warm
    before = core.get_stats()
    oid = ObjectID.for_put()
    got = {}
    # The GCS calls, ordered: a long poll of the location channel whose
    # server-side filter holds this object (the subscriber's parked poll,
    # which the seal's push ends) is noted; once the seal is asked for, a
    # fallback locate of the object waits for that push to be delivered
    # and answers as of before the seal (no location) — a loaded host's
    # slow push must not lose to the quarter-second fallback poll. A push
    # that never comes releases it after 10 s and fails the assertions.
    key = oid.binary()
    parked = []
    sealing, pushed = threading.Event(), threading.Event()
    call = core._gcs_rpc.call

    def ordered(method, *args, **kw):
        if method == "locate_object" and args[0] == key and sealing.is_set():
            pushed.wait(10.0)
            return []
        if (method == "subscribe_object_locations" and args[1] > 0
                and key in args[2]):
            parked.append(time.monotonic())
        out = call(method, *args, **kw)
        if method == "subscribe_object_locations" and any(
                m[0] == key for m in out[1]):
            pushed.set()
        return out

    monkeypatch.setattr(core._gcs_rpc, "call", ordered)

    def waiter():
        got["value"] = ray_tpu.get(ObjectRef(oid), timeout=60)
        got["t"] = time.monotonic()

    getter = threading.Thread(target=waiter, daemon=True)
    getter.start()
    # The seal is asked for only once the get's waiter is registered, a
    # poll carrying its object is parked at the GCS, and the get's own
    # fallback locate has just run: a locate in flight at the seal could
    # find the object, and no push would be needed.
    deadline = time.monotonic() + 30.0
    while True:
        with core._loc_lock:
            registered = oid in core._loc_waiters
        if registered and parked:
            break
        assert time.monotonic() < deadline, "the get never armed its waiter"
        time.sleep(0.002)
    locates = core.get_stats()["locate_calls"]
    while core.get_stats()["locate_calls"] == locates:
        assert time.monotonic() < deadline, "no fallback locate ran"
        time.sleep(0.002)
    sealing.set()
    seal_fut = owner.seal_after.remote(oid.binary(), 0.0, 256 * 1024)
    getter.join(timeout=60)
    assert not getter.is_alive()
    value, t_return = got["value"], got["t"]
    t_seal = ray_tpu.get(seal_fut, timeout=60)
    assert value == b"s" * 256 * 1024
    after = core.get_stats()
    # The waiter woke on the location push: no legacy backoff sleeps, at
    # least one push wakeup, and the locate poll stayed at its low-rate
    # fallback cadence instead of one RPC per backoff step.
    assert after["backoff_sleeps"] == before["backoff_sleeps"]
    assert after["push_wakeups"] > before["push_wakeups"]
    assert after["locate_calls"] - before["locate_calls"] <= 5
    # Seal-to-return latency is push-driven (old poll: up to 100ms backoff).
    assert t_return - t_seal < 0.1, f"woke {t_return - t_seal:.3f}s after seal"


def test_sealed_late_get_with_subscription_disabled_falls_back_to_poll(
        two_nodes):
    _cluster, core = two_nodes
    set_config(Config({"location_sub_enabled": False}))
    try:
        owner = _Owner.remote()
        before = core.get_stats()
        oid = ObjectID.for_put()
        owner.seal_after.remote(oid.binary(), 0.1, 64 * 1024)
        value = ray_tpu.get(ObjectRef(oid), timeout=60)
        assert value == b"s" * 64 * 1024
        after = core.get_stats()
        assert after["backoff_sleeps"] > before["backoff_sleeps"]
        assert after["push_wakeups"] == before["push_wakeups"]
    finally:
        set_config(Config())


def test_subscriber_thread_exits_when_idle(two_nodes):
    _cluster, core = two_nodes
    owner = _Owner.remote()
    oid = ObjectID.for_put()
    owner.seal_after.remote(oid.binary(), 0.05, 4 * 1024)
    ray_tpu.get(ObjectRef(oid), timeout=60)
    assert core._loc_sub_running  # just used it
    deadline = time.time() + 15
    while core._loc_sub_running and time.time() < deadline:
        time.sleep(0.2)
    assert not core._loc_sub_running  # idle-exit: no standing GCS poll


# ====================== memory-store satellites ======================


def _payload(n):
    return b"p" * n


def test_evict_spills_least_recently_used_not_oldest(fresh_config):
    fresh_config(object_store_memory=4000, use_native_store=False)
    store = MemoryStore(capacity_bytes=4000)
    a, b = ObjectID.for_put(), ObjectID.for_put()
    store.put(a, _payload(1500))
    store.put(b, _payload(1500))
    store.get_serialized(a)  # A is now more recently USED than B
    c = ObjectID.for_put()
    store.put(c, _payload(1500))  # over capacity: one entry must spill
    with store._lock:
        assert store._objects[b].serialized is None, "LRU victim is B"
        assert store._objects[a].serialized is not None
        assert store._objects[c].serialized is not None
    # The spilled entry still resolves (restore path).
    assert bytes(store.get(b)) == _payload(1500)


def test_restore_of_spilled_entry_triggers_eviction(fresh_config):
    fresh_config(object_store_memory=4000, use_native_store=False)
    store = MemoryStore(capacity_bytes=4000)
    a, b, c = (ObjectID.for_put() for _ in range(3))
    store.put(a, _payload(1500))
    store.put(b, _payload(1500))
    store.put(c, _payload(1500))  # spills A (least recently used)
    with store._lock:
        assert store._objects[a].serialized is None
    value = store.get(a)  # restore pushes _used over capacity
    assert bytes(value) == _payload(1500)
    with store._lock:
        assert store._used <= store._capacity, (
            "restore must re-evict down to capacity")
        assert store._objects[a].serialized is not None, (
            "the just-restored entry must not bounce straight back out")
        assert any(store._objects[oid].serialized is None for oid in (b, c))


def test_deser_cache_is_bounded_lru(fresh_config):
    fresh_config(deser_cache_entries=8, use_native_store=False)
    store = MemoryStore(capacity_bytes=1 << 20)
    oids = [ObjectID.for_put() for _ in range(20)]
    hot = oids[0]
    store.put(hot, b"hot")
    store.get(hot)
    for oid in oids[1:]:
        store.put(oid, b"cold")
        store.get(oid)
        store.get(hot)  # keep the hot entry most recently used
    with store._lock:
        assert len(store._deser_cache) <= 8
        assert hot in store._deser_cache, "LRU must keep the hot entry"


def test_in_process_fetch_args_concurrent_and_ordered():
    ray_tpu.init(resources={"CPU": 4})
    try:
        refs = [ray_tpu.put(i) for i in range(6)]

        @ray_tpu.remote
        def gather(*xs):
            return list(xs)

        assert ray_tpu.get(gather.remote(*refs), timeout=60) == list(range(6))

        @ray_tpu.remote
        def boom():
            raise KeyError("dep")

        with pytest.raises(KeyError):
            ray_tpu.get(gather.remote(refs[0], boom.remote(), refs[1]),
                        timeout=60)
    finally:
        ray_tpu.shutdown()


# ====================== pubsub filters / per-oid wait lists ======================


def test_subscribe_object_locations_server_side_filter():
    """The GCS-side subscription filter: only the subscribed oids come
    back, and the cursor advances past filtered misses so they are never
    rescanned."""
    from ray_tpu_torch.core.gcs_server import GcsService

    svc = GcsService()
    try:
        a, b = b"a" * 28, b"b" * 28
        svc._publish("object_locations", (a, None, "addr1", 1))
        svc._publish("object_locations", (b, None, "addr2", 2))
        end, msgs = svc.subscribe_object_locations(0, 1.0, [a])
        assert end == 2 and [m[0] for m in msgs] == [a]
        # Filter matches nothing: empty reply, cursor consumed the misses.
        cur, msgs = svc.subscribe_object_locations(0, 0.1, [b"x" * 28])
        assert msgs == [] and cur == 2
        # Unfiltered subscribe keeps the firehose contract.
        end, msgs = svc.subscribe_object_locations(0, 1.0)
        assert [m[0] for m in msgs] == [a, b]
    finally:
        svc.shutdown()


def test_subscribe_object_locations_per_oid_wait_lists():
    """A parked filtered subscribe wakes ONLY when one of ITS oids seals:
    seals of other objects (which used to wake every parked poll on one
    condvar) leave it asleep, and generic channel polls park per channel."""
    import threading

    from ray_tpu_torch.core.gcs_server import GcsService

    svc = GcsService()
    try:
        target = b"c" * 28
        done = {}

        def park():
            done["r"] = svc.subscribe_object_locations(0, 10.0, [target])

        t = threading.Thread(target=park, daemon=True)
        t.start()
        time.sleep(0.2)
        for i in range(5):  # unrelated seals: the parked poll must not wake
            svc._publish("object_locations", (bytes([i]) * 28, None, "n", 1))
        svc._publish("node", ("ALIVE", "beef", "addr"))  # other channel too
        time.sleep(0.3)
        assert "r" not in done
        t0 = time.monotonic()
        svc._publish("object_locations", (target, None, "addr3", 3))
        t.join(timeout=5)
        assert not t.is_alive()
        assert time.monotonic() - t0 < 2.0
        cursor, msgs = done["r"]
        assert [m[0] for m in msgs] == [target]
        assert cursor == 6  # advanced past every filtered miss
    finally:
        svc.shutdown()
