"""The port's core runtime against the JAX package's, on the same inputs.

- ``ids``: every derivation (job, actor, task, object ids and their
  embedded parents) byte for byte;
- ``ResourceSet``/``NodeResources`` arithmetic on generated resource bags
  (hypothesis), exact in both;
- the scheduler: the same request sequence over the same nodes, under one
  ``random`` seed, picks the same nodes and leaves the same availability;
- serialization: ``SerializedObject.to_bytes`` of plain and numpy data is
  the same blob from both, and each package reads the other's;
- ``observe_task_phases`` through a runtime: one workload (tasks, a failing
  task, actor calls) counts the same task states and phase observations;
- the GCS internal KV: the same shard routes and the same answers to one
  sequence of puts, deletes and reads, at 1, 3 and 8 shards.
"""

import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import ids as jids
from ray_tpu.core import metrics_export as jme
from ray_tpu.core import resources as jres
from ray_tpu.core import scheduler as jsched
from ray_tpu.core import serialization as jser
from ray_tpu.core import task_spec as jspec
from ray_tpu_torch.core import ids as tids
from ray_tpu_torch.core import metrics_export as tme
from ray_tpu_torch.core import resources as tres
from ray_tpu_torch.core import scheduler as tsched
from ray_tpu_torch.core import serialization as tser
from ray_tpu_torch.core import task_spec as tspec

# -- ids ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_id_derivations_byte_for_byte(seed):
    rng = random.Random(seed)
    job_n = rng.randrange(1, 2**31)
    actor_tail = bytes(rng.randrange(256) for _ in range(12))
    task_tail = bytes(rng.randrange(256) for _ in range(8))
    index = rng.randrange(0, 1000)
    out = []
    for ids in (jids, tids):
        job = ids.JobID.from_int(job_n)
        actor = ids.ActorID(job.binary() + actor_tail)
        task = ids.TaskID(actor.binary() + task_tail)
        obj = ids.ObjectID.for_task_return(task, index)
        out.append([job.binary(), actor.binary(), actor.job_id().binary(),
                    task.binary(), task.actor_id().binary(), obj.binary(),
                    obj.task_id().binary(), obj.return_index(),
                    ids.ActorID.nil().binary(), obj.hex(),
                    [c.SIZE for c in (ids.JobID, ids.NodeID, ids.WorkerID,
                                      ids.ActorID, ids.TaskID, ids.ObjectID,
                                      ids.PlacementGroupID)]])
        # The random derivations keep the layout: parents embedded.
        a2 = ids.ActorID.of(job)
        t2 = ids.TaskID.for_task(job, a2)
        assert a2.job_id() == job and t2.actor_id() == a2
        assert ids.TaskID.for_task(job).actor_id().is_nil()
    assert out[0] == out[1]


# -- resources ------------------------------------------------------------------

_NAMES = st.sampled_from(["CPU", "GPU", "memory", "GPU-H100", "custom"])
_QTY = st.integers(min_value=0, max_value=10**6).map(lambda n: n / 10_000)
_BAG = st.dictionaries(_NAMES, _QTY, max_size=5)


@settings(max_examples=200, deadline=None)
@given(a=_BAG, b=_BAG, c=_BAG)
def test_resource_set_arithmetic_matches(a, b, c):
    outs = []
    for res in (jres, tres):
        ra, rb, rc = res.ResourceSet(a), res.ResourceSet(b), res.ResourceSet(c)
        node = res.NodeResources(ra + rb, labels={"k": "v"})
        fits = node.can_fit(rc)
        if fits:
            node.allocate(rc)
        node.allocate(rb, force=True)  # may go negative, as in the JAX one
        outs.append([
            (ra + rb).to_dict(), (ra - rb).to_dict(), (ra + rb - rc).to_dict(),
            ra.is_subset_of(rb), rb.is_subset_of(ra + rb), ra.is_empty(),
            sorted(ra.names()), ra.get("GPU"), fits, node.available.to_dict(),
            node.is_feasible(rc), round(node.critical_utilization(), 12),
        ])
    assert outs[0] == outs[1]


def test_topology_vocabulary_matches():
    labels = tres.topology_labels("podA", "s3", tres.TIER_DCN)
    assert labels == jres.topology_labels("podA", "s3", jres.TIER_DCN)
    for lab in (labels, {}, {"topo.slice": "x"}):
        assert tres.topology_of(lab, "n1") == jres.topology_of(lab, "n1")
    slices = ["a", "a", "b", "c", "c", "c"]
    assert tres.cross_tier_edges(slices) == jres.cross_tier_edges(slices)


# -- scheduler ------------------------------------------------------------------


def _strategies(spec_mod, node_ids):
    return [
        spec_mod.DefaultSchedulingStrategy(),
        spec_mod.SpreadSchedulingStrategy(),
        spec_mod.NodeAffinitySchedulingStrategy(node_id=node_ids[2],
                                                soft=False),
        spec_mod.NodeAffinitySchedulingStrategy(node_id=node_ids[1],
                                                soft=True),
        spec_mod.NodeLabelSchedulingStrategy(hard={"zone": ["a", "b"]},
                                             soft={"zone": "b"}),
    ]


def _run_sequence(ids, res, sched_mod, spec_mod, seed):
    node_ids = [ids.NodeID(bytes([i]) * 16) for i in range(5)]
    sched = sched_mod.ClusterResourceScheduler()
    for i, nid in enumerate(node_ids):
        sched.add_node(nid, res.NodeResources(
            res.ResourceSet({"CPU": 4.0 + i, "GPU": float(i % 3)}),
            labels={"zone": "abc"[i % 3]}))
    strategies = _strategies(spec_mod, node_ids)
    rng = np.random.default_rng(seed)
    random.seed(seed)
    picks = []
    held = []
    for step in range(60):
        req = res.ResourceSet({"CPU": float(rng.integers(1, 3)),
                               "GPU": float(rng.integers(0, 2))})
        strat = strategies[int(rng.integers(len(strategies)))]
        preferred = node_ids[int(rng.integers(len(node_ids)))]
        nid = sched.best_node(req, strat, preferred)
        ok = nid is not None and sched.try_allocate(nid, req)
        picks.append((nid.binary() if nid is not None else None, ok))
        if ok:
            held.append((nid, req))
        if held and rng.random() < 0.3:
            n, r = held.pop(int(rng.integers(len(held))))
            sched.release(n, r)
    plan = sched.plan_gang([res.ResourceSet({"CPU": 1.0})] * 3)
    return (picks, sched.available_resources(),
            [n.binary() for n in plan] if plan else None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_node_choices_match(seed):
    want = _run_sequence(jids, jres, jsched, jspec, seed)
    got = _run_sequence(tids, tres, tsched, tspec, seed)
    assert got == want
    assert any(ok for _, ok in got[0]) and not all(ok for _, ok in got[0])


# -- serialization --------------------------------------------------------------


def _plain_values():
    rng = np.random.default_rng(3)
    return [
        {"a": 1, "b": [1.5, "x", None, True], "c": (b"\x00\x01", 2**70)},
        rng.standard_normal((64, 33)).astype(np.float32),
        {"ints": rng.integers(0, 2**40, 4096), "u8": np.arange(7, dtype=np.uint8),
         "nested": [np.zeros((2, 0)), np.ones(3, np.float16)]},
        list(range(1000)),
    ]


def _eq(x, y):
    if isinstance(x, np.ndarray):
        return (isinstance(y, np.ndarray) and x.dtype == y.dtype
                and np.array_equal(x, y))
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_eq(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return (type(x) is type(y) and len(x) == len(y)
                and all(_eq(a, b) for a, b in zip(x, y)))
    return x == y


@pytest.mark.parametrize("i", range(4))
def test_serialized_blobs_identical_and_cross_readable(i):
    value = _plain_values()[i]
    jblob = jser.serialize(value).to_bytes()
    tblob = tser.serialize(value).to_bytes()
    assert jblob == tblob
    assert tser.serialize(value).framed_size() == len(tblob)
    assert _eq(tser.loads(jblob), value)
    assert _eq(jser.loads(tblob), value)
    assert tser.dumps_inband(value) == jser.dumps_inband(value)
    assert _eq(jser.loads_inband(tser.dumps_inband(value)), value)


# -- task-phase metrics through a runtime ------------------------------------------


def _workload(pkg):
    @pkg.remote
    def square(x):
        return x * x

    @pkg.remote(max_retries=0)
    def boom():
        raise ValueError("boom")

    @pkg.remote
    class Acc:
        def __init__(self):
            self.n = 0

        def add(self, k):
            self.n += k
            return self.n

    assert pkg.get([square.remote(i) for i in range(7)]) == [
        i * i for i in range(7)]
    with pytest.raises(ValueError):
        pkg.get(boom.remote())
    a = Acc.remote()
    assert pkg.get([a.add.remote(1) for _ in range(5)])[-1] == 5


def _counts(me):
    snap = {"FINISHED": me.tasks_total().get({"state": "FINISHED"}),
            "FAILED": me.tasks_total().get({"state": "FAILED"})}
    h = me.task_phase_hist()._snapshot()
    for tags, (_buckets, _sum, count) in h["samples"]:
        snap[dict(tags)["phase"]] = count
    return snap


def test_observe_task_phases_counts_match():
    deltas = []
    for pkg, me, res in ((ray_tpu, jme, {"CPU": 4, "TPU": 8}),
                         (ray_tpu_torch, tme, {"CPU": 4, "GPU": 8})):
        pkg.init(resources=res)
        try:
            before = _counts(me)
            _workload(pkg)
            after = _counts(me)
        finally:
            pkg.shutdown()
        deltas.append({k: after.get(k, 0) - before.get(k, 0) for k in after})
    assert deltas[0] == deltas[1]
    assert deltas[1]["FINISHED"] == 12 and deltas[1]["FAILED"] == 1


# -- the GCS internal KV -----------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_gcs_kv_routes_and_behaves_like_jax(shards, monkeypatch):
    from ray_tpu.core import gcs_shards as jshards
    from ray_tpu.core.config import Config as JConfig
    from ray_tpu.core.config import set_config as jset
    from ray_tpu.core.gcs import GlobalControlStore as JGcs
    from ray_tpu_torch.core.gcs import GlobalControlStore as TGcs
    from ray_tpu_torch.core.gcs import shard_index

    keys = [f"k{i}" for i in range(40)] + ["", "ns\x00x", "é"]
    for k in keys:
        assert shard_index(k, shards) == jshards.shard_index(k, shards)
    monkeypatch.setenv("RAY_TPU_GCS_SHARDS", str(shards))
    jset(JConfig())
    try:
        out = []
        for store in (JGcs(), TGcs()):
            assert store.kv_shard_count() == shards
            ops = [store.kv_put(k, k.encode(), namespace=ns)
                   for k in keys for ns in ("a", "b")]
            ops.append(store.kv_put("k1", b"new", "a", overwrite=False))
            ops += [store.kv_del(k, "b") for k in keys[::3]]
            out.append((ops, sorted(store.kv_keys("k", "a")),
                        sorted(store.kv_keys("", "b")),
                        [store.kv_get(k, ns) for k in keys
                         for ns in ("a", "b")]))
        assert out[0] == out[1]
    finally:
        jset(JConfig())
