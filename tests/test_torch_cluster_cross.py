"""The port's cluster modules against the JAX package's, on the same inputs.

- ``gcs_shards``: the same keys route to the same shard at every shard
  count (hypothesis), and the sharded object directory and pubsub give the
  same answers to one sequence of calls;
- ``LocalLeaseTable``: the same carve, release, revoke, sweep and unsweep
  sequences (hypothesis) give the same outcomes and the same free units;
- ``HealthWatchdog``: the same heartbeat and report traces give the same
  transitions and states;
- ``SpecEncoder``/``SpecTemplateStore``: a spec encoded by either package
  and decoded by the same package gives the same fields (the template bytes
  differ by module path, so fields are compared, not bytes), and a cache
  miss is raised alike;
- the knobs the cluster modules read have JAX's names and defaults.
"""

import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_tpu.core import config as jcfg
from ray_tpu.core import gcs_shards as jshards
from ray_tpu.core import health as jhealth
from ray_tpu.core import ids as jids
from ray_tpu.core import lease_table as jlease
from ray_tpu.core import task_spec as jspec
from ray_tpu_torch.core import config as tcfg
from ray_tpu_torch.core import gcs_shards as tshards
from ray_tpu_torch.core import health as thealth
from ray_tpu_torch.core import ids as tids
from ray_tpu_torch.core import lease_table as tlease
from ray_tpu_torch.core import task_spec as tspec

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

# -- gcs_shards -----------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(keys=st.lists(st.one_of(st.binary(max_size=40),
                               st.text(max_size=40)), max_size=20),
       n=st.integers(1, 64))
def test_shard_routing_is_the_same(keys, n):
    assert ([tshards.shard_index(k, n) for k in keys]
            == [jshards.shard_index(k, n) for k in keys])


def _directory_trace(shards_mod, ids_mod, n):
    d = shards_mod.ShardedObjectDirectory(n, lineage_cap=4)
    nodes = [ids_mod.NodeID(bytes([i]) * ids_mod.NodeID.SIZE)
             for i in range(3)]
    oids = [bytes([i]) * 20 for i in range(6)]
    out = []
    for i, oid in enumerate(oids):
        d.add_location(oid, nodes[i % 3], 100 + i)
        if i % 2:
            d.add_location(oid, nodes[(i + 1) % 3], 100 + i)
        d.add_lineage(oid, b"lineage-%d" % i)
    d.remove_location(oids[1], nodes[1])
    d.drop_node(nodes[2])
    out.append(sorted((n.hex(), s) for n, s in d.pop_object(oids[4]).items()))
    for oid in oids:
        out.append(sorted((n.hex(), s) for n, s in d.locations(oid).items()))
        out.append(d.get_lineage(oid))
    return out


@pytest.mark.parametrize("n", [1, 3, 8])
def test_object_directory_answers_the_same(n):
    assert (_directory_trace(tshards, tids, n)
            == _directory_trace(jshards, jids, n))


def _pubsub_trace(shards_mod, n):
    ps = shards_mod.ShardedPubSub(n)
    out = []
    for i in range(10):
        ps.publish(f"ch{i % 3}", {"i": i})
    for ch in ("ch0", "ch1", "ch2", "none"):
        cursor, msgs = ps.poll(ch, 0, timeout=0.0)
        out.append((ch, cursor, msgs, ps.end_cursor(ch)))
        cursor2, msgs2 = ps.poll(ch, max(0, cursor - 1), timeout=0.0)
        out.append((ch, cursor2, msgs2))
    return out


@pytest.mark.parametrize("n", [1, 4])
def test_pubsub_answers_the_same(n):
    assert _pubsub_trace(tshards, n) == _pubsub_trace(jshards, n)


# -- LocalLeaseTable --------------------------------------------------------------

_OPS = st.lists(st.tuples(
    st.sampled_from(["adopt", "carve", "carve_hint", "release", "revoke",
                     "sweep", "unsweep", "release_again"]),
    st.integers(0, 2), st.integers(1, 4)), max_size=40)


def _lease_trace(mod, ops):
    t = mod.LocalLeaseTable()
    leases = []
    out = []
    for op, b, n in ops:
        block = f"cap-{b}"
        if op == "adopt":
            out.append(t.adopt(block, {"CPU": 1.0}, n))
        elif op == "carve":
            lid = t.carve(block)
            out.append(lid)
            if lid:
                leases.append(lid)
        elif op == "carve_hint":
            lid = t.carve(block, shape={"CPU": 1.0}, total=n)
            out.append(lid)
            if lid:
                leases.append(lid)
        elif op in ("release", "release_again") and leases:
            lid = leases[n % len(leases)]
            if op == "release":
                leases.remove(lid)
            out.append(t.release(lid))
        elif op == "revoke":
            out.append(t.revoke(block))
        elif op == "sweep":
            out.append(sorted(t.sweep_idle(0.0)))
        elif op == "unsweep":
            out.append(t.unsweep(block, 1))
        out.append(tuple(t.free_units(f"cap-{i}") for i in range(3)))
        out.append(sorted((k, sorted(v.items())) for k, v in
                          t.stats().items()))
    return out


@settings(max_examples=150, deadline=None)
@given(ops=_OPS)
def test_lease_table_outcomes_are_the_same(ops):
    assert _lease_trace(tlease, ops) == _lease_trace(jlease, ops)


def test_lease_ids_are_the_same():
    assert tlease.is_block_lease("cap-3#1") == jlease.is_block_lease("cap-3#1")
    assert tlease.is_block_lease("plain") == jlease.is_block_lease("plain")
    assert tlease.block_of("cap-3#1") == jlease.block_of("cap-3#1")


# -- HealthWatchdog ---------------------------------------------------------------

_TRACE = st.lists(st.tuples(
    st.dictionaries(st.sampled_from(["n0", "n1", "n2"]),
                    st.floats(0.0, 20.0), max_size=3),
    st.sets(st.sampled_from(["n0", "n1", "n2"]), max_size=1),
    st.lists(st.tuples(st.sampled_from(["n0", "n1"]),
                       st.sampled_from(["worker", "node_daemon"]),
                       st.integers(1, 3), st.floats(0.0, 60.0)),
             max_size=3),
    st.floats(0.0, 700.0)), min_size=1, max_size=12)


def _health_trace(mod, trace):
    seen = []
    wd = mod.HealthWatchdog(on_transition=seen.append, dead_retention_s=600)
    now = 1000.0
    out = []
    for ages, dead, comps, step in trace:
        now += step
        components = [((node, comp, pid), now - age, None)
                      for node, comp, pid, age in comps]
        trs = wd.tick(node_ages=ages, dead_nodes=set(dead),
                      components=components, node_bounds=(2.5, 5.0),
                      comp_bounds=(25.0, 50.0), now=now)
        out.append([(t["kind"], t["key"], t["old"], t["new"]) for t in trs])
        out.append(sorted((tuple(s["key"]), s["state"])
                          for s in wd.states()))
    out.append([(t["kind"], t["key"], t["old"], t["new"]) for t in seen])
    return out


@settings(max_examples=150, deadline=None)
@given(trace=_TRACE)
def test_health_watchdog_decides_the_same(trace):
    assert _health_trace(thealth, trace) == _health_trace(jhealth, trace)


@pytest.mark.parametrize("age", [None, 0.0, 2.5, 2.6, 5.0, 5.1])
def test_health_classify_is_the_same(age):
    assert thealth.classify(age, 2.5, 5.0) == jhealth.classify(age, 2.5, 5.0)


# -- the cached spec encoding -----------------------------------------------------


def _spec(mod, ids_mod, i, actor=False):
    job = ids_mod.JobID.from_int(7)
    actor_id = ids_mod.ActorID(job.binary() + bytes([i % 3]) * 12)
    task = ids_mod.TaskID(actor_id.binary() + bytes([i]) * 8)
    opts = mod.TaskOptions(name=f"f{i % 2}", num_returns=1 + i % 2,
                           resources={"CPU": 1.0}, max_retries=i % 4)
    return mod.TaskSpec(
        task_id=task, job_id=job,
        task_type=mod.TaskType.ACTOR_TASK if actor
        else mod.TaskType.NORMAL_TASK,
        function_id=f"fn-{i % 2}", function_name=f"f{i % 2}",
        args=[mod.TaskArg(value=i), mod.TaskArg(value=[i, "x"])],
        kwargs={"k": mod.TaskArg(value={"i": i})}, options=opts,
        actor_id=actor_id if actor else None,
        actor_method="m" if actor else None, sequence_number=i,
        caller_id="caller", window_min=i - 1, attempt_number=i % 2,
        owner_addr="127.0.0.1:1", trace_ctx=("t", f"s{i}"),
        submit_ts=123.0 + i)


def _fields(spec):
    return (spec.task_id.binary(), spec.job_id.binary(),
            spec.task_type.value, spec.function_id, spec.function_name,
            [(a.value, a.object_id, a.owner_addr) for a in spec.args],
            {k: (a.value, a.object_id, a.owner_addr) for k, a in spec.kwargs.items()},
            (spec.options.name, spec.options.num_returns,
             dict(spec.options.resources), spec.options.max_retries),
            spec.actor_id.binary() if spec.actor_id else None,
            spec.actor_method, spec.sequence_number, spec.caller_id,
            spec.window_min, spec.attempt_number, spec.owner_addr,
            spec.trace_ctx, spec.submit_ts)


def _round_trip(mod, ids_mod, actor):
    enc, store = mod.SpecEncoder(cap=4), mod.SpecTemplateStore(cap=4)
    out = []
    for i in range(6):
        spec = _spec(mod, ids_mod, i, actor)
        digest, blob = enc.encode_template(spec)
        store.register(digest, blob)
        out.append(_fields(store.decode((digest, enc.encode_vars(spec)))))
    out.append((enc.encode_hits, enc.encode_misses))
    with pytest.raises(mod.SpecCacheMiss):
        store.decode((b"\0" * 16, enc.encode_vars(spec)))
    return out


@pytest.mark.parametrize("actor", [False, True])
def test_spec_encoding_decodes_the_same_fields(actor):
    assert (_round_trip(tspec, tids, actor)
            == _round_trip(jspec, jids, actor))


# -- knobs ------------------------------------------------------------------------

CLUSTER_KNOBS = (
    "max_inline_object_size", "gcs_snapshot_mirrors", "pull_chunk_size",
    "whole_frame_fetch_max", "pull_chunk_concurrency", "pull_memory_budget",
    "stripe_min_size", "location_sub_enabled", "idle_lease_ttl_s",
    "max_workers_per_node", "prestart_workers_per_node",
    "gang_scheduling_enabled", "topology_labels", "sim_hosts_per_slice",
    "sim_slices_per_pod", "sim_heartbeat_period_s",
    "memory_monitor_threshold", "memory_monitor_period_s",
    "health_check_period_s", "health_check_failure_threshold",
    "health_stall_factor", "streaming_backpressure_items",
    "lease_batch_enabled", "lease_batch_max", "lease_requester_threads",
    "gcs_ingest_async_enabled", "gcs_ingest_queue_max",
    "rpc_connect_timeout_s", "get_timeout_warn_s", "rpc_coalesce_window_us",
    "rpc_max_batch_frames", "rpc_max_batch_bytes", "spec_cache_size",
    "trace_rpc_enabled", "object_store_memory", "native_store_threshold",
    "use_native_store", "gcs_shards", "metrics_export_interval_s")


@pytest.mark.parametrize("knob", CLUSTER_KNOBS)
def test_cluster_knob_has_jax_name_and_default(knob):
    port, jax_table = tcfg.Config(), jcfg.Config()
    assert getattr(port, knob) == getattr(jax_table, knob)
    assert type(getattr(port, knob)) is type(getattr(jax_table, knob))


def test_every_port_knob_is_a_jax_knob():
    jax_knobs = set(jcfg.Config().to_dict())
    assert set(tcfg.Config().to_dict()) <= jax_knobs
