"""JAX's remaining util, metrics-plane and flight-recorder tests on the port.

- ``TestActorPool`` and ``TestQueue`` of ``tests/test_util_and_state.py``
  on the port's ``util/actor_pool.py`` and ``util/queue.py`` over its
  in-process runtime;
- ``test_exporter_survives_gcs_outage`` and
  ``test_exporter_disabled_by_knob`` of ``tests/test_metrics_plane.py`` on
  the port's ``MetricsExporter``;
- ``TestRing::test_ring_survives_sigkill`` of ``tests/test_flightrec.py``
  on the port's ring, written by a process that imports the port only;
- ``TestMetrics``, ``TestCli`` (with the port's ``--num-gpus`` and its
  ``bench`` refusal) and ``test_cross_process_trace_propagation`` of
  ``tests/test_util_and_state.py``, and the rest of
  ``tests/test_metrics_plane.py``: its module units, the cursor'd task
  events, the span clock, the in-process phase histograms and the merged
  exposition through the dashboard (with ``process_meta`` against JAX's).

Then the port's util package exports what JAX's does.
"""

import pathlib
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

REPO = str(pathlib.Path(__file__).resolve().parent.parent)


@pytest.fixture
def ray_start_regular():
    ray_tpu.init(resources={"CPU": 4})
    yield ray_tpu
    ray_tpu.shutdown()


class TestActorPool:
    def test_map_ordered(self, ray_start_regular):
        @ray_tpu.remote
        class Worker:
            def double(self, x):
                return x * 2

        pool = ActorPool([Worker.remote() for _ in range(2)])
        out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
        assert out == [x * 2 for x in range(8)]

    def test_map_unordered_complete(self, ray_start_regular):
        import time as _t

        @ray_tpu.remote
        class Worker:
            def work(self, x):
                _t.sleep(0.01 * (x % 3))
                return x

        pool = ActorPool([Worker.remote() for _ in range(3)])
        out = list(pool.map_unordered(lambda a, v: a.work.remote(v), range(9)))
        assert sorted(out) == list(range(9))

    def test_submit_more_than_actors(self, ray_start_regular):
        @ray_tpu.remote
        class Worker:
            def f(self, x):
                return x + 1

        pool = ActorPool([Worker.remote()])
        for i in range(5):
            pool.submit(lambda a, v: a.f.remote(v), i)
        results = [pool.get_next() for _ in range(5)]
        assert results == [1, 2, 3, 4, 5]


class TestQueue:
    def test_fifo_and_batch(self, ray_start_regular):
        q = Queue()
        for i in range(5):
            q.put(i)
        assert q.qsize() == 5
        assert [q.get() for _ in range(5)] == list(range(5))
        q.put_nowait_batch([10, 11, 12])
        assert q.get_nowait_batch(3) == [10, 11, 12]
        q.shutdown()

    def test_empty_and_full(self, ray_start_regular):
        q = Queue(maxsize=2)
        with pytest.raises(Empty):
            q.get_nowait()
        q.put(1)
        q.put(2)
        with pytest.raises(Full):
            q.put_nowait(3)
        assert q.full()
        q.shutdown()

    def test_cross_actor_queue(self, ray_start_regular):
        q = Queue()

        @ray_tpu.remote
        def producer(q, n):
            for i in range(n):
                q.put(i)
            return True

        assert ray_tpu.get(producer.remote(q, 4))
        assert [q.get(timeout=5) for _ in range(4)] == [0, 1, 2, 3]
        q.shutdown()


# -- the metrics plane's exporter ---------------------------------------------


def test_exporter_survives_gcs_outage():
    """Reports raising (GCS down/restarting) are swallowed and the next
    tick re-registers the full snapshot — no crash, no thread death."""
    from ray_tpu_torch.core.config import Config, set_config
    from ray_tpu_torch.core.metrics_export import MetricsExporter
    from ray_tpu_torch.core.rpc import RpcConnectionError

    set_config(Config({"metrics_export_interval_s": 0.05}))
    try:
        got = []
        calls = {"n": 0}

        def report(node_id, component, pid, snapshot):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RpcConnectionError("gcs restarting")
            got.append((node_id, component, pid, snapshot))

        exp = MetricsExporter(report, node_id="n1",
                              component="worker").start()
        try:
            deadline = time.time() + 10
            while not got and time.time() < deadline:
                time.sleep(0.02)
            assert got, "exporter never recovered after failed reports"
            node_id, component, pid, snapshot = got[0]
            assert (node_id, component) == ("n1", "worker")
            assert isinstance(snapshot, list)
        finally:
            exp.stop()
    finally:
        set_config(None)    # back to the environment's knobs


def test_exporter_disabled_by_knob():
    from ray_tpu_torch.core.config import Config, set_config
    from ray_tpu_torch.core.metrics_export import (MetricsExporter,
                                                   metrics_enabled)

    set_config(Config({"metrics_export_enabled": False}))
    try:
        assert not metrics_enabled()
        exp = MetricsExporter(lambda *a: (_ for _ in ()).throw(
            AssertionError("must not report")), "n", "driver").start()
        assert exp._thread is None
        exp.stop()
    finally:
        set_config(None)    # back to the environment's knobs


# -- the flight recorder's ring -----------------------------------------------


class TestRing:
    def test_ring_survives_sigkill(self, tmp_path):
        """The kernel owns the dirty mmap pages: a SIGKILLed process's last
        events are readable with no flush having ever run."""
        path = str(tmp_path / "victim-0.ring")
        code = (
            "import os, signal\n"
            "from ray_tpu_torch.util import flightrec\n"
            f"rec = flightrec.FlightRecorder({path!r}, 'victim', ring_kb=8)\n"
            "rec.record('task', 't-9', 'start doomed')\n"
            "rec.record('lease', 'blk-3', 'carve free=1')\n"
            "os.kill(os.getpid(), signal.SIGKILL)\n"
        )
        root = pathlib.Path(__file__).resolve().parents[1]
        proc = subprocess.run([sys.executable, "-c", code], cwd=str(root))
        assert proc.returncode == -signal.SIGKILL
        ring = flightrec.read_ring(path)
        assert ring["written"] == 2
        details = [e["detail"] for e in ring["events"]]
        assert "start doomed" in details[0]
        # No orderly shutdown record — the process never got to say goodbye.
        assert not any("shutdown" in d for d in details)


def test_util_package_exports_what_jax_does():
    import ray_tpu.util as jutil

    import ray_tpu_torch.util as tutil

    assert tutil.__all__ == jutil.__all__
    assert (tutil.ActorPool, tutil.Queue, tutil.Empty, tutil.Full) == (
        ActorPool, Queue, Empty, Full)


# -- JAX's metrics-plane, metrics, CLI and cross-process trace tests ----------
from ray_tpu_torch.util import metrics as um  # noqa: E402


class TestMetrics:
    """``tests/test_util_and_state.py::TestMetrics``."""

    def test_counter_gauge_histogram(self):
        c = um.Counter("test_requests", tag_keys=("route",))
        c.inc(1.0, {"route": "/a"})
        c.inc(2.0, {"route": "/a"})
        assert c.get({"route": "/a"}) == 3.0
        with pytest.raises(ValueError):
            c.inc(0)

        g = um.Gauge("test_inflight")
        g.set(7)
        assert g.get() == 7.0

        h = um.Histogram("test_latency", boundaries=[0.1, 1.0])
        h.observe(0.05)
        h.observe(0.5)
        h.observe(5.0)
        text = um.prometheus_text()
        assert 'test_requests{route="/a"} 3.0' in text
        assert "test_latency_bucket" in text
        assert 'le="+Inf"} 3' in text

    def test_invalid_tags_rejected(self):
        g = um.Gauge("test_tagged", tag_keys=("k",))
        with pytest.raises(ValueError):
            g.set(1.0, {"other": "x"})


# ``tests/test_metrics_plane.py``: the module units, the cursor'd task events,
# the span clock and the in-process phase histograms.
def test_histogram_bisect_bucketing():
    h = um.Histogram("t_hist_bisect", boundaries=[1.0, 5.0, 10.0])
    for v in (0.5, 1.0, 1.5, 5.0, 7.0, 11.0, 1e9):
        h.observe(v)
    snap = h._snapshot()
    assert snap["type"] == "histogram" and snap["bounds"] == [1.0, 5.0, 10.0]
    [(tags, (buckets, total_sum, count))] = snap["samples"]
    # value <= bound semantics: 0.5,1.0 | 1.5,5.0 | 7.0 | 11.0,1e9 (+Inf)
    assert buckets == [2, 2, 1, 2]
    assert count == 7
    lines = h._prom_lines()
    assert any(line.endswith(" 2") and 'le="1.0"' in line for line in lines)
    assert any(line.endswith(" 5") and 'le="10.0"' in line for line in lines)
    assert any(line.endswith(" 7") and 'le="+Inf"' in line for line in lines)


def test_histogram_rejects_unsorted_bounds():
    with pytest.raises(ValueError):
        um.Histogram("t_hist_bad", boundaries=[5.0, 1.0])


def test_label_value_escaping():
    g = um.Gauge("t_gauge_escape", tag_keys=("path",))
    g.set(1.0, {"path": 'a\\b"c\nd'})
    [line] = [ln for ln in g._prom_lines() if not ln.startswith("#")]
    assert 'path="a\\\\b\\"c\\nd"' in line
    # and the escaped form survives the aggregator's merged rendering
    agg = um.MetricsAggregator()
    agg.report("n1", "driver", 1, [g._snapshot()])
    assert 'path="a\\\\b\\"c\\nd"' in agg.prometheus_text()


def test_aggregator_merges_processes_with_identity_labels():
    c = um.Counter("t_agg_counter", tag_keys=("op",))
    c.inc(3, {"op": "x"})
    snap = [c._snapshot()]
    agg = um.MetricsAggregator()
    agg.report("node-a", "worker", 11, snap)
    agg.report("node-b", "node_daemon", 22, snap)
    text = agg.prometheus_text()
    assert text.count("# TYPE t_agg_counter counter") == 1
    assert 'component="worker"' in text and 'component="node_daemon"' in text
    assert 'node_id="node-a"' in text and 'pid="22"' in text
    summ = agg.summary()
    assert len(summ["processes"]) == 2
    [row] = [m for m in summ["metrics"] if m["name"] == "t_agg_counter"]
    assert row["series"] == 2 and row["total"] == 6.0


def test_aggregator_staleness_eviction():
    g = um.Gauge("t_agg_stale")
    g.set(1.0)
    agg = um.MetricsAggregator()
    now = time.time()
    agg.report("dead-node", "worker", 1, [g._snapshot()], now=now - 3600)
    agg.report("live-node", "worker", 2, [g._snapshot()], now=now)
    text = agg.prometheus_text(now=now)
    assert "live-node" in text and "dead-node" not in text
    assert len(agg.summary(now=now)["processes"]) == 1


def test_aggregator_process_meta_keeps_stale_reports_and_beacons():
    """The health watchdog's read (``process_meta``, which the port's
    aggregator lacked, so the GCS's watchdog tick failed every period):
    every report held, one past the watchdog's stall bound too, with its
    flight-recorder beacon."""
    from ray_tpu.util import metrics as jax_um

    beacon = um.Gauge("ray_tpu_flightrec_last_write_ts")
    beacon.set(1234.5)
    mine, theirs = um.MetricsAggregator(), jax_um.MetricsAggregator()
    now = time.time()
    for agg in (mine, theirs):
        agg.report("n1", "worker", 7, [beacon._snapshot()], now=now - 20)
        agg.report("n1", "driver", 8, [], now=now)
    assert sorted(mine.process_meta()) == sorted(theirs.process_meta()) == [
        (("n1", "driver", 8), now, None),
        (("n1", "worker", 7), now - 20, 1234.5)]


def test_collector_hooks_run_before_snapshot():
    g = um.Gauge("t_collected")
    unregister = um.register_collector(lambda: g.set(42.0))
    try:
        snap = um.snapshot_registry()
        [m] = [m for m in snap if m["name"] == "t_collected"]
        assert m["samples"] == [((), 42.0)]
    finally:
        unregister()


def test_task_events_since_cursor():
    from ray_tpu_torch.core.gcs import GlobalControlStore

    store = GlobalControlStore()
    for i in range(10):
        store.record_task_event({"task_id": f"t{i}"})
    cur, evs = store.task_events_since(0, limit=4)
    assert [e["task_id"] for e in evs] == ["t0", "t1", "t2", "t3"]
    assert cur == 4
    cur, evs = store.task_events_since(cur, limit=100)
    assert len(evs) == 6 and cur == 10
    cur2, evs2 = store.task_events_since(cur)
    assert evs2 == [] and cur2 == 10
    cur3, tail = store.task_events_since(None, limit=3)
    assert [e["task_id"] for e in tail] == ["t7", "t8", "t9"] and cur3 == 10
    cur4, evs4 = store.task_events_since(99999)
    assert evs4 == [] and cur4 == 10
    assert len(store.task_events()) == 10


def test_task_events_since_survives_truncation():
    from ray_tpu_torch.core.gcs import GlobalControlStore

    store = GlobalControlStore()
    store._task_events = [{"task_id": f"t{i}"} for i in range(100)]
    store._task_event_base = 0
    with store._lock:
        drop = 50
        del store._task_events[:drop]
        store._task_event_base += drop
    cur, evs = store.task_events_since(10, limit=5)
    assert [e["task_id"] for e in evs] == ["t50", "t51", "t52", "t53", "t54"]
    assert cur == 55


def test_span_duration_uses_monotonic_clock():
    from unittest import mock

    from ray_tpu_torch.util import tracing

    class _GcsSink:
        def __init__(self):
            self.events = []

        def record_task_event(self, e):
            self.events.append(e)

    class _Rt:
        gcs = _GcsSink()

    rt = _Rt()
    with mock.patch.object(tracing.time, "time", return_value=1234.0):
        with tracing.span("probe", runtime=rt):
            time.sleep(0.05)
    [event] = rt.gcs.events
    assert event["time"] == 1234.0
    assert event["duration"] >= 0.04


def test_phase_histograms_and_summary_in_process(ray_start_regular):
    @ray_tpu.remote
    def work(x):
        return x + 1

    assert ray_tpu.get([work.remote(i) for i in range(4)]) == [1, 2, 3, 4]
    from ray_tpu_torch.core.runtime import get_runtime

    rt = get_runtime()
    rt._metrics_exporter.flush()
    text = rt.gcs.metrics_text()
    assert "ray_tpu_task_phase_s_bucket" in text
    for phase in ("queued", "args_fetch", "execute", "total"):
        assert f'phase="{phase}"' in text
    assert 'component="driver"' in text
    evs = [e for e in rt.gcs.task_events() if e.get("phases")]
    assert evs and "execute" in evs[-1]["phases"]
    summ = rt.gcs.metrics_summary()
    assert summ["processes"] and summ["metrics"]


# ``tests/test_util_and_state.py::TestCli`` on the port's CLI, with the
# port's own rules: --num-gpus (--num-tpus its alias) and a bench that says
# it is not written yet and runs nothing.
def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", *args],
        capture_output=True, text=True, timeout=120, cwd=REPO)


class TestCli:
    def test_status_and_list(self):
        import json

        out = _cli("--num-cpus", "2", "status")
        assert out.returncode == 0, out.stderr
        data = json.loads(out.stdout[out.stdout.index("{"):])
        assert data["alive_nodes"] >= 1
        out = _cli("--num-cpus", "2", "--num-tpus", "0", "list", "nodes")
        assert out.returncode == 0, out.stderr
        [node] = json.loads(out.stdout[out.stdout.index("["):])
        assert node["resources_total"]["CPU"] == 2.0
        assert node["resources_total"].get("GPU", 0) == 0

    def test_num_gpus_and_its_alias_reach_init(self, monkeypatch):
        from ray_tpu_torch import scripts
        from ray_tpu_torch.util import state

        seen = []
        monkeypatch.setattr(ray_tpu, "init", lambda **kw: seen.append(kw))
        monkeypatch.setattr(state, "summarize_tasks", lambda: {})
        for flag in ("--num-gpus", "--num-tpus"):
            assert scripts.main(["--num-cpus", "1", flag, "1", "summary",
                                 "tasks"]) == 0
        assert [kw["num_gpus"] for kw in seen] == [1.0, 1.0]
        assert all("num_tpus" not in kw for kw in seen)

    def test_bench_refuses_and_runs_nothing(self):
        out = _cli("bench")
        assert out.returncode != 0
        assert "not written yet" in out.stderr
        assert out.stdout == ""


# ``tests/test_util_and_state.py::test_cross_process_trace_propagation`` and
# ``tests/test_metrics_plane.py::test_cluster_metrics_merged_exposition_and_
# dashboard``, on one cluster exporting every 0.3 s (the second restarts its
# GCS, so it runs last).
@pytest.fixture(scope="module")
def metrics_cluster():
    import os

    from ray_tpu_torch.core import runtime as runtime_mod
    from ray_tpu_torch.core.cluster import Cluster, connect
    from ray_tpu_torch.core.config import Config, set_config

    from torch_time_limit import time_limit

    env = {"RAY_TPU_METRICS_EXPORT_INTERVAL_S": "0.3", "OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    set_config(Config())  # the driver adopts the fast cadence too
    try:
        with time_limit(120, "the module's cluster start"):
            cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 1})
            core = connect(cluster.gcs_address)
        yield cluster, core
        core.shutdown()
        runtime_mod._global_runtime = None
        cluster.shutdown()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        set_config(Config())


def test_cross_process_trace_propagation(metrics_cluster):
    """A task tree submitted under a driver span shares one trace_id across
    processes, parent links form the chain, and worker-side events reach
    the timeline through the batched task-event pipeline."""
    from ray_tpu_torch.util import tracing

    _cluster, core = metrics_cluster

    @ray_tpu.remote
    def child():
        return "leaf"

    @ray_tpu.remote
    def parent_task():
        return ray_tpu.get(child.remote(), timeout=120)

    with tracing.span("root", runtime=core) as (trace_id, root_span):
        assert ray_tpu.get(parent_task.remote(), timeout=240) == "leaf"

    def by_suffix():
        out = {}
        for e in ray_tpu.timeline():
            for want in ("root", "parent_task", "child"):
                if e["name"] == want or e["name"].endswith(want):
                    out[want] = e
        return out

    deadline = time.time() + 15
    while time.time() < deadline:
        named = by_suffix()
        if {"root", "parent_task", "child"} <= set(named):
            break
        time.sleep(0.5)
    named = by_suffix()
    assert {"root", "parent_task", "child"} <= set(named), named.keys()
    p = named["parent_task"]["args"]
    c = named["child"]["args"]
    assert p["trace_id"] == trace_id
    assert c["trace_id"] == trace_id
    assert p["parent_span_id"] == root_span
    assert c["parent_span_id"] is not None
    assert c["parent_span_id"] != root_span


def test_cluster_metrics_merged_exposition_and_dashboard(metrics_cluster):
    """Dashboard /metrics returns the merged exposition with >= 2 distinct
    components and populated task phase histograms after a multi-process
    workload; the exporter pipeline survives a GCS restart."""
    import socket
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard

    cluster, core = metrics_cluster

    def get(url):
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.read().decode()

    @ray_tpu.remote
    def work(x):
        return x * 2

    assert ray_tpu.get([work.remote(i) for i in range(6)],
                       timeout=120) == [0, 2, 4, 6, 8, 10]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dash = start_dashboard(port=port)
    try:
        deadline = time.time() + 60
        text = ""
        while time.time() < deadline:
            text = get(f"{dash.url}/metrics")
            comps = {seg.split('"')[0]
                     for seg in text.split('component="')[1:]}
            if ({"worker", "node_daemon"} <= comps
                    and "ray_tpu_task_phase_s_bucket" in text):
                break
            time.sleep(0.5)
        assert {"worker", "node_daemon"} <= comps, text[:2000]
        assert "ray_tpu_task_phase_s_bucket" in text
        assert 'phase="execute"' in text
        assert text.count("# TYPE ray_tpu_task_phase_s ") == 1

        import json

        summ = json.loads(get(f"{dash.url}/api/metrics_summary"))
        comps = {p["component"] for p in summ["processes"]}
        assert {"worker", "node_daemon", "gcs"} <= comps
        daemon_nodes = {p["node_id"] for p in summ["processes"]
                        if p["component"] == "node_daemon"}
        assert len(daemon_nodes) == 2
        assert "renderMetrics" in get(f"{dash.url}/")

        # GCS restart: exporters keep notifying and re-register on the
        # fresh aggregator — series reappear, nothing crashes.
        cluster.kill_gcs()
        cluster.restart_gcs()
        deadline = time.time() + 60
        comps = set()
        while time.time() < deadline:
            try:
                summ = core.gcs.metrics_summary()
            except Exception:  # noqa: BLE001 — GCS still rebinding
                time.sleep(0.5)
                continue
            comps = {p["component"] for p in summ["processes"]}
            if "node_daemon" in comps:
                break
            time.sleep(0.5)
        assert "node_daemon" in comps, comps
    finally:
        dash.stop()
