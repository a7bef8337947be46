"""The port's runtime checkers and postmortem reader against JAX's tests.

- ``test_devtools_lint.py``'s three ``lockcheck`` tests and
  ``test_devtools_lint2.py``'s three ``leakcheck`` tests, on
  ``ray_tpu_torch.devtools.lockcheck`` / ``leakcheck``;
- ``test_flightrec.py::TestPostmortem`` (4) on
  ``ray_tpu_torch.devtools.postmortem`` and the port's CLI;
- a ring written by JAX's ``flightrec`` read by the port's ``postmortem``,
  and the other way round: the two packages share the ``RTFR1`` format;
- the checkers' start-up hooks: the package import installs both when
  their env knobs are on (before its own module-level locks exist), and
  every cluster process (GCS, daemon, worker) runs instrumented;
- ``test_flightrec.py``'s cluster tests (a SIGSTOPped daemon flips
  ``stalled`` then ``healthy``; a SIGKILLed worker's ring; the chaos
  timeline through ``ray-tpu-torch debug``) on port ``Cluster``s.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import cloudpickle
import pytest

from ray_tpu.devtools import postmortem as jax_postmortem
from ray_tpu.util import flightrec as jax_flightrec

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.core.rpc import RpcClient
from ray_tpu_torch.devtools import leakcheck, lockcheck, postmortem
from ray_tpu_torch.util import flightrec

import torch_threads  # noqa: F401,E402  (one torch thread a test process)
from torch_time_limit import time_limit  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread_per_process(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _wait_for(predicate, timeout=60.0, interval=0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    return None


# -- lockcheck (tests/test_devtools_lint.py) ----------------------------------
@pytest.fixture
def checked():
    installed_before = lockcheck.installed()
    lockcheck.install(fresh_graph=not installed_before)
    before = len(lockcheck.violations())
    yield lockcheck
    # drop violations this test provoked on purpose, then restore state
    with lockcheck._state_lock:
        del lockcheck._violations[before:]
    if not installed_before:
        lockcheck.uninstall()


def test_lockcheck_catches_cross_thread_inversion(checked):
    A = threading.Lock()
    B = threading.Lock()
    caught = []

    def t1():
        with A:
            with B:
                pass

    def t2():
        try:
            with B:
                with A:
                    pass
        except lockcheck.LockOrderError as e:
            caught.append(e)

    th = threading.Thread(target=t1)
    th.start()
    th.join()
    th = threading.Thread(target=t2)
    th.start()
    th.join()
    assert caught, "inversion not raised"
    assert "inversion" in str(caught[0])
    assert any("inversion" in v for v in lockcheck.violations())


def test_lockcheck_consistent_order_and_reentrancy_ok(checked):
    A = threading.Lock()
    B = threading.Lock()
    R = threading.RLock()
    for _ in range(3):
        with A:
            with B:
                with R:
                    with R:  # reentrant: fine
                        pass
    cv = threading.Condition(A)
    hits = []

    def waiter():
        with cv:
            cv.wait(timeout=5.0)
            hits.append(1)

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.1)
    with cv:
        cv.notify_all()
    th.join()
    assert hits == [1]


def test_lockcheck_self_deadlock(checked):
    L = threading.Lock()
    with pytest.raises(lockcheck.LockOrderError, match="self-deadlock"):
        with L:
            L.acquire()


# -- leakcheck (tests/test_devtools_lint2.py) ---------------------------------
@pytest.fixture
def leak_installed():
    was = leakcheck.installed()
    leakcheck.install()
    yield leakcheck
    if not was:
        leakcheck.uninstall()


def test_leakcheck_names_thread_leak_with_site(leak_installed):
    before = leakcheck.snapshot()
    ev = threading.Event()
    t = threading.Thread(target=ev.wait, daemon=True, name="leaky-thread")
    t.start()
    try:
        leaks = leakcheck.check(before, settle_s=0.1)
        assert any("leaky-thread" in l for l in leaks), leaks
        # allocation site points at THIS file
        assert any("test_torch_devtools_runtime.py" in l for l in leaks), leaks
    finally:
        ev.set()
        t.join()
    assert leakcheck.check(before, settle_s=2.0) == []


def test_leakcheck_names_fd_leak_with_site(leak_installed):
    before = leakcheck.snapshot()
    fd = os.open("/tmp", os.O_RDONLY)
    try:
        leaks = leakcheck.check(before, settle_s=0.05)
        assert any(f"fd {fd}" in l for l in leaks), leaks
        assert any("os.open" in l and "test_torch_devtools_runtime.py" in l
                   for l in leaks), leaks
    finally:
        os.close(fd)
    assert leakcheck.check(before, settle_s=0.5) == []


def test_leakcheck_clean_teardown_is_clean(leak_installed):
    before = leakcheck.snapshot()
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    fd = os.open("/tmp", os.O_RDONLY)
    os.close(fd)
    import socket as socket_mod

    s = socket_mod.socket()
    s.close()
    assert leakcheck.check(before, settle_s=1.0) == []


def test_leakcheck_names_the_ports_arena(leak_installed):
    """The port's native arena (``rtpu_store_<pid>_...``) is an owned shm
    segment: one left after ``shutdown()`` is a leak, one removed is not."""
    before = leakcheck.snapshot()
    ray_tpu.init(resources={"CPU": 1})
    try:
        names = leakcheck._own_shm_names() - before.shm
        assert names and all(n.startswith(f"rtpu_store_{os.getpid()}_")
                             for n in names), names
        assert any("shm segment" in l for l in leakcheck.diff(before))
    finally:
        ray_tpu.shutdown()
    assert not any("shm segment" in l
                   for l in leakcheck.check(before, settle_s=2.0))


# -- the knobs and the start-up hooks -----------------------------------------
def test_knobs_have_jax_names_and_defaults():
    from ray_tpu.core.config import Config as JaxConfig

    from ray_tpu_torch.core.config import Config

    for knob in ("lock_order_check_enabled", "leak_check_enabled"):
        assert getattr(Config(), knob) is getattr(JaxConfig(), knob) is False
        assert getattr(Config({knob: True}), knob) is True


def test_package_import_installs_both_checkers_first():
    """With the env knobs on, ``import ray_tpu_torch`` instruments threading
    before its submodules create their module-level locks."""
    code = ("import threading\n"
            "import ray_tpu_torch\n"
            "from ray_tpu_torch.core import config, runtime\n"
            "from ray_tpu_torch.devtools import leakcheck, lockcheck\n"
            "assert lockcheck.installed() and leakcheck.installed()\n"
            "assert isinstance(config._lock, lockcheck.CheckedLock), "
            "type(config._lock)\n"
            "print('ok', 'jax' in __import__('sys').modules)\n")
    env = {**os.environ, "RAY_TPU_LOCK_ORDER_CHECK_ENABLED": "1",
           "RAY_TPU_LEAK_CHECK_ENABLED": "1", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["ok", "False"]
    env.pop("RAY_TPU_LOCK_ORDER_CHECK_ENABLED")
    env.pop("RAY_TPU_LEAK_CHECK_ENABLED")
    code = ("import ray_tpu_torch, sys\n"
            "assert 'ray_tpu_torch.devtools.lockcheck' not in sys.modules\n"
            "assert 'ray_tpu_torch.devtools.leakcheck' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("knob,module", [
    ("lock_order_check_enabled", lockcheck),
    ("leak_check_enabled", leakcheck)])
def test_maybe_install_reads_env_then_config(monkeypatch, knob, module):
    from ray_tpu_torch.core.config import Config, set_config

    was = module.installed()
    env = f"RAY_TPU_{knob.upper()}"
    try:
        monkeypatch.setenv(env, "0")
        assert module.maybe_install() is False
        monkeypatch.delenv(env)
        set_config(Config({knob: True}))
        assert module.maybe_install() is True and module.installed()
    finally:
        set_config(Config())
        if not was:
            module.uninstall()


# -- postmortem (tests/test_flightrec.py::TestPostmortem) ---------------------
class TestPostmortem:
    def test_build_and_format(self, tmp_path):
        rec = flightrec.FlightRecorder(
            str(tmp_path / f"driver-{os.getpid()}.ring"), "driver")
        rec.record("task", "t-1", "start f trace=cafe01")
        rec.record("serve", "echo", "admit -> r0 trace=cafe01")
        rec.record("process", "driver", "shutdown")
        rec.close()
        gcs_events = [
            {"type": "health_transition", "kind": "node", "subject": "n1",
             "old": "healthy", "new": "dead", "time": time.time()},
            {"state": "FINISHED", "name": "f", "time": time.time(),
             "trace_id": "cafe01"},
        ]
        tl = postmortem.build_timeline(
            session_dir=str(tmp_path), gcs_events=gcs_events,
            health_states=[{"kind": "node", "key": ["node", "n1"],
                            "state": "dead"}])
        proc = tl["processes"][0]
        assert proc["alive"] and proc["component"] == "driver"
        # Trace cross-link spans the ring AND the GCS side table.
        assert len(tl["traces"]["cafe01"]) == 3
        linked = postmortem.events_for_trace(tl, "cafe01")
        assert {e["process"] for e in linked} == {
            f"driver:{os.getpid()}", "gcs-table"}
        assert any("watchdog" in d for d in tl["diagnosis"])
        text = postmortem.format_timeline(tl)
        assert "trace cafe01" in text
        assert "admit -> r0" in text

    def test_clean_exit_is_not_a_death(self, tmp_path):
        code = (
            "from ray_tpu_torch.util import flightrec\n"
            f"import os\n"
            f"rec = flightrec.FlightRecorder(os.path.join({str(tmp_path)!r},"
            f" f'worker-{{os.getpid()}}.ring'), 'worker')\n"
            "rec.record('task', 't-1', 'finish')\n"
            "rec.record('process', 'worker', 'shutdown')\n"
            "rec.close()\n"
        )
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
        tl = postmortem.build_timeline(session_dir=str(tmp_path))
        assert tl["processes"][0]["clean_exit"]
        assert tl["diagnosis"] == []

    def test_prometheus_parse_and_select(self):
        text = ("# HELP ray_tpu_gcs_sched state\n"
                "# TYPE ray_tpu_gcs_sched gauge\n"
                'ray_tpu_gcs_sched{counter="leases"} 3\n'
                'ray_tpu_component_health{kind="node",state="dead"} 1\n'
                "plain_metric 1.5\n"
                "garbage line without value\n")
        series = postmortem.parse_prometheus(text)
        assert postmortem.select(series, "ray_tpu_gcs_sched")[0]["value"] == 3
        assert postmortem.select(series, "ray_tpu_component_health",
                                 state="dead")
        assert not postmortem.select(series, "ray_tpu_component_health",
                                     state="healthy")
        assert postmortem.select(series, "plain_metric")[0]["value"] == 1.5
        assert series == jax_postmortem.parse_prometheus(text)

    def test_debug_cli_offline(self, tmp_path):
        """``ray-tpu-torch debug --session DIR --json`` works with rings
        alone — no GCS required for a postmortem."""
        rec = flightrec.FlightRecorder(
            str(tmp_path / f"driver-{os.getpid()}.ring"), "driver")
        rec.record("task", "t-1", "start f")
        rec.close()
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", "debug",
             "--session", str(tmp_path), "--json"],
            capture_output=True, text=True, cwd=REPO)
        assert out.returncode == 0, out.stderr
        tl = json.loads(out.stdout)
        assert tl["processes"][0]["pid"] == os.getpid()
        assert any(e["subject"] == "t-1" for e in tl["events"])


def _write_ring(module, path, component):
    rec = module.FlightRecorder(path, component, ring_kb=8)
    rec.record("task", "t-7", "start f trace=beef01")
    rec.record("lease", "blk-3", "carve free=2")
    rec.close()


def _view(tl):
    return ([(p["component"], p["pid"], p["clean_exit"], p["written"])
             for p in tl["processes"]],
            [(e["category"], e["subject"], e["detail"], e["process"])
             for e in tl["events"]], tl["traces"], tl["diagnosis"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_ring_of_either_package_reads_the_same_in_both(tmp_path, writer):
    module = jax_flightrec if writer == "jax" else flightrec
    _write_ring(module, str(tmp_path / f"worker-{os.getpid()}.ring"),
                "worker")
    now = time.time()
    mine = postmortem.build_timeline(session_dir=str(tmp_path), now=now)
    theirs = jax_postmortem.build_timeline(session_dir=str(tmp_path), now=now)
    assert _view(mine) == _view(theirs)
    assert [e[1] for e in _view(mine)[1]] == ["t-7", "blk-3"]
    assert mine["traces"] == {"beef01": [0]}


# -- cluster integration (tests/test_flightrec.py) ----------------------------
def _node_health(client, hexid):
    for s in client.call("health_states"):
        if s["kind"] == "node" and s["key"][1] == hexid:
            return s["state"]
    return None


def test_sigstop_daemon_flips_stalled_then_healthy(tmp_path, monkeypatch):
    """SIGSTOP a node daemon mid-load: heartbeats freeze, the watchdog
    classifies the node `stalled` (NOT dead), the gauge reflects it, and
    SIGCONT recovers it to `healthy`."""
    monkeypatch.setenv(flightrec.ENV_SESSION_DIR, str(tmp_path))
    # The death bound far out, so SIGCONT always lands before `dead`.
    with time_limit(120, "the cluster start"):
        cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 2},
                          system_config={
                              "health_check_failure_threshold": 60,
                              "metrics_export_interval_s": 1.0})
    core = connect(cluster.gcs_address)
    try:
        @ray_tpu.remote
        def ping():
            return os.getpid()

        assert ray_tpu.get([ping.remote() for _ in range(4)], timeout=60)
        client = RpcClient(cluster.gcs_address)
        daemon = cluster.nodes[0]
        hexid = daemon.node_id.hex()
        try:
            assert _wait_for(
                lambda: _node_health(client, hexid) == "healthy", 20)
            daemon.proc.send_signal(signal.SIGSTOP)
            try:
                assert _wait_for(
                    lambda: _node_health(client, hexid) == "stalled", 20)

                def stalled_series():
                    series = postmortem.parse_prometheus(
                        client.call("metrics_text"))
                    return postmortem.select(
                        series, "ray_tpu_component_health", kind="node",
                        subject_node=hexid, state="stalled")

                assert _wait_for(stalled_series, 20)
            finally:
                daemon.proc.send_signal(signal.SIGCONT)
            assert _wait_for(
                lambda: _node_health(client, hexid) == "healthy", 20)
        finally:
            client.close()
    finally:
        core.shutdown()
        runtime_mod._global_runtime = None
        cluster.shutdown()


@pytest.fixture(scope="module")
def chaos_cluster(tmp_path_factory):
    """Two nodes of 3 CPUs whose processes write their rings into one
    session directory; the last test SIGKILLs a daemon."""
    session = str(tmp_path_factory.mktemp("session"))
    knobs = {flightrec.ENV_SESSION_DIR: session, "OMP_NUM_THREADS": "1",
             # every process of this cluster runs both checkers
             "RAY_TPU_LOCK_ORDER_CHECK_ENABLED": "1",
             "RAY_TPU_LEAK_CHECK_ENABLED": "1"}
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        with time_limit(120, "the module's cluster start"):
            cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 3},
                              system_config={"metrics_export_interval_s": 1.0})
            core = connect(cluster.gcs_address)
        for k, v in old.items():    # only the cluster's processes
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield cluster, session
        core.shutdown()
        runtime_mod._global_runtime = None
        cluster.shutdown()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_every_cluster_process_runs_both_checkers(chaos_cluster):
    """The env knobs reach the workers, whose entry point installs both
    checkers before any lock of theirs exists."""

    @ray_tpu.remote
    def probe():
        import threading as th

        from ray_tpu_torch.core import config
        from ray_tpu_torch.devtools import leakcheck as lk
        from ray_tpu_torch.devtools import lockcheck as lc

        return (lc.installed(), lk.installed(),
                isinstance(config._lock, lc.CheckedLock),
                isinstance(th.Lock(), lc.CheckedLock), lc.violations())

    assert ray_tpu.get(probe.remote(), timeout=60) == (True, True, True,
                                                       True, [])


# Module-level so the recorded function name stays short (a closure's
# qualname would truncate past the ring's 40-char name budget); the workers
# get it by value, as this module is not importable there.
@ray_tpu.remote(max_retries=0)
def _linger():
    time.sleep(300)


cloudpickle.register_pickle_by_value(sys.modules[__name__])


def test_sigkill_worker_postmortem_ring(chaos_cluster):
    """kill -9 a worker mid-task: its ring shows the task start edge with
    no finish, and the postmortem names the dead worker."""
    _cluster, session = chaos_cluster
    ref = _linger.remote()

    def started():
        for path in flightrec.discover_rings(session):
            try:
                ring = flightrec.read_ring(path)
            except (OSError, ValueError):
                continue
            if ring["component"] != "worker":
                continue
            for e in ring["events"]:
                if e["category"] == "task" and "start _linger" in e["detail"]:
                    return ring["pid"]
        return None

    pid = _wait_for(started, 60)
    assert pid, "worker never recorded the task-start edge"
    os.kill(pid, signal.SIGKILL)
    with pytest.raises(Exception):
        ray_tpu.get(ref, timeout=60)

    # The pid stays a zombie until the daemon's reaper waits on it.
    def reaped():
        timeline = postmortem.build_timeline(session_dir=session)
        v = [p for p in timeline["processes"] if p["pid"] == pid]
        return timeline if v and not v[0]["alive"] else None

    tl = _wait_for(reaped, 30)
    assert tl, "killed worker never left the process table (unreaped?)"
    victim = [p for p in tl["processes"] if p["pid"] == pid][0]
    assert not victim["clean_exit"]
    assert any(f"worker:{pid}" in d for d in tl["diagnosis"])
    task_events = [e for e in tl["events"]
                   if e["process"] == f"worker:{pid}"
                   and e["category"] == "task"]
    # The worker of this module's cluster may have run earlier tasks: its
    # last task edge is the killed task's start, with no finish after it.
    assert "start _linger" in task_events[-1]["detail"], task_events


def test_chaos_daemon_kill_debug_timeline(chaos_cluster):
    """kill -9 a node daemon under serve load, then ``ray-tpu-torch debug``
    merges every surviving ring with the GCS tables into a timeline that
    names the dead component, shows its lease state and DAG channel
    records, and cross-links a request by trace id; the watchdog flips the
    node to `dead` with the metric reflecting it."""
    cluster, session = chaos_cluster
    from ray_tpu_torch import serve
    from ray_tpu_torch.dag import InputNode

    @serve.deployment(num_replicas=2)
    def echo(x):
        return {"v": x["v"] * 2}

    h = serve.run(echo.bind(), route_prefix="/chaos")
    for i in range(6):
        assert h.remote({"v": i}).result()["v"] == i * 2

    @ray_tpu.remote(num_cpus=1)
    def hold(i):
        time.sleep(0.3)
        return i

    assert ray_tpu.get([hold.remote(i) for i in range(12)],
                       timeout=60) == list(range(12))

    @ray_tpu.remote
    class Stage:
        def apply(self, x):
            return x + 1

    stage = Stage.remote()
    compiled = stage.apply.bind(InputNode()).experimental_compile()
    try:
        assert compiled.execute(41).get(timeout=60) == 42
    finally:
        compiled.teardown()

    def daemon_with_leases():
        pids = {}
        for path in flightrec.discover_rings(session):
            try:
                ring = flightrec.read_ring(path)
            except (OSError, ValueError):
                continue
            if ring["component"] == "node_daemon" and any(
                    e["category"] == "lease" for e in ring["events"]):
                pids[ring["pid"]] = True
        for i, handle in enumerate(cluster.nodes):
            if handle.proc.pid in pids:
                return i + 1  # 1-based so index 0 is truthy
        return None

    victim_slot = _wait_for(daemon_with_leases, 30)
    assert victim_slot, "no node daemon recorded lease activity"
    victim_idx = victim_slot - 1
    victim = cluster.nodes[victim_idx]
    hexid = victim.node_id.hex()
    daemon_pid = victim.proc.pid
    cluster.kill_node(victim_idx, sig=signal.SIGKILL)

    client = RpcClient(cluster.gcs_address)
    try:
        assert _wait_for(lambda: _node_health(client, hexid) == "dead", 30)

        def dead_series():
            series = postmortem.parse_prometheus(client.call("metrics_text"))
            return postmortem.select(
                series, "ray_tpu_component_health", kind="node",
                subject_node=hexid, state="dead")

        assert _wait_for(dead_series, 20)
    finally:
        client.close()
    try:
        serve.shutdown()
    except Exception:  # noqa: BLE001 — a replica died with its node
        pass

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "debug",
         "--session", session, "--gcs", cluster.gcs_address, "--json"],
        capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    tl = json.loads(out.stdout)
    assert any(f"node_daemon:{daemon_pid}" in d
               for d in tl["diagnosis"]), tl["diagnosis"]
    assert any(s.get("state") == "dead" and s.get("kind") == "node"
               and s["key"][1] == hexid for s in tl["health"])
    daemon_events = [e for e in tl["events"]
                     if e["process"] == f"node_daemon:{daemon_pid}"]
    assert any(e["category"] == "lease" for e in daemon_events)
    assert any(e["category"] == "channel" for e in tl["events"])
    admits = [e for e in tl["events"]
              if e["category"] == "serve" and "admit" in e["detail"]
              and "trace=" in e["detail"]]
    assert admits, "no trace-linked serve admissions recorded"
    linked = [tid for tid, idxs in tl["traces"].items()
              if any(tl["events"][i]["category"] == "serve" for i in idxs)]
    assert linked, "no request trace cross-linked in the timeline"
    text = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "debug",
         "--session", session],
        capture_output=True, text=True, cwd=REPO).stdout
    assert f"node_daemon:{daemon_pid}" in text and "DEAD" in text
