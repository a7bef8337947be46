"""JAX's job-submission and runtime-env build tests on the port.

- ``tests/test_jobs_and_runtime_env.py::TestJobSubmission`` (5) on
  ``ray_tpu_torch.job_submission`` over the in-process runtime;
- its pip, conda and container runtime-env builds, on one port
  ``Cluster`` for the three (the container shim is the daemon's
  ``RAY_TPU_CONTAINER_RUNTIME`` from the cluster's start);
- ``TestCondaEnvBuildRace`` (3) on the port's ``NodeDaemon``.

Then the port's repairs: a submitted job is a row of the GCS job table
(its submission id, its end state), listed by ``util.state.list_jobs`` in
one process and on a cluster driver, whose GCS client had no job table; and
a job's ``working_dir`` goes before the PYTHONPATH the supervisor's own
process runs with (a cluster worker's: the checkout), where JAX's client
put its own, which a driver started from the checkout does not set.
"""

import os
import stat
import subprocess
import sys
import sysconfig
import time

import pytest

from ray_tpu.job_submission import JobStatus as JaxJobStatus

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.job_submission import (_STOP_WAIT_S, JobStatus,
                                          JobSubmissionClient, group_members)
from ray_tpu_torch.util import state

import torch_threads  # noqa: F401,E402  (one torch thread a test process)
from torch_time_limit import time_limit  # noqa: E402


@pytest.fixture
def ray_start_regular():
    ray_tpu.init(resources={"CPU": 4})
    yield ray_tpu
    ray_tpu.shutdown()


def test_job_states_are_jaxs():
    for name in ("PENDING", "RUNNING", "SUCCEEDED", "FAILED", "STOPPED"):
        assert getattr(JobStatus, name) == getattr(JaxJobStatus, name)
    assert JobStatus.TERMINAL == JaxJobStatus.TERMINAL


class TestJobSubmission:
    def test_submit_and_succeed(self, ray_start_regular):
        client = JobSubmissionClient()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"print('job ran fine')\""
        )
        status = client.wait_until_finish(job_id, timeout_s=60)
        assert status == JobStatus.SUCCEEDED
        assert "job ran fine" in client.get_job_logs(job_id)

    def test_failed_job_status(self, ray_start_regular):
        client = JobSubmissionClient()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"import sys; print('boom'); "
                       f"sys.exit(3)\""
        )
        status = client.wait_until_finish(job_id, timeout_s=60)
        assert status == JobStatus.FAILED
        info = client.get_job_info(job_id)
        assert info["returncode"] == 3

    def test_env_vars_reach_job(self, ray_start_regular):
        client = JobSubmissionClient()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"import os; "
                       f"print('VAR=' + os.environ['JOBVAR'])\"",
            runtime_env={"env_vars": {"JOBVAR": "xyz"}},
        )
        client.wait_until_finish(job_id, timeout_s=60)
        assert "VAR=xyz" in client.get_job_logs(job_id)

    def test_stop_job(self, ray_start_regular):
        client = JobSubmissionClient()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"import time; time.sleep(300)\""
        )
        deadline = time.monotonic() + 10
        while client.get_job_status(job_id) != JobStatus.RUNNING:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert client.stop_job(job_id)
        status = client.wait_until_finish(job_id, timeout_s=30)
        assert status == JobStatus.STOPPED

    def test_list_jobs(self, ray_start_regular):
        client = JobSubmissionClient()
        a = client.submit_job(entrypoint="true")
        b = client.submit_job(entrypoint="true")
        client.wait_until_finish(a)
        client.wait_until_finish(b)
        ids = {j["job_id"] for j in client.list_jobs()}
        assert {a, b} <= ids


def test_stop_job_kills_a_group_that_outlives_sigterm(ray_start_regular):
    """A job whose processes ignore SIGTERM: stop_job still takes its
    whole process group down, by SIGKILL after the grace period."""
    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint="trap '' TERM; " + sys.executable + " -c \"import signal, "
                   "time; signal.signal(signal.SIGTERM, signal.SIG_IGN); "
                   "print('up', flush=True); time.sleep(300)\"")
    deadline = time.monotonic() + 30
    while "up" not in client.get_job_logs(job_id):
        assert time.monotonic() < deadline, client.get_job_logs(job_id)
        time.sleep(0.05)
    pgid = runtime_mod.get_runtime().gcs.jobs[job_id].driver_pid
    members = group_members(pgid)
    assert members and all(m["SigIgn"] != "0" * 16
                                     for m in members), members
    t0 = time.monotonic()
    assert client.stop_job(job_id)
    assert client.wait_until_finish(job_id, timeout_s=30) == JobStatus.STOPPED
    while True:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            break
        assert time.monotonic() - t0 < _STOP_WAIT_S + 10, group_members(pgid)
        time.sleep(0.05)
    assert time.monotonic() - t0 >= _STOP_WAIT_S


def test_submitted_jobs_are_rows_of_the_job_table(ray_start_regular):
    client = JobSubmissionClient()
    ok = client.submit_job(entrypoint="true")
    bad = client.submit_job(entrypoint="exit 3")
    assert client.wait_until_finish(ok) == JobStatus.SUCCEEDED
    assert client.wait_until_finish(bad) == JobStatus.FAILED
    deadline = time.monotonic() + 10
    while True:
        rows = {j["job_id"]: j for j in state.list_jobs()}
        if (rows.get(ok, {}).get("status") == JobStatus.SUCCEEDED
                and rows.get(bad, {}).get("status") == JobStatus.FAILED):
            break
        assert time.monotonic() < deadline, rows
        time.sleep(0.05)
    assert rows[ok]["entrypoint"] == "true"
    assert runtime_mod.get_runtime().gcs.jobs[ok].metadata == {"type": "SUBMISSION"}
    # the driver's own job stays listed beside them
    assert any(j["status"] == "RUNNING" and j["job_id"] not in (ok, bad)
               for j in rows.values())


# -- on a cluster ---------------------------------------------------------------
_SHIM = """#!{python}
import os, sys
args = sys.argv[1:]
with open({record!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
env = dict(os.environ)
i = 1  # skip "run"
cmd = None
while i < len(args):
    a = args[i]
    if a == "-e":
        k, _, v = args[i + 1].partition("="); env[k] = v; i += 2
    elif a == "-v":
        i += 2
    elif a.startswith("-"):
        i += 1
    else:
        cmd = args[i + 1:]  # args[i] is the image
        break
cmd[0] = {python!r}  # the "image python" is this interpreter
os.execvpe(cmd[0], cmd, env)
"""


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """One node of 2 CPUs whose daemon wraps container workers in a fake
    runtime (a shim that records its argv, applies -e vars and execs the
    inner command), and a driver attached to it."""
    tmp = tmp_path_factory.mktemp("container")
    record = tmp / "invocations.log"
    shim = tmp / "fake-docker"
    shim.write_text(_SHIM.format(python=sys.executable, record=str(record)))
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    env = {"RAY_TPU_CONTAINER_RUNTIME": str(shim), "OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with time_limit(120, "the module's cluster start"):
            c = Cluster(num_nodes=1, resources_per_node={"CPU": 2})
            core = connect(c.gcs_address)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yield c, record
    core.shutdown()
    runtime_mod._global_runtime = None
    c.shutdown()


def test_pip_runtime_env_builds_isolated_venv(cluster, tmp_path):
    """runtime_env={"pip": [...]} builds a cached venv on the node daemon
    and runs the task inside it: the package imports there and ONLY there.
    No network: the requirement is a local source tree."""
    pkg = tmp_path / "rtpu_demo_pkg"
    (pkg / "rtpu_demo_pkg").mkdir(parents=True)
    (pkg / "rtpu_demo_pkg" / "__init__.py").write_text("MAGIC = 1337\n")
    (pkg / "pyproject.toml").write_text(
        '[project]\nname = "rtpu-demo-pkg"\nversion = "0.1"\n'
        '[build-system]\nrequires = ["setuptools"]\n'
        'build-backend = "setuptools.build_meta"\n'
        '[tool.setuptools]\npackages = ["rtpu_demo_pkg"]\n')

    @ray_tpu.remote(runtime_env={"pip": {
        "packages": [f"{pkg}"],
        "pip_install_options": ["--no-index", "--no-build-isolation"],
    }})
    def with_pkg():
        import rtpu_demo_pkg

        return rtpu_demo_pkg.MAGIC

    @ray_tpu.remote
    def without_pkg():
        try:
            import rtpu_demo_pkg  # noqa: F401

            return "leaked"
        except ImportError:
            return "isolated"

    assert ray_tpu.get(with_pkg.remote(), timeout=600) == 1337
    assert ray_tpu.get(without_pkg.remote(), timeout=120) == "isolated"
    # second task with the same spec reuses the cached env (fast)
    t0 = time.time()
    assert ray_tpu.get(with_pkg.remote(), timeout=120) == 1337
    assert time.time() - t0 < 60


def test_conda_prefix_runtime_env(cluster, tmp_path):
    """runtime_env={"conda": <prefix path>}: the task runs under that
    environment's interpreter (a venv prefix exercises the existing-env
    path without the conda binary)."""
    prefix = tmp_path / "condaish"
    subprocess.run([sys.executable, "-m", "venv", "--system-site-packages",
                    "--without-pip", str(prefix)], check=True, timeout=300)
    site = subprocess.run(
        [str(prefix / "bin" / "python"), "-c",
         "import sysconfig; print(sysconfig.get_paths()['purelib'])"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    with open(f"{site}/_rtpu_parent.pth", "w") as f:
        f.write(sysconfig.get_paths()["purelib"] + "\n")

    @ray_tpu.remote(runtime_env={"conda": str(prefix)})
    def which_python():
        import sys as _s

        return _s.executable

    exe = ray_tpu.get(which_python.remote(), timeout=300)
    assert exe.startswith(str(prefix)), exe


def test_container_runtime_env_wraps_worker(cluster):
    """runtime_env={"container": {...}}: the worker command is wrapped in
    the container runtime with host networking and env passthrough."""
    _c, record = cluster

    @ray_tpu.remote(runtime_env={"container": {
        "image": "example.com/rtpu:latest",
        "run_options": ["--read-only"],
    }})
    def inside():
        return "containerized-ok"

    assert ray_tpu.get(inside.remote(), timeout=300) == "containerized-ok"
    logged = record.read_text()
    assert "example.com/rtpu:latest" in logged
    assert "--network=host" in logged
    assert "--read-only" in logged
    assert "-e RAY_TPU_GCS_ADDRESS=" in logged


def test_cluster_job_table_and_working_dir(cluster, tmp_path, monkeypatch):
    """A job submitted on a cluster: its working_dir module imports next
    to the package (the worker's checkout on its PYTHONPATH), and its row
    in the GCS job table reaches ``state.list_jobs`` on the driver."""
    (tmp_path / "jobmod.py").write_text("WORD = 'from-working-dir'\n")
    client = JobSubmissionClient()
    monkeypatch.delenv("PYTHONPATH", raising=False)  # a driver in the checkout
    job = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import jobmod, ray_tpu_torch; "
                   f"print(jobmod.WORD, ray_tpu_torch.__name__)\"",
        runtime_env={"working_dir": str(tmp_path)})
    assert client.wait_until_finish(job, timeout_s=120) == \
        JobStatus.SUCCEEDED, client.get_job_logs(job)
    assert "from-working-dir ray_tpu_torch" in client.get_job_logs(job)
    rows = {j["job_id"]: j for j in state.list_jobs()}
    assert rows[job]["status"] == JobStatus.SUCCEEDED
    assert any(j["entrypoint"] == "driver" for j in rows.values())
    # the supervisor's metadata crosses the RPC into the GCS's row
    assert runtime_mod.get_runtime().gcs.jobs[job].metadata == {"type": "SUBMISSION"}


# -- TestCondaEnvBuildRace -------------------------------------------------------
class TestCondaEnvBuildRace:
    """_ensure_conda_env's dict branch uses the pip path's claim protocol:
    an atomic mkdir claim + a .building staleness marker, so two concurrent
    spawns can never rmtree each other's in-progress build."""

    def _daemon(self, monkeypatch, tmp_path):
        from ray_tpu_torch.core.node_daemon import NodeDaemon

        daemon = object.__new__(NodeDaemon)  # only env methods are used
        monkeypatch.setattr(NodeDaemon, "_pip_env_root",
                            staticmethod(lambda: str(tmp_path)))
        return daemon

    def _fake_conda(self, monkeypatch, build_log, build_delay=0.0):
        import shutil

        monkeypatch.setattr(shutil, "which",
                            lambda name: "/usr/bin/conda"
                            if name == "conda" else None)
        real_run = subprocess.run

        def fake_run(cmd, **kw):
            if len(cmd) >= 3 and cmd[1:3] == ["env", "create"]:
                prefix = cmd[cmd.index("-p") + 1]
                build_log.append(prefix)
                if build_delay:
                    time.sleep(build_delay)
                os.makedirs(os.path.join(prefix, "bin"), exist_ok=True)
                with open(os.path.join(prefix, "bin", "python"), "w") as f:
                    f.write("#!/bin/true\n")

                class R:
                    returncode = 0
                    stderr = ""
                return R()
            return real_run(cmd, **kw)

        monkeypatch.setattr(subprocess, "run", fake_run)

    def test_concurrent_builders_single_build(self, monkeypatch, tmp_path):
        import threading

        daemon = self._daemon(monkeypatch, tmp_path)
        build_log = []
        self._fake_conda(monkeypatch, build_log, build_delay=0.6)
        spec = {"dependencies": ["python=3.11"]}
        results, errors = [], []

        def build():
            try:
                results.append(daemon._ensure_conda_env(dict(spec)))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=build, daemon=True)
                   for _ in range(2)]
        threads[0].start()
        time.sleep(0.15)  # let A claim and enter the slow build
        threads[1].start()
        for t in threads:
            t.join(30)
        assert not errors, errors
        assert len(build_log) == 1, "both racers built (claim not honored)"
        assert len(set(results)) == 1 and len(results) == 2
        python = results[0]
        assert os.path.exists(python), "winner's env was deleted by loser"
        prefix = os.path.dirname(os.path.dirname(python))
        assert os.path.exists(os.path.join(prefix, ".ready"))
        assert not os.path.exists(prefix + ".claim"), "claim must be released"

    def test_stale_claim_is_reclaimed(self, monkeypatch, tmp_path):
        import hashlib
        import json

        daemon = self._daemon(monkeypatch, tmp_path)
        build_log = []
        self._fake_conda(monkeypatch, build_log)
        spec = {"dependencies": ["python=3.11"]}
        key = hashlib.sha1(json.dumps(
            spec, sort_keys=True).encode()).hexdigest()[:16]
        prefix = os.path.join(str(tmp_path), f"conda-{key}")
        claim = prefix + ".claim"
        os.makedirs(claim)
        marker = os.path.join(claim, ".building")
        open(marker, "w").close()
        ancient = time.time() - 10_000
        os.utime(marker, (ancient, ancient))
        os.makedirs(prefix)  # dead builder's half-written debris
        python = daemon._ensure_conda_env(spec)
        assert os.path.exists(python)
        assert len(build_log) == 1
        assert os.path.exists(os.path.join(prefix, ".ready"))

    def test_ready_env_reused_without_build(self, monkeypatch, tmp_path):
        daemon = self._daemon(monkeypatch, tmp_path)
        build_log = []
        self._fake_conda(monkeypatch, build_log)
        spec = {"dependencies": ["numpy"]}
        p1 = daemon._ensure_conda_env(spec)
        p2 = daemon._ensure_conda_env(spec)
        assert p1 == p2
        assert len(build_log) == 1
