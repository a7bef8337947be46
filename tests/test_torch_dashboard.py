"""JAX's dashboard tests on the port's ``ray_tpu_torch.dashboard``.

``tests/test_dashboard.py``'s three: the endpoints over the in-process
runtime, ``/api/node_stats`` fanning out to every daemon of a ``Cluster``
with the single-page UI, and the log viewer and task-event feed. The two
cluster tests share one ``Cluster`` of two 1-CPU nodes. Each dashboard
binds a free port. Beside them, ``/api/jobs`` on a cluster driver lists a
submitted job with its end state (the GCS client had no job table).
"""

import json
import socket
import time
import urllib.request

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.dashboard import start_dashboard

import torch_threads  # noqa: F401,E402  (one torch thread a test process)
from torch_time_limit import time_limit  # noqa: E402


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read().decode()


def _json(url):
    return json.loads(_get(url))


@pytest.fixture
def dashboard():
    ray_tpu.init(resources={"CPU": 4})
    d = start_dashboard(port=_free_port())
    yield d
    d.stop()
    ray_tpu.shutdown()


class TestDashboard:
    def test_endpoints(self, dashboard):
        @ray_tpu.remote
        def work(x):
            return x

        ray_tpu.get([work.remote(i) for i in range(3)])

        base = dashboard.url
        summary = _json(f"{base}/api/cluster_summary")
        assert summary["alive_nodes"] >= 1
        nodes = _json(f"{base}/api/nodes")
        assert nodes and nodes[0]["state"] == "ALIVE"
        tasks = _json(f"{base}/api/tasks")
        assert len(tasks) >= 3
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as resp:
            assert resp.status == 200
        assert "ray_tpu_torch cluster" in _get(base)
        assert isinstance(_json(f"{base}/timeline"), list)


@pytest.fixture(scope="module")
def cluster():
    with time_limit(120, "the module's cluster start"):
        c = Cluster(num_nodes=2, resources_per_node={"CPU": 1})
        core = connect(c.gcs_address)
    yield c
    core.shutdown()
    runtime_mod._global_runtime = None
    c.shutdown()


@pytest.fixture
def cluster_dash(cluster):
    d = start_dashboard(port=_free_port())
    yield d
    d.stop()


def test_node_stats_and_ui_on_multiprocess_cluster(cluster_dash):
    """The per-node agent role: /api/node_stats fans out to every daemon's
    psutil+store reporter; / serves the SPA."""
    stats = _json(f"{cluster_dash.url}/api/node_stats")
    assert len(stats) == 2
    for n in stats:
        assert n.get("workers") is not None, n
        assert n.get("store_capacity", 0) > 0, n
        assert "cpu_percent" in n, n
    page = _get(f"{cluster_dash.url}/")
    assert "ray_tpu_torch cluster" in page and "renderNodes" in page


def test_log_viewer_and_event_feed(cluster_dash):
    """/api/logs serves the aggregated worker log stream with a resumable
    cursor; /api/events serves the GCS task-event feed."""
    dash = cluster_dash

    @ray_tpu.remote
    def chatty(i):
        print(f"dashboard-log-probe-{i}")
        return i

    ray_tpu.get([chatty.remote(i) for i in range(3)], timeout=120)

    # Logs reach the channel via the daemon's 0.5s tailer tick.
    deadline = time.time() + 30
    seen, cursor = [], 0
    while time.time() < deadline:
        d = _json(f"{dash.url}/api/logs?cursor={cursor}")
        cursor = d["cursor"]
        for b in d["batches"]:
            seen.extend(b.get("lines", []))
        if any("dashboard-log-probe-" in ln for ln in seen):
            break
        time.sleep(0.5)
    assert any("dashboard-log-probe-" in ln for ln in seen), seen[-5:]
    # Cursor is resumable: a follow-up poll returns nothing new.
    d2 = _json(f"{dash.url}/api/logs?cursor={cursor}")
    assert d2["cursor"] >= cursor

    # Worker event buffers flush on a ~1s cadence; poll.
    deadline = time.time() + 30
    events = []
    while time.time() < deadline:
        events = _json(f"{dash.url}/api/events")
        if events:
            break
        time.sleep(0.5)
    assert isinstance(events, list) and events, "no task events"
    assert any("chatty" in (e.get("name") or "") for e in events), events[:3]
    assert all(e.get("kind") in ("FINISHED", "FAILED", "event")
               for e in events[:5]), events[:3]

    page = _get(f"{dash.url}/")
    assert "renderLogs" in page and "renderEvents" in page


def test_jobs_pane_lists_submitted_jobs_on_a_cluster(cluster_dash):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    client = JobSubmissionClient()
    job = client.submit_job(entrypoint="exit 3")
    assert client.wait_until_finish(job, timeout_s=60) == JobStatus.FAILED
    deadline = time.time() + 10
    while True:
        jobs = {j["job_id"]: j["status"]
                for j in _json(f"{cluster_dash.url}/api/jobs")}
        if jobs.get(job) == JobStatus.FAILED:
            break
        assert time.time() < deadline, jobs
        time.sleep(0.1)
    assert "RUNNING" in jobs.values()     # this driver's own job
