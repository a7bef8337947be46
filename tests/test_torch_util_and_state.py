"""JAX's remaining util, metrics-plane and flight-recorder tests on the port.

- ``TestActorPool`` and ``TestQueue`` of ``tests/test_util_and_state.py``
  on the port's ``util/actor_pool.py`` and ``util/queue.py`` over its
  in-process runtime;
- ``test_exporter_survives_gcs_outage`` and
  ``test_exporter_disabled_by_knob`` of ``tests/test_metrics_plane.py`` on
  the port's ``MetricsExporter``;
- ``TestRing::test_ring_survives_sigkill`` of ``tests/test_flightrec.py``
  on the port's ring, written by a process that imports the port only.

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
