"""The port's own rules of the multi-process cluster.

- A process that starts imports no torch: the GCS, the node daemons and
  idle workers run without it, and an actor whose arguments hold torch
  objects (a dtype, a model config, a tensor) is created without the GCS
  or its node's daemon importing torch: they read the spec with
  ``serialization.loads_deferred``, which keeps what they have not imported
  as placeholders that re-encode to the same objects.
- ``init(address=...)`` attaches to a cluster, refuses options only a new
  runtime could apply, and ``shutdown()`` clears the driver's knob table.
- A node has the resources it is given: no card is detected, no ``TPU``
  key is registered, and ``num_gpus`` work waits for a node given ``GPU``.
- ``Cluster.shutdown()`` leaves no process and no arena of the cluster.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.cluster import Cluster
from ray_tpu_torch.models import transformer

import torch_threads  # noqa: F401,E402  (one torch thread a test process)
from torch_time_limit import time_limit  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Workers cannot import this module: its classes travel by value.
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_per_process():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _has_torch(pid):
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in line for line in f)


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


class _Holder:
    def __init__(self, *args):
        self.args = args

    def echo(self):
        import sys as _sys

        return self.args, "torch" in _sys.modules


def _value():
    return {"cfg": transformer.tiny(), "dtype": torch.bfloat16,
            "device": torch.device("cpu"), "size": torch.Size([2, 3]),
            "t": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "big": torch.arange(40_000, dtype=torch.float32),
            "np": np.arange(5), "nested": [torch.float16, (1, "x")]}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
        elif isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


def test_deferred_read_reencodes_without_torch(tmp_path):
    """A process without torch reads and re-encodes a value holding torch
    objects, twice over, without importing torch; the result reads back as
    the original here."""
    src = tmp_path / "in.bin"
    out = tmp_path / "out.bin"
    src.write_bytes(serialization.dumps(_value()))
    code = textwrap.dedent(f"""
        import sys
        from ray_tpu_torch.core import serialization as s
        v = s.loads_deferred(open({str(src)!r}, "rb").read())
        v = s.loads_deferred(s.dumps(v))
        assert sorted(v) == sorted({sorted(_value())!r}), sorted(v)
        open({str(out)!r}, "wb").write(s.dumps(v))
        mods = [m for m in sys.modules
                if m.split(".")[0] == "torch" or m.endswith("transformer")]
        assert not mods, mods
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    _same(serialization.loads(out.read_bytes()), _value())


def test_deferred_read_is_plain_where_all_is_imported():
    v = serialization.loads_deferred(serialization.dumps(_value()))
    _same({k: x for k, x in v.items() if k not in ("t", "big")},
          {k: x for k, x in _value().items() if k not in ("t", "big")})
    # Tensors stay calls of their rebuild until a plain read.
    _same(serialization.loads(serialization.dumps(v)), _value())


@pytest.fixture(scope="module")
def cluster():
    with time_limit(120, "the module's cluster start"):
        c = Cluster(num_nodes=1, resources_per_node={"CPU": 2})
    yield c
    c.shutdown()


@pytest.fixture
def driver(cluster):
    rt.init(address=cluster.gcs_address)
    yield rt
    rt.shutdown()


def test_idle_workers_do_not_import_torch(cluster, driver):
    def probe():
        import sys as _sys

        return "torch" in _sys.modules, os.getpid()

    outs = rt.get([rt.remote(probe).remote() for _ in range(2)], timeout=120)
    assert not any(has for has, _pid in outs)


def test_actor_with_torch_arguments_leaves_gcs_and_daemon_without_torch(
        cluster, driver):
    daemon = cluster.nodes[0].proc.pid
    assert not _has_torch(cluster.gcs_proc.pid) and not _has_torch(daemon)
    a = rt.remote(_Holder).remote(_value())
    (got,), worker_has_torch = rt.get(a.echo.remote(), timeout=120)
    _same(got, _value())
    assert worker_has_torch
    assert not _has_torch(cluster.gcs_proc.pid) and not _has_torch(daemon)
    rt.kill(a)


class _TorchUser:
    """Names the ``torch`` module as a global: its by-value class pickles
    that as cloudpickle's ``subimport("torch")``."""

    def zeros(self):
        import sys as _sys

        return torch.zeros(2).tolist(), os.getpid()


def test_actor_class_naming_torch_leaves_gcs_and_daemon_without_torch(
        cluster, driver):
    """The GCS reads a spec whose class names torch without running its
    ``subimport``: importing torch held the GCS's GIL for seconds on the
    card's host (a late health tick, the card node's lost heartbeats)."""
    daemon = cluster.nodes[0].proc.pid
    # The class rides in the actor's arguments, which the GCS reads.
    a = rt.remote(_Holder).remote(_TorchUser)
    (cls,), worker_has_torch = rt.get(a.echo.remote(), timeout=120)
    assert cls().zeros()[0] == [0.0, 0.0] and worker_has_torch
    assert not _has_torch(cluster.gcs_proc.pid) and not _has_torch(daemon)
    rt.kill(a)
    blob = serialization.dumps(_TorchUser)
    code = textwrap.dedent(f"""
        import sys
        from ray_tpu_torch.core import serialization as s
        cls = s.loads_deferred({blob!r})
        again = s.loads_deferred(s.dumps(cls))
        assert "torch" not in sys.modules
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split() == ["ok"], \
        proc.stderr[-2000:]


def test_init_with_address_refuses_new_runtime_options(cluster):
    for kw in ({"num_cpus": 2}, {"num_gpus": 1}, {"resources": {"CPU": 1}},
               {"system_config": {"gcs_shards": 2}}, {"num_nodes": 2}):
        with pytest.raises(ValueError, match="existing cluster"):
            rt.init(address=cluster.gcs_address, **kw)
        assert not rt.is_initialized()


def test_driver_knob_table_follows_the_connection(cluster, monkeypatch):
    from ray_tpu_torch.core import config as cfg_mod

    monkeypatch.setenv("RAY_TPU_GCS_SHARDS", "3")
    rt.init(address=cluster.gcs_address)
    try:
        monkeypatch.setenv("RAY_TPU_GCS_SHARDS", "5")
        assert cfg_mod.config().gcs_shards == 3   # resolved at connect
    finally:
        rt.shutdown()
    assert cfg_mod.config().gcs_shards == 5      # per call again


def test_nodes_have_what_they_are_given():
    c = Cluster(num_nodes=0)
    try:
        c.add_node({"CPU": 1})
        rt.init(address=c.gcs_address)
        try:
            res = rt.cluster_resources()
            assert res == {"CPU": 1.0}, res   # no card detected, no TPU
            ref = rt.remote(num_gpus=1)(_alive).remote(1)
            ready, _ = rt.wait([ref], timeout=1.0)
            assert not ready                   # waits for a GPU node
            c.add_node({"CPU": 1, "GPU": 1})
            assert rt.get(ref, timeout=120) in (True, False)
            assert rt.cluster_resources()["GPU"] == 1.0
        finally:
            rt.shutdown()
    finally:
        c.shutdown()


def test_shutdown_leaves_no_process_or_arena():
    c = Cluster(num_nodes=2, resources_per_node={"CPU": 1})
    rt.init(address=c.gcs_address)
    try:
        assert rt.get(rt.remote(os.getpid).remote(), timeout=60) != os.getpid()
        pids = [c.gcs_proc.pid] + [h.proc.pid for h in c.nodes]
        pids += [p for i in range(2) for p in c.worker_pids(i)]
        arenas = [h.store_name for h in c.nodes]
        assert all(os.path.exists(f"/dev/shm/{n}") for n in arenas)
    finally:
        rt.shutdown()
        c.shutdown()
    import time

    deadline = time.monotonic() + 15
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [p for p in pids if _alive(p)]
    assert not [n for n in arenas if os.path.exists(f"/dev/shm/{n}")]


def test_actor_killed_while_pending_gives_its_grant_back():
    """An actor killed while its lease waits for resources (a third
    half-card replica the controller retires, say) is never built and
    holds nothing once the resources free (the port's repair; JAX's GCS
    builds it and keeps the lease)."""
    import time

    c = Cluster(num_nodes=1, resources_per_node={"CPU": 4, "GPU": 1})
    rt.init(address=c.gcs_address)
    try:
        class Holder:
            def pid(self):
                return os.getpid()

        first = rt.remote(num_gpus=1)(Holder).remote()
        rt.get(first.pid.remote(), timeout=120)
        pending = rt.remote(num_gpus=1)(Holder).remote()
        time.sleep(0.5)
        rt.kill(pending)
        rt.kill(first)
        deadline = time.monotonic() + 60
        while rt.available_resources().get("GPU", 0) != 1.0:
            assert time.monotonic() < deadline, rt.available_resources()
            time.sleep(0.1)
        time.sleep(1.0)   # nothing takes the card back afterwards
        assert rt.available_resources().get("GPU", 0) == 1.0
        with pytest.raises(rt.ActorError):
            rt.get(pending.pid.remote(), timeout=30)
    finally:
        rt.shutdown()
        c.shutdown()
