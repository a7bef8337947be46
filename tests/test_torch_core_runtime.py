"""The port's in-process runtime where it differs from, or adds to, the JAX
package's: the card (``GPU``) as the accelerator resource and no fallback to
the CPU, the knobs the runtime reads (each honoured), the object plane
carrying tensors bit for bit through the shared-memory arena, the metrics
exporter and span shipping into the runtime's GCS, and a shutdown that
leaves no thread and no arena behind.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.config import config

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def no_card_runtime():
    """``init()`` as a user calls it, on a host with no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ray_tpu_torch.init()
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _rt():
    return runtime_mod.get_runtime()


# -- the accelerator resource ----------------------------------------------------


def test_no_card_registers_no_gpu(no_card_runtime):
    rt = no_card_runtime
    res = rt.cluster_resources()
    assert "GPU" not in res and not any(k.startswith("GPU-") for k in res)
    assert "TPU" not in res


def test_gpu_task_without_a_card_is_infeasible(no_card_runtime):
    rt = no_card_runtime
    ran = []

    @rt.remote(num_gpus=1)
    def on_card():
        ran.append(1)
        return 1

    with pytest.raises(RuntimeError, match="no feasible node"):
        rt.get(on_card.remote(), timeout=10)
    assert ran == []


def test_gpu_actor_without_a_card_is_infeasible(no_card_runtime):
    rt = no_card_runtime
    built = []

    @rt.remote(num_gpus=1)
    class OnCard:
        def __init__(self):
            built.append(1)

        def ping(self):
            return 1

    a = OnCard.remote()
    with pytest.raises(rt.ActorDiedError, match="no feasible node"):
        rt.get(a.ping.remote(), timeout=10)
    assert built == []


def test_num_gpus_and_its_tpu_alias_grant_gpu(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(num_gpus=3)
    def three():
        return rt.available_resources()["GPU"]

    @rt.remote(num_tpus=2)
    def two():
        return rt.available_resources()["GPU"]

    assert rt.get(three.remote()) == 5.0
    assert rt.get(two.remote()) == 6.0
    assert "TPU" not in rt.available_resources()


def test_accelerator_type_asks_for_the_model_marker():
    ray_tpu_torch.init(resources={"CPU": 2, "GPU": 1, "GPU-H100": 1})
    try:
        @ray_tpu_torch.remote(num_gpus=1, accelerator_type="H100")
        def h100():
            return "ran"

        @ray_tpu_torch.remote(num_gpus=1, accelerator_type="A100")
        def a100():
            return "ran"

        assert ray_tpu_torch.get(h100.remote(), timeout=10) == "ran"
        with pytest.raises(RuntimeError, match="no feasible node"):
            ray_tpu_torch.get(a100.remote(), timeout=10)
    finally:
        ray_tpu_torch.shutdown()


def test_gpu_model_marker_names():
    from ray_tpu_torch.accelerators import gpu_model

    assert gpu_model("NVIDIA H100 80GB HBM3") == "H100"
    assert gpu_model("NVIDIA H100 PCIe") == "H100"
    assert gpu_model("Tesla V100-SXM2-16GB") == "V100"


def test_second_gpu_actor_pends_until_the_first_is_killed():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 1})
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        class Card:
            def ping(self):
                return "up"

        first = Card.remote()
        assert ray_tpu_torch.get(first.ping.remote(), timeout=10) == "up"
        second = Card.remote()
        pending = second.ping.remote()
        ready, _ = ray_tpu_torch.wait([pending], timeout=0.3)
        assert ready == []
        assert _rt().gcs.get_actor(second.actor_id).state == "PENDING"
        ray_tpu_torch.kill(first)
        assert ray_tpu_torch.get(pending, timeout=10) == "up"
        # The runner serves its mailbox as soon as it starts; the GCS row
        # turns ALIVE just after.
        deadline = time.monotonic() + 10
        while (_rt().gcs.get_actor(second.actor_id).state != "ALIVE"
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert _rt().gcs.get_actor(second.actor_id).state == "ALIVE"
    finally:
        ray_tpu_torch.shutdown()


def test_killed_pending_actor_is_never_built_and_holds_nothing():
    """A GPU actor killed while it waits for the card is never constructed
    once the card frees, and its queued creation takes no grant (the JAX
    runtime builds it and keeps the grant)."""
    built = []
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 1})
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        class Card:
            def __init__(self, tag):
                built.append(tag)

            def ping(self):
                return "up"

        first = Card.remote("first")
        assert ray_tpu_torch.get(first.ping.remote(), timeout=10) == "up"
        second = Card.remote("second")
        time.sleep(0.2)
        assert _rt().gcs.get_actor(second.actor_id).state == "PENDING"
        ray_tpu_torch.kill(second)
        ray_tpu_torch.kill(first)
        deadline = time.monotonic() + 10
        while (ray_tpu_torch.available_resources().get("GPU") != 1.0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert ray_tpu_torch.available_resources().get("GPU") == 1.0
        assert built == ["first"]
        third = Card.remote("third")
        assert ray_tpu_torch.get(third.ping.remote(), timeout=10) == "up"
        assert built == ["first", "third"]
    finally:
        ray_tpu_torch.shutdown()


def test_parked_gpu_work_runs_once_a_card_node_joins():
    """The autoscaler's seam: with ``autoscaling_enabled`` infeasible work
    parks as a pending demand instead of failing, and runs after a node
    with a card joins and ``retry_infeasible`` reschedules it."""
    ray_tpu_torch.init(resources={"CPU": 2, "GPU": 0})
    try:
        rt = _rt()
        rt.autoscaling_enabled = True

        @ray_tpu_torch.remote(num_gpus=1)
        def on_card():
            return ray_tpu_torch.get_runtime_context().node_id

        ref = on_card.remote()
        assert ray_tpu_torch.wait([ref], timeout=0.2)[0] == []
        assert rt.pending_resource_demands() == [{"GPU": 1.0, "CPU": 1.0}]
        node = rt.add_node({"CPU": 1.0, "GPU": 1.0})
        rt.retry_infeasible()
        assert ray_tpu_torch.get(ref, timeout=10) == node
        assert rt.pending_resource_demands() == []
    finally:
        ray_tpu_torch.shutdown()


def test_init_with_address_waits_for_the_cluster_slice():
    # init(address=...) attaches to a running cluster (tests/
    # test_torch_cluster_*.py); options only a new runtime could apply are
    # refused before anything connects.
    with pytest.raises(ValueError, match="existing cluster"):
        ray_tpu_torch.init(address="127.0.0.1:6379", num_gpus=1)
    assert not ray_tpu_torch.is_initialized()


def test_resident_dag_loop_answers_through_its_method(ray_start_regular):
    # What a compiled DAG sends: DAG_LOOP_METHOD parks the actor in the
    # resident loop with the live instance; it answers every tick off its
    # in-channel until the close pill, then returns "closed".
    from ray_tpu_torch.core.task_spec import DAG_LOOP_METHOD
    from ray_tpu_torch.dag import Channel

    rt = ray_start_regular

    @rt.remote
    class Stage:
        def __init__(self):
            self.calls = 0

        def f(self, x, k):
            self.calls += 1
            return x * k

        def count(self):
            return self.calls

    s = Stage.remote()
    cin, cout = Channel(capacity=1 << 16), Channel(capacity=1 << 16)
    try:
        ref = s._submit(DAG_LOOP_METHOD,
                        ("f", [cin], [cout], [("c", 0), ("v", 3)]), {}, {})
        for i in range(5):
            cin.write(i, timeout=10)
            assert cout.read(timeout=10) == 3 * i
        cin.close()
        assert rt.get(ref, timeout=10) == "closed"
        assert rt.get(s.count.remote(), timeout=10) == 5
    finally:
        cin.destroy()
        cout.destroy()


# -- knobs ------------------------------------------------------------------------


def test_system_config_refuses_unknown_knobs():
    with pytest.raises(ValueError, match="Unknown system_config keys"):
        ray_tpu_torch.init(system_config={"no_such_knob": 1})
    assert not ray_tpu_torch.is_initialized()


def test_system_config_sets_the_table_until_shutdown():
    ray_tpu_torch.init(system_config={"default_max_retries": 7,
                                      "gcs_shards": 3,
                                      "deser_cache_entries": 2,
                                      "get_fanout": 2})
    try:
        rt = _rt()
        assert config().default_max_retries == 7

        @ray_tpu_torch.remote
        def f():
            return 1

        assert f._default_options == {}
        f.remote()
        assert f._plain_options.max_retries == 7
        assert rt.gcs.kv_shard_count() == 3
        assert rt._arg_pool._max_workers == 2
        refs = [ray_tpu_torch.put(i) for i in range(5)]
        assert ray_tpu_torch.get(refs) == list(range(5))
        assert len(rt.store._deser_cache) <= 2
    finally:
        ray_tpu_torch.shutdown()
    assert config().default_max_retries == 3  # the env table again


def test_native_store_threshold_and_switch():
    big = np.arange(40_000, dtype=np.float32)     # 160 KB: into the arena
    small = np.arange(100, dtype=np.float32)
    ray_tpu_torch.init(system_config={"native_store_threshold": 1024})
    try:
        store = _rt().store
        assert store._native is not None
        r_big, r_small = ray_tpu_torch.put(big), ray_tpu_torch.put(small)
        assert store._objects[r_big.id].shm_keys
        assert not store._objects[r_small.id].shm_keys
        np.testing.assert_array_equal(ray_tpu_torch.get(r_big), big)
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(system_config={"use_native_store": False})
    try:
        store = _rt().store
        assert store._native is None
        r_big = ray_tpu_torch.put(big)
        assert not store._objects[r_big.id].shm_keys
        np.testing.assert_array_equal(ray_tpu_torch.get(r_big), big)
    finally:
        ray_tpu_torch.shutdown()


def test_object_store_memory_spills_to_the_spilling_dir(tmp_path):
    ray_tpu_torch.init(system_config={
        "object_store_memory": 64 * 1024, "use_native_store": False,
        "object_spilling_dir": str(tmp_path)})
    try:
        arrays = [np.full(4096, i, np.float32) for i in range(8)]  # 16 KB each
        refs = [ray_tpu_torch.put(a) for a in arrays]
        stats = _rt().store.stats()
        assert stats["evictions"] > 0 and os.listdir(tmp_path)
        for a, r in zip(arrays, refs):
            np.testing.assert_array_equal(ray_tpu_torch.get(r), a)
        assert _rt().store.stats()["restores"] > 0
    finally:
        ray_tpu_torch.shutdown()


def test_jit_check_knob_installs_the_guard():
    from ray_tpu_torch.devtools import jitcheck

    was = jitcheck.installed()
    ray_tpu_torch.init(system_config={"jit_check_enabled": True})
    try:
        assert jitcheck.installed()
    finally:
        ray_tpu_torch.shutdown()
        if not was:
            jitcheck.uninstall()


# -- the object plane -------------------------------------------------------------


@pytest.mark.parametrize("numel", [100, 100_000])  # below / above 64 KiB
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32", "int64",
                                   "bool"])
def test_put_get_tensor_bit_for_bit(ray_start_regular, numel, dtype):
    rt = ray_start_regular
    g = torch.Generator().manual_seed(numel)
    t = (torch.randn(numel, generator=g) * 3).to(getattr(torch, dtype))
    t = t.reshape(-1, 4) if numel % 4 == 0 else t
    ref = rt.put(t)
    back = rt.get(ref)
    assert back.dtype == t.dtype and back.shape == t.shape
    assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))
    in_arena = bool(_rt().store._objects[ref.id].shm_keys)
    assert in_arena == (t.numel() * t.element_size() >= 64 * 1024)


def test_tensors_nested_in_task_results(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def pair(seed):
        g = torch.Generator().manual_seed(seed)
        return {"k": torch.randn(64, 8, generator=g).to(torch.bfloat16),
                "meta": [seed, torch.arange(3)]}

    out = rt.get(pair.remote(5))
    g = torch.Generator().manual_seed(5)
    want = torch.randn(64, 8, generator=g).to(torch.bfloat16)
    assert torch.equal(out["k"], want) and out["meta"][0] == 5
    assert out["meta"][1].tolist() == [0, 1, 2]


# -- metrics and spans into the GCS ----------------------------------------------


def test_exporter_reports_task_counts_into_the_aggregator(ray_start_regular):
    from ray_tpu_torch.core.metrics_export import tasks_total

    rt = ray_start_regular
    before = tasks_total().get({"state": "FINISHED"})

    @rt.remote
    def f(x):
        return x

    rt.get([f.remote(i) for i in range(6)])
    _rt()._metrics_exporter.flush()
    summary = _rt().gcs.metrics_summary()
    assert any(p["component"] == "driver" and p["pid"] == os.getpid()
               for p in summary["processes"])
    total = {m["name"]: m for m in summary["metrics"]}
    assert total["ray_tpu_tasks_total"]["total"] >= before + 6
    hist = _rt().gcs.metrics_histogram("ray_tpu_task_phase_s",
                                       {"phase": "execute"})
    assert hist is not None and hist["count"] >= 6


def test_spans_ship_to_the_runtime_timeline(ray_start_regular):
    from ray_tpu_torch.util import tracing

    rt = ray_start_regular
    with tracing.span("user.op") as (trace_id, _span_id):
        pass
    tracing.flush()
    names = [e["name"] for e in rt.timeline(trace_id=trace_id)
             if e.get("ph") == "X"]
    assert names == ["user.op"]


# -- shutdown ---------------------------------------------------------------------


def test_shutdown_leaves_no_thread_and_no_arena():
    pid = os.getpid()
    ray_tpu_torch.init(resources={"CPU": 2, "GPU": 1})

    @ray_tpu_torch.remote(num_gpus=1, max_concurrency=4)
    class Threads:
        def ping(self):
            return 1

    a = Threads.remote()
    assert ray_tpu_torch.get([a.ping.remote() for _ in range(8)]) == [1] * 8
    ray_tpu_torch.put(np.zeros(100_000, np.float32))  # into the arena
    arena = _rt().store._native.name.lstrip("/")
    assert arena.startswith(f"rtpu_store_{pid}_")
    assert arena in os.listdir("/dev/shm")
    ray_tpu_torch.shutdown()
    for t in threading.enumerate():
        if t.name.startswith(("actor-", "metrics-export-")):
            t.join(timeout=10)
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("actor-", "metrics-export-"))]
    assert left == []
    assert not [n for n in os.listdir("/dev/shm")
                if n.startswith(f"rtpu_store_{pid}_")]


# -- runtime environments (``tests/test_jobs_and_runtime_env.py::TestRuntimeEnv``)


class TestRuntimeEnv:
    def test_validation(self, tmp_path):
        from ray_tpu_torch.runtime_env import RuntimeEnv

        env = RuntimeEnv(env_vars={"A": "1"}, working_dir=str(tmp_path))
        assert env["env_vars"] == {"A": "1"}
        with pytest.raises(ValueError):
            RuntimeEnv(bogus_field=1)
        with pytest.raises(ValueError):
            RuntimeEnv(working_dir="/nonexistent/dir")
        with pytest.raises(TypeError):
            RuntimeEnv(env_vars={"A": 1})
        assert RuntimeEnv(pip=["requests"]).deferred_plugins() == ["pip"]

    def test_applied_env_vars_restored(self):
        from ray_tpu_torch.runtime_env import applied

        os.environ.pop("RT_TORCH_TEST_VAR", None)
        with applied({"env_vars": {"RT_TORCH_TEST_VAR": "inner"}}):
            assert os.environ["RT_TORCH_TEST_VAR"] == "inner"
        assert "RT_TORCH_TEST_VAR" not in os.environ

    def test_task_runtime_env(self, ray_start_regular, tmp_path):
        rt = ray_start_regular
        (tmp_path / "my_torch_renv_module.py").write_text("VALUE = 42\n")

        @rt.remote(runtime_env={"env_vars": {"MY_TORCH_TASK_VAR": "hello"},
                                "working_dir": str(tmp_path)})
        def read_env():
            import my_torch_renv_module

            return (os.environ.get("MY_TORCH_TASK_VAR"),
                    my_torch_renv_module.VALUE)

        assert rt.get(read_env.remote()) == ("hello", 42)
        assert "MY_TORCH_TASK_VAR" not in os.environ
