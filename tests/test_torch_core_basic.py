"""The port's runtime (``ray_tpu_torch``) through ``tests/test_core_basic.py``, with
the card (``GPU``) where the JAX package names TPU chips.

Core API tests: tasks, objects, options — the reference's
``python/ray/tests/test_basic.py`` surface."""

import time

import numpy as np
import pytest

import ray_tpu_torch

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_cluster():
    """4 virtual nodes, 2 CPU + 4 GPU each."""
    ray_tpu_torch.init(resources={"CPU": 2, "GPU": 4}, num_nodes=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_put_get(ray_start_regular):
    rt = ray_start_regular
    ref = rt.put({"a": 1, "b": [1, 2, 3]})
    assert rt.get(ref) == {"a": 1, "b": [1, 2, 3]}


def test_put_get_numpy_zero_copy(ray_start_regular):
    rt = ray_start_regular
    arr = np.arange(1_000_000, dtype=np.float32)
    ref = rt.put(arr)
    out = rt.get(ref)
    np.testing.assert_array_equal(arr, out)


def test_simple_task(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2)) == 3


def test_task_with_ref_args(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def add(a, b):
        return a + b

    x = rt.put(10)
    y = add.remote(x, 5)
    z = add.remote(y, y)
    assert rt.get(z) == 30


def test_task_kwargs(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def f(a, b=0, c=0):
        return a + b + c

    assert rt.get(f.remote(1, c=3)) == 4


def test_multiple_returns(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c]) == [1, 2, 3]


def test_num_returns_zero(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(num_returns=0)
    def fire_and_forget():
        return None

    assert fire_and_forget.remote() is None


def test_task_error_propagation(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(max_retries=0)
    def boom():
        raise ValueError("bad value")

    with pytest.raises(ValueError, match="bad value"):
        rt.get(boom.remote())


def test_error_propagates_through_dependents(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(max_retries=0)
    def boom():
        raise KeyError("k")

    @rt.remote
    def consume(x):
        return x

    with pytest.raises(KeyError):
        rt.get(consume.remote(boom.remote()))


def test_retries(ray_start_regular):
    rt = ray_start_regular
    counter = {"n": 0}

    @rt.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        counter["n"] += 1
        if counter["n"] < 3:
            raise RuntimeError("transient")
        return counter["n"]

    assert rt.get(flaky.remote()) == 3


def test_nested_tasks_no_deadlock(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 1

    # More nested calls than CPU resources — blocked-worker release must kick in.
    results = rt.get([outer.remote(i) for i in range(10)])
    assert results == [i * 2 + 1 for i in range(10)]


@pytest.mark.leaks("abandons an in-flight sleeping task: the in-process runtime cannot interrupt user code mid-sleep")
def test_wait(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(5)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=3)
    assert ready == [f]
    assert not_ready == [s]


@pytest.mark.leaks("abandons an in-flight sleeping task: the in-process runtime cannot interrupt user code mid-sleep")
def test_wait_timeout_empty(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def slow():
        time.sleep(10)

    ready, not_ready = rt.wait([slow.remote()], num_returns=1, timeout=0.1)
    assert ready == []
    assert len(not_ready) == 1


@pytest.mark.leaks("abandons an in-flight sleeping task: the in-process runtime cannot interrupt user code mid-sleep")
def test_get_timeout(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def slow():
        time.sleep(10)

    with pytest.raises(rt.GetTimeoutError):
        rt.get(slow.remote(), timeout=0.1)


def test_generator_streaming(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * i

    items = [rt.get(ref) for ref in gen.remote(5)]
    assert items == [0, 1, 4, 9, 16]


@pytest.mark.leaks("abandons an in-flight sleeping task: the in-process runtime cannot interrupt user code mid-sleep")
def test_cancel_pending(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def blocker():
        time.sleep(30)

    @rt.remote
    def target():
        return 1

    # Saturate CPUs so target stays queued, then cancel it.
    blockers = [blocker.remote() for _ in range(4)]
    t = target.remote()
    time.sleep(0.2)
    rt.cancel(t)
    with pytest.raises(rt.TaskCancelledError):
        rt.get(t, timeout=5)
    del blockers


def test_options_override(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def whoami():
        return 1

    ref = whoami.options(num_cpus=2).remote()
    assert rt.get(ref) == 1


def test_resources_respected(ray_start_regular):
    rt = ray_start_regular
    total = rt.cluster_resources()
    assert total["CPU"] == 4
    assert total["GPU"] == 8

    @rt.remote(num_gpus=8)
    def use_all_gpus():
        return rt.available_resources().get("GPU", 0)

    assert rt.get(use_all_gpus.remote()) == 0


def test_infeasible_task_errors(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(num_cpus=1000, max_retries=0)
    def huge():
        return 1

    with pytest.raises(RuntimeError, match="no feasible node"):
        rt.get(huge.remote(), timeout=5)


def test_remote_function_direct_call_rejected(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    def f():
        return 1

    with pytest.raises(TypeError, match="remote"):
        f()
