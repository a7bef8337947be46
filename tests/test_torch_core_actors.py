"""The port's runtime (``ray_tpu_torch``) through ``tests/test_core_actors.py``, with
the card (``GPU``) where the JAX package names TPU chips.

Actor tests: lifecycle, ordering, named actors, async actors, kill/restart —
the reference's ``python/ray/tests/test_actor.py`` surface."""

import asyncio
import time

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


def test_actor_basic(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, by=1):
            self.n += by
            return self.n

        def value(self):
            return self.n

    c = Counter.remote(10)
    assert rt.get(c.incr.remote()) == 11
    assert rt.get(c.incr.remote(5)) == 16
    assert rt.get(c.value.remote()) == 16


def test_actor_method_ordering(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class Log:
        def __init__(self):
            self.items = []

        def append(self, x):
            self.items.append(x)

        def get_items(self):
            return self.items

    log = Log.remote()
    for i in range(50):
        log.append.remote(i)
    assert rt.get(log.get_items.remote()) == list(range(50))


def test_actor_method_error_does_not_kill(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class A:
        def bad(self):
            raise ValueError("nope")

        def good(self):
            return "ok"

    a = A.remote()
    with pytest.raises(ValueError):
        rt.get(a.bad.remote())
    assert rt.get(a.good.remote()) == "ok"


def test_actor_creation_failure(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("ctor boom")

        def m(self):
            return 1

    b = Broken.remote()
    with pytest.raises(rt.ActorError):
        rt.get(b.m.remote(), timeout=10)


def test_named_actor(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="svc1").remote()
    h = rt.get_actor("svc1")
    assert rt.get(h.ping.remote()) == "pong"


def test_named_actor_duplicate_rejected(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class Svc:
        def ping(self):
            return 1

    Svc.options(name="dup").remote()
    time.sleep(0.2)
    with pytest.raises(ValueError, match="already taken"):
        Svc.options(name="dup").remote()


def test_get_if_exists(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class Singleton:
        def __init__(self):
            self.token = time.time()

        def get_token(self):
            return self.token

    a = Singleton.options(name="s", get_if_exists=True).remote()
    t1 = rt.get(a.get_token.remote())
    b = Singleton.options(name="s", get_if_exists=True).remote()
    t2 = rt.get(b.get_token.remote())
    assert t1 == t2


def test_kill_actor(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class A:
        def m(self):
            return 1

    a = A.remote()
    assert rt.get(a.m.remote()) == 1
    rt.kill(a)
    with pytest.raises(rt.ActorError):
        rt.get(a.m.remote(), timeout=10)


def test_actor_restart(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.state = "alive"

        def get_state(self):
            return self.state

    p = Phoenix.remote()
    assert rt.get(p.get_state.remote()) == "alive"
    rt.kill(p, no_restart=False)
    time.sleep(0.5)
    # After restart the actor serves calls again (state reset).
    assert rt.get(p.get_state.remote(), timeout=10) == "alive"


def test_async_actor(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(max_concurrency=4)
    class AsyncWorker:
        async def work(self, i):
            await asyncio.sleep(0.1)
            return i * 2

    w = AsyncWorker.remote()
    start = time.time()
    refs = [w.work.remote(i) for i in range(4)]
    assert rt.get(refs) == [0, 2, 4, 6]
    # 4 concurrent 0.1s sleeps should take well under 0.4s total.
    assert time.time() - start < 2.0


def test_threaded_actor_concurrency(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(max_concurrency=4)
    class Sleeper:
        def nap(self):
            time.sleep(0.2)
            return 1

    s = Sleeper.remote()
    start = time.time()
    assert sum(rt.get([s.nap.remote() for _ in range(4)])) == 4
    assert time.time() - start < 0.79  # serial would be 0.8s


def test_actor_handle_in_task(ray_start_regular):
    rt = ray_start_regular

    @rt.remote
    class Store:
        def __init__(self):
            self.v = 0

        def set(self, v):
            self.v = v

        def get_v(self):
            return self.v

    @rt.remote
    def writer(store, v):
        rt.get(store.set.remote(v))
        return True

    s = Store.remote()
    rt.get(writer.remote(s, 42))
    assert rt.get(s.get_v.remote()) == 42


def test_actor_resources_held(ray_start_regular):
    rt = ray_start_regular

    @rt.remote(num_gpus=4)
    class MeshHolder:
        def ping(self):
            return 1

    m = MeshHolder.remote()
    assert rt.get(m.ping.remote()) == 1
    assert rt.available_resources().get("GPU", 0) == 4
    rt.kill(m)
    time.sleep(0.3)
    assert rt.available_resources().get("GPU", 0) == 8
