"""The slice end to end on ``tiny``: the paged engine in worker processes.

A JAX ``Cluster`` and a port ``Cluster``, two node daemons each, host the
paged engine in a worker-process actor: JAX's ``PagedLLMEngine`` in a JAX
worker, the port's in a port worker (``device="cpu"``), from the same JAX
``init_params`` carried across by ``params_from_numpy`` and sent through
each cluster's object store. The same greedy requests, one after another
and then from one thread each, give token-identical streams, the same
prefix-hit tokens and the same drained pools. Then the same through
``serve.run(llm_deployment(...))`` over handles on each cluster. The test
module is pickled by value (``cloudpickle.register_pickle_by_value``):
the workers cannot import it.
"""

import os
import sys
import threading

import cloudpickle
import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jruntime
from ray_tpu.core.cluster import Cluster as JaxCluster
from ray_tpu.core.cluster import connect as jconnect
from ray_tpu.models import transformer as jtf
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as truntime
from ray_tpu_torch.core.cluster import Cluster
from ray_tpu_torch.core.cluster import connect
from ray_tpu_torch.models.convert import params_from_numpy

cloudpickle.register_pickle_by_value(sys.modules[__name__])

GEOM = dict(prompt_buckets=(16, 32), chunk=4, slots=2, block_tokens=8,
            pool_blocks=129)
SHARED = list(range(30, 46))                     # two 8-token blocks
PROMPTS = [SHARED + [7, 3, 11], SHARED + [2, 4], [1] * 9, [5, 9] * 7,
           list(range(100, 125))]
N_NEW = 10


def _cfg(mod):
    return mod.tiny(max_seq_len=64)


class JaxHost:
    """JAX's paged engine in a JAX worker process."""

    def __init__(self, params):
        import jax.numpy as jnp

        from ray_tpu.serve.llm import PagedLLMEngine

        self.eng = PagedLLMEngine(jax.tree.map(jnp.asarray, params),
                                  _cfg(jtf), attention_kernel="gather",
                                  max_queue=0, name="jax-worker", **GEOM)
        self.eng.warmup()

    def generate(self, prompt, n):
        return self.eng.generate(prompt, max_new_tokens=n)

    def report(self):
        return (os.getpid(), float(self.eng.stats()["kv_hit_tokens"]),
                self.eng.kv.active_blocks())


class TorchHost:
    """The port's paged engine in a port worker process."""

    def __init__(self, params):
        from ray_tpu_torch.models import transformer as ttf
        from ray_tpu_torch.serve.llm import PagedLLMEngine

        self.eng = PagedLLMEngine(params, _cfg(ttf), device="cpu",
                                  max_queue=0, name="torch-worker", **GEOM)
        self.eng.warmup()

    def generate(self, prompt, n):
        return self.eng.generate(prompt, max_new_tokens=n)

    def report(self):
        return (os.getpid(), float(self.eng.stats()["kv_hit_tokens"]),
                self.eng.kv.active_blocks())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_per_process():
    """Every process a Cluster starts inherits the environment: one torch
    thread each, so parallel test workers do not oversubscribe the host."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def params():
    jparams = jax.tree.map(lambda p: p * 3.0,   # varied greedy output
                           jtf.init_params(_cfg(jtf), jax.random.key(0)))
    np_params = jax.tree.map(np.asarray, jparams)
    return np_params, params_from_numpy(np_params, "cpu")


@pytest.fixture(scope="module")
def clusters():
    jc = JaxCluster(num_nodes=2, resources_per_node={"CPU": 2})
    tc = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    yield jc, tc
    tc.shutdown()
    jc.shutdown()


@pytest.fixture
def drivers(clusters):
    jc, tc = clusters
    jcore = jconnect(jc.gcs_address)
    tcore = connect(tc.gcs_address)
    yield ray_tpu, ray_tpu_torch
    for mod, core, rt_mod in ((jserve, jcore, jruntime),
                              (tserve, tcore, truntime)):
        try:
            mod.shutdown()
        finally:
            core.shutdown()
            rt_mod._global_runtime = None


def _from_threads(call, n):
    outs, errs = [None] * n, []

    def client(i):
        try:
            outs[i] = call(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return outs


def _drive(rt, host_cls, params_ref):
    host = rt.remote(max_concurrency=4)(host_cls).remote(params_ref)
    serial = [rt.get(host.generate.remote(p, N_NEW), timeout=120)
              for p in PROMPTS]
    concurrent = _from_threads(lambda i: rt.get(
        host.generate.remote(PROMPTS[i], N_NEW), timeout=120), len(PROMPTS))
    return serial, concurrent, rt.get(host.report.remote(), timeout=60)


def test_engine_in_worker_processes_equals_jax(drivers, params):
    jrt, trt = drivers
    np_params, tparams = params
    want, want_c, (jpid, jhits, jactive) = _drive(
        jrt, JaxHost, jrt.put(np_params))
    got, got_c, (tpid, thits, tactive) = _drive(
        trt, TorchHost, trt.put(tparams))
    assert got == want and got_c == want_c == want
    assert thits == jhits >= len(SHARED)   # the shared prefix was reused
    assert tactive == jactive == 0
    assert tpid != os.getpid() and jpid != os.getpid()


def _serve_streams(handle):
    def one(i):
        items = list(handle.options(stream=True).remote(
            {"prompt_ids": PROMPTS[i], "max_new_tokens": N_NEW}))
        assert [it["index"] for it in items] == list(range(N_NEW))
        assert "finish_reason" in items[-1]
        return [it["token"] for it in items]

    return [one(i) for i in range(len(PROMPTS))], _from_threads(
        one, len(PROMPTS))


def test_llm_deployment_on_worker_processes_equals_jax(drivers, params):
    from ray_tpu.serve import llm as jllm
    from ray_tpu_torch.models import transformer as ttf
    from ray_tpu_torch.serve import llm as tllm

    jrt, trt = drivers
    np_params, tparams = params
    jref, tref = jrt.put(np_params), trt.put(tparams)
    jbox, tbox = [jref], [tref]   # refs inside a list ride as borrows

    def jparams_fn():
        import jax.numpy as jnp

        return jax.tree.map(jnp.asarray, ray_tpu.get(jbox[0]))

    def tparams_fn():
        return ray_tpu_torch.get(tbox[0])

    jhandle = jserve.run(jllm.llm_deployment(
        _cfg(jtf), jparams_fn, name="lm", slots=2, chunk=4).bind())
    thandle = tserve.run(tllm.llm_deployment(
        _cfg(ttf), tparams_fn, name="lm", slots=2, chunk=4,
        device="cpu").bind())
    want, want_c = _serve_streams(jhandle)
    got, got_c = _serve_streams(thandle)
    assert got == want and got_c == want_c == want
