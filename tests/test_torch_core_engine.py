"""The slice end to end on ``tiny``: the paged engine hosted in an actor.

JAX's ``PagedLLMEngine`` inside a JAX actor (``ray_tpu.init``) and the
port's inside a port actor (``ray_tpu_torch.init``, ``device="cpu"``), from
the same ``init_params`` carried across by ``params_from_numpy``, answer the
same concurrent greedy requests as ``.remote()`` calls from one thread each
(the actors' threads are the engines' request threads): the streams must be
token-identical, and the port's must also equal a direct port engine's.
The port's actor streams its tokens back through a streaming generator as
well, and its ``serve_tokens_total`` reaches the runtime's GCS aggregator
through the exporter. The two runtimes are separate module singletons and
run one after the other in this process.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import transformer as jtf
from ray_tpu.serve.llm import PagedLLMEngine as JaxEngine
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import PagedLLMEngine

GEOM = dict(prompt_buckets=(16, 32), chunk=4, slots=2, block_tokens=8,
            pool_blocks=129)
PROMPTS = [[7, 3, 11], [2, 4, 6, 8, 10], [1] * 9, [5, 9] * 7,
           list(range(100, 125))]
N_NEW = 10


class JaxHost:
    """A JAX engine in an actor."""

    def __init__(self, params):
        self.eng = JaxEngine(params, jtf.tiny(max_seq_len=64),
                             attention_kernel="gather", max_queue=0,
                             name="jax-actor", **GEOM)
        self.eng.warmup()

    def generate(self, prompt, n):
        return self.eng.generate(prompt, max_new_tokens=n)


class TorchHost:
    """The port's engine in an actor."""

    def __init__(self, params, name):
        self.eng = PagedLLMEngine(params, ttf.tiny(max_seq_len=64),
                                  device="cpu", max_queue=0, name=name,
                                  **GEOM)
        self.eng.warmup()

    def generate(self, prompt, n):
        return self.eng.generate(prompt, max_new_tokens=n)

    def stream(self, prompt, n):
        yield from self.eng.stream(prompt, max_new_tokens=n)

    def active_blocks(self):
        return self.eng.kv.active_blocks()


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the tiny model gains nothing from more, and the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_params(jtf.tiny(max_seq_len=64), jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jparams, tparams


def _from_threads(call, n_clients):
    """``call(i)`` from one thread each; results in order."""
    outs, errs = [None] * n_clients, []

    def client(i):
        try:
            outs[i] = call(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return outs


def test_engine_actor_streams_equal_jax_actor(params):
    jparams, tparams = params
    ray_tpu.init(resources={"CPU": 4})
    try:
        jhost = ray_tpu.remote(max_concurrency=4)(JaxHost).remote(jparams)
        want = _from_threads(lambda i: ray_tpu.get(
            jhost.generate.remote(PROMPTS[i], N_NEW), timeout=120),
            len(PROMPTS))
    finally:
        ray_tpu.shutdown()

    direct = PagedLLMEngine(tparams, ttf.tiny(max_seq_len=64), device="cpu",
                            max_queue=0, name="direct", **GEOM)
    direct.warmup()
    assert [direct.generate(p, max_new_tokens=N_NEW) for p in PROMPTS] == want

    ray_tpu_torch.init(resources={"CPU": 4})
    try:
        host = ray_tpu_torch.remote(max_concurrency=4)(TorchHost).remote(
            tparams, "torch-actor")
        got = _from_threads(lambda i: ray_tpu_torch.get(
            host.generate.remote(PROMPTS[i], N_NEW), timeout=120),
            len(PROMPTS))
        streamed = _from_threads(lambda i: [
            ray_tpu_torch.get(ref, timeout=120) for ref in
            host.stream.options(num_returns="streaming").remote(
                PROMPTS[i], N_NEW)], len(PROMPTS))
        assert ray_tpu_torch.get(host.active_blocks.remote()) == 0
    finally:
        ray_tpu_torch.shutdown()
    assert got == want
    assert streamed == want


def test_serve_tokens_reach_the_gcs_aggregator(params):
    from ray_tpu_torch.core.runtime import get_runtime

    _, tparams = params
    ray_tpu_torch.init(resources={"CPU": 2})
    try:
        host = ray_tpu_torch.remote(max_concurrency=2)(TorchHost).remote(
            tparams, "tokens-actor")
        outs = ray_tpu_torch.get([host.generate.remote(p, 6)
                                  for p in PROMPTS[:3]], timeout=120)
        delivered = sum(len(o) for o in outs)
        rt = get_runtime()
        rt._metrics_exporter.flush()
        rows = [m for m in rt.gcs.metrics_summary()["metrics"]
                if m["name"] == "ray_tpu_serve_tokens_total"]
        text = rt.gcs.metrics_text()
    finally:
        ray_tpu_torch.shutdown()
    assert rows
    line = next(ln for ln in text.splitlines()
                if ln.startswith("ray_tpu_serve_tokens_total{")
                and 'deployment="tokens-actor"' in ln)
    assert float(line.rsplit(" ", 1)[1]) == delivered == 18
