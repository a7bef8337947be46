"""The port's prefill/decode disaggregation against the JAX package's.

Both packages run ``tiny(max_seq_len=64)`` in f32 on the CPU with the same
weights (carried across by ``params_from_numpy``) and the geometry of
``test_serve_paged.py``'s disaggregation tests (buckets 16/32, chunk 4, 2
decode slots, 8-token blocks, 65-block pools); the JAX engines attend
through their gather path, the port's through the plain paged-attention
version. Tolerances: the handoff's block transfer (``extract_fn``,
``insert_fn``) is exact; ``prefill_to_blocks``' K, V and last-token logits
agree with JAX's to 1e-5 (f32 sums in another order); greedy streams and
prefix-hit counts are equal. Sampled streams are held to the port's
colocated ``PagedLLMEngine`` for the same seed, token for token (torch
generators are not threefry, so JAX's sampled streams differ by design).
"""

import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jgen
from ray_tpu.models import transformer as jtf
from ray_tpu.serve.llm import DisaggregatedLLMEngine as JaxDisagg
from ray_tpu.serve.llm import PagedLLMEngine as JaxPaged
from ray_tpu_torch.dag.channel import SHM_DIR
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import DisaggregatedLLMEngine, PagedLLMEngine

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

BT = 8
GEOM = dict(prompt_buckets=(16, 32), chunk=4, slots=2, max_queue=0,
            block_tokens=BT, pool_blocks=65)
PROMPTS = [[7, 3, 11], [2, 4, 6, 8, 10], [1] * 9, [5, 9] * 7,
           list(range(100, 125))]  # last spans the 32 bucket
TOL = 1e-5


@pytest.fixture(scope="module", params=["learned", "rope"])
def model(request):
    jcfg = jtf.tiny(max_seq_len=64, pos=request.param)
    jparams = jtf.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jparams, ttf.tiny(max_seq_len=64, pos=request.param),
            tparams)


@pytest.fixture(scope="module")
def disagg(model):
    """JAX's and the port's disaggregated engines on the same weights; the
    port's engine is closed twice at teardown and must leave no worker
    thread and no lane file behind."""
    jcfg, jparams, tcfg, tparams = model
    jeng = JaxDisagg(jparams, jcfg, name="jax-disagg", **GEOM)
    jeng.warmup()
    teng = DisaggregatedLLMEngine(tparams, tcfg, device="cpu",
                                  name="port-disagg", **GEOM)
    teng.warmup()
    lane_file = os.path.join(SHM_DIR, teng.lane.name)
    assert os.path.exists(lane_file)
    yield jeng, teng
    jeng.close()
    teng.close()
    teng.close()  # idempotent
    assert not [t for t in threading.enumerate()
                if t.name.startswith("port-disagg-disagg")]
    assert not os.path.exists(lane_file)


def _drained(teng):
    assert teng.decode.kv.active_blocks() == 0
    assert teng.prefill.kv.active_blocks() == 0


def test_extract_and_insert_equal_jax():
    """The handoff's block gather and block write, exactly JAX's on the same
    pools and ids; the write lands in the pool tensors themselves."""
    jcfg = jtf.tiny(max_seq_len=64)
    jparams = jtf.init_params(jcfg, jax.random.key(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(slots=2, num_blocks=17, block_tokens=BT)
    jpg = jgen.PagedGenerator(jparams, jcfg, **kw)
    tpg = tgen.PagedGenerator(tparams, ttf.tiny(max_seq_len=64),
                              device="cpu", **kw)
    rng = np.random.default_rng(0)
    shape = (jcfg.n_layers, 17, BT, jcfg.n_heads, jcfg.head_dim)
    kp, vp = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    ids = np.array([5, 2, 11], np.int32)
    jk, jv = jpg.extract_fn(3)(jax.numpy.asarray(kp), jax.numpy.asarray(vp),
                               ids)
    tkp, tvp = torch.tensor(kp), torch.tensor(vp)
    tk, tv = tpg.extract_fn(3)(tkp, tvp, ids)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tkp.numpy(), kp)  # extract leaves pools

    nk, nv = (rng.standard_normal((jcfg.n_layers, 3, BT, jcfg.n_heads,
                                   jcfg.head_dim)).astype(np.float32)
              for _ in range(2))
    dst = np.array([9, 1, 16], np.int32)
    jkp, jvp = jpg.insert_fn(3)(jax.numpy.asarray(kp), jax.numpy.asarray(vp),
                                nk, nv, dst)
    out_k, out_v = tpg.insert_fn(3)(tkp, tvp, torch.tensor(nk),
                                    torch.tensor(nv), dst)
    assert out_k is tkp and out_v is tvp
    np.testing.assert_array_equal(tkp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(jvp))


def test_prefill_to_blocks_matches_jax(model):
    """K, V and the last-token logits of a prefill's blocks within 1e-5 of
    JAX's; a second prompt sharing a 2-block prefix hits the same tokens
    and its suffix prefill still agrees."""
    jcfg, jparams, tcfg, tparams = model
    jeng = JaxPaged(jparams, jcfg, attention_kernel="gather", name="jax-pf",
                    **GEOM)
    teng = PagedLLMEngine(tparams, tcfg, device="cpu", name="port-pf",
                          **GEOM)
    prefix = [40 + i for i in range(2 * BT)]
    for prompt, want_hit in ((prefix + [3, 1, 4], 0),
                             (prefix + [9, 2, 6, 5], 2 * BT)):
        jk, jv, jlast, jhit = jeng.prefill_to_blocks(prompt, seed=3)
        tk, tv, tlast, thit = teng.prefill_to_blocks(prompt, seed=3)
        assert thit == jhit == want_hit
        assert tk.shape == jk.shape == (jcfg.n_layers, 3, BT, jcfg.n_heads,
                                        jcfg.head_dim)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(tlast, np.asarray(jlast), atol=TOL, rtol=0)
    assert teng.kv.active_blocks() == 0


def test_greedy_matches_jax_and_oracle(model, disagg):
    jeng, teng = disagg
    _, _, tcfg, tparams = model
    oracle = tgen.Generator(tparams, tcfg, device="cpu")
    for p in PROMPTS:
        want = jeng.generate(p, max_new_tokens=8)
        assert teng.generate(p, max_new_tokens=8) == want, p
        assert oracle.generate(p, max_new_tokens=8) == want, p
    _drained(teng)


def test_shared_prefix_hit_delta_matches_jax(disagg):
    """Sequential requests sharing a 2-block prefix pay its prefill once on
    the prefill engine: the hit-token delta equals JAX's, and so do the
    streams."""
    jeng, teng = disagg
    prefix = [151 + i for i in range(2 * BT)]
    prompts = [prefix + [231 + i] for i in range(3)]
    j0 = jeng.stats()["prefill_kv_hit_tokens"]
    t0 = teng.stats()["prefill_kv_hit_tokens"]
    for p in prompts:
        assert teng.generate(p, max_new_tokens=6) == \
            jeng.generate(p, max_new_tokens=6)
    dj = jeng.stats()["prefill_kv_hit_tokens"] - j0
    dt = teng.stats()["prefill_kv_hit_tokens"] - t0
    assert dt == dj >= 2 * (2 * BT)
    _drained(teng)


def test_concurrent_greedy_matches_jax(disagg):
    """Twice as many requests as decode slots, from concurrent threads with
    a short interpreter switch interval: each stream equals JAX's (a
    handoff paired with the wrong ticket would give another prompt's
    tokens) and blocks drain."""
    jeng, teng = disagg
    prompts = PROMPTS + [p[::-1] for p in PROMPTS]
    want = [jeng.generate(p, max_new_tokens=6) for p in prompts]
    outs, errs = [None] * len(prompts), []

    def client(i):
        try:
            outs[i] = teng.generate(prompts[i], max_new_tokens=6)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert outs == want
    _drained(teng)


def test_sampled_equals_colocated_engine(model, disagg):
    """The decode engine re-seeds the slot's generator at attach and the
    prefill draws nothing, so a sampled stream equals the colocated engine's
    for the same seed."""
    _, teng = disagg
    _, _, tcfg, tparams = model
    colo = PagedLLMEngine(tparams, tcfg, device="cpu", name="port-colo",
                          **GEOM)
    for p, temp, seed in ((PROMPTS[1], 0.7, 9), (PROMPTS[4], 1.0, 21)):
        want = colo.generate(p, max_new_tokens=8, temperature=temp,
                             seed=seed)
        got = teng.generate(p, max_new_tokens=8, temperature=temp, seed=seed)
        assert got == want
    _drained(teng)


def test_send_failure_poisons_one_request_only(disagg):
    """A lane.send failure (not a timeout) resolves ONLY its own ticket as
    an error and unqueues it from the handoff FIFO — the next request pairs
    with its own payload, and the stream reports finish_reason "error"."""
    jeng, teng = disagg
    orig_send = teng.lane.send
    calls = {"n": 0}

    def flaky(meta, k, v, timeout=30.0):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("payload exceeds lane capacity")
        return orig_send(meta, k, v, timeout=timeout)

    teng.lane.send = flaky
    try:
        result = {}
        with pytest.raises(ValueError, match="lane capacity"):
            list(teng.stream([61, 62, 63], max_new_tokens=4, result=result))
        assert result["finish_reason"] == "error"
        p = [64, 65, 66, 67]
        assert teng.generate(p, max_new_tokens=6) == \
            jeng.generate(p, max_new_tokens=6)
    finally:
        teng.lane.send = orig_send
    _drained(teng)


def test_abandoned_stream_drains_blocks(disagg):
    """A stream dropped after its first token cancels its decode request:
    blocks drain on both engines."""
    _, teng = disagg
    gen = teng.stream(PROMPTS[3], max_new_tokens=20)
    assert isinstance(next(gen), int)
    gen.close()
    _drained(teng)
