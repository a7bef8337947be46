"""The port's ``PagedLLMEngine`` against the JAX ``PagedLLMEngine``.

Both engines run ``tiny(max_seq_len=64)`` in f32 with the same weights
(carried across by ``params_from_numpy``) and the geometry of
``test_serve_paged.py`` (buckets 16/32, chunk 4, 2 slots, 8-token blocks,
129-block pool); the JAX engine runs its gather path, the port its plain
attention version on the CPU. Greedy streams must be token-identical and
prefix hits must count the same tokens. Sampled streams differ by design
(torch generators are not threefry), so they are held to finishing, staying
in the vocab and repeating for a seed.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.serve.llm import PagedLLMEngine as JaxEngine
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.errors import Saturated
from ray_tpu_torch.serve.llm import PagedLLMEngine

torch.backends.cuda.matmul.allow_tf32 = False

BT = 8
GEOM = dict(prompt_buckets=(16, 32), chunk=4, slots=2, block_tokens=BT,
            pool_blocks=129)
PROMPTS = [[7, 3, 11], [2, 4, 6, 8, 10], [1] * 9, [5, 9] * 7,
           list(range(100, 125))]  # last spans the 32 bucket


@pytest.fixture(scope="module")
def engines():
    jcfg = jtf.tiny(max_seq_len=64)
    jparams = jtf.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jeng = JaxEngine(jparams, jcfg, attention_kernel="gather", max_queue=0,
                     name="jax-ref", **GEOM)
    jeng.warmup()
    teng = PagedLLMEngine(tparams, ttf.tiny(max_seq_len=64), device="cpu",
                          max_queue=0, name="torch-port", **GEOM)
    teng.warmup()
    return jeng, teng, tparams


def _concurrent(eng, prompts, n, **kw):
    outs = [None] * len(prompts)
    errs = []

    def client(i):
        try:
            time.sleep(i * 0.01)
            outs[i] = eng.generate(prompts[i], max_new_tokens=n, **kw)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return outs


def _hits(eng):
    return eng.kv.stats()["kv_hit_tokens"]


def test_greedy_concurrent_across_buckets(engines):
    jeng, teng, _ = engines
    want = [jeng.generate(p, max_new_tokens=12) for p in PROMPTS]
    got = _concurrent(teng, PROMPTS, 12)
    assert got == want
    assert teng.kv.active_blocks() == 0


def test_warm_repeat_hits_like_jax(engines):
    jeng, teng, _ = engines
    p = list(range(200, 220))   # 20 tokens: 2 full blocks + tail
    for _ in range(2):
        h_j, h_t = _hits(jeng), _hits(teng)
        want = jeng.generate(p, max_new_tokens=8)
        got = teng.generate(p, max_new_tokens=8)
        assert got == want
        assert _hits(teng) - h_t == _hits(jeng) - h_j
    assert _hits(teng) - h_t >= 2 * BT      # the warm run did hit


def test_forked_tails_decode_independently(engines):
    """Follow-up turns of one retired chain hit its partial tail block
    copy-on-write and diverge; each matches JAX, so no fork's writes reach
    the shared original that the next fork copies."""
    jeng, teng, _ = engines
    base = [31 + 2 * i for i in range(13)]
    first_j = jeng.generate(base, max_new_tokens=4)
    first_t = teng.generate(base, max_new_tokens=4)
    assert first_t == first_j
    chain = base + first_t                    # 17 tokens: 2 full + tail 1
    forks = [chain + [240], chain + [241, 242], chain + [243]]
    cow_before = teng.kv.stats()["kv_cow_copies"]
    for f in forks:
        h_j, h_t = _hits(jeng), _hits(teng)
        assert teng.generate(f, max_new_tokens=6) == jeng.generate(
            f, max_new_tokens=6)
        assert _hits(teng) - h_t == _hits(jeng) - h_j
    assert teng.kv.stats()["kv_cow_copies"] > cow_before
    assert teng.kv.active_blocks() == 0


def test_refcounts_drain_after_cancel(engines):
    _, teng, _ = engines
    req = teng.submit([3, 1, 4, 1, 5], max_new_tokens=40)
    gen = teng.drive(req)
    assert isinstance(next(gen), int)
    gen.close()                              # abandon mid-stream → cancel
    assert req.finish_reason == "cancelled"
    queued = teng.submit([9, 9, 9], max_new_tokens=4)
    teng._cancel(queued)
    assert teng.kv.active_blocks() == 0
    assert teng.stats()["queue_depth"] == 0.0


def test_out_of_vocab_prompt_rejected(engines):
    _, teng, _ = engines
    with pytest.raises(ValueError, match="token ids"):
        teng.generate([1, 2, 256], max_new_tokens=4)
    with pytest.raises(ValueError, match="token ids"):
        teng.generate([-1, 2, 3], max_new_tokens=4)


def test_saturated_past_max_queue(engines):
    _, _, tparams = engines
    eng = PagedLLMEngine(tparams, ttf.tiny(max_seq_len=64), device="cpu",
                         max_queue=2, name="shed", **GEOM)
    reqs = [eng.submit([1, 2, 3], max_new_tokens=4) for _ in range(2)]
    with pytest.raises(Saturated) as ei:
        eng.submit([1, 2, 3], max_new_tokens=4)
    assert ei.value.reason == "saturated"
    assert ei.value.retry_after_s == pytest.approx(2 * 0.05)
    import pickle
    again = pickle.loads(pickle.dumps(ei.value))
    assert (again.reason, again.retry_after_s) == ("saturated",
                                                   ei.value.retry_after_s)
    for r in reqs:
        eng._cancel(r)
    assert eng.stats()["queue_depth"] == 0.0


def test_sampled_finish_in_vocab_and_repeat(engines):
    _, teng, _ = engines
    runs = _concurrent(teng, [PROMPTS[1], PROMPTS[3], PROMPTS[1]], 12,
                       temperature=0.8, seed=123)
    for out in runs:
        assert len(out) == 12
        assert all(0 <= t < 256 for t in out)
    assert runs[0] == runs[2]
    assert teng.generate(PROMPTS[1], max_new_tokens=12, temperature=0.8,
                         seed=123) == runs[0]
    assert teng.generate(PROMPTS[1], max_new_tokens=12, temperature=0.8,
                         seed=7) != runs[0]
    assert teng.kv.active_blocks() == 0


def test_serve_knobs_match_the_jax_defaults(monkeypatch):
    from ray_tpu.core.config import Config as JaxConfig
    from ray_tpu_torch.core.config import Config, config

    port = config()
    names = [n for n, v in vars(Config).items()
             if type(v).__name__ == "_Flag"]
    assert len(names) == 7
    for n in names:
        assert getattr(port, n) == getattr(JaxConfig, n).default, n
    monkeypatch.setenv("RAY_TPU_SERVE_LLM_SLOTS", "3")
    monkeypatch.setenv("RAY_TPU_SERVE_PAGED_ATTENTION_KERNEL", "gather")
    assert (config().serve_llm_slots,
            config().serve_paged_attention_kernel) == (3, "gather")
    monkeypatch.setenv("RAY_TPU_SERVE_KV_BLOCK_TOKENS", "many")
    with pytest.raises(ValueError, match="RAY_TPU_SERVE_KV_BLOCK_TOKENS"):
        config()


def test_device_defaults_to_the_card():
    """No device and no card: the engine raises instead of running on the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params = ttf.init_params(ttf.tiny(), 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedLLMEngine(params, ttf.tiny(), **GEOM)
    with pytest.raises(NotImplementedError, match="speculative"):
        PagedLLMEngine(params, ttf.tiny(), device="cpu", spec_tokens=2,
                       **GEOM)
