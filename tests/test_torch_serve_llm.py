"""The port's engines against the JAX engines: ``PagedLLMEngine`` and the
slotted ``LLMEngine``.

Both packages run ``tiny(max_seq_len=64)`` in f32 with the same weights
(carried across by ``params_from_numpy``) and the geometry of
``test_serve_paged.py`` (buckets 16/32, chunk 4, 2 slots, 8-token blocks,
129-block pool); the JAX engine runs its gather path, the port its plain
attention version on the CPU. Greedy streams must be token-identical and
prefix hits must count the same tokens. Sampled streams differ by design
(torch generators are not threefry), so they are held to finishing, staying
in the vocab and repeating for a seed. The slotted engines run the same
weights and geometry (less the pool), and their greedy streams must equal
JAX's, the port's paged engine's and the port's ``Generator``'s.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.serve.llm import LLMEngine as JaxSlotted
from ray_tpu.serve.llm import PagedLLMEngine as JaxEngine
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.generate import Generator
from ray_tpu_torch.serve.errors import Saturated
from ray_tpu_torch.serve.llm import LLMEngine, PagedLLMEngine

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

torch.backends.cuda.matmul.allow_tf32 = False

BT = 8
SLOT_GEOM = dict(prompt_buckets=(16, 32), chunk=4, slots=2)
GEOM = dict(SLOT_GEOM, block_tokens=BT, pool_blocks=129)
PROMPTS = [[7, 3, 11], [2, 4, 6, 8, 10], [1] * 9, [5, 9] * 7,
           list(range(100, 125))]  # last spans the 32 bucket


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this module: its tiny-model ops gain nothing
    from more, and the suite's workers share the cores, where extra threads
    only contend (several times slower under a full test run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    assert len(names) == 83   # 21 serve knobs (the KV tier's 5 among
    #                           them), 9 of the transport and observability
    #                           modules, 14 of the runtime, 34 of the
    #                           multi-process cluster, 5 of the compiled
    #                           DAG and the collectives
    for n in names:
        if n == "object_spilling_dir":  # by design: "" = under TMPDIR
            assert port.object_spilling_dir == ""
            continue
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(params, ttf.tiny(), **SLOT_GEOM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator(params, ttf.tiny())
    with pytest.raises(ValueError, match="draft model"):
        PagedLLMEngine(params, ttf.tiny(), device="cpu", spec_tokens=2,
                       **GEOM)


def test_env_spec_tokens_without_a_draft_raises_as_in_jax(monkeypatch):
    """``RAY_TPU_SERVE_SPEC_TOKENS=2`` and no draft model: both packages'
    paged engines refuse to build (JAX reads its config once a process, so
    its test installs a fresh one)."""
    from ray_tpu.core import config as jconfig

    monkeypatch.setenv("RAY_TPU_SERVE_SPEC_TOKENS", "2")
    jcfg = jtf.tiny(max_seq_len=64)
    old = jconfig.config()
    jconfig.set_config(jconfig.Config())
    try:
        with pytest.raises(ValueError, match="draft model"):
            JaxEngine(jtf.init_params(jcfg, jax.random.key(0)), jcfg, **GEOM)
    finally:
        jconfig.set_config(old)
    params = ttf.init_params(ttf.tiny(), 0, device="cpu")
    with pytest.raises(ValueError, match="draft model"):
        PagedLLMEngine(params, ttf.tiny(max_seq_len=64), device="cpu",
                       **GEOM)


def test_env_kv_tier_raises_not_yet_ported(monkeypatch):
    """``RAY_TPU_KV_TIER_ENABLED=1`` turns the cluster KV tier on, in JAX
    and now in the port (whose paged engine once refused it): the engine
    builds with a tier client, reports the tier's stats, and ``close``
    releases its publishes and is idempotent. Off, there is no client and
    ``close`` is a no-op."""
    from ray_tpu_torch.serve import kv_tier

    params = ttf.init_params(ttf.tiny(), 0, device="cpu")
    eng = PagedLLMEngine(params, ttf.tiny(max_seq_len=64), device="cpu",
                         **GEOM)
    assert eng._tier is None and "kv_tier_spilled_blocks" not in eng.stats()
    eng.close()
    eng.close()
    monkeypatch.setenv("RAY_TPU_KV_TIER_ENABLED", "1")
    kv_tier.reset_local_backend()
    try:
        eng = PagedLLMEngine(params, ttf.tiny(max_seq_len=64), device="cpu",
                             **GEOM)
        assert isinstance(eng._tier, kv_tier.KVTier)
        eng.warmup()
        eng.generate([5, 9] * 8, max_new_tokens=4)
        assert eng.stats()["kv_tier_spilled_blocks"] >= 2
        eng.close()
        eng.close()
        assert kv_tier._local_backend().stats()["prefix_dir_refs"] == 0
    finally:
        kv_tier.reset_local_backend()


@pytest.fixture(scope="module")
def slotted(engines):
    jeng, teng, tparams = engines
    jcfg = jtf.tiny(max_seq_len=64)
    jparams = jtf.init_params(jcfg, jax.random.key(0))
    jslot = JaxSlotted(jparams, jcfg, max_queue=0, name="jax-slotted",
                       **SLOT_GEOM)
    jslot.warmup()
    tslot = LLMEngine(tparams, ttf.tiny(max_seq_len=64), device="cpu",
                      max_queue=0, name="torch-slotted", **SLOT_GEOM)
    tslot.warmup()
    return jslot, tslot


def test_slotted_greedy_matches_jax_paged_and_generator(engines, slotted):
    """The slotted engine, concurrent across both buckets: JAX's slotted
    engine's streams, the port's paged engine's and the port's
    ``Generator``'s (the single-sequence oracle)."""
    _, teng, tparams = engines
    jslot, tslot = slotted
    want = [jslot.generate(p, max_new_tokens=12) for p in PROMPTS]
    assert _concurrent(tslot, PROMPTS, 12) == want
    assert [teng.generate(p, max_new_tokens=12) for p in PROMPTS] == want
    oracle = Generator(tparams, ttf.tiny(max_seq_len=64), device="cpu")
    assert [oracle.generate(p, max_new_tokens=12) for p in PROMPTS] == want
    assert tslot.stats()["slots_busy"] == 0.0


def test_slotted_length_cap_and_cancel(slotted):
    """A request that would outgrow max_len finishes as length_cap with
    JAX's tokens; an abandoned stream cancels and frees its slot, and a
    cancelled queued request leaves the queue."""
    jslot, tslot = slotted
    prompt = list(range(1, 31))
    res_j, res_t = {}, {}
    want = list(jslot.stream(prompt, max_new_tokens=100, result=res_j))
    got = list(tslot.stream(prompt, max_new_tokens=100, result=res_t))
    assert got == want
    assert res_t["finish_reason"] == res_j["finish_reason"] == "length_cap"
    req = tslot.submit([3, 1, 4, 1, 5], max_new_tokens=40)
    gen = tslot.drive(req)
    assert isinstance(next(gen), int)
    gen.close()
    assert req.finish_reason == "cancelled"
    queued = tslot.submit([9, 9, 9], max_new_tokens=4)
    tslot._cancel(queued)
    st = tslot.stats()
    assert (st["slots_busy"], st["queue_depth"]) == (0.0, 0.0)
    sampled = tslot.generate(PROMPTS[1], max_new_tokens=12, temperature=0.8,
                             seed=123)
    assert sampled == tslot.generate(PROMPTS[1], max_new_tokens=12,
                                     temperature=0.8, seed=123)
    assert all(0 <= t < 256 for t in sampled)


def test_slotted_saturated_past_max_queue(engines):
    _, _, tparams = engines
    eng = LLMEngine(tparams, ttf.tiny(max_seq_len=64), device="cpu",
                    max_queue=1, name="shed-slotted", **SLOT_GEOM)
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(Saturated) as ei:
        eng.submit([1, 2, 3], max_new_tokens=4)
    assert ei.value.retry_after_s == pytest.approx(0.05)
    eng._cancel(req)
    assert eng.stats()["queue_depth"] == 0.0


def test_device_metrics_of_both_engines(engines, slotted):
    """``device_metrics`` runs on a throwaway state and returns both keys
    (on the CPU, CPU times: the card's numbers come from chip_smoke.py)."""
    _, teng, _ = engines
    _, tslot = slotted
    for eng in (teng, tslot):
        m = eng.device_metrics(prompt_len=10, reps=2)
        assert set(m) == {"device_ttft_ms", "device_decode_tokens_per_sec"}
        assert m["device_ttft_ms"] > 0
        assert m["device_decode_tokens_per_sec"] > 0
    assert teng.kv.active_blocks() == 0
