"""The port's speculative decoding against JAX's, class for class of
``test_spec_decode.py``.

Both packages run ``tiny(max_seq_len=64)`` in f32 with the same weights: the
JAX target and its three drafts (``aligned`` = the target, ``near`` = the
target + 0.05 × an independent init, ``miss`` = an independent init, all
scaled 3× so greedy output varies) carried across by ``params_from_numpy``.
The JAX engines run their gather path, the port its plain attention version
on the CPU. Greedy spec streams must be token-identical to the port's plain
engine and to JAX's spec engine at k = 3 and 4, with the same accepted
totals. Sampled streams differ from JAX's by design (torch generators are
not threefry), so the sampled distribution is held to the port's plain
engine.
"""

import collections
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jgen
from ray_tpu.models import transformer as jtf
from ray_tpu.serve.llm import PagedLLMEngine as JaxEngine
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import PagedLLMEngine

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

torch.backends.cuda.matmul.allow_tf32 = False

BT = 8
LOGIT_TOL = 1e-4
ENG_KW = dict(prompt_buckets=(16, 32), chunk=4, slots=2, max_queue=4,
              block_tokens=BT, pool_blocks=80)
PROMPTS = [[5, 9, 3, 77, 21], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2, 1],
           [42] * 12]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this module: its tiny-model ops gain nothing
    from more, and the suite's workers share the cores, where extra threads
    only contend (several times slower under a full test run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def jax_models():
    """JAX's fixture: the target and three drafts, plus a one-layer draft
    (a draft shallower than the target keeps its own pool depth)."""
    cfg = jtf.tiny(max_seq_len=64)
    scale = lambda t: jax.tree.map(lambda p: p * 3.0, t)
    params = scale(jtf.init_params(cfg, jax.random.key(2)))
    miss = scale(jtf.init_params(cfg, jax.random.key(7)))
    near = jax.tree.map(
        lambda p, n: p + 0.05 * n, params,
        scale(jtf.init_params(cfg, jax.random.key(11))))
    shallow_cfg = jtf.tiny(max_seq_len=64, n_layers=1)
    shallow = scale(jtf.init_params(shallow_cfg, jax.random.key(7)))
    drafts = {"aligned": (params, cfg), "near": (near, cfg),
              "miss": (miss, cfg), "shallow": (shallow, shallow_cfg)}
    return cfg, params, drafts


@pytest.fixture(scope="module")
def models(jax_models):
    _, params, drafts = jax_models
    cfg = ttf.tiny(max_seq_len=64)
    tdrafts = {name: (_port(p), ttf.tiny(max_seq_len=64,
                                         n_layers=c.n_layers))
               for name, (p, c) in drafts.items()}
    return cfg, _port(params), tdrafts


def _spec_engine(models, draft, k=3, **kw):
    cfg, params, drafts = models
    dparams, dcfg = drafts[draft]
    return PagedLLMEngine(params, cfg, device="cpu", draft_params=dparams,
                          draft_config=dcfg, spec_tokens=k,
                          name=f"spec-{draft}", **{**ENG_KW, **kw})


@pytest.fixture(scope="module")
def plain(models):
    cfg, params, _ = models
    return PagedLLMEngine(params, cfg, device="cpu", name="spec-base",
                          **ENG_KW)


class TestGreedyTokenIdentity:
    @pytest.mark.parametrize("k", [3, 4])
    @pytest.mark.parametrize("draft", ["aligned", "near", "miss", "shallow"])
    def test_matches_plain_engine_and_jax(self, jax_models, models, plain,
                                          draft, k):
        """Identical greedy tokens whatever the draft, and the same accepted
        and proposed totals as JAX's spec engine. The 'miss' draft's EWMA
        collapses below the floor mid-request: the demotion handoff
        (pending-carry consumption, last-logits refresh) must not skew a
        token."""
        jcfg, jparams, jdrafts = jax_models
        dparams, dcfg = jdrafts[draft]
        jeng = JaxEngine(jparams, jcfg, draft_params=dparams,
                         draft_config=dcfg, spec_tokens=k,
                         attention_kernel="gather", name="jax-spec",
                         **ENG_KW)
        eng = _spec_engine(models, draft, k)
        for p in PROMPTS:
            got = eng.generate(p, max_new_tokens=20)
            assert got == plain.generate(p, max_new_tokens=20)
            assert got == jeng.generate(p, max_new_tokens=20)
        st, jst = eng.stats(), jeng.stats()
        assert st["spec_proposed_total"] > 0
        for key in ("spec_proposed_total", "spec_accepted_total"):
            assert st[key] == jst[key], key
        assert eng.kv.active_blocks() == 0

    def test_acceptance_rates_span_regimes(self, models):
        """The three drafts exercise different acceptance regimes: aligned
        ~1, near in between, miss ~0 (whereupon the gate stops proposing)."""
        ratios = {}
        for draft in ("aligned", "near", "miss"):
            eng = _spec_engine(models, draft)
            eng.generate(PROMPTS[0], max_new_tokens=20)
            st = eng.stats()
            assert st["spec_proposed_total"] > 0
            ratios[draft] = st["spec_accept_ratio"]
        assert ratios["aligned"] > 0.9
        assert ratios["miss"] < 0.2
        assert ratios["miss"] <= ratios["near"] <= ratios["aligned"]

    def test_concurrent_slots(self, models, plain):
        """Staggered concurrent requests share spec decode steps; per-slot
        acceptance state must not bleed across slots."""
        eng = _spec_engine(models, "near")
        outs = [None] * len(PROMPTS)
        errs = []

        def client(i):
            try:
                outs[i] = eng.generate(PROMPTS[i], max_new_tokens=16)
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(PROMPTS))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert not errs, errs
        for i, p in enumerate(PROMPTS):
            assert outs[i] == plain.generate(p, max_new_tokens=16)
        assert eng.kv.active_blocks() == 0


class TestSampledDistribution:
    def test_aligned_draft_accepts_everything(self, models):
        """With draft == target, p(d)/q(d) == 1: rejection sampling accepts
        every proposal whatever the temperature."""
        eng = _spec_engine(models, "aligned")
        out = eng.generate(PROMPTS[0], max_new_tokens=16, temperature=0.9,
                           seed=3)
        assert len(out) == 16 and all(0 <= t < 256 for t in out)
        assert eng.stats()["spec_accept_ratio"] == pytest.approx(1.0)
        assert eng.kv.active_blocks() == 0

    def test_fixed_seed_deterministic(self, models):
        """Same seed, fresh engines: identical sampled output (every draw
        comes from the slot's own generator, seeded at prefill)."""
        a = _spec_engine(models, "near").generate(
            PROMPTS[0], max_new_tokens=12, temperature=0.8, seed=42)
        b = _spec_engine(models, "near").generate(
            PROMPTS[0], max_new_tokens=12, temperature=0.8, seed=42)
        assert a == b

    def test_distribution_preserved(self, models, plain):
        """Rejection sampling leaves the MARGINAL distribution of emitted
        tokens the target's even under a mismatched draft: the empirical
        distribution of the first three sampled tokens over a fixed seed
        sweep stays as close to the plain engine's as two plain sweeps
        are to each other (JAX's bound: L1 <= 1.3 × the null + 0.1)."""
        eng = _spec_engine(models, "miss")
        n, new = 150, 3

        def sweep(e, base_seed):
            cs = [collections.Counter() for _ in range(new)]
            for seed in range(n):
                out = e.generate(PROMPTS[1], max_new_tokens=new,
                                 temperature=1.0, seed=base_seed + seed)
                for i in range(new):
                    cs[i][out[i]] += 1
            return cs

        def l1(a, b):
            return sum(abs(a[t] - b[t]) for t in set(a) | set(b)) / n

        cs_spec = sweep(eng, 0)
        cs_b1 = sweep(plain, 10_000)
        cs_b2 = sweep(plain, 20_000)  # plain-vs-plain null calibrates L1
        for i in range(new):
            null = l1(cs_b1[i], cs_b2[i])
            assert l1(cs_spec[i], cs_b1[i]) <= 1.3 * null + 0.1, (i, null)
        assert eng.kv.active_blocks() == 0


class TestBlockAccounting:
    def test_partial_acceptance_refcounts_drain(self, models):
        """Variable per-step advances (partial acceptance) must not skew the
        host block accounting: every refcount drains at retire."""
        eng = _spec_engine(models, "near")
        for p in PROMPTS:
            eng.generate(p, max_new_tokens=20)
            eng.generate(p, max_new_tokens=20, temperature=0.7, seed=1)
        assert eng.kv.active_blocks() == 0

    def test_cow_fork_shared_pool(self, models, plain):
        """Draft and target share the block tables under prefix reuse: a
        follow-up turn hits the retired chain's full block, and a turn that
        extends the whole chain COW-forks its partial tail in BOTH pools;
        both still decode token-identically."""
        eng = _spec_engine(models, "near")
        first = [3, 1, 4, 1, 5, 9, 2, 6]
        out1 = eng.generate(first, max_new_tokens=12)
        assert out1 == plain.generate(first, max_new_tokens=12)
        for follow in (first + out1[:5] + [7, 7], first + out1 + [7, 7]):
            before = eng.kv.stats()
            out2 = eng.generate(follow, max_new_tokens=12)
            assert eng.kv.stats()["kv_hit_tokens"] > before["kv_hit_tokens"]
            assert out2 == plain.generate(follow, max_new_tokens=12)
        # The second turn: 20 retired tokens are 2 full blocks + a 4-token
        # tail, which it hits and copies before writing past it.
        assert eng.kv.stats()["kv_cow_copies"] > before["kv_cow_copies"]
        assert eng.kv.active_blocks() == 0

    def test_draft_requires_config(self, models):
        cfg, params, drafts = models
        with pytest.raises(ValueError, match="draft model"):
            PagedLLMEngine(params, cfg, device="cpu", spec_tokens=2,
                           **ENG_KW)
        with pytest.raises(ValueError, match="go together"):
            tgen.PagedGenerator(params, cfg, slots=2, num_blocks=17,
                                block_tokens=BT, device="cpu",
                                draft_params=drafts["aligned"][0])
        with pytest.raises(ValueError, match="one vocab"):
            tgen.PagedGenerator(params, cfg, slots=2, num_blocks=17,
                                block_tokens=BT, device="cpu",
                                draft_params=drafts["aligned"][0],
                                draft_config=cfg.replace(vocab_size=200))


class TestLengthCapRegression:
    """A slot at table capacity finishes as length_cap at the engine layer
    before dispatch, and the forward itself never overwrites the last cell
    when handed an at-capacity length or a verify that runs past it."""

    def test_engine_finishes_length_cap(self, models, plain):
        eng = _spec_engine(models, "near")
        outs = {}
        for e in (eng, plain):
            outcome = {}
            toks = list(e.stream([5, 9, 3, 77, 21], max_new_tokens=500,
                                 result=outcome))
            assert outcome["finish_reason"] == "length_cap"
            assert len(toks) <= e.max_len - 5
            outs[e] = toks
        # Plain emits whole chunks, spec a variable 1 + accepted a step, so
        # the stop points near the cap differ; the streams agree on their
        # common prefix and spec only ever gets further.
        n_plain, n_spec = len(outs[plain]), len(outs[eng])
        assert n_spec >= n_plain
        assert outs[eng][:n_plain] == outs[plain]
        assert eng.kv.active_blocks() == 0

    @pytest.mark.parametrize("kernel", ["plain", "gather"])
    @pytest.mark.parametrize("T", [1, 4, 5])
    def test_at_capacity_write_redirects_to_trash(self, jax_models, models,
                                                  kernel, T):
        """lengths at capacity − 1 (T = 1: at capacity) with T query rows:
        the rows past the table write to trash block 0, never onto a live
        block, and the logits are finite and JAX's."""
        jcfg, jparams, _ = jax_models
        cfg, params, _ = models
        nb_seq, pool = 3, 8
        cap = nb_seq * BT
        rng = np.random.default_rng(T)
        shape = (cfg.n_layers, pool, BT, cfg.n_heads, cfg.head_dim)
        k0 = rng.standard_normal(shape).astype(np.float32)
        v0 = rng.standard_normal(shape).astype(np.float32)
        tables = np.array([[1, 2, 3]], np.int32)        # fully live table
        lengths = np.array([cap if T == 1 else cap - 1], np.int32)
        toks = np.array([[4, 9, 17, 33, 65][:T]], np.int32)
        logits, k2, v2 = tgen._forward_decode_paged(
            params, torch.tensor(toks, dtype=torch.long),
            torch.tensor(k0), torch.tensor(v0), torch.tensor(tables),
            torch.tensor(lengths), cfg, BT, kernel=kernel)
        jlogits, jk, jv = jgen._forward_decode_paged(
            jparams, jnp.asarray(toks), jnp.asarray(k0), jnp.asarray(v0),
            jnp.asarray(tables), jnp.asarray(lengths), jcfg, BT)
        assert torch.isfinite(logits).all()
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        # Every live cell but the in-range row at cap - 1 keeps its content.
        live = np.ones((pool, BT), bool)
        live[0] = False
        if T > 1:
            live[3, BT - 1] = False
            np.testing.assert_allclose(k2.numpy()[:, 3, BT - 1],
                                       np.asarray(jk)[:, 3, BT - 1],
                                       atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(k2.numpy()[:, live], k0[:, live])
        np.testing.assert_array_equal(v2.numpy()[:, live], v0[:, live])
        assert not np.array_equal(k2.numpy()[:, 0], k0[:, 0])
