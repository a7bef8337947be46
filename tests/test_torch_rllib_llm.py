"""The JAX package's ``tests/test_rllib_podracer.py::TestLLMRL`` on the
port's ``ray_tpu_torch.rllib.LLMRL``: generation actors on the paged engine
(on the CPU here, ``generator_device="cpu"``), the clipped-surrogate
learner on the host (``learner_device="cpu"``), weights synced every
iteration. The loop repeats under a seed, and the mean sampled reward rises
over 6 iterations.

Then its parts held to JAX on ``tiny``, on the JAX package's parameters
carried across by ``models.convert.params_from_numpy``, in f32 (1e-5):
``GenerationActor``'s token log-probs, a greedy rollout's tokens,
``gen_mask`` and ``behavior_logp`` against JAX's ``GenerationActor`` (also
after ``set_weights``, which drains the pool), and ``LLMRLLearner``'s loss,
every gradient leaf and one update; and the learner's device policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.rllib import LLMRL, LLMRLConfig
from ray_tpu_torch.rllib.rl_module import tree_leaves

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


class TestLLMRL:
    def test_reward_improves_deterministically(self, ray_start_regular):
        """The clipped-surrogate post-training loop must raise the mean
        sampled reward under a fixed seed (first third vs last third of
        the iterations, strictly), and the same seed repeats the run."""
        runs = []
        for _ in range(2):
            algo = LLMRL(LLMRLConfig(seed=0, num_generators=2,
                                     generator_device="cpu",
                                     learner_device="cpu"))
            try:
                runs.append([algo.train()["reward_mean"] for _ in range(6)])
            finally:
                algo.stop()
        rewards = runs[0]
        k = len(rewards) // 3
        first = sum(rewards[:k]) / k
        last = sum(rewards[-k:]) / k
        assert last > first, rewards
        assert runs[0] == runs[1], runs


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _requires_grad(tree):
    for t in tree_leaves(tree):
        t.requires_grad_(True)
    return tree


def _grads_match(tparams, jgrads):
    jleaves = jax.tree.leaves(jgrads)
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for t, g in zip(tleaves, jleaves):
        got = (t.grad if t.grad is not None else torch.zeros_like(t))
        assert tuple(got.shape) == tuple(g.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(g), **TOL)


def _llm_pair(seed=0, **kw):
    """JAX's config and params; the port's config and the same params."""
    from ray_tpu.models import transformer as jtf
    from ray_tpu_torch.models import transformer as ttf

    kw = dict(dict(max_seq_len=32), **kw)
    jcfg = jtf.tiny(**kw)
    tcfg = ttf.tiny(**kw)
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    return jcfg, jparams, tcfg, params_from_numpy(_np(jparams), "cpu")


def test_token_logps_match_jax():
    from ray_tpu.rllib.llm_rl import GenerationActor as JaxGen
    from ray_tpu_torch.rllib.llm_rl import token_logps

    jcfg, jparams, tcfg, tparams = _llm_pair()
    tokens = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (3, tcfg.max_seq_len)).astype(np.int32)
    jg = JaxGen.__new__(JaxGen)
    jg.model_config = jcfg
    theirs = jg._token_logps(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        ours = token_logps(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_greedy_rollout_matches_jax():
    from ray_tpu.rllib.llm_rl import GenerationActor as JaxGen
    from ray_tpu_torch.rllib.llm_rl import GenerationActor

    jcfg, jparams, tcfg, tparams = _llm_pair(max_seq_len=64)
    jg = JaxGen(jcfg, slots=2, seed=0)
    jg.set_weights(jparams)
    tg = GenerationActor(tcfg, slots=2, params=tparams, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, tcfg.vocab_size, n).tolist() for n in (4, 9)]
    theirs = jg.rollout(prompts, [0, 1], 8, 0.0)
    ours = tg.rollout(prompts, [0, 1], 8, 0.0)
    for col in ("tokens", "gen_mask", "prompt_len", "gen_len"):
        np.testing.assert_array_equal(ours[col], np.asarray(theirs[col]))
    np.testing.assert_allclose(ours["behavior_logp"],
                               np.asarray(theirs["behavior_logp"]), **TOL)
    jg.stop()
    tg.stop()


def test_set_weights_equals_a_fresh_actor_and_jax():
    """After a rollout under other weights, ``set_weights`` leaves the pool
    drained, and a greedy rollout equals a fresh actor's on the new weights
    and JAX's ``GenerationActor`` after its own ``set_weights``."""
    from ray_tpu.rllib.llm_rl import GenerationActor as JaxGen
    from ray_tpu_torch.rllib.llm_rl import GenerationActor

    _, old, tcfg, _ = _llm_pair(seed=5, max_seq_len=64)
    jcfg, jparams, _, tparams = _llm_pair(seed=6, max_seq_len=64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab_size, n).tolist() for n in (5, 11)]
    tg = GenerationActor(tcfg, slots=2, params=_np(old), device="cpu")
    tg.rollout(prompts, [0, 1], 8, 0.0)
    assert tg.kv_stats()["kv_blocks_cached"] > 0
    tg.set_weights(_np(jparams))
    st = tg.kv_stats()
    assert st["kv_blocks_active"] == 0 and st["kv_blocks_cached"] == 0
    assert st["kv_blocks_free"] == st["kv_blocks_total"]
    ours = tg.rollout(prompts, [0, 1], 8, 0.0)
    fresh = GenerationActor(tcfg, slots=2, params=tparams, device="cpu")
    want = fresh.rollout(prompts, [0, 1], 8, 0.0)
    jg = JaxGen(jcfg, slots=2, seed=1)
    jg.set_weights(jparams)
    theirs = jg.rollout(prompts, [0, 1], 8, 0.0)
    for col in ("tokens", "gen_mask", "prompt_len", "gen_len"):
        np.testing.assert_array_equal(ours[col], want[col])
        np.testing.assert_array_equal(ours[col], np.asarray(theirs[col]))
    np.testing.assert_array_equal(ours["behavior_logp"], want["behavior_logp"])
    for g in (tg, fresh, jg):
        g.stop()


@pytest.mark.parametrize("width,dev_cfg", [(64, "auto"), (128, "auto"),
                                           (128, "cpu")])
def test_llm_rl_learner_device_policy(width, dev_cfg):
    """The ``Learner`` device policy, on the transformer's parameter count:
    "auto" keeps a model under 1M parameters on the host and puts a larger
    one on the card, raising where there is none; "cpu" is obeyed."""
    from ray_tpu_torch.models import transformer as ttf
    from ray_tpu_torch.rllib.llm_rl import LLMRLLearner

    cfg = ttf.tiny(vocab_size=8192, d_model=width, n_layers=1, n_heads=4,
                   d_ff=2 * width, max_seq_len=16)
    n = ttf.param_count(ttf.init_params(cfg, 0, device="cpu"))
    assert (n >= 1_000_000) == (width == 128), n
    if dev_cfg == "auto" and n >= 1_000_000:
        if torch.cuda.is_available():
            assert LLMRLLearner(cfg, {"device": dev_cfg}).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                LLMRLLearner(cfg, {"device": dev_cfg})
    else:
        learner = LLMRLLearner(cfg, {"device": dev_cfg})
        assert learner.device.type == "cpu"
        assert all(p.device.type == "cpu" and p.requires_grad
                   for p in tree_leaves(learner.params))


def _llm_batch(tcfg, B=4, seed=3):
    rng = np.random.default_rng(seed)
    L = tcfg.max_seq_len
    tokens = rng.integers(0, tcfg.vocab_size, (B, L)).astype(np.int32)
    mask = np.zeros((B, L), np.float32)
    for b in range(B):
        p, n = 3 + b, 8 + 2 * b
        mask[b, p:p + n] = 1.0
    return {"tokens": tokens, "gen_mask": mask,
            "behavior_logp": (mask * rng.normal(-4.0, 0.3, (B, L))
                              ).astype(np.float32),
            "advantage": rng.normal(size=B).astype(np.float32)}


def test_llm_rl_learner_loss_and_every_gradient_leaf():
    from ray_tpu.rllib.llm_rl import LLMRLLearner as JaxLearner
    from ray_tpu_torch.rllib.llm_rl import LLMRLLearner

    jcfg, jparams, tcfg, tparams = _llm_pair()
    cfg = {"lr": 1e-2, "clip_param": 0.3, "grad_clip": 1.0}
    jl = JaxLearner.__new__(JaxLearner)
    jl.config, jl.model_config = cfg, jcfg
    tl = LLMRLLearner.__new__(LLMRLLearner)
    tl.config, tl.model_config = cfg, tcfg
    batch = _llm_batch(tcfg)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    _requires_grad(tparams)
    tloss = tl.loss_fn(tparams, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    _grads_match(tparams, jgrads)


def test_one_llm_rl_learner_update():
    """One update from the same parameters, with the clip active. ``bk``'s
    gradient is 0 in exact arithmetic (softmax ignores a per-row constant):
    Adam's first step moves it by ±lr on rounding noise in either package,
    so it is held to that bound; every other leaf to 1e-5."""
    from ray_tpu.rllib.llm_rl import LLMRLLearner as JaxLearner
    from ray_tpu_torch.rllib.llm_rl import LLMRLLearner

    jcfg, jparams, tcfg, tparams = _llm_pair()
    cfg = {"lr": 1e-3, "clip_param": 0.3, "grad_clip": 1e-3}
    jl = JaxLearner(jcfg, cfg, seed=0)
    tl = LLMRLLearner(tcfg, dict(cfg, device="cpu"), seed=0)
    tl.set_weights(jl.get_weights())
    batch = _llm_batch(tcfg, seed=4)
    jm, tm = jl.update(batch), tl.update(batch)
    assert jm["grad_norm"] > cfg["grad_clip"]
    np.testing.assert_allclose(tm["loss"], jm["loss"], **TOL)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], **TOL)
    names = [k for k in sorted(tl.params["blocks"])]
    ours, theirs = tl.get_weights(), _np(jl.get_weights())
    for key in sorted(ours):
        if key == "blocks":
            for name in names:
                a, b = ours["blocks"][name], theirs["blocks"][name]
                if name == "bk":
                    assert np.abs(a - b).max() <= 2 * cfg["lr"] + 1e-7
                else:
                    np.testing.assert_allclose(a, b, **TOL)
        else:
            np.testing.assert_allclose(ours[key], theirs[key], **TOL)
