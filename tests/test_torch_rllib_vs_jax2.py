"""The rest of RLlib held to the JAX package on the same numpy inputs and on
parameters carried across by ``models.convert.params_from_numpy``, in f32
(TF32 plays no part on the CPU; the JAX side runs at ``highest`` matmul
precision, ``conftest.py``):

- ``vtrace`` on random inputs with terminations and ``valids`` (1e-6);
- IMPALA's and APPO's loss and every gradient leaf, and one
  ``ImpalaLearner.update`` (1e-5);
- DQN's TD targets, loss and gradients; SAC's squashed sample and
  log-prob, and a whole SAC step (critic, actor and α losses, the TD
  errors, every updated parameter) from a JAX learner's state after one
  step; CQL's penalty and its gradients; BC's and MARWIL's losses and
  gradients (1e-5);
- the multi-agent runner's grouping by policy;
- the RLlib knobs' names and defaults.

The LLM-RL actor and learner are held to JAX in ``test_torch_rllib_llm.py``.

Sampled streams are not compared: torch generators are not JAX keys. Where
a comparison draws noise, the JAX key's draws are computed here and handed
to the port's noise-taking functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.rllib.rl_module import tree_leaves

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _requires_grad(tree):
    for t in tree_leaves(tree):
        t.requires_grad_(True)
    return tree


def _grads_match(tparams, jgrads, tol=TOL):
    jleaves = jax.tree.leaves(jgrads)
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for t, g in zip(tleaves, jleaves):
        got = (t.grad if t.grad is not None else torch.zeros_like(t))
        assert tuple(got.shape) == tuple(g.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(g), **tol)


# ---------------------------------------------------------------- V-trace
def test_vtrace_matches_jax():
    from ray_tpu.rllib.impala import vtrace as jvtrace
    from ray_tpu_torch.rllib.impala import vtrace

    rng = np.random.default_rng(0)
    T, N = 40, 6
    args = (rng.normal(0, 0.5, (T, N)).astype(np.float32),
            rng.normal(0, 0.5, (T, N)).astype(np.float32),
            rng.normal(0, 1, (T, N)).astype(np.float32),
            rng.normal(0, 1, (T, N)).astype(np.float32),
            rng.normal(0, 1, N).astype(np.float32),
            (rng.random((T, N)) < 0.1).astype(np.float32))
    valids = (rng.random((T, N)) > 0.1).astype(np.float32)
    for v in (None, valids):
        for rho_bar, c_bar in ((1.0, 1.0), (0.8, 0.5)):
            ours = vtrace(*args, gamma=0.97, rho_bar=rho_bar, c_bar=c_bar,
                          valids=v)
            theirs = jvtrace(*args, gamma=0.97, rho_bar=rho_bar,
                             c_bar=c_bar, valids=v)
            for a, b in zip(ours, theirs):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)


# --------------------------------------------------------- IMPALA / APPO
SPEC = dict(observation_dim=4, action_dim=2, hidden=(32, 16))
IMPALA_CFG = {"lr": 1e-3, "gamma": 0.99, "vf_loss_coeff": 0.5,
              "entropy_coeff": 0.01, "clip_param": 0.2, "grad_clip": 40.0,
              "rho_bar": 1.0, "c_bar": 1.0, "device": "cpu"}


def _impala_batch(T=12, N=5, seed=3):
    rng = np.random.default_rng(seed)
    term = (rng.random((T, N)) < 0.15).astype(np.float32)
    valids = np.ones((T, N), np.float32)
    valids[1:][term[:-1] > 0] = 0.0
    return {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.float32),
            "logp": np.log(rng.uniform(0.1, 0.9, (T, N))).astype(np.float32),
            "rewards": rng.normal(size=(T, N)).astype(np.float32),
            "terminateds": term, "valids": valids,
            "bootstrap_obs": rng.normal(size=(N, 4)).astype(np.float32)}


@pytest.mark.parametrize("name", ["ImpalaLearner", "APPOLearner"])
def test_impala_loss_and_every_gradient_leaf(name):
    from ray_tpu import rllib as jrllib
    from ray_tpu_torch import rllib as trllib

    jcls, tcls = getattr(jrllib, name), getattr(trllib, name)
    jl = jcls(jrllib.RLModuleSpec(**SPEC), IMPALA_CFG, seed=0)
    tl = tcls(trllib.RLModuleSpec(**SPEC), IMPALA_CFG, seed=0)
    jp = jl.params
    tp = _requires_grad(params_from_numpy(_np(jp), "cpu"))
    batch = _impala_batch()
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = tl.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    _grads_match(tp, jgrads)


def test_one_impala_learner_update():
    from ray_tpu.rllib import ImpalaLearner as JaxImpala
    from ray_tpu.rllib import RLModuleSpec as JaxSpec
    from ray_tpu_torch.rllib import ImpalaLearner, RLModuleSpec

    jl = JaxImpala(JaxSpec(**SPEC), IMPALA_CFG, seed=0)
    tl = ImpalaLearner(RLModuleSpec(**SPEC), IMPALA_CFG, seed=0)
    tl.set_weights(jl.get_weights())
    batch = _impala_batch(seed=4)
    jm, tm = jl.update(batch), tl.update(batch)
    np.testing.assert_allclose(tm["loss"], jm["loss"], **TOL)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], **TOL)
    for a, b in zip(tree_leaves(tl.get_weights()),
                    jax.tree.leaves(jl.get_weights())):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


# ------------------------------------------------------------------- DQN
def _dqn_batch(n=24, seed=5):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "terminateds": (rng.random(n) < 0.2).astype(np.float32),
            "discounts": np.full(n, 0.99 ** 2, np.float32),
            "weights": rng.uniform(0.5, 1.0, n).astype(np.float32)}


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_td_targets_loss_and_gradients(double_q):
    from ray_tpu.rllib.dqn import DQNLearner as JaxDQN
    from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec
    from ray_tpu_torch.rllib.dqn import DQNLearner
    from ray_tpu_torch.rllib.rl_module import RLModuleSpec

    cfg = {"lr": 1e-3, "gamma": 0.99, "double_q": double_q, "device": "cpu"}
    jl = JaxDQN(JaxSpec(**SPEC), cfg, seed=0)
    tl = DQNLearner(RLModuleSpec(**SPEC), cfg, seed=0)
    b = _dqn_batch()
    # a target net that differs from the online one
    jtarget = jax.tree.map(lambda x: x * 0.9, jl.params)
    tonline = params_from_numpy(_np(jl.params), "cpu")
    ttarget = params_from_numpy(_np(jtarget), "cpu")
    jt = jl._targets_fn(jtarget, jl.params, jnp.asarray(b["next_obs"]),
                        jnp.asarray(b["rewards"]),
                        jnp.asarray(b["terminateds"]),
                        jnp.asarray(b["discounts"]))
    tt = tl._targets_fn(ttarget, tonline, b["next_obs"], b["rewards"],
                        b["terminateds"], b["discounts"])
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)

    lb = {"obs": b["obs"], "actions": b["actions"],
          "targets": np.asarray(jt), "weights": b["weights"]}
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        jl.params, {k: jnp.asarray(v) for k, v in lb.items()})
    _requires_grad(tonline)
    tloss = tl.loss_fn(tonline, {k: torch.from_numpy(v) for k, v in lb.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    _grads_match(tonline, jgrads)


# ------------------------------------------------------------------- SAC
def _sac_pair(seed=0, cls="SACLearner", **extra):
    from ray_tpu.rllib import cql as jcql
    from ray_tpu.rllib import sac as jsac
    from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec
    from ray_tpu_torch.rllib import cql as tcql
    from ray_tpu_torch.rllib import sac as tsac
    from ray_tpu_torch.rllib.rl_module import RLModuleSpec

    low, high = np.array([-2.0, -1.0], np.float32), np.array([2.0, 3.0],
                                                             np.float32)
    kw = dict(observation_dim=3, action_dim=2, discrete=False)
    jm = jsac.SACModule(JaxSpec(**kw), low, high, hidden=(16, 16))
    tm = tsac.SACModule(RLModuleSpec(**kw), low, high, hidden=(16, 16))
    cfg = dict({"lr": 3e-3, "gamma": 0.99, "tau": 0.05,
                "initial_alpha": 0.5, "device": "cpu"}, **extra)
    jmod, tmod = (jcql, tcql) if cls == "CQLLearner" else (jsac, tsac)
    return (jm, getattr(jmod, cls)(jm, cfg, seed=seed),
            tm, getattr(tmod, cls)(tm, cfg, seed=seed))


def _sac_batch(B=32, seed=0):
    rng = np.random.default_rng(seed)
    # observations of a moderate scale: pre-tanh actions stay away from
    # saturation, where log(1 - a^2) is ill-conditioned in f32
    return {"obs": rng.normal(0, 0.2, (B, 3)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (B, 2)).astype(np.float32),
            "rewards": rng.normal(size=B).astype(np.float32),
            "next_obs": rng.normal(0, 0.2, (B, 3)).astype(np.float32),
            "terminateds": (rng.random(B) < 0.1).astype(np.float32),
            "discounts": np.full(B, 0.99, np.float32),
            "weights": rng.uniform(0.5, 1.0, B).astype(np.float32)}


def test_sac_squashed_sample_and_logp():
    jm, jl, tm, tl = _sac_pair()
    obs = _sac_batch()["obs"]
    key = jax.random.key(3)
    ja, jlogp, ju = jm.pi_sample(jl.params["pi"], jnp.asarray(obs), key)
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (len(obs), 2))))
    tpi = params_from_numpy(_np(jl.params["pi"]), "cpu")
    ta, tlogp, tu = tm.pi_sample(tpi, torch.from_numpy(obs), eps)
    assert float(jnp.max(jnp.abs(ju))) < 0.999
    for a, b in ((ta, ja), (tlogp, jlogp), (tu, ju)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # Q on the env-scaled action
    q = tm.q_value(params_from_numpy(_np(jl.params["q1"]), "cpu"),
                   torch.from_numpy(obs), ta)
    np.testing.assert_allclose(
        q.detach().numpy(),
        np.asarray(jm.q_value(jl.params["q1"], jnp.asarray(obs), ja)), **TOL)


def _load_jax_state(tl, jl):
    """The port learner in the JAX learner's whole state (parameters,
    targets, α and optax's three Adam states)."""
    st = jl.get_state()
    st.pop("rng_key", None)
    tl.set_state(st)


def _step_both(jl, tl, batch, key, cql_shape=None):
    """One JAX ``_step`` from ``key`` and one port ``_step`` on the same
    draws."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jl._step_fn(jl.params, jl.target_q, jl.log_alpha, jl.pi_state,
                      jl.q_state, jl.a_state, jb, key)
    k1, k2 = jax.random.split(key)
    B, A = batch["actions"].shape
    noise = {"next": np.asarray(jax.random.normal(k1, (B, A))),
             "pi": np.asarray(jax.random.normal(k2, (B, A)))}
    if cql_shape is not None:
        noise.update(_cql_draws(k1, *cql_shape))
    td, metrics = tl._step({k: torch.from_numpy(v) for k, v in batch.items()},
                           {k: torch.from_numpy(v) for k, v in noise.items()})
    return out, td, metrics


def _cql_draws(key, S, B, A):
    krand, kpi = jax.random.split(key)
    unit = jax.random.uniform(krand, (S, B, A), minval=-1.0, maxval=1.0)
    pi_keys = jax.random.split(kpi, S)
    pi = jnp.stack([jax.random.normal(pi_keys[i], (B, A)) for i in range(S)])
    return {"cql_unit": np.asarray(unit), "cql_pi": np.asarray(pi)}


def test_sac_step_losses_td_errors_and_update():
    """A JAX step brings both learners to the same state with nonzero Adam
    moments (Adam's first step is lr·sign(g), ill-conditioned where a
    gradient is rounding noise); the second step's critic, actor and α
    losses, TD errors and every updated parameter, target and α must then
    agree."""
    jm, jl, tm, tl = _sac_pair()
    b1, b2 = _sac_batch(seed=1), _sac_batch(seed=2)
    out = jl._step_fn(jl.params, jl.target_q, jl.log_alpha, jl.pi_state,
                      jl.q_state, jl.a_state,
                      {k: jnp.asarray(v) for k, v in b1.items()},
                      jax.random.key(7))
    (jl.params, jl.target_q, jl.log_alpha, jl.pi_state, jl.q_state,
     jl.a_state) = out[:6]
    _load_jax_state(tl, jl)
    out, td, metrics = _step_both(jl, tl, b2, jax.random.key(8))
    jm_ = out[7]
    np.testing.assert_allclose(
        metrics.numpy(), [float(jm_[k]) for k in ("q_loss", "pi_loss",
                                                   "alpha", "entropy")],
        **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(out[6]), **TOL)
    for a, b in zip(tree_leaves(tl.params), jax.tree.leaves(out[0])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for a, b in zip(tree_leaves(tl.target_q), jax.tree.leaves(out[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tl.log_alpha.item(), float(out[2]), **TOL)


def test_cql_penalty_and_its_gradients():
    jm, jl, tm, tl = _sac_pair(cls="CQLLearner", cql_alpha=2.0,
                               cql_n_actions=3)
    batch = _sac_batch(B=16, seed=3)
    key = jax.random.key(11)
    jqp = {"q1": jl.params["q1"], "q2": jl.params["q2"]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jpen, jgrads = jax.value_and_grad(
        lambda qp: jl._conservative_penalty(qp, jl.params, jb, key))(jqp)
    tparams = params_from_numpy(_np(jl.params), "cpu")
    tqp = _requires_grad({"q1": tparams["q1"], "q2": tparams["q2"]})
    noise = {k: torch.from_numpy(v)
             for k, v in _cql_draws(key, 3, 16, 2).items()}
    tpen = tl._conservative_penalty(
        tqp, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        noise)
    tpen.backward()
    np.testing.assert_allclose(tpen.item(), float(jpen), **TOL)
    _grads_match(tqp, jgrads)


def test_cql_step_matches_jax():
    jm, jl, tm, tl = _sac_pair(cls="CQLLearner", cql_alpha=1.0,
                               cql_n_actions=2)
    b1, b2 = _sac_batch(B=16, seed=4), _sac_batch(B=16, seed=5)
    out = jl._step_fn(jl.params, jl.target_q, jl.log_alpha, jl.pi_state,
                      jl.q_state, jl.a_state,
                      {k: jnp.asarray(v) for k, v in b1.items()},
                      jax.random.key(1))
    (jl.params, jl.target_q, jl.log_alpha, jl.pi_state, jl.q_state,
     jl.a_state) = out[:6]
    _load_jax_state(tl, jl)
    out, td, metrics = _step_both(jl, tl, b2, jax.random.key(2),
                                  cql_shape=(2, 16, 2))
    np.testing.assert_allclose(metrics[0].item(), float(out[7]["q_loss"]),
                               **TOL)
    for a, b in zip(tree_leaves(tl.params), jax.tree.leaves(out[0])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


# ------------------------------------------------------------ BC / MARWIL
@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_marwil_loss_and_gradients(beta):
    from ray_tpu.rllib.offline import MARWILLearner as JaxMARWIL
    from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec
    from ray_tpu_torch.rllib.offline import MARWILLearner

    cfg = {"lr": 1e-3, "beta": beta, "vf_coeff": 0.7, "device": "cpu"}
    jl = JaxMARWIL(JaxSpec(**SPEC), cfg, seed=0)
    tl = MARWILLearner(__import__("ray_tpu_torch.rllib", fromlist=["x"])
                       .RLModuleSpec(**SPEC), cfg, seed=0)
    rng = np.random.default_rng(6)
    n = 20
    batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.float32),
             "returns": rng.normal(size=n).astype(np.float32),
             "adv_norm": np.float32(1.3)}
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        jl.params, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _requires_grad(params_from_numpy(_np(jl.params), "cpu"))
    tloss = tl.loss_fn(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    _grads_match(tp, jgrads)


# ------------------------------------------------------------ multi-agent
class _BitEnv:
    """The multi-agent tests' two-agent env: observations depend on the
    env's own rng only, so both packages see the same ones."""

    def __init__(self, episode_len=6):
        self._len = episode_len
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._bit = 0

    def _obs(self):
        b = float(self._bit)
        return {"a0": np.array([b, 1 - b, 1.0, 0.0], np.float32),
                "a1": np.array([b, 1 - b, 0.0, 1.0], np.float32)}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._bit = int(self._rng.integers(0, 2))
        return self._obs(), {}

    def step(self, actions):
        rewards = {"a0": float(actions["a0"] == self._bit),
                   "a1": float(actions["a1"] == 1 - self._bit)}
        self._t += 1
        done = self._t >= self._len
        self._bit = int(self._rng.integers(0, 2))
        return (self._obs(), rewards,
                {"a0": done, "a1": done, "__all__": done},
                {"a0": False, "a1": False, "__all__": False}, {})

    def close(self):
        pass


@pytest.mark.parametrize("mapping", ["per_agent", "shared"])
def test_multi_agent_groups_by_policy_as_jax(mapping):
    from ray_tpu.rllib import RLModuleSpec as JaxSpec
    from ray_tpu.rllib.multi_agent import MultiAgentEnvRunner as JaxRunner
    from ray_tpu_torch.rllib import RLModuleSpec
    from ray_tpu_torch.rllib.multi_agent import MultiAgentEnvRunner

    if mapping == "per_agent":
        pids, fn = ("p0", "p1"), (lambda a: "p0" if a == "a0" else "p1")
    else:
        pids, fn = ("shared",), (lambda a: "shared")
    kw = dict(observation_dim=4, action_dim=2, hidden=(8,))
    out = {}
    for name, runner_cls, spec_cls in (("jax", JaxRunner, JaxSpec),
                                       ("port", MultiAgentEnvRunner,
                                        RLModuleSpec)):
        runner = runner_cls(_BitEnv, policies={p: spec_cls(**kw)
                                               for p in pids},
                            policy_mapping_fn=fn, seed=0)
        out[name] = [runner.sample(10), runner.sample(7)]
    for ours, theirs in zip(out["port"], out["jax"]):
        assert ours["num_episodes"] == theirs["num_episodes"]
        assert sorted(ours["trajectories"]) == sorted(theirs["trajectories"])
        for pid in pids:
            mine, ref = ours["trajectories"][pid], theirs["trajectories"][pid]
            assert len(mine) == len(ref)
            for a, b in zip(mine, ref):
                np.testing.assert_array_equal(a["obs"], b["obs"])
                assert a["terminated"] == b["terminated"]
                assert len(a["actions"]) == len(b["actions"])
                assert (a["bootstrap_value"] == 0.0) == (
                    b["bootstrap_value"] == 0.0)


# ----------------------------------------------------------------- knobs
@pytest.mark.parametrize("knob", ["rollout_lanes_enabled",
                                  "rl_inference_max_batch",
                                  "rl_inference_window_s"])
def test_rllib_knob_has_jax_name_and_default(knob):
    from ray_tpu.core import config as jcfg
    from ray_tpu_torch.core import config as tcfg

    port, ref = tcfg.Config(), jcfg.Config()
    assert getattr(port, knob) == getattr(ref, knob)
    assert type(getattr(port, knob)) is type(getattr(ref, knob))
