"""The JAX package's off-policy, offline and multi-agent RLlib tests on the
port's ``ray_tpu_torch.rllib``: ``tests/test_rllib.py``'s ``TestDQN``,
``test_dqn_per_nstep_smoke``, ``TestSAC``, ``TestOffline``'s three,
``TestMultiAgent`` and ``TestCQL``, on the in-process runtime. Sampled
streams are torch generators, not JAX keys: learning is held to JAX's own
thresholds. The offline algorithms read through the port's Data library.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.rl_module import tree_leaves

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


def pendulum():
    import gymnasium as gym

    return gym.make("Pendulum-v1")


class TestDQN:
    def test_replay_buffer_ring_and_sample(self):
        from ray_tpu_torch.rllib import ReplayBuffer

        buf = ReplayBuffer(capacity=8, seed=0)
        buf.add_batch({"x": np.arange(6, dtype=np.float32)})
        assert len(buf) == 6
        buf.add_batch({"x": np.arange(10, 14, dtype=np.float32)})
        assert len(buf) == 8  # wrapped
        s = buf.sample(16)
        assert s["x"].shape == (16,)
        # wrapped slots hold the newest values
        assert set(np.unique(s["x"])) <= {2, 3, 4, 5, 10, 11, 12, 13}

    def test_td_targets_and_target_sync(self):
        """Double-DQN targets use the target net for evaluation; the target
        net only moves on the sync boundary."""
        from ray_tpu_torch.rllib.dqn import DQNLearner
        from ray_tpu_torch.rllib.rl_module import RLModuleSpec

        spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(16,))
        lrn = DQNLearner(spec, {"lr": 1e-2, "gamma": 0.9,
                                "target_update_freq": 3}, seed=0)
        before = tree_leaves(lrn.target_params)[0].clone()
        batch = {
            "obs": np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32),
            "actions": np.zeros(32, np.int64),
            "rewards": np.ones(32, np.float32),
            "next_obs": np.random.default_rng(1).normal(size=(32, 4)).astype(np.float32),
            "terminateds": np.zeros(32, np.float32),
        }
        lrn.update(batch)
        lrn.update(batch)
        after2 = tree_leaves(lrn.target_params)[0]
        assert torch.equal(before, after2)  # not synced yet
        lrn.update(batch)  # 3rd update -> sync
        after3 = tree_leaves(lrn.target_params)[0]
        assert not torch.equal(before, after3)
        # terminal transitions: target == reward exactly
        t = lrn._targets_fn(lrn.target_params, lrn.params,
                            batch["next_obs"], batch["rewards"],
                            np.ones(32, np.float32),
                            np.full(32, 0.9, np.float32))  # γ^s column
        np.testing.assert_allclose(t.numpy(), batch["rewards"], rtol=1e-6)

    def test_dqn_learns_cartpole(self, ray_start_regular):
        """The learning-regression gate (reference:
        rllib/tuned_examples/dqn/cartpole-dqn.yaml — improve return)."""
        from ray_tpu_torch.rllib import DQNConfig

        algo = (
            DQNConfig()
            .environment(cartpole)
            .env_runners(num_env_runners=1, num_envs_per_env_runner=8)
            .training(
                rollout_fragment_length=64,
                train_batch_size=64,
                updates_per_iteration=48,
                num_steps_sampled_before_learning=512,
                target_update_freq=60,
                epsilon_decay_timesteps=8_000,
                lr=1e-3,
                seed=3,
            )
            .build()
        )
        try:
            first, best = None, -np.inf
            for _ in range(25):
                result = algo.train()
                r = result["episode_return_mean"]
                if not np.isnan(r):
                    first = r if first is None else first
                    best = max(best, r)
                if best >= 100.0:
                    break
            assert first is not None, "no episodes completed"
            assert best >= max(first * 1.5, 60.0), (first, best)
        finally:
            algo.stop()

    def test_dqn_checkpoint_roundtrip(self, ray_start_regular, tmp_path):
        from ray_tpu_torch.rllib import DQNConfig

        algo = (DQNConfig()
                .environment(cartpole)
                .training(num_steps_sampled_before_learning=64,
                          rollout_fragment_length=16, seed=0)
                .build())
        try:
            algo.train()
            path = algo.save(str(tmp_path / "ck"))
            w = algo.learner.get_weights()
            algo2 = (DQNConfig()
                     .environment(cartpole)
                     .training(num_steps_sampled_before_learning=64,
                               rollout_fragment_length=16, seed=9)
                     .build())
            try:
                algo2.restore(path)
                w2 = algo2.learner.get_weights()
                for a, b in zip(tree_leaves(w), tree_leaves(w2)):
                    np.testing.assert_array_equal(a, b)
            finally:
                algo2.stop()
        finally:
            algo.stop()


def test_dqn_per_nstep_smoke(ray_start_regular):
    from ray_tpu_torch.rllib import DQNConfig

    algo = (DQNConfig()
            .environment(cartpole)
            .training(num_steps_sampled_before_learning=64,
                      rollout_fragment_length=32,
                      updates_per_iteration=4,
                      replay="prioritized", n_step=3, seed=0)
            .build())
    try:
        r = algo.train()
        r = algo.train()
        assert np.isfinite(r["loss"])
        assert r["buffer_size"] > 0
    finally:
        algo.stop()


class TestSAC:
    def test_sac_module_squashing_and_logp(self):
        from ray_tpu_torch.rllib.rl_module import RLModuleSpec
        from ray_tpu_torch.rllib.sac import SACModule

        spec = RLModuleSpec(observation_dim=3, action_dim=1, discrete=False)
        m = SACModule(spec, np.array([-2.0], np.float32),
                      np.array([2.0], np.float32), hidden=(16,))
        params = m.init_params(0, "cpu")
        obs = torch.zeros((32, 3))
        g = torch.Generator().manual_seed(1)
        act, logp, unit = m.pi_sample(params["pi"], obs,
                                      m.draw_noise(32, g))
        assert act.shape == (32, 1) and logp.shape == (32,)
        assert float(torch.max(torch.abs(act))) <= 2.0 + 1e-5
        q = m.q_value(params["q1"], obs, act)
        assert q.shape == (32,)

    def test_sac_learns_pendulum(self, ray_start_regular):
        """Continuous-control learning gate (reference:
        rllib/tuned_examples/sac/pendulum-sac.yaml — improve return), at
        JAX's thresholds. JAX's test runs 1-step returns and tau 0.005,
        under which neither package learns in 30 iterations (the last
        returns of seeds 0-7 average about -1350 in both; the gate then
        reads the first episode's luck). With 3-step returns and tau 0.02
        both learn (seeds 0-2 reach -2 to -1023 in either)."""
        from ray_tpu_torch.rllib import SACConfig

        algo = (SACConfig()
                .environment(pendulum)
                .env_runners(num_env_runners=1, num_envs_per_env_runner=4)
                .training(
                    rollout_fragment_length=64,
                    train_batch_size=128,
                    updates_per_iteration=48,
                    num_steps_sampled_before_learning=512,
                    hidden=(64, 64),
                    lr=3e-3,
                    n_step=3,
                    tau=0.02,
                    seed=0,
                )
                .build())
        try:
            first, best = None, -np.inf
            for _ in range(30):
                result = algo.train()
                r = result["episode_return_mean"]
                if not np.isnan(r):
                    first = r if first is None else first
                    best = max(best, r)
                if best >= -300.0:
                    break
            assert first is not None, "no episodes completed"
            # Random policy sits near -1100 to -1400; learning must lift it.
            assert best >= first + 200.0 or best >= -400.0, (first, best)
        finally:
            algo.stop()

    def test_sac_checkpoint_roundtrip(self, ray_start_regular, tmp_path):
        from ray_tpu_torch.rllib import SACConfig

        def build(seed):
            return (SACConfig()
                    .environment(pendulum)
                    .training(num_steps_sampled_before_learning=32,
                              rollout_fragment_length=16,
                              updates_per_iteration=2,
                              train_batch_size=32, hidden=(16,), seed=seed)
                    .build())

        algo = build(0)
        try:
            algo.train()
            path = algo.save(str(tmp_path / "sac_ck"))
            w = algo.learner.get_weights()
            algo2 = build(5)
            try:
                algo2.restore(path)
                w2 = algo2.learner.get_weights()
                for a, b in zip(tree_leaves(w), tree_leaves(w2)):
                    np.testing.assert_array_equal(a, b)
                # the whole continuation state: the next update is the same
                batch = algo.buffer.sample(32)
                m1 = algo.learner.update(batch)
                m2 = algo2.learner.update(batch)
                assert m1["q_loss"] == m2["q_loss"]
            finally:
                algo2.stop()
        finally:
            algo.stop()


def _expert_dataset(n_episodes=40):
    """CartPole 'expert': a hand-written stabilizing controller (push
    toward upright), good for ~150-350 reward — enough signal for BC to
    beat random (~20)."""
    env = cartpole()
    episodes = []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=ep)
        rows = {"obs": [], "actions": [], "rewards": []}
        done = False
        while not done:
            a = 1 if (obs[2] + 0.3 * obs[3]) > 0 else 0
            rows["obs"].append(np.asarray(obs, np.float32))
            rows["actions"].append(a)
            nobs, r, term, trunc, _ = env.step(a)
            rows["rewards"].append(float(r))
            obs = nobs
            done = term or trunc
        rows["terminated"] = term
        episodes.append(rows)
    env.close()
    return episodes


class TestOffline:
    def test_bc_clones_expert(self, ray_start_regular):
        from ray_tpu_torch.rllib import BCConfig, episodes_to_dataset

        ds = episodes_to_dataset(_expert_dataset())
        algo = BCConfig(
            dataset=ds, observation_dim=4, action_dim=2, discrete=True,
            hidden=(32, 32), updates_per_iteration=64, lr=3e-3, seed=0,
        ).build()
        l0 = algo.train()["loss"]
        for _ in range(7):
            res = algo.train()
        assert res["loss"] < l0 * 0.6, (l0, res["loss"])
        ev = algo.evaluate(cartpole, num_episodes=5)
        assert ev["episode_return_mean"] >= 100.0, ev

    def test_marwil_beats_bc_on_mixed_data(self, ray_start_regular):
        """Mixed-quality corpus: MARWIL's advantage weighting should favor
        the good trajectories; at minimum it must stay trainable and its
        evaluation must not collapse vs BC."""
        from ray_tpu_torch.rllib import BCConfig, MARWILConfig, episodes_to_dataset

        # Half expert, half random actions.
        expert = _expert_dataset(20)
        env = cartpole()
        rng = np.random.default_rng(0)
        bad = []
        for ep in range(20):
            obs, _ = env.reset(seed=1000 + ep)
            rows = {"obs": [], "actions": [], "rewards": []}
            done = False
            while not done:
                a = int(rng.integers(0, 2))
                rows["obs"].append(np.asarray(obs, np.float32))
                rows["actions"].append(a)
                nobs, r, term, trunc, _ = env.step(a)
                rows["rewards"].append(float(r))
                obs = nobs
                done = term or trunc
            rows["terminated"] = term
            bad.append(rows)
        env.close()
        ds = episodes_to_dataset(expert + bad)

        def fit(cfg_cls, **kw):
            algo = cfg_cls(
                dataset=ds, observation_dim=4, action_dim=2, discrete=True,
                hidden=(32, 32), updates_per_iteration=64, lr=3e-3, seed=0,
                **kw).build()
            for _ in range(8):
                algo.train()
            return algo.evaluate(cartpole,
                                 num_episodes=5)["episode_return_mean"]

        marwil_ret = fit(MARWILConfig, beta=2.0)
        bc_ret = fit(BCConfig)
        assert marwil_ret >= 60.0, (marwil_ret, bc_ret)
        assert marwil_ret >= bc_ret * 0.8, (marwil_ret, bc_ret)

    def test_bc_checkpoint_roundtrip(self, ray_start_regular, tmp_path):
        from ray_tpu_torch.rllib import BCConfig, episodes_to_dataset

        ds = episodes_to_dataset(_expert_dataset(4))
        algo = BCConfig(dataset=ds, observation_dim=4, action_dim=2,
                        hidden=(16,), updates_per_iteration=4, seed=0).build()
        algo.train()
        path = algo.save(str(tmp_path / "bc_ck"))
        algo2 = BCConfig(dataset=ds, observation_dim=4, action_dim=2,
                         hidden=(16,), updates_per_iteration=4, seed=7).build()
        algo2.restore(path)
        for a, b in zip(tree_leaves(algo.learner.get_weights()),
                        tree_leaves(algo2.learner.get_weights())):
            np.testing.assert_array_equal(a, b)


class _TwoAgentBitEnv:
    """Cooperative test env on the MultiAgentEnv dict contract: each agent
    observes a 4-dim context encoding a target bit; reward 1 for matching
    it. Agent a1's bit is the NEGATION of a0's, so a shared policy cannot
    ace both — per-agent policies must specialize."""

    action_space_n = 2

    def __init__(self, episode_len=16, seed=0):
        self._len = episode_len
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._bit = 0

    def _obs(self):
        b0 = float(self._bit)
        return {
            "a0": np.array([b0, 1 - b0, 1.0, 0.0], np.float32),
            "a1": np.array([b0, 1 - b0, 0.0, 1.0], np.float32),
        }

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._bit = int(self._rng.integers(0, 2))
        return self._obs(), {}

    def step(self, actions):
        rewards = {
            "a0": float(actions["a0"] == self._bit),
            "a1": float(actions["a1"] == 1 - self._bit),
        }
        self._t += 1
        done = self._t >= self._len
        self._bit = int(self._rng.integers(0, 2))
        terms = {"a0": done, "a1": done, "__all__": done}
        truncs = {"a0": False, "a1": False, "__all__": False}
        return self._obs(), rewards, terms, truncs, {}

    def close(self):
        pass


class TestMultiAgent:
    def _policies(self):
        from ray_tpu_torch.rllib import RLModuleSpec

        spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(32,))
        return {"p0": spec, "p1": spec}

    def test_runner_groups_by_policy(self, ray_start_regular):
        from ray_tpu_torch.rllib.multi_agent import MultiAgentEnvRunner

        runner = MultiAgentEnvRunner(
            lambda: _TwoAgentBitEnv(episode_len=8),
            policies=self._policies(),
            policy_mapping_fn=lambda a: "p0" if a == "a0" else "p1",
            seed=0)
        out = runner.sample(24)
        trajs = out["trajectories"]
        assert set(trajs) == {"p0", "p1"}
        assert trajs["p0"] and trajs["p1"]
        total = sum(len(t["rewards"]) for t in trajs["p0"])
        assert total == 24  # one agent per policy, one step per env step
        assert out["num_episodes"] >= 2  # 24 steps / 8-step episodes
        t = trajs["p0"][0]
        assert t["obs"].shape[1] == 4
        assert len(t["actions"]) == len(t["logp"]) == len(t["values"])

    def test_multi_agent_ppo_learns_both_policies(self, ray_start_regular):
        """Learning gate: per-agent policies must specialize and lift the
        joint return toward the 32-per-episode max."""
        from ray_tpu_torch.rllib import MultiAgentPPOConfig

        algo = (MultiAgentPPOConfig()
                .environment(lambda: _TwoAgentBitEnv(episode_len=16))
                .multi_agent(
                    policies=self._policies(),
                    policy_mapping_fn=lambda a: "p0" if a == "a0" else "p1")
                .training(rollout_fragment_length=256, num_sgd_iter=4,
                          minibatch_size=64, lr=3e-3, entropy_coeff=0.0,
                          seed=0)
                .build())
        try:
            first, best = None, -np.inf
            for _ in range(12):
                r = algo.train()
                ret = r["episode_return_mean"]
                if not np.isnan(ret):
                    first = ret if first is None else first
                    best = max(best, ret)
                if best >= 28.0:
                    break
            # Random play averages 16 (half right); learned play nears 32.
            assert best >= 26.0, (first, best)
        finally:
            algo.stop()

    def test_multi_agent_checkpoint_roundtrip(self, ray_start_regular, tmp_path):
        from ray_tpu_torch.rllib import MultiAgentPPOConfig

        def build(seed):
            return (MultiAgentPPOConfig()
                    .environment(lambda: _TwoAgentBitEnv(episode_len=8))
                    .multi_agent(
                        policies=self._policies(),
                        policy_mapping_fn=lambda a: "p0" if a == "a0" else "p1")
                    .training(rollout_fragment_length=32, seed=seed)
                    .build())

        algo = build(0)
        try:
            algo.train()
            path = algo.save(str(tmp_path / "ma_ck"))
            algo2 = build(9)
            try:
                algo2.restore(path)
                for pid in ("p0", "p1"):
                    for a, b in zip(
                            tree_leaves(algo.learners[pid].get_weights()),
                            tree_leaves(algo2.learners[pid].get_weights())):
                        np.testing.assert_array_equal(a, b)
            finally:
                algo2.stop()
        finally:
            algo.stop()


def _pendulum_corpus(n=2000, seed=0):
    """Mediocre-policy Pendulum transitions (random + proportional
    controller mix) — enough signal for offline learning."""
    env = pendulum()
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                            "terminateds")}
    obs, _ = env.reset(seed=seed)
    for i in range(n):
        if rng.random() < 0.5:
            a = rng.uniform(-2.0, 2.0, size=(1,)).astype(np.float32)
        else:
            # crude stabilizer: torque against angular velocity
            a = np.clip(-1.5 * obs[2:3], -2.0, 2.0).astype(np.float32)
        nobs, r, term, trunc, _ = env.step(a)
        cols["obs"].append(np.asarray(obs, np.float32))
        cols["actions"].append(a)
        cols["rewards"].append(np.float32(r / 10.0))  # scale rewards
        cols["next_obs"].append(np.asarray(nobs, np.float32))
        cols["terminateds"].append(np.float32(term))
        obs = nobs
        if term or trunc:
            obs, _ = env.reset(seed=seed + i)
    env.close()
    return {k: np.stack(v) for k, v in cols.items()}


class TestCQL:
    def test_cql_penalty_pushes_down_ood_q(self, ray_start_regular):
        """The conservative term must leave Q(s, a_random) BELOW
        Q(s, a_data) after training — the defining CQL property."""
        from ray_tpu_torch.rllib import CQLConfig

        data = _pendulum_corpus(1500, seed=0)
        algo = CQLConfig(
            dataset=data, observation_dim=3, action_dim=1,
            action_low=-2.0, action_high=2.0, hidden=(32, 32),
            train_batch_size=128, updates_per_iteration=40,
            cql_alpha=5.0, lr=1e-3, seed=0,
        ).build()
        for _ in range(6):
            r = algo.train()
        assert np.isfinite(r["loss"])

        m = algo.module
        qp = algo.learner.params["q1"]
        obs = torch.from_numpy(data["obs"][:256])
        rng = np.random.default_rng(1)
        rand_a = torch.from_numpy(
            rng.uniform(-2, 2, (256, 1)).astype(np.float32))
        with torch.no_grad():
            q_data = m.q_value(qp, obs, torch.from_numpy(
                data["actions"][:256])).numpy()
            q_rand = m.q_value(qp, obs, rand_a).numpy()
        assert q_rand.mean() < q_data.mean(), (q_rand.mean(), q_data.mean())

    def test_cql_checkpoint_roundtrip(self, ray_start_regular, tmp_path):
        from ray_tpu_torch.rllib import CQLConfig

        data = _pendulum_corpus(300, seed=2)
        cfg = dict(dataset=data, observation_dim=3, action_dim=1,
                   action_low=-2.0, action_high=2.0, hidden=(16,),
                   train_batch_size=64, updates_per_iteration=4)
        algo = CQLConfig(**cfg, seed=0).build()
        algo.train()
        path = algo.save(str(tmp_path / "cql_ck"))
        algo2 = CQLConfig(**cfg, seed=7).build()
        algo2.restore(path)
        for a, b in zip(tree_leaves(algo.learner.params),
                        tree_leaves(algo2.learner.params)):
            np.testing.assert_array_equal(a.detach().numpy(),
                                          b.detach().numpy())
        ev = algo2.evaluate(pendulum, num_episodes=2)
        assert np.isfinite(ev["episode_return_mean"])
