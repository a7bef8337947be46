"""The JAX package's IMPALA/APPO tests on the port's ``ray_tpu_torch.rllib``:
``tests/test_rllib.py``'s ``TestVtrace``, ``TestImpala``,
``TestImpalaLearnerGroup`` and ``TestAPPO``, and
``tests/test_rllib_podracer.py``'s ``TestRolloutLanes``,
``TestInferenceActors`` and ``TestRunnerDeath``, on the in-process runtime.
Sampled streams are torch generators, not JAX keys: learning is held to
JAX's own thresholds. The inference pool's actions and log-probs are held
bit for bit to runner-local sampling (the runner ships its noise), and the
lane transport's fragments to the task path's.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.rllib import (
    APPOConfig,
    APPOLearner,
    ImpalaConfig,
    ImpalaLearner,
    InferencePool,
    LearnerGroup,
    RLModuleSpec,
    RolloutLanes,
    SingleAgentEnvRunner,
    vtrace,
)
from ray_tpu_torch.rllib.rl_module import spec_for_env, tree_leaves

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


# Shared with the in-process runner threads: arming "fail" makes exactly
# one env step raise, which poisons one rollout-lane tick.
_FLAKY_BOX = {"fail": False}


def _flaky_cartpole():
    import gymnasium as gym

    class _OneShotFailure(gym.Wrapper):
        def step(self, action):
            if _FLAKY_BOX["fail"]:
                _FLAKY_BOX["fail"] = False
                raise RuntimeError("injected env failure")
            return self.env.step(action)

    return _OneShotFailure(gym.make("CartPole-v1"))


FRAGMENT_COLS = ("obs", "actions", "logp", "values", "rewards",
                 "terminateds", "valids", "bootstrap_value",
                 "bootstrap_obs")


class TestVtrace:
    def test_vtrace_matches_naive_reference(self):
        """Right-to-left V-trace vs a direct O(T^2) transcription of
        Espeholt et al. eq. 1."""
        rng = np.random.default_rng(0)
        T, N = 7, 3
        gamma, rho_bar, c_bar = 0.95, 1.0, 1.0
        b_logp = rng.normal(0, 0.3, (T, N)).astype(np.float32)
        t_logp = rng.normal(0, 0.3, (T, N)).astype(np.float32)
        rewards = rng.normal(0, 1, (T, N)).astype(np.float32)
        values = rng.normal(0, 1, (T, N)).astype(np.float32)
        bootstrap = rng.normal(0, 1, N).astype(np.float32)
        dones = (rng.random((T, N)) < 0.2).astype(np.float32)

        vs, pg_adv = vtrace(b_logp, t_logp, rewards, values, bootstrap,
                            dones, gamma=gamma, rho_bar=rho_bar, c_bar=c_bar)

        rho = np.minimum(rho_bar, np.exp(t_logp - b_logp))
        c = np.minimum(c_bar, np.exp(t_logp - b_logp))
        disc = gamma * (1 - dones)
        nv = np.concatenate([values[1:], bootstrap[None]], axis=0)
        deltas = rho * (rewards + disc * nv - values)
        vs_naive = values.copy()
        for t in range(T):
            for k in range(t, T):
                coef = np.ones(N, np.float32)
                for i in range(t, k):
                    coef *= disc[i] * c[i]
                vs_naive[t] += coef * deltas[k]
        np.testing.assert_allclose(np.asarray(vs), vs_naive, rtol=1e-4,
                                   atol=1e-4)
        vs_next = np.concatenate([np.asarray(vs)[1:], bootstrap[None]], axis=0)
        adv_naive = rho * (rewards + disc * vs_next - values)
        np.testing.assert_allclose(np.asarray(pg_adv), adv_naive, rtol=1e-4,
                                   atol=1e-4)

    def test_vtrace_on_policy_reduces_to_discounted_returns(self):
        T, N = 5, 2
        logp = np.zeros((T, N), np.float32)
        rewards = np.ones((T, N), np.float32)
        values = np.zeros((T, N), np.float32)
        bootstrap = np.zeros(N, np.float32)
        dones = np.zeros((T, N), np.float32)
        vs, _ = vtrace(logp, logp, rewards, values, bootstrap, dones,
                       gamma=0.9)
        expect = np.array([sum(0.9 ** (k - t) for k in range(t, T))
                           for t in range(T)], np.float32)
        np.testing.assert_allclose(np.asarray(vs)[:, 0], expect, rtol=1e-5)


class TestImpala:
    def test_impala_learns_cartpole(self, ray_start_regular):
        """Async IMPALA improves CartPole return (learning smoke gate)."""
        algo = (
            ImpalaConfig()
            .environment(cartpole)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4)
            .training(rollout_fragment_length=64, lr=5e-3,
                      broadcast_interval=1)
            .build()
        )
        try:
            first = None
            best = -np.inf
            for _ in range(12):
                result = algo.train()
                r = result["episode_return_mean"]
                if not np.isnan(r):
                    first = r if first is None else first
                    best = max(best, r)
            assert first is not None, "no episodes completed"
            assert best > max(first * 1.3, 40.0), (first, best)
        finally:
            algo.stop()

    def test_impala_with_aggregators(self, ray_start_regular):
        algo = (
            ImpalaConfig()
            .environment(cartpole)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2)
            .training(rollout_fragment_length=32, num_aggregators=1,
                      train_batch_fragments=2)
            .build()
        )
        try:
            result = algo.train()
            assert result["num_updates"] >= 1
            assert result["timesteps_total"] > 0
        finally:
            algo.stop()

    def test_steady_state_guard_sees_no_read_after_the_first_iteration(
            self, ray_start_regular):
        """From the second iteration on, ``train`` runs inside jitcheck's
        steady state, as the JAX package's does: the learner's one
        sanctioned read back a step and its weight fetch record no
        violation."""
        from ray_tpu_torch.devtools import jitcheck

        algo = ImpalaConfig(env=cartpole, num_env_runners=2,
                            num_envs_per_runner=2, rollout_fragment_length=8,
                            seed=0, rollout_lanes=False).build()
        jitcheck.install()
        jitcheck.clear_violations()
        try:
            for _ in range(3):
                algo.train()
            assert jitcheck.violations() == []
        finally:
            jitcheck.uninstall()
            algo.stop()


class TestImpalaLearnerGroup:
    def test_two_learner_impala_matches_single(self, ray_start_regular):
        """2 learners fed IDENTICAL batch halves must produce exactly the
        update a single learner gets from one half (the allreduce mean of
        two equal gradients IS that gradient)."""
        spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(16,))
        cfg = {"lr": 1e-2, "gamma": 0.99, "vf_loss_coeff": 0.5,
               "entropy_coeff": 0.01, "grad_clip": 40.0}
        T, N = 8, 2
        rng = np.random.default_rng(0)
        half = {
            "obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.float32),
            "logp": rng.normal(size=(T, N)).astype(np.float32) * 0.1 - 0.7,
            "rewards": rng.normal(size=(T, N)).astype(np.float32),
            "terminateds": np.zeros((T, N), np.float32),
            "valids": np.ones((T, N), np.float32),
            "bootstrap_obs": rng.normal(size=(N, 4)).astype(np.float32),
        }
        double = {k: (np.concatenate([v, v], axis=1)
                      if v.ndim >= 2 and k != "bootstrap_obs"
                      else np.concatenate([v, v], axis=0))
                  for k, v in half.items()}

        single = ImpalaLearner(spec, cfg, seed=0)
        single.update(half)
        expected = single.get_weights()

        group = LearnerGroup(
            ImpalaLearner, spec, cfg, num_learners=2,
            group_name="impala-parity", seed=0,
            shard_axes={"obs": 1, "actions": 1, "logp": 1, "values": 1,
                        "rewards": 1, "terminateds": 1, "valids": 1,
                        "bootstrap_obs": 0},
        )
        try:
            group.update(double)
            got = group.get_weights()
            for a, b in zip(tree_leaves(expected), tree_leaves(got)):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        finally:
            group.shutdown()

    def test_impala_trains_with_learner_group(self, ray_start_regular):
        algo = (ImpalaConfig()
                .environment(cartpole)
                .env_runners(num_env_runners=2, num_envs_per_env_runner=2)
                .training(rollout_fragment_length=32, num_learners=2,
                          lr=5e-3)
                .build())
        try:
            for _ in range(3):
                result = algo.train()
            assert np.isfinite(result["loss"])
            assert result["timesteps_total"] > 0
        finally:
            algo.stop()


class TestAPPO:
    def test_appo_clipped_surrogate_differs_from_impala(self):
        """APPOLearner = ImpalaLearner with the PPO clip: at large policy
        divergence the clipped loss must differ from the raw pg loss."""
        import torch

        spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(16,))
        cfg = {"lr": 1e-3, "gamma": 0.99, "clip_param": 0.2,
               "vf_loss_coeff": 0.5, "entropy_coeff": 0.0, "grad_clip": 40.0}
        appo = APPOLearner(spec, cfg, seed=0)
        imp = ImpalaLearner(spec, cfg, seed=0)
        T, N = 8, 4
        rng = np.random.default_rng(0)
        batch = {
            "obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.float32),
            # VERY off-policy behavior logp -> ratios far outside the clip
            "logp": np.full((T, N), -3.0, np.float32),
            "rewards": rng.normal(size=(T, N)).astype(np.float32),
            "terminateds": np.zeros((T, N), np.float32),
            "valids": np.ones((T, N), np.float32),
            "bootstrap_obs": rng.normal(size=(N, 4)).astype(np.float32),
        }
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        la = float(appo.loss_fn(appo.params, tb))
        li = float(imp.loss_fn(imp.params, tb))
        assert np.isfinite(la) and np.isfinite(li)
        assert abs(la - li) > 1e-4  # the clip actually engaged

    def test_appo_learns_cartpole(self, ray_start_regular):
        algo = (APPOConfig()
                .environment(cartpole)
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4)
                .training(rollout_fragment_length=64, lr=5e-3,
                          entropy_coeff=0.005, clip_param=0.3, seed=0)
                .build())
        try:
            first, best = None, -np.inf
            for _ in range(30):
                r = algo.train()
                ret = r["episode_return_mean"]
                if not np.isnan(ret):
                    first = ret if first is None else first
                    best = max(best, ret)
                if best >= 120.0:
                    break
            assert first is not None
            assert best >= max(first * 1.5, 60.0), (first, best)
        finally:
            algo.stop()


class TestRolloutLanes:
    def test_lane_vs_task_fragment_equivalence(self, ray_start_regular):
        """The lane transport is a transport: a runner sampled through a
        compiled-DAG tick yields bit for bit the fragment of an
        identically-seeded runner sampled over the task path."""
        runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
        lane_runner = runner_cls.remote(cartpole, num_envs=2, seed=7)
        task_runner = runner_cls.remote(cartpole, num_envs=2, seed=7)
        lanes = RolloutLanes([lane_runner], num_steps=8, depth=1)
        try:
            for _ in range(3):  # stays equal across consecutive fragments
                (lane_frag,) = lanes.next(timeout=30.0)
                task_frag = ray_tpu_torch.get(task_runner.sample.remote(8))
                for col in FRAGMENT_COLS:
                    assert np.array_equal(
                        np.asarray(lane_frag[col]),
                        np.asarray(task_frag[col])), col
                assert "metrics" in lane_frag  # metrics ride the fragment
        finally:
            lanes.teardown()
            ray_tpu_torch.kill(lane_runner)
            ray_tpu_torch.kill(task_runner)

    def test_lane_backpressure_never_drops_fragments(self, ray_start_regular):
        """A slow consumer backpressures the lane; every fragment still
        arrives, in order: each tick's first observation equals the
        previous tick's bootstrap obs per runner."""
        runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
        runners = [runner_cls.remote(cartpole, num_envs=2, seed=11 + i)
                   for i in range(2)]
        lanes = RolloutLanes(runners, num_steps=4, depth=2)
        try:
            lanes.fill()
            time.sleep(0.3)  # learner stalls; producers block on the ring
            prev = None
            for _ in range(6):
                frags = lanes.next(timeout=30.0)
                assert len(frags) == len(runners)
                if prev is not None:
                    for last, frag in zip(prev, frags):
                        assert np.array_equal(frag["obs"][0],
                                              last["bootstrap_obs"])
                prev = frags
        finally:
            lanes.teardown()
            for r in runners:
                ray_tpu_torch.kill(r)


class TestInferenceActors:
    def test_inference_actions_match_runner_local(self, ray_start_regular):
        """Sebulba == Anakin on policy output: with the same weights and
        the same runner generator, the pooled forward samples bit for bit
        the runner-local actions, log-probs and values."""
        spec = spec_for_env(cartpole())
        local = SingleAgentEnvRunner(cartpole, num_envs=3, seed=21,
                                     spec=spec)
        pool = InferencePool(1, spec, seed=0, num_clients=1)
        pool.set_weights(local.get_weights())
        remote = SingleAgentEnvRunner(cartpole, num_envs=3, seed=21,
                                      spec=spec,
                                      inference=pool.handle_for(0))
        try:
            local_frag = local.sample(12)
            remote_frag = remote.sample(12)
            for col in FRAGMENT_COLS:
                assert np.array_equal(local_frag[col], remote_frag[col]), col
        finally:
            local.stop()
            remote.stop()
            pool.stop()

    def test_impala_trains_with_inference_pool(self, ray_start_regular):
        cfg = ImpalaConfig(env=cartpole, num_env_runners=2,
                           num_envs_per_runner=2,
                           rollout_fragment_length=8, seed=0,
                           rollout_lanes=True, num_inference_actors=1)
        algo = cfg.build()
        try:
            result = algo.train()
            assert result["num_updates"] >= 1
            assert np.isfinite(result["loss"])
            assert result["timesteps_total"] > 0
            assert result["learner_idle_s"] >= 0.0
        finally:
            algo.stop()


class TestRunnerDeath:
    def _kill_and_train(self, algo):
        algo.train()
        victim = algo._runners[0]
        survivors = list(algo._runners[1:])
        ray_tpu_torch.kill(victim)
        # Two more iterations must complete with a respawned runner.
        before = algo._timesteps
        algo.train()
        result = algo.train()
        assert algo._timesteps > before
        assert np.isfinite(result["loss"])
        assert len(algo._runners) == 2
        assert algo._runners[0] is not victim
        assert all(r in algo._runners for r in survivors)
        assert all(ray_tpu_torch.get(r.ping.remote(), timeout=10.0)
                   for r in algo._runners)

    def test_impala_task_path_survives_runner_death(self, ray_start_regular):
        """ActorError from an in-flight ``sample`` respawns the runner with
        current weights and relaunches its in-flight quota."""
        cfg = ImpalaConfig(env=cartpole, num_env_runners=2,
                           num_envs_per_runner=2,
                           rollout_fragment_length=8, seed=0,
                           rollout_lanes=False)
        algo = cfg.build()
        try:
            self._kill_and_train(algo)
        finally:
            algo.stop()

    def test_impala_lane_mode_recovers_from_stage_failure(
            self, ray_start_regular):
        """A failing stage poisons its tick; IMPALA tears the lane down,
        pings the fleet, respawns any runner that won't answer and rebuilds
        the lane. Both failure kinds at once: one runner raises mid-sample,
        another has been killed."""
        _FLAKY_BOX["fail"] = False
        cfg = ImpalaConfig(env=_flaky_cartpole, num_env_runners=2,
                           num_envs_per_runner=2,
                           rollout_fragment_length=8, seed=0,
                           rollout_lanes=True, sample_timeout_s=30.0)
        algo = cfg.build()
        try:
            algo.train()
            victim = algo._runners[1]
            keeper = algo._runners[0]
            ray_tpu_torch.kill(victim)
            _FLAKY_BOX["fail"] = True  # next env step raises once
            before = algo._timesteps
            algo.train()
            result = algo.train()
            assert algo._timesteps > before
            assert np.isfinite(result["loss"])
            assert not _FLAKY_BOX["fail"], "stage failure never fired"
            assert algo._runners[0] is keeper
            assert algo._runners[1] is not victim
        finally:
            algo.stop()

    def test_appo_survives_runner_death(self, ray_start_regular):
        cfg = APPOConfig(env=cartpole, num_env_runners=2,
                         num_envs_per_runner=2,
                         rollout_fragment_length=8, seed=0,
                         rollout_lanes=False)
        algo = cfg.build()
        try:
            self._kill_and_train(algo)
        finally:
            algo.stop()
