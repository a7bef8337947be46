"""EnvRunner — vectorized environment sampling actors.

Analog of the reference's ``rllib/env/single_agent_env_runner.py:101
sample``: each runner holds a vectorized gymnasium env + a local copy of the
module params, steps envs with forward passes on the host CPU, and returns
columnar sample batches (numpy — they cross the object store to the
learners). Episode returns are tracked per sub-env for metrics.

Counterpart of ``ray_tpu/rllib/env_runner.py``: the runner samples on the
host CPU as the JAX package's does, with a per-runner ``torch.Generator``
(seeded ``seed + 10_000``) in place of its key. The shared inference actor
(``inference=``) waits for the rollout-lane algorithms.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.rl_module import (RLModule, RLModuleSpec, spec_for_env,
                                           tree_map)


class SingleAgentEnvRunner:
    def __init__(
        self,
        env_creator: Callable[[], Any],
        *,
        num_envs: int = 1,
        seed: int = 0,
        spec: Optional[RLModuleSpec] = None,
        module_factory: Optional[Callable[[RLModuleSpec], Any]] = None,
    ):
        import gymnasium as gym

        self._envs = gym.vector.SyncVectorEnv(
            [self._thunk(env_creator, seed + i) for i in range(num_envs)]
        )
        self.num_envs = num_envs
        probe = env_creator()
        self.spec = spec or spec_for_env(probe)
        probe.close()
        # Algorithms with non-actor-critic policies (SAC's tanh-squashed
        # Gaussian) plug in their own module; the contract is
        # ``init_params`` / ``sample_action(params, obs, generator)`` /
        # ``forward_inference`` (reference: RLModuleSpec.module_class).
        self.module = (module_factory(self.spec) if module_factory
                       else RLModule(self.spec))
        # Env-runner inference is tiny and latency-bound: it runs on the
        # host CPU. The card belongs to learners — shipping a 4-float
        # CartPole obs across PCIe per step would make sampling
        # latency-bound.
        self._params = self.module.init_params(seed, "cpu")
        self._gen = torch.Generator()
        self._gen.manual_seed(seed + 10_000)
        # Value-based algorithms (DQN family) explore epsilon-greedily over
        # the argmax policy instead of sampling the softmax
        # (rllib/utils/exploration/epsilon_greedy.py analog).
        self._greedy = False
        self._epsilon = 0.0
        self._np_rng = np.random.default_rng(seed + 20_000)
        self._obs, _ = self._envs.reset(seed=seed)
        # gymnasium >=1.0 vector envs autoreset on the step AFTER done
        # (NEXT_STEP mode): that step ignores the action and returns the new
        # episode's reset obs with reward 0.  Transitions recorded on such
        # steps are junk (action never executed) and must be masked out of
        # GAE and the loss; this tracks which sub-envs are in that state.
        self._autoreset = np.zeros(num_envs, dtype=bool)
        self._ep_returns = np.zeros(num_envs)
        self._ep_lens = np.zeros(num_envs, dtype=np.int64)
        self._completed: List[float] = []
        self._completed_lens: List[int] = []

    @staticmethod
    def _thunk(creator, seed):
        def make():
            env = creator()
            env.reset(seed=seed)
            return env

        return make

    # -- weights sync (reference: WorkerSet weight broadcast) ----------------
    def set_weights(self, params) -> bool:
        self._params = tree_map(
            lambda x: torch.tensor(np.asarray(x)) if not isinstance(
                x, torch.Tensor) else x.detach().to("cpu", copy=True),
            params)
        return True

    def get_weights(self):
        return tree_map(lambda t: t.numpy().copy(), self._params)

    def set_exploration(self, epsilon: float, greedy: bool = True) -> bool:
        """Epsilon-greedy exploration for value-based learners: with prob
        epsilon a uniform random action, else argmax over the head outputs
        (interpreted as Q-values)."""
        assert self.spec.discrete, "epsilon-greedy needs a discrete space"
        self._epsilon = float(epsilon)
        self._greedy = bool(greedy)
        return True

    # -- sampling ------------------------------------------------------------
    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect ``num_steps`` per sub-env; returns a columnar batch with
        bootstrap values for GAE (shape [T, N, ...] flattened to [T*N, ...]
        AFTER advantage computation by the algorithm — kept 2D here)."""
        T, N = num_steps, self.num_envs
        # Pixel obs stay uint8 end-to-end (the conv torso casts /255 on
        # device) — 4x less object-plane traffic than float32.
        obs_dtype = np.uint8 if self.spec.conv else np.float32
        obs_buf = np.zeros((T, N, self.spec.observation_dim), obs_dtype)
        act_shape = (T, N) if self.spec.discrete else (T, N, self.spec.action_dim)
        act_buf = np.zeros(act_shape, np.float32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        valid_buf = np.ones((T, N), np.float32)

        for t in range(T):
            obs = np.asarray(self._obs, obs_dtype).reshape(N, -1)
            with torch.inference_mode():
                if self._greedy:
                    logits = self.module.forward_inference(
                        self._params, torch.from_numpy(obs))[
                            "action_dist_inputs"]
                    action_np = torch.argmax(logits, dim=-1).numpy()
                    logp_np = np.zeros(N, np.float32)
                    val_np = np.zeros(N, np.float32)
                    if self._epsilon > 0:
                        explore = self._np_rng.random(N) < self._epsilon
                        randoms = self._np_rng.integers(
                            0, self.spec.action_dim, N)
                        action_np = np.where(explore, randoms, action_np)
                else:
                    action, logp, value = self.module.sample_action(
                        self._params, torch.from_numpy(obs), self._gen)
                    action_np, logp_np, val_np = (
                        action.numpy(), logp.numpy(), value.numpy())
            env_action = action_np.astype(np.int64) if self.spec.discrete else action_np
            next_obs, reward, terminated, truncated, _ = self._envs.step(env_action)
            done = np.logical_or(terminated, truncated)

            obs_buf[t] = obs
            act_buf[t] = action_np
            logp_buf[t] = logp_np
            val_buf[t] = val_np
            rew_buf[t] = reward
            # GAE must not bootstrap across true terminations; truncations
            # keep bootstrapping (the obs recorded on the autoreset step is
            # the truncated episode's FINAL obs, so its value is exactly the
            # truncation bootstrap — see compute_gae's valids handling).
            done_buf[t] = terminated.astype(np.float32)
            valid_buf[t] = (~self._autoreset).astype(np.float32)
            self._autoreset = done.copy()

            live = (valid_buf[t] > 0)
            self._ep_returns += reward * live
            self._ep_lens += live.astype(np.int64)
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._ep_returns[i]))
                self._completed_lens.append(int(self._ep_lens[i]))
                self._ep_returns[i] = 0.0
                self._ep_lens[i] = 0
            self._obs = next_obs

        # bootstrap value of the final observation
        last_obs = np.asarray(self._obs, obs_dtype).reshape(N, -1)
        with torch.inference_mode():
            last_val = self.module.forward_inference(
                self._params, torch.from_numpy(last_obs))["vf_preds"].numpy()

        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "terminateds": done_buf,
            "valids": valid_buf,
            "bootstrap_value": last_val,
            # Off-policy learners (V-trace) re-evaluate the bootstrap under
            # the CURRENT policy — they need the obs, not our stale value.
            "bootstrap_obs": last_obs,
        }

    def sample_dag(self, payload: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """One rollout-lane tick (the compiled DAG's rollout lanes). A lane-parked
        actor's execution thread lives inside the DAG loop, so ordinary
        method calls (``set_weights``/``get_metrics``) would queue behind
        it forever — weight updates ride the tick payload in and episode
        metrics ride the fragment out instead."""
        weights = payload.get("weights")
        if weights is not None:
            self.set_weights(weights)
        fragment = self.sample(int(payload["num_steps"]))
        fragment["metrics"] = self.get_metrics()
        return fragment

    def ping(self) -> bool:
        """Liveness probe for the driver's respawn path."""
        return True

    def get_metrics(self) -> Dict[str, float]:
        completed, self._completed = self._completed, []
        lens, self._completed_lens = self._completed_lens, []
        return {
            "episode_return_mean": float(np.mean(completed)) if completed else float("nan"),
            "episode_len_mean": float(np.mean(lens)) if lens else float("nan"),
            "num_episodes": float(len(completed)),
        }

    def stop(self) -> None:
        self._envs.close()
