"""CQL — conservative Q-learning, offline continuous control.

Analog of the reference's ``rllib/algorithms/cql/cql.py`` (which builds on
SAC the same way): the learner is SAC's twin-Q actor-critic plus the
CQL(H) conservative regularizer

    α_cql · E_s[ logsumexp_a Q(s, a) − Q(s, a_data) ]

with the logsumexp estimated over uniform-random and current-policy
actions (Kumar et al. 2020). Pushing DOWN Q on out-of-distribution
actions while anchoring it on dataset actions keeps the learned policy
inside the data support. Training reads a ``ray_tpu_torch.data`` Dataset
(or columnar arrays); there are no env runners.

Counterpart of ``ray_tpu/rllib/cql.py``; the penalty's draws ride the step's
noise (``CQLLearner._step_noise``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfigBase
from ray_tpu_torch.rllib.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.sac import SACLearner, SACModule


class CQLLearner(SACLearner):
    """SAC learner + CQL(H) conservative penalty on both Q heads."""

    def _step_noise(self, n: int) -> Dict[str, torch.Tensor]:
        """SAC's draws, then the penalty's: uniforms in [-1, 1) for the
        random actions and normals for the policy's, [S, n, A] each."""
        noise = super()._step_noise(n)
        shape = (self.config.get("cql_n_actions", 4), n,
                 self.module.spec.action_dim)
        noise["cql_unit"] = 2.0 * torch.rand(
            shape, generator=self._gen, device=self.device) - 1.0
        noise["cql_pi"] = torch.randn(shape, generator=self._gen,
                                      device=self.device)
        return noise

    def _conservative_penalty(self, qp, params, batch, noise):
        m = self.module
        n_samples = self.config.get("cql_n_actions", 4)
        alpha_cql = self.config.get("cql_alpha", 1.0)
        obs = batch["obs"]
        # Uniform actions over the env range + current-policy actions —
        # the sampled support of the logsumexp. The policy is a constant
        # here: only the critics get this term's gradient.
        scale = m._scale.to(obs.device)
        center = m._center.to(obs.device)
        rand_actions = noise["cql_unit"] * scale + center
        with torch.no_grad():
            pi_actions = torch.stack([
                m.pi_sample(params["pi"], obs, noise["cql_pi"][i])[0]
                for i in range(n_samples)])
        all_actions = torch.cat([rand_actions, pi_actions])  # [2S, B, A]

        def q_on(qparams):
            qs = torch.stack([m.q_value(qparams, obs, all_actions[i])
                              for i in range(2 * n_samples)])  # [2S, B]
            lse = torch.logsumexp(qs, dim=0) - math.log(2.0 * n_samples)
            data_q = m.q_value(qparams, batch["obs"], batch["actions"])
            return torch.mean(lse - data_q)

        return alpha_cql * (q_on(qp["q1"]) + q_on(qp["q2"]))


@dataclass
class CQLConfig(AlgorithmConfigBase):
    dataset: Any = None                 # ray_tpu_torch.data Dataset OR dict of columns
    observation_dim: Optional[int] = None
    action_dim: Optional[int] = None
    action_low: Any = None
    action_high: Any = None
    hidden: Tuple[int, ...] = (64, 64)
    train_batch_size: int = 256
    updates_per_iteration: int = 64
    gamma: float = 0.99
    lr: float = 3e-4
    tau: float = 0.005
    cql_alpha: float = 1.0
    cql_n_actions: int = 4
    seed: int = 0

    def build(self) -> "CQL":
        return CQL(self)


class CQL:
    """Tune-compatible offline train() over a fixed transition corpus."""

    def __init__(self, config: CQLConfig):
        assert config.dataset is not None, "config.dataset required"
        assert config.observation_dim and config.action_dim, (
            "observation_dim/action_dim required (offline data, no env)")
        self.config = config
        low = np.asarray(
            config.action_low if config.action_low is not None else -1.0,
            np.float32).reshape(-1)
        high = np.asarray(
            config.action_high if config.action_high is not None else 1.0,
            np.float32).reshape(-1)
        if low.shape[0] == 1:
            low = np.repeat(low, config.action_dim)
            high = np.repeat(high, config.action_dim)
        self.spec = RLModuleSpec(
            observation_dim=config.observation_dim,
            action_dim=config.action_dim, discrete=False,
            hidden=tuple(config.hidden))
        self.module = SACModule(self.spec, low, high,
                                hidden=tuple(config.hidden))
        self.learner = CQLLearner(self.module, {
            "lr": config.lr, "gamma": config.gamma, "tau": config.tau,
            "cql_alpha": config.cql_alpha,
            "cql_n_actions": config.cql_n_actions,
        }, seed=config.seed)

        if isinstance(config.dataset, dict):
            cols = {k: np.asarray(v) for k, v in config.dataset.items()}
        else:
            rows = config.dataset.take_all()
            cols = {
                k: np.stack([np.asarray(r[k], np.float32) for r in rows])
                for k in ("obs", "actions", "rewards", "next_obs",
                          "terminateds")
            }
        self._cols = cols
        self._n = len(cols["rewards"])
        self._rng = np.random.default_rng(config.seed)
        self._iteration = 0

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        q_losses = []
        for _ in range(cfg.updates_per_iteration):
            idx = self._rng.integers(0, self._n,
                                     min(cfg.train_batch_size, self._n))
            batch = {k: v[idx] for k, v in self._cols.items()}
            m = self.learner.update(batch)
            q_losses.append(m["q_loss"])
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "loss": float(np.mean(q_losses)),
            "num_samples": self._n,
            "time_total_s": time.perf_counter() - t0,
        }

    def evaluate(self, env_creator: Callable[[], Any],
                 num_episodes: int = 5, seed: int = 0) -> Dict[str, float]:
        """Mean-policy rollout in a real env."""
        env = env_creator()
        params = self.learner.params
        dev = self.learner.device
        scale, center = self.module._scale, self.module._center
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=seed + ep)
            done, total = False, 0.0
            while not done:
                with torch.no_grad():
                    out = self.module.forward_inference(
                        params, torch.as_tensor(
                            np.asarray(obs, np.float32)[None], device=dev))
                    # mean action, squashed + scaled like pi_sample's center
                    a = (torch.tanh(out["action_dist_inputs"][0]).cpu()
                         * scale + center).numpy()
                obs, r, term, trunc, _ = env.step(a)
                total += float(r)
                done = term or trunc
            returns.append(total)
        env.close()
        return {"episode_return_mean": float(np.mean(returns)),
                "num_episodes": float(num_episodes)}

    def save(self, path: str) -> str:
        from ray_tpu_torch.train.checkpoint import save_pytree

        save_pytree({"state": self.learner.get_state(),
                     "iteration": self._iteration}, path)
        return path

    def restore(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import load_pytree

        data = load_pytree(path)
        self.learner.set_state(data["state"])
        self._iteration = int(data["iteration"])

    def stop(self) -> None:
        pass
