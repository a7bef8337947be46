"""DQN — the off-policy value-learning family.

Analog of the reference's ``rllib/algorithms/dqn/dqn.py`` on the new API
stack: EnvRunner actors explore epsilon-greedily, transitions land in a
replay buffer (prioritized by default, with n-step returns), and the learner
minimizes the Huber TD error against a periodically-synced TARGET network
(Mnih et al. 2015; double-DQN action selection per van Hasselt 2016 is the
default, as in the reference).

Counterpart of ``ray_tpu/rllib/dqn.py``: the TD targets run under
``torch.no_grad`` on the learner's device, the target sync is a tensor copy,
and the learner takes the port's ``Learner`` device policy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfigBase
from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.learner import Learner, _host
from ray_tpu_torch.rllib.rl_module import spec_for_env, tree_leaves, tree_map


class ReplayBuffer:
    """Uniform ring-buffer replay (reference:
    ``rllib/utils/replay_buffers/replay_buffer.py``)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._storage: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def add_batch(self, transitions: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(transitions.values())))
        if not self._storage:
            for k, v in transitions.items():
                shape = (self.capacity,) + v.shape[1:]
                self._storage[k] = np.zeros(shape, v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in transitions.items():
            self._storage[k][idx] = v
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self.capacity, self._size + n)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        return {k: v[idx] for k, v in self._storage.items()}

    def __len__(self) -> int:
        return self._size


def _q_of(q: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``q[arange(B), actions]``."""
    return q.gather(-1, actions.to(torch.int64)[:, None])[:, 0]


class DQNLearner(Learner):
    """Huber TD loss vs a target network; the head's outputs ARE Q(s, .)."""

    def __init__(self, spec, config: Dict[str, Any], seed: int = 0):
        super().__init__(spec, config, seed=seed)
        self.target_params = self._copy_params()
        self._updates = 0

    def _copy_params(self):
        return tree_map(lambda t: t.detach().clone(), self.params)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    @torch.no_grad()
    def _targets_fn(self, target_params, online_params, next_obs, rewards,
                    terminateds, discounts) -> torch.Tensor:
        next_obs, rewards, terminateds, discounts = (
            self._tensor(x) if not isinstance(x, torch.Tensor)
            else x.to(self.device)
            for x in (next_obs, rewards, terminateds, discounts))
        q_next_t = self.module.forward_train(
            target_params, next_obs)["action_dist_inputs"]
        if self.config.get("double_q", True):
            # Double DQN: ONLINE net picks the argmax action, the
            # TARGET net evaluates it (van Hasselt 2016).
            q_next_o = self.module.forward_train(
                online_params, next_obs)["action_dist_inputs"]
            next_q = _q_of(q_next_t, torch.argmax(q_next_o, dim=-1))
        else:
            next_q = torch.max(q_next_t, dim=-1).values
        # Per-sample discount γ^s (n-step chains have varying length).
        return rewards + discounts * (1.0 - terminateds) * next_q

    @torch.no_grad()
    def _errors_fn(self, params, obs, actions, targets) -> torch.Tensor:
        q = self.module.forward_train(params, obs)["action_dist_inputs"]
        return _q_of(q, actions) - targets

    def loss_fn(self, params, batch):
        q = self.module.forward_train(params, batch["obs"])["action_dist_inputs"]
        err = _q_of(q, batch["actions"]) - batch["targets"]
        # Huber (delta=1): quadratic near 0, linear in the tails.
        huber = torch.where(torch.abs(err) <= 1.0, 0.5 * err ** 2,
                            torch.abs(err) - 0.5)
        # PER importance weights (ones under uniform replay).
        return torch.mean(batch["weights"] * huber)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        n = len(batch["rewards"])
        discounts = batch.get(
            "discounts",
            np.full(n, self.config.get("gamma", 0.99), np.float32))
        targets = self._targets_fn(
            self.target_params, self.params, batch["next_obs"],
            batch["rewards"], batch["terminateds"], discounts)
        weights = batch.get("weights", np.ones(n, np.float32))
        metrics = super().update({
            "obs": batch["obs"],
            "actions": batch["actions"],
            "targets": _host(targets),
            "weights": weights,
        })
        if "indices" in batch:
            # |TD error| for PER priority refresh (post-update params) —
            # skipped under uniform replay, where nothing would read it.
            metrics["td_errors"] = _host(self._errors_fn(
                self.params, self._tensor(batch["obs"]),
                self._tensor(batch["actions"]), targets))
        self._updates += 1
        if self._updates % self.config.get("target_update_freq", 100) == 0:
            self.target_params = self._copy_params()
        return metrics

    def get_state(self) -> Dict:
        state = super().get_state()
        state["target_params"] = tree_map(_host, self.target_params)
        state["updates"] = self._updates
        return state

    def set_state(self, state: Dict) -> bool:
        super().set_state(state)
        if "target_params" in state:
            self.target_params = tree_map(
                lambda p: torch.empty_like(p, requires_grad=False),
                self.params)
            with torch.no_grad():
                for t, v in zip(tree_leaves(self.target_params),
                                tree_leaves(state["target_params"])):
                    t.copy_(torch.as_tensor(np.asarray(v)))
            self._updates = int(state.get("updates", 0))
        return True


@dataclass
class DQNConfig(AlgorithmConfigBase):
    env: Optional[Callable[[], Any]] = None
    num_env_runners: int = 1
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 32
    buffer_capacity: int = 50_000
    train_batch_size: int = 64
    num_steps_sampled_before_learning: int = 500
    updates_per_iteration: int = 32
    target_update_freq: int = 100
    gamma: float = 0.99
    lr: float = 1e-3
    grad_clip: float = 10.0
    double_q: bool = True
    # Prioritized replay (the reference's DQN default) + n-step returns.
    replay: str = "prioritized"  # "prioritized" | "uniform"
    per_alpha: float = 0.6
    per_beta: float = 0.4
    n_step: int = 1
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_timesteps: int = 5_000
    seed: int = 0
    hidden: Optional[tuple] = None

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    """Tune-compatible train() contract (reference: dqn.py training_step)."""

    def __init__(self, config: DQNConfig):
        assert config.env is not None, "config.environment(env_creator) required"
        self.config = config
        probe = config.env()
        self.spec = spec_for_env(probe)
        probe.close()
        assert self.spec.discrete, "DQN requires a discrete action space"
        if config.hidden and not self.spec.conv:
            import dataclasses

            self.spec = dataclasses.replace(self.spec,
                                            hidden=tuple(config.hidden))

        self.learner = DQNLearner(self.spec, {
            "lr": config.lr, "gamma": config.gamma,
            "grad_clip": config.grad_clip, "double_q": config.double_q,
            "target_update_freq": config.target_update_freq,
        }, seed=config.seed)
        if config.replay == "prioritized":
            from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer

            self.buffer = PrioritizedReplayBuffer(
                config.buffer_capacity, alpha=config.per_alpha,
                beta=config.per_beta, seed=config.seed)
        else:
            self.buffer = ReplayBuffer(config.buffer_capacity,
                                       seed=config.seed)

        runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
        self._runners = [
            runner_cls.remote(
                config.env, num_envs=config.num_envs_per_runner,
                seed=config.seed + 1000 * i, spec=self.spec,
            )
            for i in range(max(1, config.num_env_runners))
        ]
        self._timesteps = 0
        self._iteration = 0
        self._updates = 0
        self._sync_runners()

    # -- plumbing ------------------------------------------------------------
    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._timesteps / max(1, c.epsilon_decay_timesteps))
        return c.epsilon_initial + frac * (c.epsilon_final - c.epsilon_initial)

    def _sync_runners(self) -> None:
        weights = self.learner.get_weights()
        eps = self._epsilon()
        ray_tpu_torch.get([r.set_weights.remote(weights) for r in self._runners])
        ray_tpu_torch.get([r.set_exploration.remote(eps)
                           for r in self._runners])

    def _to_transitions(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """[T, N] rollout columns -> flat (s, a, R^(n), s_{t+n}, done, γ^s)
        transitions via the shared n-step preprocessor (replay.py).

        gymnasium NEXT_STEP autoreset: obs[t+1] is the episode's FINAL obs
        when step t ended it (reset obs only appears one step later), so
        (obs[t], a[t], r[t], obs[t+1]) is a valid transition for both
        termination and truncation; the autoreset step itself
        (valids==0) is junk, dropped here and treated as a chain break by
        the n-step accumulation."""
        from ray_tpu_torch.rllib.replay import nstep_columns

        cols = nstep_columns(
            sample["obs"], sample["rewards"], sample["terminateds"],
            sample["valids"], sample["bootstrap_obs"],
            n_step=self.config.n_step, gamma=self.config.gamma)
        keep = cols.pop("_keep")
        cols["actions"] = sample["actions"].reshape(-1)[keep]
        return cols

    # -- the Tune contract ---------------------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        samples = ray_tpu_torch.get(
            [r.sample.remote(cfg.rollout_fragment_length)
             for r in self._runners])
        for s in samples:
            trans = self._to_transitions(s)
            self.buffer.add_batch(trans)
            self._timesteps += len(trans["rewards"])

        losses = []
        if (len(self.buffer) >= cfg.num_steps_sampled_before_learning
                and len(self.buffer) >= cfg.train_batch_size):
            for _ in range(cfg.updates_per_iteration):
                batch = self.buffer.sample(cfg.train_batch_size)
                m = self.learner.update(batch)
                if "indices" in batch:
                    # PER priority refresh from this step's |TD error|.
                    self.buffer.update_priorities(batch["indices"],
                                                  m["td_errors"])
                losses.append(m["loss"])
                self._updates += 1
        self._sync_runners()

        self._iteration += 1
        metrics = ray_tpu_torch.get([r.get_metrics.remote()
                                     for r in self._runners])
        returns = [m["episode_return_mean"] for m in metrics
                   if m["num_episodes"] > 0]
        dt = time.perf_counter() - t0
        return {
            "training_iteration": self._iteration,
            "timesteps_total": self._timesteps,
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "epsilon": self._epsilon(),
            "buffer_size": len(self.buffer),
            "num_updates": self._updates,
            "env_steps_per_sec": (len(self._runners) * cfg.rollout_fragment_length
                                  * cfg.num_envs_per_runner) / dt,
            "time_total_s": dt,
        }

    def save(self, path: str) -> str:
        from ray_tpu_torch.train.checkpoint import save_pytree

        save_pytree({"state": self.learner.get_state(),
                     "iteration": self._iteration,
                     "timesteps": self._timesteps}, path)
        return path

    def restore(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import load_pytree

        data = load_pytree(path)
        self.learner.set_state(data["state"])
        self._iteration = int(data["iteration"])
        self._timesteps = int(data["timesteps"])
        self._sync_runners()

    def stop(self) -> None:
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass
