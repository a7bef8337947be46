"""PPO — the first algorithm (reference gate: PPO CartPole/Atari).

Analog of the reference's ``rllib/algorithms/ppo/ppo.py`` (``training_step``
:403) on the new API stack: parallel EnvRunner actors sample; GAE advantages
computed on the driver (vectorized numpy); the LearnerGroup runs clipped-
surrogate SGD epochs; weights broadcast back to runners. The loss lives in
``PPOLearner.loss_fn`` and runs on whatever device the learner owns.

Counterpart of ``ray_tpu/rllib/ppo.py``: ``compute_gae`` is the same numpy,
the loss is torch, and ``save``/``restore`` go through the port's
``train/checkpoint.py`` in the JAX package's file format.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfigBase
from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.rl_module import RLModuleSpec, spec_for_env


@dataclass
class PPOConfig(AlgorithmConfigBase):
    """Reference: ``rllib/algorithms/ppo/ppo.py PPOConfig`` +
    ``algorithm_config.py`` builder style (``.environment().training()...``
    collapsed into one dataclass)."""

    env: Optional[Callable[[], Any]] = None         # env creator
    num_env_runners: int = 0                        # 0 = sample inline
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 128
    num_learners: int = 0                           # 0 = local learner
    gamma: float = 0.99
    lambda_: float = 0.95
    lr: float = 3e-4
    clip_param: float = 0.2
    vf_clip_param: float = 10.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 8
    minibatch_size: int = 256
    grad_clip: float = 0.5
    seed: int = 0
    hidden: tuple = (64, 64)
    # the Learner's device policy: "auto" (the host below 1M parameters,
    # else the card), "cpu", or a device
    learner_device: str = "auto"

    def learners(self, *, num_learners: int) -> "PPOConfig":
        self.num_learners = num_learners
        return self

    def build(self) -> "PPO":
        return PPO(self)


class PPOLearner(Learner):
    def loss_fn(self, params, batch):
        cfg = self.config
        logp, entropy, values = self.module.logp_and_entropy(
            params, batch["obs"], batch["actions"]
        )
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg["clip_param"], 1 + cfg["clip_param"]) * adv,
        )
        policy_loss = -torch.mean(surr)
        vf_err = torch.clamp(
            values - batch["value_targets"], -cfg["vf_clip_param"], cfg["vf_clip_param"]
        )
        vf_loss = torch.mean(vf_err**2)
        ent = torch.mean(entropy)
        return (
            policy_loss
            + cfg["vf_loss_coeff"] * vf_loss
            - cfg["entropy_coeff"] * ent
        )


def compute_gae(
    rewards: np.ndarray,       # [T, N]
    values: np.ndarray,        # [T, N]
    terminateds: np.ndarray,   # [T, N]
    bootstrap_value: np.ndarray,  # [N]
    *,
    gamma: float,
    lambda_: float,
    valids: np.ndarray | None = None,  # [T, N] 0 on autoreset (junk) steps
):
    """Vectorized GAE (reference: ``rllib/evaluation/postprocessing.py``).

    ``valids[t, n] == 0`` marks a gymnasium NEXT_STEP-autoreset transition:
    the action was ignored by the env and ``obs[t]`` is the *final* obs of
    the episode that just ended.  Zeroing ``last`` there (a) cuts the GAE
    trace so nothing leaks across the episode boundary, and (b) leaves
    ``next_value = values[t] = V(final obs)`` for the preceding step — which
    is exactly the truncation bootstrap the reference computes from
    ``final_observation`` (``rllib/evaluation/postprocessing.py``).
    Terminated boundaries are handled by ``nonterminal`` as usual.
    """
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last = np.zeros(N, np.float32)
    next_value = bootstrap_value
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - terminateds[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last = delta + gamma * lambda_ * nonterminal * last
        if valids is not None:
            last = last * valids[t]
        adv[t] = last
        next_value = values[t]
    targets = adv + values
    return adv, targets


class PPO:
    """Tune-compatible Algorithm (reference: Algorithm is a Trainable)."""

    def __init__(self, config: PPOConfig):
        assert config.env is not None, "config.environment(env_creator) required"
        self.config = config
        probe = config.env()
        self.spec = spec_for_env(probe)
        if config.hidden and not self.spec.conv:
            # Pixel specs keep their conv torso + (512,) head regardless of
            # the MLP default; dataclasses.replace preserves every other
            # field so new spec knobs can't silently drop here.
            import dataclasses

            self.spec = dataclasses.replace(self.spec,
                                            hidden=tuple(config.hidden))
        probe.close()

        learner_cfg = {
            "lr": config.lr,
            "clip_param": config.clip_param,
            "vf_clip_param": config.vf_clip_param,
            "vf_loss_coeff": config.vf_loss_coeff,
            "entropy_coeff": config.entropy_coeff,
            "grad_clip": config.grad_clip,
            "device": config.learner_device,
        }
        self.learner_group = LearnerGroup(
            PPOLearner, self.spec, learner_cfg,
            num_learners=config.num_learners, seed=config.seed,
        )

        if config.num_env_runners == 0:
            self._local_runner = SingleAgentEnvRunner(
                config.env,
                num_envs=config.num_envs_per_runner,
                seed=config.seed,
                spec=self.spec,
            )
            self._runners = []
        else:
            self._local_runner = None
            runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
            self._runners = [
                runner_cls.remote(
                    config.env,
                    num_envs=config.num_envs_per_runner,
                    seed=config.seed + 1000 * i,
                    spec=self.spec,
                )
                for i in range(config.num_env_runners)
            ]
        self._iteration = 0
        self._timesteps = 0
        self._sync_weights()

    # -- weight broadcast (reference: WorkerSet.sync_weights) ----------------
    def _sync_weights(self):
        weights = self.learner_group.get_weights()
        if self._local_runner is not None:
            self._local_runner.set_weights(weights)
        else:
            ray_tpu_torch.get([r.set_weights.remote(weights) for r in self._runners])

    # -- one training iteration (reference: training_step) -------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()

        # 1. sample
        if self._local_runner is not None:
            samples = [self._local_runner.sample(cfg.rollout_fragment_length)]
            metric_srcs = [self._local_runner.get_metrics()]
        else:
            samples = ray_tpu_torch.get(
                [r.sample.remote(cfg.rollout_fragment_length) for r in self._runners]
            )
            metric_srcs = ray_tpu_torch.get([r.get_metrics.remote() for r in self._runners])
        t_sample = time.perf_counter() - t0

        # 2. advantages per runner, then concat to a flat train batch
        obs_l, act_l, logp_l, adv_l, tgt_l = [], [], [], [], []
        sampled_steps = 0
        for s in samples:
            valids = s.get("valids")
            adv, tgt = compute_gae(
                s["rewards"], s["values"], s["terminateds"], s["bootstrap_value"],
                gamma=cfg.gamma, lambda_=cfg.lambda_, valids=valids,
            )
            T, N = s["rewards"].shape
            sampled_steps += T * N
            # Drop autoreset (junk) transitions entirely — their action was
            # never executed, so they carry no training signal.
            keep = (
                valids.reshape(T * N) > 0
                if valids is not None
                else np.ones(T * N, bool)
            )
            obs_l.append(s["obs"].reshape(T * N, -1)[keep])
            act_l.append(s["actions"].reshape(T * N, *s["actions"].shape[2:])[keep])
            logp_l.append(s["logp"].reshape(T * N)[keep])
            adv_l.append(adv.reshape(T * N)[keep])
            tgt_l.append(tgt.reshape(T * N)[keep])
        batch = {
            "obs": np.concatenate(obs_l),
            "actions": np.concatenate(act_l),
            "logp": np.concatenate(logp_l),
            "advantages": np.concatenate(adv_l),
            "value_targets": np.concatenate(tgt_l),
        }
        # advantage normalization (reference PPO default)
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        rows = len(batch["obs"])
        # timesteps = env steps sampled (autoreset steps included — they
        # occupy a sample slot even though their transition is dropped).
        self._timesteps += sampled_steps

        # 3. SGD epochs over minibatches
        rng = np.random.default_rng(cfg.seed + self._iteration)
        losses = []
        for _ in range(cfg.num_epochs):
            perm = rng.permutation(rows)
            for lo in range(0, rows, cfg.minibatch_size):
                idx = perm[lo : lo + cfg.minibatch_size]
                if len(idx) < 2:
                    continue
                mb = {k: v[idx] for k, v in batch.items()}
                losses.append(self.learner_group.update(mb)["loss"])
        t_total = time.perf_counter() - t0

        # 4. broadcast
        self._sync_weights()
        self._iteration += 1

        returns = [m["episode_return_mean"] for m in metric_srcs if m["num_episodes"] > 0]
        return {
            "training_iteration": self._iteration,
            "timesteps_total": self._timesteps,
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "env_steps_per_sec": sampled_steps / t_total,
            "time_sample_s": t_sample,
            "time_total_s": t_total,
        }

    # -- checkpointing (reference: Algorithm.save/restore) -------------------
    def save(self, path: str) -> str:
        from ray_tpu_torch.train.checkpoint import save_pytree

        state = self.learner_group.get_state()
        save_pytree(
            {"params": state["params"], "iteration": self._iteration,
             "timesteps": self._timesteps},
            path,
        )
        return path

    def restore(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import load_pytree

        data = load_pytree(path)
        state = self.learner_group.get_state()
        state["params"] = data["params"]
        self.learner_group.set_state(state)
        self._iteration = int(data["iteration"])
        self._timesteps = int(data["timesteps"])
        self._sync_weights()

    def stop(self) -> None:
        self.learner_group.shutdown()
        if self._local_runner is not None:
            self._local_runner.stop()
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

    # -- Tune integration ----------------------------------------------------
    @classmethod
    def as_trainable(cls, base_config: PPOConfig, stop_iters: int = 10):
        """Function trainable running ``stop_iters`` iterations, reporting
        each (reference: Algorithm subclasses Trainable; same contract)."""

        def trainable(overrides: Dict):
            import copy

            cfg = copy.copy(base_config)
            for k, v in overrides.items():
                setattr(cfg, k, v)
            algo = cfg.build()
            try:
                for _ in range(stop_iters):
                    from ray_tpu_torch import tune

                    tune.report(algo.train())
            finally:
                algo.stop()

        return trainable
