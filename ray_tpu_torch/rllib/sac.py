"""SAC — soft actor-critic, the off-policy continuous-control family.

Analog of the reference's ``rllib/algorithms/sac/sac.py`` (which subclasses
DQN; here SAC shares DQN's machinery the same way: the prioritized replay
buffer and n-step preprocessing from ``rllib/replay.py``, the env-runner
actors, and the Tune-compatible ``train()`` contract). Haarnoja et al.
2018: tanh-squashed Gaussian policy, twin Q networks with min-clipping,
entropy temperature α auto-tuned against a target entropy.

Counterpart of ``ray_tpu/rllib/sac.py``. One update is critic → actor → α →
polyak target blend, each a backward and an Adam step (three
``torch.optim.Adam``, optax's ``adam`` each); the step's two Gaussian draws
come from the learner's ``torch.Generator`` (``_step_noise``) where the JAX
package splits a key, and ``_step`` takes them explicitly. The learner takes
the port's ``Learner`` device policy.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfigBase
from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.learner import (_host, adam_state_tree, learner_device,
                                         load_adam_state)
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer, nstep_columns
from ray_tpu_torch.rllib.rl_module import (RLModuleSpec, _generator,
                                           spec_for_env, tree_leaves, tree_map)
from ray_tpu_torch.utils.device import resolve_device

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0


def _mlp_init(g: torch.Generator, dims):
    return [{"w": torch.randn((a, b), generator=g) * math.sqrt(2.0 / a),
             "b": torch.zeros(b)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp(params, x):
    for layer in params[:-1]:
        x = F.relu(x @ layer["w"] + layer["b"])
    last = params[-1]
    return x @ last["w"] + last["b"]


class SACModule:
    """Policy + twin Q. Satisfies the env-runner module contract
    (``init_params`` / ``draw_noise`` / ``sample_with_noise`` /
    ``sample_action`` / ``forward_inference``)."""

    def __init__(self, spec: RLModuleSpec,
                 action_low: np.ndarray, action_high: np.ndarray,
                 hidden: Tuple[int, ...] = (256, 256)):
        assert not spec.discrete, "SAC requires a continuous action space"
        self.spec = spec
        self.hidden = hidden
        low = np.asarray(action_low, np.float32)
        high = np.asarray(action_high, np.float32)
        self._scale = torch.as_tensor((high - low) / 2.0)
        self._center = torch.as_tensor((high + low) / 2.0)

    def init_params(self, seed: Union[int, torch.Generator] = 0,
                    device: Optional[Union[str, torch.device]] = None) -> Dict:
        """Draws on a CPU generator, then moves the tree to ``device`` (the
        card unless the caller asks for the CPU)."""
        s = self.spec
        g = _generator(seed)
        params = {
            "pi": _mlp_init(g, (s.observation_dim,) + self.hidden
                            + (2 * s.action_dim,)),
            "q1": _mlp_init(g, (s.observation_dim + s.action_dim,)
                            + self.hidden + (1,)),
            "q2": _mlp_init(g, (s.observation_dim + s.action_dim,)
                            + self.hidden + (1,)),
        }
        dev = resolve_device(device)
        return tree_map(lambda t: t.to(dev), params)

    # -- policy ---------------------------------------------------------------

    def _pi_dist(self, pi_params, obs):
        out = _mlp(pi_params, obs)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)

    def pi_sample(self, pi_params, obs, eps):
        """(env_action, logp, squashed_unit_action) for the standard
        normals ``eps`` — reparameterized."""
        mean, log_std = self._pi_dist(pi_params, obs)
        pre = mean + torch.exp(log_std) * eps
        a = torch.tanh(pre)
        # logp under the squashed distribution (tanh change of variables).
        logp = torch.sum(
            -0.5 * eps ** 2 - log_std - 0.5 * math.log(2 * math.pi)
            - torch.log(1.0 - a ** 2 + 1e-6),
            dim=-1)
        scale, center = self._scale.to(a.device), self._center.to(a.device)
        return a * scale + center, logp, a

    def q_value(self, q_params, obs, env_action):
        # Q nets see UNIT actions: normalize the env-scaled input.
        a = ((env_action - self._center.to(env_action.device))
             / self._scale.to(env_action.device))
        return _mlp(q_params, torch.cat([obs, a], dim=-1))[..., 0]

    # -- env-runner contract --------------------------------------------------

    def draw_noise(self, n: int, generator: torch.Generator,
                   device=None) -> torch.Tensor:
        return torch.randn((n, self.spec.action_dim), generator=generator,
                           device=device)

    def sample_with_noise(self, params, obs, noise):
        act, logp, _ = self.pi_sample(params["pi"], obs,
                                      noise.to(obs.dtype))
        return act, logp, torch.zeros(obs.shape[0], device=obs.device)

    def sample_action(self, params, obs, generator):
        return self.sample_with_noise(
            params, obs, self.draw_noise(obs.shape[0], generator, obs.device))

    def forward_inference(self, params, obs):
        mean, _ = self._pi_dist(params["pi"], obs)
        return {"action_dist_inputs": mean,
                "vf_preds": torch.zeros(obs.shape[0], device=obs.device)}

    forward_train = forward_inference


def _sac_policy_spec(module: SACModule) -> RLModuleSpec:
    """The spec whose parameter count the device policy reads."""
    import dataclasses

    return dataclasses.replace(module.spec, hidden=tuple(module.hidden))


class SACLearner:
    """One update: critic → actor → α → polyak, on the learner's device."""

    def __init__(self, module: SACModule, config: Dict[str, Any],
                 seed: int = 0):
        self.module = module
        self.config = dict(config)
        self.device = learner_device(_sac_policy_spec(module),
                                     self.config.get("device", "auto"))
        self.params = tree_map(lambda t: t.requires_grad_(True),
                               module.init_params(seed, self.device))
        self.target_q = tree_map(lambda t: t.detach().clone(),
                                 {"q1": self.params["q1"],
                                  "q2": self.params["q2"]})
        self.log_alpha = torch.tensor(
            float(np.log(self.config.get("initial_alpha", 1.0))),
            device=self.device, requires_grad=True)
        act_dim = module.spec.action_dim
        self.target_entropy = float(
            self.config.get("target_entropy", -act_dim))

        lr = self.config.get("lr", 3e-4)
        self._pi_leaves = tree_leaves(self.params["pi"])
        self._q_tree = {"q1": self.params["q1"], "q2": self.params["q2"]}
        self._q_leaves = tree_leaves(self._q_tree)
        self.pi_opt = torch.optim.Adam(
            self._pi_leaves, lr=self.config.get("actor_lr", lr), eps=1e-8)
        self.q_opt = torch.optim.Adam(
            self._q_leaves, lr=self.config.get("critic_lr", lr), eps=1e-8)
        self.a_opt = torch.optim.Adam(
            [self.log_alpha], lr=self.config.get("alpha_lr", lr), eps=1e-8)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)
        self._updates = 0

    # -- the step's randomness -------------------------------------------------

    def _step_noise(self, n: int) -> Dict[str, torch.Tensor]:
        """The step's draws: the next-state policy sample's normals and the
        actor's (the JAX package's ``k1`` and ``k2``)."""
        a = self.module.spec.action_dim
        return {"next": torch.randn((n, a), generator=self._gen,
                                    device=self.device),
                "pi": torch.randn((n, a), generator=self._gen,
                                  device=self.device)}

    def _conservative_penalty(self, qp, params, batch, noise):
        """0 for plain SAC; CQL overrides with the logsumexp penalty."""
        return 0.0

    # -- losses ---------------------------------------------------------------

    def _critic_target(self, params, target_q, alpha, batch, eps):
        """y = r + γ^s (1-d) [min Q_t(s', a') - α log π(a'|s')]."""
        m = self.module
        with torch.no_grad():
            a2, logp2, _ = m.pi_sample(params["pi"], batch["next_obs"], eps)
            qt = torch.minimum(
                m.q_value(target_q["q1"], batch["next_obs"], a2),
                m.q_value(target_q["q2"], batch["next_obs"], a2))
            return (batch["rewards"]
                    + batch["discounts"] * (1.0 - batch["terminateds"])
                    * (qt - alpha * logp2))

    def _critic_loss(self, qp, params, y, batch, noise):
        m = self.module
        q1 = m.q_value(qp["q1"], batch["obs"], batch["actions"])
        q2 = m.q_value(qp["q2"], batch["obs"], batch["actions"])
        loss = torch.mean(batch["weights"] * ((q1 - y) ** 2 + (q2 - y) ** 2))
        # Subclass hook (CQL): conservative regularizer on OOD actions.
        loss = loss + self._conservative_penalty(qp, params, batch, noise)
        return loss, (q1 - y).detach()

    def _actor_loss(self, pp, qp, alpha, batch, eps):
        """max E[min Q(s, a_π) - α log π]; ``qp`` are the updated critics."""
        m = self.module
        a_pi, logp_pi, _ = m.pi_sample(pp, batch["obs"], eps)
        q_pi = torch.minimum(m.q_value(qp["q1"], batch["obs"], a_pi),
                             m.q_value(qp["q2"], batch["obs"], a_pi))
        return torch.mean(alpha * logp_pi - q_pi), logp_pi.detach()

    def _alpha_loss(self, log_alpha, logp_pi):
        """Drive E[log π] toward -target_entropy."""
        return -torch.mean(log_alpha * (logp_pi + self.target_entropy))

    def _step(self, batch: Dict[str, torch.Tensor],
              noise: Dict[str, torch.Tensor]):
        tau = self.config.get("tau", 0.005)
        alpha = torch.exp(self.log_alpha.detach())
        y = self._critic_target(self.params, self.target_q, alpha, batch,
                                noise["next"])

        self.q_opt.zero_grad(set_to_none=True)
        q_loss, td_err = self._critic_loss(self._q_tree, self.params, y,
                                           batch, noise)
        q_loss.backward()
        self.q_opt.step()

        self.pi_opt.zero_grad(set_to_none=True)
        detached_q = tree_map(lambda t: t.detach(), self._q_tree)
        pi_loss, logp_pi = self._actor_loss(self.params["pi"], detached_q,
                                            alpha, batch, noise["pi"])
        pi_loss.backward()
        self.pi_opt.step()

        self.a_opt.zero_grad(set_to_none=True)
        self._alpha_loss(self.log_alpha, logp_pi).backward()
        self.a_opt.step()

        with torch.no_grad():
            for t, o in zip(tree_leaves(self.target_q), self._q_leaves):
                t.copy_((1 - tau) * t + tau * o)
        metrics = torch.stack([q_loss.detach(), pi_loss.detach(),
                               torch.exp(self.log_alpha.detach()),
                               -torch.mean(logp_pi)])
        return td_err, metrics

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        n = len(batch["rewards"])

        def col(x):
            return torch.tensor(np.asarray(x, np.float32), device=self.device)

        return {
            "obs": col(batch["obs"]), "actions": col(batch["actions"]),
            "rewards": col(batch["rewards"]),
            "next_obs": col(batch["next_obs"]),
            "terminateds": col(batch["terminateds"]),
            "discounts": col(batch.get(
                "discounts",
                np.full(n, self.config.get("gamma", 0.99), np.float32))),
            "weights": col(batch.get("weights", np.ones(n, np.float32))),
        }

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        tb = self._device_batch(batch)
        td_err, metrics = self._step(tb, self._step_noise(len(tb["rewards"])))
        self._updates += 1
        q_loss, pi_loss, alpha, entropy = _host(metrics).tolist()
        return {"q_loss": q_loss, "pi_loss": pi_loss, "alpha": alpha,
                "entropy": entropy, "loss": q_loss,
                "td_errors": _host(td_err)}

    def get_weights(self):
        return tree_map(_host, self.params)

    def get_state(self) -> Dict:
        # Full continuation state: all three optimizer moments (optax's
        # adam trees) + the noise generator — restore resumes the run.
        return {
            "params": tree_map(_host, self.params),
            "target_q": tree_map(_host, self.target_q),
            "log_alpha": _host(self.log_alpha),
            "pi_state": adam_state_tree(self.pi_opt, self.params["pi"]),
            "q_state": adam_state_tree(self.q_opt, self._q_tree),
            "a_state": adam_state_tree(self.a_opt, self.log_alpha),
            "rng_state": self._gen.get_state().numpy().copy(),
            "updates": self._updates,
        }

    def set_state(self, state: Dict) -> bool:
        with torch.no_grad():
            for dst, src in ((self.params, state["params"]),
                             (self.target_q, state["target_q"])):
                for t, v in zip(tree_leaves(dst), tree_leaves(src)):
                    t.copy_(torch.as_tensor(np.asarray(v)))
            self.log_alpha.copy_(torch.as_tensor(np.asarray(
                state["log_alpha"])))
        if "pi_state" in state:
            load_adam_state(self.pi_opt, self._pi_leaves, state["pi_state"])
            load_adam_state(self.q_opt, self._q_leaves, state["q_state"])
            load_adam_state(self.a_opt, [self.log_alpha], state["a_state"])
        if "rng_state" in state:
            self._gen.set_state(torch.as_tensor(
                np.asarray(state["rng_state"], np.uint8)))
        self._updates = int(state.get("updates", 0))
        return True


@dataclass
class SACConfig(AlgorithmConfigBase):
    env: Optional[Callable[[], Any]] = None
    num_env_runners: int = 1
    num_envs_per_runner: int = 1
    rollout_fragment_length: int = 64
    buffer_capacity: int = 100_000
    train_batch_size: int = 256
    num_steps_sampled_before_learning: int = 1_000
    updates_per_iteration: int = 64
    gamma: float = 0.99
    lr: float = 3e-4
    tau: float = 0.005
    initial_alpha: float = 1.0
    target_entropy: Optional[float] = None  # default -action_dim
    replay: str = "prioritized"
    per_alpha: float = 0.6
    per_beta: float = 0.4
    n_step: int = 1
    hidden: Tuple[int, ...] = (256, 256)
    seed: int = 0

    def build(self) -> "SAC":
        return SAC(self)


class SAC:
    """Tune-compatible train() contract (mirrors DQN — the reference's SAC
    subclasses DQN for exactly this shared shape)."""

    def __init__(self, config: SACConfig):
        assert config.env is not None, "config.environment(env_creator) required"
        self.config = config
        probe = config.env()
        self.spec = spec_for_env(probe)
        low = np.asarray(probe.action_space.low, np.float32)
        high = np.asarray(probe.action_space.high, np.float32)
        probe.close()
        assert not self.spec.discrete, "SAC requires a continuous action space"

        hidden = tuple(config.hidden)

        def factory(spec):
            return SACModule(spec, low, high, hidden=hidden)

        self.module = factory(self.spec)
        lcfg = {"lr": config.lr, "gamma": config.gamma, "tau": config.tau,
                "initial_alpha": config.initial_alpha}
        if config.target_entropy is not None:
            lcfg["target_entropy"] = config.target_entropy
        self.learner = SACLearner(self.module, lcfg, seed=config.seed)

        if config.replay == "prioritized":
            self.buffer = PrioritizedReplayBuffer(
                config.buffer_capacity, alpha=config.per_alpha,
                beta=config.per_beta, seed=config.seed)
        else:
            from ray_tpu_torch.rllib.dqn import ReplayBuffer

            self.buffer = ReplayBuffer(config.buffer_capacity,
                                       seed=config.seed)

        runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
        self._runners = [
            runner_cls.remote(
                config.env, num_envs=config.num_envs_per_runner,
                seed=config.seed + 1000 * i, spec=self.spec,
                module_factory=factory,
            )
            for i in range(max(1, config.num_env_runners))
        ]
        self._timesteps = 0
        self._iteration = 0
        self._updates = 0
        self._sync_runners()

    def _sync_runners(self) -> None:
        weights = self.learner.get_weights()
        ray_tpu_torch.get([r.set_weights.remote(weights)
                           for r in self._runners])

    def _to_transitions(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        cfg = self.config
        cols = nstep_columns(
            sample["obs"], sample["rewards"], sample["terminateds"],
            sample["valids"], sample["bootstrap_obs"],
            n_step=cfg.n_step, gamma=cfg.gamma)
        keep = cols.pop("_keep")
        acts = sample["actions"]
        cols["actions"] = acts.reshape((-1,) + acts.shape[2:])[keep]
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

        q_losses, ent = [], []
        if (len(self.buffer) >= cfg.num_steps_sampled_before_learning
                and len(self.buffer) >= cfg.train_batch_size):
            for _ in range(cfg.updates_per_iteration):
                batch = self.buffer.sample(cfg.train_batch_size)
                m = self.learner.update(batch)
                if "indices" in batch:
                    self.buffer.update_priorities(batch["indices"],
                                                  m["td_errors"])
                q_losses.append(m["q_loss"])
                ent.append(m["entropy"])
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
            "loss": float(np.mean(q_losses)) if q_losses else float("nan"),
            "entropy": float(np.mean(ent)) if ent else float("nan"),
            "alpha": float(np.exp(float(_host(self.learner.log_alpha)))),
            "buffer_size": len(self.buffer),
            "num_updates": self._updates,
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
