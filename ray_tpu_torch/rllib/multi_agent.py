"""Multi-agent environments: runner actors + independent-learner PPO.

Analog of the reference's multi-agent stack
(``rllib/env/multi_agent_env.py`` env contract,
``rllib/env/multi_agent_env_runner.py`` — the episode-based runner — and
the ``policies`` / ``policy_mapping_fn`` config surface of
``AlgorithmConfig.multi_agent()``): one ``RLModule`` per POLICY; each env
step batches all agents mapped to a policy into one forward pass, and
training runs one PPO update per policy over the concatenated trajectories
of its agents (independent learners — the reference's default mode).

Counterpart of ``ray_tpu/rllib/multi_agent.py``: the runner samples on the
host CPU with one ``torch.Generator`` (seeded ``seed + 10_000``) where the
JAX package splits one key per policy group and step; the learners take the
port's ``Learner`` device policy.

Env contract (dict-keyed, mirroring the reference's MultiAgentEnv):

    reset(seed) -> (obs: {agent: obs}, infos)
    step(actions: {agent: a}) -> (obs, rewards, terminateds, truncateds,
                                  infos)  # dicts; terminateds["__all__"]
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfigBase
from ray_tpu_torch.rllib.ppo import PPOLearner, compute_gae
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec, tree_map


class MultiAgentEnvRunner:
    """Samples episodes from one multi-agent env; returns per-POLICY
    trajectory lists (each trajectory = one agent's contiguous episode
    segment, the unit GAE runs over)."""

    def __init__(self, env_creator: Callable[[], Any], *,
                 policies: Dict[str, RLModuleSpec],
                 policy_mapping_fn: Callable[[str], str],
                 seed: int = 0):
        self._env = env_creator()
        self._policies = dict(policies)
        self._map = policy_mapping_fn
        self._modules = {pid: RLModule(spec)
                         for pid, spec in self._policies.items()}
        self._params = {
            pid: m.init_params(seed + i, "cpu")
            for i, (pid, m) in enumerate(self._modules.items())
        }
        self._gen = torch.Generator()
        self._gen.manual_seed(seed + 10_000)
        self._seed = seed
        self._episode = 0
        self._completed_returns: List[float] = []
        # Episode state persists ACROSS sample() calls (like the
        # single-agent runner's self._obs): episodes longer than one
        # fragment continue where the previous fragment stopped.
        self._obs: Optional[Dict[str, Any]] = None
        self._ep_return = 0.0

    # -- weights sync ---------------------------------------------------------

    def set_weights(self, weights: Dict[str, Any]) -> bool:
        for pid, w in weights.items():
            self._params[pid] = tree_map(
                lambda x: torch.tensor(np.asarray(x)), w)
        return True

    # -- sampling -------------------------------------------------------------

    def sample(self, num_env_steps: int) -> Dict[str, Any]:
        """Run ``num_env_steps`` env steps (across episode boundaries);
        returns ``{"trajectories": {policy_id: [traj, ...]},
        "episode_return_mean": float, "num_episodes": int}``. A traj dict
        carries obs/actions/logp/values/rewards arrays plus ``terminated``
        and ``bootstrap_value`` (0 at termination; V(last obs) at
        truncation/segment cuts — the same bootstrap rule the
        single-agent path applies)."""
        open_trajs: Dict[str, Dict[str, list]] = {}
        done_trajs: Dict[str, List[dict]] = {p: [] for p in self._policies}

        if self._obs is None:
            self._obs, _ = self._env.reset(seed=self._seed + self._episode)
        obs = self._obs
        for _ in range(num_env_steps):
            # Group live agents by policy; one batched forward per policy.
            by_policy: Dict[str, List[str]] = {}
            for agent in obs:
                by_policy.setdefault(self._map(agent), []).append(agent)
            actions: Dict[str, Any] = {}
            step_info: Dict[str, tuple] = {}
            for pid, agents in by_policy.items():
                batch = np.stack([np.asarray(obs[a], np.float32).reshape(-1)
                                  for a in agents])
                with torch.inference_mode():
                    act, logp, value = self._modules[pid].sample_action(
                        self._params[pid], torch.from_numpy(batch),
                        self._gen)
                act, logp, value = act.numpy(), logp.numpy(), value.numpy()
                spec = self._policies[pid]
                for i, a in enumerate(agents):
                    env_action = (int(act[i]) if spec.discrete
                                  else np.asarray(act[i]))
                    actions[a] = env_action
                    step_info[a] = (pid, batch[i], act[i], logp[i], value[i])

            next_obs, rewards, terms, truncs, _ = self._env.step(actions)
            for agent, (pid, ob, ac, lp, va) in step_info.items():
                t = open_trajs.setdefault(agent, {
                    "pid": pid, "obs": [], "actions": [], "logp": [],
                    "values": [], "rewards": []})
                t["obs"].append(ob)
                t["actions"].append(ac)
                t["logp"].append(lp)
                t["values"].append(va)
                r = float(rewards.get(agent, 0.0))
                t["rewards"].append(r)
                self._ep_return += r

            episode_over = bool(terms.get("__all__") or truncs.get("__all__"))
            for agent in list(open_trajs):
                terminated = bool(terms.get(agent, False))
                if terminated or episode_over:
                    self._finalize(open_trajs.pop(agent), terminated,
                                   next_obs.get(agent), done_trajs)
            if episode_over:
                self._completed_returns.append(self._ep_return)
                self._ep_return = 0.0
                self._episode += 1
                obs, _ = self._env.reset(seed=self._seed + self._episode)
            else:
                obs = next_obs

        self._obs = obs  # episode continues in the next fragment
        # Cut still-open segments at the fragment boundary (bootstrapped).
        for agent in list(open_trajs):
            self._finalize(open_trajs.pop(agent), False, obs.get(agent),
                           done_trajs)
        completed, self._completed_returns = self._completed_returns, []
        return {
            "trajectories": done_trajs,
            "episode_return_mean": (float(np.mean(completed))
                                    if completed else float("nan")),
            "num_episodes": len(completed),
        }

    def _finalize(self, traj: Dict[str, list], terminated: bool,
                  last_obs, out: Dict[str, List[dict]]) -> None:
        if not traj["obs"]:
            return
        pid = traj["pid"]
        if terminated or last_obs is None:
            bootstrap = 0.0
        else:
            ob = np.asarray(last_obs, np.float32).reshape(1, -1)
            with torch.inference_mode():
                bootstrap = float(self._modules[pid].forward_train(
                    self._params[pid], torch.from_numpy(ob))[
                        "vf_preds"].numpy()[0])
        out[pid].append({
            "obs": np.stack(traj["obs"]),
            "actions": np.asarray(traj["actions"]),
            "logp": np.asarray(traj["logp"], np.float32),
            "values": np.asarray(traj["values"], np.float32),
            "rewards": np.asarray(traj["rewards"], np.float32),
            "terminated": terminated,
            "bootstrap_value": bootstrap,
        })

    def stop(self) -> None:
        try:
            self._env.close()
        except Exception:  # noqa: BLE001
            pass


@dataclass
class MultiAgentPPOConfig(AlgorithmConfigBase):
    env: Optional[Callable[[], Any]] = None
    policies: Optional[Dict[str, RLModuleSpec]] = None  # None: infer, shared
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    num_env_runners: int = 1
    rollout_fragment_length: int = 128
    num_sgd_iter: int = 4
    minibatch_size: int = 128
    gamma: float = 0.99
    lambda_: float = 0.95
    lr: float = 3e-4
    clip_param: float = 0.2
    vf_clip_param: float = 10.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 0.5
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0

    def multi_agent(self, *, policies=None, policy_mapping_fn=None):
        if policies is not None:
            self.policies = policies
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


def _infer_policies(env, hidden) -> Dict[str, RLModuleSpec]:
    """Default: one SHARED policy for every agent (reference default when
    no ``policies`` dict is configured)."""
    obs, _ = env.reset(seed=0)
    first = next(iter(obs.values()))
    obs_dim = int(np.asarray(first).reshape(-1).shape[0])
    n_actions = int(env.action_space_n) if hasattr(env, "action_space_n") \
        else 2
    return {"shared": RLModuleSpec(observation_dim=obs_dim,
                                   action_dim=n_actions,
                                   hidden=tuple(hidden))}


class MultiAgentPPO:
    """Independent-learner PPO over per-policy modules (the reference's
    default multi-agent training mode: each policy optimizes its own
    objective on its own agents' experience)."""

    def __init__(self, config: MultiAgentPPOConfig):
        assert config.env is not None, "config.environment(env_creator) required"
        self.config = config
        if config.policies is None:
            probe = config.env()
            config.policies = _infer_policies(probe, config.hidden)
            try:
                probe.close()
            except Exception:  # noqa: BLE001
                pass
        if config.policy_mapping_fn is None:
            only = next(iter(config.policies))
            config.policy_mapping_fn = lambda agent_id, _p=only: _p

        lcfg = {"lr": config.lr, "clip_param": config.clip_param,
                "vf_clip_param": config.vf_clip_param,
                "vf_loss_coeff": config.vf_loss_coeff,
                "entropy_coeff": config.entropy_coeff,
                "grad_clip": config.grad_clip}
        self.learners = {pid: PPOLearner(spec, lcfg, seed=config.seed + i)
                         for i, (pid, spec) in
                         enumerate(config.policies.items())}

        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self._runners = [
            runner_cls.remote(
                config.env, policies=config.policies,
                policy_mapping_fn=config.policy_mapping_fn,
                seed=config.seed + 1000 * i)
            for i in range(max(1, config.num_env_runners))
        ]
        self._iteration = 0
        self._timesteps = 0
        self._rng = np.random.default_rng(config.seed)
        self._sync()

    def _sync(self) -> None:
        weights = {pid: lrn.get_weights()
                   for pid, lrn in self.learners.items()}
        ray_tpu_torch.get([r.set_weights.remote(weights)
                           for r in self._runners])

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        samples = ray_tpu_torch.get(
            [r.sample.remote(cfg.rollout_fragment_length)
             for r in self._runners], timeout=600)

        # Per-policy batch assembly: GAE per trajectory, then concat.
        losses: Dict[str, List[float]] = {p: [] for p in self.learners}
        for pid, lrn in self.learners.items():
            cols: Dict[str, List[np.ndarray]] = {
                "obs": [], "actions": [], "logp": [],
                "advantages": [], "value_targets": []}
            for s in samples:
                for traj in s["trajectories"][pid]:
                    T = len(traj["rewards"])
                    terminateds = np.zeros((T, 1), np.float32)
                    if traj["terminated"]:
                        terminateds[-1] = 1.0
                    adv, tgt = compute_gae(
                        traj["rewards"].reshape(T, 1),
                        traj["values"].reshape(T, 1), terminateds,
                        np.asarray([traj["bootstrap_value"]], np.float32),
                        gamma=cfg.gamma, lambda_=cfg.lambda_)
                    cols["obs"].append(traj["obs"])
                    cols["actions"].append(traj["actions"])
                    cols["logp"].append(traj["logp"])
                    cols["advantages"].append(adv[:, 0])
                    cols["value_targets"].append(tgt[:, 0])
            if not cols["obs"]:
                continue
            batch = {k: np.concatenate(v) for k, v in cols.items()}
            n = len(batch["logp"])
            self._timesteps += n
            adv = batch["advantages"]
            batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
            for _ in range(cfg.num_sgd_iter):
                idx = self._rng.permutation(n)
                for lo in range(0, n, cfg.minibatch_size):
                    sel = idx[lo:lo + cfg.minibatch_size]
                    mb = {k: v[sel] for k, v in batch.items()}
                    losses[pid].append(lrn.update(mb)["loss"])
        self._sync()

        self._iteration += 1
        rets = [s["episode_return_mean"] for s in samples
                if s["num_episodes"] > 0]
        return {
            "training_iteration": self._iteration,
            "timesteps_total": self._timesteps,
            "episode_return_mean": (float(np.mean(rets)) if rets
                                    else float("nan")),
            "policy_loss": {p: float(np.mean(ls)) if ls else float("nan")
                            for p, ls in losses.items()},
            "time_total_s": time.perf_counter() - t0,
        }

    def save(self, path: str) -> str:
        from ray_tpu_torch.train.checkpoint import save_pytree

        save_pytree({pid: lrn.get_state()
                     for pid, lrn in self.learners.items()}, path)
        return path

    def restore(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import load_pytree

        data = load_pytree(path)
        for pid, state in data.items():
            self.learners[pid].set_state(state)
        self._sync()

    def stop(self) -> None:
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass
