"""Offline RL — BC and MARWIL training from datasets.

Analog of the reference's offline family (``rllib/algorithms/bc/bc.py``,
``rllib/algorithms/marwil/marwil.py``, dataset ingestion via
``rllib/offline/dataset_reader.py``): the algorithm never touches an
environment — it reads (obs, actions[, rewards, terminateds]) out of a
``ray_tpu_torch.data`` Dataset and trains the policy supervised.

- **BC** maximizes log π(a|s) over the dataset (pure behavior cloning).
- **MARWIL** (Wang et al. 2018) weights the cloning term by
  exp(β · Â(s, a)) with advantages from a jointly-learned value baseline —
  β = 0 reduces exactly to BC (the reference documents the same contract).

Counterpart of ``ray_tpu/rllib/offline.py``, reading through the port's Data
library; the learner takes the port's ``Learner`` device policy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfigBase
from ray_tpu_torch.rllib.learner import Learner, _host
from ray_tpu_torch.rllib.rl_module import RLModuleSpec


def episodes_to_dataset(episodes) -> "Any":
    """Build a ``ray_tpu_torch.data`` Dataset from a list of episode dicts
    (each with columns obs/actions/rewards/terminateds) — the writer-side
    helper for producing offline corpora from env runners."""
    from ray_tpu_torch import data as rt_data

    rows = []
    for ep in episodes:
        n = len(ep["actions"])
        for i in range(n):
            rows.append({
                # list<float> cells (arrow-friendly; ndarray cells are not)
                "obs": np.asarray(ep["obs"][i], np.float32).tolist(),
                "actions": (np.asarray(ep["actions"][i]).tolist()
                            if np.ndim(ep["actions"][i]) else ep["actions"][i]),
                "rewards": float(ep["rewards"][i]),
                "terminateds": float(i == n - 1
                                     and ep.get("terminated", True)),
                # Monte-Carlo return-to-go, the MARWIL advantage target.
                "returns": float(sum(ep["rewards"][i:])),
            })
    return rt_data.from_items(rows)


class MARWILLearner(Learner):
    """Advantage-weighted behavior cloning + value baseline.

    loss = -E[ exp(β Â / c) · log π(a|s) ] + vf_coeff · E[(V(s) - R)²]
    with Â = R - V(s) (no gradient) and c a running advantage-norm estimate
    (the reference normalizes the same way, ``marwil_torch_policy.py``).
    β = 0 → plain BC (the vf head still trains but nothing depends on it).
    """

    def __init__(self, spec: RLModuleSpec, config: Dict[str, Any], seed: int = 0):
        super().__init__(spec, config, seed=seed)
        self._adv_norm = 1.0

    def loss_fn(self, params, batch):
        beta = self.config.get("beta", 1.0)
        vf_coeff = self.config.get("vf_coeff", 1.0)
        logp, _entropy, values = self.module.logp_and_entropy(
            params, batch["obs"], batch["actions"])
        returns = batch["returns"]
        adv = (returns - values).detach()
        adv = adv / torch.clamp(batch["adv_norm"], min=1e-8)
        weights = torch.exp(torch.clamp(beta * adv, -10.0, 10.0))
        bc_term = -torch.mean(weights * logp)
        vf_term = torch.mean((values - returns) ** 2)
        return bc_term + vf_coeff * vf_term

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        # Running advantage scale (EMA of |Â|'s RMS) keeps exp(βÂ) tame.
        b = dict(batch)
        b["adv_norm"] = np.float32(self._adv_norm)
        metrics = super().update(b)
        # Refresh the norm from this batch (host-side, cheap).
        vals = self._value_of(batch["obs"])
        adv = batch["returns"] - vals
        rms = float(np.sqrt(np.mean(adv ** 2)) + 1e-8)
        self._adv_norm = 0.99 * self._adv_norm + 0.01 * rms
        return metrics

    def _value_of(self, obs) -> np.ndarray:
        with torch.no_grad():
            return _host(self.module.forward_train(
                self.params, torch.as_tensor(np.asarray(obs),
                                             device=self.device))["vf_preds"])


@dataclass
class BCConfig(AlgorithmConfigBase):
    """Behavior cloning: MARWIL with β = 0 (exactly the reference's BC,
    ``rllib/algorithms/bc/bc.py`` — "MARWIL with beta 0")."""

    dataset: Any = None                 # ray_tpu_torch.data Dataset
    observation_dim: Optional[int] = None
    action_dim: Optional[int] = None
    discrete: bool = True
    hidden: Tuple[int, ...] = (64, 64)
    train_batch_size: int = 256
    updates_per_iteration: int = 32
    lr: float = 1e-3
    grad_clip: float = 10.0
    beta: float = 0.0
    vf_coeff: float = 1.0
    shuffle_seed: int = 0
    seed: int = 0

    def build(self) -> "BC":
        return BC(self)


@dataclass
class MARWILConfig(BCConfig):
    beta: float = 1.0

    def build(self) -> "BC":
        return BC(self)


class BC:
    """Tune-compatible train() over a dataset (no env runners).

    Draws random minibatches out of the materialized corpus each iteration
    (reference: ``offline/dataset_reader.py`` shuffled reads).
    """

    def __init__(self, config: BCConfig):
        assert config.dataset is not None, "config.dataset required"
        assert config.observation_dim and config.action_dim, (
            "observation_dim/action_dim required (offline data has no env "
            "to probe)")
        self.config = config
        self.spec = RLModuleSpec(
            observation_dim=config.observation_dim,
            action_dim=config.action_dim,
            discrete=config.discrete,
            hidden=tuple(config.hidden),
        )
        self.learner = MARWILLearner(self.spec, {
            "lr": config.lr, "grad_clip": config.grad_clip,
            "beta": config.beta, "vf_coeff": config.vf_coeff,
        }, seed=config.seed)
        # Materialize the dataset once into columnar arrays (offline
        # corpora for control tasks are small).
        rows = config.dataset.take_all()
        returns = np.asarray([r.get("returns", r.get("rewards", 0.0))
                              for r in rows], np.float32)
        # Standardize returns over the (fixed) corpus: the value head
        # regresses a ~unit-scale target, so it neither swamps the cloning
        # term through the shared torso nor leaves advantages on a scale
        # that saturates exp(β·Â).
        self._ret_mean = float(returns.mean())
        self._ret_std = float(returns.std() + 1e-6)
        self._columns = {
            "obs": np.stack([np.asarray(r["obs"], np.float32) for r in rows]),
            "actions": np.asarray([r["actions"] for r in rows]),
            "returns": (returns - self._ret_mean) / self._ret_std,
        }
        self._n = len(rows)
        self._rng = np.random.default_rng(config.shuffle_seed)
        self._iteration = 0

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        losses = []
        for _ in range(cfg.updates_per_iteration):
            idx = self._rng.integers(0, self._n,
                                     min(cfg.train_batch_size, self._n))
            batch = {k: v[idx] for k, v in self._columns.items()}
            losses.append(self.learner.update(batch)["loss"])
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "loss": float(np.mean(losses)),
            "num_samples": self._n,
            "time_total_s": time.perf_counter() - t0,
        }

    def evaluate(self, env_creator: Callable[[], Any],
                 num_episodes: int = 10, seed: int = 0) -> Dict[str, float]:
        """Greedy policy rollout in a real env — the offline-RL report card."""
        env = env_creator()
        module = self.learner.module
        params = self.learner.params
        dev = self.learner.device
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=seed + ep)
            done, total = False, 0.0
            while not done:
                with torch.no_grad():
                    out = module.forward_inference(params, torch.as_tensor(
                        np.asarray(obs, np.float32)[None], device=dev))
                    logits = out["action_dist_inputs"][0].cpu()
                a = (int(torch.argmax(logits)) if self.spec.discrete
                     else logits.numpy())
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


MARWIL = BC  # same engine; the config's beta selects the algorithm
