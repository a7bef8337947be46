"""Learner / LearnerGroup — the gradient side of the RL stack.

Analog of the reference's ``rllib/core/learner/learner.py`` +
``learner_group.py`` (remote learner actors, torch-DDP allreduce
``torch_learner.py:386``). Counterpart of ``ray_tpu/rllib/learner.py``: a
Learner owns a tree of parameter tensors and its optimizer, optax's
``chain(clip_by_global_norm(grad_clip), adam(lr))`` as ``clip_grad_norm_``
followed by ``torch.optim.Adam`` (eps outside the square root, bias-corrected
moments, as optax's). The multi-actor ``LearnerGroup`` shards batches across
learner actors whose gradients sync through the eager collective API
(``ray_tpu_torch.parallel.collectives``), keeping the members' updates
identical.

Device policy, as the JAX package's: ``"cpu"``; ``"auto"`` — the host below
1M parameters (counted as the JAX package counts them), else the card; or an
explicit device. Where the policy picks the card and there is none, the
Learner raises: it never carries on on the CPU unasked.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.rl_module import (RLModule, RLModuleSpec, tree_leaves,
                                           tree_map)
from ray_tpu_torch.utils.device import resolve_device


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def learner_device(spec: RLModuleSpec, dev_cfg: Any) -> torch.device:
    """The JAX package's device policy (see the module docstring)."""
    n_params = (spec.observation_dim * sum(spec.hidden)
                + spec.hidden[-1] * spec.action_dim)
    if dev_cfg == "cpu" or (dev_cfg == "auto" and n_params < 1_000_000):
        return torch.device("cpu")
    return resolve_device(None if dev_cfg == "auto" else dev_cfg)


class Learner:
    """Owns params + optimizer; subclasses define the loss."""

    def __init__(self, spec: RLModuleSpec, config: Dict[str, Any], seed: int = 0):
        self.spec = spec
        self.config = dict(config)
        self.module = RLModule(spec)
        self.device = learner_device(spec, self.config.get("device", "auto"))
        self.params = tree_map(lambda t: t.requires_grad_(True),
                               self.module.init_params(seed, self.device))
        self._leaves = tree_leaves(self.params)
        self.grad_clip = float(self.config.get("grad_clip", 0.5))
        self.optimizer = torch.optim.Adam(
            self._leaves, lr=self.config.get("lr", 3e-4), eps=1e-8)

    # -- override point ------------------------------------------------------
    def loss_fn(self, params, batch) -> torch.Tensor:
        raise NotImplementedError

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        # a copy: a column may be a read-only view into the object store
        return {k: torch.tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()}

    def compute_grads(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The loss; the gradients land in each leaf's ``.grad``."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.params, batch)
        loss.backward()
        return loss.detach()

    def apply_grads(self) -> torch.Tensor:
        """The clip and the Adam step over the leaves' ``.grad``; returns the
        gradients' global norm before the clip (optax's ``global_norm``)."""
        for p in self._leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.nn.utils.clip_grad_norm_(self._leaves, self.grad_clip)
        self.optimizer.step()
        return norm

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        loss = self.compute_grads(self._device_batch(batch))
        norm = self.apply_grads()
        # one read back of both metrics, as the JAX package's one device_get
        loss_v, norm_v = torch.stack([loss, norm.detach()]).tolist()
        return {"loss": loss_v, "grad_norm": norm_v}

    def get_weights(self):
        return tree_map(_host, self.params)

    def set_weights(self, params) -> bool:
        with torch.no_grad():
            for p, v in zip(self._leaves, tree_leaves(params)):
                p.copy_(torch.tensor(np.asarray(v)))
        return True

    def _opt_tree(self):
        """The optimizer state as optax's ``chain(clip, adam)`` holds it:
        ``(EmptyState(), (ScaleByAdamState(count, mu, nu), EmptyState()))``
        as numpy, the moments shaped like the parameters."""
        from ray_tpu_torch.models.training import EmptyState, ScaleByAdamState

        def moment(name):
            def of(p):
                st = self.optimizer.state.get(p, {})
                return _host(st[name]) if name in st else np.zeros(
                    tuple(p.shape), np.float32)
            return tree_map(of, self.params)

        first = self.optimizer.state.get(self._leaves[0], {})
        count = int(first["step"].item()) if "step" in first else 0
        return (EmptyState(), (ScaleByAdamState(
            count=np.asarray(count, np.int32), mu=moment("exp_avg"),
            nu=moment("exp_avg_sq")), EmptyState()))

    def get_state(self) -> Dict:
        return {"params": self.get_weights(), "opt_state": self._opt_tree()}

    def set_state(self, state: Dict) -> bool:
        """Load ``get_state``'s tree, or optax's ``chain(clip, adam)``
        state as numpy arrays."""
        self.set_weights(state["params"])
        adam = state["opt_state"][1][0]
        count = int(np.asarray(adam[0]))
        self.optimizer.state.clear()
        if count:
            for p, m, v in zip(self._leaves, tree_leaves(adam[1]),
                               tree_leaves(adam[2])):
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": torch.as_tensor(np.array(m)).to(p.device),
                    "exp_avg_sq": torch.as_tensor(np.array(v)).to(p.device)}
        return True


class _DistributedLearnerActor:
    """One member of a LearnerGroup; gradients allreduce through the eager
    collective group (reference analog: TorchDDPRLModule NCCL sync)."""

    def __init__(
        self,
        learner_cls,
        spec: RLModuleSpec,
        config: Dict,
        rank: int,
        world: int,
        group_name: str,
        seed: int,
    ):
        from ray_tpu_torch.parallel import collectives

        # identical seed everywhere → identical initial params (the reference
        # broadcasts rank-0 weights; same effect, no wire traffic)
        self.learner: Learner = learner_cls(spec, config, seed=seed)
        self.rank = rank
        self.world = world
        self.group = group_name
        collectives.init_collective_group(world, rank, group_name=group_name)

    def update_shard(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        from ray_tpu_torch.parallel import collectives

        L = self.learner
        if any(np.asarray(v).size == 0 for v in batch.values()):
            # Fewer batch rows than learners: this member got an empty
            # shard. It must STILL join the allreduce (fixed world size) —
            # with zero gradients, not the NaNs an empty-mean loss yields
            # (which would poison every replica).
            loss = float("nan")
            grads = [torch.zeros_like(p) for p in L._leaves]
        else:
            loss = float(L.compute_grads(L._device_batch(batch)))
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in L._leaves]
        for p, g in zip(L._leaves, grads):
            summed = collectives.allreduce(g.detach().cpu().numpy(), op="sum",
                                           group_name=self.group)
            p.grad = (torch.as_tensor(np.asarray(summed)) / self.world).to(
                p.device, p.dtype)
        L.apply_grads()
        return {"loss": loss}

    def get_weights(self):
        return self.learner.get_weights()

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, state):
        return self.learner.set_state(state)


class LearnerGroup:
    """N learner actors with synchronized updates (reference:
    ``learner_group.py``); n=1 degenerates to a local in-process learner."""

    def __init__(
        self,
        learner_cls,
        spec: RLModuleSpec,
        config: Dict,
        *,
        num_learners: int = 0,
        group_name: str = "learner_group",
        seed: int = 0,
        shard_axes: Optional[Dict[str, int]] = None,
    ):
        # Per-key batch-shard axis (default 0). Trajectory learners
        # (IMPALA) shard [T, N] columns on the ENV axis (1) so V-trace's
        # time recursion stays intact per shard.
        self.shard_axes = dict(shard_axes or {})
        self.num_learners = num_learners
        if num_learners == 0:
            self._local = learner_cls(spec, config, seed=seed)
            self._actors = []
        else:
            self._local = None
            actor_cls = ray_tpu_torch.remote(_DistributedLearnerActor)
            self._actors = [
                actor_cls.remote(
                    learner_cls, spec, config, i, num_learners, group_name, seed
                )
                for i in range(num_learners)
            ]
            # barrier: all members joined the collective group
            ray_tpu_torch.get([a.get_weights.remote() for a in self._actors])

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if self._local is not None:
            return self._local.update(batch)
        n = len(self._actors)
        first_key = next(iter(batch))
        rows = batch[first_key].shape[self.shard_axes.get(first_key, 0)]
        shard = max(1, rows // n)
        refs = []
        for i, actor in enumerate(self._actors):
            lo = i * shard
            hi = rows if i == n - 1 else (i + 1) * shard
            piece = {}
            for k, v in batch.items():
                axis = self.shard_axes.get(k, 0)
                idx = [slice(None)] * v.ndim
                idx[axis] = slice(lo, hi)
                piece[k] = v[tuple(idx)]
            refs.append(actor.update_shard.remote(piece))
        metrics = ray_tpu_torch.get(refs)
        losses = [m["loss"] for m in metrics if not np.isnan(m["loss"])]
        return {"loss": float(np.mean(losses)) if losses else float("nan")}

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._actors[0].get_weights.remote())

    def get_state(self):
        if self._local is not None:
            return self._local.get_state()
        return ray_tpu_torch.get(self._actors[0].get_state.remote())

    def set_state(self, state):
        if self._local is not None:
            return self._local.set_state(state)
        return ray_tpu_torch.get([a.set_state.remote(state) for a in self._actors])

    def shutdown(self):
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
