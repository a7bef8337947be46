"""RLModule — the policy/value network abstraction (PyTorch).

Analog of the reference's new-stack ``rllib/core/rl_module/rl_module.py``:
an RLModule owns the network and exposes ``forward_inference`` /
``forward_exploration`` / ``forward_train``. Parameters are an explicit
tree of tensors (the module is stateless math, the Learner owns the
parameters), so the same module runs in env-runner actors (host CPU, small
batch) and in learners (the card, big batch) without code changes.

Counterpart of ``ray_tpu/rllib/rl_module.py``, on the same tree and names:
``{"torso": [{"w", "b"}, ...], "pi", "vf"[, "log_std"]}`` for the MLP and
``{"convs": [...], "dense", "pi", "vf"}`` for the Nature-CNN torso, whose
filters are stored HWIO as the JAX package's are, so
``models.convert.params_from_numpy`` carries its ``init_params`` across
unchanged; the convolutions run ``F.conv2d`` on permuted views. Random
draws take a ``torch.Generator`` in place of a JAX key.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class RLModuleSpec:
    """Reference: ``rl_module.RLModuleSpec`` — how to build a module."""

    observation_dim: int
    action_dim: int
    hidden: Tuple[int, ...] = (64, 64)
    discrete: bool = True
    free_log_std: bool = True  # Box spaces: state-independent log-std
    # Pixel observations: raw [H, W, C] shape + a Nature-CNN torso
    # (reference: rllib/models/catalog defaults for Atari).
    obs_shape: Optional[Tuple[int, ...]] = None
    conv: bool = False


def _generator(seed: Union[int, torch.Generator]) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


class RLModule:
    """Functional actor-critic network."""

    def __init__(self, spec: RLModuleSpec):
        self.spec = spec

    # Nature-CNN filter spec: (out_channels, kernel, stride) per layer
    _CONV_LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

    # -- params --------------------------------------------------------------
    def init_params(self, seed: Union[int, torch.Generator] = 0,
                    device: Optional[Union[str, torch.device]] = None) -> Dict:
        """Draws on a CPU generator (one stream whatever the device), then
        moves the tree to ``device`` (the card unless the caller asks for
        the CPU)."""
        dev = resolve_device(device)
        g = _generator(seed)
        params = (self._init_conv_params(g) if self.spec.conv
                  else self._init_mlp_params(g))
        return tree_map(lambda t: t.to(dev), params)

    def _init_mlp_params(self, g: torch.Generator) -> Dict:
        s = self.spec
        dims = (s.observation_dim,) + s.hidden

        def normal(shape):
            return torch.randn(shape, generator=g)

        torso = []
        for a, b in zip(dims[:-1], dims[1:]):
            torso.append({"w": normal((a, b)) * math.sqrt(2.0 / a),
                          "b": torch.zeros(b)})
        params = {
            "torso": torso,
            "pi": {"w": normal((dims[-1], s.action_dim)) * 0.01,
                   "b": torch.zeros(s.action_dim)},
            "vf": {"w": normal((dims[-1], 1)) * 1.0, "b": torch.zeros(1)},
        }
        if not s.discrete and s.free_log_std:
            params["log_std"] = torch.zeros(s.action_dim)
        return params

    def _init_conv_params(self, g: torch.Generator) -> Dict:
        """Nature-CNN torso (Mnih 2015): conv 32×8s4, 64×4s2, 64×3s1 →
        dense(hidden[-1] or 512), filters HWIO."""
        s = self.spec
        assert s.obs_shape is not None and len(s.obs_shape) == 3, s.obs_shape

        def normal(shape):
            return torch.randn(shape, generator=g)

        convs = []
        c_in = s.obs_shape[-1]
        hh, ww = s.obs_shape[0], s.obs_shape[1]
        for c_out, k, stride in self._CONV_LAYERS:
            fan_in = k * k * c_in
            convs.append({"w": normal((k, k, c_in, c_out))
                          * math.sqrt(2.0 / fan_in),
                          "b": torch.zeros(c_out)})
            hh = (hh - k) // stride + 1
            ww = (ww - k) // stride + 1
            c_in = c_out
        flat = hh * ww * c_in
        dense_out = s.hidden[-1] if s.hidden else 512
        return {
            "convs": convs,
            "dense": {"w": normal((flat, dense_out)) * math.sqrt(2.0 / flat),
                      "b": torch.zeros(dense_out)},
            "pi": {"w": normal((dense_out, s.action_dim)) * 0.01,
                   "b": torch.zeros(s.action_dim)},
            "vf": {"w": normal((dense_out, 1)), "b": torch.zeros(1)},
        }

    # -- forward passes ------------------------------------------------------
    def _torso(self, params: Dict, obs: torch.Tensor) -> torch.Tensor:
        if self.spec.conv:
            # uint8 pixels [B, H, W, C] (or pre-flattened) → [0, 1] floats,
            # as NCHW views for F.conv2d (filters HWIO → OIHW views).
            s = self.spec
            x = obs.reshape((-1,) + tuple(s.obs_shape)).to(torch.float32) / 255.0
            x = x.permute(0, 3, 1, 2)
            for i, (_, _, stride) in enumerate(self._CONV_LAYERS):
                layer = params["convs"][i]
                x = F.relu(F.conv2d(x, layer["w"].permute(3, 2, 0, 1),
                                    layer["b"], stride=stride))
            # flatten in NHWC order, as the JAX package's dense layer reads
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            return F.relu(x @ params["dense"]["w"] + params["dense"]["b"])
        h = obs
        for layer in params["torso"]:
            h = torch.tanh(h @ layer["w"] + layer["b"])
        return h

    def forward_train(self, params: Dict, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Returns action-dist inputs + value estimates."""
        h = self._torso(params, obs)
        logits = h @ params["pi"]["w"] + params["pi"]["b"]
        value = (h @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
        out = {"action_dist_inputs": logits, "vf_preds": value}
        if not self.spec.discrete and self.spec.free_log_std:
            out["log_std"] = params["log_std"].expand(logits.shape)
        return out

    forward_inference = forward_train
    forward_exploration = forward_train

    # -- distributions -------------------------------------------------------
    def sample_action(
        self, params: Dict, obs: torch.Tensor, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(action, logp, value) under the exploration policy; the draws
        come from ``generator`` (on the device of ``obs``)."""
        out = self.forward_exploration(params, obs)
        logits = out["action_dist_inputs"]
        if self.spec.discrete:
            # Gumbel-max: argmax(logits + Gumbel noise) is a categorical
            # draw, as jax.random.categorical makes it.
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device, dtype=logits.dtype)
            u = u.clamp_min(torch.finfo(logits.dtype).tiny)
            action = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
            logp = torch.log_softmax(logits, dim=-1).gather(
                -1, action[:, None])[:, 0]
        else:
            std = torch.exp(out["log_std"])
            noise = torch.randn(logits.shape, generator=generator,
                                device=logits.device, dtype=logits.dtype)
            action = logits + std * noise
            logp = torch.sum(-0.5 * noise ** 2 - out["log_std"]
                             - 0.5 * math.log(2 * math.pi), dim=-1)
        return action, logp, out["vf_preds"]

    def logp_and_entropy(
        self, params: Dict, obs: torch.Tensor, actions: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        out = self.forward_train(params, obs)
        logits = out["action_dist_inputs"]
        if self.spec.discrete:
            logp_all = torch.log_softmax(logits, dim=-1)
            logp = logp_all.gather(-1, actions.to(torch.int64)[:, None])[:, 0]
            entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        else:
            std = torch.exp(out["log_std"])
            logp = torch.sum(
                -0.5 * ((actions - logits) / std) ** 2
                - out["log_std"] - 0.5 * math.log(2 * math.pi), dim=-1)
            entropy = torch.sum(
                out["log_std"] + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
        return logp, entropy, out["vf_preds"]


def tree_leaves(tree) -> List[Any]:
    """A parameter tree's leaves in ``jax.tree.leaves``' order: dict keys
    sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def spec_for_env(env) -> RLModuleSpec:
    """Build a spec from a gymnasium env's spaces. 3-D uint8 observation
    spaces (Atari-style pixel stacks) get the conv torso automatically."""
    import gymnasium as gym

    obs_space = env.observation_space
    act_space = env.action_space
    if hasattr(obs_space, "shape") and obs_space.shape:
        obs_dim = int(np.prod(obs_space.shape))
    else:
        obs_dim = obs_space.n
    conv = (getattr(obs_space, "shape", None) is not None
            and len(obs_space.shape) == 3
            and getattr(obs_space, "dtype", None) == np.uint8)
    obs_shape = tuple(obs_space.shape) if conv else None
    if isinstance(act_space, gym.spaces.Discrete):
        return RLModuleSpec(observation_dim=obs_dim, action_dim=int(act_space.n),
                            discrete=True, conv=conv, obs_shape=obs_shape,
                            hidden=(512,) if conv else (64, 64))
    return RLModuleSpec(
        observation_dim=obs_dim, action_dim=int(np.prod(act_space.shape)),
        discrete=False, conv=conv, obs_shape=obs_shape,
        hidden=(512,) if conv else (64, 64),
    )
