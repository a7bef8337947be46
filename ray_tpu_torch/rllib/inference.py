"""Sebulba-style inference actors — centralized action selection for RL.

The Podracer "Sebulba" split: env runners shed their local forward and ship
per-step observation batches to a small shared pool of ``InferenceActor``s,
so a weight broadcast touches K inference actors instead of N runners.

Counterpart of ``ray_tpu/rllib/inference.py``. Equivalence contract: the
runner keeps its own ``torch.Generator`` and draws each step's noise on it
(``module.draw_noise``), shipping the noise with the observations; the actor
runs ``module.sample_with_noise`` on them, so actions and log-probs are bit
for bit those of the runner sampling locally. Difference by design: the JAX
package fuses concurrent requests into one flush (``serve/batching.py``'s
pacing, ``rl_inference_max_batch`` / ``rl_inference_window_s``) and vmaps
``sample_action`` over them; here the actor runs the requests one at a
time in arrival order, each one forward on the same ``[N, obs]`` shape the
runner-local forward takes. A fused forward would break the bit-identity:
a CPU GEMM's rounding depends on its row count, for one matrix product
over the stacked rows and for a batched one alike. The actor runs on the
host CPU, as the JAX package pins it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.devtools import jitcheck
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec, tree_map
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger(__name__)


class InferenceActor:
    """Policy forwards for a set of env runners, one request at a time
    (``InferencePool`` spawns it with ``max_concurrency=1``)."""

    def __init__(
        self,
        spec: RLModuleSpec,
        *,
        seed: int = 0,
        module_factory: Optional[Callable[[RLModuleSpec], Any]] = None,
    ):
        self.spec = spec
        self.module = (module_factory(spec) if module_factory
                       else RLModule(spec))
        # Same placement as the env runner: tiny latency-bound forwards stay
        # on the host CPU (the learner owns the card).
        self._params = self.module.init_params(seed, "cpu")

    # -- weights sync (one broadcast target instead of N runners) -----------
    def set_weights(self, params) -> bool:
        self._params = tree_map(
            lambda x: torch.tensor(np.asarray(x)) if not isinstance(
                x, torch.Tensor) else x.detach().to("cpu", copy=True),
            params)
        return True

    def get_weights(self):
        return tree_map(lambda t: t.numpy().copy(), self._params)

    def ping(self) -> bool:
        return True

    # -- request path --------------------------------------------------------
    def infer(self, obs: np.ndarray, noise: Optional[np.ndarray],
              greedy: bool = False):
        """One env-runner step: ``(actions, logps, values)`` as numpy, for
        the runner's ``noise`` (None when greedy)."""
        obs_t = torch.from_numpy(np.array(obs))
        with torch.inference_mode():
            if greedy:
                logits = self.module.forward_inference(
                    self._params, obs_t)["action_dist_inputs"]
                n = obs_t.shape[0]
                actions = jitcheck.device_get(torch.argmax(logits, dim=-1))
                return (actions.numpy(), np.zeros(n, np.float32),
                        np.zeros(n, np.float32))
            a, logp, v = self.module.sample_with_noise(
                self._params, obs_t, torch.from_numpy(np.array(noise)))
            # one read of the three outputs, as the JAX actor's device_get
            a, logp, v = jitcheck.device_get((a, logp, v))
            return a.numpy(), logp.numpy(), v.numpy()

    def values(self, obs: np.ndarray) -> np.ndarray:
        """Critic-only forward for fragment bootstrap values."""
        with torch.inference_mode():
            return self.module.forward_inference(
                self._params, torch.from_numpy(np.array(obs)))[
                    "vf_preds"].numpy()


class InferencePool:
    """Driver-side handle over K inference actors: round-robin runner
    assignment and the K-way weight broadcast."""

    def __init__(
        self,
        num_actors: int,
        spec: RLModuleSpec,
        *,
        seed: int = 0,
        num_clients: int = 0,
        module_factory: Optional[Callable[[RLModuleSpec], Any]] = None,
    ):
        assert num_actors > 0
        # One request at a time: concurrent forwards on the host contend
        # and a threaded actor's call costs more, so a serial actor serves
        # a step of several runners sooner. ``num_clients`` (the JAX
        # package sizes its flush by it) sizes nothing here.
        del num_clients
        actor_cls = ray_tpu_torch.remote(InferenceActor)
        self._actors = [
            actor_cls.options(max_concurrency=1).remote(
                spec, seed=seed, module_factory=module_factory)
            for _ in range(num_actors)
        ]
        # Fail fast on construction errors before runners start stepping.
        ray_tpu_torch.get([a.ping.remote() for a in self._actors])

    @property
    def actors(self):
        return list(self._actors)

    def handle_for(self, client_index: int):
        return self._actors[client_index % len(self._actors)]

    def set_weights(self, params) -> None:
        ray_tpu_torch.get([a.set_weights.remote(params) for a in self._actors])

    def stop(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                log_swallowed(logger, "inference actor kill")
