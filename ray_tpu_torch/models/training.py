"""Training-step factory, on one device.

Counterpart of ``ray_tpu/models/training.py``. JAX compiles the whole
update into one jitted program over a device mesh; here the step runs
eagerly on one device: the loss, ``backward()`` (through the flash
attention kernels on the card), the global gradient norm and one optimizer
step. The mesh, sharding rules, donation and the sharded optimizer state
wait for ROADMAP Queue 1 item 9.

Parameters are a dict of leaf tensors that require grad; ``step`` updates
them IN PLACE (JAX returns new arrays and donates the old ones) and returns
the same dict. The optimizer state is a ``torch.optim`` optimizer over the
leaves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ray_tpu_torch.utils.device import resolve_device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw``'s update: bias-corrected moments, eps outside the
    square root, decoupled weight decay ``lr * weight_decay * p`` on every
    leaf. ``init(params)`` returns the optimizer state: a
    ``torch.optim.AdamW`` over the leaves, fused into one kernel per step
    when they lie on the card."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> torch.optim.Optimizer:
        leaves = list(_leaves(params))
        fused = all(p.is_cuda for p in leaves)
        return torch.optim.AdamW(
            leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay,
            fused=True if fused else None)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw``, with optax's defaults (torch's own AdamW defaults to
    ``weight_decay=0.01``)."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


@dataclass
class TrainStepBundle:
    """What a training loop needs: ``init(seed) -> (params, opt_state)`` and
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``."""

    init: Callable[..., Tuple[Any, Any]]
    step: Callable[..., Tuple[Any, Any, Dict]]
    device: torch.device


def make_train_step(*, loss_fn: Callable, init_params_fn: Callable,
                    optimizer: Optional[AdamW] = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> TrainStepBundle:
    """Build ``(init, step)`` on one device.

    ``loss_fn(params, batch)`` returns a scalar loss tensor;
    ``init_params_fn(seed)`` returns the parameter dict. The metrics are
    device tensors (reading them synchronises): ``loss`` and ``grad_norm``,
    the global L2 norm of the gradients before the update
    (``optax.global_norm``)."""
    dev = resolve_device(device)
    optimizer = optimizer or adamw(3e-4)

    def init(seed: Union[int, torch.Generator] = 0):
        params = _tree_map(
            lambda t: t.detach().to(dev).requires_grad_(True),
            init_params_fn(seed))
        return params, optimizer.init(params)

    def step(params, opt_state, batch):
        leaves = list(_leaves(params))
        for p in leaves:
            p.grad = None
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        loss = loss_fn(params, batch)
        loss.backward()
        for p in leaves:               # optax updates (and decays) every leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad, dtype=torch.float32)
             for p in leaves]))
        opt_state.step()
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return TrainStepBundle(init=init, step=step, device=dev)


def make_eval_step(*, loss_fn: Callable) -> Callable:
    """``eval_step(params, batch) -> loss``, without gradients."""

    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)

    return eval_step
