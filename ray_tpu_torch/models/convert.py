"""Carry a parameter tree across from the JAX package.

``params_from_numpy(tree, device)`` takes the JAX parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the same dict of
the port's tensors (lists stay lists, as the MLP's layers), key for key
and shape for shape — the layouts already
agree (see ``models/transformer.py``), so nothing is transposed. This module
imports no JAX: it reads numpy only.

``adamw_state_from_numpy(state, device)`` does the same for the state of
``optax.adamw`` (``jax.tree.map(np.asarray, opt_state)``, or the tree a
checkpoint of it loads as): the port's ``training.adamw_state_tree``, which
``training.load_adamw_state_tree`` loads into the optimizer, so a JAX
``(params, opt_state)`` resumes in the port.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ray_tpu_torch.utils.device import resolve_device


def _to_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")     # a private copy: jax's arrays are read-only
    if a.dtype.name == "bfloat16":            # ml_dtypes' numpy bfloat16
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def params_from_numpy(tree, device: Optional[Union[str, torch.device]] = None):
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _to_tensor(node, dev)

    return walk(tree)


def adamw_state_from_numpy(state, device: Optional[Union[str, torch.device]] = None):
    """optax's ``(ScaleByAdamState(count, mu, nu), EmptyState(),
    EmptyState())`` as numpy arrays (NamedTuples or the plain tuples a
    checkpoint loads as) → the same tree of the port's tensors: the count an
    int32 host tensor, the moments on ``device`` like ``params_from_numpy``'s
    parameters."""
    from ray_tpu_torch.models.training import EmptyState, ScaleByAdamState

    count, mu, nu = state[0][0], state[0][1], state[0][2]
    return (ScaleByAdamState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32),
        mu=params_from_numpy(mu, device), nu=params_from_numpy(nu, device)),
        EmptyState(), EmptyState())
