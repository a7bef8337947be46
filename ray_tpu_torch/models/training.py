"""Training-step factory, on one device or over a device mesh.

Counterpart of ``ray_tpu/models/training.py``. JAX compiles the whole
update into one jitted program; here the step runs eagerly: the loss,
``backward()`` (through the flash attention kernels on the card), the
global gradient norm and one optimizer step.

With ``mesh`` (``parallel/``) the parameters are DTensors placed by their
logical axes under the rules, the batch is placed by ``batch_logical``,
and every op of the loss runs on DTensors: DTensor inserts the collectives
JAX's partitioner compiles in (gradient reductions over the batch axes,
tensor-parallel reductions). The AdamW moments are DTensors placed like
their parameters, and ``grad_norm`` is the norm over all shards.

Parameters are a dict of leaf tensors that require grad; ``step`` updates
them IN PLACE (JAX returns new arrays and donates the old ones, so
``donate`` is accepted and does nothing) and returns the same dict. The
optimizer state is a ``torch.optim`` optimizer over the leaves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.parallel.mesh import compute_mesh, replicated
from ray_tpu_torch.parallel.sharding import (ShardingRules, logical_sharding,
                                             pytree_shardings, shard_pytree)
from ray_tpu_torch.utils.device import resolve_device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw``'s update: bias-corrected moments, eps outside the
    square root, decoupled weight decay ``lr * weight_decay * p`` on every
    leaf. ``init(params)`` returns the optimizer state: a
    ``torch.optim.AdamW`` over the leaves, fused into one kernel per step
    when they lie on the card, with its moments made at once (zeros like
    each leaf, so DTensors placed like it), as ``optax``'s ``init``
    does."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> torch.optim.Optimizer:
        leaves = list(_leaves(params))
        fused = all(p.is_cuda for p in leaves)
        opt = torch.optim.AdamW(
            leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay,
            fused=True if fused else None)
        for p in leaves:    # torch.optim.AdamW's own first-step state
            opt.state[p] = {
                "step": (torch.zeros((), dtype=torch.float32, device=p.device)
                         if fused else torch.tensor(0.0, dtype=torch.float32)),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}
        return opt


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the two moments,
    each a tree shaped like the parameters."""

    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax's ``EmptyState`` (the weight decay's and the learning rate's)."""


def adamw_state_tree(opt_state: torch.optim.Optimizer, params) -> Tuple:
    """The AdamW state as the tree ``optax.adamw(...).init(params)`` has,
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``: an
    int32 count (every leaf shares one step: the first leaf's is read) and
    the moments, the optimizer's own tensors shaped like ``params``. The
    ``state_dict`` of a torch optimizer keys leaves by integers, which a
    checkpoint refuses; this tree saves as the JAX package saves its
    optimizer state."""
    first = next(iter(_leaves(params)))
    count = torch.tensor(int(opt_state.state[first]["step"].item()),
                         dtype=torch.int32)
    return (ScaleByAdamState(
        count=count,
        mu=_tree_map(lambda p: opt_state.state[p]["exp_avg"], params),
        nu=_tree_map(lambda p: opt_state.state[p]["exp_avg_sq"], params)),
        EmptyState(), EmptyState())


def _zip_leaves(tree, *others):
    """``(leaf, other leaves at the same path)`` over ``tree``, matching
    dicts by key (the others may hold them in another order) and lists and
    tuples by position; a missing path raises ``KeyError``/``IndexError``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _zip_leaves(v, *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        if any(len(o) != len(tree) for o in others):
            raise ValueError(f"a list of {len(tree)} against "
                             f"{[len(o) for o in others]}")
        for i, v in enumerate(tree):
            yield from _zip_leaves(v, *(o[i] for o in others))
    else:
        yield (tree,) + others


def _into(dst: torch.Tensor, src) -> None:
    """Copy ``src`` (a tensor, a DTensor or a numpy array) into ``dst``."""
    if not isinstance(src, torch.Tensor):
        src = torch.as_tensor(src)
    src = src.to(dtype=dst.dtype)
    if isinstance(dst, DTensor) and not isinstance(src, DTensor):
        src = distribute_tensor(src.to(dst.device), dst.device_mesh,
                                dst.placements)
    dst.copy_(src)


def load_adamw_state_tree(opt_state: torch.optim.Optimizer, params,
                          tree) -> torch.optim.Optimizer:
    """Load an ``adamw_state_tree`` (this package's, or optax's as numpy
    arrays: ``tree[0]`` is ``(count, mu, nu)``) into ``opt_state``, the
    optimizer over ``params``: every leaf's ``step`` becomes the count and
    its ``exp_avg``/``exp_avg_sq`` the moments, in place, on the fused
    route (the step on the card) and the plain one (the step on the host)
    alike."""
    count, mu, nu = tree[0][0], tree[0][1], tree[0][2]
    count = float(np.asarray(count.cpu() if isinstance(count, torch.Tensor)
                             else count))
    with torch.no_grad():
        for p, m, v in _zip_leaves(params, mu, nu):
            st = opt_state.state[p]
            st["step"].fill_(count)
            _into(st["exp_avg"], m)
            _into(st["exp_avg_sq"], v)
    return opt_state


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw``, with optax's defaults (torch's own AdamW defaults to
    ``weight_decay=0.01``)."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


@dataclass
class TrainStepBundle:
    """What a training loop needs: ``init(seed) -> (params, opt_state)`` and
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    under a mesh also the placements of the parameters, of the moments
    (those of their parameters) and of the batch."""

    init: Callable[..., Tuple[Any, Any]]
    step: Callable[..., Tuple[Any, Any, Dict]]
    device: torch.device
    param_shardings: Any = None
    opt_shardings: Any = None
    batch_sharding: Any = None
    mesh: Any = None


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def place_batch(batch: Dict, mesh, batch_sharding, dev) -> Dict:
    """Every rank's whole batch as DTensors split by ``batch_sharding``
    (each rank keeps its block: no communication)."""
    if mesh is None:
        return {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
    cm = compute_mesh(mesh)
    return {k: DTensor.from_local(
        v.to(dev, non_blocking=True), cm, replicated(mesh),
        run_check=False).redistribute(cm, batch_sharding)
        for k, v in batch.items()}


def _mesh_device(mesh) -> torch.device:
    kind = compute_mesh(mesh).device_type
    return resolve_device("cuda" if kind == "cuda" else kind)


def make_train_step(*, loss_fn: Callable, init_params_fn: Callable,
                    logical_params: Any = None, mesh=None,
                    rules: Optional[ShardingRules] = None,
                    optimizer: Optional[AdamW] = None,
                    batch_logical: Optional[Tuple] = ("batch", None),
                    donate: bool = True,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> TrainStepBundle:
    """Build ``(init, step)`` on one device, or over ``mesh`` (with
    ``logical_params``, the tree of logical axes mirroring the parameters,
    and ``rules``, default ``ShardingRules()``; the device is the mesh's).

    ``loss_fn(params, batch)`` returns a scalar loss (it closes over the
    mesh and rules itself); ``init_params_fn(seed)`` returns the parameter
    dict, the same full tensors on every rank. ``donate`` is accepted for
    JAX's signature and does nothing: ``step`` updates in place. The
    metrics are device tensors (reading them synchronises), whole on every
    rank: ``loss`` and ``grad_norm``, the global L2 norm of the gradients
    before the update (``optax.global_norm``)."""
    del donate
    optimizer = optimizer or adamw(3e-4)
    if mesh is None:
        dev = resolve_device(device)
        param_sh = batch_sh = None
    else:
        if logical_params is None:
            raise ValueError("a mesh needs logical_params")
        dev = _mesh_device(mesh)
        rules = rules or ShardingRules()
        param_sh = pytree_shardings(logical_params, mesh, rules)
        batch_sh = logical_sharding(mesh, rules, batch_logical)

    def init(seed: Union[int, torch.Generator] = 0):
        params = _tree_map(lambda t: t.detach().to(dev),
                           init_params_fn(seed))
        if mesh is not None:
            params = shard_pytree(params, logical_params, mesh, rules)
        params = _tree_map(lambda t: t.requires_grad_(True), params)
        return params, optimizer.init(params)

    def step(params, opt_state, batch):
        leaves = list(_leaves(params))
        for p in leaves:
            p.grad = None
        loss = loss_fn(params, place_batch(batch, mesh, batch_sh, dev))
        loss.backward()
        for p in leaves:               # optax updates (and decays) every leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = torch.linalg.vector_norm(torch.stack(
            [_full(torch.linalg.vector_norm(p.grad, dtype=torch.float32))
             for p in leaves]))
        opt_state.step()
        return params, opt_state, {"loss": _full(loss.detach()),
                                   "grad_norm": gnorm}

    return TrainStepBundle(init=init, step=step, device=dev,
                           param_shardings=param_sh, opt_shardings=param_sh,
                           batch_sharding=batch_sh, mesh=mesh)


def make_eval_step(*, loss_fn: Callable, param_shardings: Any = None,
                   batch_sharding: Any = None, mesh=None) -> Callable:
    """``eval_step(params, batch) -> loss``, without gradients; under
    ``mesh`` the batch is placed by ``batch_sharding`` and the loss comes
    back whole on every rank (``param_shardings`` is accepted for JAX's
    signature: the parameters are already placed)."""
    del param_shardings

    def eval_step(params, batch):
        with torch.no_grad():
            if mesh is not None:
                dev = _mesh_device(mesh)
                batch = place_batch(batch, mesh, batch_sharding, dev)
            return _full(loss_fn(params, batch))

    return eval_step
