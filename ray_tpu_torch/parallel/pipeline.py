"""Pipeline parallelism: a differentiable GPipe schedule on a mesh axis.

Counterpart of ``ray_tpu/parallel/pipeline.py``, with the same schedule and
layout (not ``torch.distributed.pipelining``, whose schedule and numerics
differ): every rank of the ``pipe`` axis holds one stage's layers (the
leading ``layers`` dim of the parameters is split over the axis), and
activations move to the next stage by
:func:`~ray_tpu_torch.parallel.spmd.ppermute` each tick. Classic GPipe
fill-drain: for M microbatches on S stages the loop runs M + S - 1 ticks;
at tick t stage 0 takes microbatch t (the last one again once they run
out) and stage S-1 emits microbatch t - (S - 1). Every stage computes every
tick; fill and drain ticks compute values nothing reads (zero cotangents).
Only the last stage writes the output, and a sum over ``pipe`` replicates
it. The backward is autograd through the same ticks: ``ppermute``'s
backward is the reverse shift, which is the backward pipeline.

Input layout: ``x`` is ``[microbatch, num_microbatches, ...]``, the
microbatch index trailing the batch-split dim, so a batch-split
``[B, ...]`` activation reshapes into it without moving data.

The per-layer body runs on local blocks inside an SPMD region over the
whole mesh (:func:`~ray_tpu_torch.parallel.spmd.spmd`), so it can itself
call collectives: ``psum`` over ``tensor``, ring attention over ``seq``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel.spmd import (axis_index, axis_size, grad_placements,
                                         ppermute, psum, spmd)


def _flatten(tree):
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                ("dict", keys, [s for _, s in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree), None, [s for _, s in parts]))
    return [tree], None


def _unflatten(leaves, struct):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        vals = [build(sub) for sub in subs]
        return dict(zip(keys, vals)) if kind == "dict" else kind(vals)

    return build(struct)


def _leaf_specs(tree, specs):
    """The spec of each leaf of ``tree``, in :func:`_flatten`'s order;
    ``specs`` mirrors ``tree`` (dicts matched by key)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaf_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v, s in zip(tree, specs) for x in _leaf_specs(v, s)]
    return [specs]


def make_pipeline(layer_fn: Callable, mesh, *, num_microbatches: int,
                  pipe_axis: str = "pipe", batch_axes=("data", "fsdp"),
                  x_spec: Optional[tuple] = None, param_specs=None,
                  remat: bool = False):
    """Build a differentiable pipelined forward.

    ``layer_fn(layer_params, x) -> y`` is one LAYER on local blocks; it
    keeps the input's shape and may call the collectives of
    ``parallel/spmd.py``.

    The returned ``pipeline(layer_params, x)`` takes:
    - ``layer_params``: a tree whose leaves have a leading dim of L layers
      (split over ``pipe_axis``; S must divide L). ``param_specs`` (a tree
      of mesh-axis specs mirroring it, or None for ``(pipe_axis,)``)
      splits the other dims too (tensor-parallel weights).
    - ``x``: ``[microbatch, num_microbatches, ...]``; ``x_spec`` overrides
      the default ``(batch_axes, None)``.

    It returns a DTensor in ``x``'s layout."""
    n_stages = axis_size(mesh, pipe_axis)
    ticks = num_microbatches + n_stages - 1
    if x_spec is None:
        x_spec = (batch_axes, None)
    split = {a for s in x_spec if s is not None
             for a in ((s,) if isinstance(s, str) else s)}

    def run_layer(lp, h):
        if remat:
            return checkpoint(layer_fn, lp, h, use_reentrant=False)
        return layer_fn(lp, h)

    def pipeline(layer_params, x):
        leaves, struct = _flatten(layer_params)
        if param_specs is None:
            specs = [(pipe_axis,)] * len(leaves)
        elif isinstance(param_specs, (dict, list)):
            specs = _leaf_specs(layer_params, param_specs)
        else:                       # one spec for every leaf
            specs = [param_specs] * len(leaves)
        if len(specs) != len(leaves):
            raise ValueError(f"{len(specs)} parameter specs for "
                             f"{len(leaves)} parameters")

        def body(*local):
            *plocal, xl = local
            stage = axis_index(mesh, pipe_axis)
            is_first = torch.tensor(stage == 0, device=xl.device)
            is_last = torch.tensor(stage == n_stages - 1, device=xl.device)
            # Schedule order [num_micro, mb_local, ...]: a local transpose.
            xt = xl.transpose(0, 1)
            n_local = plocal[0].shape[0]

            def apply_stage(h):
                for i in range(n_local):
                    h = run_layer(_unflatten([p[i] for p in plocal], struct),
                                  h)
                return h

            rows = [torch.zeros_like(xt[0]) for _ in range(num_microbatches)]
            carry = torch.zeros_like(xt[0])
            for t in range(ticks):
                fresh = xt[min(t, num_microbatches - 1)]
                y = apply_stage(torch.where(is_first, fresh, carry))
                done = t - (n_stages - 1)
                if done >= 0:       # the same on every rank: a tick count
                    rows[done] = torch.where(is_last, y, rows[done])
                if t + 1 < ticks:   # JAX's last shift feeds nothing
                    carry = ppermute(y, mesh, pipe_axis)
            # The output lives on the last stage only; the sum over pipe
            # replicates it (every other stage holds zeros).
            out = psum(torch.stack(rows), mesh, pipe_axis)
            return out.transpose(0, 1)

        in_specs = list(specs) + [x_spec]
        in_grad = ([grad_placements(mesh, s, split) for s in specs]
                   + [grad_placements(mesh, x_spec, {pipe_axis})])
        return spmd(body, mesh, in_specs, x_spec,
                    in_grad_specs=in_grad)(*leaves, x)

    return pipeline
