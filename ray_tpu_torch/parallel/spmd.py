"""Per-rank (SPMD) regions over a mesh and the differentiable collectives
they use: the port's counterpart of ``jax.shard_map`` and of
``lax.ppermute``/``psum``/``all_to_all``/``axis_index``.

:func:`spmd` runs ``fn`` on each rank's local shards of DTensor arguments
and wraps its result back into a DTensor. Inside, code calls the
collectives below on plain tensors; each is an ``autograd.Function`` whose
backward is the collective JAX's transpose rule gives:

- :func:`ppermute` shifts a tensor around an axis's ring; its backward
  shifts the cotangent back;
- :func:`psum` sums over an axis for a *replicated* consumer (megatron's
  row-parallel reduce): the cotangent arriving is already the whole one on
  every rank, so the backward is the identity;
- :func:`pbroadcast` is the identity forward and sums the cotangent over
  the axis backward (megatron's column-parallel input), the conjugate of
  :func:`psum`;
- :func:`all_to_all` splits one dim over an axis and concatenates another
  (JAX's ``tiled=True``); its backward is the inverse all-to-all.

Autograd on one rank runs the backward only of what reaches that rank's
loss, so a collective whose result a rank does not use would wait forever
for that rank in the backward. Code inside a region therefore selects with
``torch.where`` (both branches stay in the graph, with zero cotangents), as
JAX's SPMD programs do, and never skips a collective on some ranks only.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)

from ray_tpu_torch.parallel.mesh import compute_mesh, mesh_shape
from ray_tpu_torch.parallel.sharding import placements


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return compute_mesh(mesh).get_local_rank(axis)


def _group(mesh, axis: str):
    return compute_mesh(mesh).get_group(axis)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                       dist.P2POp(dist.irecv, out, src, group)]):
        # raylint: ignore[untimed-wait] — bounded by the process group's own
        # timeout (init_process_group's, set by launch and TorchConfig): a
        # lost peer fails the op there instead of parking the rank.
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1):
    """Send ``x`` to the rank ``shift`` places on along ``axis`` (a ring)
    and return what the rank ``shift`` places back sent: JAX's
    ``ppermute`` with ``perm = [(j, (j + shift) % n)]``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _PPermute.apply(x, _group(mesh, axis), shift)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, mesh, axis: str):
    """Sum over ``axis`` for a consumer replicated over it (backward: the
    identity)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _PSum.apply(x, _group(mesh, axis))


def pbroadcast(x: torch.Tensor, mesh, axis: str):
    """The identity, whose backward sums the cotangent over ``axis``: the
    input of a computation split over ``axis`` (column-parallel)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _PBroadcast.apply(x, _group(mesh, axis))


def _a2a(x, group, split_dim: int, concat_dim: int):
    n = dist.get_world_size(group)
    parts = list(x.chunk(n, dim=split_dim))
    send = torch.stack(parts).contiguous()          # [n, ...] by destination
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = group, split_dim, concat_dim
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _a2a(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int):
    """JAX's ``all_to_all(..., tiled=True)``: ``x`` splits into ``n``
    chunks along ``split_dim``, chunk ``i`` goes to rank ``i`` of ``axis``,
    and the chunks received concatenate along ``concat_dim`` in rank
    order."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllToAll.apply(x, _group(mesh, axis), split_dim, concat_dim)


def spmd(fn: Callable, mesh, in_specs: Sequence, out_spec, *,
         in_grad_specs: Sequence = None):
    """``jax.shard_map``: ``fn`` runs on each rank's local blocks.

    ``in_specs`` and ``out_spec`` give, per argument and for the one
    output, its mesh axes per tensor dim (as ``ShardingRules.mesh_axes``
    returns them). A DTensor argument is redistributed to its spec; a plain
    tensor is taken as the same full value on every rank. The output is a
    DTensor with ``out_spec``'s placements. ``in_grad_specs`` gives, per
    argument, the placements of the local gradients ``fn`` produces
    (default: its input placements): ``Partial()`` on an axis the input is
    replicated over but the computation splits (a batch axis for
    parameters)."""
    cm = compute_mesh(mesh)

    def run(*args):
        local = []
        for i, (x, spec) in enumerate(zip(args, in_specs)):
            pl = placements(mesh, spec)
            if not isinstance(x, DTensor):
                x = distribute_tensor(x, cm, pl)
            else:
                x = x.redistribute(cm, pl)
            grad = None if in_grad_specs is None else in_grad_specs[i]
            local.append(x.to_local(grad_placements=grad))
        out = fn(*local)
        return DTensor.from_local(out, cm, placements(mesh, out_spec),
                                  run_check=False)

    return run


def grad_placements(mesh, spec, split_axes) -> tuple:
    """Placements of the local gradients of an input with ``spec`` to a
    region whose computation is split over ``split_axes``: ``Partial()``
    where the input is replicated over such an axis, else its own."""
    names = compute_mesh(mesh).mesh_dim_names
    out = list(placements(mesh, spec))
    for i, name in enumerate(names):
        if isinstance(out[i], Replicate) and name in split_axes:
            out[i] = Partial()
    return tuple(out)
