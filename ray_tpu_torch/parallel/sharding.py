"""Logical-axis sharding rules: model code names *logical* axes, a rule
table maps them onto mesh axes.

Counterpart of ``ray_tpu/parallel/sharding.py``. Parameters and
activations are annotated with logical names (``("embed", "mlp")``); a
``ShardingRules`` table maps each name to a mesh axis, a tuple of axes or
None (replicate). Where JAX produces a ``NamedSharding``, this module
produces DTensor placements: one entry per mesh dim, ``Shard(d)`` where
tensor dim ``d`` is split over that mesh dim, else ``Replicate()``. A tuple
axis (``batch -> ("data", "fsdp")``) splits one tensor dim over two mesh
dims: ``Shard(0)`` on both, nested in mesh-dim order, which is JAX's
major-to-minor order only when the tuple lists its axes in mesh order, so
a tuple against the mesh order raises. Placements are those of the mesh's
:func:`~ray_tpu_torch.parallel.mesh.compute_mesh` (its axes of size > 1):
an axis of size 1 shards nothing and is left out.

Default rules (the megatron/fsdp recipe):
- ``vocab``/``mlp``/``heads`` -> ``tensor``
- ``embed`` -> ``fsdp``
- ``batch`` -> ``data`` + ``fsdp``
- ``seq_act`` -> ``seq``
- ``layers`` -> ``pipe``
- ``experts`` -> ``expert``
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple, Union

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ray_tpu_torch.parallel.mesh import AXIS_ORDER, compute_mesh

MeshAxis = Union[str, Tuple[str, ...], None]
Logical = Optional[Tuple[Optional[str], ...]]


@dataclass(frozen=True)
class ShardingRules:
    batch: MeshAxis = ("data", "fsdp")
    seq_act: MeshAxis = "seq"          # activation sequence dim
    embed: MeshAxis = "fsdp"           # parameter d_model dim (fsdp-sharded)
    mlp: MeshAxis = "tensor"           # ffn hidden dim
    heads: MeshAxis = "tensor"         # attention heads
    kv_heads: MeshAxis = "tensor"
    vocab: MeshAxis = "tensor"
    head_dim: MeshAxis = None
    layers: MeshAxis = "pipe"
    experts: MeshAxis = "expert"
    unsharded: MeshAxis = None

    def mesh_axes(self, logical: Logical) -> Tuple[MeshAxis, ...]:
        """The mesh axes of each tensor dim (JAX's ``PartitionSpec``
        entries, as a tuple)."""
        if logical is None:
            return ()
        out = []
        for name in logical:
            if name is None:
                out.append(None)
            else:
                if not hasattr(self, name):
                    raise ValueError(f"unknown logical axis '{name}'")
                out.append(getattr(self, name))
        return tuple(out)

    def update(self, **kwargs) -> "ShardingRules":
        return replace(self, **kwargs)


# Rule presets for common topologies.
DP_ONLY = ShardingRules(
    batch="data", seq_act=None, embed=None, mlp=None, heads=None,
    kv_heads=None, vocab=None, layers=None, experts=None,
)
FSDP = ShardingRules(
    batch=("data", "fsdp"), seq_act=None, mlp=None, heads=None,
    kv_heads=None, vocab=None, layers=None, experts=None,
)


def placements(mesh, spec: Tuple[MeshAxis, ...]) -> tuple:
    """DTensor placements, on ``compute_mesh(mesh)``, of a tensor whose dim
    ``d`` is split over the mesh axes ``spec[d]`` (a name, a tuple of
    names in mesh order, or None)."""
    names = list(compute_mesh(mesh).mesh_dim_names)
    out = [Replicate()] * len(names)
    used = set()
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in AXIS_ORDER:
                raise ValueError(f"mesh has no axis '{a}'")
            if a in used:
                raise ValueError(f"mesh axis '{a}' shards two tensor dims "
                                 f"in {spec}")
            used.add(a)
        order = [AXIS_ORDER.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"axes {axes} split one tensor dim against the mesh order "
                f"{AXIS_ORDER}: DTensor nests them in mesh order")
        for a in axes:
            if a in names:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def logical_sharding(mesh, rules: ShardingRules, logical: Logical) -> tuple:
    # No dropping of axes a dim is not divisible by: divisibility is a
    # model-config contract, as in JAX.
    return placements(mesh, rules.mesh_axes(logical))


def _is_logical_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))


def tree_map(fn, tree, *rest, is_leaf=None):
    """Map over nested dicts and lists (the parameter trees' containers)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def shard_pytree(tree, logical_tree, mesh, rules: ShardingRules):
    """Place a tree of tensors on the mesh under its logical annotations.

    ``logical_tree`` mirrors ``tree`` with tuples of logical names (or
    None) at the leaves. Every rank passes the same full tensors; each
    keeps its shard (``distribute_tensor`` scatters rank 0's)."""
    cm = compute_mesh(mesh)
    return tree_map(
        lambda x, logical: distribute_tensor(
            x, cm, logical_sharding(mesh, rules, logical)),
        tree, logical_tree)


def pytree_shardings(logical_tree, mesh, rules: ShardingRules):
    """The placements of every leaf of ``logical_tree``."""
    return tree_map(lambda logical: logical_sharding(mesh, rules, logical),
                    logical_tree, is_leaf=_is_logical_leaf)


def constrain(x, mesh, rules: ShardingRules, logical: Logical):
    """Redistribute a DTensor to its logical placements (JAX's
    ``with_sharding_constraint``); the identity on a plain tensor."""
    if isinstance(x, DTensor):
        return x.redistribute(compute_mesh(mesh),
                              logical_sharding(mesh, rules, logical))
    return x
