"""Device meshes: the substrate for every parallelism axis.

Counterpart of ``ray_tpu/parallel/mesh.py``. One
``torch.distributed.device_mesh.DeviceMesh`` carries every parallelism
dimension as a named axis, as JAX's ``Mesh`` does:

- ``data``    data parallelism (gradient all-reduce)
- ``fsdp``    parameter-sharded data parallelism (all-gather on use)
- ``tensor``  tensor parallelism (megatron column/row sharding)
- ``seq``     sequence parallelism (ring or Ulysses attention)
- ``pipe``    pipeline parallelism (GPipe stage handoff)
- ``expert``  expert parallelism

A device is a rank: torch runs one process per device. All six axes are
always present, size-1 axes included, in the canonical order below, so
sharding rules can name any axis whatever the topology. Tensors, though,
live on the mesh's *active* sub-mesh (:func:`compute_mesh`, the axes of
size > 1): DTensor's sharding propagation enumerates strategies over every
mesh dim, and six dims make one matmul's first dispatch take a minute
where three take a tenth of a second (on 8 CPU ranks). Size-1 axes shard
nothing, so dropping them changes no placement. Building a mesh
over one device with no process group yet starts a world-1 group (NCCL on
``cuda``, gloo on ``cpu``), so single-process code runs unchanged; a mesh
over several ranks needs the process group already started
(``parallel/launch.py`` starts CPU worlds for tests and dry runs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate

from ray_tpu_torch.core.resources import TIER_DCN, TIER_ICI

# Canonical axis order, outermost -> innermost (DCN-tolerant -> ICI-hungry).
AXIS_ORDER = ("data", "fsdp", "expert", "pipe", "seq", "tensor")

# Fabric tier of each canonical axis: ``data``/``fsdp`` collectives are
# bandwidth-bound and overlappable, every inner axis wants the fast tier.
AXIS_TIER = {"data": TIER_DCN, "fsdp": TIER_DCN, "expert": TIER_ICI,
             "pipe": TIER_ICI, "seq": TIER_ICI, "tensor": TIER_ICI}


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: axis name -> size (1 = absent).

    ``MeshSpec(data=2, tensor=4)`` on 8 devices is a (2, 4) mesh. Size
    ``-1`` on at most one axis means "fill with the remaining devices".
    """

    data: int = 1
    fsdp: int = 1
    expert: int = 1
    pipe: int = 1
    seq: int = 1
    tensor: int = 1

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        known = int(np.prod([s for s in sizes.values() if s != -1]))
        if wild:
            if n_devices % known:
                raise ValueError(
                    f"cannot fill axis {wild[0]}: {n_devices} devices not "
                    f"divisible by {known}")
            sizes[wild[0]] = n_devices // known
            known = n_devices
        if known != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {known} devices but {n_devices} provided")
        return MeshSpec(**sizes)

    def axis_names(self) -> List[str]:
        return [a for a in AXIS_ORDER if self.sizes()[a] > 1]


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def best_devices(n: Optional[int] = None,
                 device_type: str = "cuda") -> List[int]:
    """The ranks of the world, each one device of ``device_type``.

    Runs on the card unless the caller asks for the CPU, and raises when
    ``cuda`` is asked for and no card is present (JAX's version drops to
    virtual CPU devices; this one never leaves the card unasked)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' to build a CPU mesh")
    ranks = list(range(_world_size()))
    if n is not None:
        if len(ranks) < n:
            raise ValueError(f"need {n} devices, have {len(ranks)}")
        ranks = ranks[:n]
    return ranks


def _start_world_of_one(device_type: str) -> None:
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(spec: "MeshSpec | Dict[str, int] | None" = None,
              devices: Optional[Sequence[int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` over ``devices`` (ranks; default all) with the six
    canonical axes, size-1 axes included.

    Every rank of the world calls it, also ranks outside ``devices``
    (their mesh has no coordinate: ``mesh.get_coordinate()`` is None)."""
    if isinstance(spec, dict):
        spec = MeshSpec(**spec)
    if devices is None:
        devices = best_devices(device_type=device_type)
    elif device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' to build a CPU mesh")
    devices = list(devices)
    spec = (spec or MeshSpec(data=-1)).resolve(len(devices))
    if not dist.is_initialized():
        if len(devices) != 1:
            raise RuntimeError(
                f"a mesh over {len(devices)} devices needs a started process "
                f"group (torch.distributed.init_process_group)")
        _start_world_of_one(device_type)
    shape = tuple(spec.sizes()[a] for a in AXIS_ORDER)
    ranks = torch.tensor(devices, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXIS_ORDER)


def cpu_mesh(spec: "MeshSpec | Dict[str, int] | None" = None,
             n: Optional[int] = None) -> DeviceMesh:
    """A CPU mesh over the first ``n`` ranks of a gloo world: the port's
    counterpart of JAX's virtual CPU mesh for tests and multi-device dry
    runs. With ``n=None`` the count is the spec's product (a fully given
    spec) or the whole world (a wildcard spec)."""
    if isinstance(spec, dict):
        spec = MeshSpec(**spec)
    if n is None and spec is not None:
        sizes = list(spec.sizes().values())
        if -1 not in sizes:
            n = int(np.prod(sizes))
    ranks = list(range(_world_size()))
    if n is not None:
        if len(ranks) < n:
            raise ValueError(f"need {n} devices, have {len(ranks)}")
        ranks = ranks[:n]
    return make_mesh(spec, ranks, device_type="cpu")


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh: DeviceMesh) -> tuple:
    """Axes over which gradients are reduced (data + fsdp)."""
    return tuple(a for a in ("data", "fsdp") if a in mesh.mesh_dim_names)


def hierarchy_split(mesh: DeviceMesh) -> Tuple[tuple, tuple]:
    """(dcn_axes, ici_axes) among the mesh's ACTIVE (size > 1) axes."""
    active = [a for a, s in mesh_shape(mesh).items() if s > 1]
    return (tuple(a for a in active if AXIS_TIER.get(a) == "dcn"),
            tuple(a for a in active if AXIS_TIER.get(a) != "dcn"))


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements of a tensor replicated over the whole mesh (on its
    :func:`compute_mesh`)."""
    return (Replicate(),) * compute_mesh(mesh).ndim


def compute_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The sub-mesh of ``mesh``'s axes of size > 1, in mesh order (its
    ``data`` axis alone when every axis has size 1): where DTensors live.

    A mesh that is already such a sub-mesh is returned as it is; the
    sub-mesh of a canonical mesh is built once and kept on it."""
    names = mesh.mesh_dim_names
    if names is None or tuple(names) != AXIS_ORDER:
        return mesh
    sub = getattr(mesh, "_rtpu_compute_mesh", None)
    if sub is None:
        active = tuple(a for a, s in mesh_shape(mesh).items() if s > 1)
        sub = mesh[active if active else "data"]
        mesh._rtpu_compute_mesh = sub
    return sub
