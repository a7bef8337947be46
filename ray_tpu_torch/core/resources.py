"""Resource set arithmetic with fixed-point precision.

The port's copy of ``ray_tpu/core/resources.py``. Where the JAX package
names TPU chips (``TPU``, ``TPU-<version>``), the port names the card
(``GPU``, ``GPU-<model>``: see ``ray_tpu_torch.accelerators``); the
arithmetic and the topology vocabulary are the same.

Analog of the reference's scheduling resource types
(``src/ray/common/scheduling/fixed_point.h`` — resources stored as int64
ten-thousandths to make arithmetic exact, and
``cluster_resource_data.h`` ``ResourceSet``/``NodeResources``). We store
quantities as integer micro-units (1e-4 granularity like the reference) keyed
by resource name; TPU chips and slice-head markers are plain named resources,
exactly how the reference's TPU accelerator manager emits them
(``python/ray/_private/accelerators/tpu.py:294-382`` — ``TPU``, ``TPU-V4``,
``TPU-{pod_type}-head``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

PRECISION = 10_000  # 1e-4 resource granularity, same as fixed_point.h

# -- interconnect topology vocabulary -----------------------------------------
#
# The two-tier network model every layer shares: ranks inside one TPU slice
# talk over ICI (cheap, high-bandwidth collectives); anything that crosses a
# slice boundary rides the data-center network. ``parallel/mesh.py`` maps
# mesh axes onto these same tier names (AXIS_TIER), and the gang scheduler
# scores candidate placements by how many bundle pairs are forced onto DCN.
# Defined here (not in parallel/) so the GCS process never imports jax.
TIER_ICI = "ici"
TIER_DCN = "dcn"

# Node-label keys carrying a node's position in the fabric. A daemon that
# knows its TPU metadata registers with all three; unlabeled nodes degrade
# to one-node slices (every gang edge between them is a DCN edge).
TOPO_POD = "topo.pod"
TOPO_SLICE = "topo.slice"
TOPO_TIER = "topo.tier"


def topology_labels(pod: str, slice_id: str, tier: str = TIER_ICI) -> Dict[str, str]:
    """Label dict placing a node at ``(pod, slice, tier)`` in the fabric."""
    return {TOPO_POD: str(pod), TOPO_SLICE: str(slice_id), TOPO_TIER: str(tier)}


def topology_of(labels: Dict[str, str], fallback: str = "") -> Tuple[str, str, str]:
    """A node's ``(pod, slice, tier)`` from its labels.

    Unlabeled nodes each become a singleton slice named after ``fallback``
    (callers pass the node id) in a shared default pod — the topology-blind
    degenerate where no two nodes share ICI.
    """
    pod = labels.get(TOPO_POD, "pod0")
    slice_id = labels.get(TOPO_SLICE) or f"solo:{fallback}"
    tier = labels.get(TOPO_TIER, TIER_ICI)
    return pod, slice_id, tier


def cross_tier_edges(slice_ids: Sequence[str]) -> int:
    """Number of unordered bundle pairs landing in DIFFERENT slices.

    Each such pair's collective traffic must cross the DCN tier; 0 means the
    gang is fully ICI-contained. This is the bin-packing score the gang
    planner minimizes and the sim harness publishes.
    """
    counts: Dict[str, int] = {}
    for s in slice_ids:
        counts[s] = counts.get(s, 0) + 1
    n = len(slice_ids)
    same = sum(c * (c - 1) // 2 for c in counts.values())
    return n * (n - 1) // 2 - same


def _to_fixed(value: float) -> int:
    return round(value * PRECISION)


def _from_fixed(value: int) -> float:
    return value / PRECISION


class ResourceSet:
    """A bag of named resource quantities with exact arithmetic."""

    __slots__ = ("_fixed",)

    def __init__(self, resources: Dict[str, float] | None = None):
        self._fixed: Dict[str, int] = {}
        for name, qty in (resources or {}).items():
            f = _to_fixed(qty)
            if f < 0:
                raise ValueError(f"negative resource {name}={qty}")
            if f > 0:
                self._fixed[name] = f

    @classmethod
    def _from_fixed_dict(cls, fixed: Dict[str, int]) -> "ResourceSet":
        # Negative quantities are kept: node *availability* legitimately goes
        # negative under the blocked-worker oversubscription protocol (a worker
        # blocked in get() releases its CPU and force-reacquires on resume, the
        # reference's behavior). Requests are validated non-negative in
        # __init__.
        rs = cls()
        rs._fixed = {k: v for k, v in fixed.items() if v != 0}
        return rs

    def to_dict(self) -> Dict[str, float]:
        return {k: _from_fixed(v) for k, v in self._fixed.items()}

    def get(self, name: str) -> float:
        return _from_fixed(self._fixed.get(name, 0))

    def is_empty(self) -> bool:
        return not self._fixed

    def names(self) -> Iterable[str]:
        return self._fixed.keys()

    def is_subset_of(self, other: "ResourceSet") -> bool:
        """True if ``other`` has at least this much of every resource."""
        return all(other._fixed.get(k, 0) >= v for k, v in self._fixed.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._fixed)
        for k, v in other._fixed.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet._from_fixed_dict(out)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._fixed)
        for k, v in other._fixed.items():
            out[k] = out.get(k, 0) - v
        return ResourceSet._from_fixed_dict(out)

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._fixed == other._fixed

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"

    def __reduce__(self):
        return (ResourceSet, (self.to_dict(),))


class NodeResources:
    """A node's total and available resources plus labels.

    Mirrors ``NodeResources`` in the reference's
    ``cluster_resource_data.h`` (total/available/labels) — utilization drives
    the hybrid scheduling policy score.
    """

    def __init__(self, total: ResourceSet, labels: Dict[str, str] | None = None):
        self.total = total
        self.available = ResourceSet._from_fixed_dict(dict(total._fixed))
        self.labels = dict(labels or {})

    def can_fit(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.available)

    def is_feasible(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.total)

    def allocate(self, request: ResourceSet, force: bool = False) -> None:
        """Subtract ``request`` from availability.

        With ``force=True`` availability may go negative — the blocked-worker
        reacquire path (a worker resuming from a blocking ``get`` takes its
        CPU back even if another task borrowed it meanwhile; the node is
        temporarily oversubscribed and ``can_fit`` blocks new admissions until
        the imbalance drains). Every allocate is paired with exactly one
        release, so accounting stays exact.
        """
        if not force and not self.can_fit(request):
            raise ValueError(f"cannot allocate {request} from {self.available}")
        self.available = self.available - request

    def release(self, request: ResourceSet) -> None:
        self.available = self.available + request

    def critical_utilization(self) -> float:
        """Max utilization across resources the node actually has.

        This is the 'critical resource utilization' in the reference's hybrid
        policy (``hybrid_scheduling_policy.h:28-48``).
        """
        worst = 0.0
        for name, tot in self.total._fixed.items():
            avail = self.available._fixed.get(name, 0)
            used = (tot - avail) / tot
            worst = max(worst, used)
        return worst
