"""Simulated control-plane cluster — the scale proof hardware can't give us.

Grows ``bench.py --control-plane``'s stub-daemon pattern into a full
in-process cluster model: ONE real :class:`GcsService` (real scheduler,
real placement/gang/lease paths, real health watchdog) fronted by N stub
daemons that are real enough where it matters — each holds a real
:class:`LocalLeaseTable` receiving the GCS's adopt/revoke pushes, carries
synthetic ``(pod, slice, tier)`` topology labels, and heartbeats on the
daemon schedule. The GCS's daemon RPC pool is replaced by an in-process
router, so a 1000-node cluster costs dicts and threads, not sockets.

What this is for: scheduler throughput, gang-placement latency p50/p99,
cross-tier-edge counts vs the topology-blind baseline, and watchdog
detection time at 300-1000 nodes (``bench.py --sched-sim``,
``BENCH_sched_r01.json``). Determinism: all placement-relevant state is
derived from the constructor ``seed``; two SimClusters with equal
parameters place gangs identically (pinned by tests at 300 nodes).

Sim shape knobs (``sim_hosts_per_slice``, ``sim_slices_per_pod``,
``sim_heartbeat_period_s``) live in :mod:`ray_tpu_torch.core.config` so the
raylint config-knob check sees them referenced here.

The port's copy of ``ray_tpu/core/sim_cluster.py``: its nodes carry the
card's resource, ``GPU`` (``gpus_per_node``), where the JAX harness's carry
``TPU``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.gcs_server import GcsService
from ray_tpu_torch.core.ids import NodeID, PlacementGroupID
from ray_tpu_torch.core.lease_table import LocalLeaseTable
from ray_tpu_torch.core.resources import cross_tier_edges, topology_labels

__all__ = ["SimCluster", "SimStubDaemon"]


class SimStubDaemon:
    """The daemon surface the GCS pushes at, over a REAL lease table."""

    def __init__(self, node_id: NodeID, address: str):
        self.node_id = node_id
        self.address = address
        self.lease_table = LocalLeaseTable()

    # -- GCS push targets ------------------------------------------------------

    def adopt_capacity_block(self, block_id: str, shape: Dict[str, float],
                             total: int, pinned: bool = False) -> None:
        self.lease_table.adopt(block_id, shape, int(total), pinned=pinned)

    def revoke_capacity_block(self, block_id: str) -> None:
        self.lease_table.revoke(block_id)

    def free_object(self, object_id) -> None:  # directory cleanup push
        pass


class _SimClient:
    """RpcClient stand-in: dispatches straight into the stub daemon."""

    def __init__(self, daemon: SimStubDaemon):
        self._daemon = daemon

    def notify(self, method: str, *args) -> None:
        getattr(self._daemon, method)(*args)

    def call(self, method: str, *args, timeout: Optional[float] = None):
        return getattr(self._daemon, method)(*args)


class _SimDaemonPool:
    """RpcClientPool stand-in keyed by the synthetic node addresses."""

    def __init__(self):
        self._daemons: Dict[str, SimStubDaemon] = {}

    def add(self, daemon: SimStubDaemon) -> None:
        self._daemons[daemon.address] = daemon

    def get(self, address: str) -> _SimClient:
        return _SimClient(self._daemons[address])

    def invalidate(self, address: str) -> None:
        pass

    def close_all(self) -> None:
        self._daemons.clear()


class SimCluster:
    """N-node simulated cluster around one real GcsService.

    ``topology``: node ``i`` sits in slice ``i // sim_hosts_per_slice`` and
    pod ``slice // sim_slices_per_pod``; registration order is shuffled by
    ``seed`` so slice membership is uncorrelated with registration order
    (as on a real fleet). ``heartbeat=False`` skips the heartbeat thread —
    watchdog-free benches avoid the per-period O(N) wakeups.
    """

    def __init__(self, n_nodes: int, cpus_per_node: int = 16,
                 gpus_per_node: int = 4, seed: int = 0,
                 heartbeat: bool = True, topology: bool = True):
        cfg = config()
        self.n_nodes = int(n_nodes)
        self.seed = int(seed)
        self.svc = GcsService()
        self.pool = _SimDaemonPool()
        self.svc._daemons = self.pool  # in-process push routing
        self.daemons: List[SimStubDaemon] = []
        self._stop = threading.Event()
        self._paused: set = set()  # node indexes with heartbeats stopped
        rng = random.Random(self.seed)
        order = list(range(self.n_nodes))
        rng.shuffle(order)
        hosts_per_slice = max(1, int(cfg.sim_hosts_per_slice))
        slices_per_pod = max(1, int(cfg.sim_slices_per_pod))
        for i in order:
            node_id = NodeID(rng.getrandbits(128).to_bytes(16, "big"))
            addr = f"sim://node-{i}"
            labels: Dict[str, str] = {}
            if topology:
                slice_i = i // hosts_per_slice
                labels = topology_labels(f"pod{slice_i // slices_per_pod}",
                                         f"slice{slice_i}")
            daemon = SimStubDaemon(node_id, addr)
            self.pool.add(daemon)
            self.daemons.append(daemon)
            self.svc.register_node(
                node_id, addr,
                {"CPU": float(cpus_per_node), "GPU": float(gpus_per_node)},
                labels)
        self.daemons.sort(key=lambda d: int(d.address.rsplit("-", 1)[1]))
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name="sim-heartbeats",
                daemon=True)
            self._hb_thread.start()

    # -- heartbeats / failure injection ---------------------------------------

    def _heartbeat_loop(self) -> None:
        period = float(config().sim_heartbeat_period_s)
        while not self._stop.wait(period):
            for i, d in enumerate(self.daemons):
                if i in self._paused:
                    continue
                try:
                    self.svc.heartbeat(d.node_id)
                except Exception:  # noqa: BLE001 — GCS mid-shutdown
                    return

    def stop_heartbeat(self, index: int) -> None:
        """Silently kill node ``index``'s heartbeats (SIGKILL-style death
        the watchdog must DETECT, vs. kill_node's declared death)."""
        self._paused.add(index)

    def kill_node(self, index: int) -> None:
        """Declared node death — the GCS drops it immediately."""
        self._paused.add(index)
        self.svc._handle_node_death(self.daemons[index].node_id)

    # -- gang workload helpers -------------------------------------------------

    def create_gang(self, bundles: List[Dict[str, float]],
                    strategy: str = "PACK", gang_priority: int = 0,
                    timeout: float = 5.0) -> PlacementGroupID:
        pg_id = PlacementGroupID.from_random()
        self.svc.create_placement_group(pg_id, "", bundles, strategy,
                                        timeout=timeout,
                                        gang_priority=gang_priority)
        return pg_id

    def remove_gang(self, pg_id: PlacementGroupID) -> None:
        self.svc.remove_placement_group(pg_id)

    def gang_nodes(self, pg_id: PlacementGroupID) -> List[NodeID]:
        info = self.svc.get_placement_group(pg_id)
        return [b["node_id"] for b in info["bundles"]] if info else []

    def gang_cross_tier_edges(self, pg_id: PlacementGroupID) -> int:
        """DCN-crossing bundle pairs of a placed gang (0 = ICI-contained)."""
        return cross_tier_edges(
            [self.svc.scheduler.node_slice(n) for n in self.gang_nodes(pg_id)])

    def placement_digest(self, pg_id: PlacementGroupID) -> str:
        """Stable digest of a gang's (bundle -> node) map, for determinism
        checks across equally-seeded clusters."""
        return ",".join(n.hex()[:12] for n in self.gang_nodes(pg_id))

    def shutdown(self) -> None:
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        self.svc.shutdown()


def wait_for(predicate, timeout: float = 30.0, interval: float = 0.02) -> bool:
    """Poll ``predicate`` until true/timeout (watchdog-detection measures)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False
