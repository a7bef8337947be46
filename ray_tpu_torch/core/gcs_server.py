"""GCS server — the control-plane process of the multiprocess runtime.

Analog of the reference's GCS server process (``src/ray/gcs/gcs_server/`` —
entry ``gcs_server_main.cc``, wiring ``gcs_server.cc``): node membership +
health checks (``gcs_health_check_manager.h:39``), actor lifetime management
(``gcs_actor_manager.cc:255,280,515``) including restart-on-failure, the
cluster resource view + lease-based scheduling (the raylet-side
``cluster_task_manager`` collapsed into the GCS since resource truth lives
here), placement-group reservation (``gcs_placement_group_scheduler.h:113``
2PC — atomic here because this process owns all resource accounting), the
internal KV (``gcs_kv_manager.cc``), function store, job table, a cluster-wide
object directory (the role of ``ownership_based_object_directory.cc``,
centralized), long-poll pubsub (``src/ray/pubsub/publisher.h:307``), and
table persistence to disk (the Redis option of ``gcs_server.cc:523-524``).

Runs standalone: ``python -m ray_tpu_torch.core.gcs_server --port 0`` prints
``GCS_ADDRESS=host:port`` on stdout for the parent to scrape.

The port's copy of ``ray_tpu/core/gcs_server.py``. It reads actor specs
with ``serialization.loads_deferred``: an argument holding a torch object
does not make this process import torch. It serves the KV tier's prefix
directory RPCs (``prefix_*``); the lock-order and leak checkers' start-up
hooks come with those checkers.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import pickle
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import Config, config, set_config
from ray_tpu_torch.core.gcs import ActorInfo, GlobalControlStore, JobInfo, NodeInfo
from ray_tpu_torch.core.gcs_shards import ShardedObjectDirectory, ShardedPubSub
from ray_tpu_torch.core.health import HealthWatchdog
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch.core.ingest import ObservabilityIngest
from ray_tpu_torch.core.resources import NodeResources, ResourceSet
from ray_tpu_torch.core.rpc import (
    BoundedSet,
    RpcClientPool,
    RpcConnectionError,
    RpcServer,
)
from ray_tpu_torch.core.scheduler import ClusterResourceScheduler
from ray_tpu_torch.core.task_spec import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("gcs_server")

# Set by main(): only a GCS that is its own process writes its stacks to a
# file of the session when a health tick comes late.
_DUMP_STALL_STACKS = False

# An actor's lease wait or its start on a daemon past this is logged as a
# warning (each scheduling step is logged at DEBUG): the trail a creation
# that never leaves PENDING leaves behind. Above a cold GPU worker's start
# (11-17 s on the H100's host: torch's import, CUDA, the weights).
_SLOW_SCHEDULING_S = 30.0


class _Lease:
    # client_id ties a task lease to the requesting client process (stable
    # across that client's TCP reconnects) so a client death (kill -9 of a
    # driver holding reused leases) releases its resources — the reference
    # gets this from raylet leases dying with the gRPC channel. "" = not
    # client-scoped (actor leases, snapshot-restored leases).
    __slots__ = ("lease_id", "node_id", "resources", "pg_id", "bundle_index",
                 "client_id")

    def __init__(self, lease_id, node_id, resources, pg_id=None,
                 bundle_index=-1, client_id=""):
        self.lease_id = lease_id
        self.node_id = node_id
        self.resources = resources
        self.pg_id = pg_id
        self.bundle_index = bundle_index
        self.client_id = client_id


class _CapacityBlock:
    # A batched lease grant: `total` units of one resource shape reserved on
    # one node, carved into per-task worker leases by that node's daemon
    # (lease ids "cap-N#k"). client_id scopes the block to the requesting
    # client like _Lease — a client death reclaims the un-returned units.
    # pg_id (when set) marks a GANG block: it backs one node's share of an
    # atomic placement-group reservation, its units are owned by the PG's
    # bundle accounting (never returned by the idle sweep or client-death
    # reclaim), and it leaves only through remove/preempt/node-death.
    __slots__ = ("block_id", "node_id", "shape", "total", "returned",
                 "client_id", "pg_id")

    def __init__(self, block_id, node_id, shape, total, client_id="",
                 pg_id=None):
        self.block_id = block_id
        self.node_id = node_id
        self.shape = shape  # ResourceSet of ONE unit
        self.total = total
        self.returned = 0
        self.client_id = client_id
        self.pg_id = pg_id


class _Bundle:
    __slots__ = ("resources", "node_id", "in_use")

    def __init__(self, resources: ResourceSet, node_id: NodeID):
        self.resources = resources
        self.node_id = node_id
        self.in_use = ResourceSet()


class _PlacementGroup:
    # gang_priority is the preemption class: serve autoscaling under SLO
    # pressure may revoke gangs of strictly lower priority. seq orders
    # same-priority victims (newest preempted first — least sunk work).
    __slots__ = ("pg_id", "name", "strategy", "bundles", "state",
                 "gang_priority", "seq")

    def __init__(self, pg_id, name, strategy, bundles, gang_priority=0,
                 seq=0):
        self.pg_id = pg_id
        self.name = name
        self.strategy = strategy
        self.bundles: List[_Bundle] = bundles
        self.state = "CREATED"
        self.gang_priority = int(gang_priority)
        self.seq = seq


class GcsService:
    """The RPC handler: every public method is a control-plane RPC."""

    def __init__(self, snapshot_path: str | None = None,
                 restore_from: str | None = None):
        self.store = GlobalControlStore()
        self.scheduler = ClusterResourceScheduler()
        self._lock = threading.RLock()
        # _sched_cv parks only PG-lease and PG-creation waiters (small
        # populations, always woken together); plain lease waiters park on
        # PER-SHAPE conditions (_shape_conds) so a release of {CPU:1} no
        # longer wakes every infeasible {TPU:8} requester — the wake-storm
        # fix. Both share self._lock, so predicates stay race-free.
        self._sched_cv = threading.Condition(self._lock)
        self._shape_conds: Dict[tuple, threading.Condition] = {}
        self._shape_waiters: Dict[tuple, int] = {}
        self._shape_sets: Dict[tuple, ResourceSet] = {}  # cached per shape
        self._wake_stats = {"wakes": 0, "skips": 0}
        # Pending-demand snapshot maintained INCREMENTALLY under its own
        # small lock: the autoscaler poll is an O(n) list copy that never
        # touches the scheduling lock. _demand_pos maps demand id -> index
        # in the parallel _demand_list/_demand_ids arrays (swap-pop remove).
        self._demand_lock = threading.Lock()
        self._demand_list: List[Dict[str, float]] = []
        self._demand_ids: List[int] = []
        self._demand_pos: Dict[int, int] = {}
        self._demand_seq = 0
        self._node_addr: Dict[NodeID, str] = {}
        self._heartbeats: Dict[NodeID, float] = {}
        self._dead_nodes: set = set()  # explicitly declared dead
        # Liveness has its own lock, innermost (taken under self._lock,
        # never the reverse): a heartbeat runs on its connection's reader
        # thread and takes only this one, so neither a busy handler pool
        # nor a long hold of the table lock delays it past the death
        # threshold (a saturated pool of 128 handlers used to declare live
        # nodes dead in 5 s).
        self._hb_lock = threading.Lock()
        # The health loop's own punctuality: ticks that woke more than a
        # period late (the GCS process itself stalled) and the worst
        # lateness, read by health_loop_stats.
        self._late_ticks = 0
        self._worst_late_s = 0.0
        self._stall_stacks_path = ""
        # Clients whose death cleanup already ran (on_client_closed): late
        # grants to them are refused instead of leaking. Bounded (uuids
        # never repeat, so old entries are only a leak) and lifted on
        # reconnect (a live client must not be banned forever).
        self._dead_clients = BoundedSet()
        self._leases: Dict[str, _Lease] = {}
        self._next_lease = 0
        # Capacity blocks: batched lease grants carved locally by daemons
        # (the daemon-local scheduling plane). Keyed "cap-<epoch>-N".
        self._blocks: Dict[str, _CapacityBlock] = {}
        self._next_block = 0
        # Block ids carry this GCS incarnation's epoch: a restarted GCS
        # counts from 1 again, and a daemon's lease table refuses an id it
        # already swept or revoked (``LocalLeaseTable``'s tombstones).
        self._block_epoch = os.urandom(4).hex()
        self._pgs: Dict[PlacementGroupID, _PlacementGroup] = {}
        self._pg_seq = 0
        # Placement groups removed while their creation was still mid-wait:
        # the creating thread checks this at each retry and rolls back
        # instead of committing a reservation nobody will ever release.
        self._pg_tombstones = BoundedSet()
        # Object directory (locations + lineage + per-task live sets),
        # hash-partitioned by creating-task key across gcs_shards lock
        # domains so location storms stop contending with scheduling.
        n_shards = max(1, int(config().gcs_shards))
        self._directory = ShardedObjectDirectory(n_shards)
        # actor bookkeeping for restart: actor id -> pickled creation spec
        self._actor_specs: Dict[ActorID, bytes] = {}
        self._actor_addr: Dict[ActorID, str] = {}
        self._actor_leases: Dict[ActorID, str] = {}  # held for actor lifetime
        self._actor_cv = threading.Condition(self._lock)
        self._daemons = RpcClientPool()
        # pubsub as an append-only log per channel, served by long-poll.
        # Channels are hash-partitioned across gcs_shards lock domains;
        # within a shard, wait lists are PER CHANNEL and filtered
        # object-location subscribes additionally park on PER-OID wait
        # lists so a seal wakes only the polls subscribed to that oid.
        self._pubsub = ShardedPubSub(n_shards)
        # Non-blocking observability ingest: report_metrics / task events /
        # span batches stage in a bounded queue drained by one dedicated
        # thread, so a slow aggregator lags instead of parking RPC handler
        # threads against lease grants. None = inline (legacy) applies.
        self._ingest: Optional[ObservabilityIngest] = (
            ObservabilityIngest(self._ingest_apply,
                                config().gcs_ingest_queue_max)
            if config().gcs_ingest_async_enabled else None)
        self._snapshot_path = snapshot_path
        self._snapshot_seq = 0
        self._stopped = threading.Event()
        if snapshot_path and os.path.exists(snapshot_path):
            self._restore_snapshot(snapshot_path)
        elif restore_from:
            # Head-disk-loss recovery: the local snapshot is gone, but the
            # tables were MIRRORED to node daemons on every snapshot tick —
            # pull the newest copy from any surviving daemon (the external-
            # store role Redis plays in the reference,
            # ``gcs_server.cc:523-524``).
            self._restore_from_mirror(restore_from)
        # Watchdog: classifies nodes (heartbeat age) and components
        # (metrics-report age) healthy/stalled/dead each health tick;
        # transitions land on the ingest plane + the flight recorder and
        # the states export as ray_tpu_component_health.
        self._watchdog = HealthWatchdog(
            on_transition=self._on_health_transition)
        self._ingest_drop_warned = False
        self._ingest_dropped_last = 0
        self._monitor = threading.Thread(
            target=self._health_loop, name="gcs-health", daemon=True
        )
        self._monitor.start()
        # The GCS exports its own registry too (component="gcs") — straight
        # into the local aggregator, no RPC hop.
        from ray_tpu_torch.core.metrics_export import MetricsExporter

        self._metrics_exporter = MetricsExporter(
            report=self.store.report_metrics, node_id="head",
            component="gcs", collectors=[self._collect_gcs_metrics]).start()
        if snapshot_path:
            threading.Thread(
                target=self._snapshot_loop, name="gcs-snapshot", daemon=True
            ).start()

    # ====================== nodes / health ======================

    def register_node(self, node_id: NodeID, address: str,
                      resources: Dict[str, float], labels: Dict[str, str],
                      object_store_name: str = "",
                      hosted_actors: list | None = None) -> dict:
        """Register (or re-register after a GCS restart) a node.

        ``hosted_actors`` is the daemon's record of live actors it hosts —
        the restarted GCS re-adopts them into the actor table, the analog of
        the reference rebuilding GCS state from ``gcs_init_data.cc`` +
        raylet re-registration after a Redis-backed restart.
        """
        info = NodeInfo(node_id=node_id, address=address, resources=resources,
                        labels=dict(labels))
        info.labels["_object_store"] = object_store_name
        with self._lock:
            self.store.register_node(info)
            self.scheduler.add_node(
                node_id, NodeResources(ResourceSet(resources), labels=info.labels)
            )
            with self._hb_lock:
                self._node_addr[node_id] = address
                self._heartbeats[node_id] = time.time()
            for actor_id, spec_bytes, worker_addr in (hosted_actors or []):
                from ray_tpu_torch.core import serialization

                spec = serialization.loads_deferred(spec_bytes)
                if self.store.get_actor(actor_id) is None:
                    try:
                        self.store.register_actor(ActorInfo(
                            actor_id=actor_id,
                            name=spec.options.name or "",
                            namespace=spec.options.namespace or "default",
                            class_name=spec.function_name,
                            state="ALIVE",
                            node_id=node_id,
                            max_restarts=spec.options.max_restarts,
                            detached=spec.options.lifetime == "detached",
                        ))
                    except ValueError:
                        continue  # name already re-taken; keep the new one
                self._actor_specs[actor_id] = spec_bytes
                self._actor_addr[actor_id] = worker_addr
                self._actor_cv.notify_all()
            self._wake_all_locked()
        self._publish("node", ("ALIVE", node_id.hex(), address))
        self._reschedule_placement_groups()
        if getattr(self, "_pending_detached", None):
            # Nodes exist again: give daemons one health period to re-adopt
            # their live actors, then resurrect whichever detached actors
            # are still missing.
            threading.Thread(target=self._delayed_detached_recreate,
                             daemon=True).start()
        logger.info("node %s registered at %s: %s", node_id.hex()[:8], address, resources)
        return {"config": config().to_dict()}

    def heartbeat(self, node_id: NodeID) -> str:
        """'ok' | 'unknown' (re-register — fresh GCS) | 'dead' (exit).

        Runs on the connection's reader thread, under ``_hb_lock`` alone
        (see ``__init__``)."""
        with self._hb_lock:
            if node_id in self._dead_nodes:
                return "dead"
            if node_id not in self._node_addr:
                return "unknown"
            self._heartbeats[node_id] = time.time()
            return "ok"

    heartbeat._rpc_inline = True  # RpcServer runs it on the reader thread

    def _health_loop(self) -> None:
        cfg = config()
        period = cfg.health_check_period_s
        threshold = cfg.health_check_failure_threshold
        stacks = self._open_stall_stacks() if _DUMP_STALL_STACKS else None
        while True:
            waited = time.monotonic()
            if self._stopped.wait(period):
                break
            late = time.monotonic() - waited - period
            now = time.time()
            if late > period:
                self._on_late_tick(late, now, stacks)
            dead: List[NodeID] = []
            with self._hb_lock:
                for node_id, last in list(self._heartbeats.items()):
                    if now - last > period * threshold:
                        dead.append(node_id)
            for node_id in dead:
                logger.warning("node %s missed %d heartbeats — marking dead",
                               node_id.hex()[:8], threshold)
                self._handle_node_death(node_id)
            try:
                self._watchdog_tick(now)
            except Exception:  # noqa: BLE001 — diagnostics never kill health
                log_swallowed(logger, "watchdog tick")
        if stacks is not None:
            stacks.close()

    def _open_stall_stacks(self):
        path = os.path.join(flightrec.session_dir(),
                            f"gcs-{os.getpid()}-stall-stacks.txt")
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            f = open(path, "a")
        except OSError:
            log_swallowed(logger, "stall stacks file")
            return None
        self._stall_stacks_path = path
        return f

    def _on_late_tick(self, late: float, now: float, stacks=None) -> None:
        """The health tick woke more than a period late: this process was
        held (a starved host, the GIL, a GC pass, SIGSTOP), so heartbeats
        that arrived meanwhile sat unread. Credit the stall to every node
        instead of counting it as their silence: each stamp moves forward by
        the lateness (never past now). A daemon silent on its own still ages
        out threshold periods after its last heartbeat, stall excluded."""
        self._late_ticks += 1
        self._worst_late_s = max(self._worst_late_s, late)
        load = os.getloadavg()
        with self._hb_lock:
            for node_id, last in self._heartbeats.items():
                self._heartbeats[node_id] = min(now, last + late)
            n = len(self._heartbeats)
        logger.warning(
            "health tick woke %.2f s late (load %.2f %.2f %.2f): the GCS "
            "itself stalled; %d nodes' heartbeat stamps re-based (stacks "
            "in %s)", late, *load, n, self._stall_stacks_path or "-")
        flightrec.record("health", "gcs", f"tick late {late:.2f}s")
        if stacks is not None:
            # Every thread's stack as the tick resumes, dumped from this
            # thread with the GIL held. faulthandler's timer thread could
            # dump during the stall, but it walks the frames of threads
            # that are running, and after an 8 s SIGSTOP it crashed the
            # GCS (SIGSEGV) now and then.
            stacks.write(f"--- health tick {late:.2f} s late at {now:.3f}\n")
            stacks.flush()
            faulthandler.dump_traceback(file=stacks, all_threads=True)
            stacks.flush()

    def health_loop_stats(self) -> dict:
        """Late health ticks of this GCS (the process's own stalls)."""
        return {"late_ticks": self._late_ticks,
                "worst_late_s": self._worst_late_s,
                "stacks_path": self._stall_stacks_path}

    def _watchdog_tick(self, now: float) -> None:
        cfg = config()
        period = cfg.health_check_period_s
        interval = cfg.metrics_export_interval_s
        factor = cfg.health_stall_factor
        with self._hb_lock:
            node_ages = {nid.hex(): now - last
                         for nid, last in self._heartbeats.items()}
            dead_hexes = {nid.hex() for nid in self._dead_nodes}
        self._watchdog.tick(
            node_ages=node_ages, dead_nodes=dead_hexes,
            components=self.store.metrics.process_meta(),
            node_bounds=(period * factor,
                         period * cfg.health_check_failure_threshold),
            # component dead bound = the aggregator's own staleness horizon,
            # so "report aged out" and "report evicted" classify the same.
            comp_bounds=(interval * factor, max(5.0, 3.0 * interval)),
            now=now)

    def _on_health_transition(self, tr: dict) -> None:
        subject = ":".join(str(p) for p in tr["key"][1:])
        logger.warning("watchdog: %s %s %s -> %s",
                       tr["kind"], subject, tr["old"], tr["new"])
        flightrec.record("health", subject, f"{tr['old']}->{tr['new']}")
        self.record_task_event({
            "type": "health_transition", "kind": tr["kind"],
            "subject": subject, "old": tr["old"], "new": tr["new"],
            "time": tr["time"], "beacon_ts": tr.get("beacon_ts"),
        })

    def health_states(self) -> List[dict]:
        """Watchdog view: every tracked node/component with its current
        healthy/stalled/dead classification (ray-tpu status / debug)."""
        return self._watchdog.states()

    def _handle_node_death(self, node_id: NodeID) -> None:
        with self._lock:
            if node_id not in self._node_addr:
                return
            with self._hb_lock:
                addr = self._node_addr.pop(node_id)
                self._dead_nodes.add(node_id)
                self._heartbeats.pop(node_id, None)
            flightrec.record("health", node_id.hex()[:16], "node dead")
            self.store.mark_node_dead(node_id)
            self.scheduler.remove_node(node_id)
            self._daemons.invalidate(addr)
            # Leases on the node die with it.
            for lease_id in [l for l, v in self._leases.items() if v.node_id == node_id]:
                self._leases.pop(lease_id)
            # Capacity blocks too — their resources were dropped with the
            # node (remove_node), so no release; just forget the records.
            for block_id in [b for b, v in self._blocks.items()
                             if v.node_id == node_id]:
                self._blocks.pop(block_id)
            # Object locations on the node are gone.
            self._directory.drop_node(node_id)
            # PG bundles on the node lose their reservation.
            needs_reschedule = False
            for pg in self._pgs.values():
                for b in pg.bundles:
                    if b.node_id == node_id:
                        pg.state = "RESCHEDULING"
                        needs_reschedule = True
            dead_actors = [
                (aid, info) for aid, info in self.store.actors.items()
                if info.node_id == node_id and info.state in ("ALIVE", "PENDING", "RESTARTING")
            ]
            self._wake_all_locked()
        self._publish("node", ("DEAD", node_id.hex(), addr))
        for aid, info in dead_actors:
            self._on_actor_failure(aid, f"node {node_id.hex()[:8]} died")
        if needs_reschedule:
            self._reschedule_placement_groups()

    def drain_node(self, node_id: NodeID) -> None:
        """Graceful removal (autoscaler downscale path)."""
        self._handle_node_death(node_id)

    # ====================== leases / scheduling ======================

    # -- wake indexing (satellite: notify_all storms) --------------------------

    @staticmethod
    def _shape_key(resources: Dict[str, float]) -> tuple:
        return tuple(sorted(resources.items()))

    def _shape_cond(self, shape_key: tuple,
                    request: ResourceSet) -> threading.Condition:
        cond = self._shape_conds.get(shape_key)
        if cond is None:
            cond = self._shape_conds[shape_key] = threading.Condition(
                self._lock)
            self._shape_sets[shape_key] = request
        return cond

    def _wake_shapes_locked(self) -> None:
        """Capacity returned: wake PG waiters (small set, shape-agnostic
        bundles) plus only the shape classes that could now fit SOMEWHERE.
        A shape that still fits nowhere stays parked (its ≤1.0s wait slice
        remains the missed-wake safety net)."""
        self._sched_cv.notify_all()
        for shape_key, count in self._shape_waiters.items():
            if count <= 0:
                continue
            if self.scheduler.any_can_fit(self._shape_sets[shape_key]):
                self._wake_stats["wakes"] += 1
                self._shape_conds[shape_key].notify_all()
            else:
                self._wake_stats["skips"] += 1

    def _wake_all_locked(self) -> None:
        """Membership / client-death events: anything may be feasible (or
        newly hopeless) now — wake every parked waiter to re-check."""
        self._sched_cv.notify_all()
        for cond in self._shape_conds.values():
            cond.notify_all()

    # -- incremental pending-demand snapshot (satellite: O(1)-ish poll) --------

    def _demand_add(self, resources: Dict[str, float]) -> int:
        with self._demand_lock:
            self._demand_seq += 1
            demand_id = self._demand_seq
            self._demand_pos[demand_id] = len(self._demand_list)
            self._demand_list.append(dict(resources))
            self._demand_ids.append(demand_id)
            return demand_id

    def _demand_remove(self, demand_id: int) -> None:
        with self._demand_lock:
            pos = self._demand_pos.pop(demand_id, None)
            if pos is None:
                return
            last = len(self._demand_list) - 1
            if pos != last:
                # swap-pop: move the tail entry into the vacated slot
                self._demand_list[pos] = self._demand_list[last]
                moved = self._demand_ids[pos] = self._demand_ids[last]
                self._demand_pos[moved] = pos
            self._demand_list.pop()
            self._demand_ids.pop()

    def request_lease(self, resources: Dict[str, float], strategy=None,
                      timeout: float = 60.0,
                      _client_id: str = "") -> Tuple[str, NodeID, str]:
        """Blocking lease request: (lease_id, node_id, node_address).

        The reference splits this between the driver-side direct task
        transport (``RequestNewWorkerIfNeeded``) and per-raylet
        ``ClusterTaskManager`` queues with spillback; with resource truth
        centralized here, the queue is this condition variable.

        ``_client_id`` (injected by RpcServer from the hello frame) scopes
        the lease to the calling client process: if that client dies without
        releasing, the lease is reclaimed in :meth:`on_client_closed`.
        """
        request = ResourceSet(resources)
        deadline = time.time() + timeout
        pg_id, bundle_index = None, -1
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            pg_id = pg.id if hasattr(pg, "id") else pg
            bundle_index = strategy.placement_group_bundle_index
        # Register as pending demand while waiting: the autoscaler reads
        # this to size the cluster (gcs_autoscaler_state_manager.cc's
        # demand report). One request may re-enter the wait many times
        # within its timeout slices — the id keys a single logical wait.
        demand_id = self._demand_add(resources)
        try:
            return self._request_lease_wait(request, resources, strategy,
                                            deadline, timeout, pg_id,
                                            bundle_index, _client_id)
        finally:
            self._demand_remove(demand_id)

    def _request_lease_wait(self, request, resources, strategy, deadline,
                            timeout, pg_id, bundle_index, _client_id):
        shape_key = self._shape_key(resources)
        with self._lock:
            # Non-PG requests park on their shape's condition so a release
            # only wakes shape classes that could now fit; PG requests stay
            # on _sched_cv (bundle state isn't shape-indexable).
            if pg_id is None:
                cond = self._shape_cond(shape_key, request)
            else:
                cond = self._sched_cv
            waiting = False
            try:
                while True:
                    got = self._request_lease_try(request, resources,
                                                  strategy, pg_id,
                                                  bundle_index, _client_id)
                    if got is not None:
                        return got
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"no node can satisfy {resources} within "
                            f"{timeout}s (cluster: "
                            f"{self.scheduler.available_resources()})")
                    if not waiting and pg_id is None:
                        waiting = True
                        self._shape_waiters[shape_key] = (
                            self._shape_waiters.get(shape_key, 0) + 1)
                    # raylint: ignore[blocking-under-lock] — cond is either
                    # _sched_cv or a _shape_cond; both wrap self._lock.
                    cond.wait(timeout=min(remaining, 1.0))
            finally:
                if waiting:
                    n = self._shape_waiters.get(shape_key, 1) - 1
                    if n > 0:
                        self._shape_waiters[shape_key] = n
                    else:
                        # GC the idle shape's index entries so long-running
                        # clusters don't accrete one cond per shape ever seen.
                        self._shape_waiters.pop(shape_key, None)
                        self._shape_conds.pop(shape_key, None)
                        self._shape_sets.pop(shape_key, None)

    def _request_lease_try(self, request, resources, strategy, pg_id,
                           bundle_index, _client_id):
        """One feasibility check + grant attempt; caller holds self._lock."""
        if (isinstance(strategy, NodeAffinitySchedulingStrategy)
                and not strategy.soft
                and strategy.node_id in self._dead_nodes):
            # Hard affinity to a KNOWN-dead node can never be
            # satisfied — fail now instead of queueing forever.
            # (A merely unknown node may still be registering, e.g.
            # right after a GCS restart — those requests wait.)
            raise RuntimeError(
                f"no feasible node: hard affinity to dead node "
                f"{strategy.node_id}")
        if pg_id is not None:
            if pg_id not in self._pgs:
                # Group removed (remove_placement_group pops it) —
                # indistinguishable from "temporarily full" inside
                # _try_pg_lease, so fail fast here instead of
                # spinning out the whole timeout. Creation blocks
                # before handles exist, so "not yet created" can't
                # reach this path.
                raise RuntimeError(
                    f"placement group {pg_id} does not exist "
                    "(removed?)")
            if self._pgs[pg_id].state == "PREEMPTED":
                # A higher-priority gang revoked this group's reservation —
                # fail fast so the client recreates instead of spinning out
                # the whole timeout.
                raise RuntimeError(
                    f"placement group {pg_id} was preempted")
        if _client_id and _client_id in self._dead_clients:
            # Grant-after-death race: the client's cleanup already
            # ran while this handler was blocked — granting now
            # would leak the lease forever.
            raise RuntimeError("client is dead; lease refused")
        if pg_id is not None:
            return self._try_pg_lease(pg_id, bundle_index, request,
                                      client_id=_client_id)
        return self._try_lease(request, strategy, client_id=_client_id)

    request_lease._rpc_wants_conn = True  # RpcServer injects _client_id

    def request_lease_batch(self, resources: Dict[str, float], strategy=None,
                            count: int = 1, timeout: float = 60.0,
                            _client_id: str = ""):
        """Batched lease grant: one revocable CAPACITY BLOCK of up to
        ``count`` units of ``resources`` on one node, returned as
        ``(block_id, node_id, node_address, granted)``.

        The caller's node daemon carves per-task worker leases out of the
        block locally (``lease_worker_block``), so a deep scheduling-key
        queue costs one GCS hop instead of ``count``. Partial grants
        (``granted < count``) are normal; at least one unit is always
        granted before returning. Unused units flow back via
        :meth:`return_block_capacity` (daemon idle-TTL sweep) and the whole
        block is reclaimed on client death (:meth:`on_client_closed`), the
        same conn-scoped path per-task leases use.

        PG strategies are rejected — bundle accounting is per-task by
        design; the client falls back to per-task ``request_lease``.
        """
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            raise ValueError("placement-group leases cannot be batched")
        request = ResourceSet(resources)
        count = max(1, int(count))
        deadline = time.time() + timeout
        shape_key = self._shape_key(resources)
        demand_id = self._demand_add(resources)
        try:
            with self._lock:
                cond = self._shape_cond(shape_key, request)
                waiting = False
                try:
                    while True:
                        if _client_id and _client_id in self._dead_clients:
                            raise RuntimeError(
                                "client is dead; lease refused")
                        if (isinstance(strategy,
                                       NodeAffinitySchedulingStrategy)
                                and not strategy.soft
                                and strategy.node_id in self._dead_nodes):
                            raise RuntimeError(
                                f"no feasible node: hard affinity to dead "
                                f"node {strategy.node_id}")
                        got = self._try_block(request, strategy, count,
                                              _client_id)
                        if got is not None:
                            break
                        remaining = deadline - time.time()
                        if remaining <= 0:
                            raise TimeoutError(
                                f"no node can satisfy {resources} within "
                                f"{timeout}s (cluster: "
                                f"{self.scheduler.available_resources()})")
                        if not waiting:
                            waiting = True
                            self._shape_waiters[shape_key] = (
                                self._shape_waiters.get(shape_key, 0) + 1)
                        # raylint: ignore[blocking-under-lock] — the shape
                        # cond wraps self._lock (see _shape_cond).
                        cond.wait(timeout=min(remaining, 1.0))
                finally:
                    if waiting:
                        n = self._shape_waiters.get(shape_key, 1) - 1
                        if n > 0:
                            self._shape_waiters[shape_key] = n
                        else:
                            self._shape_waiters.pop(shape_key, None)
                            self._shape_conds.pop(shape_key, None)
                            self._shape_sets.pop(shape_key, None)
        finally:
            self._demand_remove(demand_id)
        block_id, node_id, addr, granted = got
        # Push the grant to the daemon OUTSIDE the lock so it can start
        # carving before the client's first lease_worker_block arrives.
        # Best-effort: the client's carve calls carry an inline adopt hint,
        # so a lost push only delays, never wedges (and in-process tests
        # run with no daemon at the node address at all).
        try:
            self._daemons.get(addr).notify(
                "adopt_capacity_block", block_id, dict(resources), granted)
        except Exception:  # noqa: BLE001 — carve-side adopt hint covers it
            log_swallowed(logger, "capacity-block adopt push")
        return block_id, node_id, addr, granted

    request_lease_batch._rpc_wants_conn = True

    def _try_block(self, request: ResourceSet, strategy, count: int,
                   client_id: str):
        """Greedy block grant: best node for the shape, then allocate as
        many units as fit there (>=1). Caller holds self._lock."""
        node_id = self.scheduler.best_node(request, strategy)
        if node_id is None or not self.scheduler.try_allocate(node_id, request):
            return None
        granted = 1
        while granted < count and self.scheduler.try_allocate(node_id, request):
            granted += 1
        self._next_block += 1
        block_id = f"cap-{self._block_epoch}-{self._next_block}"
        self._blocks[block_id] = _CapacityBlock(
            block_id, node_id, request, granted, client_id=client_id)
        flightrec.record("lease", block_id,
                         f"block grant x{granted} -> {node_id.hex()[:8]}")
        return block_id, node_id, self._node_addr[node_id], granted

    def return_block_capacity(self, block_id: str, n: int) -> bool:
        """A daemon ships back ``n`` unused units of a block (idle-TTL
        sweep). False = unknown block (e.g. the GCS restarted and lost it);
        the daemon then drops its local record instead of retrying."""
        with self._lock:
            block = self._blocks.get(block_id)
            if block is None:
                return False
            if block.pg_id is not None:
                # Gang blocks back a live placement-group reservation; the
                # PG's bundle accounting owns those units (daemons pin them
                # out of the idle sweep, so reaching here means a confused
                # daemon — refuse the return, keep the record).
                return True
            n = max(0, min(int(n), block.total - block.returned))
            if n:
                block.returned += n
                for _ in range(n):
                    self.scheduler.release(block.node_id, block.shape)
                if block.returned >= block.total:
                    self._blocks.pop(block_id, None)
                self._wake_shapes_locked()
            return True

    def pending_resource_demands(self) -> List[Dict[str, float]]:
        """Resource shapes of lease requests currently WAITING (queued or
        infeasible) — what the autoscaler sizes the cluster against.
        Maintained incrementally; this is a plain list copy off the
        scheduling lock."""
        with self._demand_lock:
            return list(self._demand_list)

    def pending_block_capacity(self) -> List[Dict[str, float]]:
        """Outstanding (granted-but-not-returned) capacity-block units, one
        scaled resource dict per live block. The autoscaler credits these
        as pending capacity in ``bin_pack`` so a block a daemon has been
        granted but not yet adopted into running tasks doesn't look like
        unmet demand and double-launch a node."""
        out: List[Dict[str, float]] = []
        with self._lock:
            for block in self._blocks.values():
                if block.pg_id is not None:
                    # Gang blocks are PG reservations, not pending lease
                    # capacity — counting them would skew the autoscaler
                    # (legacy PG reservations were never counted here).
                    continue
                units = block.total - block.returned
                if units <= 0:
                    continue
                shape = block.shape.to_dict()
                out.append({k: v * units for k, v in shape.items()})
        return out

    def node_resource_state(self, node_id_bytes: bytes) -> Optional[dict]:
        """Per-node {total, available} for the autoscaler's idle check."""
        nr = self.scheduler.node_resources(NodeID(node_id_bytes))
        if nr is None:
            return None
        return {"total": nr.total.to_dict(),
                "available": nr.available.to_dict()}

    def _try_lease(self, request: ResourceSet, strategy,
                   client_id: str = "") -> Optional[Tuple[str, NodeID, str]]:
        node_id = self.scheduler.best_node(request, strategy)
        if node_id is None or not self.scheduler.try_allocate(node_id, request):
            return None
        return self._grant(node_id, request, client_id=client_id)

    def _try_pg_lease(self, pg_id, bundle_index, request,
                      client_id: str = "") -> Optional[Tuple[str, NodeID, str]]:
        pg = self._pgs.get(pg_id)
        if pg is None or pg.state != "CREATED":
            return None
        indices = [bundle_index] if bundle_index >= 0 else range(len(pg.bundles))
        for i in indices:
            b = pg.bundles[i]
            free = b.resources - b.in_use
            if request.is_subset_of(free) and b.node_id in self._node_addr:
                b.in_use = b.in_use + request
                return self._grant(b.node_id, request, pg_id=pg_id,
                                   bundle_index=i, client_id=client_id)
        return None

    def _grant(self, node_id, request, pg_id=None, bundle_index=-1,
               client_id=""):
        self._next_lease += 1
        lease_id = f"lease-{self._next_lease}"
        self._leases[lease_id] = _Lease(lease_id, node_id, request, pg_id,
                                        bundle_index, client_id=client_id)
        flightrec.record("lease", lease_id, f"grant -> {node_id.hex()[:8]}")
        return lease_id, node_id, self._node_addr[node_id]

    def on_client_opened(self, client_id: str) -> None:
        """A client (re)connected: lift any death ban — a transient >grace
        network drop must not permanently refuse a live driver."""
        with self._lock:
            self._dead_clients.discard(client_id)

    def on_client_closed(self, client_id: str) -> None:
        """Release leases still scoped to a dead client process (kill -9 of
        a driver/worker holding reused leases — reference: leases die with
        the raylet⇄client gRPC channel). Fired by RpcServer after the
        client's last connection has been gone for the grace period."""
        if not client_id:
            return
        with self._lock:
            self._dead_clients.add(client_id)
            orphaned = [l.lease_id for l in self._leases.values()
                        if l.client_id == client_id]
            # Reclaim the dead client's capacity blocks: everything not yet
            # returned by the daemon's idle sweep comes back here (the
            # daemon is told to revoke, so a late return of the same units
            # finds the block gone and is ignored — freed exactly once).
            revoked: List[Tuple[str, str]] = []
            for block_id in [b for b, v in self._blocks.items()
                             if v.client_id == client_id]:
                block = self._blocks.pop(block_id)
                for _ in range(block.total - block.returned):
                    self.scheduler.release(block.node_id, block.shape)
                addr = self._node_addr.get(block.node_id)
                if addr is not None:
                    revoked.append((block_id, addr))
            self._wake_all_locked()  # wake its blocked requesters
        flightrec.record("lease", client_id[:32],
                         f"client death: {len(orphaned)} leases "
                         f"{len(revoked)} blocks")
        for block_id, addr in revoked:
            logger.info("revoking capacity block %s after client death",
                        block_id)
            flightrec.record("lease", block_id, "revoke (client death)")
            try:
                self._daemons.get(addr).notify("revoke_capacity_block",
                                               block_id)
            except Exception:  # noqa: BLE001 — daemon death has its own path
                log_swallowed(logger, "capacity-block revoke push")
        for lease_id in orphaned:
            logger.info("releasing lease %s after client death", lease_id)
            self.release_lease(lease_id)

    def release_lease(self, lease_id: str) -> None:
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return
            flightrec.record("lease", lease_id, "release")
            if lease.pg_id is not None:
                pg = self._pgs.get(lease.pg_id)
                if pg is not None and 0 <= lease.bundle_index < len(pg.bundles):
                    b = pg.bundles[lease.bundle_index]
                    b.in_use = b.in_use - lease.resources
            else:
                self.scheduler.release(lease.node_id, lease.resources)
            self._wake_shapes_locked()

    def available_resources(self) -> Dict[str, float]:
        return self.scheduler.available_resources()

    def cluster_resources(self) -> Dict[str, float]:
        return self.store.cluster_resources()

    def list_nodes(self) -> List[dict]:
        with self._lock:
            return [
                {"node_id": n.node_id, "address": n.address, "alive": n.alive,
                 "resources": n.resources, "labels": n.labels}
                for n in self.store.nodes.values()
            ]

    # ====================== placement groups ======================

    def create_placement_group(self, pg_id: PlacementGroupID, name: str,
                               bundles: List[Dict[str, float]], strategy: str,
                               timeout: float = 60.0,
                               gang_priority: int = 0) -> bool:
        """Atomic multi-bundle reservation.

        The reference needs prepare/commit across raylets
        (``gcs_placement_group_scheduler.h:113-115``); with centralized
        accounting the transaction is a single critical section, with the
        same all-or-nothing outcome (rollback on partial fit).

        With ``gang_scheduling_enabled``, multi-bundle PACK/STRICT_PACK
        groups take the topology-aware GANG path instead: one planner pass
        places the whole group (inside a single ICI slice when possible —
        STRICT_PACK becomes strict-one-slice rather than strict-one-node),
        then every node's share is reserved as a pinned revocable ``cap-N``
        capacity block — commit or roll back, no partial gangs. SPREAD
        strategies and single bundles keep the legacy path, as does
        ``gang_scheduling_enabled=0`` (bit-for-bit the old behavior).
        """
        requests = [ResourceSet(b) for b in bundles]
        deadline = time.time() + timeout
        use_gang = (config().gang_scheduling_enabled
                    and strategy in ("PACK", "STRICT_PACK")
                    and len(requests) > 1)
        t0 = time.monotonic()
        pushes: List[tuple] = []
        with self._lock:
            while True:
                if pg_id in self._pg_tombstones:
                    # Removed while we waited: commit would leak.
                    self._pg_tombstones.discard(pg_id)
                    flightrec.record("pg", pg_id.hex()[:16],
                                     "gang.rollback (removed mid-create)"
                                     if use_gang else
                                     "rollback (removed mid-create)")
                    raise RuntimeError(
                        f"placement group {pg_id} was removed during "
                        "creation")
                if use_gang:
                    got = self._try_place_gang(pg_id, name, requests,
                                               strategy, gang_priority)
                    if got is not None:
                        pushes = got
                        break
                else:
                    placed = self._try_place_bundles(requests, strategy)
                    if placed is not None:
                        self._pg_seq += 1
                        pg = _PlacementGroup(
                            pg_id, name, strategy,
                            [_Bundle(r, n) for r, n in zip(requests, placed)],
                            gang_priority=gang_priority, seq=self._pg_seq)
                        self._pgs[pg_id] = pg
                        break
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"cannot place bundles {bundles} ({strategy})")
                self._sched_cv.wait(timeout=min(remaining, 1.0))
        # Push the gang's pinned blocks to their daemons OUTSIDE the lock
        # (best-effort, like the batch-lease adopt push: a lost push only
        # loses daemon-side observability, the GCS accounting is already
        # committed).
        for addr, block_id, shape, total in pushes:
            try:
                self._daemons.get(addr).notify(
                    "adopt_capacity_block", block_id, shape, total, True)
            except Exception:  # noqa: BLE001 — GCS accounting already holds
                log_swallowed(logger, "gang block adopt push")
        from ray_tpu_torch.core.metrics_export import (gang_placement_hist,
                                                 metrics_enabled)
        if metrics_enabled():
            gang_placement_hist().observe(
                time.monotonic() - t0,
                {"path": "gang" if use_gang else "2pc"})
        return True

    def _try_place_gang(self, pg_id, name, requests: List[ResourceSet],
                        strategy: str, gang_priority: int):
        """One atomic gang attempt; caller holds self._lock. Returns the
        daemon adopt-push list on commit, None when the gang doesn't fit
        anywhere (nothing allocated)."""
        topo = config().topology_labels != "off"
        assignment = self.scheduler.plan_gang(
            requests, topology_aware=topo,
            strict_slice=(strategy == "STRICT_PACK" and topo))
        if assignment is None:
            return None
        nodeset = sorted({n.hex()[:8] for n in assignment})
        flightrec.record("pg", pg_id.hex()[:16],
                         f"gang.reserve n={len(requests)} "
                         f"nodes={','.join(nodeset)}")
        # Reserve every bundle; all-or-nothing (the plan worked over a
        # snapshot, so a concurrent grant can still race us — roll back and
        # let the retry loop replan).
        placed: List[tuple] = []
        for req, node_id in zip(requests, assignment):
            if not self.scheduler.try_allocate(node_id, req):
                for n, r in placed:
                    self.scheduler.release(n, r)
                flightrec.record("pg", pg_id.hex()[:16],
                                 "gang.rollback (lost allocation race)")
                return None
            placed.append((node_id, req))
        # The reservation currency: one pinned revocable cap-N block per
        # (node, bundle shape) — the unit preemption revokes.
        groups: Dict[tuple, list] = {}
        for req, node_id in zip(requests, assignment):
            key = (node_id, tuple(sorted(req._fixed.items())))
            if key in groups:
                groups[key][1] += 1
            else:
                groups[key] = [req, 1]
        pushes: List[tuple] = []
        for (node_id, _shape_key), (req, count) in groups.items():
            self._next_block += 1
            block_id = f"cap-{self._block_epoch}-{self._next_block}"
            self._blocks[block_id] = _CapacityBlock(
                block_id, node_id, req, count, pg_id=pg_id)
            addr = self._node_addr.get(node_id)
            if addr:
                pushes.append((addr, block_id, req.to_dict(), count))
        self._pg_seq += 1
        pg = _PlacementGroup(
            pg_id, name, strategy,
            [_Bundle(r, n) for r, n in zip(requests, assignment)],
            gang_priority=gang_priority, seq=self._pg_seq)
        self._pgs[pg_id] = pg
        flightrec.record("pg", pg_id.hex()[:16],
                         f"gang.commit blocks={len(groups)} "
                         f"prio={gang_priority} nodes={','.join(nodeset)}")
        return pushes

    def _gang_blocks_locked(self, pg_id) -> List[_CapacityBlock]:
        return [b for b in self._blocks.values() if b.pg_id == pg_id]

    def _drop_gang_blocks_locked(self, pg_id) -> List[Tuple[str, str]]:
        """Forget a gang's blocks WITHOUT releasing resources (the bundle
        accounting owns the units); returns (block_id, daemon addr) revoke
        targets for the caller to notify outside the lock."""
        revokes: List[Tuple[str, str]] = []
        for block in self._gang_blocks_locked(pg_id):
            self._blocks.pop(block.block_id, None)
            addr = self._node_addr.get(block.node_id)
            if addr:
                revokes.append((block.block_id, addr))
        return revokes

    def _notify_revokes(self, revokes: List[Tuple[str, str]],
                        why: str) -> None:
        for block_id, addr in revokes:
            flightrec.record("lease", block_id, f"revoke ({why})")
            try:
                self._daemons.get(addr).notify("revoke_capacity_block",
                                               block_id)
            except Exception:  # noqa: BLE001 — daemon death has its own path
                log_swallowed(logger, "gang block revoke push")

    def preempt_gangs(self, resources: Dict[str, float], count: int = 1,
                      min_priority: int = 0) -> int:
        """Revoke lower-class gangs until ``count`` units of ``resources``
        could be placed (the serve-autoscaling SLO-pressure path, riding
        the capacity-block revocation plumbing). Victims: strictly lower
        ``gang_priority`` than ``min_priority``, lowest class first, newest
        first within a class (least sunk work). Returns gangs preempted;
        0 when capacity already suffices or preemption is disabled."""
        if not config().gang_preemption_enabled:
            return 0
        request = ResourceSet(resources)
        count = max(1, int(count))
        preempted: List[_PlacementGroup] = []
        revokes: List[Tuple[str, str]] = []
        with self._lock:
            def can_fit_all() -> bool:
                # Tentatively allocate all units, then roll back — the only
                # exact cumulative-fit check.
                got: List[NodeID] = []
                for _ in range(count):
                    nid = self.scheduler.best_node(request)
                    if nid is None or not self.scheduler.try_allocate(
                            nid, request):
                        break
                    got.append(nid)
                for nid in got:
                    self.scheduler.release(nid, request)
                return len(got) >= count

            if can_fit_all():
                return 0
            victims = sorted(
                (pg for pg in self._pgs.values()
                 if pg.state in ("CREATED", "RESCHEDULING")
                 and pg.gang_priority < min_priority),
                key=lambda pg: (pg.gang_priority, -pg.seq))
            for pg in victims:
                pg.state = "PREEMPTED"
                for b in pg.bundles:
                    # Dead-node bundles of RESCHEDULING victims are already
                    # off the books; release() no-ops for unknown nodes.
                    self.scheduler.release(b.node_id, b.resources)
                    b.in_use = ResourceSet()
                revokes.extend(self._drop_gang_blocks_locked(pg.pg_id))
                preempted.append(pg)
                flightrec.record(
                    "pg", pg.pg_id.hex()[:16],
                    f"gang.preempt prio={pg.gang_priority} "
                    f"nodes={','.join(sorted({b.node_id.hex()[:8] for b in pg.bundles}))}")
                if can_fit_all():
                    break
            if preempted:
                self._wake_shapes_locked()
        self._notify_revokes(revokes, "preempt")
        if preempted:
            from ray_tpu_torch.core.metrics_export import (gang_preemptions_total,
                                                     metrics_enabled)
            if metrics_enabled():
                gang_preemptions_total().inc(len(preempted))
            logger.warning(
                "preempted %d gang(s) below priority %d for %s x%d",
                len(preempted), min_priority, resources, count)
        return len(preempted)

    def _try_place_bundles(self, requests: List[ResourceSet], strategy: str):
        # Tentatively allocate; roll back on any failure (the 2PC outcome).
        placed: List[NodeID] = []
        nodes = self.scheduler.nodes()
        try:
            if strategy in ("STRICT_PACK", "PACK"):
                for node_id in sorted(nodes, key=lambda n: nodes[n].critical_utilization()):
                    trial: List[NodeID] = []
                    ok = True
                    for req in requests:
                        if self.scheduler.try_allocate(node_id, req):
                            trial.append(node_id)
                        else:
                            ok = False
                            break
                    if ok:
                        return trial
                    for node, req in zip(trial, requests):
                        self.scheduler.release(node, req)
                if strategy == "STRICT_PACK":
                    return None
            used: set = set()
            for req in requests:
                candidates = sorted(
                    nodes, key=lambda n: (n in used, nodes[n].critical_utilization())
                )
                chosen = None
                for node_id in candidates:
                    if strategy == "STRICT_SPREAD" and node_id in used:
                        continue
                    if self.scheduler.try_allocate(node_id, req):
                        chosen = node_id
                        break
                if chosen is None:
                    raise LookupError
                placed.append(chosen)
                used.add(chosen)
            return placed
        except LookupError:
            for node, req in zip(placed, requests):
                self.scheduler.release(node, req)
            return None

    def _reschedule_placement_groups(self) -> None:
        """Re-place the dead-node bundles of RESCHEDULING groups.

        The reference's GCS does the same after node failure
        (``gcs_placement_group_manager`` re-queues damaged groups). Bundles
        on surviving nodes keep their reservation; only lost bundles get a
        fresh node. A group that can't fit yet stays RESCHEDULING and is
        retried on the next membership change.
        """
        with self._lock:
            for pg in self._pgs.values():
                if pg.state != "RESCHEDULING":
                    continue
                lost = [b for b in pg.bundles
                        if b.node_id not in self._node_addr]
                placed = []
                ok = True
                for b in lost:
                    node_id = self.scheduler.best_node(b.resources)
                    if node_id is None or not self.scheduler.try_allocate(
                            node_id, b.resources):
                        ok = False
                        break
                    placed.append((b, node_id))
                if not ok:
                    for b, node_id in placed:
                        self.scheduler.release(node_id, b.resources)
                    continue
                for b, node_id in placed:
                    b.node_id = node_id
                    b.in_use = ResourceSet()  # leases on it died with the node
                pg.state = "CREATED"
                logger.info("placement group %s re-placed after node death",
                            pg.pg_id.hex()[:8])
            self._sched_cv.notify_all()

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            pg = self._pgs.pop(pg_id, None)
            if pg is None:
                # Creation may still be mid-wait (2PC retry in flight):
                # tombstone the id so that create rolls back instead of
                # committing a reservation nobody will ever release.
                self._pg_tombstones.add(pg_id)
                return
            revokes = self._drop_gang_blocks_locked(pg_id)
            if pg.state != "PREEMPTED":
                # Preemption already released the bundle reservations.
                for b in pg.bundles:
                    self.scheduler.release(b.node_id, b.resources)
            self._wake_shapes_locked()
        self._notify_revokes(revokes, "pg remove")

    def get_placement_group(self, pg_id: PlacementGroupID) -> Optional[dict]:
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None:
                return None
            return {"pg_id": pg.pg_id, "name": pg.name, "state": pg.state,
                    "strategy": pg.strategy,
                    "bundles": [
                        {"resources": b.resources.to_dict(), "node_id": b.node_id}
                        for b in pg.bundles
                    ]}

    # ====================== actors ======================

    def create_actor(self, spec_bytes: bytes) -> ActorID:
        """Register + schedule an actor (gcs_actor_manager.cc:255,280)."""
        from ray_tpu_torch.core import serialization

        spec = serialization.loads_deferred(spec_bytes)
        actor_id = ActorID.of(spec.job_id)
        self._create_actor_with_id(actor_id, spec_bytes)
        return actor_id

    def _schedule_actor(self, actor_id: ActorID) -> None:
        from ray_tpu_torch.core import serialization

        with self._lock:
            spec_bytes = self._actor_specs.get(actor_id)
            info = self.store.get_actor(actor_id)
        if spec_bytes is None or info is None or info.state == "DEAD":
            return
        spec = serialization.loads_deferred(spec_bytes)
        name = actor_id.hex()[:8]
        t0 = time.monotonic()
        logger.debug("actor %s: lease for %s", name, spec.options.resources)
        try:
            lease_id, node_id, node_addr = self.request_lease(
                spec.options.resources, spec.options.scheduling_strategy,
                timeout=300.0,
            )
        except (TimeoutError, Exception) as e:  # noqa: BLE001
            self._mark_actor_dead(actor_id, f"actor scheduling failed: {e}")
            return
        waited = time.monotonic() - t0
        (logger.warning if waited > _SLOW_SCHEDULING_S else logger.debug)(
            "actor %s: lease %s on node %s after %.2f s", name, lease_id,
            node_id.hex()[:8], waited)
        # Killed while its lease waited (the port's repair; JAX's GCS builds
        # it anyway and keeps the lease): give the lease back, build nothing.
        if self._actor_killed(actor_id):
            self.release_lease(lease_id)
            return
        t1 = time.monotonic()
        try:
            worker_addr = self._daemons.get(node_addr).call(
                "start_actor", spec_bytes, lease_id, timeout=120.0
            )
        except Exception as e:  # noqa: BLE001
            self.release_lease(lease_id)
            logger.warning("actor %s: start_actor on %s failed after %.2f s: "
                           "%s", name, node_addr, time.monotonic() - t1, e)
            # Node likely died mid-creation; retry via the failure path.
            self._on_actor_failure(actor_id, f"creation on {node_addr} failed: {e}")
            return
        built = time.monotonic() - t1
        (logger.warning if built > _SLOW_SCHEDULING_S else logger.debug)(
            "actor %s: started in %s after %.2f s", name, worker_addr, built)
        with self._lock:
            killed = self._actor_killed(actor_id)
            if not killed:
                self.store.update_actor_state(
                    actor_id, "ALIVE", node_id=node_id,
                    num_restarts=info.num_restarts)
                self._actor_addr[actor_id] = worker_addr
                self._actor_leases[actor_id] = lease_id
                self._actor_cv.notify_all()
        if killed:
            # Killed while its worker built it: stop that worker too.
            try:
                self._daemons.get(node_addr).call(
                    "kill_actor_worker", actor_id, True, timeout=10.0)
            except Exception:  # noqa: BLE001 — the daemon reaper covers it
                log_swallowed(logger, "kill of an actor killed while starting")
            self.release_lease(lease_id)
            return
        self._publish("actor", ("ALIVE", actor_id.hex(), worker_addr))

    def _actor_killed(self, actor_id: ActorID) -> bool:
        with self._lock:
            info = self.store.get_actor(actor_id)
            return info is None or info.state == "DEAD"

    def report_actor_failure(self, actor_id: ActorID, cause: str) -> None:
        """Called by node daemons when an actor's worker process dies."""
        self._on_actor_failure(actor_id, cause)

    def _on_actor_failure(self, actor_id: ActorID, cause: str) -> None:
        with self._lock:
            info = self.store.get_actor(actor_id)
            if info is None or info.state == "DEAD":
                return
            self._actor_addr.pop(actor_id, None)
            lease = self._actor_leases.pop(actor_id, None)
        if lease is not None:
            self.release_lease(lease)
        with self._lock:
            can_restart = (info.max_restarts == -1
                           or info.num_restarts < info.max_restarts)
            if can_restart:
                info.num_restarts += 1
                self.store.update_actor_state(actor_id, "RESTARTING",
                                              death_cause=cause)
            else:
                self._mark_actor_dead_locked(actor_id, cause)
                return
        logger.info("actor %s failed (%s): restarting (%d)",
                    actor_id.hex()[:8], cause, info.num_restarts)
        self._publish("actor", ("RESTARTING", actor_id.hex(), cause))
        threading.Thread(
            target=self._schedule_actor, args=(actor_id,), daemon=True
        ).start()

    def _mark_actor_dead(self, actor_id: ActorID, cause: str) -> None:
        with self._lock:
            self._mark_actor_dead_locked(actor_id, cause)

    def _mark_actor_dead_locked(self, actor_id: ActorID, cause: str) -> None:
        self.store.update_actor_state(actor_id, "DEAD", death_cause=cause)
        self._actor_addr.pop(actor_id, None)
        self._actor_specs.pop(actor_id, None)
        lease = self._actor_leases.pop(actor_id, None)
        if lease is not None:
            self.release_lease(lease)  # RLock: safe under self._lock
        self._actor_cv.notify_all()
        self._publish("actor", ("DEAD", actor_id.hex(), cause))

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        with self._lock:
            info = self.store.get_actor(actor_id)
            if info is None:
                return
            addr = self._actor_addr.get(actor_id)
            node = self._node_addr.get(info.node_id) if info.node_id else None
            if no_restart:
                info.max_restarts = info.num_restarts  # exhaust the ladder
        if node is not None and addr is not None:
            try:
                self._daemons.get(node).call("kill_actor_worker", actor_id,
                                             no_restart, timeout=10.0)
            except Exception:  # noqa: BLE001 — death report arrives via daemon reaper
                logger.info("kill_actor: daemon unreachable for %s", actor_id.hex()[:8])
        if no_restart:
            self._mark_actor_dead(actor_id, "killed via kill_actor")

    def get_actor_info(self, actor_id: ActorID) -> Optional[dict]:
        with self._lock:
            info = self.store.get_actor(actor_id)
            if info is None:
                return None
            return {"actor_id": actor_id, "state": info.state,
                    "name": info.name, "class_name": info.class_name,
                    "node_id": info.node_id,
                    "address": self._actor_addr.get(actor_id),
                    "num_restarts": info.num_restarts,
                    "death_cause": info.death_cause}

    def wait_actor_alive(self, actor_id: ActorID, timeout: float = 60.0) -> dict:
        """Block until the actor is ALIVE (returns info) or DEAD (raises)."""
        deadline = time.time() + timeout
        with self._lock:
            while True:
                info = self.store.get_actor(actor_id)
                if info is None:
                    raise ValueError(f"unknown actor {actor_id.hex()}")
                if info.state == "ALIVE" and actor_id in self._actor_addr:
                    return {"actor_id": actor_id, "state": "ALIVE",
                            "address": self._actor_addr[actor_id],
                            "num_restarts": info.num_restarts}
                if info.state == "DEAD":
                    raise RuntimeError(
                        f"actor {actor_id.hex()[:8]} is dead: {info.death_cause}"
                    )
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"actor {actor_id.hex()[:8]} not alive "
                                       f"after {timeout}s (state={info.state})")
                self._actor_cv.wait(timeout=min(remaining, 1.0))

    def get_named_actor(self, name: str, namespace: str = "default"):
        return self.store.get_named_actor(name, namespace)

    def list_named_actors(self, namespace=None):
        return self.store.list_named_actors(namespace)

    # ====================== object directory ======================

    @staticmethod
    def _task_key(object_id: bytes) -> bytes:
        return object_id[:24]  # ObjectID = TaskID(24) + return index (4)

    # Channel name for object-location push notifications (rides the same
    # long-poll pubsub as node/actor/log events). Every seal publishes
    # (oid, node_id, node_addr, size) so waiters blocked in get() wake on
    # seal instead of polling locate_object (the reference's
    # ownership-based directory sends the same location-update pushes).
    _OBJ_LOC_CHANNEL = "object_locations"

    def add_object_location(self, object_id: bytes, node_id: NodeID,
                            size: int, lineage: bytes | None = None) -> None:
        # Sharded fast path: the directory write takes only the owning
        # shard's lock — a location storm never touches self._lock.
        # _node_addr reads are GIL-atomic dict gets on a rarely-mutated
        # table (membership changes), safe without the scheduling lock.
        self._directory.add_location(object_id, node_id, size,
                                     lineage=lineage)
        addr = self._node_addr.get(node_id)
        self._publish(self._OBJ_LOC_CHANNEL,
                      (object_id, node_id, addr, size))

    def add_lineage(self, object_id: bytes, lineage: bytes) -> None:
        """Register a task's lineage WITHOUT a location row — inline-small
        returns have no sealed replica, but their (possibly large) sibling
        returns still need the creating TaskSpec for reconstruction."""
        self._directory.add_lineage(object_id, lineage)

    def remove_object_location(self, object_id: bytes, node_id: NodeID) -> None:
        self._directory.remove_location(object_id, node_id)

    def locate_object(self, object_id: bytes) -> List[Tuple[NodeID, str, int]]:
        """[(node_id, node_address, size)] for every live replica."""
        out = []
        for node_id, size in self._directory.locations(object_id).items():
            addr = self._node_addr.get(node_id)
            if addr is not None:
                out.append((node_id, addr, size))
        return out

    def locate_object_batch(
            self, object_ids: List[bytes]
    ) -> List[List[Tuple[NodeID, str, int]]]:
        """Batched :meth:`locate_object`: one RPC resolves every ref of a
        get([refs]) call instead of one round trip per miss."""
        return [self.locate_object(oid) for oid in object_ids]

    def subscribe_object_locations(self, cursor: Optional[int],
                                   timeout: float = 30.0,
                                   oids: Optional[List[bytes]] = None):
        """Long-poll the object-location channel from ``cursor``; returns
        ``(next_cursor, [(oid, node_id, addr, size), ...])``.

        ``cursor=None`` tails from NOW: returns the current end cursor with
        no messages (subscribers use it to start, and to resync after a GCS
        restart without replaying the retained log).

        ``oids`` is the server-side subscription filter: only seals of those
        object ids are returned (the cursor still advances past misses), and
        the poll parks on PER-OID wait lists — a seal of an unrelated object
        neither wakes this handler nor ships it a message (the reference's
        per-key pubsub index, ``src/ray/pubsub/publisher.h``). ``None``
        preserves the unfiltered firehose."""
        channel = self._OBJ_LOC_CHANNEL
        if cursor is None:
            return self._pubsub.end_cursor(channel), []
        if oids is None:
            return self._pubsub.poll(channel, cursor, timeout)
        return self._pubsub.poll_filtered(channel, cursor, oids, timeout)

    def get_lineage(self, object_id: bytes) -> Optional[bytes]:
        return self._directory.get_lineage(object_id)

    def free_object(self, object_id: bytes) -> None:
        locs = self._directory.pop_object(object_id)
        targets = [(n, self._node_addr.get(n)) for n in locs]
        for node_id, addr in targets:
            if addr is None:
                continue
            try:
                self._daemons.get(addr).notify("free_object", object_id)
            except RpcConnectionError:
                pass

    def free_objects(self, object_ids: List[bytes]) -> None:
        """Batched owner frees (one note per ~100 refs from the client's
        free batcher instead of one per dropped ref)."""
        for oid in object_ids:
            self.free_object(oid)

    # ====================== KV / functions / jobs ======================

    def kv_put(self, key, value, namespace="default", overwrite=True):
        return self.store.kv_put(key, value, namespace, overwrite)

    def kv_get(self, key, namespace="default"):
        return self.store.kv_get(key, namespace)

    def kv_del(self, key, namespace="default"):
        return self.store.kv_del(key, namespace)

    def kv_keys(self, prefix="", namespace="default"):
        return self.store.kv_keys(prefix, namespace)

    # KV-tier prefix directory (serve/kv_tier.py cluster index) — thin
    # delegation like the KV above; directory state rides kv_dump, so the
    # snapshot/restore path covers it with no extra handler.
    def prefix_publish(self, digest, meta, token_count, n_blocks, hint=""):
        return self.store.prefix_publish(digest, meta, token_count,
                                         n_blocks, hint)

    def prefix_match(self, digests):
        return self.store.prefix_match(digests)

    def prefix_release(self, digest):
        return self.store.prefix_release(digest)

    def prefix_drop(self, digest):
        return self.store.prefix_drop(digest)

    def prefix_sweep(self):
        return self.store.prefix_sweep()

    def prefix_stats(self):
        return self.store.prefix_stats()

    def export_function(self, function_id: str, payload: bytes) -> None:
        self.store.export_function(function_id, payload)

    def get_function(self, function_id: str):
        return self.store.get_function(function_id)

    def has_function(self, function_id: str) -> bool:
        return self.store.get_function(function_id) is not None

    def add_job(self, job_id: JobID, entrypoint: str = "", pid: int = 0,
                metadata: Optional[Dict[str, str]] = None) -> None:
        self.store.add_job(JobInfo(job_id=job_id, driver_pid=pid,
                                   entrypoint=entrypoint,
                                   metadata=dict(metadata or {})))

    def finish_job(self, job_id: JobID, status: str = "SUCCEEDED") -> None:
        self.store.finish_job(job_id, status)

    def list_jobs(self) -> List[JobInfo]:
        """The job table: drivers, and jobs submitted through
        ``job_submission`` (keyed by their submission id)."""
        with self.store._lock:
            return list(self.store.jobs.values())

    def next_job_id(self) -> JobID:
        return JobID.next()

    # ====================== task events / observability ======================

    def _ingest_apply(self, kind: str, args: tuple) -> None:
        """Drain-thread applier: the ONLY writer of observability tables
        when async ingest is on."""
        if kind == "event":
            self.store.record_task_event(args[0])
        elif kind == "events":
            self.store.record_task_events(args[0])
        elif kind == "metrics":
            self.store.report_metrics(*args)

    def _ingest_flush(self) -> None:
        """Read-your-writes barrier for observability READERS: staged
        reports are applied before the read (bounded wait — a reader never
        blocks long on a badly lagging ingest)."""
        if self._ingest is not None:
            self._ingest.flush(timeout=2.0)

    def record_task_event(self, event: dict) -> None:
        if self._ingest is not None:
            self._ingest.submit("event", (event,))
        else:
            self.store.record_task_event(event)

    def record_task_events(self, events: List[dict]) -> None:
        """Batched form — workers flush their task-event buffers here
        (task_event_buffer.cc → gcs_task_manager.cc)."""
        if self._ingest is not None:
            self._ingest.submit("events", (events,))
        else:
            self.store.record_task_events(events)

    def trace(self, trace_id: str) -> List[dict]:
        """Assembled per-trace event list (indexed lookup, no ring scan)."""
        self._ingest_flush()
        return self.store.trace(trace_id)

    def task_events(self) -> List[dict]:
        self._ingest_flush()
        return self.store.task_events()

    def task_events_since(self, cursor: Optional[int],
                          limit: int = 1000) -> Tuple[int, List[dict]]:
        """Cursor'd task-event read — dashboard/state pollers ship only the
        delta instead of copying the whole event log every 2s."""
        self._ingest_flush()
        return self.store.task_events_since(cursor, limit)

    # ====================== cluster metrics plane ======================

    def report_metrics(self, node_id: str, component: str, pid: int,
                       snapshot: List[dict]) -> None:
        """Per-process exporter reports land here (one coalescable notify
        per process per export interval — metrics_agent → GCS analog)."""
        if self._ingest is not None:
            self._ingest.submit("metrics", (node_id, component, pid, snapshot))
        else:
            self.store.report_metrics(node_id, component, pid, snapshot)

    def metrics_text(self) -> str:
        """Merged cluster-wide Prometheus exposition (dashboard /metrics)."""
        self._ingest_flush()
        return self.store.metrics_text()

    def metrics_summary(self) -> dict:
        """JSON rollup of the live series store (dashboard UI pane)."""
        self._ingest_flush()
        return self.store.metrics_summary()

    def metrics_histogram(self, name: str, tags: dict) -> Optional[dict]:
        """Cluster-merged cumulative histogram for one metric under a tag
        filter (the serve SLO loop's TTFT read path)."""
        self._ingest_flush()
        return self.store.metrics_histogram(name, tags)

    def ingest_stats(self) -> dict:
        """Staging-queue depth / drop counter (tests + dashboard)."""
        if self._ingest is None:
            return {"queued": 0, "dropped": 0, "submitted": 0, "drained": 0}
        return self._ingest.stats()

    def wake_stats(self) -> dict:
        """Shape-indexed wake filter counters (tests + dashboard)."""
        with self._lock:
            return dict(self._wake_stats)

    def _collect_gcs_metrics(self) -> None:
        """Control-plane gauges: scheduler queue depth + lease/node counts."""
        from ray_tpu_torch.core.metrics_export import counter, mirror_stats_gauge

        with self._demand_lock:
            pending = len(self._demand_list)
        with self._lock:
            st = {"pending_demands": pending,
                  "leases": len(self._leases),
                  "capacity_blocks": len(self._blocks),
                  "alive_nodes": len(self._node_addr)}
        if self._ingest is not None:
            ing = self._ingest.stats()
            st["ingest_queued"] = ing["queued"]
            st["ingest_dropped"] = ing["dropped"]
            # Surface loss, don't just count it: a monotonic counter the
            # dashboard/alerting can rate(), plus one warn line on the
            # first drop ever (silent loss is how observability gaps hide).
            delta = ing["dropped"] - self._ingest_dropped_last
            if delta > 0:
                self._ingest_dropped_last = ing["dropped"]
                counter("ray_tpu_ingest_dropped_total",
                        "Observability reports dropped by the GCS ingest "
                        "staging queue (overflow backpressure)").inc(delta)
                if not self._ingest_drop_warned:
                    self._ingest_drop_warned = True
                    logger.warning(
                        "observability ingest dropped %d report(s) — "
                        "staging queue overflow (gcs_ingest_queue_max=%d); "
                        "metrics/trace data is now lossy",
                        ing["dropped"], config().gcs_ingest_queue_max)
        mirror_stats_gauge(
            "ray_tpu_gcs_sched",
            "GCS scheduler state (pending demands, live leases, capacity "
            "blocks, alive nodes, ingest queue)", st)
        self._watchdog.export_gauge()

    # ====================== pubsub (long-poll) ======================

    def _publish(self, channel: str, message: Any) -> None:
        # Per-oid wait lists apply only to the object-location channel
        # (filtered subscribes); other channels wake their channel cond.
        loc_key = (bytes(message[0])
                   if channel == self._OBJ_LOC_CHANNEL else None)
        self._pubsub.publish(channel, message, loc_key=loc_key)

    def publish(self, channel: str, message: Any) -> None:
        self._publish(channel, message)

    def poll_channel(self, channel: str, cursor: int,
                     timeout: float = 30.0) -> Tuple[int, List[Any]]:
        """Long-poll: block until the channel log grows past ``cursor``.

        Reference: the long-poll publisher ``src/ray/pubsub/publisher.h:307``.
        Cursor is an absolute message count; truncation is tolerated (clients
        may miss messages after a very long disconnect, same as the
        reference's bounded pubsub buffers).
        """
        return self._pubsub.poll(channel, cursor, timeout)

    # ====================== persistence ======================

    def _snapshot(self) -> None:
        if not self._snapshot_path:
            return
        with self._lock:
            detached_specs = {
                aid.binary(): spec for aid, spec in self._actor_specs.items()
                if (self.store.get_actor(aid) or ActorInfo(aid)).detached
            }
            data = pickle.dumps({
                "kv": self.store.kv_dump(),
                "functions": self.store._functions,
                "jobs": self.store.jobs,
                "detached_actor_specs": detached_specs,
            })
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._snapshot_path)
        self._mirror_snapshot(data)

    def _mirror_snapshot(self, data: bytes) -> None:
        """Replicate the snapshot blob to up to ``gcs_snapshot_mirrors``
        alive node daemons — surviving head-node DISK loss, not just head
        process death (the role of the reference's external Redis store)."""
        n = config().gcs_snapshot_mirrors
        if n <= 0:
            return
        self._snapshot_seq += 1
        with self._lock:
            addrs = [addr for node_id, addr in self._node_addr.items()
                     if node_id not in self._dead_nodes][:n]
        for addr in addrs:
            try:
                self._daemons.get(addr).notify(
                    "store_gcs_snapshot", self._snapshot_seq, data)
            except Exception:  # noqa: BLE001 — mirror is best-effort
                log_swallowed(logger, "snapshot mirror push")

    def _restore_from_mirror(self, daemon_addr: str) -> None:
        from ray_tpu_torch.core.rpc import RpcClient

        try:
            client = RpcClient(daemon_addr)
            result = client.call("fetch_gcs_snapshot", timeout=30.0)
            client.close()
        except Exception:
            logger.exception("mirror restore from %s failed; starting fresh",
                             daemon_addr)
            return
        if not result:
            logger.warning("daemon %s holds no snapshot mirror", daemon_addr)
            return
        seq, blob = result
        self._snapshot_seq = int(seq)
        self._restore_snapshot_bytes(bytes(blob))
        logger.info("restored tables from mirror on %s (seq %d)",
                    daemon_addr, seq)

    def _restore_snapshot(self, path: str) -> None:
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except Exception:
            logger.exception("snapshot restore failed; starting fresh")
            return
        self._restore_snapshot_bytes(raw)

    def _restore_snapshot_bytes(self, raw: bytes) -> None:
        try:
            data = pickle.loads(raw)
        except Exception:
            logger.exception("snapshot restore failed; starting fresh")
            return
        kv = data.get("kv", {})
        # kv_load re-routes every key to the CURRENT shard count — the
        # snapshot format is shard-count-independent (merged namespaces),
        # so a restart may change gcs_shards freely.
        self.store.kv_load(kv)
        self.store._functions = data.get("functions", {})
        self.store.jobs = data.get("jobs", {})
        self._pending_detached = data.get("detached_actor_specs", {})
        logger.info("restored snapshot: %d kv namespaces, %d functions, "
                    "%d detached actors", len(kv),
                    len(self.store._functions),
                    len(getattr(self, "_pending_detached", {})))

    def _delayed_detached_recreate(self) -> None:
        time.sleep(config().health_check_period_s * 2)
        self.recreate_detached_actors()

    def recreate_detached_actors(self) -> int:
        """Resurrect detached actors from a restored snapshot.

        Actors a daemon re-adopted (still alive on a surviving node) are
        skipped; truly lost ones are rescheduled under their ORIGINAL actor
        id so user handles keep working (the reference keeps actor ids
        stable across GCS failover — actor table in Redis).
        """
        with self._lock:
            pending = getattr(self, "_pending_detached", None) or {}
            self._pending_detached = {}
            todo = []
            for aid_bytes, spec_bytes in pending.items():
                actor_id = ActorID(aid_bytes)
                if self.store.get_actor(actor_id) is not None:
                    continue  # re-adopted by its daemon
                todo.append((actor_id, spec_bytes))
        count = 0
        for actor_id, spec_bytes in todo:
            try:
                self._create_actor_with_id(actor_id, spec_bytes)
                count += 1
            except Exception:
                logger.exception("detached actor re-create failed")
        if count:
            logger.info("resurrected %d detached actors", count)
        return count

    def _create_actor_with_id(self, actor_id: ActorID, spec_bytes: bytes) -> None:
        from ray_tpu_torch.core import serialization

        spec = serialization.loads_deferred(spec_bytes)
        spec.actor_id = actor_id
        info = ActorInfo(
            actor_id=actor_id,
            name=spec.options.name or "",
            namespace=spec.options.namespace or "default",
            class_name=spec.function_name,
            max_restarts=spec.options.max_restarts,
            detached=spec.options.lifetime == "detached",
        )
        with self._lock:
            self.store.register_actor(info)
            self._actor_specs[actor_id] = serialization.dumps(spec)
        threading.Thread(
            target=self._schedule_actor, args=(actor_id,),
            name=f"gcs-actor-{actor_id.hex()[:8]}", daemon=True,
        ).start()

    def _snapshot_loop(self) -> None:
        while not self._stopped.wait(5.0):
            try:
                self._snapshot()
            except Exception:
                logger.exception("snapshot failed")

    # ====================== lifecycle ======================

    def ping(self) -> str:
        return "pong"

    def snapshot_now(self) -> bool:
        """Force a synchronous table snapshot (tests / graceful shutdown)."""
        self._snapshot()
        return True

    def shutdown(self) -> None:
        self._stopped.set()
        self._metrics_exporter.stop()
        if self._ingest is not None:
            self._ingest.stop()
        try:
            self._snapshot()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            log_swallowed(logger, "final snapshot at shutdown")


def serve(port: int = 0, host: str = "127.0.0.1",
          snapshot_path: str | None = None,
          restore_from: str | None = None) -> Tuple[GcsService, RpcServer]:
    service = GcsService(snapshot_path=snapshot_path,
                         restore_from=restore_from)
    server = RpcServer(service, host=host, port=port, max_workers=128,
                       name="gcs")
    return service, server


def main(argv=None) -> int:
    from ray_tpu_torch.devtools.lockcheck import maybe_install

    maybe_install()  # lock_order_check_enabled: instrument before any locks
    from ray_tpu_torch.devtools.leakcheck import maybe_install as _leak_install

    _leak_install()  # leak_check_enabled: stamp allocation sites early
    # SIGUSR1 → all-thread stack dump, same live-hang debug aid the worker
    # and node-daemon entry points install.
    import faulthandler

    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)
    except (AttributeError, ValueError):  # non-main thread / platform
        pass
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--snapshot", default=None)
    parser.add_argument("--restore-from", default=None,
                        help="daemon address holding a snapshot mirror "
                             "(head-disk-loss recovery)")
    args = parser.parse_args(argv)
    set_config(Config())
    flightrec.init("gcs")
    global _DUMP_STALL_STACKS
    _DUMP_STALL_STACKS = True   # its own process: late ticks dump its stacks
    service, server = serve(args.port, args.host, args.snapshot,
                            args.restore_from)
    print(f"GCS_ADDRESS={server.address}", flush=True)

    stop = threading.Event()

    def _flush_tails():
        # Orderly deaths lose zero buffered observability: drain the
        # ingest staging queue and detach the flight-recorder ring
        # (SIGKILL is what the mmap'd ring itself is for).
        service.shutdown()
        flightrec.close()

    import atexit

    atexit.register(_flush_tails)

    def handle(sig, frame):
        _flush_tails()
        stop.set()

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)
    while not stop.wait(timeout=60.0):
        pass  # timed slices: signal handlers still interrupt immediately
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
