"""GCS — Global Control Store: cluster-wide metadata and pubsub.

Analog of the reference's GCS server (``src/ray/gcs/gcs_server/`` — actor
table ``gcs_actor_manager.cc``, node table ``gcs_node_manager.cc``, job table
``gcs_job_manager.cc``, internal KV ``gcs_kv_manager.cc``, function store
``gcs_function_manager.h``, pubsub ``pubsub_handler.cc``). This is the
in-process implementation used by the single-process runtime; the table API is
transport-agnostic so the multiprocess runtime serves the same tables over
socket RPC (see ray_tpu.core.rpc / ray_tpu.core.gcs_server in the JAX
package).

The port's copy of ``ray_tpu/core/gcs.py``, the in-process half, with the
KV tier's prefix directory (``prefix_*``); the socket-served tables are
``core/gcs_server.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, JobID, NodeID
from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.core.gcs_shards import shard_index  # noqa: F401 — re-exported
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("gcs")


@dataclass
class NodeInfo:
    node_id: NodeID
    address: str
    resources: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    start_time: float = field(default_factory=time.time)


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: str = ""
    namespace: str = "default"
    class_name: str = ""
    state: str = "PENDING"  # PENDING | ALIVE | RESTARTING | DEAD
    node_id: Optional[NodeID] = None
    max_restarts: int = 0
    num_restarts: int = 0
    detached: bool = False
    death_cause: str = ""


@dataclass
class JobInfo:
    job_id: JobID
    driver_pid: int = 0
    start_time: float = field(default_factory=time.time)
    end_time: float = 0.0
    status: str = "RUNNING"
    entrypoint: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)


class PubSub:
    """Channelized publish/subscribe (reference: ``src/ray/pubsub/`` long-poll
    publisher; channels enumerated in ``pubsub.proto``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: Dict[str, List[Callable[[Any], None]]] = {}

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> Callable[[], None]:
        with self._lock:
            self._subs.setdefault(channel, []).append(callback)

        def unsubscribe():
            with self._lock:
                try:
                    self._subs[channel].remove(callback)
                except (KeyError, ValueError):
                    pass

        return unsubscribe

    def publish(self, channel: str, message: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(channel, []))
        for cb in subs:
            try:
                cb(message)
            except Exception:
                logger.exception("pubsub callback failed on channel %s", channel)


class GlobalControlStore:
    """All cluster metadata tables behind one lock-protected facade."""

    def __init__(self):
        self._lock = threading.RLock()
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self.jobs: Dict[JobID, JobInfo] = {}
        # Internal KV, hash-partitioned by (namespace, key) across
        # gcs_shards independent lock domains so KV churn (function
        # exports, serve controller state) stops contending with the table
        # lock. gcs_shards=1 keeps one shard — identical to the old single
        # dict under one lock.
        from ray_tpu_torch.core.config import config as _config

        n_shards = max(1, int(_config().gcs_shards))
        self._kv_route = lambda ns, key: shard_index(
            f"{ns}\x00{key}", n_shards)
        self._kv_shards: List[Dict[str, Dict[str, bytes]]] = [
            {} for _ in range(n_shards)]
        self._kv_locks = [threading.Lock() for _ in range(n_shards)]
        self._functions: Dict[str, Any] = {}
        self.pubsub = PubSub()
        self._task_events: List[dict] = []
        # Absolute index of _task_events[0] (events truncated off the front
        # advance it) — the cursor space of task_events_since.
        self._task_event_base = 0
        # Bounded trace_id -> [absolute event index] side table: per-trace
        # retrieval (trace()) assembles one trace without scanning the
        # 100k-event ring. Insertion-ordered; oldest traces evict first
        # when over trace_max_traces.
        from collections import OrderedDict

        self._trace_index: "OrderedDict[str, List[int]]" = OrderedDict()
        # Cluster metrics plane: per-(node, component, pid) series store fed
        # by every process's exporter (metrics_agent → gcs analog).
        from ray_tpu_torch.util.metrics import MetricsAggregator

        self.metrics = MetricsAggregator()
        # Cluster KV-tier prefix directory: chain digest -> spilled-object
        # locator, sharded like the KV. Bounds come from config at
        # construction; the serve tier re-reads them per publish so env
        # overrides in tests apply without a GCS restart.
        from ray_tpu_torch.core.gcs_shards import ShardedPrefixDirectory

        try:
            dir_max = int(_config().kv_tier_dir_max_entries)
            dir_ttl = float(_config().kv_tier_dir_ttl_s)
        except Exception:  # noqa: BLE001 — config unavailable mid-teardown
            dir_max, dir_ttl = 4096, 600.0
        self.prefix_dir = ShardedPrefixDirectory(
            n_shards, max_entries=dir_max, ttl_s=dir_ttl)

    # -- nodes (gcs_node_manager.cc) -----------------------------------------

    def register_node(self, info: NodeInfo) -> None:
        with self._lock:
            self.nodes[info.node_id] = info
        self.pubsub.publish("node", ("ALIVE", info))

    def mark_node_dead(self, node_id: NodeID) -> None:
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or not info.alive:
                return
            info.alive = False
        self.pubsub.publish("node", ("DEAD", info))

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self.nodes.values() if n.alive]

    def cluster_resources(self) -> Dict[str, float]:
        total = ResourceSet()
        for n in self.alive_nodes():
            total = total + ResourceSet(n.resources)
        return total.to_dict()

    # -- actors (gcs_actor_manager.cc:255,280,515) ---------------------------

    def register_actor(self, info: ActorInfo) -> None:
        with self._lock:
            if info.name:
                key = (info.namespace, info.name)
                existing = self._named_actors.get(key)
                if existing is not None:
                    existing_info = self.actors.get(existing)
                    if existing_info is not None and existing_info.state != "DEAD":
                        raise ValueError(
                            f"actor name '{info.name}' already taken in "
                            f"namespace '{info.namespace}'"
                        )
                self._named_actors[key] = info.actor_id
            self.actors[info.actor_id] = info

    def update_actor_state(self, actor_id: ActorID, state: str, **fields) -> None:
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None:
                return
            info.state = state
            for k, v in fields.items():
                setattr(info, k, v)
        self.pubsub.publish("actor", (state, actor_id))

    def get_actor(self, actor_id: ActorID) -> Optional[ActorInfo]:
        with self._lock:
            return self.actors.get(actor_id)

    def get_named_actor(self, name: str, namespace: str = "default") -> Optional[ActorID]:
        with self._lock:
            aid = self._named_actors.get((namespace, name))
            if aid is None:
                return None
            info = self.actors.get(aid)
            if info is None or info.state == "DEAD":
                return None
            return aid

    def list_named_actors(self, namespace: str | None = None) -> List[Tuple[str, str]]:
        with self._lock:
            out = []
            for (ns, name), aid in self._named_actors.items():
                info = self.actors.get(aid)
                if info is not None and info.state != "DEAD":
                    if namespace is None or ns == namespace:
                        out.append((ns, name))
            return out

    # -- jobs (gcs_job_manager.cc) -------------------------------------------

    def add_job(self, info: JobInfo) -> None:
        with self._lock:
            self.jobs[info.job_id] = info

    def finish_job(self, job_id: JobID, status: str = "SUCCEEDED") -> None:
        with self._lock:
            info = self.jobs.get(job_id)
            if info:
                info.status = status
                info.end_time = time.time()

    # -- internal KV (gcs_kv_manager.cc, store_client_kv.cc) -----------------

    def kv_put(self, key: str, value: bytes, namespace: str = "default", overwrite: bool = True) -> bool:
        i = self._kv_route(namespace, key)
        with self._kv_locks[i]:
            ns = self._kv_shards[i].setdefault(namespace, {})
            if not overwrite and key in ns:
                return False
            ns[key] = value
            return True

    def kv_get(self, key: str, namespace: str = "default") -> Optional[bytes]:
        i = self._kv_route(namespace, key)
        with self._kv_locks[i]:
            return self._kv_shards[i].get(namespace, {}).get(key)

    def kv_del(self, key: str, namespace: str = "default") -> bool:
        i = self._kv_route(namespace, key)
        with self._kv_locks[i]:
            return self._kv_shards[i].get(namespace, {}).pop(key, None) is not None

    def kv_keys(self, prefix: str = "", namespace: str = "default") -> List[str]:
        out: List[str] = []
        for i, shard in enumerate(self._kv_shards):
            with self._kv_locks[i]:
                out.extend(k for k in shard.get(namespace, {})
                           if k.startswith(prefix))
        return out

    # Reserved kv_dump namespace carrying the prefix directory through the
    # GCS snapshot path (never stored in the KV shards themselves).
    _PREFIX_DIR_NS = "__kv_tier_prefix_dir__"

    def kv_dump(self) -> Dict[str, Dict[str, bytes]]:
        """Merged ``{namespace: {key: value}}`` view across every shard —
        the (shard-count-independent) snapshot format. The KV-tier prefix
        directory rides along under a reserved namespace so GCS snapshot /
        restore round-trips it for free."""
        merged: Dict[str, Dict[str, bytes]] = {}
        for i, shard in enumerate(self._kv_shards):
            with self._kv_locks[i]:
                for ns, kv in shard.items():
                    merged.setdefault(ns, {}).update(kv)
        dir_dump = self.prefix_dir.dump()
        if dir_dump:
            import pickle

            merged[self._PREFIX_DIR_NS] = {"directory": pickle.dumps(dir_dump)}
        return merged

    def kv_load(self, data: Dict[str, Dict[str, bytes]]) -> None:
        """Restore a :meth:`kv_dump` blob, re-routing every key to the
        CURRENT shard count (a restart may change ``gcs_shards``)."""
        for shard, lock in zip(self._kv_shards, self._kv_locks):
            with lock:
                shard.clear()
        data = dict(data or {})
        dir_blob = data.pop(self._PREFIX_DIR_NS, None)
        if dir_blob is not None and "directory" in dir_blob:
            import pickle

            try:
                self.prefix_dir.load(pickle.loads(dir_blob["directory"]))
            except Exception:  # noqa: BLE001 — a torn snapshot must not
                logger.exception("prefix directory restore failed")  # block KV
        else:
            self.prefix_dir.load({})
        for ns, kv in data.items():
            for key, value in kv.items():
                self.kv_put(key, value, namespace=ns)

    def kv_shard_count(self) -> int:
        return len(self._kv_shards)

    # -- KV-tier prefix directory (serve/kv_tier.py index) -------------------

    def prefix_publish(self, digest: bytes, meta: bytes, token_count: int,
                       n_blocks: int, hint: str = "") -> bool:
        self._prefix_apply_bounds()
        return self.prefix_dir.publish(digest, meta, token_count, n_blocks,
                                       hint=hint)

    def prefix_match(self, digests: List[bytes]):
        return self.prefix_dir.match(list(digests))

    def prefix_release(self, digest: bytes) -> bool:
        return self.prefix_dir.release(digest)

    def prefix_drop(self, digest: bytes) -> bool:
        return self.prefix_dir.drop(digest)

    def prefix_sweep(self) -> int:
        self._prefix_apply_bounds()
        return self.prefix_dir.sweep()

    def prefix_stats(self) -> Dict[str, int]:
        return self.prefix_dir.stats()

    def _prefix_apply_bounds(self) -> None:
        # Directory bounds track live config (tests shrink them via env
        # overrides long after this store was built).
        try:
            from ray_tpu_torch.core.config import config

            self.prefix_dir.max_entries = int(config().kv_tier_dir_max_entries)
            self.prefix_dir.ttl_s = float(config().kv_tier_dir_ttl_s)
        except Exception:  # noqa: BLE001 — config unavailable mid-teardown
            log_swallowed(logger, "prefix directory bounds")

    # -- function/code store (gcs_function_manager.h) ------------------------

    def export_function(self, function_id: str, payload: Any) -> None:
        with self._lock:
            self._functions[function_id] = payload

    def get_function(self, function_id: str) -> Any:
        with self._lock:
            return self._functions.get(function_id)

    # -- task events (gcs_task_manager.cc — observability) -------------------

    def record_task_event(self, event: dict) -> None:
        with self._lock:
            self._record_task_event_locked(event)

    def record_task_events(self, events: List[dict]) -> None:
        """Batched ingest — one call per worker flush (the
        ``task_event_buffer.cc`` batch), one lock round for the batch."""
        with self._lock:
            for event in events:
                self._record_task_event_locked(event)

    def _record_task_event_locked(self, event: dict) -> None:
        trace_id = event.get("trace_id")
        if trace_id:
            idxs = self._trace_index.get(trace_id)
            if idxs is None:
                self._trace_index[trace_id] = idxs = []
                while len(self._trace_index) > self._trace_index_cap():
                    self._trace_index.popitem(last=False)
            idxs.append(self._task_event_base + len(self._task_events))
        self._task_events.append(event)
        if len(self._task_events) > 100_000:
            drop = len(self._task_events) // 2
            del self._task_events[:drop]
            self._task_event_base += drop
            # Indices below the new base point at truncated events; prune
            # them (and now-empty traces) so trace() never dereferences one.
            for tid in list(self._trace_index):
                kept = [i for i in self._trace_index[tid]
                        if i >= self._task_event_base]
                if kept:
                    self._trace_index[tid] = kept
                else:
                    del self._trace_index[tid]

    @staticmethod
    def _trace_index_cap() -> int:
        from ray_tpu_torch.core.config import config

        return max(1, int(config().trace_max_traces))

    def trace(self, trace_id: str) -> List[dict]:
        """All retained events of one trace, oldest first — an indexed
        lookup, not a scan of the event ring."""
        with self._lock:
            idxs = self._trace_index.get(trace_id)
            if not idxs:
                return []
            base = self._task_event_base
            return [self._task_events[i - base] for i in idxs if i >= base]

    def task_events(self) -> List[dict]:
        with self._lock:
            return list(self._task_events)

    def task_events_since(self, cursor: Optional[int],
                          limit: int = 1000) -> Tuple[int, List[dict]]:
        """Incremental task-event read: ``(next_cursor, events)``.

        ``cursor`` is an absolute event index (events truncated off the
        front are skipped, same as the pubsub log); ``None`` tails from the
        end, returning at most the newest ``limit`` events — pollers store
        the returned cursor so every subsequent poll copies only NEW events
        instead of the whole (up to 100k-entry) log.
        """
        with self._lock:
            end = self._task_event_base + len(self._task_events)
            if cursor is None:
                lo = max(0, len(self._task_events) - limit) if limit else 0
            else:
                # A cursor past the end (GCS restarted with a fresh, shorter
                # log) clamps to the end: the poller resyncs going forward.
                lo = min(max(0, cursor - self._task_event_base),
                         len(self._task_events))
            events = (self._task_events[lo:lo + limit] if limit
                      else self._task_events[lo:])
            return self._task_event_base + lo + len(events), events

    # -- cluster metrics (metrics_agent.py → src/ray/stats/ analog) ----------

    def report_metrics(self, node_id: str, component: str, pid: int,
                       snapshot: List[dict]) -> None:
        self.metrics.report(node_id, component, pid, snapshot)

    def metrics_text(self) -> str:
        return self.metrics.prometheus_text()

    def metrics_summary(self) -> dict:
        return self.metrics.summary()

    def metrics_histogram(self, name: str, tags: dict) -> Optional[dict]:
        """Cluster-merged histogram for one metric/tag-filter (the serve
        SLO loop's TTFT read; see MetricsAggregator.histogram_merged)."""
        return self.metrics.histogram_merged(name, tags)
