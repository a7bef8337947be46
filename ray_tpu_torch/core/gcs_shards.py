"""Hash-sharded GCS tables — independent lock domains for hot state.

The single ``GcsService._lock`` owns scheduling AND the object directory AND
pubsub AND KV; under a location storm (thousands of seals/s from the push
wakeup plane) every ``add_object_location`` contends with every
``request_lease``. The reference keeps these planes apart structurally (the
object directory is ownership-based and distributed, pubsub has per-key
indices — ``src/ray/pubsub/publisher.h``); here we split the tables by id
hash across ``gcs_shards`` in-process shard objects, each with its OWN lock
and wait lists, so the planes stop contending without changing any RPC
surface. ``gcs_shards=1`` reproduces the single-table behavior exactly —
one shard, one lock, identical ordering.

The port's copy of ``ray_tpu/core/gcs_shards.py``. The KV tier's prefix
directory (``ShardedPrefixDirectory``) comes with the KV tier.

Routing uses ``zlib.crc32`` (NOT ``hash()``: Python string hashing is
per-process seeded, and shard routing must be stable across GCS restarts
so re-registered state lands where lookups expect it).
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import NodeID


def shard_index(key: bytes | str, n: int) -> int:
    """Stable shard route for ``key`` among ``n`` shards."""
    if n <= 1:
        return 0
    if isinstance(key, str):
        key = key.encode()
    return zlib.crc32(key) % n


class _DirectoryShard:
    __slots__ = ("lock", "objects", "lineage", "task_objects", "lineage_cap")

    def __init__(self, lineage_cap: int):
        self.lock = threading.Lock()
        # object id bytes -> {node_id: size}
        self.objects: Dict[bytes, Dict[NodeID, int]] = {}
        # task_id bytes -> pickled spec (FIFO-capped backstop)
        self.lineage: Dict[bytes, bytes] = {}
        # task_id bytes -> live object ids (GC lineage with its objects)
        self.task_objects: Dict[bytes, set] = {}
        self.lineage_cap = lineage_cap


class ShardedObjectDirectory:
    """Object locations + lineage, hash-partitioned by creating-task key.

    Sharding by the 24-byte TaskID prefix (not the full object id) keeps a
    task's sibling returns, its lineage row and its live-object set in ONE
    shard, so every operation stays single-shard and single-lock.
    """

    # ObjectID = TaskID(24) + return index (4)
    @staticmethod
    def task_key(object_id: bytes) -> bytes:
        return bytes(object_id)[:24]

    def __init__(self, num_shards: int, lineage_cap: int = 10_000):
        self._n = max(1, int(num_shards))
        per_shard_cap = max(1, lineage_cap // self._n)
        self._shards = [_DirectoryShard(per_shard_cap) for _ in range(self._n)]

    def _shard(self, object_id: bytes) -> _DirectoryShard:
        return self._shards[shard_index(self.task_key(object_id), self._n)]

    def add_location(self, object_id: bytes, node_id: NodeID, size: int,
                     lineage: Optional[bytes] = None) -> None:
        object_id = bytes(object_id)
        sh = self._shard(object_id)
        with sh.lock:
            sh.objects.setdefault(object_id, {})[node_id] = size
            tk = self.task_key(object_id)
            sh.task_objects.setdefault(tk, set()).add(object_id)
            if lineage is not None and tk not in sh.lineage:
                if len(sh.lineage) >= sh.lineage_cap:
                    sh.lineage.pop(next(iter(sh.lineage)))
                sh.lineage[tk] = lineage

    def add_lineage(self, object_id: bytes, lineage: bytes) -> None:
        object_id = bytes(object_id)
        sh = self._shard(object_id)
        with sh.lock:
            tk = self.task_key(object_id)
            if tk not in sh.lineage:
                if len(sh.lineage) >= sh.lineage_cap:
                    sh.lineage.pop(next(iter(sh.lineage)))
                sh.lineage[tk] = lineage

    def remove_location(self, object_id: bytes, node_id: NodeID) -> None:
        object_id = bytes(object_id)
        sh = self._shard(object_id)
        with sh.lock:
            locs = sh.objects.get(object_id)
            if locs:
                locs.pop(node_id, None)
                if not locs:
                    sh.objects.pop(object_id, None)

    def locations(self, object_id: bytes) -> Dict[NodeID, int]:
        object_id = bytes(object_id)
        sh = self._shard(object_id)
        with sh.lock:
            return dict(sh.objects.get(object_id, {}))

    def get_lineage(self, object_id: bytes) -> Optional[bytes]:
        object_id = bytes(object_id)
        sh = self._shard(object_id)
        with sh.lock:
            return sh.lineage.get(self.task_key(object_id))

    def pop_object(self, object_id: bytes) -> Dict[NodeID, int]:
        """Free path: drop the location row, GC lineage when the last of
        the task's outputs goes; returns the replica map for daemon frees."""
        object_id = bytes(object_id)
        sh = self._shard(object_id)
        with sh.lock:
            locs = sh.objects.pop(object_id, {})
            tk = self.task_key(object_id)
            live = sh.task_objects.get(tk)
            if live is not None:
                live.discard(object_id)
                if not live:
                    sh.task_objects.pop(tk, None)
                    sh.lineage.pop(tk, None)
            return locs

    def drop_node(self, node_id: NodeID) -> None:
        """Node death: every replica row on that node is gone."""
        for sh in self._shards:
            with sh.lock:
                for oid, locs in list(sh.objects.items()):
                    locs.pop(node_id, None)
                    if not locs:
                        sh.objects.pop(oid, None)


class _PubShard:
    __slots__ = ("lock", "conds", "log", "base", "loc_waitlists")

    def __init__(self):
        self.lock = threading.Lock()
        self.conds: Dict[str, threading.Condition] = {}
        self.log: Dict[str, List[Any]] = {}
        self.base: Dict[str, int] = {}
        # oid bytes -> conditions of filtered subscribes parked on it
        self.loc_waitlists: Dict[bytes, List[threading.Condition]] = {}


class ShardedPubSub:
    """Long-poll pubsub, hash-partitioned by channel name.

    A channel lives entirely in one shard (its log, base cursor, channel
    condvar and — for the object-location channel — per-oid wait lists), so
    cursor semantics are untouched; sharding only separates the lock a
    location-storm publish takes from the one a node-event poll takes.
    """

    def __init__(self, num_shards: int, retain: int = 10_000):
        self._n = max(1, int(num_shards))
        self._retain = retain
        self._shards = [_PubShard() for _ in range(self._n)]

    def _shard(self, channel: str) -> _PubShard:
        return self._shards[shard_index(channel, self._n)]

    def publish(self, channel: str, message: Any,
                loc_key: Optional[bytes] = None) -> None:
        sh = self._shard(channel)
        with sh.lock:
            sh.log.setdefault(channel, []).append(message)
            log = sh.log[channel]
            if len(log) > self._retain:
                drop = len(log) // 2
                del log[:drop]
                sh.base[channel] = sh.base.get(channel, 0) + drop
            cond = sh.conds.get(channel)
            if cond is not None:
                cond.notify_all()
            if loc_key is not None:
                waiters = sh.loc_waitlists.get(bytes(loc_key))
                if waiters:
                    for c in waiters:
                        c.notify_all()

    def end_cursor(self, channel: str) -> int:
        sh = self._shard(channel)
        with sh.lock:
            return sh.base.get(channel, 0) + len(sh.log.get(channel, []))

    def poll(self, channel: str, cursor: int,
             timeout: float = 30.0) -> Tuple[int, List[Any]]:
        deadline = time.time() + timeout
        sh = self._shard(channel)
        with sh.lock:
            cond = sh.conds.get(channel)
            if cond is None:
                cond = sh.conds[channel] = threading.Condition(sh.lock)
            while True:
                log = sh.log.get(channel, [])
                base = sh.base.get(channel, 0)
                end = base + len(log)
                if cursor < end:
                    # Messages below `base` were truncated and are lost
                    # (bounded buffers, as in the reference's pubsub).
                    return end, log[max(0, cursor - base):]
                remaining = deadline - time.time()
                if remaining <= 0:
                    return cursor, []
                # raylint: ignore[blocking-under-lock] — the channel cond
                # wraps sh.lock (created above as Condition(sh.lock)).
                cond.wait(timeout=remaining)

    def poll_filtered(self, channel: str, cursor: int, oids: List[bytes],
                      timeout: float = 30.0) -> Tuple[int, List[Any]]:
        """Filtered long-poll on a location-style channel: only messages
        whose first element is in ``oids`` return; the poll parks on
        per-oid wait lists so unrelated seals never wake it."""
        oidset = {bytes(o) for o in oids}
        deadline = time.time() + timeout
        sh = self._shard(channel)
        cond = threading.Condition(sh.lock)
        with sh.lock:
            for o in oidset:
                sh.loc_waitlists.setdefault(o, []).append(cond)
            try:
                while True:
                    log = sh.log.get(channel, [])
                    base = sh.base.get(channel, 0)
                    end = base + len(log)
                    if cursor < end:
                        matches = [m for m in log[max(0, cursor - base):]
                                   if bytes(m[0]) in oidset]
                        cursor = end  # filtered misses are consumed too
                        if matches:
                            return end, matches
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return cursor, []
                    # raylint: ignore[blocking-under-lock] — this cond
                    # wraps sh.lock (Condition(sh.lock) above).
                    cond.wait(timeout=remaining)
            finally:
                for o in oidset:
                    lst = sh.loc_waitlists.get(o)
                    if lst is not None:
                        try:
                            lst.remove(cond)
                        except ValueError:
                            pass
                        if not lst:
                            sh.loc_waitlists.pop(o, None)
