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

The port's copy of ``ray_tpu/core/gcs_shards.py``, with the KV tier's
prefix directory (``ShardedPrefixDirectory``).

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


class _PrefixShard:
    __slots__ = ("lock", "entries")

    def __init__(self):
        self.lock = threading.Lock()
        # digest bytes -> entry dict, insertion order == LRU order (touched
        # entries are popped and re-appended, like the paged engine's
        # cached-block LRU).
        self.entries: Dict[bytes, Dict[str, Any]] = {}


class ShardedPrefixDirectory:
    """Cluster prefix directory: KV-chain digest -> spilled-object locator.

    The serve KV tier's index (digest = ``prefix_head_hash`` of a chain's
    full blocks; entry = object locator + token count + replica hint), hash
    -partitioned by digest with per-shard locks like the tables above. The
    directory is a bounded CACHE, not an archive: per-shard LRU capacity
    plus a wall-clock TTL since last touch bound it, and every removal path
    (release-to-zero, LRU eviction, TTL expiry, explicit drop) reports the
    entry through ``on_free`` AFTER the shard lock is released so the owner
    can free the spilled payload without lock-order coupling.

    ``refs`` counts PUBLISHERS (each engine that spilled this chain), not
    readers — fetchers copy blocks into their own pool and hold nothing.
    Wall-clock timestamps (``time.time``) make TTLs survive ``dump`` /
    ``load`` across a GCS restart; restored entries whose publishers died
    age out by TTL, and a fetch that finds their payload gone drops them
    eagerly (the self-heal path — no dangling object ids).
    """

    def __init__(self, num_shards: int, max_entries: int = 4096,
                 ttl_s: float = 600.0, on_free=None):
        self._n = max(1, int(num_shards))
        self.max_entries = int(max_entries)
        self.ttl_s = float(ttl_s)
        self._on_free = on_free
        self._shards = [_PrefixShard() for _ in range(self._n)]
        self._lock = threading.Lock()  # counters only
        self._published = 0
        self._evicted = 0
        self._expired = 0
        self._hits = 0
        self._misses = 0

    def _shard(self, digest: bytes) -> _PrefixShard:
        return self._shards[shard_index(bytes(digest), self._n)]

    def _per_shard_cap(self) -> int:
        return max(1, self.max_entries // self._n)

    def _expired_locked(self, entry: Dict[str, Any], now: float) -> bool:
        return self.ttl_s > 0 and now - entry["t"] > self.ttl_s

    def _reap_locked(self, sh: _PrefixShard, now: float) -> List[tuple]:
        """Collect TTL-expired + over-capacity entries (oldest first);
        caller frees them OUTSIDE the shard lock."""
        freed = []
        for digest in list(sh.entries):
            if not self._expired_locked(sh.entries[digest], now):
                break  # LRU order: first fresh entry ends the expired run
            freed.append(("expired", digest, sh.entries.pop(digest)))
        cap = self._per_shard_cap()
        while len(sh.entries) > cap:
            digest = next(iter(sh.entries))
            freed.append(("evicted", digest, sh.entries.pop(digest)))
        return freed

    def _free(self, freed: List[tuple]) -> None:
        with self._lock:
            for reason, _digest, _entry in freed:
                if reason == "expired":
                    self._expired += 1
                elif reason == "evicted":
                    self._evicted += 1
        if self._on_free is not None:
            for _reason, digest, entry in freed:
                self._on_free(digest, entry)

    def publish(self, digest: bytes, meta: bytes, token_count: int,
                n_blocks: int, hint: str = "") -> bool:
        """Insert or re-reference ``digest``. Returns True when the entry
        is NEW (the caller's payload became the canonical object); False
        bumps the existing entry's refcount and leaves its meta alone."""
        digest = bytes(digest)
        now = time.time()
        sh = self._shard(digest)
        with sh.lock:
            entry = sh.entries.pop(digest, None)
            if entry is not None and not self._expired_locked(entry, now):
                entry["refs"] += 1
                entry["t"] = now
                sh.entries[digest] = entry  # MRU re-append
                freed = self._reap_locked(sh, now)
                created = False
            else:
                freed = [("expired", digest, entry)] if entry else []
                sh.entries[digest] = {
                    "meta": bytes(meta), "tokens": int(token_count),
                    "blocks": int(n_blocks), "refs": 1,
                    "hint": str(hint), "t": now,
                }
                freed += self._reap_locked(sh, now)
                created = True
        with self._lock:
            self._published += 1
        self._free(freed)
        return created

    def match(self, digests: List[bytes]) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Longest-prefix match: walk ``digests`` (one per full block of
        the probe chain, shortest..longest) from the LONGEST down and
        return ``(index, entry_copy)`` for the first live entry, touching
        it MRU. None when nothing matches."""
        now = time.time()
        for i in range(len(digests) - 1, -1, -1):
            digest = bytes(digests[i])
            sh = self._shard(digest)
            with sh.lock:
                entry = sh.entries.pop(digest, None)
                if entry is None:
                    continue
                if self._expired_locked(entry, now):
                    freed = [("expired", digest, entry)]
                else:
                    entry["t"] = now
                    sh.entries[digest] = entry
                    freed = None
                    snap = dict(entry)
            if freed is not None:
                self._free(freed)
                continue
            with self._lock:
                self._hits += 1
            return i, snap
        with self._lock:
            self._misses += 1
        return None

    def release(self, digest: bytes) -> bool:
        """Publisher-side decref; the entry (and its object, via
        ``on_free``) goes when the last publisher releases. Returns True
        when this call removed the entry."""
        digest = bytes(digest)
        sh = self._shard(digest)
        with sh.lock:
            entry = sh.entries.get(digest)
            if entry is None:
                return False
            entry["refs"] -= 1
            if entry["refs"] > 0:
                return False
            sh.entries.pop(digest)
        self._free([("released", digest, entry)])
        return True

    def drop(self, digest: bytes) -> bool:
        """Unconditional removal — the fetch-failure self-heal path (the
        locator pointed at a freed object; un-index it regardless of
        refs)."""
        digest = bytes(digest)
        sh = self._shard(digest)
        with sh.lock:
            entry = sh.entries.pop(digest, None)
        if entry is None:
            return False
        self._free([("dropped", digest, entry)])
        return True

    def sweep(self, now: Optional[float] = None) -> int:
        """Full TTL/capacity sweep across every shard; returns the number
        of entries freed."""
        now = time.time() if now is None else now
        total = 0
        for sh in self._shards:
            with sh.lock:
                freed = self._reap_locked(sh, now)
            self._free(freed)
            total += len(freed)
        return total

    def stats(self) -> Dict[str, int]:
        entries = refs = 0
        for sh in self._shards:
            with sh.lock:
                entries += len(sh.entries)
                refs += sum(e["refs"] for e in sh.entries.values())
        with self._lock:
            return {
                "prefix_dir_entries": entries,
                "prefix_dir_refs": refs,
                "prefix_dir_published": self._published,
                "prefix_dir_hits": self._hits,
                "prefix_dir_misses": self._misses,
                "prefix_dir_evicted": self._evicted,
                "prefix_dir_expired": self._expired,
            }

    def dump(self) -> Dict[bytes, Dict[str, Any]]:
        """Shard-count-independent snapshot (rides the GCS KV snapshot)."""
        out: Dict[bytes, Dict[str, Any]] = {}
        for sh in self._shards:
            with sh.lock:
                for digest, entry in sh.entries.items():
                    out[digest] = dict(entry)
        return out

    def load(self, data: Dict[bytes, Dict[str, Any]]) -> None:
        """Replace directory contents (restore path); entries re-route by
        digest so the restored server may run a different shard count."""
        for sh in self._shards:
            with sh.lock:
                sh.entries.clear()
        # Oldest-touch first so per-shard insertion order stays LRU order.
        for digest, entry in sorted(data.items(), key=lambda kv: kv[1]["t"]):
            digest = bytes(digest)
            sh = self._shard(digest)
            with sh.lock:
                sh.entries[digest] = dict(entry)


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
