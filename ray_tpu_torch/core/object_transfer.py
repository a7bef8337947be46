"""Chunked object transfer — the pull/push managers of the object plane.

Analog of the reference's node-to-node transfer machinery
(``src/ray/object_manager/object_manager.cc:812`` chunked push/pull,
``pull_manager.cc:801`` prioritized pull with memory budgeting,
``push_manager.cc`` chunk pipelining): objects move between nodes as a
pipeline of bounded frames instead of one object-sized frame, total
in-flight pull bytes are capped by a budget, and pulled replicas land
directly in the local shm arena (then register as a new location, so
broadcasts fan out instead of serializing on the origin).

The TPU-era difference from the reference: only HOST-RAM objects move here
(numpy/arrow buffers over DCN-equivalent sockets); device-to-device tensor
movement rides XLA collectives over ICI, never this path.
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.rpc import RpcClient
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("object_transfer")

# Per-process pull-path counters (plain int stores under the GIL — stats,
# not invariants; mirrored into gauges by the metrics exporter's collector).
_PULL_STATS = {"bytes": 0, "chunks": 0, "reassigned_ranges": 0,
               "failed_sources": 0}


def pull_stats() -> dict:
    """Snapshot of the process-wide chunked-pull counters."""
    return dict(_PULL_STATS)


class PullBudget:
    """Global cap on in-flight pulled bytes (pull_manager.cc's
    ``num_bytes_being_pulled`` budget): many concurrent big pulls queue
    instead of filling RAM. A single object larger than the whole budget
    still proceeds alone (it can't be split)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._in_use = 0
        self._cv = threading.Condition()

    def acquire(self, nbytes: int) -> int:
        grant = min(nbytes, self.capacity)
        with self._cv:
            while self._in_use > 0 and self._in_use + grant > self.capacity:
                self._cv.wait(timeout=1.0)
            self._in_use += grant
        return grant

    def release(self, grant: int) -> None:
        with self._cv:
            self._in_use -= grant
            self._cv.notify_all()


class PullManager:
    """Chunked pulls from remote daemons into caller-provided destinations.

    One object, one destination, one or MANY sources: when several replica
    daemons hold the object (and it is at least ``stripe_min_size``),
    :meth:`pull_into_multi` stripes the chunk ranges across all of them —
    per-source pipelines land disjoint slices of the same destination
    concurrently, a failed source's unfinished ranges reassign to the
    survivors, and the pull aborts only when no replica remains."""

    def __init__(self, clients):
        self._clients = clients  # RpcClientPool of daemon addresses
        cfg = config()
        self._chunk = cfg.pull_chunk_size
        self._window = cfg.pull_chunk_concurrency
        self._budget = PullBudget(cfg.pull_memory_budget)
        self._stripe_min = cfg.stripe_min_size

    def pull_into(self, addr: str, key: bytes, size: int, dest) -> bool:
        """Pull ``size`` bytes of object ``key`` from the daemon at ``addr``
        into ``dest`` (writable buffer of exactly ``size`` bytes), as a
        pipeline of ``pull_chunk_concurrency`` in-flight chunk requests.
        Returns False on any transfer failure."""
        return self._pull_striped([addr], key, size, dest)

    def pull_into_multi(self, addrs, key: bytes, size: int, dest) -> bool:
        """Pull one object of ``size`` bytes into ``dest`` from up to
        ``len(addrs)`` replica daemons at once.

        Below ``stripe_min_size`` the per-source pipeline setup isn't worth
        it: sources are tried one at a time, failing over in order. Above
        it, every source runs its own chunk pipeline over a SHARED work
        queue of (offset, length) ranges — naturally load-balanced: a slow
        replica simply claims fewer ranges. Returns False only when every
        source failed with ranges outstanding."""
        addrs = list(dict.fromkeys(addrs))
        if not addrs:
            return False
        if len(addrs) > 1 and size < self._stripe_min:
            for addr in addrs:
                if self._pull_striped([addr], key, size, dest):
                    return True
            return False
        return self._pull_striped(addrs, key, size, dest)

    def _pull_striped(self, addrs, key: bytes, size: int, dest) -> bool:
        """The one chunk pipeline: N sources over a shared range queue
        (N=1 is the plain single-source pull — same code path, no barrier
        or extra thread: the first source runs on the calling thread)."""
        grant = self._budget.acquire(size)
        try:
            from collections import deque as _deque

            queue = _deque()
            for off in range(0, size, self._chunk):
                queue.append((off, min(self._chunk, size - off)))
            st = {
                "cv": threading.Condition(),
                "queue": queue,          # unclaimed (offset, length) ranges
                "remaining": len(queue),  # ranges not yet landed in dest
                "live": len(addrs),      # sources still pulling
            }
            dest_mv = memoryview(dest).cast("B")
            threads = [
                threading.Thread(target=self._source_worker,
                                 args=(addr, key, dest_mv, st),
                                 name="pull-stripe", daemon=True)
                for addr in addrs[1:]
            ]
            for t in threads:
                t.start()
            self._source_worker(addrs[0], key, dest_mv, st)
            for t in threads:
                t.join()
            with st["cv"]:
                return st["remaining"] == 0
        finally:
            self._budget.release(grant)

    def _source_worker(self, addr: str, key: bytes, dest, st) -> None:
        """One source's chunk pipeline over the shared range queue."""
        from ray_tpu_torch.core.serialization import fast_copy_into

        try:
            client = self._clients.get(addr)
        except Exception:  # noqa: BLE001 — pool rejects bad address
            self._source_failed(st, addr, None, [], [])
            return
        inflight = []  # (offset, length, future)
        taken = []     # ranges claimed under the lock, not yet issued
        while True:
            with st["cv"]:
                while (len(inflight) + len(taken) < self._window
                       and st["queue"]):
                    taken.append(st["queue"].popleft())
                if not taken and not inflight:
                    if st["remaining"] == 0 or st["live"] == 0:
                        return
                    # Queue drained but other sources still own ranges —
                    # wait in case a failure reassigns them to us.
                    st["cv"].wait(0.1)
                    continue
            while taken:
                off, length = taken[0]
                try:
                    # _dest: the reply lands straight in the dest slice.
                    fut = client.call_async(
                        "fetch_object_chunk", key, off, length,
                        _dest=dest[off:off + length])
                except Exception:  # noqa: BLE001 — source unreachable
                    self._source_failed(st, addr, client, inflight, taken)
                    return
                taken.pop(0)
                inflight.append((off, length, fut))
            off, length, fut = inflight.pop(0)
            try:
                chunk = fut.result(timeout=120.0)
            except Exception:  # noqa: BLE001 — conn loss / timeout
                inflight.append((off, length, fut))  # revoke this one too
                self._source_failed(st, addr, client, inflight, taken)
                return
            if chunk is None or (not getattr(fut, "dest_written", False)
                                 and len(chunk) != length):
                # Replica gone at this source (or truncated read): this
                # range is UNFINISHED too — back into the pool with the
                # rest, or remaining never reaches 0 and survivors wait
                # forever.
                inflight.append((off, length, fut))
                self._source_failed(st, addr, client, inflight, taken)
                return
            if not getattr(fut, "dest_written", False):
                fast_copy_into(dest, off, chunk)
            _PULL_STATS["bytes"] += length
            _PULL_STATS["chunks"] += 1
            with st["cv"]:
                st["remaining"] -= 1
                if st["remaining"] == 0:
                    st["cv"].notify_all()

    def _source_failed(self, st, addr: str, client, inflight, taken) -> None:
        """Reassign a dead source's unfinished ranges to the survivors.

        Its zero-copy landings are revoked FIRST (release_dests) so a late
        reply can never race a survivor's re-fetch into the same slice."""
        if client is not None and inflight:
            try:
                client.release_dests([f for _, _, f in inflight])
            except Exception:  # noqa: BLE001 — connection already torn down
                log_swallowed(logger, "release_dests on dead connection")
        _PULL_STATS["failed_sources"] += 1
        _PULL_STATS["reassigned_ranges"] += len(inflight) + len(taken)
        with st["cv"]:
            for off, length, _f in inflight:
                st["queue"].append((off, length))
            for rng in taken:
                st["queue"].append(rng)
            st["live"] -= 1
            st["cv"].notify_all()
        logger.warning("pull source %s failed; %s", addr,
                       "ranges reassigned to survivors" if st["live"]
                       else "no replica remains — pull aborted")


class PushManager:
    """Chunked upload of an oversized payload to a daemon's spill shelf
    (the put-side mirror of PullManager; push_manager.cc analog)."""

    def __init__(self, clients):
        self._clients = clients
        cfg = config()
        self._chunk = cfg.pull_chunk_size
        self._window = cfg.pull_chunk_concurrency

    def push_spill(self, addr: str, key: bytes, payload) -> bool:
        view = memoryview(payload).cast("B")
        size = len(view)
        client: RpcClient = self._clients.get(addr)
        try:
            from ray_tpu_torch.core.rpc import Raw

            client.call("begin_spill_put", key, size, timeout=60.0)
            inflight = []
            off = 0
            while off < size or inflight:
                while off < size and len(inflight) < self._window:
                    length = min(self._chunk, size - off)
                    # Raw: the socket write reads straight from the source
                    # buffer — no per-chunk bytes() copy on this side.
                    inflight.append(client.call_async(
                        "spill_put_chunk", key, off,
                        Raw(view[off:off + length])))
                    off += length
                inflight.pop(0).result(timeout=120.0)
            client.call("commit_spill_put", key, size, timeout=60.0)
            return True
        except Exception:  # noqa: BLE001 — conn loss / timeout / refusal
            logger.warning("spill push of %s (%d B) to %s failed",
                           key.hex()[:12], size, addr)
            try:
                client.notify("abort_spill_put", key)
            except Exception:  # noqa: BLE001 — daemon gone; its sweeper
                log_swallowed(logger, "abort_spill_put")  # sweeps partials
            return False
