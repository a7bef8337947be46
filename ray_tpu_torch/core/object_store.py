"""In-memory object store with blocking get/wait and error objects.

Analog of the reference's in-process memory store
(``src/ray/core_worker/store_provider/memory_store/``) fronting plasma
(``src/ray/object_manager/plasma/store.cc``). One store per node; objects are
``SerializedObject`` payloads (immutable); gets block on a condition variable;
error results are stored as ``TaskError`` sentinels and re-raised at ``get`` —
the same error-object scheme the reference uses (errors are plasma objects
too). Spilling to disk when over capacity mirrors
``local_object_manager.cc:110 SpillObjects``.

The port's copy of ``ray_tpu/core/object_store.py``. The store holds host
bytes only: a tensor put on the card is copied to the host by the
serializer, as the JAX package's put of a ``jax.Array`` is.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.exceptions import GetTimeoutError, ObjectLostError
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.serialization import SerializedObject, deserialize, serialize
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("object_store")


class StoredObject:
    __slots__ = (
        "serialized", "size", "create_time", "last_access", "spilled_path",
        "pinned", "shm_keys",
    )

    def __init__(self, serialized: Optional[SerializedObject], size: int | None = None):
        self.serialized = serialized
        if size is not None:
            self.size = size
        else:
            self.size = serialized.total_size() if serialized is not None else 0
        self.create_time = time.monotonic()
        # Bumped on every read: the LRU clock for spill eviction.
        self.last_access = self.create_time
        self.spilled_path = None
        self.pinned = 0
        # buffer index -> shm key for buffers held in the native arena
        self.shm_keys: Optional[Dict[int, bytes]] = None


class MemoryStore:
    """Node-local object store: put/get/wait/delete + readiness callbacks."""

    def __init__(self, capacity_bytes: int | None = None):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._objects: Dict[ObjectID, StoredObject] = {}
        self._ready_callbacks: Dict[ObjectID, List[Callable[[ObjectID], None]]] = {}
        self._capacity = capacity_bytes or config().object_store_memory
        self._used = 0
        self._spill_dir = (config().object_spilling_dir
                           or os.path.join(tempfile.gettempdir(),
                                           "ray_tpu_spill"))
        # Small LRU of deserialized values (≤1MB each); insertion order is
        # recency order — hits re-insert, inserts past the cap evict oldest.
        self._deser_cache: Dict[ObjectID, object] = {}
        self._deser_cache_cap = max(1, config().deser_cache_entries)
        # Native shm arena (the plasma plane) for large buffers; optional.
        self._native = None
        self._native_threshold = config().native_store_threshold
        if config().use_native_store:
            try:
                from ray_tpu_torch.core.native_store import NativeObjectStore

                self._native = NativeObjectStore(
                    f"rtpu_store_{os.getpid()}_{id(self):x}",
                    capacity=self._capacity,
                )
            except Exception as e:  # lib unavailable: heap-bytes fallback
                logger.debug("native store unavailable, using heap: %s", e)
        # arena blocks whose delete was refused (reader still pinned);
        # retried on subsequent puts and deletes
        self._shm_garbage: set = set()
        # Lifetime counters surfaced by stats() (→ the metrics plane).
        self._evictions = 0
        self._restores = 0

    # -- write path -----------------------------------------------------------

    def put_serialized(self, object_id: ObjectID, serialized: SerializedObject) -> None:
        # Copy out-of-band buffers: stored objects must not alias caller
        # memory (a numpy array mutated after put() would silently mutate the
        # stored object — the reference copies into plasma for the same
        # reason). Large buffers copy ONCE into the native shm arena (the
        # plasma path: consumers map them zero-copy); small ones stay heap
        # bytes inline with the header.
        with self._lock:
            if object_id in self._objects:
                return  # idempotent: objects are immutable
        self._sweep_shm_garbage()
        shm_keys: Optional[Dict[int, bytes]] = None
        if serialized.buffers:
            kept: list = []
            for i, b in enumerate(serialized.buffers):
                mv = memoryview(b).cast("B")
                if self._native is not None and len(mv) >= self._native_threshold:
                    key = object_id.binary()[:16] + i.to_bytes(4, "big")
                    try:
                        self._native.put(key, mv)
                        if shm_keys is None:
                            shm_keys = {}
                        shm_keys[i] = key
                        kept.append(b"")  # placeholder, re-materialized on get
                        continue
                    except MemoryError:
                        pass  # arena full or raced duplicate: heap copy
                kept.append(bytes(mv))
            serialized = SerializedObject(header=serialized.header, buffers=kept)
        # heap budget counts only heap-resident bytes; shm bytes have their
        # own budget (the arena itself raises MemoryError when full)
        heap_size = serialized.total_size()
        with self._lock:
            if object_id in self._objects:
                # raced duplicate: reclaim any arena blocks we just wrote
                if shm_keys and self._native is not None:
                    for key in shm_keys.values():
                        if not self._native.delete(key):
                            self._shm_garbage.add(key)
                return
            entry = StoredObject(serialized, size=heap_size)
            entry.shm_keys = shm_keys
            if self._used + entry.size > self._capacity:
                self._evict_locked(self._used + entry.size - self._capacity)
            self._objects[object_id] = entry
            self._used += entry.size
            callbacks = self._ready_callbacks.pop(object_id, [])
            self._cv.notify_all()
        for cb in callbacks:
            try:
                cb(object_id)
            except Exception:
                logger.exception("object-ready callback failed")

    def put(self, object_id: ObjectID, value) -> None:
        self.put_serialized(object_id, serialize(value))

    def _sweep_shm_garbage(self) -> None:
        if self._native is None or not self._shm_garbage:
            return
        for key in list(self._shm_garbage):
            if self._native.delete(key):
                self._shm_garbage.discard(key)

    # -- read path ------------------------------------------------------------

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def get_serialized(
        self, object_id: ObjectID, timeout: float | None = None
    ) -> SerializedObject:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while object_id not in self._objects:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(f"timed out waiting for {object_id}")
                self._cv.wait(remaining)
            entry = self._objects[object_id]
            entry.last_access = time.monotonic()
            if entry.serialized is None:
                entry = self._restore_locked(object_id, entry)
            if entry.shm_keys:
                # re-materialize shm-backed buffers as pinned zero-copy views
                buffers = list(entry.serialized.buffers)
                for i, key in entry.shm_keys.items():
                    view = self._native.get_view(key) if self._native else None
                    if view is None:
                        raise ObjectLostError(object_id)
                    buffers[i] = view
                return SerializedObject(header=entry.serialized.header, buffers=buffers)
            return entry.serialized

    def get(self, object_id: ObjectID, timeout: float | None = None):
        with self._lock:
            if object_id in self._deser_cache:
                # dict move-to-end: the cache's insertion order IS its LRU
                # order, so a hit must re-rank the entry newest.
                value = self._deser_cache.pop(object_id)
                self._deser_cache[object_id] = value
                entry = self._objects.get(object_id)
                if entry is not None:
                    entry.last_access = time.monotonic()
                return value
        serialized = self.get_serialized(object_id, timeout)
        value = deserialize(serialized)
        with self._lock:
            # Cache only modest values to bound memory; big arrays reconstruct
            # cheaply from their zero-copy buffers anyway. The cache itself is
            # a small LRU — without the entry cap, a long-lived node serving
            # many distinct small objects grows it without bound.
            if serialized.total_size() <= 1 << 20:
                self._deser_cache[object_id] = value
                while len(self._deser_cache) > self._deser_cache_cap:
                    self._deser_cache.pop(next(iter(self._deser_cache)))
        return value

    def wait(
        self,
        object_ids: Iterable[ObjectID],
        num_returns: int,
        timeout: float | None,
    ) -> tuple[list[ObjectID], list[ObjectID]]:
        ids = list(object_ids)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                ready = [oid for oid in ids if oid in self._objects]
                if len(ready) >= num_returns:
                    ready = ready[:num_returns]
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                self._cv.wait(remaining)
            ready_set = set(ready)
            not_ready = [oid for oid in ids if oid not in ready_set]
            return ready, not_ready

    def on_ready(self, object_id: ObjectID, callback: Callable[[ObjectID], None]):
        """Invoke callback when the object becomes available (or now)."""
        with self._lock:
            if object_id in self._objects:
                fire = True
            else:
                self._ready_callbacks.setdefault(object_id, []).append(callback)
                fire = False
        if fire:
            callback(object_id)

    # -- lifecycle ------------------------------------------------------------

    def delete(self, object_ids: Iterable[ObjectID]) -> None:
        self._sweep_shm_garbage()
        with self._lock:
            for oid in object_ids:
                entry = self._objects.pop(oid, None)
                self._deser_cache.pop(oid, None)
                if entry is not None:
                    if entry.serialized is not None:
                        # _used tracks in-memory bytes only; spilled entries
                        # were already subtracted at spill time.
                        self._used -= entry.size
                    if entry.shm_keys and self._native is not None:
                        for key in entry.shm_keys.values():
                            # refused while a reader still pins the buffer →
                            # parked in _shm_garbage, retried on later
                            # puts/deletes (plasma defers eviction of pinned
                            # objects the same way)
                            if not self._native.delete(key):
                                self._shm_garbage.add(key)
                    if entry.spilled_path:
                        try:
                            os.unlink(entry.spilled_path)
                        except OSError:
                            pass

    def pin(self, object_id: ObjectID) -> None:
        with self._lock:
            if object_id in self._objects:
                self._objects[object_id].pinned += 1

    def unpin(self, object_id: ObjectID) -> None:
        with self._lock:
            if object_id in self._objects:
                self._objects[object_id].pinned -= 1

    def close(self) -> None:
        """Tear down the native shm segment (runtime shutdown)."""
        if self._native is not None:
            try:
                self._native.destroy()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log_swallowed(logger, "native segment destroy")
            self._native = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_objects": len(self._objects),
                "used_bytes": self._used,
                "capacity_bytes": self._capacity,
                "evictions": self._evictions,
                "restores": self._restores,
            }

    # -- spilling (holds lock) ------------------------------------------------

    def _evict_locked(self, bytes_needed: int) -> None:
        """Spill least-recently-USED unpinned objects to disk.

        Reference: LRU eviction (``eviction_policy.cc``) + spill orchestration
        (``local_object_manager.cc:110``). We spill rather than drop because
        without lineage reconstruction a dropped object is lost. Recency is
        ``last_access`` (bumped on every read), not creation time — a hot
        object put early must not be the first one spilled.
        """
        os.makedirs(self._spill_dir, exist_ok=True)
        candidates = sorted(
            (
                (entry.last_access, oid)
                for oid, entry in self._objects.items()
                if entry.pinned == 0 and entry.serialized is not None
            ),
        )
        freed = 0
        for _, oid in candidates:
            if freed >= bytes_needed:
                break
            entry = self._objects[oid]
            if entry.shm_keys:
                continue  # shm-backed: lives outside the heap budget
            path = os.path.join(self._spill_dir, oid.hex())
            with open(path, "wb") as f:
                f.write(entry.serialized.to_bytes())
            entry.spilled_path = path
            entry.serialized = None
            self._deser_cache.pop(oid, None)
            freed += entry.size
            self._used -= entry.size
            self._evictions += 1
        if freed < bytes_needed:
            logger.warning(
                "object store over capacity and could not spill enough "
                "(needed %d, freed %d)",
                bytes_needed,
                freed,
            )

    def _restore_locked(self, object_id: ObjectID, entry: StoredObject) -> StoredObject:
        if not entry.spilled_path or not os.path.exists(entry.spilled_path):
            raise ObjectLostError(object_id)
        with open(entry.spilled_path, "rb") as f:
            blob = f.read()
        entry.serialized = SerializedObject.from_bytes(blob)
        self._used += entry.size
        self._restores += 1
        if self._used > self._capacity:
            # A restore is a write too: re-admitting the spilled bytes can
            # push the store over capacity — spill colder entries to make
            # room. The just-restored entry is pinned across the pass so it
            # can't bounce straight back to disk.
            entry.pinned += 1
            try:
                self._evict_locked(self._used - self._capacity)
            finally:
                entry.pinned -= 1
        return entry
