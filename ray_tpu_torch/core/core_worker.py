"""Core worker — the client runtime inside every driver and worker process.

Analog of the reference's ``CoreWorker`` (``src/ray/core_worker/
core_worker.h:291``): owns task submission (lease from the control plane,
push to the node daemon — the role of ``transport/direct_task_transport.cc``),
actor submission (direct RPC to the actor's worker process —
``transport/direct_actor_task_submitter.cc``), the object API (local value
cache = the in-process memory store; the node's shm arena = plasma provider;
remote fetch through node daemons = pull manager), reference counting with
owner-side frees (``reference_count.h:61``), and retries
(``task_manager.cc``).

One instance per process, installed as the global runtime so the same
``ray_tpu_torch.api`` surface (and nested ``f.remote()`` calls inside tasks)
works identically in drivers and workers.

The port's copy of ``ray_tpu/core/core_worker.py``, with the KV tier's
prefix-directory client calls (``prefix_*``). Objects
are host bytes here as in the in-process runtime: a CUDA tensor put or
returned from a task travels as a host copy, and ``get`` gives a CPU tensor.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    ActorError,
    GetTimeoutError,
    TaskCancelledError,
    TaskError,
    WorkerDiedError,
)
from ray_tpu_torch.core.gcs import ActorInfo, JobInfo, NodeInfo
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch.core.lease_table import is_block_lease
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.rpc import (RpcClient, RpcClientPool, RpcConnectionError,
                              RpcRemoteError)
from ray_tpu_torch.core.task_spec import (SpecCacheMiss, SpecEncoder, TaskSpec,
                                    TaskType, spec_var_fields)
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("core_worker")


class _GcsClientAdapter:
    """Duck-types the in-process ``Runtime.gcs`` surface over RPC.

    The reference's equivalent is the GCS client (``gcs_client.h``) used by
    every worker; the function-table half caches deserialized callables locally
    exactly as ``function_manager.py`` does.
    """

    def __init__(self, client: RpcClient):
        self._client = client
        self._fn_cache: Dict[str, Any] = {}
        self._fn_lock = threading.Lock()

    # -- functions ------------------------------------------------------------

    def export_function(self, function_id: str, payload: Any) -> None:
        with self._fn_lock:
            self._fn_cache[function_id] = payload
        self._client.call("export_function", function_id,
                          serialization.dumps(payload))

    def get_function(self, function_id: str) -> Any:
        with self._fn_lock:
            if function_id in self._fn_cache:
                return self._fn_cache[function_id]
        blob = self._client.call("get_function", function_id)
        if blob is None:
            return None
        fn = serialization.loads(blob)
        with self._fn_lock:
            self._fn_cache[function_id] = fn
        return fn

    # -- actors ---------------------------------------------------------------

    def get_named_actor(self, name: str, namespace: str = "default"):
        return self._client.call("get_named_actor", name, namespace)

    def list_named_actors(self, namespace=None):
        return self._client.call("list_named_actors", namespace)

    def get_actor(self, actor_id: ActorID) -> Optional[ActorInfo]:
        info = self._client.call("get_actor_info", actor_id)
        if info is None:
            return None
        out = ActorInfo(actor_id=actor_id, name=info["name"],
                        class_name=info["class_name"], state=info["state"],
                        node_id=info["node_id"],
                        num_restarts=info["num_restarts"],
                        death_cause=info["death_cause"])
        return out

    # -- nodes ----------------------------------------------------------------

    @property
    def nodes(self) -> Dict[NodeID, NodeInfo]:
        out = {}
        for n in self._client.call("list_nodes"):
            out[n["node_id"]] = NodeInfo(
                node_id=n["node_id"], address=n["address"],
                resources=n["resources"], labels=n["labels"],
                alive=n["alive"],
            )
        return out

    def alive_nodes(self) -> List[NodeInfo]:
        return [n for n in self.nodes.values() if n.alive]

    def cluster_resources(self) -> Dict[str, float]:
        return self._client.call("cluster_resources")

    # -- jobs -----------------------------------------------------------------

    @property
    def jobs(self) -> Dict[Any, JobInfo]:
        return {j.job_id: j for j in self._client.call("list_jobs")}

    def add_job(self, info: JobInfo) -> None:
        self._client.call("add_job", info.job_id, info.entrypoint,
                          info.driver_pid, info.metadata)

    def finish_job(self, job_id, status: str = "SUCCEEDED") -> None:
        self._client.call("finish_job", job_id, status)

    # -- KV -------------------------------------------------------------------

    def kv_put(self, key, value, namespace="default", overwrite=True):
        return self._client.call("kv_put", key, value, namespace, overwrite)

    def kv_get(self, key, namespace="default"):
        return self._client.call("kv_get", key, namespace)

    def kv_del(self, key, namespace="default"):
        return self._client.call("kv_del", key, namespace)

    def kv_keys(self, prefix="", namespace="default"):
        return self._client.call("kv_keys", prefix, namespace)

    # -- KV-tier prefix directory ---------------------------------------------

    def prefix_publish(self, digest, meta, token_count, n_blocks, hint=""):
        return self._client.call("prefix_publish", digest, meta,
                                 token_count, n_blocks, hint)

    def prefix_match(self, digests):
        return self._client.call("prefix_match", digests)

    def prefix_release(self, digest):
        return self._client.call("prefix_release", digest)

    def prefix_drop(self, digest):
        return self._client.call("prefix_drop", digest)

    def prefix_sweep(self):
        return self._client.call("prefix_sweep")

    def prefix_stats(self):
        return self._client.call("prefix_stats")

    # -- observability --------------------------------------------------------

    def record_task_event(self, event: dict) -> None:
        try:
            self._client.notify("record_task_event", event)
        except RpcConnectionError:
            pass

    def record_task_events(self, events: List[dict]) -> None:
        """Batched form — one coalescable notify per span/event flush."""
        try:
            self._client.notify("record_task_events", events)
        except RpcConnectionError:
            pass

    def task_events(self) -> List[dict]:
        return self._client.call("task_events")

    def trace(self, trace_id: str) -> List[dict]:
        """Assembled per-trace event list from the GCS trace index."""
        return self._client.call("trace", trace_id)

    def task_events_since(self, cursor, limit: int = 1000):
        """Cursor'd task-event poll: (next_cursor, new_events)."""
        return self._client.call("task_events_since", cursor, limit)

    # -- cluster metrics plane ------------------------------------------------

    def report_metrics(self, node_id: str, component: str, pid: int,
                       snapshot: list) -> None:
        # Coalescable one-way notify: exporter ticks must never block on
        # (or crash with) a restarting GCS.
        self._client.notify("report_metrics", node_id, component, pid,
                            snapshot)

    def metrics_text(self) -> str:
        return self._client.call("metrics_text")

    def metrics_summary(self) -> dict:
        return self._client.call("metrics_summary")

    def metrics_histogram(self, name: str, tags: dict):
        """Cluster-merged histogram for one metric (serve SLO TTFT read)."""
        return self._client.call("metrics_histogram", name, tags)

    def pending_block_capacity(self) -> list:
        """Outstanding capacity-block units (autoscaler pending credit)."""
        return self._client.call("pending_block_capacity")

    def poll_channel(self, channel: str, cursor: int,
                     poll_timeout: float = 0.0):
        """Read a pubsub channel from ``cursor``; returns (end, messages).
        With ``poll_timeout`` 0 this is a non-blocking snapshot read (the
        dashboard log pane's access path)."""
        return self._client.call("poll_channel", channel, cursor,
                                 poll_timeout,
                                 timeout=poll_timeout + 30.0)


class _SchedulerProxy:
    def __init__(self, client: RpcClient):
        self._client = client

    def available_resources(self) -> Dict[str, float]:
        return self._client.call("available_resources")


# Thread-local deserialization context for the borrow protocol: while a
# worker deserializes TASK ARGUMENTS, foreign refs constructed there are
# recorded in this set and registered with their owners only if still held
# at task completion (the caller's call-duration pin covers the interim) —
# the reference piggybacks borrower bookkeeping on task replies the same
# way (reference_count.h:61 "borrowers"). Everywhere else (get() values,
# user code), a foreign ref registers with its owner synchronously at
# construction.
_BORROW_CTX = threading.local()


def _arg_borrow_set() -> Optional[set]:
    return getattr(_BORROW_CTX, "arg_set", None)


import contextlib


@contextlib.contextmanager
def arg_borrow_scope():
    """Open the deferred-registration scope for task-argument
    deserialization; yields the set of candidate borrowed oids."""
    prev = getattr(_BORROW_CTX, "arg_set", None)
    out: set = set()
    _BORROW_CTX.arg_set = out
    try:
        yield out
    finally:
        _BORROW_CTX.arg_set = prev


class _LocalRefCounter:
    """Distributed reference counting: local handles + submitted-task pins
    + the borrower protocol of ``reference_count.h:61``.

    Each process counts its own Python handles and in-flight submitted-task
    borrows. Only the *owner* (creating process) triggers a cluster-wide
    free — and defers it while any remote process is REGISTERED as a
    borrower or any live local object CONTAINS the ref (nested refs).
    Borrower registrations flow:

    - handle borrows: a process that deserializes a foreign ref registers
      with the owner (synchronously in value context; deferred to task
      completion for task args, covered by the caller's pin meanwhile);
    - contained refs: serializing a value holding refs pins the inner refs
      on the OUTER object's owner until the outer is freed; a worker
      returning such a value registers the caller as borrower before
      replying (handover — no window where nothing pins the inner);
    - worker death: owners sweep borrower addresses and purge unreachable
      ones (the reference collects borrower sets on worker exit).
    """

    def __init__(self, core: "CoreWorker"):
        self._core = core
        self._lock = threading.Lock()
        self._local: Dict[ObjectID, int] = {}
        self._submitted: Dict[ObjectID, int] = {}
        self._owned: set = set()
        # Owner side: oid -> {borrower owner-service addr: registrations}.
        self._borrowers: Dict[ObjectID, Dict[str, int]] = {}
        # Both sides: inner oid -> count of live local outer objects
        # holding it (participates in the owner's free condition and in
        # the borrower's deregistration condition).
        self._contained: Dict[ObjectID, int] = {}
        # outer oid -> [(inner oid, remote owner addr or None, registered)]
        self._contained_by: Dict[ObjectID, list] = {}
        # Borrower side: borrowed oid -> owner addr; and which oids hold a
        # HANDLE registration with their owner (at most one per oid —
        # contained-pin registrations are tracked per _contained_by entry).
        self._borrowed_owner: Dict[ObjectID, str] = {}
        self._handle_reg: set = set()

    def set_owned(self, object_id: ObjectID) -> None:
        with self._lock:
            self._owned.add(object_id)

    def add_local_reference(self, object_id: ObjectID,
                            owner_hint: Optional[str] = None) -> None:
        register = None
        with self._lock:
            self._local[object_id] = self._local.get(object_id, 0) + 1
            if (owner_hint and object_id not in self._owned
                    and owner_hint != self._core.owner_address):
                self._borrowed_owner.setdefault(object_id, owner_hint)
                arg_set = _arg_borrow_set()
                if arg_set is not None:
                    arg_set.add(object_id)  # defer: caller's pin covers us
                elif object_id not in self._handle_reg:
                    self._handle_reg.add(object_id)
                    register = self._borrowed_owner[object_id]
        if register:
            self._core._register_borrow(object_id, register)

    def remove_local_reference(self, object_id: ObjectID) -> None:
        self._dec(self._local, object_id)

    def add_submitted_task_reference(self, object_id: ObjectID) -> None:
        with self._lock:
            self._submitted[object_id] = self._submitted.get(object_id, 0) + 1

    def remove_submitted_task_reference(self, object_id: ObjectID) -> None:
        self._dec(self._submitted, object_id)

    # -- owner side: borrower sets ------------------------------------------

    def add_borrower(self, object_id: ObjectID, addr: str) -> bool:
        """A remote process (addr = its owner-service address) borrows an
        object this process owns. False if the object is already freed."""
        with self._lock:
            if object_id not in self._owned:
                return False
            d = self._borrowers.setdefault(object_id, {})
            d[addr] = d.get(addr, 0) + 1
            return True

    def remove_borrower(self, object_id: ObjectID, addr: str) -> None:
        free = False
        with self._lock:
            d = self._borrowers.get(object_id)
            if d is not None and addr in d:
                d[addr] -= 1
                if d[addr] <= 0:
                    del d[addr]
                if not d:
                    del self._borrowers[object_id]
            free = self._maybe_free_locked(object_id)
        if free:
            self._core._free_object(object_id)

    def purge_borrower_addr(self, addr: str) -> None:
        """Drop a dead borrower process from every borrower set (the
        owner-collects-borrowers-on-worker-exit half of the protocol)."""
        to_free = []
        with self._lock:
            for oid in list(self._borrowers):
                if addr in self._borrowers[oid]:
                    del self._borrowers[oid][addr]
                    if not self._borrowers[oid]:
                        del self._borrowers[oid]
                        if self._maybe_free_locked(oid):
                            to_free.append(oid)
        for oid in to_free:
            self._core._free_object(oid)

    def borrower_addrs(self) -> set:
        with self._lock:
            out: set = set()
            for d in self._borrowers.values():
                out.update(d)
            return out

    # -- contained refs (refs inside objects / actor state) -----------------

    def pin_contained(self, outer_oid: ObjectID, inners,
                      already_registered: bool) -> None:
        """Pin refs discovered while serializing ``outer_oid``'s value;
        called by the OUTER object's owner. ``inners`` is a list of
        (ObjectID, owner_addr or None). ``already_registered``: a worker
        already registered this process with the inner owners (return-value
        handover), so only record the matching release obligation."""
        to_register = []
        with self._lock:
            entries = self._contained_by.setdefault(outer_oid, [])
            for oid, owner_addr in inners:
                self._contained[oid] = self._contained.get(oid, 0) + 1
                remote = (owner_addr and oid not in self._owned
                          and owner_addr != self._core.owner_address)
                if remote:
                    self._borrowed_owner.setdefault(oid, owner_addr)
                entries.append((oid, owner_addr if remote else None,
                                bool(remote)))
                if remote and not already_registered:
                    to_register.append((oid, owner_addr))
        for oid, addr in to_register:
            self._core._register_borrow(oid, addr)

    def release_contained(self, outer_oid: ObjectID) -> None:
        """The outer object was freed: drop its inner pins (cascading owned
        frees and remote deregistrations)."""
        notify = []
        to_free = []
        with self._lock:
            for oid, addr, registered in self._contained_by.pop(outer_oid, []):
                n = self._contained.get(oid, 0) - 1
                if n > 0:
                    self._contained[oid] = n
                else:
                    self._contained.pop(oid, None)
                if registered and addr:
                    notify.append((oid, addr))
                if self._maybe_free_locked(oid):
                    to_free.append(oid)
        for oid, addr in notify:
            self._core._deregister_borrow(oid, addr)
        for oid in to_free:
            self._core._free_object(oid)

    # -- worker-side completion handover ------------------------------------

    def retained_arg_borrows(self, candidates: set) -> list:
        """Which deferred arg borrows are still held at task completion —
        these must be registered with their owners BEFORE the reply releases
        the caller's pin. Marks them handle-registered (the caller of this
        method performs the actual RPCs)."""
        retained = []
        with self._lock:
            for oid in candidates:
                if ((self._local.get(oid) or self._submitted.get(oid)
                     or self._contained.get(oid))
                        and oid in self._borrowed_owner
                        and oid not in self._handle_reg):
                    self._handle_reg.add(oid)
                    retained.append((oid, self._borrowed_owner[oid]))
        return retained

    # -- internals -----------------------------------------------------------

    def _maybe_free_locked(self, object_id: ObjectID) -> bool:
        """Owner-side free check; caller holds ``self._lock``."""
        if (object_id in self._owned
                and not self._local.get(object_id)
                and not self._submitted.get(object_id)
                and not self._contained.get(object_id)
                and not self._borrowers.get(object_id)):
            self._owned.discard(object_id)
            return True
        return False

    def _dec(self, table: Dict[ObjectID, int], object_id: ObjectID) -> None:
        free = False
        deregister = None
        with self._lock:
            n = table.get(object_id, 0) - 1
            if n > 0:
                table[object_id] = n
            else:
                table.pop(object_id, None)
            free = self._maybe_free_locked(object_id)
            if (not free and object_id in self._handle_reg
                    and not self._local.get(object_id)
                    and not self._submitted.get(object_id)
                    and not self._contained.get(object_id)):
                # Last local use of a borrowed ref: tell the owner.
                self._handle_reg.discard(object_id)
                deregister = self._borrowed_owner.pop(object_id, None)
        if free:
            self._core._free_object(object_id)
        elif deregister:
            self._core._deregister_borrow(object_id, deregister)

    def drop_owned_if_unreferenced(self, object_id: ObjectID) -> None:
        """Free an owned object that never got (or no longer has) any local
        handle — e.g. generator items the consumer abandoned mid-stream."""
        free = False
        with self._lock:
            free = self._maybe_free_locked(object_id)
        if free:
            self._core._free_object(object_id)


class _Prefetch:
    """One in-flight arg prefetch: resolvers piggyback on it only once a
    pool thread has actually STARTED fetching; a merely-queued prefetch is
    claimed (cancelled) by the resolver instead — waiting on work nobody
    is doing would stall a perfectly fetchable object."""

    __slots__ = ("event", "started")

    def __init__(self):
        self.event = threading.Event()
        self.started = False


class _LocWaiter:
    """One blocked get()'s subscription to an object's seal: the GCS
    location push sets the event and leaves the pushed replica location
    behind, so the woken fetch skips the locate round trip entirely."""

    __slots__ = ("event", "locations")

    def __init__(self):
        self.event = threading.Event()
        self.locations: Optional[list] = None

    def take_locations(self) -> Optional[list]:
        # Re-arm BEFORE reading: a push landing mid-take then re-sets the
        # event and its locations are picked up by this read or the next
        # wakeup — clearing last would erase that push entirely.
        self.event.clear()
        locs, self.locations = self.locations, None
        return locs


class _PendingTask:
    __slots__ = ("refs", "done", "error", "cancelled")

    def __init__(self, refs: List[ObjectID]):
        self.refs = refs
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.cancelled = False  # results arriving after cancel() are dropped


# Max in-flight calls per (actor, handle): bounds client memory for un-acked
# resend copies while keeping the pipe full (the reference's actor submit
# queues are unbounded in flight; a window keeps restart resends cheap).
_ACTOR_WINDOW = 64


class _ActorCall:
    """One submitted actor call held until its reply is acked (the resend
    unit of the pipelined actor transport)."""

    __slots__ = ("spec", "pending", "var_bytes", "digest", "template",
                 "miss_retries", "pinned", "nested_deps")

    def __init__(self, spec: TaskSpec, pending: _PendingTask):
        self.spec = spec
        self.pending = pending
        # Cached-template wire encoding, produced lazily at send time (a
        # resend clears var_bytes so window_min is recomputed).
        self.var_bytes: Optional[bytes] = None
        self.digest: Optional[bytes] = None
        self.template: Optional[bytes] = None
        self.miss_retries = 0  # SpecCacheMiss resends (bounded)
        self.pinned = True  # argument refs pinned until terminal
        self.nested_deps: Optional[list] = None  # refs inside arg values


class _LeasedWorker:
    """A GCS resource lease bound to a daemon-granted worker process — the
    unit of reuse in the direct task transport (the reference's leased-worker
    entry in ``direct_task_transport.h``)."""

    __slots__ = ("lease_id", "node_id", "node_addr", "worker_id", "worker_addr")

    def __init__(self, lease_id, node_id, node_addr, worker_id, worker_addr):
        self.lease_id = lease_id
        self.node_id = node_id
        self.node_addr = node_addr
        self.worker_id = worker_id  # bytes
        self.worker_addr = worker_addr


class _QueuedTask:
    __slots__ = ("spec", "spec_bytes", "digest", "template", "var_bytes",
                 "pending", "attempt", "nested_deps", "finished")

    def __init__(self, spec: TaskSpec, pending: _PendingTask,
                 refcounter: Optional["_LocalRefCounter"] = None,
                 encoder: Optional[SpecEncoder] = None):
        self.spec = spec
        with serialization.collecting_refs() as refs:
            if encoder is not None:
                # Cached-template encoding: pickle only the per-call fields;
                # the invariant template is memoized per callable and shipped
                # to each worker connection once (see task_spec.SpecEncoder).
                self.digest, self.template = encoder.encode_template(spec)
                self.var_bytes = encoder.encode_vars(spec)
                self.spec_bytes = None
            else:
                self.digest = self.template = self.var_bytes = None
                self.spec_bytes = serialization.dumps(spec)
        # Refs nested inside arg VALUES (spec.dependencies() covers only
        # top-level ref args): pin them for the task's duration so the
        # callee's deferred borrow registration has cover (_finish_task
        # releases them).
        self.nested_deps = [r.id for r in refs]
        if refcounter is not None:
            for oid in self.nested_deps:
                refcounter.add_submitted_task_reference(oid)
        self.pending = pending
        self.attempt = 0
        # _finish_task must release the dep pins exactly once even when an
        # exception AFTER a terminal finish routes through the guarded
        # catch-all (which finishes again) — a double release would free
        # objects another in-flight task still depends on.
        self.finished = False


class _KeyState:
    """Per-scheduling-key submission state (SchedulingKey of
    ``direct_task_transport.h:54-56``): a FIFO of queued tasks, the set of
    live runners (one per leased worker), in-flight lease requests, and
    parked idle leases awaiting reuse or expiry.

    ``waiters`` counts runners blocked on ``cv`` for new work — an idle
    HOT runner (thread alive, lease held) serves the next task with one
    cv wake instead of a thread spawn."""

    __slots__ = ("queue", "runners", "requesting", "idle", "cv", "waiters")

    def __init__(self, lock: threading.Lock):
        from collections import deque

        self.queue = deque()  # _QueuedTask
        self.runners = 0
        self.requesting = 0
        self.waiters = 0
        self.idle: List[Tuple[_LeasedWorker, float]] = []
        self.cv = threading.Condition(lock)


def _local_host_toward(address: str) -> str:
    """The local interface IP that routes toward ``address`` — what other
    machines must dial to reach a server in this process. Loopback clusters
    stay on loopback."""
    host = address.rsplit(":", 1)[0]
    if host in ("127.0.0.1", "localhost"):
        return "127.0.0.1"
    import socket as _socket

    probe = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
    try:
        probe.connect((host, 1))  # no traffic; just picks the route
        return probe.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        probe.close()


def _app_error_should_retry(spec: TaskSpec, attempt: int, result: dict) -> bool:
    """Shared retry decision for application errors (retry_exceptions
    option) — ONE definition for both the direct transport and the
    daemon-proxied runtime_env path."""
    retry_exc = spec.options.retry_exceptions
    should = bool(retry_exc) and attempt <= spec.options.max_retries
    if should and isinstance(retry_exc, (list, tuple)):
        cause_type = result.get("error_type", "")
        should = any(t.__name__ == cause_type for t in retry_exc)
    return should


def _retry_delay(attempt: int) -> float:
    """Backoff before re-leasing after a worker death, so the node's reaper
    collects the corpse first (retry pacing, task_manager.cc)."""
    return min(0.2 * attempt, 2.0)


class _GenState:
    """Owner-side view of one streaming generator task: items indexed as
    reported (notes may arrive out of order across pool threads), a done
    flag + total, and the consumer's progress for producer backpressure."""

    __slots__ = ("items", "total", "cv", "consumed", "lock", "error_at",
                 "released", "released_at")

    def __init__(self):
        self.items: Dict[int, ObjectID] = {}
        self.total: Optional[int] = None  # set when the task completes
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.consumed = 0
        # Index where a task error was sealed into the stream. Item reports
        # racing the error reply (different connections, no ordering) must
        # neither overwrite it nor extend the stream past it.
        self.error_at: Optional[int] = None
        # Consumer dropped its generator handle: late producer reports are
        # discarded instead of resurrecting the stream (which nothing would
        # ever reclaim again).
        self.released = False
        self.released_at = 0.0

    def contiguous_len(self) -> int:
        """Length of the gap-free item prefix. Caller holds ``lock``."""
        n = 0
        while n in self.items:
            n += 1
        return n


class _OwnerService:
    """RPC facade serving objects this process OWNS from its in-process
    value cache — the analog of the reference's ownership-based object
    directory (``ownership_based_object_directory.cc``: small objects live
    in the owner's memory store and are resolved by asking the owner, not a
    central service). Every CoreWorker (drivers included) runs one."""

    def __init__(self, core: "CoreWorker"):
        self._core = core

    def fetch_owned(self, oid_bytes: bytes) -> Optional[bytes]:
        # Serves ONLY inline-small objects (no sealed replica exists) from
        # the payload snapshotted at seal time: borrowers see the value as
        # of put/return, not later mutations, and no re-serialization is
        # paid per fetch. Large cached values have a shm/daemon replica —
        # borrowers use the data plane for those.
        with self._core._cache_lock:
            return self._core._inline_owned.get(ObjectID(oid_bytes))

    def fetch_owned_batch(self, oid_bytes_list) -> list:
        """Batched :meth:`fetch_owned`: one round trip serves every
        inline-owned ref of a get([refs]) batch (None per miss) — N small
        owner fetches collapse into one frame instead of N round trips."""
        with self._core._cache_lock:
            inline = self._core._inline_owned
            return [inline.get(ObjectID(b)) for b in oid_bytes_list]

    def has_owned(self, oid_bytes: bytes) -> bool:
        with self._core._cache_lock:
            return ObjectID(oid_bytes) in self._core._inline_owned

    # -- streaming generator reports (core_worker.cc:3199 analog) ---------

    def report_generator_item(self, task_id_bytes: bytes, index: int,
                              oid_bytes: bytes,
                              inline: Optional[bytes] = None) -> None:
        """A producing worker pushes one generator item AS PRODUCED — the
        consumer's iterator unblocks before the task finishes. Small item
        values ride inline into the owner's cache (owner-served); big ones
        were sealed node-side by the producer."""
        from ray_tpu_torch.core.ids import TaskID

        core = self._core
        oid = ObjectID(oid_bytes)
        state = core._generator_state(TaskID(task_id_bytes))
        with state.cv:
            if state.released or (state.error_at is not None
                                  and index >= state.error_at):
                # Stream already terminated (error sealed / consumer dropped
                # the handle): drop the report BEFORE caching its payload —
                # an entry cached here would be unreachable by both
                # release_generator (not in state.items) and refcounting
                # (never owned), leaking in the owner forever.
                return
            # Cache the payload even when the index is already present: the
            # completion reply (a DIFFERENT connection) can merge this
            # item's id into state.items before this report lands, and the
            # inline payload exists nowhere else. setdefault (not
            # assignment) protects already-present entries in the map.
            if inline is not None:
                with core._cache_lock:
                    core._cache[oid] = serialization.loads(inline)
                    core._inline_owned[oid] = bytes(inline)
                # Register inline items with the owner's reference counter
                # so consumed-and-dropped items are freed instead of
                # accumulating for the owner's lifetime (unconsumed ones
                # are collected by release_generator).
                core.reference_counter.set_owned(oid)
            state.items.setdefault(index, oid)
            state.cv.notify_all()

    def generator_progress(self, task_id_bytes: bytes) -> int:
        """Producer backpressure probe: how far the consumer has iterated."""
        from ray_tpu_torch.core.ids import TaskID

        state = self._core._generator_state(TaskID(task_id_bytes))
        with state.lock:
            return state.consumed

    # -- borrower protocol (reference_count.h:61) -------------------------

    def add_borrower(self, oid_bytes: bytes, addr: str) -> bool:
        """A remote process registers as borrower of an object WE own.
        False = already freed (the borrower treats the ref as lost)."""
        ok = self._core.reference_counter.add_borrower(ObjectID(oid_bytes),
                                                       addr)
        if ok:
            self._core._ensure_borrower_sweeper()
        return ok

    def remove_borrower(self, oid_bytes: bytes, addr: str) -> None:
        self._core.reference_counter.remove_borrower(ObjectID(oid_bytes),
                                                     addr)

    def ping(self) -> str:
        return "pong"


class CoreWorker:
    """The per-process runtime client (driver or worker mode)."""

    def __init__(self, gcs_address: str, *,
                 node_id: NodeID | None = None,
                 node_address: str | None = None,
                 store_name: str = "",
                 job_id: JobID | None = None,
                 namespace: str = "default",
                 mode: str = "driver"):
        self.gcs_address = gcs_address
        self.mode = mode
        self.namespace = namespace
        if mode == "driver":
            # Workers init in worker_main (before CoreWorker); the
            # cluster-attached driver gets its ring here.
            from ray_tpu_torch.util import flightrec

            flightrec.init("driver")
        self._gcs_rpc = RpcClient(gcs_address)
        self.gcs = _GcsClientAdapter(self._gcs_rpc)
        self.scheduler = _SchedulerProxy(self._gcs_rpc)
        self.reference_counter = _LocalRefCounter(self)
        self._daemons = RpcClientPool()
        self._actor_clients = RpcClientPool()

        # Local node binding (for puts + zero-copy shm gets). Nodes may be
        # mid-(re)registration — e.g. a driver attaching right after a GCS
        # restart — so poll briefly before giving up.
        if node_id is None:
            deadline = time.time() + 15.0
            while True:
                nodes = self._gcs_rpc.call("list_nodes")
                alive = [n for n in nodes if n["alive"]]
                if alive:
                    break
                if time.time() > deadline:
                    raise RuntimeError("no alive nodes in cluster")
                time.sleep(0.2)
            node_id = alive[0]["node_id"]
            node_address = alive[0]["address"]
            store_name = alive[0]["labels"].get("_object_store", "")
        self.current_node_id = node_id
        self._node_address = node_address
        self._local_daemon = self._daemons.get(node_address)
        self._shm = None
        if store_name:
            try:
                from ray_tpu_torch.core.native_store import NativeObjectStore

                self._shm = NativeObjectStore.open(store_name)
            except Exception:  # noqa: BLE001 — daemon RPC path still works
                logger.debug("cannot open shm store %r; using daemon fetch",
                             store_name)

        self.job_id = job_id or self._gcs_rpc.call("next_job_id")
        if mode == "driver":
            import os

            self._gcs_rpc.notify("add_job", self.job_id, "driver", os.getpid())

        # Object value cache (the in-process memory store of the reference).
        self._cache: Dict[ObjectID, Any] = {}
        self._cache_lock = threading.Lock()
        self._cache_cv = threading.Condition(self._cache_lock)
        self._pending: Dict[ObjectID, _PendingTask] = {}
        # Objects this process owns whose ONLY replica is local (inline
        # returns, small puts, error seals): oid -> payload snapshot taken
        # at seal time, served by the owner service (_OwnerService).
        self._inline_owned: Dict[ObjectID, bytes] = {}

        # Task submission machinery.
        self._submit_pool = ThreadPoolExecutor(max_workers=128,
                                               thread_name_prefix="submit")
        # Cached task-spec encoding (the wire fast path): steady-state calls
        # ship (digest, args) instead of a full pickled spec.
        self._spec_encoder = SpecEncoder()
        self._actor_addr_cache: Dict[ActorID, str] = {}
        self._actor_queues: Dict[tuple, dict] = {}
        self._generators: Dict[TaskID, _GenState] = {}
        # Direct task transport: per-scheduling-key lease/worker reuse.
        self._worker_clients = RpcClientPool()
        self._key_states: Dict[tuple, _KeyState] = {}
        self._key_lock = threading.Lock()
        self._lease_sweeper_started = False
        # Bounded lease-requester pool (lazy): caps concurrent lease RPCs
        # at lease_requester_threads instead of one thread per queued task.
        self._lease_pool: Optional[ThreadPoolExecutor] = None

        # Batched owner frees (see _free_object).
        self._free_lock = threading.Lock()
        self._free_batch: List[bytes] = []
        self._free_flusher = None

        # __del__-deferred releases (see release_local_ref): a finalizer
        # can run at ANY decref point — including while this thread holds
        # _cache_lock (a cache pop decrefs a value whose contained refs
        # finalize right there) or an RPC client's state lock — so
        # finalizers must not acquire locks or send. They append to this
        # deque (atomic, lock-free under the GIL); the drainer thread does
        # the real refcount work with no locks held.
        self._ref_releases: deque = deque()
        self._ref_release_stop = threading.Event()
        self._ref_release_thread = threading.Thread(
            target=self._ref_release_loop, name="ref-release", daemon=True)
        self._ref_release_thread.start()

        # Owner service: inline-small objects are served from this process's
        # cache instead of being sealed through the node daemon (ownership-
        # based directory; see _OwnerService).
        from ray_tpu_torch.core.rpc import RpcServer

        # Bind on the interface that routes toward the GCS so owner-served
        # objects stay reachable on multi-host clusters (loopback clusters
        # stay loopback).
        self._owner_server = RpcServer(
            _OwnerService(self), host=_local_host_toward(gcs_address),
            name="owner", max_workers=16)
        self.owner_address = self._owner_server.address
        self._owner_clients = RpcClientPool()
        # addr -> (retry_after, first_failure) for owner probes
        self._owner_down: Dict[str, tuple] = {}
        self._ready_probe: Dict[ObjectID, float] = {}  # wait() probe throttle
        self._ready_probe_sweep = 0.0  # next allowed eviction sweep
        self._borrow_sweeper_started = False
        self._pull = None  # lazy PullManager (chunked node-to-node fetches)

        # Parallel object-plane read path: get() fan-out + location-push
        # wakeups. _loc_waiters holds per-oid waiters blocked in _get_one;
        # a lazily started subscriber long-polls the GCS object-location
        # channel and wakes them on seal (locations ride the wakeup).
        self._stats = {"locate_calls": 0, "push_wakeups": 0,
                       "poll_timeouts": 0, "backoff_sleeps": 0}
        self._loc_lock = threading.Lock()
        self._loc_waiters: Dict[ObjectID, list] = {}
        self._loc_sub_running = False
        # In-flight arg prefetches: oid -> _Prefetch, finished (event set)
        # when the fetch completes either way. A concurrent resolver WAITS
        # on a STARTED prefetch instead of opening a second full fetch of
        # the same bytes, and CLAIMS a merely-queued one.
        self._prefetching: Dict[ObjectID, _Prefetch] = {}
        self._prefetch_pool: Optional[ThreadPoolExecutor] = None
        self._get_pool: Optional[ThreadPoolExecutor] = None

        # Execution context (worker mode fills these per task).
        self.current_task_id: Optional[TaskID] = None
        self.current_actor_id: Optional[ActorID] = None
        # Blocked-worker protocol hooks (worker_main wires these): called
        # when a get() blocks >50ms / when it unblocks, to release and
        # reacquire the running task's lease.
        self.blocked_on_get = None
        self.unblocked_after_get = None
        self._shutdown = False

        # Metrics plane: this process's exporter ships the registry to the
        # GCS every metrics_export_interval_s (component = driver | worker).
        from ray_tpu_torch.core.metrics_export import MetricsExporter

        self._metrics_exporter = MetricsExporter(
            report=self.gcs.report_metrics,
            node_id=self.current_node_id.hex() if self.current_node_id
            else "", component=mode,
            collectors=[self._collect_core_metrics]).start()

    def _collect_core_metrics(self) -> None:
        """Mirror this core's object-plane read stats + spec-cache hit rate
        into gauges (runs only at export ticks, never on hot paths)."""
        from ray_tpu_torch.core.metrics_export import gauge, mirror_stats_gauge

        mirror_stats_gauge(
            "ray_tpu_object_reads",
            "Object-plane read-path counters (locate calls, push wakeups, "
            "poll timeouts, backoff sleeps)", self._stats)
        spec = self._spec_encoder.stats()
        gauge("ray_tpu_spec_cache_hit_rate",
              "Cached task-spec encoding wire hit rate").set(
            float(spec["hit_rate"]))

    # ====================== objects ======================

    def put(self, value) -> ObjectRef:
        oid = ObjectID.for_put()
        self._seal_object(oid, value)
        self.reference_counter.set_owned(oid)
        return ObjectRef(oid, owner_hint=self.owner_address)

    def _seal_object(self, oid: ObjectID, value, lineage: bytes | None = None) -> None:
        """Store locally + make fetchable cluster-wide."""
        with self._cache_cv:
            self._cache[oid] = value
            self._cache_cv.notify_all()
        with serialization.collecting_refs() as inner_refs:
            ser = serialization.serialize(value)
        if inner_refs:
            # The sealed value CONTAINS refs: pin them for the object's
            # lifetime (nested-ref borrow protocol) — a consumer extracting
            # them later is covered until this outer object is freed.
            self.reference_counter.pin_contained(
                oid, [(r.id, r._owner_hint) for r in inner_refs],
                already_registered=False)
        size = ser.framed_size()
        if size <= config().max_inline_object_size:
            # Small objects stay in the owner's cache and are served by the
            # owner service — no daemon seal, no GCS location row (the
            # reference keeps sub-100KiB objects in the owner's in-process
            # memory store, core_worker.cc:1198).
            with self._cache_lock:
                self._inline_owned[oid] = ser.to_bytes()
            return
        self.seal_serialized(oid, ser, lineage)

    def seal_serialized(self, oid: ObjectID,
                        ser: "serialization.SerializedObject",
                        lineage: bytes | None = None) -> None:
        """Make a serialized object fetchable cluster-wide, writing the
        frame DIRECTLY into the local shm arena when possible (no
        intermediate contiguous copy — fresh-heap materialization of a big
        payload costs more than the arena write itself)."""
        from ray_tpu_torch.core.node_daemon import NodeDaemon

        key = NodeDaemon._shm_key(oid.binary())
        size = ser.framed_size()
        if self._shm is not None and size >= config().native_store_threshold:
            view = None
            try:
                view = self._shm.create(key, size)
            except Exception:  # noqa: BLE001 — store closed etc.
                view = None
            if view is not None:
                try:
                    ser.write_into(view)
                except BaseException:  # noqa: BLE001 — never leak unsealed
                    self._shm.abort(key)
                    raise
                self._shm.seal(key)
                self._gcs_rpc.notify("add_object_location", oid.binary(),
                                     self.current_node_id, size, lineage)
                return
        self.seal_payload(oid, ser.to_bytes(), lineage)

    def seal_payload(self, oid: ObjectID, payload, lineage: bytes | None = None) -> None:
        """Contiguous-payload variant of :meth:`seal_serialized`: shm arena
        → chunked spill upload for oversized payloads (bounded frames both
        sides) → daemon heap note for the rest."""
        from ray_tpu_torch.core.node_daemon import NodeDaemon

        key = NodeDaemon._shm_key(oid.binary())
        size = len(memoryview(payload).cast("B"))
        cfg = config()
        if self._shm is not None and size >= cfg.native_store_threshold:
            try:
                self._shm.put(key, payload)
                self._gcs_rpc.notify("add_object_location", oid.binary(),
                                     self.current_node_id, size, lineage)
                return
            except Exception:  # noqa: BLE001 — arena full
                log_swallowed(logger, "shm put of owned object")
        if size > cfg.pull_chunk_size:
            # Too big for the arena (or no arena): chunked upload straight
            # to the daemon's spill shelf — neither side holds a second
            # whole copy, no object-sized socket frame.
            from ray_tpu_torch.core.object_transfer import PushManager

            if PushManager(self._daemons).push_spill(
                    self._node_address, oid.binary(), payload):
                self._gcs_rpc.notify("add_object_location", oid.binary(),
                                     self.current_node_id, size, lineage)
                return
        try:
            self._local_daemon.notify("put_object", oid.binary(), payload,
                                      lineage)
        except RpcConnectionError:
            logger.warning("local daemon unreachable; object %s is cache-only",
                           oid.hex()[:12])

    # -- borrower protocol plumbing (reference_count.h:61) -------------------

    def _register_borrow(self, oid: ObjectID, owner_addr: str) -> bool:
        """Synchronously register this process as a borrower with the
        object's owner. False = the owner already freed it (the ref then
        resolves like any lost object)."""
        try:
            ok = bool(self._owner_clients.get(owner_addr).call(
                "add_borrower", oid.binary(), self.owner_address,
                timeout=30.0))
        except (RpcConnectionError, TimeoutError):
            return False
        return ok

    def _deregister_borrow(self, oid: ObjectID, owner_addr: str) -> None:
        try:
            self._owner_clients.get(owner_addr).notify(
                "remove_borrower", oid.binary(), self.owner_address)
        except RpcConnectionError:
            pass  # owner gone; nothing left to free remotely

    def _ensure_borrower_sweeper(self) -> None:
        if self._borrow_sweeper_started:
            return
        # Event + thread handle BEFORE the flag: shutdown() keys on the
        # flag and would AttributeError on a half-published sweeper.
        self._borrow_sweep_stop = threading.Event()
        self._borrow_sweeper = threading.Thread(
            target=self._sweep_dead_borrowers, name="borrow-sweeper",
            daemon=True)
        self._borrow_sweeper_started = True
        self._borrow_sweeper.start()

    # Failed-ping strikes before a borrower is purged: fast when nothing is
    # listening on its port (process is gone), slow when a listener exists
    # (a live borrower merely starved — GIL held by a big pickle/jit, loaded
    # RPC pool — must NOT lose its borrowed objects: purging it would be a
    # distributed use-after-free).
    _BORROW_PURGE_STRIKES_DEAD = 2      # ~10 s, corroborated by conn-refused
    _BORROW_PURGE_STRIKES_UNSURE = 24   # ~2 min of continuous unresponsiveness

    @staticmethod
    def _borrower_listening(addr: str) -> Optional[bool]:
        """Liveness corroboration for an unresponsive borrower: a raw TCP
        connect to its owner-service port. The kernel accepts on the listen
        backlog without the process's GIL, so a starved-but-alive borrower
        still connects; a dead process's port refuses. True = listener
        exists, False = refused (nothing bound — process gone), None =
        unreachable (network blip; treat as unknown)."""
        import socket as _socket

        host, port = addr.rsplit(":", 1)
        try:
            s = _socket.create_connection((host, int(port)), timeout=2.0)
            s.close()
            return True
        except ConnectionRefusedError:
            return False
        except OSError:
            return None

    def _sweep_dead_borrowers(self) -> None:
        """Owner side: purge borrower processes that died without
        deregistering (the reference's on-worker-exit borrower collection;
        here by probing each borrower's owner-service address, corroborated
        by a raw listener probe so an alive-but-unresponsive borrower keeps
        its borrows)."""
        strikes: Dict[str, int] = {}
        # Event-paced (not time.sleep) so shutdown can cut the 5s nap
        # short and actually join this thread.
        while not self._borrow_sweep_stop.wait(5.0) and not self._shutdown:
            addrs = self.reference_counter.borrower_addrs()
            for addr in list(strikes):
                if addr not in addrs:
                    strikes.pop(addr, None)
            for addr in addrs:
                try:
                    self._owner_clients.get(addr).call("ping", timeout=5.0)
                    strikes.pop(addr, None)
                except (RpcConnectionError, TimeoutError):
                    strikes[addr] = strikes.get(addr, 0) + 1
                    threshold = self._BORROW_PURGE_STRIKES_UNSURE
                    if self._borrower_listening(addr) is False:
                        threshold = self._BORROW_PURGE_STRIKES_DEAD
                    if strikes[addr] >= threshold:
                        strikes.pop(addr, None)
                        self._owner_clients.invalidate(addr)
                        self.reference_counter.purge_borrower_addr(addr)

    def release_local_ref(self, oid: ObjectID) -> None:
        """GC-context entry point (``ObjectRef.__del__``): defer the
        refcount drop to the drainer thread. Finalizers run at arbitrary
        decref points — possibly with _cache_lock or an RPC client's state
        lock held on this very thread — so doing the free work (which takes
        _cache_lock and may send deregistration RPCs) inline is a lock-order
        inversion the runtime validator flags. deque.append is atomic."""
        self._ref_releases.append(("ref", oid))

    def release_generator_deferred(self, task_id: TaskID) -> None:
        """GC-context entry point (``ObjectRefGenerator.__del__``); same
        contract as release_local_ref — release_generator takes
        _cache_lock, which may already be held at the finalizer's site."""
        self._ref_releases.append(("gen", task_id))

    def _ref_release_loop(self) -> None:
        """Drainer for __del__-deferred releases: runs the real refcount
        work lock-free-context (this thread holds nothing across calls).
        Deferral only delays decrements, so counts are transiently high —
        never low: no premature frees, and the borrow tests' _drained()
        polls absorb the ~20ms cadence."""
        q = self._ref_releases

        def drain() -> None:
            while q:
                kind, arg = q.popleft()
                try:
                    if kind == "ref":
                        self.reference_counter.remove_local_reference(arg)
                    else:
                        self.release_generator(arg)
                except Exception:  # noqa: BLE001 — release is best-effort
                    log_swallowed(logger, "deferred ref release")

        while True:
            drain()
            if self._ref_release_stop.wait(timeout=0.02):
                drain()  # entries queued during the final wait
                return

    def _free_object(self, oid: ObjectID) -> None:
        """Owner-side free: drop the local value now, batch the cluster-wide
        free (one note per ~100 objects / 100 ms instead of one per ref —
        the reference batches frees the same way in its io_service)."""
        self.reference_counter.release_contained(oid)
        with self._cache_lock:
            self._cache.pop(oid, None)
            self._inline_owned.pop(oid, None)
        batch = None
        with self._free_lock:
            self._free_batch.append(oid.binary())
            if self._free_flusher is None:
                self._free_flusher = threading.Timer(0.1, self._flush_frees)
                self._free_flusher.daemon = True
                self._free_flusher.start()
            elif len(self._free_batch) >= 100:
                batch, self._free_batch = self._free_batch, []
        if batch:
            self._send_frees(batch)  # socket write OUTSIDE the lock

    def _flush_frees(self) -> None:
        with self._free_lock:
            batch, self._free_batch = self._free_batch, []
            self._free_flusher = None
        if batch:
            self._send_frees(batch)

    def _send_frees(self, batch) -> None:
        try:
            self._gcs_rpc.notify("free_objects", batch)
        except RpcConnectionError:
            pass

    def get(self, refs, timeout: float | None = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
        deadline = time.time() + timeout if timeout is not None else None
        try:
            if len(ref_list) > 1:
                # Batched fan-out: ONE locate round trip, concurrent
                # fetches, caller-order results (see _get_batch).
                values = self._get_batch(ref_list, deadline)
            else:
                values = [self._get_one(r, deadline) for r in ref_list]
            for value in values:
                if isinstance(value, TaskError):
                    raise value.as_instanceof_cause()
                if isinstance(value, (TaskCancelledError, ActorError)):
                    raise value
        finally:
            # Blocked-worker protocol: _get_one only ever RELEASES the
            # running task's lease; reacquire once per get() batch, not per
            # ref (hooks are idempotent no-ops when nothing was released).
            if self.unblocked_after_get is not None:
                self.unblocked_after_get()
        return values[0] if single else values

    def get_stats(self) -> dict:
        """Read-path counters (benches/tests): locate RPCs issued by fetch
        probes, push wakeups vs fallback-poll timeouts, and legacy backoff
        sleeps (only taken with ``location_sub_enabled`` off)."""
        return dict(self._stats)

    def _get_batch(self, ref_list: List[ObjectRef], deadline: float | None,
                   notify_blocked: bool = True) -> list:
        """Resolve many refs concurrently through a bounded fan-out.

        Dedupes ids, issues ONE ``locate_object_batch`` GCS round trip for
        the unknown misses (vs one ``locate_object`` per ref), then fetches
        every miss concurrently on up to ``get_fanout`` threads — total
        in-flight pull bytes stay capped because all fetches share this
        worker's :class:`PullManager` budget. Results come back in caller
        order with serial first-error semantics preserved: refs are awaited
        in order, and when one resolves to an error value the remaining
        fetches are abandoned — the returned list is then SHORT, with the
        error value last (the caller raises from it), exactly like the old
        per-ref loop never reaching later refs.
        """
        order: List[ObjectRef] = []
        seen: set = set()
        for r in ref_list:
            if r.id not in seen:
                seen.add(r.id)
                order.append(r)
        with self._cache_lock:
            values = {r.id: self._cache[r.id] for r in order
                      if r.id in self._cache}
            missing = [r for r in order if r.id not in values]
            unknown = [r for r in missing if r.id not in self._pending]
        if not missing:
            return [values[r.id] for r in ref_list]
        # One control-plane round trip locates every unknown miss; the
        # results seed each fetch's first probe (locations hint).
        located: Dict[ObjectID, list] = {}
        if unknown:
            try:
                self._stats["locate_calls"] += 1
                batches = self._gcs_rpc.call(
                    "locate_object_batch",
                    [r.id.binary() for r in unknown], timeout=30.0)
                for r, locs in zip(unknown, batches):
                    located[r.id] = locs
            except (RpcConnectionError, TimeoutError):
                pass  # per-ref fetches fall back to their own locate
        # Owner-batch: misses with no daemon replica that share an owner
        # collapse into ONE fetch_owned_batch round trip per owner process
        # (inline objects live only in their owner's store — the dominant
        # shape of a many-small-refs get).
        owner_groups: Dict[str, List[ObjectRef]] = {}
        for r in missing:
            hint = getattr(r, "_owner_hint", None)
            if (hint and hint != self.owner_address
                    and not located.get(r.id)
                    and not self._owner_unreachable(hint)):
                owner_groups.setdefault(hint, []).append(r)
        for hint, group in owner_groups.items():
            if len(group) < 2:
                continue
            try:
                payloads = self._owner_clients.get(hint).call(
                    "fetch_owned_batch",
                    [r.id.binary() for r in group], timeout=30.0)
                self._note_owner_alive(hint)
            except (RpcConnectionError, TimeoutError):
                self._note_owner_unreachable(hint)
                continue
            except Exception:  # noqa: BLE001 — peer without the batch RPC
                continue
            loaded = [(r, serialization.loads(p))
                      for r, p in zip(group, payloads) if p is not None]
            with self._cache_cv:
                for r, value in loaded:
                    self._cache.setdefault(r.id, value)
                    values[r.id] = self._cache[r.id]
                if loaded:
                    self._cache_cv.notify_all()
        missing = [r for r in missing if r.id not in values]
        if not missing:
            return [values[r.id] for r in ref_list]
        cancel = threading.Event()
        # PER-CALL concurrency is bounded by the semaphore (the get_fanout
        # knob); the threads come from a persistent shared pool, and each
        # fetch runs in bounded ~1s SLICES that requeue themselves — a
        # blocked fetch never holds a pool thread across its whole wait,
        # so concurrent gets of ready objects can't starve behind it.
        sem = threading.Semaphore(max(1, config().get_fanout))
        pool = self._fanout_pool()
        futs = {r.id: self._submit_sliced_fetch(
                    pool, sem, r, deadline, located.get(r.id), cancel)
                for r in missing}
        out: list = []
        error_found = False
        try:
            for r in ref_list:
                if r.id not in values:
                    values[r.id] = self._await_batch_future(
                        futs[r.id], r, deadline, notify_blocked)
                v = values[r.id]
                out.append(v)
                if isinstance(v, (TaskError, TaskCancelledError, ActorError)):
                    # Serial first-error semantics: later refs are never
                    # waited for once an earlier one resolved to an error.
                    error_found = True
                    return out
            return out
        except BaseException:
            error_found = True
            raise
        finally:
            if error_found:
                cancel.set()

    def _fanout_pool(self) -> ThreadPoolExecutor:
        """Shared executor behind every batched get's fan-out. Fetches run
        in bounded slices (see _submit_sliced_fetch), so pool threads are
        never held across an unbounded wait; the size just sets how many
        fetch slices run at once across all concurrent gets."""
        pool = self._get_pool
        if pool is None:
            with self._cache_lock:
                if self._get_pool is None:
                    self._get_pool = ThreadPoolExecutor(
                        max_workers=max(32, config().get_fanout * 8),
                        thread_name_prefix="get-fanout")
                pool = self._get_pool
        return pool

    _FETCH_SLICE_S = 1.0

    def _submit_sliced_fetch(self, pool: ThreadPoolExecutor, sem, ref,
                             deadline: float | None, locations, cancel
                             ) -> Future:
        """Run one ref's fetch as a chain of bounded pool slices.

        Each slice runs _get_one with a ~1s sub-deadline; an unresolved
        slice REQUEUES itself and returns its thread to the pool, so an
        open-ended wait (deadline None is the norm) occupies a thread for
        at most one slice at a time and unrelated gets interleave fairly.
        The semaphore (per-call get_fanout bound) is held only within a
        slice — waiting for it parks the thread at most 0.1s before the
        slice requeues."""
        out: Future = Future()
        hint = [locations]  # consumed by the first slice's first probe

        def run_slice():
            if out.done():
                return
            if not sem.acquire(timeout=0.1):
                requeue()
                return
            try:
                if cancel.is_set():
                    out.set_exception(GetTimeoutError(
                        f"get() abandoned on {ref.id.hex()[:12]}"))
                    return
                now = time.time()
                eff = (now + self._FETCH_SLICE_S if deadline is None
                       else min(deadline, now + self._FETCH_SLICE_S))
                loc, hint[0] = hint[0], None
                try:
                    value = self._get_one(ref, eff, False, loc, cancel)
                except GetTimeoutError:
                    if ((deadline is None or time.time() < deadline)
                            and not cancel.is_set()):
                        requeue()  # slice expired, not the caller's deadline
                        return
                    out.set_exception(GetTimeoutError(
                        f"get() timed out on {ref.id.hex()[:12]}"))
                except BaseException as exc:  # noqa: BLE001
                    out.set_exception(exc)
                else:
                    out.set_result(value)
            finally:
                sem.release()

        def requeue():
            try:
                pool.submit(run_slice)
            except RuntimeError:  # pool shut down (process exit)
                out.set_exception(GetTimeoutError(
                    f"get() abandoned on {ref.id.hex()[:12]}"))

        requeue()
        return out

    def _await_batch_future(self, fut: Future, ref: ObjectRef,
                            deadline: float | None, notify_blocked: bool):
        """Wait for one fan-out fetch on the coordinating thread, engaging
        the blocked-worker hook like the serial path (the fetch threads
        never touch it — the lease belongs to THIS thread's task)."""
        started = time.time()
        slice_s = 0.05  # first slice short so the hook fires at ~50ms
        while True:
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                try:
                    # The fetch may have completed just as the deadline
                    # hit — a value that's already here must be returned,
                    # exactly as the serial path's cache check would.
                    return fut.result(timeout=0)
                except FuturesTimeout:
                    raise GetTimeoutError(
                        f"get() timed out on {ref.id.hex()[:12]}") from None
            try:
                return fut.result(timeout=min(slice_s, remaining)
                                  if remaining is not None else slice_s)
            except FuturesTimeout:
                if fut.done():
                    # Done now: either the value landed in the race window
                    # after the wait expired (return it) or the fetch
                    # itself raised (result re-raises the REAL exception —
                    # on 3.11+ futures.TimeoutError aliases TimeoutError,
                    # which a fetch's own GetTimeoutError subclasses, so
                    # a bare re-raise would conflate the two).
                    return fut.result(timeout=0)

            if (notify_blocked and self.blocked_on_get is not None
                    and time.time() - started > 0.05):
                notify_blocked = False
                self.blocked_on_get()
            slice_s = 0.5

    def resolve_refs(self, refs: List[ObjectRef],
                     deadline: float | None = None,
                     notify_blocked: bool = True) -> list:
        """Raw-value resolution for task-argument fetch: like get() but
        errors come back AS VALUES (the caller wraps them in its own
        dependency-failure protocol). Same short-list-on-error contract as
        :meth:`_get_batch`."""
        if len(refs) == 1:
            return [self._get_one(refs[0], deadline,
                                  notify_blocked=notify_blocked)]
        return self._get_batch(refs, deadline, notify_blocked=notify_blocked)

    def prefetch_refs(self, refs: List[ObjectRef]) -> None:
        """Fire-and-forget concurrent resolution into the local cache —
        task-arg prefetch: dependency fetch overlaps queueing/admission
        instead of starting when the task finally runs. Bounded by a shared
        ``get_fanout``-wide pool; duplicate prefetches of an oid coalesce."""
        todo = []
        with self._cache_lock:
            for r in refs:
                if r.id in self._cache or r.id in self._prefetching:
                    continue
                self._prefetching[r.id] = _Prefetch()
                todo.append(r)
            if todo and self._prefetch_pool is None:
                self._prefetch_pool = ThreadPoolExecutor(
                    max_workers=max(1, config().get_fanout),
                    thread_name_prefix="prefetch")
            pool = self._prefetch_pool
        for i, r in enumerate(todo):
            try:
                pool.submit(self._prefetch_one, r)
            except RuntimeError:  # pool shut down (process exit)
                # Finish EVERY not-yet-submitted registration, not just
                # this one — a leaked never-set Event would park later
                # resolvers on the piggyback wait forever.
                for rr in todo[i:]:
                    self._finish_prefetch(rr.id)
                return

    def _prefetch_one(self, ref: ObjectRef) -> None:
        with self._cache_lock:
            ent = self._prefetching.get(ref.id)
            if ent is None:
                return  # claimed by a resolver while we sat in the queue
            ent.started = True
        try:
            self._get_one(ref, time.time() + 300.0, notify_blocked=False,
                          is_prefetch=True)
        except BaseException:  # noqa: BLE001 — advisory; the real arg
            log_swallowed(logger, "prefetch fetch")  # fetch surfaces errors
        finally:
            self._finish_prefetch(ref.id)

    def _finish_prefetch(self, oid: ObjectID) -> None:
        with self._cache_lock:
            ent = self._prefetching.pop(oid, None)
        if ent is not None:
            ent.event.set()  # release resolvers piggybacking on this fetch

    def _get_one(self, ref: ObjectRef, deadline: float | None,
                 notify_blocked: bool = True, locations: list | None = None,
                 cancel_event: threading.Event | None = None,
                 is_prefetch: bool = False):
        """Resolve one ref; while BLOCKED in a worker, the task's lease is
        released so nested tasks can't deadlock a fully leased cluster
        (the reference's blocked-worker CPU release), and reacquired on the
        same node before returning.

        ``locations`` seeds the FIRST fetch probe (the batched get's single
        locate round trip), consumed once. ``cancel_event`` is the
        abandoned-batch signal — exit promptly once the coordinating get()
        has already raised. While waiting for a seal, a registered
        location waiter wakes on the GCS object-location push (the pushed
        location rides the wakeup, so the retry skips locate entirely);
        the timed wait doubles as the low-frequency poll fallback that
        survives a GCS restart."""
        oid = ref.id
        backoff = 0.001
        missing_since: float | None = None
        recovered = False
        started = time.time()
        warn_after = config().get_timeout_warn_s
        last_locate = 0.0
        notified_blocked = not notify_blocked
        owner_hint = getattr(ref, "_owner_hint", None)
        waiter = None
        sub_enabled = config().location_sub_enabled
        # Owner-served (inline) objects never publish a location row, so
        # their seal can only be seen by the owner probe — keep that poll
        # at the legacy cadence. Everything else can relax to a slow
        # fallback poll because the push wakes it.
        poll_cap = 0.1 if (owner_hint and owner_hint != self.owner_address
                           ) or not sub_enabled else 0.5
        try:
            while True:
                if cancel_event is not None and cancel_event.is_set():
                    raise GetTimeoutError(
                        f"get() abandoned on {oid.hex()[:12]}")
                if warn_after and time.time() - started > warn_after:
                    logger.warning(
                        "get() on %s still waiting after %.0fs",
                        oid.hex()[:12], warn_after)
                    warn_after = 0.0
                if (not notified_blocked
                        and self.blocked_on_get is not None
                        and time.time() - started > 0.05):
                    notified_blocked = True
                    self.blocked_on_get()
                with self._cache_lock:
                    if oid in self._cache:
                        return self._cache[oid]
                    pending = self._pending.get(oid)
                    inflight = None
                    if not is_prefetch:
                        ent = self._prefetching.get(oid)
                        if ent is not None:
                            if ent.started:
                                inflight = ent.event
                            else:
                                # Queued but not running: claim it — THIS
                                # thread becomes the fetch (the queued
                                # prefetch no-ops when it finds its entry
                                # gone).
                                self._prefetching.pop(oid, None)
                                ent.event.set()
                if inflight is not None and pending is None:
                    # A prefetch already owns this fetch: piggyback on it
                    # instead of pulling the same bytes twice. Bounded
                    # slices keep the blocked-hook/deadline checks live; a
                    # FAILED prefetch sets the event without caching, and
                    # the next iteration fetches normally.
                    remaining = (None if deadline is None
                                 else deadline - time.time())
                    if remaining is not None and remaining <= 0:
                        raise GetTimeoutError(
                            f"get() timed out on {oid.hex()[:12]}")
                    inflight.wait(min(remaining, 0.5)
                                  if remaining is not None else 0.5)
                    continue
                if pending is not None:
                    remaining = (None if deadline is None
                                 else deadline - time.time())
                    if remaining is not None and remaining <= 0:
                        raise GetTimeoutError(
                            f"get() timed out on {oid.hex()[:12]}")
                    # Bounded slices so the loop re-checks the blocked-worker
                    # hook (a full-deadline wait would never release the
                    # lease).
                    pending.done.wait(timeout=min(remaining, 1.0)
                                      if remaining is not None else 1.0)
                    with self._cache_lock:
                        if oid in self._cache:
                            return self._cache[oid]
                    if pending.done.is_set():
                        # Completed but not cached here (e.g. ref from
                        # another process path) — fall through to the fetch
                        # path.
                        pass
                # With a waiter armed, the push announces new locations —
                # the locate RPC drops to a ~4 Hz fallback (GCS-restart
                # recovery) instead of firing on every poll iteration; the
                # owner probe inside _try_fetch keeps its full cadence
                # (inline objects never publish a location row).
                now0 = time.time()
                allow_locate = (waiter is None or locations is not None
                                or now0 - last_locate >= 0.25)
                if allow_locate and locations is None:
                    last_locate = now0
                value = self._try_fetch(oid, owner_hint, locations=locations,
                                        skip_locate=not allow_locate)
                locations = None
                if value is not _MISSING:
                    with self._cache_cv:
                        self._cache[oid] = value
                        self._cache_cv.notify_all()
                    return value
                # Lineage-based recovery (object_recovery_manager.h:41): the
                # object has no live replica — if the GCS kept its creating
                # TaskSpec, resubmit it once; the re-executed task re-seals
                # the same return ids. Brief grace first (a fresh task's seal
                # may not have landed), then probe the lineage table at most
                # once per second so waiting consumers don't hot-loop the
                # GCS.
                now = time.time()
                missing_since = missing_since or now
                if (not recovered and pending is None
                        and now - missing_since > 0.5
                        and now - getattr(self, "_last_lineage_probe", 0.0)
                        > 1.0):
                    self._last_lineage_probe = now
                    if self._maybe_recover(oid):
                        recovered = True
                        missing_since = None
                        continue
                if (pending is None and owner_hint
                        and owner_hint != self.owner_address
                        and self._owner_presumed_dead(owner_hint)):
                    # Object's only possible replica was its owner's
                    # in-process cache (no locations, no lineage — both were
                    # just probed) and the owner has been unreachable past
                    # the death window: fail like the reference's
                    # OwnerDiedError instead of spinning forever.
                    from ray_tpu_torch.core.exceptions import ObjectLostError

                    raise ObjectLostError(
                        oid.hex()[:12],
                        f"owner process ({owner_hint}) died and no other "
                        "replica or lineage exists")
                if deadline is not None and time.time() >= deadline:
                    raise GetTimeoutError(
                        f"get() timed out on {oid.hex()[:12]}")
                if pending is not None and not pending.done.is_set():
                    continue  # pending.done.wait already paced this round
                # (A set-but-unfetchable pending falls through to the
                # waiter/backoff pacing below — otherwise this loop would
                # spin at RPC speed against a value that never lands.)
                if sub_enabled:
                    if waiter is None:
                        # Register BEFORE the next probe so a seal landing
                        # between probe and wait can never be missed
                        # (last_locate resets so that re-probe REALLY asks
                        # the GCS once more post-registration).
                        waiter = self._register_loc_waiter(oid)
                        last_locate = 0.0
                        continue
                    remaining = (None if deadline is None
                                 else deadline - time.time())
                    wait_s = (backoff if remaining is None
                              else max(0.0, min(backoff, remaining)))
                    if waiter.event.wait(wait_s):
                        self._stats["push_wakeups"] += 1
                        locations = waiter.take_locations()
                        backoff = 0.001  # fresh signal: retry eagerly
                    else:
                        self._stats["poll_timeouts"] += 1
                        backoff = min(backoff * 2, poll_cap)
                else:
                    self._stats["backoff_sleeps"] += 1
                    time.sleep(backoff)
                    backoff = min(backoff * 2, poll_cap)
        finally:
            if waiter is not None:
                self._unregister_loc_waiter(oid, waiter)

    # -- object-location push wakeups (subscribe_object_locations) ----------

    def _register_loc_waiter(self, oid: ObjectID) -> "_LocWaiter":
        waiter = _LocWaiter()
        with self._loc_lock:
            self._loc_waiters.setdefault(oid, []).append(waiter)
            start = not self._loc_sub_running
            if start:
                self._loc_sub_running = True
        if start:
            threading.Thread(target=self._loc_subscriber_loop,
                             name="loc-sub", daemon=True).start()
        return waiter

    def _unregister_loc_waiter(self, oid: ObjectID, waiter) -> None:
        with self._loc_lock:
            waiters = self._loc_waiters.get(oid)
            if waiters is not None:
                try:
                    waiters.remove(waiter)
                except ValueError:
                    pass
                if not waiters:
                    self._loc_waiters.pop(oid, None)

    def _loc_subscriber_loop(self) -> None:
        """Long-poll the GCS object-location channel and wake registered
        waiters on seal. Started lazily with the first waiter; exits after
        a few idle seconds (an idle worker holds no GCS poll slot). On GCS
        loss the cursor resets to 'now' — the waiters' fallback poll covers
        anything sealed during the outage."""
        cursor = None
        idle_since: float | None = None
        while not self._shutdown:
            with self._loc_lock:
                has_waiters = bool(self._loc_waiters)
            if not has_waiters:
                now = time.time()
                if idle_since is None:
                    idle_since = now
                elif now - idle_since > 5.0:
                    with self._loc_lock:
                        if not self._loc_waiters:
                            self._loc_sub_running = False
                            return
                    idle_since = None
                time.sleep(0.05)
                continue
            idle_since = None
            # Server-side subscription filter: ship the oid set we are
            # actually blocked on, so an unrelated seal neither wakes the
            # parked poll on the GCS nor crosses the wire. A waiter that
            # registers WHILE this poll is parked is not in the server-side
            # wait lists yet, so its seal can't cut the poll short — the
            # poll timeout (2s, vs 5s unfiltered pre-filter) bounds that
            # stale-filter window, the replay below recovers the missed
            # messages, and the waiter's own ~4 Hz locate fallback covers
            # the latency gap meanwhile.
            with self._loc_lock:
                oids = [o.binary() for o in self._loc_waiters]
            prev_cursor, prev_oids = cursor, set(oids)
            try:
                cursor, messages = self._gcs_rpc.call(
                    "subscribe_object_locations", cursor, 2.0, oids,
                    timeout=35.0)
            except (RpcConnectionError, TimeoutError):
                cursor = None  # GCS restarted: resync from 'now'
                time.sleep(0.5)
                continue
            except Exception:  # noqa: BLE001 — e.g. mid-shutdown teardown
                time.sleep(0.5)
                continue
            self._deliver_loc_messages(messages)
            # Waiters that registered WHILE the poll was parked: their seals
            # may have been filtered out of the window just consumed —
            # replay that window for the new oids only (non-blocking).
            with self._loc_lock:
                fresh = [o.binary() for o in self._loc_waiters
                         if o.binary() not in prev_oids]
            if fresh and prev_cursor is not None and cursor is not None \
                    and cursor > prev_cursor:
                try:
                    _, replay = self._gcs_rpc.call(
                        "subscribe_object_locations", prev_cursor, 0.0,
                        fresh, timeout=10.0)
                except Exception:  # noqa: BLE001 — fallback poll covers it
                    replay = []
                self._deliver_loc_messages(replay)

    def _deliver_loc_messages(self, messages) -> None:
        if not messages:
            return
        with self._loc_lock:
            for oid_bytes, node_id, addr, size in messages:
                waiters = self._loc_waiters.get(ObjectID(oid_bytes))
                if waiters and addr:
                    for w in waiters:
                        w.locations = [(node_id, addr, size)]
                        w.event.set()

    def _maybe_recover(self, oid: ObjectID) -> bool:
        """Resubmit the task that created ``oid`` (lineage reconstruction)."""
        try:
            lineage = self._gcs_rpc.call("get_lineage", oid.binary())
        except RpcConnectionError:
            return False
        if lineage is None:
            return False
        spec: TaskSpec = serialization.loads(lineage)
        return_ids = spec.return_object_ids()
        pending = _PendingTask(return_ids)
        with self._cache_lock:
            if oid in self._pending:
                return True  # another thread is already reconstructing
            for rid in return_ids:
                self._pending[rid] = pending
        logger.warning("object %s lost — reconstructing via lineage resubmit "
                       "of %s", oid.hex()[:12], spec.function_name)
        # Symmetry with submit_task: _run_submission's finally decrements
        # these; without the increment a recovery could free a dep we own.
        for dep in spec.dependencies():
            self.reference_counter.add_submitted_task_reference(dep)
        self._submit(spec, pending)
        return True

    def _try_fetch(self, oid: ObjectID, owner_hint: str | None = None,
                   locations: list | None = None,
                   skip_locate: bool = False):
        """Local shm → owner's in-process store → located daemons.

        ``locations`` short-circuits the GCS locate round trip when the
        caller already knows the replica set (batched get's single
        ``locate_object_batch``, or a location-push wakeup).
        ``skip_locate``: probe only the local/owner planes — a subscribed
        waiter gets its location discovery from the push, so the locate
        RPC runs at fallback cadence only."""
        key_bytes = oid.binary()
        if self._shm is not None:
            from ray_tpu_torch.core.node_daemon import NodeDaemon

            key = NodeDaemon._shm_key(key_bytes)
            view = self._shm.get(key)
            if view is not None:
                try:
                    return serialization.loads(view)
                finally:
                    self._shm.release(key)
        if (owner_hint and owner_hint != self.owner_address
                and not self._owner_unreachable(owner_hint)):
            # Inline-small objects have no daemon replica and no GCS
            # location row — their owner serves them directly.
            try:
                payload = self._owner_clients.get(owner_hint).call(
                    "fetch_owned", key_bytes, timeout=30.0)
                self._note_owner_alive(owner_hint)
                if payload is not None:
                    return serialization.loads(payload)
            except (RpcConnectionError, TimeoutError):
                self._note_owner_unreachable(owner_hint)
        if locations is None:
            if skip_locate:
                return _MISSING
            try:
                self._stats["locate_calls"] += 1
                locations = self._gcs_rpc.call("locate_object", key_bytes)
            except RpcConnectionError:
                return _MISSING
        # Prefer a same-node replica (zero extra hop); spread remote pulls
        # across replicas so broadcasts fan out instead of serializing on
        # the origin daemon.
        import random

        locations = list(locations)
        if not locations:
            return _MISSING
        random.shuffle(locations)
        locations.sort(key=lambda loc: loc[0] != self.current_node_id)
        return self._fetch_remote(oid, locations)

    def _fetch_remote(self, oid: ObjectID, locations: list):
        """Fetch a daemon replica: whole-frame handshake against the
        preferred source for small objects; big ones open a chunked pull
        STRIPED across every replica daemon at once (multi-source pull),
        landing in the LOCAL shm arena when possible so this node becomes a
        new location (broadcast fan-out, push_manager.cc's role)."""
        from ray_tpu_torch.core.node_daemon import NodeDaemon

        key_bytes = oid.binary()
        addrs = list(dict.fromkeys(addr for _n, addr, _s in locations))
        reply = None
        preferred = None
        dead: set = set()
        for i, addr in enumerate(addrs):
            try:
                # One round trip for the common case: small payloads come
                # back directly; bigger ones answer with their size so the
                # chunked pull can be budgeted and striped.
                reply = self._daemons.get(addr).call(
                    "fetch_or_meta", key_bytes,
                    config().whole_frame_fetch_max, timeout=60.0)
            except (RpcConnectionError, TimeoutError):
                dead.add(addr)
                continue
            if reply is not None:
                preferred = i
                break
            dead.add(addr)  # reachable but replica gone: not a source
        if reply is None:
            return _MISSING
        if "payload" in reply:
            return serialization.loads(reply["payload"])
        size = reply["size"]
        from ray_tpu_torch.core.object_transfer import PullManager

        if self._pull is None:
            self._pull = PullManager(self._daemons)
        # The preferred (same-node / first-reachable) source leads; every
        # other replica that didn't just fail the probe joins the stripe
        # when the object is big enough.
        srcs = [addrs[preferred]] + [a for j, a in enumerate(addrs)
                                     if j != preferred and a not in dead]
        key = NodeDaemon._shm_key(key_bytes)
        dest_view = None
        if self._shm is not None:
            try:
                dest_view = self._shm.create(key, size)
            except Exception:  # noqa: BLE001 — arena full / contended
                dest_view = None
        if dest_view is not None:
            if not self._pull.pull_into_multi(srcs, key_bytes, size,
                                              dest_view):
                self._shm.abort(key)
                return _MISSING
            self._shm.seal(key)
            # This node now holds a replica: register it so other nodes
            # (and later local readers) stop hitting the origin.
            try:
                self._gcs_rpc.notify("add_object_location", key_bytes,
                                     self.current_node_id, size, None)
            except RpcConnectionError:
                pass
            view = self._shm.get(key)
            try:
                return serialization.loads(view)
            finally:
                self._shm.release(key)
        buf = bytearray(size)
        if not self._pull.pull_into_multi(srcs, key_bytes, size, buf):
            return _MISSING
        return serialization.loads(buf)

    # Negative cache for owner probes: a dead owner's address must not cost
    # a blocking connect attempt on every wait()/get() poll. An address that
    # stays unreachable past _OWNER_DEATH_S is presumed dead — objects whose
    # ONLY replica was that owner's cache raise instead of spinning
    # (the reference's OwnerDiedError).
    _OWNER_RETRY_S = 5.0
    _OWNER_DEATH_S = 20.0

    def _owner_unreachable(self, addr: str) -> bool:
        entry = self._owner_down.get(addr)
        return entry is not None and time.time() < entry[0]

    def _note_owner_unreachable(self, addr: str) -> None:
        prev = self._owner_down.get(addr)
        first = prev[1] if prev else time.time()
        self._owner_down[addr] = (time.time() + self._OWNER_RETRY_S, first)
        self._owner_clients.invalidate(addr)

    def _note_owner_alive(self, addr: str) -> None:
        self._owner_down.pop(addr, None)

    def _owner_presumed_dead(self, addr: str) -> bool:
        entry = self._owner_down.get(addr)
        return (entry is not None
                and time.time() - entry[1] > self._OWNER_DEATH_S)

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: float | None = None, fetch_local: bool = True):
        refs = list(refs)
        deadline = time.time() + timeout if timeout is not None else None
        ready: List[ObjectRef] = []
        pending = list(refs)
        while True:
            still = []
            for ref in pending:
                if self._is_ready(ref):
                    ready.append(ref)
                else:
                    still.append(ref)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.time() >= deadline:
                break
            time.sleep(0.005)
        return ready, pending

    def _is_ready(self, ref: ObjectRef) -> bool:
        oid = ref.id
        with self._cache_lock:
            if oid in self._cache:
                return True
            p = self._pending.get(oid)
        if p is not None:
            return p.done.is_set()
        if self._shm is not None:
            from ray_tpu_torch.core.node_daemon import NodeDaemon

            if self._shm.contains(NodeDaemon._shm_key(oid.binary())):
                return True
        # Remote readiness probes (owner RPC + GCS locate) are throttled per
        # ref: wait() polls every 5 ms and must not turn each poll into
        # blocking network round trips.
        now = time.time()
        next_probe = self._ready_probe.get(oid, 0.0)
        if now < next_probe:
            return False
        if len(self._ready_probe) > 4096 and now > self._ready_probe_sweep:
            # Entries are popped only when a ref turns ready; refs that never
            # materialize (failed/freed/lost) would otherwise leak an entry
            # apiece for the driver's lifetime. Evict long-expired ones — at
            # most once per 30s, so a wait() sweep over >4096 live refs
            # (all recently probed, nothing evictable) isn't O(n) per probe.
            self._ready_probe_sweep = now + 30.0
            self._ready_probe = {
                k: v for k, v in self._ready_probe.items() if v > now - 60.0}
        self._ready_probe[oid] = now + 0.1
        owner_hint = getattr(ref, "_owner_hint", None)
        if (owner_hint and owner_hint != self.owner_address
                and not self._owner_unreachable(owner_hint)):
            try:
                if self._owner_clients.get(owner_hint).call(
                        "has_owned", oid.binary(), timeout=10.0):
                    self._ready_probe.pop(oid, None)
                    return True
            except (RpcConnectionError, TimeoutError):
                self._note_owner_unreachable(owner_hint)
        try:
            if bool(self._gcs_rpc.call("locate_object", oid.binary())):
                self._ready_probe.pop(oid, None)
                return True
            return False
        except RpcConnectionError:
            return False

    def future_for(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self.get(ref))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def asyncio_future_for(self, ref: ObjectRef, loop):
        afut = loop.create_future()

        def run():
            try:
                value = self.get(ref)
                loop.call_soon_threadsafe(afut.set_result, value)
            except BaseException as e:  # noqa: BLE001
                loop.call_soon_threadsafe(afut.set_exception, e)

        threading.Thread(target=run, daemon=True).start()
        return afut

    # ====================== tasks ======================

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        spec.owner_addr = self.owner_address
        n = spec.options.num_returns
        num = n if isinstance(n, int) else 0
        return_ids = spec.return_object_ids(num)
        refs = [ObjectRef(oid, owner_hint=self.owner_address)
                for oid in return_ids]
        for oid in return_ids:
            self.reference_counter.set_owned(oid)
        for dep in spec.dependencies():
            self.reference_counter.add_submitted_task_reference(dep)
        pending = _PendingTask(return_ids)
        with self._cache_lock:
            for oid in return_ids:
                self._pending[oid] = pending
        self._submit(spec, pending)
        return refs

    def _submit(self, spec: TaskSpec, pending: _PendingTask) -> None:
        from ray_tpu_torch.runtime_env import needs_dedicated_worker

        if needs_dedicated_worker(spec.options.runtime_env):
            # runtime_env tasks need a dedicated worker spawned with the env
            # applied at process start (and/or inside a pip venv) — the
            # daemon owns that; no reuse.
            self._submit_pool.submit(self._run_submission, spec, pending)
        else:
            self._dispatch(_QueuedTask(spec, pending,
                                       refcounter=self.reference_counter,
                                       encoder=self._spec_encoder))

    # ---------------- direct task transport ----------------

    @staticmethod
    def _sched_key(spec: TaskSpec) -> tuple:
        """Scheduling key (direct_task_transport.h:54-56): resource shape ×
        strategy. Tasks with equal keys may share leased workers."""
        from ray_tpu_torch.core import task_spec as ts

        res = tuple(sorted(spec.declared_resources().items()))
        s = spec.options.scheduling_strategy
        if s is None or isinstance(s, ts.DefaultSchedulingStrategy):
            skey: tuple = ("default",)
        elif isinstance(s, ts.NodeAffinitySchedulingStrategy):
            skey = ("affinity", s.node_id, s.soft)
        elif isinstance(s, ts.PlacementGroupSchedulingStrategy):
            pg = s.placement_group
            pg_id = getattr(pg, "id", pg)
            skey = ("pg", pg_id, s.placement_group_bundle_index)
        elif isinstance(s, ts.SpreadSchedulingStrategy):
            skey = ("spread",)
        else:  # NodeLabel and future strategies: keyed but never parked
            skey = ("other", repr(s))
        return (res, skey)

    def _dispatch(self, task: _QueuedTask) -> None:
        """Enqueue + ensure capacity: reuse a parked lease when one exists,
        otherwise start a lease requester (bounded per key)."""
        key = self._sched_key(task.spec)
        with self._key_lock:
            state = self._key_states.get(key)
            if state is None:
                state = self._key_states[key] = _KeyState(self._key_lock)
            state.queue.append(task)
            self._ensure_capacity_locked(key, state)

    def _ensure_capacity_locked(self, key: tuple, state: _KeyState) -> None:
        """Under _key_lock: wake hot runners, hand waiting tasks to parked
        leases, then start one lease requester per still-unclaimed task
        (busy runners don't count — each waiting task deserves its own
        worker; the GCS gates actual grants by resource availability).
        Runners claim their first task HERE, atomically, so
        ``len(state.queue)`` is exactly the unclaimed demand and no counter
        race can strand a task."""
        if state.waiters:
            # Hot idle runners (cv-parked with their lease) grab queued
            # tasks themselves — cheapest handoff, one futex wake.
            state.cv.notify(min(len(state.queue), state.waiters))
        covered = state.waiters
        while state.idle and len(state.queue) > covered:
            entry, _parked = state.idle.pop()
            task = state.queue.popleft()
            state.runners += 1
            threading.Thread(target=self._runner,
                             args=(key, state, entry, task),
                             name="task-runner", daemon=True).start()
        unclaimed = len(state.queue) - covered
        if unclaimed <= 0 or self._shutdown:
            return
        if self._batched_key(key):
            # One batched requester covers up to lease_batch_max tasks per
            # GCS round trip — the spawn bound shrinks accordingly.
            batch_max = max(1, int(config().lease_batch_max))
            need = min((unclaimed + batch_max - 1) // batch_max, 64)
            while state.requesting < need:
                state.requesting += 1
                spec = state.queue[0].spec
                self._lease_pool_submit(self._lease_requester_batched,
                                        key, state, spec)
        else:
            while state.requesting < min(unclaimed, 64):
                state.requesting += 1
                spec = state.queue[0].spec
                self._lease_pool_submit(self._lease_requester,
                                        key, state, spec)

    @staticmethod
    def _batched_key(key: tuple) -> bool:
        """Batch-eligible scheduling keys: plain default-placement shapes.
        Affinity/PG/spread placement is per-task, so those keys stay on the
        single-lease path (gcs_shards=1 + lease_batch_enabled=0 reproduces
        the old transport exactly)."""
        return key[1][0] == "default" and bool(config().lease_batch_enabled)

    def _lease_pool_submit(self, fn, *args) -> None:
        """Run a lease requester on the bounded pool (callers in
        _ensure_capacity_locked hold _key_lock, making the lazy create
        race-free; requester self-resubmits find the pool already built)."""
        pool = self._lease_pool
        if pool is None:
            pool = self._lease_pool = ThreadPoolExecutor(
                max_workers=max(1, int(config().lease_requester_threads)),
                thread_name_prefix="lease-req")
        try:
            pool.submit(fn, *args)
        except RuntimeError:
            # Pool shut down mid-submit (worker shutdown): the orphaned
            # ``requesting`` count is moot — nothing dispatches after it.
            pass

    def _lease_requester(self, key: tuple, state: _KeyState,
                         spec: TaskSpec, pool_failures: int = 0) -> None:
        """Acquire one (GCS lease → daemon worker) pair, then run tasks.

        Every exit transition (give up because demand evaporated, convert
        into a runner, park a surplus grant) happens atomically under
        _key_lock with the queue check, so _dispatch can never see a stale
        ``requesting`` count and strand a queued task. Runs on the bounded
        lease pool: a GCS-side wait (TimeoutError slice) re-submits to the
        pool tail instead of looping, so one starved shape can't pin every
        requester slot."""
        entry = None
        first_task = None
        resources = spec.declared_resources()
        strategy = spec.options.scheduling_strategy
        while True:
            with self._key_lock:
                if entry is not None:
                    state.requesting -= 1
                    if state.queue:
                        first_task = state.queue.popleft()
                        state.runners += 1
                        break
                    # Demand evaporated between grant and now: park the
                    # fresh lease (sweeper expires it) or release it.
                    if self._reusable_key(key) and not self._shutdown:
                        state.idle.append((entry, time.time()))
                        self._ensure_sweeper()
                        return
                    break  # break with first_task None -> release below
                if self._shutdown or not state.queue or state.idle:
                    # Nothing to acquire for (parked leases are handed out
                    # by _ensure_capacity_locked before requesters spawn).
                    state.requesting -= 1
                    self._ensure_capacity_locked(key, state)
                    return
            try:
                granted = self._gcs_rpc.call(
                    "request_lease", resources, strategy, 5.0, timeout=None)
            except TimeoutError:
                # Still queued at the GCS: yield this pool slot and rejoin
                # at the queue tail so other shapes' requesters can run.
                self._lease_pool_submit(self._lease_requester,
                                        key, state, spec, pool_failures)
                return
            except RpcConnectionError as e:
                self._abort_request(key, state, TaskError(
                    "lease", f"GCS unreachable: {e}", None))
                return
            except Exception as e:  # noqa: BLE001 — infeasible etc.
                self._abort_request(key, state, TaskError(
                    "lease", f"lease request failed: {e}", None))
                return
            lease_id, node_id, node_addr = granted
            try:
                wid, waddr = self._daemons.get(node_addr).call(
                    "lease_worker", lease_id, timeout=None)
            except Exception as e:  # noqa: BLE001 — node died post-grant,
                # pool exhausted, or our own clients are closing (shutdown).
                # The grant must not leak: release explicitly (no-op if node
                # death already did).
                try:
                    self._gcs_rpc.notify("release_lease", lease_id)
                except RpcConnectionError:
                    pass
                pool_failures += 1
                if pool_failures >= 4:
                    # A node that persistently cannot produce workers must
                    # surface as an error, not an infinite lease loop (the
                    # proxied path counted WorkerDiedError against
                    # max_retries the same way).
                    self._abort_request(key, state, TaskError(
                        "lease", f"cannot obtain a worker after "
                        f"{pool_failures} grants: {e}", None))
                    return
                time.sleep(0.1)
                continue
            entry = _LeasedWorker(lease_id, node_id, node_addr, wid, waddr)
        if first_task is None:
            self._release_entry(entry)
            return
        # Run on a dedicated thread: a runner holds its lease for the whole
        # task (plus the hot-idle window) — wedging a bounded pool slot that
        # long would serialize unrelated lease acquisition.
        threading.Thread(target=self._runner,
                         args=(key, state, entry, first_task),
                         name="task-runner", daemon=True).start()

    def _lease_requester_batched(self, key: tuple, state: _KeyState,
                                 spec: TaskSpec,
                                 pool_failures: int = 0) -> None:
        """Acquire a CAPACITY BLOCK covering up to lease_batch_max queued
        tasks in ONE GCS round trip, then carve per-task leases at the
        granting node's daemon (local lock, no GCS hop). Any units left
        uncarved — demand evaporated mid-batch — stay at the daemon and
        flow back to the GCS via its idle sweep, not per-lease RPCs."""
        resources = spec.declared_resources()
        strategy = spec.options.scheduling_strategy
        batch_max = max(1, int(config().lease_batch_max))
        while True:
            with self._key_lock:
                if self._shutdown or not state.queue or state.idle:
                    state.requesting -= 1
                    self._ensure_capacity_locked(key, state)
                    return
                want = min(len(state.queue), batch_max)
            try:
                block_id, node_id, node_addr, granted = self._gcs_rpc.call(
                    "request_lease_batch", resources, strategy, want, 5.0,
                    timeout=None)
            except TimeoutError:
                # Still queued at the GCS: yield the pool slot, rejoin at
                # the tail (see _lease_requester).
                self._lease_pool_submit(self._lease_requester_batched,
                                        key, state, spec, pool_failures)
                return
            except RpcConnectionError as e:
                self._abort_request(key, state, TaskError(
                    "lease", f"GCS unreachable: {e}", None))
                return
            except Exception as e:  # noqa: BLE001 — infeasible etc.
                self._abort_request(key, state, TaskError(
                    "lease", f"lease request failed: {e}", None))
                return
            carved = 0
            while carved < granted:
                with self._key_lock:
                    take = []
                    while state.queue and carved + len(take) < granted:
                        take.append(state.queue.popleft())
                if not take:
                    break  # leftover units TTL-return at the daemon
                try:
                    grants = self._daemons.get(node_addr).call(
                        "lease_worker_block_n", block_id, dict(resources),
                        granted, len(take), timeout=None)
                except Exception as e:  # noqa: BLE001 — node death
                    # post-grant, pool exhaustion, or a revoked block. The
                    # tasks go back to the queue head; un-carved capacity
                    # is reclaimed by daemon-death handling or the idle
                    # sweep — never by the client.
                    with self._key_lock:
                        state.queue.extendleft(reversed(take))
                    pool_failures += 1
                    if pool_failures >= 4:
                        self._abort_request(key, state, TaskError(
                            "lease", f"cannot obtain a worker after "
                            f"{pool_failures} block grants: {e}", None))
                        return
                    time.sleep(0.1)
                    break  # re-request from the GCS (block may be dead)
                if not grants:
                    # The block is spent, not the node: its free units went
                    # back to the GCS (the daemon's idle sweep ran before
                    # this carve landed, as under a loaded host) or it was
                    # revoked. No worker failed, so this does not count
                    # toward the abort: requeue and ask the GCS again.
                    with self._key_lock:
                        state.queue.extendleft(reversed(take))
                    time.sleep(0.05)
                    break
                if len(grants) < len(take):
                    # Short batch (slow spawn at the daemon): requeue the
                    # uncovered tail; the next loop pass retries it.
                    with self._key_lock:
                        state.queue.extendleft(reversed(take[len(grants):]))
                for got, task in zip(grants, take):
                    lease_id, wid, waddr = got
                    carved += 1
                    entry = _LeasedWorker(lease_id, node_id, node_addr,
                                          wid, waddr)
                    with self._key_lock:
                        state.runners += 1
                    threading.Thread(target=self._runner,
                                     args=(key, state, entry, task),
                                     name="task-runner", daemon=True).start()

    def _abort_request(self, key: tuple, state: _KeyState, error) -> None:
        """Fail everything queued AND decrement ``requesting`` in ONE
        critical section — a dispatch interleaved between the two would see
        a stale requesting count, spawn nothing, and strand its task."""
        with self._key_lock:
            tasks = list(state.queue)
            state.queue.clear()
            state.requesting -= 1
        for task in tasks:
            self._finish_task(task, error=error)

    def _runner(self, key: tuple, state: _KeyState, entry: _LeasedWorker,
                first_task: _QueuedTask) -> None:
        """Drive one leased worker: pull queued tasks and push them directly
        (OnWorkerIdle, direct_task_transport.cc:197). Parks the lease when
        the queue drains; drops it on worker death or lease shed."""
        alive = self._execute_guarded(entry, first_task)
        reusable = self._reusable_key(key)
        while True:
            with self._key_lock:
                task = None
                if alive and not self._shutdown and reusable:
                    # Spread/label keys never reach here: their placement
                    # re-runs per task, so each task gets a fresh lease.
                    if state.queue:
                        task = state.queue.popleft()
                    else:
                        # Hot idle: keep the thread + lease alive up to the
                        # idle TTL waiting for more work — the next task is
                        # one cv wake away instead of a thread spawn + lease
                        # round trip (worker-lease reuse window of
                        # direct_task_transport.cc).
                        deadline = time.time() + config().idle_lease_ttl_s
                        state.waiters += 1
                        try:
                            while not state.queue and not self._shutdown:
                                remaining = deadline - time.time()
                                if remaining <= 0:
                                    break
                                # raylint: ignore[blocking-under-lock]
                                # — state.cv wraps _key_lock (see _KeyState)
                                state.cv.wait(remaining)
                        finally:
                            state.waiters -= 1
                        if state.queue and not self._shutdown:
                            task = state.queue.popleft()
                if task is None:
                    state.runners -= 1
                    release = alive
                    if not alive:
                        # Worker/lease gone mid-stream: any still-queued
                        # tasks need fresh capacity working toward them.
                        self._ensure_capacity_locked(key, state)
            if task is None:
                if release:
                    self._release_entry(entry)
                return
            alive = self._execute_guarded(entry, task)

    @staticmethod
    def _reusable_key(key: tuple) -> bool:
        return key[1][0] in ("default", "affinity", "pg")

    def _execute_guarded(self, entry: _LeasedWorker, task: _QueuedTask) -> bool:
        """_execute_direct with the catch-all _run_submission has: an
        unexpected exception (unpicklable error blob, broken inline value)
        must record a TaskError — never kill the runner thread with the
        pending task unresolved — and must not reuse a worker whose channel
        state is unknown."""
        try:
            return self._execute_direct(entry, task)
        except BaseException as exc:  # noqa: BLE001
            logger.exception("direct execution of %s failed",
                             task.spec.function_name)
            try:
                self._finish_task(task, error=TaskError.from_exception(
                    task.spec.function_name, exc))
            except BaseException:  # noqa: BLE001 — last resort: unblock get
                task.pending.done.set()
            self._kill_entry(entry)
            return False

    def _kill_entry(self, entry: _LeasedWorker) -> None:
        """Dispose of a leased worker in UNKNOWN channel state: the daemon
        kills it (it may be mid-task — it can't rejoin the pool) and the
        reaper releases its lease."""
        self._worker_clients.invalidate(entry.worker_addr)
        try:
            self._daemons.get(entry.node_addr).notify(
                "kill_worker", entry.worker_id)
        except RpcConnectionError:
            pass

    def _execute_direct(self, entry: _LeasedWorker, task: _QueuedTask) -> bool:
        """Push one task to the leased worker. Returns False when the entry
        is no longer usable (worker died / lease shed)."""
        spec, pending = task.spec, task.pending
        if pending.cancelled:
            self._drop_pending(pending)
            pending.done.set()
            self._finish_task(task, error=None, record=False)
            return True
        task.attempt += 1
        try:
            result = self._call_run_task(
                self._worker_clients.get(entry.worker_addr), task,
                entry.lease_id)
        except RpcConnectionError as e:
            # Worker process died mid-task: daemon's reaper releases the
            # lease; retry on a fresh lease or surface the death.
            self._worker_clients.invalidate(entry.worker_addr)
            if task.attempt <= spec.options.max_retries:
                logger.info("task %s attempt %d lost its worker (%s); retrying",
                            spec.function_name, task.attempt, e)
                self._redispatch_later(task)
            else:
                self._finish_task(task, error=TaskError(
                    spec.function_name, f"WorkerDiedError: {e}", None))
            return False
        except Exception as e:  # noqa: BLE001 — transport-level failure
            # (oversized frame, reply unpickle error...) with the worker
            # possibly still alive in unknown state: fail the task AND
            # dispose of the worker+lease so neither leaks.
            self._finish_task(task, error=TaskError(
                spec.function_name, f"{type(e).__name__}: {e}", None))
            self._kill_entry(entry)
            return False
        final_lease = result.pop("final_lease_id", entry.lease_id)
        if result.get("ok"):
            self._record_task_results(spec, pending, result)
            self._finish_task(task, error=None, record=False)
        else:
            error = serialization.loads(result["error"])
            if _app_error_should_retry(spec, task.attempt, result):
                self._redispatch_later(task, delay=0.0)
            else:
                self._merge_streamed(spec, result)
                self._finish_task(task, error=error)
        if final_lease is None:
            # Blocked-release shed the lease and never got it back: the
            # worker holds no resources — hand it back to the daemon.
            try:
                self._daemons.get(entry.node_addr).notify(
                    "return_leased_worker", entry.worker_id)
            except RpcConnectionError:
                pass
            return False
        entry.lease_id = final_lease
        return True

    def _call_run_task(self, client: RpcClient, task: _QueuedTask, lease_id):
        """Push one task with the cached-template encoding: ship the spec
        template once per (connection, callable), then (digest, args) per
        call. A SpecCacheMiss (server evicted the template) re-sends it in
        full exactly once."""
        if task.spec_bytes is not None:  # legacy full-spec path
            return client.call("run_task", task.spec_bytes, lease_id,
                               timeout=None)
        enc = self._spec_encoder
        for retry in (False, True):
            if client.template_cached(task.digest):
                enc.wire_hits += 1
            else:
                client.send_template(task.digest, task.template)
                enc.wire_misses += 1
            try:
                return client.call("run_task", (task.digest, task.var_bytes),
                                   lease_id, timeout=None)
            except SpecCacheMiss:
                if retry:
                    raise
                client.forget_template(task.digest)

    def _redispatch_later(self, task: _QueuedTask, delay: float = None) -> None:
        if delay is None:
            delay = _retry_delay(task.attempt)

        def run():
            if delay:
                time.sleep(delay)
            self._dispatch(task)

        self._submit_pool.submit(run)

    def _drop_pending(self, pending: _PendingTask) -> None:
        """Remove a finished-by-cancel task's _pending entries (the normal
        result/error recorders pop them, but a task cancelled before it ever
        executed reaches neither)."""
        with self._cache_lock:
            for oid in pending.refs:
                self._pending.pop(oid, None)

    def _finish_task(self, task: _QueuedTask, error, record: bool = True) -> None:
        if task.finished:
            return  # already terminally finished (idempotent: see _QueuedTask)
        task.finished = True
        if record and error is not None:
            self._record_task_error(task.spec, task.pending, error)
        for dep in task.spec.dependencies():
            self.reference_counter.remove_submitted_task_reference(dep)
        for oid in task.nested_deps:
            self.reference_counter.remove_submitted_task_reference(oid)

    def _release_entry(self, entry: _LeasedWorker) -> None:
        try:
            self._daemons.get(entry.node_addr).notify(
                "return_leased_worker", entry.worker_id)
        except RpcConnectionError:
            pass
        if is_block_lease(entry.lease_id):
            # Block-carved unit: the daemon freed it inside
            # return_leased_worker (local authority); unused capacity flows
            # back to the GCS via the daemon's idle sweep, not per-lease
            # release RPCs.
            return
        try:
            self._gcs_rpc.notify("release_lease", entry.lease_id)
        except RpcConnectionError:
            pass

    def _ensure_sweeper(self) -> None:
        if self._lease_sweeper_started:
            return
        self._lease_sweeper_started = True
        threading.Thread(target=self._sweep_idle_leases, name="lease-sweeper",
                         daemon=True).start()

    def _sweep_idle_leases(self) -> None:
        """Expire parked leases after idle_lease_ttl_s — held resources must
        not outlive demand (the reference returns workers on lease expiry)."""
        while not self._shutdown:
            time.sleep(0.1)
            ttl = config().idle_lease_ttl_s
            expired: List[_LeasedWorker] = []
            now = time.time()
            with self._key_lock:
                for state in self._key_states.values():
                    keep = []
                    for entry, parked in state.idle:
                        if now - parked > ttl:
                            expired.append(entry)
                        else:
                            keep.append((entry, parked))
                    state.idle = keep
            for entry in expired:
                self._release_entry(entry)

    def _run_submission(self, spec: TaskSpec, pending: _PendingTask) -> None:
        """Lease → push → (maybe retry) → record results. One thread per
        in-flight task, mirroring the async submit loop of
        ``direct_task_transport.cc`` with retries from ``task_manager.cc``."""
        try:
            self._run_submission_inner(spec, pending)
        except BaseException as exc:  # noqa: BLE001 — a swallowed submission
            # exception would leave the pending task unresolved forever.
            logger.exception("task submission for %s failed", spec.function_name)
            self._record_task_error(
                spec, pending,
                TaskError.from_exception(spec.function_name, exc))

    def _request_lease(self, resources, strategy):
        """Lease with unbounded queueing in bounded server slices.

        Each RPC asks the GCS to wait at most ~25s (its blocking handler
        thread is a shared resource); TimeoutError means "still queued", so
        loop — a task waits for resources indefinitely, like the reference's
        raylet task queues, without pinning a GCS thread forever.
        """
        while True:
            try:
                return self._gcs_rpc.call(
                    "request_lease", resources, strategy, 25.0, timeout=None)
            except TimeoutError:
                continue

    def _run_submission_inner(self, spec: TaskSpec, pending: _PendingTask) -> None:
        with serialization.collecting_refs() as _nested:
            spec_bytes = serialization.dumps(spec)
        nested_deps = [r.id for r in _nested]
        for oid in nested_deps:
            self.reference_counter.add_submitted_task_reference(oid)
        resources = spec.declared_resources()
        max_retries = spec.options.max_retries
        attempt = 0
        try:
            while True:
                if pending.cancelled:
                    # cancel() already sealed TaskCancelledError; don't lease
                    # or (re-)execute work the user gave up on.
                    self._drop_pending(pending)
                    pending.done.set()
                    return
                attempt += 1
                try:
                    lease_id, node_id, node_addr = self._request_lease(
                        resources, spec.options.scheduling_strategy)
                except RpcConnectionError as e:
                    self._record_task_error(
                        spec, pending,
                        TaskError(spec.function_name,
                                  f"GCS unreachable: {e}", None))
                    return
                from ray_tpu_torch.runtime_env import needs_dedicated_worker

                renv = spec.options.runtime_env
                sidecar = (dict(renv)
                           if needs_dedicated_worker(renv) else None)
                try:
                    result = self._daemons.get(node_addr).call(
                        "execute_task", spec_bytes, lease_id, sidecar,
                        timeout=None,
                    )
                except Exception as e:  # noqa: BLE001
                    retriable = isinstance(e, RpcConnectionError) or (
                        isinstance(e, WorkerDiedError) and e.retriable
                    )
                    if retriable and attempt <= max_retries:
                        logger.info("task %s attempt %d failed (%s); retrying",
                                    spec.function_name, attempt, e)
                        # Backoff so the node's reaper collects dead workers
                        # before we lease again (retry pacing, task_manager.cc).
                        time.sleep(_retry_delay(attempt))
                        continue
                    self._record_task_error(
                        spec, pending,
                        TaskError(spec.function_name,
                                  f"{type(e).__name__}: {e}", None))
                    return
                if result.get("ok"):
                    self._record_task_results(spec, pending, result)
                    return
                # Application error inside the task.
                error = serialization.loads(result["error"])
                if _app_error_should_retry(spec, attempt, result):
                    continue
                self._merge_streamed(spec, result)
                self._record_task_error(spec, pending, error)
                return
        finally:
            for dep in spec.dependencies():
                self.reference_counter.remove_submitted_task_reference(dep)
            for oid in nested_deps:
                self.reference_counter.remove_submitted_task_reference(oid)

    def _record_task_results(self, spec: TaskSpec, pending: _PendingTask,
                             result: dict) -> None:
        returns: List[Tuple[bytes, Optional[bytes]]] = result["returns"]
        with self._cache_cv:
            if pending.cancelled:
                # cancel() already sealed TaskCancelledError into the cache;
                # a late real result must not race it back to a value.
                for oid in pending.refs:
                    self._pending.pop(oid, None)
                self._cache_cv.notify_all()
                pending.done.set()
                return
            for oid_bytes, inline in returns:
                if inline is not None:
                    roid = ObjectID(oid_bytes)
                    self._cache[roid] = serialization.loads(inline)
                    self._inline_owned[roid] = bytes(inline)
            for oid in pending.refs:
                self._pending.pop(oid, None)
            self._cache_cv.notify_all()
        # Nested-ref handover: the worker already registered us (the outer
        # objects' owner) as borrower of every contained ref before
        # replying; record the matching release obligations so freeing a
        # return object releases what it contains.
        for outer_bytes, inners in (result.get("contained") or {}).items():
            self.reference_counter.pin_contained(
                ObjectID(outer_bytes),
                [(ObjectID(ib), addr) for ib, addr in inners],
                already_registered=True)
        if result.get("generator_items") is not None:
            # Completion record: merge (streamed reports may already have
            # filled items) and mark the stream done.
            ids = [ObjectID(b) for b in result["generator_items"]]
            state = self._generator_state(spec.task_id)
            with state.cv:
                if not state.released:
                    for i, goid in enumerate(ids):
                        state.items.setdefault(i, goid)
                    state.total = len(ids)
                    state.cv.notify_all()
        pending.done.set()

    def _merge_streamed(self, spec: TaskSpec, result: dict) -> None:
        """A generator task that raised lists in its error reply the items
        it streamed first. They are merged before the error is sealed, so
        the error lands after them even when an item's own report (another
        connection) is still in flight; the report then only delivers the
        payload."""
        ids = result.get("generator_items")
        if not ids:
            return
        state = self._generator_state(spec.task_id)
        with state.cv:
            if not state.released and state.error_at is None:
                for i, oid_bytes in enumerate(ids):
                    state.items.setdefault(i, ObjectID(oid_bytes))

    def _record_task_error(self, spec: TaskSpec, pending: _PendingTask,
                           error) -> None:
        with self._cache_cv:
            if pending.cancelled:
                for oid in pending.refs:
                    self._pending.pop(oid, None)
                self._cache_cv.notify_all()
                pending.done.set()
                return
            error_payload = serialization.dumps(error)
            for oid in pending.refs:
                self._cache[oid] = error
                self._inline_owned[oid] = error_payload
                self._pending.pop(oid, None)
        if spec.options.num_returns in ("dynamic", "streaming"):
            # The error must surface through the ITERATOR: append it as the
            # stream's next item (after whatever was already streamed) and
            # close the stream — iteration raises at get() on that item
            # instead of silently ending (or hanging) the stream.
            state = self._generator_state(spec.task_id)
            with state.cv:
                if not state.released:
                    # Seal the error after the gap-free prefix, NOT max+1:
                    # item reports ride a different connection than this
                    # error reply, so holes below max would leave the
                    # consumer blocked on a missing index forever instead
                    # of raising. In-flight reports below the error index
                    # still land; at/after it they are dropped (see
                    # report_generator_item).
                    next_index = state.contiguous_len()
                    err_oid = ObjectID.for_task_return(spec.task_id,
                                                       next_index)
                    with self._cache_lock:
                        self._cache[err_oid] = error
                        self._inline_owned[err_oid] = error_payload
                    state.items[next_index] = err_oid
                    state.total = next_index + 1
                    state.error_at = next_index
                    state.cv.notify_all()
        with self._cache_cv:
            self._cache_cv.notify_all()
        pending.error = error
        pending.done.set()

    # ====================== actors ======================

    def create_actor(self, spec: TaskSpec) -> ActorID:
        spec_bytes = serialization.dumps(spec)
        return self._gcs_rpc.call("create_actor", spec_bytes)

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectRef]:
        spec.owner_addr = self.owner_address
        n = spec.options.num_returns
        num = n if isinstance(n, int) else 0
        return_ids = spec.return_object_ids(num)
        refs = [ObjectRef(oid, owner_hint=self.owner_address)
                for oid in return_ids]
        for oid in return_ids:
            self.reference_counter.set_owned(oid)
        pending = _PendingTask(return_ids)
        with self._cache_lock:
            for oid in return_ids:
                self._pending[oid] = pending
        # Pin argument refs for the duration of the call (the same borrow
        # submit_task takes) so the owner can't free them mid-flight.
        for dep in spec.dependencies():
            self.reference_counter.add_submitted_task_reference(dep)
        self._enqueue_actor_call(spec, pending)
        return refs

    def _enqueue_actor_call(self, spec: TaskSpec, pending: _PendingTask) -> None:
        """Per-(actor, handle) PIPELINED ordered dispatch.

        Calls from one handle go out in sequence-number order but up to
        ``_ACTOR_WINDOW`` stay in flight concurrently — the client half of
        the reference's ``direct_actor_task_submitter`` (which pipelines
        pushes and relies on server-side sequencing,
        ``sequential_actor_submit_queue.cc``); our server half is
        ``worker_main._admit_in_order``. Sends happen under the per-key
        lock so the TCP byte order matches sequence order; completions
        arrive on the RPC read-loop thread and immediately pump the next
        queued call — the sequential fast path needs NO thread-pool
        handoff at all (caller thread sends, read-loop thread records).

        Restart safety: on connection loss every un-acked call goes back to
        the heap and a recovery job re-resolves the actor's address and
        re-sends oldest-first, so a fresh incarnation still hears this
        handle's oldest outstanding call first.
        """
        key = (spec.actor_id, spec.caller_id)
        with self._cache_lock:
            st = self._actor_queues.get(key)
            if st is None:
                st = {
                    "heap": [],            # (seq, _ActorCall) not yet sent
                    "inflight": {},        # seq -> (_ActorCall, addr)
                    "lock": threading.RLock(),  # reentrant: _fail_all runs
                    #   reply callbacks synchronously under our own frames
                    "recovering": False,   # a recovery job owns the queue
                    "resolving": False,    # an address-resolution job runs
                    "failed": set(),       # quarantined incarnation addrs
                    "deadline": None,      # restart-ladder cutoff
                }
                self._actor_queues[key] = st
        import heapq

        with st["lock"]:
            heapq.heappush(st["heap"],
                           (spec.sequence_number, _ActorCall(spec, pending)))
            self._pump_actor_queue(key, st)

    def _actor_address(self, actor_id: ActorID, timeout: float = 120.0) -> str:
        addr = self._actor_addr_cache.get(actor_id)
        if addr is not None:
            return addr
        info = self._gcs_rpc.call("wait_actor_alive", actor_id,
                                  timeout=timeout)
        addr = info["address"]
        self._actor_addr_cache[actor_id] = addr
        return addr

    def _pump_actor_queue(self, key, st) -> None:
        """Send queued calls while the window has room. Caller holds
        ``st['lock']``."""
        import heapq

        if st["recovering"]:
            return
        while st["heap"] and len(st["inflight"]) < _ACTOR_WINDOW:
            addr = self._actor_addr_cache.get(key[0])
            if addr is None:
                # Resolution can block on wait_actor_alive — punt to a pool
                # thread once; it re-pumps when the address is known.
                if not st["resolving"]:
                    st["resolving"] = True
                    try:
                        self._submit_pool.submit(self._resolve_and_pump,
                                                 key, st)
                    except RuntimeError:  # pool shut down
                        st["resolving"] = False
                        return
                return
            if addr in st["failed"]:
                # Stale table entry: quarantined incarnation. Recovery owns
                # the wait-for-new-address loop.
                self._begin_actor_recovery(key, st, addr)
                return
            seq, call = heapq.heappop(st["heap"])
            if call.var_bytes is None:
                # The admission baseline for a fresh incarnation: this
                # handle's lowest outstanding seq right now (recovery clears
                # var_bytes so resends recompute it).
                call.spec.window_min = min(st["inflight"], default=seq)
                try:
                    with serialization.collecting_refs() as _nested:
                        call.digest, call.template = (
                            self._spec_encoder.encode_template(call.spec))
                        call.var_bytes = (
                            self._spec_encoder.encode_vars(call.spec))
                    if call.nested_deps is None:  # once, not per resend
                        call.nested_deps = [r.id for r in _nested]
                        for noid in call.nested_deps:
                            self.reference_counter \
                                .add_submitted_task_reference(noid)
                except BaseException as exc:  # noqa: BLE001 — unpicklable arg
                    self._finish_actor_call(call)
                    self._record_task_error(
                        call.spec, call.pending,
                        TaskError.from_exception(
                            f"{call.spec.function_name}."
                            f"{call.spec.actor_method}", exc))
                    # Tell the server this seq will never arrive: with
                    # OLDER calls still in flight, later calls'
                    # window_min can't fast-forward past an interior gap
                    # and would starve behind it (worker_main
                    # skip_actor_seq + _admit_in_order).
                    try:
                        self._actor_clients.get(addr).notify(
                            "skip_actor_seq", call.spec.actor_id.binary(),
                            call.spec.caller_id, seq)
                    except (RpcConnectionError, OSError):
                        pass  # conn loss → recovery resends recompute
                    continue
            client = self._actor_clients.get(addr)
            st["inflight"][seq] = (call, addr)
            try:
                if client.template_cached(call.digest):
                    self._spec_encoder.wire_hits += 1
                else:
                    client.send_template(call.digest, call.template)
                    self._spec_encoder.wire_misses += 1
                # Pipelined (other calls already in flight): hand the frame
                # to the connection's sender thread so back-to-back submits
                # coalesce into one sendmsg; sequential calls send inline.
                fut = client.call_async("run_actor_task",
                                        (call.digest, call.var_bytes),
                                        _handoff=len(st["inflight"]) > 1)
            except (RpcConnectionError, OSError):
                # call_async may have synchronously failed other in-flight
                # futures (reentrant callbacks already moved them back).
                if st["inflight"].pop(seq, None):
                    heapq.heappush(st["heap"], (seq, call))
                self._begin_actor_recovery(key, st, addr)
                return
            fut.add_done_callback(
                lambda f, seq=seq, addr=addr: self._on_actor_reply(
                    key, st, seq, addr, f))

    def _resolve_and_pump(self, key, st) -> None:
        try:
            self._actor_address(key[0])
        except Exception as e:  # noqa: BLE001 — actor dead / timeout
            with st["lock"]:
                st["resolving"] = False
                calls = self._take_all_queued(st)
            self._fail_actor_calls(
                calls, ActorDiedError(key[0].hex(), f"actor unavailable: {e}"))
            return
        with st["lock"]:
            st["resolving"] = False
            self._pump_actor_queue(key, st)

    def _on_actor_reply(self, key, st, seq, addr, fut) -> None:
        """Completion handler — runs on the RPC read-loop thread (or
        synchronously under ``_fail_all``)."""
        import heapq

        try:
            # raylint: ignore[untimed-wait] — completion callback: fut
            # is already resolved when this runs
            result = fut.result()
        except RpcConnectionError:
            with st["lock"]:
                ent = st["inflight"].pop(seq, None)
                if ent is not None:
                    ent[0].var_bytes = None  # resend: fresh window_min
                    heapq.heappush(st["heap"], (seq, ent[0]))
                self._begin_actor_recovery(key, st, addr)
            return
        except RpcRemoteError as e:
            if isinstance(e.cause, SpecCacheMiss):
                # The worker evicted our spec template before this call
                # decoded (bounded cache churn): re-heap and re-pump — the
                # forget() makes the next send ship the template in full.
                # Bounded: an unexpected persistent miss must surface, not
                # loop forever.
                with st["lock"]:
                    ent = st["inflight"].pop(seq, None)
                    if ent is not None and ent[0].miss_retries < 3:
                        call = ent[0]
                        call.miss_retries += 1
                        if call.digest is not None:
                            try:
                                self._actor_clients.get(addr) \
                                    .forget_template(call.digest)
                            except Exception:  # noqa: BLE001
                                log_swallowed(logger,
                                              "forget_template on miss")
                        heapq.heappush(st["heap"], (seq, call))
                        ent = None
                    self._pump_actor_queue(key, st)
                if ent is not None:
                    call = ent[0]
                    self._finish_actor_call(call)
                    self._record_task_error(
                        call.spec, call.pending,
                        TaskError.from_exception(
                            f"{call.spec.function_name}."
                            f"{call.spec.actor_method}", e.cause))
                    # This seq will never execute: step admission over the
                    # gap or every later call from the handle starves.
                    try:
                        self._actor_clients.get(addr).notify(
                            "skip_actor_seq", call.spec.actor_id.binary(),
                            call.spec.caller_id, seq)
                    except (RpcConnectionError, OSError):
                        pass
                return
            with st["lock"]:
                ent = st["inflight"].pop(seq, None)
            if ent is not None:
                call = ent[0]
                self._finish_actor_call(call)
                self._record_task_error(
                    call.spec, call.pending,
                    TaskError.from_exception(
                        f"{call.spec.function_name}.{call.spec.actor_method}",
                        e.cause))
            with st["lock"]:
                self._pump_actor_queue(key, st)
            return
        with st["lock"]:
            ent = st["inflight"].pop(seq, None)
        if ent is None:
            return
        call = ent[0]
        try:
            self._finish_actor_call(call)
            with st["lock"]:  # racing _begin_actor_recovery's quarantine
                if not st["recovering"]:
                    st["failed"].clear()  # incarnation works; reset ladder
                    st["deadline"] = None
            if result.get("ok"):
                self._record_task_results(call.spec, call.pending, result)
            else:
                self._merge_streamed(call.spec, result)
                self._record_task_error(call.spec, call.pending,
                                        serialization.loads(result["error"]))
        except BaseException as exc:  # noqa: BLE001 — keep the read loop
            # alive AND seal the pending task (e.g. a reply whose payload
            # can't be unpickled here) so ray.get raises instead of hanging.
            logger.exception("actor reply handling failed")
            try:
                self._record_task_error(
                    call.spec, call.pending,
                    TaskError.from_exception(
                        f"{call.spec.function_name}.{call.spec.actor_method}",
                        exc))
            except BaseException:  # noqa: BLE001
                logger.exception("sealing reply-handling error failed")
        with st["lock"]:
            self._pump_actor_queue(key, st)

    def _begin_actor_recovery(self, key, st, addr) -> None:
        """Caller holds ``st['lock']``. Quarantine the incarnation, fail
        every un-acked in-flight call back to the heap, and start ONE
        recovery job that waits for the next incarnation."""
        import heapq

        if st["recovering"]:
            return
        st["recovering"] = True
        st["failed"].add(addr)
        if st["deadline"] is None:
            st["deadline"] = time.time() + 300.0
        self._actor_addr_cache.pop(key[0], None)
        # Closing the client fails remaining in-flight futures; their
        # callbacks run synchronously HERE (reentrant lock) and each takes
        # the recovering-early-return path after re-heaping itself below.
        self._actor_clients.invalidate(addr)
        for seq, (call, _a) in sorted(st["inflight"].items()):
            call.var_bytes = None  # re-serialize with a fresh window_min
            heapq.heappush(st["heap"], (seq, call))
        st["inflight"].clear()
        try:
            self._submit_pool.submit(self._recover_actor_queue, key, st)
        except RuntimeError:  # pool shut down (driver exit)
            st["recovering"] = False

    def _recover_actor_queue(self, key, st) -> None:
        """Pool thread: wait out the restart ladder, then re-pump (oldest
        outstanding call first — the heap ordering guarantees it)."""
        while True:
            try:
                addr = self._actor_address(key[0])
            except Exception as e:  # noqa: BLE001 — actor dead / timeout
                with st["lock"]:
                    st["recovering"] = False
                    calls = self._take_all_queued(st)
                self._fail_actor_calls(
                    calls,
                    ActorDiedError(key[0].hex(), f"actor unavailable: {e}"))
                return
            with st["lock"]:
                if addr not in st["failed"]:
                    st["recovering"] = False
                    self._pump_actor_queue(key, st)
                    return
                deadline = st["deadline"]
                if deadline is not None and time.time() > deadline:
                    st["recovering"] = False
                    calls = self._take_all_queued(st)
                else:
                    calls = None
            if calls is not None:
                self._fail_actor_calls(
                    calls, ActorDiedError(key[0].hex(),
                                          "actor stuck on a dead worker"))
                return
            # Stale table entry: wait for the control plane to notice the
            # death rather than hammering a corpse.
            self._actor_addr_cache.pop(key[0], None)
            time.sleep(0.2)

    def _take_all_queued(self, st) -> list:
        """Caller holds ``st['lock']``: drain heap + inflight, oldest
        first."""
        calls = [c for _seq, c in sorted(st["heap"])]
        st["heap"].clear()
        for _seq, (call, _a) in sorted(st["inflight"].items()):
            calls.append(call)
        st["inflight"].clear()
        return calls

    def _fail_actor_calls(self, calls, error) -> None:
        for call in calls:
            self._finish_actor_call(call)
            self._record_task_error(call.spec, call.pending, error)

    def _finish_actor_call(self, call) -> None:
        """Drop the submission-duration argument pins exactly once."""
        if call.pinned:
            call.pinned = False
            for dep in call.spec.dependencies():
                self.reference_counter.remove_submitted_task_reference(dep)
            for noid in (call.nested_deps or ()):
                self.reference_counter.remove_submitted_task_reference(noid)

    def spec_cache_stats(self) -> dict:
        """Client-side cached-spec-encoding counters (benches read these)."""
        return self._spec_encoder.stats()

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._actor_addr_cache.pop(actor_id, None)
        self._gcs_rpc.call("kill_actor", actor_id, no_restart)

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        """Best-effort cancel: only not-yet-completed tasks are affected.

        Marking ``pending.cancelled`` under the cache lock makes the outcome
        deterministic: either the task completed first (value stays) or the
        cancel landed first and a late result is dropped by
        ``_record_task_results`` — never both racing into the cache.
        """
        with self._cache_cv:
            pending = self._pending.get(ref.id)
            if pending is not None and not pending.done.is_set():
                pending.cancelled = True
                error = TaskCancelledError(ref.id.task_id())
                error_payload = serialization.dumps(error)
                for oid in pending.refs:
                    if oid not in self._cache:
                        self._cache[oid] = error
                        # Owner-serve the cancellation too: borrowers on
                        # other processes resolving this ref must observe
                        # the error, not spin (nothing was ever sealed).
                        self._inline_owned[oid] = error_payload
                self._cache_cv.notify_all()

    # ====================== generators ======================

    def _generator_state(self, task_id: TaskID) -> _GenState:
        with self._cache_lock:
            state = self._generators.get(task_id)
            if state is None:
                state = self._generators[task_id] = _GenState()
            return state

    def _gen_item_or_none(self, state: _GenState, index: int):
        """Under state.lock: the item ref, None for end-of-stream, or
        _MISSING while the item hasn't been reported yet."""
        if index in state.items:
            state.consumed = max(state.consumed, index + 1)
            return ObjectRef(state.items[index],
                             owner_hint=self.owner_address)
        if state.total is not None and index >= state.total:
            return None
        return _MISSING

    def next_generator_item(self, task_id: TaskID, index: int):
        """Blocks until the producer has REPORTED item ``index`` (streamed
        mid-task, core_worker.cc:3199 analog) or the stream ended."""
        state = self._generator_state(task_id)
        deadline = time.time() + 300.0
        with state.cv:
            while True:
                got = self._gen_item_or_none(state, index)
                if got is not _MISSING:
                    return got
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise GetTimeoutError(
                        f"generator {task_id.hex()[:12]} timed out")
                state.cv.wait(timeout=min(remaining, 1.0))

    async def next_generator_item_async(self, task_id: TaskID, index: int):
        import asyncio

        state = self._generator_state(task_id)
        while True:
            with state.lock:
                got = self._gen_item_or_none(state, index)
            if got is not _MISSING:
                return got
            await asyncio.sleep(0.005)

    def release_generator(self, task_id: TaskID) -> None:
        """Consumer dropped its ObjectRefGenerator: reclaim the stream
        state and free owned items the consumer never took a ref to
        (items < consumed are governed by their handed-out ObjectRefs).

        The state stays in the table as a released tombstone so a
        still-producing worker's late reports are discarded rather than
        resurrecting an unreclaimable stream; tombstones are trimmed once
        the table grows past a bound."""
        with self._cache_lock:
            state = self._generators.get(task_id)
        if state is None:
            return
        with state.lock:
            if state.released:
                return
            state.released = True
            state.released_at = time.time()
            orphans = [oid for idx, oid in state.items.items()
                       if idx >= state.consumed]
            state.items.clear()
        for oid in orphans:
            self.reference_counter.drop_owned_if_unreferenced(oid)
        with self._cache_lock:
            if len(self._generators) > 4096:
                # Trim only tombstones whose producer can no longer report:
                # stream completed (total set) or released long ago.
                # Evicting a LIVE producer's tombstone would let its next
                # report resurrect an unreclaimable stream.
                now = time.time()
                stale = [t for t, s in self._generators.items()
                         if s.released and (s.total is not None
                                            or now - s.released_at > 600.0)]
                for tid in stale[:2048]:
                    self._generators.pop(tid, None)

    # ====================== placement groups ======================

    def create_placement_group(self, pg_id, bundles, strategy, name="",
                               timeout: float = 60.0,
                               gang_priority: int = 0) -> bool:
        return self._gcs_rpc.call("create_placement_group", pg_id, name,
                                  bundles, strategy, timeout, gang_priority,
                                  timeout=None)

    def remove_placement_group(self, pg_id) -> None:
        self._gcs_rpc.call("remove_placement_group", pg_id)

    def preempt_gangs(self, resources, count: int = 1,
                      min_priority: int = 0) -> int:
        """Revoke lower-class gangs so ``count`` units of ``resources``
        could be placed (serve autoscaling under SLO pressure)."""
        return self._gcs_rpc.call("preempt_gangs", dict(resources),
                                  int(count), int(min_priority))

    def get_placement_group(self, pg_id) -> Optional[dict]:
        return self._gcs_rpc.call("get_placement_group", pg_id)

    # ====================== log mirroring ======================

    def start_log_mirroring(self, sink=None) -> None:
        """Mirror worker stdout/stderr to this driver (the reference's
        GcsLogSubscriber path: node daemons tail worker log files into the
        GCS "logs" pubsub channel; we long-poll it)."""
        if getattr(self, "_log_thread", None) is not None:
            return
        sink = sink or (lambda entry, line: print(
            f"({entry['worker']}, node {entry['node_id'][:8]}) {line}"))

        # Client owned by self (not the loop) so shutdown can close it and
        # abort a parked long-poll instead of abandoning the thread to its
        # 30s RPC timeout.
        self._log_client = RpcClient(self.gcs_address)

        def poll_loop():
            cursor = 0
            client = self._log_client
            while not self._shutdown:
                try:
                    cursor, messages = client.call(
                        "poll_channel", "logs", cursor, 10.0, timeout=30.0)
                except (RpcConnectionError, TimeoutError):
                    if self._shutdown:
                        break
                    time.sleep(1.0)
                    continue
                except Exception:  # noqa: BLE001 — e.g. closed mid-shutdown
                    if self._shutdown:
                        break
                    log_swallowed(logger, "log-mirror poll")
                    time.sleep(1.0)
                    continue
                for batch in messages:
                    for entry in batch:
                        for line in entry["lines"]:
                            try:
                                sink(entry, line)
                            except Exception:  # noqa: BLE001
                                log_swallowed(logger, "log-mirror sink")
            client.close()

        self._log_thread = threading.Thread(
            target=poll_loop, name="log-mirror", daemon=True)
        self._log_thread.start()

    # ====================== lifecycle ======================

    def shutdown(self) -> None:
        self._shutdown = True
        from ray_tpu_torch.util import flightrec, tracing

        try:
            tracing.flush()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            log_swallowed(logger, "trace flush at shutdown")
        if self.mode == "driver":
            # Workers detach their ring in worker_main's exit hooks.
            flightrec.close()
        self._metrics_exporter.stop()
        # Abort the log-mirror's parked long-poll (closing the client
        # errors the in-flight call) and join the thread.
        log_client = getattr(self, "_log_client", None)
        if log_client is not None:
            try:
                log_client.close()
            except Exception:  # noqa: BLE001 — already closed/errored
                log_swallowed(logger, "log client close at shutdown")
        log_thread = getattr(self, "_log_thread", None)
        if log_thread is not None:
            log_thread.join(timeout=2.0)
        if self._borrow_sweeper_started:
            self._borrow_sweep_stop.set()
            self._borrow_sweeper.join(timeout=2.0)
        # Flush __del__-deferred releases while the owner/GCS connections
        # are still open (deregistrations and frees ride RPCs).
        self._ref_release_stop.set()
        self._ref_release_thread.join(timeout=2.0)
        # Wake hot-idle runners and let them hand their leased workers back
        # while the daemon connections are still open — otherwise the
        # daemons' conn-close reclaim KILLS those workers (they might be
        # mid-task) and the pool pays a full respawn.
        with self._key_lock:
            for st in self._key_states.values():
                st.cv.notify_all()
        deadline = time.time() + 3.0
        while time.time() < deadline:
            with self._key_lock:
                if not any(st.runners for st in self._key_states.values()):
                    break
            time.sleep(0.02)
        # Hand parked leased workers back before closing the daemon conns.
        with self._key_lock:
            parked = [e for st in self._key_states.values()
                      for e, _t in st.idle]
            for st in self._key_states.values():
                st.idle.clear()
        for entry in parked:
            self._release_entry(entry)
        if self.mode == "driver":
            try:
                self._gcs_rpc.notify("finish_job", self.job_id)
            except RpcConnectionError:
                pass
        self._submit_pool.shutdown(wait=False, cancel_futures=True)
        if self._lease_pool is not None:
            self._lease_pool.shutdown(wait=False, cancel_futures=True)
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown(wait=False, cancel_futures=True)
        if self._get_pool is not None:
            self._get_pool.shutdown(wait=False, cancel_futures=True)
        self._owner_server.stop()
        self._owner_clients.close_all()
        self._daemons.close_all()
        self._actor_clients.close_all()
        self._worker_clients.close_all()
        self._gcs_rpc.close()
        if self._shm is not None:
            self._shm.close()
        # If this worker IS the process-global runtime (cluster.connect
        # installs it there), clear the slot — otherwise a later
        # ``ray_tpu_torch.init()`` in the same process finds a dead handle and
        # every call raises "client closed".
        from ray_tpu_torch.core import runtime as runtime_mod

        if runtime_mod._global_runtime is self:
            runtime_mod._global_runtime = None
            from ray_tpu_torch.core.config import set_config
            from ray_tpu_torch.util.state import _reset_task_cache

            set_config(None)
            _reset_task_cache()


_MISSING = object()
