"""Task IR — the universal description of a unit of remote work.

Analog of the reference's ``TaskSpec`` protobuf
(``src/ray/protobuf/common.proto:398`` — function descriptor, args as inline
values or object references, resource shape, retry policy, scheduling
strategy, actor-creation payload). We keep it a plain picklable dataclass so
the same IR flows through the in-process scheduler today and socket RPC in the
multiprocess runtime.

The port's copy of ``ray_tpu/core/task_spec.py``, with the cached wire
encoding of the multiprocess cluster (``SpecEncoder``/``SpecTemplateStore``).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch.core.resources import ResourceSet


class TaskType(enum.Enum):
    # Mirrors common.proto:41 TaskType.
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


# Reserved actor-method name dispatched to the compiled-DAG resident loop
# (ray_tpu_torch.dag.compiled_dag.actor_dag_loop) by BOTH runtimes' actor-task
# executors. Lives here so the dispatchers and the dag package share one
# definition without import cycles.
DAG_LOOP_METHOD = "__ray_tpu_dag_loop__"


@dataclass
class TaskArg:
    """Either an inline (already serialized-with-the-spec) value or a ref.

    ``owner_addr`` rides with ref args so the executing worker can resolve
    small objects straight from their owner's in-process store (the
    reference's ownership-based object directory — ``ObjectReference`` in
    common.proto:576 carries ``owner_address``)."""

    value: Any = None
    object_id: Optional[ObjectID] = None
    owner_addr: Optional[str] = None

    @property
    def is_ref(self) -> bool:
        return self.object_id is not None

    def __reduce__(self):
        # Positional tuple instead of the default dataclass __dict__ pickle:
        # specs cross a socket on EVERY remote call, and skipping the three
        # field-name strings per arg measurably cuts the hot-path cost.
        return (TaskArg, (self.value, self.object_id, self.owner_addr))


@dataclass
class SchedulingStrategy:
    """Base for scheduling strategies (common.proto:111 SchedulingStrategy)."""


@dataclass
class DefaultSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass
class SpreadSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass
class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    # reference: python/ray/util/scheduling_strategies.py
    node_id: Any = None
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeLabelSchedulingStrategy(SchedulingStrategy):
    hard: Dict[str, Any] = field(default_factory=dict)
    soft: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TaskOptions:
    """Resolved per-call options (reference:
    ``python/ray/_private/ray_option_utils.py``)."""

    name: str = ""
    num_returns: Any = 1  # int | "dynamic" | "streaming"
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 3
    retry_exceptions: Any = False  # bool | list[type]
    scheduling_strategy: SchedulingStrategy = field(
        default_factory=DefaultSchedulingStrategy
    )
    # Actor-only options
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    lifetime: Optional[str] = None  # None | "detached"
    namespace: Optional[str] = None
    get_if_exists: bool = False
    concurrency_groups: Dict[str, int] = field(default_factory=dict)
    # Per-task/actor runtime environment (reference: runtime_env option in
    # ray_option_utils.py; dict form of ray_tpu_torch.runtime_env.RuntimeEnv)
    runtime_env: Optional[Dict[str, Any]] = None

    def resource_set(self) -> ResourceSet:
        return ResourceSet(self.resources)

    def __reduce__(self):
        # Positional tuple pickle (see TaskArg.__reduce__): one TaskOptions
        # rides inside every TaskSpec on the wire.
        return (TaskOptions, (
            self.name, self.num_returns, self.resources, self.max_retries,
            self.retry_exceptions, self.scheduling_strategy,
            self.max_restarts, self.max_task_retries, self.max_concurrency,
            self.max_pending_calls, self.lifetime, self.namespace,
            self.get_if_exists, self.concurrency_groups, self.runtime_env))


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function_id: str
    function_name: str
    args: List[TaskArg]
    kwargs: Dict[str, TaskArg]
    options: TaskOptions
    # Actor fields
    actor_id: Optional[ActorID] = None
    actor_method: Optional[str] = None
    actor_creation_class_id: Optional[str] = None
    # Ordering: per-caller sequence number for actor tasks (reference:
    # sequential_actor_submit_queue.cc enforces submission order). caller_id
    # identifies the submitting handle instance.
    sequence_number: int = 0
    caller_id: str = ""
    # Lowest un-acked sequence number for this handle at send time. With a
    # PIPELINED client window, requests can reach the server's pool threads
    # out of order — the first-arriving request's window_min (not its own
    # sequence_number) is the correct admission baseline for a fresh
    # incarnation, and it lets the server skip sequence numbers the client
    # dropped before sending (see worker_main._admit_in_order). -1 =
    # unknown (spec built outside the pipelined transport): the server
    # falls back to baselining on the first-seen sequence number.
    window_min: int = -1
    concurrency_group: str = ""
    # Retry bookkeeping
    attempt_number: int = 0
    # Owner-service address of the submitting process (ObjectReference's
    # owner_address, common.proto:576): executing workers push streaming
    # generator items here as produced (core_worker.cc:3199
    # HandleReportGeneratorItemReturns analog). "" = no streaming reports.
    owner_addr: str = ""
    # Tracing: (trace_id, parent_span_id) of the submitting context —
    # cross-process span propagation (tracing_helper.py:169-175 analog).
    trace_ctx: Optional[tuple] = None
    # Wall-clock submission stamp (set at spec construction): the executing
    # worker derives the "queued" and "total" task lifecycle phases from it
    # (submit → execution start / submit → finish). Wall time, not
    # monotonic, because it crosses processes; 0.0 = unknown.
    submit_ts: float = field(default_factory=time.time)

    def return_object_ids(self, num: Optional[int] = None) -> List[ObjectID]:
        n = num if num is not None else (
            self.options.num_returns if isinstance(self.options.num_returns, int) else 0
        )
        return [ObjectID.for_task_return(self.task_id, i) for i in range(n)]

    def declared_resources(self) -> Dict[str, float]:
        """The task's effective resource footprint (normal tasks imply
        CPU=1) — ONE definition shared by submission-side lease requests and
        the worker's blocked-release reacquire, so they can never drift."""
        resources = dict(self.options.resources)
        if self.task_type == TaskType.NORMAL_TASK and "CPU" not in resources:
            resources["CPU"] = 1.0
        return resources

    def dependencies(self) -> List[ObjectID]:
        deps = [a.object_id for a in self.args if a.is_ref]
        deps += [a.object_id for a in self.kwargs.values() if a.is_ref]
        return deps

    def __reduce__(self):
        # Positional tuple pickle; the enum travels as its int value (the
        # default enum pickle does a module+name lookup per spec).
        return (_make_task_spec, (
            self.task_id, self.job_id, self.task_type.value,
            self.function_id, self.function_name, self.args, self.kwargs,
            self.options, self.actor_id, self.actor_method,
            self.actor_creation_class_id, self.sequence_number,
            self.caller_id, self.window_min, self.concurrency_group,
            self.attempt_number, self.owner_addr, self.trace_ctx,
            self.submit_ts))


def _make_task_spec(task_id, job_id, task_type_value, *rest) -> TaskSpec:
    return TaskSpec(task_id, job_id, TaskType(task_type_value), *rest)


# ---------------------------------------------------------------------------
# Cached spec encoding — the wire fast path for steady-state remote calls.
#
# A TaskSpec splits into an INVARIANT template (function descriptor, options/
# resource spec, actor identity, owner address — identical for every call
# through one callable) and a small VARIANT part (task id, arguments,
# sequence numbers, trace context). The template is pickled once, content-
# addressed by digest, and shipped to each peer connection once; steady-state
# calls then carry ``(digest, var_bytes)`` — only the arguments are pickled
# per call. Content addressing makes invalidation automatic: a changed
# resource spec or a different actor handle produces different template
# bytes, hence a different digest, hence a fresh cache entry.
# ---------------------------------------------------------------------------


class SpecCacheMiss(Exception):
    """A peer referenced a spec template digest this process doesn't hold
    (bounded-cache eviction or a restarted server). The caller re-sends the
    full template and retries — see CoreWorker's run_task/run_actor_task
    submission paths."""


def spec_template_fields(spec: TaskSpec) -> tuple:
    """The invariant-per-callable portion of a spec (see module comment)."""
    return (spec.job_id, spec.task_type.value, spec.function_id,
            spec.function_name, spec.options, spec.actor_id,
            spec.actor_method, spec.actor_creation_class_id, spec.caller_id,
            spec.concurrency_group, spec.owner_addr)


def spec_var_fields(spec: TaskSpec) -> tuple:
    """The per-call portion of a spec."""
    return (spec.task_id, spec.args, spec.kwargs, spec.sequence_number,
            spec.window_min, spec.attempt_number, spec.trace_ctx,
            spec.submit_ts)


def assemble_spec(tfields: tuple, vfields: tuple) -> TaskSpec:
    (job_id, ttype, function_id, function_name, options, actor_id,
     actor_method, acc_id, caller_id, cgroup, owner_addr) = tfields
    (task_id, args, kwargs, seq, window_min, attempt, trace_ctx,
     submit_ts) = vfields
    return TaskSpec(
        task_id=task_id, job_id=job_id, task_type=TaskType(ttype),
        function_id=function_id, function_name=function_name, args=args,
        kwargs=kwargs, options=options, actor_id=actor_id,
        actor_method=actor_method, actor_creation_class_id=acc_id,
        sequence_number=seq, caller_id=caller_id, window_min=window_min,
        concurrency_group=cgroup, attempt_number=attempt,
        owner_addr=owner_addr, trace_ctx=trace_ctx, submit_ts=submit_ts)


class SpecEncoder:
    """Client-side template memoizer.

    ``encode_template`` returns ``(digest, template_bytes)`` for a spec,
    re-pickling only when the callable changes. The memo key includes the
    IDENTITY of the options object — callables that resolve their options
    once (plain ``handle.method.remote()`` / ``fn.remote()`` calls) hit the
    memo; per-call ``.options(...)`` overrides re-encode (and naturally get
    their own digest). The cached options reference keeps the object alive,
    so an ``id()`` can never be recycled while its entry is live.

    ``wire_hits``/``wire_misses`` count steady-state sends that skipped the
    template versus sends that had to ship it (the spec-cache hit rate
    reported by benches/core_perf.py).
    """

    def __init__(self, cap: Optional[int] = None):
        import threading
        from collections import OrderedDict

        if cap is None:
            from ray_tpu_torch.core.config import config

            cap = config().spec_cache_size
        self._cap = max(2, int(cap))
        self._cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.encode_hits = 0
        self.encode_misses = 0
        self.wire_hits = 0
        self.wire_misses = 0

    def encode_template(self, spec: TaskSpec) -> tuple:
        key = (id(spec.options), spec.task_type.value, spec.function_id,
               spec.function_name, spec.actor_id, spec.actor_method,
               spec.caller_id, spec.concurrency_group, spec.owner_addr)
        with self._lock:
            ent = self._cache.get(key)
            if ent is not None and ent[0] is spec.options:
                self._cache.move_to_end(key)
                self.encode_hits += 1
                return ent[1], ent[2]
        import hashlib

        from ray_tpu_torch.core import serialization

        blob = serialization.dumps_inband(spec_template_fields(spec))
        digest = hashlib.blake2b(blob, digest_size=16).digest()
        with self._lock:
            self.encode_misses += 1
            self._cache[key] = (spec.options, digest, blob)
            while len(self._cache) > self._cap:
                self._cache.popitem(last=False)
        return digest, blob

    def encode_vars(self, spec: TaskSpec) -> bytes:
        from ray_tpu_torch.core import serialization

        return serialization.dumps_inband(spec_var_fields(spec))

    def stats(self) -> dict:
        sent = self.wire_hits + self.wire_misses
        return {
            "encode_hits": self.encode_hits,
            "encode_misses": self.encode_misses,
            "wire_hits": self.wire_hits,
            "wire_misses": self.wire_misses,
            "hit_rate": self.wire_hits / sent if sent else 0.0,
        }


class SpecTemplateStore:
    """Server-side bounded digest → decoded-template store. Registration
    happens on the connection loop (ordered before any request that uses
    the digest); lookups happen on pool threads."""

    def __init__(self, cap: Optional[int] = None):
        import threading
        from collections import OrderedDict

        if cap is None:
            from ray_tpu_torch.core.config import config

            cap = config().spec_cache_size
        self._cap = max(2, int(cap))
        self._store: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._lock = threading.Lock()

    _POISON = "poisoned-template"

    def register(self, digest: bytes, blob: bytes) -> None:
        from ray_tpu_torch.core import serialization

        try:
            entry = serialization.loads_inband(blob)
        except BaseException as e:  # noqa: BLE001 — version skew / missing
            # import on this side. Store the FAILURE: decode must raise the
            # real deserialization error, not SpecCacheMiss — a miss makes
            # the client forget + re-send the same poisoned blob forever.
            entry = (self._POISON, f"{type(e).__name__}: {e}")
        with self._lock:
            self._store[digest] = entry
            self._store.move_to_end(digest)
            while len(self._store) > self._cap:
                self._store.popitem(last=False)

    def decode(self, payload) -> TaskSpec:
        """``payload``: legacy full-spec bytes, or ``(digest, var_bytes)``.
        Raises :class:`SpecCacheMiss` for an unknown digest."""
        from ray_tpu_torch.core import serialization

        if isinstance(payload, (bytes, bytearray, memoryview)):
            return serialization.loads(payload)
        digest, var_bytes = payload
        with self._lock:
            tfields = self._store.get(digest)
            if tfields is not None:
                self._store.move_to_end(digest)
        if tfields is None:
            raise SpecCacheMiss(digest.hex())
        if isinstance(tfields, tuple) and len(tfields) == 2 \
                and tfields[0] is self._POISON:
            raise RuntimeError(
                f"task-spec template {digest.hex()} failed to deserialize "
                f"on the worker: {tfields[1]}")
        return assemble_spec(tfields, serialization.loads_inband(var_bytes))
