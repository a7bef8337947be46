"""Worker process — executes tasks and hosts actors.

Analog of the reference's worker process
(``python/ray/_private/workers/default_worker.py`` bootstrap; task execution
callback ``_raylet.pyx:2246 task_execution_handler``; server-side actor
scheduling queues ``transport/actor_scheduling_queue.cc`` with per-caller
sequence ordering from ``sequential_actor_submit_queue.cc`` and concurrency
control from ``concurrency_group_manager.cc``).

Spawned by the node daemon with identity/addresses in env vars; registers its
RPC server back with the daemon, installs a :class:`CoreWorker` as the global
runtime (so nested ``f.remote()``/``get``/``put`` inside user code work), and
serves ``run_task`` / ``start_actor`` / ``run_actor_task``.

The port's copy of ``ray_tpu/core/worker_main.py``: ``DAG_LOOP_METHOD``
parks an actor in its resident compiled-DAG loop, which detaches the
channel endpoints it attached when it exits. The lock-order and leak
checkers' start-up hooks come with those checkers. A worker imports torch
only when a tensor or a user's code needs it.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import Config, config, set_config
from ray_tpu_torch.core.core_worker import CoreWorker
from ray_tpu_torch.core.exceptions import ActorError, TaskCancelledError, TaskError
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.rpc import RpcClient, RpcConnectionError, RpcServer
from ray_tpu_torch.core.task_spec import (DAG_LOOP_METHOD, SpecTemplateStore,
                                    TaskSpec)
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("worker")


class _DependencyFailed(Exception):
    def __init__(self, error):
        self.error = error


class _StreamFailed(Exception):
    """A generator task raised ``cause`` after streaming ``items`` (their
    ids): the error reply lists them, so the owner seals the error after
    every item yielded before it."""

    def __init__(self, cause: BaseException, items: List[bytes]):
        self.cause = cause
        self.items = items


def _lineage_bytes(spec: "TaskSpec") -> bytes:
    """Re-pickle a decoded spec for the lineage record, inside a PRIVATE
    ref-collection scope: the lazy materialization runs under
    ``_package_results``'s ``collecting_refs`` block, and letting the
    spec's ARGUMENT refs leak into that collector would register the
    caller as borrower of refs the return value doesn't contain."""
    with serialization.collecting_refs():
        return serialization.dumps(spec)


class _TaskEventBuffer:
    """Batched task-event reporting (the reference's per-worker
    ``task_event_buffer.cc`` → ``gcs_task_manager.cc`` pipeline): events
    accumulate locally and a flusher ships them to the GCS once a second —
    the execution hot path never pays a control-plane round trip."""

    FLUSH_INTERVAL_S = 1.0
    MAX_BUFFER = 1000

    def __init__(self, gcs_rpc):
        self._gcs = gcs_rpc
        self._buf: List[dict] = []
        self._lock = threading.Lock()
        self._started = False

    def record(self, event: dict) -> None:
        with self._lock:
            if len(self._buf) < self.MAX_BUFFER:
                self._buf.append(event)
            if not self._started:
                self._started = True
                threading.Thread(target=self._flush_loop,
                                 name="task-events", daemon=True).start()

    def _flush_loop(self) -> None:
        while True:
            time.sleep(self.FLUSH_INTERVAL_S)
            self.flush()

    def flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        if batch:
            try:
                self._gcs.notify("record_task_events", batch)
            except Exception:  # noqa: BLE001 — tracing never breaks work
                log_swallowed(logger, "task-event flush")


class _ActorState:
    """A resident actor instance + its scheduling queue state."""

    def __init__(self, actor_id: ActorID, instance: Any, max_concurrency: int):
        self.actor_id = actor_id
        self.instance = instance
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.next_seq: Dict[str, int] = {}  # caller_id -> next expected seq
        # caller_id -> seq currently EXECUTING under strict serial ordering
        # (cursor held for the call's whole runtime): admission waiters
        # treat an executing predecessor as progress, not starvation.
        self.executing: Dict[str, int] = {}
        # Seqs the client dropped before sending (unpicklable args): the
        # admission loop steps over them instead of waiting forever.
        self.skipped: Dict[str, set] = {}
        self.slots = threading.Semaphore(max(1, max_concurrency))
        self.serial = max_concurrency <= 1
        self.loop: Optional[asyncio.AbstractEventLoop] = None  # async actors
        # method name -> (bound method, is_coroutine): resolved once — the
        # getattr + inspect.iscoroutinefunction pair costs ~10us per call
        # on the hot path.
        self.methods: Dict[str, Any] = {}

    def resolve_method(self, name: str):
        entry = self.methods.get(name)
        if entry is None:
            method = getattr(self.instance, name, None)
            if method is None:
                return None
            entry = (method, inspect.iscoroutinefunction(method))
            self.methods[name] = entry
        return entry

    def ensure_loop(self) -> asyncio.AbstractEventLoop:
        with self.lock:
            if self.loop is None:
                loop = asyncio.new_event_loop()
                threading.Thread(target=loop.run_forever,
                                 name=f"actor-loop-{self.actor_id.hex()[:8]}",
                                 daemon=True).start()
                self.loop = loop
            return self.loop


class WorkerService:
    """RPC surface pushed to by the daemon (tasks) and callers (actor tasks)."""

    def __init__(self, core: CoreWorker, worker_id=None, daemon_client=None):
        self.core = core
        self.worker_id = worker_id
        self._daemon = daemon_client
        self._actors: Dict[ActorID, _ActorState] = {}
        self._actors_lock = threading.Lock()
        # Cached task-spec templates, registered in-order by the RPC conn
        # loop ("tmpl" frames) before any request referencing them.
        self._spec_store = SpecTemplateStore()
        self._task_lease = threading.local()
        self._events = _TaskEventBuffer(core._gcs_rpc)
        # Spans opened in this worker ride the SAME batched task-event
        # pipeline (one record_task_events notify per flush) instead of
        # paying one RPC per span.
        from ray_tpu_torch.util import tracing

        tracing.set_sink(self._events.record)
        # Blocked-worker protocol (reference: CPU released while a worker
        # blocks in ray.get — worker.py release/reacquire; prevents nested
        # task deadlock on a fully leased cluster).
        core.blocked_on_get = self._release_lease_while_blocked
        core.unblocked_after_get = self._reacquire_lease

    def _release_lease_while_blocked(self) -> None:
        from ray_tpu_torch.core.lease_table import is_block_lease

        st = getattr(self._task_lease, "value", None)
        if not st or st["released"] or st["lease_id"] is None:
            return
        if is_block_lease(st["lease_id"]):
            # Block-carved lease: the DAEMON is the release authority (the
            # freed unit rejoins its block's local pool; the GCS learns via
            # the idle sweep). Reacquire still goes through the GCS
            # (node-affine request_lease) — prefix dispatch keeps the mixed
            # lease ids straight.
            if self._daemon is None:
                return
            try:
                self._daemon.call("release_block_lease", st["lease_id"],
                                  timeout=10.0)
            except (RpcConnectionError, TimeoutError):
                return
            st["released"] = True
            try:
                self._daemon.notify("update_worker_lease", self.worker_id,
                                    None)
            except RpcConnectionError:
                pass
            return
        try:
            self.core._gcs_rpc.notify("release_lease", st["lease_id"])
        except RpcConnectionError:
            return
        # The GCS notify is the authoritative release — mark it NOW so a
        # failed (best-effort) daemon note can't leave us running without a
        # lease and never reacquiring.
        st["released"] = True
        if self._daemon is not None:
            try:
                self._daemon.notify("update_worker_lease", self.worker_id, None)
            except RpcConnectionError:
                pass

    def _reacquire_lease(self) -> None:
        """Idempotent; called from get()-batch finallys. Failures are
        swallowed (released stays True, so the NEXT batch retries) — a
        transient GCS outage must never clobber an already-fetched value."""
        st = getattr(self._task_lease, "value", None)
        if not st or not st["released"]:
            return
        try:
            self._reacquire_lease_inner(st)
        except Exception:  # noqa: BLE001 — retried on the next get batch
            logger.warning("lease reacquire failed; will retry next get")

    def _reacquire_lease_inner(self, st) -> None:
        from ray_tpu_torch.core.task_spec import NodeAffinitySchedulingStrategy

        strategy = NodeAffinitySchedulingStrategy(
            node_id=self.core.current_node_id, soft=False)
        lease_id, _node, _addr = self.core._request_lease(
            st["resources"], strategy)
        st["lease_id"] = lease_id
        st["released"] = False
        if self._daemon is not None:
            # BLOCKING call (not a note): the daemon must know about the new
            # lease before we resume work, shrinking the crash window in
            # which a reacquired lease exists that nobody could release to
            # the instant between grant and this call.
            try:
                self._daemon.call("update_worker_lease", self.worker_id,
                                  lease_id, timeout=10.0)
            except (RpcConnectionError, TimeoutError):
                pass

    # ====================== normal tasks ======================

    def _begin_trace(self, spec: TaskSpec) -> tuple:
        """Adopt the caller's span context for this task's execution."""
        from ray_tpu_torch.util import tracing

        span_id = spec.task_id.hex()[:16]
        trace_id = spec.trace_ctx[0] if spec.trace_ctx else span_id
        parent = spec.trace_ctx[1] if spec.trace_ctx else None
        # Carry the root's head-based sampling decision so spans opened
        # inside this task inherit it (never a half-collected trace).
        sampled = (bool(spec.trace_ctx[2])
                   if spec.trace_ctx and len(spec.trace_ctx) > 2 else True)
        tracing.set_context((trace_id, span_id, sampled))
        flightrec.record("task", spec.task_id.hex()[:16],
                         f"start {spec.function_name[:40]} trace={trace_id}")
        return (trace_id, span_id, parent, time.time())

    def _end_trace(self, spec: TaskSpec, trace: tuple, ok: bool,
                   phases: Optional[dict] = None) -> None:
        from ray_tpu_torch.core.metrics_export import observe_task_phases
        from ray_tpu_torch.util import tracing

        tracing.set_context(None)
        trace_id, span_id, parent, started = trace
        name = spec.function_name
        if spec.actor_method:
            name = f"{name}.{spec.actor_method}"
        now = time.time()
        if phases is not None and spec.submit_ts:
            phases["total"] = max(0.0, now - spec.submit_ts)
        event = {
            "task_id": spec.task_id.hex(),
            "name": name,
            "state": "FINISHED" if ok else "FAILED",
            "time": now,
            "duration": now - started,
            "node_id": self.core.current_node_id.hex()
            if self.core.current_node_id else "",
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_span_id": parent,
        }
        if phases:
            event["phases"] = {k: round(v, 6) for k, v in phases.items()}
            observe_task_phases(phases, ok=ok)
        flightrec.record("task", spec.task_id.hex()[:16],
                         f"{'finish' if ok else 'FAIL'} trace={trace_id}")
        self._events.record(event)

    def register_spec_template(self, digest: bytes, blob: bytes) -> None:
        """Called by the RPC server's connection loop on "tmpl" frames."""
        self._spec_store.register(digest, blob)

    def run_task(self, spec_bytes, lease_id: str | None = None) -> dict:
        from ray_tpu_torch.core.core_worker import arg_borrow_scope

        spec: TaskSpec = self._spec_store.decode(spec_bytes)
        if not isinstance(spec_bytes, (bytes, bytearray, memoryview)):
            # Cached-template call: the full spec pickle (lineage for
            # reconstruction-by-resubmission) is only materialized if a
            # sealed return actually records it.
            spec_bytes = None
        self.core.current_task_id = spec.task_id
        st = {"lease_id": lease_id,
              "resources": spec.declared_resources(), "released": False}
        self._task_lease.value = st
        trace = self._begin_trace(spec)
        # Lifecycle phase stamps (task lifecycle histogram): submit→here is
        # the queued phase (wire + lease + scheduling), then dep fetch, then
        # user-code runtime; _end_trace adds submit→finish as "total".
        t_recv = time.time()
        phases = ({"queued": max(0.0, t_recv - spec.submit_ts)}
                  if spec.submit_ts else {})
        borrowed: set = set()
        try:
            fn = self.core.gcs.get_function(spec.function_id)
            if fn is None:
                raise RuntimeError(f"function {spec.function_id} not in GCS")
            with arg_borrow_scope() as borrowed:
                args, kwargs = self._resolve_args(spec)
            t_args = time.time()
            phases["args_fetch"] = t_args - t_recv
            result = fn(*args, **kwargs)
            phases["execute"] = time.time() - t_args
            args = kwargs = None  # drop frame pins before the borrow audit
            # Lineage = the full spec pickle. Cached-template calls carry
            # no full pickle on the wire, so it is rebuilt lazily — only
            # when a sealed return actually records it.
            lineage = (spec_bytes if spec_bytes is not None
                       else (lambda: _lineage_bytes(spec)))
            out = self._package_results(spec, result, lineage=lineage)
            result = None
        except _DependencyFailed as df:
            out = self._package_error(spec, df.error)
        except _StreamFailed as sf:
            out = self._package_error(
                spec, TaskError.from_exception(spec.function_name, sf.cause),
                first_index=len(sf.items))
            out["generator_items"] = sf.items
        except BaseException as exc:  # noqa: BLE001 — wire to the caller
            out = self._package_error(
                spec, TaskError.from_exception(spec.function_name, exc))
        finally:
            self._task_lease.value = None
            self.core.current_task_id = None
        self._end_trace(spec, trace, ok=bool(out.get("ok")), phases=phases)
        # Borrow handover BEFORE the reply: the caller's call-duration pin
        # is released when it processes this reply, so any arg ref this
        # process still holds must be registered with its owner first
        # (reference_count.h:61 borrower reporting on task completion).
        self._handover_borrows(borrowed)
        # IN-BAND lease report: blocked-release may have swapped (or shed)
        # the lease mid-task; telling the daemon in the reply — the same
        # channel it releases on — makes the ordering deterministic (the
        # side-channel notify only covers the worker-crash case).
        out["final_lease_id"] = None if st["released"] else st["lease_id"]
        return out

    def _handover_borrows(self, candidates: set) -> None:
        """Register still-held arg borrows with their owners, synchronously,
        before the task reply releases the caller's pins."""
        if not candidates:
            return
        retained = self.core.reference_counter.retained_arg_borrows(candidates)
        for oid, addr in retained:
            try:
                self.core._owner_clients.get(addr).call(
                    "add_borrower", oid.binary(), self.core.owner_address,
                    timeout=30.0)
            except (RpcConnectionError, TimeoutError):
                pass  # owner gone; the object is already lost

    def _register_return_contained(self, spec: TaskSpec, inner_refs) -> list:
        """A return value CONTAINS refs: register the CALLER (the return
        object's owner) as borrower of each before replying — the handover
        that makes nested refs in results safe with no unpinned window.
        Returns the (inner id, owner addr) list to ride in the reply."""
        out = []
        for r in inner_refs:
            owner_addr = r._owner_hint
            if not owner_addr:
                continue  # legacy/untracked ref
            out.append((r.id.binary(), owner_addr))
            if owner_addr == spec.owner_addr:
                # Caller owns the inner ref: it pins locally when it
                # records the contained entry; no registration needed.
                continue
            if owner_addr == self.core.owner_address:
                # This process owns the inner ref: register the caller
                # directly.
                self.core.reference_counter.add_borrower(r.id, spec.owner_addr)
                continue
            try:
                self.core._owner_clients.get(owner_addr).call(
                    "add_borrower", r.id.binary(), spec.owner_addr,
                    timeout=30.0)
            except (RpcConnectionError, TimeoutError):
                pass  # inner owner gone; ref is lost regardless
        return out

    @staticmethod
    def _arg_refs(spec: TaskSpec) -> List[ObjectRef]:
        """The spec's top-level ref arguments, in positional order."""
        return [ObjectRef(a.object_id,
                          owner_hint=getattr(a, "owner_addr", None))
                for a in list(spec.args) + list(spec.kwargs.values())
                if a.is_ref]

    def _resolve_args(self, spec: TaskSpec) -> Tuple[list, dict]:
        """Resolve every argument; ref args fetch CONCURRENTLY through the
        core's batched get (one locate round trip, bounded fan-out) instead
        of one blocking fetch per ref."""
        refs = self._arg_refs(spec)
        try:
            values = self.core.resolve_refs(refs) if refs else []
            for value in values:
                if isinstance(value,
                              (TaskError, TaskCancelledError, ActorError)):
                    raise _DependencyFailed(value)
            it = iter(values)
            args = [next(it) if a.is_ref else a.value for a in spec.args]
            kwargs = {k: next(it) if v.is_ref else v.value
                      for k, v in spec.kwargs.items()}
        finally:
            # One reacquire for the whole dependency batch (the hooks are
            # idempotent; the fetches only release).
            if self.core.unblocked_after_get is not None:
                self.core.unblocked_after_get()
        return args, kwargs

    def _package_results(self, spec: TaskSpec, result,
                         lineage=None) -> dict:
        # Lineage (the pickled creating TaskSpec) rides with every sealed
        # return of a NORMAL task so the cluster can reconstruct the object
        # by resubmission after node loss (object_recovery_manager.h:41).
        # Actor-task outputs are not reconstructable (state-dependent), same
        # as the reference.
        from ray_tpu_torch.core.task_spec import TaskType

        if spec.task_type is not TaskType.NORMAL_TASK:
            lineage = None
        n = spec.options.num_returns
        if n in ("dynamic", "streaming"):
            return self._stream_generator(spec, result, lineage)
        if n == 0:
            return {"ok": True, "returns": []}
        values = (result,) if n == 1 else tuple(result)
        if n > 1 and len(values) != n:
            raise ValueError(
                f"task {spec.function_name} declared num_returns={n} but "
                f"returned {len(values)} values"
            )
        returns = []
        contained: Dict[bytes, list] = {}
        for i, value in enumerate(values):
            oid = ObjectID.for_task_return(spec.task_id, i)
            with serialization.collecting_refs() as inner_refs:
                inline = self._seal_return(oid, value,
                                           lineage if i == 0 else None,
                                           sealed_siblings=n > 1)
            if inner_refs:
                entries = self._register_return_contained(spec, inner_refs)
                if entries:
                    contained[oid.binary()] = entries
            returns.append((oid.binary(), inline))
        out = {"ok": True, "returns": returns}
        if contained:
            out["contained"] = contained
        return out

    def _stream_generator(self, spec: TaskSpec, result, lineage) -> dict:
        """Drive a generator task INCREMENTALLY: every item is reported to
        the owner as produced (``core_worker.cc:3199
        HandleReportGeneratorItemReturns`` analog), so the consumer's
        iterator unblocks mid-task. Small items ride inline in the report
        (owner-served); big items are sealed node-side first. The producer
        backpressures when it runs more than
        ``streaming_backpressure_items`` ahead of the consumer.
        """
        if callable(lineage):
            lineage = lineage()
        owner = None
        if spec.owner_addr:
            try:
                owner = self.core._owner_clients.get(spec.owner_addr)
            except Exception:  # noqa: BLE001 — buffered fallback below
                owner = None
        items: List[bytes] = []
        try:
            self._stream_items(spec, result, lineage, owner, items)
        except BaseException as exc:  # noqa: BLE001 — wired to the caller
            raise _StreamFailed(exc, items) from exc
        return {"ok": True, "returns": [], "generator_items": items}

    def _stream_items(self, spec: TaskSpec, result, lineage, owner,
                      items: List[bytes]) -> None:
        """``_stream_generator``'s loop: appends each reported item's id to
        ``items``."""
        window = config().streaming_backpressure_items
        inline_cap = config().max_inline_object_size
        for i, item in enumerate(result):
            oid = ObjectID.for_task_return(spec.task_id, i)
            ser = serialization.serialize(item)
            if ser.framed_size() <= inline_cap and owner is not None:
                # Inline item: the report itself delivers the value into
                # the owner's cache — no seal at all.
                inline = ser.to_bytes()
                if i == 0 and lineage is not None:
                    try:
                        self.core._gcs_rpc.notify("add_lineage",
                                                  oid.binary(), lineage)
                    except RpcConnectionError:
                        pass
            else:
                inline = None
                self.core.seal_serialized(oid, ser,
                                          lineage if i == 0 else None)
            items.append(oid.binary())
            if owner is not None:
                try:
                    owner.notify("report_generator_item", spec.task_id.binary(),
                                 i, oid.binary(), inline)
                    if (i + 1) % window == 0:
                        # Backpressure probe: block until the consumer is
                        # within one window of the producer.
                        while True:
                            consumed = owner.call(
                                "generator_progress", spec.task_id.binary(),
                                timeout=60.0)
                            if i + 1 - consumed <= window:
                                break
                            time.sleep(0.02)
                except (RpcConnectionError, TimeoutError):
                    owner = None  # owner gone: keep producing, reply carries ids
                    if inline is not None:
                        # The report never landed — seal so the id resolves.
                        self.core.seal_payload(oid, inline)

    def _seal_return(self, oid: ObjectID, value,
                     lineage=None,
                     force_seal: bool = False,
                     sealed_siblings: bool = False) -> Optional[bytes]:
        """Seal a return object so any process can fetch it; returns the
        payload bytes ONLY when small enough to ride inline in the reply.

        Small returns ride inline into the owner's cache and are served by
        the owner service from there (the reference's
        ``max_direct_call_object_size`` path, ray_config_def.h:206 + the
        owner's in-process memory store) — no daemon seal unless
        ``force_seal`` (generator items, whose values don't ride a reply).
        Big returns are written directly into the shm arena (no contiguous
        intermediate copy).
        """
        core = self.core
        ser = serialization.serialize(value)
        size = ser.framed_size()
        if (not force_seal
                and size <= config().max_inline_object_size):
            # Inline return: rides the reply into the OWNER's cache — no
            # daemon seal, no GCS location row; worth ~2 control-plane RPCs
            # per task on the hot path.
            # Multi-return tasks: lineage ships with return 0 only, so if
            # return 0 went inline its large SIBLING returns would lose
            # their reconstruction record — register lineage alone. (Single
            # inline returns skip this: their only replica lives with the
            # owner, and owner death is unrecoverable loss in the reference
            # too, so the hot path stays at zero control-plane RPCs.)
            if lineage is not None and sealed_siblings:
                if callable(lineage):
                    lineage = lineage()
                try:
                    core._gcs_rpc.notify("add_lineage", oid.binary(), lineage)
                except RpcConnectionError:
                    pass
            return ser.to_bytes()
        if callable(lineage):
            lineage = lineage()
        core.seal_serialized(oid, ser, lineage)
        return None

    def _package_error(self, spec: TaskSpec, error,
                       first_index: int = 0) -> dict:
        error_bytes = serialization.dumps(error)
        # Seal the error under every return id so dependent tasks (arg refs)
        # fail with the propagated error, matching in-process semantics. A
        # generator's error takes the index after the items it streamed
        # (``first_index``), where the owner seals it too: sealed at index
        # 0 it would shadow item 0, whose value rides the owner's report.
        n = spec.options.num_returns
        num = n if isinstance(n, int) else 1
        for i in range(first_index, first_index + max(num, 1)):
            oid = ObjectID.for_task_return(spec.task_id, i)
            try:
                self.core._local_daemon.notify("put_object", oid.binary(),
                                               error_bytes, None)
            except RpcConnectionError:
                pass
        cause_type = ""
        if isinstance(error, TaskError) and error.cause is not None:
            cause_type = type(error.cause).__name__
        return {"ok": False, "error": error_bytes, "error_type": cause_type}

    # ====================== actors ======================

    def start_actor(self, spec_bytes: bytes) -> bool:
        spec: TaskSpec = serialization.loads(spec_bytes)
        cls = self.core.gcs.get_function(spec.function_id)
        if cls is None:
            raise RuntimeError(f"actor class {spec.function_id} not in GCS")
        args, kwargs = self._resolve_args(spec)
        self.core.current_actor_id = spec.actor_id
        instance = cls(*args, **kwargs)
        state = _ActorState(spec.actor_id, instance,
                            spec.options.max_concurrency)
        with self._actors_lock:
            self._actors[spec.actor_id] = state
        flightrec.record("actor", spec.actor_id.hex()[:16],
                         f"start {spec.function_name[:40]}")
        logger.info("actor %s (%s) started in pid %d",
                    spec.actor_id.hex()[:8], spec.function_name, os.getpid())
        return True

    def run_actor_task(self, spec_bytes) -> dict:
        spec: TaskSpec = self._spec_store.decode(spec_bytes)
        with self._actors_lock:
            state = self._actors.get(spec.actor_id)
        if state is None:
            return self._package_error(
                spec, ActorError(spec.actor_id.hex(),
                                 "actor not hosted by this worker"))
        # Task-arg prefetch: kick off concurrent resolution of the call's
        # ref args NOW, so the dependency fetch overlaps however long this
        # call queues behind its predecessors in _admit_in_order (instead
        # of starting serially inside _resolve_args after admission).
        refs = self._arg_refs(spec)
        if refs:
            self.core.prefetch_refs(refs)
        # Serial actors (max_concurrency=1) promise per-caller EXECUTION
        # order, not just admission order: the admission cursor advances
        # only after this call completes (the ``finally`` below). Bumping
        # before execution — the concurrent-actor behavior — lets an
        # admitted-but-descheduled handler be overtaken at the actor lock
        # by its successor; harmless when calls may interleave anyway,
        # state corruption for a serial actor. Rarely observed while every
        # request paid its own send syscall; the coalesced burst arrivals
        # of the RPC fast path made it routine.
        strict = state.serial
        self._admit_in_order(state, spec, bump=not strict)
        try:
            return self._run_actor_task_admitted(state, spec)
        finally:
            if strict:
                with state.cv:
                    if state.executing.get(spec.caller_id) == \
                            spec.sequence_number:
                        del state.executing[spec.caller_id]
                    cur = state.next_seq.get(spec.caller_id,
                                             spec.sequence_number)
                    state.next_seq[spec.caller_id] = max(
                        cur, spec.sequence_number + 1)
                    state.cv.notify_all()

    def _run_actor_task_admitted(self, state: _ActorState,
                                 spec: TaskSpec) -> dict:
        from ray_tpu_torch.core.core_worker import arg_borrow_scope

        trace = self._begin_trace(spec)
        # Phase stamps: "queued" spans submit → admission (wire + per-caller
        # sequence ordering); the admitted timestamp anchors args/execute.
        t_admit = time.time()
        phases = ({"queued": max(0.0, t_admit - spec.submit_ts)}
                  if spec.submit_ts else {})
        borrowed: set = set()
        try:
            if spec.actor_method == DAG_LOOP_METHOD:
                import functools

                from ray_tpu_torch.dag.compiled_dag import actor_dag_loop

                # The loop detaches the channel endpoints it attached (fds,
                # mmaps, sockets) when it exits.
                entry = (functools.partial(actor_dag_loop, state.instance),
                         False)
            else:
                entry = state.resolve_method(spec.actor_method)
            if entry is None:
                raise AttributeError(
                    f"actor {spec.function_name} has no method "
                    f"'{spec.actor_method}'")
            method, is_coro = entry
            with arg_borrow_scope() as borrowed:
                args, kwargs = self._resolve_args(spec)
            t_args = time.time()
            phases["args_fetch"] = t_args - t_admit
            if is_coro:
                from ray_tpu_torch.util import tracing

                ctx = tracing.current_context()

                async def _traced(method=method, args=args, kwargs=kwargs,
                                  ctx=ctx):
                    # run_coroutine_threadsafe does not carry the caller's
                    # contextvars across threads — re-establish the span
                    # context inside the coroutine (its asyncio task owns a
                    # private context copy, so concurrent methods can't
                    # cross-contaminate).
                    tracing.set_context(ctx)
                    return await method(*args, **kwargs)

                loop = state.ensure_loop()
                fut = asyncio.run_coroutine_threadsafe(_traced(), loop)
                result = fut.result()
            elif state.serial:
                with state.lock:
                    result = method(*args, **kwargs)
            else:
                with state.slots:
                    result = method(*args, **kwargs)
            phases["execute"] = time.time() - t_args
            args = kwargs = None  # drop frame pins before the borrow audit
            out = self._package_results(spec, result)
            result = None
        except _DependencyFailed as df:
            out = self._package_error(spec, df.error)
        except _StreamFailed as sf:
            out = self._package_error(
                spec, TaskError.from_exception(
                    f"{spec.function_name}.{spec.actor_method}", sf.cause),
                first_index=len(sf.items))
            out["generator_items"] = sf.items
        except BaseException as exc:  # noqa: BLE001
            out = self._package_error(
                spec,
                TaskError.from_exception(
                    f"{spec.function_name}.{spec.actor_method}", exc))
        self._end_trace(spec, trace, ok=bool(out.get("ok")), phases=phases)
        # Borrow handover before the reply (see run_task): an arg ref the
        # method stored in ACTOR STATE must be registered with its owner
        # before the caller's call-duration pin is released.
        self._handover_borrows(borrowed)
        return out

    def skip_actor_seq(self, actor_id_bytes: bytes, caller_id: str,
                       seq: int) -> None:
        """The client dropped this sequence number before sending it
        (serialization failure): admission must step over it, or every
        later call from the handle starves behind the gap."""
        with self._actors_lock:
            state = self._actors.get(ActorID(actor_id_bytes))
        if state is None:
            return
        with state.cv:
            state.skipped.setdefault(caller_id, set()).add(seq)
            cur = state.next_seq.get(caller_id)
            if cur is not None and cur == seq:
                state.next_seq[caller_id] = seq + 1
                state.skipped[caller_id].discard(seq)
            state.cv.notify_all()

    def _admit_in_order(self, state: _ActorState, spec: TaskSpec,
                        timeout: float = 300.0, bump: bool = True) -> None:
        """Per-caller sequence ordering (sequential_actor_submit_queue.cc):
        requests may arrive on pool threads out of order; admit strictly by
        the handle's sequence number.

        The first sequence seen from a caller sets the baseline: a restarted
        actor (fresh incarnation) may first hear from a handle mid-stream —
        the caller's client-side dispatch is serialized per handle, so
        whatever arrives first IS that handle's oldest outstanding call.
        """
        deadline = time.time() + timeout
        window_min = spec.window_min
        if window_min < 0:  # spec built outside the pipelined transport
            window_min = spec.sequence_number
        with state.cv:
            if spec.caller_id not in state.next_seq:
                # Baseline = the handle's lowest OUTSTANDING seq at the
                # sender's window (window_min), NOT this request's own
                # seq: with a pipelined client, pool threads can reach this
                # point out of order, and baselining on the first ARRIVAL
                # would let seq 1 run before seq 0.
                state.next_seq[spec.caller_id] = min(window_min,
                                                     spec.sequence_number)
                state.cv.notify_all()
            elif window_min > state.next_seq[spec.caller_id]:
                # The client promises nothing below window_min is still
                # outstanding (earlier seqs were acked or dropped client-
                # side before sending): fast-forward past the gap instead
                # of starving every later call behind it.
                state.next_seq[spec.caller_id] = window_min
                state.cv.notify_all()
            while state.next_seq[spec.caller_id] < spec.sequence_number:
                skipped = state.skipped.get(spec.caller_id)
                if skipped and state.next_seq[spec.caller_id] in skipped:
                    skipped.discard(state.next_seq[spec.caller_id])
                    state.next_seq[spec.caller_id] += 1
                    continue
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(
                        f"actor task seq {spec.sequence_number} from "
                        f"{spec.caller_id[:8]} starved (expected "
                        f"{state.next_seq.get(spec.caller_id, 0)})")
                before = state.next_seq[spec.caller_id]
                state.cv.wait(timeout=min(remaining, 1.0))
                if (state.next_seq[spec.caller_id] > before
                        or spec.caller_id in state.executing):
                    # Progress: starvation means NO cursor movement AND no
                    # predecessor executing, for `timeout` straight. Strict
                    # serial execution holds the cursor for a call's whole
                    # runtime — a legitimately long-running method (or a
                    # deep-but-draining pipeline) must not read as a lost
                    # sequence number.
                    deadline = time.time() + timeout
            if bump:
                # max(): a duplicate/straggler below next_seq must never
                # rewind the admission cursor (that wedges every later
                # call). ``bump=False`` (strict serial execution): the
                # caller advances the cursor itself AFTER the call runs.
                state.next_seq[spec.caller_id] = max(
                    state.next_seq[spec.caller_id], spec.sequence_number + 1)
                state.cv.notify_all()
            else:
                state.executing[spec.caller_id] = spec.sequence_number

    # ====================== lifecycle ======================

    def ping(self) -> str:
        return "pong"

    def kill_self(self) -> None:
        threading.Thread(target=lambda: (time.sleep(0.05), os._exit(0)),
                         daemon=True).start()


def _die_with_parent() -> None:
    """SIGKILL this worker when the daemon dies (prctl PDEATHSIG) — the
    reference relies on workers being raylet children + a subreaper
    (``raylet/main.cc:33``); this closes the kill -9-the-daemon window
    before the socket watchdog notices."""
    try:
        import ctypes
        import signal as _signal

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, _signal.SIGKILL)
    except Exception:  # noqa: BLE001 — non-Linux: watchdog still covers it
        log_swallowed(logger, "prctl PDEATHSIG setup")


def _install_stack_dumper() -> None:
    """SIGUSR1 → dump all thread stacks to stderr (lands in the worker's
    session log). Debug aid for live hangs/spins on running clusters."""
    import faulthandler
    import signal

    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)
    except (AttributeError, ValueError):  # non-main thread / platform
        pass


def main() -> int:
    from ray_tpu_torch.devtools.lockcheck import maybe_install

    maybe_install()  # lock_order_check_enabled: instrument before any locks
    from ray_tpu_torch.devtools.leakcheck import maybe_install as _leak_install

    _leak_install()  # leak_check_enabled: stamp allocation sites early
    _die_with_parent()
    _install_stack_dumper()
    if os.environ.get("RAY_TPU_PROFILE_WORKER"):
        # Debug aid: accumulate a cProfile of every actor-task handler
        # invocation (they run on RPC pool threads, so a main-thread
        # profiler would see nothing) and dump pstats at exit.
        import atexit
        import cProfile

        prof = cProfile.Profile()
        orig = WorkerService.run_actor_task

        calls = [0]

        def profiled(self, spec_bytes, *a, **kw):
            prof.enable()
            try:
                return orig(self, spec_bytes, *a, **kw)
            finally:
                prof.disable()
                calls[0] += 1
                if calls[0] % 200 == 0:  # workers often die by SIGKILL;
                    # periodic dumps beat atexit
                    prof.dump_stats(
                        f"{os.environ['RAY_TPU_PROFILE_WORKER']}"
                        f".{os.getpid()}")

        WorkerService.run_actor_task = profiled
        atexit.register(
            lambda: prof.dump_stats(
                f"{os.environ['RAY_TPU_PROFILE_WORKER']}.{os.getpid()}"))
    worker_id = WorkerID.from_hex(os.environ["RAY_TPU_WORKER_ID"])
    daemon_address = os.environ["RAY_TPU_DAEMON_ADDRESS"]
    gcs_address = os.environ["RAY_TPU_GCS_ADDRESS"]
    node_id = NodeID.from_hex(os.environ["RAY_TPU_NODE_ID"])
    store_name = os.environ.get("RAY_TPU_STORE_NAME", "")

    # Resolve the knobs once, as the JAX worker's first config() call does
    # (the port's config() re-resolves per call while no table is set).
    set_config(Config())
    flightrec.init("worker")
    core = CoreWorker(
        gcs_address,
        node_id=node_id,
        node_address=daemon_address,
        store_name=store_name,
        job_id=JobID.from_int(0),
        mode="worker",
    )
    from ray_tpu_torch.core import runtime as runtime_mod

    runtime_mod._global_runtime = core

    daemon = RpcClient(daemon_address)
    service = WorkerService(core, worker_id=worker_id, daemon_client=daemon)
    server = RpcServer(service, name=f"worker-{worker_id.hex()[:8]}")
    daemon.call("register_worker", worker_id, server.address)

    # Crash-flush: orderly deaths (SIGTERM from the daemon, atexit) lose
    # zero buffered task events / spans — SIGKILL is what the mmap'd
    # flight-recorder ring is for.
    import atexit
    import signal as _signal

    def _flush_tails():
        from ray_tpu_torch.util import tracing

        try:
            service._events.flush()
        except Exception:  # noqa: BLE001 — flush-on-death is best-effort
            pass
        try:
            tracing.flush()
        except Exception:  # noqa: BLE001
            pass
        flightrec.close()

    atexit.register(_flush_tails)

    def _fatal(sig, frame):
        _flush_tails()
        os._exit(0)

    try:
        _signal.signal(_signal.SIGTERM, _fatal)
        _signal.signal(_signal.SIGINT, _fatal)
    except ValueError:  # non-main thread (embedded use)
        pass

    # Watchdog: the daemon is this process's reason to live. If it goes away
    # (kill -9, node death), exit so no orphan workers accumulate — the
    # reference gets this from the raylet owning worker processes as children
    # plus a subreaper (raylet/main.cc:33).
    while True:
        time.sleep(1.0)
        try:
            daemon.call("ping", timeout=5.0)
        except (RpcConnectionError, TimeoutError):
            logger.info("daemon unreachable; worker exiting")
            return 0


if __name__ == "__main__":
    sys.exit(main())
