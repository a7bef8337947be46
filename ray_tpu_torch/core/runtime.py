"""The runtime — task execution, actor management, object resolution.

This is the in-process core-worker + raylet + GCS composition: the analog of
the reference's ``CoreWorker`` (``src/ray/core_worker/core_worker.cc`` —
``SubmitTask`` :2067, ``CreateActor`` :2139, ``SubmitActorTask`` :2377,
``Put`` :1198, ``Get`` :1460, ``Wait`` :1655), the raylet's
``ClusterTaskManager``/``LocalTaskManager`` queueing and dispatch
(``src/ray/raylet/scheduling/cluster_task_manager.cc``,
``local_task_manager.cc``), and ``TaskManager`` retry/lineage bookkeeping
(``src/ray/core_worker/task_manager.cc``).

Execution model: a single OS process hosts N *virtual nodes* (the testing
topology the reference gets from ``python/ray/cluster_utils.py:135 Cluster`` —
many raylets on one host with fake resources). Workers are threads drawn from
per-node elastic pools; resource accounting (not thread count) provides
admission control, and a worker blocked in ``get`` releases its CPU resources
back to its node exactly like the reference's blocked-worker protocol, so
nested tasks cannot deadlock the pool. A separate multiprocess runtime reuses
this scheduling core with process workers (see node_provider/cluster docs).

The port's copy of ``ray_tpu/core/runtime.py``, the in-process runtime. The
runtime itself does no device compute and its store holds host bytes only.

GPU note: where the JAX package registers TPU chips (``TPU``,
``TPU-<version>``), the port registers the cards (``GPU``, ``GPU-<model>``,
``ray_tpu_torch.accelerators.gpu_resources``) under the same rule: a card's
device state is held by *one* actor — cards are not time-shared, which the
resource model enforces by making whole-card integers the grants users ask
for (``num_gpus=1``). With no card, no ``GPU`` resource is registered, and
``num_gpus`` work is infeasible: it never runs on the CPU.
"""

from __future__ import annotations

import gc
import os
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core.config import Config, config, set_config
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    ActorError,
    PendingCallsLimitExceededError,
    RuntimeNotInitializedError,
    TaskCancelledError,
    TaskError,
)
from ray_tpu_torch.core.gcs import ActorInfo, GlobalControlStore, JobInfo, NodeInfo
from ray_tpu_torch.core.metrics_export import observe_task_phases
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import MemoryStore
from ray_tpu_torch.core.refcount import ReferenceCounter
from ray_tpu_torch.core.resources import NodeResources, ResourceSet
from ray_tpu_torch.core.scheduler import ClusterResourceScheduler
from ray_tpu_torch.core.task_spec import (
    DAG_LOOP_METHOD,
    PlacementGroupSchedulingStrategy,
    TaskArg,
    TaskSpec,
    TaskType,
)
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("runtime")

_global_runtime: Optional["Runtime"] = None
_init_lock = threading.Lock()

# A GC pass starts at whatever allocation crossed its threshold, possibly on
# a thread holding a runtime or store lock, and runs the finalizers of the
# garbage it found there: an ObjectRef released from such a pass must take
# no lock. GC callbacks mark the collecting thread; its releases go to the
# runtime's drainer thread.
_gc_pass = threading.local()


def _note_gc_pass(phase: str, info: dict) -> None:
    _gc_pass.active = phase == "start"


gc.callbacks.append(_note_gc_pass)


class _WorkerContext(threading.local):
    """Per-thread execution context (reference: RuntimeContext /
    WorkerContext in core_worker)."""

    def __init__(self):
        self.task_id: Optional[TaskID] = None
        self.actor_id: Optional[ActorID] = None
        self.node_id: Optional[NodeID] = None
        self.task_state: Optional["TaskState"] = None
        self.in_worker = False
        # Resources this worker thread currently holds on its node — used by
        # the blocked-worker release/reacquire protocol.
        self.held_resources: Optional[ResourceSet] = None
        self.held_node: Optional[NodeID] = None


class TaskState:
    __slots__ = (
        "spec",
        "status",
        "node_id",
        "cancelled",
        "deps_remaining",
        "deps_released",
        "lock",
        "resources",
        "bundle_held",
        "generator_items",
        "generator_done",
        "generator_cv",
    )

    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.status = "PENDING_DEPS"
        self.node_id: Optional[NodeID] = None
        self.cancelled = False
        self.deps_remaining = 0
        self.deps_released = True  # armed by _resolve_dependencies
        # RLock: terminal paths (_finish_cancelled → _release_dep_refs) nest
        # under cancel()'s hold of the same lock.
        self.lock = threading.RLock()
        self.resources: Optional[ResourceSet] = None
        self.bundle_held = None  # (strategy, ResourceSet) while running in a PG bundle
        self.generator_items: List[ObjectID] = []
        self.generator_done = False
        self.generator_cv = threading.Condition(self.lock)


class LocalNode:
    """A virtual node: resource accounting + an elastic thread worker pool.

    Analog of one raylet + its worker pool (``src/ray/raylet/worker_pool.cc``)
    in the reference's single-host test cluster.
    """

    def __init__(self, runtime: "Runtime", node_id: NodeID, resources: Dict[str, float], labels: Dict[str, str]):
        self.runtime = runtime
        self.node_id = node_id
        self.labels = labels
        self.pending: deque[TaskState] = deque()
        self.lock = threading.Lock()
        self.alive = True

    def queue_task(self, state: TaskState) -> None:
        with self.lock:
            self.pending.append(state)
        self.dispatch()

    def dispatch(self) -> None:
        """Drain the pending queue subject to resource availability.

        Reference: ``local_task_manager.cc`` DispatchScheduledTasksToWorkers.
        PG-scheduled work additionally passes per-bundle admission (the
        shadow-resource accounting of the reference's ``CPU_group_<pgid>``).
        """
        while True:
            with self.lock:
                if not self.pending or not self.alive:
                    return
                state = self.pending[0]
                request = self.runtime._resource_request(state.spec)
                if not self.runtime.scheduler.try_allocate(self.node_id, request):
                    return
                strategy = state.spec.options.scheduling_strategy
                from ray_tpu_torch.core.task_spec import PlacementGroupSchedulingStrategy as _PGS

                if isinstance(strategy, _PGS) and self.runtime._pg_manager is not None:
                    bundle_req = self.runtime._declared_resources(state.spec)
                    if not self.runtime._pg_manager.acquire_from_bundle(strategy, bundle_req):
                        # Bundle full: roll back the node grant, stay queued.
                        self.runtime.scheduler.release(self.node_id, request)
                        return
                    state.bundle_held = (strategy, bundle_req)
                self.pending.popleft()
                state.resources = request
                state.status = "RUNNING"
            t = threading.Thread(
                target=self.runtime._execute_task,
                args=(self, state),
                daemon=True,
                name=f"worker-{state.spec.function_name}",
            )
            t.start()


class ActorRunner:
    """Hosts one actor instance: ordered mailbox + execution thread(s).

    Analog of the server side of the reference's actor transport
    (``src/ray/core_worker/transport/actor_scheduling_queue.cc`` ordered
    execution, ``concurrency_group_manager.cc`` thread groups, asyncio actors
    via ``fiber.h``): calls from a single caller run in submission order for
    ``max_concurrency == 1``; threaded actors (``max_concurrency > 1``) and
    async actors relax ordering exactly like the reference.
    """

    def __init__(self, runtime: "Runtime", actor_id: ActorID, creation_spec: TaskSpec, node_id: Optional[NodeID]):
        self.runtime = runtime
        self.actor_id = actor_id
        self.creation_spec = creation_spec
        self.node_id = node_id
        self.instance = None
        self.mailbox: deque[TaskState] = deque()
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.dead = False
        self.started = False
        self.death_error: Optional[BaseException] = None
        self.num_pending = 0
        self.max_pending = creation_spec.options.max_pending_calls
        self.max_concurrency = max(1, creation_spec.options.max_concurrency)
        self.is_async = False
        self._loop = None
        self._threads: List[threading.Thread] = []
        self._running = 0
        self.held_resources: ResourceSet = ResourceSet({})
        self.bundle_held = None  # (strategy, ResourceSet) while alive in a PG

    def start(self, instance) -> None:
        import asyncio
        import inspect

        self.instance = instance
        self.is_async = any(
            inspect.iscoroutinefunction(getattr(type(instance), name, None))
            for name in dir(type(instance))
            if not name.startswith("__")
        )
        with self.lock:
            self.started = True
        if self.is_async:
            self._loop = asyncio.new_event_loop()
            t = threading.Thread(target=self._async_main, daemon=True, name=f"actor-{self.actor_id.hex()[:8]}")
            t.start()
            self._threads.append(t)
            # Drain calls that queued while creation was in flight.
            try:
                asyncio.run_coroutine_threadsafe(self._pump_async(),
                                                 self._loop)
            except RuntimeError:
                pass  # kill() raced creation and already closed the loop
        else:
            for i in range(self.max_concurrency):
                t = threading.Thread(target=self._sync_main, daemon=True, name=f"actor-{self.actor_id.hex()[:8]}-{i}")
                t.start()
                self._threads.append(t)

    def submit(self, state: TaskState) -> None:
        """Append an (already sequence-ordered) task to the mailbox.

        Ordering is enforced upstream by the Runtime's sequence tracker, which
        survives actor restarts; the runner is a plain FIFO executor.
        """
        with self.lock:
            if self.dead:
                raise ActorDiedError(self.actor_id, str(self.death_error or "actor is dead"))
            if self.max_pending > 0 and self.num_pending >= self.max_pending:
                raise PendingCallsLimitExceededError(
                    f"actor {self.actor_id} has {self.num_pending} pending calls"
                )
            self.num_pending += 1
            self.mailbox.append(state)
            self.cv.notify_all()
        if self.is_async and self._loop is not None:
            import asyncio

            try:
                asyncio.run_coroutine_threadsafe(self._pump_async(),
                                                 self._loop)
            except RuntimeError:
                # kill() closed the loop between our dead-check and here:
                # surface the actor death, not the internal loop state.
                with self.lock:
                    self.num_pending -= 1
                    try:
                        self.mailbox.remove(state)
                    except ValueError:
                        # kill() already drained this state and propagated
                        # its error — raising here would store the error a
                        # second time.
                        return
                raise ActorDiedError(
                    self.actor_id, str(self.death_error or "actor is dead"))

    def _sync_main(self) -> None:
        while True:
            with self.lock:
                while not self.mailbox and not self.dead:
                    # Timed slice: a runner parked on a dead mailbox wakes
                    # to re-check instead of sleeping forever on a condition
                    # nobody will signal again.
                    self.cv.wait(timeout=config().internal_wait_timeout_s)
                if self.dead:
                    return
                state = self.mailbox.popleft()
            try:
                self.runtime._execute_actor_task(self, state)
            finally:
                with self.lock:
                    self.num_pending -= 1

    def _async_main(self) -> None:
        import asyncio

        # The loop thread belongs to exactly this actor: bind the context so
        # runtime_context/collectives resolve the actor from coroutines.
        self.runtime._ctx.actor_id = self.actor_id
        self.runtime._ctx.node_id = self.node_id
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()
        # kill() stopped the loop: release its self-pipe/epoll fds here on
        # the owning thread (in-flight coroutines are abandoned — that is
        # the kill semantic).
        try:
            self._loop.close()
        except Exception:  # noqa: BLE001 — a resumed callback mid-close
            log_swallowed(logger, "async actor loop close")

    async def _pump_async(self) -> None:
        import asyncio

        with self.lock:
            if not self.mailbox:
                return
            if self._running >= self.max_concurrency:
                return
            state = self.mailbox.popleft()
            self._running += 1

        async def run():
            try:
                await self.runtime._execute_actor_task_async(self, state)
            finally:
                with self.lock:
                    self.num_pending -= 1
                    self._running -= 1
                asyncio.run_coroutine_threadsafe(self._pump_async(), self._loop)

        asyncio.ensure_future(run())

    def kill(self, error: BaseException) -> List[TaskState]:
        """Mark dead; return drained mailbox + reorder buffer for error
        propagation."""
        with self.lock:
            self.dead = True
            self.death_error = error
            drained = list(self.mailbox)
            self.mailbox.clear()
            self.cv.notify_all()
        if self.is_async and self._loop is not None:
            # Stop (not just wake) the loop: a dead actor's loop thread
            # parked in run_forever leaks with its self-pipe fds.
            try:
                self._loop.call_soon_threadsafe(self._loop.stop)
            except RuntimeError:
                pass  # loop already closed
        return drained


class Runtime:
    """The per-process runtime singleton wiring store, scheduler, GCS."""

    def __init__(
        self,
        resources: Dict[str, float] | None = None,
        num_nodes: int = 1,
        system_config: Dict | None = None,
        namespace: str = "default",
        labels: Dict[str, str] | None = None,
    ):
        set_config(Config(system_config))
        from ray_tpu_torch.devtools import jitcheck

        jitcheck.maybe_install()
        flightrec.init("driver")
        self.namespace = namespace
        self.gcs = GlobalControlStore()
        self.store = MemoryStore()
        self.reference_counter = ReferenceCounter(on_release=self._maybe_free)
        self.scheduler = ClusterResourceScheduler()
        self.job_id = JobID.next()
        self.gcs.add_job(JobInfo(job_id=self.job_id, driver_pid=os.getpid()))
        self.nodes: Dict[NodeID, LocalNode] = {}
        self.tasks: Dict[TaskID, TaskState] = {}
        self.actors: Dict[ActorID, ActorRunner] = {}
        self._ctx = _WorkerContext()
        self._lock = threading.Lock()
        self._seq_lock = threading.Lock()
        self._seq_expected: Dict[tuple, int] = {}
        self._seq_buffer: Dict[tuple, Dict[int, TaskState]] = {}
        self._pg_manager = None  # set lazily by placement_group module
        # autoscaler integration: when enabled, infeasible work parks instead
        # of failing and is retried after cluster growth
        self.autoscaling_enabled = False
        self._infeasible: List[tuple] = []
        self._infeasible_lock = threading.Lock()
        # Concurrent task-arg materialization (see _fetch_args): bounded by
        # the same fan-out knob as the multiprocess batched get.
        from concurrent.futures import ThreadPoolExecutor

        self._arg_pool = ThreadPoolExecutor(
            max_workers=max(1, config().get_fanout),
            thread_name_prefix="arg-fetch")
        # Releases made inside a GC pass (``release_local_ref``), applied by
        # the drainer thread outside every lock.
        self._gc_releases: deque = deque()
        self._closing = threading.Event()
        self._gc_drainer = threading.Thread(
            target=self._drain_gc_releases, name="gc-release-drainer",
            daemon=True)
        self._gc_drainer.start()

        base = dict(resources or {})
        if "CPU" not in base:
            base["CPU"] = float(os.cpu_count() or 1)
        if "memory" not in base:
            base["memory"] = float(2**33)
        base.setdefault("object_store_memory", float(config().object_store_memory))
        self._autodetect_gpu(base)
        for i in range(num_nodes):
            self.add_node(dict(base), dict(labels or {}))
        self.head_node_id = next(iter(self.nodes))

        # Metrics plane: the in-process runtime reports straight into its
        # GCS store's aggregator — same pipeline, no RPC hop.
        from ray_tpu_torch.core.metrics_export import MetricsExporter

        self._metrics_exporter = MetricsExporter(
            report=self.gcs.report_metrics,
            node_id=self.head_node_id.hex(), component="driver",
            collectors=[self._collect_runtime_metrics]).start()

    def _collect_runtime_metrics(self) -> None:
        """Object-store occupancy gauges for the exporter tick."""
        from ray_tpu_torch.core.metrics_export import mirror_stats_gauge

        mirror_stats_gauge(
            "ray_tpu_object_store",
            "In-process object-store occupancy and spill counters",
            self.store.stats())

    # -- topology -------------------------------------------------------------

    def pending_resource_demands(self) -> List[Dict[str, float]]:
        """Resource shapes of parked infeasible work (autoscaler input —
        the analog of the demand the raylet reports to the autoscaler)."""
        with self._infeasible_lock:
            return [dict(req) for _, req in self._infeasible]

    def retry_infeasible(self) -> None:
        """Re-schedule parked work after cluster growth."""
        with self._infeasible_lock:
            parked, self._infeasible = self._infeasible, []
        for state, _ in parked:
            self._schedule(state)

    def _autodetect_gpu(self, resources: Dict[str, float]) -> None:
        """Detect the local cards and register them as named resources
        (``GPU`` and a ``GPU-<model>`` marker), unless the caller gave
        ``GPU`` — the counterpart of the JAX runtime's ``_autodetect_tpu``."""
        if "GPU" in resources:
            return
        from ray_tpu_torch.accelerators import gpu_resources

        resources.update(gpu_resources())

    def add_node(
        self, resources: Dict[str, float], labels: Dict[str, str] | None = None
    ) -> NodeID:
        node_id = NodeID.from_random()
        labels = dict(labels or {})
        node = LocalNode(self, node_id, resources, labels)
        self.nodes[node_id] = node
        self.scheduler.add_node(node_id, NodeResources(ResourceSet(resources), labels))
        self.gcs.register_node(
            NodeInfo(node_id=node_id, address=f"local://{node_id.hex()[:8]}", resources=resources, labels=labels)
        )
        return node_id

    def remove_node(self, node_id: NodeID) -> None:
        """Simulate node death: fail running/queued tasks, kill its actors.

        Reference: GCS node-death broadcast → raylets kill orphaned leases,
        owners retry tasks (``gcs_node_manager.cc``, ``task_manager.cc``).
        """
        node = self.nodes.pop(node_id, None)
        if node is None:
            return
        node.alive = False
        self.scheduler.remove_node(node_id)
        self.gcs.mark_node_dead(node_id)
        with node.lock:
            pending = list(node.pending)
            node.pending.clear()
        for state in pending:
            self._retry_or_fail(state, RuntimeError(f"node {node_id} died"))
        for actor_id, runner in list(self.actors.items()):
            if runner.node_id == node_id:
                self._handle_actor_failure(actor_id, RuntimeError(f"node {node_id} died"))

    # -- object API -----------------------------------------------------------

    def put(self, value) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() does not accept ObjectRefs (matches reference semantics)")
        object_id = ObjectID.for_put()
        self.store.put(object_id, value)
        return ObjectRef(object_id)

    def get(self, refs, timeout: float | None = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
        values = []
        release = self._ctx.in_worker and self._ctx.held_resources is not None
        if release:
            self._release_blocked_worker()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            for r in ref_list:
                remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                value = self.store.get(r.id, remaining)
                if isinstance(value, TaskError):
                    raise value.as_instanceof_cause()
                if isinstance(value, (TaskCancelledError, ActorError)):
                    raise value
                values.append(value)
        finally:
            if release:
                self._reacquire_blocked_worker()
        return values[0] if single else values

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        ids = [r.id for r in refs]
        if num_returns > len(ids):
            raise ValueError("num_returns exceeds number of refs")
        release = self._ctx.in_worker and self._ctx.held_resources is not None
        if release:
            self._release_blocked_worker()
        try:
            ready_ids, not_ready_ids = self.store.wait(ids, num_returns, timeout)
        finally:
            if release:
                self._reacquire_blocked_worker()
        by_id = {r.id: r for r in refs}
        return [by_id[i] for i in ready_ids], [by_id[i] for i in not_ready_ids]

    def future_for(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def on_ready(_):
            try:
                value = self.store.get(ref.id, timeout=0)
                if isinstance(value, TaskError):
                    fut.set_exception(value.as_instanceof_cause())
                elif isinstance(value, (TaskCancelledError, ActorError)):
                    fut.set_exception(value)
                else:
                    fut.set_result(value)
            except Exception as e:  # pragma: no cover
                fut.set_exception(e)

        self.store.on_ready(ref.id, on_ready)
        return fut

    def asyncio_future_for(self, ref: ObjectRef, loop):
        import asyncio

        afut = loop.create_future()

        def on_ready(_):
            def fill():
                if afut.cancelled():
                    return
                try:
                    value = self.store.get(ref.id, timeout=0)
                    if isinstance(value, TaskError):
                        afut.set_exception(value.as_instanceof_cause())
                    elif isinstance(value, (TaskCancelledError, ActorError)):
                        afut.set_exception(value)
                    else:
                        afut.set_result(value)
                except Exception as e:  # pragma: no cover
                    afut.set_exception(e)

            loop.call_soon_threadsafe(fill)

        self.store.on_ready(ref.id, on_ready)
        return afut

    def _maybe_free(self, object_id: ObjectID) -> None:
        # Out-of-scope objects are freed unless owned by a pending lineage.
        self.store.delete([object_id])

    # -- task submission (core_worker.cc:2067 SubmitTask) ---------------------

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        state = TaskState(spec)
        with self._lock:
            self.tasks[spec.task_id] = state
        if isinstance(spec.options.num_returns, int):
            refs = [ObjectRef(oid) for oid in spec.return_object_ids()]
        else:
            refs = []  # generator: refs come from the ObjectRefGenerator
        self.gcs.record_task_event(
            {"task_id": spec.task_id.hex(), "name": spec.function_name, "state": "SUBMITTED", "time": time.time()}
        )
        self._resolve_dependencies(state, lambda: self._schedule(state))
        return refs

    def _resolve_dependencies(self, state: TaskState, then: Callable[[], None]) -> None:
        """Count down plasma dependencies, then schedule.

        Reference: ``transport/dependency_resolver.cc`` — inline args pass
        through; ref args wait for local availability.
        """
        deps = state.spec.dependencies()
        with state.lock:
            state.deps_released = False  # new attempt holds fresh dep refs
        for oid in deps:
            self.reference_counter.add_submitted_task_reference(oid)
        if not deps:
            then()
            return
        remaining = {"n": len(deps)}
        lock = threading.Lock()

        def on_dep(_oid):
            with lock:
                remaining["n"] -= 1
                done = remaining["n"] == 0
            if done:
                then()

        for oid in deps:
            self.store.on_ready(oid, on_dep)

    def _schedule(self, state: TaskState) -> None:
        """Pick a node and queue for dispatch (cluster_task_manager.cc)."""
        spec = state.spec
        if state.cancelled:
            self._finish_cancelled(state)
            return
        request = self._resource_request(spec)
        strategy = spec.options.scheduling_strategy
        preferred = self._ctx.node_id or self.head_node_id
        if isinstance(strategy, PlacementGroupSchedulingStrategy) and self._pg_manager is not None:
            node_id = self._pg_manager.resolve_node(strategy)
            if node_id is None and strategy.placement_group is not None:
                # Group still PENDING: defer until placed (reference queues
                # PG-scheduled work until the 2PC commits).
                if self._pg_manager.when_ready(
                    strategy.placement_group.id, lambda: self._schedule(state)
                ):
                    return
        else:
            node_id = self.scheduler.best_node(request, strategy, preferred)
        if node_id is None or node_id not in self.nodes:
            if self.autoscaling_enabled:
                # Park until the autoscaler adds capacity (reference: tasks
                # pend in the raylet while the autoscaler reacts to demand).
                with self._infeasible_lock:
                    self._infeasible.append((state, request.to_dict()))
                return
            err = RuntimeError(
                f"no feasible node for task {spec.function_name} "
                f"(request={request.to_dict()}, cluster={self.gcs.cluster_resources()})"
            )
            self._store_error(state, TaskError.from_exception(spec.function_name, err))
            return
        state.node_id = node_id
        state.status = "QUEUED"
        self.nodes[node_id].queue_task(state)

    def _declared_resources(self, spec: TaskSpec) -> ResourceSet:
        res = dict(spec.options.resources)
        if spec.task_type == TaskType.NORMAL_TASK and "CPU" not in res:
            res["CPU"] = 1.0
        return ResourceSet(res)

    def _resource_request(self, spec: TaskSpec) -> ResourceSet:
        if isinstance(spec.options.scheduling_strategy, PlacementGroupSchedulingStrategy):
            # Bundle resources were reserved at PG creation; admission happens
            # against the bundle (dispatch), not the node.
            pg = spec.options.scheduling_strategy.placement_group
            if pg is not None:
                return ResourceSet({})
        return self._declared_resources(spec)

    def _release_bundle(self, state: TaskState) -> None:
        if state.bundle_held is not None and self._pg_manager is not None:
            strategy, request = state.bundle_held
            state.bundle_held = None
            self._pg_manager.release_to_bundle(strategy, request)

    # -- task execution -------------------------------------------------------

    def _release_dep_refs(self, state: TaskState) -> None:
        """Drop this attempt's submitted-task refs exactly once.

        Reference: TaskManager releases argument refs on task completion
        (task_manager.cc); every terminal path (success, error, cancel,
        pre-scheduling failure) funnels through here, guarded so the
        execute-path finally and _store_error can both call it safely.
        """
        with state.lock:
            if state.deps_released:
                return
            state.deps_released = True
        for oid in state.spec.dependencies():
            self.reference_counter.remove_submitted_task_reference(oid)

    def _fetch_args(self, spec: TaskSpec):
        """Materialize a task's arguments; with several ref args the store
        reads (deserialization included) run CONCURRENTLY on the arg-fetch
        pool instead of strictly one after another, preserving positional
        order and first-error semantics."""
        def resolve(arg: TaskArg):
            if arg.is_ref:
                value = self.store.get(arg.object_id)
                if isinstance(value, (TaskError, TaskCancelledError, ActorError)):
                    raise _DependencyFailed(value)
                return value
            return arg.value

        ref_args = [a for a in list(spec.args) + list(spec.kwargs.values())
                    if a.is_ref]
        resolved: Dict[int, Any] = {}
        if len(ref_args) > 1:
            # Only store-resident args go to the pool: a pool thread must
            # never block open-endedly on an object that may not exist (the
            # serial fallback below keeps the old blocking behavior for
            # those). 60s is a safety valve against a racing delete.
            ready = [a for a in ref_args
                     if self.store.contains(a.object_id)]
            if len(ready) > 1:
                futs = [(a, self._arg_pool.submit(
                    self.store.get, a.object_id, 60.0)) for a in ready]
                for a, fut in futs:
                    resolved[id(a)] = fut.result()

        def take(arg: TaskArg):
            # Error checks happen HERE, in positional order, so the
            # first-error semantics of the serial loop are preserved.
            if arg.is_ref and id(arg) in resolved:
                value = resolved[id(arg)]
                if isinstance(value,
                              (TaskError, TaskCancelledError, ActorError)):
                    raise _DependencyFailed(value)
                return value
            return resolve(arg)

        args = [take(a) for a in spec.args]
        kwargs = {k: take(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    def _execute_task(self, node: LocalNode, state: TaskState) -> None:
        if isinstance(state, _ActorCreationState):
            held = state.resources or ResourceSet({})
            state.resources = None  # the actor keeps them; skip release below
            runner = state.runner_ref
            # Bundle admission transfers to the actor for its lifetime.
            runner.bundle_held, state.bundle_held = state.bundle_held, None
            try:
                self._instantiate_actor(
                    state.actor_id_ref, state.spec, node.node_id, held, runner
                )
            finally:
                node.dispatch()
            return
        spec = state.spec
        # Take ownership of the dispatch-time allocation so a concurrent
        # retry/re-dispatch can never be double-released by this thread.
        held, state.resources = state.resources, None
        self._ctx.task_id = spec.task_id
        self._ctx.node_id = node.node_id
        self._ctx.task_state = state
        self._ctx.in_worker = True
        self._ctx.held_resources = held
        self._ctx.held_node = node.node_id
        started = time.time()
        trace_id, span_id, parent_span = self._adopt_trace(spec)
        flightrec.record("task", spec.task_id.hex()[:16],
                         f"start {spec.function_name[:40]} trace={trace_id}")
        # Lifecycle phase stamps (same split as the multiprocess worker's
        # execute loop): submit→dispatch, dep fetch, user-code runtime.
        phases = ({"queued": max(0.0, started - spec.submit_ts)}
                  if spec.submit_ts else {})
        failure: Optional[BaseException] = None
        try:
            if state.cancelled:
                raise TaskCancelledError(spec.task_id)
            fn = self.gcs.get_function(spec.function_id)
            if fn is None:
                raise RuntimeError(f"function {spec.function_id} not found in GCS")
            args, kwargs = self._fetch_args(spec)
            t_args = time.time()
            phases["args_fetch"] = t_args - started
            from ray_tpu_torch.runtime_env import applied as _renv

            with _renv(spec.options.runtime_env):
                result = fn(*args, **kwargs)
            phases["execute"] = time.time() - t_args
            if spec.submit_ts:
                phases["total"] = max(0.0, time.time() - spec.submit_ts)
            self._store_results(state, result)
            observe_task_phases(phases)
            self.gcs.record_task_event(
                {"task_id": spec.task_id.hex(), "name": spec.function_name, "state": "FINISHED",
                 "time": time.time(), "duration": time.time() - started, "node_id": node.node_id.hex(),
                 "trace_id": trace_id, "span_id": span_id,
                 "parent_span_id": parent_span,
                 "phases": {k: round(v, 6) for k, v in phases.items()}}
            )
        except _DependencyFailed as df:
            self._store_error(state, df.error)
            observe_task_phases(phases, ok=False)
        except TaskCancelledError:
            self._finish_cancelled(state)
        except BaseException as e:  # noqa: BLE001 — worker boundary
            failure = e
            observe_task_phases(phases, ok=False)
        finally:
            from ray_tpu_torch.util import tracing

            flightrec.record(
                "task", spec.task_id.hex()[:16],
                f"{'FAIL' if failure is not None else 'finish'} "
                f"trace={trace_id}")
            tracing.set_context(None)
            self._ctx.in_worker = False
            self._ctx.task_state = None
            self._ctx.task_id = None
            self._ctx.held_resources = None
            self._ctx.held_node = None
            if held is not None:
                self.scheduler.release(node.node_id, held)
            self._release_bundle(state)
            # Release this attempt's dep refs BEFORE any retry resubmission
            # re-arms them — ordering keeps the counts exact.
            self._release_dep_refs(state)
            if failure is not None:
                self._retry_or_fail(state, failure)
            if state.status in ("FINISHED", "FAILED", "CANCELLED") and not state.generator_items:
                with self._lock:
                    self.tasks.pop(spec.task_id, None)
            self._on_resources_freed(node)

    def _put_result(self, oid: ObjectID, value) -> None:
        """Store a task result; free it immediately if nobody can ever read
        it (all result ObjectRefs already dropped — fire-and-forget tasks
        must not accumulate garbage in the store)."""
        self.store.put(oid, value)
        if self.reference_counter.num_references(oid) == 0:
            self.store.delete([oid])

    def _store_results(self, state: TaskState, result) -> None:
        spec = state.spec
        num_returns = spec.options.num_returns
        if num_returns in ("dynamic", "streaming"):
            # Streaming generator protocol (core_worker.cc:3199).
            import inspect

            if not inspect.isgenerator(result):
                raise TypeError(
                    f"task {spec.function_name} declared num_returns="
                    f"'{num_returns}' but did not return a generator"
                )
            index = 0
            for item in result:
                oid = ObjectID.for_task_return(spec.task_id, index)
                self.store.put(oid, item)
                with state.generator_cv:
                    state.generator_items.append(oid)
                    state.generator_cv.notify_all()
                index += 1
            with state.generator_cv:
                state.generator_done = True
                state.generator_cv.notify_all()
            state.status = "FINISHED"
            return
        oids = spec.return_object_ids()
        if num_returns == 0:
            state.status = "FINISHED"
            return
        if num_returns == 1:
            self._put_result(oids[0], result)
        else:
            values = list(result)
            if len(values) != num_returns:
                raise ValueError(
                    f"task {spec.function_name} declared num_returns={num_returns} "
                    f"but returned {len(values)} values"
                )
            for oid, v in zip(oids, values):
                self._put_result(oid, v)
        state.status = "FINISHED"

    def _store_error(self, state: TaskState, error: TaskError | TaskCancelledError | ActorError) -> None:
        spec = state.spec
        state.status = "FAILED"
        self._release_dep_refs(state)
        num_returns = spec.options.num_returns
        if num_returns in ("dynamic", "streaming"):
            oid = ObjectID.for_task_return(spec.task_id, len(state.generator_items))
            self.store.put(oid, error)
            with state.generator_cv:
                state.generator_items.append(oid)
                state.generator_done = True
                state.generator_cv.notify_all()
            return
        for oid in spec.return_object_ids(max(1, num_returns if isinstance(num_returns, int) else 1)):
            self._put_result(oid, error)

    def _retry_or_fail(self, state: TaskState, exc: BaseException) -> None:
        """Task retry ladder (task_manager.cc — max_retries, retry_exceptions)."""
        spec = state.spec
        opts = spec.options
        is_app_error = isinstance(exc, Exception)
        retryable = (
            opts.retry_exceptions is True
            or (isinstance(opts.retry_exceptions, (list, tuple))
                and any(isinstance(exc, t) for t in opts.retry_exceptions))
            if is_app_error
            else True  # system errors (node death) always count against retries
        )
        if retryable and spec.attempt_number < opts.max_retries:
            spec.attempt_number += 1
            logger.info(
                "retrying task %s (attempt %d/%d) after: %s",
                spec.function_name, spec.attempt_number, opts.max_retries, exc,
            )
            state.status = "PENDING_DEPS"
            self._resolve_dependencies(state, lambda: self._schedule(state))
            return
        self._store_error(state, TaskError.from_exception(spec.function_name, exc))

    def _finish_cancelled(self, state: TaskState) -> None:
        state.status = "CANCELLED"
        self._release_dep_refs(state)
        err = TaskCancelledError(state.spec.task_id)
        num_returns = state.spec.options.num_returns
        for oid in state.spec.return_object_ids(max(1, num_returns if isinstance(num_returns, int) else 1)):
            self._put_result(oid, err)

    # -- blocked-worker resource release (deadlock avoidance) -----------------

    def _release_blocked_worker(self) -> None:
        held, node_id = self._ctx.held_resources, self._ctx.held_node
        if held is not None and node_id is not None:
            self.scheduler.release(node_id, held)
            node = self.nodes.get(node_id)
            self._on_resources_freed(node)

    def _reacquire_blocked_worker(self) -> None:
        # Force-reacquire: availability may go temporarily negative (node
        # oversubscribed) until the borrower finishes — the reference's
        # blocked-worker semantics. Exactly balanced with the release above,
        # so accounting stays consistent.
        held, node_id = self._ctx.held_resources, self._ctx.held_node
        if held is not None and node_id is not None:
            nr = self.scheduler.node_resources(node_id)
            if nr is not None:
                nr.allocate(held, force=True)

    def _on_resources_freed(self, node: Optional[LocalNode] = None) -> None:
        """Resources came back: retry pending placement groups and dispatch.

        The analog of the reference's ScheduleAndDispatchTasks +
        SchedulePendingPlacementGroups hooks that run on every resource
        change.
        """
        if self._pg_manager is not None:
            self._pg_manager.retry_pending()
        if node is not None:
            node.dispatch()
        else:
            for n in list(self.nodes.values()):
                n.dispatch()

    def preempt_gangs(self, resources: Dict[str, float], count: int = 1,
                      min_priority: int = 0) -> int:
        """Revoke placement groups of strictly lower gang_priority until
        ``count`` units of ``resources`` could be placed (the serve
        SLO-pressure hook; GCS-backed runtimes route this to the
        ``preempt_gangs`` RPC instead)."""
        if self._pg_manager is None:
            return 0
        return self._pg_manager.preempt_lower(resources, count, min_priority)

    # -- generators -----------------------------------------------------------

    def next_generator_item(self, task_id: TaskID, index: int) -> Optional[ObjectRef]:
        state = self.tasks.get(task_id)
        if state is None:
            return None
        with state.generator_cv:
            while len(state.generator_items) <= index and not state.generator_done:
                state.generator_cv.wait(
                    timeout=config().internal_wait_timeout_s)
            if index < len(state.generator_items):
                return ObjectRef(state.generator_items[index])
            return None

    async def next_generator_item_async(self, task_id: TaskID, index: int):
        import asyncio

        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(None, self.next_generator_item, task_id, index)

    def release_generator(self, task_id: TaskID) -> None:
        """In-process runtime keeps generator items in the task record, which
        the task table already reclaims; nothing extra to free here (the
        CoreWorker counterpart collects owner-cache stream state)."""

    def release_local_ref(self, oid: ObjectID) -> None:
        """``ObjectRef.__del__`` entry point. In-process the release is
        synchronous (the store's free path holds no lock across other
        acquisitions), except inside a GC pass, which may have started under
        any lock: that release waits for the drainer thread. The CoreWorker
        counterpart always defers to a drainer."""
        if getattr(_gc_pass, "active", False):
            self._gc_releases.append(oid)
            return
        self.reference_counter.remove_local_reference(oid)

    def _drain_gc_releases(self) -> None:
        while not self._closing.wait(0.05):
            self._flush_gc_releases()
        self._flush_gc_releases()

    def _flush_gc_releases(self) -> None:
        while self._gc_releases:
            try:
                oid = self._gc_releases.popleft()
            except IndexError:
                return
            self.reference_counter.remove_local_reference(oid)

    # -- actors (core_worker.cc:2139 CreateActor, :2377 SubmitActorTask) ------

    def create_actor(self, spec: TaskSpec) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        spec.actor_id = actor_id
        info = ActorInfo(
            actor_id=actor_id,
            name=spec.options.name or "",
            namespace=spec.options.namespace or self.namespace,
            class_name=spec.function_name,
            max_restarts=spec.options.max_restarts,
            detached=spec.options.lifetime == "detached",
        )
        self.gcs.register_actor(info)
        self._schedule_actor_creation(actor_id, spec)
        return actor_id

    def _schedule_actor_creation(self, actor_id: ActorID, spec: TaskSpec) -> None:
        # Register the runner up front: method calls submitted while creation
        # is still in flight (pending deps, queued on resources, restarting)
        # buffer in its mailbox instead of erroring — the reference queues
        # calls until the actor address is published.
        runner = ActorRunner(self, actor_id, spec, None)
        self.actors[actor_id] = runner
        state = TaskState(spec)

        def do_create():
            strategy = spec.options.scheduling_strategy
            if isinstance(strategy, PlacementGroupSchedulingStrategy) and self._pg_manager is not None:
                # Bundle resources were reserved at PG creation — the actor
                # rides the reservation (same rule as PG tasks).
                request = ResourceSet({})
                node_id = self._pg_manager.resolve_node(strategy)
                if node_id is None and strategy.placement_group is not None:
                    if self._pg_manager.when_ready(strategy.placement_group.id, do_create):
                        return
                if node_id is not None and node_id in self.nodes:
                    # Bundle admission + instantiation ride the node queue so
                    # per-bundle accounting applies uniformly.
                    self.nodes[node_id].queue_task(
                        _ActorCreationState(self, actor_id, spec, node_id, runner)
                    )
                    return
            else:
                request = ResourceSet(spec.options.resources)
                # Actors with no explicit resources are placed by CPU
                # feasibility but hold nothing while alive (reference actor
                # default: 1 CPU to schedule, 0 to run).
                probe = request if not request.is_empty() else ResourceSet({"CPU": 1.0})
                node_id = self.scheduler.best_node(probe, strategy, self._ctx.node_id or self.head_node_id)
            if node_id is None or node_id not in self.nodes:
                err = ActorDiedError(actor_id, f"no feasible node for actor {spec.function_name}")
                self.gcs.update_actor_state(actor_id, "DEAD", death_cause=str(err))
                for drained in runner.kill(err):
                    self._store_error(drained, err)
                return
            if not request.is_empty():
                if not self.scheduler.try_allocate(node_id, request):
                    # Wait for resources: re-queue through the node.
                    self.nodes[node_id].queue_task(
                        _ActorCreationState(self, actor_id, spec, node_id, runner)
                    )
                    return
            self._instantiate_actor(actor_id, spec, node_id, request, runner)

        self._resolve_dependencies(state, do_create)

    def _instantiate_actor(
        self, actor_id: ActorID, spec: TaskSpec, node_id: NodeID, held: ResourceSet,
        runner: ActorRunner,
    ) -> None:
        if runner.dead:
            # Killed while its creation waited in a node queue for resources
            # (the JAX runtime builds it anyway and keeps the grant): give
            # the grant back and build nothing.
            if not held.is_empty():
                self.scheduler.release(node_id, held)
            if runner.bundle_held is not None and self._pg_manager is not None:
                strategy, request = runner.bundle_held
                runner.bundle_held = None
                self._pg_manager.release_to_bundle(strategy, request)
            for oid in spec.dependencies():
                self.reference_counter.remove_submitted_task_reference(oid)
            return
        runner.node_id = node_id
        try:
            cls = self.gcs.get_function(spec.function_id)
            args, kwargs = self._fetch_args(spec)
            prev_actor, prev_node = self._ctx.actor_id, self._ctx.node_id
            self._ctx.actor_id = actor_id
            self._ctx.node_id = node_id
            try:
                instance = cls(*args, **kwargs)
            finally:
                self._ctx.actor_id, self._ctx.node_id = prev_actor, prev_node
            runner.start(instance)
            runner.held_resources = held
            self.gcs.update_actor_state(actor_id, "ALIVE", node_id=node_id)
        except BaseException as e:  # noqa: BLE001
            if not held.is_empty():
                self.scheduler.release(node_id, held)
            if runner.bundle_held is not None and self._pg_manager is not None:
                strategy, request = runner.bundle_held
                runner.bundle_held = None
                self._pg_manager.release_to_bundle(strategy, request)
            err = e if isinstance(e, ActorError) else ActorDiedError(
                actor_id, f"creation failed: {''.join(traceback.format_exception_only(type(e), e)).strip()}"
            )
            err.__cause__ = e if not isinstance(e, ActorError) else None
            for drained in runner.kill(err):
                self._store_error(drained, err)
            self.gcs.update_actor_state(actor_id, "DEAD", death_cause=str(err))
        finally:
            for oid in spec.dependencies():
                self.reference_counter.remove_submitted_task_reference(oid)

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectRef]:
        state = TaskState(spec)
        with self._lock:
            self.tasks[spec.task_id] = state
        refs = [ObjectRef(oid) for oid in spec.return_object_ids()] if isinstance(spec.options.num_returns, int) else []

        self._resolve_dependencies(state, lambda: self._deliver_actor_task(state))
        return refs

    def _deliver_actor_task(self, state: TaskState) -> None:
        """Order-preserving delivery: admit through the sequence tracker
        (per (actor, caller), survives restarts), then hand admitted tasks to
        the live runner."""
        for admitted in self._sequence_admit(state):
            spec = admitted.spec
            runner = self.actors.get(spec.actor_id)
            if runner is None or runner.dead:
                err = runner.death_error if runner is not None else ActorDiedError(spec.actor_id)
                if not isinstance(err, (ActorError, TaskError, TaskCancelledError)):
                    err = ActorDiedError(spec.actor_id, str(err))
                self._store_error(admitted, err)
                continue
            try:
                runner.submit(admitted)
            except (ActorDiedError, PendingCallsLimitExceededError) as e:
                self._store_error(
                    admitted,
                    e if isinstance(e, ActorDiedError) else TaskError.from_exception(spec.function_name, e),
                )

    def _sequence_admit(self, state: TaskState) -> List[TaskState]:
        """Per-caller in-order admission (sequential_actor_submit_queue.cc).

        Returns the list of tasks that are now deliverable, in order. A task
        arriving ahead of its turn (its deps resolved before an earlier
        call's) buffers until the gap fills.
        """
        spec = state.spec
        if not spec.caller_id:
            return [state]
        key = (spec.actor_id, spec.caller_id)
        with self._seq_lock:
            expected = self._seq_expected.get(key, 0)
            if spec.sequence_number != expected:
                self._seq_buffer.setdefault(key, {})[spec.sequence_number] = state
                return []
            admitted = [state]
            expected += 1
            buffered = self._seq_buffer.get(key, {})
            while expected in buffered:
                admitted.append(buffered.pop(expected))
                expected += 1
            self._seq_expected[key] = expected
            return admitted

    def _adopt_trace(self, spec: TaskSpec) -> tuple:
        """Execute this task under the submitter's span context (the
        in-process half of worker_main._begin_trace): the task becomes a
        span of the caller's trace, and spans opened inside it — serve
        replica/engine instrumentation runs HERE in-process — inherit the
        root's sampling decision."""
        from ray_tpu_torch.util import tracing

        span_id = spec.task_id.hex()[:16]
        trace_id = spec.trace_ctx[0] if spec.trace_ctx else span_id
        parent = spec.trace_ctx[1] if spec.trace_ctx else None
        sampled = (bool(spec.trace_ctx[2])
                   if spec.trace_ctx and len(spec.trace_ctx) > 2 else True)
        tracing.set_context((trace_id, span_id, sampled))
        return trace_id, span_id, parent

    def _record_actor_task_event(self, runner: ActorRunner, spec: TaskSpec,
                                 trace: tuple, started: float,
                                 ok: bool) -> None:
        """Actor tasks emit a trace-linked task event only when the spec
        carries a SAMPLED trace context — the plain actor-call hot path
        (untraced) stays event-free as before."""
        if not (spec.trace_ctx and len(spec.trace_ctx) > 2
                and spec.trace_ctx[2]):
            return
        trace_id, span_id, parent = trace
        now = time.time()
        self.gcs.record_task_event({
            "task_id": spec.task_id.hex(),
            "name": f"{spec.function_name}.{spec.actor_method}",
            "state": "FINISHED" if ok else "FAILED",
            "time": now,
            "duration": now - started,
            "node_id": runner.node_id.hex() if runner.node_id else "",
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_span_id": parent,
        })

    def _execute_actor_task(self, runner: ActorRunner, state: TaskState) -> None:
        spec = state.spec
        self._ctx.task_id = spec.task_id
        self._ctx.actor_id = runner.actor_id
        self._ctx.node_id = runner.node_id
        self._ctx.in_worker = True
        started = time.time()
        trace = self._adopt_trace(spec)
        try:
            if state.cancelled:
                raise TaskCancelledError(spec.task_id)
            method = _resolve_actor_method(runner.instance, spec.actor_method)
            args, kwargs = self._fetch_args(spec)
            t_args = time.time()
            result = method(*args, **kwargs)
            self._store_results(state, result)
            phases = {"args_fetch": t_args - started,
                      "execute": time.time() - t_args}
            if spec.submit_ts:
                phases["queued"] = max(0.0, started - spec.submit_ts)
                phases["total"] = max(0.0, time.time() - spec.submit_ts)
            observe_task_phases(phases)
            self._record_actor_task_event(runner, spec, trace, started, True)
        except _DependencyFailed as df:
            self._store_error(state, df.error)
            observe_task_phases({"queued": max(0.0, started - spec.submit_ts)}
                                if spec.submit_ts else {}, ok=False)
        except TaskCancelledError:
            self._finish_cancelled(state)
        except BaseException as e:  # noqa: BLE001
            # Method exceptions don't kill the actor (reference semantics).
            self._store_error(state, TaskError.from_exception(f"{spec.function_name}.{spec.actor_method}", e))
            observe_task_phases({"queued": max(0.0, started - spec.submit_ts)}
                                if spec.submit_ts else {}, ok=False)
            self._record_actor_task_event(runner, spec, trace, started, False)
        finally:
            from ray_tpu_torch.util import tracing

            tracing.set_context(None)
            self._ctx.in_worker = False
            self._ctx.task_id = None
            self._ctx.actor_id = None
            self._finalize_actor_task(state)

    def _finalize_actor_task(self, state: TaskState) -> None:
        self._release_dep_refs(state)
        if not state.generator_items:
            with self._lock:
                self.tasks.pop(state.spec.task_id, None)

    async def _execute_actor_task_async(self, runner: ActorRunner, state: TaskState) -> None:
        spec = state.spec
        started = time.time()
        # Each asyncio task owns a private contextvars copy, so adopting the
        # caller's span context here can't cross-contaminate interleaved
        # methods — and needs no reset.
        trace = self._adopt_trace(spec)
        try:
            if state.cancelled:
                raise TaskCancelledError(spec.task_id)
            if spec.actor_method == DAG_LOOP_METHOD:
                # A resident blocking loop would freeze the actor's event
                # loop (every queued coroutine starves) — reject clearly.
                raise TypeError(
                    "compiled DAGs are not supported on async actors")
            method = getattr(runner.instance, spec.actor_method)
            args, kwargs = self._fetch_args(spec)
            result = method(*args, **kwargs)
            import inspect

            if inspect.iscoroutine(result):
                result = await result
            self._store_results(state, result)
            self._record_actor_task_event(runner, spec, trace, started, True)
        except _DependencyFailed as df:
            self._store_error(state, df.error)
        except TaskCancelledError:
            self._finish_cancelled(state)
        except BaseException as e:  # noqa: BLE001
            self._store_error(state, TaskError.from_exception(f"{spec.function_name}.{spec.actor_method}", e))
            self._record_actor_task_event(runner, spec, trace, started, False)
        finally:
            self._finalize_actor_task(state)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._handle_actor_failure(actor_id, ActorDiedError(actor_id, "killed via kill()"), allow_restart=not no_restart)

    def _handle_actor_failure(self, actor_id: ActorID, cause: BaseException, allow_restart: bool = True) -> None:
        """Actor death / restart ladder (gcs_actor_manager.cc:515 restart)."""
        runner = self.actors.get(actor_id)
        if runner is None:
            return
        err = cause if isinstance(cause, ActorError) else ActorDiedError(actor_id, str(cause))
        drained = runner.kill(err)
        # The port drops the dead instance here (the JAX runtime keeps it):
        # in-process, the instance is what holds its card's memory, which a
        # killed actor's process would have given back. A method still
        # running keeps its own reference until it returns.
        runner.instance = None
        held = runner.held_resources
        if not held.is_empty() and runner.node_id in self.nodes:
            self.scheduler.release(runner.node_id, held)
            runner.held_resources = ResourceSet({})
        if runner.bundle_held is not None and self._pg_manager is not None:
            strategy, request = runner.bundle_held
            runner.bundle_held = None
            self._pg_manager.release_to_bundle(strategy, request)
        self._on_resources_freed(self.nodes.get(runner.node_id) if runner.node_id else None)
        for state in drained:
            self._store_error(state, err)
        info = self.gcs.get_actor(actor_id)
        if allow_restart and info is not None and info.num_restarts < info.max_restarts:
            self.gcs.update_actor_state(actor_id, "RESTARTING", num_restarts=info.num_restarts + 1)
            self._schedule_actor_creation(actor_id, runner.creation_spec)
        else:
            self.gcs.update_actor_state(actor_id, "DEAD", death_cause=str(err))

    # -- cancellation (core_worker.cc CancelTask) ------------------------------

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        task_id = ref.id.task_id()
        state = self.tasks.get(task_id)
        if state is None:
            return
        with state.lock:
            state.cancelled = True
            if state.status in ("PENDING_DEPS", "QUEUED"):
                # Remove from node queue if present.
                if state.node_id and state.node_id in self.nodes:
                    node = self.nodes[state.node_id]
                    with node.lock:
                        try:
                            node.pending.remove(state)
                        except ValueError:
                            pass
                self._finish_cancelled(state)

    # -- context ---------------------------------------------------------------

    @property
    def current_task_id(self):
        return self._ctx.task_id

    @property
    def current_actor_id(self):
        return self._ctx.actor_id

    @property
    def current_node_id(self):
        return self._ctx.node_id or self.head_node_id

    def shutdown(self) -> None:
        from ray_tpu_torch.util import tracing

        tracing.flush()
        flightrec.close()
        self._metrics_exporter.stop()
        from ray_tpu_torch.util.state import _reset_task_cache

        _reset_task_cache()
        for actor_id in list(self.actors):
            try:
                self.kill_actor(actor_id)
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                log_swallowed(logger, "kill_actor at shutdown")
        self.gcs.finish_job(self.job_id)
        self._arg_pool.shutdown(wait=False, cancel_futures=True)
        self._closing.set()
        self._gc_drainer.join(timeout=5.0)
        try:
            self.store.close()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            log_swallowed(logger, "object store close")
        set_config(None)


def _resolve_actor_method(instance, method_name: str):
    """Bind an actor method, routing DAG_LOOP_METHOD to the compiled-DAG
    resident loop with the live instance (dag/compiled_dag.py)."""
    if method_name == DAG_LOOP_METHOD:
        import functools

        from ray_tpu_torch.dag.compiled_dag import actor_dag_loop

        return functools.partial(actor_dag_loop, instance)
    return getattr(instance, method_name)


class _ActorCreationState(TaskState):
    """A queued actor-creation waiting for node resources."""

    __slots__ = ("actor_id_ref", "runner_ref")

    def __init__(self, runtime: Runtime, actor_id: ActorID, spec: TaskSpec, node_id: NodeID, runner: ActorRunner):
        super().__init__(spec)
        self.actor_id_ref = actor_id
        self.node_id = node_id
        self.runner_ref = runner


class _DependencyFailed(Exception):
    def __init__(self, error):
        self.error = error


def get_runtime() -> Runtime:
    if _global_runtime is None:
        raise RuntimeNotInitializedError()
    return _global_runtime


def init_runtime(**kwargs) -> Runtime:
    global _global_runtime
    with _init_lock:
        if _global_runtime is not None:
            return _global_runtime
        _global_runtime = Runtime(**kwargs)
        return _global_runtime


def shutdown_runtime() -> None:
    global _global_runtime
    with _init_lock:
        if _global_runtime is not None:
            _global_runtime.shutdown()
            _global_runtime = None
