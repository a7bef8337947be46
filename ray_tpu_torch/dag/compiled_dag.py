"""Compiled DAG executor — resident actor loops over mutable channels.

The port's copy of ``ray_tpu/dag/compiled_dag.py``: compiling a static
actor-method graph allocates one mutable channel per EDGE and parks each
actor in a resident gather→exec→broadcast loop; ``execute`` just writes the
input channels. Per-call cost collapses from a full task submission (spec
pickle → lease → push → result seal) to one channel write and one read per
edge, and with multi-slot ring channels several ticks ride each edge at
once, so burst submission pipelines through the stages.

Graph shapes beyond linear chains compile: multi-arg ``bind`` (fan-in),
several consumers of one node (fan-out, broadcast per tick), and
``MultiOutputNode`` gathering multiple leaves into a per-tick result tuple.

Channels are chosen per edge: shm rings on one host, sockets across hosts,
or :class:`~ray_tpu_torch.dag.device_channel.DeviceChannel` when torch
tensors should land on each reader's device (``channel_type="device"``;
``channel_device`` names that device, the current CUDA device when left
out).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.task_spec import DAG_LOOP_METHOD
from ray_tpu_torch.dag.channel import Channel, ChannelClosed, SocketChannel
from ray_tpu_torch.dag.dag_node import (ClassMethodNode, DAGNode, InputNode,
                                  MultiOutputNode)
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("dag")

_DRIVER = "__driver__"  # edge-key sentinel for driver-read output edges


class _DagError:
    def __init__(self, message: str):
        self.message = message


class _TracedPayload:
    """A tick payload carrying its trace context across channel edges.

    Wrapped only when the driver's ``execute`` ran under a SAMPLED trace
    context — the untraced µs-path ships raw payloads and pays one
    ``type`` check per edge read. Stages unwrap, time the method as a
    ``dag.stage`` child span of the tick span, and re-wrap so downstream
    stages (and the driver) stay in the trace."""

    __slots__ = ("ctx", "tick_span", "value")

    def __init__(self, ctx, tick_span, value):
        self.ctx = ctx
        self.tick_span = tick_span
        self.value = value


def actor_dag_loop(instance, method_name: str, in_channels: List[Any],
                   out_channels: List[Any],
                   arg_template: Optional[List[Tuple[str, Any]]] = None
                   ) -> str:
    """The resident loop body; runs INSIDE the actor (both runtimes hook
    ``DAG_LOOP_METHOD`` to call this with the live instance).

    Per tick: read one value from EVERY in-channel (fan-in gather, FIFO per
    edge keeps ticks aligned), assemble the call args from ``arg_template``
    (``("c", i)`` = the i-th gathered value, ``("v", const)`` = a baked
    constant), run the method, broadcast the result to every out-channel.
    A ``_DagError`` input skips the method and forwards downstream (error
    passthrough), so the driver sees the ORIGINATING stage's failure.

    On exit — close pill from any upstream, or a wedged downstream — every
    out-channel is closed (propagating teardown) and every ATTACHED channel
    endpoint is detached, releasing this worker's mmap/fd/socket handles
    (the driver, which created the channels, owns the unlink). In-process
    runtimes pass the driver's own channel objects by reference; those are
    not attached endpoints and the driver's ``destroy`` remains the single
    owner of their lifecycle.
    """
    from ray_tpu_torch.core.config import config

    method = getattr(instance, method_name)
    if arg_template is None:
        arg_template = [("c", 0)]
    write_bound = float(config().internal_wait_timeout_s)
    try:
        while True:
            try:
                values = [ch.read(timeout=None) for ch in in_channels]
            except ChannelClosed:
                for och in out_channels:
                    och.close()
                return "closed"
            trace = None
            if any(type(v) is _TracedPayload for v in values):
                trace = next(v for v in values
                             if type(v) is _TracedPayload)
                values = [v.value if type(v) is _TracedPayload else v
                          for v in values]
            err = next((v for v in values if isinstance(v, _DagError)), None)
            if err is not None:
                result = err
            else:
                args = [values[payload] if kind == "c" else payload
                        for kind, payload in arg_template]
                t0 = time.monotonic()
                try:
                    result = method(*args)
                except Exception as exc:  # noqa: BLE001 — deliver to caller
                    result = _DagError(f"{type(exc).__name__}: {exc}")
                if trace is not None:
                    from ray_tpu_torch.util import tracing

                    tracing.emit(
                        f"dag.stage:{method_name}", trace.ctx,
                        duration=time.monotonic() - t0,
                        parent_span_id=trace.tick_span,
                        attrs={"method": method_name})
            if trace is not None:
                result = _TracedPayload(trace.ctx, trace.tick_span, result)
            try:
                for och in out_channels:
                    # Bounded: a consumer that stopped draining (died mid-
                    # teardown) must not park this loop forever on a full
                    # ring — treat the stall as the teardown it is.
                    och.write(result, timeout=write_bound)
            except (ChannelClosed, TimeoutError):
                for och in out_channels:
                    och.close()
                return "closed"
    finally:
        for ch in list(in_channels) + list(out_channels):
            if getattr(ch, "_attached_endpoint", False):
                try:
                    ch.detach()
                except Exception:  # noqa: BLE001 — teardown is best-effort
                    log_swallowed(logger, "channel detach at DAG loop exit")


class DAGRef:
    """Future for one execute() call. ``get`` is idempotent like
    ``ObjectRef.get``: the first call drains the tick off the output
    channels, repeats serve the cached result (or re-raise the cached
    stage error)."""

    _UNSET = object()

    def __init__(self, dag: "CompiledDAG", index: int):
        self._dag = dag
        self._index = index
        self._result = DAGRef._UNSET

    def get(self, timeout: Optional[float] = 30.0):
        if self._result is DAGRef._UNSET:
            # Timeouts propagate WITHOUT caching — the tick is still in
            # flight and a later get() may find it.
            self._result = self._dag._fetch(self._index, timeout)
        result = self._result
        parts = result if self._dag._multi_output else (result,)
        errs = [r for r in parts if isinstance(r, _DagError)]
        if errs:
            raise RuntimeError(f"DAG stage failed: {errs[0].message}")
        return result


class CompiledDAG:
    def __init__(self, output_node: DAGNode, *,
                 channel_capacity: int = 4 * 1024 * 1024,
                 channel_type: str = "auto",
                 channel_slots: Optional[int] = None,
                 channel_device: Any = None):
        """``channel_type``: "shm" (same-host mutable shm ring), "socket"
        (cross-host TCP with windowed acks), "device" (DeviceChannel —
        torch tensors land on each reader's device, staged through pinned
        memory), or "auto" — per EDGE, shm when both endpoints share a
        host, sockets otherwise.

        ``channel_slots`` overrides the ``dag_channel_slots`` ring depth —
        how many ticks can be in flight per edge (1 = lock-step).
        ``channel_device`` is the device a device channel's reader lands
        tensors on (every edge, the driver's output edges too); None means
        each reader's current CUDA device, and a reader with no card then
        raises. Tests on a host with no card pass ``"cpu"``.
        """
        nodes = output_node.collect()
        self._multi_output = isinstance(output_node, MultiOutputNode)
        leaves = (list(output_node.upstreams) if self._multi_output
                  else [output_node])
        input_nodes = [n for n in nodes if isinstance(n, InputNode)]
        stages = [n for n in nodes if isinstance(n, ClassMethodNode)]
        bad = [n for n in nodes
               if not isinstance(n, (InputNode, ClassMethodNode))
               and n is not output_node]
        if bad or (self._multi_output and not all(
                isinstance(leaf, ClassMethodNode) for leaf in leaves)):
            raise ValueError("DAG nodes must be bound actor methods "
                             "(MultiOutputNode only at the root)")
        if len(input_nodes) != 1:
            raise ValueError("DAG must contain exactly one InputNode "
                             f"(found {len(input_nodes)})")
        if not stages or not all(isinstance(leaf, ClassMethodNode)
                                 for leaf in leaves):
            raise ValueError("DAG must contain at least one bound actor "
                             "method ending in actor-method leaves")
        self._input_node = input_nodes[0]
        self._stages = stages
        seen_actors = set()
        for stage in stages:
            aid = stage.actor.actor_id
            if aid in seen_actors:
                raise ValueError(
                    "compiled DAG stages must use DISTINCT actors: the "
                    "resident loop occupies an actor's execution thread, so "
                    "a second stage on the same actor can never start")
            seen_actors.add(aid)

        # -- edges: one channel per (producer, consumer, arg position) ----
        # A stage consumes one channel per DAGNode bind arg; a producer
        # broadcasts to one channel per consumer edge. Leaves additionally
        # produce a driver edge each.
        hosts = (self._node_hosts(nodes) if channel_type == "auto" else None)

        def make_channel(producer, consumer):
            if channel_type == "device":
                from ray_tpu_torch.dag.device_channel import DeviceChannel

                return DeviceChannel(capacity=channel_capacity,
                                     slots=channel_slots,
                                     device=channel_device)
            if channel_type == "socket":
                cross = True
            elif channel_type == "shm":
                cross = False
            else:
                cross = (hosts is not None
                         and hosts[id(producer)] != hosts.get(
                             id(consumer), hosts[_DRIVER]))
            if cross:
                return SocketChannel(capacity=channel_capacity)
            return Channel(capacity=channel_capacity, slots=channel_slots)

        self._channels: Dict[tuple, Any] = {}
        out_edges: Dict[int, List[tuple]] = {id(n): [] for n in nodes}
        in_chans: Dict[int, List[Any]] = {id(s): [] for s in stages}
        templates: Dict[int, List[Tuple[str, Any]]] = {}
        for stage in stages:
            template: List[Tuple[str, Any]] = []
            for pos, arg in enumerate(stage.bind_args):
                if isinstance(arg, DAGNode):
                    key = (id(arg), id(stage), pos)
                    ch = make_channel(arg, stage)
                    self._channels[key] = ch
                    out_edges[id(arg)].append(key)
                    template.append(("c", len(in_chans[id(stage)])))
                    in_chans[id(stage)].append(ch)
                else:
                    template.append(("v", arg))
            templates[id(stage)] = template
        for k, leaf in enumerate(leaves):
            key = (id(leaf), _DRIVER, k)
            self._channels[key] = make_channel(leaf, _DRIVER)
            out_edges[id(leaf)].append(key)
        self._input_channels = [self._channels[key]
                                for key in out_edges[id(self._input_node)]]
        self._output_channels = [self._channels[(id(leaf), _DRIVER, k)]
                                 for k, leaf in enumerate(leaves)]

        # -- park each actor in its resident loop ------------------------
        self._loop_refs = []
        for stage in stages:
            ref = stage.actor._submit(
                DAG_LOOP_METHOD,
                (stage.method_name, in_chans[id(stage)],
                 [self._channels[key] for key in out_edges[id(stage)]],
                 templates[id(stage)]),
                {}, {},
            )
            self._loop_refs.append(ref)
        # Loop tasks run until teardown — one completing NOW means its
        # startup failed (async actor, bad method, dead worker). Surface it
        # here instead of as an opaque ChannelTimeout at execute().
        import ray_tpu_torch

        ready, _ = ray_tpu_torch.wait(self._loop_refs,
                                num_returns=len(self._loop_refs), timeout=0.3)
        if ready:
            for ch in self._channels.values():
                ch.destroy()
            ray_tpu_torch.get(ready[0])  # raises the loop's startup error
            raise RuntimeError("DAG loop exited prematurely at compile time")
        self._next_index = 0
        self._reads = 0
        self._fetched: Dict[int, Any] = {}
        # Leaves already gathered for the IN-PROGRESS tick: a timeout
        # partway through a multi-output gather must not lose consumed
        # values — the next fetch resumes at the first unread leaf, so
        # tick alignment across output channels survives the retry.
        self._partial_outs: List[Any] = []
        self._tick_start: Dict[int, float] = {}
        # index -> (trace_ctx, tick_span_id) for ticks executed under a
        # sampled trace; the dag.tick span closes at _fetch.
        self._tick_trace: Dict[int, tuple] = {}
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._torn_down = False

    @staticmethod
    def _node_hosts(nodes) -> Dict[int, str]:
        """Host of every channel endpoint, keyed by node id; the driver's
        host under the ``_DRIVER`` sentinel (InputNode lives with the
        driver)."""
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()

        def actor_host(actor) -> str:
            try:
                addr = rt._actor_address(actor.actor_id)
                return addr.rsplit(":", 1)[0]
            except Exception:  # noqa: BLE001 — in-process runtime
                return "local"

        driver_host = (rt.owner_address.rsplit(":", 1)[0]
                       if hasattr(rt, "owner_address") else "local")
        hosts: Dict[int, str] = {_DRIVER: driver_host}
        for n in nodes:
            hosts[id(n)] = (actor_host(n.actor)
                            if isinstance(n, ClassMethodNode)
                            else driver_host)
        return hosts

    def execute(self, value: Any, timeout: Optional[float] = 30.0) -> DAGRef:
        """One DAG step: a single shm write per input edge; result via the
        returned ref. With multi-slot rings several executes pipeline
        through the stages before the first blocks on backpressure.

        Index assignment and the channel writes share one lock: input
        channels are single-writer, and FIFO index↔result mapping requires
        writes to land in index order. A failed (timed-out) execute
        consumes no index AND publishes to no edge: shm input edges commit
        two-phase — every ring slot is RESERVED before any payload is
        published, and a reservation timeout rolls the already-reserved
        slots back — so a full edge on one input can't leave its fan-out
        siblings a tick ahead (which would desync every later merge).
        """
        if self._torn_down:
            raise RuntimeError("DAG was torn down")
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.core.metrics_export import metrics_enabled
        from ray_tpu_torch.util import tracing

        # Tick tracing: only when execute() runs under an already-SAMPLED
        # context (a serve request, a user span) — the untraced µs path
        # pays one flag check and ships the raw payload.
        trace_ctx = tick_span = None
        if tracing.trace_enabled():
            ctx = tracing.current_context()
            if ctx is not None and ctx[2]:
                trace_ctx, tick_span = ctx, tracing.new_span_id()
                value = _TracedPayload(trace_ctx, tick_span, value)
        rings = [ch for ch in self._input_channels if isinstance(ch, Channel)]
        others = [ch for ch in self._input_channels
                  if not isinstance(ch, Channel)]
        with self._write_lock:
            if rings:
                payload = serialization.dumps(value)
                for ch in rings:
                    if len(payload) > ch.capacity:
                        raise ValueError(
                            f"payload of {len(payload)} bytes exceeds "
                            f"channel capacity {ch.capacity}")
                reserved = []
                try:
                    for ch in rings:
                        ch._wait_writable(timeout)
                        reserved.append(ch)
                except BaseException:
                    for ch in reserved:
                        ch._abort_write()
                    raise
                for ch in rings:
                    off = ch._wpayload_off
                    ch._mm[off:off + len(payload)] = payload
                    ch._publish(len(payload))
            for ch in others:
                # Socket/device edges have no reserve/abort protocol;
                # they publish after every shm edge committed.
                ch.write(value, timeout=timeout)
            index = self._next_index
            self._next_index += 1
            if metrics_enabled() or trace_ctx is not None:
                self._tick_start[index] = time.monotonic()
            if trace_ctx is not None:
                self._tick_trace[index] = (trace_ctx, tick_span)
        return DAGRef(self, index)

    def _fetch(self, index: int, timeout: Optional[float]):
        """Results arrive strictly FIFO on each output channel: the i-th
        read is the i-th execute's result (one read per leaf per tick; a
        MultiOutputNode DAG yields a tuple). The lock makes fetchers take
        turns draining (single-reader channel contract)."""
        with self._lock:
            while index not in self._fetched:
                # Resume a partially gathered tick at its first UNREAD
                # leaf: a timeout mid-gather already consumed (and acked)
                # the earlier leaves' values for this tick.
                while len(self._partial_outs) < len(self._output_channels):
                    ch = self._output_channels[len(self._partial_outs)]
                    self._partial_outs.append(ch.read(timeout=timeout))
                outs, self._partial_outs = self._partial_outs, []
                outs = [o.value if type(o) is _TracedPayload else o
                        for o in outs]
                self._fetched[self._reads] = (tuple(outs) if self._multi_output
                                              else outs[0])
                self._reads += 1
            result = self._fetched.pop(index)
            trace = self._tick_trace.pop(index, None)
        start = self._tick_start.pop(index, None)
        if start is not None:
            from ray_tpu_torch.core.metrics_export import (dag_tick_hist,
                                                     metrics_enabled)

            if metrics_enabled():
                dag_tick_hist().observe(time.monotonic() - start)
            if trace is not None:
                from ray_tpu_torch.util import tracing

                tracing.emit("dag.tick", trace[0], span_id=trace[1],
                             duration=time.monotonic() - start,
                             attrs={"index": index})
        return result

    def teardown(self) -> None:
        """Poison the inputs, DRAIN the stage loops, then destroy.

        The drain is the teardown-race fix: destroying/unlinking the shm
        files while a stage is mid-``read`` would yank the backing file
        out from under its mmap. Instead the close pill propagates edge by
        edge, each loop exits (detaching its endpoints), and only then —
        bounded by ``dag_teardown_timeout_s`` — does the driver unlink.
        """
        if self._torn_down:
            return
        self._torn_down = True
        for ch in self._input_channels:
            ch.close()
        import ray_tpu_torch
        from ray_tpu_torch.core.config import config

        try:
            _ready, not_ready = ray_tpu_torch.wait(
                self._loop_refs, num_returns=len(self._loop_refs),
                timeout=float(config().dag_teardown_timeout_s))
        except Exception:  # noqa: BLE001 — runtime already shut down
            not_ready = []
            log_swallowed(logger, "DAG teardown drain")
        if not_ready:
            # A stage never saw the pill (wedged in user code, or parked on
            # an edge whose producer died). Force a pill into every shm
            # edge so spinning readers wake, then destroy anyway — bounded
            # beats leaked.
            logger.warning(
                "%d DAG stage loop(s) did not exit within "
                "dag_teardown_timeout_s; forcing channel close",
                len(not_ready))
            for ch in self._channels.values():
                if not isinstance(ch, SocketChannel):
                    try:
                        ch.close()
                    except Exception:  # noqa: BLE001 — best-effort wakeup
                        log_swallowed(logger, "forced channel close")
        for ch in self._channels.values():
            ch.destroy()
