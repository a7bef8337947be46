"""Public API — init/shutdown, remote, get/put/wait, kill/cancel, context.

The analog of the reference's top-level ``ray`` API
(``python/ray/_private/worker.py`` — ``init`` :1214, ``get``/``put``/``wait``
wrappers; ``python/ray/runtime_context.py``). Semantics match the reference:
``get`` re-raises remote exceptions, ``wait`` returns (ready, not_ready),
``kill`` terminates actors, named actors resolve through the GCS.

The port's copy of ``ray_tpu/api.py``: the in-process runtime, with the card
(``GPU``) as the accelerator resource, or a driver attached to a
multiprocess cluster (``init(address=...)``, ``ray_tpu_torch.core.cluster``).
"""

from __future__ import annotations

import functools
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch.core import runtime as _runtime_mod
from ray_tpu_torch.core.actor import ActorClass, ActorHandle, get_actor  # noqa: F401 — re-exported
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core.runtime import get_runtime, init_runtime, shutdown_runtime


def init(
    *,
    address: str | None = None,
    resources: Dict[str, float] | None = None,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    num_tpus: float | None = None,
    num_nodes: int = 1,
    namespace: str = "default",
    system_config: Dict | None = None,
    labels: Dict[str, str] | None = None,
    ignore_reinit_error: bool = True,
):
    """Start the runtime.

    Without ``address``: a head node + N virtual nodes in-process (the
    single-process runtime). ``resources`` are per node; ``num_gpus`` sets
    ``GPU`` (``num_tpus`` is its alias), else the cards present are
    detected. With ``address="host:port"``: connect this process as a
    driver to a running multiprocess cluster's GCS (see
    ``ray_tpu_torch.core.cluster``).
    """
    if _runtime_mod._global_runtime is not None:
        if ignore_reinit_error:
            return _runtime_mod._global_runtime
        raise RuntimeError("ray_tpu_torch.init() already called")
    if address is not None:
        # Cluster shape is fixed by the running daemons; reject options that
        # would silently be ignored.
        ignored = {
            "resources": resources, "num_cpus": num_cpus,
            "num_gpus": num_gpus, "num_tpus": num_tpus, "labels": labels,
            "system_config": system_config,
        }
        bad = [k for k, v in ignored.items() if v is not None]
        if num_nodes != 1:
            bad.append("num_nodes")
        if bad:
            raise ValueError(
                f"init(address=...) connects to an existing cluster; "
                f"{bad} cannot apply (configure the daemons instead)"
            )
        from ray_tpu_torch.core.cluster import connect

        return connect(address, namespace=namespace)
    res = dict(resources or {})
    if num_cpus is not None:
        res["CPU"] = float(num_cpus)
    n_acc = num_gpus if num_gpus is not None else num_tpus
    if n_acc is not None:
        res["GPU"] = float(n_acc)
    return init_runtime(
        resources=res or None,
        num_nodes=num_nodes,
        namespace=namespace,
        system_config=system_config,
        labels=labels,
    )


def shutdown():
    shutdown_runtime()


def is_initialized() -> bool:
    return _runtime_mod._global_runtime is not None


def _ensure_init():
    if _runtime_mod._global_runtime is None:
        init()
    return _runtime_mod._global_runtime


def remote(*args, **options):
    """``@remote`` decorator for functions and classes.

    Mirrors ``ray.remote``: bare (``@remote``) or parameterized
    (``@remote(num_gpus=1, max_retries=5)``).
    """

    def decorate(target):
        if isinstance(target, type):
            return ActorClass(target, options)
        if callable(target):
            return functools.wraps(target)(RemoteFunction(target, options))  # type: ignore[return-value]
        raise TypeError("@remote must decorate a function or class")

    if len(args) == 1 and not options and (callable(args[0]) or isinstance(args[0], type)):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return decorate


def get(refs, *, timeout: float | None = None):
    _ensure_init()
    return get_runtime().get(refs, timeout=timeout)


def put(value) -> ObjectRef:
    _ensure_init()
    return get_runtime().put(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
    fetch_local: bool = True,
):
    _ensure_init()
    return get_runtime().wait(refs, num_returns=num_returns, timeout=timeout, fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    get_runtime().kill_actor(actor.actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    get_runtime().cancel(ref, force=force)


def nodes() -> List[dict]:
    rt = get_runtime()
    return [
        {
            "NodeID": n.node_id.hex(),
            "Alive": n.alive,
            "Resources": n.resources,
            "Labels": n.labels,
            "Address": n.address,
        }
        for n in rt.gcs.nodes.values()
    ]


def cluster_resources() -> Dict[str, float]:
    return get_runtime().gcs.cluster_resources()


def available_resources() -> Dict[str, float]:
    return get_runtime().scheduler.available_resources()


class RuntimeContext:
    """Reference: python/ray/runtime_context.py."""

    @property
    def job_id(self):
        return get_runtime().job_id

    @property
    def node_id(self):
        return get_runtime().current_node_id

    @property
    def task_id(self):
        return get_runtime().current_task_id

    @property
    def actor_id(self):
        return get_runtime().current_actor_id

    @property
    def namespace(self):
        return get_runtime().namespace

    def get_resources(self) -> Dict[str, float]:
        return cluster_resources()


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()


def _chrome_entry(e: dict) -> Optional[dict]:
    if e.get("state") not in ("FINISHED", "FAILED"):
        return None
    entry = {
        "name": e["name"],
        "cat": e.get("kind", "task"),
        "ph": "X",
        "ts": (e["time"] - e.get("duration", 0)) * 1e6,
        "dur": e.get("duration", 0) * 1e6,
        "pid": e.get("node_id", "node"),
        "tid": e["task_id"][:8],
    }
    if e.get("trace_id"):
        # span linkage (cross-process trace propagation)
        entry["args"] = {
            "trace_id": e["trace_id"],
            "span_id": e.get("span_id") or e.get("task_id"),
            "parent_span_id": e.get("parent_span_id"),
            "failed": e.get("state") == "FAILED",
        }
    return entry


def _flow_events(events: List[dict], entries: List[dict]) -> List[dict]:
    """Chrome flow events (``ph:"s"``/``ph:"f"``) linking parent→child
    spans across processes — the arrows in the trace viewer."""
    by_span: Dict[str, dict] = {}
    for e, entry in zip(events, entries):
        sid = e.get("span_id") or e.get("task_id")
        if sid:
            by_span[sid] = entry
    flows: List[dict] = []
    for e, entry in zip(events, entries):
        parent = e.get("parent_span_id")
        if not parent or parent not in by_span:
            continue
        sid = e.get("span_id") or e.get("task_id")
        src = by_span[parent]
        flows.append({"name": "span", "cat": "trace", "ph": "s", "id": sid,
                      "pid": src["pid"], "tid": src["tid"],
                      "ts": src["ts"]})
        flows.append({"name": "span", "cat": "trace", "ph": "f", "bp": "e",
                      "id": sid, "pid": entry["pid"], "tid": entry["tid"],
                      "ts": entry["ts"]})
    return flows


class _TimelineFeed:
    """Per-caller rolling chrome-trace cache: each call pulls only the NEW
    task events through cursor-paged ``task_events_since`` reads (the
    dashboard ``/api/events`` pattern) instead of copying and reconverting
    the whole up-to-100k-event log every time."""

    PAGE = 5000
    MAX_ENTRIES = 100_000

    def __init__(self, gcs):
        self.cursor = 0
        self.entries: List[dict] = []
        self.last_seen = time.monotonic()
        # Identity of the GCS this cursor indexes into — a new runtime means
        # a new event log, so a stale feed must restart from zero. A weakref
        # (not id()) so a freed-and-reallocated store can't alias the old.
        self.gcs_ref = weakref.ref(gcs)

    def pull(self, gcs) -> None:
        while True:
            self.cursor, events = gcs.task_events_since(self.cursor,
                                                        self.PAGE)
            for e in events:
                entry = _chrome_entry(e)
                if entry is not None:
                    self.entries.append(entry)
            if len(events) < self.PAGE:
                break
        if len(self.entries) > self.MAX_ENTRIES:
            del self.entries[:len(self.entries) // 2]


_TL_FEEDS: Dict[str, _TimelineFeed] = {}
_TL_LOCK = threading.Lock()
_TL_CLIENT_CAP = 32
_TL_CLIENT_TTL_S = 60.0


def timeline(trace_id: Optional[str] = None,
             client: str = "default") -> List[dict]:
    """Chrome-trace-style task events (reference:
    ``python/ray/_private/state.py:434 chrome_tracing_dump``).

    With ``trace_id``, returns ONE trace's events (an indexed GCS lookup)
    plus flow events linking parent→child spans across processes. Without,
    returns the rolling full timeline; ``client`` names the caller's
    incremental cursor cache."""
    gcs = get_runtime().gcs
    if trace_id is not None:
        events = gcs.trace(trace_id)
        entries = [_chrome_entry(e) for e in events]
        keep = [(e, en) for e, en in zip(events, entries) if en is not None]
        events, entries = [e for e, _ in keep], [en for _, en in keep]
        return entries + _flow_events(events, entries)
    now = time.monotonic()
    with _TL_LOCK:
        feed = _TL_FEEDS.get(client)
        if feed is not None and feed.gcs_ref() is not gcs:
            del _TL_FEEDS[client]
            feed = None
        if feed is None:
            for key, f in list(_TL_FEEDS.items()):
                if now - f.last_seen > _TL_CLIENT_TTL_S:
                    del _TL_FEEDS[key]
            while len(_TL_FEEDS) >= _TL_CLIENT_CAP:
                oldest = min(_TL_FEEDS, key=lambda k: _TL_FEEDS[k].last_seen)
                del _TL_FEEDS[oldest]
            feed = _TL_FEEDS[client] = _TimelineFeed(gcs)
        feed.last_seen = now
        feed.pull(gcs)
        return list(feed.entries)
