"""State API — ``list_tasks/actors/objects/nodes`` + summaries.

Analog of the reference's ``python/ray/util/state/`` (``ray list ...``,
aggregated by ``dashboard/state_aggregator.py`` from GCS task events + raylet
stats). Sources here: the GCS's task-event log, actor/node/job tables, and
object-store stats.

The port's copy of ``ray_tpu/util/state.py``.
"""

from __future__ import annotations

import threading
from collections import Counter as _Counter
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.runtime import get_runtime


def list_nodes() -> List[Dict[str, Any]]:
    rt = get_runtime()
    return [
        {
            "node_id": n.node_id.hex(),
            "state": "ALIVE" if n.alive else "DEAD",
            "resources_total": dict(n.resources),
            "labels": dict(n.labels),
        }
        for n in rt.gcs.nodes.values()
    ]


def list_actors(*, state: Optional[str] = None) -> List[Dict[str, Any]]:
    rt = get_runtime()
    out = []
    for info in rt.gcs.actors.values():
        row = {
            "actor_id": info.actor_id.hex(),
            "class_name": info.class_name,
            "state": info.state,
            "name": info.name or "",
            "node_id": info.node_id.hex() if info.node_id else "",
            "restarts": getattr(info, "num_restarts", 0),
        }
        if state is None or row["state"] == state:
            out.append(row)
    return out


# Incremental task index: repeated list_tasks() calls (the dashboard polls
# every 2s) fold only NEW events via the GCS task_events_since cursor
# instead of copying the whole (up to 100k-entry) event log per call.
_tasks_lock = threading.Lock()
_tasks_cache: Dict[str, Any] = {"gcs": None, "cursor": 0, "latest": {}}


def _reset_task_cache() -> None:
    """Drop the incremental index (called on runtime shutdown so a dead
    runtime's GCS handle and task rows aren't retained until the next
    list_tasks under a fresh runtime)."""
    with _tasks_lock:
        _tasks_cache["gcs"] = None
        _tasks_cache["cursor"] = 0
        _tasks_cache["latest"] = {}


def _fold_event(latest: Dict[str, Dict[str, Any]], e: dict) -> None:
    tid = e.get("task_id")
    cur = latest.setdefault(tid, {"task_id": tid})
    cur["name"] = e.get("name", cur.get("name", ""))
    cur["state"] = e.get("state", cur.get("state", ""))
    cur["node_id"] = e.get("node_id", cur.get("node_id", ""))
    if e.get("duration") is not None:
        cur["duration_s"] = e["duration"]


def list_tasks(*, state: Optional[str] = None, limit: int = 10_000) -> List[Dict[str, Any]]:
    rt = get_runtime()
    gcs = rt.gcs
    while True:
        with _tasks_lock:
            if _tasks_cache["gcs"] is not gcs:
                # Fresh runtime (or reconnect): rebuild from event 0.
                _tasks_cache["gcs"] = gcs
                _tasks_cache["cursor"] = 0
                _tasks_cache["latest"] = {}
            cursor = _tasks_cache["cursor"]
        # The GCS read happens OUTSIDE the lock (it may be a blocking RPC);
        # results apply only if no concurrent caller advanced the cursor.
        new_cursor, events = gcs.task_events_since(cursor, 10_000)
        with _tasks_lock:
            if _tasks_cache["gcs"] is not gcs:
                continue  # runtime swapped mid-read: start over
            if _tasks_cache["cursor"] == cursor:
                latest = _tasks_cache["latest"]
                for e in events:
                    _fold_event(latest, e)
                # Bound the index like the GCS bounds its event log: the
                # old rebuild-per-call was implicitly capped at log size.
                if len(latest) > 100_000:
                    for tid in list(latest)[: len(latest) // 2]:
                        del latest[tid]
                _tasks_cache["cursor"] = new_cursor
            if len(events) < 10_000:
                rows = [dict(r) for r in _tasks_cache["latest"].values()]
                break
    if state is not None:
        rows = [r for r in rows if r.get("state") == state]
    return rows[:limit]


def list_objects(limit: int = 10_000) -> List[Dict[str, Any]]:
    rt = get_runtime()
    stats = rt.store.stats()
    return [
        {
            "num_objects": stats["num_objects"],
            "used_bytes": stats["used_bytes"],
            "capacity_bytes": stats["capacity_bytes"],
        }
    ]


def list_jobs() -> List[Dict[str, Any]]:
    rt = get_runtime()
    return [
        {"job_id": j.job_id if isinstance(j.job_id, str) else j.job_id.hex(),
         "status": j.status, "entrypoint": j.entrypoint}
        for j in list(rt.gcs.jobs.values())
    ]


def list_placement_groups() -> List[Dict[str, Any]]:
    from ray_tpu_torch import placement_group_table

    return list(placement_group_table().values())


def summarize_tasks() -> Dict[str, int]:
    """``ray summary tasks``-style state counts."""
    return dict(_Counter(t.get("state", "UNKNOWN") for t in list_tasks()))


def summarize_actors() -> Dict[str, int]:
    return dict(_Counter(a["state"] for a in list_actors()))


def cluster_summary() -> Dict[str, Any]:
    rt = get_runtime()
    return {
        "nodes": len(rt.gcs.nodes),
        "alive_nodes": len(rt.gcs.alive_nodes()),
        "resources_total": rt.gcs.cluster_resources(),
        "resources_available": rt.scheduler.available_resources(),
        "tasks": summarize_tasks(),
        "actors": summarize_actors(),
        "object_store": rt.store.stats(),
    }
