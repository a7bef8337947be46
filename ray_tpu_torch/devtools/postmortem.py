"""Postmortem timeline assembly — the read side of the flight recorder.

``ray-tpu-torch debug`` lands here: discover every per-process ring file under
the session dir (``util.flightrec``), decode them (the mmap'd pages
survived any SIGKILL), merge them with whatever the GCS still serves —
the task-event/trace side table and the watchdog's health states — into
one causal timeline, then point at the process that died or stalled and
what it had in flight.

Three layers, separable for tests:

- :func:`build_timeline` — pure assembly: rings + optional GCS tables →
  ``{processes, events, traces, diagnosis}`` (JSON-able).
- :func:`format_timeline` — render that structure for humans.
- :func:`parse_prometheus` — tiny exposition parser shared with
  ``ray-tpu-torch status`` (the cluster rollup is the one read model both
  commands work from).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util import flightrec

# trace ids embedded in ring event details ("... trace=<id>") — the
# cross-link key between a process's black box and the GCS trace table.
_TRACE_RE = re.compile(r"trace=([0-9a-f-]+)")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return False
    return True


def build_timeline(session_dir: Optional[str] = None,
                   gcs_events: Optional[List[dict]] = None,
                   health_states: Optional[List[dict]] = None,
                   now: Optional[float] = None) -> Dict[str, Any]:
    """Merge ring files + GCS side tables into one timeline structure.

    ``gcs_events``/``health_states`` are optional — a postmortem often
    runs after the whole cluster (GCS included) is gone, and the rings
    alone must still tell the story.
    """
    import time as _time

    now = now if now is not None else _time.time()
    processes: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    for path in flightrec.discover_rings(session_dir):
        try:
            ring = flightrec.read_ring(path)
        except (OSError, ValueError):
            continue  # truncated/foreign file — postmortems take what's left
        label = f"{ring['component']}:{ring['pid']}"
        last = ring["events"][-1] if ring["events"] else None
        last_ts = last["ts"] if last else None
        alive = _pid_alive(ring["pid"])
        # flightrec.close() stamps a final "process … shutdown" record;
        # a ring ending any other way belongs to a process that died
        # without getting to say goodbye.
        clean_exit = bool(last and last["category"] == "process"
                          and "shutdown" in last["detail"])
        processes.append({
            "process": label, "component": ring["component"],
            "pid": ring["pid"], "path": path, "alive": alive,
            "clean_exit": clean_exit,
            "start_ts": ring["start_ts"], "written": ring["written"],
            "last_event_ts": last_ts,
            "last_event_age_s": (round(now - last_ts, 3)
                                 if last_ts else None),
        })
        for e in ring["events"]:
            events.append({**e, "process": label})
    for e in gcs_events or []:
        ev = {"ts": e.get("time", 0.0), "category": "gcs",
              "process": "gcs-table",
              "subject": str(e.get("task_id") or e.get("subject") or
                             e.get("name") or ""),
              "detail": _gcs_event_detail(e)}
        if e.get("trace_id"):
            ev["detail"] += f" trace={e['trace_id']}"
        events.append(ev)
    events.sort(key=lambda e: e["ts"])
    traces: Dict[str, List[int]] = {}
    for i, e in enumerate(events):
        for tid in _TRACE_RE.findall(e.get("detail", "")):
            traces.setdefault(tid, []).append(i)
    return {
        "processes": processes,
        "events": events,
        "traces": traces,
        "health": health_states or [],
        "diagnosis": _diagnose(processes, health_states or []),
    }


def _gcs_event_detail(e: dict) -> str:
    if e.get("type") == "health_transition":
        return (f"watchdog {e.get('kind')} {e.get('subject')} "
                f"{e.get('old')}->{e.get('new')}")
    parts = [str(e.get("state") or "")]
    if e.get("name"):
        parts.append(str(e["name"]))
    return " ".join(p for p in parts if p)


def _diagnose(processes: List[dict],
              health_states: List[dict]) -> List[str]:
    """Name the dead/stalled subjects — the sentence the operator came
    for. Ring pid-liveness and watchdog classification each contribute
    (the watchdog sees remote nodes this host can't probe)."""
    out: List[str] = []
    for p in processes:
        if not p["alive"] and not p["clean_exit"]:
            out.append(
                f"{p['process']} is DEAD (pid gone, no shutdown record; "
                f"last ring event {p['last_event_age_s']}s before this "
                "read)"
                if p["last_event_ts"] else
                f"{p['process']} is DEAD (pid gone; empty ring)")
    for s in health_states:
        if s.get("state") in ("stalled", "dead"):
            key = s.get("key") or []
            out.append(f"watchdog: {s.get('kind')} "
                       f"{':'.join(str(k) for k in key[1:])} "
                       f"is {s['state'].upper()}")
    return out


def events_for_trace(timeline: Dict[str, Any],
                     trace_id: str) -> List[dict]:
    """Every merged event cross-linked to one request's trace id."""
    return [timeline["events"][i]
            for i in timeline["traces"].get(trace_id, [])]


def format_timeline(timeline: Dict[str, Any], last_n: int = 25) -> str:
    """Human rendering: diagnosis first, then per-process status, the
    merged tail, and each dead process's final events."""
    import datetime as _dt

    def stamp(ts: float) -> str:
        return _dt.datetime.fromtimestamp(ts).strftime("%H:%M:%S.%f")[:-3]

    lines: List[str] = []
    if timeline["diagnosis"]:
        lines.append("== diagnosis ==")
        lines.extend(f"  {d}" for d in timeline["diagnosis"])
    else:
        lines.append("== diagnosis ==")
        lines.append("  all recorded processes alive; no watchdog alarms")
    lines.append("")
    lines.append("== processes ==")
    for p in timeline["processes"]:
        state = ("alive" if p["alive"]
                 else "exited" if p["clean_exit"] else "DEAD")
        last = (f"last event {p['last_event_age_s']}s ago"
                if p["last_event_ts"] else "no events")
        lines.append(f"  {p['process']:<24} {state:<6} "
                     f"{p['written']:>6} events  {last}")
    lines.append("")
    lines.append(f"== merged timeline (last {last_n}) ==")
    for e in timeline["events"][-last_n:]:
        lines.append(f"  {stamp(e['ts'])}  {e['process']:<22} "
                     f"[{e['category']}] {e['subject']} {e['detail']}")
    dead = [p for p in timeline["processes"]
            if not p["alive"] and not p["clean_exit"]]
    for p in dead:
        lines.append("")
        lines.append(f"== last events of {p['process']} (DEAD) ==")
        tail = [e for e in timeline["events"]
                if e["process"] == p["process"]][-last_n:]
        for e in tail:
            lines.append(f"  {stamp(e['ts'])}  [{e['category']}] "
                         f"{e['subject']} {e['detail']}")
    if timeline["traces"]:
        lines.append("")
        lines.append("== linked traces ==")
        for tid, idxs in sorted(timeline["traces"].items(),
                                key=lambda kv: -len(kv[1]))[:10]:
            procs = sorted({timeline['events'][i]['process']
                            for i in idxs})
            lines.append(f"  trace {tid}: {len(idxs)} events across "
                         f"{', '.join(procs)}")
    return "\n".join(lines)


# -- exposition parsing (shared with `ray-tpu-torch status`) ------------------

_SERIES_RE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<tags>[^}]*)\})?\s+(?P<value>[^\s]+)$")
_TAG_RE = re.compile(r'(\w+)="([^"]*)"')


def parse_prometheus(text: str) -> List[dict]:
    """``[{name, tags, value}]`` from an exposition body — enough of the
    format for our own output (which never emits escapes or exemplars)."""
    out: List[dict] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        tags = dict(_TAG_RE.findall(m.group("tags") or ""))
        out.append({"name": m.group("name"), "tags": tags, "value": value})
    return out


def select(series: List[dict], name: str, **tags: str) -> List[dict]:
    """Series of ``name`` whose tags contain ``tags`` as a subset."""
    return [s for s in series if s["name"] == name
            and all(s["tags"].get(k) == v for k, v in tags.items())]
