"""Cluster health watchdog — healthy / stalled / dead classification.

Runs inside the GCS health loop (``gcs_server.GcsService._health_loop``)
and closes the gap the binary alive/dead view leaves open: a SIGSTOPped
or deadlocked process keeps its TCP connections and looks exactly like an
idle one until the death bound fires. The watchdog consumes two existing
signals — daemon heartbeats (nodes) and per-process metrics-report ages
from the :class:`~ray_tpu_torch.util.metrics.MetricsAggregator` (components),
the report that also carries each process's flight-recorder progress
beacon — and classifies every subject:

``healthy``
    heartbeat / report age within ``health_stall_factor`` periods.
``stalled``
    age past the stall bound but before the death bound — the SIGSTOP /
    deadlock / wedged-event-loop posture. Recovers to ``healthy`` the
    moment reports resume (SIGCONT).
``dead``
    past the death bound, explicitly declared dead (node death path), or
    hosted on a dead node.

State is exported as ``ray_tpu_component_health{kind,subject_node,
subject,state}`` (value 1 on the active state's series; the other two
series of a subject are removed, not zeroed, so ``sum()`` per subject is
always 1 — and the subject tags deliberately avoid the ``node_id``/
``component`` names the aggregator stamps with REPORTER identity) and every
transition is raised as a ``health.transition`` event onto the
observability ingest plane, where ``ray-tpu debug`` merges it into the
postmortem timeline.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

HEALTHY = "healthy"
STALLED = "stalled"
DEAD = "dead"
STATES = (HEALTHY, STALLED, DEAD)


def classify(age: Optional[float], stall_after_s: float,
             dead_after_s: float) -> str:
    """Pure age → state mapping. ``age=None`` means the subject's liveness
    record is gone entirely (evicted report, popped heartbeat) — dead."""
    if age is None or age > dead_after_s:
        return DEAD
    if age > stall_after_s:
        return STALLED
    return HEALTHY


class _Subject:
    __slots__ = ("key", "kind", "state", "since", "beacon_ts")

    def __init__(self, key: tuple, kind: str):
        self.key = key
        self.kind = kind  # "node" | "component"
        self.state = HEALTHY
        self.since = time.time()
        self.beacon_ts: Optional[float] = None


class HealthWatchdog:
    """Tracks per-subject health states across ticks and emits transitions.

    ``on_transition(kind, key, old, new, detail)`` fires once per state
    change (the GCS routes it to the ingest plane + flight recorder).
    Dead subjects are remembered for ``dead_retention_s`` so the ``dead``
    gauge is exported and the postmortem can read it, then pruned (their
    gauge series removed) — worker-pid churn must not grow the table
    forever.
    """

    def __init__(self,
                 on_transition: Optional[Callable[..., None]] = None,
                 dead_retention_s: float = 600.0):
        self._lock = threading.Lock()
        self._subjects: Dict[tuple, _Subject] = {}
        self._on_transition = on_transition
        self._dead_retention_s = dead_retention_s
        self._pruned: List[tuple] = []  # gauge series to retire next export

    # -- per-tick input -------------------------------------------------------

    def tick(self, *,
             node_ages: Dict[str, float],
             dead_nodes: set,
             components: List[Tuple[Tuple, float, Optional[float]]],
             node_bounds: Tuple[float, float],
             comp_bounds: Tuple[float, float],
             now: Optional[float] = None) -> List[dict]:
        """One watchdog pass; returns the transitions it caused.

        ``node_ages`` maps node-id hex → heartbeat age; ``dead_nodes`` is
        the explicitly-declared-dead set (those classify dead regardless of
        age). ``components`` is ``MetricsAggregator.process_meta()`` output:
        ``(key=(node_id, component, pid), report_ts, beacon_ts)``. Bounds
        are ``(stall_after_s, dead_after_s)`` pairs — nodes heartbeat every
        ``health_check_period_s`` while components report every
        ``metrics_export_interval_s``, so they stall on different clocks.
        """
        now = now if now is not None else time.time()
        transitions: List[dict] = []
        seen: set = set()
        with self._lock:
            for hexid in dead_nodes:
                key = ("node", hexid)
                seen.add(key)
                self._observe(key, "node", DEAD, None, now, transitions)
            for hexid, age in node_ages.items():
                key = ("node", hexid)
                if key in seen:
                    continue
                seen.add(key)
                self._observe(key, "node",
                              classify(age, node_bounds[0], node_bounds[1]),
                              None, now, transitions)
            dead_hexes = set(dead_nodes)
            for (node_id, component, pid), ts, beacon in components:
                key = ("component", node_id, component, pid)
                seen.add(key)
                if node_id in dead_hexes:
                    state = DEAD  # its host is gone, whatever its last report
                else:
                    state = classify(now - ts, comp_bounds[0],
                                     comp_bounds[1])
                self._observe(key, "component", state, beacon, now,
                              transitions)
            # Subjects that vanished from this tick's inputs (evicted
            # report, removed node): their liveness record is gone — dead.
            for key, subj in list(self._subjects.items()):
                if key in seen:
                    continue
                if subj.state != DEAD:
                    self._observe(key, subj.kind, DEAD, subj.beacon_ts, now,
                                  transitions)
                elif now - subj.since > self._dead_retention_s:
                    self._subjects.pop(key)
                    self._pruned.append(key)
        for tr in transitions:
            self._emit(tr)
        return transitions

    def _observe(self, key: tuple, kind: str, state: str,
                 beacon: Optional[float], now: float,
                 transitions: List[dict]) -> None:
        subj = self._subjects.get(key)
        if subj is None:
            subj = self._subjects[key] = _Subject(key, kind)
        if beacon is not None:
            subj.beacon_ts = beacon
        if state != subj.state:
            transitions.append({"kind": kind, "key": key,
                                "old": subj.state, "new": state,
                                "time": now, "beacon_ts": subj.beacon_ts})
            subj.state = state
            subj.since = now

    def _emit(self, tr: dict) -> None:
        if self._on_transition is None:
            return
        try:
            self._on_transition(tr)
        except Exception:  # noqa: BLE001 — a sink must never kill the loop
            from ray_tpu_torch.utils.logging import get_logger, log_swallowed

            log_swallowed(get_logger("health"), "watchdog transition sink")

    # -- read side ------------------------------------------------------------

    def states(self) -> List[dict]:
        """Current classification of every tracked subject."""
        with self._lock:
            return [{"kind": s.kind, "key": list(s.key), "state": s.state,
                     "since": s.since, "beacon_ts": s.beacon_ts}
                    for s in self._subjects.values()]

    def export_gauge(self) -> None:
        """Mirror states into ``ray_tpu_component_health`` (called from the
        GCS metrics collector, so the gauge ships on the normal export
        tick). Only the active state's series exists per subject."""
        from ray_tpu_torch.core.metrics_export import gauge

        g = gauge("ray_tpu_component_health",
                  "Watchdog health classification per node/component "
                  "(1 on the subject's current state series)",
                  tag_keys=("kind", "subject_node", "subject", "state"))
        with self._lock:
            subjects = list(self._subjects.values())
            pruned, self._pruned = self._pruned, []
        for key in pruned:
            for state in STATES:
                g.remove(self._tags(key, state))
        for subj in subjects:
            for state in STATES:
                if state == subj.state:
                    g.set(1.0, self._tags(subj.key, state))
                else:
                    g.remove(self._tags(subj.key, state))

    @staticmethod
    def _tags(key: tuple, state: str) -> Dict[str, str]:
        # NOT node_id/component: the aggregator merges reporter-identity
        # labels of those names into every sample (identity wins), which
        # would rewrite the subject into "the GCS" on the exposition.
        if key[0] == "node":
            return {"kind": "node", "subject_node": str(key[1]),
                    "subject": "node_daemon", "state": state}
        return {"kind": "component", "subject_node": str(key[1]),
                "subject": f"{key[2]}:{key[3]}", "state": state}
