"""User-defined metrics — Counter / Gauge / Histogram.

Counterpart of ``ray_tpu/util/metrics.py``: the process-local registry, its
collectors, the Prometheus text exposition and the registry snapshot, and
the GCS side: the runtime's exporter thread
(``ray_tpu_torch.core.metrics_export``) ships :func:`snapshot_registry` to
its GCS, whose :class:`MetricsAggregator` keeps one series store per (node,
component, pid) with staleness eviction and renders the merged exposition.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: List["Metric"] = []

# Collector hooks: callables invoked right before a registry snapshot so
# ad-hoc stats dicts (rpc send counters, store occupancy, collective byte
# counters) can be mirrored into Gauges without touching their hot paths.
_collectors: List[Callable[[], None]] = []


def register_collector(fn: Callable[[], None]) -> Callable[[], None]:
    """Register ``fn`` to run before every registry snapshot; returns an
    unregister callable."""
    with _registry_lock:
        _collectors.append(fn)

    def unregister() -> None:
        with _registry_lock:
            try:
                _collectors.remove(fn)
            except ValueError:
                pass

    return unregister


def run_collectors() -> None:
    with _registry_lock:
        fns = list(_collectors)
    for fn in fns:
        try:
            fn()
        except Exception:  # noqa: BLE001 — telemetry must never break work
            from ray_tpu_torch.utils.logging import get_logger, log_swallowed

            log_swallowed(get_logger("metrics"), "registry collector")


class Metric:
    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = ()):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)

    @property
    def name(self) -> str:
        return self._name

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        unknown = set(tags) - set(self._tag_keys)
        if unknown:
            raise ValueError(f"tags {unknown} not in tag_keys {self._tag_keys}")
        self._default_tags = dict(tags)
        return self

    def _tag_tuple(self, tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
        merged = {**self._default_tags, **(tags or {})}
        unknown = set(merged) - set(self._tag_keys)
        if unknown:
            raise ValueError(f"tags {unknown} not in tag_keys {self._tag_keys}")
        return tuple(sorted(merged.items()))

    def tag_key(self, tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
        """Precompute a validated tag key for the ``*_key`` hot-path
        variants: callers observing the same tag set repeatedly (built-in
        framework instrumentation) pay the merge/validate/sort once instead
        of per observation."""
        return self._tag_tuple(tags)

    def _prom_lines(self) -> List[str]:  # pragma: no cover - overridden
        return []

    def _snapshot(self) -> dict:  # pragma: no cover - overridden
        return {}


class Counter(Metric):
    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc requires value > 0")
        with self._lock:
            self._values[self._tag_tuple(tags)] += value

    def inc_key(self, value: float, key: Tuple[Tuple[str, str], ...]):
        """``inc`` with a key precomputed by :meth:`Metric.tag_key`."""
        with self._lock:
            self._values[key] += value

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(self._tag_tuple(tags), 0.0)

    def _prom_lines(self):
        out = [f"# TYPE {self._name} counter"]
        with self._lock:
            for tags, v in self._values.items():
                out.append(f"{self._name}{_fmt_tags(tags)} {v}")
        return out

    def _snapshot(self) -> dict:
        with self._lock:
            samples = list(self._values.items())
        return {"name": self._name, "type": "counter",
                "desc": self._description, "samples": samples}


class Gauge(Metric):
    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._tag_tuple(tags)] = float(value)

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(self._tag_tuple(tags), 0.0)

    def remove(self, tags: Optional[Dict[str, str]] = None) -> None:
        """Drop one tagged series (a gauge for a retired subject — e.g. a
        pruned dead component — must disappear, not freeze at its last
        value)."""
        with self._lock:
            self._values.pop(self._tag_tuple(tags), None)

    def _prom_lines(self):
        out = [f"# TYPE {self._name} gauge"]
        with self._lock:
            for tags, v in self._values.items():
                out.append(f"{self._name}{_fmt_tags(tags)} {v}")
        return out

    def _snapshot(self) -> dict:
        with self._lock:
            samples = list(self._values.items())
        return {"name": self._name, "type": "gauge",
                "desc": self._description, "samples": samples}


class Histogram(Metric):
    def __init__(self, name, description="", boundaries: Sequence[float] = (), tag_keys=()):
        # Validate BEFORE registering: a raising __init__ after
        # super().__init__ would leave a half-constructed metric in the
        # process registry, poisoning every later snapshot/exposition.
        if not boundaries or list(boundaries) != sorted(boundaries):
            raise ValueError("boundaries must be a sorted non-empty sequence")
        super().__init__(name, description, tag_keys)
        self._bounds = list(boundaries)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = defaultdict(float)
        self._totals: Dict[Tuple, int] = defaultdict(int)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        self.observe_key(value, self._tag_tuple(tags))

    def observe_key(self, value: float, key: Tuple[Tuple[str, str], ...]):
        """``observe`` with a key precomputed by :meth:`Metric.tag_key`."""
        with self._lock:
            buckets = self._counts.setdefault(key, [0] * (len(self._bounds) + 1))
            # bisect_left: first bound >= value — matches the ``value <= b``
            # bucketing in O(log n) instead of a linear scan per observation
            # (values above every bound land in the +Inf bucket at index -1).
            buckets[bisect.bisect_left(self._bounds, value)] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def _prom_lines(self):
        out = [f"# TYPE {self._name} histogram"]
        with self._lock:
            for key, buckets in self._counts.items():
                cum = 0
                for i, b in enumerate(self._bounds):
                    cum += buckets[i]
                    tags = key + (("le", str(b)),)
                    out.append(f"{self._name}_bucket{_fmt_tags(tags)} {cum}")
                cum += buckets[-1]
                out.append(f"{self._name}_bucket{_fmt_tags(key + (('le', '+Inf'),))} {cum}")
                out.append(f"{self._name}_sum{_fmt_tags(key)} {self._sums[key]}")
                out.append(f"{self._name}_count{_fmt_tags(key)} {self._totals[key]}")
        return out

    def _snapshot(self) -> dict:
        with self._lock:
            samples = [(key, (list(buckets), self._sums[key],
                              self._totals[key]))
                       for key, buckets in self._counts.items()]
        return {"name": self._name, "type": "histogram",
                "desc": self._description, "bounds": list(self._bounds),
                "samples": samples}


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline must be escaped inside the quoted label value."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(tags: Tuple[Tuple[str, str], ...]) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in tags)
    return "{" + inner + "}"


def prometheus_text() -> str:
    """Prometheus exposition of every registered metric (the scrape body the
    reference's agent serves)."""
    with _registry_lock:
        metrics = list(_registry)
    lines: List[str] = []
    for m in metrics:
        lines.extend(m._prom_lines())
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_registry() -> List[dict]:
    """Serializable snapshot of every registered metric — the per-tick
    payload a process's metrics exporter ships to the GCS."""
    run_collectors()
    with _registry_lock:
        metrics = list(_registry)
    return [m._snapshot() for m in metrics]


# ---------------------------------------------------------------------------
# Cluster-wide aggregation (the GCS side of the metrics pipeline)
# ---------------------------------------------------------------------------


def _render_samples(name: str, mtype: str, samples, bounds,
                    extra: Tuple[Tuple[str, str], ...]) -> List[str]:
    """Exposition lines for one process's samples of one metric, with the
    per-process identity labels (``node_id``/``component``/``pid``) merged
    into each sample's tags (identity labels win on collision)."""
    out: List[str] = []
    for tags, val in samples:
        merged = dict(tags)
        merged.update(extra)
        key = tuple(sorted(merged.items()))
        if mtype == "histogram":
            buckets, total_sum, total_count = val
            cum = 0
            for i, b in enumerate(bounds or []):
                cum += buckets[i]
                out.append(f"{name}_bucket"
                           f"{_fmt_tags(key + (('le', str(b)),))} {cum}")
            cum += buckets[-1] if buckets else 0
            out.append(f"{name}_bucket{_fmt_tags(key + (('le', '+Inf'),))} "
                       f"{cum}")
            out.append(f"{name}_sum{_fmt_tags(key)} {total_sum}")
            out.append(f"{name}_count{_fmt_tags(key)} {total_count}")
        else:
            out.append(f"{name}{_fmt_tags(key)} {val}")
    return out


class MetricsAggregator:
    """Per-(node, component, pid) series store with staleness eviction.

    Every process's exporter reports a full registry snapshot each tick;
    the newest snapshot per process wins. Reports not refreshed within the
    staleness window (a dead worker, a drained node) are evicted so the
    merged exposition only shows live processes — the reference gets the
    same effect from Prometheus dropping stale scrape targets.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (node_id, component, pid) -> (report_time, snapshot)
        self._reports: Dict[Tuple[str, str, int], Tuple[float, List[dict]]] = {}

    @staticmethod
    def _staleness_s() -> float:
        from ray_tpu_torch.core.config import config

        interval = config().metrics_export_interval_s
        # Three missed exports = dead; floor keeps short test intervals from
        # evicting a process that is merely between ticks.
        return max(5.0, 3.0 * interval)

    def report(self, node_id: str, component: str, pid: int,
               snapshot: List[dict], now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        horizon = now - self._staleness_s()
        with self._lock:
            self._reports[(str(node_id), str(component), int(pid))] = (
                now, list(snapshot))
            # Evict on write too: a cluster nobody scrapes must not
            # accumulate dead-process snapshots until the read path runs.
            for key in [k for k, (ts, _) in self._reports.items()
                        if ts < horizon]:
                self._reports.pop(key, None)

    def _live(self, now: Optional[float] = None) -> List[Tuple[Tuple, float, List[dict]]]:
        now = now if now is not None else time.time()
        horizon = now - self._staleness_s()
        with self._lock:
            for key in [k for k, (ts, _) in self._reports.items()
                        if ts < horizon]:
                self._reports.pop(key, None)
            return [(k, ts, snap) for k, (ts, snap)
                    in sorted(self._reports.items())]

    _BEACON_METRIC = "ray_tpu_flightrec_last_write_ts"

    def process_meta(self) -> List[Tuple[Tuple, float, Optional[float]]]:
        """``[(key, report_ts, beacon_ts)]`` for every report STILL HELD —
        including stale ones (no eviction on this read): the health
        watchdog needs the last report time of a wedged process to age it
        into ``stalled``/``dead``, which the evicting ``_live`` read would
        erase. ``beacon_ts`` is the process's flight-recorder progress
        beacon (last ring-write wall ts), None if it ships none."""
        with self._lock:
            items = list(self._reports.items())
        out: List[Tuple[Tuple, float, Optional[float]]] = []
        for key, (ts, snap) in items:
            beacon = None
            for m in snap:
                if m.get("name") == self._BEACON_METRIC:
                    for _tags, value in m.get("samples", ()):
                        beacon = max(beacon or 0.0, float(value))
            out.append((key, ts, beacon))
        return out

    def prometheus_text(self, now: Optional[float] = None) -> str:
        """Merged cluster-wide exposition: every live process's series,
        labeled with ``node_id``/``component``/``pid``."""
        live = self._live(now)
        # name -> (type, [lines]) — one TYPE header per metric name.
        by_name: Dict[str, Tuple[str, List[str]]] = {}
        order: List[str] = []
        for (node_id, component, pid), _ts, snap in live:
            extra = (("node_id", node_id), ("component", component),
                     ("pid", str(pid)))
            for m in snap:
                name = m.get("name")
                if not name:
                    continue
                ent = by_name.get(name)
                if ent is None:
                    ent = (m["type"], [])
                    by_name[name] = ent
                    order.append(name)
                elif ent[0] != m["type"]:
                    continue  # type skew across versions: keep first seen
                ent[1].extend(_render_samples(name, m["type"], m["samples"],
                                              m.get("bounds"), extra))
        lines: List[str] = []
        for name in order:
            mtype, series = by_name[name]
            lines.append(f"# TYPE {name} {mtype}")
            lines.extend(series)
        return "\n".join(lines) + ("\n" if lines else "")

    def histogram_merged(self, name: str,
                         tags: Optional[Dict[str, str]] = None,
                         now: Optional[float] = None) -> Optional[dict]:
        """One cluster-merged cumulative histogram: bucket counts summed
        across every live process's samples of ``name`` whose tags contain
        ``tags`` as a subset (e.g. ``{"deployment": "LM", "phase":
        "total"}`` merges that deployment's series across all replicas).
        The controller's SLO loop reads TTFT through this instead of
        parsing the full exposition. None when no live sample matches;
        snapshots whose bounds disagree with the first seen (version skew)
        are skipped."""
        bounds: Optional[List[float]] = None
        buckets: List[int] = []
        total_sum = 0.0
        total_count = 0
        want = dict(tags or {})
        for _key, _ts, snap in self._live(now):
            for m in snap:
                if m.get("name") != name or m.get("type") != "histogram":
                    continue
                b = list(m.get("bounds") or ())
                if bounds is None:
                    bounds = b
                    buckets = [0] * (len(bounds) + 1)
                elif b != bounds:
                    continue
                for sample_tags, val in m.get("samples", ()):
                    st = dict(sample_tags)
                    if any(st.get(k) != v for k, v in want.items()):
                        continue
                    counts, s, c = val
                    for i, n in enumerate(counts[:len(buckets)]):
                        buckets[i] += n
                    total_sum += s
                    total_count += c
        if bounds is None or total_count == 0:
            return None
        return {"bounds": bounds, "buckets": buckets, "sum": total_sum,
                "count": total_count}

    def summary(self, now: Optional[float] = None) -> Dict[str, Any]:
        """JSON rollup for the dashboard UI: live processes + per-metric
        series counts and cluster-wide totals."""
        now = now if now is not None else time.time()
        live = self._live(now)
        processes = []
        metrics: Dict[str, Dict[str, Any]] = {}
        for (node_id, component, pid), ts, snap in live:
            processes.append({"node_id": node_id, "component": component,
                              "pid": pid, "age_s": round(now - ts, 3),
                              "metrics": len(snap)})
            for m in snap:
                name = m.get("name")
                if not name:
                    continue
                ent = metrics.setdefault(
                    name, {"name": name, "type": m["type"], "series": 0,
                           "total": 0.0})
                ent["series"] += len(m["samples"])
                for _tags, val in m["samples"]:
                    if m["type"] == "histogram":
                        ent["total"] += val[2]  # observation count
                    else:
                        ent["total"] += val
        return {"processes": processes,
                "metrics": sorted(metrics.values(), key=lambda e: e["name"])}


def histogram_quantile(q: float, bounds: Sequence[float],
                       buckets: Sequence[int]) -> Optional[float]:
    """Approximate quantile from histogram buckets (Prometheus
    ``histogram_quantile`` semantics): find the bucket holding the q-th
    observation, interpolate linearly inside it. Observations past the last
    bound (the +Inf bucket) clamp to the last finite bound — a lower bound
    on the true quantile, which is the safe direction for an SLO check
    (never understates load less than reality... it understates, so pair a
    +Inf-heavy histogram with wider bounds). None when empty."""
    total = sum(buckets)
    if total <= 0 or not bounds:
        return None
    rank = q * total
    cum = 0.0
    for i, count in enumerate(buckets):
        if count <= 0:
            continue
        if cum + count >= rank:
            if i >= len(bounds):  # +Inf bucket
                return float(bounds[-1])
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - cum) / count
            return float(lo + (hi - lo) * min(1.0, max(0.0, frac)))
        cum += count
    return float(bounds[-1])
