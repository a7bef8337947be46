"""User-defined metrics — Counter / Gauge / Histogram.

Counterpart of ``ray_tpu/util/metrics.py``, the in-process half: the
process-local registry, its collectors, the Prometheus text exposition and
the registry snapshot. The GCS side (``MetricsAggregator``,
``histogram_quantile``) comes with the core runtime, which the port does not
have yet; until then the series live in this process and are read here
(``Counter.get``, ``Histogram`` snapshots, :func:`prometheus_text`).
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
