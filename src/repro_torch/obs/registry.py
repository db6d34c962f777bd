"""Metrics registry: counters, gauges, and streaming histograms.

The port's own copy of ``repro.obs.registry`` (it imports nothing of the
reference): the same instruments, names, snapshot document and
deterministic reservoir, so a snapshot from the port reads like one from
``repro`` and the same stream of observations gives the same snapshot.

One handle — ``obs.metrics()`` — unifies the counters the stack keeps as
attributes (executor signature counts, device-sampler programs, tuner
measurement counts) plus the latency histograms the serving and training
drivers report from. Instruments are keyed by (name, labels): the same
``counter("executor_traces", executor="BlockExecutor")`` call from any
layer lands on the same object.

Design constraints (why this is not a prometheus client):

* **Zero overhead when disabled.** ``obs.metrics()`` returns the shared
  ``NULL_REGISTRY`` whose instruments are no-op singletons — disabled-mode
  instrumentation costs one attribute read and a call into a ``pass`` body.
  Nothing is ever recorded.
* **Event granularity is per batch / per cache access**, never per element
  or inside a kernel, so the enabled-mode cost is a dict lookup and an
  integer add on the host path, with no device synchronize.
* **Histograms are streaming** with exact count/sum/min/max and a bounded
  deterministic reservoir for percentiles (no wall-clock or global-RNG
  dependence, so runs are reproducible and tests can pin quantiles).
* **Registries merge**: a scoped registry (one ``serve()`` call) folds its
  instruments into the enclosing scope on exit, so an outer caller sees
  the union of every phase it ran while each call still gets exact local
  counts.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

_QUANTILES = (50.0, 90.0, 95.0, 99.0)


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default) over a sorted
    list. Empty input -> NaN; single sample -> that sample."""
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(sorted_vals[0])
    pos = (q / 100.0) * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_json(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_json(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "value": self.value}


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus a bounded
    reservoir for percentiles.

    Up to ``max_samples`` every observation is kept (percentiles are then
    exact); past that, a deterministic LCG drives classic reservoir
    sampling, keeping a uniform sample without touching the global RNG.
    """

    __slots__ = ("name", "labels", "max_samples", "count", "total",
                 "min", "max", "_samples", "_lcg")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 max_samples: int = 4096):
        self.name = name
        self.labels = labels
        self.max_samples = max_samples
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: List[float] = []
        self._lcg = 0x2545F491  # fixed seed: deterministic reservoir

    def _rand(self, n: int) -> int:
        # 32-bit LCG (numerical recipes constants); cheap and reproducible
        self._lcg = (1664525 * self._lcg + 1013904223) & 0xFFFFFFFF
        return self._lcg % n

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._samples) < self.max_samples:
            self._samples.append(v)
        else:
            j = self._rand(self.count)
            if j < self.max_samples:
                self._samples[j] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        return _percentile(sorted(self._samples), q)

    def summary(self) -> dict:
        s = sorted(self._samples)
        out = {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.min if self.count else float("nan"),
            "max": self.max if self.count else float("nan"),
        }
        for q in _QUANTILES:
            out[f"p{q:g}"] = _percentile(s, q)
        return out

    def to_json(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "summary": self.summary()}

    def _absorb(self, other: "Histogram") -> None:
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for v in other._samples:
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            else:
                j = self._rand(len(self._samples) + 1)
                if j < self.max_samples:
                    self._samples[j] = v


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create instrument store, thread-safe (the prefetch loader's
    producer thread and the driver thread share one registry)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[tuple, Counter] = {}
        self._gauges: Dict[tuple, Gauge] = {}
        self._histograms: Dict[tuple, Histogram] = {}

    # -- instrument accessors -------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(name, key[1]))
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(name, key[1]))
        return g

    def histogram(self, name: str, max_samples: int = 4096,
                  **labels) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    key, Histogram(name, key[1], max_samples=max_samples))
        return h

    # -- read side ------------------------------------------------------
    def value(self, name: str, **labels) -> Optional[float]:
        """Current value of a counter or gauge (None if never created) —
        the read path the CI gates use instead of reaching into component
        internals."""
        key = (name, _label_key(labels))
        if key in self._counters:
            return self._counters[key].value
        if key in self._gauges:
            return self._gauges[key].value
        return None

    def counter_total(self, name: str) -> int:
        """Sum of a counter across all label sets (0 if absent)."""
        return sum(c.value for (n, _), c in self._counters.items()
                   if n == name)

    def histogram_summary(self, name: str, **labels) -> Optional[dict]:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        return h.summary() if h is not None else None

    @property
    def num_instruments(self) -> int:
        return (len(self._counters) + len(self._gauges)
                + len(self._histograms))

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "schema_version": SCHEMA_VERSION,
                "counters": [c.to_json() for c in self._counters.values()],
                "gauges": [g.to_json() for g in self._gauges.values()],
                "histograms": [h.to_json()
                               for h in self._histograms.values()],
            }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)

    # -- scope merging --------------------------------------------------
    def absorb(self, child: "MetricsRegistry") -> None:
        """Fold a child scope's instruments into this registry: counters
        add, gauges take the child's last write, histograms merge."""
        with self._lock:
            for (name, lk), c in child._counters.items():
                mine = self._counters.setdefault((name, lk),
                                                 Counter(name, lk))
                mine.value += c.value
            for (name, lk), g in child._gauges.items():
                mine = self._gauges.setdefault((name, lk), Gauge(name, lk))
                mine.value = g.value
            for (name, lk), h in child._histograms.items():
                mine = self._histograms.setdefault(
                    (name, lk), Histogram(name, lk,
                                          max_samples=h.max_samples))
                mine._absorb(h)


# ---------------------------------------------------------------------------
# snapshot readers (for CI gates over exported/returned snapshots)
# ---------------------------------------------------------------------------
def snapshot_value(snap: dict, name: str, **labels) -> Optional[float]:
    """Value of a counter or gauge in a ``snapshot()`` document (None if
    absent) — how the benchmark gates read serve/train telemetry without
    reaching into component internals."""
    want = dict(_label_key(labels))
    for section in ("counters", "gauges"):
        for it in snap.get(section, ()):
            if it["name"] == name and it["labels"] == want:
                return it["value"]
    return None


def snapshot_counter_total(snap: dict, name: str) -> float:
    """Sum of a counter across all label sets in a snapshot (0 if absent)."""
    return sum(it["value"] for it in snap.get("counters", ())
               if it["name"] == name)


def snapshot_histogram(snap: dict, name: str, **labels) -> Optional[dict]:
    """Summary dict of a histogram in a snapshot (None if absent)."""
    want = dict(_label_key(labels))
    for it in snap.get("histograms", ()):
        if it["name"] == name and it["labels"] == want:
            return it["summary"]
    return None


def snapshot_histograms(snap: dict, name: str) -> List[dict]:
    """Every label set of one histogram name in a snapshot:
    ``[{"labels": {...}, "summary": {...}}, ...]``. The multi-tenant
    reader — per-tenant serving latency lands under the same name with a
    ``model=<tenant>`` label, and dashboards/CI enumerate the tenants
    from the snapshot instead of knowing them up front."""
    return [{"labels": it["labels"], "summary": it["summary"]}
            for it in snap.get("histograms", ()) if it["name"] == name]


# ---------------------------------------------------------------------------
# disabled mode: shared no-op singletons
# ---------------------------------------------------------------------------
class _NullCounter:
    __slots__ = ()
    name = "null"
    labels = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    name = "null"
    labels = ()
    value = 0.0

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    name = "null"
    labels = ()
    count = 0
    total = 0.0

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return float("nan")

    def summary(self) -> dict:
        return {"count": 0}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class NullRegistry:
    """The disabled-mode registry: every instrument is a shared no-op."""

    num_instruments = 0

    def counter(self, name: str, **labels) -> _NullCounter:
        return _NULL_COUNTER

    def gauge(self, name: str, **labels) -> _NullGauge:
        return _NULL_GAUGE

    def histogram(self, name: str, max_samples: int = 4096,
                  **labels) -> _NullHistogram:
        return _NULL_HISTOGRAM

    def value(self, name: str, **labels) -> None:
        return None

    def counter_total(self, name: str) -> int:
        return 0

    def histogram_summary(self, name: str, **labels) -> None:
        return None

    def snapshot(self) -> dict:
        return {"schema_version": SCHEMA_VERSION, "counters": [],
                "gauges": [], "histograms": []}

    def absorb(self, child) -> None:
        pass


NULL_REGISTRY = NullRegistry()
