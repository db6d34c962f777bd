"""``repro_torch.obs`` — the port's observability layer, as ``repro.obs``.

Three layers, one switchboard:

* **metrics** (``registry.py``): counters / gauges / streaming histograms
  with p50/p90/p99, labeled, JSON-exportable — ``obs.metrics()`` is the one
  handle every component reports through.
* **tracing** (``tracing.py``): nested ``with obs.span("sample")`` phase
  spans with host wall clock and explicit device sync points, exported as
  a Chrome-trace JSON plus per-phase time tables.
* **profiling** (``profile.py``, imported lazily): per-op plan timing on
  the tuner's measurement harness — ``CompiledRGNN.profile()`` and the
  drivers' ``--profile`` flag.

The switchboard is **off by default and zero-overhead when off**: every
``obs.span(...)`` returns a shared no-op span and ``obs.metrics()`` the
shared null registry, so instrumented library code costs one attribute
read per event. Nothing here runs inside a kernel, and only a traced
span's ``sync`` synchronizes the device: enabling or disabling
observability cannot change results, signatures or, with tracing off, the
synchronizes a loop makes.

Drivers opt in with a scope::

    with obs.scope(metrics=True, tracing=True) as sc:
        ...serve loop...
        sc.tracer.write("trace.json")
        sc.registry.export("metrics.json")

Scopes nest; on exit a scope folds its counters/histograms/spans into the
enclosing enabled scope (so an outer caller sees the union of every run's
metrics while each ``serve()`` call keeps exact local counts).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, NULL_REGISTRY,
                                      SCHEMA_VERSION)
from repro_torch.obs.tracing import NULL_SPAN, Span, SpanTracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanTracer",
    "Span", "SCHEMA_VERSION", "metrics", "tracer", "span", "scope",
    "metrics_enabled", "tracing_enabled", "enabled", "disabled",
]


class ObsState:
    """One activation frame: which layers are on, and their sinks."""

    __slots__ = ("metrics_on", "tracing_on", "registry", "tracer", "parent")

    def __init__(self, metrics_on: bool = False, tracing_on: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 parent: Optional["ObsState"] = None):
        self.metrics_on = metrics_on
        self.tracing_on = tracing_on
        self.registry = registry
        self.tracer = tracer
        self.parent = parent


# process-global (NOT thread-local): the prefetch loader's producer thread
# must observe the scope the driver thread opened
_ROOT = ObsState()
_current = _ROOT


def metrics_enabled() -> bool:
    return _current.metrics_on


def tracing_enabled() -> bool:
    return _current.tracing_on


def enabled() -> bool:
    return _current.metrics_on or _current.tracing_on


def metrics():
    """The active metrics registry, or the shared no-op null registry when
    metrics are disabled. Always safe to call from any layer."""
    st = _current
    return st.registry if st.metrics_on else NULL_REGISTRY


def tracer() -> Optional[SpanTracer]:
    """The active span tracer (None when tracing is disabled)."""
    st = _current
    return st.tracer if st.tracing_on else None


def span(name: str, **args):
    """A phase span context manager; the shared no-op span when tracing is
    disabled (one attribute read, no allocation)."""
    st = _current
    if not st.tracing_on:
        return NULL_SPAN
    return st.tracer.span(name, **args)


@contextlib.contextmanager
def scope(metrics: bool = True, tracing: bool = False,
          max_events: int = 200_000) -> Iterator[ObsState]:
    """Activate observability for a ``with`` region.

    A fresh registry/tracer is installed (the previous state is restored on
    exit); on exit, recorded metrics and spans are folded into the
    enclosing scope if one is active, so nested scopes compose
    bottom-up.
    """
    global _current
    st = ObsState(
        metrics_on=metrics,
        tracing_on=tracing,
        registry=MetricsRegistry() if metrics else None,
        tracer=SpanTracer(max_events=max_events) if tracing else None,
        parent=_current,
    )
    _current = st
    try:
        yield st
    finally:
        _current = st.parent
        parent = st.parent
        if st.registry is not None and parent.metrics_on:
            parent.registry.absorb(st.registry)
        if st.tracer is not None and parent.tracing_on:
            parent.tracer.absorb(st.tracer)


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Force-disable observability for a region (used by tests and by
    overhead baselines: guarantees the null fast paths are taken)."""
    global _current
    prev = _current
    _current = ObsState(parent=prev)
    try:
        yield
    finally:
        _current = prev
