"""Schema validation for the observability JSON artifacts.

The port's own copy of ``repro.obs.schema``: hand-rolled structural checks
(no jsonschema dependency) for the two documents the obs layer exports,
which each package's validators accept from the other:

* **Chrome trace** (``SpanTracer.write``): trace-event format — a
  ``traceEvents`` list of ``"M"`` thread-name metadata and ``"X"`` complete
  events with numeric ``ts``/``dur`` in microseconds.
* **Metrics snapshot** (``MetricsRegistry.export``): the
  ``schema_version``-stamped counters/gauges/histograms document.

``validate_*`` return a list of problem strings (empty = valid) so a gate
can print every violation at once instead of failing on the first.
"""
from __future__ import annotations

from typing import List

from repro_torch.obs.registry import SCHEMA_VERSION


def _is_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_trace(doc) -> List[str]:
    """Structural check of a Chrome trace-event document."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"trace root must be an object, got {type(doc).__name__}"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["trace must carry a 'traceEvents' list"]
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M"):
            errs.append(f"{where}: unexpected phase type ph={ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errs.append(f"{where}: missing/empty 'name'")
        for field in ("pid", "tid"):
            if not _is_num(e.get(field)):
                errs.append(f"{where}: '{field}' must be numeric")
        if ph == "X":
            for field in ("ts", "dur"):
                if not _is_num(e.get(field)):
                    errs.append(f"{where}: 'X' event needs numeric "
                                f"'{field}'")
                elif e[field] < 0:
                    errs.append(f"{where}: '{field}' must be >= 0")
    return errs


def validate_metrics(doc) -> List[str]:
    """Structural check of a ``MetricsRegistry.snapshot()`` document."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"metrics root must be an object, got {type(doc).__name__}"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        errs.append(f"schema_version must be {SCHEMA_VERSION}, "
                    f"got {doc.get('schema_version')!r}")
    for section in ("counters", "gauges", "histograms"):
        items = doc.get(section)
        if not isinstance(items, list):
            errs.append(f"'{section}' must be a list")
            continue
        for i, it in enumerate(items):
            where = f"{section}[{i}]"
            if not isinstance(it, dict):
                errs.append(f"{where}: not an object")
                continue
            if not isinstance(it.get("name"), str) or not it["name"]:
                errs.append(f"{where}: missing/empty 'name'")
            if not isinstance(it.get("labels"), dict):
                errs.append(f"{where}: 'labels' must be an object")
            if section == "counters" and not _is_num(it.get("value")):
                errs.append(f"{where}: counter 'value' must be numeric")
            if section == "gauges" and not _is_num(it.get("value")):
                errs.append(f"{where}: gauge 'value' must be numeric")
            if section == "histograms":
                s = it.get("summary")
                if not isinstance(s, dict):
                    errs.append(f"{where}: histogram needs a 'summary' "
                                f"object")
                    continue
                for field in ("count", "min", "max", "mean",
                              "p50", "p90", "p95", "p99"):
                    if not _is_num(s.get(field)):
                        errs.append(f"{where}: summary '{field}' must be "
                                    f"numeric")
    return errs


def require_phases(doc, phases) -> List[str]:
    """Check that every name in ``phases`` appears as at least one 'X'
    span with dur > 0 (a missing or zero-length pipeline phase means the
    instrumentation regressed)."""
    errs: List[str] = []
    evs = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    for phase in phases:
        spans = [e for e in evs if isinstance(e, dict)
                 and e.get("ph") == "X" and e.get("name") == phase]
        if not spans:
            errs.append(f"required phase span {phase!r} missing from trace")
        elif not any(e.get("dur", 0) > 0 for e in spans):
            errs.append(f"phase span {phase!r} present but all zero-length")
    return errs
