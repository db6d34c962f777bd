"""Drivers of the port, and the telemetry scope both RGNN drivers run in."""
from __future__ import annotations

from repro_torch import obs

OBS_MODES = ("on", "off")


def obs_scope(obs_mode: str, trace_out=None):
    """The ``repro_torch.obs`` region a driver runs in: ``obs.disabled()``
    (yields ``None``) for ``"off"``; for ``"on"`` a scope with metrics, and
    with phase tracing when ``trace_out`` is given (yields the scope)."""
    if obs_mode not in OBS_MODES:
        raise ValueError(f"obs_mode {obs_mode!r}; pick one of {OBS_MODES}")
    if obs_mode == "off":
        return obs.disabled()
    return obs.scope(metrics=True, tracing=trace_out is not None)


def obs_report(sc, stats: dict, trace_out, metrics_out, log, tag: str):
    """Fold a driver's scope into its stats: the phase table (logged, and
    ``stats["phases"]``) and the Chrome trace at ``trace_out`` when
    tracing, the metrics snapshot as ``stats["metrics"]`` (exported to
    ``metrics_out`` when given). Nothing without a scope."""
    if sc is None:
        return
    if sc.tracer is not None:
        log(f"[{tag}] phase table:\n" + sc.tracer.phase_table())
        stats["phases"] = sc.tracer.phase_totals()
        sc.tracer.write(trace_out)
        log(f"[{tag}] chrome trace -> {trace_out}")
    stats["metrics"] = sc.registry.snapshot()
    if metrics_out:
        sc.registry.export(metrics_out)
        log(f"[{tag}] metrics snapshot -> {metrics_out}")
