"""Phase-attributed span tracer with Chrome-trace export.

The port's counterpart of ``repro.obs.tracing``. ``with obs.span("sample"):
...`` records a host-side wall-clock interval, attributed to the thread
that opened it — so the prefetch loader's ``sample``/``layout`` spans land
on their own track next to the driver thread's ``execute`` spans, and
``chrome://tracing`` / Perfetto render the overlap directly.

CUDA work is asynchronous, so a span around a launched computation
measures the launch only; spans that should cover device time must end at
an explicit sync point. ``Span.sync(x)`` synchronizes the device of every
CUDA tensor in ``x`` *inside* the span (and is a no-op passthrough on the
disabled-mode null span, so instrumented code behaves identically either
way)::

    with obs.span("execute") as sp:
        logits = executor(params, ...)
        sp.sync(logits)          # device time charged to the span

Spans never run inside a kernel — the tracer is pure host-side Python that
imports ``torch`` only inside ``sync`` — so enabling tracing cannot change
what runs or its signatures; only ``sync`` adds a device synchronize.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional


class Span:
    """One open interval. Context manager; reentrant use is not supported
    (open a new span instead)."""

    __slots__ = ("tracer", "name", "args", "t0", "_depth")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self._depth = 0

    def __enter__(self) -> "Span":
        self._depth = self.tracer._push(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.tracer._pop()
        self.tracer._record(self.name, self.t0, t1, self._depth, self.args)

    def sync(self, x):
        """Wait until ``x``'s device work is done, charging the wait to
        this span; returns ``x``. ``x`` is a tensor or a list, tuple or
        dict of them: every CUDA device among them is synchronized once;
        CPU tensors (and anything else) pass through."""
        import torch

        devices = []

        def visit(v):
            if isinstance(v, torch.Tensor):
                if v.is_cuda and v.device not in devices:
                    devices.append(v.device)
            elif isinstance(v, dict):
                for u in v.values():
                    visit(u)
            elif isinstance(v, (list, tuple)):
                for u in v:
                    visit(u)

        visit(x)
        for dev in devices:
            torch.cuda.synchronize(dev)
        return x


class _NullSpan:
    """Disabled-mode span: free to enter/exit, records nothing. ``sync``
    is a passthrough (no implicit device sync in disabled mode — callers
    that need the result synced already block on it themselves)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def sync(self, x):
        return x


NULL_SPAN = _NullSpan()


class SpanTracer:
    """Append-only span log, thread-safe, bounded.

    Timestamps are microseconds since the tracer's epoch (its creation),
    which is what the Chrome trace-event format expects. Completed spans
    are stored as flat dicts; nesting is implicit in the (ts, dur)
    intervals per thread track, exactly how Chrome renders them.
    """

    def __init__(self, max_events: int = 200_000):
        self.max_events = max_events
        self.dropped = 0
        self._epoch = time.perf_counter()
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}       # thread ident -> dense tid
        self._tid_names: Dict[int, str] = {}  # dense tid -> thread name

    # -- span lifecycle (called by Span) --------------------------------
    def span(self, name: str, **args) -> Span:
        return Span(self, name, args)

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, name: str) -> int:
        st = self._stack()
        st.append(name)
        return len(st) - 1

    def _pop(self) -> None:
        st = self._stack()
        if st:
            st.pop()

    def _tid(self) -> int:
        t = threading.current_thread()
        tid = self._tids.get(t.ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(t.ident, len(self._tids))
                self._tid_names[tid] = t.name
        return tid

    def _record(self, name: str, t0: float, t1: float, depth: int,
                args: dict) -> None:
        ev = {
            "name": name,
            "ts": (t0 - self._epoch) * 1e6,
            "dur": (t1 - t0) * 1e6,
            "tid": self._tid(),
            "depth": depth,
            "args": args,
        }
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # -- read side ------------------------------------------------------
    @property
    def num_events(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self, name: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        return evs

    def phase_totals(self) -> Dict[str, dict]:
        """Aggregate wall time per span name: {name: {count, total_s,
        mean_s, max_s}}. Nested spans each count their own interval."""
        out: Dict[str, dict] = {}
        for e in self.events():
            d = out.setdefault(e["name"], {"count": 0, "total_s": 0.0,
                                           "max_s": 0.0})
            d["count"] += 1
            dur_s = e["dur"] / 1e6
            d["total_s"] += dur_s
            d["max_s"] = max(d["max_s"], dur_s)
        for d in out.values():
            d["mean_s"] = d["total_s"] / d["count"]
        return out

    def phase_table(self) -> str:
        """Fixed-width per-phase time table (the human-readable summary
        the drivers print next to the Chrome trace)."""
        totals = sorted(self.phase_totals().items(),
                        key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'phase':<16} {'count':>6} {'total ms':>10} "
                 f"{'mean ms':>9} {'max ms':>9}"]
        for name, d in totals:
            lines.append(
                f"{name:<16} {d['count']:>6} {d['total_s'] * 1e3:>10.2f} "
                f"{d['mean_s'] * 1e3:>9.3f} {d['max_s'] * 1e3:>9.3f}")
        return "\n".join(lines)

    # -- Chrome trace-event export --------------------------------------
    def chrome_trace(self) -> dict:
        """Trace-event-format document: complete ("X") events per span
        plus thread_name metadata, loadable in chrome://tracing and
        Perfetto."""
        events = []
        with self._lock:
            tid_names = dict(self._tid_names)
            spans = list(self._events)
        for tid, name in sorted(tid_names.items()):
            events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": name},
            })
        for e in spans:
            events.append({
                "name": e["name"], "ph": "X", "cat": "phase", "pid": 0,
                "tid": e["tid"], "ts": e["ts"], "dur": e["dur"],
                "args": dict(e["args"], depth=e["depth"]),
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    # -- scope merging --------------------------------------------------
    def absorb(self, child: "SpanTracer") -> None:
        """Fold a child scope's spans into this tracer, re-basing their
        timestamps onto this tracer's epoch (thread tracks are re-mapped
        by the child's recorded thread names)."""
        shift = (child._epoch - self._epoch) * 1e6
        with child._lock:
            child_events = list(child._events)
            child_names = dict(child._tid_names)
        with self._lock:
            remap: Dict[int, int] = {}
            for ctid, cname in child_names.items():
                # reuse an existing track with the same thread name
                ntid = next((tid for tid, name in self._tid_names.items()
                             if name == cname), None)
                if ntid is None:
                    ntid = (max(self._tid_names) + 1) if self._tid_names \
                        else 0
                    self._tid_names[ntid] = cname
                remap[ctid] = ntid
            for e in child_events:
                if len(self._events) >= self.max_events:
                    self.dropped += 1
                    continue
                e2 = dict(e)
                e2["ts"] = e["ts"] + shift
                e2["tid"] = remap.get(e["tid"], e["tid"])
                self._events.append(e2)
        self.dropped += child.dropped
