"""Measured validation of serving bucket ladders (the port's copy of
``repro.tune.ladder``: the same surviving rungs from the same timings).

The serving coalescer admits request batches into shape-bucket "rungs"
(padded seed counts). Finer-than-pow2 rungs cut pad waste only if the
executor actually runs faster at the finer size — on some backends a
48-seed batch costs the same as 64 (identical downstream pow2 block
buckets), and then the extra rung just buys more compilations. That is a
measured question, so it is answered on the tuner's own harness:
``measure_group`` times every rung's compiled execute interleaved
(round-robin, min-of-iters), and a non-pow2 rung survives only if it
beats the next pow2 rung by ``min_gain``.

The measurements double as the latency calibration the coalescer's
admission control runs on, so validation costs nothing extra.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.kernels.layout import pow2ceil
from repro_torch.tune.tuner import measure_group


@dataclasses.dataclass
class LadderReport:
    """Outcome of ``validate_ladder``: the surviving rungs, per-rung
    measured milliseconds, and which non-pow2 rungs were dropped."""

    rungs: List[int]
    measured_ms: Dict[int, float]
    dropped: List[int]

    def describe(self) -> str:
        rows = [f"  rung {r:>4}: {self.measured_ms[r]:8.3f} ms"
                + ("  [dropped]" if r in self.dropped else "")
                for r in sorted(self.measured_ms)]
        return "ladder validation:\n" + "\n".join(rows)


def validate_ladder(
    rungs: Sequence[int],
    prepare: Callable[[int], Tuple[Callable, tuple]],
    *,
    warmup: int = 1,
    iters: int = 3,
    min_gain: float = 0.03,
    device="cpu",
) -> LadderReport:
    """Measure every rung and drop non-pow2 rungs that don't pay.

    ``prepare(rung) -> (fn, args)`` must return a ready-to-run execute of
    one batch at that rung size (the serving runtime passes its compiled
    block forward over a representative sampled batch). All rungs are
    timed with one interleaved ``measure_group`` call so machine drift
    lands on every rung alike. A non-pow2 rung is kept only when its
    measured time undercuts the next pow2 rung by at least ``min_gain``
    (fractional); pow2 rungs are always kept — they are the shape set the
    executor compiles for anyway.

    ``device`` is the engine's: every timed call ends in its synchronize.
    Each rung runs at least twice before the timed iterations (``warmup``
    is raised to 1): on a card its executor key's first call runs op by
    op and its second captures the CUDA graph, so what is timed is the
    replay traffic gets.
    """
    rungs = sorted(set(int(r) for r in rungs))
    if not rungs:
        raise ValueError("empty ladder")
    calls = [prepare(r) for r in rungs]
    times = measure_group(calls, device=device, warmup=max(1, warmup),
                          iters=iters)
    measured = {r: t * 1e3 for r, t in zip(rungs, times)}

    kept, dropped = [], []
    for r in rungs:
        if r & (r - 1) == 0:        # pow2: always kept
            kept.append(r)
            continue
        cover = pow2ceil(r)
        cover_ms = measured.get(cover)
        if cover_ms is None or measured[r] <= cover_ms * (1.0 - min_gain):
            kept.append(r)
        else:
            dropped.append(r)
    return LadderReport(rungs=kept, measured_ms=measured, dropped=dropped)
