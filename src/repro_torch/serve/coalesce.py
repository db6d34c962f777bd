"""Deadline-aware batch coalescing over a measured shape-bucket ladder (the
port's copy of ``repro.serve.coalesce``: the same rungs, estimates and
decisions for the same inputs).

Serving traffic arrives as small requests (1-16 seeds); the compiled
executors amortize best over larger batches. The coalescer holds queued
requests just long enough to merge them into the **largest ladder rung
whose measured execute latency still meets the tightest deadline in the
batch** — the classic latency/throughput trade, but made explicit against
per-rung measurements instead of a fixed timeout.

Three pieces:

* ``ladder(...)`` builds the rung set. ``pow2`` is the shape-bucket set
  serving already compiles for; ``fine`` interleaves ``3 * 2^k`` rungs
  (1, 2, 3, 4, 6, 8, 12, ...) halving the worst-case pad waste. Whether a
  finer rung *pays for itself* is a measured question — padding a
  37-request batch to 48 instead of 64 only helps if the 48-rung actually
  executes faster — so ``repro_torch.tune.ladder.validate_ladder`` times every
  rung with the tuner's interleaved ``measure_group`` harness and drops
  non-pow2 rungs that don't beat the next pow2 rung.
* ``LatencyModel``: per-rung execute-latency estimates — seeded by the
  calibration measurements, tracked online as a peak-decaying EWMA so the
  admission decision follows the machine it is running on.
* ``Coalescer.plan(...)``: one admission decision over the pending queue.
  Expired requests (deadline unmeetable even at the smallest rung) are
  rejected immediately — never silently served late — and the decision to
  *wait* for more arrivals is taken only while the tightest in-queue
  deadline retains slack beyond the coalesce window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.layout import pow2ceil
from repro_torch.serve.load import Request


def ladder(max_batch: int, kind: str = "fine") -> List[int]:
    """Rung sizes (ascending). ``pow2``: 1, 2, 4, ..., max_batch.
    ``fine`` adds the 3*2^k midpoints: 1, 2, 3, 4, 6, 8, 12, 16, ...
    ``max_batch`` is rounded up to a power of two (the top rung)."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    if kind not in ("pow2", "fine"):
        raise ValueError(f"ladder kind={kind!r}; pick pow2/fine")
    top = pow2ceil(max_batch)
    rungs = {1 << k for k in range(top.bit_length())}
    if kind == "fine":
        rungs.update(3 << k for k in range(top.bit_length())
                     if 3 << k <= top)
    return sorted(rungs)


class LatencyModel:
    """Per-rung execute-latency estimates (milliseconds).

    ``calibrate(rung, ms)`` installs a measured baseline (the ladder
    validation / warmup pass); ``observe(rung, ms)`` folds in live
    samples with an EWMA whose estimate decays *down* slowly but jumps
    *up* immediately (admission errs toward rejecting what it cannot
    serve, not toward promising latencies it once saw on a cold cache).
    ``estimate`` for an unmeasured rung falls back to the nearest
    measured rung above it (conservative), then below."""

    def __init__(self, alpha: float = 0.25, headroom: float = 1.1):
        if not 0 < alpha <= 1:
            raise ValueError("alpha in (0, 1] required")
        self.alpha = alpha
        self.headroom = headroom
        self._ewma: Dict[int, float] = {}
        self.samples = 0

    def calibrate(self, rung: int, ms: float) -> None:
        self._ewma[int(rung)] = float(ms)

    def observe(self, rung: int, ms: float) -> None:
        rung = int(rung)
        self.samples += 1
        prev = self._ewma.get(rung)
        if prev is None or ms > prev:
            self._ewma[rung] = float(ms)     # jump up immediately
        else:
            self._ewma[rung] = prev + self.alpha * (ms - prev)

    def known(self) -> Dict[int, float]:
        return dict(self._ewma)

    def estimate(self, rung: int) -> Optional[float]:
        """Headroom-padded latency estimate for ``rung`` (None if nothing
        is measured yet — admission then treats every rung as feasible,
        the only option before calibration)."""
        if not self._ewma:
            return None
        rung = int(rung)
        v = self._ewma.get(rung)
        if v is None:
            above = [r for r in self._ewma if r >= rung]
            v = (self._ewma[min(above)] if above
                 else self._ewma[max(self._ewma)])
        return v * self.headroom


@dataclasses.dataclass
class PlannedBatch:
    """One admitted batch: the member requests, the rung it executes at,
    and the padded seed vector (member seeds concatenated in arrival
    order, padded with repeats of the first seed — inert rows that are
    never sliced back out)."""

    step: int
    rung: int
    requests: List[Request]
    seeds: np.ndarray
    t_admit: float

    @property
    def slices(self) -> List[Tuple[int, int]]:
        """Per-request [lo, hi) row ranges into the executed batch."""
        out, lo = [], 0
        for r in self.requests:
            out.append((lo, lo + r.num_seeds))
            lo += r.num_seeds
        return out


@dataclasses.dataclass
class PlanDecision:
    """Outcome of one ``Coalescer.plan`` call."""

    batch: Optional[PlannedBatch]      # admit this now (None: nothing yet)
    rejects: List[Request]             # deadline-unmeetable, reject NOW
    wait_s: float                      # if no batch: how long to hold


class Coalescer:
    """Admission control: pending requests -> (batch | wait | rejects).

    ``max_wait_ms`` bounds how long the oldest pending request may be
    held for coalescing; the deadline-aware part is that waiting is also
    cut short whenever the tightest pending deadline's slack (beyond the
    estimated execute latency) runs out.
    """

    def __init__(self, rungs: Sequence[int], latency: LatencyModel,
                 *, max_wait_ms: float = 5.0, slack_margin_ms: float = 0.5):
        self.rungs = sorted(int(r) for r in rungs)
        if not self.rungs or self.rungs[0] < 1:
            raise ValueError("need a non-empty ladder of positive rungs")
        self.latency = latency
        self.max_wait_ms = float(max_wait_ms)
        self.slack_margin_ms = float(slack_margin_ms)
        self._step = 0

    @property
    def max_rung(self) -> int:
        return self.rungs[-1]

    def covering_rung(self, num_seeds: int) -> int:
        """Smallest rung holding ``num_seeds`` (the executed bucket)."""
        for r in self.rungs:
            if r >= num_seeds:
                return r
        raise ValueError(f"{num_seeds} seeds exceed the top rung "
                         f"{self.max_rung}")

    # ------------------------------------------------------------------
    def plan(self, pending: List[Request], now: float,
             drain: bool = False) -> PlanDecision:
        """One admission decision. ``pending`` is mutated: admitted and
        rejected requests are removed (arrival order is preserved for the
        remainder). ``drain`` disables waiting — shutdown admits whatever
        is feasible immediately.

        Every request in ``pending`` must be stamped (``t_arrive``)."""
        rejects: List[Request] = []
        min_est = self.latency.estimate(self.rungs[0])
        # 1) reject what can no longer make its deadline even alone at the
        #    smallest rung — an expired request must never ride along and
        #    be silently served late
        keep = []
        for r in pending:
            slack_ms = (r.deadline() - now) * 1e3
            if slack_ms <= 0 or (min_est is not None
                                 and slack_ms < min_est):
                rejects.append(r)
            else:
                keep.append(r)
        pending[:] = keep
        if not pending:
            return PlanDecision(None, rejects, self.max_wait_ms * 1e-3)

        # 2) the largest rung whose estimated latency fits the tightest
        #    in-queue deadline
        tightest_ms = min((r.deadline() - now) * 1e3 for r in pending)
        budget_ms = tightest_ms - self.slack_margin_ms
        feasible = [r for r in self.rungs
                    if (est := self.latency.estimate(r)) is None
                    or est <= budget_ms]
        r_max = max(feasible) if feasible else self.rungs[0]

        # 3) fill it in arrival order
        batch: List[Request] = []
        used = 0
        for r in pending:
            if used + r.num_seeds > r_max:
                break
            batch.append(r)
            used += r.num_seeds

        total = sum(r.num_seeds for r in pending)
        oldest = pending[0]
        waited_ms = (now - oldest.t_arrive) * 1e3
        if (not drain and used < r_max and total < r_max
                and waited_ms < self.max_wait_ms
                and budget_ms - self.max_wait_ms > (
                    self.latency.estimate(r_max) or 0.0)):
            # the largest feasible rung is not full, more arrivals may
            # still make it, and the tightest deadline can afford the wait
            wait_s = min(self.max_wait_ms - waited_ms,
                         self.max_wait_ms) * 1e-3
            return PlanDecision(None, rejects, max(wait_s, 1e-4))

        if not batch:
            # head request alone exceeds every feasible rung (a huge
            # request under a tight deadline): serve it at its covering
            # rung rather than starving it — completion marks it late if
            # the estimate was right
            batch = [pending[0]]
            used = pending[0].num_seeds
        del pending[:len(batch)]
        rung = self.covering_rung(used)
        seeds = np.concatenate([r.seeds for r in batch])
        if seeds.shape[0] < rung:   # pad rows are never sliced back out
            seeds = np.concatenate([
                seeds, np.full(rung - seeds.shape[0], seeds[0],
                               dtype=seeds.dtype)])
        pb = PlannedBatch(step=self._step, rung=rung, requests=batch,
                          seeds=seeds.astype(np.int32), t_admit=now)
        self._step += 1
        return PlanDecision(pb, rejects, 0.0)
