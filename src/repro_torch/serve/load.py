"""Open-loop load generation for the serving runtime (the port's copy of
``repro.serve.load``: the same schedule for the same arguments).

An *open-loop* generator decides request arrival times independently of
how fast the server completes them — the production traffic model, and the
one under which tail latency means anything (a closed loop silently
self-throttles when the server slows down, hiding queueing collapse).

``OpenLoopLoad`` is a pure function of its seed: it materializes a list of
``Request`` objects with

* **arrival offsets** drawn from a seeded arrival process — ``poisson``
  (exponential inter-arrival gaps at ``rate_rps``), ``burst`` (groups of
  ``burst_size`` back-to-back requests, bursts Poisson-spaced at the same
  average rate), or ``uniform`` (fixed gaps);
* **seed-node ids** drawn through the existing ``sampling.SeedStream`` —
  so the Zipf-skew machinery (``zipf_alpha``) and the id-space permutation
  that serving benchmarks already rely on apply unchanged to request
  traffic;
* **request sizes** (seeds per request) drawn from ``size_choices``; and
* **per-request deadlines** (``slo_ms`` — a scalar or per-request choices)
  that the coalescer's admission control honors.

Replaying the same ``OpenLoopLoad`` therefore submits bit-identical
request content on every run; only wall-clock service times differ.
``replay()`` walks the schedule in real time (sleeping out the gaps) and
pushes each request into a runtime's ``submit`` — KeyboardInterrupt-safe,
so Ctrl-C mid-replay stops submission and lets the caller drain.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.sampling import SeedStream

# terminal request states (set by the runtime, reported by stats())
OK = "ok"                          # completed within its deadline
LATE = "late"                      # completed, but past its deadline
REJECTED_DEADLINE = "rejected_deadline"  # admission: could not make SLO
REJECTED_OVERLOAD = "rejected_overload"  # admission queue full
REJECTED_SHUTDOWN = "rejected_shutdown"  # queued at close(), not served
TERMINAL_STATUSES = (OK, LATE, REJECTED_DEADLINE, REJECTED_OVERLOAD,
                     REJECTED_SHUTDOWN)


@dataclasses.dataclass
class Request:
    """One inference request: classify ``seeds`` within ``slo_ms`` of
    arrival. ``arrival_s`` is the scheduled offset from stream start;
    ``t_arrive`` is stamped (monotonic clock) when the runtime admits the
    request into its queue, and every deadline computation runs off it."""

    rid: int
    seeds: np.ndarray
    arrival_s: float
    slo_ms: float
    model: Optional[str] = None     # tenant route (None: single-model)
    t_arrive: Optional[float] = None

    @property
    def num_seeds(self) -> int:
        return int(self.seeds.shape[0])

    def deadline(self) -> float:
        """Absolute monotonic-clock deadline (requires ``t_arrive``)."""
        return self.t_arrive + self.slo_ms * 1e-3


@dataclasses.dataclass
class Response:
    """Terminal record for one request."""

    rid: int
    status: str
    logits: Optional[np.ndarray]    # [num_seeds, classes] or None
    latency_ms: float               # arrival -> completion (0 for rejects)
    queue_ms: float                 # arrival -> batch admission
    rung: Optional[int] = None      # shape bucket the request was served in
    model: Optional[str] = None

    @property
    def completed(self) -> bool:
        return self.status in (OK, LATE)


class OpenLoopLoad:
    """Seeded open-loop request schedule over a ``SeedStream``.

    ``requests()`` returns the full schedule (a pure function of the
    constructor arguments); ``replay(submit)`` walks it in real time.

    ``rate_rps`` is the *average* arrival rate for every process kind.
    ``size_choices`` gives the per-request seed counts (drawn uniformly,
    per-request rng); ``slo_ms`` is one budget for all requests or a
    sequence of choices drawn the same way. ``models`` routes requests
    round-robin across tenant names (multi-model tenancy traffic).
    """

    def __init__(self, num_nodes: int, *, rate_rps: float = 100.0,
                 num_requests: int = 64, process: str = "poisson",
                 burst_size: int = 4,
                 size_choices: Sequence[int] = (1, 2, 4, 8),
                 slo_ms: Union[float, Sequence[float]] = 50.0,
                 zipf_alpha: Optional[float] = None,
                 models: Optional[Sequence[str]] = None, seed: int = 0):
        if rate_rps <= 0:
            raise ValueError("rate_rps must be positive")
        if process not in ("poisson", "burst", "uniform"):
            raise ValueError(f"process={process!r}; "
                             f"pick poisson/burst/uniform")
        if burst_size < 1:
            raise ValueError("burst_size must be >= 1")
        self.num_nodes = int(num_nodes)
        self.rate_rps = float(rate_rps)
        self.num_requests = int(num_requests)
        self.process = process
        self.burst_size = int(burst_size)
        self.size_choices = tuple(int(s) for s in size_choices)
        if any(s < 1 for s in self.size_choices):
            raise ValueError("request sizes must be >= 1")
        self.slo_choices = (tuple(float(s) for s in slo_ms)
                            if isinstance(slo_ms, (tuple, list, np.ndarray))
                            else (float(slo_ms),))
        self.models = tuple(models) if models else None
        self.seed = int(seed)
        # seed ids ride the existing stream machinery (Zipf skew included);
        # batch_size = max request size, each request takes a prefix
        self._stream = SeedStream(self.num_nodes,
                                  batch_size=max(self.size_choices),
                                  seed=self.seed, zipf_alpha=zipf_alpha)

    # ------------------------------------------------------------------
    def _arrivals(self) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 0xA881))
        n = self.num_requests
        if self.process == "uniform":
            return np.arange(n, dtype=np.float64) / self.rate_rps
        if self.process == "poisson":
            return np.cumsum(rng.exponential(1.0 / self.rate_rps, size=n))
        # burst: groups arrive back-to-back; burst starts are Poisson at
        # rate rate_rps / burst_size so the average rate is preserved
        starts = np.cumsum(rng.exponential(
            self.burst_size / self.rate_rps,
            size=-(-n // self.burst_size)))
        return np.repeat(starts, self.burst_size)[:n]

    def requests(self) -> List[Request]:
        """The full schedule, deterministic in the constructor args."""
        arrivals = self._arrivals()
        out: List[Request] = []
        for rid in range(self.num_requests):
            rng = np.random.default_rng((self.seed, 0x5120, rid))
            size = int(self.size_choices[rng.integers(
                len(self.size_choices))])
            slo = float(self.slo_choices[rng.integers(
                len(self.slo_choices))])
            seeds = self._stream.batch(rid)[:size]
            model = (self.models[rid % len(self.models)]
                     if self.models else None)
            out.append(Request(rid=rid, seeds=seeds,
                               arrival_s=float(arrivals[rid]),
                               slo_ms=slo, model=model))
        return out

    # ------------------------------------------------------------------
    def replay(self, submit: Callable[[Request], object],
               requests: Optional[List[Request]] = None,
               speedup: float = 1.0) -> int:
        """Submit the schedule in real time (open loop: never waits on
        completions). ``speedup`` > 1 compresses the schedule. Returns the
        number of requests submitted; stops early (without raising) on
        KeyboardInterrupt so the caller can drain what is in flight."""
        if requests is None:
            requests = self.requests()
        t0 = time.monotonic()
        submitted = 0
        try:
            for req in requests:
                delay = t0 + req.arrival_s / speedup - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                submit(req)
                submitted += 1
        except KeyboardInterrupt:
            pass
        return submitted
