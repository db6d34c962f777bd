"""The online serving runtime of the port: an async request pipeline over
the captured executors (``repro.serve.runtime``'s counterpart).

One ``ServingRuntime`` turns a compiled engine (``hector_torch.compile()``
/ ``RGNNEngine``) into a deadline-aware online server::

    submit(Request) -> [admission queue] -> coalescer thread
        -> PlannedBatch -> [plan queue] -> MiniBatchLoader producer
            (sample + layout + feature gather, prefetch-overlapped)
        -> device-ready MiniBatch -> execute thread (block forward)
        -> per-request Response (OK / LATE / REJECTED_*)

The three stages run concurrently for *different* batches: while batch k
executes, the loader's producer samples and gathers batch k+1, and the
coalescer accumulates batch k+2 from fresh arrivals. Queues are bounded
everywhere, so a slow stage exerts backpressure. Admission is the
``coalesce.Coalescer``: requests merge into the largest ladder rung whose
measured latency still meets the tightest in-batch deadline; expired
requests are rejected, never silently served late.

Where the port differs from the reference, and why:

* **One thread owns the executor.** On a card the block executor captures
  a key's CUDA graph at its second call, and an executor captures on one
  thread only (``core.executor``). So the runtime's execute thread is
  started by ``calibrate()`` (or ``start()``), and every forward of the
  engine runs on it: calibration's ladder timings and warm rounds (the
  caller waits for them; ``calibrate()`` still comes before ``start()``)
  and then every traffic batch. A key first seen in traffic is captured
  there too, on the same thread.
* **Warm means captured.** ``calibrate()`` repeats its warm rounds until a
  round adds neither a key nor a graph: every rung's shape set is keyed
  and captured before traffic. ``stats()["retraces_after_warmup"]`` keeps
  the reference's meaning (keys first seen after ``mark_warm``);
  ``captures_after_warmup`` counts the graphs captured after it.
* **Latency ends on the host.** A batch's execute time runs from its
  dispatch to its logits on the host (``Response.logits`` is NumPy; the
  copy back synchronizes), never around an unsynchronized launch.
* **One writer for the feature store.** ``calibrate()`` gathers rows
  before ``start()``; during traffic the loader's producer (the execute
  thread itself with ``sampler="device"``) is the store's only caller.

Shutdown (``close()``) is a graceful drain: no new requests are accepted,
queued requests are admitted or rejected with ``REJECTED_SHUTDOWN``,
in-flight batches complete, and every worker thread is joined.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.sampling.bucketing import ShapeFloors
from repro_torch.sampling.loader import SourceNotReady, build_minibatch
from repro_torch.serve.coalesce import (Coalescer, LatencyModel,
                                        PlannedBatch, ladder)
from repro_torch.serve.load import (LATE, OK, REJECTED_DEADLINE,
                                    REJECTED_OVERLOAD, REJECTED_SHUTDOWN,
                                    Request, Response)

# calibration batches sample with step indices far outside real traffic so
# they never collide with the request stream's (seed, batch_index) keying
_CAL_STEP_BASE = 1 << 30
_PROBE_BASE = 1 << 20    # floor-probe builds use their own index range


class _Handle:
    """Per-request completion handle: ``wait()`` blocks for the terminal
    ``Response`` (set exactly once by the runtime)."""

    __slots__ = ("_event", "response")

    def __init__(self):
        self._event = threading.Event()
        self.response: Optional[Response] = None

    def _complete(self, resp: Response) -> None:
        self.response = resp
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> Optional[Response]:
        self._event.wait(timeout)
        return self.response

    @property
    def done(self) -> bool:
        return self._event.is_set()


class _Job:
    """One function given to an ``_Owner``: ``done`` is set once it ran,
    with its ``result`` or its ``error``."""

    __slots__ = ("fn", "done", "result", "error")

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Owner:
    """One thread that runs the functions given to it, in order: the
    thread every forward of one engine runs on."""

    def __init__(self, name: str):
        self._jobs: "queue.Queue" = queue.Queue()
        self._running = False
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name=name)

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                job.result = job.fn()
            except BaseException as e:  # noqa: BLE001 - handed to the caller
                job.error = e
            job.done.set()

    def submit(self, fn) -> _Job:
        """Queue ``fn`` (starting the thread at the first one)."""
        if not self._running:
            self._running = True
            self.thread.start()
        job = _Job(fn)
        self._jobs.put(job)
        return job

    def call(self, fn):
        """Run ``fn`` on the thread; its result, or its exception raised
        here."""
        job = self.submit(fn)
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def stop(self, timeout: float) -> None:
        if self._running:
            self._jobs.put(None)
            self.thread.join(timeout=timeout)


class ServingRuntime:
    """Deadline-aware online server over one compiled engine.

    ``engine`` is a ``CompiledRGNN`` or ``RGNNEngine``; ``store`` a
    ``repro_torch.feats`` store (feature rows then ride the loader's
    prefetch) or the raw device feature table. ``rungs`` is the
    coalescer's shape-bucket ladder (default: the fine ladder up to
    ``max_batch``); run ``calibrate()`` before ``start()`` to measure it.

    Metrics land in the ambient ``obs`` scope labeled by tenant
    (``model=<name>``): ``serve_request_ms`` / ``serve_queue_ms`` /
    ``serve_execute_ms`` histograms, ``serve_requests`` (by status) and
    ``serve_deadline_miss`` counters, ``serve_queue_depth`` gauge +
    histogram, and per-rung ``serve_batches`` counters. Spans:
    ``coalesce`` per admitted batch, ``execute_async`` per executed batch
    (both on their worker threads' tracks).
    """

    def __init__(self, engine, params, store=None, *,
                 name: Optional[str] = None,
                 rungs: Optional[Sequence[int]] = None,
                 max_batch: int = 32,
                 max_wait_ms: float = 5.0,
                 queue_limit: int = 256,
                 depth: int = 2,
                 cache_blocks: int = 0,
                 cache_layouts: int = 64,
                 latency_headroom: float = 1.25,
                 now_fn: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.params = params
        if store is None:
            raise ValueError(
                "ServingRuntime needs features: pass store= (a "
                "repro_torch.feats store, rides the loader's prefetch) or "
                "the raw device feature table")
        self.store = store
        self.name = name or engine.cfg.model_name
        self.latency = LatencyModel(headroom=latency_headroom)
        self.coalescer = Coalescer(
            rungs if rungs is not None else ladder(max_batch, "fine"),
            self.latency, max_wait_ms=max_wait_ms)
        self.queue_limit = int(queue_limit)
        self._now = now_fn

        self._lock = threading.Condition()
        self._pending: List[Request] = []
        self._handles = {}                    # rid -> _Handle
        self._inflight = 0                    # submitted, not yet terminal
        self._plan_q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._by_step = {}                    # loader step -> PlannedBatch
        self.responses: List[Response] = []   # completion order

        self._closing = False
        self._closed = threading.Event()
        self._started = False
        self._stopping = False                # unblocks the seed callable
        self._close_lock = threading.Lock()

        self._device_sampler = getattr(engine, "device_sampler", None)
        # grow-only per-rung bucket floors: one ladder rung converges to
        # one keyed shape set (host sampler path; the device sampler
        # brings its own bucket hysteresis)
        self.shape_floors = (ShapeFloors() if self._device_sampler is None
                             else None)
        # only a real store can ride the loader's producer-side gather; a
        # raw feature table goes straight to the executor instead
        loader_store = store if hasattr(store, "gather") else None
        self._loader = engine.make_loader(
            self._planned_seeds, num_batches=None, depth=depth,
            cache_blocks=cache_blocks, cache_layouts=cache_layouts,
            feature_store=loader_store, shape_floors=self.shape_floors)
        self._coalesce_thread = threading.Thread(
            target=self._coalesce_loop, daemon=True,
            name=f"serve-coalesce-{self.name}")
        # the execute thread: every forward of the engine runs on it
        self._owner = _Owner(f"serve-exec-{self.name}")
        self._exec_job: Optional[_Job] = None

        # warmup bookkeeping for the zero-retrace steady-state contract
        self._warm_traces: Optional[int] = None
        self._warm_captures: Optional[int] = None
        self._hubs: Optional[np.ndarray] = None
        self._exec_failure: Optional[BaseException] = None
        # local aggregates (exact even when obs is disabled)
        self._lat_ms: List[float] = []
        self._queue_ms: List[float] = []
        self._exec_ms: List[float] = []
        self._depth_seen: List[int] = []
        self._rung_counts = {}
        self._batches = 0
        self._padded_seeds = 0
        self._real_seeds = 0
        self.ladder_report = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def _exec_thread(self) -> threading.Thread:
        return self._owner.thread

    def start(self) -> "ServingRuntime":
        if self._started:
            return self
        self._started = True
        self._coalesce_thread.start()
        self._exec_job = self._owner.submit(self._exec_loop)
        return self

    def __enter__(self) -> "ServingRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def mark_warm(self) -> None:
        """Snapshot the executor's key and graph counts: keys first seen
        after this point count as steady-state retraces in ``stats()``,
        graphs captured after it as ``captures_after_warmup``."""
        ex = self.engine.block_executor
        self._warm_traces = ex.trace_count
        self._warm_captures = ex.captures

    # ------------------------------------------------------------------
    # calibration: measure the ladder, warm the keyed shape set
    # ------------------------------------------------------------------
    def _hub_seeds(self) -> np.ndarray:
        """Node ids ranked by capped sampled-neighborhood size — the seeds
        that produce the *largest* block shapes. Fanout sampling takes up
        to ``fanout`` in-neighbors per (node, etype), so a node's worst-case
        frontier contribution is its per-etype in-degree capped at the
        fanout, summed; probing floors with the top-ranked nodes pins the
        heavy tail (hub seeds) that random probes miss."""
        if self._hubs is None:
            g = self.engine.graph
            fan = max((int(x) for f in self.engine.cfg.fanouts
                       for x in np.atleast_1d(f)), default=3)
            if fan < 0:     # full-neighborhood sampling: no cap
                fan = np.iinfo(np.int64).max
            key = (np.asarray(g.dst, np.int64) * g.num_etypes
                   + np.asarray(g.etype, np.int64))
            uniq, cnt = np.unique(key, return_counts=True)
            score = np.zeros(g.num_nodes, np.int64)
            np.add.at(score, uniq // g.num_etypes, np.minimum(cnt, fan))
            self._hubs = np.argsort(-score).astype(np.int32)
        return self._hubs

    def _calibration_mb(self, rung: int, index: int, hubs: bool = False):
        """A representative device-ready batch of ``rung`` seeds (built
        through the same sampler / layout config the loader uses, so the
        keys it warms are the ones traffic hits). ``hubs`` draws the
        highest-degree seeds instead of random ones — the adversarial
        shape probe."""
        cfg = self.engine.cfg
        if hubs:
            # consecutive top-of-ranking windows: probe 0 takes the worst
            # hubs, later probes the next tiers
            ranked = self._hub_seeds()
            lo = min((index % 16) * rung, max(0, ranked.size - rung))
            seeds = ranked[lo:lo + rung]
            if seeds.size < rung:
                seeds = np.concatenate(
                    [seeds, ranked[:rung - seeds.size]])
        else:
            seeds = np.random.default_rng(
                (cfg.seed, 0xCA11B, rung, index)).integers(
                0, self.engine.graph.num_nodes, rung).astype(np.int32)
        step = _CAL_STEP_BASE + index
        dev = self._device_sampler
        if dev is not None:
            return dev.settle(dev.sample_minibatch(seeds, batch_index=step,
                                                   step=step))
        seq = self.engine.sampler.sample(seeds, batch_index=step)
        return build_minibatch(seq, step=step, tile=cfg.tile,
                               node_block=cfg.node_block, bucket=cfg.bucket,
                               shape_floors=self.shape_floors,
                               device=self.engine.device)

    def _forward_to_host(self, mb) -> np.ndarray:
        """One forward of ``mb``, its rows gathered through the store per
        call (never a loader-attached copy), ended by the copy of its
        logits to the host."""
        out = self.engine.forward_minibatch(
            self.params, dataclasses.replace(mb, feats=None), self.store)
        return out.cpu().numpy()

    def calibrate(self, *, batches_per_rung: int = 2, validate: bool = True,
                  min_gain: float = 0.03, iters: int = 3,
                  probe_batches: int = 16, floor_margin: int = 1,
                  warm_rounds: int = 6, log=None) -> None:
        """Measure every ladder rung with the tuner's interleaved
        ``measure_group`` harness (``tune.ladder.validate_ladder``); seed
        the coalescer's latency model with the measurements; optionally
        drop non-pow2 rungs that don't beat their covering pow2 rung
        (``validate=True``); and mark the executor warm — calibration keys
        and captures every surviving rung's shape set up front.

        Shape stability comes first: ``probe_batches`` sampled batches per
        rung grow the loader's ``ShapeFloors`` (host-only builds, nothing
        executes), then the floors get ``floor_margin`` buckets of
        headroom; with the device sampler they settle its bucket guesses
        instead (hub seeds first, each batch's counts read back). Then the ladder is timed (each rung's key run op by op,
        captured, then replayed for the timings), and ``warm_rounds``
        rounds of fresh batches per rung run until a round adds neither a
        key nor a captured graph.

        Must run before ``start()``. It runs on the runtime's execute
        thread, the thread that will serve traffic (the caller waits)."""
        if self._started:
            raise RuntimeError("calibrate() before start()")
        self._owner.call(lambda: self._calibrate(
            batches_per_rung, validate, min_gain, iters, probe_batches,
            floor_margin, warm_rounds, log))

    def _calibrate(self, batches_per_rung, validate, min_gain, iters,
                   probe_batches, floor_margin, warm_rounds, log) -> None:
        from repro_torch.tune.ladder import validate_ladder

        if self.shape_floors is not None:
            for i in range(probe_batches):
                for rung in self.coalescer.rungs:
                    # random probes cover typical traffic; hub probes pin
                    # the heavy tail; i // 2 keeps the hub window index
                    # starting at 0, so the top of the ranking is probed
                    self._calibration_mb(rung, _PROBE_BASE + i // 2,
                                         hubs=i % 2 == 1)
            self.shape_floors.bump(floor_margin)
            self.shape_floors.growths = 0   # probing is not traffic
        elif self._device_sampler is not None:
            # the device sampler tightens each bucket signature once, from
            # the first counts it reads back (with a pow2 step of
            # headroom), and falls back to its worst case on an overflow:
            # hub probes first, each read back at once, so every signature
            # tightens from the heaviest batches, then random probes
            for i in range(probe_batches):
                for rung in self.coalescer.rungs:
                    self._calibration_mb(rung, _PROBE_BASE + i // 2,
                                         hubs=i % 2 == 0)
                    self._device_sampler.drain(block=True)

        def prepare(rung: int):
            mbs = [self._calibration_mb(rung, i)
                   for i in range(batches_per_rung)]
            it = {"i": 0}

            def fn():
                mb = mbs[it["i"] % len(mbs)]
                it["i"] += 1
                return self._forward_to_host(mb)
            return (fn, ())

        report = validate_ladder(self.coalescer.rungs, prepare, iters=iters,
                                 min_gain=min_gain,
                                 device=self.engine.device)
        self.ladder_report = report
        for rung, ms in report.measured_ms.items():
            self.latency.calibrate(rung, ms)
        if validate:
            self.coalescer.rungs = report.rungs
        if log is not None:
            log(f"[serve-runtime:{self.name}] " + report.describe()
                + (f"\n  -> ladder {self.coalescer.rungs}"))

        # shape-set warmup: sampled batches at one rung can land on
        # different pow2 block buckets, and a key first met mid-traffic
        # runs op by op and is captured at its next call (a latency spike
        # each) — keep executing fresh batches per surviving rung until a
        # round adds neither a key nor a graph
        ex = self.engine.block_executor
        for rnd in range(max(0, warm_rounds)):
            before = (ex.trace_count, ex.captures)
            for i, rung in enumerate(self.coalescer.rungs):
                self._forward_to_host(self._calibration_mb(
                    rung, batches_per_rung + rnd * len(self.coalescer.rungs)
                    + i))
            if (ex.trace_count, ex.captures) == before:
                break
        if log is not None:
            log(f"[serve-runtime:{self.name}] warm: {ex.trace_count} keyed "
                f"shape sets, {ex.captures} captured graphs")
        self.mark_warm()

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> _Handle:
        """Admit ``req`` into the queue (stamping its arrival time).
        Returns a completion handle; rejections resolve it immediately."""
        handle = _Handle()
        req.t_arrive = self._now()
        if req.num_seeds > self.coalescer.max_rung:
            raise ValueError(
                f"request {req.rid}: {req.num_seeds} seeds exceed the top "
                f"ladder rung {self.coalescer.max_rung}")
        if not self._started and not self._closing:
            self.start()
        with self._lock:
            if self._closing:
                self._finish(req, handle, REJECTED_SHUTDOWN)
                return handle
            if len(self._pending) >= self.queue_limit:
                self._finish(req, handle, REJECTED_OVERLOAD)
                return handle
            self._handles[req.rid] = handle
            self._pending.append(req)
            self._inflight += 1
            self._observe_depth(len(self._pending))
            self._lock.notify_all()
        return handle

    def _observe_depth(self, depth: int) -> None:
        self._depth_seen.append(depth)
        m = obs.metrics()
        m.gauge("serve_queue_depth", model=self.name).set(depth)
        m.histogram("serve_queue_depth_hist", model=self.name).observe(depth)

    def _finish(self, req: Request, handle: Optional[_Handle],
                status: str, logits: Optional[np.ndarray] = None,
                rung: Optional[int] = None,
                t_admit: Optional[float] = None) -> Response:
        """Resolve one request to its terminal status (any thread)."""
        now = self._now()
        lat_ms = (now - req.t_arrive) * 1e3 if status in (OK, LATE) else 0.0
        q_ms = ((t_admit - req.t_arrive) * 1e3
                if t_admit is not None else 0.0)
        resp = Response(rid=req.rid, status=status, logits=logits,
                        latency_ms=lat_ms, queue_ms=q_ms, rung=rung,
                        model=self.name)
        m = obs.metrics()
        m.counter("serve_requests", model=self.name, status=status).inc()
        if status in (LATE, REJECTED_DEADLINE):
            m.counter("serve_deadline_miss", model=self.name).inc()
        if status in (OK, LATE):
            m.histogram("serve_request_ms", model=self.name).observe(lat_ms)
            m.histogram("serve_queue_ms", model=self.name).observe(q_ms)
            self._lat_ms.append(lat_ms)
            self._queue_ms.append(q_ms)
        with self._lock:
            self.responses.append(resp)
            h = self._handles.pop(req.rid, None)
            if h is not None:       # was registered (i.e. counted in-flight)
                self._inflight -= 1
            self._lock.notify_all()
        (h or handle)._complete(resp)
        return resp

    # ------------------------------------------------------------------
    # coalescer thread
    # ------------------------------------------------------------------
    def _coalesce_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closing:
                    self._lock.wait(timeout=0.2)
                if self._closing and not self._pending:
                    break
                with obs.span("coalesce", pending=len(self._pending)):
                    decision = self.coalescer.plan(
                        self._pending, self._now(), drain=self._closing)
                if decision.batch is not None:
                    self._observe_depth(len(self._pending))
            for req in decision.rejects:
                self._finish(req, None, REJECTED_DEADLINE)
            if decision.batch is not None:
                self._enqueue_plan(decision.batch)
            elif decision.wait_s > 0 and not self._closing:
                time.sleep(min(decision.wait_s, 0.05))
        while True:              # end-of-stream for the loader producer
            try:
                self._plan_q.put(None, timeout=0.5)
                break
            except queue.Full:
                if not self._exec_alive():
                    break        # close() force-stops the loader instead

    def _exec_alive(self) -> bool:
        return self._exec_job is not None and not self._exec_job.done.is_set()

    def _enqueue_plan(self, pb: PlannedBatch) -> None:
        m = obs.metrics()
        m.counter("serve_batches", model=self.name, rung=pb.rung).inc()
        real = sum(r.num_seeds for r in pb.requests)
        m.histogram("serve_batch_fill", model=self.name).observe(
            real / pb.rung)
        while True:
            try:
                self._plan_q.put(pb, timeout=0.5)
                return
            except queue.Full:
                if not self._exec_alive():
                    # executor died: fail the batch's requests instead of
                    # spinning forever against a queue nobody drains
                    for req in pb.requests:
                        self._finish(req, None, REJECTED_SHUTDOWN)
                    return

    # ------------------------------------------------------------------
    # loader seed source (the loader's producer thread; with the device
    # sampler, the execute thread)
    # ------------------------------------------------------------------
    def _planned_seeds(self, step: int):
        if self._device_sampler is not None and self._loader.pending:
            # a batch is ready to run: dispatch the next one only if its
            # plan is already here, never wait for it
            try:
                pb = self._plan_q.get_nowait()
            except queue.Empty:
                raise SourceNotReady from None
        else:
            while True:
                try:
                    pb = self._plan_q.get(timeout=0.2)
                    break
                except queue.Empty:
                    if self._stopping:
                        return None
        if pb is None:
            return None              # drain: loader ends its stream
        self._by_step[step] = pb
        return pb.seeds

    # ------------------------------------------------------------------
    # execute loop (the execute thread)
    # ------------------------------------------------------------------
    def _exec_loop(self) -> None:
        try:
            for mb in self._loader:
                pb = self._by_step.pop(mb.step)
                t0 = self._now()
                with obs.span("execute_async", step=mb.step, rung=pb.rung):
                    logits = self.engine.forward_minibatch(
                        self.params, mb, self.store)
                    rows = logits.cpu().numpy()    # synchronizes
                t1 = self._now()
                exec_ms = (t1 - t0) * 1e3
                # the promise admission makes is admit -> completion: feed
                # that (not just device time) back into the latency model
                self.latency.observe(pb.rung, (t1 - pb.t_admit) * 1e3)
                self._exec_ms.append(exec_ms)
                obs.metrics().histogram(
                    "serve_execute_ms", model=self.name).observe(exec_ms)
                self._batches += 1
                self._rung_counts[pb.rung] = \
                    self._rung_counts.get(pb.rung, 0) + 1
                real = sum(r.num_seeds for r in pb.requests)
                self._real_seeds += real
                self._padded_seeds += pb.rung
                for req, (lo, hi) in zip(pb.requests, pb.slices):
                    status = OK if t1 <= req.deadline() else LATE
                    self._finish(req, None, status, logits=rows[lo:hi],
                                 rung=pb.rung, t_admit=pb.t_admit)
        except BaseException as e:  # noqa: BLE001 - recorded, re-raised in close
            self._exec_failure = e
        finally:
            # resolve anything still mapped to a batch (the loader died
            # before executing it)
            for pb in list(self._by_step.values()):
                for req in pb.requests:
                    if req.rid in self._handles:
                        self._finish(req, None, REJECTED_SHUTDOWN)
            self._by_step.clear()

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        """Graceful drain: stop accepting, serve or reject everything
        queued, join every worker thread. Idempotent; also the SIGINT
        path (``with runtime:`` calls it on any exception, Ctrl-C
        included)."""
        with self._close_lock:
            if self._closed.is_set():
                return
            with self._lock:
                self._closing = True
                self._lock.notify_all()
            if self._started:
                self._coalesce_thread.join(timeout=timeout)
                self._exec_job.done.wait(timeout=timeout)
            else:
                # never started: nothing consumes the plan queue; reject
                # whatever was queued so handles always resolve
                with self._lock:
                    pending, self._pending = self._pending, []
                for req in pending:
                    self._finish(req, None, REJECTED_SHUTDOWN)
            self._stopping = True
            self._loader.close()
            self._owner.stop(timeout)
            self._closed.set()
        if self._exec_failure is not None:
            raise self._exec_failure

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        """Block until every submitted request reached a terminal state
        (without closing — the runtime keeps serving afterwards)."""
        deadline = None if timeout is None else self._now() + timeout
        with self._lock:
            while self._inflight > 0:
                rem = None if deadline is None else deadline - self._now()
                if rem is not None and rem <= 0:
                    raise TimeoutError(
                        f"{self._inflight} requests still in flight")
                if self._started and not self._exec_alive() \
                        and self._exec_failure is not None:
                    raise self._exec_failure
                self._lock.wait(timeout=0.1 if rem is None
                                else min(rem, 0.1))

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def worker_threads(self) -> List[threading.Thread]:
        """Every thread this runtime (incl. its loader) may own — the
        no-orphans-after-close contract is asserted over these."""
        ts = [self._coalesce_thread, self._exec_thread]
        lt = getattr(self._loader, "_thread", None)
        if lt is not None:
            ts.append(lt)
        return ts

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate serving report (exact local aggregates; the registry
        carries the same numbers labeled ``model=<name>`` when obs is
        on): the reference's keys, plus the executor's captured graphs
        (``executor_captures``, ``captures_after_warmup``)."""
        by_status = {}
        for r in self.responses:
            by_status[r.status] = by_status.get(r.status, 0) + 1
        graded = sum(n for s, n in by_status.items()
                     if s != REJECTED_SHUTDOWN)
        lat = np.asarray(self._lat_ms) if self._lat_ms else np.zeros(1)
        ex = self.engine.block_executor
        out = {
            "model": self.name,
            "requests": len(self.responses),
            "by_status": by_status,
            "slo_attainment": (by_status.get(OK, 0) / graded
                               if graded else 1.0),
            "deadline_misses": (by_status.get(LATE, 0)
                                + by_status.get(REJECTED_DEADLINE, 0)),
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "latency_ms_mean": float(lat.mean()),
            "queue_ms_mean": (float(np.mean(self._queue_ms))
                              if self._queue_ms else 0.0),
            "execute_ms_mean": (float(np.mean(self._exec_ms))
                                if self._exec_ms else 0.0),
            "queue_depth_max": max(self._depth_seen, default=0),
            "batches": self._batches,
            "rung_counts": dict(sorted(self._rung_counts.items())),
            "batch_fill": (self._real_seeds / self._padded_seeds
                           if self._padded_seeds else 0.0),
            "ladder": list(self.coalescer.rungs),
            "ladder_ms": (dict(self.ladder_report.measured_ms)
                          if self.ladder_report is not None else {}),
            "executor_traces": ex.trace_count,
            "retraces_after_warmup": (
                ex.trace_count - self._warm_traces
                if self._warm_traces is not None else None),
            "executor_captures": ex.captures,
            "captures_after_warmup": (
                ex.captures - self._warm_captures
                if self._warm_captures is not None else None),
            "shape_floor_growths": (self.shape_floors.growths
                                    if self.shape_floors is not None
                                    else None),
        }
        if obs.metrics_enabled():
            hs = obs.metrics().histogram_summary("serve_request_ms",
                                                 model=self.name)
            if hs and hs["count"]:
                out["latency_ms_p50"] = hs["p50"]
                out["latency_ms_p99"] = hs["p99"]
        return out
