"""The port's online serving runtime (``repro_torch.serve``,
``repro_torch.tune.ladder``, ``serve_rgnn --runtime online``) on the CPU.

Every test of the reference's ``tests/test_serve_runtime.py`` runs again on
the port, with the reference's small engine (RGAT, one layer, dim 8,
fanout 2, tile 8, bucketed, over ``synthetic_heterograph(160, 900, 3, 4)``).
Beside them, parity with the reference: the rung ladders for every kind
and size up to 1024, the open-loop schedules field by field (Poisson and
burst, with and without tenant routes), the latency model over one
sequence of calibrations and observations, the coalescer's decisions on a
simulated clock (rung, members, padded seeds, rejections, step, wait),
the ladder validation from one injected table of timings, and one planned
batch's logits through both engines with the same weights (rtol = atol =
1e-4, the port's serving bound). Every wait has a timeout, so a hung
thread fails its test instead of hanging the suite."""
import numpy as np
import pytest
import jax
import torch

import hector
import hector_torch
import repro.serve as R
import repro.tune.ladder as ref_ladder_mod
from repro.core.graph import synthetic_heterograph as ref_graph
from repro.sampling import build_minibatch as ref_build_minibatch
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.launch import serve_rgnn
from repro_torch.sampling import build_minibatch
from repro_torch.serve import (LATE, OK, REJECTED_DEADLINE,
                               REJECTED_SHUTDOWN, Coalescer, LatencyModel,
                               MultiTenantRuntime, OpenLoopLoad, Request,
                               ServingRuntime, ladder)
from repro_torch.tune import ladder as ladder_mod

GRAPH = dict(num_nodes=160, num_edges=900, num_ntypes=3, num_etypes=4,
             seed=0)
ENGINE = dict(layers=1, dim=8, hidden=8, classes=4, sample=2, tile=8,
              node_block=8, bucket=True, seed=0)
WAIT_S = 60.0


# ---------------------------------------------------------------------------
# open-loop load generation
# ---------------------------------------------------------------------------
def test_ladder_rung_sets():
    assert ladder(16, "pow2") == [1, 2, 4, 8, 16]
    assert ladder(16, "fine") == [1, 2, 3, 4, 6, 8, 12, 16]
    assert ladder(5, "fine") == [1, 2, 3, 4, 6, 8]   # top rounds up to pow2
    with pytest.raises(ValueError):
        ladder(0)
    with pytest.raises(ValueError):
        ladder(8, "coarse")


@pytest.mark.parametrize("kind", ["pow2", "fine"])
def test_ladder_equals_reference(kind):
    for n in range(1, 1025):
        assert ladder(n, kind) == R.ladder(n, kind), n


@pytest.mark.parametrize("process", ["poisson", "burst", "uniform"])
def test_open_loop_schedule_deterministic(process):
    """The schedule is a pure function of the seed: same args -> identical
    requests (arrivals, seeds, sizes, SLOs); a different seed differs."""
    mk = lambda s: OpenLoopLoad(500, rate_rps=200.0, num_requests=24,  # noqa: E731
                                process=process, size_choices=(1, 2, 4),
                                slo_ms=(20.0, 50.0), seed=s)
    a, b = mk(3).requests(), mk(3).requests()
    assert len(a) == len(b) == 24
    for ra, rb in zip(a, b):
        assert ra.arrival_s == rb.arrival_s
        assert ra.slo_ms == rb.slo_ms
        np.testing.assert_array_equal(ra.seeds, rb.seeds)
    arr = np.array([r.arrival_s for r in a])
    assert np.all(np.diff(arr) >= 0)            # arrivals are sorted
    c = mk(4).requests()
    assert any(ra.arrival_s != rc.arrival_s or
               not np.array_equal(ra.seeds, rc.seeds)
               for ra, rc in zip(a, c))


@pytest.mark.parametrize("process", ["poisson", "burst"])
@pytest.mark.parametrize("models", [None, ("a", "b", "c")])
def test_open_loop_requests_equal_reference(process, models):
    kw = dict(rate_rps=150.0, num_requests=40, process=process,
              burst_size=3, size_choices=(1, 2, 4, 8),
              slo_ms=(10.0, 25.0, 100.0), zipf_alpha=1.1, models=models,
              seed=7)
    ours = OpenLoopLoad(500, **kw).requests()
    ref = R.OpenLoopLoad(500, **kw).requests()
    assert len(ours) == len(ref) == 40
    for a, b in zip(ours, ref):
        assert (a.rid, a.arrival_s, a.slo_ms, a.model, a.t_arrive) == \
            (b.rid, b.arrival_s, b.slo_ms, b.model, b.t_arrive)
        assert a.seeds.dtype == b.seeds.dtype
        np.testing.assert_array_equal(a.seeds, b.seeds)


def test_open_loop_burst_groups_and_tenant_routing():
    load = OpenLoopLoad(100, rate_rps=100.0, num_requests=12,
                        process="burst", burst_size=3, slo_ms=10.0,
                        models=("a", "b"), seed=0)
    reqs = load.requests()
    arr = [r.arrival_s for r in reqs]
    # bursts arrive back-to-back in groups of burst_size
    assert arr[0] == arr[1] == arr[2]
    assert arr[3] == arr[4] == arr[5] != arr[2]
    assert [r.model for r in reqs[:4]] == ["a", "b", "a", "b"]


# ---------------------------------------------------------------------------
# deadline-aware coalescing (unit level: no engine, synthetic clock)
# ---------------------------------------------------------------------------
def _req(rid, size=1, slo_ms=100.0, t_arrive=0.0):
    r = Request(rid=rid, seeds=np.arange(size, dtype=np.int32),
                arrival_s=0.0, slo_ms=slo_ms)
    r.t_arrive = t_arrive
    return r


def _model(table):
    lm = LatencyModel(headroom=1.0)
    for rung, ms in table.items():
        lm.calibrate(rung, ms)
    return lm


def test_coalescer_picks_largest_feasible_rung():
    """Admission merges into the largest rung whose *measured* latency
    meets the tightest in-batch deadline — not simply the largest rung."""
    lm = _model({1: 1.0, 2: 2.0, 4: 4.0, 8: 50.0})
    co = Coalescer([1, 2, 4, 8], lm, max_wait_ms=5.0)
    # 6 single-seed requests, 10 ms budget: rung 8 (50 ms) is infeasible,
    # rung 4 (4 ms) fits -> admit exactly 4 requests at rung 4
    pending = [_req(i, slo_ms=10.0) for i in range(6)]
    d = co.plan(pending, now=0.0)
    assert d.batch is not None and d.batch.rung == 4
    assert [r.rid for r in d.batch.requests] == [0, 1, 2, 3]
    assert len(pending) == 2 and not d.rejects
    assert d.batch.seeds.shape == (4,)
    assert d.batch.slices == [(0, 1), (1, 2), (2, 3), (3, 4)]


def test_coalescer_rejects_expired_never_serves_late_silently():
    lm = _model({1: 5.0, 8: 10.0})
    co = Coalescer([1, 8], lm, max_wait_ms=1.0)
    pending = [
        _req(0, slo_ms=100.0),                 # healthy
        _req(1, slo_ms=10.0, t_arrive=-1.0),   # deadline already passed
        _req(2, slo_ms=4.0),                   # slack < smallest-rung est
    ]
    d = co.plan(pending, now=0.0, drain=True)
    assert sorted(r.rid for r in d.rejects) == [1, 2]
    assert d.batch is not None
    assert [r.rid for r in d.batch.requests] == [0]


def test_coalescer_waits_for_fill_then_drain_flushes():
    """With loose deadlines and a part-filled rung the coalescer holds for
    more arrivals; drain (shutdown) admits immediately."""
    lm = _model({1: 1.0, 2: 1.5, 4: 2.0})
    co = Coalescer([1, 2, 4], lm, max_wait_ms=50.0)
    pending = [_req(0, slo_ms=10_000.0)]
    d = co.plan(pending, now=0.0)
    assert d.batch is None and not d.rejects and d.wait_s > 0
    assert len(pending) == 1
    d = co.plan(pending, now=0.0, drain=True)
    assert d.batch is not None and d.batch.requests[0].rid == 0
    assert d.batch.rung == 1                    # covering rung, minimal pad
    assert not pending


def test_coalescer_padding_repeats_first_seed():
    lm = _model({4: 1.0})
    co = Coalescer([4], lm, max_wait_ms=0.0)
    pending = [_req(0, size=3, slo_ms=100.0)]
    d = co.plan(pending, now=0.0, drain=True)
    np.testing.assert_array_equal(d.batch.seeds, np.array([0, 1, 2, 0]))


def test_latency_model_jumps_up_decays_down():
    lm = LatencyModel(alpha=0.5, headroom=1.0)
    lm.calibrate(4, 10.0)
    lm.observe(4, 40.0)
    assert lm.estimate(4) == 40.0               # spikes register instantly
    lm.observe(4, 10.0)
    assert 10.0 < lm.estimate(4) < 40.0         # recovery is gradual
    # unmeasured rung falls back to the nearest measured rung above
    lm.calibrate(16, 100.0)
    assert lm.estimate(8) == 100.0


def test_latency_model_equals_reference():
    rng = np.random.default_rng(5)
    ours, ref = LatencyModel(alpha=0.3, headroom=1.2), \
        R.LatencyModel(alpha=0.3, headroom=1.2)
    assert ours.estimate(4) is None and ref.estimate(4) is None
    for i in range(200):
        rung = int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 24, 32]))
        ms = float(rng.gamma(2.0, 3.0))
        if i % 7 == 0:
            ours.calibrate(rung, ms)
            ref.calibrate(rung, ms)
        else:
            ours.observe(rung, ms)
            ref.observe(rung, ms)
        assert ours.known() == ref.known()
        for r in (1, 5, 16, 64):
            assert ours.estimate(r) == ref.estimate(r)
    assert ours.samples == ref.samples


def test_coalescer_decisions_equal_reference():
    """Both coalescers driven by one arrival schedule on one simulated
    clock: every decision's batch (rung, members, padded seeds, step,
    admit time), rejections and wait are equal."""
    table = {1: 1.5, 2: 2.0, 3: 2.4, 4: 2.9, 6: 3.8, 8: 4.6, 12: 7.0,
             16: 9.5}
    rungs = sorted(table)
    lm_o, lm_r = LatencyModel(headroom=1.1), R.LatencyModel(headroom=1.1)
    for rung, ms in table.items():
        lm_o.calibrate(rung, ms)
        lm_r.calibrate(rung, ms)
    co_o = Coalescer(rungs, lm_o, max_wait_ms=3.0)
    co_r = R.Coalescer(rungs, lm_r, max_wait_ms=3.0)
    kw = dict(rate_rps=900.0, num_requests=120, process="burst",
              burst_size=4, size_choices=(1, 2, 3, 5),
              slo_ms=(4.0, 8.0, 30.0), seed=11)
    sched_o = OpenLoopLoad(400, **kw).requests()
    sched_r = R.OpenLoopLoad(400, **kw).requests()
    pend_o, pend_r = [], []
    now, i, decisions, admitted, rejected = 0.0, 0, 0, 0, 0
    while i < len(sched_o) or pend_o:
        while i < len(sched_o) and sched_o[i].arrival_s <= now:
            sched_o[i].t_arrive = sched_r[i].t_arrive = now
            pend_o.append(sched_o[i])
            pend_r.append(sched_r[i])
            i += 1
        if pend_o:
            drain = i == len(sched_o)
            d_o = co_o.plan(pend_o, now, drain=drain)
            d_r = co_r.plan(pend_r, now, drain=drain)
            decisions += 1
            assert [r.rid for r in d_o.rejects] == \
                [r.rid for r in d_r.rejects]
            assert d_o.wait_s == d_r.wait_s
            assert (d_o.batch is None) == (d_r.batch is None)
            assert [r.rid for r in pend_o] == [r.rid for r in pend_r]
            rejected += len(d_o.rejects)
            if d_o.batch is not None:
                b_o, b_r = d_o.batch, d_r.batch
                assert (b_o.step, b_o.rung, b_o.t_admit, b_o.slices) == \
                    (b_r.step, b_r.rung, b_r.t_admit, b_r.slices)
                assert [r.rid for r in b_o.requests] == \
                    [r.rid for r in b_r.requests]
                assert b_o.seeds.dtype == b_r.seeds.dtype
                np.testing.assert_array_equal(b_o.seeds, b_r.seeds)
                admitted += 1
                # the batch "executes" for its estimated time
                est = table[b_o.rung]
                lm_o.observe(b_o.rung, est)
                lm_r.observe(b_r.rung, est)
        now = round(now + 0.0005, 9)
    assert decisions > 100 and admitted > 10 and rejected > 0


def test_validate_ladder_equals_reference(monkeypatch):
    """One injected table of timings (seconds per rung) into both
    packages' ``measure_group``: the same surviving and dropped rungs and
    measured ms; the port warms every rung twice before timing."""
    rungs = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32]
    secs = {1: 1e-3, 2: 1.2e-3, 3: 1.3e-3, 4: 1.32e-3, 6: 1.88e-3,
            8: 1.9e-3, 12: 1.86e-3, 16: 2.5e-3, 24: 2.65e-3, 32: 2.7e-3}
    seen = {}

    def fake(calls, device="cpu", warmup=1, iters=3):
        seen.update(device=device, warmup=warmup, iters=iters)
        return [secs[fn()] for fn, _ in calls]

    monkeypatch.setattr(ladder_mod, "measure_group", fake)
    monkeypatch.setattr(ref_ladder_mod, "measure_group", fake)
    prepare = lambda r: (lambda: r, ())                    # noqa: E731
    ours = ladder_mod.validate_ladder(rungs, prepare, warmup=0,
                                      device="cpu")
    assert seen == dict(device="cpu", warmup=1, iters=3)
    ref = ref_ladder_mod.validate_ladder(rungs, prepare)
    assert ours.rungs == ref.rungs and ours.dropped == ref.dropped
    assert ours.measured_ms == ref.measured_ms
    assert ours.describe() == ref.describe()
    assert ours.dropped == [3, 6, 24]


# ---------------------------------------------------------------------------
# the async runtime end-to-end (small engine on the CPU)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    graph = synthetic_heterograph(**GRAPH)
    engine = hector_torch.compile("rgat", graph, device="cpu", **ENGINE)
    params = engine.init(0)
    feats = np.random.default_rng(1).normal(
        size=(graph.num_nodes, 8)).astype(np.float32)
    store = engine.make_feature_store(feats)
    return graph, engine, params, store


def _runtime(served, **kw):
    graph, engine, params, store = served
    kw.setdefault("rungs", ladder(4, "fine"))
    kw.setdefault("max_wait_ms", 2.0)
    return ServingRuntime(engine, params, store, **kw)


def _calibrate(rt):
    rt.calibrate(batches_per_rung=1, validate=False, iters=1,
                 probe_batches=4, warm_rounds=2)


def test_runtime_end_to_end_all_ok_zero_retraces(served):
    graph = served[0]
    rt = _runtime(served)
    try:
        _calibrate(rt)
        load = OpenLoopLoad(graph.num_nodes, rate_rps=400.0,
                            num_requests=16, size_choices=(1, 2, 4),
                            slo_ms=30_000.0, seed=2)
        handles = [rt.submit(r) for r in load.requests()]
        rt.drain(timeout=WAIT_S)
        for h in handles:
            resp = h.wait(timeout=10.0)
            assert resp is not None and resp.status == OK
            assert resp.logits.shape[1] == 4
            assert np.all(np.isfinite(resp.logits))
            assert resp.latency_ms >= resp.queue_ms >= 0.0
        s = rt.stats()
        assert s["requests"] == 16 and s["by_status"] == {OK: 16}
        assert s["slo_attainment"] == 1.0
        assert s["retraces_after_warmup"] == 0
        # nothing is captured on the CPU
        assert s["executor_captures"] == s["captures_after_warmup"] == 0
        # a floor growth without a retrace is benign (the grown bucket was
        # already keyed); with the short probe pass used here allow one
        assert s["shape_floor_growths"] <= 1
        # every forward of the engine ran on the runtime's execute thread
        assert rt.worker_threads()[1].name == "serve-exec-rgat"
    finally:
        rt.close()


def test_runtime_response_sizes_match_requests(served):
    rt = _runtime(served)
    try:
        _calibrate(rt)
        sizes = [1, 3, 2, 4]
        handles = [
            rt.submit(Request(rid=i, seeds=np.arange(sz, dtype=np.int32),
                              arrival_s=0.0, slo_ms=30_000.0))
            for i, sz in enumerate(sizes)]
        rt.drain(timeout=WAIT_S)
        for sz, h in zip(sizes, handles):
            resp = h.wait(timeout=10.0)
            assert resp.status == OK and resp.logits.shape == (sz, 4)
    finally:
        rt.close()


def test_runtime_rejects_unmeetable_deadline(served):
    rt = _runtime(served)
    try:
        _calibrate(rt)
        h = rt.submit(Request(rid=0, seeds=np.arange(2, dtype=np.int32),
                              arrival_s=0.0, slo_ms=1e-6))
        resp = h.wait(timeout=10.0)
        assert resp is not None and resp.status == REJECTED_DEADLINE
        assert resp.logits is None
    finally:
        rt.close()
    assert rt.stats()["deadline_misses"] == 1


def test_runtime_oversized_request_raises(served):
    rt = _runtime(served)
    try:
        with pytest.raises(ValueError, match="exceed the top"):
            rt.submit(Request(rid=0, seeds=np.arange(64, dtype=np.int32),
                              arrival_s=0.0, slo_ms=1000.0))
    finally:
        rt.close()


def test_runtime_close_is_graceful_and_leaves_no_threads(served):
    """close() drains: queued requests terminate (served or rejected with
    REJECTED_SHUTDOWN), every handle resolves, and no worker thread
    survives — the execute thread and the loader's producer included."""
    rt = _runtime(served)
    try:
        _calibrate(rt)
        rt.start()
        handles = [
            rt.submit(Request(rid=i, seeds=np.arange(1, dtype=np.int32),
                              arrival_s=0.0, slo_ms=30_000.0))
            for i in range(6)]
    finally:
        rt.close()
    for h in handles:
        resp = h.wait(timeout=5.0)
        assert resp is not None
        assert resp.status in (OK, LATE, REJECTED_SHUTDOWN)
    assert all(not t.is_alive() for t in rt.worker_threads() if t)
    # post-close submissions are rejected, not queued
    h = rt.submit(Request(rid=99, seeds=np.arange(1, dtype=np.int32),
                          arrival_s=0.0, slo_ms=1000.0))
    assert h.wait(timeout=1.0).status == REJECTED_SHUTDOWN
    rt.close()   # idempotent


def test_runtime_close_without_start(served):
    rt = _runtime(served)
    rt.close()
    assert all(not t.is_alive() for t in rt.worker_threads() if t)


def test_runtime_calibrated_but_never_started_leaves_no_threads(served):
    """Calibration starts the execute thread; close() without start()
    still joins it."""
    rt = _runtime(served)
    _calibrate(rt)
    assert rt.worker_threads()[1].is_alive()
    rt.close()
    assert all(not t.is_alive() for t in rt.worker_threads() if t)


# ---------------------------------------------------------------------------
# multi-model tenancy
# ---------------------------------------------------------------------------
def test_tenancy_routes_by_model_and_never_cross_retraces(served):
    """Two tenants share the process; traffic routed by Request.model.
    Serving one tenant must never retrace the other: after each tenant's
    own calibration, interleaved two-tenant traffic leaves both at zero
    retraces."""
    graph, engine_a, params_a, store_a = served
    engine_b = hector_torch.compile("rgcn", graph, device="cpu", **ENGINE)
    params_b = engine_b.init(1)
    feats = np.random.default_rng(2).normal(
        size=(graph.num_nodes, 8)).astype(np.float32)
    store_b = engine_b.make_feature_store(feats)

    mt = MultiTenantRuntime()
    mt.add(ServingRuntime(engine_a, params_a, store_a, name="a",
                          rungs=ladder(4, "fine"), max_wait_ms=2.0))
    mt.add(ServingRuntime(engine_b, params_b, store_b, name="b",
                          rungs=ladder(4, "fine"), max_wait_ms=2.0))
    try:
        mt.calibrate(batches_per_rung=1, validate=False, iters=1,
                     probe_batches=4, warm_rounds=2)
        load = OpenLoopLoad(graph.num_nodes, rate_rps=400.0,
                            num_requests=16, size_choices=(1, 2),
                            slo_ms=30_000.0, models=("a", "b"), seed=5)
        handles = [mt.submit(r) for r in load.requests()]
        mt.drain(timeout=WAIT_S)
        assert all(h.wait(timeout=10.0).status == OK for h in handles)
        s = mt.stats()
        assert s["tenants"]["a"]["requests"] == 8
        assert s["tenants"]["b"]["requests"] == 8
        assert s["tenants"]["a"]["retraces_after_warmup"] == 0
        assert s["tenants"]["b"]["retraces_after_warmup"] == 0
        assert s["retraces_after_warmup"] == 0
    finally:
        mt.close()
    assert all(not t.is_alive() for t in mt.worker_threads() if t)


def test_tenancy_routing_errors():
    mt = MultiTenantRuntime()
    with pytest.raises(RuntimeError):
        mt.start()
    req = Request(rid=0, seeds=np.arange(1, dtype=np.int32),
                  arrival_s=0.0, slo_ms=10.0, model="ghost")
    with pytest.raises(KeyError):
        mt.submit(req)


# ---------------------------------------------------------------------------
# against the reference engine, and the driver
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_served():
    graph = ref_graph(**GRAPH)
    engine = hector.compile("rgat", graph, **ENGINE)
    params = engine.init(jax.random.key(0))
    return graph, engine, params


def test_planned_batch_logits_equal_reference(served, ref_served):
    """One coalesced batch (three requests padded to rung 8) through each
    package's engine with the same weights and features: the port's rows
    within 1e-4 of the reference's."""
    graph, engine, _, _ = served
    _, rengine, rparams = ref_served
    params = engine.params_from_reference(
        [{k: np.asarray(v) for k, v in p.items()} for p in rparams])
    reqs = [_req(i, size=s, slo_ms=1000.0) for i, s in enumerate((2, 1, 3))]
    for r, seeds in zip(reqs, ([5, 77], [140], [3, 99, 12])):
        r.seeds = np.asarray(seeds, np.int32)
    co = Coalescer(ladder(8, "pow2"), _model({8: 1.0}), max_wait_ms=0.0)
    pb = co.plan(reqs, now=0.0, drain=True).batch
    assert pb.rung == 8 and pb.seeds.shape == (8,)
    feats = np.random.default_rng(1).normal(
        size=(graph.num_nodes, 8)).astype(np.float32)

    seq = engine.sampler.sample(pb.seeds, batch_index=pb.step)
    mb = build_minibatch(seq, step=pb.step, tile=8, node_block=8,
                         bucket=True)
    ours = engine.apply_blocks(params, mb, torch.from_numpy(feats)).numpy()
    rseq = rengine.sampler.sample(pb.seeds, batch_index=pb.step)
    rmb = ref_build_minibatch(rseq, step=pb.step, tile=8, node_block=8,
                              bucket=True)
    ref = np.asarray(rengine.forward_minibatch(rparams, rmb,
                                               jax.numpy.asarray(feats)))
    assert ours.shape == ref.shape == (8, 4)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    for (lo, hi), r in zip(pb.slices, pb.requests):
        assert hi - lo == r.num_seeds


def test_online_driver_reports_the_reference_keys(ref_served):
    """``serve_rgnn --runtime online --device cpu`` at a small size: every
    request terminal and OK, and the stats dict holds every key of the
    reference runtime's report and of its driver's."""
    _, rengine, rparams = ref_served
    rstore = rengine.make_feature_store(
        np.zeros((GRAPH["num_nodes"], 8), np.float32))
    rrt = R.ServingRuntime(rengine, rparams, rstore, rungs=[1, 2])
    try:
        ref_keys = set(rrt.stats()) | {"submitted", "requests_per_s",
                                       "metrics"}
    finally:
        rrt.close()
    stats = serve_rgnn.main([
        "--runtime", "online", "--device", "cpu", "--dataset", "aifb",
        "--scale", "0.02", "--layers", "1", "--fanout", "2", "--dim", "8",
        "--hidden", "8", "--classes", "4", "--tile", "8", "--node-block",
        "8", "--batch-size", "4", "--ladder", "pow2", "--rate", "400",
        "--requests", "12", "--sizes", "1,2", "--slo-ms", "30000"])
    assert ref_keys <= set(stats), ref_keys - set(stats)
    assert stats["submitted"] == stats["requests"] == 12
    assert stats["by_status"] == {OK: 12}
    assert stats["retraces_after_warmup"] == 0
    assert stats["device"] == "cpu"
