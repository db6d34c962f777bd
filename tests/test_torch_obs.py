"""The port's telemetry (``repro_torch.obs``) against the reference's
``repro.obs``, on the CPU: registry snapshots equal as JSON for one
scripted sequence of instrument operations (the reservoir overflow
included), Chrome traces of the same structure for one span script, each
package's schema accepting the other's documents, ``_isotonic`` equal, and
the per-op profile's rows (labels, categories, hops) equal to
``repro.obs.profile.profile_minibatch``'s on ``tests/test_obs.py``'s
``profiled`` graph with the reference's weights carried by
``params_from_reference``. Then the mirrors of ``tests/test_obs.py``'s
tests, and the port's instrumented layers and drivers: logits and losses
bitwise equal with obs off, on, and on with tracing; the written files
valid; the executor, sampler and tuner counters equal to the attributes
they mirror.

Timing: the profile tests check the attribution's structure exactly (the
telescoping of the fitted prefix times is an identity, and a scripted
harness pins the arithmetic); the one band on measured times, the
coverage of a real profile, is kept wide (0.2-5) because the suite runs
six workers on shared cores, where the reference's own 0.5-1.6 band once
read 199 %.
"""
import json
import math
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hector
import hector_torch
from repro import obs as robs
from repro.core.graph import synthetic_heterograph as ref_graph
from repro.obs import profile as rprofile
from repro.obs import registry as rregistry
from repro.obs import schema as rschema
from repro.obs import tracing as rtracing
from repro.sampling import build_minibatch as ref_build
from repro_torch import obs
from repro_torch.core import executor
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.launch import serve_rgnn, train_rgnn
from repro_torch.obs import profile as tprofile
from repro_torch.obs import registry as tregistry
from repro_torch.obs import schema
from repro_torch.obs import tracing as ttracing
from repro_torch.obs.registry import (MetricsRegistry, NULL_REGISTRY,
                                      snapshot_counter_total,
                                      snapshot_histogram, snapshot_value)
from repro_torch.obs.tracing import NULL_SPAN, SpanTracer
from repro_torch.optim import AdamW
from repro_torch.sampling import build_minibatch

PACKAGES = {"reference": (rregistry, rtracing, rschema),
            "port": (tregistry, ttracing, schema)}


def _quiet(*_a, **_k):
    pass


# ---------------------------------------------------------------------------
# the port against the reference: same inputs, same documents
# ---------------------------------------------------------------------------
def _scripted_registry(reg_mod):
    """One sequence of counter, gauge and histogram operations, with a
    reservoir that overflows, labels, a child registry absorbed, and the
    empty histogram's NaN summary."""
    reg = reg_mod.MetricsRegistry()
    reg.counter("executor_traces", executor="BlockExecutor").inc()
    reg.counter("executor_traces", executor="PlanExecutor").inc(3)
    reg.counter("tune_measurements").inc(7)
    reg.gauge("tile").set(16)
    reg.gauge("tile").set(32)
    reg.histogram("empty")
    h = reg.histogram("serve_batch_ms", max_samples=32)
    rng = np.random.default_rng(5)
    for v in rng.lognormal(size=500):
        h.observe(float(v))
    reg.histogram("lat", model="a").observe(2.5)
    child = reg_mod.MetricsRegistry()
    child.counter("executor_traces", executor="BlockExecutor").inc(2)
    child.gauge("tile").set(8)
    hc = child.histogram("serve_batch_ms", max_samples=32)
    for v in rng.normal(size=300):
        hc.observe(float(v))
    reg.absorb(child)
    return reg


def test_registry_snapshot_equals_the_reference_as_json():
    ours = _scripted_registry(tregistry)
    ref = _scripted_registry(rregistry)
    a = json.dumps(ours.snapshot(), sort_keys=True)
    b = json.dumps(ref.snapshot(), sort_keys=True)
    assert a == b
    snap = json.loads(a)
    # the overflowed reservoir kept its bound; count and sum stay exact
    s = snapshot_histogram(snap, "serve_batch_ms")
    assert s["count"] == 800
    assert s == rregistry.snapshot_histogram(snap, "serve_batch_ms")
    for name in ("executor_traces", "tune_measurements", "absent"):
        assert snapshot_counter_total(snap, name) == \
            rregistry.snapshot_counter_total(snap, name)
    assert snapshot_value(snap, "tile") == 8.0
    assert snapshot_value(snap, "executor_traces",
                          executor="BlockExecutor") == 3
    assert ours.num_instruments == ref.num_instruments
    assert ours.histogram("serve_batch_ms").percentile(50) == \
        ref.histogram("serve_batch_ms").percentile(50)
    assert json.dumps(tregistry.NULL_REGISTRY.snapshot()) == \
        json.dumps(rregistry.NULL_REGISTRY.snapshot())


def _scripted_trace(tr_mod):
    tr = tr_mod.SpanTracer(max_events=6)
    with tr.span("execute", step=0):
        with tr.span("inner"):
            pass

    def worker():
        with tr.span("sample", step=1):
            pass
        with tr.span("layout", step=1):
            pass
    t = threading.Thread(target=worker, name="prefetch")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    child = tr_mod.SpanTracer()
    with child.span("wait", batch=0):
        pass
    tr.absorb(child)
    for _ in range(3):               # past max_events: dropped
        with tr.span("x"):
            pass
    return tr


def _structure(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in doc["traceEvents"]]


def test_chrome_trace_structure_equals_the_reference():
    ours, ref = _scripted_trace(ttracing), _scripted_trace(rtracing)
    a = json.loads(json.dumps(ours.chrome_trace()))
    b = json.loads(json.dumps(ref.chrome_trace()))
    assert _structure(a) == _structure(b)
    assert a["displayTimeUnit"] == b["displayTimeUnit"]
    assert ours.dropped == ref.dropped == 2
    assert {k: v["count"] for k, v in ours.phase_totals().items()} == \
        {k: v["count"] for k, v in ref.phase_totals().items()}
    assert ours.phase_table().splitlines()[0] == \
        ref.phase_table().splitlines()[0]


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("reader", sorted(PACKAGES))
def test_each_schema_accepts_the_others_documents(writer, reader):
    reg_mod, tr_mod, _ = PACKAGES[writer]
    check = PACKAGES[reader][2]
    metrics = json.loads(json.dumps(_scripted_registry(reg_mod).snapshot()))
    trace = json.loads(json.dumps(_scripted_trace(tr_mod).chrome_trace()))
    assert check.validate_metrics(metrics) == []
    assert check.validate_trace(trace) == []
    assert check.require_phases(trace, ["execute", "sample", "layout",
                                        "wait"]) == []
    # and they reject the same faults with the same words
    bad_m = dict(metrics, schema_version=0, gauges=[{"name": ""}])
    bad_t = {"traceEvents": [{"ph": "B", "name": "x"},
                             {"ph": "X", "name": "y", "pid": 0, "tid": 0,
                              "ts": -1, "dur": "1"}]}
    assert check.validate_metrics(bad_m) == \
        rschema.validate_metrics(bad_m) != []
    assert check.validate_trace(bad_t) == rschema.validate_trace(bad_t) != []
    assert check.require_phases(trace, ["backward"]) == \
        rschema.require_phases(trace, ["backward"]) != []


def test_isotonic_equals_the_reference():
    rng = np.random.default_rng(3)
    cases = [[], [1.0], [1.0, 2.0, 3.0], [3.0, 2.0, 1.0],
             [1.0, 3.0, 2.0, 2.0, 5.0, 4.0]]
    cases += [list(np.cumsum(rng.normal(0.5, 1.0, size=n)))
              for n in (5, 17, 40)]
    for xs in cases:
        assert tprofile._isotonic(xs) == rprofile._isotonic(xs)


# ---------------------------------------------------------------------------
# the profiled graph of tests/test_obs.py, in both packages
# ---------------------------------------------------------------------------
PROFILED_GRAPH = dict(num_nodes=120, num_edges=900, num_ntypes=4,
                      num_etypes=7, seed=0)
PROFILED = dict(layers=2, dim=8, hidden=8, classes=4, sample=[3, 3],
                tile=8, node_block=8)


@pytest.fixture(scope="module")
def profiled():
    """``tests/test_obs.py``'s fixture, in the port, with the reference's
    engine, weights and mini-batch beside it."""
    rg = ref_graph(**PROFILED_GRAPH)
    rng = np.random.default_rng(1)
    feats_np = rng.normal(size=(rg.num_nodes, 8)).astype(np.float32)
    ref = hector.compile("rgat", rg, log=None, **PROFILED)
    rparams = ref.init(0)
    rmb = ref_build(ref.sampler.sample(np.arange(8, dtype=np.int32),
                                       batch_index=0, epoch=0),
                    step=0, tile=8, node_block=8, bucket=True)
    eng = hector_torch.compile("rgat", synthetic_heterograph(**PROFILED_GRAPH),
                               device="cpu", **PROFILED)
    params = eng.params_from_reference(
        [{k: np.asarray(v) for k, v in p.items()} for p in rparams])
    mb = build_minibatch(eng.sampler.sample(np.arange(8, dtype=np.int32),
                                            batch_index=0, epoch=0),
                         step=0, tile=8, node_block=8, bucket=True)
    return eng, params, mb, torch.from_numpy(feats_np), (
        ref, rparams, rmb, jnp.asarray(feats_np))


def _rows(p):
    return [(o.index, o.label, o.category, o.hop) for o in p.ops]


def test_profile_rows_equal_the_reference(profiled):
    eng, params, mb, feats, (ref, rparams, rmb, rfeats) = profiled
    assert eng.describe() == ref.describe()
    p = eng.profile(params, mb, feats, warmup=0, iters=1)
    rp = rprofile.profile_minibatch(ref.engine, rparams, rmb, rfeats,
                                    warmup=0, iters=1)
    assert _rows(p) == _rows(rp)
    assert p.backend == "cpu"
    doc = json.loads(json.dumps(p.to_json()))
    rdoc = json.loads(json.dumps(rp.to_json()))
    assert sorted(doc) == sorted(rdoc)
    assert sorted(doc["by_category_us"]) == sorted(rdoc["by_category_us"])
    assert [sorted(o) for o in doc["ops"]] == [sorted(o)
                                               for o in rdoc["ops"]]


def test_profile_attribution_arithmetic(profiled, monkeypatch):
    """With a scripted harness (every prefix run once, then given a set
    time), each row is the isotonic fit's difference, as the reference
    computes it; the whole-sequence time comes last."""
    eng, params, mb, feats, _ = profiled
    n_steps = sum(len(pl.ops) for pl in eng.plans) + len(eng.plans)
    script = [1.0, 3.0, 2.0, 4.0, 4.5, 4.0, 6.0, 6.5, 7.0, 6.0, 8.0, 9.0,
              9.5, 10.0, 11.0][:n_steps]
    assert len(script) == n_steps
    outs = []

    def fake(calls, device="cpu", warmup=1, iters=3):
        assert len(calls) == n_steps + 1
        for fn, args in calls:
            outs.append(fn(*args))
        return script + [10.0]

    monkeypatch.setattr(tprofile, "measure_group", fake)
    p = eng.profile(params, mb, feats)
    fit = rprofile._isotonic(script)
    want = [max(b - a, 0.0) for a, b in zip([0.0] + fit[:-1], fit)]
    assert [o.seconds for o in p.ops] == want
    assert [o.prefix_seconds for o in p.ops] == script
    assert p.total_seconds == 10.0
    assert p.coverage == pytest.approx(fit[-1] / 10.0)
    # the last prefix (the seed gather) is the whole sequence's output
    whole = eng.apply_blocks(params, mb, feats)
    assert torch.equal(outs[n_steps - 1], whole)
    assert torch.equal(outs[-1], whole)


# ---------------------------------------------------------------------------
# mirrors of tests/test_obs.py
# ---------------------------------------------------------------------------
def test_counter_identity_by_name_and_labels():
    reg = MetricsRegistry()
    a = reg.counter("hits", cache="block")
    b = reg.counter("hits", cache="block")
    c = reg.counter("hits", cache="layout")
    assert a is b and a is not c
    a.inc()
    b.inc(4)
    assert reg.value("hits", cache="block") == 5
    assert reg.value("hits", cache="layout") == 0
    assert reg.value("hits", cache="nope") is None
    assert reg.counter_total("hits") == 5


def test_gauge_last_write_wins():
    reg = MetricsRegistry()
    reg.gauge("depth").set(3)
    reg.gauge("depth").set(7)
    assert reg.value("depth") == 7.0


def test_histogram_empty_and_single_sample():
    h = MetricsRegistry().histogram("lat")
    s = h.summary()
    assert s["count"] == 0
    assert math.isnan(s["p50"]) and math.isnan(s["min"])
    h.observe(4.5)
    s = h.summary()
    assert s["count"] == 1
    assert s["p50"] == s["p99"] == s["min"] == s["max"] == 4.5


def test_histogram_linear_interpolation_matches_numpy():
    h = MetricsRegistry().histogram("lat")
    vals = [5.0, 1.0, 9.0, 3.0, 7.0]
    for v in vals:
        h.observe(v)
    for q in (50, 90, 95, 99):
        assert h.percentile(q) == pytest.approx(np.percentile(vals, q))
    s = h.summary()
    assert s["mean"] == pytest.approx(5.0)
    assert s["min"] == 1.0 and s["max"] == 9.0 and s["sum"] == 25.0


def test_histogram_reservoir_exact_aggregates_and_determinism():
    def fill():
        h = MetricsRegistry().histogram("lat", max_samples=128)
        for i in range(5000):
            h.observe(float(i))
        return h

    a, b = fill(), fill()
    assert a.count == 5000 and a.min == 0.0 and a.max == 4999.0
    assert a.total == pytest.approx(sum(range(5000)))
    assert a.summary() == b.summary()
    assert 1500 < a.percentile(50) < 3500


def test_histogram_absorb_merges_distributions():
    a, b = MetricsRegistry(), MetricsRegistry()
    for v in (1.0, 2.0):
        a.histogram("lat").observe(v)
    for v in (3.0, 4.0):
        b.histogram("lat").observe(v)
    a.absorb(b)
    s = a.histogram_summary("lat")
    assert s["count"] == 4 and s["min"] == 1.0 and s["max"] == 4.0
    assert s["sum"] == 10.0


def test_snapshot_readers_round_trip():
    reg = MetricsRegistry()
    reg.counter("traces", executor="BlockExecutor").inc(3)
    reg.counter("traces", executor="StackTrainExecutor").inc(2)
    reg.gauge("tile").set(16)
    reg.histogram("lat").observe(2.0)
    snap = json.loads(json.dumps(reg.snapshot()))
    assert snap["schema_version"] == obs.SCHEMA_VERSION == \
        robs.SCHEMA_VERSION
    assert snapshot_value(snap, "traces", executor="BlockExecutor") == 3
    assert snapshot_counter_total(snap, "traces") == 5
    assert snapshot_value(snap, "tile") == 16.0
    assert snapshot_histogram(snap, "lat")["count"] == 1
    assert snapshot_value(snap, "absent") is None
    assert schema.validate_metrics(snap) == []


def test_metrics_null_outside_scope_and_live_inside():
    assert obs.metrics() is NULL_REGISTRY
    assert obs.span("x") is NULL_SPAN
    assert not obs.enabled()
    with obs.scope(metrics=True) as sc:
        assert obs.metrics() is sc.registry
        assert obs.metrics_enabled() and not obs.tracing_enabled()
        assert obs.tracer() is None
        obs.metrics().counter("c").inc()
        assert sc.registry.value("c") == 1
    assert obs.metrics() is NULL_REGISTRY
    assert NULL_REGISTRY.counter("c").value == 0


def test_nested_scope_folds_into_parent():
    with obs.scope(metrics=True, tracing=True) as outer:
        obs.metrics().counter("c").inc()
        with obs.scope(metrics=True, tracing=True) as inner:
            obs.metrics().counter("c").inc(10)
            with obs.span("phase"):
                pass
            assert inner.registry.value("c") == 10
        assert outer.registry.value("c") == 11
        assert len(outer.tracer.events("phase")) == 1


def test_disabled_forces_null_even_inside_scope():
    with obs.scope(metrics=True, tracing=True):
        with obs.disabled():
            assert obs.metrics() is NULL_REGISTRY
            assert obs.span("x") is NULL_SPAN
            assert not obs.enabled()
        assert obs.metrics() is not NULL_REGISTRY


def test_scope_is_process_global_for_the_loader_thread():
    """The host loader's producer thread reports into the scope the
    calling thread opened (the state is not thread-local)."""
    seen = []
    with obs.scope(metrics=True, tracing=True) as sc:
        t = threading.Thread(target=lambda: seen.append(obs.metrics()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen == [sc.registry]


def test_span_nesting_depth_and_containment():
    tr = SpanTracer()
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    outer, = tr.events("outer")
    inner, = tr.events("inner")
    assert outer["depth"] == 0 and inner["depth"] == 1
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def test_chrome_trace_schema_and_thread_tracks():
    tr = SpanTracer()
    with tr.span("execute", step=0):
        pass

    def worker():
        with tr.span("sample"):
            pass
    t = threading.Thread(target=worker, name="prefetch")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()

    doc = json.loads(json.dumps(tr.chrome_trace()))
    assert schema.validate_trace(doc) == []
    assert schema.require_phases(doc, ["execute", "sample"]) == []
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M" and e["name"] == "thread_name"]
    spans = [e for e in evs if e["ph"] == "X"]
    assert {m["args"]["name"] for m in meta} >= {"prefetch"}
    assert len({e["tid"] for e in spans}) == 2
    for e in spans:
        assert e["pid"] == 0 and e["dur"] >= 0 and e["cat"] == "phase"
    assert schema.require_phases(doc, ["backward"]) != []


def test_tracer_absorb_rebases_and_merges_tracks():
    parent, child = SpanTracer(), SpanTracer()
    with parent.span("a"):
        pass
    with child.span("b"):
        pass
    parent.absorb(child)
    assert parent.num_events == 2
    assert {e["name"] for e in parent.events()} == {"a", "b"}
    assert len({e["tid"] for e in parent.events()}) == 1


def test_tracer_bounded_drops_not_grows():
    tr = SpanTracer(max_events=2)
    for _ in range(5):
        with tr.span("x"):
            pass
    assert tr.num_events == 2 and tr.dropped == 3


def test_span_sync_passes_cpu_values_through_without_a_synchronize(
        monkeypatch):
    def forbidden(*_a, **_k):
        raise AssertionError("synchronize on CPU values")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    x = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": "text"}
    with SpanTracer().span("execute") as sp:
        assert sp.sync(x) is x
    assert NULL_SPAN.sync(x) is x


def test_profile_minibatch_structure_and_coverage(profiled):
    eng, params, mb, feats, _ = profiled
    p = eng.profile(params, mb, feats, warmup=1, iters=5)
    n_plan_ops = sum(len(pl.ops) for pl in eng.plans)
    assert len(p.ops) == n_plan_ops + len(eng.plans)
    assert {o.hop for o in p.ops} == {0, 1}
    assert {o.category for o in p.ops} <= {"gemm", "traversal", "wprod",
                                           "glue"}
    assert all(o.seconds >= 0 for o in p.ops)
    assert p.total_seconds > 0
    # the fitted prefix differences telescope: their sum is the fitted
    # time of the last prefix, which runs the whole sequence
    fit = tprofile._isotonic([o.prefix_seconds for o in p.ops])
    assert p.sum_op_seconds == pytest.approx(fit[-1], rel=1e-12)
    # a band on measured times: wide for six workers on shared cores
    assert 0.2 < p.coverage < 5.0, p.table()
    assert sum(p.by_category().values()) == pytest.approx(p.sum_op_seconds)
    doc = json.loads(json.dumps(p.to_json()))
    assert doc["total_us"] > 0 and len(doc["ops"]) == len(p.ops)
    assert p.table().count("\n") >= len(p.ops)


def test_profile_plan_rows_cover_one_plan(profiled):
    eng, params, _, feats, _ = profiled
    plan = eng.plans[0]
    p = tprofile.profile_plan(plan, params[0], eng.gt, eng.layouts,
                              {"feature": feats}, warmup=0, iters=2)
    assert [(o.index, o.label) for o in p.ops] == [
        (i, tprofile._op_label(op)) for i, op in enumerate(plan.ops)]
    assert {o.hop for o in p.ops} == {0} and p.total_seconds > 0


def test_profile_train_step_phases(profiled):
    eng, params, mb, feats, _ = profiled
    opt = AdamW(learning_rate=1e-3)
    state = opt.init(params)
    before = [{k: v.clone() for k, v in p.items()} for p in state.params]
    labels = np.zeros(8, dtype=np.int32)
    ph = tprofile.profile_train_step(
        eng.plans, opt, state, mb, labels,
        {"feature": feats[mb.input_ids.long()]},
        activation=eng.cfg.activation, decisions=eng.decisions, warmup=1,
        iters=3)
    assert set(ph) == {"forward", "backward", "optimizer", "total"}
    assert ph["forward"] > 0 and ph["total"] > 0
    assert all(v >= 0 for v in ph.values())
    assert ph["total"] >= ph["forward"] * 0.5
    # the functional step leaves the caller's state as it was
    for p, q in zip(state.params, before):
        assert all(torch.equal(p[k], q[k]) for k in p)


def test_isotonic_fit_is_monotone_and_mass_preserving():
    xs = [1.0, 3.0, 2.0, 2.0, 5.0, 4.0]
    fit = tprofile._isotonic(xs)
    assert all(b >= a for a, b in zip(fit, fit[1:]))
    assert sum(fit) == pytest.approx(sum(xs))
    assert tprofile._isotonic([1.0, 2.0, 3.0]) == [1.0, 2.0, 3.0]


SERVE = dict(model="rgat", dataset="aifb", scale=0.05, layers=2, dim=8,
             hidden=8, classes=4, fanouts=[3, 3], batch_size=8,
             num_batches=6, tile=8, node_block=8, device="cpu", log=_quiet)


def test_serve_disabled_records_nothing_and_keeps_signatures():
    """The reference's test with its loader-cache arguments: repeating
    traffic over two distinct batches with both caches on keeps zero new
    signatures after warmup, with obs off and on alike."""
    kwargs = dict(SERVE, repeat_after=2, cache_blocks=8, cache_layouts=32)
    off = serve_rgnn.serve(obs_mode="off", **kwargs)
    assert "metrics" not in off
    assert off["retraces_after_warmup"] == 0
    assert NULL_REGISTRY.counter("executor_traces").value == 0
    on = serve_rgnn.serve(obs_mode="on", **kwargs)
    assert "metrics" in on
    assert on["retraces_after_warmup"] == 0
    assert on["executor_traces"] == off["executor_traces"]
    assert snapshot_counter_total(on["metrics"], "executor_traces") \
        == on["executor_traces"]
    hs = snapshot_histogram(on["metrics"], "serve_batch_ms")
    assert hs["count"] == on["batches"]
    assert hs["p50"] <= hs["p99"]
    assert on["latency_ms_p50"] == hs["p50"]


# ---------------------------------------------------------------------------
# the instrumented layers
# ---------------------------------------------------------------------------
def test_executor_counters_mirror_its_signature_counts(profiled):
    eng, params, mb, feats, _ = profiled
    ex = executor.BlockExecutor(eng.plans, decisions=eng.decisions)
    with obs.scope(metrics=True) as sc:
        for _ in range(3):
            ex.run_minibatch(params, mb, feats)
        snap = sc.registry.snapshot()
    lab = dict(executor="BlockExecutor")
    assert (ex.trace_count, ex.cache_hits) == (1, 2)
    assert snapshot_value(snap, "executor_traces", **lab) == 1
    assert snapshot_value(snap, "executor_cache_misses", **lab) == 1
    assert snapshot_value(snap, "executor_cache_hits", **lab) == 2


def test_train_executor_counters_are_labelled_by_class(profiled):
    eng, params, mb, feats, _ = profiled
    opt = AdamW(learning_rate=1e-3)
    ex = executor.BlockTrainExecutor(eng.plans, opt)
    with obs.scope(metrics=True) as sc:
        ex.grad_and_update(opt.init(params), mb, torch.zeros(8, dtype=int),
                           {"feature": feats[mb.input_ids.long()]})
    assert sc.registry.value("executor_traces",
                             executor="BlockTrainExecutor") == 1


def _serve_three(**kw):
    """Serve with obs off, on, and on with tracing; the logits of every
    batch and the stats of each run."""
    runs = {}
    for mode, extra in (("off", {}), ("on", {}),
                        ("trace", dict(trace_out=kw.pop("trace_out"),
                                       metrics_out=kw.pop("metrics_out"),
                                       profile=True))):
        logits = []
        stats = serve_rgnn.serve(
            obs_mode="off" if mode == "off" else "on",
            on_batch=lambda mb, y: logits.append(y.clone()), **extra, **kw)
        runs[mode] = (logits, stats)
    return runs


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_serve_driver_is_bitwise_equal_with_obs_off_on_and_traced(
        sampler, tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    runs = _serve_three(**SERVE, sampler=sampler, trace_out=str(trace),
                        metrics_out=str(metrics))
    (off, s_off), (on, s_on), (tr, s_tr) = (runs[m] for m in
                                            ("off", "on", "trace"))
    assert len(off) == len(on) == len(tr) == SERVE["num_batches"]
    for a, b, c in zip(off, on, tr):
        assert torch.equal(a, b) and torch.equal(a, c)
    for key in ("executor_traces", "retraces_after_warmup",
                "executor_cache_hits"):
        assert s_off[key] == s_on[key] == s_tr[key]
    doc = json.loads(trace.read_text())
    assert schema.validate_trace(doc) == []
    assert rschema.validate_trace(doc) == []
    mdoc = json.loads(metrics.read_text())
    assert schema.validate_metrics(mdoc) == []
    assert mdoc == json.loads(json.dumps(s_tr["metrics"]))
    assert snapshot_histogram(mdoc, "serve_wait_ms")["count"] == \
        snapshot_histogram(mdoc, "serve_compute_ms")["count"] == \
        SERVE["num_batches"]
    if sampler == "host":
        phases = ["wait", "execute", "sample", "layout"]
        spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        tid = {e["name"]: e["tid"] for e in spans}
        assert tid["sample"] == tid["layout"] != tid["execute"]
    else:
        phases = ["wait", "execute", "sample_device", "layout_device"]
        assert snapshot_counter_total(mdoc, "sampler_traces") == \
            s_tr["sampler_traces"] > 0
        assert s_off["sampler_traces"] == s_tr["sampler_traces"]
    assert schema.require_phases(doc, phases) == []
    assert set(s_tr["phases"]) >= set(phases)
    assert "phases" not in s_on and "profile" not in s_on
    prof = s_tr["profile"]
    assert prof["backend"] == "cpu" and prof["total_us"] > 0
    assert {o["category"] for o in prof["ops"]} <= {"gemm", "traversal",
                                                    "wprod", "glue"}
    assert sum(o["category"] == "glue" for o in prof["ops"]) == 2


def test_serve_driver_flags(tmp_path):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    stats = serve_rgnn.main([
        "--device", "cpu", "--scale", "0.05", "--num-batches", "2",
        "--dim", "8", "--hidden", "8", "--classes", "3", "--batch-size",
        "4", "--tile", "8", "--node-block", "8", "--trace-out", str(trace),
        "--metrics-out", str(metrics), "--profile"])
    assert schema.validate_trace(json.loads(trace.read_text())) == []
    assert schema.validate_metrics(json.loads(metrics.read_text())) == []
    assert "profile" in stats
    off = serve_rgnn.main(["--device", "cpu", "--scale", "0.05",
                           "--num-batches", "1", "--dim", "8", "--hidden",
                           "8", "--classes", "3", "--batch-size", "4",
                           "--tile", "8", "--node-block", "8", "--obs",
                           "off"])
    assert "metrics" not in off
    with pytest.raises(ValueError, match="obs_mode"):
        serve_rgnn.serve(obs_mode="maybe", **SERVE)


TRAIN = dict(model="rgat", dataset="synthetic", scale=0.05, layers=2,
             dim=8, hidden=8, classes=4, fanouts=[3, 3], batch_size=32,
             epochs=1, tile=8, node_block=8, seed=0, eval_every_epochs=0,
             device="cpu", log=_quiet)


def test_train_driver_is_bitwise_equal_with_obs_off_on_and_traced(
        tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    off = train_rgnn.train(obs_mode="off", **TRAIN)
    on = train_rgnn.train(obs_mode="on", **TRAIN)
    tr = train_rgnn.train(obs_mode="on", trace_out=str(trace),
                          metrics_out=str(metrics), profile=True, **TRAIN)
    assert off["losses"] == on["losses"] == tr["losses"]
    assert off["full_train_loss"] == on["full_train_loss"] == \
        tr["full_train_loss"]
    for key in ("executor_traces", "retraces_after_warmup"):
        assert off[key] == on[key] == tr[key]
    assert "metrics" not in off and "profile" not in on
    doc = json.loads(trace.read_text())
    assert schema.validate_trace(doc) == []
    assert schema.require_phases(doc, ["train_step", "sample", "layout",
                                       "execute"]) == []
    steps = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "train_step"]
    assert len(steps) == tr["steps"]
    mdoc = json.loads(metrics.read_text())
    assert schema.validate_metrics(mdoc) == []
    assert snapshot_histogram(mdoc, "train_step_ms")["count"] == tr["steps"]
    assert snapshot_value(mdoc, "executor_traces",
                          executor="BlockTrainExecutor") == \
        tr["executor_traces"]
    ph = tr["profile"]
    assert set(ph) == {"forward", "backward", "optimizer", "total"}
    assert all(v >= 0 for v in ph.values()) and ph["total"] > 0


def test_train_driver_flags(tmp_path):
    trace = tmp_path / "t.json"
    stats = train_rgnn.main(["--device", "cpu", "--reduced", "--epochs",
                             "1", "--dim", "8", "--hidden", "8",
                             "--batch-size", "64", "--tile", "8",
                             "--node-block", "8", "--eval-every-epochs",
                             "0", "--trace-out", str(trace), "--profile",
                             "--obs", "on"])
    assert schema.require_phases(json.loads(trace.read_text()),
                                 ["train_step"]) == []
    assert set(stats["profile"]) == {"forward", "backward", "optimizer",
                                     "total"}


@pytest.mark.parametrize("driver", ["serve", "train"])
def test_tuner_counts_mirror_into_tune_counters(driver, tmp_path):
    cache = str(tmp_path / "tune.json")
    if driver == "serve":
        stats = serve_rgnn.serve(tune="full", tune_cache=cache,
                                 **dict(SERVE, num_batches=2))
    else:
        stats = train_rgnn.train(tune="full", tune_cache=cache, **TRAIN)
    assert stats["tune_measurements"] > 0
    for key in ("measurements", "cache_hits", "tuned_ops"):
        assert snapshot_counter_total(stats["metrics"], f"tune_{key}") == \
            stats[f"tune_{key}"]
