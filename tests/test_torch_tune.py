"""The port's autotuner (``repro_torch.tune``) on the CPU, mirroring
``tests/test_tune.py``: the ``tile_rows`` x ``tile_n`` variant space of the
GEMMs against the reference's ops in Pallas interpret mode; every forced
variant on every key of an RGAT and an RGCN plan (each materialization
choice) against the reference's ``HectorModule`` under the same decisions
(outputs rtol = atol = 2e-4, gradients normalized 5e-4, the bounds of
``tests/test_tune.py``); keys, candidates and pruning string for string
against the reference; the fusion budget; the persistent cache (schema,
atomic save, invalidation by a kernel source); ``full`` then ``cached``
with zero re-measurement; the drivers and ``hector_torch.compile`` with
``tune="full"``."""
import json
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hector_torch
from repro.core import codegen as rcodegen
from repro.core.graph import synthetic_heterograph as ref_graph
from repro.core.module import HectorModule as RefModule
from repro.kernels import layout as RL
from repro.kernels import ops as rops
from repro.kernels import ref as RR
from repro.train.engine import MODEL_PROGRAMS as REF_PROGRAMS
from repro.tune import cost as rcost
from repro.tune import device as rdevice
from repro.tune import space as rspace
from repro.tune.decisions import TuningDecisions as RefDecisions
from repro.tune.tuner import _KeyRecorder as RefRecorder
from repro_torch.core import codegen
from repro_torch.core.codegen import params_from_reference
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.core.ir import inter_op as I
from repro_torch.core.module import HectorModule, HectorStack
from repro_torch.kernels import layout as L
from repro_torch.kernels import ops
from repro_torch.launch import serve_rgnn, train_rgnn
from repro_torch.train.engine import MODEL_PROGRAMS
from repro_torch.tune import cache as tcache
from repro_torch.tune import cost, space
from repro_torch.tune import device as tdevice
from repro_torch.tune.cache import TuneCache
from repro_torch.tune.decisions import TuningDecisions
from repro_torch.tune.tuner import Tuner, _KeyRecorder

GRAPH = dict(num_nodes=96, num_edges=700, num_ntypes=3, num_etypes=5,
             seed=0, target_compaction=0.5)
QUIET = dict(log=lambda *a: None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# op level: the tile space of the GEMMs against the reference (interpret)
# ---------------------------------------------------------------------------
def _segments(rng, n_groups, max_size):
    sizes = rng.integers(1, max_size, n_groups)
    ptr = np.zeros(n_groups + 1, np.int64)
    np.cumsum(sizes, out=ptr[1:])
    return ptr, np.repeat(np.arange(n_groups), sizes), int(sizes.sum())


@pytest.mark.parametrize("tile_rows", [None, 8, 4])   # None: layout tile 16
@pytest.mark.parametrize("tile_n", [None, 8, 256])
def test_segment_mm_variant_space(tile_rows, tile_n):
    """K4 (and its K4 / K5 backward) across the row x column tile space
    against the reference op in interpret mode and its oracle, values and
    gradients."""
    rng = np.random.default_rng(7)
    ptr, seg_ids, m = _segments(rng, 4, 19)
    x = rng.normal(size=(m, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12, 24)).astype(np.float32)
    s = rng.normal(size=(m,)).astype(np.float32)
    ps = L.pad_segments(ptr, 16)
    lay, rlay = ops.padded_segments_dev(ps), rops.padded_segments_dev(
        RL.pad_segments(ptr, 16))
    kw = dict(tile_n=tile_n, tile_rows=tile_rows)
    rkw = dict(tile_n=tile_n or 128, tile_rows=tile_rows)

    ts = [_t(a).requires_grad_(True) for a in (x, w, s)]
    y = ops.segment_mm(*ts[:2], lay, row_scale=ts[2], **kw)
    torch.sum(torch.sin(y)).backward()
    ry = rops.segment_mm(jnp.asarray(x), jnp.asarray(w), rlay,
                         row_scale=jnp.asarray(s),
                         backend="pallas_interpret", **rkw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(RR.segment_mm_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(seg_ids),
            jnp.asarray(s))), rtol=1e-4, atol=1e-4)
    g = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(rops.segment_mm(
        a, b, rlay, row_scale=c, backend="pallas_interpret", **rkw))),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    for t, want in zip(ts, g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tile_rows", [None, 8])
@pytest.mark.parametrize("tile_n", [None, 8])
def test_segment_mm_gather_variant_space(tile_rows, tile_n):
    """K1 (with its scatter-add backward) across the tile space against
    the reference's gather-fused op in interpret mode."""
    rng = np.random.default_rng(8)
    ptr, seg_ids, m = _segments(rng, 4, 17)
    n_src = 11
    gidx = rng.integers(0, n_src, m)
    feats = rng.normal(size=(n_src, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12, 24)).astype(np.float32)
    ps = L.pad_segments(ptr, 16)
    gmap = L.compose_gather_rows(ps, gidx)
    lay = ops.padded_segments_dev(ps)
    rlay = rops.padded_segments_dev(RL.pad_segments(ptr, 16))
    rkw = dict(tile_n=tile_n or 128, tile_rows=tile_rows)

    ts = [_t(a).requires_grad_(True) for a in (feats, w)]
    y = ops.segment_mm_gather(*ts, lay, _t(gmap), tile_n=tile_n,
                              tile_rows=tile_rows)
    torch.sum(torch.sin(y)).backward()
    ry = rops.segment_mm_gather(jnp.asarray(feats), jnp.asarray(w), rlay,
                                jnp.asarray(gmap),
                                backend="pallas_interpret", **rkw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(RR.gather_mm_ref(
            jnp.asarray(feats), jnp.asarray(w), jnp.asarray(gidx),
            jnp.asarray(seg_ids))), rtol=1e-4, atol=1e-4)
    g = jax.grad(lambda a, b: jnp.sum(jnp.sin(rops.segment_mm_gather(
        a, b, rlay, jnp.asarray(gmap), backend="pallas_interpret", **rkw))),
        argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    for t, want in zip(ts, g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_gemm_tiles_subtile_the_group_map():
    ps = L.pad_segments(np.array([0, 5, 5, 40]), 16)
    lay = ops.padded_segments_dev(ps)
    t = ops.gemm_tiles(lay, tile_rows=4, tile_n=256)
    assert t.tile == 4 and t.cols(24) == 24 and t.cols(512) == 256
    assert ops.gemm_tiles(lay, tile_n=8).cols(12) == 12   # 8 does not divide
    assert t.t2g.tolist() == np.repeat(ps.tile_to_group, 4).tolist()
    t = ops.gemm_tiles(lay, tile_rows=5)          # not a divisor: the layout
    assert t.tile == 16 and t.t2g is lay.t2g and t.cols(24) is None
    with pytest.raises(ValueError, match="tile_n"):
        ops.segment_mm(torch.ones(40, 4), torch.ones(3, 4, 8), lay,
                       tile_n=0)


# ---------------------------------------------------------------------------
# plan level: forced decisions on every key against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def graphs():
    return synthetic_heterograph(**GRAPH), ref_graph(**GRAPH)


@pytest.fixture(scope="module")
def feats16():
    return np.random.default_rng(1).normal(
        size=(GRAPH["num_nodes"], 16)).astype(np.float32)


def _pair(name, graphs, compact_vars=None):
    """The port's and the reference's module for ``name`` (16 -> 24, tile
    and node block 16) on the same graph, and the same weights."""
    g, rg = graphs
    rmod = RefModule(REF_PROGRAMS[name](16, 24), rg, tile=16, node_block=16,
                     backend="pallas_interpret", compact_vars=compact_vars,
                     jit=False)
    mod = HectorModule(MODEL_PROGRAMS[name](16, 24), g, tile=16,
                       node_block=16, compact_vars=compact_vars)
    assert mod.describe() == rmod.describe()
    rparams = rmod.init(jax.random.key(0))
    (params,) = params_from_reference(
        [{k: np.asarray(v) for k, v in rparams.items()}], plans=[mod.plan],
        num_etypes=g.num_etypes, num_ntypes=g.num_ntypes)
    return mod, rmod, params, rparams


def _port_keys(mod, params, feats):
    rec = _KeyRecorder()
    with torch.no_grad():
        codegen.execute_plan(mod.plan, params, mod.gt,
                             {"feature": _t(feats)}, mod.layouts, rec)
    return rec.keys


def _ref_keys(rmod, rparams, feats):
    rec = RefRecorder()
    jax.eval_shape(lambda p, f: rcodegen.execute_plan(
        rmod.plan, p, rmod.gt, f, rmod.layouts, rmod.backend, rec),
        rparams, {"feature": jnp.asarray(feats)})
    return rec.keys


VARIANTS = [
    {},                                             # defaults
    {"fuse_gather": False},
    {"tile_rows": 8},
    {"tile_rows": 8, "fuse_gather": False},
    {"tile_rows": 8, "tile_n": 8, "fuse_gather": True},
]


@pytest.mark.parametrize("name", ["rgat", "rgcn"])
@pytest.mark.parametrize("compact_vars", [frozenset(), None])  # none / all
@pytest.mark.parametrize("variant_kw", VARIANTS)
def test_forced_variants_match_reference(graphs, feats16, name,
                                         compact_vars, variant_kw):
    """One variant forced onto EVERY op of the plan, on the port and on the
    reference (same keys): outputs and gradients agree."""
    mod, rmod, params, rparams = _pair(name, graphs, compact_vars)
    keys = _port_keys(mod, params, feats16)
    assert keys == _ref_keys(rmod, rparams, feats16)
    ours, theirs = TuningDecisions(), RefDecisions()
    for key in keys:
        if key.startswith("gemm"):
            ours.set_op(key, space.GemmVariant(**variant_kw))
            theirs.set_op(key, rspace.GemmVariant(**variant_kw))
        else:
            fg = variant_kw.get("fuse_gather")
            ours.set_op(key, space.TravVariant(fuse_gather=fg))
            theirs.set_op(key, rspace.TravVariant(fuse_gather=fg))
    mod.executor.set_decisions(ours)
    rmod.decisions = theirs
    out_name = mod.plan.outputs[0]

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    got = mod.apply(leaves, {"feature": _t(feats16)})[out_name]
    torch.sum(got ** 2).backward()
    want = rmod.apply(rparams, {"feature": jnp.asarray(feats16)})[out_name]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    g_ref = jax.grad(lambda p: jnp.sum(rmod.apply(
        p, {"feature": jnp.asarray(feats16)})[out_name] ** 2))(rparams)
    for k, t in leaves.items():
        ref = np.asarray(g_ref[k])
        denom = float(np.abs(ref).max()) + 1e-9
        np.testing.assert_allclose(t.grad.numpy() / denom, ref / denom,
                                   rtol=5e-4, atol=5e-4, err_msg=k)


@pytest.mark.parametrize("fuse", [True, False])
def test_decisions_dispatch_to_the_variant_kernels(graphs, feats16, fuse,
                                                   monkeypatch):
    """A decision changes which kernel runs: forcing ``fuse_gather=False``
    on every key routes the GEMMs to K4 and the aggregation to K6 (RGAT),
    and ``True`` to K1 and K3; the default table stays on K1 / K3."""
    mod = HectorModule(MODEL_PROGRAMS["rgat"](16, 24), graphs[0], tile=16,
                       node_block=16)
    params = mod.init(torch.Generator().manual_seed(0))
    calls = {n: 0 for n in ("segment_mm_gather_padded", "segment_mm_padded",
                            "seg_softmax_agg_gather_padded",
                            "seg_softmax_agg_padded")}

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    d = TuningDecisions()
    for key in _port_keys(mod, params, feats16):
        d.set_op(key, space.GemmVariant(fuse_gather=fuse)
                 if key.startswith("gemm") else
                 space.TravVariant(fuse_gather=fuse))
    mod.executor.set_decisions(d)
    for n in ("segment_mm_gather_padded", "seg_softmax_agg_gather_padded",
              "seg_softmax_agg_padded"):
        spy(ops, n)
    spy(ops.SK, "segment_mm_padded")
    with torch.no_grad():
        mod.apply(params, {"feature": _t(feats16)})
    if fuse:
        assert calls["segment_mm_gather_padded"] == 3
        assert calls["seg_softmax_agg_gather_padded"] == 1
        assert calls["segment_mm_padded"] == 0
        assert calls["seg_softmax_agg_padded"] == 0
    else:
        assert calls["segment_mm_gather_padded"] == 0
        assert calls["seg_softmax_agg_gather_padded"] == 0
        assert calls["segment_mm_padded"] == 3
        assert calls["seg_softmax_agg_padded"] == 1


def test_decision_naming_another_backend_raises(graphs, feats16):
    """The port has its own kernels only: a decision that names another
    backend (here the reference's ``xla``) is refused, not run as
    something else."""
    mod = HectorModule(MODEL_PROGRAMS["rgcn"](16, 24), graphs[0], tile=16,
                       node_block=16)
    params = mod.init(torch.Generator().manual_seed(0))
    for key in _port_keys(mod, params, feats16):
        d = TuningDecisions()
        d.set_op(key, space.GemmVariant(backend="xla")
                 if key.startswith("gemm") else
                 space.TravVariant(backend="xla"))
        mod.executor.set_decisions(d)
        with pytest.raises(ValueError, match="names backend 'xla'"):
            mod.apply(params, {"feature": _t(feats16)})


# ---------------------------------------------------------------------------
# keys, candidates and the cost model, string for string
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["rgat", "rgcn", "hgt"])
@pytest.mark.parametrize("compact_vars", [frozenset(), None])
def test_keys_and_candidates_equal_the_reference(graphs, feats16, name,
                                                 compact_vars):
    """The CPU keys the port records equal the reference's; each key's
    candidates are the reference's ``pallas_interpret`` space without its
    other-backend variants; pruning and scores agree."""
    mod, rmod, params, rparams = _pair(name, graphs, compact_vars)
    keys = _port_keys(mod, params, feats16)
    assert keys and keys == _ref_keys(rmod, rparams, feats16)
    assert any(k.startswith("gemm") for k in keys)
    for key in keys:
        assert key.endswith("|float32|cpu")
        assert space.parse_key(key) == rspace.parse_key(key)
        ref_cands = [v for v in rspace.candidates_for_key(
            key, "pallas_interpret") if v.backend == rspace.DEFAULT]
        cands = space.candidates_for_key(key, "cpu")
        assert [v.to_json() for v in cands] == \
            [v.to_json() for v in ref_cands]
        for v, rv in zip(cands, ref_cands):
            assert cost.score(key, v, "cpu") == \
                rcost.score(key, rv, "pallas_interpret")
        for k in (1, 3, 4):
            assert [v.to_json() for v in cost.prune(key, cands, "cpu", k)] \
                == [v.to_json() for v in rcost.prune(
                    key, ref_cands, "pallas_interpret", k)]


def test_key_roundtrip_and_prune(graphs, feats16):
    mod, _, params, _ = _pair("rgat", graphs)
    for key in _port_keys(mod, params, feats16):
        info = space.parse_key(key)
        assert info["kind"] in ("gemm", "trav")
        cands = space.candidates_for_key(key, "cpu")
        assert cands[0] in (space.GEMM_DEFAULT, space.TRAV_DEFAULT)
        assert all(v.backend == space.DEFAULT for v in cands)
        pruned = cost.prune(key, cands, "cpu", k=3)
        assert pruned[0] == cands[0] and len(pruned) <= 3
        assert all(np.isfinite(cost.score(key, v, "cpu")) for v in pruned)
        assert space.variant_from_json(cands[-1].to_json()) == cands[-1]
    with pytest.raises(ValueError, match="unparseable"):
        space.parse_key("lay|x")


def test_card_keys_have_no_infeasible_variant():
    """On a CUDA card's key the budget is unbounded: no variant is
    infeasible, even where the predicted bytes pass the reference's 1e9
    sentinel (8-row tiles over a million padded rows), and ``prune`` keeps
    the top ``k`` by predicted bytes."""
    card = "cuda:NVIDIA H100 80GB HBM3"
    gemm = (f"gemm|edge_src|etype|etype_ptr|k64|n64|s0|t32|g122|"
            f"rp1048576|x131072|float32|{card}")
    trav = f"trav|softmax_agg|d64|c1|et32|nb32|ep1048576|float32|{card}"
    for key in (gemm, trav):
        cands = space.candidates_for_key(key, "cuda")
        scores = [cost.score(key, v, "cuda") for v in cands]
        assert all(np.isfinite(scores))
        pruned = cost.prune(key, cands, "cuda", k=3)
        assert len(pruned) == min(3, len(cands))
        rest = sorted(cost.score(key, v, "cuda") for v in cands[1:])
        assert [cost.score(key, v, "cuda") for v in pruned[1:]] == \
            rest[:len(pruned) - 1]
    # the same shapes on the CPU: the fused variants past the budget go
    cpu = trav.replace(card, "cpu")
    assert cost.score(cpu, space.TravVariant(fuse_gather=True), "cpu") \
        == float("inf")


# ---------------------------------------------------------------------------
# the fusion budget
# ---------------------------------------------------------------------------
def test_fits_budget_counts_index_bytes(monkeypatch):
    src = torch.zeros((100, 10))                 # 4000 bytes
    gmap = torch.zeros((300,), dtype=torch.int32)   # 1200 bytes
    monkeypatch.setenv(tdevice.BUDGET_ENV, "5000")
    assert codegen._fits_budget(src)
    assert not codegen._fits_budget(src, gmap)
    monkeypatch.setenv(tdevice.BUDGET_ENV, "6000")
    assert codegen._fits_budget(src, gmap)
    assert codegen._fits_budget(src, None)        # absent maps are free


def test_budget_on_the_cpu_equals_the_reference(monkeypatch):
    for env in (tdevice.BUDGET_ENV, tdevice.VMEM_ENV):
        monkeypatch.delenv(env, raising=False)
    assert tdevice.device_kind("cpu") == rdevice.device_kind() == "cpu"
    assert tdevice.fused_gather_budget_bytes("cpu") == \
        rdevice.fused_gather_budget_bytes() == 4 * 1024 * 1024
    monkeypatch.setenv(tdevice.VMEM_ENV, str(8 * 1024 * 1024))
    assert tdevice.fused_gather_budget_bytes("cpu") == \
        rdevice.fused_gather_budget_bytes() == 2 * 1024 * 1024
    # a card has no residency limit, unless the budget is set outright
    assert tdevice.budget_for_kind("cuda:NVIDIA H100") == tdevice.UNBOUNDED
    monkeypatch.setenv(tdevice.BUDGET_ENV, "123")
    assert tdevice.budget_for_kind("cuda:NVIDIA H100") == 123
    assert tdevice.fused_gather_budget_bytes("cpu") == 123
    assert tdevice.device_limits("cpu") == {
        "shared_memory_per_block_optin": None, "l2_cache_bytes": None}


# ---------------------------------------------------------------------------
# per-var materialization
# ---------------------------------------------------------------------------
def test_stack_takes_per_layer_compact_vars(graphs):
    g = graphs[0]
    progs = [MODEL_PROGRAMS["rgat"](16, 16), MODEL_PROGRAMS["rgat"](16, 4)]
    stack = HectorStack(progs, g, tile=16, node_block=16,
                        compact_vars=[frozenset(), None])
    layouts = [set(p.layouts.values()) for p in stack.plans]
    assert I.Layout.COMPACT not in layouts[0]
    assert I.Layout.COMPACT in layouts[1]
    with pytest.raises(ValueError, match="one compact-var set per layer"):
        HectorStack(progs, g, compact_vars=[None])


# ---------------------------------------------------------------------------
# the persistent cache
# ---------------------------------------------------------------------------
def test_tune_cache_schema_and_atomicity(tmp_path):
    path = str(tmp_path / "c.json")
    c = TuneCache(path)
    c.put("k1", {"kind": "gemm", "backend": "default", "tile_rows": 8,
                 "tile_n": None, "fuse_gather": None})
    c.save()
    assert not [p for p in tmp_path.iterdir() if p.name != "c.json"]
    c2 = TuneCache(path)
    assert space.variant_from_json(c2.get("k1")) == \
        space.GemmVariant(tile_rows=8)
    with open(path, "w") as f:
        f.write('{"version": 999, "entries": {"k1": 1}}')
    assert TuneCache(path).get("k1") is None
    with open(path, "w") as f:
        f.write("not json")
    assert TuneCache(path).get("k1") is None


def test_default_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(tcache.CACHE_ENV, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert tcache.default_cache_path() == str(
        tmp_path / "repro_torch-tune.json")
    monkeypatch.setenv(tcache.CACHE_ENV, str(tmp_path / "x.json"))
    assert tcache.default_cache_path() == str(tmp_path / "x.json")
    assert tcache.CACHE_ENV != "REPRO_TUNE_CACHE"


@pytest.mark.parametrize("source", tcache.FINGERPRINTED)
def test_tune_cache_invalidated_by_a_kernel_source(source, tmp_path,
                                                   monkeypatch):
    """A change to any fingerprinted source of the port (the kernel
    wrappers, ops, codegen, and the CUDA sources) drops measured
    decisions."""
    pkg = tmp_path / "pkg"
    for rel in tcache.FINGERPRINTED:
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(tcache._PKG / rel, pkg / rel)
    monkeypatch.setattr(tcache, "_PKG", pkg)
    tcache.code_fingerprint.cache_clear()
    try:
        path = str(tmp_path / "c.json")
        c = TuneCache(path)
        c.put("k1", {"kind": "trav", "backend": "default",
                     "fuse_gather": False})
        c.save()
        with open(path) as f:
            assert json.load(f)["code"] == tcache.code_fingerprint()
        assert TuneCache(path).get("k1") is not None
        with open(pkg / source, "a") as f:
            f.write("\n// changed\n" if source.endswith(".cu")
                    else "\n# changed\n")
        tcache.code_fingerprint.cache_clear()
        assert TuneCache(path).get("k1") is None
    finally:
        tcache.code_fingerprint.cache_clear()


# ---------------------------------------------------------------------------
# the tuner: full, then cached with zero measurements
# ---------------------------------------------------------------------------
def test_tuner_full_then_cached_replays_without_measuring(graphs, tmp_path):
    cache = str(tmp_path / "tune.json")
    g = graphs[0]
    progs = [MODEL_PROGRAMS["rgat"](16, 24)]
    t1 = Tuner(mode="full", cache_path=cache, iters=1, warmup=0)
    rep1 = t1.tune_stack(progs, g, tile=16, node_block=16, feat_dims=[16])
    assert t1.stats["measurements"] > 0 and t1.stats["tuned_ops"] > 0
    assert len(rep1.decisions.ops) > 0 and len(rep1.decisions.layout) == 1
    with open(cache) as f:
        assert json.load(f)["version"] == tcache.SCHEMA_VERSION

    for mode in ("full", "cached"):
        t2 = Tuner(mode=mode, cache_path=cache, iters=1, warmup=0)
        rep2 = t2.tune_stack(progs, g, tile=16, node_block=16,
                             feat_dims=[16])
        assert t2.stats["measurements"] == 0
        assert t2.stats["cache_hits"] == t1.stats["tuned_ops"] + 1  # +layout
        assert rep2.decisions.fingerprint() == rep1.decisions.fingerprint()
        assert (rep2.tile, rep2.node_block) == (rep1.tile, rep1.node_block)
        assert rep2.compact_vars == rep1.compact_vars

    # a cold cache in cached mode: the defaults, nothing measured
    t3 = Tuner(mode="cached", cache_path=str(tmp_path / "cold.json"))
    rep3 = t3.tune_stack(progs, g, tile=16, node_block=16, feat_dims=[16])
    assert t3.stats == {"measurements": 0, "cache_hits": 0, "tuned_ops": 0}
    assert (rep3.tile, rep3.node_block) == (16, 16)
    assert rep3.compact_vars == [None] and len(rep3.decisions) == 0
    with pytest.raises(ValueError, match="tune mode"):
        Tuner(mode="sometimes")


def test_measure_and_measure_group_call_pattern():
    """``measure`` runs a first call, ``warmup`` untimed calls and ``iters``
    timed ones; ``measure_group`` warms every candidate first, then
    round-robins the timed calls across the group."""
    from repro_torch.tune import measure, measure_group

    order = []
    t = measure(lambda: order.append("a"), warmup=2, iters=3)
    assert order == ["a"] * 6 and t >= 0.0
    order.clear()
    ts = measure_group([(order.append, ("a",)), (order.append, ("b",))],
                       warmup=1, iters=2)
    assert order == ["a", "a", "b", "b", "a", "b", "a", "b"]
    assert len(ts) == 2 and all(x >= 0.0 for x in ts)


# ---------------------------------------------------------------------------
# the entry points with tune="full" on the CPU
# ---------------------------------------------------------------------------
DIMS = dict(dim=8, hidden=8, classes=3)


def test_compile_tunes_and_block_tuning_replays(tmp_path):
    g = synthetic_heterograph(80, 500, 3, 4, seed=1, target_compaction=0.5)
    cache = str(tmp_path / "t.json")
    kw = dict(layers=2, sample=[3, 3], tile=8, node_block=8, device="cpu",
              tune_cache=cache, **DIMS)
    c = hector_torch.compile("rgcn", g, tune="full", **kw)
    assert c.tuner_stats["measurements"] > 0
    assert c.decisions is c.stack.block_executor.decisions
    params = c.init(0)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(g.num_nodes, 8)).astype(np.float32))
    loader = c.make_loader(lambda step: np.arange(6, dtype=np.int32),
                           num_batches=1)
    mb = next(loader)
    loader.close()
    before = len(c.decisions.ops)
    c.tune_minibatch(params, mb, x)
    assert len(c.decisions.ops) > before          # block-scale keys added
    y = c.apply_blocks(params, mb, x)
    assert y.shape == (6, 3) and torch.isfinite(y).all()

    c2 = hector_torch.compile("rgcn", g, tune="cached", **kw)
    c2.tune_minibatch(params, mb, x)
    assert c2.tuner_stats["measurements"] == 0
    assert c2.decisions.fingerprint() == c.decisions.fingerprint()
    torch.testing.assert_close(c2.apply_blocks(params, mb, x), y)
    off = hector_torch.compile("rgcn", g, **kw)
    assert off.tuner_stats == {} and off.decisions is None
    torch.testing.assert_close(off.apply_blocks(params, mb, x), y,
                               rtol=2e-4, atol=2e-4)


def test_serve_driver_tunes_then_replays(tmp_path):
    cache = str(tmp_path / "serve.json")
    kw = dict(model="rgat", dataset="aifb", scale=0.05, layers=2,
              fanouts=[3, 3], batch_size=8, num_batches=2, tile=8,
              node_block=8, seed=0, device="cpu", tune_cache=cache,
              **QUIET, **DIMS)
    logits = {}
    for mode in ("full", "cached", "off"):
        got = []
        stats = serve_rgnn.serve(**kw, tune=mode,
                                 on_batch=lambda mb, y: got.append(y))
        logits[mode] = got
        if mode == "off":
            assert not any(k.startswith("tune_") for k in stats)
        elif mode == "full":
            assert stats["tune_measurements"] > 0
        else:
            assert stats["tune_measurements"] == 0
            assert stats["tune_cache_hits"] > 0
    for mode in ("cached", "off"):
        for a, b in zip(logits["full"], logits[mode]):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    assert serve_rgnn.main(["--device", "cpu", "--scale", "0.05",
                            "--num-batches", "1", "--dim", "8", "--hidden",
                            "8", "--classes", "3", "--batch-size", "4",
                            "--tile", "8", "--node-block", "8", "--tune",
                            "cached", "--tune-cache", cache])[
        "tune_measurements"] == 0


def test_train_driver_tunes_then_replays(tmp_path):
    cache = str(tmp_path / "train.json")
    kw = dict(model="rgat", dataset="synthetic", scale=0.05, layers=2,
              fanouts=[3, 3], batch_size=16, epochs=1, tile=8,
              node_block=8, seed=0, device="cpu", tune_cache=cache,
              eval_every_epochs=0, **QUIET, **DIMS)
    full = train_rgnn.train(**kw, tune="full")
    assert full["tune_measurements"] > 0 and full["tune_tuned_ops"] > 0
    cached = train_rgnn.train(**kw, tune="cached")
    assert cached["tune_measurements"] == 0
    # every decision the first run measured or replayed, and its layout
    assert cached["tune_cache_hits"] == (full["tune_tuned_ops"]
                                         + full["tune_cache_hits"] + 1)
    np.testing.assert_allclose(cached["losses"], full["losses"], rtol=1e-5)
    assert all(np.isfinite(full["losses"]))
    stats = train_rgnn.main(["--device", "cpu", "--dataset", "synthetic",
                             "--scale", "0.05", "--epochs", "1", "--dim",
                             "8", "--hidden", "8", "--classes", "3",
                             "--tile", "8", "--node-block", "8", "--tune",
                             "cached", "--tune-cache", cache])
    assert stats["tune_measurements"] == 0


def test_card_keys_measure_the_kernels_default_column_tile():
    """On a CUDA key the default column tile is the kernels' 64 columns
    (``kColTile``), not the reference's 128: for n = 128 the candidates
    hold ``tile_n=128`` (a distinct kernel configuration), and the cost
    prior counts 64-column steps for the default. CPU keys keep the
    reference's default."""
    card = "cuda:NVIDIA H100 80GB HBM3"
    key = (f"gemm|edge_src|etype|etype_ptr|k64|n128|s0|t32|g4|"
           f"rp1024|x512|float32|{card}")
    cands = space.candidates_for_key(key, "cuda")
    assert space.GemmVariant(tile_n=128) in cands
    assert tdevice.default_tile_n(card) == 64
    steps = 1024 // 32
    default = cost.score(key, space.GEMM_DEFAULT, "cuda")
    wide = cost.score(key, space.GemmVariant(tile_n=128), "cuda")
    assert default - wide == steps * (128 // 64 - 1) * \
        cost._GRID_STEP_COST_BYTES
    # n = 64 clips every request to the default on the card too
    narrow = key.replace("|n128|", "|n64|")
    assert all(v.tile_n is None
               for v in space.candidates_for_key(narrow, "cuda"))
    # the CPU key of the same op keeps the reference's list and score
    cpu = key.replace(card, "cpu")
    assert all(v.tile_n is None
               for v in space.candidates_for_key(cpu, "cpu"))
    assert cost.score(cpu, space.GEMM_DEFAULT, "cpu") == \
        rcost.score(cpu, rspace.GEMM_DEFAULT, "pallas_interpret")
