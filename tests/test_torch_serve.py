"""The port's slice end to end against the reference: ``hector_torch.compile``
on the CPU vs ``hector.compile`` (Pallas interpret) with the same weights
and mini-batch, the serving driver vs the reference driver, the GPU-default
entry points, and the port's independence from JAX and the reference."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

import hector
import hector_torch
from repro.core.graph import synthetic_heterograph as ref_graph
from repro.launch import serve_rgnn as ref_serve
from repro.sampling import build_minibatch as ref_build
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.launch import serve_rgnn
from repro_torch.sampling import build_minibatch

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIMS = dict(dim=16, hidden=16, classes=4)


def _np_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.fixture(scope="module")
def compiled_pair():
    kw = dict(num_nodes=200, num_edges=1400, num_ntypes=3, num_etypes=6,
              seed=2)
    g, rg = synthetic_heterograph(**kw), ref_graph(**kw)
    ref = hector.compile("rgat", rg, layers=2, sample=3, tile=8,
                         node_block=8, backend="pallas_interpret", **DIMS)
    ours = hector_torch.compile("rgat", g, layers=2, sample=3, tile=8,
                                node_block=8, device="cpu", **DIMS)
    rparams = ref.init(jax.random.key(0))
    params = ours.params_from_reference(_np_params(rparams))
    feats = np.random.default_rng(1).normal(
        size=(g.num_nodes, DIMS["dim"])).astype(np.float32)
    return ours, ref, params, rparams, feats


@pytest.mark.parametrize("bucket", [True, False])
def test_compile_apply_blocks_matches_reference(compiled_pair, bucket):
    ours, ref, params, rparams, feats = compiled_pair
    seeds = np.array([3, 17, 17, 150, 42, 99, 0, 199], np.int32)
    seq = ours.sampler.sample(seeds, batch_index=4)
    rseq = ref.sampler.sample(seeds, batch_index=4)
    mb = build_minibatch(seq, tile=8, node_block=8, bucket=bucket)
    rmb = ref_build(rseq, tile=8, node_block=8, bucket=bucket)
    out = ours.apply_blocks(params, mb, torch.from_numpy(feats))
    rout = ref.apply_blocks(rparams, rmb, jax.numpy.asarray(feats))
    assert out.shape == (len(seeds), DIMS["classes"])
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(rout),
                               rtol=1e-4, atol=1e-4)
    assert ours.describe() == ref.describe()


@pytest.mark.parametrize("model", ["rgcn", "hgt", "rgcn_cat"])
def test_new_models_apply_blocks_match_reference(model):
    """RGCN (K1 + K7), HGT (K4 on node types, K1, K2 + K3) and rgcn_cat:
    a sampled, bucketed mini-batch through the port on the CPU against the
    reference (Pallas interpret) with the same weights."""
    kw = dict(num_nodes=200, num_edges=1400, num_ntypes=3, num_etypes=6,
              seed=2)
    g, rg = synthetic_heterograph(**kw), ref_graph(**kw)
    ref = hector.compile(model, rg, layers=2, sample=3, tile=8,
                         node_block=8, backend="pallas_interpret", **DIMS)
    ours = hector_torch.compile(model, g, layers=2, sample=3, tile=8,
                                node_block=8, device="cpu", **DIMS)
    assert ours.describe() == ref.describe()
    rparams = ref.init(jax.random.key(0))
    params = ours.params_from_reference(_np_params(rparams))
    feats = np.random.default_rng(1).normal(
        size=(g.num_nodes, DIMS["dim"])).astype(np.float32)
    seeds = np.array([3, 17, 17, 150, 42, 99, 0, 199], np.int32)
    mb = build_minibatch(ours.sampler.sample(seeds, batch_index=4), tile=8,
                         node_block=8, bucket=True)
    rmb = ref_build(ref.sampler.sample(seeds, batch_index=4), tile=8,
                    node_block=8, bucket=True)
    out = ours.apply_blocks(params, mb, torch.from_numpy(feats))
    rout = ref.apply_blocks(rparams, rmb, jax.numpy.asarray(feats))
    assert out.shape == (len(seeds), DIMS["classes"])
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(rout),
                               rtol=1e-4, atol=1e-4)


def test_compile_model_args_bind_and_reject_as_the_reference():
    g = synthetic_heterograph(60, 300, 2, 4, seed=0)
    rg = ref_graph(60, 300, 2, 4, seed=0)
    kw = dict(layers=1, tile=8, node_block=8, **DIMS)
    ours = hector_torch.compile("rgcn", g, device="cpu",
                                model_args={"activation": "tanh"}, **kw)
    ref = hector.compile("rgcn", rg, model_args={"activation": "tanh"},
                         **kw)
    assert ours.describe() == ref.describe()
    assert "tanh" in ours.describe()
    assert ours.engine.cfg.model_name == ref.engine.cfg.model_name
    plain = hector_torch.compile("rgcn", g, device="cpu", **kw)
    assert "tanh" not in plain.describe()
    # a model hyperparameter as a plain keyword (no collision)
    rgat = hector_torch.compile("rgat", g, device="cpu", slope=0.2, **kw)
    assert rgat.describe() == hector.compile("rgat", rg, slope=0.2,
                                             **kw).describe()
    for fn, kwargs in ((hector_torch.compile, dict(device="cpu")),
                       (hector.compile, {})):
        graph = g if fn is hector_torch.compile else rg
        with pytest.raises(ValueError, match="unknown model 'gcn'"):
            fn("gcn", graph, model_args={"activation": "tanh"}, **kwargs,
               **kw)
        with pytest.raises(ValueError, match="unknown model 'gcn'"):
            fn("gcn", graph, **kwargs, **kw)


@pytest.mark.parametrize("model", ["rgcn", "hgt", "rgcn_cat"])
def test_serve_driver_runs_every_model_on_the_cpu(model):
    logits = []
    stats = serve_rgnn.serve(
        model=model, dataset="aifb", scale=0.05, layers=2, fanouts=[3, 3],
        batch_size=8, num_batches=2, tile=8, node_block=8, seed=0,
        device="cpu", log=lambda *a: None,
        on_batch=lambda mb, y: logits.append(y), **DIMS)
    assert stats["batches"] == 2 and len(logits) == 2
    assert all(y.shape == (8, DIMS["classes"]) and torch.isfinite(y).all()
               for y in logits)
    assert serve_rgnn.main(["--model", model, "--device", "cpu",
                            "--scale", "0.05", "--num-batches", "1",
                            "--dim", "8", "--hidden", "8", "--classes", "3",
                            "--batch-size", "4", "--tile", "8",
                            "--node-block", "8"])["batches"] == 1


def test_params_from_reference_checks_the_weight_table(compiled_pair):
    ours, _, _, rparams, _ = compiled_pair
    bad = _np_params(rparams)
    bad[0]["W_rel"] = bad[0]["W_rel"][:, :, :3]
    with pytest.raises(ValueError, match="W_rel"):
        ours.params_from_reference(bad)
    missing = _np_params(rparams)
    del missing[1]["w_att_dst"]
    with pytest.raises(ValueError, match="weight table"):
        ours.params_from_reference(missing)


def test_serve_driver_matches_reference_driver():
    kw = dict(model="rgat", dataset="aifb", scale=0.05, layers=2,
              fanouts=[5, 5], batch_size=8, num_batches=3, tile=8,
              node_block=8, seed=0, log=lambda *a: None, **DIMS)
    rstats = ref_serve.serve(**kw)
    # the reference driver's weights, as its engine draws them
    rg = ref_serve.table3_graph("aifb", scale=0.05, seed=0)
    rparams = hector.compile("rgat", rg, layers=2, sample=[5, 5], tile=8,
                             node_block=8, **DIMS).init(jax.random.key(0))
    logits = []
    stats = serve_rgnn.serve(**kw, device="cpu",
                             params=_np_params(rparams),
                             on_batch=lambda mb, y: logits.append(y))
    np.testing.assert_array_equal(stats["last_preds"], rstats["last_preds"])
    assert len(logits) == 3 and all(torch.isfinite(y).all() for y in logits)
    for key in ("batches", "batch_size", "latency_ms_p50", "seeds_per_s",
                "executor_traces", "retraces_after_warmup", "host_builds"):
        assert key in stats
    assert stats["batches"] == rstats["batches"] == 3


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = synthetic_heterograph(50, 200, 2, 3, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hector_torch.compile("rgat", g, **DIMS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_rgnn.serve(scale=0.01, log=lambda *a: None, **DIMS)


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro\b|hector\b)", re.M)


def test_port_imports_nothing_of_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "src" / "hector_torch.py", ROOT / "chip_smoke.py",
              ROOT / "tenant_probe.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro', 'hector'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch, hector_torch\n"
        "from repro_torch.core.graph import synthetic_heterograph\n"
        "from repro_torch.launch import serve_rgnn\n"
        "from repro_torch.sampling import build_minibatch\n"
        "g = synthetic_heterograph(60, 300, 2, 4, seed=0)\n"
        "c = hector_torch.compile('rgat', g, dim=8, hidden=8, classes=3,\n"
        "                         tile=8, node_block=8, device='cpu')\n"
        "mb = build_minibatch(c.sampler.sample(np.arange(5)), tile=8,\n"
        "                     node_block=8, bucket=True)\n"
        "y = c.apply_blocks(c.init(0), mb, torch.randn(60, 8))\n"
        "assert y.shape == (5, 3) and torch.isfinite(y).all()\n"
        "assert not any(k.startswith(('jax', 'repro.')) for k, v in\n"
        "               sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_block_executor_counts_new_and_repeated_signatures(compiled_pair):
    ours, _, params, _, feats = compiled_pair
    ex = ours.block_executor
    before = (ex.trace_count, ex.cache_hits)
    seq = ours.sampler.sample(np.array([1, 2, 3], np.int32), batch_index=0)
    mb = build_minibatch(seq, tile=8, node_block=8, bucket=True)
    x = torch.from_numpy(feats)
    a = ours.apply_blocks(params, mb, x)
    b = ours.apply_blocks(params, mb, x)
    assert (ex.trace_count, ex.cache_hits) == (before[0] + 1, before[1] + 1)
    assert torch.equal(a, b)          # eager and deterministic on the CPU


def test_fused_region_returns_attention_when_it_is_an_output():
    """The fused softmax+aggregate region computes the per-edge attention
    only when something reads it; here the plan returns it, so both outputs
    equal the reference's (Pallas interpret), and so do the gradients of a
    loss over both, taken through the attention's own autograd Function
    (K2's statistics, the softmax VJP) and the fused region's."""
    from repro.core import codegen as rcodegen
    from repro.core.ir.passes import lower_program as ref_lower
    from repro_torch.core import codegen
    from repro_torch.core.ir.passes import lower_program

    def body(dsl):
        def att_model(g, e, n, i, o):
            W = g.weight("W_rel", (i, o), indexed_by="etype")
            w_s = g.weight("w_att_src", (o,), indexed_by="etype")
            e["hs"] = e.src["feature"] @ W
            e["s"] = dsl.dot(e["hs"], w_s)
            e["att"] = dsl.edge_softmax(e["s"])
            n["h"] = dsl.aggregate(e["hs"], scale=e["att"])
            return n["h"], e["att"]
        return dsl.model(att_model)(6, 5)

    kw = dict(num_nodes=40, num_edges=160, num_ntypes=2, num_etypes=3,
              seed=1)
    g, rg = synthetic_heterograph(**kw), ref_graph(**kw)
    plan = lower_program(body(hector_torch))
    rplan = ref_lower(body(hector))
    assert plan.fingerprint() == rplan.fingerprint()
    params = codegen.init_params(plan, g.num_etypes, g.num_ntypes,
                                 torch.Generator().manual_seed(0))
    x = np.random.default_rng(1).normal(size=(40, 6)).astype(np.float32)
    kl = codegen.build_kernel_layouts(g, tile=8, node_block=8)
    rkl = rcodegen.build_kernel_layouts(rg, tile=8, node_block=8)
    with torch.no_grad():
        out = codegen.execute_plan(
            plan, params, g.to_tensors(), {"feature": torch.from_numpy(x)},
            kl)
    rparams = {k: jax.numpy.asarray(v.numpy()) for k, v in params.items()}

    def rrun(p):
        return rcodegen.execute_plan(
            rplan, p, rg.to_tensors(), {"feature": jax.numpy.asarray(x)},
            rkl, backend="pallas_interpret")

    rout = rrun(rparams)
    assert set(out) == set(rout) == {"h", "att"}
    np.testing.assert_allclose(out["att"].numpy(), np.asarray(rout["att"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["h"].numpy(), np.asarray(rout["h"]),
                               rtol=1e-4, atol=1e-4)

    rng = np.random.default_rng(2)
    c_h = rng.normal(size=out["h"].shape).astype(np.float32)
    c_att = rng.normal(size=out["att"].shape).astype(np.float32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    o = codegen.execute_plan(plan, leaves, g.to_tensors(),
                             {"feature": torch.from_numpy(x)}, kl)
    (torch.sum(o["h"] * torch.from_numpy(c_h))
     + torch.sum(o["att"] * torch.from_numpy(c_att))).backward()

    def rloss(p):
        r = rrun(p)
        return jax.numpy.sum(r["h"] * c_h) + jax.numpy.sum(r["att"] * c_att)

    rgrads = jax.grad(rloss)(rparams)
    assert set(rgrads) == set(leaves)
    for name, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(rgrads[name]),
                                   rtol=1e-4, atol=1e-4)


def test_attention_is_computed_only_when_read():
    """RGAT's plan never reads the attention tensor outside its fused
    aggregation, so the executor skips it (with or without autograd)."""
    from repro_torch.core import codegen
    from repro_torch.core.ir import intra_op as O
    from repro_torch.core.ir.passes import lower_program
    from repro_torch.models import rgat_program

    plan = lower_program(rgat_program(8, 8))
    (trav,) = [op for op in plan.ops if isinstance(op, O.TraversalSpec)]
    fused = [j for j, s in enumerate(trav.stmts)
             if s.kind == "segment_sum" and s.scale is not None]
    assert len(fused) == 1
    att = trav.stmts[fused[0]].scale
    assert not codegen._read_elsewhere(plan, trav, fused[0], att)
    assert codegen._read_elsewhere(plan, trav, fused[0] - 1, att)
