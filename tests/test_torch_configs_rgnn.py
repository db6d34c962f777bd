"""The port's RGNN front door against the reference, on the CPU: the
paper's model configs (``repro_torch.configs.rgnn``: the same keys and
fields, programs with the reference's fingerprints, the same graphs) and
``serve_rgnn``'s ``--reduced`` / ``--no-bucket`` with the reference's
meaning."""
import dataclasses

import numpy as np
import pytest
import jax
import torch

import hector
from repro.configs import rgnn as rcfg
from repro.launch import serve_rgnn as ref_serve
from repro_torch.configs import rgnn as cfg
from repro_torch.core.graph import CPU_REDUCED_SCALES
from repro_torch.launch import serve_rgnn

DIMS = dict(dim=16, hidden=16, classes=4)


def test_rgnn_configs_equal_reference():
    assert list(cfg.RGNN_CONFIGS) == list(rcfg.RGNN_CONFIGS)
    assert len(cfg.RGNN_CONFIGS) == 3 * 8
    for name, c in cfg.RGNN_CONFIGS.items():
        assert dataclasses.asdict(c) == dataclasses.asdict(
            rcfg.RGNN_CONFIGS[name])
        assert cfg.get_rgnn_config(name) is c
    with pytest.raises(KeyError):
        cfg.get_rgnn_config("gcn-aifb")


@pytest.mark.parametrize("width", [None, (8, 4)])
@pytest.mark.parametrize("name", sorted(cfg.RGNN_CONFIGS))
def test_rgnn_config_programs_match_reference(name, width):
    """Every config's program renders and fingerprints as the reference's,
    at the paper's in_dim 64 and at a small width."""
    ours, ref = cfg.get_rgnn_config(name), rcfg.get_rgnn_config(name)
    if width is not None:
        ours = dataclasses.replace(ours, in_dim=width[0], out_dim=width[1])
        ref = dataclasses.replace(ref, in_dim=width[0], out_dim=width[1])
    a, b = ours.program(), ref.program()
    assert a.fingerprint() == b.fingerprint()
    assert a.describe() == b.describe()


@pytest.mark.parametrize("name", ["rgat-aifb", "hgt-mutag"])
def test_rgnn_config_graphs_match_reference(name):
    ours = dataclasses.replace(cfg.get_rgnn_config(name), scale=0.02)
    ref = dataclasses.replace(rcfg.get_rgnn_config(name), scale=0.02)
    g, rg = ours.graph(seed=3), ref.graph(seed=3)
    for f in ("src", "dst", "etype", "node_type", "dst_ptr", "unique_src"):
        np.testing.assert_array_equal(getattr(g, f), getattr(rg, f))


def _recorded_main(monkeypatch, argv):
    seen = {}
    monkeypatch.setattr(serve_rgnn, "serve",
                        lambda **kw: seen.update(kw) or "served")
    monkeypatch.setattr(serve_rgnn, "serve_online",
                        lambda **kw: seen.update(kw) or "online")
    return serve_rgnn.main(argv), seen


@pytest.mark.parametrize("dataset", ["aifb", "bgs", "mutag"])
def test_serve_reduced_picks_the_cpu_scale(monkeypatch, dataset):
    """``--scale`` defaults to none: an explicit one wins, else
    ``--reduced`` takes ``CPU_REDUCED_SCALES[dataset]``, else 1.0 — in
    both runtimes."""
    _, kw = _recorded_main(monkeypatch, ["--dataset", dataset, "--reduced"])
    assert kw["scale"] == CPU_REDUCED_SCALES[dataset]
    assert CPU_REDUCED_SCALES[dataset] == ref_serve.REDUCED_SCALES[dataset]
    _, kw = _recorded_main(monkeypatch, ["--dataset", dataset, "--reduced",
                                         "--scale", "0.07"])
    assert kw["scale"] == 0.07
    _, kw = _recorded_main(monkeypatch, ["--dataset", dataset])
    assert kw["scale"] == 1.0 and kw["bucket"] is True and kw["dp"] == 1
    out, kw = _recorded_main(monkeypatch, ["--dataset", dataset, "--runtime",
                                           "online", "--reduced"])
    assert out == "online" and kw["scale"] == CPU_REDUCED_SCALES[dataset]


def test_serve_cli_flags_reach_serve(monkeypatch):
    _, kw = _recorded_main(monkeypatch, ["--no-bucket", "--dp", "2",
                                         "--partitions", "4"])
    assert kw["bucket"] is False and kw["dp"] == 2 and kw["partitions"] == 4


def test_serve_reduced_runs_on_the_cpu():
    stats = serve_rgnn.main(["--device", "cpu", "--model", "rgcn",
                             "--reduced", "--dim", "8", "--hidden", "8",
                             "--classes", "4", "--tile", "8",
                             "--node-block", "8", "--batch-size", "8",
                             "--num-batches", "2", "--obs", "off"])
    assert stats["batches"] == 2 and np.isfinite(stats["latency_ms_p50"])


def test_serve_no_bucket_serves_exact_shapes():
    """``--no-bucket`` serves every batch at its exact shapes (one new key
    a batch of new sizes), its logits hold the bucketed run's, and its
    predictions are the reference's ``--no-bucket`` run's on the
    reference's weights."""
    kw = dict(model="rgat", dataset="aifb", scale=0.05, layers=2,
              fanouts=[3, 3], batch_size=8, num_batches=3, tile=8,
              node_block=8, seed=0, **DIMS)
    rg = ref_serve.table3_graph("aifb", scale=0.05, seed=0)
    rparams = hector.compile("rgat", rg, layers=2, sample=[3, 3], tile=8,
                             node_block=8, **DIMS).init(jax.random.key(0))
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in rparams]
    shapes = {}
    for bucket in (True, False):
        mbs = []
        shapes[bucket] = serve_rgnn.serve(
            **kw, device="cpu", bucket=bucket, params=np_params,
            keep_logits=True, log=lambda *a: None,
            on_batch=lambda mb, y: mbs.append(mb)), mbs
    (exact, mbs), (bucketed, bmbs) = shapes[False], shapes[True]
    for mb in mbs:   # exact: every block at its sampled size
        for gt, b in zip(mb.tensors, mb.seq.blocks):
            assert gt.num_nodes == b.graph.num_nodes
    assert any(gt.num_nodes != b.graph.num_nodes
               for mb in bmbs for gt, b in zip(mb.tensors, mb.seq.blocks))
    assert exact["executor_traces"] == 3
    for a, b in zip(exact["logits"], bucketed["logits"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    rstats = ref_serve.serve(**kw, bucket=False, log=lambda *a: None)
    np.testing.assert_array_equal(exact["last_preds"], rstats["last_preds"])
    assert torch.isfinite(torch.from_numpy(exact["logits"][-1])).all()
