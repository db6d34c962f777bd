"""The port's training slice against the reference, on the CPU: AdamW and
the cosine schedule step for step, ``EpochSeedStream`` batches, the
full-graph forward, one sampled and one full-graph SGD step against the
reference executors (same numpy graph, weights, features and labels,
weights carried by ``params_from_reference``), and inside the port the
full-fanout parity invariant, mid-epoch resume and the driver.

Bounds are the reference's own (``tests/test_train.py``): loss rtol 1e-5,
params rtol 1e-4 / atol 1e-6, moments rtol 1e-4 / atol 1e-7; the forward
rtol = atol = 1e-4; AdamW rtol 1e-6, atol 1e-8 (same fp32 arithmetic,
the global norm summed in another order)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hector
import hector_torch
from repro.core import executor as rexecutor
from repro.core.graph import synthetic_heterograph as ref_graph
from repro.optim import AdamW as RAdamW
from repro.optim import cosine_schedule as r_cosine
from repro.sampling import EpochSeedStream as REpochSeedStream
from repro.sampling import build_minibatch as ref_build
from repro_torch.core import executor
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sampling import EpochSeedStream, build_minibatch
from repro_torch.train import SampledTrainer

SEEDS = np.array([3, 50, 7, 3, 119, 0, 88, 12], dtype=np.int32)  # dupes
GRAPH = dict(num_nodes=120, num_edges=900, num_ntypes=4, num_etypes=7,
             seed=0)
DIMS = dict(layers=2, dim=16, hidden=12, classes=6, tile=8, node_block=8)


def _np_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.fixture(scope="module")
def task():
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(GRAPH["num_nodes"], 16)).astype(np.float32)
    labels = rng.integers(0, 6, GRAPH["num_nodes"])
    return feats, labels


def _pair(fanouts, model="rgat"):
    """The reference engine (xla backend) and the port's on the CPU, over
    the same graph, with the reference's weights carried to the port."""
    ref = hector.compile(model, ref_graph(**GRAPH), sample=fanouts, **DIMS)
    ours = hector_torch.compile(model, synthetic_heterograph(**GRAPH),
                                sample=fanouts, device="cpu", **DIMS)
    rparams = ref.init(jax.random.key(0))
    return ref, ours, rparams, ours.params_from_reference(
        _np_params(rparams))


def _assert_state_close(state, rstate):
    for a, b in zip(tree_leaves(state.params),
                    jax.tree.leaves(rstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    for a, b in zip(tree_leaves(state.mu), jax.tree.leaves(rstate.mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-7)
    assert int(state.step) == int(rstate.step)


# ---------------------------------------------------------------------------
# optimizer and seed stream
# ---------------------------------------------------------------------------
def test_adamw_cosine_matches_reference_with_clipping():
    rng = np.random.default_rng(7)
    shapes = {"W": (3, 5, 4), "b": (4,)}
    params = [{k: rng.normal(size=s).astype(np.float32)
               for k, s in shapes.items()} for _ in range(2)]
    kw = dict(weight_decay=0.01, clip_norm=1.0)
    opt = AdamW(learning_rate=cosine_schedule(1e-2, 2, 6), **kw)
    ropt = RAdamW(learning_rate=r_cosine(1e-2, 2, 6), **kw)
    state = opt.init([{k: torch.from_numpy(v) for k, v in p.items()}
                      for p in params])
    rstate = ropt.init([{k: jnp.asarray(v) for k, v in p.items()}
                        for p in params])
    for step in range(6):
        # gradients far above the clip norm: clipping is active every step
        grads = [{k: (rng.normal(size=s) * 10).astype(np.float32)
                  for k, s in shapes.items()} for _ in range(2)]
        state = opt.update([{k: torch.from_numpy(v) for k, v in g.items()}
                            for g in grads], state)
        rstate = ropt.update([{k: jnp.asarray(v) for k, v in g.items()}
                              for g in grads], rstate)
        for tree, rtree in ((state.params, rstate.params),
                            (state.mu, rstate.mu), (state.nu, rstate.nu)):
            for a, b in zip(tree_leaves(tree), jax.tree.leaves(rtree)):
                # atol: moments that cancel to ~1e-4 carry the 1-ulp
                # difference of the clip scale of values ~1e-2
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-8)
        assert int(state.step) == int(rstate.step) == step + 1
        np.testing.assert_allclose(
            float(cosine_schedule(1e-2, 2, 6)(state.step)),
            float(r_cosine(1e-2, 2, 6)(rstate.step)), rtol=1e-6)


def test_epoch_seed_stream_matches_reference():
    ids = np.arange(50, dtype=np.int32) * 2
    s, r = EpochSeedStream(ids, 16, seed=3), REpochSeedStream(ids, 16, seed=3)
    assert s.batches_per_epoch == r.batches_per_epoch == 3
    assert s.steps_for(4) == 12 and s.epoch_of(7) == r.epoch_of(7) == 2
    for step in (0, 1, 2, 3, 7, 11, 5, 0):
        np.testing.assert_array_equal(s.batch(step), r.batch(step))
    flat = np.concatenate([s.batch(k) for k in range(3)])
    assert len(np.unique(flat)) == 48


# ---------------------------------------------------------------------------
# full-graph forward and the two SGD steps against the reference
# ---------------------------------------------------------------------------
def test_full_graph_apply_matches_reference(task):
    feats, _ = task
    ref, ours, rparams, params = _pair([3, 3])
    out = ours.apply(params, torch.from_numpy(feats))
    rout = ref.apply(rparams, jnp.asarray(feats))
    assert out.shape == (GRAPH["num_nodes"], DIMS["classes"])
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-4,
                               atol=1e-4)


def test_train_steps_match_reference_executors(task):
    """One sampled (BlockTrainExecutor) and one full-graph
    (StackTrainExecutor) step from the same state as the reference's."""
    feats, labels = task
    ref, ours, rparams, params = _pair([3, 3])
    opt, ropt = (AdamW(learning_rate=1e-2, weight_decay=0.01),
                 RAdamW(learning_rate=1e-2, weight_decay=0.01))

    seq = ours.sampler.sample(SEEDS, batch_index=2, epoch=0)
    rseq = ref.sampler.sample(SEEDS, batch_index=2, epoch=0)
    mb = build_minibatch(seq, tile=8, node_block=8, bucket=True)
    rmb = ref_build(rseq, tile=8, node_block=8, bucket=True)
    x = torch.from_numpy(feats)
    state, m = executor.BlockTrainExecutor(ours.plans, opt).grad_and_update(
        opt.init(params), mb, torch.from_numpy(seq.slice_labels(labels)),
        {"feature": x[mb.input_ids.long()]})
    rstate, rm = rexecutor.BlockTrainExecutor(
        ref.plans, ropt).grad_and_update(
        ropt.init(rparams), rmb, jnp.asarray(rseq.slice_labels(labels)),
        {"feature": jnp.asarray(feats)[rmb.input_ids]})
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["accuracy"]), float(rm["accuracy"]))
    _assert_state_close(state, rstate)

    idx = np.arange(0, GRAPH["num_nodes"], 3, dtype=np.int32)
    state, m = executor.StackTrainExecutor(ours.plans, opt).grad_and_update(
        opt.init(params), ours.gt, ours.layouts, torch.from_numpy(idx),
        torch.from_numpy(labels[idx]), {"feature": x})
    rstate, rm = rexecutor.StackTrainExecutor(
        ref.plans, ropt).grad_and_update(
        ropt.init(rparams), ref.gt, ref.layouts, jnp.asarray(idx),
        jnp.asarray(labels[idx]), {"feature": jnp.asarray(feats)})
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    _assert_state_close(state, rstate)


@pytest.mark.parametrize("model", ["rgcn", "hgt"])
def test_new_model_train_steps_match_reference_executors(task, model):
    """RGCN and HGT: one sampled and one full-graph step against the
    reference's executors (Pallas interpret, so the reference runs its
    weighted aggregation, node-typed GEMMs and softmax kernels), at the
    same bounds as RGAT's."""
    feats, labels = task
    ref = hector.compile(model, ref_graph(**GRAPH), sample=[3, 3],
                         backend="pallas_interpret", **DIMS)
    ours = hector_torch.compile(model, synthetic_heterograph(**GRAPH),
                                sample=[3, 3], device="cpu", **DIMS)
    rparams = ref.init(jax.random.key(0))
    params = ours.params_from_reference(_np_params(rparams))
    opt, ropt = (AdamW(learning_rate=1e-2, weight_decay=0.01),
                 RAdamW(learning_rate=1e-2, weight_decay=0.01))

    seq = ours.sampler.sample(SEEDS, batch_index=2, epoch=0)
    rseq = ref.sampler.sample(SEEDS, batch_index=2, epoch=0)
    mb = build_minibatch(seq, tile=8, node_block=8, bucket=True)
    rmb = ref_build(rseq, tile=8, node_block=8, bucket=True)
    x = torch.from_numpy(feats)
    state, m = ours.train_step(ours.init_state(params, opt=opt), mb,
                               seq.slice_labels(labels), x)
    rstate, rm = ref.train_executor(ropt).grad_and_update(
        ropt.init(rparams), rmb, jnp.asarray(rseq.slice_labels(labels)),
        {"feature": jnp.asarray(feats)[rmb.input_ids]})
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    _assert_state_close(state, rstate)

    idx = np.arange(0, GRAPH["num_nodes"], 3, dtype=np.int32)
    state, m = executor.StackTrainExecutor(ours.plans, opt).grad_and_update(
        opt.init(params), ours.gt, ours.layouts, torch.from_numpy(idx),
        torch.from_numpy(labels[idx]), {"feature": x})
    rstate, rm = rexecutor.StackTrainExecutor(
        ref.plans, ropt, backend="pallas_interpret").grad_and_update(
        ropt.init(rparams), ref.gt, ref.layouts, jnp.asarray(idx),
        jnp.asarray(labels[idx]), {"feature": jnp.asarray(feats)})
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    _assert_state_close(state, rstate)


@pytest.mark.parametrize("model", ["rgcn", "hgt", "rgcn_cat"])
def test_new_models_full_graph_apply_matches_reference(task, model):
    feats, _ = task
    ref, ours, rparams, params = _pair([3, 3], model)
    out = ours.apply(params, torch.from_numpy(feats))
    rout = ref.apply(rparams, jnp.asarray(feats))
    assert out.shape == (GRAPH["num_nodes"], DIMS["classes"])
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------
def test_full_fanout_train_step_matches_full_graph(task):
    feats, labels = task
    ours = hector_torch.compile("rgat", synthetic_heterograph(**GRAPH),
                                sample=-1, device="cpu", **DIMS)
    opt = AdamW(learning_rate=1e-2, weight_decay=0.01)
    params = ours.init(0)
    x = torch.from_numpy(feats)
    s_full, m_full = executor.StackTrainExecutor(
        ours.plans, opt).grad_and_update(
        opt.init(params), ours.gt, ours.layouts, torch.from_numpy(SEEDS),
        torch.from_numpy(labels[SEEDS]), {"feature": x})
    seq = ours.sampler.sample(SEEDS)
    mb = build_minibatch(seq, tile=8, node_block=8, bucket=True)
    s_blk, m_blk = ours.train_step(ours.init_state(params, opt=opt), mb,
                                   seq.slice_labels(labels), x)
    np.testing.assert_allclose(float(m_full["loss"]), float(m_blk["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(s_full.params), tree_leaves(s_blk.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
    for a, b in zip(tree_leaves(s_full.mu), tree_leaves(s_blk.mu)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-7)


def test_checkpoint_resume_mid_epoch_bit_identical(task, tmp_path):
    feats, labels = task
    ids = np.arange(GRAPH["num_nodes"], dtype=np.int32)
    opt = AdamW(learning_rate=1e-2)

    def make_trainer():
        eng = hector_torch.compile("rgat", synthetic_heterograph(**GRAPH),
                                   sample=3, device="cpu", **DIMS)
        tr = SampledTrainer(eng, feats, labels, ids, opt=opt,
                            ckpt_dir=str(tmp_path / "ckpt"), log=None)
        return tr, tr.init_state(eng.init(0))

    tr_a, state_a = make_trainer()
    state_a, stats_a = tr_a.train(state_a, epochs=2, batch_size=40,
                                  ckpt_every=4)
    assert stats_a["steps"] == 6
    tr_b, state_b = make_trainer()
    state_b, start = tr_b.resume(state_b)
    assert start == 4
    state_b, stats_b = tr_b.train(state_b, epochs=2, batch_size=40,
                                  start_step=start)
    assert stats_b["steps"] == 2
    np.testing.assert_array_equal(stats_a["losses"][4:], stats_b["losses"])
    for a, b in zip(tree_leaves(state_a), tree_leaves(state_b)):
        assert torch.equal(a, b)


def test_train_rgnn_driver_end_to_end(tmp_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train_rgnn

    stats = train_rgnn.train(
        model="rgat", dataset="synthetic", scale=0.05, layers=2, dim=16,
        hidden=16, classes=6, fanouts=[3, 3], batch_size=32, epochs=2,
        lr=1e-2, tile=8, node_block=8, seed=0, val_frac=0.2,
        ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2, eval_every_epochs=2,
        device="cpu", log=lambda *a, **k: None)
    assert stats["steps"] == stats["epochs"] * stats["batches_per_epoch"]
    assert stats["losses"][-1] < stats["losses"][0]
    assert np.isfinite(stats["full_val_loss"]) and len(stats["evals"]) == 1
    assert Checkpointer(str(tmp_path / "ckpt")).latest_step() is not None


@pytest.mark.parametrize("model", ["rgcn", "hgt", "rgcn_cat"])
def test_train_rgnn_driver_trains_every_model(model):
    from repro_torch.launch import train_rgnn

    stats = train_rgnn.train(
        model=model, dataset="synthetic", scale=0.05, layers=2, dim=16,
        hidden=16, classes=6, fanouts=[3, 3], batch_size=32, epochs=2,
        lr=1e-2, tile=8, node_block=8, seed=0, val_frac=0.2,
        device="cpu", log=lambda *a, **k: None)
    assert stats["steps"] == stats["epochs"] * stats["batches_per_epoch"]
    assert np.all(np.isfinite(stats["losses"]))
    assert np.isfinite(stats["full_val_loss"])


def test_train_driver_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import train_rgnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_rgnn.main(["--reduced", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_rgnn.train(scale=0.05, log=lambda *a: None)
