"""The port's data group across ranks, on the CPU: ``one_step`` is what
each rank computes (one served batch and one SGD step over the synthetic
graph of ``tests/test_dist.py``, returned as numpy; it lives here, in a
module without JAX, so that the ranks ``launch_ranks`` spawns can import
it), and the tests hold dp=2 and dp=4 to dp=1 bit for bit, through the
executors and through both drivers' ``--dp``. Every run of ranks is a
subprocess with its own timeout, so a hung rendezvous fails its test and
does not stall the suite."""
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = np.array([3, 50, 7, 3, 119, 0, 88, 12], dtype=np.int32)


def one_step(dp=1, partitions=4, models=("rgat", "rgcn"), device="cpu",
             log=None):
    """For each of ``models``: serve logits, loss and the whole optimizer
    state after one step on ``dp`` ranks over ``partitions`` shards (the
    weights, features and labels are the same on every rank)."""
    return {m: _one_model(dp, partitions, m, device) for m in models}


def _one_model(dp, partitions, model, device):
    from repro_torch.core.graph import synthetic_heterograph
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.engine import EngineConfig, RGNNEngine
    g = synthetic_heterograph(120, 900, 4, 7, seed=0)
    eng = RGNNEngine(g, EngineConfig(
        model=model, layers=2, dim=16, hidden=12, classes=6, fanouts=[3, 3],
        tile=8, node_block=8, seed=0, dp=dp, partitions=partitions,
        device=device))
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(g.num_nodes, 16)).astype(np.float32)
    labels = rng.integers(0, 6, g.num_nodes)
    params = eng.init_params(torch.Generator().manual_seed(0))
    own = eng.shard_features(feats)
    smb = eng.dist_batcher.build(SEEDS, step=0, epoch=0)
    logits = eng.dist_serve_executor().run_minibatch(params, smb, own)
    opt = AdamW(learning_rate=1e-2, weight_decay=0.01)
    state, m = eng.dist_train_executor(opt).grad_and_update(
        opt.init(params), smb, labels, own)
    return {"logits": logits.cpu().numpy(), "loss": float(m["loss"]),
            "accuracy": float(m["accuracy"]),
            "state": [t.cpu().numpy() for t in tree_leaves(state)],
            "shards": eng.data_mesh.shards(eng.cfg.num_partitions),
            "backend": eng.data_mesh.backend}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def run_ranks(code: str, timeout: int = 240):
    """Run ``code`` in a fresh interpreter (``src`` and ``tests`` on the
    path, one intra-op thread, as every rank has) and unpickle what it
    writes to ``OUT``."""
    out = pathlib.Path(os.environ.get("TMPDIR", "/tmp")) / \
        f"torch-dist-{os.getpid()}-{abs(hash(code))}.pkl"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    prog = f"OUT = {str(out)!r}\n" + textwrap.dedent(code)
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    try:
        with open(out, "rb") as f:
            return pickle.load(f)
    finally:
        out.unlink(missing_ok=True)


def _same(a, b) -> bool:
    return a["loss"] == b["loss"] and a["accuracy"] == b["accuracy"] \
        and np.array_equal(a["logits"], b["logits"]) \
        and len(a["state"]) == len(b["state"]) \
        and all(np.array_equal(x, y) for x, y in zip(a["state"], b["state"]))


@pytest.fixture(scope="module")
def ranks():
    """``one_step`` of RGAT and RGCN at dp = 1 (in process), 2 and 4 (gloo
    ranks on the CPU), and a launch whose ranks raise, in one
    subprocess."""
    return run_ranks("""
        import pickle
        from repro_torch.launch.mesh import launch_ranks
        from test_torch_dist_ranks import one_step
        if __name__ == "__main__":
            out = {1: one_step(dp=1)}
            for dp in (2, 4):
                out[dp] = launch_ranks(one_step, dp, "cpu", dict(dp=dp),
                                       timeout_s=180)
            try:
                launch_ranks(one_step, 2, "cpu", dict(dp=2, partitions=3),
                             timeout_s=120)
            except Exception as e:
                out["failed"] = type(e).__name__
            else:
                out["failed"] = "no error"
            with open(OUT, "wb") as f:
                pickle.dump(out, f)
        """)


@pytest.mark.parametrize("model", ["rgat", "rgcn"])
def test_dp_ranks_match_dp1_bitwise(ranks, model):
    """Folding 4 shards onto 1 rank, 2 or 4 changes nothing: serve logits,
    loss, accuracy and the whole updated optimizer state (params, mu, nu,
    step) are the same bits, because every reduction runs over the
    gathered [P, ...] shard axis in the same order (gloo ranks on the
    CPU)."""
    one, two, four = (ranks[dp][model] for dp in (1, 2, 4))
    assert one["shards"] == (0, 1, 2, 3) and one["backend"] is None
    assert two["shards"] == (0, 1) and two["backend"] == "gloo"
    assert four["shards"] == (0,)
    assert np.isfinite(one["loss"])
    assert _same(one, two), "dp=2 differs from dp=1"
    assert _same(one, four), "dp=4 differs from dp=1"


def test_drivers_train_and_serve_on_two_ranks():
    """``train_rgnn`` / ``serve_rgnn`` with ``--dp 2 --partitions 4
    --device cpu`` at a reduced size: two gloo ranks started by the
    driver, whose losses, final state and served logits equal the same
    driver's one-rank run bit for bit."""
    res = run_ranks("""
        import pickle
        from repro_torch.launch import serve_rgnn, train_rgnn
        if __name__ == "__main__":
            base = ["--device", "cpu", "--dataset", "aifb", "--scale",
                    "0.05", "--dim", "16", "--hidden", "16", "--classes",
                    "4", "--fanout", "3", "--tile", "8", "--node-block",
                    "8", "--batch-size", "16", "--obs", "off",
                    "--partitions", "4"]
            out = {}
            for dp in ("1", "2"):
                t = train_rgnn.main(base + ["--epochs", "1", "--max-steps",
                                            "3", "--dp", dp])
                s = serve_rgnn.serve(
                    dataset="aifb", scale=0.05, dim=16, hidden=16,
                    classes=4, fanouts=[3, 3], tile=8, node_block=8,
                    batch_size=16, num_batches=3, device="cpu",
                    obs_mode="off", partitions=4, dp=int(dp),
                    keep_logits=True, log=lambda *a: None)
                m = serve_rgnn.main(base + ["--num-batches", "2", "--dp",
                                            dp])
                out[dp] = (t, s, m)
            with open(OUT, "wb") as f:
                pickle.dump(out, f)
        """, timeout=300)
    (t1, s1, m1), (t2, s2, m2) = res["1"], res["2"]
    assert t2["dp"] == 2 and t2["num_partitions"] == 4 and t2["steps"] == 3
    assert t1["losses"] == t2["losses"] and np.isfinite(t2["losses"]).all()
    assert all(np.array_equal(a, b)
               for a, b in zip(t1["final_state"], t2["final_state"]))
    assert np.isfinite(t2["full_train_loss"])
    assert s2["dp"] == 2 and s2["batches"] == 3
    assert all(np.array_equal(a, b) for a, b in zip(s1["logits"],
                                                    s2["logits"]))
    assert m2["dp"] == 2 and m2["batches"] == 2
    np.testing.assert_array_equal(m1["last_preds"], m2["last_preds"])


def test_launch_ranks_reports_a_failed_rank(ranks):
    """A rank that raises (4 shards cannot fold onto 2 ranks as 3) fails
    the launch: no rank carries on alone."""
    assert ranks["failed"] == "ProcessRaisedException"
