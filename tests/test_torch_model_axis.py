"""The model axis on CPU gloo ranks: LM training and serving split over
``(data, model)`` meshes, held to the one-device port and, through
``params_from_reference``, to the JAX reference.

``torch_mesh_probe.mesh_probe`` runs one train step (loss, every gradient
leaf, the new state) and a prefill with 3 decodes (logits, caches) on the
ranks and gathers every result whole. Reduced qwen3-4b (2 KV heads) and
gemma2-2b run on ``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` (where the 2 KV
heads are used whole by all 4 model ranks and the decode cache is
head_dim-sharded), reduced moonshot, mamba2 and whisper on ``(1, 2)``
(their MoE, SSM and encoder leaves gathered), and qwen3-4b / moonshot on
``(2, 2)`` with the FSDP and ZeRO-1 thresholds lowered so that they shard
the reduced leaves. Tolerances: 1e-4 (loss, state, logits, caches),
gradients 1e-4 / 1e-6; initial parameters bit for bit; on every rank the
resident parameter and moment bytes equal the sum of its shard shapes
from the rules, each leaf exactly its shard.

The reference's ``tests/test_distributed.py`` mesh tests fail in the
reference (``ROADMAP.md`` §3); their mirrors here hold the port's ``(2,
4)`` mesh to the one-device math at 1e-4 (the reference asks 5e-2). Both
drivers run with ``--model-parallel 2 --device cpu``; the failure drill
re-meshes and resumes bit for bit as on one device; a checkpoint moves
between ``(1, 2)`` and ``(1, 1)``.

qwen3-4b's and gemma2-2b's plain runs start from the reference's
parameters; the others draw theirs on the ranks, which gathered back are
the one device's bit for bit. Every run of ranks is a subprocess with its own timeout (one intra-op
thread a rank, as ``tests/test_torch_dist_ranks.py`` runs them), so a hung
rendezvous fails its test and does not stall the suite; the groups of runs
start together and each test waits for its own.
"""
import dataclasses
import functools
import os
import pathlib
import pickle
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.lm.model import TransformerLM as RefLM
from repro_torch import configs as C
import torch_mesh_probe as probe
from repro_torch.launch.serve import stub_frontend

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, S, PROMPT, GEN = 4, 16, 8, 4
LOW = dict(fsdp_threshold=2**14, zero_threshold=2**12)

# (arch, mesh, lowered thresholds). qwen3-4b's and gemma2-2b's plain runs
# start from the reference's parameters (held to one device on the same
# parameters and to the reference); the others draw theirs from the seed
# on the ranks (the drawn shards, gathered, one device's bit for bit)
PROBES = {
    ("qwen3-4b", (1, 2), False), ("qwen3-4b", (2, 2), False),
    ("qwen3-4b", (1, 4), False), ("gemma2-2b", (1, 2), False),
    ("gemma2-2b", (2, 2), False), ("gemma2-2b", (1, 4), False),
    ("moonshot-v1-16b-a3b", (1, 2), False), ("mamba2-780m", (1, 2), False),
    ("whisper-medium", (1, 2), False), ("qwen3-4b", (2, 2), True),
    ("moonshot-v1-16b-a3b", (2, 2), True),
}
REF_PROBES = {k for k in PROBES
              if k[0] in ("qwen3-4b", "gemma2-2b") and not k[2]}

def inputs(arch):
    cfg = C.get_reduced(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    fe = stub_frontend(cfg, B, rng)
    if fe is not None:
        batch["frontend"] = stub_frontend(cfg, B, np.random.default_rng(2))
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT))
    return cfg, batch, prompts, fe


def ref_params(arch):
    rp = RefLM(RC.get_reduced(arch), remat=False).init(jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, rp)


@functools.lru_cache(maxsize=None)
def one_device(arch, with_ref):
    """The one-device port's results on ``inputs(arch)`` (the same on
    every mesh of a config)."""
    cfg, batch, prompts, fe = inputs(arch)
    torch.set_num_threads(1)
    return probe.one_device(cfg, batch=batch, prompts=prompts, gen=GEN,
                            frontend=fe, params_np=ref_params(arch)
                            if with_ref else None)


@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(arch):
    """The reference's loss and gradient leaves on ``inputs(arch)``."""
    _, batch, _, _ = inputs(arch)
    rm = RefLM(RC.get_reduced(arch), remat=False)
    (loss, _), rg = jax.value_and_grad(rm.loss, has_aux=True)(
        rm.init(jax.random.key(0)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(rg)]


def step_batches(cfg, b, s, n=3):
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)} for _ in range(n)]


# ---------------------------------------------------------------------------
# the runs of ranks: each group one subprocess, all started together
# ---------------------------------------------------------------------------
def _probe_code(keys):
    return f"""
        import pickle
        from repro_torch.launch.mesh import launch_ranks
        import torch_mesh_probe as probe
        from test_torch_model_axis import (inputs, ref_params, LOW, GEN,
                                           REF_PROBES)
        if __name__ == "__main__":
            out = {{}}
            for key in {sorted(keys)!r}:
                arch, shape, low = key
                cfg, batch, prompts, fe = inputs(arch)
                kw = dict(cfg=cfg, shape=shape, batch=batch, prompts=prompts,
                          gen=GEN, frontend=fe,
                          part_kwargs=LOW if low else None)
                if key in REF_PROBES:
                    kw["params_np"] = ref_params(arch)
                out[key] = launch_ranks(probe.mesh_probe,
                                        shape[0] * shape[1], "cpu", kw,
                                        timeout_s=240)
            with open(OUT, "wb") as f:
                pickle.dump(out, f)
        """


MIRRORS = """
    import pickle
    from repro_torch import configs as C
    from repro_torch.launch.mesh import launch_ranks
    import torch_mesh_probe as probe
    from test_torch_model_axis import step_batches
    if __name__ == "__main__":
        out = {}
        for arch, s, n in (("qwen3-4b", 32, 3), ("gemma2-2b", 16, 1)):
            cfg = C.get_reduced(arch)
            out[arch] = launch_ranks(probe.mesh_steps, 8, "cpu", dict(
                cfg=cfg, shape=(2, 4), batches=step_batches(cfg, 8, s, n)),
                timeout_s=240)
        with open(OUT, "wb") as f:
            pickle.dump(out, f)
    """

DRIVERS = """
    import pickle, shutil, tempfile
    from repro_torch.launch import serve as SV, train as TR
    if __name__ == "__main__":
        d = tempfile.mkdtemp()
        kw = dict(reduced=True, steps=8, batch=4, seq=32, ckpt_every=3,
                  simulate_failure=5, device="cpu", log=lambda m: None)
        out = {"drill_mesh": TR.train("qwen3-4b", ckpt_dir=d + "/a",
                                      model_parallel=2, **kw),
               "drill_one": TR.train("qwen3-4b", ckpt_dir=d + "/b", **kw)}
        kw = dict(reduced=True, steps=10, batch=4, seq=32, ckpt_every=0,
                  resume=True, device="cpu", log=lambda m: None)
        # (1, 2)'s checkpoint resumed on one device, and one device's on
        # (1, 2)
        out["moved_to_one"] = TR.train("qwen3-4b", ckpt_dir=d + "/a", **kw)
        out["moved_to_mesh"] = TR.train("qwen3-4b", ckpt_dir=d + "/b",
                                        model_parallel=2, **kw)
        out["main_losses"] = TR.main(["--device", "cpu", "--arch",
                                      "gemma2-2b", "--reduced", "--steps", "4",
                                      "--batch", "4", "--seq", "16",
                                      "--ckpt-every", "0", "--model-parallel",
                                      "2", "--ckpt-dir", d + "/c"])
        out["serve_mesh"] = SV.serve("qwen3-4b", reduced=True, device="cpu",
                                     model_parallel=2, dp=2, keep_logits=True,
                                     log=lambda m: None)
        out["serve_one"] = SV.serve("qwen3-4b", reduced=True, device="cpu",
                                    keep_logits=True, log=lambda m: None)
        out["serve_main"] = SV.main(["--device", "cpu", "--reduced", "--arch",
                                     "whisper-medium", "--model-parallel",
                                     "2", "--gen", "4"])
        shutil.rmtree(d)
        with open(OUT, "wb") as f:
            pickle.dump(out, f)
    """


def _groups():
    probes = sorted(PROBES)
    return {
        "probes_a": _probe_code([k for k in probes if k[0] == "qwen3-4b"]),
        "probes_b": _probe_code([k for k in probes if k[0] == "gemma2-2b"]),
        "probes_c": _probe_code([k for k in probes
                                 if k[0] not in ("qwen3-4b", "gemma2-2b")]),
        "mirrors": textwrap.dedent(MIRRORS),
        "drivers": textwrap.dedent(DRIVERS),
    }


class Group:
    """One subprocess running ``code`` (``src`` and ``tests`` on the path,
    one intra-op thread, ``env`` added to the environment); ``result()``
    waits for it, within its own timeout, and unpickles what it wrote to
    ``OUT``."""

    def __init__(self, name, code, timeout, env=None):
        self.out = pathlib.Path(os.environ.get("TMPDIR", "/tmp")) / \
            f"torch-model-axis-{os.getpid()}-{name}.pkl"
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                               str(ROOT / "tests")]),
                   **(env or {}))
        prog = f"OUT = {str(self.out)!r}\n" + textwrap.dedent(code)
        # a session of its own: stop() ends the ranks it spawned too
        self.proc = subprocess.Popen([sys.executable, "-c", prog], cwd=ROOT,
                                     env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     start_new_session=True)
        self.timeout, self._value = timeout, None

    def stop(self):
        """Kill the subprocess and every process it started, if running."""
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.communicate()

    def result(self):
        if self._value is None:
            try:
                _, err = self.proc.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                self.stop()
                raise
            assert self.proc.returncode == 0, err[-4000:]
            with open(self.out, "rb") as f:
                self._value = pickle.load(f)
            self.out.unlink(missing_ok=True)
        return self._value


@pytest.fixture(scope="module")
def runs():
    groups = {name: Group(name, code, 420)
              for name, code in _groups().items()}
    yield groups
    for g in groups.values():
        g.stop()


def probe_result(runs, key):
    group = {"qwen3-4b": "probes_a", "gemma2-2b": "probes_b"}.get(
        key[0], "probes_c")
    return runs[group].result()[key]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
def close(got, want, tol=TOL, what=""):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, err_msg=f"{what} leaf {i}", **tol)


@pytest.mark.parametrize("key", sorted(PROBES), ids=str)
def test_mesh_equals_one_device(runs, key):
    arch, shape, _ = key
    want = one_device(arch, key in REF_PROBES)
    got = probe_result(runs, key)
    assert got["mesh"] == shape
    # drawn on the ranks, or the reference's sharded: gathered back, the
    # one device's parameters bit for bit
    assert all(np.array_equal(a, b) for a, b in
               zip(got["params"], want["params"])), "params not bit for bit"
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], **TOL)
    close(got["grads"], want["grads"], GRAD_TOL, "grads")
    close(got["state"], want["state"], TOL, "state")
    close(got["logits"], want["logits"], TOL, "logits")
    close(got["caches"], want["caches"], TOL, "caches")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("key", sorted(PROBES), ids=str)
def test_each_rank_holds_exactly_its_shards(runs, key):
    """Before and after the step, on every rank: the resident parameter
    and moment bytes are the sum of the shard shapes of the rules, and
    every leaf is exactly its shard (shape and storage)."""
    got = probe_result(runs, key)
    ranks = key[1][0] * key[1][1]
    for res in (got["resident"], got["resident_after"]):
        assert len(res) == ranks
        for r in res:
            for part in ("params", "moments"):
                assert r[part]["bytes"] == r[part]["expected"], (r, part)
                assert r[part]["exact"] == 1, (r, part)
    if key[2] or key[1][1] > 1:
        # the model axis (and, lowered, FSDP / ZeRO-1) leaves each rank less
        # than the whole: a mesh of ranks holds each parameter once over
        # the model axis
        whole = sum(a.nbytes for a in got["params"])
        assert got["resident"][0]["params"]["bytes"] < whole


@pytest.mark.parametrize("key", sorted(REF_PROBES), ids=str)
def test_mesh_equals_the_reference(runs, key):
    """The reference's parameters through ``params_from_reference`` onto
    the mesh: the loss and every gradient leaf are ``jax.value_and_grad``
    of the reference's loss, and prefill + 3 decodes its logits."""
    arch, shape, _ = key
    _, _, prompts, _ = inputs(arch)
    got = probe_result(runs, key)
    loss, grads = ref_loss_and_grads(arch)
    np.testing.assert_allclose(got["metrics"]["loss"], loss, **TOL)
    close(got["grads"], grads, GRAD_TOL, "grads")
    rm = RefLM(RC.get_reduced(arch), remat=False)
    rp = rm.init(jax.random.key(0))
    lg, caches = rm.prefill(rp, jnp.asarray(prompts, jnp.int32),
                            cache_len=PROMPT + GEN)
    want = [np.asarray(lg[:, -1])]
    for i in range(GEN - 1):
        tok = jnp.asarray(got["tokens"][:, i:i + 1], jnp.int32)
        lg, caches = rm.decode_step(rp, tok, PROMPT + i, caches)
        want.append(np.asarray(lg[:, -1]))
    close(got["logits"], want, TOL, "logits")
    close(got["caches"], [np.asarray(c) for c in
                          jax.tree_util.tree_leaves(caches)], TOL, "caches")


def _one_device_steps(arch, s, n):
    cfg = C.get_reduced(arch)
    torch.set_num_threads(1)
    return probe.mesh_steps(cfg, (1, 1), step_batches(cfg, 8, s, n),
                            device="cpu")


def test_train_step_runs_on_2x4_mesh(runs):
    """``tests/test_distributed.py::test_train_step_runs_on_2x4_mesh`` on
    the port: reduced qwen3-4b, 3 steps of B 8, S 32 on 2 x 4 ranks; finite
    losses below 20, each within 1e-4 of one device's, and the final
    state too."""
    got = runs["mirrors"].result()["qwen3-4b"]
    want = _one_device_steps("qwen3-4b", 32, 3)
    assert len(got["losses"]) == 3
    assert all(l == l and l < 20 for l in got["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    close(got["state"], want["state"], TOL, "state")


def test_sharded_equals_single_device(runs):
    """``tests/test_distributed.py::test_sharded_equals_single_device`` on
    the port: reduced gemma2-2b, one step of B 8, S 16 on 2 x 4 ranks and on
    one device agree within 1e-4 (the reference asks 5e-2)."""
    got = runs["mirrors"].result()["gemma2-2b"]
    want = _one_device_steps("gemma2-2b", 16, 1)
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    close(got["state"], want["state"], TOL, "state")


def test_train_driver_drill_on_the_model_axis(runs):
    """``train --model-parallel 2``: the drill at step 5 re-meshes to (1,
    2), restores step 3 and repeats it; the losses are one device's within
    1e-4, step for step, and the repeated ones bit for bit the first
    run's; each rank holds its shards."""
    out = runs["drivers"].result()
    mesh, one = out["drill_mesh"], out["drill_one"]
    assert mesh["plan"].shape == (1, 2) and one["plan"].shape == (1, 1)
    assert len(mesh["losses"]) == len(one["losses"]) == 11
    np.testing.assert_allclose(mesh["losses"], one["losses"], **TOL)
    assert mesh["losses"][3:6] == mesh["losses"][6:9]
    assert len(mesh["events"]) == 1
    assert mesh["events"][0].dead_hosts == ["host0"]
    assert all(r["params"]["bytes"] == r["params"]["expected"]
               and r["moments"]["exact"] for r in mesh["resident"])
    assert mesh["state"] is None and len(mesh["state_digest"]) == 2


def test_checkpoint_moves_between_meshes(runs):
    """A checkpoint written on (1, 2) resumes on one device and one
    written on one device resumes on (1, 2): both continue from step 6 as
    the uninterrupted runs did."""
    out = runs["drivers"].result()
    for name, src in (("moved_to_one", "drill_mesh"),
                      ("moved_to_mesh", "drill_one")):
        got = out[name]
        assert got["start_step"] == 6 and len(got["losses"]) == 4
        np.testing.assert_allclose(got["losses"],
                                   out[src]["losses"][-2:] + got["losses"][2:],
                                   **TOL)
    np.testing.assert_allclose(out["moved_to_one"]["losses"],
                               out["moved_to_mesh"]["losses"], **TOL)


def test_drivers_main_take_model_parallel(runs):
    out = runs["drivers"].result()
    assert len(out["main_losses"]) == 4
    assert all(np.isfinite(out["main_losses"]))
    assert out["serve_main"].shape == (4, 4)


def test_serve_driver_on_a_mesh_equals_one_device(runs):
    """``serve(model_parallel=2, dp=2)``: the tokens one device generates
    and the logits within 1e-4."""
    out = runs["drivers"].result()
    mesh, one = out["serve_mesh"], out["serve_one"]
    assert mesh["mesh"] == (2, 2) and one["mesh"] == (1, 1)
    np.testing.assert_array_equal(mesh["tokens"], one["tokens"])
    close([t.numpy() for t in mesh["logits"]],
          [t.numpy() for t in one["logits"]], TOL, "logits")


def test_shard_check_raises_on_a_wrong_local_shape():
    from repro_torch.launch import partitioning as PT
    from repro_torch.nn.common import shard, sharding_context
    cfg = C.get_reduced("qwen3-4b")
    part = PT.Partitioner(PT.MeshShape(("data", "model"), (2, 2)), cfg)
    res = part.logical_resolver(batch=4)
    x = torch.zeros(2, 8, cfg.d_model)          # the batch split over data
    heads = torch.zeros(2, 8, cfg.num_heads // 2, cfg.resolved_head_dim)
    with sharding_context(res):
        assert shard("activation", x) is x
        assert shard("attn_out_heads", heads) is heads
        assert shard("something_else", x) is x
        with pytest.raises(ValueError, match="activation"):
            shard("activation", torch.zeros(4, 8, cfg.d_model))
        with pytest.raises(ValueError, match="attn_out_heads"):
            shard("attn_out_heads", torch.zeros(
                2, 8, cfg.num_heads, cfg.resolved_head_dim))
    assert shard("activation", torch.zeros(4, 8, cfg.d_model)).shape[0] == 4


def test_hooks_are_the_identity_without_a_resolver():
    """With no resolver, ``rp_einsum`` is the matmul each layer ran before
    the hooks, bit for bit, and ``mesh_ctx`` is ``None``."""
    from repro_torch.nn.common import mesh_ctx, rp_einsum
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 5, 3, 4, generator=g)
    w = torch.randn(3, 4, 6, generator=g)
    assert mesh_ctx() is None
    assert torch.equal(rp_einsum("bqhk,hkd->bqd", a, w, leaf="wo"),
                       torch.matmul(a.reshape(2, 5, 12), w.reshape(12, 6)))
    h = torch.randn(2, 5, 7, generator=g)
    w2 = torch.randn(7, 6, generator=g)
    assert torch.equal(rp_einsum("bsf,fd->bsd", h, w2, leaf="w_down"),
                       h @ w2)


@pytest.mark.parametrize("pattern", ["bqhk,hkd->bqd", "bsf,fd->bsd"])
def test_rp_partials_keep_the_model_dtype(pattern):
    """Where ``wo`` / ``w_down`` split, the partial sums of bf16 operands
    are the fp32 contraction of those operands (nothing widened before
    the GEMM on the card), and their gradients are bf16 matmuls, as the
    single-device matmul's are."""
    from repro_torch.nn.common import _partials
    g = torch.Generator().manual_seed(0)
    a_shape, b_shape = (((2, 5, 3, 4), (3, 4, 6))
                        if pattern.startswith("bqhk") else ((2, 5, 7), (7, 6)))
    a = torch.randn(a_shape, generator=g).bfloat16().requires_grad_(True)
    b = torch.randn(b_shape, generator=g).bfloat16().requires_grad_(True)
    out = _partials(pattern, a, b)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 6)
    want = torch.einsum(pattern, a.detach().float(), b.detach().float())
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    up = torch.randn(out.shape, generator=g)
    ga, gb = torch.autograd.grad(out, (a, b), up)
    a2 = a.detach().reshape(10, -1)
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga.reshape(10, -1),
                       up.bfloat16().reshape(10, 6) @ b.detach().reshape(
                           -1, 6).t())
    assert torch.equal(gb.reshape(-1, 6), a2.t() @ up.bfloat16().reshape(
        10, 6))


def test_one_rank_mesh_step_equals_the_one_device_step():
    """``build_step(mesh=make_mesh((1, 1)))`` on reduced qwen3-4b: the
    sharded step's machinery with no collective gives one device's state
    bit for bit but for the clipping's order (within 1e-6)."""
    torch.set_num_threads(1)
    cfg, batch, _, _ = inputs("qwen3-4b")
    want = probe.mesh_steps(cfg, (1, 1), [batch], device="cpu")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.lm.config import ShapeCell
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    bundle = ST.build_step(cfg, ShapeCell("t", S, B, "train"), mesh=mesh)
    assert bundle.partitioner.mesh is mesh
    state = ST.init_state(AdamW(), bundle.model, bundle.partitioner,
                          torch.Generator().manual_seed(0))
    state, m = bundle.fn(state, {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), want["losses"][0],
                               rtol=1e-6)
    close([t.numpy() for t in tree_leaves(state)], want["state"],
          dict(rtol=1e-6, atol=1e-7), "state")


def test_a_reduced_config_with_odd_kv_heads_refuses_nothing():
    """KV heads fewer than tp and not a power of two of the query groups
    fall back to replicated attention in the plan (no split the math
    cannot take)."""
    from repro_torch.launch import partitioning as PT
    cfg = dataclasses.replace(C.get_reduced("qwen3-4b"), num_heads=6,
                              num_kv_heads=3)
    part = PT.Partitioner(PT.MeshShape(("data", "model"), (1, 2)), cfg)
    assert not part.attn_split and not part.kv_split
    part = PT.Partitioner(PT.MeshShape(("data", "model"), (1, 3)), cfg)
    assert part.attn_split and part.kv_split


def test_rank_layout_is_row_major_with_model_fastest():
    """rank = d * tp + m, as ``jax.make_mesh`` lays out devices; a group
    of axes orders its ranks row-major over them; one rank needs no
    process group."""
    from repro_torch.launch.mesh import RankMesh, make_mesh
    for rank in range(8):
        m = RankMesh(("data", "model"), (2, 4), rank, torch.device("cpu"))
        assert m.coord == {"data": rank // 4, "model": rank % 4}
        assert m.index(("model",)) == rank % 4
        assert m.index(("data",)) == rank // 4
        assert m.index(("data", "model")) == rank
        assert m.group_size("model") == 4 and m.size == 8
    m = RankMesh(("pod", "data", "model"), (2, 2, 2), 6, torch.device("cpu"))
    assert m.coord == {"pod": 1, "data": 1, "model": 0}
    assert m.index(("pod", "data")) == 3
    one = make_mesh((1, 1), ("data", "model"), "cpu")
    assert one.size == 1 and one.groups == {} and one.backend is None
    x = torch.arange(6.0)
    assert one.all_reduce(x, ("model",)) is x
    assert one.all_gather(x, ("data", "model"), 0) is x
    with pytest.raises(ValueError, match="world size 2"):
        make_mesh((1, 2), ("data", "model"), "cpu")
