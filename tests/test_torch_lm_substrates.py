"""The LM training substrates of the PyTorch port against the JAX
reference: every case of ``tests/test_substrates.py`` that the port's
``data/pipeline.py``, ``optim/compression.py``, ``runtime/fault.py``,
``launch/mesh.py`` and ``checkpoint/checkpointer.py`` cover, run on the
port, plus the reference's own outputs on the same inputs (the stream's
arrays, the quantizer's bits, the plans and the checkpoint files), and
bf16 checkpoints, which the reference's tests do not save."""
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap
import zipfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.data.pipeline import SyntheticLMStream as RefStream
from repro.lm.config import ShapeCell as RefShapeCell
from repro.launch.mesh import plan_elastic_mesh as ref_plan
from repro.optim import compression as RQ
from repro.runtime import fault as RF
from repro_torch import configs as C
from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import PrefetchIterator, SyntheticLMStream
from repro_torch.launch.mesh import plan_elastic_mesh
from repro_torch.lm.config import ShapeCell
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.compression import (
    ErrorFeedback, compressed_psum, dequantize_int8, quantize_int8,
)
from repro_torch.runtime.fault import (
    ElasticController, HeartbeatMonitor, StragglerPolicy,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# --------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-2b", "whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_stream_equals_the_reference(arch):
    """Array for array the reference's batches, the stubbed frontends of
    the encoder / frontend configs included."""
    cfg = C.get_reduced(arch)
    got = SyntheticLMStream(cfg, ShapeCell("t", 16, 4, "train"), seed=3)
    want = RefStream(RC.get_reduced(arch), RefShapeCell("t", 16, 4, "train"),
                     seed=3)
    for step in (0, 11):
        a, b = got.batch(step), want.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_stream_deterministic_per_step():
    cfg = C.get_reduced("qwen3-4b")
    cell = ShapeCell("t", 16, 4, "train")
    s1 = SyntheticLMStream(cfg, cell, seed=3)
    s2 = SyntheticLMStream(cfg, cell, seed=3)
    b1, b2 = s1.batch(11), s2.batch(11)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(s1.batch(12)["tokens"], b1["tokens"])
    # targets are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])


def test_prefetch_iterator_order_and_restart():
    cfg = C.get_reduced("qwen3-4b")
    cell = ShapeCell("t", 8, 2, "train")
    stream = SyntheticLMStream(cfg, cell)
    it = PrefetchIterator(stream, start_step=5)
    try:
        got = [next(it) for _ in range(4)]
    finally:
        it.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], stream.batch(s)["tokens"])
    assert not it._thread.is_alive()


# --------------------------------------------------------------- compression
def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32))
    q, s = quantize_int8(x)
    x2 = dequantize_int8(q, s, x.shape, x.dtype)
    # blockwise int8: error bounded by scale/2 per element
    max_err = float(torch.max(torch.abs(x - x2)))
    assert max_err <= float(torch.max(s)) * 0.51


def test_quantize_equals_the_reference_bitwise():
    """Half-way values round to even, as ``jnp.round`` does; scales,
    payload and the dequantized values are the reference's bits."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 300)).astype(np.float32)
    top = np.abs(x[0, :256]).max()
    x[0, :6] = np.float32(top / 127) * np.array([0.5, 1.5, 2.5, -0.5, -2.5,
                                                 126.5], np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = RQ.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and tuple(q.shape) == (4, 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        dequantize_int8(q, s, x.shape, torch.float32).numpy(),
        np.asarray(RQ.dequantize_int8(rq, rs, x.shape, jnp.float32)))


def test_error_feedback_removes_bias():
    """Accumulated EF-compressed gradients converge to the true sum."""
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy((rng.normal(size=(256,)) * 1e-3)
                               .astype(np.float32))}
    res = ErrorFeedback.init(g)
    acc = torch.zeros(256)
    n = 50
    for _ in range(n):
        comp, res = ErrorFeedback.compress(g, res)
        acc = acc + comp["w"]
    true = g["w"] * n
    # without EF the quantization bias would accumulate linearly
    np.testing.assert_allclose(acc.numpy(), true.numpy(), atol=2e-3)


def test_error_feedback_equals_the_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.normal(size=(300,)).astype(np.float32) * 1e-3,
         "b": {"c": rng.normal(size=(7, 9)).astype(np.float32)}}
    tg = {"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(
        g["b"]["c"])}}
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    res, rres = ErrorFeedback.init(tg), RQ.ErrorFeedback.init(jg)
    for _ in range(3):
        comp, res = ErrorFeedback.compress(tg, res)
        rcomp, rres = RQ.ErrorFeedback.compress(jg, rres)
    for a, b in ((comp, rcomp), (res, rres)):
        np.testing.assert_array_equal(a["a"].numpy(), np.asarray(b["a"]))
        np.testing.assert_array_equal(a["b"]["c"].numpy(),
                                      np.asarray(b["b"]["c"]))


def test_compressed_psum_single_member():
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    x = np.random.default_rng(2).normal(size=(64,)).astype(np.float32)
    y = compressed_psum(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), x, atol=np.max(np.abs(x)) / 100)
    mesh = jax.make_mesh((1,), ("pod",))
    f = shard_map(partial(RQ.compressed_psum, axis_name="pod"), mesh=mesh,
                  in_specs=P(), out_specs=P())
    np.testing.assert_array_equal(y.numpy(), np.asarray(f(jnp.asarray(x))))


_PSUM_RANK = """
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.compression import compressed_psum
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
try:
    x = np.random.default_rng(rank).normal(size=(700,)).astype(np.float32)
    x *= 10.0 ** rank
    mesh = make_mesh((2,), ("pod",), "cpu")
    y = compressed_psum(torch.from_numpy(x), mesh, ("pod",))
    with open(out, "wb") as f:
        pickle.dump(y.numpy(), f)
finally:
    dist.destroy_process_group()
"""


def test_compressed_psum_two_members(tmp_path):
    """Two gloo ranks of a ``("pod",)`` mesh: both get the same bits, which are a numpy
    emulation's (the MAX of the members' block scales, the int8 payloads
    summed in int32), within one shared scale of the exact sum."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    init = "file://" + str(tmp_path / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_PSUM_RANK), str(r), init,
         str(tmp_path / f"{r}.pkl")], env=env, cwd=ROOT,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=180) == 0, p.stderr.read()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.stderr.close()
    got = []
    for r in range(2):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    np.testing.assert_array_equal(got[0], got[1])
    xs = [np.random.default_rng(r).normal(size=(700,)).astype(np.float32)
          * np.float32(10.0 ** r) for r in range(2)]
    blocks = [np.pad(x, (0, 68)).reshape(-1, 256) for x in xs]
    scale = np.maximum(*[np.abs(b).max(1, keepdims=True) / np.float32(127)
                         for b in blocks])
    scale = np.maximum(scale, np.float32(1e-12))
    acc = sum(np.clip(np.rint(b / scale), -127, 127).astype(np.int32)
              for b in blocks)
    want = (acc.astype(np.float32) * scale).reshape(-1)[:700]
    np.testing.assert_array_equal(got[0], want)
    assert np.all(np.abs(got[0] - (xs[0] + xs[1]))
                  <= np.repeat(scale[:, 0], 256)[:700] * 1.01)


# --------------------------------------------------------------- fault
def test_heartbeat_death_detection():
    t = [0.0]
    mon = HeartbeatMonitor(["h0", "h1"], timeout=10, clock=lambda: t[0])
    t[0] = 5.0
    mon.heartbeat("h0")
    t[0] = 12.0
    assert mon.dead_hosts() == ["h1"]
    assert mon.alive_hosts() == ["h0"]


def test_straggler_policy_escalation():
    t = [0.0]
    mon = HeartbeatMonitor(["h0", "h1", "h2", "h3"], clock=lambda: t[0])
    pol = StragglerPolicy(trigger_factor=1.5, persist_steps=3)
    for step in range(6):
        for h in mon.hosts:
            mon.heartbeat(h, step, step_time=2.0 if h == "h3" else 1.0)
        actions = pol.decide(mon, spares=0)
    assert actions.get("h3") == "evict"
    actions = pol.decide(mon, spares=1)
    assert actions.get("h3") == "hot_swap"


def test_fault_policies_equal_the_reference():
    """The same clock and reports drive both monitors and policies: the
    same dead, alive and straggling hosts and the same actions, step for
    step (33 step times kept to 32)."""
    hosts = [f"h{i}" for i in range(5)]
    t = [0.0]
    ours = (HeartbeatMonitor(hosts, timeout=3, clock=lambda: t[0]),
            StragglerPolicy(persist_steps=4))
    ref = (RF.HeartbeatMonitor(hosts, timeout=3, clock=lambda: t[0]),
           RF.StragglerPolicy(persist_steps=4))
    rng = np.random.default_rng(0)
    for step in range(33):
        t[0] += 1.0
        times = rng.uniform(0.8, 1.2, len(hosts))
        times[3] *= 2.0 if 5 <= step < 20 else 1.0
        for i, h in enumerate(hosts):
            if h == "h4" and step > 25:
                continue                     # h4 falls silent
            for mon, _ in (ours, ref):
                mon.heartbeat(h, step, step_time=float(times[i]))
        got = (ours[0].dead_hosts(), ours[0].alive_hosts(),
               ours[0].stragglers(), ours[1].decide(ours[0], spares=step % 2))
        want = (ref[0].dead_hosts(), ref[0].alive_hosts(),
                ref[0].stragglers(), ref[1].decide(ref[0], spares=step % 2))
        assert got == want, step
    assert len(ours[0].hosts["h0"].step_times) == 32
    assert ours[0].dead_hosts() == ["h4"]


def test_elastic_plan_preserves_tp():
    plan = plan_elastic_mesh(512 - 16, model_parallel=16)
    assert plan.shape[-1] == 16
    assert plan.used_devices == 496
    assert plan.dropped_devices == 0
    plan2 = plan_elastic_mesh(509, model_parallel=16)
    assert plan2.used_devices == 496 and plan2.dropped_devices == 13
    with pytest.raises(ValueError):
        plan_elastic_mesh(15, model_parallel=16)


@pytest.mark.parametrize("surviving,mp,pods", [
    (496, 16, 1), (509, 16, 1), (512, 16, 2), (480, 16, 2), (496, 16, 2),
    (1, 1, 1), (7, 1, 1), (6, 2, 3), (64, 8, 4)])
def test_elastic_plans_equal_the_reference(surviving, mp, pods):
    a = plan_elastic_mesh(surviving, model_parallel=mp, pods=pods)
    b = ref_plan(surviving, model_parallel=mp, pods=pods)
    assert (a.shape, a.axes, a.used_devices, a.dropped_devices,
            a.dp_degree) == (b.shape, b.axes, b.used_devices,
                             b.dropped_devices, b.dp_degree)


def test_elastic_controller_event_flow():
    t = [0.0]
    mon = HeartbeatMonitor(["h0", "h1"], timeout=5, clock=lambda: t[0])
    ctl = ElasticController(mon, devices_per_host=256, model_parallel=16)
    assert ctl.check(step=3) is None
    t[0] = 10.0
    mon.heartbeat("h0")
    t[0] = 12.0          # h0 heartbeat 2s ago (alive), h1 12s ago (dead)
    ev = ctl.check(step=7)
    assert ev is not None and ev.dead_hosts == ["h1"]
    plan = ctl.replan(ev)
    assert plan.used_devices == 256 and plan.shape[-1] == 16
    assert ctl.events == [ev] and ev.surviving_devices == 256


# --------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    ck.save(5, tree)
    ck.wait()
    out = ck.restore(tree)
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])


def test_checkpoint_async_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": tree["w"] + s})
    ck.wait()
    assert ck.steps() == [3, 4]
    out = ck.restore(tree)          # latest
    np.testing.assert_allclose(out["w"].numpy(), np.full(4, 4.0))


def test_checkpoint_atomicity_tmp_never_visible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(7, {"w": torch.ones(2)})
    ck.wait()
    names = [p.name for p in tmp_path.iterdir()]
    assert "step_00000007" in names
    assert not any(n.endswith(".tmp") for n in names)


def _members(path):
    with zipfile.ZipFile(path / "shard_000.npz") as z:
        return {n: z.read(n) for n in z.namelist()}


def test_checkpoint_bf16_roundtrips_bit_for_bit(tmp_path):
    """A bf16 train state (bf16 params, fp32 moments, the int32 step)
    round-trips bit for bit; each bf16 leaf is stored as its 16-bit
    pattern and recorded as ``bfloat16``."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(33, 7, generator=g).to(torch.bfloat16),
              "n": {"s": (torch.randn(5, generator=g) * 1e-30).to(
                  torch.bfloat16)}}
    params["n"]["s"][0] = float("inf")
    params["n"]["s"][1] = -0.0
    state = AdamW().init(params)
    state.mu["w"] += 0.25
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state)
    ck.wait()
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    assert manifest["dtypes"] == ["bfloat16", "bfloat16", "float32",
                                  "float32", "float32", "float32", "int32"]
    with np.load(tmp_path / "step_00000003" / "shard_000.npz") as data:
        assert data["leaf_1"].dtype == np.int16
        np.testing.assert_array_equal(
            data["leaf_1"], params["w"].view(torch.int16).numpy())
    like = AdamW().init({"w": torch.zeros(33, 7, dtype=torch.bfloat16),
                         "n": {"s": torch.zeros(5, dtype=torch.bfloat16)}})
    out = ck.restore(like)
    for got, want in zip(tree_leaves(out), tree_leaves(state)):
        assert got.dtype == want.dtype
        if want.dtype == torch.bfloat16:
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        else:
            assert torch.equal(got, want)


def test_checkpoint_fp32_files_are_the_reference_files(tmp_path):
    """Without bf16 nothing changed: the manifest and every array's bytes
    in the npz are what the reference's ``Checkpointer`` writes for the
    same tree (the zip's timestamps aside)."""
    rng = np.random.default_rng(0)
    tree = {"b": rng.normal(size=(4, 3)).astype(np.float32),
            "a": {"k": rng.integers(0, 9, (5,)).astype(np.int32),
                  "z": rng.normal(size=(2,)).astype(np.float32)}}
    ours = Checkpointer(str(tmp_path / "port"))
    ours.save(2, jax.tree_util.tree_map(torch.from_numpy, tree))
    ours.wait()
    RefCheckpointer(str(tmp_path / "ref")).save(
        2, jax.tree_util.tree_map(jnp.asarray, tree), blocking=True)
    a, b = (tmp_path / d / "step_00000002" for d in ("port", "ref"))
    assert (a / "manifest.json").read_text() == \
        (b / "manifest.json").read_text()
    assert _members(a) == _members(b)
