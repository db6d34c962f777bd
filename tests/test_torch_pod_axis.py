"""The pod axis on CPU gloo ranks: the compressed cross-pod all-reduce
through ``RankMesh`` and LM training and serving on ``(pod, data,
model)`` meshes, held to numpy, to the JAX reference and to one device.

The reference's ``tests/test_distributed.py::
test_compressed_psum_across_pods`` and ``::
test_multipod_mesh_axes_and_compile`` fail in the reference itself
(``ROADMAP.md`` §3), so the port is held to their inputs and bounds, to a
numpy emulation of the reference's math (the per-block MAX of the
members' scales, the int8 payloads summed in int32) and to one device's
math. ``compressed_psum`` over the 4 ranks of a ``("pod",)`` mesh and over
the ``pod`` groups of a ``(2, 2, 2)`` mesh: every member's result bit for
bit the same and the emulation's, within the reference test's bound
``err < 0.05 * scale + 1e-3``; one member equal to the reference's
``shard_map`` run. Reduced gemma2-2b (the reference test's decode cell:
``ShapeCell('d', 64, 8, 'decode')``, prefill of 60 then 4 decodes into a
64-position cache) and qwen3-4b (also with the FSDP and ZeRO-1 thresholds
lowered, so that they shard over ``data`` only while the batch splits over
``(pod, data)``) on ``(2, 2, 2)`` against one device at the model-axis
mirrors' tolerances (1e-4; gradients 1e-4 / 1e-6), every rank holding
exactly its shards; qwen3-4b 3 steps of B 8, S 32 on ``(2, 2, 2)``
against one device.

Every run of ranks is a subprocess with its own timeout and one intra-op
thread a rank (``test_torch_model_axis.Group``).
"""
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.optim import compression as RQ
from repro_torch import configs as C
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.compression import compressed_psum
import torch_mesh_probe as probe
from torch_mesh_probe import psum_emulate as emulate
from test_torch_model_axis import GRAD_TOL, LOW, TOL, Group, close

POD = ("pod", "data", "model")
PROMPT, GEN = {"qwen3-4b": 8, "gemma2-2b": 60}, 4
PROBES = (("qwen3-4b", False), ("qwen3-4b", True), ("gemma2-2b", False))


def psum_inputs():
    """The reference test's input (``(4, 128)`` from seed 0, a row a pod
    member) and 8 members' rows for the ``(2, 2, 2)`` mesh."""
    x4 = np.random.default_rng(0).normal(size=(4, 128)).astype(np.float32)
    x8 = np.random.default_rng(1).normal(size=(8, 1, 300)).astype(
        np.float32) * np.float32(10.0) ** np.arange(8, dtype=np.float32)[
            :, None, None] / np.float32(1e4)
    return [x4[r:r + 1] for r in range(4)], list(x8)


def lm_inputs(arch):
    cfg = C.get_reduced(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
    return (cfg, {"tokens": toks[:, :-1], "targets": toks[:, 1:]},
            rng.integers(0, cfg.vocab_size, (8, PROMPT[arch])))


def step_batches(cfg, n=3):
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(
        np.int32), "targets": rng.integers(0, cfg.vocab_size, (8, 32))
        .astype(np.int32)} for _ in range(n)]


PSUM = """
    import pickle
    from repro_torch.launch.mesh import launch_ranks
    import torch_mesh_probe as probe
    from test_torch_pod_axis import psum_inputs
    if __name__ == "__main__":
        x4, x8 = psum_inputs()
        out = {"pods": launch_ranks(probe.psum_probe, 4, "cpu", dict(
                   shape=(4,), axes=("pod",), xs=x4), timeout_s=120),
               "mesh": launch_ranks(probe.psum_probe, 8, "cpu", dict(
                   shape=(2, 2, 2), axes=("pod", "data", "model"), xs=x8),
                   timeout_s=120)}
        with open(OUT, "wb") as f:
            pickle.dump(out, f)
    """

PROBE = """
    import pickle
    from repro_torch.launch.mesh import launch_ranks
    import torch_mesh_probe as probe
    from test_torch_pod_axis import lm_inputs, POD, GEN, LOW, PROBES
    if __name__ == "__main__":
        out = {}
        for arch, low in PROBES:
            cfg, batch, prompts = lm_inputs(arch)
            out[arch, low] = launch_ranks(probe.mesh_probe, 8, "cpu", dict(
                cfg=cfg, shape=(2, 2, 2), axes=POD, batch=batch,
                prompts=prompts, gen=GEN, part_kwargs=LOW if low else None),
                timeout_s=240)
        cfg = lm_inputs("qwen3-4b")[0]
        from test_torch_pod_axis import step_batches
        out["steps"] = launch_ranks(probe.mesh_steps, 8, "cpu", dict(
            cfg=cfg, shape=(2, 2, 2), axes=POD, batches=step_batches(cfg)),
            timeout_s=240)
        with open(OUT, "wb") as f:
            pickle.dump(out, f)
    """


@pytest.fixture(scope="module")
def runs():
    groups = {"psum": Group("pod-psum", textwrap.dedent(PSUM), 300),
              "probes": Group("pod-probes", textwrap.dedent(PROBE), 420)}
    yield groups
    for g in groups.values():
        g.stop()


# ---------------------------------------------------------------------------
# the compressed all-reduce
# ---------------------------------------------------------------------------
def test_compressed_psum_across_pods(runs):
    """``tests/test_distributed.py::test_compressed_psum_across_pods`` on
    the port: 4 pod ranks, every member's result the same bits, the numpy
    emulation's, within the reference test's bound of the exact sum."""
    x4, _ = psum_inputs()
    got = runs["psum"].result()["pods"]
    assert got.shape == (4, 1, 128)
    for r in range(4):
        np.testing.assert_array_equal(got[r], got[0])
    np.testing.assert_array_equal(got[0], emulate(x4))
    want = np.concatenate(x4).sum(0, keepdims=True)
    err = float(np.max(np.abs(got[0] - want)))
    scale = float(np.max(np.abs(want)))
    assert err < 0.05 * scale + 1e-3, (err, scale)


def test_compressed_psum_over_the_pod_groups_of_a_2x2x2_mesh(runs):
    """Over ``("pod",)`` of ``(2, 2, 2)``: each rank sums with the rank of
    the other pod at its ``(data, model)`` coordinate only (ranks ``r`` and
    ``r ^ 4``), bit for bit the emulation's, four groups at once; inputs
    spanning eight decades, so that blocks of one group differ in scale."""
    _, x8 = psum_inputs()
    got = runs["psum"].result()["mesh"]
    assert got.shape == (8, 1, 300)
    for r in range(8):
        np.testing.assert_array_equal(got[r], emulate([x8[r % 4],
                                                       x8[r % 4 + 4]]))
        np.testing.assert_array_equal(got[r], got[r ^ 4])
    assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("one_rank_mesh", [False, True])
def test_compressed_psum_single_member_equals_the_reference(one_rank_mesh):
    """One member (``mesh=None``, or a mesh of one pod rank): the
    reference's ``shard_map`` run over a one-device ``pod`` mesh, bit for
    bit."""
    x = np.random.default_rng(3).normal(size=(5, 77)).astype(np.float32)
    mesh = make_mesh((1,), ("pod",), "cpu") if one_rank_mesh else None
    y = compressed_psum(torch.from_numpy(x), mesh)
    f = shard_map(partial(RQ.compressed_psum, axis_name="pod"),
                  mesh=jax.make_mesh((1,), ("pod",)), in_specs=P(),
                  out_specs=P())
    np.testing.assert_array_equal(y.numpy(), np.asarray(f(jnp.asarray(x))))
    np.testing.assert_array_equal(y.numpy(), emulate([x]))


# ---------------------------------------------------------------------------
# LM steps on (pod, data, model)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", PROBES, ids=str)
def test_pod_mesh_equals_one_device(runs, key):
    """Train step (B 8, S 16), prefill and 4 decodes on ``(2, 2, 2)``: the
    batch over ``(pod, data)``, gradients summed there; the one device's
    parameters bit for bit, loss / state / logits / caches 1e-4, gradients
    1e-4 / 1e-6, the same greedy tokens."""
    arch, _ = key
    cfg, batch, prompts = lm_inputs(arch)
    torch.set_num_threads(1)
    want = probe.one_device(cfg, batch=batch, prompts=prompts, gen=GEN)
    got = runs["probes"].result()[key]
    assert got["mesh"] == (2, 2, 2)
    assert all(np.array_equal(a, b) for a, b in
               zip(got["params"], want["params"]))
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], **TOL)
    close(got["grads"], want["grads"], GRAD_TOL, "grads")
    close(got["state"], want["state"], TOL, "state")
    close(got["logits"], want["logits"], TOL, "logits")
    close(got["caches"], want["caches"], TOL, "caches")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("key", PROBES, ids=str)
def test_each_pod_rank_holds_exactly_its_shards(runs, key):
    """Before and after the step, all 8 ranks: parameter and moment bytes
    the sum of the rules' shard shapes, each leaf exactly its shard; with
    the thresholds lowered, FSDP and ZeRO-1 split over ``data`` only, so
    the two pods hold the same bytes."""
    got = runs["probes"].result()[key]
    for res in (got["resident"], got["resident_after"]):
        assert len(res) == 8
        for r in res:
            for part in ("params", "moments"):
                assert r[part]["bytes"] == r[part]["expected"], (r, part)
                assert r[part]["exact"] == 1, (r, part)
        # rank = pod * 4 + data * 2 + model: pod 1 holds what pod 0 holds
        for r in range(4):
            assert res[r] == res[r + 4]
    if key[1]:
        whole = sum(a.nbytes for a in got["params"])
        assert got["resident"][0]["params"]["bytes"] < whole / 2


def test_train_steps_on_a_2x2x2_mesh(runs):
    """Reduced qwen3-4b, 3 steps of B 8, S 32 on ``(pod, data, model) =
    (2, 2, 2)``: finite losses below 20, each within 1e-4 of one
    device's, and the final state too."""
    got = runs["probes"].result()["steps"]
    cfg = lm_inputs("qwen3-4b")[0]
    torch.set_num_threads(1)
    want = probe.mesh_steps(cfg, (1, 1), step_batches(cfg), device="cpu")
    assert len(got["losses"]) == 3
    assert all(x == x and x < 20 for x in got["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    close(got["state"], want["state"], TOL, "state")


def test_pod_mesh_rules_split_the_batch_over_pod_and_data():
    """The rules on ``(2, 2, 2)``: the batch over ``(pod, data)``, FSDP and
    ZeRO-1 over ``data`` only (the reference's ``fsdp_axis``), the B=1
    decode's cache over the sequence on ``data``."""
    from repro_torch.launch import partitioning as PT
    cfg = C.get_reduced("qwen3-4b")
    part = PT.Partitioner(PT.MeshShape(POD, (2, 2, 2)), cfg, **LOW)
    assert part.dp_axes == ("pod", "data") and part.dp == 4
    assert part.batch_dims(8) == ("pod", "data")
    assert part.batch_dims(2) == ("data",)
    assert part.batch_dims(1) is None
    embed = torch.empty(cfg.vocab_size, cfg.d_model, device="meta")
    for spec in (part.param_spec("embed", embed),
                 part.opt_spec("embed", embed)):
        assert "pod" not in spec.all_axes() and "data" in spec.all_axes()
