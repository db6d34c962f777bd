"""``runtime/pipeline.py`` on CPU gloo ranks: the GPipe schedule over the
``pod`` axis against the stages run in sequence.

The reference's ``tests/test_pipeline.py::test_pipeline_matches_sequential``
fails in the reference itself (``ROADMAP.md`` §3), so its case (``P = 4``
stages, ``M = 8`` microbatches of ``mb = 2`` rows, ``d = 16``, the stage
``tanh(h @ w)``) is held to the JAX reference's stages run in sequence:
the outputs within 1e-5 (and to the port's sequential stages bit for
bit), the gradient of ``sum(out ** 2)`` within rtol 1e-5 / atol 1e-6, and
``bubble_fraction(8, 4) == 3/11``. The same on the ``pod`` axis of a
``(2, 2, 2)`` mesh (four rings of two stages at once) and on one pod.
Every run of ranks is a subprocess with its own timeout
(``test_torch_model_axis.Group``).
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.pipeline import bubble_fraction as ref_bubble
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.pipeline import bubble_fraction, pipeline_forward
import torch_mesh_probe as probe
from test_torch_model_axis import Group

M, MB, D = 8, 2, 16


def case(stages):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(stages, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M, MB, D)).astype(np.float32)
    return w, x


RANKS = """
    import pickle
    import numpy as np
    from repro_torch.launch.mesh import launch_ranks
    import torch_mesh_probe as probe
    from test_torch_pipeline import case
    if __name__ == "__main__":
        out = {}
        for shape, axes, stages in (((4,), ("pod",), 4),
                                    ((2, 2, 2), ("pod", "data", "model"), 2)):
            w, x = case(stages)
            out[shape] = launch_ranks(probe.pipeline_probe,
                                      int(np.prod(shape)), "cpu", dict(
                                          shape=shape, axes=axes, w=w, x=x),
                                      timeout_s=120)
        with open(OUT, "wb") as f:
            pickle.dump(out, f)
    """


@pytest.fixture(scope="module")
def runs():
    g = Group("pipeline", textwrap.dedent(RANKS), 300)
    yield g
    g.stop()


def jax_sequential(w, x):
    """The reference test's sequential stages and the gradient of
    ``sum(out ** 2)``, in JAX."""
    def seq(wj):
        h = jnp.asarray(x)
        for i in range(wj.shape[0]):
            h = jnp.tanh(h @ wj[i])
        return h
    wj = jnp.asarray(w)
    out = seq(wj)
    g = jax.grad(lambda a: jnp.sum(seq(a) ** 2))(wj)
    return np.asarray(out), np.asarray(g)


def jax_input_grad(w, x):
    """The gradient of ``sum(out ** 2)`` over ``x`` through the reference
    test's stages in sequence, in JAX."""
    def seq(xj):
        h = xj
        for i in range(w.shape[0]):
            h = jnp.tanh(h @ jnp.asarray(w[i]))
        return jnp.sum(h ** 2)
    return np.asarray(jax.grad(seq)(jnp.asarray(x)))


def torch_sequential(w, x, input_grad=False):
    """The port's stages in sequence, a microbatch at a time (with
    ``input_grad``, also the gradient over ``x``)."""
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=input_grad)
    outs = []
    for j in range(x.shape[0]):
        h = xt[j]
        for i in range(w.shape[0]):
            h = probe.tanh_stage({"w": wt[i]}, h)
        outs.append(h)
    out = torch.stack(outs)
    if not input_grad:
        (g,) = torch.autograd.grad(torch.sum(out ** 2), [wt])
        return out.detach().numpy(), g.numpy()
    g, gx = torch.autograd.grad(torch.sum(out ** 2), [wt, xt])
    return out.detach().numpy(), g.numpy(), gx.numpy()


@pytest.mark.parametrize("shape", [(4,), (2, 2, 2)], ids=str)
def test_pipeline_matches_sequential(runs, shape):
    """The reference test's case on 4 pod ranks (and 2 stages on the pod
    axis of ``(2, 2, 2)``): every rank's outputs the same, within 1e-5 of
    the JAX stages in sequence and bit for bit the port's; the gradient
    within rtol 1e-5 / atol 1e-6 of JAX's (2 stages: atol 1e-5 of the
    largest entry) and of the port's (the sums over microbatches run in
    another order), nonzero, each stage's slice
    computed on its own ranks; without grad, the same outputs."""
    stages = 4 if shape == (4,) else 2
    w, x = case(stages)
    got = runs.result()[shape]
    ref_out, ref_g = jax_sequential(w, x)
    seq_out, seq_g = torch_sequential(w, x)
    for r in range(len(got["out"])):
        np.testing.assert_array_equal(got["out"][r], got["out"][0])
    assert float(np.max(np.abs(got["out"][0] - ref_out))) < 1e-5
    np.testing.assert_array_equal(got["out"][0], seq_out)
    np.testing.assert_array_equal(got["plain"], seq_out)
    # the reference's case at rtol 1e-5 / atol 1e-6; the 2-stage case's
    # sums run over another split of the work than XLA's, so it is held
    # there to 1e-5 of the largest entry, and to the port's stages at the
    # bound
    atol = 1e-6 if shape == (4,) else 1e-5 * float(np.max(np.abs(ref_g)))
    np.testing.assert_allclose(got["grad"], ref_g, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got["grad"], seq_g, rtol=1e-5, atol=1e-6)
    assert float(np.max(np.abs(got["grad"]))) > 0
    # rank r is stage r // (ranks / stages): its own slice of the gradient
    per = len(got["own"]) // stages
    for r, own in enumerate(got["own"]):
        np.testing.assert_array_equal(own, got["grad"][r // per])


@pytest.mark.parametrize("shape", [(4,), (2, 2, 2)], ids=str)
def test_input_gradient_on_every_rank(runs, shape):
    """``x`` is replicated, so every rank gets the whole gradient of
    ``sum(out ** 2)`` over it, not only stage 0: every rank's the same
    bits, within rtol 1e-5 / atol 1e-6 of the JAX stages in sequence and
    of the port's."""
    stages = 4 if shape == (4,) else 2
    w, x = case(stages)
    got = runs.result()[shape]["grad_x"]
    want = jax_input_grad(w, x)
    _, _, seq_gx = torch_sequential(w, x, input_grad=True)
    assert got.shape == (int(np.prod(shape)),) + x.shape
    for r in range(len(got)):
        np.testing.assert_array_equal(got[r], got[0])
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0], seq_gx, rtol=1e-5, atol=1e-6)
    assert float(np.max(np.abs(got[0]))) > 0


def test_bubble_fraction():
    assert abs(bubble_fraction(8, 4) - 3 / 11) < 1e-9
    for m, p in ((1, 1), (8, 4), (32, 2), (3, 7)):
        assert bubble_fraction(m, p) == ref_bubble(m, p)


def test_one_stage_is_the_stage():
    """One pod (a mesh of one rank): ``stage_fn`` over each microbatch, no
    handoff, differentiable."""
    w, x = case(1)
    mesh = make_mesh((1,), ("pod",), "cpu")
    wt = torch.tensor(w, requires_grad=True)
    out = pipeline_forward(probe.tanh_stage, {"w": wt}, torch.tensor(x),
                           mesh)
    seq_out, seq_g = torch_sequential(w, x)
    np.testing.assert_array_equal(out.detach().numpy(), seq_out)
    (g,) = torch.autograd.grad(torch.sum(out ** 2), [wt])
    np.testing.assert_allclose(g.numpy(), seq_g, rtol=1e-6, atol=1e-7)


def test_gradient_reaches_the_microbatches():
    """The input's gradient (stage 0 takes each microbatch) is the
    sequential run's."""
    w, x = case(1)
    mesh = make_mesh((1,), ("pod",), "cpu")
    xt = torch.tensor(x, requires_grad=True)
    out = pipeline_forward(probe.tanh_stage, {"w": torch.tensor(w)}, xt,
                           mesh)
    (gx,) = torch.autograd.grad(torch.sum(out ** 2), [xt])
    xs = torch.tensor(x, requires_grad=True)
    ref = torch.tanh(xs @ torch.tensor(w)[0])
    (want,) = torch.autograd.grad(torch.sum(ref ** 2), [xs])
    np.testing.assert_allclose(gx.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)
