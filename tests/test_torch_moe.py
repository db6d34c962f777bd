"""The port's MoE FFN (``repro_torch.nn.moe``) against the JAX reference
(``repro.nn.moe``), on the CPU: every case of ``tests/test_moe.py`` on the
port, ``moe_ffn`` against the reference's on the same numpy parameters and
inputs (output within 1e-4, ``lb_loss`` within fp32 rounding, ``dropped``
and the routing exactly) at capacity factors that drop (0.5), the
default (1.25) and none (E), every gradient against ``jax.grad``, and
``capacity`` over the reference's grid. The router's top-k has no ties on
these random fp32 inputs (checked), so ``torch.topk`` and ``lax.top_k``
pick the same experts.
"""
import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from hypothesis import given, settings, strategies as st

from repro.nn import moe as RMOE
from repro_torch.nn import moe as MOE
from repro_torch.nn.moe import capacity, init_moe, moe_ffn

RNG = np.random.default_rng(0)
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
KEYS = ("router", "w_gate", "w_up", "w_down")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def port_params(e, d, f, seed):
    return init_moe(torch.Generator().manual_seed(seed), d, f, e,
                    torch.float32)


def ref_case(e, k, d, f, shape, seed):
    """The reference's parameters and a random input, as numpy."""
    rp = RMOE.init_moe(jax.random.key(seed), d, f, e, jnp.float32)
    pnp = {n: np.asarray(v) for n, v in rp.items()}
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return pnp, x


def dense_reference(params, x, e, k):
    """Per-token top-k expert mix computed densely (the oracle of
    ``tests/test_moe.py``), in torch."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf @ params["router"], -1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xf,
                                              params["w_gate"]))
    h = h * torch.einsum("td,edf->tef", xf, params["w_up"])
    y_all = torch.einsum("tef,efd->ted", h, params["w_down"])
    y = torch.gather(y_all, 1, idx[..., None].expand(-1, -1, d))
    return (y * gate[..., None]).sum(1).reshape(b, s, d)


def no_ties(probs, k):
    top = torch.topk(probs, k + 1, dim=-1).values
    return bool((top[:, :-1] - top[:, 1:]).min() > 0)


# ---------------------------------------------------------------------------
# tests/test_moe.py on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (8, 4)])
def test_matches_dense_reference_when_no_drops(e, k):
    d, f = 16, 32
    params = port_params(e, d, f, 0)
    x = t(RNG.normal(size=(2, 24, d)))
    out, aux = moe_ffn(params, x, e, k, capacity_factor=float(e))
    ref = dense_reference(params, x, e, k)
    assert float(aux["dropped"]) == 0.0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_capacity_drops_bounded():
    d, f, e, k = 8, 16, 4, 2
    params = port_params(e, d, f, 1)
    x = t(RNG.normal(size=(2, 32, d)))
    out, aux = moe_ffn(params, x, e, k, capacity_factor=0.5)
    assert 0.0 <= float(aux["dropped"]) < 1.0
    assert bool(torch.isfinite(out).all())


def test_load_balance_loss_range():
    d, f, e, k = 8, 16, 8, 2
    params = port_params(e, d, f, 2)
    x = t(RNG.normal(size=(1, 64, d)))
    _, aux = moe_ffn(params, x, e, k, capacity_factor=2.0)
    assert 0.0 < float(aux["lb_loss"]) < 6 * e


@settings(max_examples=10, deadline=None)
@given(t_=st.sampled_from([8, 64, 1000]), e=st.sampled_from([4, 16, 64]),
       k=st.sampled_from([1, 2, 6]), cf=st.sampled_from([1.0, 1.25, 2.0]))
def test_property_capacity_flops_scaling(t_, e, k, cf):
    """capacity-bucketed compute = O(T·k·cf), not O(T·E)."""
    c = capacity(t_, e, k, cf)
    routed_rows = e * c
    assert routed_rows >= t_ * k * cf * 0.99
    if e > k * cf * 2 and t_ >= 64:
        assert routed_rows < t_ * e
    assert c % 8 == 0


def test_moe_gradients_flow_to_all_param_groups():
    d, f, e, k = 8, 16, 4, 2
    params = {n: v.requires_grad_(True)
              for n, v in port_params(e, d, f, 3).items()}
    x = t(RNG.normal(size=(1, 16, d)))
    out, aux = moe_ffn(params, x, e, k, capacity_factor=4.0)
    loss = torch.sum(out ** 2) + 0.01 * aux["lb_loss"]
    grads = torch.autograd.grad(loss, list(params.values()))
    for name, g in zip(params, grads):
        assert float(g.abs().max()) > 0, name


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def test_init_has_the_reference_tree_and_dtypes():
    """Shapes as the reference's, the router fp32 in a bf16 model, and the
    reference's fan-in (the leading dim) for the expert weights."""
    g = torch.Generator().manual_seed(0)
    p = init_moe(g, 64, 128, 16, torch.bfloat16, lead=(3,))
    rp = RMOE.init_moe(jax.random.key(0), 64, 128, 16, jnp.bfloat16)
    assert {n: tuple(v.shape) for n, v in p.items()} == \
        {n: (3,) + tuple(v.shape) for n, v in rp.items()}
    assert {n: str(v.dtype) for n, v in p.items()} == \
        {n: f"torch.{v.dtype}" for n, v in rp.items()}
    assert p["router"].dtype == torch.float32
    assert abs(float(p["w_gate"].float().std()) - 16 ** -0.5) < 0.02
    assert abs(float(p["w_down"].float().std()) - 128 ** -0.5) < 0.01
    assert init_moe(None, 8, 16, 4, torch.float32)["w_up"].device.type == \
        "meta"


@pytest.mark.parametrize("e,k,cf", [
    (4, 2, 0.5), (4, 2, 1.25), (4, 2, 4.0),
    (8, 2, 0.5), (8, 2, 1.25), (8, 2, 8.0),
    (16, 6, 0.5), (16, 6, 1.25), (16, 6, 16.0),
])
def test_moe_ffn_equals_the_reference(e, k, cf):
    d, f = 16, 24
    pnp, x = ref_case(e, k, d, f, (3, 20, d), seed=e + k)
    want, waux = RMOE.moe_ffn({n: jnp.asarray(v) for n, v in pnp.items()},
                              jnp.asarray(x), e, k, capacity_factor=cf)
    params = {n: t(v) for n, v in pnp.items()}
    probs, _, idx = MOE.route(t(x).reshape(-1, d), params["router"], k)
    assert no_ties(probs, k)
    _, ridx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x).reshape(-1, d) @ jnp.asarray(pnp["router"]), -1), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    out, aux = moe_ffn(params, t(x), e, k, capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    assert float(aux["dropped"]) == float(waux["dropped"])
    assert (float(aux["dropped"]) > 0) == (cf < 1)
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(waux["lb_loss"]), rtol=1e-6)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_moe_gradients_equal_the_reference(cf):
    """The gradient of every parameter and of the input, through the
    output and the load-balance loss, against ``jax.grad``."""
    e, k, d, f = 8, 2, 16, 24
    pnp, x = ref_case(e, k, d, f, (2, 16, d), seed=11)
    dout = np.random.default_rng(12).normal(size=x.shape).astype(np.float32)

    def ref_loss(p, xx):
        out, aux = RMOE.moe_ffn(p, xx, e, k, capacity_factor=cf)
        return jnp.sum(out * dout) + 0.5 * aux["lb_loss"]

    want = jax.grad(ref_loss, argnums=(0, 1))(
        {n: jnp.asarray(v) for n, v in pnp.items()}, jnp.asarray(x))
    leaves = {n: t(v).requires_grad_(True) for n, v in pnp.items()}
    xt = t(x).requires_grad_(True)
    out, aux = moe_ffn(leaves, xt, e, k, capacity_factor=cf)
    loss = torch.sum(out * t(dout)) + 0.5 * aux["lb_loss"]
    got = torch.autograd.grad(loss, [leaves[n] for n in KEYS] + [xt])
    for name, g in zip(KEYS, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[0][name]),
                                   **GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[1]),
                               **GRAD_TOL)


def test_capacity_equals_the_reference_over_its_grid():
    for t_, e, k, cf, mult in itertools.product(
            [1, 8, 64, 1000, 8192], [4, 8, 16, 64], [1, 2, 6],
            [0.5, 1.0, 1.25, 2.0, 8.0], [8, 16]):
        assert capacity(t_, e, k, cf, mult) == \
            RMOE.capacity(t_, e, k, cf, mult), (t_, e, k, cf, mult)


@pytest.mark.parametrize("t_,e,k", [(1, 4, 2), (37, 8, 2), (200, 64, 6),
                                    (512, 4, 1)])
def test_positions_equal_the_reference_cumsum(t_, e, k):
    """``positions`` (a stable sort by expert) gives the reference's
    cumsum over the one-hot, integer for integer."""
    idx = np.random.default_rng(t_).integers(0, e, (t_, k))
    onehot = np.eye(e, dtype=np.int64)[idx.reshape(-1)]
    want = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    got = MOE.positions(torch.from_numpy(idx.reshape(-1)), e)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropped_rows_are_the_latest_in_token_order():
    """Each expert keeps its first ``cap`` (token, choice) pairs in
    token-major order; the dropped ones add nothing to their token."""
    e, k, d, f = 4, 2, 8, 16
    params = port_params(e, d, f, 5)
    x = t(RNG.normal(size=(1, 40, d)))
    cf = 0.5
    cap = capacity(40, e, k, cf)
    _, gate, idx = MOE.route(x.reshape(-1, d), params["router"], k)
    seen = {i: 0 for i in range(e)}
    kept = np.zeros((40, k), bool)
    for tok in range(40):
        for j in range(k):
            ex = int(idx[tok, j])
            kept[tok, j] = seen[ex] < cap
            seen[ex] += 1
    out, aux = moe_ffn(params, x, e, k, capacity_factor=cf)
    assert abs(float(aux["dropped"]) - (1 - kept.mean())) < 1e-7
    # a token whose choices were all dropped gets zero output
    for tok in np.flatnonzero(~kept.any(1)):
        assert float(out[0, tok].abs().max()) == 0.0
    # one that kept all its choices matches the dense oracle
    dense = dense_reference(params, x, e, k)
    full = np.flatnonzero(kept.all(1))
    assert len(full)
    np.testing.assert_allclose(out[0, full].numpy(), dense[0, full].numpy(),
                               **TOL)


def test_backward_is_bitwise_repeatable():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        e, k, d, f = 8, 2, 16, 24
        pnp, x = ref_case(e, k, d, f, (2, 24, d), seed=21)
        runs = []
        for _ in range(2):
            leaves = [t(pnp[n]).requires_grad_(True) for n in KEYS]
            out, aux = moe_ffn(dict(zip(KEYS, leaves)), t(x), e, k, 1.0)
            runs.append(torch.autograd.grad(
                (out ** 2).sum() + aux["lb_loss"], leaves))
        assert all(torch.equal(a, b) for a, b in zip(*runs))
    finally:
        torch.set_num_threads(threads)
