"""The port's Mamba2 / SSD layer (``repro_torch.nn.ssm``) against the JAX
reference (``repro.nn.ssm``), on the CPU: every case of
``tests/test_ssm.py`` on the port, ``ssd_chunked`` / ``ssd_sequential``
and ``mamba_forward`` (no cache, prefill into a cache, decode from one)
against the reference at 1e-4 (decode 1e-3, the reference's own bound for
decode against the full forward), the in-place cache writes, the
short-prompt refusal, and the gradient at a long chunk, where the
reference's is NaN.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as RC
from repro.nn import ssm as RS
from repro_torch import configs as C
from repro_torch.nn.ssm import (init_mamba, mamba_forward, ssd_chunked,
                                ssd_sequential)

RNG = np.random.default_rng(0)
TOL = dict(rtol=1e-4, atol=1e-4)
DEC_TOL = dict(rtol=1e-3, atol=1e-3)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _inputs(b, l, h, p, n, scale=1.0, rng=RNG):
    xh = t(rng.normal(size=(b, l, h, p)))
    dt = t(rng.uniform(0.01, 0.2, size=(b, l, h)))
    a = -t(rng.uniform(0.5, 2.0, size=(h,)))
    bm = t(rng.normal(size=(b, l, h, n)) * scale)
    cm = t(rng.normal(size=(b, l, h, n)) * scale)
    return xh, dt, a, bm, cm


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# tests/test_ssm.py on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("l,chunk", [(16, 4), (32, 8), (24, 24), (8, 2)])
def test_chunked_equals_sequential(l, chunk):
    xh, dt, a, bm, cm = _inputs(2, l, 3, 4, 5)
    y_c, s_c = ssd_chunked(xh, dt, a, bm, cm, chunk)
    y_s, s_s = ssd_sequential(xh, dt, a, bm, cm)
    close(y_c, y_s.numpy())
    close(s_c, s_s.numpy())


def test_chunked_with_initial_state():
    xh, dt, a, bm, cm = _inputs(1, 16, 2, 3, 4)
    init = t(RNG.normal(size=(1, 2, 3, 4)))
    y_c, s_c = ssd_chunked(xh, dt, a, bm, cm, 4, init_state=init)
    y_s, s_s = ssd_sequential(xh, dt, a, bm, cm, init_state=init)
    close(y_c, y_s.numpy())
    close(s_c, s_s.numpy())


def test_state_handoff_splits_sequence():
    """Running [0:L1] then [L1:L] with the carried state == full run."""
    xh, dt, a, bm, cm = _inputs(1, 24, 2, 3, 4)
    y_full, s_full = ssd_sequential(xh, dt, a, bm, cm)
    y1, s1 = ssd_chunked(xh[:, :16], dt[:, :16], a, bm[:, :16], cm[:, :16], 8)
    y2, s2 = ssd_sequential(xh[:, 16:], dt[:, 16:], a, bm[:, 16:],
                            cm[:, 16:], init_state=s1)
    close(torch.cat([y1, y2], 1), y_full.numpy())
    close(s2, s_full.numpy())


@settings(max_examples=10, deadline=None)
@given(l=st.sampled_from([8, 16]), chunk=st.sampled_from([2, 4, 8]),
       h=st.integers(1, 3), seed=st.integers(0, 3))
def test_property_chunk_size_invariance(l, chunk, h, seed):
    rng = np.random.default_rng(seed)
    xh = t(rng.normal(size=(1, l, h, 2)))
    dt = t(rng.uniform(0.01, 0.3, size=(1, l, h)))
    a = -t(rng.uniform(0.5, 1.5, size=(h,)))
    bm = t(rng.normal(size=(1, l, h, 3)))
    cm = t(rng.normal(size=(1, l, h, 3)))
    y1, s1 = ssd_chunked(xh, dt, a, bm, cm, chunk)
    y2, s2 = ssd_chunked(xh, dt, a, bm, cm, l)   # single chunk
    close(y1, y2.numpy())
    close(s1, s2.numpy())


def _layer(rcfg, seed=0):
    """The reference's layer parameters and the same as torch tensors."""
    rp = RS.init_mamba(jax.random.key(seed), rcfg, jnp.float32)
    return rp, {k: t(v) for k, v in rp.items()}


def test_mamba_layer_decode_continues_prefill():
    cfg = C.get_reduced("mamba2-780m")
    _, params = _layer(RC.get_reduced("mamba2-780m"))
    x = t(RNG.normal(size=(2, 17, cfg.d_model)))
    y_full, _ = mamba_forward(params, x, cfg)
    cache = _empty_cache(cfg, 2)
    y_pre, cache = mamba_forward(params, x[:, :16], cfg, cache, prefill=True)
    y_dec, _ = mamba_forward(params, x[:, 16:], cfg, cache)
    close(y_pre, y_full[:, :16].numpy())
    close(y_dec, y_full[:, 16:].numpy(), **DEC_TOL)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def _empty_cache(cfg, b, dtype=torch.float32):
    ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"conv": torch.zeros((b, cfg.ssm_conv - 1, ch), dtype=dtype),
            "state": torch.zeros((b, cfg.ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state))}


@pytest.mark.parametrize("l,chunk,init", [(16, 4, False), (21, 8, False),
                                          (24, 24, True), (13, 4, True)])
def test_ssd_equals_the_reference(l, chunk, init):
    """Both SSD forms against the reference's, a ragged tail (zero-padded
    to a whole chunk) and a carried-in state included."""
    xh, dt, a, bm, cm = _inputs(2, l, 3, 4, 5)
    s0 = t(RNG.normal(size=(2, 3, 4, 5))) if init else None
    j = [jnp.asarray(v.numpy()) for v in (xh, dt, a, bm, cm)]
    j0 = None if s0 is None else jnp.asarray(s0.numpy())
    for got, want in (
            (ssd_chunked(xh, dt, a, bm, cm, chunk, s0),
             RS.ssd_chunked(*j, chunk, j0)),
            (ssd_sequential(xh, dt, a, bm, cm, s0),
             RS.ssd_sequential(*j, j0))):
        close(got[0], want[0])
        close(got[1], want[1])
        assert got[1].dtype == torch.float32


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_mamba_forward_equals_the_reference(arch):
    """No cache; a prefill of 11 tokens (a ragged chunk) against the
    reference's ``return_cache=True``, its conv tail and state written
    into the given cache in place; then three decode steps against the
    reference's decode, cache for cache."""
    rcfg, cfg = RC.get_reduced(arch), C.get_reduced(arch)
    rp, params = _layer(rcfg, seed=1)
    x = RNG.normal(size=(2, 14, cfg.d_model)).astype(np.float32)
    want, none = RS.mamba_forward(rp, jnp.asarray(x), rcfg)
    got, cache = mamba_forward(params, t(x), cfg)
    assert none is None and cache is None
    close(got, want)

    want, rc = RS.mamba_forward(rp, jnp.asarray(x[:, :11]), rcfg,
                                return_cache=True)
    cache = _empty_cache(cfg, 2)
    conv, state = cache["conv"], cache["state"]
    got, out_cache = mamba_forward(params, t(x[:, :11]), cfg, cache,
                                   prefill=True)
    assert out_cache["conv"] is conv and out_cache["state"] is state
    close(got, want)
    close(conv, rc["conv"])
    close(state, rc["state"])
    for i in range(11, 14):
        want, rc = RS.mamba_forward(rp, jnp.asarray(x[:, i:i + 1]), rcfg,
                                    cache=rc)
        got, out_cache = mamba_forward(params, t(x[:, i:i + 1]), cfg, cache)
        assert out_cache["conv"] is conv and out_cache["state"] is state
        close(got, want, **DEC_TOL)
        close(conv, rc["conv"])
        close(state, rc["state"], **DEC_TOL)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_mamba_forward_gradients_equal_the_reference(arch):
    """Every parameter's and the input's gradient of one layer (B 2, L 32:
    four chunks) against ``jax.grad``, within 1e-5 of each leaf's largest
    entry (fp32 rounding of the two stays under 1e-6 of it)."""
    rcfg, cfg = RC.get_reduced(arch), C.get_reduced(arch)
    rp, params = _layer(rcfg, seed=2)
    x = RNG.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    dy = RNG.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    want = jax.grad(
        lambda p, xx: jnp.sum(RS.mamba_forward(p, xx, rcfg)[0] * dy),
        argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xt = t(x).requires_grad_(True)
    out, _ = mamba_forward(leaves, xt, cfg)
    got = torch.autograd.grad((out * t(dy)).sum(),
                              list(leaves.values()) + [xt])
    for name, g in zip(list(leaves) + ["x"], got):
        w = np.asarray(want[1] if name == "x" else want[0][name])
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (name, err)


def test_cache_views_of_a_stacked_cache_are_written_in_place():
    """The model hands each repeat a view of its stage's stacked cache:
    the writes land in that repeat's slice and nowhere else."""
    cfg = C.get_reduced("mamba2-780m")
    _, params = _layer(RC.get_reduced("mamba2-780m"))
    ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv = torch.zeros((3, 2, cfg.ssm_conv - 1, ch))
    state = torch.zeros((3, 2, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state))
    x = t(RNG.normal(size=(2, 9, cfg.d_model)))
    mamba_forward(params, x, cfg, {"conv": conv[1], "state": state[1]},
                  prefill=True)
    assert bool(conv[1].abs().sum() > 0) and bool(state[1].abs().sum() > 0)
    for r in (0, 2):
        assert not conv[r].any() and not state[r].any()


def test_short_prompt_prefill_raises():
    cfg = C.get_reduced("mamba2-780m")
    _, params = _layer(RC.get_reduced("mamba2-780m"))
    x = t(RNG.normal(size=(2, cfg.ssm_conv - 2, cfg.d_model)))
    with pytest.raises(ValueError, match="ssm_conv - 1"):
        mamba_forward(params, x, cfg, _empty_cache(cfg, 2), prefill=True)
    mamba_forward(params, x, cfg)          # no cache: nothing to fill
    ok = t(RNG.normal(size=(2, cfg.ssm_conv - 1, cfg.d_model)))
    mamba_forward(params, ok, cfg, _empty_cache(cfg, 2), prefill=True)
    with pytest.raises(ValueError, match="one token"):
        mamba_forward(params, ok, cfg, _empty_cache(cfg, 2))


def test_init_has_the_reference_tree_and_fp32_leaves():
    """Shapes as the reference's; ``A_log``, ``dt_bias`` and ``D_skip``
    fp32 in a bf16 model."""
    rcfg = RC.get_reduced("jamba-v0.1-52b")
    cfg = C.get_reduced("jamba-v0.1-52b")
    rp = RS.init_mamba(jax.random.key(0), rcfg, jnp.bfloat16)
    p = init_mamba(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                   lead=(2,))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: (2,) + tuple(v.shape) for k, v in rp.items()}
    assert {k: str(v.dtype) for k, v in p.items()} == \
        {k: f"torch.{v.dtype}" for k, v in rp.items()}
    for k in ("A_log", "dt_bias", "D_skip"):
        assert p[k].dtype == torch.float32
        np.testing.assert_array_equal(p[k][0].numpy(), np.asarray(rp[k]))


def test_long_chunk_gradient_is_finite_where_the_reference_is_nan():
    """At a chunk of 256 with large steps, ``exp(diff)`` over the masked
    upper triangle overflows: the reference's gradient is NaN there
    (``0 * inf``). The port masks before the ``exp``: the same outputs,
    and a gradient equal to the reference's at a chunk short enough not to
    overflow."""
    rng = np.random.default_rng(7)
    xh, dt, a, bm, cm = _inputs(1, 256, 2, 3, 4, rng=rng)
    dt = dt * 5                                   # up to 1.0 a step
    a = a * 2
    dy = rng.normal(size=(1, 256, 2, 3)).astype(np.float32)

    def ref(chunk):
        def f(*args):
            y, s = RS.ssd_chunked(*args, chunk)
            return jnp.sum(y * dy) + jnp.sum(s)
        args = [jnp.asarray(v.numpy()) for v in (xh, dt, a, bm, cm)]
        return jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4))(*args)

    (v256, g256), (v16, g16) = ref(256), ref(16)
    assert any(bool(jnp.isnan(g).any()) for g in g256)
    leaves = [v.clone().requires_grad_(True) for v in (xh, dt, a, bm, cm)]
    y, s = ssd_chunked(*leaves, 256)
    val = torch.sum(y * t(dy)) + torch.sum(s)
    np.testing.assert_allclose(float(val.detach()), float(v256),
                               rtol=1e-5)
    for g, w in zip(torch.autograd.grad(val, leaves), g16):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3)

