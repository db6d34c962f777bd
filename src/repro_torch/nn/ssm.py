"""Mamba2 layer via the SSD (state-space duality) chunked algorithm
(Dao & Gu, arXiv:2405.21060); the port's copy of ``repro.nn.ssm``.

Recurrence (per head h, state n, head-dim p):
    h_t = exp(dt_t·A) · h_{t-1} + dt_t · B_t ⊗ x_t
    y_t = C_t · h_t + D · x_t

The chunked form computes, per chunk of Q tokens, an intra-chunk quadratic
"attention-like" term (batched GEMMs) plus an inter-chunk recurrence over
the chunk states (a loop over the l/Q chunks, the reference's
``lax.scan``). Everything in the SSD runs in fp32. The einsums stay
``torch.einsum``: the reference computes them outside any Pallas kernel.

``ssd_sequential`` is the step-by-step oracle of the tests and the decode
step.

Differences by design:

* the cache is written in place, as attention writes its KV cache: a
  prefill stores the conv window's last ``K - 1`` inputs and the final
  state into the given cache, a decode step rolls the window and replaces
  the state there. A prompt shorter than ``K - 1`` has no whole conv
  window, so its prefill raises ``ValueError`` (the reference fails on it
  while tracing).
* the intra-chunk decay masks the upper triangle before the ``exp``
  (``exp(-inf) = 0``), where the reference masks after it. The values are
  the same; the reference's gradient there is ``0 * exp(diff)``, which is
  NaN once ``exp(diff)`` overflows (a long chunk of large ``dt``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.lm.config import LMConfig
from repro_torch.nn.common import dense_init, init_device, rms_norm, shard


def init_mamba(generator: Optional[torch.Generator], cfg: LMConfig,
               dtype: torch.dtype, lead: tuple = ()) -> Dict:
    """Input projections as separate matrices (z / x / BC / dt), as in the
    reference; ``A_log``, ``dt_bias`` and ``D_skip`` stay fp32."""
    d = cfg.d_model
    din, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    g, kk = cfg.ssm_groups, cfg.ssm_conv
    dev = init_device(generator)
    full = lambda shape, v, dt: torch.full(   # noqa: E731
        tuple(lead) + shape, v, dtype=dt, device=dev)
    return {
        "wi_z": dense_init((d, din), dtype, generator, lead=lead),
        "wi_x": dense_init((d, din), dtype, generator, lead=lead),
        "wi_bc": dense_init((d, 2 * g * ns), dtype, generator, lead=lead),
        "wi_dt": dense_init((d, nh), dtype, generator, lead=lead),
        "conv_w_x": dense_init((kk, din), dtype, generator, fan_in=kk,
                               lead=lead),
        "conv_w_bc": dense_init((kk, 2 * g * ns), dtype, generator,
                                fan_in=kk, lead=lead),
        "conv_b_x": full((din,), 0.0, dtype),
        "conv_b_bc": full((2 * g * ns,), 0.0, dtype),
        "A_log": full((nh,), 0.0, torch.float32),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "D_skip": full((nh,), 1.0, torch.float32),
        "gate_norm": full((din,), 1.0, dtype),
        "wo": dense_init((din, d), dtype, generator, fan_in=din, lead=lead),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, fp32 taps, then SiLU. xbc: [B, L,
    C]; w: [K, C]."""
    k, n = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i:i + n].float() * w[i].float()
    return F.silu(out + b.float()).to(xbc.dtype)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def ssd_chunked(
    xh: torch.Tensor,    # [b, l, h, p]
    dt: torch.Tensor,    # [b, l, h]  (post-softplus)
    a: torch.Tensor,     # [h]        (negative)
    bm: torch.Tensor,    # [b, l, h, n]  (already expanded over heads)
    cm: torch.Tensor,    # [b, l, h, n]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # [b, h, p, n]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [b, l, h, p] in xh's dtype, final state [b, h, p, n] fp32)``."""
    b, l, h, p = xh.shape
    n = bm.shape[-1]
    pad = (-l) % chunk
    if pad:
        # zero-pad the tail; dt = 0 makes padded steps identity state
        # updates (exp(0) = 1 decay, zero input contribution)
        def zp(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        y, state = ssd_chunked(zp(xh), zp(dt), a, zp(bm), zp(cm), chunk,
                               init_state)
        return y[:, :l], state
    c, q = l // chunk, chunk
    x_ = xh.reshape(b, c, q, h, p).float()
    dt_ = dt.reshape(b, c, q, h).float()
    b_ = bm.reshape(b, c, q, h, n).float()
    c_ = cm.reshape(b, c, q, h, n).float()

    da = dt_ * a.float()                                  # [b,c,q,h]
    da_cs = torch.cumsum(da, dim=2)                       # inclusive

    # intra-chunk (quadratic): L[i,j] = exp(cs_i - cs_j) for i >= j
    diff = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]   # [b,c,i,j,h]
    upper = ~torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xh.device))[None, None, :, :, None]
    decay = torch.exp(diff.masked_fill(upper, float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", c_, b_)
    m = scores * decay * dt_[:, :, None, :, :]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", m, x_)
    del diff, decay, scores, m

    # chunk-final states: S_c = Σ_j exp(cs_Q - cs_j) dt_j B_j ⊗ x_j
    decay_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)    # [b,c,q,h]
    s_c = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", dt_ * decay_end, b_, x_)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])           # [b,c,h]

    # inter-chunk recurrence; keep the state *entering* each chunk
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if init_state is None else init_state.float())
    states_in = []
    for i in range(c):
        states_in.append(state)
        state = state * chunk_decay[:, i, :, None, None] + s_c[:, i]
    states_in = torch.stack(states_in, dim=1)             # [b,c,h,p,n]

    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", c_, states_in,
                         torch.exp(da_cs))
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y.to(xh.dtype), state


def ssd_sequential(xh, dt, a, bm, cm, init_state=None):
    """Step-by-step oracle (and the decode step): ``(y [b, l, h, p] in
    xh's dtype, final state [b, h, p, n] fp32)``."""
    b, l, h, p = xh.shape
    n = bm.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if init_state is None else init_state.float())
    a = a.float()
    ys = []
    for i in range(l):
        x_t, dt_t = xh[:, i].float(), dt[:, i].float()
        b_t, c_t = bm[:, i].float(), cm[:, i].float()
        da = torch.exp(dt_t * a)[:, :, None, None]
        state = state * da + torch.einsum("bh,bhn,bhp->bhpn", dt_t, b_t, x_t)
        ys.append(torch.einsum("bhn,bhpn->bhp", c_t, state))
    return torch.stack(ys, dim=1).to(xh.dtype), state


# ---------------------------------------------------------------------------
# full Mamba2 layer
# ---------------------------------------------------------------------------
def mamba_forward(
    params: Dict,
    x: torch.Tensor,               # [B, L, D]
    cfg: LMConfig,
    cache: Optional[Dict] = None,  # {"conv": [B, K-1, C], "state": [B,h,p,n]}
    *,
    prefill: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One Mamba2 layer: ``(out [B, L, D], cache)``.

    Without ``cache`` the chunked SSD runs over ``x`` from a zero state.
    With ``cache`` and ``prefill`` it does the same and writes the last
    ``K - 1`` conv inputs (model dtype) and the final state (fp32) into
    the cache in place; without ``prefill`` ``x`` is one token (``L ==
    1``) that rolls the cache's conv window and advances its state, in
    place. The returned cache is the given tensors."""
    din, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    g, hd, kk = cfg.ssm_groups, cfg.ssm_head_dim, cfg.ssm_conv
    bsz, l, _ = x.shape
    z = x @ params["wi_z"]
    xin = x @ params["wi_x"]
    bc = x @ params["wi_bc"]
    dt = x @ params["wi_dt"]

    decode = cache is not None and not prefill
    if not decode:
        if cache is not None:
            if l < kk - 1:
                raise ValueError(
                    f"a Mamba prefill needs at least ssm_conv - 1 = "
                    f"{kk - 1} tokens to fill its conv window; the prompt "
                    f"has {l}")
            conv_tail = torch.cat([xin, bc], -1)[:, l - (kk - 1):]
        xin = _causal_conv(xin, params["conv_w_x"], params["conv_b_x"])
        bc = _causal_conv(bc, params["conv_w_bc"], params["conv_b_bc"])
    else:
        # decode: one token, rolling conv window + recurrent state
        if l != 1:
            raise ValueError(f"a Mamba decode step takes one token, not {l}")
        cur = torch.cat([xin, bc], -1)
        window = torch.cat([cache["conv"], cur.to(cache["conv"].dtype)], 1)
        conv_w = torch.cat([params["conv_w_x"], params["conv_w_bc"]],
                           -1).float()
        conv_b = torch.cat([params["conv_b_x"], params["conv_b_bc"]],
                           -1).float()
        conv_out = torch.einsum("bkc,kc->bc", window.float(), conv_w)
        conv_out = F.silu(conv_out + conv_b)[:, None, :].to(x.dtype)
        xin, bc = conv_out[..., :din], conv_out[..., din:]
        conv_tail = window[:, 1:]

    hpg = nh // g
    bmat = bc[..., :g * ns].reshape(bsz, l, g, ns).repeat_interleave(hpg, 2)
    cmat = bc[..., g * ns:].reshape(bsz, l, g, ns).repeat_interleave(hpg, 2)
    xh = shard("ssm_heads", xin.reshape(bsz, l, nh, hd))
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])

    if decode:
        y, final_state = ssd_sequential(xh, dt, a, bmat, cmat,
                                        cache["state"])
    else:
        y, final_state = ssd_chunked(xh, dt, a, bmat, cmat, cfg.ssm_chunk)

    y = y + (params["D_skip"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(bsz, l, din)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"],
                 cfg.norm_eps)
    out = y @ params["wo"]
    if cache is not None:
        cache["conv"].copy_(conv_tail)
        cache["state"].copy_(final_state)
    return out, cache
