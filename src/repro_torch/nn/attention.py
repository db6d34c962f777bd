"""GQA attention with qk-norm, RoPE, logit softcap, sliding windows,
cross-attention and KV-cache decode (the port's copy of
``repro.nn.attention``).

The attention core is K10 (``kernels/flash_attention.py``): its Hopper
kernel on CUDA tensors, its plain version (the reference's einsum /
softmax, with the reference's ``_mask`` as ``attention_mask``) on CPU
ones. KV heads are never replicated. Where the reference
returns a new cache from ``dynamic_update_slice``, the port writes the
step's K/V into the preallocated cache in place and attends over it; at
prefill a cross-attention layer likewise writes the K/V of its memory into
the preallocated cross cache.

On a mesh whose resolver splits the heads (``launch/partitioning.py``)
the block is Megatron's: the input goes through ``to_model`` (its gradient
summed over ``model``), the rank projects and attends with its own query
heads and the KV heads they group with (the split ones, or, where ``tp``
does not divide the KV heads, its group's of the whole set it computes),
and ``wo``'s partial sums are all-reduced (``rp_einsum``). The cache given
holds the KV heads the rank computes. Under v-E (``seq``) the input is
the rank's slice of the sequence, all-gathered first (its gradient
reduce-scattered where the heads split), and ``wo``'s sums are
reduce-scattered back to the slice.

v-C (the resolver's ``run.kv_seq``: a decode over a self-attention cache
split on the sequence) is the reference's ``_seqshard_decode_attention``:
each rank projects the heads its weights hold and the token's q, k and v
are all-gathered over heads (as XLA gathers them before the reference's
``shard_map``), the rank whose slice holds the position writes the
token's K/V, each rank scores its ``S / tp`` keys and the
``(max, numerator, denominator)`` of its partial softmax are combined over
``model`` (the max all-reduced, both sums in fp32); then ``wo`` (split on
heads where stored so) through ``rp_einsum``. Like the reference it runs
outside the attention kernel, as plain torch ops; the scores are taken
from fp32 operands (the reference's from the model dtype). A cross
attention in such a decode also computes every head (its cache gathered)
(its q gathered over heads, its cache gathered) and keeps its heads for a
split ``wo``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.lm.config import LayerSpec, LMConfig
from repro_torch.nn.common import (dense_init, init_device, mesh_ctx,
                                   rms_norm, rope, rp_einsum, shard, softcap)


def init_attention(generator: Optional[torch.Generator], cfg: LMConfig,
                   dtype: torch.dtype, lead: tuple = (),
                   cross: bool = False) -> Dict:
    """Attention parameters (``lead``: stacked repeat dims; a ``None``
    generator gives shapes only, on the meta device). A cross-attention
    layer (``cross``) has no qk-norm."""
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init((d, h, hd), dtype, generator, lead=lead),
        "wk": dense_init((d, kv, hd), dtype, generator, lead=lead),
        "wv": dense_init((d, kv, hd), dtype, generator, lead=lead),
        "wo": dense_init((h, hd, d), dtype, generator, fan_in=h * hd,
                         lead=lead),
    }
    if cfg.qk_norm and not cross:
        dev = init_device(generator)
        p["q_norm"] = torch.ones(tuple(lead) + (hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(tuple(lead) + (hd,), dtype=dtype, device=dev)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    d, heads, hd = w.shape
    return torch.matmul(x, w.reshape(d, heads * hd)).reshape(
        x.shape[0], x.shape[1], heads, hd)


def attention(
    params: Dict,
    x: torch.Tensor,                    # [B, Q, D]
    cfg: LMConfig,
    spec: LayerSpec,
    q_positions: torch.Tensor,          # [Q] consecutive, batch-shared
    *,
    memory: Optional[torch.Tensor] = None,   # cross K/V source [B, M, D]
    cross_kv: Optional[Dict] = None,    # cross cache {"k", "v": [B, M, KV, hd]}
    store_cross: bool = False,          # prefill: fill / return the cross K/V
    kv_cache: Optional[Dict] = None,    # {"k", "v": [B, S, KV, hd]}
    cache_index: Optional[int] = None,  # write position (a Python int)
    causal: bool = True,
    seq: bool = False,                  # v-E: x is the rank's sequence slice
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One attention block: ``(out [B, Q, D], cache)``.

    Self-attention (no ``memory``, no ``cross_kv``): with ``kv_cache`` the
    step's K/V are written into it at ``cache_index`` (in place) and the
    queries, at positions ``cache_index + arange(Q)``, attend over the whole
    cache; the returned cache is the same tensors. Without it the queries
    attend over their own K/V, causally unless ``causal=False`` (the
    encoder). ``q_positions`` are consecutive in both cases (every caller of
    the model passes an ``arange``), which is what K10's ``q_offset``
    encodes.

    Cross-attention: K/V are projected from ``memory`` (prefill, training)
    or read from ``cross_kv`` (decode); no RoPE, no k-norm, and every query
    sees every memory position. With ``store_cross`` and ``memory`` the
    projected K/V are returned as the cross cache: written in place into
    ``cross_kv`` where it is given (the preallocated cache), else as new
    tensors (the reference's ``store_cross``).
    """
    is_cross = memory is not None or cross_kv is not None
    ctx = mesh_ctx()
    if (ctx is not None and ctx.run.kv_seq and kv_cache is not None
            and not is_cross):
        return _seqshard_decode(params, x, cfg, spec, q_positions, kv_cache,
                                cache_index, ctx)
    split = ctx is not None and ctx.attn_split
    if seq:
        x = ctx.seq_gather(x, partial=split)
    elif split:
        x = ctx.to_model(x)
    if split and memory is not None:
        memory = ctx.to_model(memory)
    q = _project(x, params["wq"])
    if memory is not None:
        k = _project(memory, params["wk"])
        v = _project(memory, params["wv"])
    elif cross_kv is not None:
        k, v = cross_kv["k"], cross_kv["v"]
    else:
        k = _project(x, params["wk"])
        v = _project(x, params["wv"])
    if cfg.qk_norm and "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        if not is_cross:
            k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if not is_cross:
        q = rope(q, q_positions, cfg.rope_theta)
        k = rope(k, q_positions, cfg.rope_theta)
    if ctx is not None and ctx.q_split:           # v-C: every head here
        q = ctx.gather_model(q, 2)

    new_cache = None
    q_offset = 0
    if is_cross:
        if store_cross and memory is not None:
            if cross_kv is not None:
                cross_kv["k"].copy_(k)
                cross_kv["v"].copy_(v)
                new_cache = cross_kv
            else:
                new_cache = {"k": k, "v": v}
        causal = False
        q_offset = int(cache_index or 0)
    elif kv_cache is not None:
        kc, vc = kv_cache["k"], kv_cache["v"]
        q_len = x.shape[1]
        kc[:, cache_index:cache_index + q_len] = k.to(kc.dtype)
        vc[:, cache_index:cache_index + q_len] = v.to(vc.dtype)
        new_cache = {"k": kc, "v": vc}
        k, v = kc, vc
        q_offset = int(cache_index)

    if split:
        lo, hi = ctx.kv_rows(k.shape[2])
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    out = flash_attention(q, k, v, causal=causal, window=spec.window,
                          softcap=cfg.attn_softcap, q_offset=q_offset)
    out = shard("attn_out_heads", out)
    if not split and ctx is not None and ctx.splits("wo"):
        out = ctx.model_slice(out, 2)       # v-C: the heads of the split wo
    return rp_einsum("bqhk,hkd->bqd", out, params["wo"], leaf="wo",
                     seq=seq), new_cache


def _qkv(params: Dict, x: torch.Tensor, cfg: LMConfig,
         positions: torch.Tensor):
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qk_norm and "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _seqshard_decode(params: Dict, x: torch.Tensor, cfg: LMConfig,
                     spec: LayerSpec, q_positions: torch.Tensor,
                     kv_cache: Dict, cache_index: int, ctx):
    """v-C: one token a row against this rank's slice ``[B, S / tp, KV,
    hd]`` of a sequence-split cache (written in place where the slice
    holds ``cache_index``); ``(out [B, 1, D], cache)``."""
    q, k, v = _qkv(params, x, cfg, q_positions)
    if ctx.q_split:
        q = ctx.gather_model(q, 2)
    if ctx.kv_heads_split:
        k, v = ctx.gather_model(k, 2), ctx.gather_model(v, 2)
    kc, vc = kv_cache["k"], kv_cache["v"]
    s_l = kc.shape[1]
    lo = ctx.model_index() * s_l
    if lo <= cache_index < lo + s_l:
        kc[:, cache_index - lo:cache_index - lo + 1] = k.to(kc.dtype)
        vc[:, cache_index - lo:cache_index - lo + 1] = v.to(vc.dtype)
    b, _, h, hd = q.shape
    kv = kc.shape[2]
    k_pos = lo + torch.arange(s_l, device=kc.device)
    qg = q.float().reshape(b, 1, kv, h // kv, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kc.float())
    scores = softcap(scores / math.sqrt(hd), cfg.attn_softcap)
    valid = k_pos[None, :] <= q_positions[:, None]
    if spec.window is not None:
        valid &= k_pos[None, :] > q_positions[:, None] - spec.window
    scores = scores.masked_fill(~valid, -1e30)
    m_l = scores.amax(dim=-1)                              # [b, kv, g, 1]
    p = torch.exp(scores - m_l[..., None])
    num_l = torch.einsum("bkgqs,bskd->bkgqd", p, vc.float())
    m_g = ctx.max_model(m_l)
    corr = torch.exp(m_l - m_g)
    num = ctx.reduce_model(num_l * corr[..., None])
    den = ctx.reduce_model(p.sum(dim=-1) * corr)
    out = num / torch.clamp(den, min=1e-38)[..., None]     # [b, kv, g, 1, hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(q.dtype)
    if ctx.splits("wo"):
        out = ctx.model_slice(out, 2)
    return rp_einsum("bqhk,hkd->bqd", out, params["wo"], leaf="wo"), \
        {"k": kc, "v": vc}
