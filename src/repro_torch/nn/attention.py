"""GQA self-attention with qk-norm, RoPE, logit softcap, sliding windows and
KV-cache decode (the port's copy of ``repro.nn.attention``).

The attention core is K10 (``kernels/flash_attention.py``): its Hopper
kernel on CUDA tensors, its plain version (the reference's einsum /
softmax, with the reference's ``_mask`` as ``attention_mask``) on CPU
ones. KV heads are never replicated. Where the reference
returns a new cache from ``dynamic_update_slice``, the port writes the
step's K/V into the preallocated cache in place and attends over it.

Not ported yet (``ROADMAP.md`` §1, the LM substrate): cross-attention
(``memory`` / ``cross_kv``, for whisper and llama-vision; ``TransformerLM``
refuses a config that has it) and the sequence-sharded decode of a mesh
(``_seqshard_decode_attention``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.lm.config import LayerSpec, LMConfig
from repro_torch.nn.common import dense_init, init_device, rms_norm, rope


def init_attention(generator: Optional[torch.Generator], cfg: LMConfig,
                   dtype: torch.dtype, lead: tuple = ()) -> Dict:
    """Self-attention parameters (``lead``: stacked repeat dims; a ``None``
    generator gives shapes only, on the meta device)."""
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init((d, h, hd), dtype, generator, lead=lead),
        "wk": dense_init((d, kv, hd), dtype, generator, lead=lead),
        "wv": dense_init((d, kv, hd), dtype, generator, lead=lead),
        "wo": dense_init((h, hd, d), dtype, generator, fan_in=h * hd,
                         lead=lead),
    }
    if cfg.qk_norm:
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
    kv_cache: Optional[Dict] = None,    # {"k", "v": [B, S, KV, hd]}
    cache_index: Optional[int] = None,  # write position (a Python int)
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One self-attention block: ``(out [B, Q, D], cache)``.

    With ``kv_cache`` the step's K/V are written into it at
    ``cache_index`` (in place) and the queries, at positions
    ``cache_index + arange(Q)``, attend over the whole cache; the returned
    cache is the same tensors. Without it the queries attend over their own
    K/V. ``q_positions`` are consecutive in both cases (every caller of the
    model passes an ``arange``), which is what K10's ``q_offset`` encodes.
    """
    h = cfg.num_heads
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qk_norm and "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, q_positions, cfg.rope_theta)
    k = rope(k, q_positions, cfg.rope_theta)

    new_cache = None
    q_offset = 0
    if kv_cache is not None:
        kc, vc = kv_cache["k"], kv_cache["v"]
        q_len = x.shape[1]
        kc[:, cache_index:cache_index + q_len] = k.to(kc.dtype)
        vc[:, cache_index:cache_index + q_len] = v.to(vc.dtype)
        new_cache = {"k": kc, "v": vc}
        k, v = kc, vc
        q_offset = int(cache_index)

    out = flash_attention(q, k, v, window=spec.window,
                          softcap=cfg.attn_softcap, q_offset=q_offset)
    b, q_len = out.shape[:2]
    wo = params["wo"]
    out = torch.matmul(out.reshape(b, q_len, h * wo.shape[1]),
                       wo.reshape(h * wo.shape[1], wo.shape[2]))
    return out, new_cache
