"""LM architecture configuration (the port's copy of ``repro.lm.config``).

A model is a sequence of **stages**; each stage is a repeated homogeneous
layer *pattern* (tuple of LayerSpec). Parameters are stacked over each
stage's repeat dimension, as in the reference; the port runs the repeats as
a Python loop. Hybrid architectures (Jamba's
1:7 Mamba:attention interleave, Gemma's local:global alternation,
Llama-vision's cross-attention insertion) are expressed as multi-layer
patterns.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the backbone pattern."""

    kind: str = "self_attn"         # self_attn | cross_attn | mamba
    moe: bool = False               # MoE MLP instead of dense MLP
    window: Optional[int] = None    # sliding-window size; None = global
    dec_cross: bool = False         # enc-dec decoder layer (self + cross)


@dataclasses.dataclass(frozen=True)
class Stage:
    pattern: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    stages: Tuple[Stage, ...]
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention options
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # encoder / multimodal frontend (stubs provide embeddings)
    encoder_layers: int = 0
    encoder_seq: int = 0            # whisper: 1500 frames
    frontend_tokens: int = 0        # llama-vision: image patch tokens
    frontend_dim: int = 0           # provided embedding dim (projected to d_model)
    # misc
    tie_embeddings: bool = True
    scale_embed: bool = False       # Gemma-style sqrt(d_model) embed scaling
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    sub_quadratic: bool = False     # eligible for long_500k cell
    decoder_only_note: str = ""

    # -------------------------------------------------------------- derived
    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.stages)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def has_kind(self, kind: str) -> bool:
        return any(l.kind == kind for s in self.stages for l in s.pattern)

    # ------------------------------------------------------------ counting
    def param_count(self) -> int:
        """Exact parameter count (embedding + backbone + heads)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n = v * d  # token embedding
        if not self.tie_embeddings:
            n += v * d
        n += d  # final norm
        for st in self.stages:
            for spec in st.pattern:
                n += st.repeats * self._layer_params(spec, d, hd)
        if self.encoder_layers:
            enc_spec = LayerSpec(kind="self_attn")
            n += self.encoder_layers * self._layer_params(enc_spec, d, hd)
            n += d  # encoder final norm
        if self.frontend_dim:
            n += self.frontend_dim * d  # projection of provided embeddings
        return n

    def _layer_params(self, spec: LayerSpec, d: int, hd: int) -> int:
        n = 0
        if spec.kind in ("self_attn", "cross_attn"):
            n += d * self.num_heads * hd            # q
            n += 2 * d * self.num_kv_heads * hd     # k, v
            n += self.num_heads * hd * d            # o
            n += d                                   # pre-norm
            if self.qk_norm:
                n += 2 * hd
            if spec.dec_cross:                       # extra cross block
                n += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                n += self.num_heads * hd * d + d
        elif spec.kind == "mamba":
            din, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            g = self.ssm_groups
            proj_in = d * (2 * din + 2 * g * ns + nh)
            n += proj_in + din * d                   # in/out proj
            n += (din + 2 * g * ns) * self.ssm_conv  # conv
            n += 2 * nh + din                        # A, dt bias, skip D
            n += d                                   # pre-norm
        # MLP (mamba layers in hybrid archs also carry an MLP when d_ff > 0)
        if spec.kind != "mamba" or self.d_ff > 0:
            if spec.moe:
                f = self.moe_d_ff or self.d_ff
                n += d * self.num_experts            # router
                n += self.num_experts * (3 * d * f)  # gate/up/down
            else:
                n += 3 * d * self.d_ff
            n += d                                   # pre-norm (mlp)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        f = self.moe_d_ff or self.d_ff
        per_layer_all = self.num_experts * 3 * d * f
        per_layer_active = self.experts_per_tok * 3 * d * f
        moe_layers = sum(
            st.repeats * sum(1 for l in st.pattern if l.moe) for st in self.stages
        )
        return self.param_count() - moe_layers * (per_layer_all - per_layer_active)


# ---------------------------------------------------------------------------
# input shape cells (assigned per architecture)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
