"""Architecture registry: the 10 assigned LM configs, with ``reduced()``
smoke-test variants (the port's copy of ``repro.configs``); the paper's
RGNN configs are in ``repro_torch.configs.rgnn``.

``get_config(arch_id)`` returns the exact published full config;
``get_reduced(arch_id)`` returns a structurally identical small config
(same stage patterns, tiny dims) for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.lm.config import LMConfig, LayerSpec, Stage, SHAPES, ShapeCell

from repro_torch.configs import (  # noqa: E402
    jamba_v0_1_52b,
    qwen3_4b,
    gemma2_2b,
    qwen3_14b,
    gemma3_4b,
    mamba2_780m,
    grok_1_314b,
    moonshot_v1_16b_a3b,
    llama_3_2_vision_11b,
    whisper_medium,
)

_MODULES = {
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "qwen3-4b": qwen3_4b,
    "gemma2-2b": gemma2_2b,
    "qwen3-14b": qwen3_14b,
    "gemma3-4b": gemma3_4b,
    "mamba2-780m": mamba2_780m,
    "grok-1-314b": grok_1_314b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "whisper-medium": whisper_medium,
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> LMConfig:
    return _MODULES[arch].CONFIG


def get_reduced(arch: str) -> LMConfig:
    return _MODULES[arch].reduced()


def _shrink_stage(st: Stage, repeats: int = 1) -> Stage:
    return Stage(st.pattern, min(st.repeats, repeats))


def shrink(cfg: LMConfig, **overrides) -> LMConfig:
    """Generic reduced config: same family/pattern, tiny dims."""
    kv = min(cfg.num_kv_heads, 2)
    small = dict(
        stages=tuple(_shrink_stage(s) for s in cfg.stages),
        d_model=64,
        num_heads=4,
        num_kv_heads=kv if 4 % kv == 0 else 2,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        head_dim=16,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_tok=min(cfg.experts_per_tok, 2) if cfg.num_experts else 0,
        moe_d_ff=64 if cfg.moe_d_ff else None,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=8,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=16 if cfg.encoder_seq else 0,
        frontend_tokens=8 if cfg.frontend_tokens else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        dtype="float32",
    )
    small.update(overrides)
    # shrink windows inside patterns
    new_stages = []
    for st in small["stages"]:
        pat = tuple(
            dataclasses.replace(l, window=None if l.window is None else 8)
            for l in st.pattern
        )
        new_stages.append(Stage(pat, st.repeats))
    small["stages"] = tuple(new_stages)
    return dataclasses.replace(cfg, **small)


# arch -> shape-cell applicability (DESIGN.md §6)
def applicable_shapes(arch: str) -> List[str]:
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells
