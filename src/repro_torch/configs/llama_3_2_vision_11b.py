"""llama-3.2-vision-11b [vlm] — cross-attention image layers.

40L (32 self + 8 cross inserted every 5th) d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256 head_dim=128. Vision frontend is a STUB: input_specs
provides precomputed patch embeddings [B, 1600, 1280] projected to d_model
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.lm.config import LMConfig, LayerSpec, Stage
from repro_torch import configs as _c

_SELF = LayerSpec(kind="self_attn")
_CROSS = LayerSpec(kind="cross_attn")

CONFIG = LMConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    stages=(Stage((_SELF, _SELF, _SELF, _SELF, _CROSS), 8),),   # 40 layers
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    frontend_tokens=1600,
    frontend_dim=1280,
    tie_embeddings=False,
    sub_quadratic=False,
)


def reduced() -> LMConfig:
    return _c.shrink(CONFIG)
