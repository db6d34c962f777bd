"""qwen3-4b [dense] — qk_norm, GQA. 36L d_model=2560 32H (kv=8) d_ff=9728
vocab=151936 head_dim=128 [hf:Qwen/Qwen3-8B family]."""
from repro_torch.lm.config import LMConfig, LayerSpec, Stage
from repro_torch import configs as _c

CONFIG = LMConfig(
    name="qwen3-4b",
    family="dense",
    stages=(Stage((LayerSpec(kind="self_attn"),), 36),),
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sub_quadratic=False,
)


def reduced() -> LMConfig:
    return _c.shrink(CONFIG)
