"""grok-1-314b [moe] — 8 experts top-2.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072 head_dim=128,
MoE on every layer [hf:xai-org/grok-1]."""
from repro_torch.lm.config import LMConfig, LayerSpec, Stage
from repro_torch import configs as _c

CONFIG = LMConfig(
    name="grok-1-314b",
    family="moe",
    stages=(Stage((LayerSpec(kind="self_attn", moe=True),), 64),),
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    num_experts=8,
    experts_per_tok=2,
    attn_softcap=30.0,      # grok caps attention logits
    tie_embeddings=False,
    sub_quadratic=False,
)


def reduced() -> LMConfig:
    return _c.shrink(CONFIG)
