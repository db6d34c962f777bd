"""moonshot-v1-16b-a3b [moe] — kimi/moonlight-style fine-grained MoE.

48L d_model=2048 16H (kv=16, MHA) expert d_ff=1408 vocab=163840,
MoE 64 experts top-6 on every layer [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.lm.config import LMConfig, LayerSpec, Stage
from repro_torch import configs as _c

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    stages=(Stage((LayerSpec(kind="self_attn", moe=True),), 48),),
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,              # expert hidden dim (fine-grained experts)
    vocab_size=163840,
    head_dim=128,
    num_experts=64,
    experts_per_tok=6,
    tie_embeddings=False,
    sub_quadratic=False,
)


def reduced() -> LMConfig:
    return _c.shrink(CONFIG)
