"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=65536, ssm_state=128.
Period-8 block: attention at position 3 (1 attn : 7 mamba), MoE on every
other layer [arXiv:2403.19887].
"""
from repro_torch.lm.config import LMConfig, LayerSpec, Stage
from repro_torch import configs as _c

_PATTERN = tuple(
    LayerSpec(
        kind="self_attn" if i == 3 else "mamba",
        moe=(i % 2 == 1),
    )
    for i in range(8)
)

CONFIG = LMConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    stages=(Stage(_PATTERN, 4),),              # 4 x 8 = 32 layers
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    num_experts=16,
    experts_per_tok=2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=False,
    sub_quadratic=True,
)


def reduced() -> LMConfig:
    return _c.shrink(CONFIG)
