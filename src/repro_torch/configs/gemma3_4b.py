"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144 head_dim=256,
window=1024 on local layers, qk-norm (Gemma3 replaced softcap with qk-norm)
[hf:google/gemma-3 family]. 34 = 5x(5 local + 1 global) + 4 local.
"""
from repro_torch.lm.config import LMConfig, LayerSpec, Stage
from repro_torch import configs as _c

_LOCAL = LayerSpec(kind="self_attn", window=1024)
_GLOBAL = LayerSpec(kind="self_attn", window=None)

CONFIG = LMConfig(
    name="gemma3-4b",
    family="dense",
    stages=(
        Stage((_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL), 5),
        Stage((_LOCAL,), 4),
    ),
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262_144,
    head_dim=256,
    qk_norm=True,
    rope_theta=1_000_000.0,
    scale_embed=True,
    tie_embeddings=True,
    sub_quadratic=True,     # 5:1 local:global
)


def reduced() -> LMConfig:
    return _c.shrink(CONFIG)
