"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 head_dim=256,
window=4096 on local layers, attn softcap 50, final logit softcap 30
[arXiv:2408.00118]."""
from repro_torch.lm.config import LMConfig, LayerSpec, Stage
from repro_torch import configs as _c

_LOCAL = LayerSpec(kind="self_attn", window=4096)
_GLOBAL = LayerSpec(kind="self_attn", window=None)

CONFIG = LMConfig(
    name="gemma2-2b",
    family="dense",
    stages=(Stage((_LOCAL, _GLOBAL), 13),),    # 26 layers
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=256,
    attn_softcap=50.0,
    logit_softcap=30.0,
    scale_embed=True,
    tie_embeddings=True,
    # local:global 1:1 — half the layers are sliding-window; global layers
    # are decode-linear with data-sharded KV, so the 500k cell runs.
    sub_quadratic=True,
)


def reduced() -> LMConfig:
    return _c.shrink(CONFIG)
