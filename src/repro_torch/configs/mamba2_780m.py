"""mamba2-780m [ssm] — attention-free SSD (state-space duality).

48L d_model=1536, ssm_state=128, expand=2 (d_inner=3072, 48 heads x 64),
vocab=50280 (padded 50304), no MLP (d_ff=0) [arXiv:2405.21060]."""
from repro_torch.lm.config import LMConfig, LayerSpec, Stage
from repro_torch import configs as _c

CONFIG = LMConfig(
    name="mamba2-780m",
    family="ssm",
    stages=(Stage((LayerSpec(kind="mamba"),), 48),),
    d_model=1536,
    num_heads=1,            # no attention layers
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
    sub_quadratic=True,
)


def reduced() -> LMConfig:
    return _c.shrink(CONFIG)
