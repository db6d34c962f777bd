"""whisper-medium [audio] — encoder-decoder; conv frontend STUBBED.

24 encoder + 24 decoder layers, d_model=1024 16H (kv=16) d_ff=4096
vocab=51865 head_dim=64. input_specs provides precomputed frame embeddings
[B, 1500, 1024]; decoder layers are self-attn + cross-attn
[arXiv:2212.04356]. Native decoder context is 448 tokens — noted per cell in
EXPERIMENTS.md where the assigned shapes exceed it."""
from repro_torch.lm.config import LMConfig, LayerSpec, Stage
from repro_torch import configs as _c

CONFIG = LMConfig(
    name="whisper-medium",
    family="audio",
    stages=(Stage((LayerSpec(kind="self_attn", dec_cross=True),), 24),),
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=24,
    encoder_seq=1500,
    tie_embeddings=True,
    sub_quadratic=False,
    decoder_only_note="whisper decoder native max context = 448",
)


def reduced() -> LMConfig:
    return _c.shrink(CONFIG)
