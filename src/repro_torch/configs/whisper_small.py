"""whisper-small — the paper's scaling study. [arXiv:2212.04356]

Encoder-decoder with a conv frontend stub: precomputed 80-mel frames go
through one linear projection in place of the two stride-2 convolutions.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,               # decoder layers
    num_encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    vocab_pad=7,                 # -> 51,872 rows, a multiple of 16
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    pos_embedding="learned",
    tie_embeddings=True,
    is_encoder_decoder=True,
    encoder_ctx=1500,
    n_mels=80,
    quant="q8_0",                # the paper's Q8_0 serving path
)

SMOKE = reduced(CONFIG)
