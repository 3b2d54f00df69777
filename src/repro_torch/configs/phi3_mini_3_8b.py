"""phi3-mini-3.8b [arXiv:2404.14219; unverified]

[dense] 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064 — RoPE SwiGLU.
kv=32 == heads -> effectively MHA.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    norm="rmsnorm",
    act="swiglu",
    quant="q8_0",
)

SMOKE = reduced(CONFIG)
