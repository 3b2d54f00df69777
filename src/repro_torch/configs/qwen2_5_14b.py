"""qwen2.5-14b [hf:Qwen/Qwen2.5-0.5B; hf]

[dense] 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 — GQA, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13_824,
    vocab_size=152_064,
    norm="rmsnorm",
    act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    quant="q8_0",
)

SMOKE = reduced(CONFIG)
