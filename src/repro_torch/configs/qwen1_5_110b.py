"""qwen1.5-110b [hf:Qwen/Qwen1.5-0.5B; hf]

[dense] 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064 — QKV bias.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49_152,
    vocab_size=152_064,
    norm="rmsnorm",
    act="swiglu",
    qkv_bias=True,
    quant="q8_0",
)

SMOKE = reduced(CONFIG)
