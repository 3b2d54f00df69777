"""olmoe-1b-7b [arXiv:2409.02060; hf]

[moe] 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64e top-8 — 64 experts top-8, no shared expert.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,                   # per-expert width (no dense branch)
    vocab_size=50_304,
    norm="rmsnorm",
    act="swiglu",
    moe=MoEConfig(
        num_experts=64,
        experts_per_token=8,
        d_ff=1024,
    ),
    moe_every=1,
    quant="q8_0",
)

SMOKE = reduced(CONFIG)
