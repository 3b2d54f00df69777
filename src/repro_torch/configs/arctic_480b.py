"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf]

[moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 — 128 experts top-2 PLUS a dense residual MLP in parallel
(dense-MoE hybrid: every layer has dense d_ff=4864 residual + routed experts).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                    # dense residual branch width
    vocab_size=32_000,
    norm="rmsnorm",
    act="swiglu",
    moe=MoEConfig(
        num_experts=128,
        experts_per_token=2,
        d_ff=4864,
        dense_residual_d_ff=4864,  # arctic's dense-residual design
    ),
    moe_every=1,                   # MoE in every layer
    quant="q8_0",
)

SMOKE = reduced(CONFIG)
