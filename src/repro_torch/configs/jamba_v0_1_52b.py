"""jamba-v0.1-52b [arXiv:2403.19887; hf]

[hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16e top-2 — Mamba+attention 1:7 interleave (1 attention layer per 8,
at offset 4 within each block of 8), MoE every other layer (offset 1).
The SSM mixer is the SSD (Mamba-2) recurrence with jamba's d_state=16.
The port serves it in bf16 only (``serve/engine.py::check_servable``);
its 32 layers are about 104 GB of bf16, so a card holds a cut of it
(``dataclasses.replace(CONFIG, num_layers=8)``: one pattern repeat, 26.5
GB).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, reduced

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    norm="rmsnorm",
    act="swiglu",
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff=14_336),
    moe_every=2,
    moe_offset=1,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    attn_every=8,
    attn_offset=4,               # attention at layer 4 of each 8-block
    quant="q8_0",
)

SMOKE = reduced(CONFIG)
