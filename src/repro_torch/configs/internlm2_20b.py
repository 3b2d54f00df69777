"""internlm2-20b [arXiv:2403.17297; hf]

[dense] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544 — GQA.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=92_544,
    norm="rmsnorm",
    act="swiglu",
    quant="q8_0",
)

SMOKE = reduced(CONFIG)
