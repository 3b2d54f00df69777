"""mamba2-780m [arXiv:2405.21060; unverified]

[ssm] 48L d_model=1536 (attn-free) d_ff=0 vocab=50280, ssm_state=128 —
SSD (state-space duality) recurrence. d_inner = 2*1536 = 3072,
head_dim=64 -> 48 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduced

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,                      # no FFN; the mixer is the block
    vocab_size=50_280,
    vocab_pad=8,                 # -> 50,288, a multiple of 16
    norm="rmsnorm",
    act="swiglu",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    quant="q8_0",
)

SMOKE = reduced(CONFIG)
