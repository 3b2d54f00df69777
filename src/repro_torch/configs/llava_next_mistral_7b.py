"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

[vlm] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 — anyres tiling.
Vision tower is a STUB: precomputed patch embeddings (anyres tiling fixed at
a 576-patch base grid + one 576-patch tile) go through a learned projector
inside the model and replace the first P token positions.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1_000_000.0,     # mistral-7b-v0.2 long-context base
    vision_patches=1152,        # 576 base + 576 anyres tile (stub)
    vision_embed_dim=1024,      # CLIP-L patch dim before projector
    quant="q8_0",
)

SMOKE = reduced(CONFIG)
