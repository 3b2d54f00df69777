"""Model configuration for the PyTorch port: the subset of the reference's
``ModelConfig`` that the Whisper (audio) ladder reads.

This is the port's own copy: the port imports nothing of the JAX package.
Field names, defaults and ``reduced`` follow the reference
(``repro/configs/base.py``) so that a config built here describes the same
model as its reference twin.
"""
from __future__ import annotations

from dataclasses import dataclass

AUDIO = "audio"   # encoder-decoder with stubbed conv frontend


@dataclass(frozen=True)
class ModelConfig:
    """One encoder-decoder audio architecture."""
    name: str
    family: str
    num_layers: int              # decoder layers
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # embedding pad: table/readout built at vocab_size + vocab_pad; pad
    # columns are masked out of the greedy argmax
    vocab_pad: int = 0

    norm: str = "layernorm"
    act: str = "gelu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    pos_embedding: str = "learned"

    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_ctx: int = 1500      # whisper n_audio_ctx (frames after conv stride 2)
    n_mels: int = 80

    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    quant: str = "none"          # none | q8_0  (weights for the serving path)
    burst: int = 256
    # encoder attention: "chunked" (q-chunked full-row softmax) | "flash"
    # (k-blocked online softmax on the flash_attention_fwd kernel)
    attn_impl: str = "chunked"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.attn_impl not in ("chunked", "flash"):
            raise ValueError(f"attn_impl {self.attn_impl!r}: 'chunked' or "
                             "'flash'")
        if self.family != AUDIO or not self.is_encoder_decoder:
            raise ValueError(f"{self.name}: the port serves the audio "
                             "encoder-decoder family only")

    @property
    def padded_vocab(self) -> int:
        return self.vocab_size + self.vocab_pad


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving reduction for smoke tests, the same cut as the
    reference's ``reduced``: tiny layers, width, vocab and frame count."""
    d_model = min(cfg.d_model, 64)
    num_heads = min(cfg.num_heads, 4)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    if cfg.num_kv_heads < cfg.num_heads:
        num_kv = max(1, num_heads // max(1, cfg.num_heads // cfg.num_kv_heads))
    base = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        num_layers=min(cfg.num_layers, 2),
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=d_model // num_heads,
        d_ff=min(cfg.d_ff, 128),
        vocab_size=min(cfg.vocab_size, 512),
        norm=cfg.norm, act=cfg.act, qkv_bias=cfg.qkv_bias,
        tie_embeddings=cfg.tie_embeddings,
        pos_embedding=cfg.pos_embedding,
        is_encoder_decoder=cfg.is_encoder_decoder,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_ctx=min(cfg.encoder_ctx, 32),
        n_mels=min(cfg.n_mels, 8),
        dtype="float32", param_dtype="float32",
        quant=cfg.quant, burst=128,
    )
    base.update(overrides)
    return ModelConfig(**base)
