"""Model configuration for the PyTorch port: the subset of the reference's
``ModelConfig`` that the Whisper (audio) ladder and the dense,
mixture-of-experts, state-space (SSM) and hybrid decoder-only LM families
read, and the vision-language (VLM) family's: a dense backbone whose
first token positions take projected patch embeddings.

This is the port's own copy: the port imports nothing of the JAX package.
Field names, defaults, the derived quantities (``attention_layers``,
``moe_layers``, ``n_params``, ``n_active_params``) and ``reduced`` follow
the reference (``repro/configs/base.py``) so that a config built here
describes the same model as its reference twin. ``MoEConfig`` and
``SSMConfig`` configure ``models/moe.py``'s block and ``models/ssm.py``'s
mixer (``reduced`` and the parameter count read them too).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional, Tuple

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
AUDIO = "audio"   # encoder-decoder with stubbed conv frontend
VLM = "vlm"       # decoder-only LM backbone with stubbed vision frontend

#: the reference's families, every one of which the port serves
FAMILIES = (DENSE, MOE, SSM, HYBRID, AUDIO, VLM)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block parameters."""
    num_experts: int
    experts_per_token: int
    d_ff: int                    # per-expert hidden dim
    dense_residual_d_ff: int = 0 # arctic: dense MLP running in parallel
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    capacity_factor: float = 1.25
    dispatch_group: int = 512


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD mixer parameters."""
    d_state: int
    d_conv: int = 4
    expand: int = 2              # d_inner = expand * d_model
    head_dim: int = 64           # P; n_heads = d_inner // head_dim
    n_groups: int = 1
    chunk: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """One architecture: an audio encoder-decoder, or a dense, MoE, SSM,
    hybrid or vision-language LM."""
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

    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    pos_embedding: str = "rope"  # rope | learned

    moe: Optional[MoEConfig] = None
    moe_every: int = 1
    moe_offset: int = 0

    ssm: Optional[SSMConfig] = None
    attn_every: int = 1
    attn_offset: int = 0

    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_ctx: int = 1500      # whisper n_audio_ctx (frames after conv stride 2)
    n_mels: int = 80

    vision_patches: int = 0
    vision_embed_dim: int = 0

    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    quant: str = "none"          # none | q8_0  (weights for the serving path)
    burst: int = 256

    # training: the activation checkpoint policy of each layer-pattern
    # repeat (none | full | dots)
    remat: str = "full"
    # encoder attention: "chunked" (q-chunked full-row softmax) | "flash"
    # (k-blocked online softmax on the flash_attention_fwd kernel)
    attn_impl: str = "chunked"
    # decode KV-cache storage: "none" (model dtype) | "q8" (int8 + one f32
    # scale a position and head)
    kv_quant: str = "none"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
        if self.attn_impl not in ("chunked", "flash"):
            raise ValueError(f"attn_impl {self.attn_impl!r}: 'chunked' or "
                             "'flash'")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat {self.remat!r}: 'none', 'full' or "
                             "'dots'")
        if self.kv_quant not in ("none", "q8"):
            raise ValueError(f"kv_quant {self.kv_quant!r}: 'none' or 'q8'")
        if self.family == MOE and self.moe is None:
            raise ValueError(f"{self.name}: the moe family needs a MoEConfig")
        if self.family in (SSM, HYBRID) and self.ssm is None:
            raise ValueError(f"{self.name}: the {self.family} family needs "
                             "an SSMConfig")
        if (self.family == AUDIO) != self.is_encoder_decoder:
            # the port's models dispatch on the family: only the audio
            # family is an encoder-decoder, and it always is
            raise ValueError(f"{self.name}: the encoder-decoder models are "
                             "the audio family's, and only theirs")

    @property
    def padded_vocab(self) -> int:
        return self.vocab_size + self.vocab_pad

    @property
    def uses_full_attention(self) -> bool:
        """True when every token attends over the whole sequence in all
        mixer layers: the long_500k cell is then inapplicable."""
        return self.family not in (SSM, HYBRID)

    # ----- derived quantities used by coverage and the parameter count -----
    @property
    def attention_layers(self) -> Tuple[int, ...]:
        if self.family == SSM:
            return ()
        if self.family == HYBRID:
            return tuple(i for i in range(self.num_layers)
                         if i % self.attn_every == self.attn_offset)
        return tuple(range(self.num_layers))

    @property
    def moe_layers(self) -> Tuple[int, ...]:
        if self.moe is None:
            return ()
        return tuple(i for i in range(self.num_layers)
                     if i % self.moe_every == self.moe_offset)

    def n_params(self) -> int:
        """Total parameter count (embedding included once)."""
        return sum(int(p) for p in self._param_terms().values())

    def n_active_params(self) -> int:
        """Active-per-token parameters (MoE: top-k experts only)."""
        terms = self._param_terms()
        total = sum(int(v) for v in terms.values())
        if self.moe is not None:
            total -= int(terms["moe_experts"])
            frac = self.moe.experts_per_token / self.moe.num_experts
            total += int(terms["moe_experts"] * frac)
        return int(total)

    def _param_terms(self) -> dict:
        d, dff, V = self.d_model, self.d_ff, self.vocab_size
        hq, hkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * (hq * hd) + 2 * d * (hkv * hd) + (hq * hd) * d
        ffn_mults = 3 if self.act == "swiglu" else 2
        dense_ffn = ffn_mults * d * dff
        terms = {"embed": V * d, "head": 0 if self.tie_embeddings else V * d}
        n_attn = len(self.attention_layers)
        n_layers = self.num_layers + (self.num_encoder_layers
                                      if self.is_encoder_decoder else 0)
        if self.is_encoder_decoder:
            # decoder cross-attention adds another attn block per decoder layer
            terms["attn"] = attn * (self.num_encoder_layers
                                    + 2 * self.num_layers)
            terms["ffn"] = dense_ffn * n_layers
        else:
            terms["attn"] = attn * n_attn
            moe_l = set(self.moe_layers)
            dense_l = [i for i in range(self.num_layers) if i not in moe_l]
            terms["ffn"] = dense_ffn * len(dense_l)
            if self.moe is not None:
                e_ffn = ffn_mults * d * self.moe.d_ff
                terms["moe_experts"] = e_ffn * self.moe.num_experts * len(moe_l)
                terms["router"] = d * self.moe.num_experts * len(moe_l)
                if self.moe.dense_residual_d_ff:
                    terms["ffn"] += (ffn_mults * d * self.moe.dense_residual_d_ff
                                     * len(moe_l))
            if self.ssm is not None:
                di = self.ssm.d_inner(d)
                nh = self.ssm.n_heads(d)
                ssm_l = (self.num_layers - n_attn if self.family == HYBRID
                         else self.num_layers)
                per = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state
                           + nh) \
                    + di * d + self.ssm.d_conv * (
                        di + 2 * self.ssm.n_groups * self.ssm.d_state) \
                    + 2 * nh
                terms["ssm"] = per * ssm_l
        terms["norms"] = 2 * d * n_layers + d
        return terms


# ---------------------------------------------------------------------------
# Input shapes: the reference's four named cells of every arch (the
# dry-run's matrix), and the training run's own shape
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig
                     ) -> Tuple[bool, str]:
    """(applicable, the reason if not): long_500k needs sub-quadratic
    attention, so a pure full-attention arch skips it."""
    if shape.name == "long_500k" and model.uses_full_attention:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{model.name} is pure full-attention (skip per brief)")
    return True, ""


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    grad_compress: str = "none"  # none | int8_ef
    # moment storage: float32 | bfloat16 | q8_0 (blocks of 32 int8 values
    # with an fp16-valued scale, ``core.qformats``)
    state_dtype: str = "float32"


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    steps: int = 100
    checkpoint_every: int = 50
    # the reference's /tmp/repro_ckpt, under the process's temp directory
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    max_restarts: int = 3


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving reduction for smoke tests, the same cut as the
    reference's ``reduced``: tiny layers, width, heads (the GQA ratio
    kept where it can be), vocabulary, experts and frame count."""
    d_model = min(cfg.d_model, 64)
    if cfg.num_heads == 0:       # attention-free (SSM)
        num_heads = num_kv = 0
    else:
        num_heads = min(cfg.num_heads, 4)
        num_kv = max(1, min(cfg.num_kv_heads, num_heads))
        # keep the GQA-vs-MHA character: preserve ratio when possible
        if cfg.num_kv_heads < cfg.num_heads:
            num_kv = max(1, num_heads // max(1, cfg.num_heads
                                             // cfg.num_kv_heads))
    base = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        num_layers=min(cfg.num_layers, 2),
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=d_model // num_heads if num_heads else 16,
        d_ff=min(cfg.d_ff, 128) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        norm=cfg.norm, act=cfg.act, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta, tie_embeddings=cfg.tie_embeddings,
        pos_embedding=cfg.pos_embedding,
        moe_every=cfg.moe_every, moe_offset=cfg.moe_offset,
        attn_every=min(cfg.attn_every, 2), attn_offset=min(cfg.attn_offset, 1),
        is_encoder_decoder=cfg.is_encoder_decoder,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_ctx=min(cfg.encoder_ctx, 32),
        n_mels=min(cfg.n_mels, 8),
        vision_patches=min(cfg.vision_patches, 8),
        vision_embed_dim=min(cfg.vision_embed_dim, 32),
        dtype="float32", param_dtype="float32",
        quant=cfg.quant, burst=128,
        remat="none",
    )
    if cfg.moe is not None:
        base["moe"] = MoEConfig(
            num_experts=min(cfg.moe.num_experts, 4),
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            d_ff=min(cfg.moe.d_ff, 64),
            dense_residual_d_ff=min(cfg.moe.dense_residual_d_ff, 64)
            if cfg.moe.dense_residual_d_ff else 0,
        )
    if cfg.ssm is not None:
        base["ssm"] = SSMConfig(
            d_state=min(cfg.ssm.d_state, 16), d_conv=cfg.ssm.d_conv,
            expand=2, head_dim=16, n_groups=1, chunk=8,
        )
    base.update(overrides)
    return ModelConfig(**base)
