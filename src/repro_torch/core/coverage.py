"""Local-memory kernel coverage (paper Table 2 / Table 6, §3.3, §5.1).

The paper's central co-design axis: a dot-product invocation is
*offloadable* iff its working set fits the local-memory budget; everything
else falls back to the host. Coverage(budget) = fraction of invocations
that fit.

Footprint model (the reference's; the paper does not fully specify its
accounting):

* An invocation is one ``ggml_mul_mat(src0=W[N,K], src1=X[M,K])`` call.
* **Optimized** (padding stripped, dense DMA packing, weights streamed in
  double-buffered bursts and never resident): the LMM set must hold the
  dense activation operand, ``M*K*2`` bytes (fp16), spread across the
  lane's active PE LMMs -> fits iff ``M*K*2 <= budget_kb * 1024 *
  AGG_UNITS``.
* **Baseline** (whisper.cpp layout with alignment padding, whole-operand
  DMA with scratch duplication): M and K round up to 32 elements and the
  staging buffer is duplicated: ``2 * pad32(M) * pad32(K) * 2`` bytes.

``AGG_UNITS = 46`` — the Q8_0 kernel's active PEs per lane (paper §3.2);
the FP16 kernel's 2-lane total (2x22=44) is treated identically, matching
the paper's identical FP16/Q8_0 optimized coverage columns.

The offload dispatcher keeps the same rule with ``agg_units=1``
(``core/plan.py``), so that the port's dispatch plans equal the
reference's entry for entry; on the H100 it decides the ledger's
offloaded/fallback split, not the routing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

from repro_torch.configs.base import ModelConfig

AGG_UNITS = 46            # active PE LMMs aggregated per offloaded invocation
FP16_BYTES = 2
PAD = 32                  # baseline alignment padding, elements

LMM_SIZES_KB = (8, 16, 32, 64, 128, 256)


@dataclass(frozen=True)
class MulMat:
    """One ggml_mul_mat invocation class: W[N,K] x X[M,K] -> [M,N]."""
    name: str
    m: int
    k: int
    n: int
    count: int = 1          # invocations of this class over the workload
    phase: str = "decode"   # encode | prefill | decode

    @property
    def flops(self) -> int:
        return 2 * self.m * self.k * self.n * self.count

    @property
    def dots(self) -> int:
        """Row dot-products (the paper counts 477k/645k/1.9M for t/b/s)."""
        return self.m * self.n * self.count

    def act_bytes_dense(self) -> int:
        return self.m * self.k * FP16_BYTES

    def act_bytes_padded(self) -> int:
        mp = -(-self.m // PAD) * PAD
        kp = -(-self.k // PAD) * PAD
        return 2 * mp * kp * FP16_BYTES   # x2: staging-scratch duplication


def enumerate_whisper(cfg: ModelConfig, n_frames: int = 1500,
                      n_tokens: int = 27) -> List[MulMat]:
    """All mul_mat invocations of one whisper.cpp inference (the paper's
    workload: jfk.wav ~10 s, padded to 30 s -> 1500 encoder frames, ~27
    decoded tokens)."""
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, hd = cfg.num_heads, cfg.head_dim
    el, dl = cfg.num_encoder_layers, cfg.num_layers
    F, T = n_frames, n_tokens
    ms: List[MulMat] = []
    a = ms.append
    # --- encoder (per layer) ---
    a(MulMat("enc.attn.qkv", F, d, 3 * d, el, "encode"))
    a(MulMat("enc.attn.out", F, d, d, el, "encode"))
    a(MulMat("enc.attn.scores", F, hd, F, el * h, "encode"))
    a(MulMat("enc.attn.av", F, F, hd, el * h, "encode"))
    a(MulMat("enc.ffn.up", F, d, dff, el, "encode"))
    a(MulMat("enc.ffn.down", F, dff, d, el, "encode"))
    # --- decoder cross K/V projection: once per utterance per layer ---
    a(MulMat("dec.cross.kv", F, d, 2 * d, dl, "encode"))
    # --- decoder (per token per layer); self-attn KV length grows ~T/2 avg ---
    t_avg = max(T // 2, 1)
    a(MulMat("dec.self.qkv", 1, d, 3 * d, dl * T, "decode"))
    a(MulMat("dec.self.out", 1, d, d, dl * T, "decode"))
    a(MulMat("dec.self.scores", 1, hd, t_avg, dl * T * h, "decode"))
    a(MulMat("dec.self.av", 1, t_avg, hd, dl * T * h, "decode"))
    a(MulMat("dec.cross.q", 1, d, d, dl * T, "decode"))
    a(MulMat("dec.cross.out", 1, d, d, dl * T, "decode"))
    a(MulMat("dec.cross.scores", 1, hd, F, dl * T * h, "decode"))
    a(MulMat("dec.cross.av", 1, F, hd, dl * T * h, "decode"))
    a(MulMat("dec.ffn.up", 1, d, dff, dl * T, "decode"))
    a(MulMat("dec.ffn.down", 1, dff, d, dl * T, "decode"))
    a(MulMat("dec.vocab", 1, d, v, T, "decode"))
    return ms


def enumerate_lm(cfg: ModelConfig, seq: int, new_tokens: int = 0,
                 batch: int = 1) -> List[MulMat]:
    """Decoder-only LM: prefill over ``seq`` + ``new_tokens`` decode steps
    (the reference's count, term for term, its MoE and SSM terms
    included: pure arithmetic over the config)."""
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ms: List[MulMat] = []
    a = ms.append
    n_attn = len(cfg.attention_layers)
    moe_layers = len(cfg.moe_layers)
    dense_layers = cfg.num_layers - moe_layers
    ffn_mult = 3 if cfg.act == "swiglu" else 2
    if seq and n_attn:
        a(MulMat("attn.qkv", seq * batch, d, (hq + 2 * hkv) * hd, n_attn,
                 "prefill"))
        a(MulMat("attn.out", seq * batch, hq * hd, d, n_attn, "prefill"))
        a(MulMat("attn.scores", seq, hd, seq, n_attn * hq * batch, "prefill"))
        a(MulMat("attn.av", seq, seq, hd, n_attn * hq * batch, "prefill"))
    if seq and dense_layers and dff:
        a(MulMat("ffn", seq * batch, d, ffn_mult * dff, dense_layers,
                 "prefill"))
    if seq and moe_layers and cfg.moe is not None:
        tok_per_e = max(1, seq * batch * cfg.moe.experts_per_token
                        // cfg.moe.num_experts)
        a(MulMat("moe.expert", tok_per_e, d, ffn_mult * cfg.moe.d_ff,
                 moe_layers * cfg.moe.num_experts, "prefill"))
    if cfg.ssm is not None and seq:
        ssm_layers = (cfg.num_layers - n_attn if cfg.family == "hybrid"
                      else cfg.num_layers)
        di = cfg.ssm.d_inner(d)
        a(MulMat("ssm.in_proj", seq * batch, d,
                 2 * di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
                 + cfg.ssm.n_heads(d), ssm_layers, "prefill"))
        a(MulMat("ssm.out_proj", seq * batch, di, d, ssm_layers, "prefill"))
    if seq:
        a(MulMat("vocab", seq * batch, d, v, 1, "prefill"))
    for t in range(new_tokens):
        kvlen = seq + t
        if n_attn:
            a(MulMat("dec.attn.qkv", batch, d, (hq + 2 * hkv) * hd, n_attn,
                     "decode"))
            a(MulMat("dec.attn.out", batch, hq * hd, d, n_attn, "decode"))
            a(MulMat("dec.attn.scores", 1, hd, kvlen, n_attn * hq * batch,
                     "decode"))
            a(MulMat("dec.attn.av", 1, kvlen, hd, n_attn * hq * batch,
                     "decode"))
        if dense_layers and dff:
            a(MulMat("dec.ffn", batch, d, ffn_mult * dff, dense_layers,
                     "decode"))
        a(MulMat("dec.vocab", batch, d, v, 1, "decode"))
    return ms


def fits(mm: MulMat, budget_kb: int, optimized: bool = True,
         agg_units: int = AGG_UNITS) -> bool:
    cap = budget_kb * 1024 * agg_units
    b = mm.act_bytes_dense() if optimized else mm.act_bytes_padded()
    return b <= cap


def coverage(mulmats: Sequence[MulMat], budget_kb: int, *,
             optimized: bool = True, weight: str = "dots",
             agg_units: int = AGG_UNITS) -> float:
    """Coverage in [0, 1], weighted by ``weight``: calls | dots | flops.
    'dots' (row dot-products) reproduces the paper's Table 2/6 columns to
    within ~2 points: its 'cumulative percentage' counts dot-product
    operations (§5.4)."""
    def w(mm: MulMat) -> float:
        if weight == "calls":
            return mm.count
        if weight == "dots":
            return mm.dots
        if weight == "flops":
            return mm.flops
        raise ValueError(weight)
    total = sum(w(m) for m in mulmats)
    if total == 0:
        return 0.0
    hit = sum(w(m) for m in mulmats
              if fits(m, budget_kb, optimized, agg_units))
    return hit / total


def coverage_cdf(mulmats: Sequence[MulMat], *,
                 sizes_kb: Iterable[int] = LMM_SIZES_KB,
                 weight: str = "dots") -> List[Tuple[int, float, float]]:
    """[(size_kb, baseline_cov, optimized_cov)] — the Table 2 structure."""
    return [(s,
             coverage(mulmats, s, optimized=False, weight=weight),
             coverage(mulmats, s, optimized=True, weight=weight))
            for s in sizes_kb]


def fallback_time_fraction(mulmats: Sequence[MulMat], budget_kb: int,
                           accel_speedup: float = 8.0) -> float:
    """Latency model of §5.1: covered kernels run ``accel_speedup`` x
    faster; uncovered kernels run at host speed. Returns
    T(budget)/T(host-only), FLOP-weighted — Fig 11's monotone
    latency-vs-LMM trend."""
    total = sum(m.flops for m in mulmats)
    if total == 0:
        return 1.0
    cov = sum(m.flops for m in mulmats if fits(m, budget_kb))
    return (total - cov) / total + (cov / total) / accel_speedup
