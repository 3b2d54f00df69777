"""Burst-length (execution-granularity) selection (paper §3.2, §4.4, Fig 10).

Two layers:

1. **Paper reproduction** — ``paper_burst_sweep`` recomputes PDP/EDP for
   bursts {8, 16, 32} from the paper's measured T_MAIN and synthesized
   powers via Eq. 2/3, confirming burst 16 as PDP- and EDP-optimal (42.2 J
   / 1511 J*s); ``optimal_burst`` picks the best point by either metric.

2. **Hopper analog** — ``tile_sweep_report`` scores candidate bursts
   {64, 128, 256, 512} on a workload's vector-length distribution: the
   residual fraction (the alignment term), the shared memory a block would
   claim to stage one burst of each operand (the LMM term, refused above
   the most one block may claim on the H100), and a per-burst overhead
   term. ``select_tile_burst`` picks the best. The autotuner
   (``tuning/``) measures what this scores.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.core import energy
from repro_torch.core.coverage import MulMat
from repro_torch.core.mixed_exec import residual_fraction
from repro_torch.kernels import tiles

PAPER_BURSTS = (8, 16, 32)
# multiples of the Hopper kernels' 64-wide K step: the analog of 8/16/32
HOPPER_TILE_BURSTS = (64, 128, 256, 512)
# host-arm work costs about this many times the accelerator's: the paper's
# Amdahl kernel speedup (7.75x on whisper-tiny Q8_0)
HOST_COST = 8.0


@dataclass(frozen=True)
class BurstPoint:
    burst: int
    t_main_s: float
    t_active_s: float
    power_w: float
    pdp_j: float
    edp_js: float


def _t_active(burst: int, t_main: float) -> float:
    """The accelerator-active time, from the calibration in §4.4: the
    measured burst-16 point gives T_active = 21.2 s of 35.8 s, and the
    active time scales with the per-burst overhead, ~ (1 + c/burst)."""
    t16_active = 21.2
    c = 8.0  # overhead constant fit to the 8->16 latency drop
    rel = (1.0 + c / burst) / (1.0 + c / 16.0)
    return min(t16_active * rel, t_main)


def paper_burst_sweep(lanes: int = 2) -> List[BurstPoint]:
    """Fig 10 from the paper's measured times and powers."""
    out = []
    for b in PAPER_BURSTS:
        tm = energy.BURST_T_MAIN_S[b]
        ta = _t_active(b, tm)
        p_sys = energy.system_power_burst(b, lanes)
        out.append(BurstPoint(
            burst=b, t_main_s=tm, t_active_s=ta, power_w=p_sys,
            pdp_j=energy.pdp_mixed(ta, tm, p_sys),
            edp_js=energy.edp_mixed(ta, tm, p_sys),
        ))
    return out


def optimal_burst(points: Sequence[BurstPoint],
                  metric: str = "pdp") -> BurstPoint:
    key = (lambda p: p.pdp_j) if metric == "pdp" else (lambda p: p.edp_js)
    return min(points, key=key)


@dataclass(frozen=True)
class TilePoint:
    burst: int                 # the split granularity (block_k)
    residual_flop_frac: float  # work left to the host arm
    smem_claim_bytes: int      # a block staging one burst of x, W, scales
    grid_overhead: float       # relative per-burst overhead ~ 1 + c/b
    score: float               # lower is better (PDP proxy)


def tile_sweep_report(mulmats: Sequence[MulMat], block_m: int = 64,
                      block_n: int = 32,
                      bursts: Sequence[int] = HOPPER_TILE_BURSTS,
                      dtype_bytes: int = 1) -> List[TilePoint]:
    """Score each burst on the workload's vector lengths, the paper's
    three-way trade-off: a longer burst amortizes its overhead but strands
    more residual work and claims more shared memory. ``dtype_bytes=1``
    for the Q8_0 weight path; the default block is ``q8_matmul``'s
    untuned 64 x 32 tile."""
    total_flops = sum(m.flops for m in mulmats) or 1
    out = []
    for b in bursts:
        resid = sum(m.flops * residual_fraction(m.k, b)
                    for m in mulmats) / total_flops
        # shared memory to stage one burst: bf16 x tile, weight tile, and
        # the weight's f32 scales; accumulators live in registers
        smem = (block_m * b * 2 + block_n * b * dtype_bytes
                + block_n * (b // 32) * 4)
        over = 1.0 + tiles.K_STEP / b
        accel = (1.0 - resid) * over
        host = resid * HOST_COST
        penalty = 1e6 if smem > tiles.SMEM_OPTIN_BYTES else 0.0
        out.append(TilePoint(b, resid, smem, over, accel + host + penalty))
    return out


def select_tile_burst(mulmats: Sequence[MulMat], **kw) -> int:
    return min(tile_sweep_report(mulmats, **kw), key=lambda p: p.score).burst
