"""Burst-length (execution-granularity) selection (paper §3.2, §4.4, Fig 10).

``paper_burst_sweep`` recomputes PDP/EDP for bursts {8, 16, 32} from the
paper's measured T_MAIN and synthesized powers via Eq. 2/3, confirming
burst 16 as PDP- and EDP-optimal (42.2 J / 1511 J*s); ``optimal_burst``
picks the best point by either metric.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.core import energy

PAPER_BURSTS = (8, 16, 32)


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
