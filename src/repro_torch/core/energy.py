"""PDP/EDP energy model (paper Eq. 1-3, Table 3, Fig 7/9/10).

PDP = execution time x power; EDP = PDP x time. The paper's GPU platforms
use nominal TDP (its §4.1 method); IMAX powers come from its 28 nm
Synopsys DC synthesis. The constants below are the paper's own
measurements: they make its cross-platform tables (Fig 8/9), burst sweep
(Fig 10) and LMM power curve (Fig 7) reproducible as analytical
experiments.

The port's own card has no constant here. ``card_power_limit_w`` reads
the card's power limit from ``nvidia-smi`` (the paper's TDP method) and
raises when it cannot; a sampled draw is the caller's measurement.
``card_report`` turns either into an ``EnergyReport``.
"""
from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Dict

# ---------------------------------------------------------------------------
# Platform power constants (paper Table 3)
# ---------------------------------------------------------------------------
P_ARM_A72_W = 0.6485          # 2-core Cortex-A72 active
P_ARM_IDLE_W = 0.2487         # derived from §4.4 system powers (2xP_lane + idle)
P_JETSON_W = 15.0             # AGX Orin lowest-power mode (TDP)
P_RTX4090_W = 450.0           # nominal TDP
P_IMAX_FPGA_W = 180.0         # VPK180 board

# IMAX 28 nm per-lane synthesized power by kernel path (Fig 7 / §4.1, 32 KB LMM)
P_IMAX_LANE_FP16_W = 0.647
P_IMAX_LANE_Q8_W = 1.32

# Per-LMM-size per-lane FP16 power (Fig 7; 16->32 KB adds only 10 mW)
LMM_POWER_FP16_W: Dict[int, float] = {
    8: 0.630, 16: 0.637, 32: 0.647, 64: 0.699, 128: 0.803, 256: 1.011,
}
# Q8_0 path: same LMM scaling, offset by the wider integer datapath
_Q8_OFFSET = P_IMAX_LANE_Q8_W - P_IMAX_LANE_FP16_W
LMM_POWER_Q8_W: Dict[int, float] = {k: v + _Q8_OFFSET
                                    for k, v in LMM_POWER_FP16_W.items()}

# Burst-length dependent per-lane power (§4.4): 14/22/38 active PEs
BURST_POWER_LANE_W: Dict[int, float] = {8: 0.424, 16: 0.647, 32: 1.09}
BURST_ACTIVE_PES: Dict[int, int] = {8: 14, 16: 22, 32: 38}

# Paper-measured burst-sweep times for Whisper-tiny.en FP16, 32 KB LMM,
# 2 lanes + 2 host threads (§4.4: T_MAIN wall-clock; T_active derived
# from prompt_eval + token_gen lane timings).
BURST_T_MAIN_S: Dict[int, float] = {8: 48.3, 16: 35.8, 32: 34.7}

# Projected 28 nm E2E latencies (§5.6) and the paper's PDP results (Fig 9)
PAPER_LATENCY_28NM_S = {
    ("tiny", "fp16"): 15.39, ("tiny", "q8_0"): 10.71,
}
PAPER_PDP_J = {
    ("tiny", "fp16", "imax"): 12.65, ("tiny", "q8_0", "imax"): 11.58,
    ("tiny", "fp16", "jetson"): 22.59, ("tiny", "q8_0", "jetson"): 27.16,
    ("tiny", "q8_0", "rtx4090"): 121.38,
    ("base", "fp16", "imax"): 29.43, ("base", "q8_0", "imax"): 22.16,
    ("base", "fp16", "jetson"): 25.98, ("base", "q8_0", "jetson"): 26.09,
    ("small", "fp16", "imax"): 103.84, ("small", "q8_0", "imax"): 125.31,
    ("small", "fp16", "jetson"): 52.41, ("small", "q8_0", "jetson"): 51.57,
}


# ---------------------------------------------------------------------------
# Metrics (Eq. 1-3)
# ---------------------------------------------------------------------------
def pdp(time_s: float, power_w: float) -> float:
    """Eq. 1: PDP = execution time x power consumption [J]."""
    return time_s * power_w


def edp(time_s: float, power_w: float) -> float:
    """EDP = PDP x time [J*s]."""
    return pdp(time_s, power_w) * time_s


def pdp_mixed(t_active_s: float, t_main_s: float,
              p_accel_w: float, p_host_w: float = P_ARM_A72_W) -> float:
    """Eq. 2: accelerator-active phase at P_accel, remainder at P_host."""
    if t_active_s > t_main_s:
        raise ValueError("t_active exceeds t_main")
    return t_active_s * p_accel_w + (t_main_s - t_active_s) * p_host_w


def edp_mixed(t_active_s: float, t_main_s: float,
              p_accel_w: float, p_host_w: float = P_ARM_A72_W) -> float:
    """Eq. 3: EDP_burst = PDP_burst x T_MAIN."""
    return pdp_mixed(t_active_s, t_main_s, p_accel_w, p_host_w) * t_main_s


def system_power_burst(burst: int, lanes: int = 2) -> float:
    """§4.4 system power: lanes x P_lane(burst) + ARM idle."""
    return lanes * BURST_POWER_LANE_W[burst] + P_ARM_IDLE_W


def lmm_power(size_kb: int, path: str = "fp16", lanes: int = 1) -> float:
    """Fig 7: synthesized per-lane power as a function of LMM size."""
    table = LMM_POWER_FP16_W if path == "fp16" else LMM_POWER_Q8_W
    if size_kb not in table:
        raise KeyError(f"no synthesis point for {size_kb} KB")
    return lanes * table[size_kb]


# ---------------------------------------------------------------------------
# The card's energy: a measured time at a read or sampled power
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class EnergyReport:
    platform: str
    time_s: float
    power_w: float

    @property
    def pdp_j(self) -> float:
        return pdp(self.time_s, self.power_w)

    @property
    def edp_js(self) -> float:
        return edp(self.time_s, self.power_w)


def card_report(time_s: float, power_w: float, platform: str
                ) -> EnergyReport:
    """PDP/EDP of ``time_s`` on ``platform`` (the card's name) at
    ``power_w``: its power limit (the paper's TDP method) or a draw the
    caller sampled while the work ran."""
    if not power_w > 0:
        raise ValueError(f"power must be positive, got {power_w}")
    return EnergyReport(platform, time_s, power_w)


def card_power_limit_w(index: int = 0) -> float:
    """The power limit of card ``index`` in watts, as ``nvidia-smi``
    reports it. Raises RuntimeError when it cannot be read: there is no
    default."""
    cmd = ["nvidia-smi", "--query-gpu=power.limit",
           "--format=csv,noheader,nounits", "-i", str(index)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             check=True, timeout=30).stdout
        watts = float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError,
            IndexError) as e:
        raise RuntimeError(f"cannot read card {index}'s power limit with "
                           f"nvidia-smi: {e}") from e
    if not watts > 0:
        raise RuntimeError(f"nvidia-smi reported a power limit of {watts} W")
    return watts
