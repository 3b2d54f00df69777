"""Cost models of a candidate: an analytic roofline (deterministic, runs
anywhere), the same accounting priced with constants fitted on the card
(calibrated), and the kernel timed on the card (measured).

The analytic model restates the paper's PDP argument in roofline terms
for a launch of a Hopper kernel on (M, N, K):

  compute_s = 2*M*N*K / peak FLOP/s for the operands' type
  memory_s  = device-memory bytes / 3.35 TB/s, where the tile sets the
              re-reading: a tensor-core launch reads the x panel once per
              column tile (N / block_n) and the weight panel once per
              64-row tile (M / 64); an M <= 16 launch streams each once;
  launch_s  = steps x STEP_S, ``steps`` being 1 for the launch plus its
              sequential steps: the waves of blocks the SMs take in turn
              (blocks resident on an SM bounded by shared memory and
              threads) times the K steps one block (or one lane) walks.

cost_s = max(compute_s, memory_s) + launch_s. PDP multiplies by the card's
power limit (``core/energy.py``) or an explicit power (paper Eq. 1).

Calibrated costs reuse ``analytic_features`` with per-backend effective
constants fitted from replays on the card (``tuning/calibrate.py``);
``preferred_cost`` is the seam the tuner ranks through: calibrated when
coefficients for the backend are active, analytic otherwise. Measured
costs time a CUDA graph of the kernel's launches with CUDA events
(``replay.timed``); they exist only on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core import energy
from repro_torch.core.qformats import QBLOCK
from repro_torch.kernels import tiles
from repro_torch.roofline.analysis import H100, HW  # noqa: F401 (re-export)
from repro_torch.tuning.calibrate import (
    BackendCoefficients, CalibratedCoefficients)
from repro_torch.tuning.space import TileCandidate, row_launch

#: the backend the Hopper kernels run on (backends/hopper.py)
BACKEND = "hopper"

# One sequential step of a launch: a guess of one device-memory round trip
# (about a microsecond), the analog of the reference's per-grid-step
# overhead. ``calibrate.fit`` replaces it with the card's own figure.
STEP_S = 1e-6
MAX_BLOCKS_PER_SM = 32                     # an SM's resident blocks
MAX_THREADS_PER_SM = 2048
TC_THREADS = 128                           # a tensor-core block: a warpgroup


@dataclass(frozen=True)
class CostReport:
    cand: TileCandidate
    compute_s: float
    memory_s: float
    launch_s: float
    cost_s: float
    source: str                   # analytic | calibrated | measured

    def pdp_j(self, power_w: Optional[float] = None) -> float:
        """PDP at ``power_w`` watts; None reads card 0's power limit."""
        return energy.pdp(self.cost_s, _power(power_w))

    def edp_js(self, power_w: Optional[float] = None) -> float:
        return energy.edp(self.cost_s, _power(power_w))


def _power(power_w: Optional[float]) -> float:
    return energy.card_power_limit_w() if power_w is None else power_w


def _weight_bytes_per_elem(kernel: str) -> float:
    # Q8_0: 1 int8 byte + a 4-byte f32 scale per 32 values
    return 1.0 + 4.0 / QBLOCK if kernel.startswith("q8") else 2.0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def analytic_features(cand: TileCandidate, m: int, n: int, k: int, *,
                      x_bytes: int = 2) -> Tuple[float, float, float]:
    """The analytic accounting of one candidate: ``(flops, bytes, steps)``
    (module docstring). The calibrated model fits its constants against
    exactly these features."""
    flops = 2.0 * m * n * k
    w_bpe = _weight_bytes_per_elem(cand.kernel)
    rl = row_launch(cand.kernel, m)
    if rl is not None:
        _, warps, split = cand.launch
        bytes_hbm = m * k * x_bytes + n * k * w_bpe + m * n * 4
        blocks = _ceil(n, rl.rows_per_block(cand.launch))
        resident = min(MAX_THREADS_PER_SM // (32 * warps), MAX_BLOCKS_PER_SM)
        depth = _ceil(rl.chunks(k), split * rl.lanes)
    else:
        col_tiles, row_tiles = _ceil(n, cand.block_n), _ceil(m, cand.block_m)
        bytes_hbm = (col_tiles * m * k * x_bytes + row_tiles * n * k * w_bpe
                     + m * n * 4)
        blocks = col_tiles * row_tiles
        resident = max(1, min(tiles.SMEM_PER_SM_BYTES
                              // (cand.claim_bytes + 1024),
                              MAX_THREADS_PER_SM // TC_THREADS))
        depth = _ceil(k, tiles.K_STEP)
    steps = 1 + _ceil(blocks, tiles.SMS * resident) * depth
    return flops, float(bytes_hbm), float(steps)


def analytic_cost(cand: TileCandidate, m: int, n: int, k: int, *,
                  hw: HW = H100, x_bytes: int = 2) -> CostReport:
    """Deterministic roofline cost of running (M, N, K) with this launch."""
    flops, bytes_hbm, steps = analytic_features(cand, m, n, k,
                                                x_bytes=x_bytes)
    compute_s = flops / hw.peak_flops(cand.kernel)
    memory_s = bytes_hbm / hw.hbm_bw
    launch_s = steps * STEP_S
    return CostReport(cand, compute_s, memory_s, launch_s,
                      max(compute_s, memory_s) + launch_s, "analytic")


def calibrated_cost(cand: TileCandidate, m: int, n: int, k: int, *,
                    coeffs: BackendCoefficients,
                    x_bytes: int = 2) -> CostReport:
    """The analytic accounting priced with replay-fitted effective
    constants (additive form, ``tuning/calibrate.py``)."""
    flops, bytes_hbm, steps = analytic_features(cand, m, n, k,
                                                x_bytes=x_bytes)
    compute_s, memory_s, launch_s = coeffs.predict_parts(
        flops, bytes_hbm, steps)
    return CostReport(cand, compute_s, memory_s, launch_s,
                      compute_s + memory_s + launch_s, "calibrated")


# -- active calibration (process-wide, opt-in) ------------------------------
_ACTIVE_CALIBRATION: Optional[CalibratedCoefficients] = None


def set_calibration(cal: Optional[CalibratedCoefficients]
                    ) -> Optional[CalibratedCoefficients]:
    """Install (or clear, with None) the process-wide calibration that
    ``preferred_cost`` consults. Returns the previous one."""
    global _ACTIVE_CALIBRATION
    prev, _ACTIVE_CALIBRATION = _ACTIVE_CALIBRATION, cal
    return prev


def get_calibration() -> Optional[CalibratedCoefficients]:
    return _ACTIVE_CALIBRATION


def activate_calibration_file(path: str) -> Optional[CalibratedCoefficients]:
    """Load a coefficients file and install it process-wide. A missing or
    corrupt file warns and leaves the current calibration as it was."""
    cal = CalibratedCoefficients.load_or_none(path)
    if cal is not None:
        set_calibration(cal)
    return cal


def preferred_cost(cand: TileCandidate, m: int, n: int, k: int, *,
                   backend: Optional[str] = BACKEND,
                   calibration: Optional[CalibratedCoefficients] = None,
                   hw: HW = H100, x_bytes: int = 2) -> CostReport:
    """The ranking seam: the calibrated cost when coefficients for
    ``backend`` exist (the ``calibration`` argument first, else the active
    calibration; None means the calibration's default backend), the
    analytic roofline otherwise."""
    cal = calibration if calibration is not None else _ACTIVE_CALIBRATION
    coeffs = cal.for_backend(backend) if cal is not None else None
    if coeffs is not None:
        return calibrated_cost(cand, m, n, k, coeffs=coeffs,
                               x_bytes=x_bytes)
    return analytic_cost(cand, m, n, k, hw=hw, x_bytes=x_bytes)


def measured_cost(cand: TileCandidate, m: int, n: int, k: int, *,
                  device="cuda", operands=None, **replay_kw) -> CostReport:
    """The kernel's device time under this launch, from a replay on the
    card (``replay.replay_candidate``). Raises on any other device."""
    import torch

    from repro_torch.tuning.replay import replay_candidate
    if torch.device(device).type != "cuda":
        raise ValueError("measured costs are taken on the card only; use "
                         "analytic_cost elsewhere")
    dtype = "q8_0" if cand.kernel.startswith("q8") else "bf16"
    t = replay_candidate(cand, m, n, k, dtype, device=device,
                         operands=operands, **replay_kw).time_s
    return CostReport(cand, t, t, 0.0, t, "measured")
