"""Burst and tile autotuning on the H100: the paper's local-memory size x
burst-length co-design sweep as a subsystem of the port. Candidate launch
tiles and bursts under a shared-memory budget (space), analytic,
calibrated and measured costs (cost), a persistent JSON winner cache
(cache), the dispatch-facing Autotuner (tuner) that
``core.offload.OffloadEngine`` consumes, and the replay-and-fit loop
(replay, calibrate) that fits the analytic model's constants on the
card."""
from repro_torch.tuning.cache import (  # noqa: F401
    TuningCache, TuningKey, TuningRecord)
from repro_torch.tuning.calibrate import (  # noqa: F401
    BackendCoefficients, CalibratedCoefficients, fit, fit_backend,
    rank_correlation, sibling_path)
from repro_torch.tuning.cost import (  # noqa: F401
    H100, HW, CostReport, activate_calibration_file, analytic_cost,
    analytic_features, calibrated_cost, get_calibration, measured_cost,
    preferred_cost, set_calibration)
from repro_torch.tuning.replay import (  # noqa: F401
    ReplaySample, make_operands, replay, replay_candidate, trimmed_mean)
from repro_torch.tuning.space import (  # noqa: F401
    TileCandidate, budget_grid, default_candidate, enumerate_candidates)
from repro_torch.tuning.tuner import (  # noqa: F401
    Autotuner, kernel_for, padded_m, sweep_grid)
