"""Measured-replay calibration of the analytic cost model.

The roofline in ``tuning/cost.py`` ranks candidates with data-sheet
constants (the H100's peak FLOP/s and device-memory bytes/s, a guessed
cost of a sequential step), so every cost it prints is a projection, not
a measurement. This module closes the loop: given replay measurements
(``tuning/replay.py``) it least-squares fits *effective* per-backend
constants and persists them as a versioned JSON next to the tuning cache,
where ``cost.preferred_cost`` picks them up.

The fitted form is the **additive** roofline

    t(cand) = flops/eff_flops + bytes/eff_bw + steps * overhead_s

rather than the analytic model's ``max(compute, memory) + launch``: the
additive form is linear in ``(1/eff_flops, 1/eff_bw, overhead_s)``, so a
plain linear least squares recovers the constants exactly from noise-free
samples and degrades gracefully on noisy ones. ``max`` and ``+`` agree in
the regimes that decide rankings (one term dominant); where they differ
the additive form is the conservative upper bound.

Schema (``CalibratedCoefficients.to_dict``)::

    {"schema": "hopper-1",
     "default_backend": "hopper",
     "backends": {"hopper": {"eff_flops": ..., "eff_bw": ...,
                             "overhead_s": ..., "n_samples": ...,
                             "median_rel_err": ...}}}

The schema is the port's own: a file the JAX package wrote (schema 1, fits
of its TPU and XLA backends) is refused, so its constants never price a
Hopper launch. The store follows the tuning cache's discipline: atomic
tmp + ``os.replace`` writes, and ``load_or_none`` degrades a corrupt or
schema-mismatched file to "no calibration" with a warning instead of
failing the caller (a calibration is an optimization, like the cache).
"""
from __future__ import annotations

import json
import os
import tempfile
import warnings
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

SCHEMA_VERSION = "hopper-1"

#: coefficient floor: a fit on degenerate samples (e.g. all-identical
#: shapes) can return ~0 or negative columns; clamping keeps ``predict``
#: finite and positive without rejecting the whole calibration.
_COEF_FLOOR = 1e-30


@dataclass(frozen=True)
class BackendCoefficients:
    """Effective roofline constants for ONE execution backend."""
    backend: str
    eff_flops: float              # effective FLOP/s
    eff_bw: float                 # effective bytes/s
    overhead_s: float             # per sequential step of a launch
    n_samples: int = 0
    median_rel_err: float = 0.0   # fit residual on the calibration set

    def predict(self, flops: float, bytes_hbm: float,
                steps: float) -> float:
        """Additive calibrated roofline (module docstring)."""
        return (flops / self.eff_flops + bytes_hbm / self.eff_bw
                + steps * self.overhead_s)

    def predict_parts(self, flops: float, bytes_hbm: float,
                      steps: float) -> Tuple[float, float, float]:
        return (flops / self.eff_flops, bytes_hbm / self.eff_bw,
                steps * self.overhead_s)


@dataclass
class CalibratedCoefficients:
    """Per-backend calibrated constants + the JSON store."""
    by_backend: Dict[str, BackendCoefficients] = field(default_factory=dict)
    default_backend: Optional[str] = None

    def __len__(self) -> int:
        return len(self.by_backend)

    def put(self, coeffs: BackendCoefficients) -> None:
        self.by_backend[coeffs.backend] = coeffs
        if self.default_backend is None:
            self.default_backend = coeffs.backend

    def for_backend(self, backend: Optional[str] = None
                    ) -> Optional[BackendCoefficients]:
        """Coefficients for ``backend`` (None -> the default backend);
        None when this calibration has none for it."""
        name = backend or self.default_backend
        return self.by_backend.get(name) if name else None

    # -- persistence ----------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": SCHEMA_VERSION,
                "default_backend": self.default_backend,
                "backends": {name: asdict(c)
                             for name, c in sorted(self.by_backend.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "CalibratedCoefficients":
        if d.get("schema") != SCHEMA_VERSION:
            raise ValueError(f"calibration schema {d.get('schema')!r} "
                             f"!= {SCHEMA_VERSION}")
        out = cls(default_backend=d.get("default_backend"))
        for name, cv in d.get("backends", {}).items():
            out.by_backend[name] = BackendCoefficients(**cv)
        return out

    def save(self, path: str) -> str:
        """Atomic write (tmp + ``os.replace``) — same discipline as
        ``tuning/cache.py``: a crashed writer never truncates a good
        coefficients file."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_dict(), f, indent=1)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibratedCoefficients":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def load_or_none(cls, path: Optional[str]
                     ) -> Optional["CalibratedCoefficients"]:
        """Best-effort load: a missing, corrupt, truncated, or
        schema-mismatched file degrades to None (uncalibrated analytic
        costs) with a warning instead of raising."""
        if path and os.path.exists(path):
            try:
                return cls.load(path)
            except (ValueError, KeyError, TypeError, OSError) as e:
                warnings.warn(
                    f"ignoring unreadable calibration file {path}: {e}")
        return None


def sibling_path(cache_path: str) -> str:
    """Where a tuning cache's calibration lives: ``foo.json`` ->
    ``foo.calibration.json`` in the same directory (so shipping a cache
    ships its calibration too)."""
    root, _ = os.path.splitext(cache_path)
    return root + ".calibration.json"


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------
def fit(samples: Sequence[Tuple[float, float, float, float]],
        backend: str = "") -> BackendCoefficients:
    """Least-squares fit of the additive roofline.

    ``samples`` are ``(flops, bytes_hbm, steps, measured_s)`` rows —
    features from ``cost.analytic_features`` and times from
    ``replay.replay``.  Solves ``t ~= a*flops + b*bytes + c*steps`` in
    float64 and returns ``BackendCoefficients(eff_flops=1/a, eff_bw=1/b,
    overhead_s=c)``.  Noise-free samples generated by the same form are
    recovered exactly; real measurements get
    the least-squares compromise, whose quality ``median_rel_err``
    reports.
    """
    if len(samples) < 3:
        raise ValueError(f"need >= 3 samples to fit 3 coefficients, "
                         f"got {len(samples)}")
    a = np.asarray([s[:3] for s in samples], dtype=np.float64)
    t = np.asarray([s[3] for s in samples], dtype=np.float64)
    # column scaling: flops ~1e9, bytes ~1e6, steps ~1e1 — normalize so
    # lstsq conditioning doesn't swamp the small columns
    scale = np.maximum(np.abs(a).max(axis=0), 1e-300)
    coef, *_ = np.linalg.lstsq(a / scale, t, rcond=None)
    coef = coef / scale
    coef = np.maximum(coef, _COEF_FLOOR)
    pred = a @ coef
    rel = np.abs(pred - t) / np.maximum(np.abs(t), 1e-300)
    return BackendCoefficients(
        backend=backend,
        eff_flops=float(1.0 / coef[0]),
        eff_bw=float(1.0 / coef[1]),
        overhead_s=float(coef[2]),
        n_samples=len(samples),
        median_rel_err=float(np.median(rel)))


def fit_backend(samples: Iterable, backend: str) -> BackendCoefficients:
    """``fit`` over replay samples (objects with ``flops`` /
    ``bytes_hbm`` / ``steps`` / ``time_s`` attributes, i.e.
    ``replay.ReplaySample``) that ran on ``backend``."""
    rows = [(s.flops, s.bytes_hbm, s.steps, s.time_s)
            for s in samples if s.backend == backend]
    return fit(rows, backend=backend)


# ---------------------------------------------------------------------------
# rank correlation (the "does analytic order match measured order?" gate)
# ---------------------------------------------------------------------------
def _ranks(xs: Sequence[float]) -> np.ndarray:
    """Average-tie ranks (scipy-free rankdata)."""
    xs = np.asarray(xs, dtype=np.float64)
    order = np.argsort(xs, kind="stable")
    ranks = np.empty(len(xs), dtype=np.float64)
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j)       # average of tied slots
        i = j + 1
    return ranks


def rank_correlation(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation in [-1, 1]: Pearson on average-tie
    ranks.  1.0 means the analytic model orders candidates exactly as
    the measurements do — the property the CI gate protects even when
    absolute errors are large."""
    if len(a) != len(b):
        raise ValueError(f"length mismatch: {len(a)} != {len(b)}")
    if len(a) < 2:
        return 1.0
    ra, rb = _ranks(a), _ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
    if denom == 0.0:                                # all-tied side: no order
        return 1.0 if (ra == rb).all() else 0.0
    return float((ra * rb).sum() / denom)
