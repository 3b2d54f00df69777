"""The autotuner: search the admissible space, keep winners in the
persistent cache, answer dispatch-time queries with a dict lookup.

This is the paper's central experiment run as a feature: the local-memory
size x burst-length co-design sweep that lands on 32 KB / burst 16. Here
the local-memory axis is ``smem_budget_bytes`` (what one block of a launch
may claim of an SM's shared memory) and the burst axis is ``block_k``; the
winner of each (kernel, M, N, K, dtype, budget) persists in a JSON cache.

Modes:
  analytic — rank candidates by the roofline model (any device);
  measured — time every admissible launch of the shape on the card, one
             replay a launch (bursts that divide K run the same launch),
             ties going to the largest burst and the untuned launch; a
             launch replaces the kernel's own only when it is faster by
             more than ``MEASURED_MARGIN`` (a replay's spread);
  auto     — measured when the tuner's device is CUDA, analytic on the CPU.

The tuner's ``device`` defaults to ``"cuda"``; without a card it raises
unless ``device="cpu"`` was passed, like the port's other entry points.
Rankings go through ``cost.preferred_cost``: with a calibration (passed
in, or found beside ``cache_path`` as its ``calibrate.sibling_path``)
candidates are priced with constants fitted on the card.

When nothing fits the budget, ``best_tiling`` answers None (memoized, so
the sweep is not repeated): the plan entry then keeps the default burst
and the kernel's own launch, and says it was not tuned. The reference
instead falls back to its XLA path; the H100 kernels have no capacity
limit to fall back from.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.backends.base import kernel_for, padded_m
from repro_torch.core.device import resolve_device
from repro_torch.kernels import tiles
from repro_torch.tuning.cache import TuningCache, TuningKey, TuningRecord
from repro_torch.tuning.calibrate import CalibratedCoefficients, sibling_path
from repro_torch.tuning.cost import (
    CostReport, analytic_cost, measured_cost, preferred_cost)
from repro_torch.tuning.replay import make_operands
from repro_torch.tuning.space import default_launch, enumerate_candidates

__all__ = ["Autotuner", "kernel_for", "padded_m", "sweep_grid"]

#: a measured launch must beat the kernel's own by this fraction to replace
#: it, so that the spread of one replay does not displace the kernel's own
#: launch with one that is no faster
MEASURED_MARGIN = 0.03


@dataclass
class Autotuner:
    """Owned by ``core.offload.OffloadEngine`` (one per engine)."""
    cache: TuningCache = field(default_factory=TuningCache)
    smem_budget_bytes: int = tiles.SMEM_OPTIN_BYTES
    mode: str = "auto"                    # analytic | measured | auto
    device: object = "cuda"
    cache_path: Optional[str] = None
    # fitted cost coefficients: explicit, or loaded from calibration_path
    # or the cache_path sibling file
    calibration: Optional[CalibratedCoefficients] = None
    calibration_path: Optional[str] = None
    searches: int = 0                     # sweeps run (cache misses)
    # shapes where nothing fits the budget, memoized in-process so that
    # dispatch never repeats a fruitless sweep
    _no_tiling: set = field(default_factory=set, repr=False)

    def __post_init__(self):
        if self.mode not in ("analytic", "measured", "auto"):
            raise ValueError(f"unknown tuning mode {self.mode!r}")
        self.device = resolve_device(self.device)
        if self.mode == "measured" and self.device.type != "cuda":
            raise ValueError("measured tuning runs on the card: "
                             "device='cuda'")
        if self.cache_path:
            self.cache.merge(TuningCache.load_or_empty(self.cache_path))
        if self.calibration is None:
            path = self.calibration_path or (
                sibling_path(self.cache_path) if self.cache_path else None)
            self.calibration = CalibratedCoefficients.load_or_none(path)

    def resolved_mode(self) -> str:
        if self.mode != "auto":
            return self.mode
        return "measured" if self.device.type == "cuda" else "analytic"

    # -- search ----------------------------------------------------------
    def _measure(self, reports: List[CostReport], m: int, n: int,
                 k: int) -> List[CostReport]:
        """Every candidate's measured cost, one replay a launch on one set
        of operands."""
        kernel = reports[0].cand.kernel
        dtype = "q8_0" if kernel.startswith("q8") else "bf16"
        operands = make_operands(kernel, m, n, k, dtype, device=self.device)
        by_launch = {}
        out = []
        for r in reports:
            t = by_launch.get(r.cand.launch)
            if t is None:
                t = by_launch[r.cand.launch] = measured_cost(
                    r.cand, m, n, k, device=self.device,
                    operands=operands).cost_s
            out.append(CostReport(r.cand, t, t, 0.0, t, "measured"))
        return out

    def search(self, kernel: str, m: int, n: int,
               k: int) -> Optional[TuningRecord]:
        """Sweep the admissible space of this shape; None if nothing fits
        the budget."""
        self.searches += 1
        cands = enumerate_candidates(
            kernel, m, n, k, smem_budget_bytes=self.smem_budget_bytes)
        if not cands:
            return None
        reports = [preferred_cost(c, m, n, k, calibration=self.calibration)
                   for c in cands]
        best = None
        if self.resolved_mode() == "measured":
            reports = self._measure(reports, m, n, k)
            own = reports[0]        # largest burst, the kernel's own launch
            if own.cand.launch == default_launch(kernel, m, n, k):
                best = own
        fastest = min(reports, key=lambda r: r.cost_s)   # first of equals
        if best is None or (fastest.cost_s
                            < best.cost_s * (1 - MEASURED_MARGIN)):
            best = fastest
        c = best.cand
        return TuningRecord(block_m=c.block_m, block_n=c.block_n,
                            block_k=c.block_k, cost_s=best.cost_s,
                            claim_bytes=c.claim_bytes, source=best.source,
                            launch=c.launch)

    def best_tiling(self, kernel: str, m: int, n: int, k: int,
                    dtype: str) -> Optional[TuningRecord]:
        """Dispatch-time entry point: a cache hit is a dict lookup; a miss
        runs one search whose winner is cached for every later call of the
        same shape."""
        key = TuningKey(kernel, m, n, k, dtype, self.smem_budget_bytes)
        if key in self._no_tiling:        # memoized negative: also a hit
            self.cache.hits += 1
            return None
        rec = self.cache.get(key)
        if rec is not None:
            return rec
        rec = self.search(kernel, m, n, k)
        if rec is None:
            self._no_tiling.add(key)
        else:
            self.cache.put(key, rec)
        return rec

    # -- offline warming -------------------------------------------------
    def warm(self, mulmats: Iterable, dtype: str = "q8_0") -> int:
        """Pre-tune a workload (``core.coverage.MulMat`` items) so that
        serving does not stall on a first-call sweep. Returns the number of
        distinct full-K shapes tuned. Each shape warms the queries
        ``core.plan.plan_linear`` makes: the full-K one at the padded M
        (the burst), then the main segment's at ``tiles.tile_m`` and
        ``k_main`` (the launch tile) where that is another key."""
        seen, tile_keys = set(), set()
        quant = dtype.startswith("q8")
        for mm in mulmats:
            kern = kernel_for(mm.m, quant)
            mp = padded_m(mm.m)
            sig = (kern, mp, mm.n, mm.k)
            tm = tiles.tile_m(mm.m)
            if sig in seen and (sig, tm) in tile_keys:
                continue
            seen.add(sig)
            tile_keys.add((sig, tm))
            rec = self.best_tiling(kern, mp, mm.n, mm.k, dtype)
            if rec is not None:
                k_main = (mm.k // rec.block_k) * rec.block_k
                if k_main and (tm, k_main) != (mp, mm.k):
                    self.best_tiling(kern, tm, mm.n, k_main, dtype)
        return len(seen)

    def save(self, path: Optional[str] = None) -> Optional[str]:
        p = path or self.cache_path
        return self.cache.save(p) if p else None


def sweep_grid(kernel: str, m: int, n: int, k: int, *,
               budgets: Sequence[int], block_ks: Sequence[int],
               cost_fn=None) -> List[Tuple[int, CostReport]]:
    """The paper's Fig 7/10-style grid: the cheapest admissible launch at
    each (shared-memory budget, burst) cell, as (budget bytes, CostReport)
    pairs. Cells where no launch fits the budget are left out (the
    coverage cliff of the paper's Table 6). ``cost_fn(cand, m, n, k)``
    defaults to the analytic model; pass a measured one on the card."""
    cost_fn = cost_fn or analytic_cost
    out: List[Tuple[int, CostReport]] = []
    for budget in budgets:
        cands = enumerate_candidates(kernel, m, n, k,
                                     smem_budget_bytes=budget)
        for bk in block_ks:
            sub = [c for c in cands if c.block_k == bk]
            if not sub:
                continue
            best = min((cost_fn(c, m, n, k) for c in sub),
                       key=lambda r: r.cost_s)
            out.append((budget, best))
    return out
