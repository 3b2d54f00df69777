"""Offload dispatcher — the paper's co-design loop as a runtime feature.

For each linear call it resolves a ``PlanEntry`` from static shapes
(``core/plan.py``): whether the working set fits the local-memory budget,
where the burst splits K, and which kernel, launch tile and backend run
the main segment. With an autotuner attached (``tuning.Autotuner``) the
burst and the tile come from its persistent cache, one dict lookup each
once a shape is warm. It executes the entry through the mixed-split
executor.

Plan/ledger split, as in the reference: an eager call accounts its entry
in the ``OffloadLedger`` when it runs. Inside ``recording(plan)`` a call
appends its entry to the plan and accounts nothing: the serving engine
records the run of Python that precedes a capture (and every run of the
same program on the CPU) that way, and accounts each program by
``ledger.commit(plan, times)`` with the number of times it ran.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch import obs
from repro_torch.backends import executor
from repro_torch.core.coverage import MulMat, fits
from repro_torch.core.plan import DispatchPlan, PlanEntry, plan_linear
from repro_torch.core.qformats import QTensor
from repro_torch.tuning import Autotuner


@dataclass
class OffloadStats:
    """Aggregated accounting: call and FLOP totals, calls per call-site
    name (``by_kernel``) and per main-segment backend (``by_backend``)."""
    offloaded_calls: int = 0
    fallback_calls: int = 0
    offloaded_flops: int = 0
    fallback_flops: int = 0
    residual_flops: int = 0
    tuned_calls: int = 0        # offloads that ran on a tuned burst
    by_kernel: Dict[str, int] = field(default_factory=dict)
    by_backend: Dict[str, int] = field(default_factory=dict)
    # FLOPs per role of a two-model (speculative) engine: "draft" and
    # "verify" commits, "main" for everything else. Whole-linear FLOPs,
    # so sum(by_role) == offloaded + fallback + residual FLOPs exactly.
    by_role: Dict[str, int] = field(default_factory=dict)

    def offload_rate(self) -> float:
        t = self.offloaded_calls + self.fallback_calls
        return self.offloaded_calls / t if t else 0.0

    def offload_flop_rate(self) -> float:
        t = self.offloaded_flops + self.fallback_flops
        return self.offloaded_flops / t if t else 0.0


@dataclass
class OffloadLedger:
    """Host-side accounting: an eager call accounts its entry once; a
    recorded program is committed as its plan times the number of runs."""
    totals: OffloadStats = field(default_factory=OffloadStats)
    commits: int = 0            # plans committed (not runs)

    def account(self, entry: PlanEntry, times: int = 1,
                role: str = "main") -> None:
        s = self.totals
        if entry.offload:
            s.offloaded_calls += times
            if entry.tuned:
                s.tuned_calls += times
            s.offloaded_flops += entry.offloaded_flops * times
            s.residual_flops += entry.residual_flops * times
        else:
            s.fallback_calls += times
            s.fallback_flops += entry.fallback_flops * times
        s.by_kernel[entry.name] = s.by_kernel.get(entry.name, 0) + times
        s.by_backend[entry.backend] = (s.by_backend.get(entry.backend, 0)
                                       + times)
        s.by_role[role] = s.by_role.get(role, 0) + entry.flops * times

    def commit(self, plan: Optional[DispatchPlan], times: int = 1,
               role: str = "main") -> None:
        """Account ``times`` runs of a recorded program's plan, its FLOPs
        under ``role`` ("draft" or "verify" from a speculative engine,
        "main" everywhere else)."""
        if plan is None or times <= 0:
            return
        for entry in plan:
            self.account(entry, times, role=role)
        self.commits += 1


@dataclass
class OffloadEngine:
    """The dispatcher. ``vmem_budget_kb`` is the local-memory budget an
    invocation's working set must fit to be offloaded (the reference's
    rule, kept for plan parity); ``burst`` is the split granularity when no
    ``tuner`` is attached or none of its launches fits its budget."""
    vmem_budget_kb: int = 8 * 1024
    burst: int = 256
    tuner: Optional[Autotuner] = None
    ledger: OffloadLedger = field(default_factory=OffloadLedger)
    _recording: Optional[DispatchPlan] = field(default=None, repr=False)

    @property
    def stats(self) -> OffloadStats:
        return self.ledger.totals

    def should_offload(self, m: int, k: int, n: int,
                       name: str = "linear") -> bool:
        """Whether an (m, k, n) product's working set fits the local-memory
        budget with the optimized data layout (the reference's rule, one
        aggregation unit)."""
        return fits(MulMat(name, m=m, k=k, n=n), self.vmem_budget_kb,
                    optimized=True, agg_units=1)

    def plan_entry(self, m: int, k: int, n: int, *, quantized: bool,
                   name: str = "linear", dense_f32: bool = False
                   ) -> PlanEntry:
        """Resolve the routing of one static shape (``plan_linear``)."""
        return plan_linear(name, m, k, n, quantized=quantized,
                           vmem_budget_kb=self.vmem_budget_kb,
                           default_burst=self.burst, tuner=self.tuner,
                           dense_f32=dense_f32)

    @contextmanager
    def recording(self, plan: DispatchPlan):
        """While active, every ``linear`` call appends its entry to
        ``plan`` instead of accounting it: the routing of one program run,
        which the caller commits to the ledger per run."""
        prev, self._recording = self._recording, plan
        try:
            yield plan
        finally:
            self._recording = prev

    def linear(self, x: torch.Tensor, w, name: str = "linear") -> torch.Tensor:
        """y = x @ W^T (f32), routed per the plan entry for this shape;
        recorded into the active plan, or else accounted in the ledger."""
        k = x.shape[-1]
        n = w.shape[0]
        m = x.numel() // k if k else 0
        quantized = isinstance(w, QTensor)
        entry = self.plan_entry(
            m, k, n, quantized=quantized, name=name,
            dense_f32=not quantized and torch.float32 in (x.dtype, w.dtype))
        y = self.execute(x, w, entry)
        if self._recording is not None:
            self._recording.add(entry)
        else:
            self.ledger.account(entry)
            # an eager account lands outside any ledger span; claiming it
            # on the active telemetry keeps the span FLOPs == ledger delta
            # invariant exact under mixed eager and program use
            tele = obs.active()
            if tele is not None and tele._ledger is self.ledger:
                tele.claim_eager(entry)
        return y

    def execute(self, x: torch.Tensor, w, entry: PlanEntry) -> torch.Tensor:
        """Run one linear per a resolved ``PlanEntry``: its burst, its
        backend and its launch tile."""
        return executor.matmul(x, w, burst=entry.burst, backend=entry.backend,
                               tiling=entry.tiling)
