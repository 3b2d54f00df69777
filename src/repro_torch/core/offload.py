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

Sharded serving: an engine on a serving mesh stamps the mesh's signature
(``mesh_sig``) into every entry, and the ledger splits each entry's FLOPs
evenly over the mesh's devices (``OffloadStats.by_device``), the
reference's rule. A program that runs one of n data shards of a batch
(``sharding.ctx.shard_program``) plans each linear at the global M, n
times its own rows: one plan describes the step, whichever shard
recorded it, and the step commits it once. The entry's kernel, burst,
launch tile and backend are resolved at the shard's own rows, the launch
that runs (``plan_linear``'s ``shards``). A linear split over the model
shards of a data shard (``sharding.ctx.model_shard``) is planned at its
whole N or K, launched at the shard's slice, and recorded once, by model
shard 0; the ledger puts its FLOPs on the model devices that ran it
(``PlanEntry.split``).
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
from repro_torch.sharding import ctx
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
    # FLOPs per mesh device under sharded serving: slot-DP splits every
    # linear's rows evenly over the mesh, so each device's share is
    # flops / n_devices, the remainder to dev0; an unsharded entry's all
    # to dev0. sum(by_device) == offloaded + fallback + residual FLOPs.
    by_device: Dict[str, int] = field(default_factory=dict)

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
        n_dev = 1
        for _, size in (entry.mesh or ()):
            n_dev *= int(size)
        total = entry.flops * times
        if entry.split is None:
            share, rem = divmod(total, n_dev)
            shares = [share + (rem if i == 0 else 0) for i in range(n_dev)]
        else:
            # over "model": each data shard's rows on its model devices,
            # split evenly where the linear is, else on the first
            n_model = dict(entry.mesh)["model"]
            per = total // (n_dev // n_model) // entry.split
            shares = [per if i % n_model < entry.split else 0
                      for i in range(n_dev)]
            shares[0] += total - sum(shares)
        for i, share in enumerate(shares):
            dev = f"dev{i}"
            s.by_device[dev] = s.by_device.get(dev, 0) + share

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
    ``tuner`` is attached or none of its launches fits its budget.
    ``mesh_sig`` is the serving mesh's signature, set by a ``ServeEngine``
    on a mesh and stamped into every entry."""
    vmem_budget_kb: int = 8 * 1024
    burst: int = 256
    tuner: Optional[Autotuner] = None
    ledger: OffloadLedger = field(default_factory=OffloadLedger)
    mesh_sig: Optional[tuple] = None
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
                   name: str = "linear", f32_operand: bool = False,
                   shards: int = 1, model: int = 1,
                   row_parallel: bool = False) -> PlanEntry:
        """Resolve the routing of one static shape (``plan_linear``)."""
        return plan_linear(name, m, k, n, quantized=quantized,
                           vmem_budget_kb=self.vmem_budget_kb,
                           default_burst=self.burst, tuner=self.tuner,
                           f32_operand=f32_operand, mesh_sig=self.mesh_sig,
                           shards=shards, model=model,
                           row_parallel=row_parallel)

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

    def linear(self, x: torch.Tensor, w, name: str = "linear", *,
               row_parallel: bool = False) -> torch.Tensor:
        """y = x @ W^T (f32), routed per the plan entry for this shape;
        recorded into the active plan, or else accounted in the ledger.
        Inside a data shard's program the entry is the whole step's: M is
        this shard's rows times the number of shards, and its kernel the
        one this shard's rows launch. Inside model shard m of M
        (``sharding.ctx.model_shard``) W is the shard's slice of a linear
        split over "model" (its input columns where ``row_parallel``): the
        entry is the whole linear's and only shard 0 records or accounts
        it, so that a step's plan and the ledger hold each linear once."""
        k = x.shape[-1]
        n = w.shape[0]
        shards = ctx.batch_shards()
        m_index, n_model = ctx.model_shard()
        m = (x.numel() // k if k else 0) * shards
        quantized = isinstance(w, QTensor)
        entry = self.plan_entry(
            m, k, n, quantized=quantized, name=name,
            f32_operand=(x.dtype == torch.float32
                         or (not quantized and w.dtype == torch.float32)),
            shards=shards, model=n_model, row_parallel=row_parallel)
        y = self.execute(x, w, entry)
        if m_index:
            return y
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
