"""Dispatch planning: each linear's routing resolved from static shapes.

Every routing input — the offload decision, the burst split, the kernel,
its launch tile and the main-segment backend — is a function of static
shapes plus engine configuration (and the autotuner's cache, whose first
query of a shape runs one search and whose later ones are dict hits), and
is recorded as a ``PlanEntry``. A
``DispatchPlan`` holds the entries of one run of a program (a prefill or
one decode step), and the serving engine keeps one per shape key in a
``PlanCache`` (``plan_key``). The plan of a captured program is recorded
while its Python runs once before capture; replays run no Python, so the
ledger (``core/offload.py``) accounts a program by committing its plan
times the number of runs.

``offload`` keeps the reference's local-memory rule (``coverage.fits``), so
the ledger's offloaded/fallback split stays in step with the reference.
It does not route: the H100 kernels have no such capacity limit, so every
Q8_0 main segment resolves to the Hopper kernels. The reference instead
pins its capacity fallbacks to ``xla_ref``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from repro_torch.backends import (
    MAIN, REGISTRY, KernelRequest, kernel_for, padded_m)
from repro_torch.core.coverage import MulMat, fits
from repro_torch.core.mixed_exec import select_burst, split_aligned
from repro_torch.kernels import tiles
from repro_torch.sharding.rules import mesh_signature


@dataclass(frozen=True)
class PlanEntry:
    """Routing record for one linear call site at one static shape: the
    ``(name, m, k, n, dtype)`` identity, the offload decision, the burst
    split and whether the autotuner chose it (``tuned``), the kernel the
    main segment dispatches to and its launch tile (``tiling``, None: the
    kernel's own), and the registry backend resolved for the main
    segment. ``mesh`` is the signature of the serving mesh the program was
    planned under (None unsharded): sharded and unsharded entries never
    compare equal at the same shapes, and the ledger splits a sharded
    entry's FLOPs over the mesh's devices."""
    name: str
    m: int
    k: int
    n: int
    dtype: str                 # "q8_0" | "bf16"
    offload: bool
    burst: int
    tuned: bool
    kernel: str
    tiling: Optional[Tuple[int, ...]]
    k_main: int
    k_res: int
    backend: str
    mesh: Optional[Tuple[Tuple[str, int], ...]] = None
    #: the launch's K where it is not ``k``: a row-parallel linear's model
    #: shard contracts K / M (0: ``k``)
    k_run: int = 0
    #: in a program over a mesh with "model" > 1, the model shards the
    #: linear runs on: M where it is split over them, 1 where it runs whole
    #: on the data shard's first model device (None: no such mesh)
    split: Optional[int] = None

    @property
    def flops(self) -> int:
        return 2 * self.m * self.k * self.n

    @property
    def offloaded_flops(self) -> int:
        """FLOPs on the accelerator kernel (main segment) if offloaded."""
        return (self.flops * self.k_main // max(self.k_run or self.k, 1)
                if self.offload else 0)

    @property
    def residual_flops(self) -> int:
        return (self.flops * self.k_res // max(self.k_run or self.k, 1)
                if self.offload else 0)

    @property
    def fallback_flops(self) -> int:
        return 0 if self.offload else self.flops


def plan_linear(name: str, m: int, k: int, n: int, *, quantized: bool,
                vmem_budget_kb: int, default_burst: int,
                tuner=None, f32_operand: bool = False,
                mesh_sig=None, shards: int = 1, model: int = 1,
                row_parallel: bool = False) -> PlanEntry:
    """Resolve one linear's routing from static shapes — pure apart from
    warming the tuner's cache (a miss runs one search whose winner is
    cached, so repeated calls are dict hits).

    With a ``tuner`` the burst is its winner for the full-K problem
    (``select_burst``), keyed by the sublane-padded M as in the reference,
    and the launch tile its winner for the main segment the kernel sees
    (``k_main``), keyed by ``tiles.tile_m`` (the batch tile a M <= 16
    launch runs). Where no launch fits the tuner's budget the entry keeps
    ``default_burst`` and the kernel's own launch, with ``tuned=False``.
    ``f32_operand``: an operand is f32 (x, or a dense W), so above M = 16
    the product runs a converting launch, which takes no tile:
    ``bf16_matmul``'s, or ``q8_matmul``'s ``q8_split_tc_kernel`` for a
    Q8_0 weight. ``mesh_sig`` is stamped into the entry.

    ``shards``: the program is one of that many data shards of a step of
    ``m`` rows, each launching its ``m / shards`` rows. The entry's M, its
    FLOPs and the reference's offload rule stay the whole step's; the
    kernel, the burst, the launch tile and the backend are those of the
    launch a shard runs, so the entry names the kernel that ran.

    ``model``: the linear is split over that many model shards, each
    launching ``n`` output columns of it, or with ``row_parallel`` ``k``
    of its input columns. The entry's N or K, its FLOPs and the offload
    rule are the whole linear's, its kernel, burst, ``k_main``/``k_res``
    and tile a shard's launch's (``k_run`` its K), and ``split`` is
    ``model`` wherever the mesh has a model axis above 1.
    """
    dtype = "q8_0" if quantized else "bf16"
    run_m = m // shards
    run_k, whole_n = k, n
    if model > 1 and row_parallel:
        k = k * model
    elif model > 1:
        whole_n = n * model
    split = None
    if mesh_sig is not None and dict(mesh_sig).get("model", 1) > 1:
        split = model
    kern = kernel_for(run_m, quantized)
    mp = padded_m(run_m)
    burst = default_burst
    tuned = False
    if tuner is not None:
        b = select_burst(run_k, tuner, kernel=kern, m=mp, n=n, dtype=dtype,
                         default=0)
        if b:
            burst, tuned = b, True
    k_main, k_res = split_aligned(run_k, burst)
    offload = fits(MulMat(name, m=m, k=k, n=whole_n), vmem_budget_kb,
                   agg_units=1)
    tiling = None
    takes_tile = not (f32_operand and run_m > tiles.MAX_ROW_M)
    if tuner is not None and offload and k_main and takes_tile:
        rec = tuner.best_tiling(kern, tiles.tile_m(run_m), n, k_main, dtype)
        if rec is not None:
            tiling = rec.tiling() or None     # (): a launch with no tile
    if k_main:
        req = KernelRequest(kernel=kern, m=run_m, n=n, k=k_main, dtype=dtype,
                            segment=MAIN, tiling=tiling)
        resolved = REGISTRY.resolve(req).name
    else:
        # k < burst: no main segment — the whole linear runs on the host arm
        resolved = "host_residual"
    return PlanEntry(name=name, m=m, k=k, n=whole_n, dtype=dtype,
                     offload=offload, burst=burst, tuned=tuned, kernel=kern,
                     tiling=tiling, k_main=k_main, k_res=k_res,
                     backend=resolved, mesh=mesh_sig,
                     k_run=run_k if run_k != k else 0, split=split)


@dataclass
class DispatchPlan:
    """The routing of one program: ``PlanEntry`` per linear call, in
    execution order. One plan describes ONE run of the program; the ledger
    multiplies by the run count."""
    key: Hashable = None
    entries: List[PlanEntry] = field(default_factory=list)

    def add(self, entry: PlanEntry) -> None:
        self.entries.append(entry)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def signature(self) -> Tuple[PlanEntry, ...]:
        """Hashable identity: equal signatures mean identical routing."""
        return tuple(self.entries)

    def summary(self) -> Dict[str, Any]:
        off = [e for e in self.entries if e.offload]
        return {
            "calls": len(self.entries),
            "offloaded": len(off),
            "tuned": sum(1 for e in off if e.tuned),
            "offloaded_flops": sum(e.offloaded_flops for e in self.entries),
            "fallback_flops": sum(e.fallback_flops for e in self.entries),
            "residual_flops": sum(e.residual_flops for e in self.entries),
        }


def plan_key(phase: str, quant: Optional[str], batch: int,
             *extra: Hashable, mesh=None,
             pages: Optional[Tuple[Hashable, ...]] = None,
             role: Optional[str] = None,
             k: Optional[int] = None) -> Tuple[Hashable, ...]:
    """Canonical plan-cache key: ``(phase, quant, batch, *extra)``; the
    serving engine's extra is the frame count. Routing depends only on
    static shapes, so equal keys mean one program and one plan.

    ``mesh`` (a ``Mesh``, or a ``mesh_signature`` tuple) appends
    ``("mesh", signature)`` first, in the reference's position: a sharded
    step at (batch, frames) is another program than its unsharded twin,
    so the two never share an entry. ``mesh=None`` leaves a key as it
    was.

    ``pages`` appends the paged pool's geometry as ``("pages", pages)``,
    as the reference does: a paged decode step gathers its KV through
    block tables, another program than the contiguous step at the same
    (batch, frames), so the two never share a ``PlanCache`` entry.

    ``role`` and ``k`` append the speculative identity, ``("role",
    role)`` then ``("k", k)``, after the pages qualifier, in the
    reference's order: a draft step and a verify window of ``k + 1``
    positions (M = batch x (k + 1) a linear) are other programs than the
    plain step at the same batch. ``None`` leaves a key as it was."""
    base = (phase, quant, batch, *extra)
    sig = mesh_signature(mesh) if hasattr(mesh, "axis_names") else mesh
    if sig is not None:
        base = (*base, ("mesh", sig))
    if pages is not None:
        base = (*base, ("pages", tuple(pages)))
    if role is not None:
        base = (*base, ("role", role))
    if k is not None:
        base = (*base, ("k", k))
    return base


@dataclass
class PlanCache:
    """Plans keyed by ``plan_key``, so that steady-state serving resolves
    its routing with one dict hit."""
    plans: Dict[Hashable, DispatchPlan] = field(default_factory=dict)
    hits: int = 0
    misses: int = 0

    def get_or_build(self, key: Hashable,
                     build: Callable[[], DispatchPlan]) -> DispatchPlan:
        plan = self.plans.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        self.misses += 1
        plan = build()
        plan.key = key
        self.plans[key] = plan
        return plan

    def __len__(self) -> int:
        return len(self.plans)
