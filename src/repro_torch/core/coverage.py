"""Local-memory kernel coverage: the offload decision of the dispatcher.

A dot-product invocation is *offloadable* iff its working set fits the
local-memory budget; everything else falls back to the reference path.
The optimized footprint holds the dense activation operand, ``M*K*2``
bytes (fp16), so an invocation fits iff ``M*K*2 <= budget_kb * 1024 *
agg_units``. The port keeps the reference's rule unchanged so that its
dispatch plans equal the reference's entry for entry.
"""
from __future__ import annotations

from dataclasses import dataclass

AGG_UNITS = 46            # active PE LMMs aggregated per offloaded invocation
FP16_BYTES = 2


@dataclass(frozen=True)
class MulMat:
    """One ggml_mul_mat invocation class: W[N,K] x X[M,K] -> [M,N]."""
    name: str
    m: int
    k: int
    n: int

    def act_bytes_dense(self) -> int:
        return self.m * self.k * FP16_BYTES


def fits(mm: MulMat, budget_kb: int, agg_units: int = AGG_UNITS) -> bool:
    return mm.act_bytes_dense() <= budget_kb * 1024 * agg_units
