"""The backend protocol and the request object it answers.

A ``KernelRequest`` describes one *segment* of one linear invocation — the
burst-aligned main segment or the ragged residual tail of the paper's mixed
execution — in purely static terms (shapes, dtype, launch tile). A
``Backend`` looks at a request and either declines it (``supports``/
``auto``) or returns a callable that runs it (``build``).
``registry.REGISTRY.resolve`` is the one place that selects an
implementation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Protocol, Tuple, runtime_checkable

MAIN = "main"
RESIDUAL = "residual"

_SUBLANE = 8          # the reference pads M to this before choosing a kernel
_MATVEC_MAX_M = 16    # padded M up to this takes the matvec kernel


def padded_m(m: int) -> int:
    """M rounded up to the reference's sublane multiple. Only the kernel
    choice reads it: the Hopper kernels mask ragged M themselves."""
    return m + (-m) % _SUBLANE


def kernel_for(m: int, quantized: bool) -> str:
    """The kernel a (raw, unpadded) M dispatches to — the reference's rule,
    kept as the identity of every plan entry."""
    if quantized:
        return "q8_matvec" if padded_m(m) <= _MATVEC_MAX_M else "q8_matmul"
    return "bf16_matmul"


@dataclass(frozen=True)
class KernelRequest:
    """One segment of one linear call, described statically. ``m`` is the
    row count of the flattened activation; ``k`` is the contraction length
    *this segment* sees (k_main or k_res); ``tiling`` is the main segment's
    launch tile (``kernels/tiles.py``), None for the kernel's own."""
    kernel: str                               # kernel_for's name
    m: int
    n: int
    k: int
    dtype: str                                # "q8_0" | "bf16"
    segment: str = MAIN                       # MAIN | RESIDUAL
    tiling: Optional[Tuple[int, ...]] = None


@runtime_checkable
class Backend(Protocol):
    """What the registry requires of an execution backend."""

    name: str

    def supports(self, req: KernelRequest) -> bool:
        """Can this backend run ``req`` at all (when forced or pinned)?"""
        ...

    def auto(self, req: KernelRequest) -> bool:
        """Would it volunteer for ``req`` under capability resolution?"""
        ...

    def build(self, req: KernelRequest) -> Callable:
        """A callable ``(x_segment, w_segment) -> f32 output``; the weight
        is a tensor or a ``QTensor`` already sliced to the segment's K."""
        ...
