"""Mixed-execution executor: one entry point for every linear.

``matmul`` flattens leading batch dims, splits the K contraction at the
burst boundary (paper §3.2 — the accelerator never sees a partial burst),
resolves each segment through the backend registry, and adds the partial
sums in f32.

Slicing a weight to a K range makes a view, never a copy: a Q8_0 weight's
main segment keeps its full row stride, which the Hopper kernels take as
an argument.

Each resolution counts in ``repro_dispatch_total`` on the active
telemetry, by segment, backend and kernel. A program's linears resolve on
every run of its Python (on the CPU) and twice per capture (its warm-up
and the captured pass, on the card); the serving engine runs every pass
but a program's build under ``quiet_dispatch()``, so the counter moves
once per linear per program build and once per eager call.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.backends.base import MAIN, RESIDUAL, KernelRequest, kernel_for
from repro_torch.backends.registry import REGISTRY
from repro_torch.core.mixed_exec import split_aligned
from repro_torch.core.qformats import QBLOCK, QTensor


_quiet = 0                   # open quiet_dispatch() scopes


@contextmanager
def quiet_dispatch():
    """Resolutions inside this scope count nothing: a run of a program
    that was already built."""
    global _quiet
    _quiet += 1
    try:
        yield
    finally:
        _quiet -= 1


def _note_dispatch(segment: str, backend_name: str, kernel: str) -> None:
    """Count one registry dispatch on the active telemetry, outside a
    ``quiet_dispatch()`` scope; a no-op when telemetry is off."""
    tele = obs.active()
    if tele is not None and not _quiet:
        tele.inc("repro_dispatch_total", segment=segment,
                 backend=backend_name, kernel=kernel)


def _slice_k(w, start: int, stop: int):
    """A view of the weight's K range. QTensor slicing moves whole Q8_0
    blocks — callers guarantee block-aligned boundaries."""
    if isinstance(w, QTensor):
        b0, b1 = start // QBLOCK, stop // QBLOCK
        return QTensor(qs=w.qs[..., b0:b1, :], scales=w.scales[..., b0:b1])
    return w[:, start:stop]


def split_matmul(x: torch.Tensor, w, burst: int, *,
                 backend: Optional[str] = None,
                 tiling: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """y = x @ W^T with the K contraction split at the burst boundary.

    x: (M, K); w: (N, K) tensor or QTensor. The aligned main segment
    resolves through the registry (optionally pinned to ``backend``) and
    runs with the launch tile ``tiling``; the residual always resolves by
    capability — the host arm — and runs only where K leaves one: a burst
    that divides K launches no residual. Returns f32.
    """
    quant = isinstance(w, QTensor)
    if quant and burst % QBLOCK != 0:
        raise ValueError(f"burst {burst} must be a multiple of QBLOCK={QBLOCK}")
    m, k = x.shape
    n = w.shape[0]
    dtype = "q8_0" if quant else "bf16"
    kern = kernel_for(m, quant)
    k_main, k_res = split_aligned(k, burst)
    out = None
    if k_main:
        req = KernelRequest(kernel=kern, m=m, n=n, k=k_main, dtype=dtype,
                            segment=MAIN, tiling=tiling)
        b = REGISTRY.resolve(req, pin=backend)
        _note_dispatch("main", b.name, kern)
        out = b.build(req)(x[:, :k_main], _slice_k(w, 0, k_main))
    if k_res:
        req = KernelRequest(kernel=kern, m=m, n=n, k=k_res, dtype=dtype,
                            segment=RESIDUAL)
        b = REGISTRY.resolve(req)
        _note_dispatch("residual", b.name, kern)
        res = b.build(req)(x[:, k_main:], _slice_k(w, k_main, k))
        out = res if out is None else out + res
    if out is None:
        return torch.zeros((m, n), dtype=torch.float32, device=x.device)
    return out


def matmul(x: torch.Tensor, w, *, burst: int = 256,
           backend: Optional[str] = None,
           tiling: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """x: (..., K) -> (..., N) f32 through ``split_matmul``. ``backend``
    and ``tiling`` pin the main segment's backend and launch tile (a plan
    entry's)."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x2d.stride(-1) != 1:       # the kernels read rows with unit stride
        x2d = x2d.contiguous()
    out = split_matmul(x2d, w, burst, backend=backend, tiling=tiling)
    return out.reshape(*lead, out.shape[-1])
