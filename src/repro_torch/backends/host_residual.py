"""The host-residual backend: the paper's ARM-host arm.

In the paper each vector's unaligned tail (L mod b elements) runs on the
host while the accelerator consumes the aligned bursts. Here that tail is
an f32 contraction in plain PyTorch on the operands' own device; residual
Q8_0 weights are dequantized on this path (whole blocks: the burst is a
QBLOCK multiple, so the tail starts block-aligned). TF32 must stay off for
it to match the reference's f32 semantics (``core.device.resolve_device``
turns it off).
It takes no main segment, Q8_0 or dense, even when forced or pinned: those
run on the Hopper kernels. A linear whose K is shorter than the burst has
no main segment, so all of it is one residual segment here.

A product of 2 to ``MAX_ROWS`` rows (a decode step's) runs one row at a
time, each row the 1-row product a batch-1 step runs: the library picks
its GEMM, and with it the order of each row's sums, by the row count, so
a row would otherwise get other bits in a 4-slot continuous-batching step
than in a batch-1 step, and greedy tokens could differ. A Q8_0 weight is
dequantized once for all the rows.
"""
from __future__ import annotations

import torch

from repro_torch.backends.base import RESIDUAL, KernelRequest
from repro_torch.core.qformats import QBLOCK, QTensor, dequantize_q8_0


#: the decode kernels' batch limit (``kernels.q8_matvec.MAX_M``)
MAX_ROWS = 16


def _rows_apart(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T in f32 (w already f32), one row at a time when x has 2 to
    MAX_ROWS rows, so that a row's sums do not depend on the row count."""
    x = x.to(torch.float32)
    if not 1 < x.shape[0] <= MAX_ROWS:
        return x @ w.t()
    return torch.cat([x[i:i + 1] @ w.t() for i in range(x.shape[0])])


def _dense_host(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _rows_apart(x, w.to(torch.float32))


def _q8_host(x: torch.Tensor, wq: QTensor) -> torch.Tensor:
    """``q8_matmul_ref``'s function: the per-32-block dequant, then the f32
    contraction."""
    return _rows_apart(x, dequantize_q8_0(wq))


class HostResidualBackend:
    """f32 contraction on the host arm — the mixed-execution residual."""

    name = "host_residual"

    def supports(self, req: KernelRequest) -> bool:
        return req.segment == RESIDUAL and (req.dtype != "q8_0"
                                            or req.k % QBLOCK == 0)

    def auto(self, req: KernelRequest) -> bool:
        return self.supports(req)

    def build(self, req: KernelRequest):
        return _q8_host if req.dtype == "q8_0" else _dense_host
