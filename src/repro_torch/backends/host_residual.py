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
"""
from __future__ import annotations

import torch

from repro_torch.backends.base import RESIDUAL, KernelRequest
from repro_torch.core.qformats import QBLOCK
from repro_torch.kernels.ref import q8_matmul_ref


def _dense_host(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) @ w.to(torch.float32).t()


class HostResidualBackend:
    """f32 contraction on the host arm — the mixed-execution residual."""

    name = "host_residual"

    def supports(self, req: KernelRequest) -> bool:
        return req.segment == RESIDUAL and (req.dtype != "q8_0"
                                            or req.k % QBLOCK == 0)

    def auto(self, req: KernelRequest) -> bool:
        return self.supports(req)

    def build(self, req: KernelRequest):
        return q8_matmul_ref if req.dtype == "q8_0" else _dense_host
