"""The Hopper backend: the paper's accelerator path on the H100, in the
role of the reference's ``pallas_tpu`` backend.

It runs every main segment on the hand-written CUDA kernels: Q8_0 ones on
``q8_matvec`` when the sublane-padded M is at most 16, else ``q8_matmul``
(the reference's ``kernel_for`` rule, which stays the identity of every
plan entry), and dense (``bf16``) ones on ``bf16_matmul`` at every M. It
takes every main segment, also those the reference's local-memory rule
marks ``offload=False``: the H100 kernels have no such capacity limit.
Unlike the TPU backend it pads nothing: the kernels mask ragged M and N
themselves and read the K-sliced weight through its row stride. The launch
tile comes from the request (a plan entry's ``tiling``, which the
autotuner chose); without one each kernel makes its own choice.

On CPU tensors the kernel wrappers run their plain versions; on CUDA
tensors they launch the kernel or raise.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.backends.base import MAIN, KernelRequest, kernel_for
from repro_torch.core.qformats import QBLOCK, QTensor
from repro_torch.kernels.bf16_matmul import bf16_matmul
from repro_torch.kernels.q8_matmul import q8_matmul
from repro_torch.kernels.q8_matvec import q8_matvec


def q8_main(x2d: torch.Tensor, wq: QTensor, *,
            tile: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Aligned-segment Q8_0 product: x2d (M, K) -> (M, N) f32."""
    qs2d = wq.flat_qs()
    if kernel_for(x2d.shape[0], True) == "q8_matvec":
        return q8_matvec(x2d, qs2d, wq.scales, tile=tile)
    return q8_matmul(x2d, qs2d, wq.scales, tile=tile)


class HopperBackend:
    """The port's CUDA kernels for every main segment."""

    name = "hopper"

    def supports(self, req: KernelRequest) -> bool:
        return req.segment == MAIN and (req.dtype != "q8_0"
                                        or req.k % QBLOCK == 0)

    def auto(self, req: KernelRequest) -> bool:
        return self.supports(req)

    def build(self, req: KernelRequest):
        fn = q8_main if req.dtype == "q8_0" else bf16_matmul
        return functools.partial(fn, tile=req.tiling) if req.tiling else fn
