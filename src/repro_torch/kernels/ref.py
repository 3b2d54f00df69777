"""Plain PyTorch oracles for the kernels' semantics, one for one with the
reference's ``repro/kernels/ref.py``. ``q8_matmul_ref`` is the one Q8_0
oracle: the kernels' plain versions (``q8_flat_ref``) and the host
residual arm call it, and tests hold every kernel against it.
``matmul_bf16_ref`` is ``bf16_matmul``'s plain version. ``split_bf16x3``
is the exact split of an f32 x that ``q8_matmul``'s converting launch
makes on the card, written out for the CPU tests; no path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.core.qformats import QBLOCK, QTensor, dequantize_q8_0


def matmul_bf16_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The paper's FP16 kernel semantics: 16-bit operands, inline-converted,
    fp32 accumulated. bf16 products are exact in f32, so rounding the
    operands and contracting in f32 is the same function."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    wb = w.to(torch.bfloat16).to(torch.float32)
    return xb @ wb.t()


def q8_matmul_ref(x: torch.Tensor, wq: QTensor) -> torch.Tensor:
    """The paper's Q8_0 kernel semantics: per-32-block dequant then f32 MAC.
    x: (M, K); wq: QTensor over W[N, K]. Returns (M, N) f32."""
    return x.to(torch.float32) @ dequantize_q8_0(wq).t()


def q8_matvec_ref(x: torch.Tensor, wq: QTensor) -> torch.Tensor:
    """Decode-path dot product: x (B, K) against quantized W[N, K]."""
    return q8_matmul_ref(x, wq)


def q8_flat_ref(x: torch.Tensor, qs: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """``q8_matmul_ref`` on the kernels' operands: the flat int8 payload
    qs (N, K), whose rows may be strided, and scales (N, K/32)."""
    return q8_matmul_ref(x, QTensor(qs.unflatten(-1, (-1, QBLOCK)), scales))


def split_bf16x3(x: torch.Tensor):
    """An f32 tensor split into three bf16 tensors, as
    ``q8_split_tc_kernel`` splits x: hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid), rounding to nearest even. Both differences are
    exact in f32 and lo is exact in bf16, so hi + mid + lo == x wherever
    the parts stay normal."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)
