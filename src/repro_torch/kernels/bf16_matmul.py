"""Dense (FP16-path) matrix product: x (M, K) times W (N, K)^T -> (M, N)
f32, both operands rounded to bf16, f32 accumulation.

Replaces the Pallas TPU kernel ``repro/kernels/bf16_matmul.py``
(``bf16_matmul``, body ``_bf16_matmul_kernel``), the paper's FP16
dot-product kernel. Rounding both operands to bf16 inside the kernel, as
the TPU kernel does, makes an f32 x (or an f32 W of the f32 test configs)
the same function as a bf16 one; bf16 products are exact in f32. The CUDA
kernel (``csrc/bf16_matmul.cu``) has three launch configurations: at
M <= 16 (decode, M = 1) ``gemv_bf16_kernel`` streams the bf16 weight once,
bound by its bytes: a warp per row of 16-byte loads issued before use, x
read through L1 with no barrier, long K split over a block's warps, and a
grid that gives every SM a block; it takes every operand at M <= 16. Above
(prefill, M = 1500), for bf16 x and W with 16-byte aligned rows and K a
whole number of 8, ``wgmma_kernel`` runs 64 x 64 tiles on the tensor cores
(``wgmma`` fed by a ``cp.async`` ring, f32 accumulators). Every other
operand above M = 16 (an f32 x or W, bf16 rows off a 16-byte boundary, K
not a whole number of 8) takes ``bf16_cvt_tc_kernel``: the same tiles and
``wgmma`` products, each operand loaded through registers and rounded to
bf16 on its way into shared memory (the function's own rounding), the
next K step's loads in flight under the current step's products. All read
x and W through their row strides, so the burst-aligned K-slice of a
wider weight needs no copy, and mask ragged M, N and K themselves.

Each launch takes an optional tile (``kernels/tiles.py``, chosen by the
autotuner): the M <= 16 launch's rows, warps and K split, the tensor-core
launch's ring depth (3 to 5 slots); with none it makes today's choice.
The converting launch takes no tile.

``bf16_matmul`` runs ``bf16_matmul_plain`` only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref, tiles
from repro_torch.roofline import op_cost

MAX_GEMV_M = tiles.MAX_ROW_M     # M up to this takes gemv_bf16_kernel

#: the kernel's arithmetic in plain PyTorch: round both operands to bf16,
#: then an f32 contraction
bf16_matmul_plain = ref.matmul_bf16_ref


def c_tile(m: int, k: int, tile: Optional[Tuple[int, ...]],
           bf16_operands: bool = True) -> Tuple[int, int, int, int]:
    """The C entry's tile arguments (rows, warps, split, stages) for a
    caller's tile: at M <= 16 a (rows, warps, split) that K admits
    (``tiles.BF16_GEMV``), at M > 16 a (block_n, stages) of
    ``tiles.BF16_WGMMA_TILES`` for bf16 x and W (an f32 operand runs the
    converting launch, which takes no tile); None, or its ``()``,
    gives zeros (the kernel's own choice). Any other tile raises, as the C
    entry refuses it."""
    if not tile:                 # None, or () of the converting launch
        return 0, 0, 0, 0
    if m <= MAX_GEMV_M:
        tiles.BF16_GEMV.check(tile, k)
        return (*tile, 0)
    if not bf16_operands:
        raise ValueError(f"bf16_matmul: tile {tuple(tile)} at M={m} with an "
                         "f32 operand: the converting launch takes no tile")
    tiles.check_wgmma_tile("bf16_matmul", tile, tiles.BF16_WGMMA_TILES)
    return 0, 0, 0, tile[1]


def _fake(x, w, **_):
    _build.check_dense_operands(x, w)
    return x.new_empty((x.shape[0], w.shape[0]), dtype=torch.float32)


@op_cost.priced(op_cost.bf16_price, _fake)
def bf16_matmul(x: torch.Tensor, w: torch.Tensor, *,
                tile: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """x (M, K) f32/bf16; w (N, K) bf16/f32 -> (M, N) f32. Rows of both
    operands may be strided; M and N may be ragged. ``tile`` chooses the
    launch (``c_tile``); the converting launch of M > 16 with an f32
    operand, or rows ``cp.async`` cannot copy, takes none."""
    _build.check_dense_operands(x, w)
    m, k = x.shape
    args = c_tile(m, k, tile, x.dtype == w.dtype == torch.bfloat16)
    if x.device.type == "cpu":
        return bf16_matmul_plain(x, w)
    n = w.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.call("bf16_matmul", x.device,
                x.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(0),
                w.data_ptr(), int(w.dtype == torch.bfloat16), w.stride(0),
                out.data_ptr(), out.stride(0), m, n, k, *args)
    bf16_matmul.launches += 1
    return out


bf16_matmul.launches = 0
