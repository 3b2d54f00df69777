"""Prefill-path Q8_0 block-dequant matrix product: x (M, K) times a Q8_0
weight W (N, K) -> (M, N) f32.

Replaces the Pallas TPU kernel ``repro/kernels/q8_matmul.py``
(``q8_matmul``, body ``_q8_matmul_kernel``). At prefill M = 1500 frames and
x is bf16, so the products belong on the tensor cores: a bf16 x int8
product is exact in f32, so per-32-block bf16 MMAs with f32 accumulation,
scaled per block afterwards, compute the same function up to summation
order, and the bytes (about 1 us at 1500 x 384 x 256) then bound it. The
CUDA kernel (``csrc/q8_matmul.cu``) does exactly that for bf16 x with
16-byte aligned rows: ``wgmma`` on 64 x 32 output tiles, x and the raw
int8 payload copied by ``cp.async``, the payload widened to bf16 in shared
memory, two products per Q8_0 block into a partial accumulator that is
scaled and added in f32. An f32 x cannot be rounded to bf16 (that would
change the function), so ``q8_split_tc_kernel`` splits it exactly into
three bf16 parts (``ref.split_bf16x3``: hi + mid + lo == x), each of whose
products with an int8 value is exact in f32, and sums the three parts'
products of each Q8_0 block on the tensor cores, the smallest first,
before the scale: the same function up to the order of the f32 sums. Its
x comes in through registers (bf16 rows off 16 bytes take the same
launch with the one part x itself); at the small grids of a verify window
the K steps of a tile are shared by up to 8 CTAs of a cluster, summed in
a fixed order through distributed shared memory (``tiles.q8_split_launch``
mirrors that choice). Both mask ragged M and N in the kernel (no padding,
unlike the TPU kernel, which needed whole tiles), and both are bit for bit
the same from one launch to the next.

The tensor-core launch takes an optional tile (``kernels/tiles.py``,
chosen by the autotuner): its tile N (32 or 64) and ring depth (2 to 4
slots); with none it runs 64 x 32 tiles and 3 slots. The converting launch
chooses its own and runs the same with any tile.

``q8_matmul`` runs ``q8_matmul_plain`` only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref, tiles
from repro_torch.roofline import op_cost


#: the kernel's arithmetic in plain PyTorch: dequantize W in f32 (q * scale
#: per 32-block), then an f32 contraction
q8_matmul_plain = ref.q8_flat_ref


@op_cost.priced(functools.partial(op_cost.q8_price, "q8_matmul"),
                _build.fake_q8)
def q8_matmul(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor, *,
              tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x (M, K) f32/bf16; qs (N, K) int8; scales (N, K/32) f32 -> (M, N)
    f32. Rows of every operand may be strided; M and N may be ragged.
    ``tile`` = (block_n, stages), one of ``tiles.Q8_WGMMA_TILES``, chooses
    the tensor-core launch (None: (32, 3)); the converting launch of f32 x
    chooses its own. A tile not in that list raises."""
    _build.check_q8_operands(x, qs, scales)
    tiles.check_wgmma_tile("q8_matmul", tile, tiles.Q8_WGMMA_TILES)
    if x.device.type == "cpu":
        return q8_matmul_plain(x, qs, scales)
    out = _build.launch_q8("q8_matmul", x, qs, scales, tile or (0, 0))
    q8_matmul.launches += 1
    return out


q8_matmul.launches = 0
