"""Decode-path Q8_0 matrix-vector product: x (B <= 16, K) times a Q8_0
weight W (N, K) -> (B, N) f32.

Replaces the Pallas TPU kernel ``repro/kernels/q8_matvec.py`` (``q8_matvec``,
body ``_q8_matvec_kernel``). On the H100 it is bound by device-memory bytes:
at B = 1 each weight byte feeds one multiply-add, far below the card's
arithmetic-to-bandwidth ratio, and most decode shapes are so small that
what counts is keeping loads in flight. The CUDA kernel
(``csrc/q8_matvec.cu``) streams the int8 payload and the scales exactly
once in 16-byte loads (half a Q8_0 block each, issued before any is used),
reads x straight from L1 with no barrier, splits long rows over the warps
of a block and shrinks blocks at small N so that every SM has work,
dequantizes in registers and reduces each row across its half-warp; it
masks the ragged N edge itself (the 51,872-row vocabulary readout) and
reads every operand through its row stride, so the burst-aligned K-slice
of a wider weight needs no copy.

The launch takes an optional tile (``kernels/tiles.py``, chosen by the
autotuner): the rows a half-warp walks, the warps a block and the K split;
with none the heuristic above chooses them.

``q8_matvec`` runs ``q8_matvec_plain`` only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref, tiles
from repro_torch.roofline import op_cost

MAX_M = 16     # decode batch tile; larger M goes to q8_matmul


#: the kernel's arithmetic in plain PyTorch: dequantize W in f32 (q * scale
#: per 32-block), then an f32 contraction
q8_matvec_plain = ref.q8_flat_ref


@op_cost.priced(functools.partial(op_cost.q8_price, "q8_matvec"),
                _build.fake_q8)
def q8_matvec(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor, *,
              tile: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """x (B, K) f32/bf16; qs (N, K) int8; scales (N, K/32) f32 -> (B, N)
    f32, with B <= 16. Rows of every operand may be strided. ``tile`` =
    (rows, warps, split) chooses the launch (None: the heuristic's,
    ``tiles.Q8_MATVEC.default``); a tile K does not admit
    (``tiles.Q8_MATVEC.tiles``) raises."""
    _build.check_q8_operands(x, qs, scales)
    if x.shape[0] > MAX_M:
        raise ValueError(f"q8_matvec takes at most {MAX_M} rows, got "
                         f"{x.shape[0]}")
    if tile is not None:
        tiles.Q8_MATVEC.check(tile, x.shape[1])
    if x.device.type == "cpu":
        return q8_matvec_plain(x, qs, scales)
    out = _build.launch_q8("q8_matvec", x, qs, scales, tile or (0, 0, 0))
    q8_matvec.launches += 1
    return out


q8_matvec.launches = 0
