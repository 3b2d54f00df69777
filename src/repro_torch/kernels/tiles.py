"""The launch tiles of the port's three matrix-product kernels: which tiles
each launch is built for, which a shape admits, the shared memory a block
of each claims, and the tile each launch takes when none is given.

The constants mirror those of ``csrc/q8_matmul.cu``, ``csrc/q8_matvec.cu``
and ``csrc/bf16_matmul.cu``; the C entries check a caller's tile by the
same rules and refuse one they do not admit. A tile changes the launch,
not the function: every tile computes the kernel's plain version.

- ``q8_matmul``'s tensor-core launch (``q8_wgmma_kernel``) and
  ``bf16_matmul``'s M > 16 one (``wgmma_kernel``): a tile is ``(block_n,
  stages)``, the output columns of a 64-row block and the slots of its
  ``cp.async`` ring.
- ``q8_matvec`` and ``bf16_matmul``'s M <= 16 launch (``gemv_bf16_kernel``):
  a tile is ``(rows, warps, split)``: the rows a lane group walks (1 or 4),
  the warps of a block, and how many of them share each row's K.
- The converting launches, which run above M = 16 where the
  ``cp.async`` ones cannot take the operands: ``bf16_matmul``'s
  ``bf16_cvt_tc_kernel`` (an f32 operand, or rows ``cp.async`` cannot
  copy: K not a whole number of 8) and ``q8_matmul``'s
  ``q8_split_tc_kernel`` (f32 x split into three bf16 parts, or bf16 x
  rows off 16 bytes). Each is one launch that takes no tile, written
  ``()`` in ``bf16_matmul``'s space; ``q8_matmul``'s chooses its tile N
  and its K split across a cluster from (M, N, K) alone
  (``q8_split_launch``), and the tuner's space of ``q8_matmul`` is its
  tensor-core launch's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

Tile = Tuple[int, ...]

SMS = 132                          # SMs of an H100 SXM
SMEM_PER_SM_BYTES = 228 * 1024     # shared memory of one SM
SMEM_OPTIN_BYTES = 227 * 1024      # the most one block may claim (opt-in)
MAX_ROW_M = 16                     # M up to this: the M <= 16 launches
BLOCK_M = 64                       # rows of a tensor-core block (wgmma m64)
K_STEP = 64                        # K a tensor-core block takes a step

# q8_wgmma_kernel: (block_n, stages); the first is the launch with no tile
Q8_WGMMA_TILES: Tuple[Tile, ...] = ((32, 3), (32, 2), (32, 4), (64, 2),
                                    (64, 3), (64, 4))
# wgmma_kernel (bf16_matmul, M > 16): (block_n, stages)
BF16_WGMMA_TILES: Tuple[Tile, ...] = ((64, 5), (64, 3), (64, 4))
# bf16_cvt_tc_kernel (bf16_matmul, M > 16, converting): a 64 x 64 block
# stepping K by K_STEP, its dynamic shared memory two buffers of the bf16 x
# and W step tiles and 1 KB to align
CVT_BLOCK_N = 64
CVT_SMEM_BYTES = 2 * (BLOCK_M + CVT_BLOCK_N) * K_STEP * 2 + 1024  # 33,792 B
# q8_split_tc_kernel (q8_matmul, converting): split K over at most this many
# CTAs of a cluster while the grid has fewer tiles than the SMs
SPLIT_MAX_CTAS = 8


def bf16_tensor_core_k(k: int) -> bool:
    """Whether contiguous bf16 rows of K values can feed ``wgmma_kernel``
    (``cp.async`` copies 16 bytes: K a whole number of 8)."""
    return k % 8 == 0


def q8_split_launch(m: int, n: int, k: int) -> Tuple[int, int]:
    """``split_launch`` of q8_matmul.cu: the converting launch's tile N and
    the CTAs of a cluster that share each tile's K steps, from (M, N, K)
    alone. 64 columns where that grid already gives every SM a tile; else
    32, and K split 2, 4 or 8 ways while the grid stays within one wave
    and every CTA has a K step."""
    rows, steps = -(-m // BLOCK_M), (k // 32 + 1) // 2
    if -(-n // 64) * rows >= SMS:
        return 64, 1
    tiles = -(-n // 32) * rows
    split = 1
    while (split < SPLIT_MAX_CTAS and 2 * split <= steps
           and 2 * split * tiles <= SMS):
        split *= 2
    return 32, split


def q8_wgmma_smem_bytes(tile: Tile) -> int:
    """``q_smem_bytes`` of q8_matmul.cu: the ring (bf16 x tile, raw int8 qs
    tile and the step's scales a slot), two widened bf16 W tiles and 1 KB
    to align; 40,704 B at (32, 3)."""
    bn, stages = tile
    return (stages * (BLOCK_M * K_STEP * 2 + bn * K_STEP + bn * 2 * 4)
            + 2 * bn * K_STEP * 2 + 1024)


def bf16_wgmma_smem_bytes(tile: Tile) -> int:
    """``tc_smem_bytes`` of bf16_matmul.cu: the ring of x and W tiles and
    1 KB to align; 82,944 B at (64, 5)."""
    bn, stages = tile
    return stages * (BLOCK_M + bn) * K_STEP * 2 + 1024


def batch_tile(m: int) -> int:
    """The batch tile a M <= 16 launch is instantiated for (1, 2, 4, 8, 16)."""
    t = 1
    while t < m:
        t *= 2
    return t


def tile_m(m: int) -> int:
    """The M at which a launch tile is chosen and timed: the batch tile of a
    M <= 16 launch (a decode step's M = 1 runs the M = 1 instantiation,
    whose best tile is not the M = 8 one's), else M padded to 8 rows, the
    key of the burst."""
    return batch_tile(m) if m <= MAX_ROW_M else m + (-m) % 8


@dataclass(frozen=True)
class RowLaunch:
    """A M <= 16 launch: each lane loads ``chunk`` values (16 bytes) of a
    row at a time, ``lanes`` lanes cover a row, so a warp holds 32 / lanes
    lane groups side by side."""
    lanes: int
    chunk: int
    max_warps: int = 4
    max_split: int = 4
    wide_rows: int = 4             # rows a lane group walks at large N
    min_blocks: int = SMS          # blocks the heuristic gives the grid

    @property
    def groups(self) -> int:
        return 32 // self.lanes

    def chunks(self, k: int) -> int:
        return -(-k // self.chunk)

    def rows_per_block(self, tile: Tile) -> int:
        rows, warps, split = tile
        return warps // split * self.groups * rows

    def tiles(self, k: int) -> List[Tile]:
        """Every tile the launch is built for that K admits: with a split,
        every lane of its warps has a chunk of each row to read."""
        return [(r, w, s) for r in (1, self.wide_rows) for w in (1, 2, 4)
                for s in (1, 2, 4)
                if w <= self.max_warps and s <= self.max_split
                and w % s == 0
                and (s == 1 or s * self.lanes <= self.chunks(k))]

    def default(self, n: int, k: int) -> Tile:
        """The heuristic's tile (the C ``launch`` with no tile): split K
        while each lane keeps whole steps, then the most rows a block that
        still gives every SM a block."""
        nc = self.chunks(k)
        split = 1
        while split < self.max_split and 2 * split * self.lanes <= nc:
            split *= 2

        def blocks(rows: int, warps: int) -> int:
            return -(-n // self.rows_per_block((rows, warps, split)))
        warps = self.max_warps
        rows = (self.wide_rows if blocks(self.wide_rows, warps)
                >= self.min_blocks else 1)
        while warps > split and blocks(rows, warps) < self.min_blocks:
            warps //= 2
        return rows, warps, split

    def smem_bytes(self, tile: Tile, m: int) -> int:
        """The static array of the split's partial sums, sized for the most
        warps a block."""
        return 4 * self.max_warps * self.groups * tile[0] * batch_tile(m)

    def check(self, tile: Tile, k: int) -> None:
        if tuple(tile) not in self.tiles(k):
            raise ValueError(f"tile {tuple(tile)} (rows, warps, split) is "
                             f"not admissible at K={k}; admissible: "
                             f"{self.tiles(k)}")


Q8_MATVEC = RowLaunch(lanes=16, chunk=16)    # int8: 16 bytes, half a block
BF16_GEMV = RowLaunch(lanes=32, chunk=8)     # bf16: 16 bytes


def check_wgmma_tile(name: str, tile: Optional[Tile],
                     tiles: Tuple[Tile, ...]) -> None:
    if tile is not None and tuple(tile) not in tiles:
        raise ValueError(f"{name}: tile {tuple(tile)} (block_n, stages) is "
                         f"not one of {tiles}")
