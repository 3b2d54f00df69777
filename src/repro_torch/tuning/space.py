"""The Hopper design space of the autotuner: candidate tiles and bursts
under a shared-memory budget.

The paper's design space is (local-memory size) x (burst length); here it
is (shared memory a block may claim) x (launch tile, burst). A candidate
is admissible iff

  * its burst ``block_k`` divides K, within [32, 1024], in whole Q8_0
    blocks on the q8 kernels, and is K itself on ``q8_matvec`` (the
    reference's burst rule: a divisor of K leaves the host residual arm no
    work);
  * its launch is one the kernel is built for and the shape admits
    (``kernels/tiles.py``: the tensor-core launches' tile N and ring depth,
    the M <= 16 launches' rows, warps and K split; ``bf16_matmul`` at a K
    its tensor-core launch cannot take has one launch, the converting one,
    ``()``, with no tile);
  * the shared memory one block of the launch claims fits the budget (the
    32 KB-LMM analog).

The kernels take K in steps of their own, so on the H100 the burst decides
only the mixed split, and the launch tile is what the budget admits or
refuses. ``budget_grid`` is the paper's own axis, 16 to 128 KB, then the
most a block may claim. Every list is in one fixed order (burst
descending, then the kernel's tiles with the one it takes untuned first),
so that ties in a cost model resolve alike on every host.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.core.qformats import QBLOCK
from repro_torch.kernels import tiles

BLOCK_K_FLOOR, BLOCK_K_CAP = 32, 1024      # the burst axis
# canonical power-of-two burst axis for sweep grids
BLOCK_K_CANDIDATES = (32, 64, 128, 256, 512, 1024)
DEFAULT_BURST = 256                        # OffloadEngine's burst untuned
BUDGETS_KB = (16, 32, 64, 128)             # the paper's local-memory axis
MATVEC_MAX_M = tiles.MAX_ROW_M             # M up to this: the M <= 16 launches

KERNELS = ("q8_matmul", "q8_matvec", "bf16_matmul")


@dataclass(frozen=True)
class TileCandidate:
    """One point of the design space: a launch and a burst.

    ``block_m`` x ``block_n`` is the output a block of the launch covers (64
    rows on the tensor-core launches, the whole batch on the M <= 16 ones),
    ``block_k`` the burst, ``claim_bytes`` the shared memory a block claims,
    and ``launch`` the kernel's tile argument (``kernels/tiles.py``)."""
    kernel: str
    block_m: int
    block_n: int
    block_k: int
    claim_bytes: int
    launch: Tuple[int, ...]


def row_launch(kernel: str, m: int):
    """The M <= 16 launch description of ``kernel`` at ``m`` rows, or None
    where it runs a tensor-core launch."""
    if kernel == "q8_matvec":
        return tiles.Q8_MATVEC
    if kernel == "bf16_matmul" and m <= MATVEC_MAX_M:
        return tiles.BF16_GEMV
    return None


def _tensor_core(kernel: str, k: int):
    """The launches above M = 16 and their claims; ``bf16_matmul`` at a K
    its tensor-core launch cannot take runs the converting launch,
    ``()``."""
    if kernel == "q8_matmul":
        return tiles.Q8_WGMMA_TILES, tiles.q8_wgmma_smem_bytes
    if not tiles.bf16_tensor_core_k(k):
        return ((),), lambda launch: tiles.CVT_SMEM_BYTES
    return tiles.BF16_WGMMA_TILES, tiles.bf16_wgmma_smem_bytes


def launch_candidate(kernel: str, m: int, n: int, k: int, block_k: int,
                     launch: Tuple[int, ...]) -> TileCandidate:
    """The candidate of ``launch`` at (M, N, K) with burst ``block_k``: the
    block's extent and claim follow from the launch."""
    rl = row_launch(kernel, m)
    launch = tuple(launch)
    if rl is not None:
        return TileCandidate(kernel, m, rl.rows_per_block(launch), block_k,
                             rl.smem_bytes(launch, m), launch)
    _, claim = _tensor_core(kernel, k)
    block_n = launch[0] if launch else tiles.CVT_BLOCK_N
    return TileCandidate(kernel, tiles.BLOCK_M, block_n, block_k,
                         claim(launch), launch)


def default_launch(kernel: str, m: int, n: int, k: int) -> Tuple[int, ...]:
    """The tile the kernel takes with no tile given."""
    rl = row_launch(kernel, m)
    if rl is not None:
        return rl.default(n, k)
    return _tensor_core(kernel, k)[0][0]


def launches(kernel: str, m: int, n: int, k: int) -> List[Tuple[int, ...]]:
    """Every launch of ``kernel`` that (M, N, K) admits, the one it takes
    untuned first."""
    rl = row_launch(kernel, m)
    if rl is None:
        return list(_tensor_core(kernel, k)[0])
    first = rl.default(n, k)
    return [first] + [t for t in rl.tiles(k) if t != first]


def _divisors(dim: int, floor: int, cap: int, mult: int = 1) -> List[int]:
    """Every divisor of ``dim`` in [floor, cap] that is a multiple of
    ``mult``; a small dim that has none is its own single burst."""
    out = [d for d in range(floor, min(dim, cap) + 1)
           if dim % d == 0 and d % mult == 0]
    if not out and dim % mult == 0:
        out = [dim]
    return out


def bursts(kernel: str, k: int) -> List[int]:
    """The admissible bursts of K, largest first. ``q8_matvec`` streams each
    row's whole K in one launch, so its one burst is K, as in the
    reference."""
    kmult = QBLOCK if kernel.startswith("q8") else 1
    if kernel.startswith("q8") and k % QBLOCK:
        return []                 # the q8 kernels take whole Q8_0 blocks
    if kernel == "q8_matvec":
        return [k]
    return sorted(_divisors(k, BLOCK_K_FLOOR, BLOCK_K_CAP, kmult),
                  reverse=True)


def enumerate_candidates(kernel: str, m: int, n: int, k: int, *,
                         smem_budget_bytes: int = tiles.SMEM_OPTIN_BYTES
                         ) -> List[TileCandidate]:
    """Every admissible candidate of (M, N, K) for ``kernel`` within the
    shared-memory budget, in the fixed order of the module docstring."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    if kernel == "q8_matvec" and m > MATVEC_MAX_M:
        raise ValueError(f"q8_matvec takes M <= {MATVEC_MAX_M}, not {m}")
    cands = [launch_candidate(kernel, m, n, k, 0, t)
             for t in launches(kernel, m, n, k)]
    cands = [c for c in cands if c.claim_bytes <= smem_budget_bytes]
    return [dataclasses.replace(c, block_k=bk)
            for bk in bursts(kernel, k) for c in cands]


def default_candidate(kernel: str, m: int, n: int, k: int) -> TileCandidate:
    """What dispatch runs with no tuner attached: burst 256 and the launch
    the kernel chooses itself, as a candidate, so that the untuned path is
    priced with the same machinery as tuned ones."""
    return launch_candidate(kernel, m, n, k, DEFAULT_BURST,
                            default_launch(kernel, m, n, k))


def budget_grid() -> List[int]:
    """The shared-memory budgets of the (local memory x burst) grid, in
    bytes: the paper's 16, 32, 64 and 128 KB, then the most one block may
    claim."""
    return [kb * 1024 for kb in BUDGETS_KB] + [tiles.SMEM_OPTIN_BYTES]
