"""Mixed execution (paper §3.2): the burst-aligned main segment of each
contraction runs on the accelerator kernel, the residual on the host arm —
the kernel never sees a partial burst.

Each vector of length L splits into a main segment of ⌊L/b⌋·b and a
residual of L mod b. The split arithmetic and the choice of b
(``select_burst``: the autotuner's burst, or the engine's) live here; the
executor (``backends/executor.py``) runs the two segments and adds their
partial sums.
"""
from __future__ import annotations

from typing import Tuple


def split_point(length: int, burst: int) -> int:
    """⌊L/b⌋·b — the aligned main-segment length."""
    if burst <= 0:
        raise ValueError("burst must be positive")
    return (length // burst) * burst


def split_aligned(length: int, burst: int) -> Tuple[int, int]:
    """(main_len, residual_len) with main_len % burst == 0."""
    m = split_point(length, burst)
    return m, length - m


def select_burst(k: int, tuner=None, *, kernel: str = "q8_matmul",
                 m: int = 1, n: int = 1, dtype: str = "q8_0",
                 default: int = 256) -> int:
    """The split granularity of a (M, K) x (N, K) call: the tuned burst
    (``block_k`` of the autotuner's record for the full-K problem) when a
    tuner is attached and a launch fits its budget, else ``default``. A
    tuned burst divides K and holds whole Q8_0 blocks on the q8 kernels,
    because the candidate space admits no other."""
    if tuner is None:
        return default
    rec = tuner.best_tiling(kernel, m, n, k, dtype)
    return rec.block_k if rec else default


def residual_fraction(length: int, burst: int) -> float:
    """Fraction of the work left to the host arm (paper §3.2's three-way
    trade-off: a larger burst strands more of a length it does not
    divide)."""
    if length == 0:
        return 0.0
    return (length % burst) / length
