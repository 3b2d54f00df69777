"""Mixed execution (paper §3.2): the burst-aligned main segment of each
contraction runs on the accelerator kernel, the residual on the host arm —
the kernel never sees a partial burst.

Each vector of length L splits into a main segment of ⌊L/b⌋·b and a
residual of L mod b. The split arithmetic lives here; the executor
(``backends/executor.py``) runs the two segments and adds their partial
sums.
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
