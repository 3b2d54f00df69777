"""Amdahl's-Law analysis of the dot-product bottleneck (paper §1, Fig 4).

The paper profiles Whisper-tiny.en on a Cortex-A72: the dot-product
kernel is 90.6 % (FP16) / 87.1 % (Q8_0) of CPU time, bounding
single-kernel offload at 10.6x / 7.8x. ``profile_shares`` measures the
same split for a program by timing it with the GEMM path ablated against
intact; ``timeit_median`` waits for the card where the work runs on one.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

# Paper's measured FP16/Q8_0 dot-product shares (Fig 4)
PAPER_SHARE = {"fp16": 0.906, "q8_0": 0.871}


def amdahl_speedup(offload_fraction: float, kernel_speedup: float) -> float:
    """System speedup when ``offload_fraction`` of time runs
    ``kernel_speedup`` x faster."""
    if not 0.0 <= offload_fraction <= 1.0:
        raise ValueError("fraction must be in [0,1]")
    if kernel_speedup <= 0:
        raise ValueError("speedup must be positive")
    return 1.0 / ((1.0 - offload_fraction) + offload_fraction / kernel_speedup)


def amdahl_bound(offload_fraction: float) -> float:
    """Theoretical maximum (kernel_speedup -> inf): 1/(1-f).
    f=0.906 -> 10.6x (FP16); f=0.871 -> 7.8x (Q8_0) — paper §1."""
    if offload_fraction >= 1.0:
        return float("inf")
    return 1.0 / (1.0 - offload_fraction)


def timeit_median(fn: Callable[[], object], iters: int = 5,
                  warmup: int = 2,
                  device: Optional[torch.device] = None) -> float:
    """Median wall-clock seconds of fn() after ``warmup`` calls. With a
    CUDA ``device`` every timed call ends in a synchronize of that card,
    so the time covers the work, not its enqueue."""
    def sync():
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    for _ in range(warmup):
        fn()
    sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def profile_shares(full_fn: Callable[[], object],
                   nogemm_fn: Callable[[], object],
                   iters: int = 5,
                   device: Optional[torch.device] = None) -> Dict[str, float]:
    """Dot-product share = (T_full - T_nogemm)/T_full. The ablation keeps
    softmax/norms/elementwise ops and removes only mul_mat work, mirroring
    the paper's per-op profile."""
    t_full = timeit_median(full_fn, iters, device=device)
    t_rest = timeit_median(nogemm_fn, iters, device=device)
    share = max(0.0, min(1.0, (t_full - t_rest) / t_full))
    return {
        "t_full_s": t_full,
        "t_rest_s": t_rest,
        "dot_share": share,
        "amdahl_bound": amdahl_bound(share),
    }
