"""Replays of one kernel request for cost-model calibration.

A replay resolves one candidate ``KernelRequest`` through the backend
registry, as production dispatch does (a forced backend, then the pin,
then capability: the Hopper backend for every main segment), runs it with
its launch tile pinned, ``reps`` times after warm-up, and reports the
times beside the analytic model's FLOP/byte/step accounting of the same
candidate (the features ``calibrate.fit`` regresses against). On a CUDA
device each time is CUDA events around the replay of a CUDA graph of
``inner`` calls, divided by ``inner`` (the device's time, without the
host's launch cost between calls); on the CPU (the kernels' plain
versions) it is the host clock around one call.

Operands come from a seeded ``torch.Generator`` on the replay's device:
two replays of one request run on identical inputs, and the output's
checksum witnesses it. The activations take the type each kernel meets on
whisper's serving paths (``X_DTYPES``): bf16 at prefill, where it selects
the tensor-core launches, and f32 on the Q8_0 decode path; a dense weight
is bf16, as served.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.tuning.cost import analytic_features
from repro_torch.tuning.space import (
    TileCandidate, default_candidate, launch_candidate)

X_DTYPES = {"q8_matmul": torch.bfloat16, "q8_matvec": torch.float32,
            "bf16_matmul": torch.bfloat16}


@dataclass(frozen=True)
class ReplaySample:
    """One replayed (candidate, backend) measurement."""
    kernel: str
    m: int
    n: int
    k: int
    dtype: str                            # "q8_0" | "bf16"
    backend: str                          # the backend that ran it
    tiling: Optional[Tuple[int, ...]]     # the launch tile, None: default
    times_s: Tuple[float, ...]            # per rep
    warmup: int
    checksum: float                       # f64 sum of the output
    flops: float                          # the analytic accounting of the
    bytes_hbm: float                      # same candidate (calibrate.fit's
    steps: float                          # feature columns)

    @property
    def time_s(self) -> float:
        return trimmed_mean(self.times_s)


def trimmed_mean(ts: Sequence[float], trim: float = 0.25) -> float:
    """Mean of the middle after dropping samples from each end: robust to
    one slow outlier. At least one sample is dropped per side once n >= 3
    (n = 3: the median; n = 5: the mean of the middle three)."""
    if not ts:
        raise ValueError("no timing samples")
    xs = sorted(ts)
    drop = max(int(len(xs) * trim), 1) if len(xs) >= 3 else 0
    mid = xs[drop:len(xs) - drop]
    return sum(mid) / len(mid)


def make_operands(kernel: str, m: int, n: int, k: int, dtype: str,
                  seed: int = 0, device="cuda"):
    """Operands (x, w) of a replay, from a seeded generator on ``device``
    (the card unless the caller asks for the CPU; raises without a card):
    x (M, K) in the kernel's activation type, w (N, K) a Q8_0 ``QTensor``
    or a bf16 tensor."""
    from repro_torch.core.device import resolve_device
    from repro_torch.core.qformats import quantize_q8_0
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(
        X_DTYPES[kernel])
    w = torch.randn((n, k), generator=gen, device=device) * 0.05
    w = quantize_q8_0(w) if dtype == "q8_0" else w.to(torch.bfloat16)
    return x, w


def timed(fn, reps: int, inner: int, device) -> Tuple[list, object]:
    """Per-rep times of ``fn`` and its last output. On the CPU: the host
    clock around one call. On a CUDA device: CUDA events around the replay
    of a CUDA graph holding ``inner`` calls, divided by ``inner``, so that
    the host's launch cost between calls (tens of µs of Python, more than
    most of these kernels take) stays out, as it does in the serving
    engine's captured programs. The graph's own start costs about as much
    as a few µs-long launches, so ``inner`` must be large for those to
    rank as the profiler does (``replay`` takes 50)."""
    device = torch.device(device)
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return times, out
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            out = fn()
    graph.replay()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for start, end in zip(starts, ends):
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize(device)
    return [s.elapsed_time(e) / 1e3 / inner
            for s, e in zip(starts, ends)], out


def replay(kernel: str, m: int, n: int, k: int, dtype: str, *,
           backend: Optional[str] = None,
           tiling: Optional[Tuple[int, ...]] = None,
           reps: int = 5, warmup: int = 2, inner: int = 50, seed: int = 0,
           device="cuda", operands=None) -> ReplaySample:
    """Time one request on one backend, on ``device``: the card unless the
    caller asks for the CPU (where the plain version runs); raises without
    a card.

    ``backend`` is a registry pin, not a force: a ``REGISTRY.force``
    context outranks it, as in production dispatch, and the sample records
    the backend that ran. ``tiling`` pins the launch tile; the analytic
    features are those of the same tile (or of the default launch when
    None). ``operands`` reuses ``make_operands``'s pair across replays of
    one shape."""
    from repro_torch.backends.base import MAIN, KernelRequest
    from repro_torch.backends.registry import REGISTRY
    from repro_torch.core.device import resolve_device

    device = resolve_device(device)
    req = KernelRequest(kernel=kernel, m=m, n=n, k=k, dtype=dtype,
                        segment=MAIN, tiling=tiling)
    resolved = REGISTRY.resolve(req, pin=backend)
    fn = resolved.build(req)
    x, w = operands if operands is not None else make_operands(
        kernel, m, n, k, dtype, seed=seed, device=device)
    for _ in range(max(warmup, 1)):
        fn(x, w)
    times, out = timed(lambda: fn(x, w), max(reps, 1), max(inner, 1),
                       device)
    cand = (launch_candidate(kernel, m, n, k, k, tiling) if tiling is not None
            else default_candidate(kernel, m, n, k))
    flops, bytes_hbm, steps = analytic_features(cand, m, n, k)
    return ReplaySample(
        kernel=kernel, m=m, n=n, k=k, dtype=dtype, backend=resolved.name,
        tiling=tiling, times_s=tuple(times), warmup=warmup,
        checksum=float(out.double().sum()), flops=flops,
        bytes_hbm=bytes_hbm, steps=steps)


def replay_candidate(cand: TileCandidate, m: int, n: int, k: int,
                     dtype: str, **kw) -> ReplaySample:
    """``replay`` of a space-enumerated candidate's launch."""
    return replay(cand.kernel, m, n, k, dtype, tiling=cand.launch, **kw)
