#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device and builds its
own kernels with nvcc. Phases, each of which fails the run on error:

1. The card's name and power limit (nvidia-smi), then the build of every
   kernel from ``src/repro_torch/csrc/`` (one nvcc per source, started
   together), with the ``-Xptxas -v`` register and shared-memory report.
2. Each kernel at every shape its main path gives it: its result against
   its plain PyTorch version on the card, its device time (torch.profiler,
   warm L2) and its back-to-back time per call (CUDA events, which include
   the host's launch cost), the plain version's device time, the least
   time the card could take (the larger of bytes over 3.35 TB/s and FLOPs
   over the peak for the operands' type: 989 TFLOP/s for bf16 operands,
   and for a bf16 x times int8 weights, whose product is exact on the
   tensor cores; 67 TFLOP/s for f32 x), and one PyTorch call as a library
   yardstick, timed here and used nowhere in the port: ``torch.matmul``
   against the pre-dequantized f32 weight for the Q8_0 kernels (no single
   PyTorch call computes a Q8_0 product), ``torch.mm(..., out_dtype=
   torch.float32)`` on the same bf16 operands (cuBLAS with the kernel's f32
   output) for ``bf16_matmul``, beside which ``torch.matmul`` with a bf16
   output (the yardstick of earlier runs) is kept as
   ``library_bf16_out_ms``, and ``scaled_dot_product_attention`` on the
   same bf16 q, k, v (a bf16 output; the kernel writes f32) for
   ``flash_attention_fwd``. TF32 is off (``resolve_device``), which leaves
   bf16 products alone. Flash attention is also checked causal and at
   ragged lengths.
3. The main path: full-width whisper-tiny with Q8_0 weights from a seeded
   generator, the eager greedy loop through ``ServeEngine.prefill`` and
   ``ServeEngine.step`` (every kernel launched from Python) over one
   1500-frame utterance with ``max_new=32`` and no EOS, through the
   offload engine. The kernels' launch counts are zeroed just before and
   read just after: exactly 32 ``q8_matmul`` launches (the prefill) and
   33 ``q8_matvec`` launches per decode step. Then the same weights and
   mel run through the port on the CPU, and the first decode step's logits
   must agree with the card's. A profiled prefill and 8 decode steps give
   each phase's device time, idle share and top kernels by name; the
   prefill's 32 ``q8_matmul`` launches must all be its tensor-core kernel
   (``q8_wgmma_kernel``), none the f32 SIMT one.
4. Batch 2 at full width, where the encoder's ffn.down (M = 3000, K = 1536)
   fails the reference's local-memory rule (``offload=False`` in its plan
   entries): a captured ``transcribe`` gives the plans and its tokens, and
   in the eager loop every Q8_0 linear must still launch a kernel; the two
   loops' tokens must agree.
5. The dense (FP16) path with flash attention: full-width whisper-tiny with
   bf16 weights (``quant="none"``) and ``attn_impl="flash"``, the same
   eager loop. Exactly 32 ``bf16_matmul`` launches per prefill plus 33 per
   decode step, 4 ``flash_attention_fwd`` launches (one per encoder layer)
   and no Q8_0 launch; first-step logits against the CPU's. In the
   profiled decode steps every one of the 33 ``bf16_matmul`` launches a
   step must be the decode kernel (``gemv_bf16_kernel``), none the one it
   replaced (``matvec_kernel``); their device time a step is printed.
6. Captured programs, on each path's engine: ``transcribe`` captures the
   prefill and the greedy step into CUDA graphs at its first request; its
   tokens must equal the eager loop's. At capture each program's Python
   runs twice (warm-up and capture), so the launch counts read twice the
   program's launches; later requests launch nothing from Python, capture
   nothing more, and their ledger totals must equal as many eager
   requests'. Printed: prefill ms and decode ms a token (median of 4
   requests), and one replayed prefill and 8 replayed steps under the
   profiler (device time, idle share, kernels by name, which must be 32
   ``q8_wgmma_kernel`` a prefill and 33 ``q8_matvec_kernel`` a step on
   Q8_0; 32 ``wgmma_kernel`` + 4 ``flash_fwd_mma_kernel`` and 33
   ``gemv_bf16_kernel`` on dense), beside phase 3's and 5's eager split;
   the dot-product kernels' share of the replayed step's device time and
   its Amdahl bound, beside the paper's shares.
7. Power and PDP, on each path: captured ``transcribe`` of 1500 frames and
   27 tokens (the paper's workload) over and over for 5 s while
   ``nvidia-smi`` samples the card's draw every 100 ms; the samples' count,
   mean and range, the mean transcript time, the PDP at the mean draw and
   at the power limit, beside the paper's whisper-tiny PDPs. No samples
   fail the phase.
8. ``coverage_cdf(enumerate_whisper(whisper-tiny))``: the paper's Table 2
   structure.

The last two lines are the kernels' JSON record and the result line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
# H100 SXM dense peak for x's type: a bf16 x int8 product is exact in f32,
# so bf16 x runs at the bf16 tensor-core rate; f32 x outside the tensor
# cores (tf32 would round x)
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
FIRST_STEP_TOL = 1e-2           # card vs CPU logits, see check_against_cpu
# the dense path's decoder runs in bf16 (bf16 embedding table), so its
# logits leave every linear rounded to bf16: steps of 2^-7 at |logit| in
# [1, 2). 3e-2 is about four such steps.
DENSE_FIRST_STEP_TOL = 3e-2
# kernel vs plain on the card: f32 sums in another order, relative to the
# output's largest value; flash attention in bf16 at 1e-2, where a
# probability next to a bf16 rounding boundary can round the other way on
# the card's exp than on PyTorch's (one bf16 step, 2^-8, of one weight)
KERNEL_TOL = 1e-4
FLASH_BF16_TOL = 1e-2

# (m, n, k_main, k_full, launches per decode step / per prefill, x dtype)
MATVEC_SHAPES = [
    (1, 384, 256, 384, 24, "float32"),     # self q/k/v/o + cross q/o, 4 layers
    (1, 1536, 256, 384, 4, "float32"),     # ffn.up
    (1, 384, 1536, 1536, 4, "float32"),    # ffn.down
    (1, 51872, 256, 384, 1, "float32"),    # dec.vocab
]
MATMUL_SHAPES = [
    (1500, 384, 256, 384, 24, "bfloat16"),    # enc q/k/v/o + dec.cross.k/v
    (1500, 1536, 256, 384, 4, "bfloat16"),    # enc ffn.up
    (1500, 384, 1536, 1536, 4, "bfloat16"),   # enc ffn.down
]
# dense path, all operands bf16: (m, n, k_main, k_full, launches, x dtype)
BF16_STEP_SHAPES = [
    (1, 384, 256, 384, 24, "bfloat16"),     # self q/k/v/o + cross q/o
    (1, 1536, 256, 384, 4, "bfloat16"),     # ffn.up
    (1, 384, 1536, 1536, 4, "bfloat16"),    # ffn.down
    (1, 51872, 256, 384, 1, "bfloat16"),    # dec.vocab
]
BF16_PREFILL_SHAPES = [
    (1500, 384, 256, 384, 24, "bfloat16"),    # enc q/k/v/o + dec.cross.k/v
    (1500, 1536, 256, 384, 4, "bfloat16"),    # enc ffn.up
    (1500, 384, 1536, 1536, 4, "bfloat16"),   # enc ffn.down
]
# (batch*heads, Sq, Sk, D, launches per prefill, dtype, causal)
FLASH_SHAPES = [(6, 1500, 1500, 64, 4, "bfloat16", False)]   # encoder
FLASH_CHECKS = [                 # held against the plain version, not timed
    (6, 1500, 1500, 64, 0, "bfloat16", True),
    (3, 37, 101, 64, 0, "bfloat16", False),
    (3, 101, 37, 16, 0, "float32", True),
    (2, 1000, 1000, 16, 0, "float32", False),
]
KERNELS = {
    "q8_matvec": dict(source="src/repro_torch/csrc/q8_matvec.cu",
                      replaces="src/repro/kernels/q8_matvec.py:68",
                      shapes={"decode step": MATVEC_SHAPES},
                      library_call="torch.matmul(x_f32, W_dequantized_f32.T):"
                                   " no single PyTorch call computes a Q8_0 "
                                   "product"),
    "q8_matmul": dict(source="src/repro_torch/csrc/q8_matmul.cu",
                      replaces="src/repro/kernels/q8_matmul.py:87",
                      shapes={"prefill": MATMUL_SHAPES},
                      library_call="torch.matmul(x_f32, W_dequantized_f32.T):"
                                   " no single PyTorch call computes a Q8_0 "
                                   "product"),
    "bf16_matmul": dict(source="src/repro_torch/csrc/bf16_matmul.cu",
                        replaces="src/repro/kernels/bf16_matmul.py:76",
                        shapes={"prefill": BF16_PREFILL_SHAPES,
                                "decode step": BF16_STEP_SHAPES},
                        library_call="torch.mm(x_bf16, W_bf16.T, out_dtype="
                                     "torch.float32) on the same strided "
                                     "bf16 operands (cuBLAS, f32 output as "
                                     "the kernel's); library_bf16_out_ms: "
                                     "torch.matmul with a bf16 output"),
    "flash_attention_fwd": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:94",
        shapes={"prefill": FLASH_SHAPES},
        library_call="torch.nn.functional.scaled_dot_product_attention on "
                     "the same bf16 q, k, v as (1, BH, S, D) (bf16 output; "
                     "the kernel writes f32)"),
}
MAX_NEW = 32
PROFILED_STEPS = 8               # decode steps under torch.profiler
CAPTURE_PASSES = 2               # Python runs a program twice: warm-up, capture
REQUESTS = 4                     # captured requests held against eager ones
PAPER_TOKENS = 27                # the paper's jfk.wav transcript (enumerate_whisper)
POWER_S = 5.0                    # seconds of transcripts under the power sampler
# substrings of the names of dot-product kernels: the port's, and cuBLAS's
DOT_KERNEL_WORDS = ("q8_matvec", "q8_matmul", "gemv", "gemm",
                    "wgmma_kernel", "tiled_kernel", "flash_fwd", "xmma",
                    "cutlass")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def wall_ms(fn, iters: int = 50) -> float:
    """CUDA-event time per call of back-to-back calls after a warm-up. It
    includes the host's launch cost wherever the host, not the card, is
    the slower of the two."""
    import torch
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_total_us(prof) -> float:
    return sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages())


def device_us(prof) -> float:
    """Summed device time (µs) of every kernel and copy a profile saw.
    Raises if the profiler saw none: a wall-clock time is not a device
    time."""
    total = _device_total_us(prof)
    if not total > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total


def device_ms(fn, iters: int = 20, attempts: int = 3) -> float:
    """Device time per call: the card's own time in the kernels one call
    launches (torch.profiler, CUPTI), without the host's launch cost. A
    profiled window in which CUPTI delivered no kernel record (seen once in
    a run of short windows) is profiled again, up to ``attempts`` times,
    then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = _device_total_us(prof)
        if total > 0:
            return total / 1e3 / iters
        print("torch.profiler recorded no device time; profiling again",
              flush=True)
    raise RuntimeError("torch.profiler recorded no device time")


def bound(bytes_ms: float, ops_ms: float):
    """Least time of work whose bytes take ``bytes_ms`` at the memory rate
    and whose operations take ``ops_ms`` at the peak for their type: the
    larger of the two. Returns (ms, 'bytes'|'operations')."""
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


def _q8_case(gen, m, n, k, k_full, xdt):
    """Operands of a Q8_0 kernel at one shape: (kernel args, library
    call, bytes moved, FLOPs, FLOP rate key, further yardsticks by the
    name of their time)."""
    import torch
    from repro_torch.core.qformats import QTensor, quantize_q8_0
    dtype = getattr(torch, xdt)
    x_full = torch.randn((m, k_full), generator=gen, device="cuda").to(dtype)
    w = torch.randn((n, k_full), generator=gen, device="cuda") * 0.05
    wq = quantize_q8_0(w)
    main = QTensor(wq.qs[:, :k // 32], wq.scales[:, :k // 32])
    args = (x_full[:, :k], main.flat_qs(), main.scales)
    w_deq = (main.qs.float() * main.scales[..., None]).reshape(n, k
                                                              ).contiguous()
    x32 = args[0].float().contiguous()
    # each input read once (x, int8 qs, f32 scales), output written once
    moved = m * k * x_full.element_size() + n * k + (n * k // 32) * 4 \
        + m * n * 4
    return args, lambda: torch.matmul(x32, w_deq.t()), moved, \
        2 * m * n * k, xdt, {}


def _bf16_case(gen, m, n, k, k_full, xdt):
    """Operands of bf16_matmul at one shape: the first k of k_full columns
    of x and a bf16 W, as the burst split hands them over. The library
    call writes f32, as the kernel does; the bf16-output call is kept
    beside it."""
    import torch
    x_full = torch.randn((m, k_full), generator=gen, device="cuda").to(
        getattr(torch, xdt))
    w_full = (torch.randn((n, k_full), generator=gen, device="cuda") * 0.05
              ).to(torch.bfloat16)
    x, w = x_full[:, :k], w_full[:, :k]
    xb = x.to(torch.bfloat16)
    moved = m * k * x.element_size() + n * k * 2 + m * n * 4
    return (x, w), lambda: torch.mm(xb, w.t(), out_dtype=torch.float32), \
        moved, 2 * m * n * k, "bfloat16", \
        {"library_bf16_out_ms": lambda: torch.matmul(xb, w.t())}


def _flash_case(gen, bh, sq, sk, d, dt):
    """q, k, v of flash_attention_fwd as the encoder hands them over: the
    (B, S, H, D) projections folded to (B*H, S, D) views."""
    import torch
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn((1, s, bh, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2).reshape(bh, s, d) for s in (sq, sk, sk))
    size = q.element_size()
    moved = (bh * sq * d + 2 * bh * sk * d) * size + bh * sq * d * 4
    q4, k4, v4 = (t.contiguous()[None] for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return (q, k, v), lambda: sdpa(q4, k4, v4), moved, \
        4 * bh * sq * sk * d, dt, {}


def _measure(name, label, kernel, plain, library, moved, flops, rate, tol,
             extra):
    """Kernel against plain at one shape, then the times and the bound, and
    the device time of each further yardstick in ``extra``. ``tol`` is
    relative to the plain output's largest value (at least 1)."""
    import torch
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    lim = tol * max(1.0, want.abs().max().item())
    if not err <= lim:
        raise AssertionError(f"{name} {label}: max |kernel - plain| = {err} "
                             f"> {lim}")
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FLOPS_PER_S[rate] * 1e3
    b_ms, b_by = bound(bytes_ms, ops_ms)
    return dict(max_abs_err=err, bytes=moved, flops=flops,
                bytes_ms=bytes_ms, ops_ms=ops_ms, ms=device_ms(kernel),
                wall_ms=wall_ms(kernel), plain_ms=device_ms(plain),
                library_ms=device_ms(library), bound_ms=b_ms, bound_by=b_by,
                **{key: device_ms(fn) for key, fn in extra.items()})


def check_kernels():
    """Phase 2: every kernel against its plain version at the main paths'
    shapes, with its times and bound, and the extra flash checks. Returns
    the per-kernel records."""
    import torch
    from repro_torch.kernels import (
        bf16_matmul, flash_attention, q8_matmul, q8_matvec)

    mods = {"q8_matvec": (q8_matvec.q8_matvec, q8_matvec.q8_matvec_plain,
                          _q8_case),
            "q8_matmul": (q8_matmul.q8_matmul, q8_matmul.q8_matmul_plain,
                          _q8_case),
            "bf16_matmul": (bf16_matmul.bf16_matmul,
                            bf16_matmul.bf16_matmul_plain, _bf16_case)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    for name, meta in KERNELS.items():
        rows = []
        for per, shapes in meta["shapes"].items():
            for shape in shapes:
                if name == "flash_attention_fwd":
                    bh, sq, sk, d, count, dt, causal = shape
                    args, library, moved, flops, rate, extra = _flash_case(
                        gen, bh, sq, sk, d, dt)
                    kw = dict(causal=causal)
                    kernel = flash_attention.flash_attention_fwd
                    plain = flash_attention.flash_attention_fwd_plain
                    tol = FLASH_BF16_TOL if dt == "bfloat16" else KERNEL_TOL
                    label = (f"bh={bh} sq={sq} sk={sk} d={d} {dt} "
                             f"causal={causal}")
                    dims = dict(bh=bh, sq=sq, sk=sk, d=d, dtype=dt,
                                causal=causal)
                else:
                    m, n, k, k_full, count, xdt = shape
                    kernel, plain, case = mods[name]
                    args, library, moved, flops, rate, extra = case(
                        gen, m, n, k, k_full, xdt)
                    kw = {}
                    tol = KERNEL_TOL
                    label = f"m={m} n={n} k={k} x={xdt}"
                    dims = dict(m=m, n=n, k=k, x=xdt)
                row = _measure(name, label,
                               lambda: kernel(*args, **kw),
                               lambda: plain(*args, **kw),
                               library, moved, flops, rate, tol, extra)
                row.update(dims, per=per, per_step=count)
                print(f"kernel {name} {label} x{count} per {per}: "
                      f"max_abs_err={row['max_abs_err']:.3e} "
                      f"ms={row['ms']:.5f} wall_ms={row['wall_ms']:.5f} "
                      f"plain_ms={row['plain_ms']:.5f} "
                      f"library_ms={row['library_ms']:.5f} "
                      + "".join(f"{key}={row[key]:.5f} " for key in extra)
                      + f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})",
                      flush=True)
                rows.append(row)
        records[name] = rows
    for bh, sq, sk, d, _, dt, causal in FLASH_CHECKS:
        (q, k, v), *_ = _flash_case(gen, bh, sq, sk, d, dt)
        got = flash_attention.flash_attention_fwd(q, k, v, causal=causal)
        want = flash_attention.flash_attention_fwd_plain(q, k, v,
                                                         causal=causal)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = FLASH_BF16_TOL if dt == "bfloat16" else KERNEL_TOL
        print(f"check flash_attention_fwd bh={bh} sq={sq} sk={sk} d={d} "
              f"{dt} causal={causal}: max_abs_err={err:.3e} (tolerance "
              f"{tol})", flush=True)
        if not err <= tol * max(1.0, want.abs().max().item()):
            raise AssertionError(f"flash_attention_fwd check failed: {err}")
    return records


def check_against_cpu(cfg, params_cpu, mel, card_logits, sot,
                      tol=FIRST_STEP_TOL):
    """The first decode step's logits on the CPU, same weights and mel,
    against the card's; the greedy token must agree wherever the CPU's
    top-1/top-2 margin exceeds twice the tolerance. Tolerance
    FIRST_STEP_TOL: whisper-tiny runs its encoder in bf16, and a sum that
    differs in its last f32 bits between card and CPU can round to a
    neighbouring bf16 value (a relative step of 2^-8) and carry through
    the layers; logits are of O(1). The dense path passes
    DENSE_FIRST_STEP_TOL."""
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params_cpu, max_len=MAX_NEW + 8,
                      offload=OffloadEngine(), eos_id=None, device="cpu")
    _, state = eng.prefill(torch.from_numpy(mel))
    cpu_logits, _ = eng.step(torch.full((1, 1), sot), state)
    diff = (card_logits.cpu() - cpu_logits).abs().max().item()
    print(f"first step logits card vs cpu: max_abs_err={diff:.3e} "
          f"(tolerance {tol}), |logits|max="
          f"{cpu_logits.abs().max().item():.3f}", flush=True)
    if not diff <= tol:
        raise AssertionError(f"card and CPU first-step logits differ by {diff}")
    top2 = cpu_logits[0, -1, :cfg.vocab_size].topk(2).values
    if (top2[0] - top2[1]).item() > 2 * tol and int(
            cpu_logits[0, -1, :cfg.vocab_size].argmax()) != int(
            card_logits[0, -1, :cfg.vocab_size].argmax()):
        raise AssertionError("card and CPU pick different first tokens")
    return diff


def _top_kernels(prof, per: int, top: int):
    """The ``top`` kernels of a profile by device time: (name, launches,
    device ms), each divided by ``per``."""
    events = sorted(prof.key_averages(),
                    key=lambda e: getattr(e, "self_device_time_total", 0.0),
                    reverse=True)[:top]
    return [(e.key[:80], e.count // per,
             getattr(e, "self_device_time_total", 0.0) / 1e3 / per)
            for e in events]


def _by_kernel(prof, per: int = 1):
    """Each kernel a profile saw on the device: {name: (launches, device
    ms)}, the launches and time divided by ``per``."""
    return {e.key: (e.count / per,
                    getattr(e, "self_device_time_total", 0.0) / 1e3 / per)
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0}


def by_route(kernels, routes):
    """Launches and device ms of each route in ``kernels`` (``_by_kernel``'s
    map), summed over the kernels whose name holds the route's name."""
    return {route: tuple(sum(v[j] for key, v in kernels.items()
                             if route in key) for j in (0, 1))
            for route in routes}


def where_time_goes(eng, mel, vocab: int, steps: int = PROFILED_STEPS):
    """One prefill and ``steps`` decode steps under torch.profiler: device
    time (summed kernel time) against host wall time, the device's idle
    share, and each phase's largest kernels. Returns the summary and each
    phase's kernels by name (``_by_kernel``, the decode's per step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    mel_t = torch.from_numpy(mel).cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, state = eng.prefill(mel_t)
        torch.cuda.synchronize()
        pre_wall = (time.perf_counter() - t0) * 1e3
    pre_dev = device_us(prof) / 1e3
    pre_top = _top_kernels(prof, 1, 12)
    pre_kernels = _by_kernel(prof)
    tok = torch.full((1, 1), 1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, state = eng.step(tok, state)
            tok = logits[:, -1, :vocab].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        dec_wall = (time.perf_counter() - t0) * 1e3 / steps
    dec_dev = device_us(prof) / 1e3 / steps
    out = dict(prefill_wall_ms=pre_wall, prefill_device_ms=pre_dev,
               prefill_idle_share=1 - pre_dev / pre_wall,
               prefill_top_kernels=pre_top,
               decode_wall_ms_per_step=dec_wall,
               decode_device_ms_per_step=dec_dev,
               decode_idle_share=1 - dec_dev / dec_wall,
               decode_top_kernels=_top_kernels(prof, steps, 8))
    print(f"where the time goes (profiled): {json.dumps(out)}", flush=True)
    return out, pre_kernels, _by_kernel(prof, steps)


def eager_transcribe(eng, mel, max_new: int, sot: int = 1):
    """The eager greedy loop through the engine's public ``prefill`` and
    ``step`` (every kernel launched from Python, so the launch counts are
    Python's): one host sync a step, as in ``transcribe``, and no EOS stop
    (the engines here have ``eos_id=None``). Returns (tokens per row,
    prefill s, decode s)."""
    import torch
    mel_t = torch.from_numpy(mel).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state = eng.prefill(mel_t)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.full((mel.shape[0], 1), sot, device="cuda")
    toks = []
    t0 = time.perf_counter()
    for _ in range(max_new):
        logits, state = eng.step(tok, state)
        tok = eng._argmax(logits[:, -1])[:, None]
        toks.append(tok)
    rows = torch.cat(toks, dim=1).cpu().tolist()
    return rows, prefill_s, time.perf_counter() - t0


def main_path():
    """Phase 3: full-width whisper-tiny Q8_0 transcribe on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.kernels import q8_matmul, q8_matvec
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("whisper-tiny")
    params_cpu = model.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    mel = np.random.default_rng(1).standard_normal(
        (1, cfg.encoder_ctx, cfg.n_mels)).astype(np.float32)
    offload = OffloadEngine()
    eng = ServeEngine(cfg, params_cpu, max_len=MAX_NEW + 8, offload=offload,
                      eos_id=None, device="cuda")
    eager_transcribe(eng, mel, 2)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    q8_matmul.q8_matmul.launches = 0
    q8_matvec.q8_matvec.launches = 0
    (tokens,), prefill_s, decode_s = eager_transcribe(eng, mel, MAX_NEW)
    launches = {"q8_matmul": q8_matmul.q8_matmul.launches,
                "q8_matvec": q8_matvec.q8_matvec.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: whisper-tiny q8_0 eager greedy loop 1x"
          f"{cfg.encoder_ctx} frames, {len(tokens)} tokens: prefill_ms="
          f"{prefill_s * 1e3:.3f} decode_ms_per_token="
          f"{decode_s * 1e3 / MAX_NEW:.3f} peak_mem_bytes={peak} "
          f"launches={launches}", flush=True)
    print(f"main path tokens: {tokens}", flush=True)
    if len(tokens) != MAX_NEW:
        raise AssertionError(f"expected {MAX_NEW} tokens, got {len(tokens)}")
    if not all(0 <= t < cfg.vocab_size for t in tokens):
        raise AssertionError("token outside the vocabulary")
    if launches != {"q8_matmul": 32, "q8_matvec": 33 * MAX_NEW}:
        raise AssertionError(f"launch counts {launches}: expected 32 "
                             f"q8_matmul and {33 * MAX_NEW} q8_matvec")

    sot = 1
    _, state = eng.prefill(torch.from_numpy(mel).cuda())
    card_logits, _ = eng.step(torch.full((1, 1), sot, device="cuda"), state)
    if not torch.isfinite(card_logits).all():
        raise AssertionError("non-finite logits on the card")
    if int(card_logits[0, -1, :cfg.vocab_size].argmax()) != tokens[0]:
        raise AssertionError("first-step argmax differs from the loop's")
    err = check_against_cpu(cfg, params_cpu, mel, card_logits, sot)
    split, pre_kernels, _ = where_time_goes(eng, mel, cfg.vocab_size)
    routes = {route: launches for route, (launches, _) in by_route(
        pre_kernels, ("q8_wgmma_kernel", "q8_matmul_kernel")).items()}
    print(f"main path prefill q8_matmul launches by kernel: {routes}",
          flush=True)
    if routes != {"q8_wgmma_kernel": 32, "q8_matmul_kernel": 0}:
        raise AssertionError(f"prefill q8_matmul kernels {routes}: expected "
                             "32 tensor-core launches and no SIMT one")
    return launches, dict(prefill_ms=prefill_s * 1e3,
                          decode_ms_per_token=decode_s * 1e3 / MAX_NEW,
                          peak_mem_bytes=peak, first_step_cpu_err=err,
                          **split), (eng, mel, tokens, split)


def batch2_routing():
    """Phase 4: batch 2 at full width. The encoder's ffn.down (M = 3000,
    K = 1536) fails the reference's local-memory rule, so its plan entries
    say offload=False; every Q8_0 linear must launch a kernel all the
    same. These launches are the phase's own: the main path's counts have
    been read already."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.kernels import q8_matmul, q8_matvec
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("whisper-tiny")
    params = model.init_params(torch.Generator().manual_seed(2), cfg,
                               device="cpu")
    mel = np.random.default_rng(3).standard_normal(
        (2, cfg.encoder_ctx, cfg.n_mels)).astype(np.float32)
    eng = ServeEngine(cfg, params, max_len=8, offload=OffloadEngine(),
                      eos_id=None, device="cuda")
    max_new = 2
    res = eng.transcribe(mel, max_new=max_new)        # captured: its plans
    q8_matmul.q8_matmul.launches = q8_matvec.q8_matvec.launches = 0
    rows, _, _ = eager_transcribe(eng, mel, max_new)
    torch.cuda.synchronize()
    got = {"q8_matmul": q8_matmul.q8_matmul.launches,
           "q8_matvec": q8_matvec.q8_matvec.launches}
    pre, step = (
        [e for e in eng._plans.plans[(phase, "q8_0", 2,
                                      cfg.encoder_ctx)].entries
         if e.dtype == "q8_0" and e.k_main]
        for phase in ("prefill", "step"))
    fallbacks = sum(not e.offload for e in pre)
    want = {"q8_matmul": len(pre), "q8_matvec": max_new * len(step)}
    print(f"batch 2: {len(pre)} q8_0 prefill linears ({fallbacks} with "
          f"offload=False), {len(step)} per step; launches={got}",
          flush=True)
    if got != want or fallbacks == 0 or len(pre) != 32:
        raise AssertionError(f"batch 2 launches {got}, expected {want} "
                             f"with some offload=False entries")
    if [r.steps for r in res] != [max_new, max_new]:
        raise AssertionError("batch 2 did not decode every row")
    if [r.tokens for r in res] != rows:
        raise AssertionError(f"batch 2 captured tokens "
                             f"{[r.tokens for r in res]} != eager {rows}")


def dense_flash_path():
    """Phase 5: full-width whisper-tiny with bf16 weights (quant="none")
    and attn_impl="flash": the same transcribe as the main path, every
    dense main segment on bf16_matmul and every encoder attention on
    flash_attention_fwd."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.kernels import (
        bf16_matmul, flash_attention, q8_matmul, q8_matvec)
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine

    counted = {"bf16_matmul": bf16_matmul.bf16_matmul,
               "flash_attention_fwd": flash_attention.flash_attention_fwd,
               "q8_matmul": q8_matmul.q8_matmul,
               "q8_matvec": q8_matvec.q8_matvec}
    cfg = dataclasses.replace(get_config("whisper-tiny"), quant="none",
                              attn_impl="flash")
    params_cpu = model.init_params(torch.Generator().manual_seed(4), cfg,
                                   device="cpu")
    mel = np.random.default_rng(5).standard_normal(
        (1, cfg.encoder_ctx, cfg.n_mels)).astype(np.float32)
    eng = ServeEngine(cfg, params_cpu, max_len=MAX_NEW + 8,
                      offload=OffloadEngine(), eos_id=None, device="cuda")
    eager_transcribe(eng, mel, 2)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    (tokens,), prefill_s, decode_s = eager_transcribe(eng, mel, MAX_NEW)
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"dense+flash path: whisper-tiny bf16 eager greedy loop 1x"
          f"{cfg.encoder_ctx} frames, {len(tokens)} tokens: prefill_ms="
          f"{prefill_s * 1e3:.3f} decode_ms_per_token="
          f"{decode_s * 1e3 / MAX_NEW:.3f} peak_mem_bytes={peak} "
          f"launches={launches}", flush=True)
    print(f"dense+flash path tokens: {tokens}", flush=True)
    if len(tokens) != MAX_NEW:
        raise AssertionError(f"expected {MAX_NEW} tokens, got {len(tokens)}")
    if not all(0 <= t < cfg.vocab_size for t in tokens):
        raise AssertionError("token outside the vocabulary")
    want = {"bf16_matmul": 32 + 33 * MAX_NEW,
            "flash_attention_fwd": cfg.num_encoder_layers,
            "q8_matmul": 0, "q8_matvec": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches}: expected {want}")

    sot = 1
    _, state = eng.prefill(torch.from_numpy(mel).cuda())
    card_logits, _ = eng.step(torch.full((1, 1), sot, device="cuda"), state)
    if not torch.isfinite(card_logits).all():
        raise AssertionError("non-finite logits on the card")
    if int(card_logits[0, -1, :cfg.vocab_size].argmax()) != tokens[0]:
        raise AssertionError("first-step argmax differs from the loop's")
    err = check_against_cpu(cfg, params_cpu, mel, card_logits, sot,
                            tol=DENSE_FIRST_STEP_TOL)
    split, _, dec_kernels = where_time_goes(eng, mel, cfg.vocab_size)
    routes = by_route(dec_kernels, ("gemv_bf16_kernel", "matvec_kernel"))
    print(f"dense decode step bf16_matmul by kernel (launches, device ms "
          f"per step): {routes}", flush=True)
    if {route: launches for route, (launches, _) in routes.items()} != {
            "gemv_bf16_kernel": 33, "matvec_kernel": 0}:
        raise AssertionError(f"decode-step bf16_matmul kernels {routes}: "
                             "expected 33 gemv_bf16_kernel launches a step "
                             "and no matvec_kernel")
    return launches, dict(prefill_ms=prefill_s * 1e3,
                          decode_ms_per_token=decode_s * 1e3 / MAX_NEW,
                          peak_mem_bytes=peak, first_step_cpu_err=err,
                          decode_bf16_matmul_device_ms_per_step=routes[
                              "gemv_bf16_kernel"][1], **split), \
        (eng, mel, tokens, split)


def _stats(offload):
    """The ledger's totals as a flat dict (counters and per-name counts)."""
    import dataclasses
    return dataclasses.asdict(offload.stats)


def _ledger_delta(after, before):
    return {key: ({k: v - before[key].get(k, 0) for k, v in val.items()}
                  if isinstance(val, dict) else val - before[key])
            for key, val in after.items()}


def dot_share(kernels) -> float:
    """Share of a profile's device time in dot-product kernels (``_by_kernel``
    map): the port's kernels and cuBLAS's (the residual arm's products and
    the attention's score and value products, which ggml also runs as
    mul_mat)."""
    total = sum(ms for _, ms in kernels.values())
    dots = sum(ms for name, (_, ms) in kernels.items()
               if any(word in name for word in DOT_KERNEL_WORDS))
    return dots / total


def captured_path(label, eng, mel, eager_tokens, eager_split, counted,
                  per_run, replay_kernels, share_key):
    """Phase 6, on one path: captured ``transcribe`` of 1 x 1500 frames, its
    tokens against the eager loop's on the same engine, the launches from
    Python at capture (CAPTURE_PASSES runs of each program's Python) and
    none at replay, no recapture at a repeated key, the ledger after
    REQUESTS requests against REQUESTS eager requests, and the profiled
    replays beside the eager split of the same run."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.amdahl import PAPER_SHARE, amdahl_bound

    f = eng.cfg.encoder_ctx
    for fn in counted.values():
        fn.launches = 0
    res = eng.transcribe(mel, max_new=MAX_NEW)    # captures, then replays
    torch.cuda.synchronize()
    got = {name: fn.launches for name, fn in counted.items()}
    want = {name: CAPTURE_PASSES * per_run.get(name, 0) for name in counted}
    print(f"captured {label}: launches from Python at capture {got} "
          f"(expected {want}); step captures {eng._step_captures}",
          flush=True)
    if got != want:
        raise AssertionError(f"{label}: capture launches {got} != {want}")
    if res[0].tokens != eager_tokens:
        raise AssertionError(f"{label}: captured tokens {res[0].tokens} != "
                             f"eager {eager_tokens}")

    before = _stats(eng.offload)
    eager_transcribe(eng, mel, MAX_NEW)
    one = _ledger_delta(_stats(eng.offload), before)
    for fn in counted.values():
        fn.launches = 0
    before = _stats(eng.offload)
    results = [eng.transcribe(mel, max_new=MAX_NEW)[0]
               for _ in range(REQUESTS)]
    delta = _ledger_delta(_stats(eng.offload), before)
    got = {name: fn.launches for name, fn in counted.items()}
    scaled = {key: ({k: v * REQUESTS for k, v in val.items()}
                    if isinstance(val, dict) else val * REQUESTS)
              for key, val in one.items()}
    print(f"captured {label}: {REQUESTS} more requests: launches from "
          f"Python {got}, step captures {eng._step_captures}, ledger "
          f"{json.dumps(delta, sort_keys=True)}", flush=True)
    if any(got.values()):
        raise AssertionError(f"{label}: replays launched from Python: {got}")
    if eng._step_captures != 1:
        raise AssertionError(f"{label}: {eng._step_captures} step captures "
                             "at one key")
    if delta != scaled:
        raise AssertionError(f"{label}: ledger after {REQUESTS} requests "
                             f"{delta} != {REQUESTS} x one eager request's "
                             f"{one}")
    for r in results:
        if r.tokens != eager_tokens:
            raise AssertionError(f"{label}: a replayed request's tokens "
                                 f"{r.tokens} != eager {eager_tokens}")
    prefill_ms = statistics.median(r.prefill_s for r in results) * 1e3
    decode_ms = statistics.median(r.decode_s for r in results) * 1e3 / MAX_NEW

    # one replayed prefill and PROFILED_STEPS replayed steps, each step
    # with transcribe's host sync
    st = eng._static[(1, f)]
    pre_key, step_key = eng._key("prefill", 1, f), eng._key("step", 1, f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._run(pre_key, None)
        torch.cuda.synchronize()
        pre_wall = (time.perf_counter() - t0) * 1e3
    pre_kernels, pre_top = _by_kernel(prof), _top_kernels(prof, 1, 8)
    st.token.fill_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            eng._run(step_key, None)
            bool(st.done.all())
        torch.cuda.synchronize()
        dec_wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    dec_kernels = _by_kernel(prof, PROFILED_STEPS)
    out = dict(prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
               prefill_wall_ms=pre_wall, decode_wall_ms_per_step=dec_wall,
               eager=eager_split)
    if not (pre_kernels and dec_kernels):
        print(f"captured {label}: the profiler saw no kernels inside the "
              f"replays; launches per replay from the capture pass: "
              f"{per_run}", flush=True)
        out.update(replay_launches="not measured: profiler saw no replay",
                   prefill_device_ms=None, decode_device_ms_per_step=None)
    else:
        pre_dev = sum(ms for _, ms in pre_kernels.values())
        dec_dev = sum(ms for _, ms in dec_kernels.values())
        launches = {phase: {name: launches for name, (launches, _) in
                            by_route(kernels, replay_kernels[phase]).items()}
                    for phase, kernels in (("prefill", pre_kernels),
                                           ("step", dec_kernels))}
        share = dot_share(dec_kernels)
        # the profiler's records of a replay's kernels slow the replay's
        # host side, so idle shares are also given against the unprofiled
        # requests' times
        out.update(prefill_device_ms=pre_dev,
                   prefill_idle_share=1 - pre_dev / pre_wall,
                   prefill_idle_share_unprofiled=1 - pre_dev / prefill_ms,
                   decode_device_ms_per_step=dec_dev,
                   decode_idle_share=1 - dec_dev / dec_wall,
                   decode_idle_share_unprofiled=1 - dec_dev / decode_ms,
                   replay_launches=launches,
                   prefill_top_kernels=pre_top,
                   decode_top_kernels=_top_kernels(prof, PROFILED_STEPS, 8),
                   step_dot_share=share, step_amdahl_bound=amdahl_bound(share),
                   paper_share=PAPER_SHARE[share_key],
                   paper_amdahl_bound=amdahl_bound(PAPER_SHARE[share_key]))
        if launches != replay_kernels:
            raise AssertionError(f"{label}: kernels per replay {launches} != "
                                 f"{replay_kernels}")
    print(f"captured {label} summary: {json.dumps(out)}", flush=True)
    return out


def power_pdp(label, eng, mel, paper_path):
    """Phase 7, on one path: ``transcribe`` of 1500 frames and PAPER_TOKENS
    tokens (the paper's workload) over and over for POWER_S seconds while
    ``nvidia-smi`` samples the card's draw every 100 ms; PDP at the mean
    draw and at the power limit, beside the paper's whisper-tiny rows."""
    import statistics

    import torch
    from repro_torch.core import energy

    eng.transcribe(mel, max_new=PAPER_TOKENS)          # same keys: no capture
    torch.cuda.synchronize()
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=power.draw",
         "--format=csv,noheader,nounits", "-lms", "100", "-i", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    results = []
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < POWER_S:
            results += eng.transcribe(mel, max_new=PAPER_TOKENS)
    finally:
        sampler.terminate()
        out, err = sampler.communicate(timeout=30)
    watts = []
    for line in out.splitlines():
        try:
            watts.append(float(line))
        except ValueError:
            pass
    if not watts:
        raise RuntimeError(f"{label}: nvidia-smi gave no power samples "
                           f"({err.strip()[:200]})")
    if any(r.steps != PAPER_TOKENS for r in results):
        raise AssertionError(f"{label}: a transcript stopped early")
    kind = torch.cuda.get_device_name(0)
    limit = energy.card_power_limit_w(0)
    mean_s = statistics.fmean(r.total_s for r in results)
    drawn = energy.card_report(mean_s, statistics.fmean(watts), kind)
    at_limit = energy.card_report(mean_s, limit, kind)
    paper = {f"{p}_{plat}": energy.PAPER_PDP_J[("tiny", p, plat)]
             for p, plat in (("q8_0", "imax"), ("q8_0", "jetson"),
                             ("q8_0", "rtx4090"), ("fp16", "imax"),
                             ("fp16", "jetson"))}
    rep = dict(path=label, paper_path=paper_path, transcripts=len(results),
               frames=mel.shape[1], tokens=PAPER_TOKENS,
               transcript_mean_s=mean_s,
               transcript_median_s=statistics.median(
                   r.total_s for r in results),
               prefill_mean_s=statistics.fmean(r.prefill_s for r in results),
               samples=len(watts), draw_mean_w=statistics.fmean(watts),
               draw_min_w=min(watts), draw_max_w=max(watts),
               power_limit_w=limit, pdp_at_draw_j=drawn.pdp_j,
               edp_at_draw_js=drawn.edp_js, pdp_at_limit_j=at_limit.pdp_j,
               energy_report_at_limit=eng.energy_report(results, limit),
               paper_pdp_j=paper)
    print(f"power {label}: {json.dumps(rep)}", flush=True)
    return rep


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build

    resolve_device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    logs = _build.build(list(KERNELS))
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            # (C75..): ptxas's notes on serialized or waited-for wgmma
            if any(word in line for word in (
                    "Compiling entry", "Used", "spill", "(C75")):
                print(f"  {name}: {line.strip()}")

    records = check_kernels()
    launches, path, (q8_eng, q8_mel, q8_tokens, q8_split) = main_path()
    print(f"main path summary: {json.dumps(path)}", flush=True)
    batch2_routing()
    dense_launches, dense, (d_eng, d_mel, d_tokens, d_split) = \
        dense_flash_path()
    print(f"dense+flash path summary: {json.dumps(dense)}", flush=True)
    launches.update((k, dense_launches[k])
                    for k in ("bf16_matmul", "flash_attention_fwd"))

    from repro_torch.configs import get_config
    from repro_torch.core.coverage import coverage_cdf, enumerate_whisper
    from repro_torch.kernels import (
        bf16_matmul, flash_attention, q8_matmul, q8_matvec)
    counted = {"bf16_matmul": bf16_matmul.bf16_matmul,
               "flash_attention_fwd": flash_attention.flash_attention_fwd,
               "q8_matmul": q8_matmul.q8_matmul,
               "q8_matvec": q8_matvec.q8_matvec}
    captured_path("q8_0", q8_eng, q8_mel, q8_tokens, q8_split, counted,
                  {"q8_matmul": 32, "q8_matvec": 33},
                  {"prefill": {"q8_wgmma_kernel": 32},
                   "step": {"q8_matvec_kernel": 33}}, "q8_0")
    captured_path("dense+flash", d_eng, d_mel, d_tokens, d_split, counted,
                  {"bf16_matmul": 32 + 33, "flash_attention_fwd": 4},
                  {"prefill": {"wgmma_kernel": 32, "flash_fwd_mma_kernel": 4},
                   "step": {"gemv_bf16_kernel": 33}}, "fp16")
    power_pdp("q8_0", q8_eng, q8_mel, "q8_0")
    power_pdp("dense+flash", d_eng, d_mel, "fp16")
    cdf = coverage_cdf(enumerate_whisper(get_config("whisper-tiny")))
    print(f"coverage whisper-tiny (LMM KB, baseline, optimized): "
          f"{json.dumps(cdf)}", flush=True)

    kernels = []
    for name, meta in KERNELS.items():
        rows = records[name]

        def total(key, per=None):   # over one prefill and/or decode step
            return sum(r[key] * r["per_step"] for r in rows
                       if per in (None, r["per"]))
        b_ms, b_by = bound(total("bytes_ms"), total("ops_ms"))
        # further yardsticks' times (bf16_matmul's bf16-output call)
        extras = [key for key in rows[0]
                  if key.startswith("library_") and key != "library_ms"]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=total("library_ms"),
            library_call=meta["library_call"],
            per=" + one ".join(meta["shapes"]),
            **{key: total(key) for key in extras},
            by_phase={per: {key: total(key, per) for key in (
                "ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms",
                *extras)}
                for per in meta["shapes"]},
            shapes=rows))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
