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
   warm L2; CUDA events over a captured graph where three profiled
   windows recorded none, said on its line) and its back-to-back time per
   call (CUDA events, which include the host's launch cost), the plain
   version's device time, the least
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
   ragged lengths. The decode kernels are also held against their plain
   versions at M = 4, the continuous-batching slot step's (their MT = 4
   instantiations), in rows of their own (``per`` "slot decode step"):
   those show in the kernels line's ``by_phase`` and ``shapes`` but not in
   its top-level times, which sum one prefill and one batch-1 decode step.
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
   profiler, each window opened by a spin kernel and profiled again (up
   to 3 times) where its kernels differ from the graphs' (device time,
   idle share, kernels by name, which must be 32 ``q8_wgmma_kernel`` a
   prefill and 33 ``q8_matvec_kernel`` a step on Q8_0; 32
   ``wgmma_kernel`` + 4 ``flash_fwd_mma_kernel`` and 33
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
9. Tuning (the autotuner and its calibrated cost model):
   a. every admissible launch tile of ``q8_matmul``, ``q8_matvec`` and
      ``bf16_matmul`` at whisper-tiny's shapes (K whole, as a tuned burst
      leaves it, and the frontend's K = 80) against the plain version
      (KERNEL_TOL of the largest output), with its device time beside the
      default launch's;
   b. ``Autotuner(mode="measured")`` warmed over ``warm_tuning``'s shapes
      on both paths; every admissible launch of each shape replayed and
      ``hopper`` coefficients fitted (``calibrate.fit_backend``); the
      coefficients, their median relative error, and the rank
      correlation of the analytic and of the calibrated costs with the
      measured ones (pooled, and the mean within a shape); the cache and
      its calibration saved under ``build/tuning/``;
   c. the Fig 7/10-style grid: measured cost and PDP at the power limit
      of the best launch at each (shared-memory budget, burst) cell for
      ``q8_matmul`` at enc.ffn.up (1500 x 1536 x 384), beside the untuned
      split (burst 256: the kernel at K = 256 and the host arm at 128);
   d. both paths served tuned: an engine with the tuner, its eager loop
      (launch counts: 32 ``q8_matmul`` + 1 ``bf16_matmul`` (the frontend,
      K = 80, which the untuned burst left on the host arm) a prefill and
      33 ``q8_matvec`` a step; dense 33 + 33 ``bf16_matmul`` and 4 flash),
      its first-step logits against the untuned engine's (1e-2 Q8_0, 3e-2
      dense), then phase 6 on it: captured tokens equal the tuned eager
      loop's, prefill ms, decode ms a token, device time and kernels a
      replay by name; the residual-arm linears a replay (from the plans;
      0 at every K = 384 linear) beside the untuned engine's, and the
      cuBLAS launches the profiler saw in each.
10. Continuous batching, on each path's weights (a new engine: max_len 56,
    no EOS): the scheduler over a pool of 4 slots at 1500 frames, with the
    workload of ``benchmarks/continuous_batching.py`` (16 requests, max_new
    in 6-48 from default_rng(0); dense + flash: 6), a first wave, then the
    rest submitted mid-drain. The launch counts are zeroed just before and
    read just after: the pool's first admission captures the batch-1
    prefill and the slot step (twice each program's launches), and nothing
    after launches from Python. Fails unless the step captures stay put
    after the pool's first step, the ledger's commits equal admissions plus
    slot steps, per-request PDP sums to the batch's (rel 1e-9), every
    request's tokens equal a batch-1 ``transcribe`` of its mel, a free
    slot's lengths pass max_len with no device assert (Q8_0), a profiled
    replayed slot step holds 33 ``q8_matvec_kernel`` (dense: 33
    ``gemv_bf16_kernel``) and a profiled admission 32 ``q8_wgmma_kernel``
    (dense: 32 ``wgmma_kernel`` and 4 ``flash_fwd_mma_kernel``). Printed:
    the slot step's device time, idle share and top kernels beside phase
    6's batch-1 step, the splice's device time an admission, tokens a
    second of the same drive repeated on the warm pool, the pool's
    committed KV bytes and peak utilization; on Q8_0 the benchmark's static-vs-continuous comparison
    by its own method (min-of-probes service times, one Poisson trace at
    3x load on a virtual clock), printed and not held to a limit.

11. Paged serving, on each path's weights (a new engine: max_len 16 + 8,
    no EOS): ``benchmarks/paged_serving.py``'s three modes over the same
    arrival trace (its ``_workload`` at the full config from
    default_rng(0): 24 requests over 3 utterances drawn with reuse, max_new
    in 6-16, Poisson arrivals at 3x load, replayed on its virtual step
    clock; each utterance a 1500-frame mel from default_rng(1)): the paged
    pool (12 logical slots, pages of 4 positions, ``1 + 12 x pages_per``
    self pages, one cross page of 1500 frames an utterance, 1 + 3 cross
    pages), the tight arena (4 slots, ``2 + 2 x pages_per`` self pages)
    and the contiguous pool (4 slots), the paged pool first. Launches from
    Python per drive: only the captures of that drive (the paged pool's
    first admission captures the batch-1 prefill and step, the replays'
    program, and its slot step). Fails unless every request's tokens agree
    across the modes and with a batch-1 ``transcribe`` of its mel, the
    tight arena preempted, the paged pool hit a shared prefix, each pool
    captured one slot step and the engine the batch-1 step once, the
    ledger's commits equal prefills (misses and replays') + slot steps +
    replays and its FLOPs the plans' times prefills, steps and replayed
    steps, per-request PDP sums to the batch's (rel 1e-9), the paged pool
    admits at least 2x the contiguous pool's requests per committed byte
    (the reference's ``mem_2x``), a profiled paged slot step holds 33
    ``q8_matvec_kernel`` (dense: 33 ``gemv_bf16_kernel``), and a free
    slot's length passes max_len with no device assert. Printed: each
    mode's tokens a second (of the same drive repeated on the warm pool:
    the first one's wall holds the captures), p50/p95/p99 latency in
    steps, committed KV bytes, peak utilization and activity; the paged
    slot step's device time, idle share, top kernels and index kernels
    beside phase 10's 4-slot step, the gathers' device time alone, the
    replay's device time a token, preemptions and prefix hits. Phase 2
    holds ``q8_matvec`` and ``bf16_matmul``'s decode launch at M = 12
    (``per`` "paged slot step", their ``MT = 16`` instantiations).
12. Speculative decoding (``serve/speculative.py``): whisper-base verifies
    at its published widths (Q8_0 through an untuned offload engine, and
    dense in one case), whisper-tiny drafts (dense, on ``bf16_matmul``),
    both from seeded random weights, 1500-frame mels, no EOS.
    a. The paper's other rungs: captured ``transcribe`` of whisper-base and
       whisper-small (Q8_0, 27 tokens): prefill ms, decode ms a token and
       PDP at the power limit, beside phase 7's whisper-tiny figure and
       each model's 32 KB coverage (the port's and the paper's).
    b. ``SpeculativeEngine.transcribe`` (``spec_case``): raw weights at
       batch 1, k = 4, 24 tokens (acceptance near 0: the correction path);
       the echo parameterization of ``benchmarks/speculative.py``
       (alpha 0.02 on every decoder block's self ``o``, cross ``o`` and
       ``ffn.down``, both models) at batch 1, k = 4, 48 tokens (window M =
       5) and batch 4, k = 6, 48 tokens (M = 28); the last again with a
       dense verifier. Fails unless every row's tokens equal the
       verifier's batch-1 ``transcribe``'s; the first request's launches
       are exactly the captures of the draft's prefill, the draft step and
       the window (twice each program's plan) and the second request's
       none; the captures stay put; commits equal prefills + 2 a round and
       each role's FLOPs its plans times prefills, rounds x (k + 1) draft
       steps and rounds windows, ``by_role`` summing to the FLOP totals;
       the window's logits at each position equal k + 1 sequential steps'
       from the same state bit for bit at M <= 16, within FIRST_STEP_TOL
       (Q8_0) or DENSE_FIRST_STEP_TOL (dense) at M = 28. Printed:
       acceptance and rounds, tokens a second speculative and plain and
       their ratio (held to no limit), a round's device time split into
       the draft steps and the window, its idle share against the host's
       round time, the window's top kernels, PDP per transcript at the
       limit, speculative beside plain.
    c. The schedulers on ``benchmarks/paged_speculative.py``'s trace
       (``spec_schedulers``: 14 requests, 2 slots, k = 4, max_len 22, echo
       Q8_0 verifier): the ``SpecScheduler`` wave, the
       ``SpecContinuousScheduler``, the ``PagedSpecScheduler`` and its
       tight arena, with the gates of its docstring.
    d. The phase's wall time. Phase 2 holds the kernels at the verifier's
       shapes: ``q8_matvec`` at M = 1 (``per`` "whisper-base decode step")
       and M = 5, ``q8_matmul`` at M = 28 with the decoder's f32 x, and
       ``bf16_matmul`` at M = 5 and 28 (``per`` "verify window M=5" and
       "verify window M=28").

13. Telemetry (``repro_torch.obs``), the port's counterpart of
    ``benchmarks/telemetry_overhead.py``; with telemetry off, phases 2-12
    print what they printed before.
    a. The gate (``telemetry_gate``): two whisper-tiny engines at
       published widths, Q8_0, untuned ``OffloadEngine()``, one with
       ``Telemetry()`` and one without, over 4-slot pools, on the
       reference's full trace (16 requests, max_new 6-24 from
       default_rng(0); 1500-frame mels in place of its 32-frame ones).
       Both drain 2 requests to warm up, then 5 lockstep drains of the
       trace, one step each in turn. Fails unless the overhead, the
       median of the paired per-step deltas over the median
       telemetry-off step, is at most 3% (1.03x); tokens, the captures'
       launches from Python, the one slot-step capture a pool and a
       replayed step's kernels are equal with telemetry on and off; and
       the telemetry-on engine's ledger is exact, every rid's phases are
       closed, the spans nest, every histogram's buckets sum to its
       count and its Perfetto JSON passes ``tools/check_trace.py``.
    b. ``telemetry_drives``: phase 11's paged geometry on its 24-request
       trace, and phase 12c's tight speculative pool on its 14-request
       trace, each with telemetry on against its telemetry-off twin in
       lockstep: the same invariants, ``prefix_hit`` (paged) and
       ``preempt``, ``replay`` and ``spec_round`` (speculative) present,
       ``repro_preemptions_total`` equal to the scheduler's preemptions;
       each overhead printed, not gated.
    One ``telemetry ...: {...}`` line per drive, then the phase's wall
    time.

The last two lines are the kernels' JSON record and the result line; each
kernel's record also carries its launches on the tuned paths' eager loops
(``tuned_launches``), its launches on each path's drive
(``launches_by_path``: the main path's, phase 10's, phase 11's paged
pool drives, both paths summed, under "paged", phase 12's captures
under "speculative" and phase 13's captures, every engine's summed,
under "telemetry") and its tiles' times (``tiles``).

Copied out of a checkout (no ``src/repro_torch`` beside the script), or
without a CUDA device, it prints why and exits 1.
"""
from __future__ import annotations

import collections
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
# the continuous-batching slot step (phase 10): every decode linear at M =
# SLOTS, on the MT = 4 instantiations of the decode kernels
MATVEC_SLOT_SHAPES = [(4, *shape[1:]) for shape in MATVEC_SHAPES]
BF16_SLOT_SHAPES = [(4, *shape[1:]) for shape in BF16_STEP_SHAPES]
# the paged slot step (phase 11): 12 logical slots, every decode linear at
# M = 12, on the MT = 16 instantiations
MATVEC_PAGED_SHAPES = [(12, *shape[1:]) for shape in MATVEC_SHAPES]
BF16_PAGED_SHAPES = [(12, *shape[1:]) for shape in BF16_STEP_SHAPES]
# whisper-base's decode linears, the verifier's (phase 12): (n, k, launches
# a step or a window); burst 256 divides every K, so k_main = K
BASE_DECODE = [(512, 512, 36),     # self q/k/v/o + cross q/o, 6 layers
               (2048, 512, 6),     # ffn.up
               (512, 2048, 6),     # ffn.down
               (51872, 512, 1)]    # dec.vocab
# the verify window: whisper-base's step (M = 1), and its window at M = 5
# (batch 1, k = 4) and M = 28 (batch 4, k = 6: above 16 rows, where
# kernel_for sends it to q8_matmul, the f32 tiled launch with the Q8_0
# decoder's f32 x, and to bf16_matmul's tensor-core launch)
BASE_STEP_Q8 = [(1, n, k, k, c, "float32") for n, k, c in BASE_DECODE]
WINDOW5_Q8 = [(5, n, k, k, c, "float32") for n, k, c in BASE_DECODE]
WINDOW28_Q8 = [(28, n, k, k, c, "float32") for n, k, c in BASE_DECODE]
WINDOW5_BF16 = [(5, n, k, k, c, "bfloat16") for n, k, c in BASE_DECODE]
WINDOW28_BF16 = [(28, n, k, k, c, "bfloat16") for n, k, c in BASE_DECODE]
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
                      shapes={"decode step": MATVEC_SHAPES,
                              "slot decode step": MATVEC_SLOT_SHAPES,
                              "paged slot step": MATVEC_PAGED_SHAPES,
                              "whisper-base decode step": BASE_STEP_Q8,
                              "verify window M=5": WINDOW5_Q8},
                      library_call="torch.matmul(x_f32, W_dequantized_f32.T):"
                                   " no single PyTorch call computes a Q8_0 "
                                   "product"),
    "q8_matmul": dict(source="src/repro_torch/csrc/q8_matmul.cu",
                      replaces="src/repro/kernels/q8_matmul.py:87",
                      shapes={"prefill": MATMUL_SHAPES,
                              "verify window M=28": WINDOW28_Q8},
                      library_call="torch.matmul(x_f32, W_dequantized_f32.T):"
                                   " no single PyTorch call computes a Q8_0 "
                                   "product"),
    "bf16_matmul": dict(source="src/repro_torch/csrc/bf16_matmul.cu",
                        replaces="src/repro/kernels/bf16_matmul.py:76",
                        shapes={"prefill": BF16_PREFILL_SHAPES,
                                "decode step": BF16_STEP_SHAPES,
                                "slot decode step": BF16_SLOT_SHAPES,
                                "paged slot step": BF16_PAGED_SHAPES,
                                "verify window M=5": WINDOW5_BF16,
                                "verify window M=28": WINDOW28_BF16},
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
# the kernels line's top-level times sum these (one prefill + one batch-1
# decode step, as PERF.md compares across PRs); other rows (the slot step)
# show in by_phase and shapes
SUMMED = ("prefill", "decode step")
MAX_NEW = 32
PROFILED_STEPS = 8               # decode steps under torch.profiler
REPLAY_PROFILES = 3              # profiled windows of the replays, at most
SPIN_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel: opens a window
CAPTURE_PASSES = 2               # Python runs a program twice: warm-up, capture
REQUESTS = 4                     # captured requests held against eager ones
PAPER_TOKENS = 27                # the paper's jfk.wav transcript (enumerate_whisper)
POWER_S = 5.0                    # seconds of transcripts under the power sampler
# substrings of the names of dot-product kernels: the port's, and cuBLAS's
DOT_KERNEL_WORDS = ("q8_matvec", "q8_matmul", "gemv", "gemm",
                    "wgmma_kernel", "tiled_kernel", "flash_fwd", "xmma",
                    "cutlass")
# cuBLAS's products (the residual arm's and the attention's), told from
# the port's kernels by name
LIBRARY_WORDS = ("gemm", "gemv", "xmma", "cutlass", "cublas")
PORT_KERNEL_WORDS = ("q8_matvec_kernel", "q8_matmul_kernel",
                     "q8_wgmma_kernel", "gemv_bf16_kernel", "wgmma_kernel",
                     "tiled_kernel", "flash_fwd")
# phase 9a: (kernel, m, n, k, x dtype) — the main paths' products with K
# whole, as a tuned burst leaves it, and the frontend's K = 80: on the
# tensor-core launch (bf16 x), and as the tuned paths run it, f32 mel as x
# on the tiled launch, which takes no tile
TILE_SHAPES = [
    ("q8_matmul", 1500, 384, 384, "bfloat16"),
    ("q8_matmul", 1500, 1536, 384, "bfloat16"),
    ("q8_matmul", 1500, 384, 1536, "bfloat16"),
    ("q8_matvec", 1, 384, 384, "float32"),
    ("q8_matvec", 1, 1536, 384, "float32"),
    ("q8_matvec", 1, 384, 1536, "float32"),
    ("q8_matvec", 1, 51872, 384, "float32"),
    ("bf16_matmul", 1500, 384, 384, "bfloat16"),
    ("bf16_matmul", 1500, 1536, 384, "bfloat16"),
    ("bf16_matmul", 1500, 384, 1536, "bfloat16"),
    ("bf16_matmul", 1500, 384, 80, "bfloat16"),
    ("bf16_matmul", 1500, 384, 80, "float32"),
    ("bf16_matmul", 1, 384, 384, "bfloat16"),
    ("bf16_matmul", 1, 1536, 384, "bfloat16"),
    ("bf16_matmul", 1, 384, 1536, "bfloat16"),
    ("bf16_matmul", 1, 51872, 384, "bfloat16"),
]
TUNING_DIR = os.path.join(ROOT, "build", "tuning")
# phase 10, the parameters of benchmarks/continuous_batching.py::_variant
# (full config) at whisper's 1500-frame window: 4 slots, 16 requests whose
# max_new is drawn in 6-48 after their mels from default_rng(0), no EOS,
# max_len = 48 + 8
SLOTS = 4
CB_REQUESTS = 16
CB_BUDGETS = (6, 48)
CB_MAX_LEN = 56
CB_SECOND_WAVE = 8               # requests of the wave submitted mid-drain
CB_WAVE_GAP = 10                 # slot steps before it
CB_DENSE_REQUESTS = 6
CB_CAL_ROUNDS = 5                # the benchmark's _calibrate rounds
# phase 11, benchmarks/paged_serving.py::_workload and _variant (full
# config): 24 requests over 3 distinct utterances drawn with reuse, max_new
# in 6-16, Poisson arrivals at 3x load, all from default_rng(0) in the
# reference's order (its 32-frame mels drawn and discarded); each distinct
# utterance then a 1500-frame mel from default_rng(1). max_len = 16 + 8;
# pages of 4 positions; 3 logical slots per contiguous slot
PG_REQUESTS = 24
PG_DISTINCT = 3
PG_BUDGETS = (6, 16)
PG_REF_FRAMES = 32
PG_MAX_LEN = 16 + 8
PG_PAGE = 4
PG_OVERSUB = 3
PG_SLOTS = PG_OVERSUB * SLOTS    # the paged pool's 12 logical slots
# phase 12, speculative decoding: whisper-base verifies (Q8_0, and dense
# in one case), whisper-tiny drafts (dense), both at their published
# widths with seeded random weights, 1500 frames, no EOS
SPEC_RUNG_REQUESTS = 3           # timed transcripts a rung (12a), median
ECHO_ALPHA = 0.02                # benchmarks/speculative.py's alpha
SPEC_MAX_NEW = 48                # benchmarks/speculative.py::run, full
SPEC_RAW_MAX_NEW = 24
SPEC_MAX_LEN = SPEC_MAX_NEW + 6 + 2      # max_new + k + 1 at k = 6, and one
# 12c, benchmarks/paged_speculative.py::_workload and _variant at the full
# setting: 14 requests, max_new in 6-16, Poisson arrivals in rounds at 2x
# load on 2 slots, k = 4, max_len = 16 + k + 2, pages of 4
PS_REQUESTS = 14
PS_REF_FRAMES = 32
PS_BUDGETS = (6, 16)
PS_SLOTS = 2
PS_K = 4
PS_MAX_LEN = PS_BUDGETS[1] + PS_K + 2
PS_PAGE = 4
# phase 13: benchmarks/telemetry_overhead.py's full trace
TE_REQUESTS = 16
TE_REF_FRAMES = 32                # its mels' frames (drawn, then discarded)
TE_BUDGETS = (6, 24)
TE_WARM = 2                       # requests each engine drains to warm up
TE_ROUNDS = 5                     # lockstep drains of the trace
TE_BUDGET = 0.03                  # the gate: telemetry-on step <= 1.03x off
TE_BARE = 200                     # paired bare replays: the pools' own gap


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


def graph_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device time per call from CUDA events around the replay of a CUDA
    graph that holds ``iters`` calls (``tuning.replay.timed``): no host
    launch cost between the calls, the graph's small gaps between kernels
    included. The median of ``reps`` replays."""
    import statistics

    from repro_torch.tuning.replay import timed
    return statistics.median(timed(fn, reps, iters, "cuda")[0]) * 1e3


def device_ms(fn, iters: int = 20, attempts: int = 3):
    """Device time per call and how it was taken, as (ms, source): the
    card's own time in the kernels one call launches (torch.profiler,
    CUPTI), without the host's launch cost (source "profiler"). A profiled
    window in which CUPTI delivered no kernel record (seen now and then in
    runs of short windows) is profiled again, up to ``attempts`` times;
    then the call is timed with CUDA events over a captured graph
    (``graph_ms``: source "graph_events", which holds the gaps between the
    graph's kernels too), and the line says so. Every record that keeps a
    time keeps its source beside it (``ms_source``)."""
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
            return total / 1e3 / iters, "profiler"
        print("torch.profiler recorded no device time; profiling again",
              flush=True)
    ms = graph_ms(fn, iters)
    print(f"torch.profiler recorded no device time in {attempts} windows: "
          f"{ms:.5f} ms from CUDA events over a captured graph of {iters} "
          "calls", flush=True)
    return ms, "graph_events"


def device_ms_each(fns, iters: int = 20):
    """Device time per call of each of ``fns`` from one profiled window, as
    ``device_ms``'s (ms, source) pairs: each runs ``iters`` times in turn,
    and the window's kernel records, in launch order, fall into
    consecutive groups of ``iters`` (each call launches one kernel). Where
    the records do not add up, each is timed on its own (``device_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        for fn in fns:
            for _ in range(iters):
                fn()
        torch.cuda.synchronize()
    recs = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0 and SPIN_KERNEL not in e.name),
                  key=lambda e: e.time_range.start)
    if len(recs) != len(fns) * iters:
        return [device_ms(fn, iters) for fn in fns]
    return [(sum(e.device_time_total
                 for e in recs[i * iters:(i + 1) * iters]) / 1e3 / iters,
             "profiler") for i in range(len(fns))]


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
    timed = {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
             "library_ms": device_ms(library),
             **{key: device_ms(fn) for key, fn in extra.items()}}
    return dict(max_abs_err=err, bytes=moved, flops=flops,
                bytes_ms=bytes_ms, ops_ms=ops_ms, wall_ms=wall_ms(kernel),
                bound_ms=b_ms, bound_by=b_by,
                **{key: ms for key, (ms, _) in timed.items()},
                ms_source={key: src for key, (_, src) in timed.items()})


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
    events = sorted((e for e in prof.key_averages()
                     if SPIN_KERNEL not in e.key),
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
            if getattr(e, "self_device_time_total", 0.0) > 0
            and SPIN_KERNEL not in e.key}


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


def _open_window() -> None:
    """Start a profiled window with a short spin kernel. On the card the
    profiler can drop the first kernel record of a window over graph
    replays (seen as 7 of 8 launches of a step's first kernel, and as a
    prefill's first kernel missing); the spin kernel takes that place, and
    ``_by_kernel`` and ``device_ms_each`` leave it out by name."""
    import torch
    torch.cuda._sleep(1000)


def _profile_replays(eng, f: int):
    """One replayed prefill and PROFILED_STEPS replayed steps (each with
    transcribe's host sync) under torch.profiler: each phase's kernels by
    name (the step's per step), its top kernels and its host wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    st = eng._static[(1, f)]
    pre_key, step_key = eng._key("prefill", 1, f), eng._key("step", 1, f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        t0 = time.perf_counter()
        eng._run(pre_key, None)
        torch.cuda.synchronize()
        pre_wall = (time.perf_counter() - t0) * 1e3
    pre_kernels, pre_top = _by_kernel(prof), _top_kernels(prof, 1, 8)
    st.token.fill_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            eng._run(step_key, None)
            bool(st.done.all())
        torch.cuda.synchronize()
        dec_wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    return (pre_kernels, pre_top, pre_wall, _by_kernel(prof, PROFILED_STEPS),
            _top_kernels(prof, PROFILED_STEPS, 8), dec_wall)


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

    # one replayed prefill and PROFILED_STEPS replayed steps; the graphs
    # are fixed, so a window whose kernels differ from them lost records
    # and is profiled again
    for attempt in range(REPLAY_PROFILES):
        (pre_kernels, pre_top, pre_wall, dec_kernels, dec_top,
         dec_wall) = _profile_replays(eng, f)
        launches = {phase: {name: launches for name, (launches, _) in
                            by_route(kernels, replay_kernels[phase]).items()}
                    for phase, kernels in (("prefill", pre_kernels),
                                           ("step", dec_kernels))}
        if launches == replay_kernels or not (pre_kernels and dec_kernels):
            break
        print(f"captured {label}: kernels per replay {launches} in profiled "
              f"window {attempt + 1}, expected {replay_kernels}; profiling "
              "again", flush=True)
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
        share = dot_share(dec_kernels)
        library = {phase: sum(n for name, (n, _) in kernels.items()
                              if any(w in name for w in LIBRARY_WORDS)
                              and not any(w in name
                                          for w in PORT_KERNEL_WORDS))
                   for phase, kernels in (("prefill", pre_kernels),
                                          ("step", dec_kernels))}
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
                   library_launches=library,
                   prefill_top_kernels=pre_top,
                   decode_top_kernels=dec_top,
                   step_dot_share=share, step_amdahl_bound=amdahl_bound(share),
                   paper_share=PAPER_SHARE[share_key],
                   paper_amdahl_bound=amdahl_bound(PAPER_SHARE[share_key]))
        if launches != replay_kernels:
            seen = {phase: sorted((name[:70], n) for name, (n, _) in
                                  kernels.items())
                    for phase, kernels in (("prefill", pre_kernels),
                                           ("step", dec_kernels))}
            raise AssertionError(f"{label}: kernels per replay {launches} != "
                                 f"{replay_kernels}; the windows saw {seen}")
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


def _tile_operands(gen, kernel, m, n, k, xdt):
    """(kernel args, kernel, plain, bound ms, bound by) of one product at
    one shape, on the serving path's operand types."""
    from repro_torch.kernels import bf16_matmul, q8_matmul, q8_matvec
    if kernel == "bf16_matmul":
        args, _, moved, flops, rate, _ = _bf16_case(gen, m, n, k, k, xdt)
        fn, plain = bf16_matmul.bf16_matmul, bf16_matmul.bf16_matmul_plain
    else:
        args, _, moved, flops, rate, _ = _q8_case(gen, m, n, k, k, xdt)
        mod = q8_matmul if kernel == "q8_matmul" else q8_matvec
        fn, plain = getattr(mod, kernel), getattr(mod, f"{kernel}_plain")
    b_ms, b_by = bound(moved / HBM_BYTES_PER_S * 1e3,
                       flops / FLOPS_PER_S[rate] * 1e3)
    return args, fn, plain, b_ms, b_by


def check_tiles():
    """Phase 9a: every admissible launch tile of the three products at
    whisper-tiny's shapes against the plain version, and its device time
    beside the default launch's and the bound. The tiled f32 launch of
    ``bf16_matmul`` (f32 x above M = 16) takes no tile: its one launch is
    checked and timed as it comes (tile None). Returns {kernel:
    [records]}."""
    import torch
    from repro_torch.kernels.tiles import MAX_ROW_M, tile_m
    from repro_torch.tuning.space import default_launch, launches

    gen = torch.Generator(device="cuda").manual_seed(7)
    records = {}
    for kernel, m, n, k, xdt in TILE_SHAPES:
        args, fn, plain, b_ms, b_by = _tile_operands(gen, kernel, m, n, k,
                                                     xdt)
        want = plain(*args)
        tm = tile_m(m)                        # where the tuner keys a tile
        if kernel == "bf16_matmul" and m > MAX_ROW_M and xdt == "float32":
            tiles, default = [None], None
        else:
            tiles = launches(kernel, tm, n, k)
            default = default_launch(kernel, tm, n, k)
        lim = KERNEL_TOL * max(1.0, want.abs().max().item())
        errs = []
        for t in tiles:
            err = (fn(*args, tile=t) - want).abs().max().item()
            if not err <= lim:
                raise AssertionError(f"{kernel} {m}x{n}x{k} tile {t}: max "
                                     f"|kernel - plain| = {err} > {lim}")
            errs.append(err)
        times = device_ms_each([lambda t=t: fn(*args, tile=t) for t in tiles])
        base = times[tiles.index(default)][0]
        rows = [dict(m=m, n=n, k=k, x=xdt, tile=list(t) if t else None,
                     default=t == default, ms=ms, ms_source=src,
                     default_ms=base, bound_ms=b_ms, bound_by=b_by,
                     max_abs_err=err)
                for t, (ms, src), err in zip(tiles, times, errs)]
        best = min(rows, key=lambda r: r["ms"])

        def name(t):
            return tuple(t) if t else None
        print(f"tiles {kernel} {m}x{n}x{k} x={xdt}: default {default} "
              f"{base:.5f} ms; best {name(best['tile'])} {best['ms']:.5f} "
              "ms; " + " ".join(f"{name(r['tile'])}={r['ms']:.5f}"
                                for r in rows)
              + f" bound {b_ms:.5f} ms ({b_by}) max_abs_err={max(errs):.3e}"
              + "".join(f" {name(r['tile'])} from {r['ms_source']}"
                        for r in rows if r["ms_source"] != "profiler"),
              flush=True)
        records.setdefault(kernel, []).extend(rows)
    return records


def tuning_fit(cfg):
    """Phase 9b: a measured Autotuner warmed over warm_tuning's shapes on
    both paths (the paper's 27 tokens and this script's MAX_NEW), every
    admissible launch of each shape replayed, ``hopper`` coefficients
    fitted, and the analytic and calibrated rankings held against the
    measured one. Saves the cache and its calibration under
    build/tuning/. Returns (tuner, summary)."""
    import statistics

    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models.whisper import warm_tuning
    from repro_torch.tuning import (
        Autotuner, CalibratedCoefficients, analytic_cost, calibrated_cost,
        enumerate_candidates, fit_backend, make_operands, rank_correlation,
        replay_candidate, sibling_path)

    path = os.path.join(TUNING_DIR, "whisper_tiny.json")
    for stale in (path, sibling_path(path)):
        if os.path.exists(stale):
            os.remove(stale)
    tuner = Autotuner(mode="measured", cache_path=path)
    eng = OffloadEngine(tuner=tuner)
    t0 = time.perf_counter()
    shapes = {quant: max(warm_tuning(cfg, eng, quant=quant, n_tokens=t)
                         for t in (PAPER_TOKENS, MAX_NEW))
              for quant in ("q8_0", "none")}
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples, analytic, measured = [], [], []
    by_shape = {}
    for key in sorted(tuner.cache.entries, key=lambda key: key.encode()):
        cands = {c.launch: c for c in enumerate_candidates(
            key.kernel, key.m, key.n, key.k)}
        ops = make_operands(key.kernel, key.m, key.n, key.k, key.dtype,
                            device="cuda")
        for c in cands.values():
            sample = replay_candidate(c, key.m, key.n, key.k, key.dtype,
                                      device="cuda", operands=ops)
            samples.append(sample)
            analytic.append(analytic_cost(c, key.m, key.n, key.k).cost_s)
            measured.append(sample.time_s)
            by_shape.setdefault(key, []).append((c, len(samples) - 1))
    coeffs = fit_backend(samples, "hopper")
    calibrated = [calibrated_cost(c, key.m, key.n, key.k, coeffs=coeffs
                                  ).cost_s
                  for key, rows in by_shape.items() for c, _ in rows]

    def within(costs):
        rhos = [rank_correlation([costs[i] for _, i in rows],
                                 [measured[i] for _, i in rows])
                for rows in by_shape.values() if len(rows) > 1]
        return statistics.fmean(rhos), len(rhos)
    cal = CalibratedCoefficients()
    cal.put(coeffs)
    cal.save(sibling_path(path))
    tuner.save()
    fit_s = time.perf_counter() - t0
    summary = dict(
        shapes=shapes, cache_entries=len(tuner.cache),
        searches=tuner.searches, warm_s=warm_s, replays=len(samples),
        fit_s=fit_s, eff_flops=coeffs.eff_flops, eff_bw=coeffs.eff_bw,
        overhead_s=coeffs.overhead_s, median_rel_err=coeffs.median_rel_err,
        rank_analytic=rank_correlation(analytic, measured),
        rank_calibrated=rank_correlation(calibrated, measured),
        rank_analytic_within_shape=within(analytic),
        rank_calibrated_within_shape=within(calibrated),
        cache=os.path.relpath(path, ROOT),
        calibration=os.path.relpath(sibling_path(path), ROOT),
        winners={key.encode(): [rec.block_k, list(rec.launch), rec.cost_s]
                 for key, rec in sorted(tuner.cache.entries.items(),
                                        key=lambda kv: kv[0].encode())})
    print(f"tuning fit: {json.dumps(summary)}", flush=True)
    return tuner, summary


def tuning_grid(power_w: float):
    """Phase 9c: the measured (shared-memory budget x burst) grid of
    q8_matmul at enc.ffn.up, each cell's best launch and its PDP at
    ``power_w``, beside the untuned split at burst 256."""
    import dataclasses

    from repro_torch.backends import executor
    from repro_torch.tuning import (
        budget_grid, make_operands, measured_cost, sweep_grid)
    from repro_torch.tuning.space import bursts

    m, n, k = 1500, 1536, 384
    ops = make_operands("q8_matmul", m, n, k, "q8_0", device="cuda")
    seen = {}

    def cost(c, m, n, k):                   # one replay a launch
        if c.launch not in seen:
            seen[c.launch] = measured_cost(c, m, n, k, operands=ops)
        return dataclasses.replace(seen[c.launch], cand=c)
    grid = sweep_grid("q8_matmul", m, n, k, budgets=budget_grid(),
                      block_ks=bursts("q8_matmul", k), cost_fn=cost)
    x, wq = ops
    untuned_ms, untuned_src = device_ms(
        lambda: executor.split_matmul(x, wq, 256))
    best = min(grid, key=lambda cell: cell[1].cost_s)[1]
    tuned_ms, tuned_src = device_ms(lambda: executor.split_matmul(
        x, wq, best.cand.block_k, tiling=best.cand.launch))
    cells = [dict(budget_kb=b / 1024, burst=r.cand.block_k,
                  launch=list(r.cand.launch), claim_bytes=r.cand.claim_bytes,
                  ms=r.cost_s * 1e3, pdp_uj=r.pdp_j(power_w) * 1e6)
             for b, r in grid]
    empty = sorted({b / 1024 for b in budget_grid()}
                   - {c["budget_kb"] for c in cells})
    for c in cells:
        print(f"grid q8_matmul {m}x{n}x{k}: budget {c['budget_kb']:g} KB "
              f"burst {c['burst']}: launch {tuple(c['launch'])} "
              f"({c['claim_bytes']} B) {c['ms']:.5f} ms, PDP "
              f"{c['pdp_uj']:.3f} uJ at {power_w:g} W", flush=True)
    out = dict(shape=[m, n, k], budgets_without_a_launch_kb=empty,
               cells=cells, untuned_split_device_ms=untuned_ms,
               tuned_split_device_ms=tuned_ms,
               split_ms_source=[untuned_src, tuned_src],
               tuned=[best.cand.block_k, list(best.cand.launch)])
    print(f"grid summary: {json.dumps(dict(out, cells=len(cells)))}",
          flush=True)
    return out


def residual_linears(eng, frames: int):
    """Linears with a host-residual segment in each program's plan: (all,
    those at K = 384)."""
    out = {}
    for phase in ("prefill", "step"):
        plan = eng._plans.plans[eng._key(phase, 1, frames)]
        out[phase] = (sum(1 for e in plan if e.k_res),
                      sum(1 for e in plan if e.k_res and e.k == 384))
    return out


def tiles_vs_own(eng, frames: int):
    """The launch tiles of a tuned engine's plans against the kernels' own
    launches (no tile) on the same operands, timed in one profiled window
    per shape: the device ms of each program's tiled launches, tuned and
    own, and per shape. Shows whether a tuned tile runs slower than the
    launch it replaced."""
    import collections

    import torch
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for phase in ("prefill", "step"):
        plan = eng._plans.plans[eng._key(phase, 1, frames)]
        counts = collections.Counter(
            (e.kernel, e.m, e.n, e.k_main, e.tiling) for e in plan
            if e.tiling)
        rows = []
        for (kernel, m, n, k, tile), count in sorted(counts.items()):
            xdt = "float32" if kernel == "q8_matvec" else "bfloat16"
            args, fn, _, _, _ = _tile_operands(gen, kernel, m, n, k, xdt)
            (t_ms, t_src), (o_ms, o_src) = device_ms_each(
                [lambda: fn(*args, tile=tile), lambda: fn(*args)])
            rows.append(dict(kernel=kernel, m=m, n=n, k=k, tile=list(tile),
                             count=count, tuned_ms=t_ms, own_ms=o_ms,
                             ms_source=[t_src, o_src]))
        out[phase] = dict(
            tuned_ms=sum(r["tuned_ms"] * r["count"] for r in rows),
            own_ms=sum(r["own_ms"] * r["count"] for r in rows), shapes=rows)
    return out


def tuned_path(label, untuned, tuner, counted, eager_want, per_run,
               replay_kernels, share_key, tol):
    """Phase 9d, on one path: an engine with the tuner on the untuned
    engine's weights; its eager loop's launches, its first-step logits
    against the untuned engine's, then phase 6 on it, and the residual-arm
    linears a replay against the untuned engine's."""
    import numpy as np
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models.whisper import warm_tuning
    from repro_torch.serve.engine import ServeEngine

    eng0, mel, _, _ = untuned
    cfg = eng0.cfg
    eng = ServeEngine(cfg, eng0.params, max_len=MAX_NEW + 8,
                      offload=OffloadEngine(tuner=tuner), eos_id=None,
                      device="cuda")
    # every key the path asks warm before its counts are read: warm_tuning's
    # shapes at MAX_NEW tokens, and the plans' own (the vocabulary readout
    # at its padded N, the frontend at K = 80) in a short eager run
    warm_tuning(cfg, eng.offload, n_frames=mel.shape[1], n_tokens=MAX_NEW,
                quant=eng._serve_quant)
    eager_transcribe(eng, mel, 2)
    searches = tuner.searches
    for fn in counted.values():
        fn.launches = 0
    (tokens,), prefill_s, decode_s = eager_transcribe(eng, mel, MAX_NEW)
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"tuned {label}: eager loop launches {launches} (expected "
          f"{eager_want}), prefill_ms={prefill_s * 1e3:.3f} "
          f"decode_ms_per_token={decode_s * 1e3 / MAX_NEW:.3f}", flush=True)
    if launches != eager_want:
        raise AssertionError(f"tuned {label}: launches {launches} != "
                             f"{eager_want}")
    sot = 1
    logits = []
    for e in (eng, eng0):
        _, state = e.prefill(torch.from_numpy(mel).cuda())
        out, _ = e.step(torch.full((1, 1), sot, device="cuda"), state)
        logits.append(out)
    diff = (logits[0] - logits[1]).abs().max().item()
    print(f"tuned {label}: first-step logits tuned vs untuned max_abs_err="
          f"{diff:.3e} (tolerance {tol})", flush=True)
    if not (torch.isfinite(logits[0]).all() and diff <= tol):
        raise AssertionError(f"tuned {label}: first-step logits differ from "
                             f"the untuned engine's by {diff}")
    summary = captured_path(f"{label} tuned", eng, mel, tokens, None,
                            counted, per_run, replay_kernels, share_key)
    # the replays recompute from their input: a new mel through the graphs
    # gives the eager loop's tokens on it
    mel2 = np.random.default_rng(11).standard_normal(mel.shape).astype(
        np.float32)
    (want2,), _, _ = eager_transcribe(eng, mel2, MAX_NEW)
    got2 = eng.transcribe(mel2, max_new=MAX_NEW)[0].tokens
    print(f"tuned {label}: a new mel, captured tokens equal the eager "
          f"loop's: {got2 == want2}", flush=True)
    if got2 != want2:
        raise AssertionError(f"tuned {label}: captured tokens on a new mel "
                             f"{got2} != eager {want2}")
    f = mel.shape[1]
    resid = {"tuned": residual_linears(eng, f),
             "untuned": residual_linears(eng0, f)}
    print(f"tuned {label}: residual-arm linears a replay (all, at K = 384): "
          f"{json.dumps(resid)}", flush=True)
    if any(at384 for _, at384 in resid["tuned"].values()):
        raise AssertionError(f"tuned {label}: a K = 384 linear kept a "
                             "residual")
    if tuner.searches != searches:
        raise AssertionError(f"tuned {label}: the tuner searched while "
                             "serving")
    own = tiles_vs_own(eng, f)
    print(f"tuned {label}: tiled launches a replay, device ms with the "
          "tuned tiles vs the kernels' own launches: " + ", ".join(
              f"{phase} {v['tuned_ms']:.5f} vs {v['own_ms']:.5f}"
              for phase, v in own.items()), flush=True)
    entries = [e for p in eng._plans.plans.values() for e in p]
    return launches, dict(tiles_vs_own=own,
                          eager_prefill_ms=prefill_s * 1e3,
                          eager_decode_ms_per_token=decode_s * 1e3 / MAX_NEW,
                          first_step_vs_untuned=diff, residual_linears=resid,
                          tuned_entries=sum(e.tuned for e in entries),
                          entries=len(entries), **summary)


def _cb_workload(cfg, n_req):
    """The benchmark's draws: n_req mels of 1500 frames, then their max_new
    in CB_BUDGETS, from default_rng(0); the generator is returned for the
    arrival trace."""
    import numpy as np
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((1, cfg.encoder_ctx, cfg.n_mels)).astype(
        np.float32) for _ in range(n_req)]
    lo, hi = CB_BUDGETS
    max_news = [int(rng.integers(lo, hi + 1)) for _ in range(n_req)]
    return mels, max_news, rng


def _drain_waves(sched, mels, max_news):
    """A first wave of requests, the second submitted after CB_WAVE_GAP
    slot steps, drained by hand (admit, step). Returns (rids in submission
    order, admissions, slot steps, tokens, each step's host seconds, the
    engine's step captures after the pool's first step, drain seconds)."""
    import torch
    eng = sched.engine
    first = len(mels) - min(CB_SECOND_WAVE, len(mels) - 1)
    rids = [sched.submit(m, max_new=n)
            for m, n in zip(mels[:first], max_news[:first])]
    admissions = steps = tokens = 0
    step_s, captures = [], None
    t0 = time.perf_counter()
    while len(rids) < len(mels) or sched.n_queued or sched.n_active:
        if len(rids) < len(mels) and (
                steps >= CB_WAVE_GAP or not (sched.n_queued or sched.n_active)):
            rids += [sched.submit(m, max_new=n)
                     for m, n in zip(mels[first:], max_news[first:])]
        admissions += len(sched.admit())
        t1 = time.perf_counter()
        events = sched.decode_step()
        if events:
            step_s.append(time.perf_counter() - t1)
            steps += 1
            tokens += len(events)
            if captures is None:
                captures = eng._step_captures
    torch.cuda.synchronize()            # a device assert would surface here
    return rids, admissions, steps, tokens, step_s, captures, \
        time.perf_counter() - t0


def _slot_lengths(sched):
    """Each slot's self-KV length (layer 0), on the host."""
    return sched.pool.state.layer_states.self_kv[0].length.tolist()


def _profile_slot_steps(sched):
    """PROFILED_STEPS replays of the pool's slot step, each with the
    scheduler's host sync, under torch.profiler: kernels by name a step,
    the top kernels and host wall ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            sched._program.graph.replay()
            sched._token[:, 0].tolist()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    return (_by_kernel(prof, PROFILED_STEPS),
            _top_kernels(prof, PROFILED_STEPS, 8), wall)


def _profile_admission(sched, mel):
    """One admission (the batch-1 prefill replay and its splice) under
    torch.profiler: kernels by name, the top kernels and host wall ms. The
    admitted request is drained after."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rid = sched.submit(mel, max_new=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        t0 = time.perf_counter()
        sched.admit()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    sched.run()
    return _by_kernel(prof), _top_kernels(prof, 1, 8), wall, rid


def cb_benchmark(eng, mels, max_news, rng, power_w):
    """benchmarks/continuous_batching.py's comparison by its own method:
    service times as the minimum over interleaved probes (``_calibrate``:
    CB_CAL_ROUNDS rounds of a static batch of SLOTS x 6 tokens, and two
    admissions and their slot steps), then one Poisson arrival trace at 3x
    load replayed on a virtual clock through static run-to-completion
    batches (``_run_static``) and the scheduler (``_run_continuous``),
    every prefill and step executed for real. Tokens a second and p50/p95
    latency of each mode, printed, not held to a limit."""
    import numpy as np
    from repro_torch.obs.metrics import percentile
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    n = len(mels)
    f = mels[0].shape[1]

    def lat_summary(xs):
        return {f"p{q}_s": percentile(xs, q) for q in (50, 95, 99)}

    # _calibrate
    warm = np.concatenate([mels[0]] * SLOTS, axis=0)
    eng.transcribe(warm, max_new=6)
    sched = ContinuousBatchingScheduler(eng, n_slots=SLOTS, n_frames=f)
    sched.submit(mels[0], max_new=2)
    sched.run()
    pf_b, st_b, admits, csteps = [], [], [], []
    for _ in range(CB_CAL_ROUNDS):
        r = eng.transcribe(warm, max_new=6)
        pf_b.append(r[0].prefill_s * SLOTS)
        st_b.append(r[0].decode_s * SLOTS / max(r[0].steps, 1))
        for _ in range(2):
            sched.submit(mels[0], max_new=4)
        while sched.n_queued or sched.n_active:
            if sched.n_queued and sched.pool.n_free:
                t0 = time.perf_counter()
                k = len(sched.admit())
                admits.append((time.perf_counter() - t0) / max(k, 1))
            t0 = time.perf_counter()
            sched.decode_step()
            csteps.append(time.perf_counter() - t0)
        sched.run()
    cal = {"t_prefill_b": float(np.min(pf_b)), "t_step_b": float(np.min(st_b)),
           "t_admit": float(np.min(admits)), "t_cstep": float(np.min(csteps))}
    captures0 = eng._step_captures
    mean_gap = cal["t_step_b"] * float(np.mean(max_news)) / (3 * SLOTS)
    arrivals = np.cumsum(rng.exponential(mean_gap, n))

    # _run_static
    t, done_t, tokens, i = 0.0, {}, 0, 0
    while i < n:
        t = max(t, float(arrivals[i]))
        j = i + 1
        while j - i < SLOTS and j < n and arrivals[j] <= t:
            j += 1
        members = list(range(i, j))
        batch = [mels[k] for k in members]
        while len(batch) < SLOTS:
            batch.append(batch[-1])
        budget = max(max_news[k] for k in members)
        res = eng.transcribe(np.concatenate(batch, axis=0), max_new=budget)
        t += cal["t_prefill_b"] + res[0].steps * cal["t_step_b"]
        for k in members:
            done_t[k] = t
            tokens += min(max_news[k], res[0].steps)
        i = j
    static = {"tok_s": tokens / max(t, 1e-9),
              **lat_summary([done_t[k] - float(arrivals[k]) for k in range(n)]),
              "makespan_s": t, "tokens": tokens,
              "pdp_j": t * power_w}

    # _run_continuous
    sched = ContinuousBatchingScheduler(eng, n_slots=SLOTS, n_frames=f)
    t, done_t, rid2idx = 0.0, {}, {}
    pending = list(range(n))
    while pending or sched.n_queued or sched.n_active:
        while pending and arrivals[pending[0]] <= t:
            idx = pending.pop(0)
            rid2idx[sched.submit(mels[idx], max_new=max_news[idx])] = idx
        if sched.n_queued and sched.pool.n_free:
            t += len(sched.admit()) * cal["t_admit"]
        if sched.n_active:
            events = sched.decode_step()
            t += cal["t_cstep"]
            for ev in events:
                if ev.done:
                    done_t[rid2idx[ev.rid]] = t
        elif pending:
            t = max(t, float(arrivals[pending[0]]))
    tokens = sum(r.steps for r in sched.finished.values())
    att = sched.attribution(power_w)
    per_req = sum(att["per_request_pdp_j"].values())
    if not abs(per_req - att["batch_pdp_j"]) <= \
            1e-6 * max(1.0, att["batch_pdp_j"]):
        raise AssertionError("benchmark replay: per-request PDP does not "
                             "sum to the batch's")
    lengths = _slot_lengths(sched)
    cont = {"tok_s": tokens / max(t, 1e-9),
            **lat_summary([done_t[k] - float(arrivals[k]) for k in range(n)]),
            "makespan_s": t, "tokens": tokens, "pdp_j": t * power_w,
            "attributed_pdp_j": per_req,
            "kv_committed_bytes": sched.kv_committed_bytes,
            "kv_utilization": sched.kv_utilization_peak,
            "slot_lengths_at_end": lengths}
    out = dict(static=static, continuous=cont, cal=cal,
               step_captures_after_warmup=eng._step_captures - captures0,
               speedup_tok_s=cont["tok_s"] / max(static["tok_s"], 1e-9),
               p95_ratio=static["p95_s"] / max(cont["p95_s"], 1e-9),
               n_req=n, n_slots=SLOTS, n_frames=f, mean_gap_s=float(mean_gap),
               power_w=power_w)
    print(f"continuous batching benchmark replay: {json.dumps(out)}",
          flush=True)
    return out


def continuous_path(label, eng0, counted, per_run, replay_kernels, n_req,
                    batch1, bench):
    """Phase 10, on one path: the continuous-batching scheduler over SLOTS
    slots at 1500 frames, on a new engine (max_len CB_MAX_LEN, no EOS) with
    ``eng0``'s weights and quantization. The launch counts are zeroed just
    before the drive (a first wave, the second submitted mid-drain) and
    read just after: the pool's first admission captures the batch-1
    prefill and the slot step, CAPTURE_PASSES runs of each program's
    Python, and every later admission and step replays. Checks: the step
    captures do not move after the pool's first step; the ledger's
    commits equal admissions plus slot steps; per-request PDP sums to the
    batch's; each request's tokens equal a batch-1 ``transcribe`` of its
    mel; no device assert (a free slot's lengths pass max_len in the drain
    tail); a profiled replayed slot step holds ``replay_kernels["step"]``
    and a profiled admission ``replay_kernels["prefill"]``. Printed beside
    ``batch1`` (phase 6's captured summary): the slot step's device time,
    idle share and top kernels, the splice's device time, the pool's KV
    bytes, and tokens a second and the steps' host time of the same drive
    run again on the warm pool (its tokens, captures and commits checked
    too: the first drive's wall holds the captures); with ``bench``, the
    benchmark's static-vs-continuous comparison."""
    import statistics

    import torch
    from repro_torch.core import energy
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg = eng0.cfg
    f = cfg.encoder_ctx
    power_w = energy.card_power_limit_w(0)
    eng = ServeEngine(cfg, eng0.params, max_len=CB_MAX_LEN,
                      quant=eng0._serve_quant, offload=OffloadEngine(),
                      eos_id=-1, device="cuda")
    mels, max_news, rng = _cb_workload(cfg, n_req)
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    captures0 = eng._step_captures
    sched = ContinuousBatchingScheduler(eng, n_slots=SLOTS, n_frames=f)
    rids, admissions, steps, tokens, step_s, captures, drain_s = \
        _drain_waves(sched, mels, max_news)
    launches = {name: fn.launches for name, fn in counted.items()}
    want = {name: CAPTURE_PASSES * per_run.get(name, 0) for name in counted}
    lengths = _slot_lengths(sched)
    commits = eng.offload.ledger.commits
    att = sched.attribution(power_w)
    results = sched.run()
    print(f"continuous {label}: {n_req} requests, {SLOTS} slots, "
          f"{admissions} admissions, {steps} slot steps, {tokens} tokens in "
          f"{drain_s * 1e3:.3f} ms; launches from Python {launches} "
          f"(expected {want}); step captures {captures0} -> {captures} after "
          f"the first step -> {eng._step_captures}; ledger commits {commits}; "
          f"slot lengths at the end {lengths} (max_len {CB_MAX_LEN})",
          flush=True)
    if launches != want:
        raise AssertionError(f"continuous {label}: launches {launches} != "
                             f"{want}")
    if captures != captures0 + 1 or eng._step_captures != captures:
        raise AssertionError(f"continuous {label}: step captures "
                             f"{captures0} -> {captures} -> "
                             f"{eng._step_captures}")
    if commits != admissions + steps or admissions != n_req:
        raise AssertionError(f"continuous {label}: {commits} commits for "
                             f"{admissions} admissions and {steps} steps")
    per_req = sum(att["per_request_pdp_j"].values())
    if not abs(per_req - att["batch_pdp_j"]) <= 1e-9 * att["batch_pdp_j"]:
        raise AssertionError(f"continuous {label}: per-request PDP {per_req} "
                             f"!= batch {att['batch_pdp_j']}")
    got = [results[r] for r in rids]
    if [r.steps for r in got] != max_news:
        raise AssertionError(f"continuous {label}: steps "
                             f"{[r.steps for r in got]} != {max_news}")
    # batch-1 transcribe of each mel (after the drive: its step capture at
    # (1, F) is the one-shot path's own)
    refs = [eng.transcribe(m, max_new=n)[0].tokens
            for m, n in zip(mels, max_news)]
    same = [r.tokens == ref for r, ref in zip(got, refs)]
    print(f"continuous {label}: tokens equal batch-1 transcribe for "
          f"{sum(same)} of {n_req} requests", flush=True)
    if not all(same):
        bad = same.index(False)
        raise AssertionError(f"continuous {label}: request {bad} tokens "
                             f"{got[bad].tokens} != transcribe {refs[bad]}")

    # the same drive again on the warm pool (nothing left to capture): its
    # wall time gives the drain's tokens a second and the steps' host time
    c0, k0 = eng.offload.ledger.commits, eng._step_captures
    rids2, admissions2, steps2, tokens2, step_s, _, warm_s = _drain_waves(
        sched, mels, max_news)
    again = sched.run()
    if ([again[r].tokens for r in rids2] != refs
            or eng._step_captures != k0
            or eng.offload.ledger.commits - c0 != admissions2 + steps2):
        raise AssertionError(f"continuous {label}: the warm drive's tokens, "
                             "captures or commits differ")

    # profiled replays of the slot step; a window whose kernels differ
    # from the graph's lost records and is profiled again
    for attempt in range(REPLAY_PROFILES):
        kernels, top, wall = _profile_slot_steps(sched)
        seen = {name: n for name, (n, _) in
                by_route(kernels, replay_kernels["step"]).items()}
        if seen == replay_kernels["step"]:
            break
        print(f"continuous {label}: kernels per slot step {seen} in "
              f"profiled window {attempt + 1}, expected "
              f"{replay_kernels['step']}; profiling again", flush=True)
    if seen != replay_kernels["step"]:
        raise AssertionError(f"continuous {label}: kernels per replayed "
                             f"slot step {seen} != {replay_kernels['step']}")
    dev = sum(ms for _, ms in kernels.values())
    host = statistics.median(step_s) * 1e3
    routes = by_route(kernels, replay_kernels["step"])
    for attempt in range(REPLAY_PROFILES):
        pre_kernels, pre_top, pre_wall, _ = _profile_admission(sched,
                                                               mels[0])
        pre_seen = {name: n for name, (n, _) in
                    by_route(pre_kernels, replay_kernels["prefill"]).items()}
        if pre_seen == replay_kernels["prefill"]:
            break
    if pre_seen != replay_kernels["prefill"]:
        raise AssertionError(f"continuous {label}: kernels per admission "
                             f"{pre_seen} != {replay_kernels['prefill']}")
    st = eng._static[(1, f)]
    splice_ms, splice_src = device_ms(lambda: sched.pool.insert(0, st.state))
    out = dict(
        path=label, requests=n_req, slots=SLOTS, frames=f,
        max_len=CB_MAX_LEN, admissions=admissions, slot_steps=steps,
        tokens=tokens, first_drive_ms=drain_s * 1e3, warm_drive_ms=warm_s * 1e3,
        drain_tok_s=tokens2 / warm_s, launches=launches,
        step_captures=eng._step_captures,
        slot_lengths_after_drain=lengths,
        slots_past_max_len=sum(n > CB_MAX_LEN for n in lengths),
        slot_step_host_ms_median=host,
        slot_step_host_ms_min=min(step_s) * 1e3,
        slot_step_wall_ms_profiled=wall, slot_step_device_ms=dev,
        slot_step_idle_share=1 - dev / wall,
        slot_step_idle_share_unprofiled=1 - dev / host,
        slot_step_kernels=seen,
        slot_step_kernel_device_ms={k: v[1] for k, v in routes.items()},
        slot_step_top_kernels=top,
        admission_kernels=pre_seen,
        admission_device_ms=sum(ms for _, ms in pre_kernels.values()),
        admission_wall_ms_profiled=pre_wall, admission_top_kernels=pre_top,
        splice_device_ms=splice_ms, splice_ms_source=splice_src,
        prefill_ms_median=statistics.median(r.prefill_s for r in got) * 1e3,
        kv_committed_bytes=sched.kv_committed_bytes,
        kv_utilization_peak=sched.kv_utilization_peak,
        batch1_step_device_ms=batch1.get("decode_device_ms_per_step"),
        batch1_decode_ms_per_token=batch1.get("decode_ms_per_token"),
        attribution_batch_pdp_j=att["batch_pdp_j"],
        attribution_per_request_sum_j=per_req, power_w=power_w)
    print(f"continuous {label} summary: {json.dumps(out)}", flush=True)
    if bench:
        out["benchmark"] = cb_benchmark(eng, mels, max_news, rng, power_w)
        lengths = out["benchmark"]["continuous"]["slot_lengths_at_end"]
        out["slots_past_max_len"] += sum(n > CB_MAX_LEN for n in lengths)
    return launches, out



def _pg_workload(cfg):
    """benchmarks/paged_serving.py::_workload at its full config, drawn
    from default_rng(0) in the reference's order: PG_DISTINCT mels of
    PG_REF_FRAMES frames (drawn and discarded: the trace stays the
    reference's), which utterance each request repeats, the max_news in
    PG_BUDGETS, the Poisson arrival steps at 3x load. Each distinct
    utterance is then a 1500-frame mel from default_rng(1). Returns (mels
    by request, the distinct mels, which one each request is, max_news,
    arrivals)."""
    import numpy as np
    rng = np.random.default_rng(0)
    for _ in range(PG_DISTINCT):
        rng.standard_normal((1, PG_REF_FRAMES, cfg.n_mels))
    which = [int(rng.integers(PG_DISTINCT)) for _ in range(PG_REQUESTS)]
    lo, hi = PG_BUDGETS
    max_news = [int(rng.integers(lo, hi + 1)) for _ in range(PG_REQUESTS)]
    mean_gap = float(np.mean(max_news)) / (3 * SLOTS)
    arrivals = np.floor(np.cumsum(rng.exponential(mean_gap, PG_REQUESTS)))
    real = np.random.default_rng(1)
    distinct = [real.standard_normal((1, cfg.encoder_ctx, cfg.n_mels)
                                     ).astype(np.float32)
                for _ in range(PG_DISTINCT)]
    return [distinct[i] for i in which], distinct, which, max_news, arrivals


def _pg_drive(sched, mels, max_news, arrivals, power_w):
    """benchmarks/paged_serving.py::_drive: the arrival trace replayed on a
    virtual clock of one unit a slot step (an idle scheduler jumps to the
    next arrival), admissions and steps driven by hand. Returns the tokens
    in submission order, the slot steps run, each step's host seconds,
    the drive's wall seconds and tokens a second, p50/p95/p99 latency in
    steps, the KV bytes and peaks, and the attribution's sums."""
    import torch
    from repro_torch.obs.metrics import percentile
    t, i, n = 0, 0, len(mels)
    rid2idx, done_at, step_s = {}, {}, []
    torch.cuda.synchronize()
    wall0 = time.perf_counter()
    while i < n or sched.n_queued or sched.n_active:
        while i < n and arrivals[i] <= t:
            rid2idx[sched.submit(mels[i], max_new=max_news[i])] = i
            i += 1
        sched.admit()
        if sched.n_active:
            t0 = time.perf_counter()
            events = sched.decode_step()
            if events:
                step_s.append(time.perf_counter() - t0)
            for ev in events:
                if ev.done:
                    done_at[rid2idx[ev.rid]] = t + 1
            t += 1
        elif i < n:
            t = int(arrivals[i])
    torch.cuda.synchronize()            # a device assert would surface here
    wall = time.perf_counter() - wall0
    got = sched.finished
    rids = sorted(rid2idx, key=rid2idx.get)
    tokens = sum(got[r].steps for r in rids)
    lat = [done_at[k] - float(arrivals[k]) for k in sorted(done_at)]
    att = sched.attribution(power_w)
    return dict(
        tokens=[got[r].tokens for r in rids], slot_steps=len(step_s),
        step_s=step_s, wall_s=wall, n_tokens=tokens, tok_s=tokens / wall,
        **{f"p{q}_steps": percentile(lat, q) for q in (50, 95, 99)},
        kv_committed_bytes=sched.kv_committed_bytes,
        kv_used_peak_bytes=sched.kv_used_peak,
        kv_utilization=sched.kv_utilization_peak,
        active_peak=sched.active_peak,
        per_request_pdp_j=sum(att["per_request_pdp_j"].values()),
        batch_pdp_j=att["batch_pdp_j"])


def _ledger_want(eng, counts):
    """The ledger totals that committing each program's cached plan its
    count of times gives: {plan key: runs}."""
    out = {}
    for key, runs in counts.items():
        for f, v in eng._plans.plans[key].summary().items():
            if f.endswith("flops"):
                out[f] = out.get(f, 0) + v * runs
    return out


def _paged_gathers(pool):
    """One paged slot step's KV gathers, as the step runs them: each
    layer's self K and V through the block table and cross K and V through
    the cross table."""
    from repro_torch.models.attention import paged_window_gather
    ls = pool.state.layer_states
    for i in range(ls.self_k.shape[0]):
        for arena, table in ((ls.self_k, ls.block_table),
                             (ls.self_v, ls.block_table),
                             (ls.cross_k, ls.cross_table),
                             (ls.cross_v, ls.cross_table)):
            paged_window_gather(arena[i], table)


def paged_path(label, eng0, counted, programs, replay_kernels, batch1,
               slot4):
    """Phase 11, on one path: benchmarks/paged_serving.py's three modes on
    one new engine (max_len PG_MAX_LEN, no EOS) with ``eng0``'s weights
    and quantization, each over its own pool and the same arrival trace
    (``_pg_workload``): the paged pool (PG_SLOTS logical slots over the
    reference's page geometry), the tight arena (SLOTS slots, 2 + 2 x
    pages_per self pages: it must preempt) and the contiguous pool (SLOTS
    slots). The paged pool drives first, so that its first admission
    captures the batch-1 prefill, the batch-1 step (the replays') and its
    slot step. The launch counts are zeroed just before each drive and
    read just after: CAPTURE_PASSES runs of each program captured in that
    drive (``programs``: the prefill's and a step's launches), nothing
    else. Fails unless every request's tokens agree across the modes and
    with the first max_new tokens of a batch-1 ``transcribe`` of its mel;
    the tight arena preempted and the paged pool had a prefix hit; each
    pool captured one slot step and the engine the batch-1 step once; the
    ledger's commits equal prefills + slot steps + replays and its FLOPs
    the plans' times prefills, slot steps and replayed steps; per-request
    PDP sums to the batch's; the paged pool admits at least 2x the
    contiguous pool's requests per committed byte; a profiled paged slot
    step holds ``replay_kernels["step"]``; a free slot's length passes
    max_len with no device assert. Printed: each mode's tokens a second,
    latency percentiles in steps, committed KV bytes, peak utilization
    and activity (tokens a second and the steps' host time from the same
    drive repeated on the warm pool, whose tokens, captures and launches
    are checked too); the paged slot step's device time, idle share and
    top kernels beside ``slot4`` (phase 10's 4-slot step) and ``batch1``
    (phase 6's step), the gathers' device time; the replay's device time
    a token; preemptions and prefix hits."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.core import energy
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    cfg = eng0.cfg
    f = cfg.encoder_ctx
    power_w = energy.card_power_limit_w(0)
    eng = ServeEngine(cfg, eng0.params, max_len=PG_MAX_LEN,
                      quant=eng0._serve_quant, offload=OffloadEngine(),
                      eos_id=-1, device="cuda")
    mels, distinct, which, max_news, arrivals = _pg_workload(cfg)
    pages_per = -(-(int(np.mean(max_news)) + 1) // PG_PAGE)
    cross = dict(cross_page_size=f, n_cross_pages=1 + PG_DISTINCT)
    geom = dict(page_size=PG_PAGE, n_pages=1 + PG_SLOTS * pages_per, **cross)
    tight = dict(page_size=PG_PAGE, n_pages=2 + 2 * pages_per, **cross)
    pre_prog, step_prog = programs
    pre1, step1 = eng._key("prefill", 1, f), eng._key("step", 1, f)
    modes = (
        ("paged", lambda: eng.paged_scheduler(PG_SLOTS, f, **geom),
         (pre_prog, step_prog, step_prog), 2),
        ("tight", lambda: eng.paged_scheduler(SLOTS, f, **tight),
         (step_prog,), 1),
        ("contiguous", lambda: eng.scheduler(n_slots=SLOTS, n_frames=f),
         (step_prog,), 1))
    runs, scheds, launches_by_mode = {}, {}, {}
    for mode, make, captured, n_captures in modes:
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        captures0, commits0 = eng._step_captures, eng.offload.ledger.commits
        stats0 = _stats(eng.offload)
        sched = make()
        r = _pg_drive(sched, mels, max_news, arrivals, power_w)
        launches = {name: fn.launches for name, fn in counted.items()}
        want = {name: CAPTURE_PASSES * sum(p.get(name, 0) for p in captured)
                for name in counted}
        captures = eng._step_captures - captures0
        commits = eng.offload.ledger.commits - commits0
        paged = mode != "contiguous"
        prefills = sched.prefills if paged else PG_REQUESTS
        replays = sched.replays if paged else 0
        replayed = sched.replayed_steps if paged else 0
        counts = {pre1: prefills, sched._step_key: r["slot_steps"]}
        if replayed:
            counts[step1] = replayed
        delta = _ledger_delta(_stats(eng.offload), stats0)
        flops = {k: delta[k] for k in _ledger_want(eng, counts)}
        r.update(launches=launches, step_captures=captures,
                 ledger_commits=commits, prefills=prefills, replays=replays,
                 replayed_steps=replayed,
                 preemptions=getattr(sched, "preemptions", 0),
                 shared_hits=getattr(sched, "shared_hits", 0))
        # the same drive again on the warm pool (nothing left to capture):
        # its wall time gives the tokens a second and the steps' host time
        sched.run()                       # claims the first drive's results
        for fn in counted.values():
            fn.launches = 0
        captures0 = eng._step_captures
        warm = _pg_drive(sched, mels, max_news, arrivals, power_w)
        if (warm["tokens"] != r["tokens"] or eng._step_captures != captures0
                or any(fn.launches for fn in counted.values())):
            raise AssertionError(f"paged {label} {mode}: the warm drive's "
                                 "tokens, captures or launches differ")
        r.update(first_drive_wall_s=r["wall_s"], wall_s=warm["wall_s"],
                 tok_s=warm["tok_s"], step_s=warm["step_s"])
        print(f"paged {label} {mode}: {r['n_tokens']} tokens, "
              f"{r['slot_steps']} slot steps in {r['wall_s'] * 1e3:.3f} ms "
              f"warm ({r['tok_s']:.1f} tok/s; the first drive, its captures "
              f"included, {r['first_drive_wall_s'] * 1e3:.3f} ms); latency "
              f"p50/p95/p99 "
              f"{r['p50_steps']}/{r['p95_steps']}/{r['p99_steps']} steps; "
              f"KV committed {r['kv_committed_bytes']} B, used peak "
              f"{r['kv_used_peak_bytes']} B, utilization "
              f"{r['kv_utilization']:.4f}, peak active {r['active_peak']}; "
              f"preemptions {r['preemptions']}, prefix hits "
              f"{r['shared_hits']}, prefills {prefills}, replays {replays} "
              f"({replayed} steps); launches from Python {launches} "
              f"(expected {want}); step captures {captures}; ledger commits "
              f"{commits}", flush=True)
        if launches != want:
            raise AssertionError(f"paged {label} {mode}: launches "
                                 f"{launches} != {want}")
        if captures != n_captures:
            raise AssertionError(f"paged {label} {mode}: {captures} step "
                                 f"captures, expected {n_captures}")
        if commits != prefills + r["slot_steps"] + replays:
            raise AssertionError(f"paged {label} {mode}: {commits} commits "
                                 f"for {prefills} prefills, "
                                 f"{r['slot_steps']} steps, {replays} "
                                 "replays")
        if flops != _ledger_want(eng, counts):
            raise AssertionError(f"paged {label} {mode}: ledger {flops} != "
                                 f"plans x runs {_ledger_want(eng, counts)}")
        if not abs(r["per_request_pdp_j"] - r["batch_pdp_j"]) <= \
                1e-9 * r["batch_pdp_j"]:
            raise AssertionError(f"paged {label} {mode}: per-request PDP "
                                 f"{r['per_request_pdp_j']} != batch "
                                 f"{r['batch_pdp_j']}")
        runs[mode], scheds[mode], launches_by_mode[mode] = r, sched, launches

    # batch-1 transcribe of each distinct utterance (its graphs exist: the
    # paged pool captured them); each request's tokens are its first max_new
    captures0 = eng._step_captures
    full = [eng.transcribe(m, max_new=PG_MAX_LEN)[0].tokens for m in distinct]
    refs = [full[w][:n] for w, n in zip(which, max_news)]
    same = {mode: sum(a == b for a, b in zip(r["tokens"], refs))
            for mode, r in runs.items()}
    print(f"paged {label}: tokens equal batch-1 transcribe for {same} of "
          f"{PG_REQUESTS} requests; step captures by the transcribes "
          f"{eng._step_captures - captures0}", flush=True)
    if any(n != PG_REQUESTS for n in same.values()):
        raise AssertionError(f"paged {label}: tokens differ: {same}")
    if eng._step_captures != captures0:
        raise AssertionError(f"paged {label}: transcribe captured the "
                             "batch-1 step again")
    sp, st = scheds["paged"], scheds["tight"]
    rpb = {mode: runs[mode]["active_peak"] / runs[mode]["kv_committed_bytes"]
           for mode in ("paged", "contiguous")}
    if not st.preemptions or not st.replays:
        raise AssertionError(f"paged {label}: the tight arena preempted "
                             f"{st.preemptions} times, replayed {st.replays}")
    if not sp.shared_hits:
        raise AssertionError(f"paged {label}: no prefix hit")
    if not rpb["paged"] >= 2 * rpb["contiguous"]:
        raise AssertionError(f"paged {label}: requests per committed byte "
                             f"{rpb['paged']} < 2 x {rpb['contiguous']}")

    # a free slot drifts: one request of max_len tokens on the paged pool
    # while the other slots are free; their lengths pass max_len
    rid = sp.submit(distinct[0], max_new=PG_MAX_LEN)
    drift = sp.run()[rid].tokens
    torch.cuda.synchronize()
    lengths = sp.pool.state.layer_states.length[0].tolist()
    past = sum(n > PG_MAX_LEN for n in lengths)
    print(f"paged {label}: a request of {PG_MAX_LEN} tokens on the drained "
          f"paged pool, tokens equal transcribe: {drift == full[0]}; slot "
          f"lengths {lengths} (max_len {PG_MAX_LEN})", flush=True)
    if drift != full[0] or not past:
        raise AssertionError(f"paged {label}: drift probe: tokens "
                             f"{drift == full[0]}, {past} slots past max_len")

    # the paged slot step under the profiler; a window whose kernels
    # differ from the graph's lost records and is profiled again
    for attempt in range(REPLAY_PROFILES):
        kernels, top, wall = _profile_slot_steps(sp)
        seen = {name: n for name, (n, _) in
                by_route(kernels, replay_kernels["step"]).items()}
        if seen == replay_kernels["step"]:
            break
        print(f"paged {label}: kernels per slot step {seen} in profiled "
              f"window {attempt + 1}, expected {replay_kernels['step']}; "
              "profiling again", flush=True)
    if seen != replay_kernels["step"]:
        raise AssertionError(f"paged {label}: kernels per paged slot step "
                             f"{seen} != {replay_kernels['step']}")
    dev = sum(ms for _, ms in kernels.values())
    host = statistics.median(runs["paged"]["step_s"]) * 1e3
    index = {name: v for name, v in kernels.items() if "index" in name}
    gather_ms, gather_src = device_ms(lambda: _paged_gathers(sp.pool))
    # the replay's batch-1 step (phase 6's profile over this engine's
    # static buffers: a prefill replay resets them, then the steps)
    rep = _profile_replays(eng, f)
    out = dict(
        path=label, requests=PG_REQUESTS, frames=f, max_len=PG_MAX_LEN,
        geometry=dict(paged=dict(slots=PG_SLOTS, **geom),
                      tight=dict(slots=SLOTS, **tight),
                      contiguous=dict(slots=SLOTS)),
        modes={mode: {k: v for k, v in r.items()
                      if k not in ("tokens", "step_s")}
               for mode, r in runs.items()},
        requests_per_byte_ratio=rpb["paged"] / rpb["contiguous"],
        **{key: runs["tight"][key]
           for key in ("preemptions", "replays", "replayed_steps")},
        shared_hits=runs["paged"]["shared_hits"],
        tight_shared_hits=runs["tight"]["shared_hits"],
        paged_step_host_ms_median=host,
        paged_step_wall_ms_profiled=wall, paged_step_device_ms=dev,
        paged_step_idle_share=1 - dev / wall,
        paged_step_idle_share_unprofiled=1 - dev / host,
        paged_step_kernels=seen, paged_step_top_kernels=top,
        paged_step_index_kernels={k[:80]: v for k, v in index.items()},
        paged_step_index_device_ms=sum(ms for _, ms in index.values()),
        gathers_device_ms=gather_ms, gathers_ms_source=gather_src,
        replay_device_ms_per_token=sum(ms for _, ms in rep[3].values()),
        replay_wall_ms_per_token_profiled=rep[5],
        slot4_step_device_ms=slot4.get("slot_step_device_ms"),
        batch1_step_device_ms=batch1.get("decode_device_ms_per_step"),
        slot_lengths_after_drift=lengths, power_w=power_w)
    print(f"paged {label} summary: {json.dumps(out)}", flush=True)
    return launches_by_mode["paged"], out


def _echo_params(params, alpha: float):
    """benchmarks/speculative.py::_echo_params: every decoder block's self
    ``o``, cross ``o`` and ``ffn.down`` scaled by ``alpha``. At a small
    alpha the blocks approach the identity and, with tied embeddings, each
    model's argmax approaches its input token: draft and verifier agree on
    most positions despite independent random weights."""
    out = dict(params)
    out["dec_blocks"] = []
    for block in params["dec_blocks"]:
        block = dict(block)
        for arm, proj in (("self_attn", "o"), ("cross_attn", "o"),
                          ("ffn", "down")):
            block[arm] = dict(block[arm])
            block[arm][proj] = {key: leaf * alpha
                                for key, leaf in block[arm][proj].items()}
        out["dec_blocks"].append(block)
    return out


def _zero(counted):
    for fn in counted.values():
        fn.launches = 0


def _read(counted):
    return {name: fn.launches for name, fn in counted.items()}


def _plan_launches(*plans):
    """The kernel launches one run of each plan makes: its entries with a
    main segment, by kernel."""
    out = {}
    for plan in plans:
        for e in plan:
            if e.k_main:
                out[e.kernel] = out.get(e.kernel, 0) + 1
    return out


def _role_flops(eng, counts):
    """Whole-linear FLOPs (``by_role``'s measure) of committing each of
    ``eng``'s cached plans its count of times: {plan key: runs}."""
    return sum(e.flops * runs for key, runs in counts.items()
               for e in eng._plans.plans[key])


def rung_pdp(arch: str, seed: int, tiny_power):
    """Phase 12a, on one rung of the paper's ladder: captured ``transcribe``
    of whisper-base or whisper-small at its published widths, Q8_0 through
    an untuned offload engine, seeded random weights, 1500 frames and
    PAPER_TOKENS tokens, no EOS: prefill ms, decode ms a token and the
    transcript's PDP at the power limit (the median of SPEC_RUNG_REQUESTS
    requests after the capturing one), beside phase 7's whisper-tiny
    figure, the port's 32 KB coverage of each model and the paper's."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import energy
    from repro_torch.core.coverage import coverage, enumerate_whisper
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)
    params = model.init_params(torch.Generator().manual_seed(seed), cfg,
                               device="cpu")
    eng = ServeEngine(cfg, params, max_len=PAPER_TOKENS + 8,
                      offload=OffloadEngine(), eos_id=-1, device="cuda")
    mel = np.random.default_rng(seed).standard_normal(
        (1, cfg.encoder_ctx, cfg.n_mels)).astype(np.float32)
    first = eng.transcribe(mel, max_new=PAPER_TOKENS)[0]
    runs = [eng.transcribe(mel, max_new=PAPER_TOKENS)[0]
            for _ in range(SPEC_RUNG_REQUESTS)]
    if any(r.tokens != first.tokens for r in runs) or \
            len(first.tokens) != PAPER_TOKENS:
        raise AssertionError(f"rung {arch}: captured transcripts differ or "
                             "stopped early")
    limit = energy.card_power_limit_w(0)
    total = statistics.median(r.total_s for r in runs)
    out = dict(
        arch=arch, frames=cfg.encoder_ctx, tokens=PAPER_TOKENS,
        layers=cfg.num_layers, d_model=cfg.d_model,
        prefill_ms=statistics.median(r.prefill_s for r in runs) * 1e3,
        decode_ms_per_token=statistics.median(
            r.decode_s for r in runs) * 1e3 / PAPER_TOKENS,
        transcript_s=total, power_limit_w=limit,
        pdp_at_limit_j=energy.pdp(total, limit),
        coverage_32kb=coverage(enumerate_whisper(cfg), 32),
        tiny_pdp_at_limit_j=tiny_power["pdp_at_limit_j"],
        tiny_transcript_s=tiny_power["transcript_median_s"],
        tiny_coverage_32kb=coverage(
            enumerate_whisper(get_config("whisper-tiny")), 32),
        paper_coverage_32kb={"tiny": 0.938, "base": 0.665, "small": 0.665},
        paper_tiny_pdp_j={"q8_0_imax": energy.PAPER_PDP_J[
            ("tiny", "q8_0", "imax")], "q8_0_rtx4090": energy.PAPER_PDP_J[
            ("tiny", "q8_0", "rtx4090")]},
        step_captures=eng._step_captures)
    print(f"rung {arch}: {json.dumps(out)}", flush=True)
    return out


def _window_vs_steps(spec, b: int, f: int, tol: float):
    """The verifier's window over the one-shot path's state at (b, f), as
    the last request left it (each row at its final length, real KV),
    eagerly beside k + 1 eager decode steps of the same tokens from the
    same state (the kernels the graphs captured): bit for bit at M = b x
    (k + 1) <= 16, else within ``tol``. The state is restored. Returns
    (max |logit difference|, bit-equal)."""
    import torch
    from repro_torch.models import model
    v, k = spec.verifier, spec.k
    rounds = spec._statics[(b, f)]
    st = rounds.v_state
    tok = rounds.window[:, :k + 1].clone()
    snap = [t.clone() for t in model.state_tensors(st)]
    with torch.no_grad():
        win, _ = model.verify_step(v._serve_params, v.cfg, tok, st,
                                   engine=v.offload)
        for t, s in zip(model.state_tensors(st), snap):
            t.copy_(s)
        seq = torch.cat([model.serve_step(v._serve_params, v.cfg,
                                          tok[:, j:j + 1], st,
                                          engine=v.offload)[0]
                         for j in range(k + 1)], dim=1)
        for t, s in zip(model.state_tensors(st), snap):
            t.copy_(s)
    torch.cuda.synchronize()
    diff = (win - seq).abs().max().item()
    exact = bool(torch.equal(win, seq))
    if b * (k + 1) <= 16 and not exact:
        raise AssertionError(f"window at M = {b * (k + 1)}: logits differ "
                             f"from the sequential steps' by {diff}")
    if not diff <= tol:
        raise AssertionError(f"window at M = {b * (k + 1)}: max |logit "
                             f"difference| {diff} > {tol}")
    return diff, exact


def _profile_round(spec, b: int, f: int):
    """One round of the one-shot path at (b, f) under torch.profiler: the
    k + 1 draft-step replays and the verify replay, each timed apart
    (``device_ms``: the draft's column index reset first, a one-element
    fill), and the window's top kernels by name. The replays run past the
    state's lengths (clamped, as a free slot's); the next request
    re-prefills."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rounds = spec._statics[(b, f)]
    dprog, vprog = rounds.programs

    def drafts():
        rounds.col.zero_()
        for _ in range(spec.k + 1):
            dprog.graph.replay()
    draft_ms, draft_src = device_ms(drafts)
    window_ms, window_src = device_ms(vprog.graph.replay)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        vprog.graph.replay()
        torch.cuda.synchronize()
    return dict(draft_steps_device_ms=draft_ms, draft_ms_source=draft_src,
                window_device_ms=window_ms, window_ms_source=window_src,
                window_top_kernels=_top_kernels(prof, 1, 8),
                window_kernels={name[:60]: n for name, (n, _) in
                                _by_kernel(prof).items()
                                if any(w in name for w in PORT_KERNEL_WORDS)})


def spec_case(label, v, spec, mel, max_new: int, tol: float, counted,
              power_w: float):
    """Phase 12b, one case: ``SpeculativeEngine.transcribe`` of ``mel``
    (B x 1500 frames) against the verifier's batch-1 ``transcribe`` of each
    row. The verifier's batch-B greedy ``transcribe`` runs first (its
    graphs), so the first speculative request captures exactly the
    draft's prefill, the draft step and the window: the launch counts,
    zeroed just before and read just after, must be CAPTURE_PASSES times
    those programs' plans. A second request (timed) must capture and
    launch nothing. Fails unless every row's tokens equal its batch-1
    transcribe's; on Q8_0, the commits equal prefills + 2 a round and
    each role's FLOPs its plans times prefills, rounds x (k + 1) draft
    steps and rounds windows, and ``by_role`` sums to the FLOP totals;
    the window's logits equal the sequential steps' (``_window_vs_steps``).
    Returns (launches, summary)."""
    import numpy as np
    import torch
    b, f = mel.shape[0], mel.shape[1]
    k, d = spec.k, spec.draft
    refs = [v.transcribe(mel[i:i + 1], max_new=max_new)[0].tokens
            for i in range(b)]
    v.transcribe(mel, max_new=max_new)               # the batch's graphs
    plain = v.transcribe(mel, max_new=max_new)
    stats0, commits0 = _stats(v.offload), v.offload.ledger.commits
    r0, dr0, a0 = spec.rounds, spec.drafted, spec.accepted
    torch.cuda.synchronize()
    _zero(counted)
    got = spec.transcribe(mel, max_new=max_new)
    torch.cuda.synchronize()
    launches = _read(counted)
    rounds = spec._statics[(b, f)]
    want = {name: 0 for name in counted}
    for name, n in _plan_launches(
            d._plans.plans[d._key("prefill", b, f)], rounds.d_plan,
            rounds.v_plan).items():
        want[name] = CAPTURE_PASSES * n
    captures = (v._verify_captures, d._step_captures)
    r1 = spec.rounds
    _zero(counted)
    got2 = spec.transcribe(mel, max_new=max_new)
    torch.cuda.synchronize()
    launches2 = _read(counted)
    n_rounds, rounds2 = spec.rounds - r0, spec.rounds - r1
    tokens = [r.tokens for r in got]
    same = sum(t == r for t, r in zip(tokens, refs))
    acceptance = (spec.accepted - a0) / max(spec.drafted - dr0, 1)
    spec_tok_s = sum(r.steps for r in got2) / sum(r.decode_s for r in got2)
    plain_tok_s = sum(r.steps for r in plain) / sum(r.decode_s for r in plain)
    spec_s = sum(r.total_s for r in got2) / b
    plain_s = sum(r.total_s for r in plain) / b
    commits = v.offload.ledger.commits - commits0
    delta = _ledger_delta(_stats(v.offload), stats0)
    roles = {role: delta["by_role"].get(role, 0)
             for role in ("verify", "draft")}
    runs_v = {v._key("prefill", b, f): 2, rounds.v_key: n_rounds}
    runs_d = {d._key("prefill", b, f): 2, rounds.d_key: n_rounds * (k + 1)}
    want_roles = {"verify": _role_flops(v, runs_v),
                  "draft": _role_flops(d, runs_d)}
    s = v.offload.stats
    sums = sum(s.by_role.values()) == (s.offloaded_flops + s.fallback_flops
                                       + s.residual_flops)
    ledger = dict(commits=commits, by_role_delta=roles,
                  by_role_want=want_roles, by_role_sum_equals_flops=sums)
    if commits != 2 * 2 + 2 * n_rounds or roles != want_roles or not sums:
        raise AssertionError(f"spec {label}: ledger {ledger}, rounds "
                             f"{n_rounds}")
    diff, exact = _window_vs_steps(spec, b, f, tol)
    prof = _profile_round(spec, b, f)
    round_host_ms = sum(r.decode_s for r in got2) * 1e3 / rounds2
    round_dev = prof["draft_steps_device_ms"] + prof["window_device_ms"]
    out = dict(
        case=label, batch=b, k=k, window_m=b * (k + 1), max_new=max_new,
        quant=v._serve_quant, rows_equal_transcribe=same,
        rounds=rounds2, acceptance=acceptance,
        spec_tok_s=spec_tok_s, plain_tok_s=plain_tok_s,
        speedup=spec_tok_s / plain_tok_s,
        spec_transcript_s=spec_s, plain_transcript_s=plain_s,
        spec_pdp_at_limit_j=spec_s * power_w,
        plain_pdp_at_limit_j=plain_s * power_w, power_w=power_w,
        launches=launches, launches_expected=want,
        launches_second_request=launches2, captures=captures,
        window_max_abs_logit_diff=diff, window_bit_equal=exact,
        round_host_ms=round_host_ms, round_device_ms=round_dev,
        round_idle_share=1 - round_dev / round_host_ms, **prof, **ledger)
    print(f"spec {label}: {json.dumps(out)}", flush=True)
    if same != b:
        raise AssertionError(f"spec {label}: {same} of {b} rows equal "
                             f"transcribe: {tokens} vs {refs}")
    if [r.tokens for r in got2] != tokens:
        raise AssertionError(f"spec {label}: the second request's tokens "
                             "differ")
    if launches != want or any(launches2.values()):
        raise AssertionError(f"spec {label}: launches {launches} (expected "
                             f"{want}), then {launches2}")
    if (v._verify_captures, d._step_captures) != captures:
        raise AssertionError(f"spec {label}: recaptured")
    if not np.isfinite(out["speedup"]):
        raise AssertionError(f"spec {label}: no tokens a second")
    return launches, out


def _ps_workload(cfg):
    """benchmarks/paged_speculative.py::_workload at its full setting from
    default_rng(0) in the reference's order: its PS_REQUESTS mels of
    PS_REF_FRAMES frames (drawn and discarded: the trace stays the
    reference's), the max_news in PS_BUDGETS, the Poisson arrival rounds
    at 2x load on 2 slots. Each request's mel is then a 1500-frame mel
    from default_rng(1). Returns (mels, max_news, arrivals)."""
    import numpy as np
    rng = np.random.default_rng(0)
    for _ in range(PS_REQUESTS):
        rng.standard_normal((1, PS_REF_FRAMES, cfg.n_mels))
    lo, hi = PS_BUDGETS
    max_news = [int(rng.integers(lo, hi + 1)) for _ in range(PS_REQUESTS)]
    mean_gap = float(np.mean(max_news)) / (PS_K + 1) / (2 * 2)
    arrivals = np.floor(np.cumsum(rng.exponential(mean_gap, PS_REQUESTS)))
    real = np.random.default_rng(1)
    mels = [real.standard_normal((1, cfg.encoder_ctx, cfg.n_mels)
                                 ).astype(np.float32)
            for _ in range(PS_REQUESTS)]
    return mels, max_news, arrivals


def _ps_drive(sched, mels, max_news, arrivals, power_w):
    """benchmarks/paged_speculative.py::_drive: the arrival trace on a
    virtual clock of one unit a round (an idle scheduler jumps to the next
    arrival), counting admissions that land while earlier requests hold
    live rows. Returns the tokens in submission order, rounds, wall
    seconds, tokens a second, mid-flight admissions and the attribution's
    sums."""
    import torch
    t, i, n = 0, 0, len(mels)
    rid2idx, midflight, rounds = {}, 0, 0
    torch.cuda.synchronize()
    wall0 = time.perf_counter()
    while i < n or sched.n_queued or sched.n_active:
        while i < n and arrivals[i] <= t:
            rid2idx[sched.submit(mels[i], max_new=max_news[i])] = i
            i += 1
        was_active = sched.n_active
        admitted = sched.admit()
        if was_active and admitted:
            midflight += len(admitted)
        if sched.n_active:
            sched.decode_step()
            rounds += 1
            t += 1
        elif i < n:
            t = int(arrivals[i])
    torch.cuda.synchronize()            # a device assert would surface here
    wall = time.perf_counter() - wall0
    got = sched.finished
    rids = sorted(rid2idx, key=rid2idx.get)
    n_tok = sum(got[r].steps for r in rids)
    att = sched.attribution(power_w)
    return dict(tokens=[got[r].tokens for r in rids], rounds=rounds,
                wall_s=wall, n_tokens=n_tok, tok_s=n_tok / wall,
                midflight=midflight,
                per_request_pdp_j=sum(att["per_request_pdp_j"].values()),
                batch_pdp_j=att["batch_pdp_j"])


def spec_schedulers(v, spec, counted, power_w):
    """Phase 12c: benchmarks/paged_speculative.py's trace (``_ps_workload``)
    over PS_SLOTS slots at k = PS_K, driven four ways on one echo Q8_0
    verifier (max_len PS_MAX_LEN): the ``SpecScheduler`` wave, the
    ``SpecContinuousScheduler``, the ``PagedSpecScheduler`` (pages of
    PS_PAGE, 1 + 2 x pages_per self pages, a 1500-frame cross page a
    request and 1 + 2 cross pages) and its tight arena (1 + pages_per self
    pages). The launch counts are zeroed before each mode's first drive
    and read after it: only that drive's captures launch. Fails unless
    every request's tokens equal the wave's and its batch-1
    ``transcribe``'s; the tight arena preempted; admissions landed
    mid-flight; each pool captured one window and one draft step (the
    first paged pool also the draft's batch-1 step, for replays); commits
    equal 2 x (prefills + replays + rounds) and the ledger's FLOPs by role
    the plans times their runs; per-request PDP sums to the batch's (rel
    1e-9); a repeated drive on the warm pool gives the same tokens with
    no capture and no launch; a free slot past max_len takes a round with
    no device assert. Printed: each mode's tokens a second (the warm
    drive), acceptance, preemptions, trimmed pages, committed KV bytes.
    Returns (launches over the drives, summary)."""
    import numpy as np
    import torch
    from repro_torch.models import model
    from repro_torch.serve.speculative import SpecScheduler

    cfg, d, k = v.cfg, spec.draft, spec.k
    f = cfg.encoder_ctx
    mels, max_news, arrivals = _ps_workload(cfg)
    refs = [v.transcribe(m, max_new=n)[0].tokens
            for m, n in zip(mels, max_news)]
    pages_per = -(-PS_MAX_LEN // PS_PAGE)
    cross = dict(cross_page_size=f, n_cross_pages=1 + PS_SLOTS)
    geom = dict(page_size=PS_PAGE, n_pages=1 + PS_SLOTS * pages_per, **cross)
    tight = dict(page_size=PS_PAGE, n_pages=1 + pages_per, **cross)
    total = {name: 0 for name in counted}
    out, wave = {}, None
    for mode in ("wave", "continuous", "paged", "tight"):
        caps0 = (v._verify_captures, d._step_captures)
        commits0, stats0 = v.offload.ledger.commits, _stats(v.offload)
        r0, dr0, a0 = spec.rounds, spec.drafted, spec.accepted
        torch.cuda.synchronize()
        _zero(counted)
        if mode == "wave":
            sched = SpecScheduler(spec, n_slots=PS_SLOTS)
            t0 = time.perf_counter()
            rids = [sched.submit(m, max_new=n)
                    for m, n in zip(mels, max_news)]
            res = sched.run()
            torch.cuda.synchronize()
            r = dict(tokens=[res[i].tokens for i in rids],
                     wall_s=time.perf_counter() - t0, midflight=0,
                     rounds=spec.rounds - r0)
        else:
            sched = (spec.continuous(PS_SLOTS, f) if mode == "continuous"
                     else spec.paged(PS_SLOTS, f,
                                     **(geom if mode == "paged" else tight)))
            r = _ps_drive(sched, mels, max_news, arrivals, power_w)
        launches = _read(counted)
        for name, n in launches.items():
            total[name] += n
        caps = (v._verify_captures - caps0[0], d._step_captures - caps0[1])
        commits = v.offload.ledger.commits - commits0
        delta = _ledger_delta(_stats(v.offload), stats0)
        rounds = spec.rounds - r0
        acc = (spec.accepted - a0) / max(spec.drafted - dr0, 1)
        paged = mode in ("paged", "tight")
        n_pre = sched.prefills if paged else PS_REQUESTS
        replays = sched.replays if paged else 0
        replayed = sched.replayed_steps if paged else 0
        if mode == "wave":
            waves = -(-PS_REQUESTS // PS_SLOTS)
            ok_commits = commits == 2 * waves + 2 * rounds
            rk = spec._statics[(PS_SLOTS, f)]
            want_flops = (_role_flops(v, {v._key("prefill", PS_SLOTS, f):
                                          waves, rk.v_key: rounds})
                          + _role_flops(d, {d._key("prefill", PS_SLOTS, f):
                                            waves,
                                            rk.d_key: rounds * (k + 1)}))
        else:
            rk = sched._spec_rounds
            ok_commits = commits == 2 * (n_pre + replays + rounds)
            runs_v = {v._key("prefill", 1, f): n_pre, rk.v_key: rounds}
            runs_d = {d._key("prefill", 1, f): n_pre,
                      rk.d_key: rounds * (k + 1)}
            if replayed:
                runs_v[v._key("step", 1, f)] = replayed
                runs_d[d._key("step", 1, f, role="draft")] = replayed
            want_flops = _role_flops(v, runs_v) + _role_flops(d, runs_d)
        flops = sum(delta["by_role"].values())
        ledger_flops = (delta["offloaded_flops"] + delta["fallback_flops"]
                        + delta["residual_flops"])
        want_caps = (1, 1 + (mode == "paged"))
        r.update(launches=launches, captures=caps, commits=commits,
                 rounds=rounds, acceptance=acc,
                 preemptions=getattr(sched, "preemptions", 0),
                 replays=replays, pages_trimmed=getattr(
                     sched, "pages_trimmed", 0),
                 shared_hits=getattr(sched, "shared_hits", 0),
                 flops=flops, flops_expected=want_flops)
        if mode != "wave":
            r.update(kv_committed_bytes=sched.kv_committed_bytes,
                     draft_kv_committed_bytes=sched._draft_pool
                     .committed_kv_bytes())
            sched.run()                       # claims the first drive's
            _zero(counted)
            caps1 = (v._verify_captures, d._step_captures)
            warm = _ps_drive(sched, mels, max_news, arrivals, power_w)
            if (warm["tokens"] != r["tokens"] or any(_read(counted).values())
                    or (v._verify_captures, d._step_captures) != caps1):
                raise AssertionError(f"spec sched {mode}: the warm drive's "
                                     "tokens, captures or launches differ")
            r.update(first_drive_wall_s=r["wall_s"], wall_s=warm["wall_s"],
                     tok_s=warm["tok_s"])
        else:
            t0 = time.perf_counter()
            rids = [sched.submit(m, max_new=n)
                    for m, n in zip(mels, max_news)]
            res = sched.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if [res[i].tokens for i in rids] != r["tokens"]:
                raise AssertionError("spec sched wave: the warm run's "
                                     "tokens differ")
            r.update(first_drive_wall_s=r["wall_s"], wall_s=wall,
                     tok_s=sum(map(len, r["tokens"])) / wall)
        same = sum(a == b for a, b in zip(r["tokens"], refs))
        shown = {key: val for key, val in r.items() if key != "tokens"}
        print(f"spec sched {mode}: {json.dumps(shown)}; tokens equal "
              f"transcribe for {same} of {PS_REQUESTS}", flush=True)
        if same != PS_REQUESTS or (wave is not None
                                   and r["tokens"] != wave):
            raise AssertionError(f"spec sched {mode}: tokens differ")
        if caps != want_caps:
            raise AssertionError(f"spec sched {mode}: captures {caps}, "
                                 f"expected {want_caps}")
        if not ok_commits or flops != want_flops or flops != ledger_flops:
            raise AssertionError(f"spec sched {mode}: commits {commits}, "
                                 f"FLOPs {flops} (plans x runs "
                                 f"{want_flops}, ledger {ledger_flops})")
        if r["shared_hits"]:
            raise AssertionError(f"spec sched {mode}: a prefix hit among "
                                 "distinct mels")
        if mode != "wave":
            if not abs(r["per_request_pdp_j"] - r["batch_pdp_j"]) <= \
                    1e-9 * r["batch_pdp_j"]:
                raise AssertionError(f"spec sched {mode}: per-request PDP "
                                     "does not sum to the batch's")
            if not r["midflight"]:
                raise AssertionError(f"spec sched {mode}: no admission "
                                     "landed mid-flight")
        if mode == "tight" and not r["preemptions"]:
            raise AssertionError("spec sched tight: no preemption")
        if mode == "wave":
            wave = r["tokens"]
        out[mode] = {key: val for key, val in r.items() if key != "tokens"}
        if mode == "continuous":
            cont = sched

    # a free slot past max_len takes a window: one request on the drained
    # contiguous pool with the other slot's counters set past max_len
    rid = cont.submit(mels[0], max_new=max_news[0])
    cont.admit()
    far = torch.full((PS_SLOTS,), PS_MAX_LEN + 5, dtype=torch.int32,
                     device="cuda")
    far[0] = 0
    model.set_slot_lengths(cont.pool.state, far)
    model.set_slot_lengths(cont._draft_pool.state, far)
    probe = cont.run()[rid].tokens
    torch.cuda.synchronize()
    print(f"spec sched: a free slot at length {PS_MAX_LEN + 5} (max_len "
          f"{PS_MAX_LEN}) beside a live request: tokens equal transcribe: "
          f"{probe == refs[0]}", flush=True)
    if probe != refs[0]:
        raise AssertionError("spec sched: the free-slot probe's tokens "
                             "differ")
    out.update(requests=PS_REQUESTS, slots=PS_SLOTS, k=PS_K,
               max_len=PS_MAX_LEN, geometry=dict(paged=geom, tight=tight),
               free_slot_probe_length=PS_MAX_LEN + 5)
    return total, out


def speculative_phase(counted, tiny_power):
    """Phase 12: speculative decoding at full width (12a-c; see the
    module docstring). Returns (launches on the speculative path, the
    summary)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import energy
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    power_w = energy.card_power_limit_w(0)
    rungs = [rung_pdp(arch, seed, tiny_power)
             for arch, seed in (("whisper-base", 30), ("whisper-small", 31))]
    base, tiny = get_config("whisper-base"), get_config("whisper-tiny")
    bp = model.init_params(torch.Generator().manual_seed(32), base,
                           device="cpu")
    tp = model.init_params(torch.Generator().manual_seed(33), tiny,
                           device="cpu")
    bp_echo, tp_echo = (_echo_params(bp, ECHO_ALPHA),
                        _echo_params(tp, ECHO_ALPHA))
    rng = np.random.default_rng(34)
    mel1 = rng.standard_normal((1, base.encoder_ctx, base.n_mels)
                               ).astype(np.float32)
    mel4 = rng.standard_normal((4, base.encoder_ctx, base.n_mels)
                               ).astype(np.float32)
    launches = {name: 0 for name in counted}

    def engine(params, quant, max_len):
        cfg = dataclasses.replace(base, quant=quant)
        return ServeEngine(cfg, params, max_len=max_len, quant=quant,
                           offload=OffloadEngine(), eos_id=-1,
                           device="cuda")

    cases = []
    v_raw = engine(bp, "q8_0", SPEC_MAX_LEN)
    v_echo = engine(bp_echo, "q8_0", SPEC_MAX_LEN)
    v_dense = engine(bp_echo, "none", SPEC_MAX_LEN)
    for label, v, tparams, mel, k, max_new, tol in (
            ("raw q8_0 b1 k4", v_raw, tp, mel1, 4, SPEC_RAW_MAX_NEW,
             FIRST_STEP_TOL),
            ("echo q8_0 b1 k4", v_echo, tp_echo, mel1, 4, SPEC_MAX_NEW,
             FIRST_STEP_TOL),
            ("echo q8_0 b4 k6", v_echo, tp_echo, mel4, 6, SPEC_MAX_NEW,
             FIRST_STEP_TOL),
            ("echo dense b4 k6", v_dense, tp_echo, mel4, 6, SPEC_MAX_NEW,
             DENSE_FIRST_STEP_TOL)):
        spec = v.speculative(tiny, tparams, k=k)
        got, summary = spec_case(label, v, spec, mel, max_new, tol,
                                 counted, power_w)
        for name, n in got.items():
            launches[name] += n
        cases.append(summary)
    v_ps = engine(bp_echo, "q8_0", PS_MAX_LEN)
    got, sched = spec_schedulers(v_ps, v_ps.speculative(tiny, tp_echo,
                                                        k=PS_K),
                                 counted, power_w)
    for name, n in got.items():
        launches[name] += n
    missing = [name for name in ("q8_matvec", "q8_matmul", "bf16_matmul")
               if not launches[name]]
    wall = time.perf_counter() - t0
    print(f"speculative phase: {wall:.1f}s; launches {launches}", flush=True)
    if missing:
        raise AssertionError(f"speculative path: {missing} never launched")
    return launches, dict(rungs=rungs, cases=cases, schedulers=sched,
                          wall_s=wall)


def _check_trace_module():
    """tools/check_trace.py, loaded by path (tools/ is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(ROOT, "tools", "check_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _te_workload(cfg):
    """benchmarks/telemetry_overhead.py's full trace from default_rng(0)
    in the reference's order: TE_REQUESTS mels of TE_REF_FRAMES frames
    (drawn and discarded: the trace stays the reference's), then the
    max_news in TE_BUDGETS; each request's mel is then a 1500-frame mel
    from default_rng(1). Returns (mels, max_news)."""
    import numpy as np
    rng = np.random.default_rng(0)
    for _ in range(TE_REQUESTS):
        rng.standard_normal((1, TE_REF_FRAMES, cfg.n_mels))
    lo, hi = TE_BUDGETS
    max_news = [int(rng.integers(lo, hi + 1)) for _ in range(TE_REQUESTS)]
    real = np.random.default_rng(1)
    mels = [real.standard_normal((1, cfg.encoder_ctx, cfg.n_mels)
                                 ).astype(np.float32)
            for _ in range(TE_REQUESTS)]
    return mels, max_news


def _lockstep(scheds, mels, max_news, arrivals, times, first):
    """One trace through both schedulers ({"off": ..., "on": ...}) in
    lockstep on a virtual clock of one unit a step (an idle pair jumps to
    the next arrival): each submits the same arrivals, admits, and takes
    one step, in turn, ``first`` going first; every ``decode_step`` is
    timed alone into ``times[mode]``. The schedules are identical (same
    trace, deterministic tokens), so each off/on pair of steps sees the
    same work and nearly the same machine state. Returns {mode: tokens in
    submission order}."""
    t, i, n = 0, 0, len(mels)
    rids = {mode: [] for mode in scheds}
    order = [first] + [m for m in scheds if m != first]
    while i < n or any(s.n_queued or s.n_active for s in scheds.values()):
        while i < n and arrivals[i] <= t:
            for mode, s in scheds.items():
                rids[mode].append(s.submit(mels[i], max_new=max_news[i]))
            i += 1
        stepped = False
        for mode in order:
            s = scheds[mode]
            s.admit()
            if s.n_active:
                t0 = time.perf_counter()
                s.decode_step()
                times[mode].append(time.perf_counter() - t0)
                stepped = True
        if stepped:
            t += 1
        elif i < n:
            t = int(arrivals[i])
    out = {}
    for mode, s in scheds.items():
        got = s.run()                   # claims the results, flushes metrics
        out[mode] = [got[r].tokens for r in rids[mode]]
    if len(times["on"]) != len(times["off"]):
        raise AssertionError(f"lockstep: {len(times['on'])} telemetry-on "
                             f"steps against {len(times['off'])} off")
    return out


def _overhead(times):
    """benchmarks/telemetry_overhead.py's estimate: the median of the
    paired per-step deltas over the median telemetry-off step."""
    import statistics
    deltas = [a - b for a, b in zip(times["on"], times["off"])]
    med = {mode: statistics.median(ts) for mode, ts in times.items()}
    return statistics.median(deltas) / med["off"], med, len(deltas)


def _tele_checks(tele, label, rids):
    """The telemetry-on engine's invariants: the ledger exact, every
    phase closed and every submitted rid among the closed, per-track
    nesting, ``sum(bucket_counts) == count`` for every histogram, and the
    Perfetto JSON (written under build/telemetry/) valid by
    tools/check_trace.py. Raises on any failure; returns the record."""
    tr = tele.tracer
    cons = tele.ledger_consistent()
    path = tele.write_trace(os.path.join(
        ROOT, "build", "telemetry", label.replace(" ", "_") + ".json"))
    with open(path) as fh:
        errors = _check_trace_module().validate(json.load(fh))
    snap = tele.snapshot()
    checks = {
        "ledger_exact": bool(cons["exact"]),
        "phases_closed": (tr.all_closed() and not tr.open_phases()
                          and tr.rids_closed == tr.rids_opened
                          and set(rids) <= tr.rids_closed),
        "nesting_ok": tr.check_nesting() == [],
        "histogram_sums": all(
            sum(c for _, c in h["buckets"]) == h["count"]
            for h in snap["metrics"]["histograms"].values()),
        "trace_valid": not errors}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"telemetry {label}: {failed} failed "
                             f"({cons}; trace: {errors[:5]})")
    return dict(checks=checks, ledger=cons, trace=snap["trace"],
                spans=dict(sorted(collections.Counter(
                    s.name for s in tr.spans).items())),
                events=dict(sorted(collections.Counter(
                    e.name for e in tr.events).items())))


def telemetry_gate(q8_eng, counted):
    """Phase 13a: benchmarks/telemetry_overhead.py on the card. Two
    whisper-tiny engines at published widths with ``q8_eng``'s weights
    (Q8_0, untuned ``OffloadEngine()``, max_len 32, no EOS), one with
    ``Telemetry()`` and one without, each over a SLOTS-slot pool. Each
    drains TE_WARM requests to warm up (the pool's captures), the launch
    counts zeroed before and read after each engine's warm-up; then
    TE_ROUNDS lockstep drains of the trace (``_te_workload``), the first
    mover alternating by round. Fails unless the overhead (``_overhead``)
    is at most TE_BUDGET; both engines gave the same tokens, launched the
    same kernels from Python at their captures and captured one slot step
    each, none after the warm-up; a replayed slot step of each holds the
    same kernels by name and count; and the telemetry-on engine's
    invariants hold (``_tele_checks``). Printed beside the overhead, not
    gated: TE_BARE paired replays of each pool's slot step with its host
    sync and nothing else, whose gap is the engines' own, telemetry
    apart. Returns the launches."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    cfg = q8_eng.cfg
    f = cfg.encoder_ctx
    mels, max_news = _te_workload(cfg)
    engines, scheds, warm = {}, {}, {}
    for mode in ("off", "on"):
        torch.cuda.synchronize()
        _zero(counted)
        eng = engines[mode] = ServeEngine(
            cfg, q8_eng.params, max_len=TE_BUDGETS[1] + 8, quant="q8_0",
            offload=OffloadEngine(), eos_id=-1, device="cuda",
            telemetry=obs.Telemetry() if mode == "on" else None)
        s = scheds[mode] = eng.scheduler(SLOTS, f)
        for m, n in zip(mels[:TE_WARM], max_news[:TE_WARM]):
            s.submit(m, max_new=n)
        s.run()
        torch.cuda.synchronize()
        warm[mode] = _read(counted)
    captures0 = {mode: e._step_captures for mode, e in engines.items()}
    times = {"off": [], "on": []}
    _zero(counted)
    tokens = None
    for r in range(TE_ROUNDS):
        got = _lockstep(scheds, mels, max_news, np.zeros(TE_REQUESTS),
                        times, "on" if r % 2 else "off")
        if got["on"] != got["off"] or (tokens is not None
                                       and got["on"] != tokens):
            raise AssertionError("telemetry gate: telemetry-on tokens "
                                 "differ from telemetry-off tokens")
        tokens = got["on"]
    torch.cuda.synchronize()
    replays = _read(counted)
    overhead, med, pairs = _overhead(times)
    # the control: each pool's slot-step replay and its host sync alone,
    # paired the same way, with no scheduler and no telemetry code: what
    # the two engines' graphs differ by on their own
    bare = {"off": [], "on": []}
    for _ in range(TE_BARE):
        for mode in ("off", "on"):
            s = scheds[mode]
            t0 = time.perf_counter()
            s._program.graph.replay()
            s._token[:, 0].tolist()
            bare[mode].append(time.perf_counter() - t0)
    bare_gap, bare_med, _ = _overhead(bare)
    kernels = {mode: {k: v[0] for k, v in
                      _profile_slot_steps(scheds[mode])[0].items()}
               for mode in scheds}
    matvec = sum(n for k, n in kernels["on"].items()
                 if "q8_matvec_kernel" in k)
    tele = engines["on"].telemetry
    record = _tele_checks(tele, "gate q8_0", range(
        TE_WARM + TE_ROUNDS * TE_REQUESTS))
    captures = {mode: e._step_captures for mode, e in engines.items()}
    out = dict(overhead=overhead, overhead_x=1 + overhead,
               budget=TE_BUDGET, pairs=pairs,
               median_step_ms={k: v * 1e3 for k, v in med.items()},
               bare_replay_ms={k: v * 1e3 for k, v in bare_med.items()},
               bare_replay_gap=bare_gap,
               captures=captures, launches_warm=warm,
               launches_lockstep=replays,
               replay_kernels={"equal": kernels["on"] == kernels["off"],
                               "distinct": len(kernels["on"]),
                               "launches": sum(kernels["on"].values()),
                               "q8_matvec_kernel": matvec},
               tokens=sum(len(t) for t in tokens) * TE_ROUNDS, **record)
    print(f"telemetry gate q8_0: {json.dumps(out)}", flush=True)
    problems = []
    if overhead > TE_BUDGET:
        problems.append(f"overhead {overhead:.4f} > {TE_BUDGET}")
    if warm["on"] != warm["off"] or not warm["on"]["q8_matvec"]:
        problems.append(f"capture launches differ: {warm}")
    if any(captures[m] != 1 or captures0[m] != 1 for m in captures):
        problems.append(f"step captures {captures0} -> {captures}")
    if any(replays.values()):
        problems.append(f"launches from Python after the warm-up: {replays}")
    if kernels["on"] != kernels["off"] or matvec != 33:
        problems.append(f"replayed slot step kernels: {matvec} "
                        "q8_matvec_kernel, or on and off differ")
    if problems:
        raise AssertionError(f"telemetry gate: {problems}")
    return {name: warm["on"][name] + warm["off"][name] for name in counted}


def _te_pair(make, label, mels, max_news, arrivals, counted):
    """One telemetry drive (13b): ``make(telemetry)`` builds a scheduler
    (its own engine); the off and on schedulers take the trace in
    lockstep, the launch counts zeroed before and read after (the pools'
    captures). Fails unless both gave the same tokens and the same step
    and window captures, and the on engine's invariants hold. Returns
    (the on scheduler, the record, the launches)."""
    import torch
    from repro_torch import obs
    torch.cuda.synchronize()
    _zero(counted)
    scheds = {"off": make(None), "on": make(obs.Telemetry())}
    times = {"off": [], "on": []}
    got = _lockstep(scheds, mels, max_news, arrivals, times, "off")
    torch.cuda.synchronize()
    launches = _read(counted)
    if got["on"] != got["off"]:
        raise AssertionError(f"telemetry {label}: telemetry-on tokens "
                             "differ from telemetry-off tokens")
    caps = {mode: (s.engine._step_captures, s.engine._verify_captures)
            for mode, s in scheds.items()}
    if caps["on"] != caps["off"]:
        raise AssertionError(f"telemetry {label}: captures differ {caps}")
    s = scheds["on"]
    tele = s.engine.telemetry
    record = _tele_checks(tele, label, range(len(mels)))
    overhead, med, pairs = _overhead(times)
    record.update(
        overhead=overhead, overhead_x=1 + overhead, pairs=pairs,
        median_step_ms={k: v * 1e3 for k, v in med.items()},
        captures=caps, preemptions=s.preemptions,
        preemptions_counter=tele.metrics.counter(
            "repro_preemptions_total").value(),
        prefix_hits=s.shared_hits, launches=launches,
        tokens=sum(len(t) for t in got["on"]))
    if record["preemptions_counter"] != s.preemptions:
        raise AssertionError(f"telemetry {label}: repro_preemptions_total "
                             f"{record['preemptions_counter']} != "
                             f"{s.preemptions} preemptions")
    print(f"telemetry {label}: {json.dumps(record)}", flush=True)
    print(f"telemetry {label} overhead (not gated): {overhead:+.4%} of a "
          f"{med['off'] * 1e3:.3f} ms step", flush=True)
    return s, record, launches


def telemetry_drives(q8_eng, counted):
    """Phase 13b: telemetry on the paged pool (phase 11's paged geometry
    on ``_pg_workload``'s 24-request trace, whisper-tiny Q8_0, max_len
    PG_MAX_LEN) and on the speculative paged scheduler (phase 12c's tight
    pool on ``_ps_workload``'s 14-request trace: an echo whisper-base Q8_0
    verifier, an echo whisper-tiny draft, k = PS_K), each against its
    telemetry-off twin in lockstep (``_te_pair``). Fails unless the
    invariants hold, ``prefix_hit`` (paged) and ``preempt``, ``replay``
    and ``spec_round`` (speculative) appear, and
    ``repro_preemptions_total`` equals the scheduler's preemptions. Each
    overhead is printed, not gated. Returns the launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine

    cfg = q8_eng.cfg
    f = cfg.encoder_ctx
    mels, _, _, max_news, arrivals = _pg_workload(cfg)
    pages_per = -(-(int(np.mean(max_news)) + 1) // PG_PAGE)
    geom = dict(page_size=PG_PAGE, n_pages=1 + PG_SLOTS * pages_per,
                cross_page_size=f, n_cross_pages=1 + PG_DISTINCT)

    def paged(tele):
        eng = ServeEngine(cfg, q8_eng.params, max_len=PG_MAX_LEN,
                          quant="q8_0", offload=OffloadEngine(), eos_id=-1,
                          device="cuda", telemetry=tele)
        return eng.paged_scheduler(PG_SLOTS, f, **geom)

    launches = {name: 0 for name in counted}
    _, rec, got = _te_pair(paged, "paged q8_0", mels, max_news, arrivals,
                           counted)
    for name, n in got.items():
        launches[name] += n
    if "prefix_hit" not in rec["events"]:
        raise AssertionError("telemetry paged q8_0: no prefix_hit event")

    base, tiny = get_config("whisper-base"), get_config("whisper-tiny")
    bp = _echo_params(model.init_params(torch.Generator().manual_seed(32),
                                        base, device="cpu"), ECHO_ALPHA)
    tp = _echo_params(model.init_params(torch.Generator().manual_seed(33),
                                        tiny, device="cpu"), ECHO_ALPHA)
    mels, max_news, arrivals = _ps_workload(base)
    tight = dict(page_size=PS_PAGE, n_pages=1 + -(-PS_MAX_LEN // PS_PAGE),
                 cross_page_size=base.encoder_ctx,
                 n_cross_pages=1 + PS_SLOTS)

    def spec_tight(tele):
        v = ServeEngine(dataclasses.replace(base, quant="q8_0"), bp,
                        max_len=PS_MAX_LEN, quant="q8_0",
                        offload=OffloadEngine(), eos_id=-1, device="cuda",
                        telemetry=tele)
        return v.speculative(tiny, tp, k=PS_K).paged(
            PS_SLOTS, base.encoder_ctx, **tight)

    s, rec, got = _te_pair(spec_tight, "spec tight q8_0", mels, max_news,
                           arrivals, counted)
    for name, n in got.items():
        launches[name] += n
    missing = [name for name in ("preempt", "replay")
               if name not in rec["events"]]
    if "spec_round" not in rec["spans"]:
        missing.append("spec_round")
    if missing or not s.preemptions:
        raise AssertionError(f"telemetry spec tight q8_0: {missing} absent "
                             f"({s.preemptions} preemptions)")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
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
    q8_run = {"q8_matmul": 32, "q8_matvec": 33}
    q8_replay = {"prefill": {"q8_wgmma_kernel": 32},
                 "step": {"q8_matvec_kernel": 33}}
    d_run = {"bf16_matmul": 32 + 33, "flash_attention_fwd": 4}
    d_replay = {"prefill": {"wgmma_kernel": 32, "flash_fwd_mma_kernel": 4},
                "step": {"gemv_bf16_kernel": 33}}
    q8_captured = captured_path("q8_0", q8_eng, q8_mel, q8_tokens, q8_split,
                                counted, q8_run, q8_replay, "q8_0")
    d_captured = captured_path("dense+flash", d_eng, d_mel, d_tokens, d_split,
                               counted, d_run, d_replay, "fp16")
    tiny_power = power_pdp("q8_0", q8_eng, q8_mel, "q8_0")
    power_pdp("dense+flash", d_eng, d_mel, "fp16")
    cdf = coverage_cdf(enumerate_whisper(get_config("whisper-tiny")))
    print(f"coverage whisper-tiny (LMM KB, baseline, optimized): "
          f"{json.dumps(cdf)}", flush=True)

    from repro_torch.core import energy
    t0 = time.perf_counter()
    tile_records = check_tiles()
    tuner, fit = tuning_fit(get_config("whisper-tiny"))
    tuning_grid(energy.card_power_limit_w(0))
    tuned_launches = {name: 0 for name in counted}
    for args in (
            ("q8_0", (q8_eng, q8_mel, q8_tokens, q8_split),
             {"q8_matmul": 32, "q8_matvec": 33 * MAX_NEW,
              "bf16_matmul": 1, "flash_attention_fwd": 0},
             {"q8_matmul": 32, "q8_matvec": 33, "bf16_matmul": 1},
             {"prefill": {"q8_wgmma_kernel": 32, "tiled_kernel": 1},
              "step": {"q8_matvec_kernel": 33}}, "q8_0", FIRST_STEP_TOL),
            ("dense+flash", (d_eng, d_mel, d_tokens, d_split),
             {"bf16_matmul": 33 + 33 * MAX_NEW, "flash_attention_fwd": 4,
              "q8_matmul": 0, "q8_matvec": 0},
             {"bf16_matmul": 33 + 33, "flash_attention_fwd": 4},
             {"prefill": {"wgmma_kernel": 32, "tiled_kernel": 1,
                          "flash_fwd_mma_kernel": 4},
              "step": {"gemv_bf16_kernel": 33}}, "fp16",
             DENSE_FIRST_STEP_TOL)):
        label, untuned, want, per_run, replay, share, tol = args
        got, summary = tuned_path(label, untuned, tuner, counted, want,
                                  per_run, replay, share, tol)
        print(f"tuned {label} summary: {json.dumps(summary)}", flush=True)
        for name, n in got.items():
            tuned_launches[name] += n
    print(f"tuning phase: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    path_launches = {"main": launches}
    slot4 = {}
    for label, eng0, run, replay, n_req, batch1, bench in (
            ("q8_0", q8_eng, q8_run, q8_replay, CB_REQUESTS, q8_captured,
             True),
            ("dense+flash", d_eng, d_run, d_replay, CB_DENSE_REQUESTS,
             d_captured, False)):
        got, slot4[label] = continuous_path(label, eng0, counted, run,
                                            replay, n_req, batch1, bench)
        path_launches[f"continuous {label}"] = got
        if bench and not slot4[label]["slots_past_max_len"]:
            raise AssertionError("continuous q8_0: no free slot passed "
                                 "max_len, so the clamp went untested")
    print(f"continuous batching phase: {time.perf_counter() - t0:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    path_launches["paged"] = {name: 0 for name in counted}
    for label, eng0, programs, replay, batch1 in (
            ("q8_0", q8_eng, ({"q8_matmul": 32}, {"q8_matvec": 33}),
             q8_replay, q8_captured),
            ("dense+flash", d_eng,
             ({"bf16_matmul": 32, "flash_attention_fwd": 4},
              {"bf16_matmul": 33}), d_replay, d_captured)):
        got, _ = paged_path(label, eng0, counted, programs, replay, batch1,
                            slot4[label])
        for name, n in got.items():
            path_launches["paged"][name] += n
    print(f"paged serving phase: {time.perf_counter() - t0:.1f}s",
          flush=True)

    path_launches["speculative"], spec_summary = speculative_phase(
        counted, tiny_power)
    print(f"speculative summary: {json.dumps(spec_summary)}", flush=True)

    t0 = time.perf_counter()
    path_launches["telemetry"] = telemetry_gate(q8_eng, counted)
    for name, n in telemetry_drives(q8_eng, counted).items():
        path_launches["telemetry"][name] += n
    print(f"telemetry phase: {time.perf_counter() - t0:.1f}s; launches "
          f"{path_launches['telemetry']}", flush=True)

    kernels = []
    for name, meta in KERNELS.items():
        rows = records[name]

        def total(key, per=None):   # over one prefill and/or decode step
            return sum(r[key] * r["per_step"] for r in rows
                       if r["per"] == per or (per is None
                                              and r["per"] in SUMMED))
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
            per=" + one ".join(p for p in meta["shapes"] if p in SUMMED),
            ms_source={key: sorted({r["ms_source"][key] for r in rows})
                       for key in ("ms", "plain_ms", "library_ms", *extras)},
            tuned_launches=tuned_launches[name],
            launches_by_path={path: got.get(name, 0)
                              for path, got in path_launches.items()},
            tiles=tile_records.get(name, []),
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
