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
   tensor cores; for an f32 x times int8 weights three bf16 products a
   multiply-add at that rate, the exact split ``q8_matmul`` makes, with
   the 67 TFLOP/s f32 FMA bound beside it as ``bound_f32_fma_ms``), and
   one PyTorch call as a library
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
   (``q8_wgmma_kernel``), none the converting f32 one
   (``q8_split_tc_kernel``). Where a profiled window of known launches
   differs, the wrappers' own counts over it are printed beside the
   profiler's.
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
   its Amdahl bound, beside the paper's shares. The two graphs keep their
   cudaGraph_t (``kept_graphs``): the replayed prefill graph, and any
   graph whose window lacked a kernel, is dumped (``debug_dump``, under
   ``build/graph_dumps/``) and its kernel nodes counted by route beside
   the profiler's, which tells a lost profiler record from a graph
   without the launch.
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
       and M = 5, ``q8_matmul`` at M = 28 with the decoder's f32 x (the
       split launch, ``q8_split_tc_kernel``), and ``bf16_matmul`` at M =
       5 and 28 (``per`` "verify window M=5" and "verify window M=28").

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

14. The dense LM family (``lm_phase``): qwen2.5-14b at its published
    widths (48 layers, d_model 5120, vocabulary 152,064), weights drawn
    on the card from a seeded CUDA generator, no EOS, max_len 160. Every
    linear of a step runs at M = batch, 337 a step.
    a. Q8_0: the peak memory while the engine quantizes and what stays
       once the bf16 draw is freed; the first logits of a short prompt
       against the port on the CPU at depth 2 (the same embedding, first
       two layers, final norm and head), within 1e-2 of the CPU's
       largest logit; the eager loop (``prefill``/``step``) over the last
       16 tokens of a 64-token prompt and 16 new tokens launches 337
       ``q8_matvec`` a step from Python, a captured request of the same
       tokens equals it, the capture launches two passes of one step and
       later requests none; the timed requests, 64 + 64 tokens, launch
       nothing, their tokens equal each other's and their ledger is
       four eager loops';
       the profiler counts 337 ``q8_matvec_kernel`` a replayed step;
       prefill ms, decode ms a token, device ms a step, idle shares
       (profiled and unprofiled), the top kernels, the dot-product share
       and the PDP of the request at the power limit; batch 4, prompts
       of 16-64 tokens left-padded with token 0, their last 16 tokens and
       16 new captured against eager, then the whole prompts timed.
    b. bf16 (``quant="none"``), the Q8_0 engine freed first: the same at
       batch 1, 337 ``gemv_bf16_kernel`` a replayed step.
    c. The slot scheduler: 12 requests (prompts of 16-64 tokens, max_new
       8-32 from default_rng(0)) over 4 slots: every request's tokens
       equal its batch-1 ``generate``'s, one slot-step capture, one
       commit an admission and a step, lm_head run once a prompt token
       and a step; a warm drive's tokens a second, KV bytes, and the
       4-row step's replay profiled.
    e. (run after c) sharded: c's trace over 4 slots of a new engine on a
       mesh of 2 entries of the card, built from a's quantized weights
       (every leaf the same tensor: no second draw): tokens equal c's
       streams, one slot-step build captured once a shard (and the
       admissions' batch-1 step); a warm drive's tokens a second beside
       c's. Then over "model" (``lm_tp``): a new engine on a (1, 4) mesh
       of the card from the same weights (every split leaf's parts views
       of them, no bytes added), attention (40 heads over 8 KV heads),
       FFN and vocabulary split four ways; a batch-1 ``generate`` (16 +
       16 tokens) and 4 requests over 4 slots (8 + 8 tokens). First the
       f32 witness, the same weights with f32 activations, unsharded and
       over (1, 4): its tokens equal, exactly. Then the bf16 floor, the
       unsharded engine's logits along its tokens against the witness's
       (``tie_floor``), before the bf16 run over (1, 4): its tokens equal
       the unsharded engine's or first part at a near-tie (``tie_check``:
       the witness's logits there hold the two picks within twice the
       floor); the next-token logits after 4 prompt tokens within 5e-2
       of the unsharded engine's largest (48 bf16 layers); host and
       device ms beside the unsharded engine's, the slot step's top
       kernels. Its launches count under "sharded".
    d. ``kv_quant="q8"``: one captured batch-1 ``generate`` whose tokens
       equal its eager loop's.
    ``lm ...`` lines, then ``lm phase: N s``. Phase 2 holds both decode
    kernels at its shapes at M = 1 and 4 (``per`` "qwen2.5-14b decode
    step" and "qwen2.5-14b slot step"), and ``q8_matvec`` at a model
    shard's launches of the (1, 4) step ("qwen2.5-14b tp step (1, 4)").

15. The MoE family (``moe_phase``), in bf16 (``quant="none"``: the
    reference fails on Q8_0 expert stacks), weights drawn on the card
    from a seeded CUDA generator, no EOS, max_len 160. The engine's
    linears run ``gemv_bf16_kernel``; the experts' products are library
    batched matmuls over every expert's capacity slots.
    a. olmoe-1b-7b at its published widths and depth (16 layers, 64
       experts, top-8): the first logits against the port on the CPU at
       depth 2, within 3e-2 of the largest logit; ``lm_oneshot`` at batch
       1 (64 + 64 tokens timed, its eager loops 16 + 16 as phase 14's)
       and 4: 65 ``gemv_bf16_kernel`` a step, eagerly
       and at a replay, captured tokens equal the eager loop's, prefill
       ms a prompt token, decode ms a token, device ms a step, idle
       shares, PDP at the power limit; the step's device time split into
       expert products, dispatch/combine, the gemv and the rest, beside
       its byte bounds (every expert streamed, and the chosen experts
       only, each plus the gemv weights).
    b. Its slot scheduler (``lm_scheduler``, 14c's trace over 4 slots):
       tokens equal batch-1 ``generate``'s; the keep masks of an eager
       4-row step drop nothing (cap 8).
    c. arctic-480b at its published widths with its 35 layers cut to 1
       (28 GB; the whole model is 954 GB): the draw's peak memory;
       ``lm_oneshot`` at batch 1 (64 + 32 tokens, 8 ``gemv_bf16_kernel``
       a step), the split and the bounds; four identical prompts over 4
       slots (cap 2): the dropped (token, choice) pairs a step of an eager
       4-row prefill (more than 0), rows 0-1 equal batch-1 ``generate``.
    d. Both smoke configs, four identical prompts over 4 slots: the
       card's tokens equal the port's on the CPU, rows 2-3 differ.
    ``moe ...`` lines, then ``moe phase: N s``. Phase 2 holds
    ``bf16_matmul`` at the new shapes (``per`` "olmoe-1b-7b decode step",
    "olmoe-1b-7b slot step" and "arctic-480b decode step").

16. The SSM and hybrid families (``ssm_phase``), weights drawn on the
    card from a seeded CUDA generator, no EOS, max_len 160. A step reads
    f32 conv windows and SSD states besides the weights; the engine's
    linears run the decode kernels.
    a. mamba2-780m at its published widths and depth (48 layers, d_model
       1536, 48 SSD heads of 64, d_state 128), Q8_0: the first logits
       against the port on the CPU at depth 2, within 1e-2 of the
       largest logit; ``lm_oneshot`` at batch 1 (64 + 64 tokens timed,
       its eager loops 16 + 16 as phase 14's) and 4: 97
       ``q8_matvec_kernel`` a step, eagerly and at a replay, captured
       tokens equal the eager loop's, prefill ms a prompt token, decode
       ms a token, device ms a step, idle shares, top kernels, dot
       share, PDP at the power limit; the step's device time split into
       the decode kernel, the SSM layers' small kernels (one layer run
       alone) and the rest, beside its byte bound (the Q8_0 linears and
       the f32 states read and written). The same in bf16 (97
       ``gemv_bf16_kernel``), the Q8_0 engine freed first.
    b. The Q8_0 slot scheduler (``lm_scheduler``): 12 requests, prompts
       of 8-32 tokens and max_new 16-48 from default_rng(0), over 4
       slots: tokens equal batch-1 ``generate``'s, one slot-step capture,
       commits = admissions + steps, tokens a second, committed and used
       state bytes; row 0 of an eager 4-slot step bit for bit a batch-1
       step's (logits, conv windows, SSD states).
    c. jamba-v0.1-52b at its published widths with its 32 layers cut to
       one pattern repeat of 8 (26.5 GB of bf16; the whole model is
       about 104 GB), bf16: the draw's peak memory; the first SSM
       layer's ``ssm_decode_step`` card vs CPU over 16 carried steps
       (within 1e-2); ``lm_oneshot`` at batch 1 (64 + 32 tokens, 31
       ``gemv_bf16_kernel`` a step); the step's split (expert products,
       dispatch/combine, gemv, SSM small kernels, rest) beside the
       all-expert and chosen-expert byte bounds; the smoke config's
       ``generate`` and drop-case scheduler tokens, card vs CPU.
    ``ssm ...`` lines, then ``ssm phase: N s``. Phase 2 holds both
    decode kernels at mamba2's shapes at M = 1 and 4 (``per``
    "mamba2-780m decode step", "mamba2-780m slot step") and
    ``bf16_matmul`` at jamba's ("jamba-v0.1-52b repeat step").

17. The full-sequence forward and loss of every family (``forward_phase``),
    and the VLM served. The memory still allocated at its start is
    printed, before and after the cuBLAS workspaces are cleared
    (``release_memory``, also called before phases 14-16; every earlier
    phase frees its engines, trees and graph pools).
    a. llava-next-mistral-7b at its published widths and depth (32
       layers, d_model 4096, 32 heads over 8 KV heads of 128, d_ff 14,336,
       vocabulary 32,000, a projector from 1024-wide patches), bf16
       weights drawn on the card from a seeded CUDA generator, a second
       engine quantizing them to Q8_0: the memory both trees hold and the
       draw's peak.
    b. ``forward`` and ``loss_fn`` through the offload engine at one row
       of the reference's train_4k cell (S = 4096, 1152 f32 patches from a
       seeded CUDA generator), Q8_0 and bf16, ``attn_impl`` "chunked" and
       "flash": the depth-2 cut's logits and loss on a 256-token row
       against the port on the CPU (1e-2 of the largest logit in Q8_0,
       3e-2 in bf16); the launches from Python a forward (224 decoder
       linears, the projector and lm_head on ``q8_matmul`` or
       ``bf16_matmul``; 32 ``flash_attention_fwd`` under flash; in
       ``loss_fn`` lm_head once a CE chunk, 8 at S = 4096); forward ms
       (host clock, synchronized) and tokens a second; one profiled
       forward's device ms split into the product kernels, attention
       (flash, or the chunked path's library products and softmax) and
       the rest, its idle share, beside the bound (the plan's linears'
       operations and the causal attention's, against their bytes);
       flash's logits within 3e-2 of chunked's largest logit and its loss
       within 1e-2; every loss finite.
    c. ``_embed_inputs`` alone, Q8_0, card against CPU: the projector's
       product (M = 1152, K = 1024, N = 4096, f32 x) one ``q8_matmul``
       launch, the splice within 1e-2, the token rows equal.
    d. llava served on tokens alone, as the reference serves it:
       ``lm_oneshot`` at batch 1 (64 + 64 tokens timed, its eager loops
       16 + 16 as phase 14's) and 4, and
       ``lm_scheduler`` (14c's trace over 4 slots), in Q8_0 (225
       ``q8_matvec_kernel`` a step) and in bf16 (225 ``gemv_bf16_kernel``),
       the gates of phase 14's.
    e. mamba2-780m's forward at full width in Q8_0 (S = 4096: the chunked
       SSD scan, ``q8_matmul`` at in_proj 1536 -> 6448): the depth-2 cut
       against the CPU, the launches (97 a forward), forward ms, the
       device split into products, the scan's library products and the
       rest.
    f. The smoke config of each family (dense, MoE at a no-drop capacity,
       SSM, hybrid, VLM with 4 patches, whisper-tiny through
       ``decode_train``): ``forward`` and ``loss_fn`` on the card against
       the CPU, and a teacher-forced ``forward`` against the
       ``serve_step`` loop on the card (2e-4).
    ``forward ...`` lines, then ``forward phase: N s``. Phase 2 holds
    the decode kernels at llava's step at M = 1 and 4 ("llava decode
    step", "llava slot step"); its rows at the forward's shapes are
    measured after this phase (``LATE_ROWS``): ``q8_matmul`` and
    ``bf16_matmul`` at M = 4096, and the projector at M = 1152 with f32
    x (``per`` "llava forward"), and ``flash_attention_fwd`` causal at S
    = 4096 over 32 heads at D = 128 ("llava forward") and D = 96
    ("phi3-mini forward").

18. Sharded serving (``sharded_phase``), run after phase 13 on its
    engines' weights: slot-DP over meshes of logical devices that are
    all the card (``make_serve_mesh(data=n, devices=[cuda:0] * n)``).
    On one card it checks the sharded machinery with real kernels and
    graphs (placement, one captured program a shard, shard-local
    admission, the ledger's split, parity), not scaling.
    a. whisper-tiny on phase 10's trace over 4 slots, Q8_0 and dense +
       flash, at data 4 and 2, after the unsharded drive: tokens equal
       the unsharded scheduler's; the step key built once and captured
       once a shard, then never; Python launches two passes of the
       batch-1 prefill and of n shards' steps; the profiler counts n x
       33 ``q8_matvec_kernel`` (``gemv_bf16_kernel``) a replayed step;
       ``sum(by_device)`` the ledger's FLOPs over n devices; plan keys
       disjoint from the unsharded engine's; ledger totals and commits
       the unsharded drive's; a warm drive with no capture or launch; a
       shard's row bit for bit the batch-1 step's. The sharded step's
       host ms, device ms and idle share beside phase 10's.
    b. the paged pool at data 4 on phase 11's trace (its self arena
       rounded up to a multiple of 4 pages): tokens equal the unsharded
       paged pool's and the contiguous scheduler's; commits = prefills +
       steps + replays; a slot's self pages from its shard's range
       whenever that range had one; requests per committed byte against
       the contiguous pool's.
    c. ``SpecScheduler``'s waves with phase 12c's echo whisper-base
       verifier and whisper-tiny draft at data 2 on phase 12c's trace,
       each wave's batch split over the data shards: tokens equal the
       unsharded waves'; the window and the draft step built once and
       captured once a shard; the round schedulers refuse the mesh, as
       the reference's do.
    d. tensor parallelism over "model" (``tp_path``): whisper-tiny at
       full width, Q8_0 and dense + flash, a new engine (max_len 56, no
       EOS) unsharded and over (1, 2), (2, 2) and (1, 4) meshes of the
       card: a batch-1 ``transcribe`` of 24 tokens and phase 10's trace
       over 4 slots. Before any sharded run, the bf16 floor: the
       unsharded engine's logits along its transcribe against the f32
       witness's (the same weights, Q8_0 dequantized, served in f32 by
       plain PyTorch; ``tie_floor``). Tokens equal the unsharded
       engine's: exactly on Q8_0; on dense + flash, or first part at a
       near-tie (``tie_check``: the witness's logits there hold the two
       picks within twice the floor); the first decode step's logits
       within 1e-2 (Q8_0) or 3e-2 (dense) of the largest; the
       transcribe's host prefill ms and decode ms a token, the batch-1
       step graph's and the 4-row slot step's device ms, the launches by
       kernel, and the blocks split or whole by reason (on (1, 4)
       whisper's 6 heads run whole: ``tp ... (1, 4) blocks``).
    e. paged and speculative serving over "model" (``tp_paged``,
       ``tp_spec``). Phase 11's trace through the paged pool (12 logical
       slots; on Q8_0 also the tight arena, which preempts and replays)
       on whisper-tiny at full width, Q8_0 and dense + flash, a new
       engine (max_len 24, no EOS) unsharded and over (1, 2) and (1, 4)
       (on (1, 4) the 6 heads and so the page arenas whole): every
       request's tokens exactly the same engine's batch-1 transcribe's;
       against the unsharded pool's equal or first parted at a near-tie
       within twice the floor measured before any sharded run (Q8_0's
       residual stream is bf16, so its split sums move the logits too);
       commits = prefills + steps + replays; requests per
       committed byte the unsharded pool's; one paged step capture a data
       shard, then a warm drive with no capture and no launch; launches
       by kernel, the blocks split or whole, the paged step's device ms
       (CUDA events: median and spread of 10 replays). Then phase 12's
       echo whisper-base verifier (Q8_0) and whisper-tiny draft sharing a
       (1, 2) mesh, and unsharded: a one-shot echo b1 k4 transcribe
       (tokens and acceptance the unsharded engine's, tokens the
       verifier's own transcribe over the mesh, no launch at the second
       request, FLOPs by role = plans x runs), a round's device split
       (draft steps, window: median and spread of 10), and phase 12c's
       trace through ``SpecScheduler``'s waves (tokens and acceptance
       18c's unsharded waves', one window and draft capture a data
       shard, the round schedulers refused); the echo models repeat SOT,
       so phase 12's raw pair transcribes the echo mel over the mesh
       too, its tokens exactly the verifier's own transcribe's.
    ``sharded ...``, ``tp ...``, ``tp paged ...`` and ``tp spec ...``
    lines, ``sharded phase 18e: N s``, then ``sharded phase: N s``.
    Phase 2 holds ``q8_matvec`` and ``bf16_matmul`` at the (1, 2)
    step's model-shard launches (``per`` "tp decode step (1, 2)"), and
    ``q8_matmul``, ``bf16_matmul`` and ``flash_attention_fwd`` at the
    (1, 2) prefill's (``per`` "tp prefill (1, 2)"). It holds
    ``q8_matvec`` at the data-4 step's shapes (``per`` "sharded slot step
    data=4": each decode linear 4 x at M = 1), whose bytes are four
    graphs' weight streams; the step's own byte bound, the weights once,
    is the "slot decode step" row's. It holds ``q8_matvec`` at the
    (1, 2) paged step's model-shard launches (``per`` "tp paged slot step
    (1, 2)", M = 12) and at the (1, 2) verify window's (``per`` "tp
    verify window (1, 2)", M = 5, whisper-base's split shapes).

19. Training (``train_phase``), after the late kernel rows:
    a. the backward's registers and spills a kernel instantiation (its
       build log, ``ptxas flash_attention_bwd ...``); the forward's
       logsumexp against its plain version, and ``flash_attention_bwd``
       against ``flash_attention_bwd_plain`` at phi3-mini's shape
       (causal, BH = 64, S = 4096, D = 96, bf16), llava's D = 128,
       whisper-tiny's encoder (non-causal, BH = 6, 1500 frames, f32 and
       bf16) and D = 16 and 32 (2e-5 of the largest magnitude in f32,
       1e-2 in bf16, and in bf16 a mean error of 1e-4 of the mean
       magnitude, which a dS rounded once to bf16 would exceed), each
       launched twice and equal bit for bit, every
       bf16 case on the tensor-core route and every f32 one on the SIMT
       route; ``_FlashCore``'s gradients against autograd through the
       plain forward; the backward's rows at phi3's shape, llava's D =
       128 (BH = 32, causal) and whisper-tiny's encoder in bf16: device
       time, plain, the library's (SDPA's backward alone), its bound at
       the f32 FMA rate and at the bf16 one.
    b. phi3-mini-3.8b at full width through ``Trainer``: bf16, flash,
       full remat, 4096 tokens x batch 2, bf16 moments, weights drawn on
       the card; 4 steps and one checkpoint after the last (its save
       timed) into a temporary directory: finite losses, 64 forward and
       32 backward flash launches a step, every backward launch on the
       tensor-core route, step ms (CUDA events), tokens a second, peak
       memory; step_4 loaded onto the card bit for bit (timed); one more
       step profiled (the device split into flash forward, flash
       backward, GEMMs and the rest; the backward's kernels by name, 32
       each of the delta and the tensor-core dK/dV and dQ kernels and no
       SIMT kernel; J a step at the power limit); then, at phi3's width
       cut to 4 layers, 4 steps with a checkpoint every 2, and a fresh
       ``Trainer`` restores step_2 and reruns steps 2-3 within 1e-3.
    d. training over a mesh (``train_mesh_phase``): ``Trainer(mesh=)``
       over ``make_smoke_mesh`` of four entries of the card, (2, 2) data
       x model, the state split by ``train_state_specs``, each data shard
       one row of 19b's batch: 2 steps from 19b's init whose losses and
       gradient norms equal 19b's within 1e-3, all on the tensor cores;
       step ms, tokens a second, peak memory,
       the state's bytes by logical entry and on the card; the gathers,
       partial sums, shards, reduce and update ms of a step (CUDA
       events); a profiled
       step's device split; the elastic round trip at 2 layers: a mesh
       step's whole-leaf checkpoint restored unsharded, onto a (4, 1)
       mesh and onto the (2, 2) one, bit for bit. On one card the mesh
       measures the machinery (copies, gathers, reduces), not scaling.
       Every attention and FFN runs split over the 2 model shards of its
       data shard (the layers by outcome, and the blocks run, printed), so
       each (data, model) shard launches 64 forward and 32 backward flash
       kernels a step (256 and 128 a step); the timed step adds the
       per-layer gathers (``rules.gather_part``) and the partial sums
       (``transformer.sum_partials``) inside the shards' forward and
       backward; the peak stays under TRAIN_MESH_PEAK_GB.
    e. the "model" axis alone (``train_model_axis_phase``): one step over
       a (1, 4) mesh of four entries of the card, 8 of 32 heads and 2048
       of 8192 FFN columns a model shard, 19b's batch on one data shard:
       its loss and gradient norm within 1e-3 of 19b's first step, 4 x 2
       x 32 forward and 4 x 32 backward flash launches on the tensor
       cores, its step ms and peak memory.
    f. expert parallelism and the vocabulary split (``train_moe_phase``):
       olmoe-1b-7b at its published widths cut to 4 of its 16 layers
       (1.884e9 parameters), bf16, flash, full remat, bf16 moments, 2
       rows of 2048 tokens: one unsharded step, then one step of
       ``Trainer(mesh=)`` over (1, 4) (16 experts a model shard) and
       over (2, 2) (a row a data shard, 32 experts a model shard) of the
       card's entries; each within 1e-3 of the unsharded step's loss and
       gradient norm, every MoE layer's experts, attention and the
       vocabulary split, each ``_experts`` call over E / M experts, the
       flash launches on the tensor cores; step ms, peak and the
       all-to-all and all-reduce bytes reported to ``op_cost``.
    c. the CLI: ``launch.train.main`` on whisper-tiny at full width, 4
       steps, ends with ``final:`` (run after 19d, 19e and 19f).
    ``train ...`` lines, then ``train phase: N s``. The backward's
    kernels-line entry sums its phi3 row over a training step (32
    launches), keeps the other rows under ``by_phase``, its kernels'
    registers and spills (``ptxas``) and the profiled step's kernels by
    name (``device_kernels``); its ``launches`` are 19b's continuous
    run's, and ``launches_by_path["train"]`` adds 19d's, 19e's, 19f's
    and 19c's.

20. The roofline (``roofline_phase``), the port's analysis tools on the
    programs the phases above ran, counted on fake tensors (no storage,
    nothing launched) by ``roofline.op_cost.OpCounter`` and priced on
    ``roofline.analysis.H100`` (the figures every bound of this script
    takes):
    a. whisper-tiny Q8_0 at full width: the batch-1 prefill and one decode
       step of a ``ServeEngine`` over fake weights; the kernels' FLOPs and
       weight bytes must equal phase 3's plan entries' (2 m k n over the
       kernels' share of K, 1.125 bytes a weight) within 1%; each
       program's roofline terms, its bound against phase 6's measured
       replay device time;
    b. phi3-mini-3.8b at 19b's shape (4096 x 2, bf16, flash, full remat,
       bf16 moments): ``model_flops``, the counted FLOPs, the useful-FLOP
       ratio, the bound, the counted peak against 19b's measured peak,
       and the MFU of 19b's measured step (model FLOPs over the step's
       seconds times 989 TFLOP/s);
    c. the dry-run cell ``whisper-tiny x train_4k`` on the pod mesh (16 x
       16), ``python -m repro_torch.launch.dryrun``, run in a process of
       its own started before phase 2 (CPU only: its 256 entries' mesh
       step takes minutes of host time), must end "ok": its busiest
       entry's bytes and terms.
    ``roofline ...`` lines, each with the card's name and power limit,
    then ``roofline phase: N s``.

The last two lines are the kernels' JSON record and the result line; each
kernel's record also carries its launches on the tuned paths' eager loops
(``tuned_launches``), its launches on each path's drive
(``launches_by_path``: the main path's, phase 10's, phase 11's paged
pool drives, both paths summed, under "paged", phase 12's captures
under "speculative", phase 13's captures, every engine's summed, under
"telemetry", every Python launch of phase 14 under "lm", of phase 15
under "moe", of phase 16 under "ssm", of phase 17 under "forward", of
phase 17d under "vlm", of phases 18 and 14e under "sharded" and of
phase 19 under "train") and its
tiles' times
(``tiles``).

Copied out of a checkout (no ``src/repro_torch`` beside the script), or
without a CUDA device, it prints why and exits 1.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))


def _h100():
    """The H100's figures from the port's roofline module, one home for
    them (None where the script stands alone, without the port beside
    it: ``main`` then stops before any bound)."""
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return None
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.roofline.analysis import H100
    return H100


H100 = _h100()
HBM_BYTES_PER_S = H100.hbm_bw if H100 else None   # H100 SXM device memory
# H100 SXM dense peak for x's type: a bf16 x int8 product is exact in f32,
# so bf16 x runs at the bf16 tensor-core rate; f32 x outside the tensor
# cores (tf32 would round x), or, split exactly into three bf16 parts as
# q8_matmul's converting launch does, three bf16 products a multiply-add
FLOPS_PER_S = {"bfloat16": H100.peak_bf16, "float32": H100.peak_f32,
               "float32_split": H100.peak_bf16 / 3} if H100 else {}
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
# the sharded 4-row slot step at data 4 (phase 18a): four graphs of the
# batch-1 step, each streaming every weight, so each linear 4 x at M = 1;
# its plain and library times are those of the same 4 x M = 1 calls. The
# step's own byte bound (the weights once) is the slot step's row's
SHARD_STEP_DATA = 4
MATVEC_SHARDED_SHAPES = [(*shape[:4], SHARD_STEP_DATA * shape[4], shape[5])
                         for shape in MATVEC_SHAPES]
BF16_PAGED_SHAPES = [(12, *shape[1:]) for shape in BF16_STEP_SHAPES]
# a decode step over "model" (phase 18d, (1, 2)): each model shard's
# launches, both shards' counted; q/k/v and cross q at N / 2, ffn.up at
# N / 2, ffn.down at K / 2 and dec.vocab at N / 2. The o products' K / 2
# = 192 falls under the 256 burst: they run on the host arm, no kernel
TP_STEP = [(192, 256, 384, 32),       # self q/k/v + cross q, 4 layers x 2
           (768, 256, 384, 8),        # ffn.up
           (384, 768, 1536, 8),       # ffn.down: a view of the rows
           (25936, 256, 384, 2)]      # dec.vocab
MATVEC_TP_SHAPES = [(1, n, km, k, c, "float32") for n, km, k, c in TP_STEP]
# the paged slot step over (1, 2) (phase 18e): phase 11's 12 rows at the
# (1, 2) step's model-shard launches (M = 12, the MT = 16 instantiations)
MATVEC_TP_PAGED_SHAPES = [(12, n, km, k, c, "float32")
                          for n, km, k, c in TP_STEP]
BF16_TP_SHAPES = [(1, n, km, k, c, "bfloat16") for n, km, k, c in TP_STEP]
# a prefill over "model" (phase 18d, (1, 2)), both shards' launches: the
# encoder's q/k/v and the decoder's cross k/v at N / 2, enc ffn.up at
# N / 2, enc ffn.down at K / 2 (the o products' K / 2 on the host arm, as
# in the step); flash over each shard's 3 of the 6 heads
TP_PREFILL = [(192, 256, 384, 40),    # enc q/k/v + cross k/v, 4 layers x 2
              (768, 256, 384, 8),     # enc ffn.up
              (384, 768, 1536, 8)]    # enc ffn.down
MATMUL_TP_SHAPES = [(1500, n, km, k, c, "bfloat16")
                    for n, km, k, c in TP_PREFILL]
FLASH_TP_SHAPES = [(3, 1500, 1500, 64, 8, "bfloat16", False)]
# whisper-base's decode linears, the verifier's (phase 12): (n, k, launches
# a step or a window); burst 256 divides every K, so k_main = K
BASE_DECODE = [(512, 512, 36),     # self q/k/v/o + cross q/o, 6 layers
               (2048, 512, 6),     # ffn.up
               (512, 2048, 6),     # ffn.down
               (51872, 512, 1)]    # dec.vocab
# the verify window: whisper-base's step (M = 1), and its window at M = 5
# (batch 1, k = 4) and M = 28 (batch 4, k = 6: above 16 rows, where
# kernel_for sends it to q8_matmul, the converting launch that splits the
# Q8_0 decoder's f32 x into three bf16 parts, and to bf16_matmul's
# tensor-core launch)
BASE_STEP_Q8 = [(1, n, k, k, c, "float32") for n, k, c in BASE_DECODE]
WINDOW5_Q8 = [(5, n, k, k, c, "float32") for n, k, c in BASE_DECODE]
WINDOW28_Q8 = [(28, n, k, k, c, "float32") for n, k, c in BASE_DECODE]
WINDOW5_BF16 = [(5, n, k, k, c, "bfloat16") for n, k, c in BASE_DECODE]
WINDOW28_BF16 = [(28, n, k, k, c, "bfloat16") for n, k, c in BASE_DECODE]
# the verify window over (1, 2) (phase 18e, batch 1, k = 4: M = 5), both
# model shards' launches: whisper-base's 8 heads split, each shard's q,
# k, v and cross q at N / 2, self and cross o at K / 2 (256, a view of
# the rows: on the kernel, as the burst divides it), ffn.up at N / 2,
# ffn.down at K / 2 and dec.vocab at N / 2: (n, k_main, k_full, launches)
TP_WINDOW = [(256, 512, 512, 48),      # self q/k/v + cross q, 6 layers x 2
             (512, 256, 512, 24),      # self o + cross o
             (1024, 512, 512, 12),     # ffn.up
             (512, 1024, 2048, 12),    # ffn.down
             (25936, 512, 512, 2)]     # dec.vocab
WINDOW5_TP_Q8 = [(5, n, km, k, c, "float32") for n, km, k, c in TP_WINDOW]
# the decode linears of a qwen2.5-14b step: (n, k, launches a step);
# burst 256 divides both K, so k_main = K
QWEN_DECODE = [(5120, 5120, 96),      # attn.q and attn.o, 48 layers
               (1024, 5120, 96),      # attn.k and attn.v (8 KV heads x 128)
               (13824, 5120, 96),     # ffn.gate and ffn.up
               (5120, 13824, 48),     # ffn.down
               (152064, 5120, 1)]     # lm_head
# x is bf16 on both paths (the LM embeds in the model's type), at M = 1
# and at M = 4, the 4-slot step's (phase 14)
QWEN_M1 = [(1, n, k, k, c, "bfloat16") for n, k, c in QWEN_DECODE]
QWEN_M4 = [(4, n, k, k, c, "bfloat16") for n, k, c in QWEN_DECODE]
# the same step over "model" (14e, (1, 4)): each of 4 model shards'
# launches (all counted): q, k, v, gate, up and lm_head at N / 4, o at
# K / 4, down at K / 4 (3456: 3328 on the kernel, 128 on the host arm),
# the row-parallel slices views of the whole weight's rows
QWEN_TP_M1 = [(1, 1280, 5120, 5120, 192, "bfloat16"),
              (1, 256, 5120, 5120, 384, "bfloat16"),
              (1, 5120, 1280, 5120, 192, "bfloat16"),
              (1, 3456, 5120, 5120, 384, "bfloat16"),
              (1, 5120, 3328, 13824, 192, "bfloat16"),
              (1, 38016, 5120, 5120, 4, "bfloat16")]
# phase 15, the MoE family in bf16: the engine's linears of an olmoe-1b-7b
# step (q/k/v/o at 2048 -> 2048, 16 layers, and lm_head), at M = 1 and at
# M = 4 (the 4-slot step), and of arctic-480b's one-layer step (q and o
# at 7168, k and v at 7168 -> 1024, the dense branch's up and gate at
# 7168 -> 4864 and down at 4864 -> 7168, and lm_head)
OLMOE_DECODE = [(2048, 2048, 64), (50304, 2048, 1)]
ARCTIC_DECODE = [(7168, 7168, 2), (1024, 7168, 2), (4864, 7168, 2),
                 (7168, 4864, 1), (32000, 7168, 1)]
OLMOE_M1 = [(1, n, k, k, c, "bfloat16") for n, k, c in OLMOE_DECODE]
OLMOE_M4 = [(4, n, k, k, c, "bfloat16") for n, k, c in OLMOE_DECODE]
ARCTIC_M1 = [(1, n, k, k, c, "bfloat16") for n, k, c in ARCTIC_DECODE]
# phase 16, the SSM and hybrid families: the engine's linears of a
# mamba2-780m step (ssm.in_proj 1536 -> 6448 and ssm.out_proj 3072 ->
# 1536, 48 layers, and lm_head 1536 -> 50,288) at M = 1 and at M = 4 (the
# 4-slot step), and of jamba-v0.1-52b's one-repeat step (7 SSM layers'
# in_proj 4096 -> 16,544 and out_proj 8192 -> 4096; the attention layer's
# q and o at 4096 and k and v at 4096 -> 1024; 4 dense FFNs' gate and up
# 4096 -> 14,336 and down 14,336 -> 4096; lm_head 4096 -> 65,536)
MAMBA_DECODE = [(6448, 1536, 48), (1536, 3072, 48), (50288, 1536, 1)]
JAMBA_DECODE = [(16544, 4096, 7), (4096, 8192, 7), (4096, 4096, 2),
                (1024, 4096, 2), (14336, 4096, 8), (4096, 14336, 4),
                (65536, 4096, 1)]
MAMBA_M1 = [(1, n, k, k, c, "bfloat16") for n, k, c in MAMBA_DECODE]
MAMBA_M4 = [(4, n, k, k, c, "bfloat16") for n, k, c in MAMBA_DECODE]
JAMBA_M1 = [(1, n, k, k, c, "bfloat16") for n, k, c in JAMBA_DECODE]
# phase 17, llava-next-mistral-7b: its linears (n, k, launches) at a
# forward of S = 4096 tokens (M = 4096) and at a decode step (M = 1, 4):
# q and o at 4096, k and v at 4096 -> 1024, gate and up 4096 -> 14,336 and
# down 14,336 -> 4096, 32 layers; lm_head 4096 -> 32,000. The projector
# takes the 1152 f32 patches (M = 1152, 1024 -> 4096): f32 x on the
# converting launches of q8_matmul (split in three) and bf16_matmul
# (rounded to bf16)
LLAVA_LINEARS = [(4096, 4096, 64), (1024, 4096, 64), (14336, 4096, 64),
                 (4096, 14336, 32), (32000, 4096, 1)]
LLAVA_PROJECTOR = (1152, 4096, 1024, 1024, 1, "float32")
LLAVA_FWD = [(4096, n, k, k, c, "bfloat16") for n, k, c in LLAVA_LINEARS] \
    + [LLAVA_PROJECTOR]
LLAVA_M1 = [(1, n, k, k, c, "bfloat16") for n, k, c in LLAVA_LINEARS]
LLAVA_M4 = [(4, n, k, k, c, "bfloat16") for n, k, c in LLAVA_LINEARS]
# the whisper frontend (models/whisper.py): the f32 mel, 1500 x 80, into
# d_model 384 on bf16_matmul's converting launch, where a tuned burst hands
# it the whole K (phase 9d; untuned, burst 256 > K leaves it on the host)
BF16_FRONTEND = [(1500, 384, 80, 80, 1, "float32")]
BF16_PREFILL_SHAPES = [
    (1500, 384, 256, 384, 24, "bfloat16"),    # enc q/k/v/o + dec.cross.k/v
    (1500, 1536, 256, 384, 4, "bfloat16"),    # enc ffn.up
    (1500, 384, 1536, 1536, 4, "bfloat16"),   # enc ffn.down
]
# (batch*heads, Sq, Sk, D, launches per prefill, dtype, causal)
FLASH_SHAPES = [(6, 1500, 1500, 64, 4, "bfloat16", False)]   # encoder
# phase 17: the causal self-attention of a 4096-token forward, 32 heads a
# layer folded to BH = 32: llava (D = 128) and phi3-mini (D = 96), 32
# layers each
FLASH_LLAVA = [(32, 4096, 4096, 128, 32, "bfloat16", True)]
FLASH_PHI3 = [(32, 4096, 4096, 96, 32, "bfloat16", True)]
# phase 19: the flash backward of phi3-mini's training step, 32 heads of 96
# at batch 2 (BH = 64), causal, one launch a layer: (bh, sq, sk, d, dtype,
# causal, launches a training step)
FLASH_BWD_PHI3 = [(64, 4096, 4096, 96, "bfloat16", True, 32)]
# timed beside it in phase 19a, one launch each: llava's head size 128
# (causal, 32 heads, one 4096-token row) and whisper-tiny's encoder in bf16
# (6 heads of 64, 1500 frames, not causal)
FLASH_BWD_LLAVA = [(32, 4096, 4096, 128, "bfloat16", True, 1)]
FLASH_BWD_WHISPER = [(6, 1500, 1500, 64, "bfloat16", False, 1)]
# phase 2's rows at the 4096-token forward's shapes, measured last (after
# phase 17), so that phases 3-16 run after the same phase 2 as before
# they were added: their plain versions launch some 13,000 kernels a
# profiled window (the flash rows), and on the card torch.profiler's
# records of the tuned prefill replays' first kernel went missing twice
# with them in place. Late in the run the profiler drops records too (a
# library call's time came out below its bound), so these rows are timed
# with CUDA events over captured graphs (``graph_ms``; PERF.md §6)
LATE_ROWS = ("llava forward", "phi3-mini forward")
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
                              "sharded slot step data=4":
                                  MATVEC_SHARDED_SHAPES,
                              "tp decode step (1, 2)": MATVEC_TP_SHAPES,
                              "tp paged slot step (1, 2)":
                                  MATVEC_TP_PAGED_SHAPES,
                              "tp verify window (1, 2)": WINDOW5_TP_Q8,
                              "qwen2.5-14b tp step (1, 4)": QWEN_TP_M1,
                              "whisper-base decode step": BASE_STEP_Q8,
                              "verify window M=5": WINDOW5_Q8,
                              "qwen2.5-14b decode step": QWEN_M1,
                              "qwen2.5-14b slot step": QWEN_M4,
                              "mamba2-780m decode step": MAMBA_M1,
                              "mamba2-780m slot step": MAMBA_M4,
                              "llava decode step": LLAVA_M1,
                              "llava slot step": LLAVA_M4},
                      library_call="torch.matmul(x_f32, W_dequantized_f32.T):"
                                   " no single PyTorch call computes a Q8_0 "
                                   "product"),
    "q8_matmul": dict(source="src/repro_torch/csrc/q8_matmul.cu",
                      replaces="src/repro/kernels/q8_matmul.py:87",
                      shapes={"prefill": MATMUL_SHAPES,
                              "tp prefill (1, 2)": MATMUL_TP_SHAPES,
                              "verify window M=28": WINDOW28_Q8,
                              "llava forward": LLAVA_FWD},
                      library_call="torch.matmul(x_f32, W_dequantized_f32.T):"
                                   " no single PyTorch call computes a Q8_0 "
                                   "product"),
    "bf16_matmul": dict(source="src/repro_torch/csrc/bf16_matmul.cu",
                        replaces="src/repro/kernels/bf16_matmul.py:76",
                        shapes={"prefill": BF16_PREFILL_SHAPES,
                                "decode step": BF16_STEP_SHAPES,
                                "tuned prefill frontend": BF16_FRONTEND,
                                "slot decode step": BF16_SLOT_SHAPES,
                                "paged slot step": BF16_PAGED_SHAPES,
                                "tp decode step (1, 2)": BF16_TP_SHAPES,
                                "tp prefill (1, 2)": MATMUL_TP_SHAPES,
                                "verify window M=5": WINDOW5_BF16,
                                "verify window M=28": WINDOW28_BF16,
                                "qwen2.5-14b decode step": QWEN_M1,
                                "qwen2.5-14b slot step": QWEN_M4,
                                "olmoe-1b-7b decode step": OLMOE_M1,
                                "olmoe-1b-7b slot step": OLMOE_M4,
                                "arctic-480b decode step": ARCTIC_M1,
                                "mamba2-780m decode step": MAMBA_M1,
                                "mamba2-780m slot step": MAMBA_M4,
                                "jamba-v0.1-52b repeat step": JAMBA_M1,
                                "llava forward": LLAVA_FWD,
                                "llava decode step": LLAVA_M1,
                                "llava slot step": LLAVA_M4},
                        library_call="torch.mm(x_bf16, W_bf16.T, out_dtype="
                                     "torch.float32) on the same strided "
                                     "bf16 operands (cuBLAS, f32 output as "
                                     "the kernel's); library_bf16_out_ms: "
                                     "torch.matmul with a bf16 output"),
    "flash_attention_fwd": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:94",
        shapes={"prefill": FLASH_SHAPES,
                "tp prefill (1, 2)": FLASH_TP_SHAPES,
                "llava forward": FLASH_LLAVA,
                "phi3-mini forward": FLASH_PHI3},
        library_call="torch.nn.functional.scaled_dot_product_attention on "
                     "the same bf16 q, k, v as (1, BH, S, D) (bf16 output; "
                     "the kernel writes f32)"),
    # no TPU kernel backs the backward: it replaces the reference's custom
    # VJP of its flash attention, in plain JAX; its rows are phase 19a's
    "flash_attention_bwd": dict(
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:166",
        shapes={"phi3-mini training step": FLASH_BWD_PHI3,
                "llava-next-mistral-7b layer": FLASH_BWD_LLAVA,
                "whisper-tiny encoder layer": FLASH_BWD_WHISPER},
        summed=("phi3-mini training step",),
        library_call="the backward of torch.nn.functional."
                     "scaled_dot_product_attention on the same bf16 q, k, v "
                     "and cotangent as (1, BH, S, D), its forward run "
                     "outside the timed call (torch.autograd.grad)"),
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
# (CUDA 12.8's cuBLAS names its bf16 batched GEMMs "nvjet_...")
DOT_KERNEL_WORDS = ("q8_matvec", "q8_split_tc_kernel", "gemv", "gemm",
                    "wgmma_kernel", "bf16_cvt_tc_kernel", "flash_fwd",
                    "xmma", "cutlass", "nvjet")
# cuBLAS's products (the residual arm's, the attention's and the MoE
# experts'), told from the port's kernels by name
LIBRARY_WORDS = ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")
PORT_KERNEL_WORDS = ("q8_matvec_kernel", "q8_split_tc_kernel",
                     "q8_wgmma_kernel", "gemv_bf16_kernel", "wgmma_kernel",
                     "bf16_cvt_tc_kernel", "flash_fwd")
# phase 9a: (kernel, m, n, k, x dtype) — the main paths' products with K
# whole, as a tuned burst leaves it, and the frontend's K = 80: on the
# tensor-core launch (bf16 x), and as the tuned paths run it, f32 mel as x
# on the converting launch, which takes no tile
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
# the graphs of a replay window that lacked a kernel (phase 6's gates)
GRAPH_DUMPS = os.path.join(ROOT, "build", "graph_dumps")
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
# phase 14: the dense LM family, qwen2.5-14b at its published widths
# (configs/qwen2_5_14b.py: 48 layers, d_model 5120, 40 heads over 8 KV
# heads, d_ff 13,824, vocabulary 152,064), seeded random weights drawn on
# the card, no EOS. Every linear of a step runs at M = batch: the 337 of
# one step (q/k/v/o, gate/up/down a layer, and lm_head)
LM_ARCH = "qwen2.5-14b"
LM_SEED = 0
LM_PER_STEP = 7 * 48 + 1
LM_PROMPT = 64                    # 14a: one prompt of 64 tokens, 64 new
LM_NEW = 64
LM_BATCH = 4                      # 14a: batch 4, prompts of 16-64 tokens
LM_B4_LENS = (16, 64)             # left-padded with token 0 to the longest
LM_MAX_LEN = 160
LM_CPU_LAYERS = 2                 # the CPU check: embed, 2 layers, head
LM_CPU_PROMPT = 3
LM_CPU_TOL = 1e-2                 # of the CPU's largest logit
LM_REQUESTS = 2                   # captured requests after the capturing one
LM_SLOTS = 4                      # 14c: 12 requests over 4 slots
LM_SCHED_REQUESTS = 12
LM_SCHED_PROMPTS = (16, 64)
LM_SCHED_BUDGETS = (8, 32)
LM_KVQ_NEW = 32                   # 14d: one batch-1 request, int8 KV
LM_EAGER = 16                     # the eager loops' prompt and new tokens
LM_SHARD_DATA = 2                 # 14e: 14c's trace over a data-2 mesh
# 14e over (1, 4): every width divides by 4 (40 heads, 8 KV heads, d_ff
# 13,824, vocabulary 152,064); one batch-1 generate of LM_TP_NEW tokens
# after an LM_TP_PROMPT-token prompt, and LM_SLOTS short requests over
# LM_SLOTS slots (an eager step takes ~157 ms there: the floor and the
# near-tie checks step the prompts eagerly, so they stay short); the same
# drive with f32 activations over the same Q8_0 weights (the witness)
LM_TP_MESH = (1, 4)
LM_TP_PROMPT = 16
LM_TP_NEW = 16
LM_TP_SCHED_PROMPT = 8            # LM_SLOTS requests over LM_SLOTS slots
LM_TP_SCHED_NEW = 8
LM_TP_CHECK = 4                   # the logits check's prompt tokens
LM_TP_REPLAYS = 10                # step replays timed by CUDA events
# the next token's logits after LM_TP_CHECK prompt tokens, sharded
# against unsharded (bf16, both eager), of the unsharded largest: 48
# layers of seeded random weights carry bf16 rounding far, and the split
# products round in another order; a wrong layout moves the logits by
# O(1)
LM_TP_TOL = 5e-2
# near-ties (``tie_check``): a sharded bf16 run may first part from the
# unsharded one only where the f32 witness holds the two picks within
# TIE_FACTOR times the unsharded run's own spread from the witness,
# measured before any sharded run (``tie_floor``): two runs each within
# e of the f32 logits can pick apart only where the picks lie within 2 e
TIE_FACTOR = 2.0
# phase 18, sharded serving over meshes of logical devices, all the card:
# whisper-tiny at data 4 and 2 (18a), the paged pool at 4 (18b), the
# speculative waves at 2 (18c)
SHARD_DATAS = (SHARD_STEP_DATA, 2)
SHARD_PG_DATA = 4
SHARD_SPEC_DATA = 2
# 18d, tensor parallelism over "model" (whisper-tiny at full width): the
# (data, model) meshes of the card, one batch-1 transcribe of TP_NEW
# tokens and phase 10's trace over SLOTS slots each; the first decode
# step's logits against the unsharded engine's, of its largest (bf16:
# the split products' f32 partial sums round once, where the whole
# product rounds its own f32 sum)
TP_MESHES = ((1, 2), (2, 2), (1, 4))
TP_NEW = 24
TP_LOGIT_TOL = {"q8_0": 1e-2, "dense+flash": 3e-2}
TP_EXACT = ("q8_0",)              # paths held to the unsharded tokens exactly
# 18e, paged and speculative serving over "model": whisper-tiny's paged
# pool at full width on phase 11's trace over these meshes of the card
# (its tight arena, which preempts, on the exact path), and phase 12's
# echo whisper-base verifier with its whisper-tiny draft over one; the
# paged step and the rounds timed a replay at a time by CUDA events,
# TP_TIMED of each, for a median and a spread
TP_PAGED_MESHES = ((1, 2), (1, 4))
TP_TIGHT = ("q8_0",)              # paths also driven on the tight arena
TP_SPEC_MESH = (1, 2)
TP_TIMED = 10
# profiled windows of replayed LM steps lose a kernel record now and then
# on the card (one to nine of 36,000 in 8 steps; one in every window of
# 2 steps, window after window, late in a long run). So a spin kernel
# follows each replay, each replay's records are read apart, and the
# kernels of a replay the profiler saw whole (its spin kernels on both
# sides, the graph's fixed launches all there) are the step's; windows
# of LM_PROFILED_STEPS replays, LM_PROFILE_WINDOWS of them at most
LM_PROFILED_STEPS = 4
LM_PROFILE_WINDOWS = 8
# phase 15: the MoE family in bf16 (quant="none": the reference cannot
# serve a MoE model in Q8_0), weights drawn on the card from MOE_SEED, no
# EOS, max_len LM_MAX_LEN. olmoe-1b-7b at its published widths and depth
# (configs/olmoe_1b_7b.py: 16 layers, d_model 2048, 64 experts of d_ff
# 1024, top-8, vocabulary 50,304); arctic-480b at its published widths
# (d_model 7168, 56 heads over 8 KV heads, 128 experts of 4864, top-2, a
# dense branch of 4864, vocabulary 32,000) with its 35 layers cut to 1:
# its 954 GB of bf16 do not fit one card, one layer is 28 GB
MOE_SEED = 0
OLMOE_PER_STEP = 4 * 16 + 1       # q/k/v/o a layer and lm_head
ARCTIC_LAYERS = 1
ARCTIC_PER_STEP = 4 + 3 + 1       # q/k/v/o, the dense up/gate/down, lm_head
ARCTIC_NEW = 32                   # 15c: one 64-token prompt, 32 new
MOE_CPU_TOL = 3e-2                # of the CPU's largest logit: bf16 weights
# 15d: the smoke configs, four identical prompts over 4 slots (cap 2)
MOE_DROP_PROMPT = (3, 5, 7, 9)
MOE_DROP_NEW = 6
# phase 16: the SSM and hybrid families, weights drawn on the card from
# MOE_SEED as phase 15's, no EOS, max_len LM_MAX_LEN
MAMBA_ARCH = "mamba2-780m"
JAMBA_ARCH = "jamba-v0.1-52b"
MAMBA_PER_STEP = 2 * 48 + 1       # ssm.in_proj, ssm.out_proj; lm_head
JAMBA_LAYERS = 8                  # one pattern repeat of its 32 layers
# 7 SSM layers' 2, the attention layer's q/k/v/o, 4 dense FFNs' 3, lm_head
JAMBA_PER_STEP = 7 * 2 + 4 + 4 * 3 + 1
JAMBA_NEW = 32                    # 16c: one 64-token prompt, 32 new
SSM_CPU_TOL = 1e-2                # first logits, of the CPU's largest
SSM_LAYER_STEPS = 16              # 16c: one SSM layer's carried steps
SSM_LAYER_TOL = 1e-2              # bf16 at full width, of the largest
SSM_SCHED_PROMPTS = (8, 32)       # 16b: 12 requests over 4 slots
SSM_SCHED_BUDGETS = (16, 48)
# phase 17: the full-sequence forward and loss of every family, and the VLM
# served. llava-next-mistral-7b at its published widths and depth
# (configs/llava_next_mistral_7b.py: 32 layers, d_model 4096, 32 heads over
# 8 KV heads of 128, d_ff 14,336, vocabulary 32,000, a biased projector
# from 1024-wide patches), bf16 weights drawn on the card from MOE_SEED and
# quantized to Q8_0 by a second engine. The forward runs one row of the
# reference's train_4k cell: B = 1, S = 4096 and P = min(vision_patches,
# S // 2) = 1152 f32 patches (launch/input_specs.py), drawn from a CUDA
# generator seeded with FWD_SEED (the reference's vision tower is a stub)
VLM_ARCH = "llava-next-mistral-7b"
VLM_PER_STEP = 7 * 32 + 1         # q/k/v/o, gate/up/down a layer; lm_head
FWD_SEQ = 4096
FWD_SEED = 0
FWD_CE_CHUNK = 512                # loss_fn's: 8 readout chunks at 4096
FWD_REPS = 2                      # timed forwards after the recorded one
FWD_CPU_LAYERS = 2                # the CPU check: depth 2, a shorter row
FWD_CPU_SEQ = 256
# flash vs chunked logits, of the largest: the two round the bf16
# probabilities against other maxima (chunked: the row's, normalized;
# flash: a key block's running one), and each layer's bf16 output can
# land a step apart. At the depth-2 cut 3e-2; over llava's 32 layers the
# steps add up: 6 bf16 steps (0.1875) at |logit| 5.66 were measured, 3.3e-2
# (NVIDIA H100 80GB HBM3, 700.00 W), so the full depth is held at 5e-2. A
# wrong mask or layout moves the logits by O(1) and the loss with them.
FWD_FLASH_TOL = 3e-2
FWD_FLASH_FULL_TOL = 5e-2
FWD_LOSS_TOL = 1e-2               # flash vs chunked loss, absolute
# 17f: a smoke config of each family (dense, MoE, SSM, hybrid, VLM, audio)
SMOKE_FORWARD_ARCHS = ("qwen2.5-14b", "olmoe-1b-7b", "mamba2-780m",
                       "jamba-v0.1-52b", "llava-next-mistral-7b",
                       "whisper-tiny")
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


def release_memory(label: str) -> dict:
    """Free what the phases before ``label`` left on the card, with no
    live CUDA graph: unreachable engines and trees (the collector), the
    allocator's cached blocks, and the cuBLAS workspaces that PyTorch
    keeps for every stream a library product ran on (each capture warms
    up on a new side stream). Prints the allocated bytes and the
    allocator's live blocks by size before, and the allocated bytes
    after."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    blocks = collections.Counter(
        b["size"] for seg in torch.cuda.memory_snapshot()
        for b in seg["blocks"] if b["state"] == "active_allocated")
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    out = dict(allocated_bytes=before,
               largest_blocks=sorted(blocks.items(), reverse=True)[:8],
               cublas_workspaces_cleared=clear is not None,
               allocated_after_bytes=torch.cuda.memory_allocated())
    print(f"{label}: {before / 1e9:.3f} GB allocated at their start "
          f"(largest live blocks, bytes: count {out['largest_blocks']}); "
          f"{out['allocated_after_bytes'] / 1e9:.3f} GB after the cuBLAS "
          f"workspaces are cleared ({out['cublas_workspaces_cleared']})",
          flush=True)
    return out


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
               for e in prof.key_averages() if SPIN_KERNEL not in e.key)


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


def _q8_case(gen, m, n, k, k_full, xdt, split=False):
    """Operands of a Q8_0 kernel at one shape: (kernel args, library
    call, bytes moved, FLOPs, FLOP rate key, further yardsticks by the
    name of their time). With ``split`` (``q8_matmul``) an f32 x is
    priced as its three bf16 parts on the tensor cores."""
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
    rate = "float32_split" if split and xdt == "float32" else xdt
    return args, lambda: torch.matmul(x32, w_deq.t()), moved, \
        2 * m * n * k, rate, {}


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


def _flash_case(gen, bh, sq, sk, d, dt, causal=False):
    """q, k, v of flash_attention_fwd as the encoder and the forward hand
    them over: the (B, S, H, D) projections folded to (B*H, S, D) views.
    The operations count the query-key pairs the mask leaves (query i
    sees keys 0..i when causal), and the library call masks alike."""
    import torch
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn((1, s, bh, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2).reshape(bh, s, d) for s in (sq, sk, sk))
    size = q.element_size()
    moved = (bh * sq * d + 2 * bh * sk * d) * size + bh * sq * d * 4
    q4, k4, v4 = (t.contiguous()[None] for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    return (q, k, v), lambda: sdpa(q4, k4, v4, is_causal=causal), moved, \
        4 * bh * pairs * d, dt, {}


def _graph_timer(fn):
    """``graph_ms``'s time of ``fn`` as ``device_ms``'s (ms, source)
    pair."""
    return graph_ms(fn), "graph_events"


def _measure(name, label, kernel, plain, library, moved, flops, rate, tol,
             extra, timer=device_ms):
    """Kernel against plain at one shape, then the times (by ``timer``)
    and the bound, and the time of each further yardstick in ``extra``.
    ``tol`` is relative to the plain output's largest value (at least
    1)."""
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
    # the split f32 route's bound beside the f32 FMA rate's, which it can beat
    fma = ({"bound_f32_fma_ms": bound(
        bytes_ms, flops / FLOPS_PER_S["float32"] * 1e3)[0]}
        if rate == "float32_split" else {})
    timed = {"ms": timer(kernel), "plain_ms": timer(plain),
             "library_ms": timer(library),
             **{key: timer(fn) for key, fn in extra.items()}}
    return dict(max_abs_err=err, bytes=moved, flops=flops,
                bytes_ms=bytes_ms, ops_ms=ops_ms, wall_ms=wall_ms(kernel),
                bound_ms=b_ms, bound_by=b_by, **fma,
                **{key: ms for key, (ms, _) in timed.items()},
                ms_source={key: src for key, (_, src) in timed.items()})


def check_kernels(late: bool = False):
    """Phase 2: every kernel against its plain version at the main paths'
    shapes, with its times and bound, and the extra flash checks; with
    ``late``, only the rows of LATE_ROWS (the 4096-token forward's, run
    after phase 17, timed with CUDA events over captured graphs), else
    every other. Returns the per-kernel records."""
    import torch
    from repro_torch.kernels import (
        bf16_matmul, flash_attention, q8_matmul, q8_matvec)

    mods = {"q8_matvec": (q8_matvec.q8_matvec, q8_matvec.q8_matvec_plain,
                          _q8_case),
            "q8_matmul": (q8_matmul.q8_matmul, q8_matmul.q8_matmul_plain,
                          functools.partial(_q8_case, split=True)),
            "bf16_matmul": (bf16_matmul.bf16_matmul,
                            bf16_matmul.bf16_matmul_plain, _bf16_case)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    for name, meta in KERNELS.items():
        if name == "flash_attention_bwd":       # phase 19a's rows
            continue
        rows = []
        for per, shapes in meta["shapes"].items():
            if (per in LATE_ROWS) != late:
                continue
            for shape in shapes:
                if name == "flash_attention_fwd":
                    bh, sq, sk, d, count, dt, causal = shape
                    args, library, moved, flops, rate, extra = _flash_case(
                        gen, bh, sq, sk, d, dt, causal)
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
                               library, moved, flops, rate, tol, extra,
                               _graph_timer if late else device_ms)
                row.update(dims, per=per, per_step=count)
                print(f"kernel {name} {label} x{count} per {per}: "
                      f"max_abs_err={row['max_abs_err']:.3e} "
                      f"ms={row['ms']:.5f} wall_ms={row['wall_ms']:.5f} "
                      f"plain_ms={row['plain_ms']:.5f} "
                      f"library_ms={row['library_ms']:.5f} "
                      + "".join(f"{key}={row[key]:.5f} " for key in extra)
                      + f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})"
                      + "".join(f" {key}={row[key]:.5f}" for key in row
                                if key == "bound_f32_fma_ms"), flush=True)
                rows.append(row)
        records[name] = rows
    for bh, sq, sk, d, _, dt, causal in ([] if late else FLASH_CHECKS):
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


@contextlib.contextmanager
def kept_graphs():
    """Inside, every CUDA graph the port captures keeps its cudaGraph_t
    (``keep_graph=True``; its first replay instantiates it), so that
    ``debug_dump`` can write it: a default graph drops it at the end of
    its capture, debug mode or not (PyTorch 2.11)."""
    import torch
    base = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = functools.partial(base, keep_graph=True)
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = base


def graph_routes(graph, path: str, routes):
    """The kernel nodes of a captured graph by route: the graph's
    ``debug_dump`` (a graph captured under ``kept_graphs``) written to
    ``path``, and each route counted over the nodes whose entry names a
    kernel holding it. Returns (nodes, {route: nodes}), or None where no
    dump was written."""
    graph.debug_dump(path)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    # a node's entry opens a line with its quoted name and "[" (an edge's
    # line goes on with " ->")
    starts = [m.start() for m in re.finditer(r'^"graph_\d+_node_\d+"\[',
                                             text, flags=re.M)]
    nodes = [text[a:b] for a, b in zip(starts, starts[1:] + [len(text)])]
    return len(nodes), {route: sum(route in node for node in nodes)
                        for route in routes}


def where_time_goes(eng, mel, vocab: int, steps: int = PROFILED_STEPS,
                    expect=None):
    """One prefill and ``steps`` decode steps under torch.profiler: device
    time (summed kernel time) against host wall time, the device's idle
    share, and each phase's largest kernels. Returns the summary and each
    phase's kernels by name (``_by_kernel``, the decode's per step).
    ``expect`` ({"prefill" or "step": {route: launches}}) holds what the
    launch counts already fixed: a window whose routes differ from it lost
    kernel records and is profiled again, REPLAY_PROFILES times at most;
    the caller checks the last window's routes. The windows are eager (no
    graph to dump): where they differ, the wrappers' own launch counts
    over them are printed beside the profiler's."""
    from repro_torch.kernels import (
        bf16_matmul, flash_attention, q8_matmul, q8_matvec)
    wrappers = (q8_matmul.q8_matmul, q8_matvec.q8_matvec,
                bf16_matmul.bf16_matmul, flash_attention.flash_attention_fwd)
    expect = expect or {}
    for attempt in range(REPLAY_PROFILES):
        before = [fn.launches for fn in wrappers]
        out, pre_kernels, dec_kernels = _profile_eager(eng, mel, vocab,
                                                       steps)
        windows = {"prefill": pre_kernels, "step": dec_kernels}
        seen = {phase: {route: n for route, (n, _) in
                        by_route(windows[phase], want).items()}
                for phase, want in expect.items()}
        if seen == expect:
            break
        python = {fn.__name__: fn.launches - n
                  for fn, n in zip(wrappers, before) if fn.launches != n}
        print(f"eager windows: kernels by route {seen} in profiled window "
              f"{attempt + 1}, expected {expect}; the wrappers launched "
              f"{python} from Python over the prefill and {steps} steps; "
              "profiling again", flush=True)
    print(f"where the time goes (profiled): {json.dumps(out)}", flush=True)
    return out, pre_kernels, dec_kernels


def _profile_eager(eng, mel, vocab: int, steps: int):
    """``where_time_goes``'s two windows, each opened by a spin kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    mel_t = torch.from_numpy(mel).cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        t0 = time.perf_counter()
        _, state = eng.prefill(mel_t)
        torch.cuda.synchronize()
        pre_wall = (time.perf_counter() - t0) * 1e3
    pre_dev = device_us(prof) / 1e3
    pre_top = _top_kernels(prof, 1, 12)
    pre_kernels = _by_kernel(prof)
    tok = torch.full((1, 1), 1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
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
    want = {"q8_wgmma_kernel": 32, "q8_split_tc_kernel": 0}
    split, pre_kernels, _ = where_time_goes(eng, mel, cfg.vocab_size,
                                            expect={"prefill": want})
    routes = {route: launches for route, (launches, _) in by_route(
        pre_kernels, want).items()}
    print(f"main path prefill q8_matmul launches by kernel: {routes}",
          flush=True)
    if routes != want:
        raise AssertionError(f"prefill q8_matmul kernels {routes}: expected "
                             "32 tensor-core launches and no converting "
                             "one")
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
    want_step = {"gemv_bf16_kernel": 33, "matvec_kernel": 0}
    split, _, dec_kernels = where_time_goes(eng, mel, cfg.vocab_size,
                                            expect={"step": want_step})
    routes = by_route(dec_kernels, want_step)
    print(f"dense decode step bf16_matmul by kernel (launches, device ms "
          f"per step): {routes}", flush=True)
    if {route: launches for route, (launches, _) in routes.items()} != \
            want_step:
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


def _dump_graph(eng, label, phase, key, want, seen):
    """``graph_routes`` of the graph ``eng`` replays at ``key``, printed
    beside the launches the profiler saw in its window and those
    expected."""
    os.makedirs(GRAPH_DUMPS, exist_ok=True)
    stem = re.sub(r"[^A-Za-z0-9_]", "_", f"{label}-{phase}")
    path = os.path.join(GRAPH_DUMPS, f"{stem}.dot")
    nodes = graph_routes(eng._graphs[key].graph, path, want)
    print(f"captured {label}: the {phase} graph's kernel nodes (nodes, by "
          f"route): {nodes}; the profiler saw {seen}, expected {want} "
          f"({path})", flush=True)
    return nodes


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
    with kept_graphs():                           # for _dump_graph
        res = eng.transcribe(mel, max_new=MAX_NEW)    # captures, replays
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
    # and is profiled again, after the graph's own kernel nodes are
    # counted (once a graph) and printed beside the profiler's
    keys = {"prefill": eng._key("prefill", 1, f),
            "step": eng._key("step", 1, f)}
    dumped = {}
    for attempt in range(REPLAY_PROFILES):
        (pre_kernels, pre_top, pre_wall, dec_kernels, dec_top,
         dec_wall) = _profile_replays(eng, f)
        launches = {phase: {name: launches for name, (launches, _) in
                            by_route(kernels, replay_kernels[phase]).items()}
                    for phase, kernels in (("prefill", pre_kernels),
                                           ("step", dec_kernels))}
        if launches == replay_kernels or not (pre_kernels and dec_kernels):
            break
        for phase, want in replay_kernels.items():
            if launches[phase] != want and phase not in dumped:
                dumped[phase] = _dump_graph(eng, label, phase, keys[phase],
                                            want, launches[phase])
        print(f"captured {label}: kernels per replay {launches} in profiled "
              f"window {attempt + 1}, expected {replay_kernels}; profiling "
              "again", flush=True)
    if "prefill" not in dumped:                  # the prefill graph's own
        dumped["prefill"] = _dump_graph(eng, label, "prefill",
                                        keys["prefill"],
                                        replay_kernels["prefill"],
                                        launches["prefill"])
    out = dict(prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
               prefill_wall_ms=pre_wall, decode_wall_ms_per_step=dec_wall,
               eager=eager_split, prefill_graph_nodes=dumped["prefill"])
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
        args, _, moved, flops, rate, _ = _q8_case(
            gen, m, n, k, k, xdt, split=kernel == "q8_matmul")
        mod = q8_matmul if kernel == "q8_matmul" else q8_matvec
        fn, plain = getattr(mod, kernel), getattr(mod, f"{kernel}_plain")
    b_ms, b_by = bound(moved / HBM_BYTES_PER_S * 1e3,
                       flops / FLOPS_PER_S[rate] * 1e3)
    return args, fn, plain, b_ms, b_by


def check_tiles():
    """Phase 9a: every admissible launch tile of the three products at
    whisper-tiny's shapes against the plain version, and its device time
    beside the default launch's and the bound. The converting launch of
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
    rounds = spec._statics[(b, f)][0].rounds
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
    rounds = spec._statics[(b, f)][0].rounds
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
    rounds = spec._statics[(b, f)][0].rounds
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
            rk = spec._statics[(PS_SLOTS, f)][0].rounds
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
                          wall_s=wall), (bp_echo, tp_echo, bp, tp)


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
    # each pool's slot step under the profiler; windows whose kernels
    # differ lost records and are profiled again
    for attempt in range(REPLAY_PROFILES):
        kernels = {mode: {k: v[0] for k, v in
                          _profile_slot_steps(scheds[mode])[0].items()}
                   for mode in scheds}
        matvec = sum(n for k, n in kernels["on"].items()
                     if "q8_matvec_kernel" in k)
        if kernels["on"] == kernels["off"] and matvec == 33:
            break
        print(f"telemetry gate: replayed slot step kernels on and off "
              f"differ or {matvec} q8_matvec_kernel in profiled window "
              f"{attempt + 1}; profiling again", flush=True)
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


# ---------------------------------------------------------------------------
# Phase 18: sharded serving (slot-DP over a mesh of logical devices)
# ---------------------------------------------------------------------------
def _shard_mesh(n: int):
    """A data-only serving mesh of ``n`` logical devices, all the card."""
    import torch
    from repro_torch.launch.mesh import make_serve_mesh
    return make_serve_mesh(data=n, devices=[torch.device("cuda:0")] * n)


def _profile_sharded_steps(sched):
    """PROFILED_STEPS sharded slot steps under torch.profiler, each every
    shard's replay and the scheduler's host read: kernels by name a step,
    the top kernels and host wall ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            sched._replay_all(sched._programs)
            sched._host_rows(sched._tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    return (_by_kernel(prof, PROFILED_STEPS),
            _top_kernels(prof, PROFILED_STEPS, 8), wall)


def _row_bits(eng, sched, mel) -> bool:
    """One request of 2 tokens through the sharded pool, then a batch-1
    ``transcribe`` of its mel on the same engine: the last decoder layer's
    self K and V of the request's slot at positions 0-1 equal the batch-1
    step's, bit for bit."""
    import torch
    f = mel.shape[1]
    rid = sched.submit(mel, max_new=2)
    sched.admit()
    slot = next(s for s, a in sched._active.items() if a.rid == rid)
    sched.run()
    dev, row = sched.pool.locate(slot)
    kv = sched.pool.states[dev].layer_states.self_kv[-1]
    eng.transcribe(mel, max_new=2)
    st = eng._static[(1, f)].state.layer_states.self_kv[-1]
    torch.cuda.synchronize()
    return (torch.equal(kv.k[row, :2], st.k[0, :2])
            and torch.equal(kv.v[row, :2], st.v[0, :2]))


_LEDGER_TOTALS = ("offloaded_calls", "fallback_calls", "offloaded_flops",
                  "fallback_flops", "residual_flops", "tuned_calls",
                  "by_kernel", "by_backend")


def sharded_path(label, eng0, counted, programs, replay_kernels, n_req,
                 slot4):
    """Phase 18a on one path: phase 10's trace (``_cb_workload``, n_req
    requests, the second wave mid-drain) over SLOTS slots at 1500 frames,
    first unsharded, then over meshes of SHARD_DATAS entries of the card,
    each on a new engine (max_len CB_MAX_LEN, no EOS) with ``eng0``'s
    weights and quantization. The launch counts are zeroed before each
    sharded drive and read after it. Gates: tokens equal the unsharded
    scheduler's; the step key built once and captured once a shard, then
    never; Python launches two passes of the batch-1 prefill and of n
    shards' steps; a replayed step n x the unsharded step's kernels by
    name; ``sum(by_device)`` the ledger's FLOPs over n devices; sharded
    and unsharded plan keys disjoint; the ledger's totals and commits the
    unsharded drive's; a warm drive's tokens with no capture and no
    launch; a shard's row bit for bit the batch-1 step's. Printed beside
    ``slot4`` (phase 10's 4-row step): the sharded step's host ms (the
    warm drive's median), device ms and idle share. Returns (launches,
    summary by n)."""
    import statistics

    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    cfg = eng0.cfg
    f = cfg.encoder_ctx
    mels, max_news, _ = _cb_workload(cfg, n_req)

    def make(mesh):
        return ServeEngine(cfg, eng0.params, max_len=CB_MAX_LEN,
                           quant=eng0._serve_quant, offload=OffloadEngine(),
                           eos_id=-1, device="cuda", mesh=mesh)

    one = make(None)
    s1 = one.scheduler(SLOTS, f)
    rids, adm1, steps1, _, _, _, _ = _drain_waves(s1, mels, max_news)
    got1 = s1.run()
    want = [got1[r].tokens for r in rids]
    totals1 = _stats(one.offload)
    commits1 = one.offload.ledger.commits
    pre_run, step_run = programs
    launches = {name: 0 for name in counted}
    out = {}
    for n in SHARD_DATAS:
        eng = make(_shard_mesh(n))
        torch.cuda.synchronize()
        _zero(counted)
        sched = eng.scheduler(SLOTS, f)
        rids, admissions, steps, tokens, _, captures, drain_s = \
            _drain_waves(sched, mels, max_news)
        got = _read(counted)
        for name, c in got.items():
            launches[name] += c
        res = sched.run()
        toks = [res[r].tokens for r in rids]
        want_l = {name: CAPTURE_PASSES * (pre_run.get(name, 0)
                                          + n * step_run.get(name, 0))
                  for name in counted}
        totals = _stats(eng.offload)
        flops = (totals["offloaded_flops"] + totals["fallback_flops"]
                 + totals["residual_flops"])
        by_dev = totals["by_device"]
        disjoint = not set(one._plans.plans) & set(eng._plans.plans)
        same = all(totals[k] == totals1[k] for k in _LEDGER_TOTALS)
        print(f"sharded {label} data={n}: {n_req} requests, {SLOTS} slots "
              f"({sched.pool.n_shards} shards of {sched.pool.shard_size}), "
              f"{admissions} admissions, {steps} steps, {tokens} tokens in "
              f"{drain_s * 1e3:.3f} ms; tokens equal the unsharded "
              f"scheduler's: {toks == want}; step captures {captures} after "
              f"the first step -> {eng._step_captures}, builds "
              f"{eng._step_builds}; launches from Python {got} (expected "
              f"{want_l}); by_device {by_dev} (sum {sum(by_dev.values())}, "
              f"ledger {flops}); keys disjoint {disjoint}; ledger totals "
              f"equal the unsharded drive's {same}; commits "
              f"{eng.offload.ledger.commits} (unsharded {commits1})",
              flush=True)
        if toks != want:
            bad = next(i for i, (a, b) in enumerate(zip(toks, want))
                       if a != b)
            raise AssertionError(f"sharded {label} data={n}: request {bad} "
                                 f"tokens {toks[bad]} != {want[bad]}")
        if (captures != n or eng._step_captures != n
                or eng._step_builds != 1):
            raise AssertionError(f"sharded {label} data={n}: captures "
                                 f"{captures} -> {eng._step_captures}, "
                                 f"builds {eng._step_builds}")
        if got != want_l:
            raise AssertionError(f"sharded {label} data={n}: launches {got} "
                                 f"!= {want_l}")
        if (sum(by_dev.values()) != flops
                or sorted(by_dev) != [f"dev{i}" for i in range(n)]):
            raise AssertionError(f"sharded {label} data={n}: by_device "
                                 f"{by_dev} against {flops} FLOPs")
        if not disjoint or not same or \
                eng.offload.ledger.commits != commits1 or \
                commits1 != adm1 + steps1:
            raise AssertionError(f"sharded {label} data={n}: keys disjoint "
                                 f"{disjoint}, ledger equal {same}, commits "
                                 f"{eng.offload.ledger.commits} vs "
                                 f"{commits1}")
        # the same drive on the warm pool: nothing captured or launched
        k0 = eng._step_captures
        _zero(counted)
        rids2, _, steps2, tokens2, step_s, _, warm_s = _drain_waves(
            sched, mels, max_news)
        again = sched.run()
        if ([again[r].tokens for r in rids2] != want
                or eng._step_captures != k0 or any(_read(counted).values())):
            raise AssertionError(f"sharded {label} data={n}: the warm "
                                 "drive's tokens, captures or launches")
        want_step = {k: v * n for k, v in replay_kernels["step"].items()}
        for attempt in range(REPLAY_PROFILES):
            kernels, top, wall = _profile_sharded_steps(sched)
            seen = {name: c for name, (c, _) in
                    by_route(kernels, want_step).items()}
            if seen == want_step:
                break
            print(f"sharded {label} data={n}: kernels a step {seen} in "
                  f"profiled window {attempt + 1}, expected {want_step}; "
                  "profiling again", flush=True)
        if seen != want_step:
            raise AssertionError(f"sharded {label} data={n}: kernels a "
                                 f"replayed step {seen} != {want_step}")
        dev = sum(ms for _, ms in kernels.values())
        host = statistics.median(step_s) * 1e3
        routes = by_route(kernels, want_step)
        bits = _row_bits(eng, sched, mels[0])
        print(f"sharded {label} data={n}: a shard's row bit for bit the "
              f"batch-1 step's: {bits}", flush=True)
        if not bits:
            raise AssertionError(f"sharded {label} data={n}: a shard's row "
                                 "differs from the batch-1 step's")
        out[n] = dict(
            path=label, data=n, requests=n_req, slots=SLOTS,
            shard_size=sched.pool.shard_size, slot_steps=steps,
            tokens=tokens, first_drive_ms=drain_s * 1e3,
            warm_drive_ms=warm_s * 1e3, drain_tok_s=tokens2 / warm_s,
            launches=got, step_captures=eng._step_captures,
            step_builds=eng._step_builds, by_device=by_dev,
            step_host_ms_median=host, step_host_ms_min=min(step_s) * 1e3,
            step_wall_ms_profiled=wall, step_device_ms=dev,
            step_idle_share=1 - dev / wall,
            step_idle_share_unprofiled=1 - dev / host,
            step_kernels=seen,
            step_kernel_device_ms={k: v[1] for k, v in routes.items()},
            step_top_kernels=top,
            unsharded_step_host_ms=slot4.get("slot_step_host_ms_median"),
            unsharded_step_device_ms=slot4.get("slot_step_device_ms"),
            unsharded_step_idle_share=slot4.get(
                "slot_step_idle_share_unprofiled"),
            unsharded_tok_s=slot4.get("drain_tok_s"))
        print(f"sharded {label} data={n} summary: {json.dumps(out[n])}",
              flush=True)
        del eng, sched
    return launches, out


def sharded_paged(eng0, counted, power_w):
    """Phase 18b: phase 11's trace (``_pg_workload``) over PG_SLOTS logical
    slots of the paged pool, unsharded and over a mesh of SHARD_PG_DATA
    entries of the card (one physical device: the arenas stay one tensor),
    and over the contiguous SLOTS-slot pool, on new Q8_0 engines (max_len
    PG_MAX_LEN, no EOS). The self arena has phase 11's pages and the few
    more that make its page count divide over the shards. Gates: the
    sharded tokens equal the unsharded paged pool's and the contiguous
    scheduler's; commits = prefills + steps + replays; a slot's self pages
    come from its shard's range whenever that range had a free page;
    captures n shards' paged steps and the batch-1 step (replays). Printed:
    requests per committed byte against the contiguous pool's (phase 11:
    2.97x). Returns (launches, summary)."""
    import numpy as np
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    cfg = eng0.cfg
    f = cfg.encoder_ctx
    n = SHARD_PG_DATA
    mels, _, _, max_news, arrivals = _pg_workload(cfg)
    pages_per = -(-(int(np.mean(max_news)) + 1) // PG_PAGE)
    n_pages = 1 + PG_SLOTS * pages_per
    n_pages += -n_pages % n
    geom = dict(page_size=PG_PAGE, n_pages=n_pages, cross_page_size=f,
                n_cross_pages=1 + PG_DISTINCT)

    def make(mesh):
        return ServeEngine(cfg, eng0.params, max_len=PG_MAX_LEN,
                           quant=eng0._serve_quant, offload=OffloadEngine(),
                           eos_id=-1, device="cuda", mesh=mesh)

    one = make(None)
    r_one = _pg_drive(one.paged_scheduler(PG_SLOTS, f, **geom), mels,
                      max_news, arrivals, power_w)
    r_cont = _pg_drive(one.scheduler(n_slots=SLOTS, n_frames=f), mels,
                       max_news, arrivals, power_w)
    eng = make(_shard_mesh(n))
    torch.cuda.synchronize()
    _zero(counted)
    sched = eng.paged_scheduler(PG_SLOTS, f, **geom)
    pool = sched.pool
    picks = []
    alloc = pool.alloc_self_page

    def tracked(slot):
        want = pool.slot_shard(slot) % pool.self_alloc.n_shards
        had = bool(pool.self_alloc._free[want])
        page = alloc(slot)
        picks.append((want, pool.self_alloc.page_shard(page), had))
        return page

    pool.alloc_self_page = tracked
    r = _pg_drive(sched, mels, max_news, arrivals, power_w)
    launches = _read(counted)
    commits = eng.offload.ledger.commits
    local = [w == p for w, p, had in picks if had]
    rpb = {k: v["active_peak"] / v["kv_committed_bytes"]
           for k, v in (("sharded", r), ("unsharded", r_one),
                        ("contiguous", r_cont))}
    out = dict(data=n, slots=PG_SLOTS, geometry=geom,
               n_shards=pool.n_shards, page_shards=pool.self_alloc.n_shards,
               tokens_equal_unsharded=r["tokens"] == r_one["tokens"],
               tokens_equal_contiguous=r["tokens"] == r_cont["tokens"],
               prefills=sched.prefills, replays=sched.replays,
               slot_steps=r["slot_steps"], commits=commits,
               shared_hits=sched.shared_hits, preemptions=sched.preemptions,
               self_page_allocations=len(picks),
               shard_local_when_free=sum(local), with_free_page=len(local),
               step_captures=eng._step_captures,
               step_builds=eng._step_builds, launches=launches,
               tok_s=r["tok_s"], unsharded_tok_s=r_one["tok_s"],
               kv_committed_bytes=r["kv_committed_bytes"],
               active_peak=r["active_peak"],
               requests_per_byte_ratio=rpb["sharded"] / rpb["contiguous"],
               unsharded_requests_per_byte_ratio=(rpb["unsharded"]
                                                  / rpb["contiguous"]))
    print(f"sharded paged summary: {json.dumps(out)}", flush=True)
    if not (out["tokens_equal_unsharded"] and out["tokens_equal_contiguous"]):
        raise AssertionError("sharded paged: tokens differ from the "
                             "unsharded paged pool's or the contiguous "
                             "scheduler's")
    if commits != sched.prefills + r["slot_steps"] + sched.replays:
        raise AssertionError(f"sharded paged: {commits} commits")
    if not local or not all(local) or pool.self_alloc.n_shards != n:
        raise AssertionError(f"sharded paged: self pages off their shard's "
                             f"range {sum(local)} of {len(local)}")
    if eng._step_captures != n + 1 or eng._step_builds != 2:
        raise AssertionError(f"sharded paged: {eng._step_captures} captures, "
                             f"{eng._step_builds} builds")
    return launches, out


def sharded_spec(spec_params, counted):
    """Phase 18c: phase 12c's trace (``_ps_workload``) through
    ``SpecScheduler``'s waves of PS_SLOTS rows with phase 12's echo
    whisper-base verifier (Q8_0) and whisper-tiny draft, unsharded and
    over a mesh of SHARD_SPEC_DATA entries of the card shared by both
    models: each wave's one-shot batch splits over the data shards, as
    the reference's waves serve on a mesh. Gates: tokens equal the
    unsharded waves'; the window and the draft step each built once and
    captured once a shard; ``by_device`` over the mesh's devices; the
    round schedulers refuse the mesh, as the reference's do. Returns
    (launches, summary, the unsharded waves' tokens and acceptance)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.speculative import SpecScheduler

    bp_echo, tp_echo = spec_params[:2]
    base = dataclasses.replace(get_config("whisper-base"), quant="q8_0")
    tiny = get_config("whisper-tiny")
    f = base.encoder_ctx
    n = SHARD_SPEC_DATA
    mels, max_news, _ = _ps_workload(base)
    launches = {name: 0 for name in counted}
    toks = {}
    for mesh in (None, _shard_mesh(n)):
        v = ServeEngine(base, bp_echo, max_len=PS_MAX_LEN, quant="q8_0",
                        offload=OffloadEngine(), eos_id=-1, device="cuda",
                        mesh=mesh)
        spec = v.speculative(tiny, tp_echo, k=PS_K)
        torch.cuda.synchronize()
        _zero(counted)
        sched = SpecScheduler(spec, n_slots=PS_SLOTS)
        t0 = time.perf_counter()
        rids = [sched.submit(m, max_new=mn) for m, mn in zip(mels, max_news)]
        res = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read(counted)
        n_tok = sum(res[r].steps for r in rids)
        toks[mesh is None] = dict(tokens=[res[r].tokens for r in rids],
                                  tok_s=n_tok / wall, rounds=spec.rounds,
                                  acceptance=spec.acceptance_rate())
        if mesh is None:
            del spec, v, sched
            continue
        for name, c in got.items():
            launches[name] += c
        refused = {}
        for mode in ("continuous", "paged"):
            try:
                spec.continuous(PS_SLOTS, f) if mode == "continuous" \
                    else spec.paged(PS_SLOTS, f, page_size=PS_PAGE)
                refused[mode] = False
            except NotImplementedError:
                refused[mode] = True
        out = dict(
            mode="wave", data=n, requests=PS_REQUESTS, slots=PS_SLOTS,
            rounds=spec.rounds, tok_s=toks[False]["tok_s"],
            unsharded_tok_s=toks[True]["tok_s"],
            unsharded_rounds=toks[True]["rounds"],
            verify_captures=v._verify_captures,
            verify_builds=v._verify_builds,
            draft_captures=spec.draft._step_captures,
            draft_builds=spec.draft._step_builds,
            by_device=dict(v.offload.stats.by_device), launches=got,
            rounds_schedulers_refused=refused,
            tokens_equal_unsharded=toks[False]["tokens"]
            == toks[True]["tokens"])
        del spec, v, sched
    print(f"sharded spec wave data={n}: {json.dumps(out)}", flush=True)
    if not out["tokens_equal_unsharded"]:
        raise AssertionError("sharded spec wave: tokens differ from the "
                             "unsharded waves'")
    if (out["verify_captures"] != n or out["verify_builds"] != 1
            or out["draft_captures"] != n or out["draft_builds"] != 1
            or sorted(out["by_device"]) != [f"dev{i}" for i in range(n)]
            or not all(refused.values())):
        raise AssertionError(f"sharded spec wave: {out}")
    return launches, out, toks[True]


def _tp_mesh(data: int, model: int):
    """A serving mesh of (data, model) logical devices, all the card."""
    import torch
    from repro_torch.launch.mesh import make_serve_mesh
    return make_serve_mesh(data, model,
                           devices=[torch.device("cuda:0")] * (data * model))


def _forced_logits(eng, seq, mel=None):
    """An engine's logits at each token of ``seq`` (ints), fed one at a
    time by ``serve_step`` (eager) over its batch-1 buffers and serving
    weights (split over "model" on a mesh): whisper's after the prefill
    of ``mel`` (1, F, n_mels), an LM's from empty caches. (len(seq), V)
    f32 on the host: row i the logits that pick the token after
    ``seq[:i + 1]``."""
    import torch
    from repro_torch.models import model as model_lib
    st = (eng._lm_static_for(1) if mel is None
          else eng._static_for(1, mel.shape[1]))
    rows = []
    with torch.no_grad():
        if mel is None:
            for t in model_lib.state_tensors(st.state):
                t.zero_()
        else:
            st.mel.copy_(torch.as_tensor(mel))
            eng._prefill_fn(st)
        for t in seq:
            tok = torch.full((1, 1), int(t), dtype=torch.long,
                             device=st.device)
            logits, _ = model_lib.serve_step(eng._params_on(st.device),
                                             eng.cfg, tok, st.state,
                                             engine=eng.offload)
            rows.append(logits[0, -1, :eng.cfg.vocab_size].float())
    return torch.stack(rows).cpu()


def logit_spread(got, ref) -> float:
    """The largest |got - ref| of two runs' logits (rows of tokens), each
    row's of ``ref``'s largest |logit| there."""
    return float(((got - ref).abs().amax(-1)
                  / ref.abs().amax(-1)).max())


def tie_floor(bf16_rows, f32_rows) -> dict:
    """The bf16 floor of an unsharded run, measured before any sharded
    run: its logits' spread from its f32 witness's (``logit_spread``)
    along its own tokens, and the tie bound TIE_FACTOR times it."""
    floor = logit_spread(bf16_rows, f32_rows)
    return {"floor": floor, "bound": TIE_FACTOR * floor}


def tie_check(ref_at, want, got, bound: float) -> dict:
    """Whether a sharded run's tokens ``got`` are the unsharded ``want``,
    or first part at a near-tie: at their first difference j the f32
    witness's logits there (``ref_at(j)``, after ``want[:j]``) hold the
    two picks within ``bound`` (``tie_floor``) of their largest |logit|
    of each other. Returns {"equal", "first_diff", "gap", "tie"}."""
    j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             None)
    if j is None:
        same = len(want) == len(got)
        return {"equal": same, "tie": False, "gap": None,
                "first_diff": None if same else min(len(want), len(got))}
    logits = ref_at(j)
    gap = abs(float(logits[want[j]] - logits[got[j]])) / float(
        logits.abs().max())
    return {"equal": False, "first_diff": j, "gap": gap,
            "tie": gap <= bound}


def _ties_ok(checks) -> bool:
    return all(c["equal"] or c["tie"] for c in checks)


def _f32_witness(eng0, max_len: int):
    """The f32 witness of ``eng0``'s path: the same weights (Q8_0
    dequantized), f32 activations and chunked attention, served by plain
    PyTorch on the card (no offload engine, so no kernel)."""
    import dataclasses

    import torch
    from repro_torch.core import tree
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(
        dataclasses.replace(eng0.cfg, dtype="float32", param_dtype="float32",
                            attn_impl="chunked"),
        tree.map_with_path(lambda _, x: x.float() if torch.is_tensor(x)
                           and x.is_floating_point() else x, eng0.params),
        max_len=max_len, quant=eng0._serve_quant, offload=None, eos_id=-1,
        device="cuda")


def _tp_drive(eng, mels, max_news, f: int):
    """A batch-1 ``transcribe`` of ``mels[0]`` (TP_NEW tokens), then
    phase 10's trace over SLOTS slots: (its tokens, the scheduler's
    tokens, the transcribe's result, the scheduler)."""
    res = eng.transcribe(mels[0], max_new=TP_NEW)[0]
    sched = eng.scheduler(SLOTS, f)
    rids, *_ = _drain_waves(sched, mels, max_news)
    got = sched.run()
    return res.tokens, [got[r].tokens for r in rids], res, sched


def _tp_step_ms(eng, f: int):
    """Device ms of one replay of the batch-1 step graph at (1, f)."""
    prog = eng._graphs[eng._key("step", 1, f)]
    return device_ms(prog.graph.replay)


def tp_path(label, eng0, counted, n_req):
    """Phase 18d on one path: whisper-tiny at full width with ``eng0``'s
    weights and quantization, unsharded and then over each of TP_MESHES
    (all the card), each a new engine (max_len CB_MAX_LEN, no EOS). The
    launch counts are zeroed before each engine's drive (``_tp_drive``)
    and read after it. Before any sharded run, the bf16 floor
    (``tie_floor``): the unsharded engine's logits along its transcribe
    against the f32 witness's, the same weights (Q8_0 dequantized)
    served in f32 by plain PyTorch on the card (no kernel). Gates: the
    transcribe's and the scheduler's tokens equal the unsharded
    engine's, exactly on the TP_EXACT paths, else or up to a near-tie
    (``tie_check`` at the floor's bound over the witness's logits); the
    first decode step's logits within TP_LOGIT_TOL of its largest.
    Printed beside the unsharded engine's: the transcribe's host prefill
    ms and decode ms a token, the batch-1 step graph's device ms, the
    slot step's device ms and host wall ms a step (profiled), the
    launches by kernel, and which blocks ran split or whole and why
    (``rules.tp_summary``). On one card this measures the machinery,
    not scaling. Returns (launches, summary by mesh)."""
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import rules

    cfg = eng0.cfg
    f = cfg.encoder_ctx
    mels, max_news, _ = _cb_workload(cfg, n_req)
    tol = TP_LOGIT_TOL[label]
    total = {name: 0 for name in counted}

    def make(mesh):
        return ServeEngine(cfg, eng0.params, max_len=CB_MAX_LEN,
                           quant=eng0._serve_quant, offload=OffloadEngine(),
                           eos_id=-1, device="cuda", mesh=mesh)

    def measure(eng):
        torch.cuda.synchronize()
        _take(counted, total)
        one_tok, sched_tok, res, sched = _tp_drive(eng, mels, max_news, f)
        got = _read(counted)
        _take(counted, total)
        kernels, _, wall = _profile_sharded_steps(sched)
        step_ms, source = _tp_step_ms(eng, f)
        logits = _forced_logits(eng, [1], mels[0])[0]
        _take(counted, total)
        return one_tok, sched_tok, logits, dict(
            launches=got, prefill_host_ms=res.prefill_s * 1e3,
            decode_host_ms_per_token=res.decode_s * 1e3 / TP_NEW,
            step_device_ms=step_ms, step_device_ms_source=source,
            slot_step_device_ms=sum(ms for _, ms in kernels.values()),
            slot_step_wall_ms_profiled=wall,
            step_captures=eng._step_captures, step_builds=eng._step_builds)

    one = make(None)
    want_one, want_sched, want_logits, base = measure(one)
    out = {"unsharded": base}
    print(f"tp {label} unsharded: {json.dumps(base)}", flush=True)
    scale = float(want_logits.abs().max())
    witness = _f32_witness(eng0, CB_MAX_LEN)
    streams = [want_one] + want_sched
    rows = {}

    def ref_rows(s):
        """The witness's logits along stream s's unsharded tokens."""
        if s not in rows:
            rows[s] = _forced_logits(witness, [1] + streams[s][:-1],
                                     ([mels[0]] + mels)[s])
        return rows[s]
    floor = tie_floor(_forced_logits(one, [1] + want_one[:-1], mels[0]),
                      ref_rows(0))
    _take(counted, total)
    out["floor"] = floor
    print(f"tp {label} floor (before any sharded run): "
          f"{json.dumps(floor)}", flush=True)
    for data, model in TP_MESHES:
        mesh = _tp_mesh(data, model)
        eng = make(mesh)
        one_tok, sched_tok, logits, row = measure(eng)
        err = float((logits - want_logits).abs().max()) / scale
        blocks = rules.tp_summary(cfg, rules.serve_param_specs(
            eng._serve_params, mesh), mesh)
        ties = [tie_check(lambda j, s=s: ref_rows(s)[j], w, g,
                          floor["bound"])
                for s, (w, g) in enumerate(zip(streams,
                                               [one_tok] + sched_tok))]
        _take(counted, total)
        row.update(data=data, model=model, logit_err=err,
                   logit_tol=tol, tokens_equal=one_tok == want_one,
                   sched_tokens_equal=sched_tok == want_sched,
                   differing=[t for t in ties if not t["equal"]],
                   tie_bound=floor["bound"],
                   blocks=blocks, kv_split=any(
                       v is not None for v in eng._kv_devices.values()))
        out[f"{data}x{model}"] = row
        print(f"tp {label} ({data}, {model}): {json.dumps(row)}",
              flush=True)
        if model == 4:
            print(f"tp {label} (1, 4) blocks (split, or why whole): "
                  f"{json.dumps(blocks)}", flush=True)
        if not all(t["equal"] for t in ties) and (
                label in TP_EXACT or not _ties_ok(ties)):
            how = "" if label in TP_EXACT else " past a near-tie"
            raise AssertionError(f"tp {label} ({data}, {model}): tokens "
                                 f"differ from the unsharded engine's{how}"
                                 f": {ties}")
        if not err <= tol:
            raise AssertionError(f"tp {label} ({data}, {model}): logits "
                                 f"{err} of the largest > {tol}")
        del eng
    del one, witness
    return total, out


def _replay_times(fn, n: int = TP_TIMED) -> dict:
    """Device ms of each of ``n`` calls of ``fn`` (a graph replay), one at
    a time: CUDA events around the call, the card synchronized between
    calls, after one untimed call. The median, the spread (min, max) and
    every time; "graph_events": the gaps between a graph's kernels
    count."""
    import statistics

    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return dict(median=statistics.median(times), min=min(times),
                max=max(times), n=n, ms=times, source="graph_events")


def _round_times(spec, b: int, f: int, n: int = TP_TIMED) -> dict:
    """``n`` rounds of the one-shot path at (b, f) replayed, each timed
    by CUDA events in two parts: the k + 1 draft-step replays (the
    column index reset first) and the window's replay (``_replay_times``'
    measure). The replays run past the state's lengths (clamped, as a
    free slot's); the next request re-prefills."""
    import statistics

    import torch
    rounds = spec._statics[(b, f)][0].rounds
    dprog, vprog = rounds.programs
    draft, window = [], []
    for i in range(n + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        rounds.col.zero_()
        for _ in range(spec.k + 1):
            dprog.graph.replay()
        ev[1].record()
        vprog.graph.replay()
        ev[2].record()
        torch.cuda.synchronize()
        if i:                                    # the first: untimed
            draft.append(ev[0].elapsed_time(ev[1]))
            window.append(ev[1].elapsed_time(ev[2]))

    def stats(ms):
        return dict(median=statistics.median(ms), min=min(ms), max=max(ms))
    return dict(draft_steps_ms=stats(draft), window_ms=stats(window),
                round_ms=stats([a + w for a, w in zip(draft, window)]),
                n=n, source="graph_events")


def tp_paged(label, eng0, counted):
    """Phase 18e, the paged pool over "model" on one path: phase 11's
    trace (``_pg_workload``) over its paged geometry (PG_SLOTS logical
    slots), whisper-tiny at full width with ``eng0``'s weights and
    quantization, a new engine (max_len PG_MAX_LEN, no EOS) unsharded and
    over each of TP_PAGED_MESHES (the card); on TP_TIGHT paths also the
    tight arena (SLOTS slots, 2 + 2 x pages_per self pages), which
    preempts and replays. The launch counts are zeroed before each drive
    and read after it. Before any sharded run, the floor (``tie_floor``)
    of the first request's stream against the f32 witness's. Gates: on
    each engine every request's tokens are the first max_new of the same
    engine's batch-1 ``transcribe`` of its utterance, exactly (the paged
    pool over "model" is the contiguous path over the same mesh), the
    tight arena's too; against the unsharded pool's they are equal or
    first part at a near-tie (``tie_check`` at the floor's bound: the
    split partial sums move the logits, on Q8_0 too, whose residual
    stream is bf16); commits = prefills + steps + replays; requests per
    committed byte the unsharded pool's; one paged step capture a data
    shard and the batch-1 step's (the replays') at the engine's first
    pool; a warm drive of the same trace gives the same tokens with no
    capture and no launch from Python. Printed: launches by kernel, the
    blocks split or whole and why (``rules.tp_summary``), the paged slot
    step's device ms by CUDA events (``_replay_times``: median and
    spread) beside the unsharded pool's, prefix hits, preemptions.
    Returns (launches, summary)."""
    import numpy as np
    import torch
    from repro_torch.core import energy
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import rules

    cfg = eng0.cfg
    f = cfg.encoder_ctx
    power_w = energy.card_power_limit_w(0)
    mels, distinct, which, max_news, arrivals = _pg_workload(cfg)
    pages_per = -(-(int(np.mean(max_news)) + 1) // PG_PAGE)
    cross = dict(cross_page_size=f, n_cross_pages=1 + PG_DISTINCT)
    pools = [("paged", PG_SLOTS, dict(page_size=PG_PAGE,
                                       n_pages=1 + PG_SLOTS * pages_per,
                                       **cross))]
    if label in TP_TIGHT:
        pools.append(("tight", SLOTS, dict(page_size=PG_PAGE,
                                           n_pages=2 + 2 * pages_per,
                                           **cross)))
    total = {name: 0 for name in counted}

    def make(mesh):
        return ServeEngine(cfg, eng0.params, max_len=PG_MAX_LEN,
                           quant=eng0._serve_quant, offload=OffloadEngine(),
                           eos_id=-1, device="cuda", mesh=mesh)

    def drive(eng, n_slots, geom):
        torch.cuda.synchronize()
        _take(counted, total)
        c0, b0 = eng._step_captures, eng._step_builds
        commits0 = eng.offload.ledger.commits
        sched = eng.paged_scheduler(n_slots, f, **geom)
        r = _pg_drive(sched, mels, max_news, arrivals, power_w)
        launches = _read(counted)
        _take(counted, total)
        row = dict(
            launches=launches, step_captures=eng._step_captures - c0,
            step_builds=eng._step_builds - b0,
            commits=eng.offload.ledger.commits - commits0,
            prefills=sched.prefills, replays=sched.replays,
            slot_steps=r["slot_steps"], shared_hits=sched.shared_hits,
            preemptions=sched.preemptions, programs=len(sched._programs),
            kv_committed_bytes=r["kv_committed_bytes"],
            active_peak=r["active_peak"],
            requests_per_byte=r["active_peak"] / r["kv_committed_bytes"],
            tok_s=r["tok_s"])
        sched.run()                       # claims the first drive's results
        c1 = eng._step_captures
        warm = _pg_drive(sched, mels, max_news, arrivals, power_w)
        row.update(warm_tokens_equal=warm["tokens"] == r["tokens"],
                   warm_launches=_read(counted),
                   warm_captures=eng._step_captures - c1,
                   warm_tok_s=warm["tok_s"])
        _take(counted, total)
        row["step_device_ms"] = _replay_times(
            lambda: sched._replay_all(sched._programs))
        _take(counted, total)
        return r["tokens"], row

    def transcribed(eng):
        """Each request's first max_new tokens of ``eng``'s batch-1
        transcribe of its utterance (the graphs the pool's replays use)."""
        full = [eng.transcribe(m, max_new=PG_MAX_LEN)[0].tokens
                for m in distinct]
        _take(counted, total)
        return [full[w][:n] for w, n in zip(which, max_news)]

    def check(line, pool, row, got, refs):
        row["tokens_equal_transcribe"] = sum(
            g == r for g, r in zip(got, refs))
        if row["tokens_equal_transcribe"] != PG_REQUESTS:
            raise AssertionError(f"{line}: {row['tokens_equal_transcribe']}"
                                 f" of {PG_REQUESTS} requests equal the "
                                 "engine's own batch-1 transcribe")
        if row["commits"] != (row["prefills"] + row["slot_steps"]
                              + row["replays"]):
            raise AssertionError(f"{line}: {row['commits']} commits")
        if (not row["warm_tokens_equal"] or row["warm_captures"]
                or any(row["warm_launches"].values())):
            raise AssertionError(f"{line}: the warm drive's tokens, "
                                 "captures or launches")
        if pool == "tight" and not (row["preemptions"] and row["replays"]):
            raise AssertionError(f"{line}: no preemption or replay")

    one = make(None)
    base, want = {}, None
    for pool, n_slots, geom in pools:
        got, base[pool] = drive(one, n_slots, geom)
        want = got if want is None else want
        check(f"tp paged {label} {pool} unsharded", pool, base[pool], got,
              transcribed(one))
    out = {"unsharded": base}
    print(f"tp paged {label} unsharded: {json.dumps(base)}", flush=True)
    witness = _f32_witness(eng0, PG_MAX_LEN)
    rows = {}

    def ref_rows(s):
        """The witness's logits along request s's unsharded stream."""
        if s not in rows:
            rows[s] = _forced_logits(witness, [1] + want[s][:-1], mels[s])
        return rows[s]
    floor = tie_floor(_forced_logits(one, [1] + want[0][:-1], mels[0]),
                      ref_rows(0))
    _take(counted, total)
    out["floor"] = floor
    print(f"tp paged {label} floor (before any sharded run): "
          f"{json.dumps(floor)}", flush=True)
    del one
    for data, model in TP_PAGED_MESHES:
        mesh = _tp_mesh(data, model)
        eng = make(mesh)
        res, refs = {}, None
        for i, (pool, n_slots, geom) in enumerate(pools):
            got, row = drive(eng, n_slots, geom)
            refs = transcribed(eng) if refs is None else refs
            ties = [tie_check(lambda j, s=s: ref_rows(s)[j], w, g,
                              floor["bound"])
                    for s, (w, g) in enumerate(zip(want, got))]
            _take(counted, total)
            first = i == 0
            row.update(
                tokens_equal=got == want,
                differing=[dict(t, request=s, utterance=which[s])
                           for s, t in enumerate(ties) if not t["equal"]],
                tie_bound=floor["bound"],
                requests_per_byte_equal=(row["requests_per_byte"]
                                         == base[pool]["requests_per_byte"]),
                unsharded_step_device_ms=base[pool]["step_device_ms"][
                    "median"])
            res[pool] = row
            line = f"tp paged {label} {pool} ({data}, {model})"
            print(f"{line}: {json.dumps(row)}", flush=True)
            check(line, pool, row, got, refs)
            if not _ties_ok(ties):
                raise AssertionError(f"{line}: tokens differ from the "
                                     f"unsharded pool's past a near-tie: "
                                     f"{row['differing']}")
            if not row["requests_per_byte_equal"]:
                raise AssertionError(f"{line}: requests per committed byte "
                                     f"{row['requests_per_byte']} != "
                                     f"{base[pool]['requests_per_byte']}")
            if (row["programs"] != data
                    or row["step_captures"] != data + first
                    or row["step_builds"] != 1 + first):
                raise AssertionError(f"{line}: {row['programs']} programs, "
                                     f"{row['step_captures']} captures, "
                                     f"{row['step_builds']} builds")
        blocks = rules.tp_summary(cfg, rules.serve_param_specs(
            eng._serve_params, mesh), mesh)
        res.update(blocks=blocks, kv_split=eng._kv_devices[eng._phys]
                   is not None)
        print(f"tp paged {label} ({data}, {model}) blocks (split, or why "
              f"whole): {json.dumps(blocks)}; KV split over 'model': "
              f"{res['kv_split']}", flush=True)
        out[f"{data}x{model}"] = res
        del eng
    del witness
    return total, out


def tp_spec(spec_params, counted, waves_ref):
    """Phase 18e, speculative serving over "model": phase 12's echo
    whisper-base verifier (Q8_0) and whisper-tiny draft sharing a
    TP_SPEC_MESH mesh of the card (base's 8 heads and tiny's 6 split two
    ways), new engines (max_len PS_MAX_LEN, no EOS), and unsharded: a
    one-shot ``transcribe`` of phase 12's echo b1 mel at k = PS_K (the
    capturing request, then a second one), then over the mesh phase 12c's
    trace through ``SpecScheduler``'s waves of PS_SLOTS, and a one-shot
    ``transcribe`` of the same mel by phase 12's raw verifier and draft
    over the mesh (distinct tokens: the echo models repeat SOT). Gates:
    the one-shot tokens and acceptance equal the unsharded engine's and
    the tokens the verifier's own ``transcribe`` over the mesh, the raw
    pair's too; the waves'
    tokens and acceptance equal 18c's unsharded waves' (``waves_ref``);
    the second request captures and launches nothing; the window and the
    draft step are built once a key and captured once a data shard; the
    ledger's FLOPs by role equal the plans times their runs; the round
    schedulers refuse the mesh. Printed: launches by kernel, the blocks
    of both models, and a round's device split (``_round_times``: draft
    steps and window, median and spread) beside the unsharded engine's.
    Returns (launches, summary)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.speculative import SpecScheduler
    from repro_torch.sharding import rules

    bp_echo, tp_echo, bp_raw, tp_raw = spec_params
    base = dataclasses.replace(get_config("whisper-base"), quant="q8_0")
    tiny = get_config("whisper-tiny")
    f, k = base.encoder_ctx, PS_K
    max_new = PS_MAX_LEN - k - 2             # max_new + k + 1 <= max_len
    mel1 = np.random.default_rng(34).standard_normal(
        (1, f, base.n_mels)).astype(np.float32)      # phase 12's echo b1
    mels, max_news, _ = _ps_workload(base)
    total = {name: 0 for name in counted}
    out = {}
    for mesh in (None, _tp_mesh(*TP_SPEC_MESH)):
        name = "unsharded" if mesh is None else "{}x{}".format(*TP_SPEC_MESH)
        v = ServeEngine(base, bp_echo, max_len=PS_MAX_LEN, quant="q8_0",
                        offload=OffloadEngine(), eos_id=-1, device="cuda",
                        mesh=mesh)
        spec = v.speculative(tiny, tp_echo, k=k)
        d = spec.draft
        torch.cuda.synchronize()
        _take(counted, total)
        stats0 = _stats(v.offload)
        got = spec.transcribe(mel1, max_new=max_new)
        launches = _read(counted)
        _take(counted, total)
        got2 = spec.transcribe(mel1, max_new=max_new)
        torch.cuda.synchronize()
        launches2 = _read(counted)
        _take(counted, total)
        rounds = spec._statics[(1, f)][0].rounds
        n_rounds = spec.rounds
        delta = {role: _ledger_delta(_stats(v.offload), stats0)[
            "by_role"].get(role, 0) for role in ("verify", "draft")}
        want_roles = {
            "verify": _role_flops(v, {v._key("prefill", 1, f): 2,
                                      rounds.v_key: n_rounds}),
            "draft": _role_flops(d, {d._key("prefill", 1, f): 2,
                                     rounds.d_key: n_rounds * (k + 1)})}
        row = dict(
            tokens=got[0].tokens, acceptance=spec.acceptance_rate(),
            rounds=n_rounds, launches=launches,
            launches_second_request=launches2,
            second_tokens_equal=got2[0].tokens == got[0].tokens,
            by_role=delta, by_role_want=want_roles,
            verify_captures=v._verify_captures,
            verify_builds=v._verify_builds,
            draft_captures=d._step_captures, draft_builds=d._step_builds,
            blocks={"verifier": rules.tp_summary(
                        base, rules.serve_param_specs(v._serve_params, mesh),
                        mesh),
                    "draft": rules.tp_summary(
                        tiny, rules.serve_param_specs(d._serve_params, mesh),
                        mesh)} if mesh is not None else None,
            round=_round_times(spec, 1, f))
        _take(counted, total)
        out[name] = row
        line = f"tp spec {name}"
        if (any(launches2.values()) or not row["second_tokens_equal"]
                or delta != want_roles or row["verify_builds"] != 1
                or row["verify_captures"] != 1 or row["draft_builds"] != 1
                or row["draft_captures"] != 1):
            raise AssertionError(f"{line}: {row}")
        if mesh is None:
            print(f"{line} one-shot: {json.dumps(row)}", flush=True)
            del spec, v, d
            continue
        one = out["unsharded"]
        plain = v.transcribe(mel1, max_new=max_new)[0].tokens
        row.update(tokens_equal_unsharded=row["tokens"] == one["tokens"],
                   tokens_equal_transcribe=row["tokens"] == plain,
                   acceptance_equal=row["acceptance"] == one["acceptance"])
        print(f"{line} one-shot: {json.dumps(row)}", flush=True)
        if not (row["tokens_equal_unsharded"]
                and row["tokens_equal_transcribe"]
                and row["acceptance_equal"]):
            raise AssertionError(f"{line}: one-shot tokens or acceptance "
                                 "differ")
        _take(counted, total)
        a0, d0, vc0, dc0 = (spec.accepted, spec.drafted,
                            v._verify_captures, d._step_captures)
        sched = SpecScheduler(spec, n_slots=PS_SLOTS)
        rids = [sched.submit(m, max_new=mn) for m, mn in zip(mels, max_news)]
        res = sched.run()
        torch.cuda.synchronize()
        refused = {}
        for mode in ("continuous", "paged"):
            try:
                spec.continuous(PS_SLOTS, f) if mode == "continuous" \
                    else spec.paged(PS_SLOTS, f, page_size=PS_PAGE)
                refused[mode] = False
            except NotImplementedError:
                refused[mode] = True
        waves = dict(
            tokens_equal_unsharded=[res[r].tokens for r in rids]
            == waves_ref["tokens"],
            acceptance=(spec.accepted - a0) / max(spec.drafted - d0, 1),
            unsharded_acceptance=waves_ref["acceptance"],
            launches=_read(counted),
            verify_captures=v._verify_captures - vc0,
            draft_captures=d._step_captures - dc0,
            verify_builds=v._verify_builds, draft_builds=d._step_builds,
            rounds_schedulers_refused=refused)
        _take(counted, total)
        out["waves"] = waves
        print(f"{line} waves: {json.dumps(waves)}", flush=True)
        if (not waves["tokens_equal_unsharded"]
                or waves["acceptance"] != waves["unsharded_acceptance"]
                or waves["verify_captures"] != TP_SPEC_MESH[0]
                or waves["draft_captures"] != TP_SPEC_MESH[0]
                or waves["verify_builds"] != 2 or waves["draft_builds"] != 2
                or not all(refused.values())):
            raise AssertionError(f"{line} waves: {waves}")
        del sched, spec, v, d
        # raw weights: the echo models' argmax is their input token, so
        # their streams repeat SOT; phase 12's raw verifier and draft
        # give a stream of distinct tokens, which the speculative rounds
        # over the mesh must reproduce exactly (the window's rows keep
        # their bits at any M, as the steps')
        v = ServeEngine(base, bp_raw, max_len=PS_MAX_LEN, quant="q8_0",
                        offload=OffloadEngine(), eos_id=-1, device="cuda",
                        mesh=mesh)
        spec = v.speculative(tiny, tp_raw, k=k)
        got = spec.transcribe(mel1, max_new=max_new)[0].tokens
        plain = v.transcribe(mel1, max_new=max_new)[0].tokens
        raw = dict(tokens=got, distinct_tokens=len(set(got)),
                   tokens_equal_transcribe=got == plain,
                   acceptance=spec.acceptance_rate(), rounds=spec.rounds,
                   launches=_read(counted))
        _take(counted, total)
        out["raw"] = raw
        print(f"{line} raw one-shot: {json.dumps(raw)}", flush=True)
        if not raw["tokens_equal_transcribe"]:
            raise AssertionError(f"{line} raw: the speculative tokens "
                                 f"{got} differ from the verifier's own "
                                 f"transcribe {plain} over the mesh")
        del spec, v
    return total, out


def sharded_phase(q8_eng, d_eng, counted, slot4, spec_params):
    """Phase 18: 18a (both paths at SHARD_DATAS), 18b, 18c, 18d and 18e.
    Returns (the phase's Python launches by kernel, its summary)."""
    from repro_torch.core import energy

    t0 = time.perf_counter()
    power_w = energy.card_power_limit_w(0)
    total = {name: 0 for name in counted}
    summary = {}
    for label, eng0, programs, replay, n_req in (
            ("q8_0", q8_eng, ({"q8_matmul": 32}, {"q8_matvec": 33}),
             {"step": {"q8_matvec_kernel": 33}}, CB_REQUESTS),
            ("dense+flash", d_eng,
             ({"bf16_matmul": 32, "flash_attention_fwd": 4},
              {"bf16_matmul": 33}),
             {"step": {"gemv_bf16_kernel": 33}}, CB_DENSE_REQUESTS)):
        got, summary[label] = sharded_path(label, eng0, counted, programs,
                                           replay, n_req, slot4[label])
        for name, c in got.items():
            total[name] += c
    waves = {}

    def spec_waves():
        got, out, waves["ref"] = sharded_spec(spec_params, counted)
        return got, out
    for key, fn in (("paged", lambda: sharded_paged(q8_eng, counted,
                                                    power_w)),
                    ("speculative", spec_waves),
                    ("tp q8_0", lambda: tp_path("q8_0", q8_eng, counted,
                                                CB_REQUESTS)),
                    ("tp dense+flash", lambda: tp_path(
                        "dense+flash", d_eng, counted, CB_DENSE_REQUESTS))):
        got, summary[key] = fn()
        for name, c in got.items():
            total[name] += c
    t18e = time.perf_counter()
    for key, fn in (("tp paged q8_0", lambda: tp_paged("q8_0", q8_eng,
                                                       counted)),
                    ("tp paged dense+flash", lambda: tp_paged(
                        "dense+flash", d_eng, counted)),
                    ("tp spec", lambda: tp_spec(spec_params, counted,
                                                waves["ref"]))):
        got, summary[key] = fn()
        for name, c in got.items():
            total[name] += c
    summary["phase_18e_s"] = time.perf_counter() - t18e
    print(f"sharded phase 18e: {summary['phase_18e_s']:.1f} s", flush=True)
    wall = time.perf_counter() - t0
    summary["phase_s"] = wall
    print(f"sharded phase: {wall:.1f} s; launches {total}", flush=True)
    return total, summary


# ---------------------------------------------------------------------------
# Phase 14: the dense LM family (qwen2.5-14b at full width)
# ---------------------------------------------------------------------------
def _take(counted, total):
    """Add the launch counts since the last zeroing to ``total`` and zero
    them: the phase's Python launches, summed over its checks."""
    for name, n in _read(counted).items():
        total[name] = total.get(name, 0) + n
    _zero(counted)


def _lm_params(quant_note: str):
    """qwen2.5-14b's weights drawn on the card from LM_SEED, tensor by
    tensor (no weight passes through host memory): (cfg, params)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(LM_SEED), cfg,
        device="cuda")
    torch.cuda.synchronize()
    print(f"lm init {quant_note}: {cfg.name} drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"({cfg.n_params() / 1e9:.3f} G parameters)", flush=True)
    return cfg, params


def _lm_eager(eng, prompts, max_new: int):
    """The eager greedy loop through the engine's public ``prefill`` and
    ``step`` (every kernel launched from Python; one host read a step,
    ``step``'s cache check): (tokens per row, prefill s, decode s)."""
    import torch
    x = torch.from_numpy(prompts).long().cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = eng.prefill(x)
    tok = eng._argmax(logits[:, -1])[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    toks = []
    t0 = time.perf_counter()
    for _ in range(max_new):
        logits, state = eng.step(tok, state)
        tok = eng._argmax(logits[:, -1])[:, None]
        toks.append(tok)
    rows = torch.cat(toks, dim=1).cpu().tolist()
    return rows, prefill_s, time.perf_counter() - t0


def _lm_cpu_check(eng, tol: float = LM_CPU_TOL, prefix: str = "lm"):
    """The first logits of a short prompt on the card and on the CPU with
    the same weights (Q8_0, or bf16 for a MoE model) cut to depth
    LM_CPU_LAYERS (the seed's embedding, first layers, final norm and
    head), through the offload engine on both: within ``tol`` of the CPU's
    largest logit. The logits are bf16 (the model's type), a step of 2^-8
    relative; random weights keep the largest logit of O(1)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(eng.cfg, num_layers=LM_CPU_LAYERS)
    sp = eng._serve_params
    sub = {"embed": sp["embed"],
           "stack": {"blocks": sp["stack"]["blocks"][:LM_CPU_LAYERS]},
           "final_norm": sp["final_norm"], "lm_head": sp["lm_head"]}
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, LM_CPU_PROMPT)).astype(np.int32)
    quant = eng._serve_quant
    card = ServeEngine(cfg, sub, max_len=8, quant=quant,
                       offload=OffloadEngine(), eos_id=None, device="cuda")
    card_logits, _ = card.prefill(torch.from_numpy(prompt).long().cuda())
    t0 = time.perf_counter()
    cpu = ServeEngine(cfg, model.to_device(sub, torch.device("cpu")),
                      max_len=8, quant=quant, offload=OffloadEngine(),
                      eos_id=None, device="cpu")
    cpu_logits, _ = cpu.prefill(torch.from_numpy(prompt).long())
    cpu_s = time.perf_counter() - t0
    got, want = card_logits.float().cpu(), cpu_logits.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{prefix}: non-finite logits on the card")
    err = (got - want).abs().max().item()
    big = want.abs().max().item()
    agree = int(got[0, -1, :cfg.vocab_size].argmax()) == int(
        want[0, -1, :cfg.vocab_size].argmax())
    print(f"{prefix} first logits card vs cpu ({LM_CPU_LAYERS} layers, full "
          f"width, {LM_CPU_PROMPT}-token prompt): max_abs_err={err:.3e}, "
          f"|logits|max={big:.3f}, tolerance {tol} x |logits|max, "
          f"argmax agrees: {agree}; cpu {cpu_s:.1f}s", flush=True)
    if not err <= tol * big:
        raise AssertionError(f"{prefix}: card and CPU logits differ by {err}")
    return dict(cpu_max_abs_err=err, cpu_logits_absmax=big,
                cpu_argmax_agrees=agree)


def _lm_profile_steps(step_graph, done, want_name: str,
                      per_step: int = LM_PER_STEP, prefix: str = "lm"):
    """LM_PROFILED_STEPS replays of a step graph under torch.profiler,
    each with the one host sync its caller makes and a spin kernel after
    it: the kernels by name of one replay the profiler saw whole (its
    ``want_name`` launches ``per_step``, the graph's fixed count; see
    LM_PROFILE_WINDOWS), that replay's top kernels, and the window's host
    wall ms a step. A window in which no replay was seen whole is
    profiled again, LM_PROFILE_WINDOWS times at most; then the last
    replay seen is returned, and its count fails the caller's check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = LM_PROFILED_STEPS
    for attempt in range(LM_PROFILE_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _open_window()
            t0 = time.perf_counter()
            for _ in range(steps):
                step_graph.replay()
                done()
                _open_window()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        recs = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and e.device_time_total > 0),
                      key=lambda e: e.time_range.start)
        replays, cur = [], None
        for e in recs:                       # a spin kernel opens a replay
            if SPIN_KERNEL in e.name:
                if cur:
                    replays.append(cur)
                cur = {}
            elif cur is not None:
                n, ms = cur.get(e.name, (0, 0.0))
                cur[e.name] = (n + 1, ms + e.device_time_total / 1e3)
        counts = [by_route(k, (want_name,))[want_name][0] for k in replays]
        kernels = next((k for k, n in zip(replays, counts)
                        if n == per_step), replays[-1] if replays else {})
        if per_step in counts or not recs:
            break
        print(f"{prefix}: {want_name} a replay {counts} in profiled window "
              f"{attempt + 1}, none whole; profiling again", flush=True)
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
    return kernels, [(name[:80], n, ms) for name, (n, ms) in top], wall


def _lm_host_ms(step_graph, done, reps: int = 4 * PROFILED_STEPS) -> float:
    """Host ms a step of ``reps`` unprofiled replays, each with its
    caller's host sync: the time the idle share is taken against."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step_graph.replay()
        done()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _replay_summary(label, kernels, top, wall, host_ms, want_name,
                    per_step: int = LM_PER_STEP, prefix: str = "lm"):
    """Device ms a step, idle shares (profiled, and against the unprofiled
    host time), the dot-product share and ``want_name``'s launches a
    replay, which must be ``per_step`` where the profiler saw the
    replay."""
    if not kernels:
        print(f"{prefix} {label}: the profiler saw no kernels inside the "
              "replays", flush=True)
        return dict(step_device_ms="not measured: profiler saw no replay")
    dev = sum(ms for _, ms in kernels.values())
    n = by_route(kernels, (want_name,))[want_name][0]
    if n != per_step:
        raise AssertionError(f"{prefix} {label}: {n} {want_name} a replayed "
                             f"step, expected {per_step}")
    return dict(step_device_ms=dev, step_wall_ms_profiled=wall,
                step_idle_share=1 - dev / wall,
                step_idle_share_unprofiled=1 - dev / host_ms,
                replay_kernel_launches={want_name: n},
                kernels_a_replay=round(sum(c for c, _ in kernels.values())),
                step_dot_share=dot_share(kernels), top_kernels=top)


def lm_oneshot(label, eng, counted, total, want_name, batch4: bool,
               per_step: int = LM_PER_STEP, new: int = LM_NEW,
               prefix: str = "lm", eager: Optional[int] = None):
    """14a/14b (and 15a/15c): ``generate`` of one LM_PROMPT-token prompt
    and ``new`` new tokens at full width: the eager loop's launches
    (``per_step`` a step, prefill steps included) and tokens; the captured
    request's tokens equal them, its launches from Python only at the
    capture (two passes of one step), then none for LM_REQUESTS more
    requests, whose ledger is that many eager requests'; the profiled
    replay's kernels, device ms a step and idle shares; PDP of one request
    at the power limit. With ``batch4``, batch LM_BATCH of prompts of
    LM_B4_LENS tokens, left-padded with token 0, captured against eager.
    Returns the summary and the profiled replay's kernels by name.

    With ``eager`` (LM_EAGER), the eager loops and the captured requests
    held against them run the last ``eager`` tokens of each prompt and
    ``eager`` new tokens; the timed requests keep LM_PROMPT + ``new``,
    their ledger that many eager steps', their tokens equal each other's."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.core import energy

    cfg = eng.cfg
    name = "q8_matvec" if want_name == "q8_matvec_kernel" else "bf16_matmul"
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, LM_PROMPT)).astype(np.int32)
    e_prompt, e_new = ((prompt, new) if eager is None
                       else (prompt[:, -eager:], eager))
    e_runs, runs = e_prompt.shape[1] + e_new, LM_PROMPT + new
    if runs % e_runs:
        raise AssertionError(f"{prefix} {label}: {runs} steps are no "
                             f"multiple of the eager loop's {e_runs}")
    _take(counted, total)
    before = _stats(eng.offload)
    rows, e_pre, e_dec = _lm_eager(eng, e_prompt, e_new)
    one = _ledger_delta(_stats(eng.offload), before)
    got = _read(counted)
    want = {k: (per_step * e_runs if k == name else 0) for k in counted}
    print(f"{prefix} {label} eager ({e_prompt.shape[1]} + {e_new} tokens): "
          f"prefill_ms={e_pre * 1e3:.3f} "
          f"decode_ms_per_token={e_dec * 1e3 / e_new:.3f} launches={got}",
          flush=True)
    if got != want:
        raise AssertionError(f"{prefix} {label}: eager launches {got} != "
                             f"{want}")
    _take(counted, total)
    captures = eng._step_captures
    res = eng.generate(e_prompt, max_new=e_new)
    torch.cuda.synchronize()
    got = _read(counted)
    want = {k: (CAPTURE_PASSES * per_step if k == name else 0)
            for k in counted}
    print(f"{prefix} {label} captured: launches from Python at capture {got} "
          f"(expected {want}); step captures "
          f"{eng._step_captures - captures}", flush=True)
    if got != want or eng._step_captures != captures + 1:
        raise AssertionError(f"{prefix} {label}: capture launches {got}")
    if res[0].tokens != rows[0]:
        raise AssertionError(f"{prefix} {label}: captured tokens "
                             f"{res[0].tokens} != eager {rows[0]}")
    if not all(0 <= t < cfg.vocab_size for t in rows[0]):
        raise AssertionError(f"{prefix} {label}: token outside the vocabulary")
    _take(counted, total)
    before = _stats(eng.offload)
    results = [eng.generate(prompt, max_new=new)[0]
               for _ in range(LM_REQUESTS)]
    delta = _ledger_delta(_stats(eng.offload), before)
    got = _read(counted)
    times = LM_REQUESTS * (runs // e_runs)
    scaled = {key: ({k: v * times for k, v in val.items()}
                    if isinstance(val, dict) else val * times)
              for key, val in one.items()}
    if any(got.values()) or eng._step_captures != captures + 1:
        raise AssertionError(f"{prefix} {label}: replays launched {got} or "
                             "captured again")
    if delta != scaled:
        raise AssertionError(f"{prefix} {label}: ledger {delta} != "
                             f"{LM_REQUESTS} x eager {one}")
    first = rows[0] if eager is None else results[0].tokens
    if any(r.tokens != first for r in results) or len(first) != new:
        raise AssertionError(f"{prefix} {label}: a replayed request's tokens "
                             "differ")
    prefill_ms = statistics.median(r.prefill_s for r in results) * 1e3
    decode_ms = statistics.median(r.decode_s for r in results) * 1e3 / new
    st = eng._lm_static[1]
    kernels, top, wall = _lm_profile_steps(
        eng._graphs[eng._key("step", 1)].graph,
        lambda: bool(st.done.all()), want_name, per_step, prefix)
    limit = energy.card_power_limit_w(0)
    total_s = statistics.median(r.total_s for r in results)
    out = dict(path=label, prompt=LM_PROMPT, new=new,
               eager_prompt=e_prompt.shape[1], eager_new=e_new,
               eager_prefill_ms=e_pre * 1e3,
               eager_decode_ms_per_token=e_dec * 1e3 / e_new,
               prefill_ms=prefill_ms,
               prefill_ms_per_token=prefill_ms / LM_PROMPT,
               decode_ms_per_token=decode_ms, request_s=total_s,
               power_limit_w=limit,
               pdp_at_limit_j=energy.pdp(total_s, limit),
               **_replay_summary(label, kernels, top, wall, decode_ms,
                                 want_name, per_step, prefix))
    _take(counted, total)
    if batch4:
        rng = np.random.default_rng(2)
        lens = rng.integers(LM_B4_LENS[0], LM_B4_LENS[1] + 1, LM_BATCH)
        width = int(lens.max())
        prompts = np.zeros((LM_BATCH, width), np.int32)
        for i, n in enumerate(lens):
            prompts[i, width - n:] = rng.integers(0, cfg.vocab_size, n)
        prompts_e = prompts if eager is None else prompts[:, -eager:]
        rows4, _, _ = _lm_eager(eng, prompts_e, e_new)
        _take(counted, total)
        res4 = eng.generate(prompts_e, max_new=e_new)
        got = _read(counted)
        if got[name] != CAPTURE_PASSES * per_step:
            raise AssertionError(f"{prefix} {label} batch {LM_BATCH}: capture "
                                 f"launches {got}")
        if [r.tokens for r in res4] != rows4:
            raise AssertionError(f"{prefix} {label} batch {LM_BATCH}: "
                                 "captured tokens differ from eager")
        if eager is not None:            # the timed batch: replays only
            _take(counted, total)
            res4 = eng.generate(prompts, max_new=new)
            if any(_read(counted).values()):
                raise AssertionError(f"{prefix} {label} batch {LM_BATCH}: "
                                     "the timed batch launched")
        out.update(batch4_prompt_lens=lens.tolist(),
                   batch4_prefill_ms=res4[0].prefill_s * LM_BATCH * 1e3,
                   batch4_decode_ms_per_step=(res4[0].decode_s * LM_BATCH
                                              * 1e3 / new))
        _take(counted, total)
    print(f"{prefix} {label} summary: {json.dumps(out)}", flush=True)
    return out, kernels


def lm_scheduler(eng, counted, total, name: str = "q8_matvec",
                 want_name: str = "q8_matvec_kernel",
                 per_step: int = LM_PER_STEP, prefix: str = "lm",
                 prompt_lens=LM_SCHED_PROMPTS, budget_lens=LM_SCHED_BUDGETS,
                 keep_trace: bool = False):
    """14c (and 15b, 16b): LM_SCHED_REQUESTS prompts of ``prompt_lens``
    tokens and budgets of ``budget_lens`` from default_rng(0) over
    LM_SLOTS slots, max_len LM_MAX_LEN: every request's tokens equal its
    batch-1
    ``generate``'s; one slot-step capture for the pool (two Python passes
    of its ``per_step`` launches of ``name``), the admissions replaying
    the batch-1 step graph; one commit an admission and a step, and
    lm_head run once a prompt token and a step; a warm drive of the same
    requests for tokens a second; the slot step's replay profiled; KV
    bytes. With ``keep_trace``, the summary returned (not printed) keeps
    the trace and its streams under "trace" for 14e."""
    import numpy as np
    import torch
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg = eng.cfg
    rng = np.random.default_rng(0)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1,
                        LM_SCHED_REQUESTS)
    budgets = rng.integers(budget_lens[0], budget_lens[1] + 1,
                           LM_SCHED_REQUESTS).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    refs = [eng.generate(p[None], max_new=n)[0].tokens
            for p, n in zip(prompts, budgets)]
    _take(counted, total)
    captures = eng._step_captures
    commits = eng.offload.ledger.commits
    before = _stats(eng.offload)
    sched = ContinuousBatchingScheduler(eng, n_slots=LM_SLOTS)
    rids = [sched.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    steps = 0
    while sched.n_queued or sched.n_active:
        sched.admit()
        steps += bool(sched.decode_step())
    res = sched.run()
    torch.cuda.synchronize()
    got = _read(counted)
    delta = _ledger_delta(_stats(eng.offload), before)
    runs = int(lens.sum()) + steps
    print(f"{prefix} scheduler: {LM_SCHED_REQUESTS} requests over {LM_SLOTS} "
          f"slots in {steps} slot steps; launches from Python {got}; step "
          f"captures {eng._step_captures - captures}; commits "
          f"{eng.offload.ledger.commits - commits}; lm_head runs "
          f"{delta['by_kernel'].get('lm_head')} (prompt tokens + steps = "
          f"{runs})", flush=True)
    if [res[r].tokens for r in rids] != refs:
        raise AssertionError(f"{prefix} scheduler: tokens differ from "
                             "batch-1 generate")
    if eng._step_captures != captures + 1 or \
            got[name] != CAPTURE_PASSES * per_step:
        raise AssertionError(f"{prefix} scheduler: captures or launches "
                             f"{got}")
    if eng.offload.ledger.commits - commits != LM_SCHED_REQUESTS + steps \
            or delta["by_kernel"].get("lm_head") != runs:
        raise AssertionError(f"{prefix} scheduler: commits or runs {delta}")
    _take(counted, total)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [sched.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    res = sched.run()
    wall = time.perf_counter() - t0
    if [res[r].tokens for r in rids] != refs or any(_read(counted).values()):
        raise AssertionError(f"{prefix} scheduler: the warm drive's tokens "
                             "or launches")
    sync = (lambda: sched._token[:, 0].tolist())
    host_ms = _lm_host_ms(sched._program.graph, sync)
    kernels, top, pwall = _lm_profile_steps(sched._program.graph, sync,
                                            want_name, per_step, prefix)
    out = dict(requests=LM_SCHED_REQUESTS, slots=LM_SLOTS,
               prompt_lens=lens.tolist(), budgets=budgets, slot_steps=steps,
               warm_drain_s=wall, tokens=sum(budgets),
               tokens_per_s=sum(budgets) / wall,
               kv_committed_bytes=sched.kv_committed_bytes,
               kv_used_peak_bytes=sched.kv_used_peak,
               kv_utilization_peak=sched.kv_utilization_peak,
               slot_step_host_ms=host_ms,
               **{f"slot_{k}": v for k, v in _replay_summary(
                   "slot step", kernels, top, pwall, host_ms,
                   want_name, per_step, prefix).items()})
    print(f"{prefix} scheduler summary: {json.dumps(out)}", flush=True)
    if keep_trace:
        out["trace"] = (prompts, budgets, [res[r].tokens for r in rids])
    return out


def lm_sharded(eng, counted, total, sharded, sched_out):
    """14e: 14c's trace (``sched_out["trace"]``, popped) over LM_SLOTS
    slots of a new Q8_0 engine on a mesh of LM_SHARD_DATA entries of the
    card, built from ``eng``'s serving weights: no second draw, no copy.
    Gates: every leaf of its weights is ``eng``'s tensor; the tokens equal
    14c's streams; one build of the slot step, LM_SHARD_DATA captures (and
    the admissions' batch-1 step). Printed: a warm drive's tokens a
    second beside 14c's. The drive's Python launches go to ``sharded``.
    Returns the summary."""
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.core.tree import leaves as tree_leaves

    prompts, budgets, streams = sched_out.pop("trace")
    n = LM_SHARD_DATA
    _take(counted, total)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    sh = ServeEngine(eng.cfg, eng._serve_params, max_len=LM_MAX_LEN,
                     quant="q8_0", offload=OffloadEngine(), eos_id=None,
                     device="cuda", mesh=_shard_mesh(n))
    pairs = list(zip(tree_leaves(sh._serve_params),
                     tree_leaves(eng._serve_params)))
    shared = bool(pairs) and all(a.data_ptr() == b.data_ptr()
                                 for a, b in pairs)
    grown = torch.cuda.memory_allocated() - mem0
    sched = sh.scheduler(n_slots=LM_SLOTS)
    rids = [sched.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    steps = 0
    while sched.n_queued or sched.n_active:
        sched.admit()
        steps += bool(sched.decode_step())
    res = sched.run()
    torch.cuda.synchronize()
    toks = [res[r].tokens for r in rids]
    _take(counted, sharded)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids2 = [sched.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    again = sched.run()
    wall = time.perf_counter() - t0
    warm_ok = [again[r].tokens for r in rids2] == streams
    warm_launches = _read(counted)
    out = dict(data=n, requests=len(prompts), slots=LM_SLOTS,
               shard_size=sched.pool.shard_size, slot_steps=steps,
               weights_shared=shared, leaves=len(pairs),
               allocated_growth_bytes=grown,
               tokens_equal_14c=toks == streams, warm_tokens_equal=warm_ok,
               step_captures=sh._step_captures, step_builds=sh._step_builds,
               by_device=dict(sh.offload.stats.by_device),
               warm_drain_s=wall, tokens_per_s=sum(budgets) / wall,
               unsharded_tokens_per_s=sched_out.get("tokens_per_s"))
    print(f"lm sharded (14e) summary: {json.dumps(out)}", flush=True)
    if not shared:
        raise AssertionError("lm sharded: the mesh engine's weights are not "
                             "14's tensors")
    if toks != streams or not warm_ok:
        raise AssertionError("lm sharded: tokens differ from 14c's streams")
    if (sh._step_captures != n + 1 or sh._step_builds != 2
            or any(warm_launches.values())):
        raise AssertionError(f"lm sharded: captures {sh._step_captures}, "
                             f"builds {sh._step_builds}, warm launches "
                             f"{warm_launches}")
    del sched, sh
    return out


def _top_of_one(fn, top: int = 8):
    """The top kernels of one profiled call of ``fn`` (a graph replay):
    [(name, launches, device ms)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        fn()
        torch.cuda.synchronize()
    return _top_kernels(prof, 1, top)


def _lm_first(eng, p) -> int:
    """The token an LM engine's batch-1 step program picks at the last
    position of prompt ``p`` (1-D): the first input of ``generate``'s
    greedy loop and of a slot's decode (both return the tokens after
    it), read from the program's token buffer."""
    eng.generate(p[None], max_new=1)
    return int(eng._lm_static_for(1).tokens[0, len(p) - 1])


def lm_tp(eng, counted, sharded):
    """14e over "model": a new Q8_0 engine on a LM_TP_MESH mesh of the
    card built from ``eng``'s serving weights (every split leaf's parts
    views of them: no copy), its attention, FFNs and vocabulary split
    four ways. The drive: a batch-1 ``generate`` (LM_TP_PROMPT +
    LM_TP_NEW tokens) and LM_SLOTS requests through a LM_SLOTS-slot pool
    (LM_TP_SCHED_PROMPT + LM_TP_SCHED_NEW). Gates, each set before the
    sharded bf16 run:
    - the witness: the same Q8_0 weights served with f32 activations
      (``cfg`` at dtype float32), unsharded and over the mesh: the
      drive's tokens equal, exactly;
    - the bf16 floor (``tie_floor``): ``eng``'s logits along its
      generate's tokens against the unsharded witness's;
    - bf16 over the mesh: the drive's tokens, each stream from its first
      input (``_lm_first``), equal ``eng``'s, each or up to a near-tie
      (``tie_check`` over the witness's logits at the floor's bound);
      the next token's logits after LM_TP_CHECK prompt
      tokens (both engines stepped eagerly, ``_forced_logits``) within
      LM_TP_TOL of ``eng``'s largest.
    Printed beside ``eng``'s: the generate's host prefill ms and decode
    ms a token, the batch-1 step graph's and the LM_SLOTS-slot step's
    ms a replay by CUDA events over LM_TP_REPLAYS back-to-back replays
    (the card's time and its gaps: the profiler takes minutes over the
    split step's 5,000 kernels), the split slot step's top kernels from
    one profiled replay, the bf16 drive's launches by kernel, the
    stages' seconds. On one card this measures the machinery, not
    scaling. Its Python launches go to ``sharded``; returns the
    summary."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import rules

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, eng.cfg.vocab_size,
                          (1, LM_TP_PROMPT)).astype(np.int32)
    n = LM_SLOTS
    prompts = [rng.integers(0, eng.cfg.vocab_size,
                            LM_TP_SCHED_PROMPT).astype(np.int32)
               for _ in range(n)]
    stages = {}

    def mark(name):
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0 - sum(stages.values())

    def make(cfg, mesh=None):
        return ServeEngine(cfg, eng._serve_params, max_len=LM_MAX_LEN,
                           quant="q8_0", offload=OffloadEngine(),
                           eos_id=None, device="cuda", mesh=mesh)

    def drive(e):
        res = e.generate(prompt, max_new=LM_TP_NEW)[0]
        sched = e.scheduler(n_slots=n)
        rids = [sched.submit(p, max_new=LM_TP_SCHED_NEW) for p in prompts]
        got = sched.run()
        return res, [got[r].tokens for r in rids], sched

    _take(counted, sharded)
    want, streams, base = drive(eng)
    base_step = wall_ms(eng._graphs[eng._key("step", 1)].graph.replay,
                        LM_TP_REPLAYS)
    base_slot = wall_ms(lambda: base._replay_all(base._programs),
                        LM_TP_REPLAYS)
    _take(counted, sharded)
    mark("unsharded")
    ps = [prompt[0]] + prompts
    # each stream from its first input on (``_lm_first``)
    wants = [[_lm_first(eng, p)] + w
             for p, w in zip(ps, [want.tokens] + streams)]
    _take(counted, sharded)
    witness = make(dataclasses.replace(eng.cfg, dtype="float32"))
    rows = {}

    def forced(e, s):
        """``e``'s logits that pick stream s's unsharded tokens."""
        p = ps[s]
        return _forced_logits(e, np.concatenate(
            [p, np.asarray(wants[s][:-1], dtype=p.dtype)]))[len(p) - 1:]

    def ref_rows(s):
        if s not in rows:
            rows[s] = forced(witness, s)
        return rows[s]
    floor = tie_floor(forced(eng, 0), ref_rows(0))
    print(f"lm tp (14e) floor (before any sharded run): "
          f"{json.dumps(floor)}", flush=True)
    mark("floor")
    mesh = _tp_mesh(*LM_TP_MESH)
    w_want, w_streams, _ = drive(witness)
    w_tp = make(witness.cfg, mesh)
    w_got, w_toks, _ = drive(w_tp)
    checked = dict(tokens_equal=w_got.tokens == w_want.tokens,
                   sched_tokens_equal=w_toks == w_streams,
                   tokens=[w_want.tokens] + w_streams)
    del w_tp
    _take(counted, sharded)
    mark("witness")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    tp = make(eng.cfg, mesh)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    mark("engine")
    got = tp.generate(prompt, max_new=LM_TP_NEW)[0]
    mark("generate")
    sched = tp.scheduler(n_slots=n)
    rids = [sched.submit(p, max_new=LM_TP_SCHED_NEW) for p in prompts]
    res = sched.run()
    mark("scheduler")
    toks = [res[r].tokens for r in rids]
    launches = _read(counted)
    gots = [[_lm_first(tp, p)] + g
            for p, g in zip(ps, [got.tokens] + toks)]
    _take(counted, sharded)
    ties = [tie_check(lambda j, s=s: ref_rows(s)[j], w, g, floor["bound"])
            for s, (w, g) in enumerate(zip(wants, gots))]
    mark("ties")
    check = prompt[0, :LM_TP_CHECK]
    first = _forced_logits(eng, check)[-1]
    err = float((_forced_logits(tp, check)[-1] - first).abs().max()) \
        / float(first.abs().max())
    _take(counted, sharded)
    mark("logits")
    top = _top_of_one(lambda: sched._replay_all(sched._programs))
    _take(counted, sharded)
    step = wall_ms(tp._graphs[tp._key("step", 1)].graph.replay,
                   LM_TP_REPLAYS)
    slot = wall_ms(lambda: sched._replay_all(sched._programs),
                   LM_TP_REPLAYS)
    _take(counted, sharded)
    mark("profiles")
    out = dict(mesh=list(LM_TP_MESH), weights_growth_bytes=grown,
               witness_f32=checked, floor=floor,
               tokens_equal=gots[0] == wants[0],
               sched_tokens_equal=gots[1:] == wants[1:],
               differing=[t for t in ties if not t["equal"]],
               first_logit_err=err, tol=LM_TP_TOL,
               slot_step_top_kernels=top,
               launches=launches,
               blocks=rules.tp_summary(eng.cfg, rules.serve_param_specs(
                   eng._serve_params, mesh), mesh),
               prefill_host_ms=got.prefill_s * 1e3,
               decode_host_ms_per_token=got.decode_s * 1e3 / LM_TP_NEW,
               step_event_ms=step, slot_step_event_ms=slot,
               unsharded_prefill_host_ms=want.prefill_s * 1e3,
               unsharded_decode_host_ms_per_token=(want.decode_s * 1e3
                                                   / LM_TP_NEW),
               unsharded_step_event_ms=base_step,
               unsharded_slot_step_event_ms=base_slot,
               step_captures=tp._step_captures,
               seconds=time.perf_counter() - t0, stage_s=stages)
    print(f"lm tp (14e, {LM_TP_MESH}) summary: {json.dumps(out)}",
          flush=True)
    if not (checked["tokens_equal"] and checked["sched_tokens_equal"]):
        raise AssertionError(f"lm tp: the f32 witness's tokens over the "
                             f"mesh differ from its unsharded run's: "
                             f"{checked}")
    if not _ties_ok(ties) or not err <= LM_TP_TOL:
        raise AssertionError(f"lm tp: first logits {err} of the largest, "
                             f"tokens {ties}")
    del sched, tp, base, witness
    return out


def lm_kv_quant(eng, counted, total):
    """14d: the Q8_0 weights with the int8 KV cache (kv_quant="q8"): one
    captured batch-1 ``generate`` whose tokens equal its eager loop's."""
    import dataclasses

    import numpy as np
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(eng.cfg, kv_quant="q8")
    q = ServeEngine(cfg, eng._serve_params, max_len=LM_MAX_LEN,
                    offload=OffloadEngine(), eos_id=None, device="cuda")
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, LM_PROMPT)).astype(np.int32)
    rows, _, _ = _lm_eager(q, prompt, LM_KVQ_NEW)
    _take(counted, total)
    res = q.generate(prompt, max_new=LM_KVQ_NEW)
    got = _read(counted)
    out = dict(kv_quant="q8", tokens_equal=res[0].tokens == rows[0],
               capture_launches=got,
               prefill_ms=res[0].prefill_s * 1e3,
               decode_ms_per_token=res[0].decode_s * 1e3 / LM_KVQ_NEW,
               kv_bytes_batch1=sum(
                   t.numel() * t.element_size() for c in
                   q._lm_static[1].state.layer_states for t in c))
    print(f"lm kv_quant q8: {json.dumps(out)}", flush=True)
    if not out["tokens_equal"] or got["q8_matvec"] != \
            CAPTURE_PASSES * LM_PER_STEP:
        raise AssertionError(f"lm kv_quant: tokens {res[0].tokens} vs "
                             f"eager {rows[0]}, launches {got}")
    _take(counted, total)
    return out


def lm_phase(counted):
    """Phase 14: qwen2.5-14b at full width. The Q8_0 engine first (14a,
    14c, 14d), its bf16 draw freed once quantized; then, the Q8_0 engine
    freed, the same seed's bf16 weights for 14b. Returns the phase's
    Python launches by kernel and its summary."""
    import gc

    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    total = {}
    _zero(counted)
    cfg, params = _lm_params("q8_0")
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN,
                      offload=OffloadEngine(), eos_id=None, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    eng.params = params = None          # the bf16 draw: freed, quantized
    gc.collect()
    torch.cuda.empty_cache()
    q8_bytes = torch.cuda.memory_allocated()
    print(f"lm q8_0 engine: peak {peak / 1e9:.2f} GB while quantizing, "
          f"{q8_bytes / 1e9:.2f} GB after the bf16 draw is freed",
          flush=True)
    summary = {"q8_0_peak_bytes": peak, "q8_0_resident_bytes": q8_bytes}
    summary["cpu"] = _lm_cpu_check(eng)
    _take(counted, total)
    summary["q8_0"], _ = lm_oneshot("q8_0", eng, counted, total,
                                    "q8_matvec_kernel", batch4=True,
                                    eager=LM_EAGER)
    summary["scheduler"] = lm_scheduler(eng, counted, total,
                                        keep_trace=True)
    sharded = {name: 0 for name in counted}
    summary["sharded"] = lm_sharded(eng, counted, total, sharded,
                                    summary["scheduler"])
    summary["tp"] = lm_tp(eng, counted, sharded)
    summary["sharded_launches"] = sharded
    summary["kv_quant"] = lm_kv_quant(eng, counted, total)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = _lm_params("bf16")
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN, quant="none",
                      offload=OffloadEngine(), eos_id=None, device="cuda")
    del params
    summary["bf16"], _ = lm_oneshot("bf16", eng, counted, total,
                                    "gemv_bf16_kernel", batch4=False,
                                    eager=LM_EAGER)
    summary["bf16_resident_bytes"] = torch.cuda.memory_allocated()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    _take(counted, total)
    wall = time.perf_counter() - t0
    summary["phase_s"] = wall
    print(f"lm phase: {wall:.1f} s; launches {total}", flush=True)
    return total, summary


# ---------------------------------------------------------------------------
# Phase 15: the MoE family (olmoe-1b-7b at full width, arctic-480b's layer)
# ---------------------------------------------------------------------------
def _moe_params(arch: str, layers: int = 0, prefix: str = "moe"):
    """The arch's published config (its depth cut to ``layers`` when
    given) and its bf16 weights drawn on the card from MOE_SEED, the expert
    stacks a chunk of experts at a time: (cfg, params, the draw's record
    with the allocator's peak)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(MOE_SEED), cfg,
        device="cuda")
    torch.cuda.synchronize()
    info = dict(arch=cfg.name, layers=cfg.num_layers,
                n_params=cfg.n_params(),
                n_active_params=cfg.n_active_params(),
                init_s=time.perf_counter() - t0,
                allocated_bytes=torch.cuda.memory_allocated(),
                peak_bytes=torch.cuda.max_memory_allocated())
    print(f"{prefix} init {cfg.name}: {cfg.num_layers} layer(s) drawn on "
          f"the card in {info['init_s']:.1f}s, "
          f"{info['allocated_bytes'] / 1e9:.2f} GB allocated, peak {info['peak_bytes'] / 1e9:.2f} GB "
          f"({info['n_params'] / 1e9:.3f} G parameters)", flush=True)
    return cfg, params, info


def _moe_bounds(cfg, batch: int = 1):
    """A decode step's byte bounds at HBM_BYTES_PER_S, weights read once
    (the activations are kilobytes): every expert's stacks, which the
    reference's formulation streams each step; the stacks of the experts a
    batch of ``batch`` rows chooses (k a row, E at most); and the engine's
    linears (q/k/v/o, arctic's dense branch, lm_head)."""
    m = cfg.moe
    d, hd = cfg.d_model, cfg.head_dim
    n_moe = len(cfg.moe_layers)
    per_expert = 3 * d * m.d_ff * 2                 # up, gate, down in bf16
    all_b = n_moe * m.num_experts * per_expert
    chosen = n_moe * min(m.num_experts, batch * m.experts_per_token) \
        * per_expert
    attn = 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
    lin = cfg.num_layers * attn + d * cfg.padded_vocab
    lin += n_moe * 3 * d * m.dense_residual_d_ff
    lin_b = 2 * lin

    def ms(b):
        return b / HBM_BYTES_PER_S * 1e3
    return dict(all_experts_bytes=all_b, all_experts_ms=ms(all_b),
                chosen_experts_bytes=chosen, chosen_experts_ms=ms(chosen),
                gemv_bytes=lin_b, gemv_ms=ms(lin_b),
                bound_all_experts_ms=ms(all_b + lin_b),
                bound_chosen_experts_ms=ms(chosen + lin_b))


def _moe_split(eng, kernels, step_ms: float, counted, batch: int = 1):
    """A replayed decode step's device ms split four ways: the expert
    products, dispatch/combine (the router, the routing, the gathers and
    the combine), the engine's ``gemv_bf16_kernel`` launches and the rest
    (attention, norms, the embedding, the argmax). The first two are one
    layer's ``moe._experts`` and ``moe.moe_ffn`` run alone at the step's
    shapes (device time, torch.profiler), times the MoE layers, less the
    dense branch's linears; the gemv is the replay's kernels by name. The
    launches these timings make are not the path's: they are zeroed."""
    import torch
    from repro_torch.models import layers, moe
    cfg = eng.cfg
    p = next(b["moe"] for b in eng._serve_params["stack"]["blocks"]
             if "moe" in b)
    gen = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn((batch, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    cap = moe._capacity(batch, cfg.moe)
    xe = torch.randn((1, cfg.moe.num_experts, cap, cfg.d_model),
                     generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        exp_ms, exp_src = device_ms(lambda: moe._experts(p, cfg, xe))
        ffn_ms, ffn_src = device_ms(
            lambda: moe.moe_ffn(p, cfg, h, engine=eng.offload))
        dense_ms = 0.0
        if "dense" in p:
            dense_ms, _ = device_ms(lambda: layers.mlp_apply(
                p["dense"], h, cfg.act, eng.offload))
    _zero(counted)
    n = len(cfg.moe_layers)
    gemv = by_route(kernels, ("gemv_bf16_kernel",))["gemv_bf16_kernel"][1] \
        if kernels else float("nan")
    experts = n * exp_ms
    routing = n * (ffn_ms - exp_ms - dense_ms)
    return dict(expert_products_ms=experts, dispatch_combine_ms=routing,
                gemv_bf16_kernel_ms=gemv,
                rest_ms=step_ms - experts - routing - gemv,
                split_source=f"layer alone x {n}: {exp_src}/{ffn_src}; gemv "
                             "from the replay")


def _moe_drops(eng, prompts):
    """One eager prefill of ``prompts`` (B, S) with ``moe.route`` wrapped
    to read each MoE layer's keep mask: the (token, choice) pairs dropped
    a step, summed over the layers, one entry a prompt position."""
    import torch
    from repro_torch.models import moe
    seen = []
    route = moe.route

    def reading(p, cfg, x):
        r, aux = route(p, cfg, x)
        seen.append(int((~r.keep).sum()))
        return r, aux

    moe.route = reading
    try:
        eng.prefill(torch.from_numpy(prompts).long().cuda())
    finally:
        moe.route = route
    n = len(eng.cfg.moe_layers)
    return [sum(seen[i:i + n]) for i in range(0, len(seen), n)]


def _moe_step_report(label, eng, one, kernels, counted, batch: int = 1):
    """15a/15c's step: the device ms split and the byte bounds beside the
    replayed step's time (decode ms a token)."""
    bounds = _moe_bounds(eng.cfg, batch)
    step_ms = one.get("step_device_ms")
    split = (_moe_split(eng, kernels, step_ms, counted, batch)
             if isinstance(step_ms, float) else {})
    dec = one["decode_ms_per_token"]
    out = dict(**bounds, **split,
               decode_vs_bound_all_experts=dec / bounds[
                   "bound_all_experts_ms"],
               decode_vs_bound_chosen_experts=dec / bounds[
                   "bound_chosen_experts_ms"])
    print(f"moe {label} step: {json.dumps(out)}", flush=True)
    return out


def moe_drop_semantics(counted, total):
    """15d: olmoe's and arctic's smoke configs (cap 2 at four rows), four
    identical prompts over 4 slots on the card and on the CPU, the same
    weights (seeded on the CPU): equal tokens, and rows 2-3, whose choices
    were dropped, differ from rows 0-1."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    out = {}
    prompt = np.array(MOE_DROP_PROMPT, np.int32)
    for arch in ("olmoe-1b-7b", "arctic-480b"):
        cfg = get_smoke_config(arch)
        params = model.init_params(torch.Generator().manual_seed(MOE_SEED),
                                   cfg, device="cpu")
        rows = {}
        for device in ("cuda", "cpu"):
            # burst 32 sends the smoke widths' main segments to the kernel
            eng = ServeEngine(cfg, params, max_len=16, quant="none",
                              offload=OffloadEngine(burst=32), eos_id=None,
                              device=device)
            sched = ContinuousBatchingScheduler(eng, n_slots=SLOTS)
            rids = [sched.submit(prompt, max_new=MOE_DROP_NEW)
                    for _ in range(SLOTS)]
            res = sched.run()
            rows[device] = [res[r].tokens for r in rids]
        out[arch] = dict(card=rows["cuda"], cpu=rows["cpu"],
                         equal=rows["cuda"] == rows["cpu"])
        print(f"moe drops {arch} smoke: {json.dumps(out[arch])}", flush=True)
        r = rows["cuda"]
        if r != rows["cpu"] or r[0] != r[1] or r[2] != r[3] or r[0] == r[2]:
            raise AssertionError(f"moe drops {arch}: card {r} vs cpu "
                                 f"{rows['cpu']}")
    _take(counted, total)
    return out


def moe_phase(counted):
    """Phase 15: the MoE family in bf16. 15a olmoe-1b-7b at full width
    (16 layers): the first logits against the CPU at depth 2, ``generate``
    eager and captured at batch 1 and 4 (``lm_oneshot``), the step's
    split and bounds; 15b its slot scheduler (``lm_scheduler``) and a
    4-row step's keep masks; 15c, the olmoe engine freed, arctic-480b at
    full width with one layer: ``generate`` at batch 1, the split and
    bounds, and four identical prompts over 4 slots, which drop choices;
    15d the smoke configs' drop case against the CPU. Returns the phase's
    Python launches by kernel and its summary."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    t0 = time.perf_counter()
    total = {}
    _zero(counted)
    gc.collect()
    torch.cuda.empty_cache()
    summary = {}
    cfg, params, summary["olmoe_init"] = _moe_params("olmoe-1b-7b")
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN, quant="none",
                      offload=OffloadEngine(), eos_id=None, device="cuda")
    del params
    summary["olmoe_cpu"] = _lm_cpu_check(eng, MOE_CPU_TOL, "moe olmoe")
    _take(counted, total)
    one, kernels = lm_oneshot("bf16", eng, counted, total,
                              "gemv_bf16_kernel", batch4=True,
                              per_step=OLMOE_PER_STEP, prefix="moe olmoe",
                              eager=LM_EAGER)
    summary["olmoe"] = one
    summary["olmoe_step"] = _moe_step_report("olmoe", eng, one, kernels,
                                             counted)
    summary["olmoe_scheduler"] = lm_scheduler(
        eng, counted, total, "bf16_matmul", "gemv_bf16_kernel",
        OLMOE_PER_STEP, "moe olmoe")
    rng = np.random.default_rng(0)
    four = rng.integers(0, cfg.vocab_size, (SLOTS, 16)).astype(np.int32)
    drops = _moe_drops(eng, four)
    print(f"moe olmoe keep: a 4-row eager step drops {max(drops)} (token, "
          f"choice) pairs at most over {len(drops)} steps (cap "
          f"{eng.cfg.moe.experts_per_token} >= 4 rows)", flush=True)
    if any(drops):
        raise AssertionError(f"moe olmoe: 4 rows dropped choices {drops}")
    summary["olmoe_scheduler"]["dropped_a_step_4_rows"] = max(drops)
    _take(counted, total)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params, summary["arctic_init"] = _moe_params("arctic-480b",
                                                      ARCTIC_LAYERS)
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN, quant="none",
                      offload=OffloadEngine(), eos_id=None, device="cuda")
    del params
    one, kernels = lm_oneshot("bf16", eng, counted, total,
                              "gemv_bf16_kernel", batch4=False,
                              per_step=ARCTIC_PER_STEP, new=ARCTIC_NEW,
                              prefix="moe arctic")
    summary["arctic"] = one
    summary["arctic_step"] = _moe_step_report("arctic", eng, one, kernels,
                                              counted)
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, LM_CPU_PROMPT * 4).astype(np.int32)
    drops = _moe_drops(eng, np.stack([prompt] * SLOTS))
    _take(counted, total)
    batch1 = eng.generate(prompt[None], max_new=ARCTIC_NEW)[0].tokens
    sched = ContinuousBatchingScheduler(eng, n_slots=SLOTS)
    rids = [sched.submit(prompt, max_new=ARCTIC_NEW) for _ in range(SLOTS)]
    res = sched.run()
    rows = [res[r].tokens for r in rids]
    out = dict(dropped_a_step=drops, rows=rows, batch1=batch1,
               rows01_equal_batch1=rows[0] == rows[1] == batch1,
               rows23_differ=rows[2] != rows[0])
    print(f"moe arctic drops: {json.dumps(out)}", flush=True)
    if not min(drops) > 0 or not out["rows01_equal_batch1"]:
        raise AssertionError(f"moe arctic: drops {drops}, rows 0-1 "
                             f"{rows[:2]} vs batch 1 {batch1}")
    summary["arctic_drops"] = out
    _take(counted, total)
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    summary["drop_semantics"] = moe_drop_semantics(counted, total)
    wall = time.perf_counter() - t0
    summary["phase_s"] = wall
    print(f"moe phase: {wall:.1f} s; launches {total}", flush=True)
    return total, summary


# ---------------------------------------------------------------------------
# Phase 16: the SSM and hybrid families (mamba2-780m whole, jamba's repeat)
# ---------------------------------------------------------------------------
def _ssm_state_bytes(cfg, batch: int = 1) -> int:
    """Bytes of the f32 conv windows and SSD states of every SSM layer at
    ``batch`` rows."""
    m = cfg.ssm
    di = m.d_inner(cfg.d_model)
    per = ((m.d_conv - 1) * (di + 2 * m.n_groups * m.d_state)
           + m.n_heads(cfg.d_model) * m.head_dim * m.d_state)
    return 4 * per * batch * (cfg.num_layers - len(cfg.attention_layers))


def _step_bounds(eng, batch: int = 1):
    """A decode step's byte bounds at HBM_BYTES_PER_S: the weights of the
    engine's linears as the step's plan lists them, read once (bf16: 2
    bytes a weight; Q8_0: 1.125, int8 and an f32 scale a block of 32);
    the SSM layers' f32 conv windows and SSD states, read and written;
    with MoE layers every expert's bf16 stacks (the reference's
    formulation streams them all), or only the experts a batch of
    ``batch`` rows chooses."""
    cfg = eng.cfg
    plan = eng._plans.plans[eng._key("step", batch)]
    per_w = 1.125 if eng._serve_quant == "q8_0" else 2
    lin = int(sum(e.n * e.k for e in plan) * per_w)
    state = 2 * _ssm_state_bytes(cfg, batch)

    def ms(b):
        return b / HBM_BYTES_PER_S * 1e3
    out = dict(linear_bytes=lin, linear_ms=ms(lin), state_bytes=state,
               state_ms=ms(state), bound_ms=ms(lin + state))
    if cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff * 2
        n_moe = len(cfg.moe_layers)
        all_b = n_moe * m.num_experts * per_expert
        chosen = n_moe * min(m.num_experts, batch * m.experts_per_token) \
            * per_expert
        out.pop("bound_ms")
        out.update(all_experts_bytes=all_b, chosen_experts_bytes=chosen,
                   bound_all_experts_bytes=all_b + lin + state,
                   bound_all_experts_ms=ms(all_b + lin + state),
                   bound_chosen_experts_bytes=chosen + lin + state,
                   bound_chosen_experts_ms=ms(chosen + lin + state))
    return out


def _ssm_small_ms(eng, counted, batch: int = 1):
    """One SSM layer's small kernels at the step's shapes: its
    ``ssm_decode_step`` run alone (device time, torch.profiler, over a
    scratch state) less its two linears run alone. The launches these
    timings make are not the path's: they are zeroed."""
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import layers, ssm
    cfg = eng.cfg
    p = next(b["ssm"] for b in eng._serve_params["stack"]["blocks"]
             if "ssm" in b)
    off = OffloadEngine()
    gen = torch.Generator(device="cuda").manual_seed(6)
    dt = torch.bfloat16
    h = torch.randn((batch, 1, cfg.d_model), generator=gen,
                    device="cuda").to(dt)
    y = torch.randn((batch, 1, cfg.ssm.d_inner(cfg.d_model)), generator=gen,
                    device="cuda").to(dt)
    st = ssm.SSMState.zeros(batch, cfg.ssm, cfg.d_model, device="cuda")

    def linears():
        layers.linear(p["in_proj"], h[:, 0], off, "ssm.in_proj")
        layers.linear(p["out_proj"], y, off, "ssm.out_proj")
    with torch.no_grad():
        step_ms, src = device_ms(
            lambda: ssm.ssm_decode_step(p, cfg, h, st, engine=off))
        lin_ms, _ = device_ms(linears)
    _zero(counted)
    return step_ms - lin_ms, src


def _ssm_step_report(label, eng, one, kernels, counted, want_name):
    """16a/16c's step: the replayed step's device ms split into the
    engine's ``want_name`` launches (from the replay), the SSM layers'
    small kernels (one layer alone times the SSM layers), with MoE layers
    the expert products and dispatch/combine (``_moe_split``), and the
    rest, beside the step's byte bounds (decode ms a token over each)."""
    cfg = eng.cfg
    bounds = _step_bounds(eng)
    out = dict(**bounds)
    step_ms = one.get("step_device_ms")
    if isinstance(step_ms, float):
        split = (_moe_split(eng, kernels, step_ms, counted)
                 if cfg.moe is not None else {})
        split.pop("gemv_bf16_kernel_ms", None)
        dec_ms = by_route(kernels, (want_name,))[want_name][1]
        small, src = _ssm_small_ms(eng, counted)
        n_ssm = cfg.num_layers - len(cfg.attention_layers)
        out.update(split, **{f"{want_name}_ms": dec_ms},
                   ssm_small_kernels_ms=n_ssm * small,
                   ssm_small_kernels_a_layer_ms=small,
                   ssm_small_source=f"layer alone x {n_ssm}: {src}")
        out["rest_ms"] = (step_ms - dec_ms - n_ssm * small
                          - split.get("expert_products_ms", 0.0)
                          - split.get("dispatch_combine_ms", 0.0))
    dec = one["decode_ms_per_token"]
    for key in [k for k in bounds if k.startswith("bound") and
                k.endswith("_ms")]:
        out[f"decode_vs_{key}"] = dec / bounds[key]
    print(f"ssm {label} step: {json.dumps(out)}", flush=True)
    return out


def _ssm_row_invariance(eng, counted, total):
    """16b: row 0 of an eager 4-slot step gets exactly the logits, conv
    windows and SSD states a batch-1 step gives it, over three steps from
    random states (lengths 5, 2, 9, 0)."""
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model
    cfg, dev = eng.cfg, torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    one = model.zeros_serve_state(cfg, 1, 0, LM_MAX_LEN, device=dev)
    pool = model.zeros_slot_state(cfg, SLOTS, 0, LM_MAX_LEN, device=dev)
    for a, b in zip(model.state_tensors(one), model.state_tensors(pool)):
        if b.is_floating_point():
            b.copy_(torch.randn(b.shape, generator=gen, device=dev))
        else:
            b.copy_(torch.tensor([5, 2, 9, 0]))
        a.copy_(b[:1].reshape(a.shape))
    tok = torch.tensor([[11], [22], [33], [44]], device=dev)
    off = OffloadEngine()
    equal = []
    with torch.no_grad():
        for _ in range(3):
            l4, _ = model.serve_step(eng._serve_params, cfg, tok, pool,
                                     engine=off)
            l1, _ = model.serve_step(eng._serve_params, cfg, tok[:1], one,
                                     engine=off)
            equal.append(bool(torch.equal(l1, l4[:1])))
    states = all(torch.equal(a.reshape(b[:1].shape), b[:1]) for a, b in
                 zip(model.state_tensors(one), model.state_tensors(pool)))
    _take(counted, total)
    out = dict(logits_bit_equal=equal, states_bit_equal=states)
    print(f"ssm mamba2 row: a {SLOTS}-slot step's row 0 against a batch-1 "
          f"step: {json.dumps(out)}", flush=True)
    if not all(equal) or not states:
        raise AssertionError(f"ssm mamba2: a slot row differs from its "
                             f"batch-1 step {out}")
    return out


def _ssm_layer_vs_cpu(eng, counted, total):
    """16c: the first full-width SSM layer's ``ssm_decode_step`` on the
    card and, on a copy of its weights, on the CPU (the kernels' plain
    versions), one row over SSM_LAYER_STEPS carried steps of seeded
    inputs: the outputs, conv window and SSD state within SSM_LAYER_TOL
    of the CPU's largest value."""
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model, ssm
    cfg = eng.cfg
    p = next(b["ssm"] for b in eng._serve_params["stack"]["blocks"]
             if "ssm" in b)
    p_cpu = model.to_device(p, torch.device("cpu"))
    st = ssm.SSMState.zeros(1, cfg.ssm, cfg.d_model, device="cuda")
    st_cpu = ssm.SSMState.zeros(1, cfg.ssm, cfg.d_model, device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(8)
    off = OffloadEngine()
    errs = []

    def rel(got, want):
        want = want.float()
        return ((got.float().cpu() - want).abs().max().item()
                / max(1.0, want.abs().max().item()))
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(SSM_LAYER_STEPS):
            u = torch.randn((1, 1, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            y, st = ssm.ssm_decode_step(p, cfg, u, st, engine=off)
            yc, st_cpu = ssm.ssm_decode_step(p_cpu, cfg, u.cpu(), st_cpu,
                                             engine=off)
            errs.append(rel(y, yc))
    _take(counted, total)
    out = dict(steps=SSM_LAYER_STEPS, out_rel_err_max=max(errs),
               conv_rel_err=rel(st.conv, st_cpu.conv),
               ssd_rel_err=rel(st.ssd, st_cpu.ssd),
               ssd_absmax=st_cpu.ssd.abs().max().item(),
               tolerance=SSM_LAYER_TOL, s=time.perf_counter() - t0)
    print(f"ssm jamba layer card vs cpu: {json.dumps(out)}", flush=True)
    if not max(out["out_rel_err_max"], out["conv_rel_err"],
               out["ssd_rel_err"]) <= SSM_LAYER_TOL:
        raise AssertionError(f"ssm jamba layer: card and CPU differ {out}")
    return out


def _jamba_smoke_vs_cpu(counted, total):
    """16c: jamba's smoke config (weights seeded on the CPU), the same
    requests on the card and on the CPU: ``generate`` of two prompts, and
    four identical prompts over 4 slots (capacity 2: their MoE choices
    drop): equal tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    cfg = get_smoke_config(JAMBA_ARCH)
    params = model.init_params(torch.Generator().manual_seed(MOE_SEED), cfg,
                               device="cpu")
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    rows = {}
    for device in ("cuda", "cpu"):
        # burst 32 sends the smoke widths' main segments to the kernel
        eng = ServeEngine(cfg, params, max_len=16, quant="none",
                          offload=OffloadEngine(burst=32), eos_id=None,
                          device=device)
        gen = [r.tokens for r in eng.generate(prompts, max_new=8)]
        sched = ContinuousBatchingScheduler(eng, n_slots=SLOTS)
        rids = [sched.submit(np.array(MOE_DROP_PROMPT, np.int32),
                             max_new=MOE_DROP_NEW) for _ in range(SLOTS)]
        res = sched.run()
        rows[device] = dict(generate=gen,
                            scheduler=[res[r].tokens for r in rids])
    _take(counted, total)
    out = dict(card=rows["cuda"], cpu=rows["cpu"],
               equal=rows["cuda"] == rows["cpu"])
    print(f"ssm jamba smoke card vs cpu: {json.dumps(out)}", flush=True)
    if not out["equal"]:
        raise AssertionError(f"ssm jamba smoke: card and CPU differ {out}")
    return out


def ssm_phase(counted):
    """Phase 16: the SSM and hybrid families. 16a mamba2-780m at full
    width (48 layers) in Q8_0: the first logits against the CPU at depth
    2, ``generate`` eager and captured at batch 1 and 4 (``lm_oneshot``,
    97 ``q8_matvec_kernel`` a replay), the step's split and bounds; 16b
    its slot scheduler (``lm_scheduler``) and a 4-slot row bit for bit a
    batch-1 row; 16a again in bf16 (97 ``gemv_bf16_kernel``); 16c, mamba2
    freed, jamba-v0.1-52b at full width cut to one 8-layer repeat: one
    SSM layer card vs CPU, ``generate`` at batch 1 (31
    ``gemv_bf16_kernel``), the split and bounds, and the smoke config's
    tokens card vs CPU. Returns the phase's Python launches by kernel and
    its summary."""
    import gc

    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    total = {}
    _zero(counted)
    gc.collect()
    torch.cuda.empty_cache()
    summary = {}
    cfg, params, summary["mamba2_init"] = _moe_params(MAMBA_ARCH,
                                                      prefix="ssm")
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN,
                      offload=OffloadEngine(), eos_id=None, device="cuda")
    eng.params = params = None          # the bf16 draw: freed, quantized
    gc.collect()
    torch.cuda.empty_cache()
    summary["mamba2_cpu"] = _lm_cpu_check(eng, SSM_CPU_TOL, "ssm mamba2")
    _take(counted, total)
    one, kernels = lm_oneshot("q8_0", eng, counted, total,
                              "q8_matvec_kernel", batch4=True,
                              per_step=MAMBA_PER_STEP, prefix="ssm mamba2",
                              eager=LM_EAGER)
    summary["mamba2_q8_0"] = one
    summary["mamba2_q8_0_step"] = _ssm_step_report(
        "mamba2 q8_0", eng, one, kernels, counted, "q8_matvec_kernel")
    summary["mamba2_scheduler"] = lm_scheduler(
        eng, counted, total, "q8_matvec", "q8_matvec_kernel",
        MAMBA_PER_STEP, "ssm mamba2", SSM_SCHED_PROMPTS, SSM_SCHED_BUDGETS)
    summary["mamba2_row"] = _ssm_row_invariance(eng, counted, total)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params, _ = _moe_params(MAMBA_ARCH, prefix="ssm")
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN, quant="none",
                      offload=OffloadEngine(), eos_id=None, device="cuda")
    del params
    one, kernels = lm_oneshot("bf16", eng, counted, total,
                              "gemv_bf16_kernel", batch4=True,
                              per_step=MAMBA_PER_STEP, prefix="ssm mamba2",
                              eager=LM_EAGER)
    summary["mamba2_bf16"] = one
    summary["mamba2_bf16_step"] = _ssm_step_report(
        "mamba2 bf16", eng, one, kernels, counted, "gemv_bf16_kernel")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params, summary["jamba_init"] = _moe_params(
        JAMBA_ARCH, JAMBA_LAYERS, prefix="ssm")
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN, quant="none",
                      offload=OffloadEngine(), eos_id=None, device="cuda")
    del params
    summary["jamba_layer"] = _ssm_layer_vs_cpu(eng, counted, total)
    one, kernels = lm_oneshot("bf16", eng, counted, total,
                              "gemv_bf16_kernel", batch4=False,
                              per_step=JAMBA_PER_STEP, new=JAMBA_NEW,
                              prefix="ssm jamba")
    summary["jamba"] = one
    summary["jamba_step"] = _ssm_step_report(
        "jamba", eng, one, kernels, counted, "gemv_bf16_kernel")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    summary["jamba_smoke"] = _jamba_smoke_vs_cpu(counted, total)
    wall = time.perf_counter() - t0
    summary["phase_s"] = wall
    print(f"ssm phase: {wall:.1f} s; launches {total}", flush=True)
    return total, summary


# ---------------------------------------------------------------------------
# Phase 17: the full-sequence forward and loss of every family; llava served
# ---------------------------------------------------------------------------
def _fwd_batch(cfg, s: int, seed: int = FWD_SEED):
    """One row of ``s`` tokens from default_rng(seed) with its shifted
    labels (the last masked), on the card; a VLM's min(vision_patches, s
    // 2) f32 patches (launch/input_specs.py's rule) from a CUDA generator
    seeded alike: the reference's vision tower is a stub."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s)))
    labels = toks.roll(-1, 1)
    labels[:, -1] = -1
    batch = {"tokens": toks.cuda(), "labels": labels.cuda()}
    if cfg.family == "vlm":
        gen = torch.Generator(device="cuda").manual_seed(seed)
        batch["patches"] = torch.randn(
            (1, min(cfg.vision_patches, s // 2), cfg.vision_embed_dim),
            generator=gen, device="cuda")
    return batch


def _fwd_bounds(eng, plan, cfg, s: int):
    """The least time of one forward at ``s`` tokens: the operations of
    the linears its plan lists (2 m k n each; at 989 TFLOP/s for bf16 x,
    and a third of that for the f32 patches on the Q8_0 projector, split
    into three bf16 parts) and of the causal
    attention (QK and PV over the s (s + 1) / 2 query-key pairs a head
    needs, bf16 rate), against the bytes that each linear reads (x, bf16
    or the projector's f32 patches; the weight at 2 bytes or Q8_0's 1.125;
    its f32 output written) at the memory rate."""
    q8 = eng._serve_quant == "q8_0"
    ops_ms = bytes_ = 0
    lin_flops = 0
    for e in plan:
        flops = 2 * e.m * e.k * e.n
        lin_flops += flops
        f32_x = e.name == "vlm.projector"
        rate = "float32_split" if q8 and f32_x else "bfloat16"
        ops_ms += flops / FLOPS_PER_S[rate] * 1e3
        bytes_ += e.m * e.k * (4 if f32_x else 2) \
            + e.n * e.k * (1.125 if q8 else 2) + e.m * e.n * 4
    attn_flops = (4 * cfg.num_heads * cfg.head_dim * s * (s + 1) // 2
                  * len(cfg.attention_layers))
    ops_ms += attn_flops / FLOPS_PER_S["bfloat16"] * 1e3
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = bound(bytes_ms, ops_ms)
    return dict(linear_flops=lin_flops, attention_flops=attn_flops,
                bytes=int(bytes_), bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=b_ms, bound_by=b_by)


def _core_ms(cfg, s: int, counted):
    """One mixer core alone at a forward's shapes on random bf16 inputs,
    times the layers that run it (CUDA events over a captured graph of 3
    calls, ``graph_ms``: late in the run the profiler drops records): an
    attention layer's causal attention over RoPE'd q, k, v (``attn_impl``
    "flash" or "chunked"), an SSM layer's chunked SSD scan. Returns
    (part name, ms, source). The launches it makes are not the path's:
    they are zeroed."""
    import torch
    from repro_torch.models import attention, ssm
    gen = torch.Generator(device="cuda").manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    if cfg.family == "ssm":
        m = cfg.ssm
        h = m.n_heads(cfg.d_model)
        x = rnd(1, s, h, m.head_dim).float()
        dt = torch.rand((1, s, h), generator=gen, device="cuda") * 0.1
        a = -torch.rand((h,), generator=gen, device="cuda")
        bm, cm = (rnd(1, s, m.n_groups, m.d_state).float() for _ in "bc")
        fn = (lambda: ssm.ssd_scan(x, dt, a, bm, cm, m.chunk))
        part, n = "scan_ms", cfg.num_layers
    else:
        q = rnd(1, s, cfg.num_heads, cfg.head_dim)
        k, v = (rnd(1, s, cfg.num_kv_heads, cfg.head_dim) for _ in "kv")
        fn = ((lambda: attention._flash_attention(q, k, v, causal=True))
              if cfg.attn_impl == "flash" else
              (lambda: attention._chunked_attention(q, k, v, True)))
        part, n = "attention_ms", len(cfg.attention_layers)
    with torch.inference_mode():
        ms = graph_ms(fn, iters=3)
    _zero(counted)
    return part, n * ms, f"one layer alone x {n}: graph_events"


def _fwd_split(kernels, core):
    """A profiled forward's device ms by part: the port's product kernels
    by name (``PORT_KERNEL_WORDS`` but flash), the mixer cores
    (``_core_ms``: attention, or an SSM model's scan), and the rest (norms,
    RoPE, casts, copies, the conv, the gate, the embedding, the CE)."""
    part, core_ms, src = core
    products = sum(ms for name, (_, ms) in kernels.items()
                   if any(w in name for w in PORT_KERNEL_WORDS
                          if w != "flash_fwd"))
    device = sum(ms for _, ms in kernels.values())
    return {"products_ms": products, part: core_ms,
            "rest_ms": device - products - core_ms, "device_ms": device,
            "core_source": src}


def _forward_case(label, eng, cfg, batch, counted, total, want, want_loss,
                  prefix="forward"):
    """One forward configuration at full width: a recorded forward (its
    Python launches ``want``, its plan the bound's), FWD_REPS timed
    forwards (host clock, synchronized), ``loss_fn`` (launches
    ``want_loss``: lm_head once a CE chunk), and one profiled forward:
    its device ms split by part and its idle share. Returns (summary,
    logits, loss)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.plan import DispatchPlan
    from repro_torch.models import model

    sp, off = eng._serve_params, eng.offload
    s = batch["tokens"].shape[1]
    plan = DispatchPlan()
    _take(counted, total)
    with torch.inference_mode():
        with off.recording(plan):
            logits, _ = model.forward(sp, cfg, batch, engine=off)
        torch.cuda.synchronize()
        got = _read(counted)
        _take(counted, total)
        walls = []
        for _ in range(FWD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.forward(sp, cfg, batch, engine=off)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        _take(counted, total)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics = model.loss_fn(sp, cfg, batch, engine=off,
                                      ce_chunk=FWD_CE_CHUNK)
        torch.cuda.synchronize()
        loss_ms = (time.perf_counter() - t0) * 1e3
        got_loss = _read(counted)
        _take(counted, total)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _open_window()
            t0 = time.perf_counter()
            model.forward(sp, cfg, batch, engine=off)
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
        _take(counted, total)
    split = _fwd_split(_by_kernel(prof), _core_ms(cfg, s, counted))
    host_ms = statistics.median(walls)
    bounds = _fwd_bounds(eng, plan, cfg, s)
    out = dict(case=label, tokens=s, forward_ms=host_ms,
               forward_ms_each=walls, tokens_per_s=s / host_ms * 1e3,
               loss_ms=loss_ms, loss=float(loss), ce=float(metrics["ce"]),
               ntok=float(metrics["ntok"]), launches=got,
               loss_launches=got_loss, linears_a_forward=len(plan),
               **split, profiled_wall_ms=pwall,
               idle_share=1 - split["device_ms"] / pwall,
               idle_share_unprofiled=1 - split["device_ms"] / host_ms,
               **bounds, forward_vs_bound=host_ms / bounds["bound_ms"],
               device_vs_bound=split["device_ms"] / bounds["bound_ms"])
    print(f"{prefix} {label}: {json.dumps(out)}", flush=True)
    if got != want or got_loss != want_loss:
        raise AssertionError(f"{prefix} {label}: launches {got} (loss "
                             f"{got_loss}), expected {want} ({want_loss})")
    if not (torch.isfinite(loss) and torch.isfinite(logits).all()):
        raise AssertionError(f"{prefix} {label}: non-finite logits or loss")
    if logits.shape != (1, s, cfg.padded_vocab):
        raise AssertionError(f"{prefix} {label}: logits {logits.shape}")
    return out, logits, loss


def _fwd_cpu_check(label, eng, cfg, tol: float, prefix="forward"):
    """The logits of the forward cut to depth FWD_CPU_LAYERS (the seed's
    embedding, first layers, final norm, head and projector) over a row of
    FWD_CPU_SEQ tokens (and its share of patches), on the card and on the
    CPU through the offload engine: within ``tol`` of the CPU's largest
    logit; the losses alike. With attention layers, the card's flash
    forward of the same cut within FWD_FLASH_TOL of its chunked one."""
    import dataclasses

    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model

    sub_cfg = dataclasses.replace(cfg, num_layers=FWD_CPU_LAYERS)
    sp = eng._serve_params
    sub = {k: v for k, v in sp.items() if k != "stack"}
    sub["stack"] = {"blocks": sp["stack"]["blocks"][:FWD_CPU_LAYERS]}
    batch = _fwd_batch(cfg, FWD_CPU_SEQ, seed=FWD_SEED + 1)
    with torch.inference_mode():
        card, _ = model.forward(sub, sub_cfg, batch, engine=eng.offload)
        card_loss, _ = model.loss_fn(sub, sub_cfg, batch, engine=eng.offload)
        t0 = time.perf_counter()
        sub_cpu = model.to_device(sub, torch.device("cpu"))
        batch_cpu = {k: v.cpu() for k, v in batch.items()}
        cpu, _ = model.forward(sub_cpu, sub_cfg, batch_cpu,
                               engine=OffloadEngine())
        cpu_loss, _ = model.loss_fn(sub_cpu, sub_cfg, batch_cpu,
                                    engine=OffloadEngine())
        cpu_s = time.perf_counter() - t0
        flash = None
        if sub_cfg.attention_layers:
            flash, _ = model.forward(
                sub, dataclasses.replace(sub_cfg, attn_impl="flash"), batch,
                engine=eng.offload)
    got, want = card.float().cpu(), cpu.float()
    err = (got - want).abs().max().item()
    big = want.abs().max().item()
    loss_err = abs(float(card_loss) - float(cpu_loss))
    out = dict(layers=FWD_CPU_LAYERS, tokens=FWD_CPU_SEQ, max_abs_err=err,
               logits_absmax=big, tolerance=tol, loss_card=float(card_loss),
               loss_cpu=float(cpu_loss), loss_abs_err=loss_err, cpu_s=cpu_s)
    if flash is not None:
        out["flash_vs_chunked_err"] = (flash.float() - card.float()
                                       ).abs().max().item()
        out["flash_tolerance"] = FWD_FLASH_TOL
    print(f"{prefix} {label} card vs cpu: {json.dumps(out)}", flush=True)
    if not (torch.isfinite(got).all() and err <= tol * big
            and loss_err <= tol * float(cpu_loss)):
        raise AssertionError(f"{prefix} {label}: card and CPU differ by "
                             f"{err} (loss {loss_err})")
    if flash is not None and not out["flash_vs_chunked_err"] <= \
            FWD_FLASH_TOL * card.float().abs().max().item():
        raise AssertionError(f"{prefix} {label}: flash and chunked differ "
                             f"by {out['flash_vs_chunked_err']} at depth "
                             f"{FWD_CPU_LAYERS}")
    return out


def _embed_vs_cpu(eng, cfg, batch, counted, total, prefix="forward vlm"):
    """17c: the patch splice alone (``_embed_inputs``), card against CPU,
    within 1e-2 of the CPU's largest value (the splice is cast to bf16):
    the projector's product (M = 1152, K = 1024, N = 4096, f32 x) is one
    ``q8_matmul`` launch, and kernel_for sends M > 16 there."""
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model

    sub = {k: eng._serve_params[k] for k in ("embed", "projector")}
    _take(counted, total)
    with torch.inference_mode():
        got = model._embed_inputs(sub, cfg, batch, eng.offload)
        torch.cuda.synchronize()
        launches = _read(counted)
        _take(counted, total)
        want = model._embed_inputs(model.to_device(sub, torch.device("cpu")),
                                   cfg, {k: v.cpu() for k, v in batch.items()},
                                   OffloadEngine())
    p = batch["patches"].shape[1]
    err = (got.float().cpu() - want.float()).abs().max().item()
    big = want.float().abs().max().item()
    out = dict(patches=p, m=p, k=cfg.vision_embed_dim, n=cfg.d_model,
               launches=launches, max_abs_err=err, absmax=big,
               tokens_equal=bool(torch.equal(got[:, p:].cpu(), want[:, p:])))
    print(f"{prefix} embed_inputs card vs cpu: {json.dumps(out)}", flush=True)
    if launches.get("q8_matmul") != 1 or not err <= 1e-2 * big \
            or not out["tokens_equal"]:
        raise AssertionError(f"{prefix}: _embed_inputs {out}")
    return out


def _smoke_forwards(counted, total, prefix="forward smoke"):
    """17f: every family's smoke config (weights from seed 0 on the card),
    through an engine with burst 32 (every main segment on a kernel): the
    forward's logits and the loss on the card against the CPU (Q8_0, or
    bf16 for a MoE model, as it is served; f32 activations: 1e-4 of the
    largest logit for Q8_0, 2e-2 where bf16 rounds the operands), a VLM
    with 4 patches; and a teacher-forced forward against the
    ``serve_step`` loop on the card (2e-4, as the reference's
    test_prefill_decode_consistency; a MoE's capacity made no-drop)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.models import model, whisper
    from repro_torch.serve.engine import ServeEngine

    out = {}
    for arch in SMOKE_FORWARD_ARCHS:
        cfg = get_smoke_config(arch)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        quant = "none" if cfg.moe is not None else "q8_0"
        params = model.init_params(torch.Generator().manual_seed(0), cfg,
                                   max_positions=64, device="cuda")
        eng = ServeEngine(cfg, params, max_len=32, quant=quant,
                          offload=OffloadEngine(burst=32), eos_id=None,
                          device="cuda")
        sp = eng._serve_params
        rng = np.random.default_rng(3)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 10)))
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        if cfg.family == "vlm":
            batch["patches"] = torch.from_numpy(rng.standard_normal(
                (2, 4, cfg.vision_embed_dim)).astype(np.float32))
        if cfg.family == "audio":
            batch["mel"] = torch.from_numpy(rng.standard_normal(
                (2, 12, cfg.n_mels)).astype(np.float32))
        card_b = {k: v.cuda() for k, v in batch.items()}
        with torch.inference_mode():
            logits, _ = model.forward(sp, cfg, card_b, engine=eng.offload)
            loss, _ = model.loss_fn(sp, cfg, card_b, engine=eng.offload)
            cpu_p = model.to_device(sp, torch.device("cpu"))
            want, _ = model.forward(cpu_p, cfg, batch,
                                    engine=OffloadEngine(burst=32))
            want_loss, _ = model.loss_fn(cpu_p, cfg, batch,
                                         engine=OffloadEngine(burst=32))
            memory = (whisper.encode(sp, cfg, card_b["mel"],
                                     engine=eng.offload)
                      if cfg.family == "audio" else None)
            st = model.init_serve_state(sp, cfg, 2, 32, memory=memory,
                                        engine=eng.offload)
            tf_b = {k: v for k, v in card_b.items() if k != "patches"}
            tf, _ = model.forward(sp, cfg, tf_b, engine=eng.offload)
            steps = []
            for t in range(toks.shape[1]):
                lg, st = model.serve_step(sp, cfg, card_b["tokens"][:, t:t + 1],
                                          st, engine=eng.offload)
                steps.append(lg[:, 0])
            steps = torch.stack(steps, dim=1)
        torch.cuda.synchronize()
        tol = 1e-4 if quant == "q8_0" else 2e-2

        def rel(a, b):
            a, b = a.float().cpu(), b.float().cpu()
            return (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        row = dict(quant=quant, card_vs_cpu=rel(logits, want),
                   loss_card=float(loss), loss_cpu=float(want_loss),
                   forward_vs_steps=rel(tf, steps), tolerance=tol)
        out[arch] = row
        print(f"{prefix} {arch}: {json.dumps(row)}", flush=True)
        if not (row["card_vs_cpu"] <= tol and row["forward_vs_steps"] <= 2e-4
                and abs(row["loss_card"] - row["loss_cpu"])
                <= tol * row["loss_cpu"]):
            raise AssertionError(f"{prefix} {arch}: {row}")
        del eng, params, sp, cpu_p
    _take(counted, total)
    return out


def forward_phase(counted):
    """Phase 17: 17a llava-next-mistral-7b at full width drawn on the card
    (bf16, and quantized to Q8_0 by a second engine); 17b ``forward`` and
    ``loss_fn`` at one row of S = FWD_SEQ with its 1152 patches, Q8_0 and
    bf16, chunked and flash (the depth-2 cut against the CPU, flash
    against chunked, launches, time, the device split beside the bound,
    idle share); 17c ``_embed_inputs`` alone against the CPU; 17d llava
    served, Q8_0 then bf16 (``lm_oneshot`` batch 1 and 4, 225 decode
    launches a step; ``lm_scheduler``); 17e mamba2-780m's forward at full
    width in Q8_0 (the chunked SSD scan); 17f every family's smoke config
    (``_smoke_forwards``). Returns the phase's Python launches, those of
    17d alone, and its summary."""
    import dataclasses
    import gc

    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    total, served = {}, {}
    _zero(counted)
    summary = {"memory_at_start": release_memory("forward phase")}
    cfg, params, summary["llava_init"] = _moe_params(VLM_ARCH,
                                                     prefix="forward")
    engines = {"bf16": ServeEngine(cfg, params, max_len=LM_MAX_LEN,
                                   quant="none", offload=OffloadEngine(),
                                   eos_id=None, device="cuda")}
    engines["q8_0"] = ServeEngine(cfg, params, max_len=LM_MAX_LEN,
                                  offload=OffloadEngine(), eos_id=None,
                                  device="cuda")
    del params
    torch.cuda.synchronize()
    summary["llava_both_trees_bytes"] = torch.cuda.memory_allocated()
    summary["llava_peak_bytes"] = torch.cuda.max_memory_allocated()
    batch = _fwd_batch(cfg, FWD_SEQ)
    per_fwd = 7 * cfg.num_layers + 2        # the linears, projector, lm_head
    n_chunks = FWD_SEQ // FWD_CE_CHUNK
    for quant, name, tol in (("q8_0", "q8_matmul", FIRST_STEP_TOL),
                             ("bf16", "bf16_matmul", DENSE_FIRST_STEP_TOL)):
        eng = engines[quant]
        summary[f"{quant}_cpu"] = _fwd_cpu_check(quant, eng, cfg, tol)
        cases = {}
        for impl in ("chunked", "flash"):
            icfg = dataclasses.replace(cfg, attn_impl=impl)
            nflash = cfg.num_layers if impl == "flash" else 0
            want = {k: 0 for k in counted}
            want[name] = per_fwd
            want["flash_attention_fwd"] = nflash
            want_loss = dict(want, **{name: per_fwd - 1 + n_chunks})
            cases[impl] = _forward_case(f"{quant} {impl}", eng, icfg, batch,
                                        counted, total, want, want_loss)
        (c_out, c_logits, c_loss), (f_out, f_logits, f_loss) = \
            cases["chunked"], cases["flash"]
        err = (f_logits.float() - c_logits.float()).abs().max().item()
        big = c_logits.float().abs().max().item()
        loss_err = abs(float(f_loss) - float(c_loss))
        print(f"forward {quant} flash vs chunked: max_abs_err={err:.4e} of "
              f"|logits|max {big:.3f} (tolerance {FWD_FLASH_FULL_TOL}); loss "
              f"{float(f_loss):.5f} vs {float(c_loss):.5f} (tolerance "
              f"{FWD_LOSS_TOL})", flush=True)
        if not (err <= FWD_FLASH_FULL_TOL * big
                and loss_err <= FWD_LOSS_TOL):
            raise AssertionError(f"forward {quant}: flash and chunked differ "
                                 f"by {err} (loss {loss_err})")
        summary[quant] = dict(chunked=c_out, flash=f_out,
                              flash_vs_chunked_err=err, logits_absmax=big,
                              flash_vs_chunked_loss_err=loss_err)
        del cases, c_logits, f_logits
    summary["embed_inputs"] = _embed_vs_cpu(engines["q8_0"], cfg, batch,
                                            counted, total)
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    _take(counted, total)
    for quant, want_name, name in (("q8_0", "q8_matvec_kernel", "q8_matvec"),
                                   ("bf16", "gemv_bf16_kernel",
                                    "bf16_matmul")):
        eng = engines.pop(quant)
        before = dict(total)
        summary[f"served_{quant}"], _ = lm_oneshot(
            quant, eng, counted, total, want_name, batch4=True,
            per_step=VLM_PER_STEP, prefix="forward vlm", eager=LM_EAGER)
        summary[f"served_{quant}_scheduler"] = lm_scheduler(
            eng, counted, total, name, want_name, VLM_PER_STEP,
            "forward vlm")
        _take(counted, total)
        for k, n in total.items():
            served[k] = served.get(k, 0) + n - before.get(k, 0)
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    mcfg, mparams, summary["mamba2_init"] = _moe_params(MAMBA_ARCH,
                                                        prefix="forward")
    eng = ServeEngine(mcfg, mparams, max_len=8, offload=OffloadEngine(),
                      eos_id=None, device="cuda")
    del mparams
    eng.params = None
    gc.collect()
    torch.cuda.empty_cache()
    summary["mamba2_cpu"] = _fwd_cpu_check("mamba2 q8_0", eng, mcfg,
                                           FIRST_STEP_TOL)
    want = {k: 0 for k in counted}
    want["q8_matmul"] = 2 * mcfg.num_layers + 1
    want_loss = dict(want, q8_matmul=2 * mcfg.num_layers + n_chunks)
    summary["mamba2"], _, _ = _forward_case(
        "mamba2 q8_0", eng, mcfg, _fwd_batch(mcfg, FWD_SEQ), counted, total,
        want, want_loss)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    summary["smoke"] = _smoke_forwards(counted, total)
    _take(counted, total)
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    summary["phase_s"] = wall
    summary["allocated_at_end_bytes"] = torch.cuda.memory_allocated()
    print(f"forward phase: {wall:.1f} s; launches {total}; llava served "
          f"{served}", flush=True)
    return total, served, summary


# ---------------------------------------------------------------------------
# Phase 19: training
# ---------------------------------------------------------------------------
# 19b: phi3-mini-3.8b at its published widths (configs/phi3_mini_3_8b.py:
# 32 layers, d_model 3072, 32 heads of 96, d_ff 8192, vocabulary 32,064),
# bf16, flash attention, full remat, TRAIN_4K's 4096 tokens at a global
# batch of 2, one microbatch, weights drawn on the card from TRAIN_SEED.
# The AdamW moments are kept in bf16: two checkpoints of f32 moments (38 GB
# each) would not fit the 75 GB the card's machine has free on disk
TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_EVERY = 4096, 2, 4, 2
TRAIN_SEED = 0
TRAIN_STATE_DTYPE = "bfloat16"
# 19b's resume check runs at phi3's width cut to this many layers (its
# checkpoints about an eighth of a full-depth one's 22.9 GB); 19d's
# elastic round trip at TRAIN_ROUND_TRIP_LAYERS
TRAIN_RESUME_LAYERS, TRAIN_ROUND_TRIP_LAYERS = 4, 2
# 19d: steps over the reference CLI's smoke mesh, (2, 2) data x model of
# four entries of the one card, each data shard one 4096-token row of
# 19b's batch; its losses and gradient norms against 19b's first steps
# within TRAIN_RESUME_TOL
TRAIN_MESH_STEPS = 2
# 19d's peak: 7.6 GB of split parameters, no whole gathered copy (each
# data shard gathers one remat unit's slices at a time, 0.23 GB a layer),
# 15.3 GB of bf16 moments, two shards' 7.6 GB of bf16 gradients (their f32
# sums replace them as they are freed) and remat's activations: about 40
# GB, 7.6 below the 46.77 GB that a whole gathered copy took (H100 80GB)
TRAIN_MESH_PEAK_GB = 42
# 19e: one step over a (1, 4) mesh of four entries of the card, the
# "model" axis alone (8 of 32 heads, 2048 of 8192 FFN columns a shard),
# 19b's whole batch on the one data shard; its loss and gradient norm
# against 19b's first step within TRAIN_RESUME_TOL
TRAIN_TP_MESH = (1, 4)
# 19f: olmoe-1b-7b at its published widths (configs/olmoe_1b_7b.py:
# d_model 2048, 16 heads of 128, 64 experts of d_ff 1024, top-8,
# vocabulary 50,304, capacity factor 1.25, dispatch groups of 512) cut to
# TRAIN_MOE_LAYERS of its 16 layers (1.884e9 parameters, 3.77 GB in bf16),
# bf16, flash, full remat, bf16 moments, TRAIN_MOE_BATCH rows of
# TRAIN_MOE_SEQ tokens drawn on the card from TRAIN_SEED: TRAIN_MOE_STEPS
# unsharded steps, then as many of Trainer(mesh=) over each of
# TRAIN_MOE_MESHES (16 experts a model shard on (1, 4); a row a data shard
# and 32 experts a model shard on (2, 2), a data shard's 2048 tokens 4
# whole dispatch groups, so the drops are the unsharded step's), the
# first step's loss and gradient norm against the unsharded step's within
# TRAIN_RESUME_TOL; a run's first step pays the allocator's and cuBLAS's
# first calls at its shapes, so its last step is the one timed
TRAIN_MOE_ARCH = "olmoe-1b-7b"
TRAIN_MOE_LAYERS, TRAIN_MOE_SEQ, TRAIN_MOE_BATCH = 4, 2048, 2
TRAIN_MOE_STEPS = 2
TRAIN_MOE_MESHES = ((1, 4), (2, 2))
# the resumed run's losses against the continuous run's: the embedding's
# backward (index_add_ with atomics on the card) sums in a scheduling order
TRAIN_RESUME_TOL = 1e-3
# a full-width step's gradients through the flash kernels against those of
# attn_impl="chunked" (no flash kernel) on the same parameters and batch:
# each leaf's ||g - g_chunked|| / ||g_chunked||. Both run in bf16, whose
# rounding (2^-8) the two attentions take at different places; a wrong
# backward (a missing or misplaced dq, dk or dv) moves the attention
# weights' gradients by their own size
TRAIN_GRAD_TOL = 5e-2
# then a few steps on one fixed batch at the reference's default lr
# (OptimizerConfig.lr, no warmup), whose loss must fall at every step
TRAIN_DESCENT_STEPS, TRAIN_DESCENT_LR = 3, 3e-4
# flash backward kernel vs plain, of each output's largest magnitude: f32
# sums in another order; in bf16 the outputs round to bf16 (2^-8) after
# sums that may differ in their last f32 bits
FLASH_BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# bf16 kernel vs plain, each output's mean |kernel - plain| over its mean
# magnitude: where the two agree before the outputs round to bf16, the
# roundings differ in few elements; a dS rounded once to bf16 (2^-9)
# before the dK and dQ products, not split as hi + lo, moves most of them
# (tools/flash_bwd_ds_ablation.py measures both)
FLASH_BWD_MEAN_TOL = 1e-4
# 19a checks: llava's head size 128 (causal, BH = 32), whisper-tiny's
# encoder (non-causal, 6 heads of 64, 1500 frames: ragged against 64) in
# f32 and bf16, and the head sizes 16 and 32 (ragged, cross lengths)
FLASH_BWD_CHECKS = [
    (64, 4096, 4096, 96, "bfloat16", True),
    (32, 4096, 4096, 128, "bfloat16", True),
    (6, 1500, 1500, 64, "float32", False),
    (6, 1500, 1500, 64, "bfloat16", False),
    (3, 101, 101, 16, "bfloat16", True),
    (3, 45, 200, 16, "float32", False),
    (2, 150, 77, 32, "float32", False),
    (2, 129, 129, 32, "bfloat16", True),
]
FLASH_LSE_TOL = 1e-5            # of max(1, |lse|): the card's exp and log
FLASH_CORE_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# kernel names of the step's device split
TRAIN_SPLIT_WORDS = (("flash_fwd", ("flash_fwd",)),
                     ("flash_bwd", ("flash_bwd",)),
                     ("gemm", LIBRARY_WORDS))
# the backward's kernels a bf16 layer launches in a step: delta, then the
# tensor-core dK/dV and dQ kernels; the SIMT ones (f32) must not appear
TRAIN_BWD_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_mma_kernel",
                     "flash_bwd_dq_mma_kernel")
TRAIN_BWD_SIMT = ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


def _flash_bwd_case(gen, bh, sq, sk, d, dt, causal):
    """The backward's operands at one shape, the forward's output and
    logsumexp from the kernel, and the library's backward: SDPA's on the
    same bf16 q, k, v and cotangent, its forward run once outside the
    timed call. Bytes: q, k, v, out, dout and lse read once, dq, dk, dv
    written once; operations: the five contractions of 2 D FLOPs a
    query-key pair the mask leaves."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda").to(
        dtype) for s in (sq, sk, sk))
    dout = torch.randn((bh, sq, d), generator=gen, device="cuda").to(dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    out = out.to(dtype)
    size = q.element_size()
    moved = (3 * bh * sq * d + 2 * bh * sk * d) * size + bh * sq * 4 \
        + (bh * sq * d + 2 * bh * sk * d) * size
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    q4, k4, v4 = (t.detach().clone()[None].requires_grad_(True)
                  for t in (q, k, v))
    o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=causal)
    g4 = dout[None]

    def library():
        return torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True)
    return (q, k, v, out, dout, lse), library, moved, 10 * bh * pairs * d


def _bwd_err(got, want):
    """The largest of the three outputs' max |kernel - plain|, each over
    its plain output's largest magnitude."""
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp(min=1e-30)).item()
               for g, w in zip(got, want))


def _bwd_mean_err(got, want):
    """The largest of the three outputs' mean |kernel - plain|, each over
    its plain output's mean magnitude."""
    return max(((g.float() - w.float()).abs().mean()
                / w.float().abs().mean().clamp(min=1e-30)).item()
               for g, w in zip(got, want))


def train_kernel_checks():
    """Phase 19a: the forward's logsumexp against its plain version, the
    backward against its plain version at FLASH_BWD_CHECKS (two launches
    bit for bit equal), ``_FlashCore``'s gradients against autograd
    through the plain forward, and the backward's row at phi3-mini's
    shape: device time, plain time, the library's backward (SDPA's, timed
    without its forward), the bound at the card's peak rate for the
    operands' type (bf16's tensor-core rate) and, beside it, at the f32
    FMA rate the SIMT kernel runs on (67 TFLOP/s)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import _flash_attention, \
        _repeat_kv_heads

    gen = torch.Generator(device="cuda").manual_seed(19)
    for bh, sq, sk, d, dt, causal in FLASH_BWD_CHECKS:
        args, *_ = _flash_bwd_case(gen, bh, sq, sk, d, dt, causal)
        q, k, v, out, dout, lse = args
        _, lse_want = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   return_lse=True)
        lse_err = (lse - lse_want).abs().max().item()
        routes = dict(fa.flash_attention_bwd.launches_by_route)
        got = fa.flash_attention_bwd(*args, causal=causal)
        again = fa.flash_attention_bwd(*args, causal=causal)
        want = fa.flash_attention_bwd_plain(*args, causal=causal)
        torch.cuda.synchronize()
        taken = {r: n - routes[r] for r, n
                 in fa.flash_attention_bwd.launches_by_route.items()}
        route = "mma" if dt == "bfloat16" else "simt"
        err, mean_err = _bwd_err(got, want), _bwd_mean_err(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"check flash_attention_bwd bh={bh} sq={sq} sk={sk} d={d} "
              f"{dt} causal={causal}: route {route} {taken}, rel_err="
              f"{err:.3e} (tolerance {FLASH_BWD_TOL[dt]}), mean_err="
              f"{mean_err:.3e} (bf16 tolerance {FLASH_BWD_MEAN_TOL}), "
              f"repeat_bitwise={same}; lse max_abs_err={lse_err:.3e}",
              flush=True)
        if taken[route] != 2 or sum(taken.values()) != 2:
            raise AssertionError(f"flash_attention_bwd {dt}: routes "
                                 f"{taken}, expected 2 on {route}")
        if not err <= FLASH_BWD_TOL[dt]:
            raise AssertionError(f"flash_attention_bwd {bh, sq, sk, d, dt}: "
                                 f"relative error {err}")
        if dt == "bfloat16" and not mean_err <= FLASH_BWD_MEAN_TOL:
            raise AssertionError(f"flash_attention_bwd {bh, sq, sk, d, dt}: "
                                 f"mean relative error {mean_err}")
        if not same:
            raise AssertionError("flash_attention_bwd: two launches differ")
        if not lse_err <= FLASH_LSE_TOL * max(
                1.0, lse_want.abs().max().item()):
            raise AssertionError(f"flash_attention_fwd lse: {lse_err}")
        del args, got, again, want

    for dt in ("float32", "bfloat16"):
        b, s, hq, hkv, d = 2, 256, 4, 2, 96
        leaves = [torch.randn(shape, generator=gen, device="cuda").to(
            getattr(torch, dt)) for shape in ((b, s, hq, d), (b, s, hkv, d),
                                              (b, s, hkv, d))]
        w = torch.randn((b, s, hq, d), generator=gen, device="cuda")

        def grads(fn):
            q, k, v = (t.clone().requires_grad_(True) for t in leaves)
            return torch.autograd.grad((fn(q, k, v).float() * w).sum(),
                                       (q, k, v))

        def plain(q, k, v):
            k, v = _repeat_kv_heads(k, hq), _repeat_kv_heads(v, hq)

            def fold(t):
                return t.transpose(1, 2).reshape(b * hq, s, d)
            o = fa.flash_attention_fwd_plain(fold(q), fold(k), fold(v),
                                             causal=True).to(q.dtype)
            return o.reshape(b, hq, s, d).transpose(1, 2)
        got = grads(lambda q, k, v: _flash_attention(q, k, v, causal=True))
        err = _bwd_err(got, grads(plain))
        print(f"check _FlashCore gradients {dt} (B={b} S={s} Hq={hq} "
              f"Hkv={hkv} D={d}, causal) against autograd through the plain "
              f"forward: rel_err={err:.3e} (tolerance {FLASH_CORE_TOL[dt]})",
              flush=True)
        if not err <= FLASH_CORE_TOL[dt]:
            raise AssertionError(f"_FlashCore gradients {dt}: {err}")

    rows = []
    for per, shapes in KERNELS["flash_attention_bwd"]["shapes"].items():
        for shape in shapes:
            rows.append(_flash_bwd_row(gen, per, *shape))
    return rows


def _flash_bwd_row(gen, per, bh, sq, sk, d, dt, causal, count):
    """The backward's timed row at one shape: kernel against plain, device
    ms of the kernel, the plain version and SDPA's backward, and the bound
    at the operands' rate and at the f32 FMA rate."""
    from repro_torch.kernels import flash_attention as fa
    args, library, moved, flops = _flash_bwd_case(gen, bh, sq, sk, d,
                                                  dt, causal)

    def kernel():
        return fa.flash_attention_bwd(*args, causal=causal)

    def plain():
        return fa.flash_attention_bwd_plain(*args, causal=causal)
    got, want = kernel(), plain()
    err, mean_err = _bwd_err(got, want), _bwd_mean_err(got, want)
    abs_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    del got, want
    if not err <= FLASH_BWD_TOL[dt]:
        raise AssertionError(f"flash_attention_bwd row: {err}")
    if dt == "bfloat16" and not mean_err <= FLASH_BWD_MEAN_TOL:
        raise AssertionError(f"flash_attention_bwd row: mean {mean_err}")
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FLOPS_PER_S[dt] * 1e3
    b_ms, b_by = bound(bytes_ms, ops_ms)
    timed = {"ms": device_ms(kernel, iters=5),
             "plain_ms": device_ms(plain, iters=2),
             "library_ms": device_ms(library, iters=5)}
    row = dict(max_abs_err=abs_err, rel_err=err, mean_err=mean_err,
               bytes=moved,
               flops=flops,
               bytes_ms=bytes_ms, ops_ms=ops_ms,
               wall_ms=wall_ms(kernel, iters=5), bound_ms=b_ms,
               bound_by=b_by,
               bound_f32_simt_ms=max(bytes_ms, flops / FLOPS_PER_S[
                   "float32"] * 1e3),
               **{key: ms for key, (ms, _) in timed.items()},
               ms_source={key: src for key, (_, src) in timed.items()},
               bh=bh, sq=sq, sk=sk, d=d, dtype=dt, causal=causal,
               route="mma" if dt == "bfloat16" else "simt", per=per,
               per_step=count)
    print(f"kernel flash_attention_bwd bh={bh} sq={sq} sk={sk} d={d} "
          f"{dt} causal={causal} x{count} per {per} ({row['route']}): "
          f"rel_err={err:.3e} mean_err={mean_err:.3e} "
          f"max_abs_err={abs_err:.3e} "
          f"ms={row['ms']:.5f} "
          f"wall_ms={row['wall_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
          f"library_ms={row['library_ms']:.5f} bound_ms="
          f"{row['bound_ms']:.5f} ({b_by}, {dt}) bound_f32_simt_ms="
          f"{row['bound_f32_simt_ms']:.5f}", flush=True)
    return row


def _train_grad_check(cfg, params, batch):
    """One step's gradients at ``params`` on ``batch`` through the flash
    kernels against ``attn_impl="chunked"``'s, leaf by leaf. Returns the
    two losses and, for the leaf whose relative difference is largest, its
    path, that ratio (the L2 norm of the difference over the chunked
    gradient's) and the cosine of the two gradients."""
    import dataclasses

    import torch
    from repro_torch.core import tree
    from repro_torch.train.step import value_and_grad

    loss, _, grads = value_and_grad(cfg, params, batch)
    paths = []
    tree.map_with_path(lambda p, x: paths.append("/".join(p)), grads)
    got = tree.leaves(grads)
    del grads
    ref_loss, _, ref = value_and_grad(
        dataclasses.replace(cfg, attn_impl="chunked"), params, batch)
    worst = dict(rel_l2=-1.0)
    for path, g, r in zip(paths, got, tree.leaves(ref), strict=True):
        g, r = g.float(), r.float()
        rel = ((g - r).norm() / r.norm().clamp(min=1e-30)).item()
        if rel > worst["rel_l2"]:
            cos = (g * r).sum() / (g.norm() * r.norm()).clamp(min=1e-30)
            worst = dict(leaf=path, rel_l2=rel, cosine=cos.item())
    del got, ref
    return dict(loss=loss.item(), chunked_loss=ref_loss.item(), **worst)


def _train_split(prof):
    """One profiled step's device time by kind: the flash forward
    (recompute included), the flash backward, the GEMMs (cuBLAS's), and
    the rest; with each kind's launches. Also the backward's launches and
    device ms by kernel name (``flash_bwd_..._kernel<...>``)."""
    split = {name: [0, 0.0] for name, _ in TRAIN_SPLIT_WORDS}
    split["rest"] = [0, 0.0]
    bwd = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if not us > 0 or SPIN_KERNEL in e.key:
            continue
        kind = next((name for name, words in TRAIN_SPLIT_WORDS
                     if any(w in e.key for w in words)), "rest")
        split[kind][0] += e.count
        split[kind][1] += us / 1e3
        if kind == "flash_bwd":
            m = re.search(r"flash_bwd_\w+_kernel(<[^>(]*>)?", e.key)
            name = m.group(0) if m else e.key
            got = bwd.setdefault(name, {"launches": 0, "device_ms": 0.0})
            got["launches"] += e.count
            got["device_ms"] += us / 1e3
    return {k: {"launches": n, "device_ms": ms} for k, (n, ms)
            in split.items()}, bwd


def ptxas_report(log: str):
    """Registers and spills of each flash backward kernel from an nvcc
    ``-Xptxas -v`` log: [{kernel, dtype, d, registers, spill_stores,
    spill_loads}], one an instantiation."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name = re.search(r"flash_bwd_[a-z_]+?_kernel", mangled)
            cur = None
            if name:
                d = re.search(r"Li(\d+)E", mangled)
                cur = dict(kernel=name.group(0),
                           dtype="bfloat16" if "bfloat16" in mangled
                           or "mma" in name.group(0) else "float32",
                           d=int(d.group(1)) if d else None,
                           registers=None, spill_stores=None,
                           spill_loads=None)
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def train_run(ckpt_dir: str):
    """(ModelConfig, RunConfig) of phase 19b: phi3-mini at its published
    widths, bf16, flash, full remat, TRAIN_BATCH rows of TRAIN_SEQ tokens,
    TRAIN_STATE_DTYPE moments, TRAIN_STEPS steps from TRAIN_SEED. No
    checkpoint between steps: the one full-depth save is the last step's,
    timed; the resume check runs at TRAIN_RESUME_LAYERS."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import (
        OptimizerConfig, RunConfig, ShapeConfig)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="bfloat16",
                              param_dtype="bfloat16", quant="none",
                              attn_impl="flash", remat="full")
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("train_4k_b2", TRAIN_SEQ, TRAIN_BATCH,
                                      "train"),
                    optimizer=OptimizerConfig(lr=1e-4, warmup_steps=2,
                                              total_steps=100,
                                              state_dtype=TRAIN_STATE_DTYPE),
                    seed=TRAIN_SEED, steps=TRAIN_STEPS, checkpoint_every=0,
                    checkpoint_dir=ckpt_dir)
    return cfg, run


def train_phase(bwd_log: str):
    """Phase 19: 19a the kernels (``train_kernel_checks``), after the
    backward's registers and spills from its build log ``bwd_log``
    (``ptxas_report``); 19b phi3-mini
    at full width through ``Trainer``: TRAIN_STEPS steps and one timed
    checkpoint after the last into a temporary directory (finite losses;
    the flash backward launched once a layer a step; step ms by CUDA
    events, tokens a second, peak memory; step_4 loaded back bit for bit,
    timed; one more step profiled: the device split; J a step at the
    power limit; that step's gradients against chunked attention's
    within TRAIN_GRAD_TOL, and the loss on its batch falling over
    TRAIN_DESCENT_STEPS steps), then at TRAIN_RESUME_LAYERS layers a
    continuous run with a checkpoint every TRAIN_CKPT_EVERY steps and a
    fresh ``Trainer`` restored from its step_2 rerunning steps 2-3 within
    TRAIN_RESUME_TOL; 19d training over a mesh (``train_mesh_phase``);
    19c the CLI: whisper-tiny at full width, 4 steps, prints ``final:``.
    Returns (the kernel rows, the main path's launches, the phase's
    launches, its summary)."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import energy, tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import Trainer

    counted = {"flash_attention_fwd": fa.flash_attention_fwd,
               "flash_attention_bwd": fa.flash_attention_bwd}
    t0 = time.perf_counter()
    summary = {"memory_at_start": release_memory("train phase")}
    summary["ptxas"] = ptxas_report(bwd_log)
    for r in summary["ptxas"]:
        print(f"ptxas flash_attention_bwd {r['kernel']} {r['dtype']} "
              f"D={r['d']}: {r['registers']} registers, "
              f"{r['spill_stores']} bytes spill stores, "
              f"{r['spill_loads']} bytes spill loads", flush=True)
    if not summary["ptxas"]:
        print("ptxas flash_attention_bwd: built before this run, no report",
              flush=True)
    rows = train_kernel_checks()
    summary["kernels_s"] = time.perf_counter() - t0
    print(f"train phase 19a: {summary['kernels_s']:.1f}s", flush=True)

    t1 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg, run = train_run(ckpt_dir)
    try:
        events = []

        def mark(step):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        tr = Trainer(run, device="cuda", fault_hook=mark)
        save_s = []

        def timed_save(step, _save=tr.save):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _save(step)
            save_s.append(time.perf_counter() - t)
            return out
        tr.save = timed_save
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(counted)
        routes = dict(fa.flash_attention_bwd.launches_by_route)
        tr.train()
        mark(TRAIN_STEPS)
        torch.cuda.synchronize()
        launches = _read(counted)
        routes = {r: n - routes[r] for r, n
                  in fa.flash_attention_bwd.launches_by_route.items()}
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in tr.history]
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        print(f"train {TRAIN_ARCH}: {cfg.n_params() / 1e9:.3f} B params, "
              f"seq {TRAIN_SEQ} x batch {TRAIN_BATCH}, losses {losses}, "
              f"step_ms (CUDA events, the last step's window holds the "
              f"checkpoint saved after it) {step_ms}, host dt_s "
              f"{[h['dt_s'] for h in tr.history]}, peak_bytes {peak}, "
              f"launches {launches}, backward routes {routes}", flush=True)
        if not all(map(lambda x: x == x and abs(x) != float("inf"),
                       losses)):
            raise AssertionError(f"non-finite training losses {losses}")
        want = {"flash_attention_fwd": 2 * cfg.num_layers * TRAIN_STEPS,
                "flash_attention_bwd": cfg.num_layers * TRAIN_STEPS}
        if launches != want:
            raise AssertionError(f"training launches {launches}, expected "
                                 f"{want} (forward and its recompute, one "
                                 "backward a layer a step)")
        if routes != {"mma": want["flash_attention_bwd"], "simt": 0}:
            raise AssertionError(f"the bf16 backward's routes {routes}: "
                                 "every launch on the tensor cores")
        # only the last step saves: step 2 is the steady one
        steady_ms = step_ms[2]
        power_w = energy.card_power_limit_w(0)
        summary["train"] = dict(
            arch=TRAIN_ARCH, n_params=cfg.n_params(), seq=TRAIN_SEQ,
            batch=TRAIN_BATCH, moments=TRAIN_STATE_DTYPE, losses=losses,
            bwd_routes=routes,
            step_ms_events=step_ms, step_ms=steady_ms,
            tokens_per_s=TRAIN_SEQ * TRAIN_BATCH / (steady_ms / 1e3),
            peak_bytes=peak, power_limit_w=power_w,
            j_per_step_at_limit=power_w * steady_ms / 1e3,
            host_dt_s=[h["dt_s"] for h in tr.history],
            grad_norms=[h["grad_norm"] for h in tr.history])

        # step_4 loaded onto the card beside the live state (a template of
        # meta leaves, so nothing is overwritten) and compared byte for byte
        t2 = time.perf_counter()
        last = ckpt_lib.latest_checkpoint(ckpt_dir)
        template = tree.map_with_path(
            lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            tr.state)
        loaded, manifest = ckpt_lib.load_checkpoint(last, template,
                                                    device="cuda")
        n_bytes = 0
        for a, b in zip(tree.leaves(tr.state), tree.leaves(loaded),
                        strict=True):
            if not (a.dtype == b.dtype and torch.equal(
                    a.reshape(-1).view(torch.uint8),
                    b.reshape(-1).view(torch.uint8))):
                raise AssertionError("checkpoint round trip changed a leaf")
            n_bytes += b.numel() * b.element_size()
        del loaded, template
        summary["train"]["checkpoint_bytes"] = n_bytes
        summary["train"]["checkpoint_save_s"] = save_s[0]
        summary["train"]["checkpoint_load_s"] = time.perf_counter() - t2
        print(f"train checkpoint {os.path.basename(last)} "
              f"(cursor {manifest['cursor']}): {n_bytes / 1e9:.3f} GB "
              f"saved in {save_s[0]:.1f}s, round-trips bit for bit, "
              f"loaded in {summary['train']['checkpoint_load_s']:.1f}s",
              flush=True)
        shutil.rmtree(last)

        batch = tr.stream.batch_at(TRAIN_STEPS)
        tr._step_fn(tr.state, batch)          # warm, outside the window
        torch.cuda.synchronize()
        # a window whose flash launches differ from the step's lost kernel
        # records and is profiled again (a step's launches are fixed)
        want = {"flash_bwd": 3 * cfg.num_layers,
                "flash_fwd": 2 * cfg.num_layers}
        want_bwd = {name: cfg.num_layers for name in TRAIN_BWD_KERNELS}
        for attempt in range(REPLAY_PROFILES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _open_window()
                tr.state, _ = tr._step_fn(tr.state, batch)
                torch.cuda.synchronize()
            split, bwd_kernels = _train_split(prof)
            del prof
            seen = {k: split[k]["launches"] for k in want}
            if seen == want:
                break
            print(f"train step: flash launches {seen} in profiled window "
                  f"{attempt + 1}, expected {want}; profiling again",
                  flush=True)
        device = sum(v["device_ms"] for v in split.values())
        bwd_ms = split["flash_bwd"]["device_ms"]
        row = rows[0]
        summary["train"].update(
            device_split=split, device_ms=device,
            flash_bwd_ms_a_step=bwd_ms,
            flash_bwd_bound_ms_a_step=row["bound_ms"] * row["per_step"],
            flash_bwd_bound_f32_simt_ms_a_step=row["bound_f32_simt_ms"]
            * row["per_step"],
            flash_bwd_library_ms_a_step=row["library_ms"] * row["per_step"])
        print(f"train step device split (torch.profiler, one step): "
              f"{json.dumps(split)}; device_ms={device:.3f}; flash backward "
              f"{bwd_ms:.3f} ms a step against its bound "
              f"{row['bound_ms'] * row['per_step']:.3f} ms (bf16) and "
              f"the library's {row['library_ms'] * row['per_step']:.3f} ms",
              flush=True)
        if seen != want:
            raise AssertionError(f"profiled step's flash kernels {split}: "
                                 "expected 3 backward kernels and 2 forward "
                                 "launches a layer")
        by_word = {w: sum(k["launches"] for name, k in bwd_kernels.items()
                          if name.split("<")[0] == w)
                   for w in TRAIN_BWD_KERNELS + TRAIN_BWD_SIMT}
        summary["train"]["bwd_kernels"] = bwd_kernels
        print(f"train step flash backward kernels (profiled step): "
              f"{json.dumps(bwd_kernels)}", flush=True)
        if {w: by_word[w] for w in TRAIN_BWD_KERNELS} != want_bwd or any(
                by_word[w] for w in TRAIN_BWD_SIMT):
            raise AssertionError(f"profiled step's backward kernels "
                                 f"{bwd_kernels}: expected {want_bwd} and "
                                 f"no SIMT kernel")

        # is the step right? its gradients against attn_impl="chunked"'s,
        # then TRAIN_DESCENT_STEPS steps on that one batch at the
        # reference's lr: the loss must fall
        t4 = time.perf_counter()
        grad_check = _train_grad_check(cfg, tr.state.params, batch)
        print(f"train gradients, flash against chunked attention at full "
              f"width (one step, the worst leaf): {json.dumps(grad_check)} "
              f"(tolerance {TRAIN_GRAD_TOL})", flush=True)
        if not grad_check["rel_l2"] <= TRAIN_GRAD_TOL:
            raise AssertionError(f"training gradients: {grad_check}")
        descent_fn = make_train_step(cfg, dataclasses.replace(
            run.optimizer, lr=TRAIN_DESCENT_LR, warmup_steps=0))
        descent = []
        for _ in range(TRAIN_DESCENT_STEPS):
            tr.state, m = descent_fn(tr.state, batch)
            descent.append(float(m["loss"]))
        print(f"train descent: {TRAIN_DESCENT_STEPS} steps on one batch at "
              f"lr {TRAIN_DESCENT_LR}: losses {descent}", flush=True)
        if not all(a > b for a, b in zip(descent, descent[1:])):
            raise AssertionError(f"the loss on one fixed batch did not fall "
                                 f"at every step: {descent}")
        summary["train"].update(grad_check=grad_check,
                                descent_losses=descent,
                                check_s=time.perf_counter() - t4)
        history = list(tr.history)
        # timed_save holds a bound method of tr: both go, or the state
        # stays on the card through 19d
        del tr, batch, timed_save
        release_memory("train resume")

        # the resume check at phi3's width cut to TRAIN_RESUME_LAYERS: a
        # continuous run with a checkpoint every TRAIN_CKPT_EVERY steps,
        # then a fresh Trainer restores step_2 (the continuous run's last
        # checkpoint is moved out of its way) and reruns steps 2-3
        t5 = time.perf_counter()
        cut = dataclasses.replace(
            run, model=dataclasses.replace(cfg,
                                           num_layers=TRAIN_RESUME_LAYERS),
            checkpoint_every=TRAIN_CKPT_EVERY,
            checkpoint_dir=os.path.join(ckpt_dir, "resume"))
        tr1 = Trainer(cut, device="cuda")
        tr1.train()
        cut_losses = [h["loss"] for h in tr1.history]
        del tr1
        shutil.rmtree(ckpt_lib.latest_checkpoint(cut.checkpoint_dir))
        tr2 = Trainer(cut, device="cuda")
        tr2.train()
        resumed = {h["step"]: h["loss"] for h in tr2.history}
        print(f"train resume ({TRAIN_RESUME_LAYERS} layers) from step_2: "
              f"losses {resumed} against the continuous run's "
              f"{cut_losses[2:]}", flush=True)
        if sorted(resumed) != [2, 3]:
            raise AssertionError(f"resumed steps {sorted(resumed)}")
        for s in (2, 3):
            if not abs(resumed[s] - cut_losses[s]) <= TRAIN_RESUME_TOL * \
                    abs(cut_losses[s]):
                raise AssertionError(f"resumed loss at step {s}: "
                                     f"{resumed[s]} vs {cut_losses[s]}")
        summary["train"].update(resume_layers=TRAIN_RESUME_LAYERS,
                                resume_losses=cut_losses,
                                resumed_losses=[resumed[2], resumed[3]],
                                resume_s=time.perf_counter() - t5)
        del tr2
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    summary["trainer_s"] = time.perf_counter() - t1
    print(f"train phase 19b: {summary['trainer_s']:.1f}s", flush=True)

    mesh_launches, summary["mesh"] = train_mesh_phase(cfg, run, history,
                                                      counted)
    axis_launches, summary["model_axis"] = train_model_axis_phase(
        cfg, run, history, counted)
    moe_launches, summary["moe_mesh"] = train_moe_phase(counted)
    release_memory("train cli")

    t3 = time.perf_counter()
    cli_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    before = _read(counted)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(["--arch", "whisper-tiny", "--full",
                                 "--steps", "4", "--ckpt-every", "2",
                                 "--ckpt-dir", cli_dir])
        text = buf.getvalue().strip()
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    cli = {k: v - before[k] for k, v in _read(counted).items()}
    print(f"train cli (whisper-tiny --full, 4 steps): rc={rc} "
          f"{text.splitlines()[-1] if text else ''}; launches {cli}",
          flush=True)
    if rc != 0 or not text.splitlines()[-1].startswith("final:"):
        raise AssertionError(f"training CLI: rc={rc}, output {text!r}")
    summary["cli_s"] = time.perf_counter() - t3
    total = {k: launches[k] + mesh_launches[k] + axis_launches[k]
             + moe_launches[k] + cli[k] for k in counted}
    print(f"train phase: {time.perf_counter() - t0:.1f}s; launches {total}",
          flush=True)
    return rows, launches, total, summary


def _timed(module, name: str, times: dict):
    """``module.name`` wrapped to add the device time between CUDA events
    recorded around each call to ``times[name]``; returns the original."""
    import torch
    real = getattr(module, name)

    def timed(*args, **kwargs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = real(*args, **kwargs)
        b.record()
        times.setdefault(name, []).append((a, b))
        return out
    setattr(module, name, timed)
    return real


def train_mesh_phase(cfg, run, history, counted):
    """Phase 19d: ``Trainer(mesh=)`` over ``make_smoke_mesh`` of four
    entries of the card, (2, 2) data x model, on 19b's model, optimizer,
    seed and batches (each data shard one row): TRAIN_MESH_STEPS steps
    whose losses and gradient norms equal 19b's within TRAIN_RESUME_TOL,
    every block's attention and FFN split over the model shards, every
    flash backward launch on the tensor cores; step ms (CUDA events),
    tokens a second, peak memory, the state's bytes by logical entry and
    by the card; one more step with the per-layer gathers, the partial
    sums, the shards' forward and backward, the reduce and the update
    timed by CUDA events around each; one profiled step (the device split,
    and each (data, model) shard's flash launches); then the elastic
    round trip at
    TRAIN_ROUND_TRIP_LAYERS layers: one mesh step, its whole-leaf
    checkpoint restored unsharded and onto a (4, 1) mesh, bit for bit.
    The Trainer's own saves are skipped here (19b times the full-depth
    one). Returns (the phase's launches, its summary)."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import energy, tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import Mesh, make_smoke_mesh
    from repro_torch.models import transformer
    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    release_memory("train mesh")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_smoke_mesh([dev] * 4)
    shards = len(mesh.batch_devices())
    model_shards = mesh.shape["model"]
    layers = cfg.num_layers
    mrun = dataclasses.replace(run, steps=TRAIN_MESH_STEPS)
    events = []

    def mark(step):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    tr = Trainer(mrun, mesh=mesh, fault_hook=mark)
    tr.save = lambda step: None
    tr._init_or_restore()
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _read(counted)
    routes = dict(fa.flash_attention_bwd.launches_by_route)
    blocks_before = collections.Counter(rules.TP_BLOCKS)
    tr.train()
    mark(TRAIN_MESH_STEPS)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _read(counted).items()}
    routes = {r: n - routes[r] for r, n
              in fa.flash_attention_bwd.launches_by_route.items()}
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = [h["loss"] for h in tr.history]
    norms = [h["grad_norm"] for h in tr.history]
    by_entry = rules.entry_bytes(tr.state, tr.specs, mesh)
    stored = sum(t.numel() * t.element_size() for t in tree.leaves(tr.state))
    blocks = {f"{k}: {why}": n for (k, why), n in
              (collections.Counter(rules.TP_BLOCKS) - blocks_before).items()}
    layout = tr.tp_summary()
    print(f"train mesh blocks over 'model' ({model_shards} model shards "
          f"a data shard): layers {json.dumps(layout)}; run in "
          f"{TRAIN_MESH_STEPS} steps x {shards} data shards "
          f"{json.dumps(blocks)}", flush=True)
    if set(layout) != {"attn: split", "ffn: split", "vocab: split"} or \
            blocks != {k: n * shards * TRAIN_MESH_STEPS
                       for k, n in layout.items()}:
        raise AssertionError(f"phi3-mini's blocks over (2, 2): {layout}, "
                             f"run {blocks}: every attention and FFN, "
                             "and the vocabulary, split expected")
    print(f"train mesh {dict(mesh.shape)} over {len(mesh.physical_devices)} "
          f"card ({shards} data shards of one {TRAIN_SEQ}-token row): "
          f"losses {losses} against 19b's {[h['loss'] for h in history]}, "
          f"grad_norms {norms} against 19b's "
          f"{[h['grad_norm'] for h in history]}; step_ms (CUDA events) "
          f"{step_ms}; host dt_s {[h['dt_s'] for h in tr.history]}; "
          f"launches {launches}; backward routes {routes}; state bytes by "
          f"logical entry {by_entry}, stored on the card {stored}; init "
          f"(draw and split) {init_s:.1f}s", flush=True)
    per_step = shards * model_shards * layers
    want = {"flash_attention_fwd": 2 * per_step * TRAIN_MESH_STEPS,
            "flash_attention_bwd": per_step * TRAIN_MESH_STEPS}
    if launches != want:
        raise AssertionError(f"mesh training launches {launches}, expected "
                             f"{want} (each (data, model) shard's forward "
                             "and its recompute, one backward a layer a "
                             "(data, model) shard)")
    if routes != {"mma": want["flash_attention_bwd"], "simt": 0}:
        raise AssertionError(f"the mesh step's backward routes {routes}")
    for s, h in enumerate(tr.history):
        for key in ("loss", "grad_norm"):
            got, ref = h[key], history[s][key]
            if not abs(got - ref) <= TRAIN_RESUME_TOL * abs(ref):
                raise AssertionError(f"mesh step {s} {key} {got} against "
                                     f"19b's {ref}")

    # one more step with its phases timed between CUDA events: the
    # per-layer gathers and the partial sums run inside the shards'
    # forward and backward (_shard_grads), and are also timed alone
    times = {}
    patched = [(module, name, _timed(module, name, times))
               for module, name in ((rules, "gather_part"),
                                    (transformer, "sum_partials"),
                                    (step_lib, "_shard_grads"),
                                    (step_lib, "reduce_grads"),
                                    (step_lib, "adamw_update_split"))]
    try:
        batch = tr.stream.batch_at(TRAIN_MESH_STEPS)
        mark(None)
        tr.state, _ = tr._step_fn(tr.state, batch)
        mark(None)
        torch.cuda.synchronize()
    finally:
        for module, name, real in patched:
            setattr(module, name, real)
    timed_ms = events[-2].elapsed_time(events[-1])
    phases = {name: sum(a.elapsed_time(b) for a, b in pairs)
              for name, pairs in times.items()}
    phase_calls = {name: len(pairs) for name, pairs in times.items()}
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v - before[k] for k, v in _read(counted).items()}

    # one profiled step: the device split and each shard's flash kernels
    batch = tr.stream.batch_at(TRAIN_MESH_STEPS + 1)
    want_prof = {"flash_bwd": 3 * per_step, "flash_fwd": 2 * per_step}
    for attempt in range(REPLAY_PROFILES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _open_window()
            tr.state, _ = tr._step_fn(tr.state, batch)
            torch.cuda.synchronize()
        split, bwd_kernels = _train_split(prof)
        del prof
        seen = {k: split[k]["launches"] for k in want_prof}
        if seen == want_prof:
            break
        print(f"train mesh step: flash launches {seen} in profiled window "
              f"{attempt + 1}, expected {want_prof}; profiling again",
              flush=True)
    launches = {k: v - before[k] for k, v in _read(counted).items()}
    device = sum(v["device_ms"] for v in split.values())
    by_word = {w: sum(k["launches"] for name, k in bwd_kernels.items()
                      if name.split("<")[0] == w)
               for w in TRAIN_BWD_KERNELS + TRAIN_BWD_SIMT}
    power_w = energy.card_power_limit_w(0)
    steady = step_ms[-1]
    summary = dict(
        mesh=dict(mesh.shape), data_shards=shards, losses=losses,
        grad_norms=norms, ref_losses=[h["loss"] for h in history],
        ref_grad_norms=[h["grad_norm"] for h in history],
        step_ms_events=step_ms, step_ms=steady,
        tokens_per_s=TRAIN_SEQ * TRAIN_BATCH / (steady / 1e3),
        timed_step_ms=timed_ms, phases_ms=phases, phase_calls=phase_calls,
        blocks=blocks, layers_by_outcome=layout, peak_bytes=peak,
        state_bytes_by_entry=by_entry, state_bytes_stored=stored,
        device_split=split, device_ms=device, bwd_kernels=bwd_kernels,
        power_limit_w=power_w, j_per_step_at_limit=power_w * steady / 1e3,
        init_s=init_s)
    print(f"train mesh step phases (CUDA events, one step of "
          f"{timed_ms:.3f} ms; gather_part and sum_partials nested in "
          f"_shard_grads): {json.dumps(phases)}, calls "
          f"{json.dumps(phase_calls)}; peak_bytes {peak}; "
          f"step {steady:.3f} ms, "
          f"{summary['tokens_per_s']:.1f} tokens/s", flush=True)
    print(f"train mesh step device split (torch.profiler, one step): "
          f"{json.dumps(split)}; device_ms={device:.3f}; flash backward "
          f"kernels {json.dumps(bwd_kernels)}", flush=True)
    if not peak <= TRAIN_MESH_PEAK_GB * 1e9:
        raise AssertionError(f"the mesh steps' peak {peak} bytes is past "
                             f"{TRAIN_MESH_PEAK_GB} GB")
    if seen != want_prof:
        raise AssertionError(f"profiled mesh step's flash kernels {split}: "
                             "expected 3 backward kernels and 2 forward "
                             "launches a layer a (data, model) shard")
    if {w: by_word[w] for w in TRAIN_BWD_KERNELS} != {
            w: per_step for w in TRAIN_BWD_KERNELS} or any(
            by_word[w] for w in TRAIN_BWD_SIMT):
        raise AssertionError(f"profiled mesh step's backward kernels "
                             f"{bwd_kernels}")
    del tr, batch
    release_memory("train round trip")

    # the elastic round trip at TRAIN_ROUND_TRIP_LAYERS layers
    t1 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        small = dataclasses.replace(
            run, model=dataclasses.replace(
                cfg, num_layers=TRAIN_ROUND_TRIP_LAYERS),
            steps=1, checkpoint_every=0, checkpoint_dir=ckpt_dir)
        tr = Trainer(small, mesh=mesh)
        tr.train()
        whole = tr.whole_state()
        path = ckpt_lib.latest_checkpoint(ckpt_dir)
        template = tree.map_with_path(
            lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            whole)
        tall = Mesh((4, 1), ("data", "model"), [dev] * 4)
        tall_specs = rules.train_state_specs(whole, tall)
        checks = {}
        for label, kwargs, target, specs in (
                ("unsharded", dict(device=dev), None, None),
                ("(4, 1)", dict(mesh=tall, specs=tall_specs), tall,
                 tall_specs),
                ("(2, 2)", dict(mesh=mesh, specs=tr.specs), mesh,
                 tr.specs)):
            got, _ = ckpt_lib.load_checkpoint(path, template, **kwargs)
            if target is not None:
                got = rules.gather_tree(got, specs, target, dev)
            checks[label] = all(
                a.dtype == b.dtype and torch.equal(
                    a.reshape(-1).view(torch.uint8),
                    b.reshape(-1).view(torch.uint8))
                for a, b in zip(tree.leaves(got), tree.leaves(whole),
                                strict=True))
            del got
        n_bytes = sum(t.numel() * t.element_size()
                      for t in tree.leaves(whole))
        del tr, whole, template
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    summary["round_trip"] = dict(layers=TRAIN_ROUND_TRIP_LAYERS,
                                 bytes=n_bytes, bit_for_bit=checks,
                                 s=time.perf_counter() - t1)
    print(f"train mesh round trip ({TRAIN_ROUND_TRIP_LAYERS} layers, "
          f"{n_bytes / 1e9:.3f} GB): (2, 2) mesh -> whole-leaf checkpoint "
          f"-> {checks} bit for bit in {time.perf_counter() - t1:.1f}s",
          flush=True)
    if not all(checks.values()):
        raise AssertionError(f"the elastic round trip changed a leaf: "
                             f"{checks}")
    launches = {k: v - before[k] for k, v in _read(counted).items()}
    summary["launches"] = launches
    summary["s"] = time.perf_counter() - t0
    print(f"train phase 19d: {summary['s']:.1f}s; launches {launches}",
          flush=True)
    return launches, summary


def train_model_axis_phase(cfg, run, history, counted):
    """Phase 19e: one step of ``Trainer(mesh=)`` over a TRAIN_TP_MESH (1,
    4) mesh of four entries of the card, the "model" axis alone: every
    block's attention and FFN split over 4 model shards (8 of phi3-mini's
    32 heads and 2048 of its 8192 FFN columns a shard), 19b's whole batch
    on the one data shard. Its loss and gradient norm against 19b's first
    step within TRAIN_RESUME_TOL; 4 x 2 x 32 flash forward and 4 x 32
    backward launches, all on the tensor cores; its step ms (CUDA events)
    and peak memory. Returns (its launches, its summary)."""
    import dataclasses

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    release_memory("train model axis")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(TRAIN_TP_MESH, ("data", "model"),
                [dev] * (TRAIN_TP_MESH[0] * TRAIN_TP_MESH[1]))
    model_shards, layers = mesh.shape["model"], cfg.num_layers
    events = []

    def mark(step):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    tr = Trainer(dataclasses.replace(run, steps=1), mesh=mesh,
                 fault_hook=mark)
    tr.save = lambda step: None
    tr._init_or_restore()
    layout = tr.tp_summary()
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _read(counted)
    routes = dict(fa.flash_attention_bwd.launches_by_route)
    tr.train()
    mark(1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v - before[k] for k, v in _read(counted).items()}
    routes = {r: n - routes[r] for r, n
              in fa.flash_attention_bwd.launches_by_route.items()}
    step_ms = events[0].elapsed_time(events[1])
    got = tr.history[0]
    summary = dict(mesh=dict(mesh.shape), layers_by_outcome=layout,
                   loss=got["loss"], grad_norm=got["grad_norm"],
                   ref_loss=history[0]["loss"],
                   ref_grad_norm=history[0]["grad_norm"], step_ms=step_ms,
                   host_dt_s=got["dt_s"], peak_bytes=peak, launches=launches,
                   init_s=init_s)
    print(f"train model axis {dict(mesh.shape)} over one card "
          f"({model_shards} model shards, 19b's batch on one data shard): "
          f"layers {json.dumps(layout)}; loss {got['loss']} against 19b's "
          f"{history[0]['loss']}, grad_norm {got['grad_norm']} against "
          f"19b's {history[0]['grad_norm']}; step_ms (CUDA events, the "
          f"Trainer's first step) {step_ms:.3f}; host dt_s {got['dt_s']}; "
          f"peak_bytes {peak}; launches {launches}; backward routes "
          f"{routes}; init (draw and split) {init_s:.1f}s", flush=True)
    want = {"flash_attention_fwd": 2 * model_shards * layers,
            "flash_attention_bwd": model_shards * layers}
    if launches != want:
        raise AssertionError(f"model-axis step launches {launches}, "
                             f"expected {want} (each model shard's forward "
                             "and its recompute, one backward a layer a "
                             "model shard)")
    if routes != {"mma": want["flash_attention_bwd"], "simt": 0}:
        raise AssertionError(f"the model-axis step's backward routes "
                             f"{routes}")
    if layout != {"attn: split": layers, "ffn: split": layers,
                  "vocab: split": 1}:
        raise AssertionError(f"phi3-mini's blocks over {TRAIN_TP_MESH}: "
                             f"{layout}")
    for key in ("loss", "grad_norm"):
        ref = history[0][key]
        if not abs(got[key] - ref) <= TRAIN_RESUME_TOL * abs(ref):
            raise AssertionError(f"model-axis step {key} {got[key]} "
                                 f"against 19b's {ref}")
    del tr
    summary["s"] = time.perf_counter() - t0
    print(f"train phase 19e: {summary['s']:.1f}s", flush=True)
    return launches, summary


def train_moe_run(ckpt_dir: str):
    """(ModelConfig, RunConfig) of phase 19f: olmoe-1b-7b at its published
    widths cut to TRAIN_MOE_LAYERS layers, bf16, flash, full remat,
    TRAIN_MOE_BATCH rows of TRAIN_MOE_SEQ tokens, TRAIN_STATE_DTYPE
    moments, TRAIN_MOE_STEPS steps from TRAIN_SEED, no checkpoint."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import (
        OptimizerConfig, RunConfig, ShapeConfig)
    cfg = dataclasses.replace(get_config(TRAIN_MOE_ARCH),
                              num_layers=TRAIN_MOE_LAYERS, dtype="bfloat16",
                              param_dtype="bfloat16", quant="none",
                              attn_impl="flash", remat="full")
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("train_2k_b2", TRAIN_MOE_SEQ,
                                      TRAIN_MOE_BATCH, "train"),
                    optimizer=OptimizerConfig(lr=1e-4, warmup_steps=2,
                                              total_steps=100,
                                              state_dtype=TRAIN_STATE_DTYPE),
                    seed=TRAIN_SEED, steps=TRAIN_MOE_STEPS,
                    checkpoint_every=0, checkpoint_dir=ckpt_dir)
    return cfg, run


def _fwd_routes(log: dict):
    """``kernels._build.call`` wrapped to count each ``flash_attention_fwd``
    launch by the route its C entry takes (``"mma"``: bf16 operands whose
    rows lie on 16 bytes, as ``flash::rows16`` checks; else ``"simt"``);
    returns the original."""
    from repro_torch.kernels import _build
    real = _build.call

    def call(name, device, *args):
        if name == "flash_attention_fwd":
            q, k, v, bf16, *strides = args[:10]
            rows = all(p % 16 == 0 and 2 * a % 16 == 0 and 2 * b % 16 == 0
                       for p, a, b in zip((q, k, v), strides[0::2],
                                          strides[1::2]))
            log["mma" if bf16 and rows else "simt"] += 1
        return real(name, device, *args)
    _build.call = call
    return real


def train_moe_step(run, mesh, counted) -> dict:
    """Phase 19f's olmoe run: unsharded on the card where ``mesh`` is None,
    else ``Trainer(mesh=)``. Counts, over its steps, the flash launches
    (the backward's and the forward's by route), the blocks the steps ran
    (``rules.TP_BLOCKS``), the experts each ``moe._experts`` call took, and
    the bytes reported to ``op_cost.collective`` by kind (a step's); times
    each step between CUDA events; reads the peak memory. Returns them with
    each step's loss and gradient norm, the first's under "loss" and
    "grad_norm", the last step's ms under "step_ms"."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe as moe_lib
    from repro_torch.roofline import op_cost
    from repro_torch.sharding import rules
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    events = []

    def mark(step):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    tr = (Trainer(run, device="cuda", fault_hook=mark) if mesh is None
          else Trainer(run, mesh=mesh, fault_hook=mark))
    tr.save = lambda step: None
    tr._init_or_restore()
    layout = tr.tp_summary()
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _read(counted)
    routes = dict(fa.flash_attention_bwd.launches_by_route)
    blocks_before = collections.Counter(rules.TP_BLOCKS)
    fwd = {"mma": 0, "simt": 0}
    experts, coll = [], collections.Counter()
    real_experts, real_coll = moe_lib._experts, op_cost.collective

    def spy_experts(p, cfg, xe):
        experts.append(xe.shape[1])
        return real_experts(p, cfg, xe)

    def spy_coll(op, nbytes, group, what=""):
        if group > 1:
            coll[op] += int(nbytes)
        return real_coll(op, nbytes, group, what)
    moe_lib._experts, op_cost.collective = spy_experts, spy_coll
    real_call = _fwd_routes(fwd)
    try:
        tr.train()
        mark(None)
        torch.cuda.synchronize()
    finally:
        moe_lib._experts, op_cost.collective = real_experts, real_coll
        _build.call = real_call
    peak = torch.cuda.max_memory_allocated()
    steps = len(tr.history)
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    out = dict(
        mesh=None if mesh is None else dict(mesh.shape),
        loss=tr.history[0]["loss"], grad_norm=tr.history[0]["grad_norm"],
        losses=[h["loss"] for h in tr.history],
        grad_norms=[h["grad_norm"] for h in tr.history],
        step_ms=ms[-1], step_ms_events=ms,
        host_dt_s=[h["dt_s"] for h in tr.history],
        peak_bytes=peak, layers_by_outcome=layout,
        blocks={f"{k}: {why}": n for (k, why), n in
                (collections.Counter(rules.TP_BLOCKS)
                 - blocks_before).items()},
        expert_calls=dict(collections.Counter(experts)),
        collective_bytes={op: n // steps for op, n in coll.items()},
        launches={k: v - before[k] for k, v in _read(counted).items()},
        bwd_routes={r: n - routes[r] for r, n
                    in fa.flash_attention_bwd.launches_by_route.items()},
        fwd_routes=fwd, init_s=init_s)
    del tr
    out["s"] = time.perf_counter() - t0
    return out


def train_moe_phase(counted):
    """Phase 19f: olmoe-1b-7b at its published widths cut to
    TRAIN_MOE_LAYERS layers (``train_moe_run``), TRAIN_MOE_STEPS unsharded
    steps, then as many of ``Trainer(mesh=)`` over each of
    TRAIN_MOE_MESHES of the card's entries (``train_moe_step``). Gates, for
    each mesh: the first step's loss and gradient norm within
    TRAIN_RESUME_TOL of the unsharded first step's; every MoE layer's
    experts, attention and the vocabulary split (``tp_summary``), run
    TRAIN_MOE_LAYERS times a data shard a step ("moe: split") and the
    vocabulary once; every ``_experts`` call over E / M experts, one a
    model shard a MoE layer a data shard in the forward and again in the
    remat recompute; the flash forward (2 a layer a (data, model) shard a
    step) and backward (1) launches all on the tensor cores. Prints each
    run's step ms (CUDA events; the last step's is the steady one), peak
    GB, the all-to-all and all-reduce bytes a step reported to
    ``op_cost.collective``, and every step's gaps to the unsharded
    run's. Returns (the phase's launches, its summary)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.launch.mesh import Mesh

    t0 = time.perf_counter()
    release_memory("train moe")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        cfg, run = train_moe_run(ckpt_dir)
        dev = torch.device("cuda", torch.cuda.current_device())
        steps = {"unsharded": train_moe_step(run, None, counted)}
        for sizes in TRAIN_MOE_MESHES:
            release_memory(f"train moe {sizes}")
            mesh = Mesh(sizes, ("data", "model"),
                        [dev] * (sizes[0] * sizes[1]))
            steps[f"{sizes}"] = train_moe_step(run, mesh, counted)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ref = steps["unsharded"]
    n_exp, layers = cfg.moe.num_experts, cfg.num_layers
    for label, st in steps.items():
        st["gaps"] = {key: [abs(g - r) / abs(r)
                            for g, r in zip(st[key], ref[key])]
                      for key in ("losses", "grad_norms")}
        print(f"train moe {label} ({TRAIN_MOE_ARCH}, {layers} layers, "
              f"{cfg.n_params() / 1e9:.3f}e9 parameters, "
              f"{TRAIN_MOE_STEPS} steps): losses {st['losses']} "
              f"grad_norms {st['grad_norms']} (gaps to the unsharded "
              f"steps {json.dumps(st['gaps'])}); step_ms (CUDA events) "
              f"{st['step_ms_events']}; host dt_s {st['host_dt_s']}; peak "
              f"{st['peak_bytes'] / 1e9:.2f} GB; collective bytes a step "
              f"(op_cost) {json.dumps(st['collective_bytes'])}; layers "
              f"{json.dumps(st['layers_by_outcome'])}; blocks run "
              f"{json.dumps(st['blocks'])}; _experts calls by experts "
              f"{json.dumps(st['expert_calls'])}; launches "
              f"{st['launches']}; forward routes {st['fwd_routes']}; "
              f"backward routes {st['bwd_routes']}; init "
              f"{st['init_s']:.1f}s, {st['s']:.1f}s in all", flush=True)
    for label, st in steps.items():
        sizes = st["mesh"] or {"data": 1, "model": 1}
        shards, m = sizes["data"], sizes["model"]
        fwd = 2 * shards * m * layers * TRAIN_MOE_STEPS
        want = {"flash_attention_fwd": fwd,
                "flash_attention_bwd": fwd // 2}
        if st["launches"] != want or st["fwd_routes"] != {
                "mma": fwd, "simt": 0} or st["bwd_routes"] != {
                "mma": fwd // 2, "simt": 0}:
            raise AssertionError(
                f"19f {label}: flash launches {st['launches']}, forward "
                f"routes {st['fwd_routes']}, backward routes "
                f"{st['bwd_routes']}; expected {want}, all on the tensor "
                "cores")
        if st["expert_calls"] != {n_exp // m: fwd}:
            raise AssertionError(
                f"19f {label}: _experts calls by experts "
                f"{st['expert_calls']}, expected {fwd} of {n_exp // m} "
                "experts")
        if st["mesh"] is None:
            continue
        runs = shards * TRAIN_MOE_STEPS
        if st["layers_by_outcome"] != {"attn: split": layers,
                                       "moe: split": layers,
                                       "vocab: split": 1} or \
                st["blocks"] != {"attn: split": layers * runs,
                                 "moe: split": layers * runs,
                                 "vocab: split": runs}:
            raise AssertionError(
                f"19f {label}: layers {st['layers_by_outcome']}, blocks run "
                f"{st['blocks']}: every attention, MoE layer and the "
                "vocabulary split expected")
        if not st["collective_bytes"].get("all-to-all"):
            raise AssertionError(f"19f {label}: no all-to-all reported")
        for key in ("loss", "grad_norm"):
            if not abs(st[key] - ref[key]) <= TRAIN_RESUME_TOL * \
                    abs(ref[key]):
                raise AssertionError(f"19f {label} {key} {st[key]} against "
                                     f"the unsharded step's {ref[key]}")
    launches = {k: sum(st["launches"][k] for st in steps.values())
                for k in counted}
    summary = dict(arch=TRAIN_MOE_ARCH, layers=layers,
                   n_params=cfg.n_params(), seq=TRAIN_MOE_SEQ,
                   batch=TRAIN_MOE_BATCH, steps=steps, launches=launches,
                   s=time.perf_counter() - t0)
    print(f"train phase 19f: {summary['s']:.1f}s; launches {launches}",
          flush=True)
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 20: the roofline
# ---------------------------------------------------------------------------
#: the pod cell's own process may take this long past phase 20's start
DRYRUN_WAIT_S = 300
#: counted kernel FLOPs and weight bytes against the plan entries'
ROOFLINE_TOL = 1e-2
_STARTED = []


def _stop_started():
    for proc in _STARTED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_dryrun_cell():
    """Phase 20c's cell, ``whisper-tiny x train_4k`` on the pod mesh, in a
    process of its own (fake tensors on the CPU, one thread), started now
    so that its minutes of host time overlap the card's phases. Returns
    (the process, its output directory, its start on the wall clock)."""
    import atexit
    import tempfile
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    # its output to a file: a pipe nobody reads until phase 20 would stop
    # it once the pipe's buffer filled
    with open(os.path.join(out, "dryrun.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "whisper-tiny", "--shape", "train_4k", "--mesh", "pod",
             "--out", out], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=ROOT)
    if not _STARTED:
        atexit.register(_stop_started)
    _STARTED.append(proc)
    return proc, out, time.time()


def _terms(flops: float, nbytes: float) -> dict:
    """A program's roofline terms on the H100 (seconds) and its bound."""
    compute_s, memory_s = flops / H100.peak_bf16, nbytes / H100.hbm_bw
    return dict(compute_s=compute_s, memory_s=memory_s,
                bound_s=max(compute_s, memory_s),
                bound_by="operations" if compute_s > memory_s else "bytes")


def _kernel_bounds(entries) -> dict:
    """The plan entries' hand bounds of their kernels' share (the first
    ``k_main`` of each K): 2 m k n FLOPs and 1.125 bytes a Q8_0 weight
    (int8 and an f32 scale a block of 32, as ``_step_bounds``)."""
    q8 = [e for e in entries if e.dtype == "q8_0" and e.k_main]
    return dict(flops=sum(2 * e.m * e.k_main * e.n for e in q8),
                weight_bytes=sum(e.n * e.k_main * 1.125 for e in q8),
                launches=len(q8))


def _roofline_whisper(plans, measured_ms, card):
    """20a: whisper-tiny Q8_0's prefill and one step counted on fake
    weights, against phase 3's plan entries and phase 6's device
    times."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.launch import input_specs
    from repro_torch.models import model
    from repro_torch.roofline import op_cost
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("whisper-tiny")
    mode = input_specs.fake_mode()
    params = input_specs.abstract_params(
        cfg, ShapeConfig("prefill", cfg.encoder_ctx, 1, "prefill"),
        mode=mode)
    out = {}
    with mode:
        eng = ServeEngine(cfg, params, max_len=MAX_NEW + 8,
                          offload=OffloadEngine(), eos_id=None, device="cpu")
        mel = torch.zeros((1, cfg.encoder_ctx, cfg.n_mels))
        with op_cost.OpCounter() as pre:
            _, state = eng.prefill(mel)
        with op_cost.OpCounter() as step, torch.inference_mode():
            model.serve_step(eng._serve_params, cfg,
                             torch.ones((1, 1), dtype=torch.long), state,
                             engine=eng.offload)
    for name, cost in (("prefill", pre), ("step", step)):
        kern = cost.kernel_totals()
        got = dict(flops=sum(k["flops"] for k in kern.values()),
                   weight_bytes=sum(k["weight_bytes"] for k in kern.values()),
                   launches=int(sum(k["calls"] for k in kern.values())))
        want = _kernel_bounds(plans[name])
        for key in ("flops", "weight_bytes"):
            if abs(got[key] - want[key]) > ROOFLINE_TOL * want[key]:
                raise AssertionError(f"roofline whisper-tiny {name}: counted "
                                     f"kernel {key} {got[key]} against the "
                                     f"plan's {want[key]}")
        if got["launches"] != want["launches"]:
            raise AssertionError(f"roofline whisper-tiny {name}: "
                                 f"{got['launches']} kernel calls counted, "
                                 f"{want['launches']} planned")
        terms = _terms(float(cost.flops[0]), float(cost.bytes[0]))
        kterms = _terms(got["flops"], sum(k["bytes"] for k in kern.values()))
        ms = measured_ms.get(name)
        row = dict(counted_kernels=got, plan_bounds=want,
                   kernels={k: {f: v[f] for f in ("calls", "flops", "bytes")}
                            for k, v in kern.items()},
                   flops=float(cost.flops[0]),
                   matmul_flops=float(cost.matmul_flops[0]),
                   bytes=float(cost.bytes[0]), ops=int(cost.ops[0]),
                   **terms, kernel_bound_s=kterms["bound_s"],
                   measured_device_ms=ms,
                   bound_over_measured=(terms["bound_s"] * 1e3 / ms
                                        if ms else "not measured"))
        out[name] = row
        print(f"roofline whisper-tiny q8_0 {name} [{card}]: "
              f"{json.dumps(row)}", flush=True)
    return out


def _roofline_train(train_summary, card):
    """20b: phi3-mini's training step at 19b's shape counted on fake
    tensors; MFU of 19b's measured step."""
    import tempfile

    import torch
    from repro_torch.core import tree
    from repro_torch.launch import input_specs
    from repro_torch.roofline import analysis, op_cost
    from repro_torch.train.step import init_train_state, make_train_step

    with tempfile.TemporaryDirectory() as d:
        cfg, run = train_run(d)
    mode = input_specs.fake_mode()
    with mode:
        state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                 run.optimizer,
                                 max_positions=run.shape.seq_len,
                                 device="cpu")
    batch = input_specs.batch_specs_struct(cfg, run.shape, mode=mode)
    step = make_train_step(cfg, run.optimizer)
    with mode, op_cost.OpCounter() as cost:
        step(state, batch)
    mf = analysis.model_flops(cfg, run.shape)
    flops = float(cost.flops[0])
    arg = sum(t.numel() * t.element_size() for t in tree.leaves(state))
    step_ms = train_summary["train"]["step_ms"]
    row = dict(arch=cfg.name, seq=run.shape.seq_len,
               batch=run.shape.global_batch, model_flops=mf,
               counted_flops=flops,
               counted_matmul_flops=float(cost.matmul_flops[0]),
               counted_bytes=float(cost.bytes[0]),
               useful_flop_ratio=mf / flops,
               kernels={k: {f: v[f] for f in ("calls", "flops", "bytes")}
                        for k, v in cost.kernel_totals().items()},
               **_terms(flops, float(cost.bytes[0])),
               counted_peak_bytes=int(arg + cost.peak[0]),
               measured_peak_bytes=train_summary["train"]["peak_bytes"],
               measured_step_ms=step_ms,
               mfu=mf / (step_ms / 1e3 * H100.peak_bf16),
               counted_flops_per_s_share=flops / (step_ms / 1e3
                                                  * H100.peak_bf16))
    row["bound_over_measured"] = row["bound_s"] * 1e3 / step_ms
    print(f"roofline {cfg.name} train step [{card}]: {json.dumps(row)}",
          flush=True)
    return row


def _roofline_pod_cell(dry, card):
    """20c: the pod cell's process, waited for, its JSON read."""
    import shutil
    proc, out, t_start = dry
    done_before = proc.poll() is not None
    try:
        proc.wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"roofline pod cell: not done "
                             f"{DRYRUN_WAIT_S}s into phase 20 "
                             f"({time.time() - t_start:.0f}s since it "
                             "started)")
    path = os.path.join(out, "pod_16x16", "whisper-tiny__train_4k.json")
    log, text, took = os.path.join(out, "dryrun.log"), "", None
    try:
        # the log's last write is the process's last line
        took = os.path.getmtime(log) - t_start
        with open(log) as f:
            text = f.read()
        with open(path) as f:
            r = json.load(f)
    except OSError:
        r = {"status": "missing"}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if proc.returncode != 0 or r.get("status") != "ok":
        raise AssertionError(f"roofline pod cell: status {r.get('status')}, "
                             f"exit {proc.returncode}: {text[-2000:]} "
                             f"{r.get('error', '')}")
    rf, mem = r["roofline"], r["memory"]
    e = rf["entry"]
    ent = mem["entries"]
    row = dict(status=r["status"], mesh=r["mesh"], chips=rf["chips"],
               busiest_entry=e, argument_bytes=mem["argument_bytes"],
               peak_bytes=ent["peak_bytes"][e],
               flops=rf["flops_per_device"], bytes=rf["bytes_per_device"],
               collective_bytes=rf["collective_raw_bytes"],
               collective_wire_bytes=rf["collective_wire_bytes"],
               coll_by_op=rf["coll_by_op"], compute_s=rf["compute_s"],
               memory_s=rf["memory_s"], collective_s=rf["collective_s"],
               bottleneck=rf["bottleneck"],
               useful_flop_ratio=rf["useful_flop_ratio"],
               roofline_fraction=rf["roofline_fraction"],
               entries_with_work=sum(f > 0 for f in ent["flops"]),
               cell_run_s=r["run_s"], cell_build_s=r["build_s"],
               done_before_phase_20=done_before, process_s=took,
               output_tail=text[-300:])
    print(f"roofline dry-run whisper-tiny x train_4k pod [{card}]: "
          f"{json.dumps(row)}", flush=True)
    return row


def roofline_phase(dry, plans, measured_ms, train_summary, card):
    """Phase 20 (the module docstring): 20a, 20b, 20c in turn."""
    t0 = time.perf_counter()
    out = dict(whisper=_roofline_whisper(plans, measured_ms, card),
               train=_roofline_train(train_summary, card))
    out["ac_s"] = time.perf_counter() - t0
    out["pod_cell"] = _roofline_pod_cell(dry, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"roofline phase: {out['phase_s']:.1f}s [{card}]", flush=True)
    return out


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
    start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    dry = start_dryrun_cell()
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

    t0 = time.perf_counter()
    records = check_kernels()
    print(f"kernels phase: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
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
    print(f"main paths phase (3-8): {time.perf_counter() - t0:.1f}s",
          flush=True)

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
             {"prefill": {"q8_wgmma_kernel": 32, "bf16_cvt_tc_kernel": 1},
              "step": {"q8_matvec_kernel": 33}}, "q8_0", FIRST_STEP_TOL),
            ("dense+flash", (d_eng, d_mel, d_tokens, d_split),
             {"bf16_matmul": 33 + 33 * MAX_NEW, "flash_attention_fwd": 4,
              "q8_matmul": 0, "q8_matvec": 0},
             {"bf16_matmul": 33 + 33, "flash_attention_fwd": 4},
             {"prefill": {"wgmma_kernel": 32, "bf16_cvt_tc_kernel": 1,
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

    path_launches["speculative"], spec_summary, spec_params = \
        speculative_phase(counted, tiny_power)
    print(f"speculative summary: {json.dumps(spec_summary)}", flush=True)

    t0 = time.perf_counter()
    path_launches["telemetry"] = telemetry_gate(q8_eng, counted)
    for name, n in telemetry_drives(q8_eng, counted).items():
        path_launches["telemetry"][name] += n
    print(f"telemetry phase: {time.perf_counter() - t0:.1f}s; launches "
          f"{path_launches['telemetry']}", flush=True)

    path_launches["sharded"], shard_summary = sharded_phase(
        q8_eng, d_eng, counted, slot4, spec_params)
    print(f"sharded summary: {json.dumps(shard_summary)}", flush=True)
    del spec_params

    # phase 20a's plans and device times, kept past the whisper engines
    q8_plans = {phase: q8_eng._plans.plans[q8_eng._key(
        phase, 1, q8_eng.cfg.encoder_ctx)].entries
        for phase in ("prefill", "step")}
    q8_device_ms = {"prefill": q8_captured.get("prefill_device_ms"),
                    "step": q8_captured.get("decode_device_ms_per_step")}
    # the whisper engines' buffers and graph pools, freed before the LMs
    del q8_eng, d_eng, q8_mel, d_mel
    release_memory("lm phases")
    path_launches["lm"], lm_summary = lm_phase(counted)
    for name, n in lm_summary.pop("sharded_launches").items():
        path_launches["sharded"][name] += n
    print(f"lm summary: {json.dumps(lm_summary)}", flush=True)
    release_memory("moe phase")
    path_launches["moe"], moe_summary = moe_phase(counted)
    print(f"moe summary: {json.dumps(moe_summary)}", flush=True)
    release_memory("ssm phase")
    path_launches["ssm"], ssm_summary = ssm_phase(counted)
    print(f"ssm summary: {json.dumps(ssm_summary)}", flush=True)
    path_launches["forward"], path_launches["vlm"], fwd_summary = \
        forward_phase(counted)
    print(f"forward summary: {json.dumps(fwd_summary)}", flush=True)
    t0 = time.perf_counter()
    for name, rows in check_kernels(late=True).items():
        records[name] += rows
    print(f"late kernel rows: {time.perf_counter() - t0:.1f}s", flush=True)
    records["flash_attention_bwd"], train_main, path_launches["train"], \
        train_summary = train_phase(logs.get("flash_attention_bwd", ""))
    # a new dict: path_launches["main"] keeps the whisper main path's
    launches = dict(launches,
                    flash_attention_bwd=train_main["flash_attention_bwd"])
    print(f"train summary: {json.dumps(train_summary)}", flush=True)
    roofline = roofline_phase(dry, q8_plans, q8_device_ms, train_summary,
                              card)
    print(f"roofline summary: {json.dumps(roofline)}", flush=True)

    kernels = []
    for name, meta in KERNELS.items():
        rows = records[name]

        summed = meta.get("summed", SUMMED)

        def total(key, per=None):   # over one prefill and/or decode step
            return sum(r[key] * r["per_step"] for r in rows
                       if r["per"] == per or (per is None
                                              and r["per"] in summed))
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
            per=" + one ".join(p for p in meta["shapes"] if p in summed),
            ms_source={key: sorted({r["ms_source"][key] for r in rows})
                       for key in ("ms", "plain_ms", "library_ms", *extras)},
            tuned_launches=tuned_launches.get(name, 0),
            launches_by_path={path: got.get(name, 0)
                              for path, got in path_launches.items()},
            tiles=tile_records.get(name, []),
            **({"ptxas": train_summary["ptxas"],
                "device_kernels": train_summary["train"]["bwd_kernels"]}
               if name == "flash_attention_bwd" else {}),
            **{key: total(key) for key in extras},
            by_phase={per: {key: total(key, per) for key in (
                "ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms",
                *extras)}
                for per in meta["shapes"]},
            shapes=rows))
    print(f"chip_smoke total: {time.perf_counter() - start:.1f}s",
          flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
