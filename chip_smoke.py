#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device and builds its
own kernels with nvcc. Phases, each of which fails the run on error:

1. The card's name and power limit (nvidia-smi), then the build of every
   kernel from ``src/repro_torch/csrc/`` (one nvcc per source, started
   together), with the ``-Xptxas -v`` register and shared-memory report.
2. Each kernel at every shape the main path gives it: its result against
   its plain PyTorch version on the card, its device time (torch.profiler,
   warm L2) and its back-to-back time per call (CUDA events, which include
   the host's launch cost), the plain version's device time, the least
   time the card could take (the larger of bytes over 3.35 TB/s and FLOPs
   over the peak for x's type: 989 TFLOP/s for bf16 x, whose product with
   int8 weights is exact on the tensor cores, 67 TFLOP/s for f32 x), and
   ``torch.matmul`` against the pre-dequantized f32 weight as a library
   yardstick (no single PyTorch call computes a Q8_0 product).
3. The main path: full-width whisper-tiny with Q8_0 weights from a seeded
   generator, ``ServeEngine.transcribe`` of one 1500-frame utterance with
   ``max_new=32`` and no EOS, through the offload engine. The kernels'
   launch counts are zeroed just before and read just after: exactly 32
   ``q8_matmul`` launches (the prefill) and 33 ``q8_matvec`` launches per
   decode step. Then the same weights and mel run through the port on the
   CPU, and the first decode step's logits must agree with the card's.
4. Batch 2 at full width, where the encoder's ffn.down (M = 3000, K = 1536)
   fails the reference's local-memory rule (``offload=False`` in its plan
   entries): every Q8_0 linear must still launch a kernel.

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
KERNELS = {
    "q8_matvec": dict(source="src/repro_torch/csrc/q8_matvec.cu",
                      replaces="src/repro/kernels/q8_matvec.py:68",
                      shapes=MATVEC_SHAPES),
    "q8_matmul": dict(source="src/repro_torch/csrc/q8_matmul.cu",
                      replaces="src/repro/kernels/q8_matmul.py:87",
                      shapes=MATMUL_SHAPES),
}
MAX_NEW = 32


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


def device_us(prof) -> float:
    """Summed device time (µs) of every kernel and copy a profile saw.
    Raises if the profiler saw none: a wall-clock time is not a device
    time."""
    total = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages())
    if not total > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the card's own time in the kernels one call
    launches (torch.profiler, CUPTI), without the host's launch cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_us(prof) / 1e3 / iters


def bound(bytes_ms: float, ops_ms: float):
    """Least time of work whose bytes take ``bytes_ms`` at the memory rate
    and whose operations take ``ops_ms`` at the peak for their type: the
    larger of the two. Returns (ms, 'bytes'|'operations')."""
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


def check_kernels():
    """Phase 2: every kernel against its plain version at the main path's
    shapes, with its times and bound. Returns the per-kernel records."""
    import torch
    from repro_torch.core.qformats import QTensor, quantize_q8_0
    from repro_torch.kernels import q8_matmul, q8_matvec

    mods = {"q8_matvec": (q8_matvec.q8_matvec, q8_matvec.q8_matvec_plain),
            "q8_matmul": (q8_matmul.q8_matmul, q8_matmul.q8_matmul_plain)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    for name, meta in KERNELS.items():
        kernel, plain = mods[name]
        rows = []
        for m, n, k, k_full, count, xdt in meta["shapes"]:
            dtype = getattr(torch, xdt)
            x_full = torch.randn((m, k_full), generator=gen, device="cuda"
                                 ).to(dtype)
            w = torch.randn((n, k_full), generator=gen, device="cuda") * 0.05
            wq = quantize_q8_0(w)
            main = QTensor(wq.qs[:, :k // 32], wq.scales[:, :k // 32])
            x, qs, sc = x_full[:, :k], main.flat_qs(), main.scales
            got = kernel(x, qs, sc)
            want = plain(x, qs, sc)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-4 * max(1.0, want.abs().max().item())
            if not err <= tol:
                raise AssertionError(f"{name} {m}x{n}x{k}: max |kernel - "
                                     f"plain| = {err} > {tol}")
            w_deq = (main.qs.float() * main.scales[..., None]
                     ).reshape(n, k).contiguous()
            x32 = x.float().contiguous()
            # each input read once (x, int8 qs, f32 scales), output written once
            moved = (m * k * x.element_size() + n * k + (n * k // 32) * 4
                     + m * n * 4)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * m * n * k / FLOPS_PER_S[xdt] * 1e3
            b_ms, b_by = bound(bytes_ms, ops_ms)
            row = dict(m=m, n=n, k=k, x=xdt, per_step=count, max_abs_err=err,
                       bytes=moved, flops=2 * m * n * k,
                       bytes_ms=bytes_ms, ops_ms=ops_ms,
                       ms=device_ms(lambda: kernel(x, qs, sc)),
                       wall_ms=wall_ms(lambda: kernel(x, qs, sc)),
                       plain_ms=device_ms(lambda: plain(x, qs, sc)),
                       library_ms=device_ms(
                           lambda: torch.matmul(x32, w_deq.t())),
                       bound_ms=b_ms, bound_by=b_by)
            print(f"kernel {name} m={m} n={n} k={k} x={xdt} x{count}: "
                  f"max_abs_err={err:.3e} ms={row['ms']:.5f} "
                  f"wall_ms={row['wall_ms']:.5f} "
                  f"plain_ms={row['plain_ms']:.5f} "
                  f"library_ms(torch.matmul, dequantized f32 W)="
                  f"{row['library_ms']:.5f} bound_ms={b_ms:.5f} ({b_by})",
                  flush=True)
            rows.append(row)
        records[name] = rows
    return records


def check_against_cpu(cfg, params_cpu, mel, card_logits, sot):
    """The first decode step's logits on the CPU, same weights and mel,
    against the card's; the greedy token must agree wherever the CPU's
    top-1/top-2 margin exceeds twice the tolerance. Tolerance
    FIRST_STEP_TOL: whisper-tiny runs its encoder in bf16, and a sum that
    differs in its last f32 bits between card and CPU can round to a
    neighbouring bf16 value (a relative step of 2^-8) and carry through
    the layers; logits are of O(1)."""
    import torch
    from repro_torch.core.offload import OffloadEngine
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params_cpu, max_len=MAX_NEW + 8,
                      offload=OffloadEngine(), eos_id=None, device="cpu")
    _, state = eng.prefill(torch.from_numpy(mel))
    cpu_logits, _ = eng.step(torch.full((1, 1), sot), state)
    diff = (card_logits.cpu() - cpu_logits).abs().max().item()
    print(f"first step logits card vs cpu: max_abs_err={diff:.3e} "
          f"(tolerance {FIRST_STEP_TOL}), |logits|max="
          f"{cpu_logits.abs().max().item():.3f}", flush=True)
    if not diff <= FIRST_STEP_TOL:
        raise AssertionError(f"card and CPU first-step logits differ by {diff}")
    top2 = cpu_logits[0, -1, :cfg.vocab_size].topk(2).values
    if (top2[0] - top2[1]).item() > 2 * FIRST_STEP_TOL and int(
            cpu_logits[0, -1, :cfg.vocab_size].argmax()) != int(
            card_logits[0, -1, :cfg.vocab_size].argmax()):
        raise AssertionError("card and CPU pick different first tokens")
    return diff


def where_time_goes(eng, mel, vocab: int, steps: int = 8):
    """One prefill and ``steps`` decode steps under torch.profiler: device
    time (summed kernel time) against host wall time, the device's idle
    share, and the decode step's largest kernels."""
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
    tok = torch.full((1, 1), 1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, state = eng.step(tok, state)
            tok = logits[:, -1, :vocab].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        dec_wall = (time.perf_counter() - t0) * 1e3 / steps
    dec_dev = device_us(prof) / 1e3 / steps
    top = sorted(prof.key_averages(),
                 key=lambda e: getattr(e, "self_device_time_total", 0.0),
                 reverse=True)[:8]
    out = dict(prefill_wall_ms=pre_wall, prefill_device_ms=pre_dev,
               prefill_idle_share=1 - pre_dev / pre_wall,
               decode_wall_ms_per_step=dec_wall,
               decode_device_ms_per_step=dec_dev,
               decode_idle_share=1 - dec_dev / dec_wall,
               decode_top_kernels=[
                   (e.key[:80], e.count // steps,
                    getattr(e, "self_device_time_total", 0.0) / 1e3 / steps)
                   for e in top])
    print(f"where the time goes (profiled): {json.dumps(out)}", flush=True)
    return out


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
    eng.transcribe(mel, max_new=2)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    q8_matmul.q8_matmul.launches = 0
    q8_matvec.q8_matvec.launches = 0
    res = eng.transcribe(mel, max_new=MAX_NEW)
    launches = {"q8_matmul": q8_matmul.q8_matmul.launches,
                "q8_matvec": q8_matvec.q8_matvec.launches}
    peak = torch.cuda.max_memory_allocated()
    r = res[0]
    print(f"main path: whisper-tiny q8_0 transcribe 1x{cfg.encoder_ctx} "
          f"frames, {r.steps} tokens: prefill_ms={r.prefill_s * 1e3:.3f} "
          f"decode_ms_per_token={r.decode_s * 1e3 / r.steps:.3f} "
          f"peak_mem_bytes={peak} launches={launches}", flush=True)
    print(f"main path tokens: {r.tokens}", flush=True)
    if r.steps != MAX_NEW or len(r.tokens) != MAX_NEW:
        raise AssertionError(f"expected {MAX_NEW} tokens, got {r.steps}")
    if not all(0 <= t < cfg.vocab_size for t in r.tokens):
        raise AssertionError("token outside the vocabulary")
    if launches != {"q8_matmul": 32, "q8_matvec": 33 * MAX_NEW}:
        raise AssertionError(f"launch counts {launches}: expected 32 "
                             f"q8_matmul and {33 * MAX_NEW} q8_matvec")

    sot = 1
    _, state = eng.prefill(torch.from_numpy(mel).cuda())
    card_logits, _ = eng.step(torch.full((1, 1), sot, device="cuda"), state)
    if not torch.isfinite(card_logits).all():
        raise AssertionError("non-finite logits on the card")
    if int(card_logits[0, -1, :cfg.vocab_size].argmax()) != r.tokens[0]:
        raise AssertionError("first-step argmax differs from transcribe")
    err = check_against_cpu(cfg, params_cpu, mel, card_logits, sot)
    split = where_time_goes(eng, mel, cfg.vocab_size)
    return launches, dict(prefill_ms=r.prefill_s * 1e3,
                          decode_ms_per_token=r.decode_s * 1e3 / r.steps,
                          peak_mem_bytes=peak, first_step_cpu_err=err,
                          **split)


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
    q8_matmul.q8_matmul.launches = q8_matvec.q8_matvec.launches = 0
    res = eng.transcribe(mel, max_new=max_new)
    torch.cuda.synchronize()
    got = {"q8_matmul": q8_matmul.q8_matmul.launches,
           "q8_matvec": q8_matvec.q8_matvec.launches}
    pre, step = (
        [e for e in eng.plans[(phase, 2, cfg.encoder_ctx)].entries
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
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    records = check_kernels()
    launches, path = main_path()
    print(f"main path summary: {json.dumps(path)}", flush=True)
    batch2_routing()

    kernels = []
    for name, meta in KERNELS.items():
        rows = records[name]

        def total(key):        # over the launches of one step or prefill
            return sum(r[key] * r["per_step"] for r in rows)
        b_ms, b_by = bound(total("bytes_ms"), total("ops_ms"))
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=total("library_ms"),
            library_call="torch.matmul(x_f32, W_dequantized_f32.T): no single "
                         "PyTorch call computes a Q8_0 product",
            per="decode step" if name == "q8_matvec" else "prefill",
            shapes=rows))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
