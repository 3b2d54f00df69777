#!/usr/bin/env python3
"""Sweep the launch configurations of the port's hand-written kernels on one
NVIDIA H100.

    python3 sweep_kernels.py [--out build/sweep/sweep.json]

Run from the root of a checkout, on a machine with a CUDA device and nvcc.
For each configuration below, the kernel's source is copied with its
``constexpr int`` configuration constants replaced (``constexpr int
kTcWarps = 4`` becomes ``... = 2``; a comment that names a constant is left
alone), built with the port's nvcc flags (one nvcc per variant, all started
together), loaded with ctypes and called through the same C interface as
the shipped library (with no tile: each launch's own choice), at the main
paths' shapes (``chip_smoke``'s
``MATMUL_SHAPES`` and ``MATVEC_SHAPES`` for the Q8_0 kernels,
``BF16_PREFILL_SHAPES``, ``BF16_STEP_SHAPES`` and ``FLASH_SHAPES`` for the
dense path's). Each result is held against the kernel's plain version (the
tolerances of chip_smoke.py) and timed on the card
(``chip_smoke.device_ms``). The first configuration of each kernel is the
shipped one. Prints one line per configuration, with its device time
summed over one prefill and over one decode step (``bf16_matmul`` has
both), and writes them all as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# per kernel: its source and the configurations to build; {} is the source
# as shipped
CONFIGS = {
    "flash_attention_fwd": ("flash_attention", [
        {},
        dict(kTcWarps=2, kTcSub=1, kTcStages=3),
        dict(kTcWarps=2, kTcSub=2, kTcStages=2),
        dict(kTcWarps=4, kTcSub=1, kTcStages=3),
        dict(kTcWarps=4, kTcSub=2, kTcStages=3),
        dict(kTcWarps=8, kTcSub=2, kTcStages=2),
    ]),
    # the prefill launch's ring depth; the decode launch's loads a lane
    # issues up front, rows a warp walks at large N, K split and warps a
    # block, and a half-warp per row
    "bf16_matmul": ("bf16_matmul", [
        {},
        dict(kTcStages=2),
        dict(kTcStages=3),
        dict(kTcStages=4),
        dict(kMvUnroll=2),
        dict(kMvUnroll=4),
        dict(kMvRows=2),
        dict(kMvRows=8),
        dict(kMvMaxSplit=2),
        dict(kMvMaxWarps=8),
        dict(kMvLanes=16),
    ]),
    # ring slots (copies run kQStages - 1 steps ahead), 64 x 64 tiles,
    # registers capped for more blocks an SM
    "q8_matmul": ("q8_matmul", [
        {},
        dict(kQStages=2),
        dict(kQStages=4),
        dict(kQBN=64),
        dict(kQBN=64, kQStages=4),
        dict(kQMinBlocks=6),
    ]),
    # rows a half-warp walks at large N, loads a lane issues up front, and
    # the K split over the warps of a block
    "q8_matvec": ("q8_matvec", [
        {},
        dict(kUnroll=4),
        dict(kRowsPerSlot=1),
        dict(kRowsPerSlot=2),
        dict(kMaxSplit=2),
        dict(kMaxWarps=8),
        dict(kMaxWarps=8, kMaxSplit=8),
    ]),
}


def variant_source(src: str, consts: dict) -> str:
    """The source with each named ``constexpr int`` constant set anew, in
    its declaration (which may declare several, ``constexpr int a = 1,
    b = 2;``); the name in a comment is not a declaration."""
    for name, value in consts.items():
        src, n = re.subn(
            rf"(\bconstexpr\s+int\s+(?:\w+\s*=\s*\d+\s*,\s*)*{name}\s*=\s*)\d+",
            rf"\g<1>{value}", src, count=1)
        if n != 1:
            raise KeyError(f"no constexpr int {name} in the source")
    return src


def tag(consts: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in consts.items()) or "shipped"


def build_all(out_dir: str):
    """Write and compile every variant; returns {(kernel, i): .so path}."""
    from repro_torch.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, (stem, configs) in CONFIGS.items():
        src = (_build.CSRC / f"{stem}.cu").read_text()
        for i, consts in enumerate(configs):
            cu = os.path.join(out_dir, f"{stem}-{i}.cu")
            so = os.path.join(out_dir, f"{stem}-{i}.so")
            with open(cu, "w") as f:
                f.write(variant_source(src, consts))
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                   "-o", so, cu]
            jobs[(name, i)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for key, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = so
    return libs


def bind(name: str, so: str):
    from repro_torch.kernels import _build
    fn = getattr(ctypes.CDLL(so), name)
    fn.argtypes = _build.KERNELS[name][1]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import bf16_matmul, flash_attention, ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sweep",
                                                  "sweep.json"))
    args = ap.parse_args()
    resolve_device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = build_all(os.path.join(ROOT, "build", "sweep"))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f}s",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    cases = {name: [] for name in CONFIGS}
    for name, shapes in (("q8_matmul", chip_smoke.MATMUL_SHAPES),
                         ("q8_matvec", chip_smoke.MATVEC_SHAPES)):
        for m, n, k, k_full, count, xdt in shapes:
            (x, qs, sc), *_ = chip_smoke._q8_case(gen, m, n, k, k_full, xdt)
            out = torch.empty((m, n), dtype=torch.float32, device="cuda")
            call_args = (x.data_ptr(), int(x.dtype == torch.bfloat16),
                         x.stride(0), qs.data_ptr(), qs.stride(0),
                         sc.data_ptr(), sc.stride(0), out.data_ptr(),
                         out.stride(0), m, n, k,
                         *((0, 0, 0) if name == "q8_matvec" else (0, 0)))
            per = "decode step" if name == "q8_matvec" else "prefill"
            cases[name].append((f"{m}x{n}x{k}", per, count, call_args, out,
                                ref.q8_flat_ref(x, qs, sc),
                                chip_smoke.KERNEL_TOL, (x, qs, sc)))
    for per, shapes in (("prefill", chip_smoke.BF16_PREFILL_SHAPES),
                        ("decode step", chip_smoke.BF16_STEP_SHAPES)):
        for m, n, k, k_full, count, xdt in shapes:
            (x, w), *_ = chip_smoke._bf16_case(gen, m, n, k, k_full, xdt)
            out = torch.empty((m, n), dtype=torch.float32, device="cuda")
            call_args = (x.data_ptr(), 1, x.stride(0), w.data_ptr(), 1,
                         w.stride(0), out.data_ptr(), out.stride(0), m, n, k,
                         0, 0, 0, 0)
            cases["bf16_matmul"].append((
                f"{m}x{n}x{k}", per, count, call_args, out,
                bf16_matmul.bf16_matmul_plain(x, w), chip_smoke.KERNEL_TOL,
                (x, w)))
    for bh, sq, sk, d, count, dt, causal in chip_smoke.FLASH_SHAPES:
        (q, k, v), *_ = chip_smoke._flash_case(gen, bh, sq, sk, d, dt)
        out = torch.empty((bh, sq, d), dtype=torch.float32, device="cuda")
        call_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), 1,
                     q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                     v.stride(0), v.stride(1), out.data_ptr(), None, bh, sq,
                     sk, d, int(causal))
        want = flash_attention.flash_attention_fwd_plain(q, k, v,
                                                         causal=causal)
        cases["flash_attention_fwd"].append((
            f"bh{bh} {sq}x{sk} d{d}", "prefill", count, call_args, out, want,
            chip_smoke.FLASH_BF16_TOL, (q, k, v)))

    rows = []
    for (name, i), so in libs.items():
        fn = bind(name, so)
        consts = CONFIGS[name][1][i]
        per_shape, totals, worst, sources = {}, {}, 0.0, set()
        # each case keeps its operands alive: the call holds raw pointers
        for label, per, count, call_args, out, want, tol, _ in cases[name]:
            def run(fn=fn, call_args=call_args):
                rc = fn(*call_args, stream())
                if rc:
                    raise RuntimeError(f"{name} [{tag(consts)}] failed: {rc}")
            run()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if not err <= tol * max(1.0, want.abs().max().item()):
                raise AssertionError(f"{name} [{tag(consts)}] {label}: "
                                     f"max |kernel - plain| = {err}")
            ms, src = chip_smoke.device_ms(run)
            per_shape[label] = ms
            sources.add(src)
            totals[per] = totals.get(per, 0.0) + ms * count
            worst = max(worst, err)
        rows.append(dict(kernel=name, config=tag(consts), ms=per_shape,
                         ms_total=totals, ms_source=sorted(sources),
                         max_abs_err=worst))
        print(f"sweep {name} [{tag(consts)}]: "
              + "; ".join(f"per {per} {t:.5f} ms" for per, t in totals.items())
              + "; " + " ".join(f"{k}={v:.5f}" for k, v in per_shape.items())
              + f" max_abs_err={worst:.3e}", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
