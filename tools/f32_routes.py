"""The f32-operand products on a CUDA card: what the exact split of f32 x
buys in ``q8_matmul``, and the converting launches' times beside another
tree's.

``q8_matmul``'s converting launch (``src/repro_torch/csrc/q8_matmul.cu``,
``q8_split_tc_kernel``) splits an f32 x into three bf16 parts, hi, mid
and lo. This script builds that source as it is ("split") and twice
patched, each from its own copy of the package under
``build/f32_routes/``: with lo stored as zeros ("hi_mid") and with mid and
lo stored as zeros ("hi", x rounded once to bf16). Each variant is held
against a float64 product of the same dequantized weight at the card
tests' shapes (``tests/test_torch_kernels_gpu.py``'s
``CONVERTING_SHAPES``), by max |err| over the largest output, against the
reference oracle's 2e-5. Each variant's ``-Xptxas -v`` lines are kept.

With ``--parent DIR`` (the ``src`` directory of another checkout, such as
the parent commit unpacked with ``git archive``), the same shapes are also
timed on that tree, in the order parent, split, split, parent: the whisper
frontend (1500 x 384 x 80, f32 mel, bf16 W) and llava's projector (1152 x
4096 x 1024, f32 patches) on ``bf16_matmul``, the projector and a
whisper-base verify window (M = 28, f32 x; its four shapes, 49 launches a
window) on ``q8_matmul``. Device ms a launch from one profiled window
(``chip_smoke.device_ms_each``: torch.profiler, warm L2), beside the
plain version's and the library call's of ``chip_smoke.py``'s phase 2,
with the bytes' time at the memory rate and the FLOPs.

Run from the root of the repo on a machine with one card:

    python3 tools/f32_routes.py [--parent build/parent/src] [--out PATH]

It prints one line a case and writes the results as JSON to ``PATH``
(``build/f32_routes/f32_routes.json`` by default).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "f32_routes"
SOURCE = "q8_matmul.cu"
# the edits that store a part as zeros: its products then add 0
LO_TAIL = "r1 - __uint_as_float(mid & 0xffff0000u));"
ZERO_LO = (("  lo = hopper::pack_bf16(", "  lo = 0u * hopper::pack_bf16("),)
ZERO_MID = (("  mid = hopper::pack_bf16(r0, r1);\n", "  mid = 0u;\n"),
            (LO_TAIL, LO_TAIL + "\n  lo = 0u;"))
EDITS = {"hi_mid": ZERO_LO, "hi": ZERO_MID}
TOL = 2e-5
# (kernel, m, n, k, x dtype, launches a window): the timed products
TIMED = [("bf16_matmul", 1500, 384, 80, "float32", 1),
         ("bf16_matmul", 1152, 4096, 1024, "float32", 1),
         ("q8_matmul", 1152, 4096, 1024, "float32", 1),
         ("q8_matmul", 28, 512, 512, "float32", 36),
         ("q8_matmul", 28, 2048, 512, "float32", 6),
         ("q8_matmul", 28, 512, 2048, "float32", 6),
         ("q8_matmul", 28, 51872, 512, "float32", 1)]


def variant_src(name: str) -> Path:
    """The ``src`` directory to import ``repro_torch`` from: the repo's own
    for "split", a patched copy otherwise."""
    if name == "split":
        return ROOT / "src"
    src = WORK / name / "src"
    shutil.rmtree(WORK / name, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = src / "repro_torch" / "csrc" / SOURCE
    text = cu.read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{SOURCE}: expected one {old!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return src


def measure(name: str, timed: bool) -> dict:
    """In a process whose ``repro_torch`` is the variant's: each shape's
    error against float64 and, with ``timed``, the timed products."""
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "tests"))
    import chip_smoke as cs
    from repro_torch.core.device import resolve_device
    from repro_torch.core.qformats import quantize_q8_0
    from repro_torch.kernels import _build, bf16_matmul, q8_matmul
    resolve_device("cuda")
    logs = _build.build(["q8_matmul", "bf16_matmul"])
    ptxas = [line.strip() for log in logs.values()
             for line in log.splitlines()
             if any(w in line for w in ("Used", "spill", "Compiling entry"))]
    out = dict(variant=name, ptxas=ptxas, cases=[], times=[])
    import test_torch_kernels_gpu as card
    for m, n, k in card.CONVERTING_SHAPES:
        x, w = card._operands(m, n, k, seed=m + n + k)
        x = torch.from_numpy(x).cuda()
        tq = quantize_q8_0(torch.from_numpy(w).cuda())
        got = q8_matmul.q8_matmul(x, tq.flat_qs(), tq.scales)
        deq = (tq.qs.float() * tq.scales[..., None]).reshape(n, k)
        want = x.double() @ deq.double().t()
        rel = ((got.double() - want).abs().max() / want.abs().max()).item()
        print(f"{name} q8_matmul f32 x {m}x{n}x{k}: max |err| / largest = "
              f"{rel:.3e} ({'within' if rel <= TOL else 'above'} {TOL})",
              flush=True)
        out["cases"].append(dict(shape=[m, n, k], rel_err=rel))
    if timed:
        gen = torch.Generator(device="cuda").manual_seed(30)
        for kernel, m, n, k, xdt, count in TIMED:
            if kernel == "q8_matmul":
                args, library, moved, flops, _, _ = cs._q8_case(
                    gen, m, n, k, k, xdt)
                fn, plain = q8_matmul.q8_matmul, q8_matmul.q8_matmul_plain
            else:
                args, library, moved, flops, _, _ = cs._bf16_case(
                    gen, m, n, k, k, xdt)
                fn = bf16_matmul.bf16_matmul
                plain = bf16_matmul.bf16_matmul_plain
            (ms, src), (plain_ms, _), (lib_ms, _) = cs.device_ms_each(
                [lambda: fn(*args), lambda: plain(*args), library])
            row = dict(kernel=kernel, shape=[m, n, k], x=xdt, count=count,
                       ms=ms, ms_source=src, plain_ms=plain_ms,
                       library_ms=lib_ms,
                       bytes_ms=moved / cs.HBM_BYTES_PER_S * 1e3,
                       flops=flops)
            print(f"{name} {kernel} {m}x{n}x{k} x={xdt} x{count}: "
                  f"ms={ms:.5f} ({src}) plain_ms={plain_ms:.5f} "
                  f"library_ms={lib_ms:.5f}", flush=True)
            out["times"].append(row)
    return out


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--measure":
        dest = Path(os.environ["F32_ROUTES_OUT"])
        dest.write_text(json.dumps(measure(args[1],
                                           os.environ["F32_TIMED"] == "1")))
        return 0
    opts = dict(zip(args[::2], args[1::2]))
    if len(args) % 2 or set(opts) - {"--parent", "--out"}:
        raise SystemExit("usage: tools/f32_routes.py [--parent SRC_DIR] "
                         "[--out PATH]")
    parent = Path(opts["--parent"]).resolve() if "--parent" in opts else None
    WORK.mkdir(parents=True, exist_ok=True)
    order = (["parent", "split", "hi", "hi_mid", "split", "parent"]
             if parent else ["split", "hi", "hi_mid"])
    runs = []
    for i, name in enumerate(order):
        src = parent if name == "parent" else variant_src(name)
        dest = WORK / f"{i}-{name}.json"
        env = dict(os.environ, PYTHONPATH=str(src), F32_ROUTES_OUT=str(dest),
                   F32_TIMED="1" if name in ("parent", "split") else "0")
        subprocess.run([sys.executable, __file__, "--measure", name],
                       env=env, cwd=ROOT, check=True)
        runs.append(json.loads(dest.read_text()))
    for name in ("split", "hi_mid", "hi"):
        worst = max(c["rel_err"] for r in runs if r["variant"] == name
                    for c in r["cases"])
        best = min(c["rel_err"] for r in runs if r["variant"] == name
                   for c in r["cases"])
        print(f"{name}: max |err| / largest {best:.3e} to {worst:.3e} "
              f"(gate {TOL})")
    dest = Path(opts.get("--out", WORK / "f32_routes.json"))
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(dict(runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
