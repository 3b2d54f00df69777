"""What the bf16 flash backward's dS split buys, on a CUDA card.

The tensor-core backward (``src/repro_torch/csrc/flash_attention_bwd.cu``)
feeds dS, f32 in the reference, to the dK and dQ products as two bf16
terms, hi = bf16(dS) and lo = bf16(dS - hi). This script builds that
source twice, as it is ("split") and with the lo term dropped so that dS
is rounded once to bf16 ("hi"), each from its own copy of the package
under ``build/ds_ablation/``, and holds both against the plain version
(``flash_attention_bwd_plain``) on the same inputs:

* at ``chip_smoke.py``'s phase 19a checks (``FLASH_BWD_CHECKS``, the same
  seed and order) and at every bf16 shape of the card tests
  (``tests/test_torch_train_gpu.py``'s ``SHAPES`` and ``_operands``);
* by each output's max |err| over its largest value (``_bwd_err``, the
  tolerance of 1e-2) and its mean |err| over its mean magnitude
  (``_bwd_mean_err``, ``FLASH_BWD_MEAN_TOL``);
* and times one launch at phi3-mini's training shape (BH = 64, S = 4096,
  D = 96, causal) with CUDA events.

Run from the root of the repo on a machine with one card:

    python3 tools/flash_bwd_ds_ablation.py

It prints one line a case and writes ``chiprun_out/ds_ablation.json``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "ds_ablation"
SOURCE = "flash_attention_bwd.cu"
# the two edits that drop the lo term: one bf16 term a k-step, one mma
HI_ONLY = (("uint32_t ds[2][4];", "uint32_t ds[1][4];"),
           ("acc_rows<D, 2>(", "acc_rows<D, 1>("))
PHI3 = (64, 4096, 4096, 96, "bfloat16", True)


def variant_src(name: str) -> Path:
    """The ``src`` directory to import ``repro_torch`` from: the repo's own
    for "split", a patched copy for "hi"."""
    if name == "split":
        return ROOT / "src"
    src = WORK / name / "src"
    shutil.rmtree(WORK / name, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = src / "repro_torch" / "csrc" / SOURCE
    text = cu.read_text()
    for old, new in HI_ONLY:
        if text.count(old) != 2:
            raise SystemExit(f"{SOURCE}: expected 2 of {old!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return src


def measure(name: str) -> dict:
    """In a process whose ``repro_torch`` is the variant's: every case's
    two errors and phi3's time a launch."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    spec = importlib.util.spec_from_file_location(
        "card_tests", ROOT / "tests" / "test_torch_train_gpu.py")
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)

    _build.build(["flash_attention_fwd", "flash_attention_bwd"])
    cases = []

    def check(where, args, shape):
        causal = shape[-1]
        got = fa.flash_attention_bwd(*args, causal=causal)
        want = fa.flash_attention_bwd_plain(*args, causal=causal)
        case = dict(where=where, shape=shape, max_err=cs._bwd_err(got, want),
                    mean_err=cs._bwd_mean_err(got, want))
        print(f"{name} {where} {shape}: max_err={case['max_err']:.3e} "
              f"mean_err={case['mean_err']:.3e}", flush=True)
        cases.append(case)

    gen = torch.Generator(device="cuda").manual_seed(19)
    for bh, sq, sk, d, dt, causal in cs.FLASH_BWD_CHECKS:
        args, *_ = cs._flash_bwd_case(gen, bh, sq, sk, d, dt, causal)
        if dt == "bfloat16":
            check("19a", args, (bh, sq, sk, d, causal))
    dev = torch.device("cuda")
    for bh, sq, sk, d, causal in card.SHAPES:
        q, k, v, dout = card._operands(bh, sq, sk, d, "bfloat16", dev)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_lse=True)
        check("card", (q, k, v, out.to(q.dtype), dout, lse),
              (bh, sq, sk, d, causal))

    args, *_ = cs._flash_bwd_case(gen, *PHI3)
    ms, source = cs.device_ms(
        lambda: fa.flash_attention_bwd(*args, causal=True), iters=5)
    print(f"{name} phi3 {PHI3}: {ms:.4f} ms a launch ({source})",
          flush=True)
    return dict(variant=name, cases=cases, phi3_ms=ms, ms_source=source)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        out = Path(os.environ["DS_ABLATION_OUT"])
        out.write_text(json.dumps(measure(sys.argv[2])))
        return 0
    WORK.mkdir(parents=True, exist_ok=True)
    results = []
    for name in ("split", "hi"):
        out = WORK / f"{name}.json"
        env = dict(os.environ, PYTHONPATH=str(variant_src(name)),
                   DS_ABLATION_OUT=str(out))
        subprocess.run([sys.executable, __file__, "--measure", name],
                       env=env, cwd=ROOT, check=True)
        results.append(json.loads(out.read_text()))
    split, hi = results
    worst = {key: (max(c[key] for c in split["cases"]),
                   min(c[key] for c in hi["cases"]))
             for key in ("max_err", "mean_err")}
    for key, (s, h) in worst.items():
        print(f"{key}: split at most {s:.3e}, hi at least {h:.3e}")
    print(f"phi3 a launch: split {split['phi3_ms']:.4f} ms, hi "
          f"{hi['phi3_ms']:.4f} ms")
    dest = ROOT / "chiprun_out" / "ds_ablation.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(dict(results=results, worst=worst), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
