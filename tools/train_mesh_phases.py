"""``chip_smoke.py``'s mesh-training phases alone, on a CUDA card.

Runs 19b's configuration (``chip_smoke.train_run``: phi3-mini-3.8b at its
published widths, bf16, weights drawn on the card) unsharded for two
steps, whose losses and gradient norms are the reference, then
``chip_smoke.train_mesh_phase`` (19d, the (2, 2) mesh of four entries of
the card) and ``chip_smoke.train_model_axis_phase`` (19e, the (1, 4)
mesh) with their own checks, then ``chip_smoke.train_moe_phase`` (19f:
olmoe-1b-7b at its published widths cut to 4 layers, one unsharded step
and one step each over (1, 4) and (2, 2) meshes of the card, its experts
and vocabulary split over the model shards). It takes a few minutes where
the whole script takes ten. ``--moe-only`` runs 19f alone (19b's steps,
19d and 19e skipped). ``--moe-ablation`` then reruns 19f's mesh steps
with the experts, the vocabulary, or both computed whole (``rules``'
layouts replaced), and the unsharded step once more, printing each
leg's loss and gradient-norm gaps to 19f's unsharded step: which split
the gaps come from, against the unsharded step's own repeat.

``--bf16-input-grads`` adds an ablation: 19d and 19e run four times, as
the tree has them, with the model shards' inputs left in bf16 (so the
column-parallel products' input gradients are bf16 products summed in
bf16: ``models.transformer.shard_inputs`` replaced), that again, and as
the tree has them again; each run's gradient-norm gaps to 19b are
printed.

Run from the root of the repo on a machine with one card:

    python3 tools/train_mesh_phases.py [--bf16-input-grads | --moe-only]
        [--moe-ablation]

It prints the phases' lines and a ``mesh phases:`` JSON summary (19f's
under ``"19f"``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gaps(mesh: dict, axis: dict) -> dict:
    """The phases' largest relative gaps to 19b: loss and gradient norm."""
    def gap(got, ref):
        return max(abs(g - r) / abs(r) for g, r in zip(got, ref))
    return {"19d_loss": gap(mesh["losses"], mesh["ref_losses"]),
            "19d_grad_norm": gap(mesh["grad_norms"],
                                 mesh["ref_grad_norms"]),
            "19e_loss": gap([axis["loss"]], [axis["ref_loss"]]),
            "19e_grad_norm": gap([axis["grad_norm"]],
                                 [axis["ref_grad_norm"]])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16-input-grads", action="store_true",
                    help="also run the phases with the shards' inputs "
                         "in bf16 (the ablation above)")
    ap.add_argument("--moe-only", action="store_true",
                    help="run phase 19f alone")
    ap.add_argument("--moe-ablation", action="store_true",
                    help="rerun 19f's mesh steps with the experts and/or "
                         "the vocabulary whole (above)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("train_mesh_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    # the flash kernels built before any step is timed (chip_smoke.py has
    # built them by phase 19)
    _build.build(["flash_attention_fwd", "flash_attention_bwd"])
    counted = {"flash_attention_fwd": fa.flash_attention_fwd,
               "flash_attention_bwd": fa.flash_attention_bwd}
    out = []
    if not args.moe_only:
        out = _phi3_phases(cs, counted, args.bf16_input_grads)
    _, moe = cs.train_moe_phase(counted)
    out.append({"19f": moe})
    if args.moe_ablation:
        out.append({"19f ablation": _moe_ablation(cs, counted, moe)})
    print("mesh phases:", json.dumps(out), flush=True)
    print(f"train_mesh_phases: {time.perf_counter() - t0:.1f}s "
          f"({torch.cuda.get_device_name(0)})")
    return 0


def _moe_ablation(cs, counted, moe: dict) -> dict:
    """19f's mesh steps again with the experts, the vocabulary, or both
    computed whole (``rules.tp_layout``'s "moe" and ``rules.vocab_layout``
    replaced by a reason), and the unsharded steps again: {leg: its first
    step's loss and gradient-norm gaps to 19f's unsharded first step, its
    last step's ms and its peak bytes}."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import rules

    real_tp, real_vocab = rules.tp_layout, rules.vocab_layout

    def experts_whole(cfg, sp, mesh):
        out = real_tp(cfg, sp, mesh)
        if "moe" in out:
            out["moe"] = "ablation: experts whole"
        return out

    def vocab_whole(cfg, specs, mesh):
        return "ablation: vocabulary whole"
    legs = {"split": (real_tp, real_vocab),
            "experts whole": (experts_whole, real_vocab),
            "vocabulary whole": (real_tp, vocab_whole),
            "both whole": (experts_whole, vocab_whole)}
    ref = moe["steps"]["unsharded"]
    _, run = cs.train_moe_run(tempfile.mkdtemp(prefix="moe_ablation_"))
    dev = torch.device("cuda", torch.cuda.current_device())

    def gaps(st):
        return {**{k: abs(st[k] - ref[k]) / abs(ref[k])
                   for k in ("loss", "grad_norm")},
                "step_ms": st["step_ms"], "peak_bytes": st["peak_bytes"]}
    out = {"unsharded again": gaps(cs.train_moe_step(run, None, counted))}
    for sizes in cs.TRAIN_MOE_MESHES:
        mesh = Mesh(sizes, ("data", "model"),
                    [dev] * (sizes[0] * sizes[1]))
        for leg, (tp, vocab) in legs.items():
            rules.tp_layout, rules.vocab_layout = tp, vocab
            try:
                st = cs.train_moe_step(run, mesh, counted)
            finally:
                rules.tp_layout, rules.vocab_layout = real_tp, real_vocab
            out[f"{sizes} {leg}"] = gaps(st)
    for leg, g in out.items():
        print(f"19f ablation {leg}: {json.dumps(g)}", flush=True)
    return out


def _phi3_phases(cs, counted, bf16_input_grads: bool) -> list:
    """19b's first two steps, then 19d and 19e (four legs each with the
    ablation, where ``bf16_input_grads``): one entry a leg."""
    from repro_torch.models import transformer
    from repro_torch.train.trainer import Trainer

    cfg, run = cs.train_run(tempfile.mkdtemp(prefix="train_mesh_phases_"))
    tr = Trainer(dataclasses.replace(run, steps=2), device="cuda")
    tr.save = lambda step: None
    tr.train()
    history = list(tr.history)
    print(f"19b's first 2 steps: losses {[h['loss'] for h in history]}, "
          f"grad_norms {[h['grad_norm'] for h in history]}, host dt_s "
          f"{[h['dt_s'] for h in history]}", flush=True)
    del tr
    real = transformer.shard_inputs
    legs = ["f32", "bf16", "bf16", "f32"] if bf16_input_grads else ["f32"]
    out = []
    for leg in legs:
        if leg == "bf16":
            transformer.shard_inputs = lambda part, inputs: (inputs, False)
        print(f"--- input gradients: {leg}", flush=True)
        try:
            _, mesh = cs.train_mesh_phase(cfg, run, history, counted)
            _, axis = cs.train_model_axis_phase(cfg, run, history, counted)
        finally:
            transformer.shard_inputs = real
        for key in ("device_split", "bwd_kernels"):
            mesh.pop(key, None)
        out.append({"input_grads": leg, "gaps": _gaps(mesh, axis),
                    "19d": mesh, "19e": axis})
        print(f"gaps ({leg} input gradients): {json.dumps(out[-1]['gaps'])}",
              flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
