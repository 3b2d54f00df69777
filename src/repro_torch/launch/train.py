"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``, the reference's ``repro.launch.train`` on one device.

Runs the supervised training loop (``Trainer``) on ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu`` is given): the
smoke config by default, ``--full`` for the published widths. The
supervision loop restarts from the latest atomic checkpoint on retryable
failures. ``--mesh`` trains over ``make_smoke_mesh`` of the visible cards
(with ``--device cpu``, a (1, 1) mesh of the CPU), the state split by
``train_state_specs``, under ``activation_sharding(mesh)`` as the
reference's CLI runs, and prints how many layers run their attention and
FFN split over "model" and how many whole, by reason.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch

from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import ALL_ARCHS, get_config, \
    get_smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.train.fault import RestartPolicy, run_with_restarts
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ALL_ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke config)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard over make_smoke_mesh of the visible cards "
                         "(with --device cpu, a (1, 1) mesh of the CPU)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        mesh = make_smoke_mesh([device] if device.type == "cpu" else None)
        print(f"training mesh: {mesh.shape} over "
              f"{len(mesh.physical_devices)} device(s)")

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    run = RunConfig(
        model=cfg, shape=shape,
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=5,
                                  total_steps=max(args.steps, 10),
                                  grad_compress=args.grad_compress),
        steps=args.steps, checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir, max_restarts=args.max_restarts)

    def make_attempt(attempt: int):
        def attempt_fn():
            trainer = Trainer(run, device=device, mesh=mesh,
                              install_signal_handler=True, vocab_cap=512)
            if mesh is not None:
                print(f"blocks over 'model': {trainer.tp_summary()}")
            with (shard_ctx.activation_sharding(mesh) if mesh is not None
                  else contextlib.nullcontext()):
                return trainer.train()
        return attempt_fn

    metrics = run_with_restarts(
        make_attempt, RestartPolicy(max_restarts=run.max_restarts))
    print("final:", {k: round(v, 4) for k, v in metrics.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
