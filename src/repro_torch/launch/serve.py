"""One-shot serving launcher of the port:
``python -m repro_torch.launch.serve --arch whisper-tiny [...]``.

Boots the ServeEngine with random weights from ``--seed`` (Q8_0 on load by
default), transcribes a batch of synthetic mel requests and prints each
request's latency and tokens, then the offload ledger when ``--offload``
routes the linears through the dispatcher, then one ``energy_report`` JSON
object: PDP/EDP at the card's power limit as nvidia-smi reads it, or at
``--power-w``, which the CPU requires. Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import asdict

import numpy as np
import torch

from repro_torch.configs.registry import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core import energy
from repro_torch.core.offload import OffloadEngine
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ALL_ARCHS))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--quant", default="q8_0", choices=["none", "q8_0"])
    ap.add_argument("--offload", action="store_true",
                    help="route linears through the offload dispatcher")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke config)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--power-w", type=float, default=None,
                    help="power for the energy report (default on the card: "
                         "its power limit; required on the CPU)")
    args = ap.parse_args(argv)
    if args.power_w is None and args.device == "cpu":
        ap.error("--device cpu needs --power-w for the energy report")

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    gen = torch.Generator().manual_seed(args.seed)
    params = model_lib.init_params(gen, cfg, max_positions=512,
                                   device=args.device)
    offload = OffloadEngine() if args.offload else None
    engine = ServeEngine(cfg, params, max_len=args.max_new + 32,
                         quant=args.quant, offload=offload,
                         device=args.device)
    frames = cfg.encoder_ctx if args.full else 64
    rng = np.random.default_rng(args.seed)
    mel = rng.standard_normal((args.requests, frames, cfg.n_mels)
                              ).astype(np.float32)
    results = engine.transcribe(mel, max_new=args.max_new)
    for i, r in enumerate(results):
        print(f"req{i}: {r.steps} tokens in {r.total_s:.3f}s "
              f"(prefill {r.prefill_s:.3f}s) tokens={r.tokens[:8]}...")
    if offload is not None:
        print(json.dumps({"ledger": asdict(offload.stats)}, indent=1,
                         sort_keys=True))
    power_w = args.power_w
    if power_w is None:
        power_w = energy.card_power_limit_w(engine.device.index or 0)
    print(json.dumps({"energy": engine.energy_report(results, power_w),
                      "power_w": power_w}, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
