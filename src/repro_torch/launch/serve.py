"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch whisper-tiny [...]``.

Boots the ServeEngine with random weights from ``--seed`` (Q8_0 on load by
default) and serves a set of synthetic requests: mels for a Whisper arch,
for a dense, MoE, SSM or hybrid LM (``--arch qwen2.5-14b``, ``--arch
mamba2-780m``; ``--arch olmoe-1b-7b --quant none``, ``--arch
jamba-v0.1-52b --quant none``, a model with MoE layers in Q8_0 being
refused) prompts of 8 tokens drawn
from ``--seed`` as the reference's launcher draws them (an LM's weights
are drawn on ``--device``, from a generator there). It serves them as one
static batch (``transcribe`` or ``generate``), or with ``--continuous``
through the continuous-batching
scheduler over a pool of ``--slots`` slots, drained step by step, whose
per-request attribution it prints, or with ``--speculative`` through a
two-model speculative engine (Whisper archs only, as the reference): a
``--draft`` arch (whisper-tiny by default, dense, its weights from
``--seed`` + 1) proposes ``-k`` tokens a round and the served arch
verifies them, token-exact with its own greedy decode; the report adds
``spec.stats()`` (acceptance, captures, FLOPs by role). Then
each request's latency and tokens,
the offload ledger when ``--offload`` routes the linears through the
dispatcher, and one ``energy_report`` JSON object. Power is the card's
limit as nvidia-smi reads it, or ``--power-w``, which the CPU requires.
Runs on the card unless ``--device cpu`` is given.

``--mesh`` serves sharded over every visible card: slot-DP over the
mesh's data axis (``launch/mesh.py``), a scheduler's pool split into data
shards, the energy report's ``dispatch.by_device`` one entry a device.
With ``--device cpu`` the mesh is (1, 1), of the CPU. ``--speculative``
with ``--mesh`` is refused, as the reference refuses it.

``--trace-out PATH`` writes the run's Perfetto ``trace_event`` JSON and
``--metrics-out PATH`` its Prometheus text exposition; either one turns
telemetry on (``repro_torch.obs``), and the report then carries
``"telemetry": snapshot()`` (metrics, trace shape, the ledger
consistency record).
"""
from __future__ import annotations

import argparse
import json
from dataclasses import asdict

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.registry import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core import energy
from repro_torch.core.offload import OffloadEngine
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import ServeEngine, check_servable


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ALL_ARCHS))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--quant", default="q8_0", choices=["none", "q8_0"])
    ap.add_argument("--offload", action="store_true",
                    help="route linears through the offload dispatcher")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching scheduler instead of one "
                         "static batch")
    ap.add_argument("--slots", type=int, default=4,
                    help="slot-pool width for --continuous")
    ap.add_argument("--mesh", action="store_true",
                    help="serve sharded over every visible device (slot-DP "
                         "over the data axis; with --device cpu, a (1, 1) "
                         "mesh of the CPU)")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative decoding: a --draft model proposes "
                         "-k tokens a round, the served arch verifies them")
    ap.add_argument("--draft", default="whisper-tiny",
                    choices=sorted(ALL_ARCHS),
                    help="draft arch for --speculative")
    ap.add_argument("-k", type=int, default=6,
                    help="draft window size for --speculative")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's Perfetto trace_event JSON here "
                         "(enables telemetry)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write Prometheus text exposition here "
                         "(enables telemetry)")
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
    if args.speculative and args.continuous:
        ap.error("--speculative batches its requests in one wave; drop "
                 "--continuous")
    if args.speculative and args.mesh:
        ap.error("--speculative over a sharded mesh is not supported yet")

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    check_servable(cfg, args.quant)
    audio = cfg.family == "audio"
    if args.speculative and not audio:
        ap.error("--speculative serves the Whisper ladder (audio archs)")
    gen = torch.Generator(device="cpu" if audio else args.device
                          ).manual_seed(args.seed)
    params = model_lib.init_params(gen, cfg, max_positions=512,
                                   device=args.device)
    offload = OffloadEngine() if args.offload else None
    telemetry = (obs.Telemetry()
                 if (args.trace_out or args.metrics_out) else None)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_serve_mesh
        mesh = make_serve_mesh(devices=[torch.device("cpu")]
                               if args.device == "cpu" else None)
        print(f"serving mesh: {mesh.shape} over "
              f"{len(mesh.physical_devices)} device(s)")
    engine = ServeEngine(cfg, params, max_len=args.max_new + 32,
                         quant=args.quant, offload=offload,
                         device=args.device, mesh=mesh, telemetry=telemetry)
    frames = cfg.encoder_ctx if args.full else 64
    rng = np.random.default_rng(args.seed)
    if audio:
        mel = rng.standard_normal((args.requests, frames, cfg.n_mels)
                                  ).astype(np.float32)
        payloads = [mel[i:i + 1] for i in range(args.requests)]
    else:
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.requests, 8)).astype(np.int32)
        payloads = [prompts[i:i + 1] for i in range(args.requests)]
    power_w = args.power_w
    if power_w is None:
        power_w = energy.card_power_limit_w(engine.device.index or 0)
    if args.continuous:
        sched = engine.scheduler(n_slots=args.slots,
                                 n_frames=frames if audio else None)
        rids = [sched.submit(p, max_new=args.max_new) for p in payloads]
        streamed = {r: 0 for r in rids}

        def on_token(ev):
            streamed[ev.rid] += 1

        # drain by hand so that attribution() sees the finished, unclaimed
        # results; run() then claims them
        while sched.n_queued or sched.n_active:
            sched.admit()
            for ev in sched.decode_step():
                on_token(ev)
        attribution = sched.attribution(power_w)
        got = sched.run(on_token=on_token)
        results = [got[r] for r in rids]
        print(f"continuous batching: {args.slots} slots, "
              f"{sum(streamed.values())} tokens streamed, "
              f"{sched.step_captures} step capture(s)")
        print(json.dumps({"attribution": attribution, "power_w": power_w},
                         indent=1, sort_keys=True))
    elif args.speculative:
        dcfg = (get_config(args.draft) if args.full
                else get_smoke_config(args.draft))
        dparams = model_lib.init_params(
            torch.Generator().manual_seed(args.seed + 1), dcfg,
            max_positions=512, device=args.device)
        spec = engine.speculative(dcfg, dparams, k=args.k)
        results = spec.transcribe(mel, max_new=args.max_new)
        print(f"speculative: draft={args.draft} k={args.k} "
              f"acceptance={spec.acceptance_rate():.2f} "
              f"rounds={spec.rounds} "
              f"verify_captures={spec.stats()['verify_captures']}")
    elif audio:
        results = engine.transcribe(mel, max_new=args.max_new)
    else:
        results = engine.generate(prompts, max_new=args.max_new)
    for i, r in enumerate(results):
        print(f"req{i}: {r.steps} tokens in {r.total_s:.3f}s "
              f"(prefill {r.prefill_s:.3f}s) tokens={r.tokens[:8]}...")
    if offload is not None:
        print(json.dumps({"ledger": asdict(offload.stats)}, indent=1,
                         sort_keys=True))
    report = {"energy": engine.energy_report(results, power_w),
              "power_w": power_w}
    if args.speculative:
        report["speculative"] = spec.stats()
    if telemetry is not None:
        report["telemetry"] = telemetry.snapshot()
        if args.trace_out:
            print("trace written:", telemetry.write_trace(args.trace_out))
        if args.metrics_out:
            print("metrics written:",
                  telemetry.write_metrics(args.metrics_out))
    print(json.dumps(report, indent=1, default=str, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
