"""Multi-pod dry-run of the port: run every (architecture x input shape)
cell's program on fake tensors over the production meshes and record its
memory, cost and collectives per logical device, with no card and no
full-width tensor allocated.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-tiny \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell with XLA on 512 host devices.
The port's programs are eager, so a cell runs its program once under a
``FakeTensorMode`` (``launch/input_specs.py``) and the counter of
``roofline/op_cost.py``, every logical entry of the mesh standing on one
fake CPU device (a ``torch.device`` index is too narrow for 512 distinct
ones; the counter names entries by their mesh coordinates):

  train_4k     the port's mesh training step (``make_train_step(...,
               mesh=, specs=, microbatches=)``), its state laid out by
               ``train_state_specs`` and stored split (``Pieces``, built
               empty here);
  prefill_32k  ``forward`` over the batch, and
  decode_32k / long_500k
               one ``serve_step`` against a full cache, each data shard's
               program on its rows (under ``shard_program``: a MoE
               layer's capacity and claim are the whole step's).
               Over "model" > 1 both serving kinds run with the weights a
               ``ServeEngine`` holds there (``rules.place`` and
               ``rules.serve_tree``): the split blocks over their model
               shards, each charged to its entry, and the KV caches split
               by their heads where attention is. Each entry's argument
               bytes are what ``serve_param_specs`` (and
               ``cache_specs``, or ``batch_specs``) give it.

A cell whose shape does not apply to its arch (long_500k on a pure
full-attention arch) ends ``"skip"`` with the reference's reason; any other
failure ends ``"error"``. Results go to
``<out>/<mesh>/<arch>__<shape>[__variant].json`` (default
``experiments/dryrun_torch/``, which ``.gitignore`` lists): ``status``,
``memory`` (the busiest entry's argument and peak bytes, and per entry
``entries``: argument bytes, peak bytes, FLOPs, bytes and collective
bytes) and ``roofline`` (``analysis.RooflineReport`` of the busiest
entry, on the H100's figures).

Per-arch training overrides (microbatches, moment storage) are the
reference's ``TRAIN_OVERRIDES``, part of the system config.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig, \
    ShapeConfig, shape_applicable
from repro_torch.configs.registry import ALL_SHAPES, ASSIGNED, get_config, \
    get_shape
from repro_torch.core import tree
from repro_torch.core.qformats import quantize_tree
from repro_torch.launch import input_specs as specs_lib
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.roofline import op_cost
from repro_torch.roofline.analysis import H100, analyze_program
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding import rules
from repro_torch.train.step import init_train_state, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: every entry of a dry-run mesh stands on this fake device
DEVICE = torch.device("cpu")

# ---------------------------------------------------------------------------
# Per-arch training memory configs (the reference's). microbatches:
# gradient-accumulation splits of the global batch; state_dtype: the
# optimizer moments' storage (q8_0 = the paper's block format).
# ---------------------------------------------------------------------------
TRAIN_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "arctic-480b":            {"microbatches": 16, "state_dtype": "q8_0",
                               "grad_accum_dtype": "bfloat16"},
    "qwen1.5-110b":           {"microbatches": 8, "state_dtype": "bfloat16"},
    "jamba-v0.1-52b":         {"microbatches": 8},
    "olmoe-1b-7b":            {"microbatches": 8},
    "llava-next-mistral-7b":  {"microbatches": 4},
    "internlm2-20b":          {"microbatches": 4},
    "qwen2.5-14b":            {"microbatches": 4},
    "phi3-mini-3.8b":         {"microbatches": 4},
    "mamba2-780m":            {"microbatches": 2},
    "whisper-tiny":           {"microbatches": 1},
}


def _mesh_name(multi_pod: bool) -> str:
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


def _name_of(mesh: Mesh) -> str:
    return "mesh_" + "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def device_mesh(mesh: Mesh) -> Mesh:
    """``mesh`` with every entry on ``DEVICE`` (an abstract mesh gets
    them; a mesh of devices is kept)."""
    if not mesh.is_abstract:
        return mesh
    return Mesh(tuple(mesh.shape[a] for a in mesh.axis_names),
                mesh.axis_names, [DEVICE] * mesh.size)


def _quantizer(cfg: ModelConfig):
    from repro_torch.serve.engine import _keep_dense
    return lambda p: quantize_tree(p, _keep_dense)


def empty_split(state, specs, mesh: Mesh):
    """``state`` stored split by ``specs`` as ``rules.split_tree`` stores
    it, each piece an empty tensor of its region's shape (no copy: the
    dry-run's values do not matter)."""
    def split(x, spec):
        lay = rules.leaf_layout(x.shape, spec, mesh)
        return rules.Pieces(
            torch.empty(tuple(r.stop - r.start for r in region)
                        + tuple(x.shape[len(region):]), dtype=x.dtype,
                        device=dev)
            for region, dev in zip(lay.regions, lay.devices))
    return tree.unflatten_like(state, [
        split(x, s) for x, s in zip(
            tree.leaves(state), tree.leaves(specs, is_leaf=rules.is_spec),
            strict=True)])


# ---------------------------------------------------------------------------
# Cells: each builds its inputs under ``mode`` and returns (the program,
# meta, each entry's argument bytes)
# ---------------------------------------------------------------------------
def lower_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
                     mode, overrides: Optional[Dict[str, Any]] = None):
    ov = dict(TRAIN_OVERRIDES.get(cfg.name, {}))
    ov.update(overrides or {})
    micro = int(ov.get("microbatches", 1))
    opt_cfg = OptimizerConfig(state_dtype=ov.get("state_dtype", "float32"))
    accum = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[ov.get("grad_accum_dtype", "float32")]
    with mode:
        state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                 opt_cfg, max_positions=shape.seq_len,
                                 device=DEVICE)
        specs = rules.train_state_specs(state, mesh)
        state = empty_split(state, specs, mesh)
    batch = specs_lib.batch_specs_struct(cfg, shape, mode=mode,
                                         device=DEVICE)
    step = make_train_step(cfg, opt_cfg, microbatches=micro,
                           grad_accum_dtype=accum, mesh=mesh, specs=specs)
    return (lambda: step(state, batch)), {"microbatches": micro, **ov}, \
        rules.entry_bytes(state, specs, mesh)


def _serve_params(cfg: ModelConfig, params, mesh: Mesh):
    """The serving weights one data shard computes with, as a
    ``ServeEngine`` on ``mesh`` holds them: over "model" > 1 the serving
    tree of ``rules.serve_tree`` (every entry on ``DEVICE``, so each model
    part is a view of the one copy), else ``params``; and the devices its
    KV caches split over (None where its attention runs whole)."""
    if mesh.shape.get("model", 1) <= 1:
        return params, None
    specs = rules.serve_param_specs(params, mesh)
    placed = rules.place(params, mesh, specs)
    devs = (DEVICE,) * mesh.shape["model"]
    tree = rules.serve_tree(cfg, placed, specs, mesh, devs,
                            layers.VocabShards)
    return tree, (devs if rules.attention_split(tree) else None)


def _rows(mesh: Mesh, n: int) -> List[slice]:
    """Each data shard's rows of a batch of ``n`` (the whole batch on the
    first where the shards do not divide it)."""
    shards = len(mesh.shard_devices())
    if n % shards or shards == 1:
        return [slice(None)]
    size = n // shards
    return [slice(i * size, (i + 1) * size) for i in range(shards)]


def lower_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
                       mode, quant: str = "none"):
    qz = _quantizer(cfg) if quant == "q8_0" else None
    params = specs_lib.abstract_params(cfg, shape, mode=mode, quantize=qz,
                                       device=DEVICE)
    batch = specs_lib.batch_specs_struct(cfg, shape, mode=mode,
                                         device=DEVICE)
    arg = rules.spec_bytes(params, rules.serve_param_specs(params, mesh),
                           mesh) \
        + rules.spec_bytes(batch, rules.batch_specs(batch, mesh), mesh)
    with mode:
        tree, _ = _serve_params(cfg, params, mesh)
    rows = _rows(mesh, shape.global_batch)

    def run():
        with torch.no_grad(), shard_ctx.shard_program(len(rows)):
            for i, r in enumerate(rows):
                with op_cost.at(shard=i):
                    model_lib.forward(tree, cfg, {k: v[r] for k, v
                                                  in batch.items()})
    return run, {"quant": quant}, [arg] * mesh.size


def lower_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
                      mode, quant: str = "none"):
    qz = _quantizer(cfg) if quant == "q8_0" else None
    params = specs_lib.abstract_params(cfg, shape, mode=mode, quantize=qz,
                                       device=DEVICE)
    state = specs_lib.abstract_serve_state(cfg, shape, params, mode=mode)
    token = specs_lib.token_struct(shape, mode=mode, device=DEVICE)
    arg = rules.spec_bytes(params, rules.serve_param_specs(params, mesh),
                           mesh) \
        + rules.spec_bytes(state, rules.cache_specs(
            state, mesh, cfg.num_kv_heads, cfg.head_dim), mesh)
    rows = _rows(mesh, shape.global_batch)
    with mode:
        tree, kv_devices = _serve_params(cfg, params, mesh)
        if kv_devices is not None:    # each model shard's own KV heads
            state = model_lib.zeros_serve_state(
                cfg, shape.global_batch, cfg.encoder_ctx, shape.seq_len,
                device=DEVICE, kv_devices=kv_devices)
            state.step.fill_(shape.seq_len - 1)
        if len(rows) > 1:       # each row's own cache length: shardable
            state = model_lib.slot_layout(state, shape.global_batch)

    def run():
        with torch.no_grad(), shard_ctx.shard_program(len(rows)):
            for i, r in enumerate(rows):
                st = state if len(rows) == 1 else model_lib.slot_view(
                    state, r.start, r.stop - r.start)
                with op_cost.at(shard=i):
                    model_lib.serve_step(tree, cfg, token[r], st)
    return run, {"quant": quant}, [arg] * mesh.size


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *, mode,
               quant: str = "none",
               overrides: Optional[Dict[str, Any]] = None):
    if shape.kind == "train":
        return lower_train_cell(cfg, shape, mesh, mode=mode,
                                overrides=overrides)
    if shape.kind == "prefill":
        return lower_prefill_cell(cfg, shape, mesh, mode=mode, quant=quant)
    return lower_decode_cell(cfg, shape, mesh, mode=mode, quant=quant)


# ---------------------------------------------------------------------------
# Cell execution: build -> run under the counter -> analyze -> JSON
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape: Union[str, ShapeConfig], *,
             multi_pod: bool = False, mesh: Optional[Mesh] = None,
             cfg: Optional[ModelConfig] = None, quant: str = "none",
             out_dir: str = OUT_DIR, variant: str = "",
             verbose: bool = True,
             overrides: Optional[Dict[str, Any]] = None,
             cfg_overrides: Optional[Dict[str, Any]] = None) -> dict:
    """One cell: ``arch`` (or the config ``cfg`` under its name) at
    ``shape`` (a name or a ``ShapeConfig``) on the production mesh, or on
    ``mesh`` (abstract or of devices) where given."""
    cfg = cfg or get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_name = _mesh_name(multi_pod)
    else:
        mesh_name = _name_of(mesh)
    mesh = device_mesh(mesh)
    ok, reason = shape_applicable(cfg, shape)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "quant": quant, "variant": variant, "status": "skip",
        "reason": reason,
    }
    tag = f"{arch}__{shape.name}" + (f"__{variant}" if variant else "")
    path = os.path.join(out_dir, mesh_name, tag + ".json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if ok:
        try:
            result.update(_run(cfg, arch, shape, mesh, mesh_name,
                               quant=quant, overrides=overrides))
        except Exception as e:        # a failing cell is a bug to fix
            result.update(status="error", error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-4000:])
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    if verbose:
        _print_cell(result)
    return result


def _run(cfg: ModelConfig, arch: str, shape: ShapeConfig, mesh: Mesh,
         mesh_name: str, *, quant: str, overrides) -> dict:
    mode = specs_lib.fake_mode()
    t0 = time.time()
    program, meta, arg = lower_cell(cfg, shape, mesh, mode=mode,
                                    quant=quant, overrides=overrides)
    t_build = time.time() - t0
    memory = {"argument_bytes": int(max(arg))}
    t0 = time.time()
    with mode, shard_ctx.activation_sharding(mesh), \
            op_cost.OpCounter(mesh) as cost:
        program()
    t_run = time.time() - t0
    report = analyze_program(cost, arch=arch, shape_cfg=shape, cfg=cfg,
                             mesh_name=mesh_name, chips=mesh.size, hw=H100)
    e = report.entry
    coll = [c.raw_bytes for c in cost.collectives]
    report.arg_bytes = int(arg[e])
    memory.update(
        argument_bytes=int(arg[e]), temp_bytes=int(cost.peak[e]),
        output_bytes=0,     # the step updates its state in place
        peak_estimate_bytes=int(arg[e] + cost.peak[e]),
        entries={"argument_bytes": [int(a) for a in arg],
                 "peak_bytes": [int(a + p) for a, p in zip(arg, cost.peak)],
                 "flops": cost.flops.tolist(),
                 "bytes": cost.bytes.tolist(),
                 "collective_bytes": [int(c) for c in coll]})
    return dict(status="ok", meta=meta, build_s=round(t_build, 2),
                run_s=round(t_run, 2), memory=memory,
                kernels=cost.kernel_totals(e), roofline=report.to_dict())


def _fmt_bytes(b) -> str:
    return f"{b / 2**30:.2f}GiB" if b > 2**28 else f"{b / 2**20:.1f}MiB"


def _print_cell(r: dict):
    tag = f"{r['arch']}x{r['shape']}[{r['mesh']}]" + \
        (f"({r['variant']})" if r.get("variant") else "")
    if r["status"] == "skip":
        print(f"SKIP {tag}: {r['reason']}")
    elif r["status"] == "error":
        print(f"FAIL {tag}: {r['error']}")
    else:
        m, rf = r["memory"], r["roofline"]
        print(f"OK   {tag} run={r['run_s']:.0f}s entry={rf['entry']} "
              f"mem(arg={_fmt_bytes(m['argument_bytes'])} "
              f"temp={_fmt_bytes(m['temp_bytes'])}) "
              f"terms(c={rf['compute_s']:.4f}s m={rf['memory_s']:.4f}s "
              f"coll={rf['collective_s']:.4f}s) "
              f"bound={rf['bottleneck']} "
              f"useful={rf['useful_flop_ratio']:.2f} "
              f"roofline={rf['roofline_fraction']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=sorted(ASSIGNED))
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--quant", default="none", choices=["none", "q8_0"])
    ap.add_argument("--variant", default="", help="tag for ablation outputs")
    ap.add_argument("--attn-impl", default=None, choices=["chunked", "flash"])
    ap.add_argument("--kv-quant", default=None, choices=["none", "q8"])
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = sorted(ASSIGNED) if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in ALL_SHAPES]
              if (args.all or not args.shape) else [args.shape])
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    cfg_ov = {}
    if args.attn_impl:
        cfg_ov["attn_impl"] = args.attn_impl
    if args.kv_quant:
        cfg_ov["kv_quant"] = args.kv_quant
    if args.remat:
        cfg_ov["remat"] = args.remat
    train_ov = ({"microbatches": args.microbatches}
                if args.microbatches else None)

    n_fail = 0
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, multi_pod=multi_pod,
                             quant=args.quant, out_dir=args.out,
                             variant=args.variant, overrides=train_ov,
                             cfg_overrides=cfg_ov or None)
                n_fail += r["status"] == "error"
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
