"""The port's dry-run (``repro_torch.launch.dryrun``) and its fake-tensor
inputs (``repro_torch.launch.input_specs``), on the CPU.

- ``input_specs`` gives the reference's shapes and types, leaf for leaf,
  against ``jax.eval_shape`` of the reference's, for the smoke config of
  every family: the parameters (the reference's layer-stacked leaves
  unstacked, as ``convert.from_jax_params`` lays them out), the batch,
  the token and the decode state (each stacked leaf counted once a
  layer).
- A smoke-config train cell over an abstract (2, 2) mesh, through
  ``run_cell`` with the mesh passed in: every entry's argument bytes equal
  ``rules.entry_bytes`` of the state split on real CPU tensors; the cell
  ends "ok" with its roofline block. One split leaf's gathers report the
  hand-counted all-gather bytes at the entry that gathers.
- A decode or prefill cell with "model" > 1 ends "refused", naming ROADMAP
  item 14b, with each entry's argument bytes; on a data-only mesh it runs.
- long_500k on phi3 ends "skip" with the reference's reason, through the
  CLI, at the reference's JSON path.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME as JAX_SHAPES
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.launch import input_specs as jax_specs
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import tree
from repro_torch.core.device import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch import input_specs as specs_lib
from repro_torch.launch.mesh import Mesh, abstract_mesh
from repro_torch.roofline import analysis, op_cost
from repro_torch.sharding import rules
from repro_torch.train.step import init_train_state, split_train_state

FAMILIES = ["whisper-tiny", "phi3-mini-3.8b", "olmoe-1b-7b", "mamba2-780m",
            "jamba-v0.1-52b", "llava-next-mistral-7b"]
TRAIN = ShapeConfig("train_4k", 16, 4, "train")
DECODE = ShapeConfig("decode_32k", 32, 2, "decode")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sds(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _jsds(s):
    return tuple(s.shape), str(s.dtype)


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_input_specs_match_the_reference(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    train = JAX_SHAPES["train_4k"]
    got = specs_lib.input_specs(cfg, ShapeConfig(
        train.name, train.seq_len, train.global_batch, train.kind))
    want = jax_specs.input_specs(jcfg, train)
    # parameters: the reference's stacked leaves unstacked by the port's
    # own converter, run over zeros of the reference's shapes and types
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   want["params"])
    laid = from_jax_params(zeros, device="cpu")
    assert {p: _sds(t) for p, t in tree.leaves_with_path(got["params"])} \
        == {p: _sds(t) for p, t in tree.leaves_with_path(laid)}
    assert {k: _sds(v) for k, v in got["batch"].items()} == \
        {k: _jsds(v) for k, v in want["batch"].items()}
    assert all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
               for t in tree.leaves(got["params"]))

    jdec = JaxShape(DECODE.name, DECODE.seq_len, DECODE.global_batch,
                    DECODE.kind)
    got = specs_lib.input_specs(cfg, DECODE)
    want = jax_specs.input_specs(jcfg, jdec)
    assert _sds(got["token"]) == _jsds(want["token"])
    # the decode state: each reference leaf of its layer states stacks
    # one leaf a layer; the step is the reference's scalar, at S - 1
    ref = []
    for s in jax.tree_util.tree_leaves(want["state"].layer_states):
        ref += [(tuple(s.shape[1:]), str(s.dtype))] * s.shape[0]
    mine = [_sds(t) for t in tree.leaves(got["state"].layer_states)]
    assert sorted(mine) == sorted(ref)
    assert _sds(got["state"].step) == _jsds(want["state"].step)


def test_fake_devices_resolve_without_moving_to_the_cpu():
    with specs_lib.fake_mode():
        assert resolve_device("cuda").type == "cuda"
        assert resolve_device("cpu:3") == torch.device("cpu", 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


# ---------------------------------------------------------------------------
# run_cell
# ---------------------------------------------------------------------------
def test_train_cell_over_an_abstract_mesh(tmp_path):
    arch = "phi3-mini-3.8b"
    cfg = get_smoke_config(arch)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    r = dryrun.run_cell(arch, TRAIN, mesh=mesh, cfg=cfg, out_dir=tmp_path,
                        verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    with open(tmp_path / "mesh_2x2" / f"{arch}__train_4k.json") as f:
        assert json.load(f)["status"] == "ok"
    # what each entry holds: the state split on real tensors
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             OptimizerConfig(), max_positions=TRAIN.seq_len,
                             device="cpu")
    real = dryrun.device_mesh(mesh)
    split, specs = split_train_state(state, real)
    want = rules.entry_bytes(split, specs, real)
    ent = r["memory"]["entries"]
    assert ent["argument_bytes"] == want
    assert all(p > a for p, a in zip(ent["peak_bytes"], want))
    rf = r["roofline"]
    assert rf["chips"] == 4 and rf["bottleneck"] in (
        "compute", "memory", "collective")
    assert rf["model_flops_total"] == analysis.model_flops(cfg, TRAIN)
    assert rf["flops_per_device"] == max(ent["flops"]) > 0
    assert rf["coll_count"] > 0 and set(rf["coll_by_op"]) >= {
        "all-gather", "reduce-scatter"}
    # phi3-smoke's 4 heads and d_ff divide the model axis: each data
    # shard's second model entry computes its half of every block
    assert all(f > 0 for f in ent["flops"])
    assert ent["collective_bytes"][rf["entry"]] == rf["collective_raw_bytes"]


def test_one_leaf_gathers_hand_counted():
    mesh = dryrun.device_mesh(abstract_mesh((2, 2), ("data", "model")))
    spec = rules.P("model", "data")
    pieces = rules.split_leaf(torch.randn(64, 32), spec, mesh)
    with op_cost.OpCounter(mesh) as c:
        with op_cost.at(shard=1):
            whole = rules.gather_part(pieces, spec, mesh, "cpu")
            with op_cost.at(model=1):
                part = rules.gather_part(pieces, spec, mesh, "cpu", model=1)
    assert whole.shape == (64, 32) and part.shape == (32, 32)
    # entry (1, 0) gathered all four parts, entry (1, 1) the two of its
    # model part; nothing else reported anything
    g0, g1 = c.collectives[2], c.collectives[3]
    assert g0.by_op == {"all-gather": 64 * 32 * 4}
    assert g0.wire_bytes == 3 / 4 * 64 * 32 * 4
    assert g1.by_op == {"all-gather": 32 * 32 * 4}
    assert g1.wire_bytes == 1 / 2 * 32 * 32 * 4
    assert c.collectives[0].count == c.collectives[1].count == 0


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_serving_over_model_is_refused(tmp_path, kind):
    """Serving cells over "model" run (the name is kept from when they
    were refused): each entry's argument bytes are what
    ``serve_param_specs`` and ``cache_specs`` (or ``batch_specs``) give
    it, every entry computes, and the split sub-blocks' partial sums and
    the vocabulary's gathers are reported as collectives."""
    arch = "whisper-tiny"
    cfg = get_smoke_config(arch)
    shape = DECODE if kind == "decode" else ShapeConfig(
        "prefill_32k", 16, 2, "prefill")
    mesh = abstract_mesh((2, 2), ("data", "model"))
    r = dryrun.run_cell(arch, shape, mesh=mesh, cfg=cfg, out_dir=tmp_path,
                        verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    mode = specs_lib.fake_mode()
    params = specs_lib.abstract_params(cfg, shape, mode=mode,
                                         device="cpu")
    want = rules.spec_bytes(params, rules.serve_param_specs(params, mesh),
                            mesh)
    if kind == "decode":
        state = specs_lib.abstract_serve_state(cfg, shape, params,
                                                 mode=mode)
        want += rules.spec_bytes(state, rules.cache_specs(
            state, mesh, cfg.num_kv_heads, cfg.head_dim), mesh)
    else:
        batch = specs_lib.batch_specs_struct(cfg, shape, mode=mode,
                                               device="cpu")
        want += rules.spec_bytes(batch, rules.batch_specs(batch, mesh),
                                 mesh)
    e = r["memory"]["entries"]
    assert e["argument_bytes"] == [want] * 4
    assert min(e["flops"]) > 0
    assert min(e["collective_bytes"]) > 0


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_serving_on_a_data_only_mesh_runs(tmp_path, kind):
    arch = "phi3-mini-3.8b"
    shape = DECODE if kind == "decode" else ShapeConfig(
        "prefill_32k", 16, 2, "prefill")
    r = dryrun.run_cell(arch, shape, mesh=abstract_mesh(
        (2, 1), ("data", "model")), cfg=get_smoke_config(arch),
        out_dir=tmp_path, verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    flops = r["memory"]["entries"]["flops"]
    assert flops[0] == flops[1] > 0          # one data shard's rows each


def test_long_context_skips_a_full_attention_arch(tmp_path):
    assert dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    with open(tmp_path / "pod_16x16" / "phi3-mini-3.8b__long_500k.json") as f:
        r = json.load(f)
    assert r["status"] == "skip" and "full-attention" in r["reason"]


def test_device_mesh_keeps_a_mesh_of_devices():
    m = Mesh((2, 1), ("data", "model"), ["cpu", "cpu"])
    assert dryrun.device_mesh(m) is m
    assert dryrun.device_mesh(abstract_mesh((1, 2), ("data", "model"))
                              ).physical_devices == [torch.device("cpu")]
