"""Expert parallelism and the vocabulary split of the mesh training step
on the CPU (``repro_torch.models.moe.expert_parallel``,
``sharding.rules.tp_layout``/``vocab_layout``, ``models.model``'s
``_ce_of_shards`` and ``layers.VocabShards``), at the smoke sizes.

- Each model shard's ``_experts`` runs on E / M experts on its own
  device, over (1, 2) and (1, 4) meshes of distinct ``cpu:i`` devices.
- The expert-parallel MoE block's forward is the whole block's bit for
  bit in f32 (``torch.equal``), drops included, and so are its input and
  weight gradients: a slot belongs to one expert, so nothing is summed
  across the shards, and each expert's batched product over its slots is
  the same product whatever the batch count of the ``bmm`` around it.
- The split CE equals ``_ce_of_logits`` within 1e-6 with pad columns and
  labels of -1, its gradients too; the split embedding equals the whole
  lookup bit for bit. A vocabulary that does not divide the model axis
  stays whole, with its reason, and the step still equals the unsharded
  step; a padded one splits with its pad columns on the last shard.
- ``op_cost`` on fake tensors of one olmoe-1b-7b MoE layer at its
  published widths over an abstract (1, 4) mesh: each model entry's
  expert FLOPs and gathered expert bytes are a quarter of the whole
  layer's (0.81 GB), the router's FLOPs stay on entry 0, and each entry
  reports its all-to-all.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import tree
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, abstract_mesh
from repro_torch.models import layers, model as model_lib, moe as moe_lib
from repro_torch.models import transformer
from repro_torch.roofline import op_cost
from repro_torch.sharding import ctx, rules
from repro_torch.train.step import init_train_state, mesh_value_and_grad, \
    split_train_state, value_and_grad

CPU = torch.device("cpu")
DISTINCT = [torch.device("cpu", i) for i in range(4)]
B, S = 4, 16
OPT = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for these small tensors (see
    ``test_torch_train_tp.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    labels[:, :2] = -1
    return {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)),
            "labels": torch.from_numpy(labels.astype(np.int32))}


def _state(cfg):
    return init_train_state(torch.Generator().manual_seed(0), cfg, OPT, 64,
                            device="cpu")


def _spy(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        log.append((args, kwargs))
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("m", [2, 4])
def test_each_model_shard_runs_its_experts_on_its_own_device(monkeypatch, m):
    """A mesh step over (1, m) distinct devices: each MoE layer's forward
    runs ``expert_parallel`` over the m entries' devices, whose
    ``_experts`` calls, in shard order, each take E / m experts' slots and
    slices; each shard's slices of the three expert stacks are gathered
    as model part m onto entry (0, m)'s device, and the router whole onto
    entry (0, 0)'s. (CPU tensors carry no device index: the devices are
    read where the code names them.)"""
    cfg = get_smoke_config("olmoe-1b-7b")
    mesh = Mesh((1, m), ("data", "model"), DISTINCT[:m])
    split, specs = split_train_state(_state(cfg), mesh)
    owner = {t.data_ptr(): path for path, x in tree.leaves_with_path(
        split.params, is_leaf=rules.is_pieces) for t in x}
    runs, calls, gathers = [], [], []
    _spy(monkeypatch, moe_lib, "expert_parallel", runs)
    _spy(monkeypatch, moe_lib, "_experts", calls)
    _spy(monkeypatch, rules, "gather_part", gathers)
    mesh_value_and_grad(cfg, split.params, _batch(cfg), specs.params, mesh)
    per = cfg.moe.num_experts // m
    assert len(runs) == cfg.num_layers
    assert all(list(a[3]) == DISTINCT[:m] for a, _ in runs)
    assert len(calls) == m * cfg.num_layers
    for args, _ in calls:
        assert args[2].shape[1] == per
        assert {k: v.shape[0] for k, v in args[0].items()} == {
            "w_up": per, "w_gate": per, "w_down": per}
    moe = {}
    for args, kw in gathers:
        path = owner[args[0][0].data_ptr()]
        if "moe" in path:
            moe.setdefault(path[-1], []).append((kw.get("model"), args[3]))
    for leaf in ("w_up", "w_gate", "w_down"):
        assert sorted(moe[leaf], key=str) == sorted(
            [(i, DISTINCT[i]) for i in range(m)] * cfg.num_layers, key=str)
    assert set(moe["w"]) == {(None, DISTINCT[0])}        # the router


@pytest.mark.parametrize("arch,capacity", [("olmoe-1b-7b", 1.25),
                                           ("olmoe-1b-7b", 0.5),
                                           ("arctic-480b", 1.25)])
def test_expert_parallel_block_is_the_whole_block_bit_for_bit(arch,
                                                              capacity):
    """``moe_ffn`` with its experts split over 2 and 4 model shards of
    distinct devices equals the whole layer's in f32 with ``torch.equal``:
    its output and load-balance loss, and the gradients of x and of every
    expert leaf (capacity 0.5 drops tokens; arctic adds its dense branch,
    whole on the first device)."""
    base = get_smoke_config(arch)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=capacity))
    p = moe_lib.init_moe(torch.Generator().manual_seed(1), cfg,
                         torch.float32)
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    dy = torch.randn(B, S, cfg.d_model,
                     generator=torch.Generator().manual_seed(3))
    keys = [k for k in rules.EXPERT_LEAVES if k in p]

    def run(m):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items() if k in keys}
        xx = x.clone().requires_grad_(True)
        whole = {**p, **leaves}
        if m == 1:
            y, aux = moe_lib.moe_ffn(whole, cfg, xx)
        else:
            per = cfg.moe.num_experts // m
            parts = [{k: v[i * per:(i + 1) * per].to(DISTINCT[i])
                      for k, v in leaves.items()} for i in range(m)]
            y, aux = moe_lib.moe_ffn(whole, cfg, xx, experts=parts,
                                     devices=DISTINCT[:m])
        grads = torch.autograd.grad((y * dy).sum() + aux,
                                    [xx] + [leaves[k] for k in keys])
        return y.detach(), aux.detach(), grads
    want = run(1)
    for m in (2, 4):
        got = run(m)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for g, w in zip(got[2], want[2], strict=True):
            assert torch.equal(g, w)


def _ce_case(m, v_stored, vocab, seed=0):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(v_stored, 32, generator=gen)
    x = torch.randn(3, 7, 32, generator=gen)
    labels = torch.randint(0, vocab, (3, 7), generator=gen)
    labels[0, :3] = -1
    return w, x, labels


@pytest.mark.parametrize("m", [2, 4])
def test_split_ce_equals_the_whole_ce(m):
    """A stored vocabulary of 24 rows, 21 of them real (3 pad columns on
    the last shard), labels of -1 masked: the split CE's two sums and the
    gradients of x and W within 1e-6 of ``_ce_of_logits``'s of the whole
    readout; the split embedding bit for bit the whole lookup."""
    w, x, labels = _ce_case(m, 24, 21)
    per = 24 // m

    def run(split):
        ww, xx = (t.clone().requires_grad_(True) for t in (w, x))
        if split:
            shards = layers.VocabShards(
                tuple(ww[i * per:(i + 1) * per].to(DISTINCT[i])
                      for i in range(m)), tuple(DISTINCT[:m]))
            cs, nt = model_lib._ce_of_shards(shards, xx, labels, 21)
        else:
            cs, nt = model_lib._ce_of_logits(xx @ ww.t(), labels, 21)
        gx, gw = torch.autograd.grad(cs, (xx, ww))
        return cs.detach(), nt, gx, gw
    want, got = run(False), run(True)
    assert float(got[1]) == float(want[1]) == 18.0
    assert abs(float(got[0] - want[0])) <= 1e-6 * abs(float(want[0]))
    for g, ref in zip(got[2:], want[2:]):
        assert float((g - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    ids = torch.randint(0, 24, (3, 7), generator=torch.Generator())
    shards = layers.VocabShards(tuple(w[i * per:(i + 1) * per]
                                      for i in range(m)), (CPU,) * m)
    assert torch.equal(layers.embed({"table": shards}, ids), w[ids])


@pytest.mark.parametrize("vocab,pad,why", [(509, 0, rules.VOCAB),
                                           (509, 3, rules.SPLIT)])
def test_vocabulary_split_or_whole_by_its_stored_rows(vocab, pad, why):
    """phi3's smoke config with 509 real tokens over (1, 2): unpadded the
    vocabulary does not divide and runs whole, counted with the reason;
    padded to 512 it splits (its 3 pad columns on the second shard). The
    mesh step's loss within 1e-5 of the unsharded step's and every
    gradient within 1e-4 of its leaf's largest, either way."""
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              vocab_size=vocab, vocab_pad=pad)
    mesh = Mesh((1, 2), ("data", "model"), DISTINCT[:2])
    whole = _state(cfg)
    split, specs = split_train_state(
        init_train_state(torch.Generator().manual_seed(0), cfg, OPT, 64,
                         device="cpu"), mesh)
    assert rules.vocab_layout(cfg, specs.params, mesh) == why
    batch = _batch(cfg)
    rules.TP_BLOCKS.clear()
    mloss, _, mgrads = mesh_value_and_grad(cfg, split.params, batch,
                                           specs.params, mesh)
    assert rules.TP_BLOCKS[(rules.VOCAB_KEY, why)] == 1
    loss, _, grads = value_and_grad(cfg, whole.params, batch)
    assert float(mloss) == pytest.approx(float(loss), rel=1e-5)
    for (path, w), g in zip(tree.leaves_with_path(grads), tree.leaves(
            rules.gather_tree(mgrads, specs.params, mesh, CPU)),
            strict=True):
        assert float((g - w).abs().max()) <= \
            1e-4 * float(w.abs().max()), path


def test_olmoe_layer_costs_a_quarter_an_entry_over_a_model_axis_of_4():
    """One olmoe-1b-7b MoE layer at its published widths (64 experts of
    2048 x 1024, bf16) on fake tensors over an abstract (1, 4) mesh, one
    row of 2048 tokens (4 dispatch groups, C = 80): each model entry
    gathers 16 experts' slices, a quarter of the layer's 0.81 GB, and
    runs a quarter of its expert products; entry 0 adds the router's
    product; each entry reports its dispatch and combine as all-to-alls."""
    cfg = get_config("olmoe-1b-7b")
    mesh = dryrun.device_mesh(abstract_mesh((1, 4), ("data", "model")))
    devices = [CPU] * 4
    d, dff, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    with FakeTensorMode() as mode:
        p = moe_lib.init_moe(torch.Generator().manual_seed(0), cfg)
        block = {"moe": p}
        sp = rules.param_specs({"stack": {"blocks": [block]}},
                               mesh)["stack"]["blocks"][0]
        pieces = dryrun.empty_split(block, sp, mesh)
        x = torch.empty((1, 2048, d), dtype=torch.bfloat16)
    layout = rules.tp_layout(cfg, sp, mesh)
    assert layout == {"moe": rules.SPLIT}
    gathered = np.zeros(4)
    real = rules.gather_part

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        if kwargs.get("model") is not None:
            gathered[op_cost.active().entries()] += out.numel() * 2
        return out
    rules.gather_part = spy
    try:
        with mode, op_cost.OpCounter(mesh) as c, op_cost.at(shard=0):
            whole, parts = rules.gather_block(pieces, sp, mesh, devices,
                                              layout)
            y, _ = transformer.moe_ffn(whole["moe"], cfg, x,
                                       parts.get("moe"), devices, None,
                                       None)
    finally:
        rules.gather_part = real
    assert y.shape == x.shape
    stacks = 3 * e * d * dff * 2
    assert stacks == 805_306_368                      # 0.81 GB
    assert list(gathered) == [stacks / 4] * 4
    slots = 4 * 80                                    # G x C
    expert_flops = 3 * 2 * slots * d * dff * e // 4
    router = 2 * 2048 * d * e
    assert list(c.matmul_flops) == [expert_flops + router] + \
        [expert_flops] * 3
    moved = 4 * (e // 4) * 80 * d * 2
    for m in range(4):
        assert c.collectives[m].by_op["all-to-all"] == 2 * moved


def test_remat_recompute_runs_in_the_forwards_shard_program():
    """A remat unit's recompute sees the data-shard count its forward ran
    under (``ctx.shard_program``, which sizes a MoE layer's capacity from
    the whole step's tokens), though the backward runs outside that scope:
    on the card the autograd engine recomputes on its device thread,
    where the forward's thread-local scope is not set."""
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), remat="full")
    seen = []

    def fn(x):
        seen.append(ctx.batch_shards())
        return x * x * seen[-1]
    unit = transformer.remat(fn, cfg)
    x = torch.ones(3, requires_grad=True)
    with ctx.shard_program(2):
        y = unit(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert seen == [2, 2] and torch.equal(g, torch.full((3,), 4.0))
