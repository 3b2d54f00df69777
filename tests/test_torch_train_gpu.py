"""Training on a CUDA device: the flash forward's logsumexp and the flash-2
backward (``flash_attention_bwd``) against their plain versions at every
head size the kernels are built for, causal and not, ragged Sq and Sk,
f32 and bf16, every bf16 case on the tensor-core route and every f32 one
on the SIMT route; two launches of the backward bit for bit equal;
strided operands (free (BH, S) strides, an out, dout or lse whose last
stride is not 1, bf16 rows off a 16-byte boundary) equal bit for bit to
contiguous ones; the forward's output unchanged by asking for the
logsumexp; ``_FlashCore``'s
gradients against autograd through the plain forward; and a 3-step smoke
``Trainer`` on the card under ``attn_impl="flash"`` whose every gradient
leaf is non-zero (a flash forward without a backward would leave q, k
and v without one through attention); the same Trainer over the smoke
mesh of four ``cuda:0`` entries against the unsharded one; a model
shard's two products (an f32 output, an f32 input gradient) against
float64; the training CLI on the card; olmoe's smoke Trainer over (1,
2) and (2, 2) meshes of the card, its experts and vocabulary split over
the model shards, against the unsharded one; and its drop case over a
(2, 1) mesh of the card, whose capacity claim spans the data shards
(they run in lockstep threads), against the unsharded one.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_train_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain)

# kernel vs plain, of the largest magnitude of each output: f32 sums in
# another order (2e-5); in bf16 the outputs round to bf16 (2^-8 relative)
# after sums that may differ in their last f32 bits (1e-2)
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# bf16, each output's mean |kernel - plain| over its mean magnitude
# (chip_smoke.py's FLASH_BWD_MEAN_TOL): the two roundings to bf16 differ
# in few elements; a dS rounded once to bf16 before the dK and dQ
# products, instead of entering them as hi + lo, moves most of them
MEAN_TOL = 1e-4
# (bh, sq, sk, d, causal): every head size; ragged lengths; a block of one
# query; cross-attention lengths (sk != sq, not causal); at D = 96 and 128
# lengths that are multiples of neither 16 nor 64, causal and not
SHAPES = [(3, 101, 101, 16, True), (2, 64, 64, 32, True),
          (2, 130, 130, 64, True), (3, 45, 200, 16, False),
          (2, 100, 77, 96, False), (2, 150, 150, 96, True),
          (2, 129, 129, 128, True), (1, 1, 64, 32, False),
          (2, 83, 83, 96, True), (2, 75, 141, 128, False),
          (2, 203, 203, 128, True), (2, 141, 75, 96, False)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _operands(bh, sq, sk, d, dtype, dev, seed=0):
    """q, k, v, dout drawn with numpy from ``seed`` in ``dtype`` on
    ``dev``."""
    rng = np.random.default_rng(seed + sq + sk + d)
    return [torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dev, getattr(torch, dtype))
        for s in (sq, sk, sk, sq)]


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _mean_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().mean()
                 / want.abs().mean().clamp(min=1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,d,causal", SHAPES)
def test_forward_lse_matches_plain_and_keeps_the_output(bh, sq, sk, d,
                                                        causal, dtype):
    dev = _cuda_or_skip()
    q, k, v, _ = _operands(bh, sq, sk, d, dtype, dev)
    plain = flash_attention_fwd(q, k, v, causal=causal)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    _, want = flash_attention_fwd_plain(q, k, v, causal=causal,
                                        return_lse=True)
    assert lse.shape == (bh, sq) and lse.dtype == torch.float32
    # the card's exp and log against PyTorch's, a few f32 ulps of |lse|
    np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,d,causal", SHAPES)
def test_backward_matches_plain_and_repeats_bit_for_bit(bh, sq, sk, d,
                                                        causal, dtype):
    dev = _cuda_or_skip()
    q, k, v, dout = _operands(bh, sq, sk, d, dtype, dev)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    out = out.to(q.dtype)
    before = flash_attention_bwd.launches
    routes = dict(flash_attention_bwd.launches_by_route)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    again = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    route = "mma" if dtype == "bfloat16" else "simt"
    assert {r: n - routes[r] for r, n in
            flash_attention_bwd.launches_by_route.items()} == {
        "mma": 0, "simt": 0, route: 2}
    want = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=causal)
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, a), f"d{name} differs between launches"
        assert _rel_err(g, w) <= TOL[dtype], (name, _rel_err(g, w))
        if dtype == "bfloat16":
            assert _mean_err(g, w) <= MEAN_TOL, (name, _mean_err(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_takes_strided_operands(causal, dtype):
    """(BH, S, D) views of (B, S, H, D) tensors, as ``_flash_attention``
    folds them at B = 1; an out, dout or lse whose last stride is not 1;
    and (bf16) rows one element off a 16-byte boundary: each gives the
    bits of its contiguous copies, on the dtype's route."""
    dev = _cuda_or_skip()
    h, s, d = 4, 150, 96
    rng = np.random.default_rng(7)

    def heads():           # (1, S, H, D) folded to a (H, S, D) view
        x = rng.standard_normal((1, s, h, d)).astype(np.float32)
        return torch.from_numpy(x).to(dev, getattr(torch, dtype)).transpose(
            1, 2).reshape(h, s, d)
    q, k, v, dout = heads(), heads(), heads(), heads()
    assert not q.is_contiguous()
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    out = out.to(q.dtype).transpose(0, 1).contiguous().transpose(0, 1)
    assert not out.is_contiguous()
    flat = flash_attention_bwd(*(t.contiguous() for t in
                                 (q, k, v, out, dout)), lse, causal=causal)

    def last_strided(t):   # the same values, stride 1 along S, not D
        return t.transpose(-1, -2).contiguous().transpose(-1, -2)

    def shifted(t):        # the same values, rows 2 bytes off a boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    cases = [(q, k, v, out, dout, lse),
             (q, k, v, last_strided(out), dout, lse),
             (q, k, v, out, last_strided(dout), lse),
             (q, k, v, out, dout, last_strided(lse))]
    if dtype == "bfloat16":
        cases.append((*(shifted(t) for t in (q, k, v, out, dout)), lse))
    route = "mma" if dtype == "bfloat16" else "simt"
    for args in cases:
        before = flash_attention_bwd.launches_by_route[route]
        got = flash_attention_bwd(*args, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches_by_route[route] == before + 1
        for g, f in zip(got, flat):
            assert g.is_contiguous() and torch.equal(g, f)


@pytest.mark.gpu
def test_every_head_size_is_covered_and_others_refused():
    dev = _cuda_or_skip()
    assert {s[3] for s in SHAPES} == set(HEAD_DIMS)
    q, k, v, dout = _operands(1, 8, 8, 48, "float32", dev)
    lse = torch.zeros((1, 8), device=dev)
    with pytest.raises(ValueError, match="head size"):
        flash_attention_bwd(q, k, v, q, dout, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_core_gradients_match_autograd_through_plain(dtype):
    """``_flash_attention`` (``_FlashCore``, GQA repeat and fold included)
    against autograd through the plain forward's loop on the same
    folded operands."""
    dev = _cuda_or_skip()
    from repro_torch.models.attention import _flash_attention, \
        _repeat_kv_heads
    rng = np.random.default_rng(3)
    b, s, hq, hkv, d = 2, 96, 4, 2, 32
    shapes = [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)]
    leaves = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
              .to(dev, getattr(torch, dtype)) for sh in shapes]
    w = torch.from_numpy(rng.standard_normal((b, s, hq, d)).astype(
        np.float32)).to(dev)

    def grads(fn):
        q, k, v = (t.clone().requires_grad_(True) for t in leaves)
        loss = (fn(q, k, v).float() * w).sum()
        return torch.autograd.grad(loss, (q, k, v))

    def plain(q, k, v):
        k, v = _repeat_kv_heads(k, hq), _repeat_kv_heads(v, hq)

        def fold(t):
            return t.transpose(1, 2).reshape(b * hq, s, d)
        out = flash_attention_fwd_plain(fold(q), fold(k), fold(v),
                                        causal=True).to(q.dtype)
        return out.reshape(b, hq, s, d).transpose(1, 2)

    before = flash_attention_bwd.launches
    got = grads(lambda q, k, v: _flash_attention(q, k, v, causal=True))
    assert flash_attention_bwd.launches == before + 1
    want = grads(plain)
    for name, g, x in zip("qkv", got, want):
        assert _rel_err(g, x) <= TOL[dtype], (name, _rel_err(g, x))


@pytest.mark.gpu
def test_tensor_parallel_products_on_the_card():
    """The two products a model shard of a bf16 mesh step runs on the
    card (``models/layers.py``), against float64 on the same bf16 values:
    ``f32_out`` (``_F32Product``) an f32 output within 1e-4 of its
    largest magnitude, its input and weight gradients bf16 within 2^-7;
    ``f32_grad`` (``_F32GradProduct``) a bf16 output within 2^-7, its
    input gradient f32 within 1e-4 and its weight gradient bf16 within
    2^-7."""
    dev = _cuda_or_skip()
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    x, w, dy = (torch.randn(s, generator=gen).to(bf)
                for s in ((2, 96, 512), (384, 512), (2, 96, 384)))
    want_y = x.double() @ w.double().t()
    want_dx = dy.double() @ w.double()
    want_dw = (dy.double().reshape(-1, 384).t()
               @ x.double().reshape(-1, 512))

    def rel(got, want):
        return float((got.double().cpu() - want).abs().max()) / float(
            want.abs().max())

    wd = w.to(dev).requires_grad_(True)
    xd = x.to(dev).requires_grad_(True)
    y = layers.linear({"w": wd}, xd, f32_out=True)
    dx, dw = torch.autograd.grad(y, (xd, wd), dy.to(dev).float())
    assert (y.dtype, dx.dtype, dw.dtype) == (torch.float32, bf, bf)
    assert rel(y.detach(), want_y) <= 1e-4
    assert rel(dx, want_dx) <= 2.0 ** -7
    assert rel(dw, want_dw) <= 2.0 ** -7

    x32 = x.to(dev).float().requires_grad_(True)
    y = layers.linear({"w": wd}, x32, f32_grad=True)
    dx, dw = torch.autograd.grad(y, (x32, wd), dy.to(dev))
    assert (y.dtype, dx.dtype, dw.dtype) == (bf, torch.float32, bf)
    assert rel(y.detach(), want_y) <= 2.0 ** -7
    assert rel(dx, want_dx) <= 1e-4
    assert rel(dw, want_dw) <= 2.0 ** -7


@pytest.mark.gpu
def test_smoke_trainer_on_the_card_gives_every_leaf_a_gradient(tmp_path):
    """Three steps of the phi3 smoke config under flash attention and full
    remat on the card: finite losses, the flash backward launched, and a
    non-zero gradient on every parameter leaf of the last step."""
    dev = _cuda_or_skip()
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (
        OptimizerConfig, RunConfig, ShapeConfig)
    from repro_torch.core import tree
    from repro_torch.models import model
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              attn_impl="flash", remat="full")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 2, "train"),
                    optimizer=OptimizerConfig(lr=5e-3, warmup_steps=1,
                                              total_steps=10),
                    steps=3, checkpoint_every=100,
                    checkpoint_dir=str(tmp_path / "c"))
    before = flash_attention_bwd.launches
    tr = Trainer(run, device=dev, vocab_cap=64)
    tr.train()
    assert flash_attention_bwd.launches - before == 3 * cfg.num_layers
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    batch = tr.stream.batch_at(3)
    params = tr.state.params
    leaves = tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    assert all(bool(g.abs().sum() > 0) for g in grads)


@pytest.mark.gpu
def test_cli_trains_whisper_on_the_card(tmp_path, capsys):
    """The training CLI on the card (weights drawn there, Whisper's
    positional table included)."""
    _cuda_or_skip()
    from repro_torch.launch import train as train_cli
    assert train_cli.main(["--arch", "whisper-tiny", "--steps", "2",
                           "--ckpt-every", "1",
                           "--ckpt-dir", str(tmp_path / "c")]) == 0
    assert capsys.readouterr().out.startswith("final:")



@pytest.mark.gpu
def test_smoke_mesh_of_the_card_matches_the_unsharded_trainer(tmp_path):
    """``Trainer(mesh=)`` over the reference's smoke mesh of four
    ``cuda:0`` entries, (2, 2): the phi3 smoke config under flash
    attention and full remat, three steps from the unsharded Trainer's
    init: losses within 1e-5 of the unsharded Trainer's on the card (each
    data shard's attention and FFN split over its 2 model shards, whose
    partial products are summed in f32), every parameter within 1e-4 of
    its leaf's largest, each (data, model) shard launching the flash
    backward once a layer a step; the state
    split by its specs, replicas on the one card stored once; the
    whole-leaf checkpoint restored onto the mesh bit for bit."""
    dev = _cuda_or_skip()
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (
        OptimizerConfig, RunConfig, ShapeConfig)
    from repro_torch.core import tree
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              attn_impl="flash", remat="full")

    def run(name):
        return RunConfig(model=cfg, shape=ShapeConfig("t", 64, 2, "train"),
                         optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                   total_steps=10),
                         steps=3, checkpoint_every=100,
                         checkpoint_dir=str(tmp_path / name))
    one = Trainer(run("one"), device=dev, vocab_cap=64)
    one.train()
    mesh = make_smoke_mesh([dev] * 4)
    before = flash_attention_bwd.launches
    tr = Trainer(run("mesh"), mesh=mesh, vocab_cap=64)
    tr.train()
    assert flash_attention_bwd.launches - before == \
        2 * 2 * 3 * cfg.num_layers
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in one.history], rtol=1e-5)
    whole = tr.whole_state()
    for (path, w), g in zip(tree.leaves_with_path(one.state.params),
                            tree.leaves(whole.params), strict=True):
        assert _rel_err(g, w) <= 1e-4, path
    assert rules.entry_bytes(tr.state, tr.specs, mesh) == [
        rules.spec_bytes(whole, tr.specs, mesh)] * 4
    assert all(len(p) == int(np.prod(mesh.parts(s))) for p, s in zip(
        tree.leaves(tr.state, is_leaf=rules.is_pieces),
        tree.leaves(tr.specs, is_leaf=rules.is_spec)))
    last = ckpt_lib.latest_checkpoint(str(tmp_path / "mesh"))
    back, _ = ckpt_lib.load_checkpoint(last, whole, mesh=mesh,
                                       specs=tr.specs)
    for a, b in zip(tree.leaves(back), tree.leaves(tr.state), strict=True):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)])
def test_expert_parallel_mesh_of_the_card_matches_the_unsharded_trainer(
        tmp_path, sizes):
    """``Trainer(mesh=)`` over a (1, 2) and a (2, 2) mesh of ``cuda:0``
    entries on olmoe's smoke config (capacity factor E / k: nothing
    drops) under flash attention and full remat, two steps from the
    unsharded Trainer's init: every MoE layer's experts split over the
    model shards (2 of 4 a shard) and the vocabulary too, each
    ``_experts`` call over 2 experts; the losses and gradient norms of
    both steps within 1e-5 of the unsharded Trainer's on the card (the
    second step's loss reads the first update)."""
    dev = _cuda_or_skip()
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (
        OptimizerConfig, RunConfig, ShapeConfig)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.sharding import rules
    from repro_torch.train.trainer import Trainer
    base = get_smoke_config("olmoe-1b-7b")
    cfg = dataclasses.replace(
        base, attn_impl="flash", remat="full",
        moe=dataclasses.replace(base.moe, capacity_factor=(
            base.moe.num_experts / base.moe.experts_per_token)))

    def run(name):
        return RunConfig(model=cfg, shape=ShapeConfig("t", 64, 2, "train"),
                         optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                   total_steps=10),
                         steps=2, checkpoint_every=100,
                         checkpoint_dir=str(tmp_path / name))
    one = Trainer(run("one"), device=dev, vocab_cap=64)
    one.train()
    mesh = Mesh(sizes, ("data", "model"), [dev] * (sizes[0] * sizes[1]))
    experts = []
    real = moe_lib._experts

    def spy(p, c, xe):
        experts.append(xe.shape[1])
        return real(p, c, xe)
    rules.TP_BLOCKS.clear()
    moe_lib._experts = spy
    try:
        tr = Trainer(run("mesh"), mesh=mesh, vocab_cap=64)
        tr.train()
    finally:
        moe_lib._experts = real
    assert rules.TP_BLOCKS[("moe", rules.SPLIT)] == \
        2 * sizes[0] * cfg.num_layers
    assert rules.TP_BLOCKS[("vocab", rules.SPLIT)] == 2 * sizes[0]
    assert set(experts) == {cfg.moe.num_experts // sizes[1]}
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in tr.history],
                                   [h[key] for h in one.history], rtol=1e-5)


@pytest.mark.gpu
def test_moe_claim_spanning_shards_runs_in_lockstep_on_the_card(tmp_path):
    """olmoe's smoke config at capacity factor 0.5 under flash attention
    and full remat: each of two data shards of a (2, 1) mesh of the card
    holds 64 tokens, below the dispatch group, whose claim can drop, so
    the shards run in lockstep threads and join their expert choices at
    every MoE layer (the recompute replays them); two steps' losses and
    gradient norms within 1e-5 of the unsharded Trainer's on the card."""
    dev = _cuda_or_skip()
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (
        OptimizerConfig, RunConfig, ShapeConfig)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.train.trainer import Trainer
    base = get_smoke_config("olmoe-1b-7b")
    cfg = dataclasses.replace(
        base, attn_impl="flash", remat="full",
        moe=dataclasses.replace(base.moe, capacity_factor=0.5))
    assert moe_lib.spans_shards(cfg, 64, 2)

    def run(name):
        return RunConfig(model=cfg, shape=ShapeConfig("t", 64, 2, "train"),
                         optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                   total_steps=10),
                         steps=2, checkpoint_every=100,
                         checkpoint_dir=str(tmp_path / name))
    one = Trainer(run("one"), device=dev, vocab_cap=64)
    one.train()
    joins = []
    real = moe_lib._joint_claim

    def spy(*a):
        joins.append(a[0].device)
        return real(*a)
    moe_lib._joint_claim = spy
    try:
        tr = Trainer(run("mesh"), mesh=Mesh((2, 1), ("data", "model"),
                                            [dev] * 2), vocab_cap=64)
        tr.train()
    finally:
        moe_lib._joint_claim = real
    assert joins and all(d.type == "cuda" for d in joins)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in tr.history],
                                   [h[key] for h in one.history], rtol=1e-5)
