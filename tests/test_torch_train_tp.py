"""Tensor-parallel compute and the per-layer gather of the mesh training
step on the CPU (``repro_torch.train.step`` over ``sharding.rules.tp_layout``
and ``gather_block``), at the smoke sizes.

Meshes: (1, 2) and (2, 2) of repeated ``cpu`` entries, and (2, 2) of four
distinct ``cpu:i`` entries.

- For every family (phi3-mini, whisper-tiny, olmoe with room for every
  token, jamba, llava and arctic with two KV heads, so that their
  attention splits; the MoE layers' experts and arctic's dense branch
  split too, and every vocabulary): one step's loss within 1e-5 of the unsharded step's, every
  gradient within 1e-4 of its leaf's largest magnitude (a leaf whose
  exact gradient is zero, the key bias, within 1e-6 of the largest
  gradient), and every parameter and f32 moment after the update within
  1e-4 of its leaf's largest. The key bias's parameter takes an Adam
  step of noise over noise and is held within 2 lr; so are at most two
  elements of a parameter leaf whose gradient is under 10 Adam eps,
  where Adam's step lr g / (|g| + eps) is steep.
- The split is real: on (1, 2) each model shard's attention runs Hq / 2
  query heads, and its slices, and its rows of the embedding and the
  readout, are gathered onto its own entry's device.
- The smoke qwen (one KV head) runs its attention whole and its FFN
  split, and ``TP_BLOCKS`` names the reason; the SSD mixer runs whole,
  counted by its own; MoE experts, arctic's dense branch and the
  vocabulary are counted split.
- Gathers: under ``remat="full"`` every block leaf is gathered twice a
  step onto each (data, model) entry that reads it, under ``"none"``
  once, the leaves outside the blocks once a data shard; no code path
  gathers a whole tree or calls ``gather_leaf``.
- ``gather_part`` against slicing, and its backward region by region;
  ``tp_layout`` and ``vocab_layout`` at the published widths on the
  production mesh (olmoe's 64 and arctic's 128 experts split) and on a
  model axis of 3 that neither olmoe's experts nor whisper's vocabulary
  divide.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import OptimizerConfig, reduced
from repro_torch.core import tree
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import layers, transformer
from repro_torch.sharding import rules
from repro_torch.train.step import init_train_state, make_train_step, \
    mesh_value_and_grad, split_train_state, value_and_grad

CPU = torch.device("cpu")
DISTINCT = [torch.device("cpu", i) for i in range(4)]
MESHES = {"1x2": ((1, 2), [CPU] * 2), "2x2": ((2, 2), [CPU] * 4),
          "2x2-distinct": ((2, 2), DISTINCT)}
FAMILIES = ["phi3-mini-3.8b", "whisper-tiny", "olmoe-1b-7b",
            "jamba-v0.1-52b", "llava-next-mistral-7b", "arctic-480b"]
#: the smoke configs that keep one KV head (their GQA ratio), given two
TWO_KV = ("jamba-v0.1-52b", "llava-next-mistral-7b", "arctic-480b")
B, S, PATCHES = 4, 16, 4
OPT = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for these small tensors: beside the JAX runtime
    that the test session imports, its thread pool spins the host's cores
    and the same step takes tens of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(name):
    sizes, devs = MESHES[name]
    return Mesh(sizes, ("data", "model"), devs)


def _cfg(arch):
    """The smoke config; jamba's, llava's and arctic's with two KV heads
    (their smoke configs keep one, the GQA ratio), a MoE's capacity factor
    E / k, so that nothing drops."""
    if arch in TWO_KV:
        cfg = reduced(get_config(arch), num_kv_heads=2)
    else:
        cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.experts_per_token))
    return cfg


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
              "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    arrays["labels"][:, :2] = -1
    if cfg.family == "audio":
        arrays["mel"] = rng.standard_normal((B, S, cfg.n_mels)).astype(
            np.float32)
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (B, PATCHES, cfg.vision_embed_dim)).astype(np.float32)
    return {k: torch.from_numpy(v.astype(np.int32) if v.dtype == np.int64
                                else v) for k, v in arrays.items()}


def _state(cfg):
    return init_train_state(torch.Generator().manual_seed(0), cfg, OPT, 64,
                            device="cpu")


def _copy(t):
    return tree.map_with_path(lambda _, x: x.clone(), t)


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def test_jamba_and_llava_take_two_kv_heads_from_their_published_configs():
    """``reduced`` of the published config is the smoke config; with
    ``num_kv_heads=2`` only the KV heads change (1 -> 2), so that the
    attention divides a model axis of 2."""
    for arch in TWO_KV:
        smoke = get_smoke_config(arch)
        assert reduced(get_config(arch)) == smoke
        assert smoke.num_kv_heads == 1
        assert reduced(get_config(arch), num_kv_heads=2) == \
            dataclasses.replace(smoke, num_kv_heads=2)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_tensor_parallel_step_matches_unsharded(arch, mesh_name):
    cfg, mesh = _cfg(arch), _mesh(mesh_name)
    batch = _batch(cfg)
    whole = _state(cfg)
    split, specs = split_train_state(_copy(whole), mesh)
    loss, _, grads = value_and_grad(cfg, whole.params, batch)
    rules.TP_BLOCKS.clear()
    mloss, _, mgrads = mesh_value_and_grad(cfg, split.params, batch,
                                           specs.params, mesh)
    assert rules.TP_BLOCKS[("attn", rules.SPLIT)] > 0
    assert float(mloss) == pytest.approx(float(loss), rel=1e-5)
    flat = tree.leaves_with_path(grads)
    big = max(float(g.abs().max()) for _, g in flat)
    noise = {p for p, g in flat if float(g.abs().max()) <= 1e-6 * big}
    for (path, w), g in zip(flat, tree.leaves(rules.gather_tree(
            mgrads, specs.params, mesh, CPU)), strict=True):
        tol = 1e-6 * big if path in noise else 1e-4 * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol, path

    # one step: every parameter and f32 moment within 1e-4 of its leaf's
    # largest; a noise leaf's parameter within 2 lr, its moments not at
    # all; at most two parameter elements a leaf off that bound, each of
    # gradient under 10 eps, within 2 lr
    one = make_train_step(cfg, OPT)
    many = make_train_step(cfg, OPT, mesh=mesh, specs=specs)
    want, m1 = one(whole, batch)
    got, m2 = many(split, batch)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    got = rules.gather_tree(got, specs, mesh, CPU)
    steep = {p: g.abs() < 10 * OPT.eps for p, g in flat}
    for (path, w), g in zip(tree.leaves_with_path(want),
                            tree.leaves(got), strict=True):
        if not w.is_floating_point():
            assert torch.equal(g, w), path
            continue
        diff = (g - w).abs()
        if _param_path(path) in noise:
            if path[0] == "params":
                assert float(diff.max()) <= 2 * OPT.lr, path
            continue
        off = diff > 1e-4 * float(w.abs().max())
        if path[0] == "params":
            assert int(off.sum()) <= 2, (path, int(off.sum()))
            assert bool(steep[path[1:]][off].all()), path
            assert bool((diff[off] <= 2 * OPT.lr).all()), path
        else:
            assert not bool(off.any()), path


def _param_path(path):
    """A state leaf's parameter path (its tree prefix dropped), None for
    a leaf that is not parameter-shaped."""
    for pre in (("params",), ("opt", "mu"), ("opt", "nu")):
        if path[:len(pre)] == pre:
            return path[len(pre):]
    return None


def _spy(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        log.append((args, kwargs))
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


def test_each_model_shard_runs_its_heads_on_its_own_device(monkeypatch):
    """(1, 2) over two distinct devices: every attention call a block
    makes is one model shard's, with 2 of phi3's 4 query and KV heads;
    shard m's slices (q, k, v, o, up, gate, down) and its rows of the
    embedding and ``lm_head`` are gathered as model part m onto entry (0,
    m)'s device, and every whole leaf onto entry (0, 0)'s."""
    cfg = _cfg("phi3-mini-3.8b")
    mesh = Mesh((1, 2), ("data", "model"), DISTINCT[:2])
    split, specs = split_train_state(_state(cfg), mesh)
    calls, gathers = [], []
    _spy(monkeypatch, transformer, "attention", calls)
    _spy(monkeypatch, rules, "gather_part", gathers)
    mesh_value_and_grad(cfg, split.params, _batch(cfg), specs.params, mesh)
    assert len(calls) == 2 * cfg.num_layers
    for args, _ in calls:
        assert (args[1].num_heads, args[1].num_kv_heads) == (2, 2)
        assert args[1].head_dim == cfg.head_dim
    parts = [(kw.get("model"), args[3]) for args, kw in gathers]
    slices = [(m, d) for m, d in parts if m is not None]
    # 7 sliced leaves (q, k, v, o, up, gate, down) a layer a model shard,
    # and the two vocabulary leaves
    assert sorted(slices, key=str) == sorted(
        [(m, DISTINCT[m]) for m in range(2)] * (7 * cfg.num_layers + 2),
        key=str)
    assert all(d == DISTINCT[0] for m, d in parts if m is None)


def test_qwen_runs_its_attention_whole_and_its_ffn_split():
    """The smoke qwen has one KV head: on a model axis of 2 its attention
    runs whole (counted with the reason), its FFN split; the step is the
    unsharded one's."""
    cfg = get_smoke_config("qwen2.5-14b")
    assert (cfg.num_heads, cfg.num_kv_heads) == (4, 1)
    mesh = _mesh("1x2")
    whole = _state(cfg)
    split, specs = split_train_state(_copy(whole), mesh)
    assert rules.tp_layout(cfg, specs.params["stack"]["blocks"][0],
                           mesh) == {"attn": rules.HEADS,
                                     "ffn": rules.SPLIT}
    rules.TP_BLOCKS.clear()
    batch = _batch(cfg)
    mloss, _, _ = mesh_value_and_grad(cfg, split.params, batch,
                                      specs.params, mesh)
    assert dict(rules.TP_BLOCKS) == {("attn", rules.HEADS): cfg.num_layers,
                                     ("ffn", rules.SPLIT): cfg.num_layers,
                                     ("vocab", rules.SPLIT): 1}
    loss, _, _ = value_and_grad(cfg, whole.params, batch)
    assert float(mloss) == pytest.approx(float(loss), rel=1e-5)


@pytest.mark.parametrize("arch,want", [
    ("olmoe-1b-7b", {("attn", rules.SPLIT): 2, ("moe", rules.SPLIT): 2,
                     ("vocab", rules.SPLIT): 1}),
    ("jamba-v0.1-52b", {("attn", rules.SPLIT): 1, ("ffn", rules.SPLIT): 1,
                        ("ssm", rules.SSD): 1, ("moe", rules.SPLIT): 1,
                        ("vocab", rules.SPLIT): 1}),
    ("whisper-tiny", {("attn", rules.SPLIT): 2, ("ffn", rules.SPLIT): 4,
                      ("self_attn", rules.SPLIT): 2,
                      ("cross_attn", rules.SPLIT): 2,
                      ("vocab", rules.SPLIT): 1}),
    ("arctic-480b", {("attn", rules.SPLIT): 2, ("moe", rules.SPLIT): 2,
                     ("moe/dense", rules.SPLIT): 2,
                     ("vocab", rules.SPLIT): 1}),
])
def test_block_counter_by_family(arch, want):
    """``TP_BLOCKS`` counts each sub-block once a block a data shard a
    forward, and the vocabulary once a data shard a forward; on one model
    shard every sub-block and the vocabulary run whole."""
    cfg = _cfg(arch)
    for name, expect in (("1x2", want), ("one", {
            (k, rules.ONE_SHARD): n for (k, _), n in want.items()})):
        mesh = (_mesh(name) if name != "one" else
                Mesh((1, 1), ("data", "model"), [CPU]))
        split, specs = split_train_state(_state(cfg), mesh)
        rules.TP_BLOCKS.clear()
        mesh_value_and_grad(cfg, split.params, _batch(cfg), specs.params,
                            mesh)
        assert dict(rules.TP_BLOCKS) == expect


def _refuse(*args, **kwargs):
    raise AssertionError("a mesh step gathered a whole tree")


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "whisper-tiny"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_blocks_gather_inside_their_remat_unit(monkeypatch, arch, remat):
    """Over (2, 2) of four distinct devices: each block leaf is gathered
    onto each (data, model) entry that reads it once a step under
    ``remat="none"`` and twice under ``"full"`` (the forward and the
    backward's recompute); a leaf outside the blocks once a data shard;
    ``gather_leaf`` and ``gather_tree`` never."""
    cfg = dataclasses.replace(_cfg(arch), remat=remat)
    mesh = _mesh("2x2-distinct")
    split, specs = split_train_state(_state(cfg), mesh)
    owner = {}
    for path, x in tree.leaves_with_path(split.params,
                                         is_leaf=rules.is_pieces):
        for t in x:
            owner[t.data_ptr()] = path
    gathers = []
    _spy(monkeypatch, rules, "gather_part", gathers)
    monkeypatch.setattr(rules, "gather_leaf", _refuse)
    monkeypatch.setattr(rules, "gather_tree", _refuse)
    mesh_value_and_grad(cfg, split.params, _batch(cfg), specs.params, mesh)
    counts = {}
    for args, kw in gathers:
        key = (owner[args[0][0].data_ptr()], args[3], kw.get("model"))
        counts[key] = counts.get(key, 0) + 1
    per_step = 2 if remat == "full" else 1
    in_blocks = {k: n for k, n in counts.items()
                 if tree.in_layer_list(k[0])}
    outside = {k: n for k, n in counts.items() if k not in in_blocks}
    assert set(in_blocks.values()) == {per_step}
    assert set(outside.values()) == {1}
    n_leaves = len(tree.leaves(split.params, is_leaf=rules.is_pieces))
    # every leaf is read by both data shards
    assert {p for p, _, _ in counts} == {
        p for p, _ in tree.leaves_with_path(split.params,
                                            is_leaf=rules.is_pieces)}
    assert len({p for p, _, _ in counts}) == n_leaves
    # split leaves reach the model entries' devices, whole ones the first
    devs = {k[1] for k in in_blocks}
    assert devs == set(DISTINCT)


def test_gather_part_against_slicing_and_its_backward():
    """A (8, 6) leaf split P("model", "data") over (2, 2) distinct
    devices: whole, model part 0 and 1 equal slices of the leaf; the
    gradient of a weighted sum reaches each piece as its own region."""
    mesh = _mesh("2x2-distinct")
    x = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    spec = rules.P("model", "data")
    pieces = rules.split_leaf(x, spec, mesh)
    views = rules.Pieces(t.detach().requires_grad_(True) for t in pieces)
    assert torch.equal(rules.gather_part(views, spec, mesh, CPU), x)
    w = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    total = 0
    for m in range(2):
        part = rules.gather_part(views, spec, mesh, DISTINCT[2 * m], model=m)
        assert torch.equal(part, x[4 * m:4 * (m + 1)])
        total = total + (part * w).sum()
    grads = torch.autograd.grad(total, list(views))
    whole_grad = torch.cat([w, w])
    lay = rules.leaf_layout(x.shape, spec, mesh)
    for g, region in zip(grads, lay.regions, strict=True):
        assert torch.equal(g, whole_grad[region])
    with pytest.raises(ValueError, match="model"):
        rules.gather_part(views, rules.P(None, "data"), mesh, CPU, model=0)


def test_tp_layout_at_the_published_widths():
    """On the production (16, 16) mesh (abstract): phi3-mini's 32 heads
    and d_ff 8192 split; whisper-tiny's 6 heads do not divide 16 (its
    attention runs whole, its d_ff of 1536 splits); qwen2.5-14b's 8 KV
    heads do not either; olmoe's 64 experts and arctic's 128 split (4 and
    8 a shard), and arctic's dense branch (d_ff 4864) with them, while
    its 8 KV heads keep its attention whole; every vocabulary splits
    (whisper's stored 51,872 rows, olmoe's 50,304). On a (1, 4) mesh
    phi3-mini splits 8 heads a shard; on (1, 3) olmoe's experts and
    whisper's vocabulary do not divide and run whole, by their reasons."""
    prod = make_production_mesh()

    def layout(arch, mesh, key="stack"):
        cfg = get_config(arch)
        blocks = _abstract_blocks(cfg)
        sp = rules.param_specs(blocks, mesh)[key]
        sp = (sp["blocks"] if key == "stack" else sp)[0]
        return rules.tp_layout(cfg, sp, mesh)

    def vocab(arch, mesh):
        cfg = get_config(arch)
        return rules.vocab_layout(
            cfg, rules.param_specs(_abstract_vocab(cfg), mesh), mesh)

    assert layout("phi3-mini-3.8b", prod) == {"attn": rules.SPLIT,
                                              "ffn": rules.SPLIT}
    assert layout("qwen2.5-14b", prod)["attn"] == rules.HEADS
    assert layout("whisper-tiny", prod, "enc_blocks") == {
        "attn": rules.HEADS, "ffn": rules.SPLIT}
    assert layout("olmoe-1b-7b", prod) == {"attn": rules.SPLIT,
                                           "moe": rules.SPLIT}
    assert layout("arctic-480b", prod) == {
        "attn": rules.HEADS, "moe": rules.SPLIT, "moe/dense": rules.SPLIT}
    assert layout("phi3-mini-3.8b", Mesh((1, 4), ("data", "model"))) == {
        "attn": rules.SPLIT, "ffn": rules.SPLIT}
    for arch in ("phi3-mini-3.8b", "whisper-tiny", "olmoe-1b-7b",
                 "arctic-480b"):
        assert vocab(arch, prod) == rules.SPLIT, arch
    three = Mesh((1, 3), ("data", "model"))
    assert layout("olmoe-1b-7b", three)["moe"] == rules.EXPERTS
    assert vocab("whisper-tiny", three) == rules.VOCAB


def _abstract_vocab(cfg):
    """The vocabulary leaves of ``cfg``'s parameter tree as meta
    tensors."""
    def table():
        return torch.empty((cfg.padded_vocab, cfg.d_model), device="meta")
    out = {"embed": {"table": table()}}
    if not (cfg.tie_embeddings or cfg.family == "audio"):
        out["lm_head"] = {"w": table()}
    return out


def _abstract_blocks(cfg):
    """One layer's parameter tree of ``cfg`` as meta tensors, under the
    key a parameter tree holds it at: attention and a dense FFN, or a MoE
    layer (its router, expert stacks and any dense branch) for a MoE
    config."""
    d, hd = cfg.d_model, cfg.head_dim

    def lin(n_out, n_in):
        return {"w": torch.empty((n_out, n_in), device="meta")}

    def mlp(d_ff):
        return {"up": lin(d_ff, d), "down": lin(d, d_ff)}

    attn = {"q": lin(cfg.num_heads * hd, d),
            "k": lin(cfg.num_kv_heads * hd, d),
            "v": lin(cfg.num_kv_heads * hd, d),
            "o": lin(d, cfg.num_heads * hd)}
    block = {"norm1": {"scale": torch.empty((d,), device="meta")},
             "attn": attn}
    if cfg.moe is None:
        block["ffn"] = mlp(cfg.d_ff)
    else:
        e, dff = cfg.moe.num_experts, cfg.moe.d_ff
        block["moe"] = {
            "router": lin(e, d),
            "w_up": torch.empty((e, d, dff), device="meta"),
            "w_gate": torch.empty((e, d, dff), device="meta"),
            "w_down": torch.empty((e, dff, d), device="meta")}
        if cfg.moe.dense_residual_d_ff:
            block["moe"]["dense"] = mlp(cfg.moe.dense_residual_d_ff)
    if cfg.family == "audio":
        return {"enc_blocks": [block]}
    return {"stack": {"blocks": [block]}}


def test_shard_inputs_upcast_only_inputs_of_the_weights_16_bit_type():
    """16-bit float inputs of the slices' weights' type are upcast to f32
    exactly; integer inputs pass as they are; f32 weights, or an input of
    another type, leave every input as it is."""
    bf = torch.bfloat16
    part = {"q": {"w": torch.zeros(4, 8, dtype=bf)}}
    h = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(0))
    h, pos = h.to(bf), torch.arange(3)
    (h32, p32), up = transformer.shard_inputs(part, (h, pos))
    assert up and h32.dtype == torch.float32 and p32 is pos
    assert torch.equal(h32.to(bf), h)
    for ins, prt in (((h.float(), pos), part),
                     ((h, pos), {"q": {"w": torch.zeros(4, 8)}}),
                     ((h, h.half()), part)):
        assert transformer.shard_inputs(prt, ins) == (ins, False)


def test_f32_grad_products_sum_the_shards_input_gradients_in_f32():
    """``linear(..., f32_grad=True)`` on the CPU: of an f32 x that holds
    bf16 values, the bf16 product within one bf16 rounding of the f32
    one; x's gradient from two shards' products is the f32 sum of their
    f32 input gradients (within 1e-6 of float64), where the two bf16
    input gradients summed in bf16 land further off."""
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, generator=gen).to(bf)
    ws = [torch.randn(16, 64, generator=gen).to(bf) for _ in range(2)]
    dys = [torch.randn(8, 16, generator=gen).to(bf) for _ in range(2)]
    x32 = x.float().requires_grad_(True)
    ys = [layers.linear({"w": w}, x32, f32_grad=True) for w in ws]
    for y, w in zip(ys, ws):
        assert y.dtype == bf
        want = x.double() @ w.double().t()
        assert float((y.detach().double() - want).abs().max()) <= \
            2.0 ** -8 * float(want.abs().max())
    (dx,) = torch.autograd.grad(ys, x32, dys)
    assert dx.dtype == torch.float32
    exact = sum(dy.double() @ w.double() for dy, w in zip(dys, ws))
    assert _rel(dx.double(), exact) <= 1e-6
    rounded = sum(((dy @ w) for dy, w in zip(dys, ws)),
                  torch.zeros((), dtype=bf))
    assert _rel(rounded.double(), exact) > 1e-4


def test_bf16_step_over_the_model_axis_matches_unsharded():
    """phi3's smoke config in bf16 over (1, 2): the shards' inputs reach
    them upcast (``f32_grad``), the loss within 1e-3 and every gradient
    within 2^-6 of its leaf's largest of the unsharded step's (bf16
    products and sums in another order, each off by a few roundings of
    2^-8)."""
    cfg = dataclasses.replace(_cfg("phi3-mini-3.8b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    mesh = _mesh("1x2")
    batch = _batch(cfg)
    whole = _state(cfg)
    split, specs = split_train_state(_copy(whole), mesh)
    loss, _, grads = value_and_grad(cfg, whole.params, batch)
    seen = []
    real = transformer.shard_inputs

    def spy(part, inputs):
        out = real(part, inputs)
        seen.append(out[1])
        return out
    transformer.shard_inputs = spy
    try:
        mloss, _, mgrads = mesh_value_and_grad(cfg, split.params, batch,
                                               specs.params, mesh)
    finally:
        transformer.shard_inputs = real
    assert seen and all(seen)
    assert float(mloss) == pytest.approx(float(loss), rel=1e-3)
    for (path, w), g in zip(tree.leaves_with_path(grads), tree.leaves(
            rules.gather_tree(mgrads, specs.params, mesh, CPU)),
            strict=True):
        assert _rel(g.float(), w.float()) <= 2.0 ** -6, path
