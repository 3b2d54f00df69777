"""Training over a device mesh on the CPU (``Trainer(mesh=)``, the mesh
step of ``repro_torch.train.step``): the state stored split by
``train_state_specs``, the step held to the port's unsharded step, to the
reference's ``make_train_step``, and checkpoints across meshes.

Meshes: (2, 1) and (2, 2) of repeated ``cpu`` entries, and (2, 2) of four
distinct ``cpu:i`` entries (four physical devices whose tensors share the
host's memory), with (4, 1) where a leaf's parts are narrower than a Q8_0
block.

- Against the unsharded step, for every family (phi3-mini, whisper-tiny,
  olmoe with room for every token, mamba2, llava): the loss within 1e-5,
  every gradient within 1e-4 of its leaf's largest magnitude (or 1e-6 of
  the largest gradient, for a leaf whose exact gradient is zero), and
  after 2 steps every parameter and f32 moment within 1e-4 of its leaf's
  largest. Microbatches 2 the same.
- A value that leaves through a quantizer (a moment stored in bf16 or in
  Q8_0 blocks, int8 error feedback) lands on one of two neighbouring steps
  when the f32 sums before it differ in their last bits, so those leaves
  are held within one step of theirs: a bf16 moment within 2^-7 of each
  value, a Q8_0 moment within its block's scale. Given the same
  gradients, the split optimizer and compression equal the whole leaf's
  bit for bit (clipping off, so both scale by exactly 1), and within
  1e-6 with clipping on.
- The loss uses the global token count: a batch whose masked labels split
  unevenly over the shards, where a mean of the shards' means is off. A
  batch the shards do not divide runs whole on the first.
- One mesh step against the reference's own step on the same converted
  state: phi3-mini, and olmoe with its experts and vocabulary split over
  the model axis.
- Storage: every logical entry holds what ``train_state_specs`` gives it;
  replicas on one physical device are stored once; checkpoints written on
  any mesh, or none, restore onto any other bit for bit.
- MoE with drops: where the step's dispatch group spans the shards, they
  run in lockstep and join their expert choices, and the loss and
  gradients are the unsharded step's (the shards' own claims would not
  be); where a shard's tokens are whole groups, or no group can drop,
  nothing is joined and the step is the unsharded step's all the same.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.core import tree
from repro_torch.core.qformats import QTensor, dequantize_q8_0, \
    quantize_q8_0
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model, moe
from repro_torch.optim.adamw import adamw_update, adamw_update_split
from repro_torch.optim.compression import ef_compress_grads, \
    ef_compress_split
from repro_torch.sharding import ctx, rules
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.step import init_train_state, make_train_step, \
    mesh_value_and_grad, split_train_state, value_and_grad
from repro_torch.train.trainer import Trainer

CPU = torch.device("cpu")
DISTINCT = [torch.device("cpu", i) for i in range(4)]
MESHES = {"2x1": ((2, 1), [CPU] * 2), "2x2": ((2, 2), [CPU] * 4),
          "2x2-distinct": ((2, 2), DISTINCT)}
FAMILIES = ["phi3-mini-3.8b", "whisper-tiny", "olmoe-1b-7b", "mamba2-780m",
            "llava-next-mistral-7b"]
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


def _mesh(name, sizes=None):
    if sizes is not None:
        return Mesh(sizes, ("data", "model"), DISTINCT)
    sizes, devs = MESHES[name]
    return Mesh(sizes, ("data", "model"), devs)


def _cfg(arch, room=True):
    """The smoke config; a MoE's capacity factor E / k where ``room``, so
    that every expert has a slot for every token of its group and nothing
    drops."""
    cfg = get_smoke_config(arch)
    if cfg.moe is not None and room:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.experts_per_token))
    return cfg


def _batch(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, S)),
              "labels": rng.integers(0, cfg.vocab_size, (b, S))}
    arrays["labels"][:, :2] = -1
    if cfg.family == "audio":
        arrays["mel"] = rng.standard_normal((b, S, cfg.n_mels)).astype(
            np.float32)
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (b, PATCHES, cfg.vision_embed_dim)).astype(np.float32)
    return {k: torch.from_numpy(v.astype(np.int32) if v.dtype == np.int64
                                else v) for k, v in arrays.items()}


def _state(cfg, opt=OPT):
    return init_train_state(torch.Generator().manual_seed(0), cfg, opt, 64,
                            device="cpu")


def _copy(t):
    return tree.map_with_path(lambda _, x: x.clone(), t)


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def _assert_grads_close(got, want):
    got, want = tree.leaves(got), tree.leaves(want)
    assert len(got) == len(want)
    floor = 1e-6 * max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        tol = max(1e-4 * float(w.abs().max()), floor)
        assert float((g.float() - w.float()).abs().max()) <= tol


def _noise_leaves(grads):
    """The parameter paths whose gradient is rounding noise: zero in exact
    arithmetic (the key projection's bias: softmax ignores a shift common
    to every key), at most 1e-6 of the largest gradient."""
    flat = tree.leaves_with_path(grads)
    floor = 1e-6 * max(float(g.abs().max()) for _, g in flat)
    return {p for p, g in flat if float(g.abs().max()) <= floor}


def _state_path(path):
    """A state leaf's parameter path (its tree prefix dropped)."""
    for pre in (("params",), ("opt", "mu"), ("opt", "nu"), ("ef",)):
        if path[:len(pre)] == pre:
            return path[len(pre):]
    return path


def _near_eps(grads, eps):
    """{parameter path: the elements whose gradient is under 10 eps}.
    Adam's first step lr g / (|g| + eps) is steep there (slope lr eps /
    (|g| + eps)^2): a gradient of 2.8e-8 that a reordered f32 sum moves by
    2.5e-9, 1e-8 of its leaf's largest, moves the step by 1.7e-2 lr,
    where an element of larger gradient takes the same step."""
    return {p: g.abs() < 10 * eps for p, g in tree.leaves_with_path(grads)}


def _assert_state_close(got, want, noise=(), bound=0.0, small=None):
    """Parameters and f32 moments within 1e-4 of their leaf's largest
    magnitude; a bf16 moment within 2^-7 of each value, a Q8_0 moment
    within its block's scale (one quantization step); integers equal. A
    leaf whose gradient is noise (``noise``) takes Adam steps of noise
    over noise: its parameter is held within ``bound`` (2 lr a step), its
    moments not at all. With ``small`` (``_near_eps``), at most two
    elements of a parameter leaf may lie outside its bound, each one
    whose first gradient is under 10 Adam eps, and each within
    ``bound``."""
    for (path, w), g in zip(tree.leaves_with_path(want, is_leaf=_is_q),
                            tree.leaves(got, is_leaf=_is_q), strict=True):
        name = "/".join(path)
        if _state_path(path) in noise and w.is_floating_point():
            if path[0] == "params":
                assert float((g - w).abs().max()) <= bound, name
        elif _is_q(w):
            step = w.scales[..., None].expand(w.qs.shape).reshape(
                w.shape)
            diff = (dequantize_q8_0(g) - dequantize_q8_0(w)).abs()
            big = 1e-4 * float(dequantize_q8_0(w).abs().max())
            assert bool((diff <= 1.01 * step + big).all()), name
        elif not w.is_floating_point():
            assert torch.equal(g, w), name
        elif w.dtype == torch.bfloat16 and path[0] == "opt":
            diff = (g.float() - w.float()).abs()
            big = 1e-4 * float(w.float().abs().max())
            assert bool((diff <= 2.0 ** -7 * w.float().abs() + big).all()), \
                name
        elif small is not None and path[0] == "params":
            diff = (g - w).abs()
            off = diff > 1e-4 * max(float(w.abs().max()), 1e-30)
            assert int(off.sum()) <= 2, (name, int(off.sum()))
            assert bool(small[path[1:]][off].all()), name
            assert bool((diff[off] <= bound).all()), name
        else:
            assert _rel(g, w) <= 1e-4, (name, _rel(g, w))


def _assert_trees_close(got, want, batches, cfg, opt, init):
    """``_assert_state_close`` with the noise leaves of the first batch's
    gradients, each bound 2 lr a step, and the elements whose first
    gradient at the initial parameters ``init`` is under 10 Adam eps."""
    _, _, grads = value_and_grad(cfg, want.params, batches[0])
    _, _, first = value_and_grad(cfg, init, batches[0])
    _assert_state_close(got, want, _noise_leaves(grads),
                        2 * opt.lr * len(batches),
                        _near_eps(first, opt.eps))


def _run_both(cfg, mesh, batches, opt=OPT, microbatches=1, start=None):
    """The unsharded step and the mesh step from the same state (``start``,
    or the initial state) over ``batches``: (their losses, their final
    whole states)."""
    whole = _state(cfg, opt) if start is None else _copy(start)
    split, specs = split_train_state(_copy(whole), mesh)
    one = make_train_step(cfg, opt, microbatches=microbatches)
    many = make_train_step(cfg, opt, microbatches=microbatches, mesh=mesh,
                           specs=specs)
    losses = []
    for b in batches:
        whole, m1 = one(whole, b)
        split, m2 = many(split, b)
        losses.append((float(m1["loss"]), float(m2["loss"])))
    return losses, whole, rules.gather_tree(split, specs, mesh, CPU)


# ---------------------------------------------------------------------------
# the mesh step against the unsharded step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_step_matches_unsharded(arch, mesh_name):
    cfg, mesh = _cfg(arch), _mesh(mesh_name)
    batch = _batch(cfg)
    whole = _state(cfg)
    split, specs = split_train_state(_copy(whole), mesh)
    loss, aux, grads = value_and_grad(cfg, whole.params, batch)
    mloss, maux, mgrads = mesh_value_and_grad(cfg, split.params, batch,
                                              specs.params, mesh)
    assert float(mloss) == pytest.approx(float(loss), rel=1e-5)
    assert float(maux["ntok"]) == float(aux["ntok"])
    assert float(maux["moe_aux"]) == pytest.approx(float(aux["moe_aux"]),
                                                   rel=1e-5, abs=1e-9)
    _assert_grads_close(rules.gather_tree(mgrads, specs.params, mesh, CPU),
                        grads)

    batches = [batch, _batch(cfg, 1)]
    losses, want, got = _run_both(cfg, mesh, batches)
    for a, b in losses:
        assert b == pytest.approx(a, rel=1e-5)
    _assert_state_close(got, want, _noise_leaves(grads),
                        2 * OPT.lr * len(batches))


@pytest.mark.parametrize("sizes", [(2, 2), (4, 1)])
@pytest.mark.parametrize("option", ["microbatches2", "bf16_moments",
                                    "q8_0_moments", "int8_ef"])
def test_mesh_step_options_match_unsharded(option, sizes):
    """Microbatches, bf16 and Q8_0 moments and int8 error feedback over
    four distinct devices; at (4, 1) the embedding's and readout's 64
    columns split into parts 16 wide, narrower than a Q8_0 block, so
    their Q8_0 moments and compression run whole. Quantized leaves are
    held within one quantization step (above); with Q8_0 moments the
    stored moments feed the next step's update, so one step is held. With
    bf16 moments each of two steps is held from the same state: a moment
    one step off after the first can land two off after the second where
    its magnitude falls below a power of two, so the second step starts
    both from the mesh's state after the first."""
    cfg, mesh = _cfg("phi3-mini-3.8b"), _mesh(None, sizes)
    opt, micro, steps = OPT, 1, 2
    if option == "microbatches2":
        micro = 2
    elif option == "bf16_moments":
        opt = dataclasses.replace(OPT, state_dtype="bfloat16")
    elif option == "q8_0_moments":
        opt, steps = dataclasses.replace(OPT, state_dtype="q8_0"), 1
    else:
        opt, steps = dataclasses.replace(OPT, grad_compress="int8_ef"), 1
    batches = [_batch(cfg, s) for s in range(steps)]
    init = _state(cfg, opt).params
    if option == "bf16_moments":
        losses, want, start = _run_both(cfg, mesh, batches[:1], opt=opt)
        _assert_trees_close(start, want, batches[:1], cfg, opt, init)
        more, want, got = _run_both(cfg, mesh, batches[1:], opt=opt,
                                    start=start)
        losses, batches, init = losses + more, batches[1:], start.params
    else:
        losses, want, got = _run_both(cfg, mesh, batches, opt=opt,
                                      microbatches=micro)
    for a, b in losses:
        assert b == pytest.approx(a, rel=1e-5)
    if option != "int8_ef":
        _assert_trees_close(got, want, batches, cfg, opt, init)
        return
    # one step from zero errors: the compressed gradient is the reduced
    # gradient's Q8_0 blocks, and an element that lands one block step s
    # away moves its error by s, its first moment by (1 - b1) s and its
    # second by (1 - b2) s (2 |g| + s); the parameters take sign steps
    _assert_state_close(got.params, want.params)
    _, _, grads = value_and_grad(cfg, _state(cfg, opt).params, batches[0])
    for path, g in tree.leaves_with_path(grads):
        e = _at(want.ef, path)
        if e.ndim == 0:
            continue
        q = quantize_q8_0(g)
        step = 1.01 * q.scales[..., None].expand(q.qs.shape).reshape(g.shape)
        for a, b, bound in ((got.ef, want.ef, step),
                            (got.opt.mu, want.opt.mu, (1 - opt.b1) * step),
                            (got.opt.nu, want.opt.nu, (1 - opt.b2) * step
                             * (2 * g.abs() + step))):
            w = _at(b, path)
            big = 1e-4 * float(w.abs().max())
            assert bool(((_at(a, path) - w).abs() <= bound + big).all()), \
                path


def _at(t, path):
    for k in path:
        t = t[int(k)] if isinstance(t, list) else t[k]
    return t


def _random_like(t, gen):
    return torch.randn(t.shape, generator=gen) * 0.01


@pytest.mark.parametrize("sizes", [(2, 2), (4, 1)])
def test_split_compression_is_the_whole_leafs_bit_for_bit(sizes):
    cfg, mesh = _cfg("phi3-mini-3.8b"), _mesh(None, sizes)
    opt = dataclasses.replace(OPT, grad_compress="int8_ef")
    state = _state(cfg, opt)
    gen = torch.Generator().manual_seed(3)
    grads = tree.map_with_path(lambda _, p: _random_like(p, gen),
                               state.params)
    ef = tree.map_with_path(lambda _, e: _random_like(e, gen) * 0.1,
                            state.ef)
    split, specs = split_train_state(state._replace(ef=_copy(ef)), mesh)
    want_g, want_e, _ = ef_compress_grads(grads, ef)
    got = ef_compress_split(rules.split_tree(grads, specs.params, mesh),
                            split.ef, specs.ef, mesh)
    for a, b in zip(tree.leaves(rules.gather_tree(got, specs.params, mesh,
                                                  CPU)),
                    tree.leaves(want_g), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(rules.gather_tree(split.ef, specs.ef, mesh,
                                                  CPU)),
                    tree.leaves(want_e), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("clip", [1e9, 1.0])
@pytest.mark.parametrize("sizes", [(2, 2), (4, 1)])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "q8_0"])
def test_split_adamw_is_the_whole_leafs(state_dtype, sizes, clip):
    """Given the same gradients, the split update is the whole leaf's bit
    for bit where clipping scales by exactly 1; with clipping on, the
    global norm sums its parts in another order, within 1e-6."""
    cfg, mesh = _cfg("phi3-mini-3.8b"), _mesh(None, sizes)
    opt = dataclasses.replace(OPT, state_dtype=state_dtype, grad_clip=clip)
    state = _state(cfg, opt)
    gen = torch.Generator().manual_seed(4)
    grads = tree.map_with_path(lambda _, p: _random_like(p, gen),
                               state.params)
    split, specs = split_train_state(_copy(state), mesh)
    want_p, want_opt, want_m = adamw_update(grads, state.opt, state.params,
                                            opt)
    got_p, got_opt, got_m = adamw_update_split(
        rules.split_tree(grads, specs.params, mesh), split.opt,
        split.params, opt, specs=specs, mesh=mesh)
    got = rules.gather_tree(split._replace(params=got_p, opt=got_opt),
                            specs, mesh, CPU)
    want = state._replace(params=want_p, opt=want_opt)
    if clip > 1e8:
        assert torch.equal(got_m["grad_norm"], want_m["grad_norm"]) or \
            float(got_m["grad_norm"]) == pytest.approx(
                float(want_m["grad_norm"]), rel=1e-6)
        for a, b in zip(tree.leaves(got), tree.leaves(want), strict=True):
            assert torch.equal(a, b)
    else:
        assert float(got_m["grad_norm"]) == pytest.approx(
            float(want_m["grad_norm"]), rel=1e-6)
        for (path, b), a in zip(tree.leaves_with_path(want.params),
                                tree.leaves(got.params), strict=True):
            assert _rel(a, b) <= 1e-6, path


def test_mesh_loss_uses_the_global_token_count():
    """Row 0 keeps 2 labels, row 1 all 16: over (2, 1) each shard holds a
    row, and the reference's loss divides the summed CE by 18, which a
    mean of the two shards' means does not."""
    cfg, mesh = _cfg("phi3-mini-3.8b"), _mesh("2x1")
    batch = _batch(cfg, b=2)
    batch["labels"] = batch["labels"].clone()
    batch["labels"][0, :14] = -1
    batch["labels"][1, :] = batch["tokens"][1]
    whole = _state(cfg)
    split, specs = split_train_state(_copy(whole), mesh)
    loss, aux, grads = value_and_grad(cfg, whole.params, batch)
    mloss, maux, mgrads = mesh_value_and_grad(cfg, split.params, batch,
                                              specs.params, mesh)
    assert float(aux["ntok"]) == float(maux["ntok"]) == 18
    assert float(mloss) == pytest.approx(float(loss), rel=1e-5)
    _assert_grads_close(rules.gather_tree(mgrads, specs.params, mesh, CPU),
                        grads)
    means = [float(model.loss_fn(whole.params, cfg,
                                 {k: v[i:i + 1] for k, v in batch.items()}
                                 )[0]) for i in range(2)]
    assert abs(sum(means) / 2 - float(loss)) > 1e-2


def test_a_batch_the_shards_do_not_divide_runs_whole_on_the_first():
    """3 rows over 2 data shards: ``batch_specs`` would split the
    sequence, which the mesh step does not do (attention is not split):
    the whole batch runs on the first shard, and the step is the
    unsharded one's."""
    cfg, mesh = _cfg("phi3-mini-3.8b"), _mesh("2x2-distinct")
    batch = _batch(cfg, b=3)
    assert rules.batch_specs(batch, mesh)["tokens"] == rules.P(None, "data")
    whole = _state(cfg)
    split, specs = split_train_state(_copy(whole), mesh)
    loss, _, grads = value_and_grad(cfg, whole.params, batch)
    mloss, _, mgrads = mesh_value_and_grad(cfg, split.params, batch,
                                           specs.params, mesh)
    assert float(mloss) == pytest.approx(float(loss), rel=1e-5)
    _assert_grads_close(rules.gather_tree(mgrads, specs.params, mesh, CPU),
                        grads)


def test_mesh_step_matches_the_reference_step():
    """The reference's ``make_train_step`` (jitted, one device) and the
    port's mesh step over four distinct devices, from the same converted
    state on the same batch: the loss and the gradient norm within 1e-5,
    every updated parameter within 1e-4 of its leaf's largest."""
    _reference_step_case("phi3-mini-3.8b")


def test_olmoe_mesh_step_matches_the_reference_step():
    """The same for olmoe, with capacity factor E / k in both packages:
    over (2, 2) its experts run split over the model shards (expert
    parallelism), 2 of 4 a shard, and its vocabulary too."""
    rules.TP_BLOCKS.clear()
    _reference_step_case("olmoe-1b-7b")
    assert rules.TP_BLOCKS[("moe", rules.SPLIT)] == 2 * 2
    assert rules.TP_BLOCKS[("vocab", rules.SPLIT)] == 2


def _reference_step_case(arch):
    jcfg = jax_smoke_config(arch)
    cfg = _cfg(arch)
    if cfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cfg.moe.capacity_factor))
    jopt = jax_base.OptimizerConfig(lr=1e-3, warmup_steps=0,
                                    total_steps=10)
    state0 = jax_init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                                  max_positions=64)
    batch = _batch(cfg)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jopt))(
        state0, {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()})
    np_tree = jax.tree_util.tree_map(np.asarray, state0)
    mesh = _mesh("2x2-distinct")
    split, specs = split_train_state(
        from_jax_train_state(np_tree, device="cpu"), mesh)
    step = make_train_step(cfg, OPT, mesh=mesh, specs=specs)
    split, m = step(split, batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params),
                           device="cpu")
    got = rules.gather_tree(split.params, specs.params, mesh, CPU)
    for (path, w), g in zip(tree.leaves_with_path(want), tree.leaves(got),
                            strict=True):
        assert _rel(g, w) <= 1e-4, path


# ---------------------------------------------------------------------------
# storage and checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(MESHES) + ["4x1-distinct"])
def test_state_is_stored_split_by_train_state_specs(mesh_name):
    cfg = _cfg("phi3-mini-3.8b")
    mesh = (_mesh(None, (4, 1)) if mesh_name == "4x1-distinct"
            else _mesh(mesh_name))
    opt = dataclasses.replace(OPT, state_dtype="q8_0",
                              grad_compress="int8_ef")
    state = _state(cfg, opt)
    split, specs = split_train_state(_copy(state), mesh)
    # every logical entry holds each leaf's bytes over its parts
    want = rules.spec_bytes(state, specs, mesh)
    assert rules.entry_bytes(split, specs, mesh) == [want] * mesh.size
    assert want < sum(x.numel() * x.element_size()
                      for x in tree.leaves(state))
    distinct = len(mesh.physical_devices) == mesh.size
    for (path, x), pieces, spec in zip(
            tree.leaves_with_path(state),
            tree.leaves(split, is_leaf=rules.is_pieces),
            tree.leaves(specs, is_leaf=rules.is_spec), strict=True):
        assert isinstance(pieces, rules.Pieces)
        parts = mesh.parts(spec)
        n_parts = int(np.prod(parts))
        # one piece an entry on distinct devices; on one device, a piece
        # a part (replicas stored once)
        assert len(pieces) == (mesh.size if distinct else n_parts), path
        for p in pieces:
            assert tuple(p.shape) == tuple(
                d // (parts[i] if i < len(parts) else 1)
                for i, d in enumerate(x.shape))
        assert torch.equal(rules.gather_leaf(pieces, spec, mesh, CPU), x)
    assert len(tree.leaves(split)) == sum(
        len(p) for p in tree.leaves(split, is_leaf=rules.is_pieces))


def _bits_equal(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))


def test_checkpoints_round_trip_between_meshes_bit_for_bit(tmp_path):
    """A state after a mesh step: saved from (2, 2) over four devices,
    restored unsharded (onto meta templates) and onto (4, 1) and (2, 1);
    saved again from (4, 1) and from the unsharded state, and restored
    onto (2, 2): every leaf bit for bit."""
    cfg = _cfg("phi3-mini-3.8b")
    opt = dataclasses.replace(OPT, state_dtype="q8_0",
                              grad_compress="int8_ef")
    mesh = _mesh("2x2-distinct")
    split, specs = split_train_state(_state(cfg, opt), mesh)
    split, _ = make_train_step(cfg, opt, mesh=mesh, specs=specs)(
        split, _batch(cfg))
    whole = rules.gather_tree(split, specs, mesh, CPU)
    template = tree.map_with_path(
        lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
        whole)
    a = ckpt_lib.save_checkpoint(str(tmp_path), split, step=1, mesh=mesh,
                                 specs=specs)
    loaded, manifest = ckpt_lib.load_checkpoint(a, template, device="cpu")
    assert manifest["step"] == 1
    _bits_equal(loaded, whole)
    for target in (_mesh(None, (4, 1)), _mesh("2x1")):
        tspecs = rules.train_state_specs(whole, target)
        on, _ = ckpt_lib.load_checkpoint(a, template, mesh=target,
                                         specs=tspecs)
        assert rules.is_split(on)
        _bits_equal(rules.gather_tree(on, tspecs, target, CPU), whole)
    b = ckpt_lib.save_checkpoint(str(tmp_path), on, step=2, mesh=target,
                                 specs=tspecs)
    c = ckpt_lib.save_checkpoint(str(tmp_path), whole, step=3)
    for path in (b, c):
        back, _ = ckpt_lib.load_checkpoint(path, template, mesh=mesh,
                                           specs=specs)
        _bits_equal(back, split)


# ---------------------------------------------------------------------------
# MoE: the load-balance loss and the drop case
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["span-2x1", "span-2x2-distinct",
                                  "groups-2x1", "nodrop-2x1"])
def test_moe_drop_case_claims_capacity_per_shard(case, monkeypatch):
    """olmoe's smoke config at capacity factor 0.5: the unsharded step's
    one group of 64 tokens has 128 (token, choice) pairs for 4 experts'
    16 slots each, so tokens drop. "span": the dispatch group of 512
    exceeds a shard's 32 tokens, so the step's one group spans the
    shards: they join their choices in lockstep, and the mesh
    step's loss and gradients equal the unsharded step's (over the
    distinct devices of "2x2-distinct" too, with the experts and the
    vocabulary split). "groups": with a group of 32 tokens the shards'
    groups are the unsharded step's and nothing is joined. "nodrop": at
    capacity factor 8 no group can drop, and each shard claims among its
    own rows, as before: nothing is joined."""
    kind, mesh_name = case.split("-", 1)
    cfg, mesh = _cfg("olmoe-1b-7b", room=False), _mesh(mesh_name)
    factor = 8.0 if kind == "nodrop" else 0.5
    group = 2 * S if kind == "groups" else cfg.moe.dispatch_group
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor, dispatch_group=group))
    t = B // mesh.shape["data"] * S
    assert moe.claim_spans_shards(cfg.moe, t, 2) == (kind == "span")
    joins = []
    real = moe._joint_claim
    monkeypatch.setattr(moe, "_joint_claim",
                        lambda *a: joins.append(len(a)) or real(*a))
    batch = _batch(cfg)
    whole = _state(cfg)
    split, specs = split_train_state(_copy(whole), mesh)
    mloss, _, mgrads = mesh_value_and_grad(cfg, split.params, batch,
                                           specs.params, mesh)
    loss, _, grads = value_and_grad(cfg, whole.params, batch)
    assert bool(joins) == (kind == "span")
    assert float(mloss) == pytest.approx(float(loss), rel=1e-5)
    _assert_grads_close(rules.gather_tree(mgrads, specs.params, mesh, CPU),
                        grads)
    if kind == "span":
        # the shards' own claims (the per-shard model this replaced)
        # drop other pairs: the loss is not the unsharded step's
        terms, stats = [], []
        with torch.no_grad(), ctx.shard_program(2):
            for i in range(2):
                with moe.router_stats() as st:
                    terms.append(model.loss_terms(
                        whole.params, dataclasses.replace(
                            cfg, moe=dataclasses.replace(
                                cfg.moe, dispatch_group=t)),
                        {k: v[2 * i:2 * i + 2] for k, v in batch.items()}))
                stats.append(st)
        own = (sum(x[0] for x in terms) / sum(x[1] for x in terms)
               + moe.load_balance_loss(stats, cfg, CPU))
        assert abs(float(own) - float(loss)) > 1e-4


# ---------------------------------------------------------------------------
# the Trainer over a mesh
# ---------------------------------------------------------------------------
def _run(ckpt_dir, steps=4, arch="phi3-mini-3.8b"):
    return RunConfig(model=_cfg(arch), shape=ShapeConfig("t", 16, 4, "train"),
                     optimizer=dataclasses.replace(OPT, lr=5e-3),
                     steps=steps, checkpoint_every=2,
                     checkpoint_dir=ckpt_dir)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "whisper-tiny"])
def test_trainer_over_a_mesh_matches_and_resumes_on_another(tmp_path, arch):
    """``Trainer(mesh=)`` over four distinct devices: its losses within
    1e-5 of the unsharded Trainer's, its whole state within 1e-4; a fresh
    Trainer over a (4, 1) mesh restores the (2, 2) run's step_2 and reruns
    steps 2-3 within 1e-5."""
    one = Trainer(_run(str(tmp_path / "one"), arch=arch), device="cpu",
                  vocab_cap=64)
    one.train()
    d = str(tmp_path / "mesh")
    tr = Trainer(_run(d, arch=arch), mesh=_mesh("2x2-distinct"),
                 vocab_cap=64)
    tr.train()
    assert rules.is_split(tr.state)
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in one.history], rtol=1e-5)

    run = tr.run
    init = init_train_state(torch.Generator().manual_seed(run.seed),
                            run.model, run.optimizer,
                            max_positions=run.shape.seq_len, device="cpu")
    _assert_trees_close(tr.whole_state(), one.state,
                        [one.stream.batch_at(s) for s in range(run.steps)],
                        run.model, run.optimizer, init.params)

    os.rename(os.path.join(d, "step_4"), str(tmp_path / "step_4_aside"))
    again = Trainer(_run(d, arch=arch), mesh=_mesh(None, (4, 1)),
                    vocab_cap=64)
    again.train()
    assert [h["step"] for h in again.history] == [2, 3]
    np.testing.assert_allclose([h["loss"] for h in again.history],
                               [h["loss"] for h in tr.history[2:]],
                               rtol=1e-5)
