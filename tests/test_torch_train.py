"""The training path of the port against the reference, on the CPU:
``repro_torch.train`` (step, trainer, CLI), the flash-2 backward
(``flash_attention_bwd_plain`` and ``_FlashCore``), ``remat``,
``sharding.rules.train_state_specs`` and ``convert.from_jax_train_state``,
held to ``repro.train``, ``repro.models`` and the reference's
``tests/test_trainer.py`` and ``test_attention_impls.py``:

- the flash backward against ``jax.grad`` of the reference's
  ``_flash_attention`` (its custom VJP) on the reference test's shapes
  (GQA, cross lengths, one query, ragged against the key block) at
  rtol = atol = 1e-4, the reference test's tolerance: the reference walks
  its keys in one block where the port walks 64 at a time, so the
  logsumexp and the gradients differ by rounding;
- ``loss_fn``'s gradients against ``jax.grad`` of the reference's, for one
  smoke config of every family (audio, dense, MoE, SSM, hybrid, VLM)
  under both ``attn_impl``s: max |d| <= 1e-4 max |g_ref| a leaf (at
  least 1e-6 of the largest gradient, for a leaf whose exact gradient is
  zero), and
  ``remat="full"`` and ``"dots"`` bit for bit ``"none"``'s;
- ``remat`` checkpoints only where a gradient is recorded; ``loss_fn``'s
  CE chunks are checkpointed in training;
- the first 3 ``Trainer`` losses from a converted reference state within
  1e-4 relative of the reference Trainer's; the reference's trainer tests
  (convergence, resume cursor, straggler metrics, microbatches equal to
  one batch, int8 error feedback), ``Trainer(mesh=)`` refused for an
  abstract mesh and training over four ``cpu`` entries (the mesh step is
  held leaf by leaf in ``test_torch_train_mesh.py``); the CLI on the CPU,
  ``--mesh`` included, refused without a card;
- ``train_state_specs`` leaf by leaf against the reference's on four
  abstract meshes (Q8_0 moments and error-feedback trees included);
  ``from_jax_train_state`` leaf for leaf; the new configs field for
  field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.qformats import QTensor as JaxQTensor
from repro.launch.mesh import abstract_mesh as jax_abstract_mesh
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression
from repro.sharding import rules as jax_rules
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.configs import base, get_config, get_smoke_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import ALL_ARCHS
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.core import tree
from repro_torch.core.qformats import QTensor
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_fwd_plain)
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import abstract_mesh, make_smoke_mesh
from repro_torch.models import model, transformer
from repro_torch.models.attention import _flash_attention
from repro_torch.sharding import rules
from repro_torch.train.step import init_train_state, make_train_step, \
    value_and_grad
from repro_torch.train.trainer import Trainer

B, S, PATCHES = 2, 16, 4
FAMILY_ARCHS = ["whisper-tiny", "phi3-mini-3.8b", "olmoe-1b-7b",
                "mamba2-780m", "jamba-v0.1-52b", "llava-next-mistral-7b"]


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


# ---------------------------------------------------------------------------
# the flash-2 backward (tests/test_attention_impls.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 64, 64, 4, 2, 16, True),
    (1, 128, 128, 8, 8, 32, True),
    (2, 32, 96, 4, 1, 16, False),     # cross-attention lengths
    (2, 1, 64, 4, 2, 16, True),       # one query
    (2, 48, 48, 4, 4, 16, True),      # ragged against the key block
    (1, 100, 100, 2, 2, 32, False),   # ragged against 64
])
def test_flash_backward_matches_reference_grad(b, sq, sk, hq, hkv, d,
                                               causal):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    w = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_attention._flash_attention(
        q, k, v, causal, 32) * w), argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    (_flash_attention(tq, tk, tv, causal) * torch.from_numpy(w)).sum(
    ).backward()
    for g, x in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-4,
                                   atol=1e-4)

    # the plain backward alone, on the folded (BH, S, D) operands: the
    # reference's per-head gradients, k's and v's summed over each GQA
    # group
    g = hq // hkv

    def fold(a, h):
        return torch.from_numpy(a).transpose(1, 2).reshape(b * h, -1, d)
    fq = fold(q, hq)
    fk = fold(np.repeat(k, g, axis=2), hq)
    fv = fold(np.repeat(v, g, axis=2), hq)
    out, lse = flash_attention_fwd_plain(fq, fk, fv, causal=causal,
                                         return_lse=True)
    dq, dk, dv = flash_attention_bwd_plain(fq, fk, fv, out, fold(w, hq), lse,
                                           causal=causal)

    def unfold(t, h):
        return t.reshape(b, h, -1, d).transpose(1, 2).numpy()
    np.testing.assert_allclose(unfold(dq, hq), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    for got, x in ((dk, want[1]), (dv, want[2])):
        got = unfold(got, hq).reshape(b, sk, hkv, g, d).sum(axis=3)
        np.testing.assert_allclose(got, np.asarray(x), rtol=1e-4, atol=1e-4)


def _bwd_operands(dtype=torch.float32, bh=2, sq=5, sk=7, d=16):
    g = torch.Generator().manual_seed(0)
    q, out, dout = (torch.randn(bh, sq, d, generator=g).to(dtype)
                    for _ in range(3))
    k, v = (torch.randn(bh, sk, d, generator=g).to(dtype) for _ in range(2))
    return [q, k, v, out, dout, torch.randn(bh, sq, generator=g)]


def _misshape(i, shape):
    def edit(args):
        args[i] = torch.zeros(shape, dtype=args[i].dtype)
    return edit


def _retype(i, dtype):
    def edit(args):
        args[i] = args[i].to(dtype)
    return edit


def _last_strided(i):
    def edit(args):
        t = args[i]
        args[i] = t.transpose(1, 2).contiguous().transpose(1, 2)
    return edit


def _on_meta(i):
    def edit(args):
        args[i] = args[i].to("meta")
    return edit


@pytest.mark.parametrize("edit,error", [
    (_misshape(0, (2, 5)), ValueError),             # q not 3-D
    (_misshape(1, (2, 6, 16)), ValueError),         # k and v disagree
    (_misshape(0, (2, 0, 16)), ValueError),         # Sq = 0
    (_misshape(3, (2, 4, 16)), ValueError),         # out not q's shape
    (_misshape(4, (2, 5, 8)), ValueError),          # dout not q's shape
    (_misshape(5, (2, 4)), ValueError),             # lse not (BH, Sq)
    (_retype(5, torch.float64), ValueError),        # lse not f32
    (_retype(0, torch.float16), TypeError),         # q not f32 or bf16
    (_retype(1, torch.bfloat16), TypeError),        # k not q's type
    (_retype(4, torch.bfloat16), TypeError),        # dout not q's type
    (_last_strided(0), ValueError),                 # q's D stride not 1
    (_on_meta(3), ValueError),                      # out elsewhere
])
def test_flash_backward_wrapper_refuses_what_it_refused(edit, error):
    """The wrapper's shape, type and device checks, which run before the
    route is chosen: what they refused before the (BH, S) strides were
    taken as they are, they refuse now."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    args = _bwd_operands()
    edit(args)
    with pytest.raises(error):
        flash_attention_bwd(*args[:5], args[5], causal=True)


@pytest.mark.parametrize("offset,pad,copied", [
    (0, 0, False), (8, 0, False),      # rows on 16-byte boundaries
    (1, 0, True),                      # the start 2 bytes off a boundary
    (0, 4, True)])                     # a row stride of 36 bf16 values
def test_flash_backward_aligns_bf16_rows(offset, pad, copied):
    """What the bf16 backward hands its tensor-core kernels: an operand
    whose rows all start on 16-byte boundaries as it is, any other as a
    fresh contiguous copy with the same values (``contiguous()`` would
    return an unaligned contiguous view itself)."""
    from repro_torch.kernels.flash_attention import _align_rows
    bh, s, d = 2, 5, 32
    buf = torch.arange(bh * s * (d + pad) + offset,
                       dtype=torch.float32).to(torch.bfloat16)
    t = buf[offset:].view(bh, s, d + pad)[..., :d]
    got = _align_rows(t)
    assert (got is not t) == copied and torch.equal(got, t)
    assert got.data_ptr() % 16 == 0
    assert all(st * 2 % 16 == 0 for st in got.stride()[:2])


def test_raw_forward_with_a_gradient_raises():
    q = torch.randn(2, 8, 16, requires_grad=True)
    k, v = torch.randn(2, 8, 16), torch.randn(2, 8, 16)
    with pytest.raises(RuntimeError, match="_FlashCore"):
        flash_attention_fwd(q, k, v)
    with torch.no_grad():
        flash_attention_fwd(q, k, v)
    flash_attention_fwd(q.detach(), k, v)


# ---------------------------------------------------------------------------
# loss_fn gradients against jax.grad, every family, both attention impls
# ---------------------------------------------------------------------------
_PARAMS = {}


def _smoke(arch):
    if arch not in _PARAMS:
        jcfg = jax_smoke_config(arch)
        if jcfg.quant == "q8_0" and jcfg.moe is not None:
            jcfg = dataclasses.replace(jcfg, quant="none")
        jp = jax.jit(lambda key: jax_model.init_params(key, jcfg, 64))(
            jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, from_jax_params(_np_tree(jp), device="cpu"))
    return _PARAMS[arch]


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :2] = -1
    arrays["labels"] = labels
    if cfg.family == "audio":
        arrays["mel"] = rng.standard_normal((B, S, cfg.n_mels)).astype(
            np.float32)
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (B, PATCHES, cfg.vision_embed_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_gradients_match_reference(arch, impl):
    jp, tp = _smoke(arch)
    jcfg = dataclasses.replace(jax_smoke_config(arch), attn_impl=impl)
    jb, tb = _batch(jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    want = tree.leaves(from_jax_params(_np_tree(jgrads), device="cpu"))

    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(get_smoke_config(arch), attn_impl=impl,
                                  remat=remat)
        loss, aux, grads = value_and_grad(cfg, tp, tb)
        runs[remat] = (loss, tree.leaves(grads))
    loss, got = runs["none"]
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert len(got) == len(want)
    # a leaf whose gradient is zero in exact arithmetic (the key
    # projection's bias: softmax ignores a shift common to every key) holds
    # rounding noise alone: the floor is f32 noise of the largest gradient
    floor = 1e-6 * max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        tol = max(1e-4 * float(w.abs().max()), floor)
        assert float((g - w).abs().max()) <= tol
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], loss)
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][1], got))
    assert not any(t.requires_grad for t in tree.leaves(tp))


def _counting(monkeypatch, module):
    calls = []
    real = module.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, "checkpoint", counted)
    return calls


def test_remat_only_where_a_gradient_is_recorded(monkeypatch):
    """Full remat checkpoints each pattern repeat when training; under
    ``no_grad``, ``inference_mode`` or with no parameter requiring grad,
    nothing is checkpointed."""
    _, tp = _smoke("jamba-v0.1-52b")
    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"),
                              quant="none", remat="full")
    _, tb = _batch(cfg)
    calls = _counting(monkeypatch, transformer)
    with torch.no_grad():
        model.loss_fn(tp, cfg, tb)
    with torch.inference_mode():
        model.loss_fn(tp, cfg, tb)
    model.loss_fn(tp, cfg, tb)
    assert calls == []
    value_and_grad(cfg, tp, tb)
    assert len(calls) == transformer.n_repeats(cfg) >= 1


def test_ce_chunks_are_checkpointed_in_training(monkeypatch):
    _, tp = _smoke("phi3-mini-3.8b")
    cfg = get_smoke_config("phi3-mini-3.8b")
    _, tb = _batch(cfg)
    calls = _counting(monkeypatch, model)
    model.loss_fn(tp, cfg, tb, ce_chunk=4)
    assert calls == []
    leaves = tree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    try:
        chunked, _ = model.loss_fn(tp, cfg, tb, ce_chunk=4)
        g4 = torch.autograd.grad(chunked, leaves)
        assert len(calls) == S // 4
        whole, _ = model.loss_fn(tp, cfg, tb, ce_chunk=S)
        g1 = torch.autograd.grad(whole, leaves)
        chunked, whole = chunked.detach(), whole.detach()
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert float(chunked) == pytest.approx(float(whole), rel=1e-6)
    for a, b in zip(g4, g1):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# the Trainer (tests/test_trainer.py) and parity from a reference state
# ---------------------------------------------------------------------------
def _run_cfg(ckpt_dir, steps=6, arch="phi3-mini-3.8b", **opt):
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=40, **opt)
    return RunConfig(model=get_smoke_config(arch),
                     shape=ShapeConfig("t", 32, 4, "train"),
                     optimizer=OptimizerConfig(**kw), steps=steps,
                     checkpoint_every=3, checkpoint_dir=ckpt_dir)


@pytest.mark.parametrize("arch,impl", [("phi3-mini-3.8b", "chunked"),
                                       ("whisper-tiny", "flash")])
def test_trainer_losses_from_a_reference_state_match(tmp_path, arch, impl):
    jcfg = dataclasses.replace(jax_smoke_config(arch), attn_impl=impl)
    jopt = jax_base.OptimizerConfig(lr=5e-3, warmup_steps=2, total_steps=40)
    jrun = jax_base.RunConfig(model=jcfg,
                              shape=jax_base.ShapeConfig("t", 32, 4, "train"),
                              optimizer=jopt, steps=3, checkpoint_every=100,
                              checkpoint_dir=str(tmp_path / "ref"))
    ref = JaxTrainer(jrun, vocab_cap=64)
    ref.train()
    state0 = jax_init_train_state(jax.random.PRNGKey(jrun.seed), jcfg, jopt,
                                  max_positions=32)

    run = dataclasses.replace(
        _run_cfg(str(tmp_path / "port"), steps=3, arch=arch),
        model=dataclasses.replace(get_smoke_config(arch), attn_impl=impl),
        checkpoint_every=100)
    tr = Trainer(run, device="cpu", vocab_cap=64)
    tr.state = from_jax_train_state(_np_tree(state0), device="cpu")
    tr.train()
    got = [h["loss"] for h in tr.history]
    want = [h["loss"] for h in ref.history]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert [h["step"] for h in tr.history] == [0, 1, 2]


def test_loss_decreases(tmp_path):
    tr = Trainer(_run_cfg(str(tmp_path / "c"), steps=10), device="cpu",
                 vocab_cap=64)
    tr.train()
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_resume_cursor_and_straggler_metrics(tmp_path):
    d = str(tmp_path / "c")
    first = Trainer(_run_cfg(d, steps=6), device="cpu", vocab_cap=64)
    first.train()
    assert all("dt_s" in h and "straggler" in h for h in first.history)
    tr2 = Trainer(_run_cfg(d, steps=6), device="cpu", vocab_cap=64)
    tr2._init_or_restore()
    assert tr2._start_step == 6
    tr2.train(steps=8)
    assert [h["step"] for h in tr2.history] == [6, 7]


def test_microbatch_grads_match_monolithic():
    cfg = get_smoke_config("qwen2.5-14b")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}

    def state():
        return init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                64, device="cpu")
    s1, m1 = make_train_step(cfg, opt)(state(), batch)
    s4, m4 = make_train_step(cfg, opt, microbatches=4)(state(), batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for a, b in zip(tree.leaves(s1.params), tree.leaves(s4.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=2e-4)
    assert int(s1.step) == int(s4.step) == 1


def test_int8_ef_training_runs(tmp_path):
    run = dataclasses.replace(
        _run_cfg(str(tmp_path / "c"), grad_compress="int8_ef"),
        checkpoint_every=100)
    tr = Trainer(run, device="cpu", vocab_cap=64)
    tr.train()
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0] * 1.2
    assert tree.leaves(tr.state.ef)


def test_mesh_training_is_refused(tmp_path):
    """An abstract mesh (axis sizes, no devices) is refused; a mesh of
    devices trains: the reference's smoke mesh over four ``cpu`` entries
    gives the unsharded Trainer's losses (``test_torch_train_mesh.py``
    holds the mesh step leaf by leaf)."""
    with pytest.raises(ValueError, match="abstract"):
        Trainer(_run_cfg(str(tmp_path / "a")), device="cpu",
                mesh=abstract_mesh((2, 2), ("data", "model")))
    one = Trainer(_run_cfg(str(tmp_path / "one"), steps=3), device="cpu",
                  vocab_cap=64)
    one.train()
    tr = Trainer(_run_cfg(str(tmp_path / "mesh"), steps=3),
                 mesh=make_smoke_mesh([torch.device("cpu")] * 4),
                 vocab_cap=64)
    tr.train()
    assert tr.mesh.shape == {"data": 2, "model": 2}
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in one.history], rtol=1e-5)


def test_cli_trains_on_the_cpu_and_refuses_what_it_lacks(tmp_path, capsys):
    d = str(tmp_path / "c")
    assert train_cli.main(["--arch", "whisper-tiny", "--steps", "4",
                           "--ckpt-every", "2", "--ckpt-dir", d,
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("final:") and "'step': 3" in out
    # --mesh with --device cpu: the reference's smoke mesh of one device
    assert train_cli.main(["--arch", "phi3-mini-3.8b", "--mesh", "--steps",
                           "2", "--ckpt-dir", str(tmp_path / "m"),
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("training mesh: {'data': 1, 'model': 1} over 1")
    assert "final:" in out and "'step': 1" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(["--arch", "phi3-mini-3.8b", "--steps", "1",
                            "--ckpt-dir", d])


# ---------------------------------------------------------------------------
# train_state_specs, from_jax_train_state, configs
# ---------------------------------------------------------------------------
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 1), ("data", "model")),
          ((2, 2), ("data", "model"))]


def _meta(shape):
    return torch.empty(tuple(shape), device="meta")


def _port_shapes(ref, stacked: bool):
    """A reference (sub)tree of shapes in the port's leaf types."""
    if isinstance(ref, dict):
        return {k: _port_shapes(v, stacked) for k, v in ref.items()}
    if isinstance(ref, JaxQTensor):
        drop = 1 if stacked else 0
        return QTensor(_meta(ref.qs.shape[drop:]),
                       _meta(ref.scales.shape[drop:]))
    shape = ref.shape[1:] if stacked and ref.shape else ref.shape
    return _meta(shape)


def _layers(ref) -> int:
    while isinstance(ref, dict):
        ref = next(iter(ref.values()))
    return (ref.qs if isinstance(ref, JaxQTensor) else ref).shape[0]


def _port_param_tree(ref):
    out = {}
    for key, sub in ref.items():
        if key in ("enc_blocks", "dec_blocks"):
            out[key] = [_port_shapes(sub, True)
                        for _ in range(_layers(sub))]
        elif key == "stack":
            pat = sub["blocks"]
            n = len(pat) * _layers(pat[0])
            out[key] = {"blocks": [_port_shapes(pat[i % len(pat)], True)
                                   for i in range(n)]}
        else:
            out[key] = _port_shapes(sub, False)
    return out


def _ref_path(path, period):
    """A port state path -> (the reference's path, stacked)."""
    pre = next((p for p in (("params",), ("opt", "mu"), ("opt", "nu"),
                            ("ef",)) if path[:len(p)] == p), None)
    if pre is None:
        return "/".join(path), False
    rest = path[len(pre):]
    if rest[0] in ("enc_blocks", "dec_blocks"):
        return "/".join(pre + (rest[0],) + rest[2:]), True
    if rest[:2] == ("stack", "blocks"):
        return "/".join(pre + ("stack", "blocks", str(int(rest[2]) % period))
                        + rest[3:]), True
    return "/".join(path), False


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "whisper-small",
                                  "llava-next-mistral-7b"])
def test_train_state_specs_equal_reference_leaf_by_leaf(arch):
    cfg = jax_config(arch)
    opt = jax_base.OptimizerConfig(state_dtype="q8_0",
                                   grad_compress="int8_ef")
    ref = jax.eval_shape(lambda: jax_init_train_state(
        jax.random.PRNGKey(0), cfg, opt,
        448 if cfg.family == "audio" else 0))
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState
    port = TrainState(
        params=_port_param_tree(ref.params),
        opt=AdamWState(_port_param_tree(ref.opt.mu),
                       _port_param_tree(ref.opt.nu), _meta(())),
        ef=_port_param_tree(ref.ef), seed=_meta(()))
    period = len(ref.params["stack"]["blocks"]) if "stack" in ref.params \
        else 1
    for shape, axes in MESHES:
        want = jax.tree_util.tree_flatten_with_path(
            jax_rules.train_state_specs(ref, jax_abstract_mesh(shape, axes)),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        want = {jax_rules._path_str(p): tuple(s) for p, s in want}
        got = rules.train_state_specs(port, abstract_mesh(shape, axes))
        for path, spec in tree.leaves_with_path(
                got, is_leaf=lambda x: isinstance(x, rules.P)):
            if path == ("seed",):          # the reference's key: replicated
                assert tuple(spec) == () == want["rng"]
                continue
            rpath, stacked = _ref_path(path, period)
            w = want[rpath]
            if stacked and w:
                w = w[1:]
            while w and w[-1] is None:
                w = w[:-1]
            assert tuple(spec) == w, (shape, path)


def test_from_jax_train_state_carries_every_leaf():
    jcfg = jax_smoke_config("phi3-mini-3.8b")
    opt = jax_base.OptimizerConfig(state_dtype="q8_0",
                                   grad_compress="int8_ef", lr=1e-2,
                                   warmup_steps=0)
    jstate = jax.jit(lambda key: jax_init_train_state(key, jcfg, opt, 32))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), jstate.params)

    @jax.jit
    def step(st, g):
        g, ef, _ = jax_compression.ef_compress_grads(g, st.ef)
        params, jopt, _ = jax_adamw.adamw_update(g, st.opt, st.params, opt)
        return st._replace(params=params, opt=jopt, ef=ef)
    jstate = step(jstate, grads)
    state = from_jax_train_state(_np_tree(jstate), seed=4, device="cpu")
    assert int(state.opt.count) == 1 and int(state.seed) == 4
    assert isinstance(state.opt.mu["embed"]["table"], QTensor)
    n_layers = jcfg.num_layers
    assert len(state.params["stack"]["blocks"]) == n_layers
    for sub, ref in ((state.params, jstate.params),
                     (state.opt.mu, jstate.opt.mu),
                     (state.opt.nu, jstate.opt.nu), (state.ef, jstate.ef)):
        want = from_jax_params(_np_tree(ref), device="cpu")
        for a, b in zip(tree.leaves(sub), tree.leaves(want), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # layer i of the port is repeat i of the reference's stack (P = 1); a
    # layer's norm scale, 2-D stacked, keeps Q8_0 moments
    mu = jstate.opt.mu["stack"]["blocks"][0]["norm1"]["scale"]
    got = state.opt.mu["stack"]["blocks"][1]["norm1"]["scale"]
    assert isinstance(got, QTensor)
    np.testing.assert_array_equal(got.qs.numpy(), np.asarray(mu.qs[1]))


def test_configs_equal_the_references():
    def names(cls):
        return [f.name for f in dataclasses.fields(cls)]
    assert names(ShapeConfig) == names(jax_base.ShapeConfig)
    assert dataclasses.asdict(ShapeConfig("t", 32, 4, "train")) == \
        dataclasses.asdict(jax_base.ShapeConfig("t", 32, 4, "train"))
    for arch in sorted(ALL_ARCHS):
        cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
        assert cfg.remat == jcfg.remat == "none"
        assert get_config(arch).remat == jax_config(arch).remat
    full = base.ModelConfig(name="x", family="dense", num_layers=1,
                            d_model=8, num_heads=1, num_kv_heads=1, d_ff=8,
                            vocab_size=8)
    assert full.remat == "full"
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(full, remat="some")
    assert dataclasses.asdict(OptimizerConfig()) == dataclasses.asdict(
        jax_base.OptimizerConfig())
    # the reference's log_every, which its Trainer never reads, is left out
    ours = {f.name for f in dataclasses.fields(RunConfig)}
    assert ours == {f.name for f in dataclasses.fields(jax_base.RunConfig)
                    } - {"log_every"}
