"""The training stack's data, checkpoint, fault and optimizer modules of
the port against the reference, on the CPU: ``repro_torch.data``,
``repro_torch.train.checkpoint``, ``repro_torch.train.fault`` and
``repro_torch.optim`` held case for case to the reference's
``tests/test_data.py``, ``test_checkpoint.py``, ``test_fault.py`` and
``test_optim.py``, plus parity on equal inputs:

- every batch (LM, Whisper, VLM; host slices) equals the reference's bit
  for bit;
- ``adamw_update`` over a model's parameter tree (the reference's stacked
  ranks: a layer's norm scale is decayed) and ``ef_compress_grads`` on
  gradients converted from the reference's, two steps: parameters,
  moments and compressed gradients within 1e-6 of the reference's largest
  magnitude a leaf; Q8_0 moments within one quantization step (their
  block's scale); ``lr_schedule`` and ``global_norm`` too;
- a checkpoint keeps the reference's layout (manifest keys, one uint8
  member a leaf, ``.tmp_step_<N>`` then rename) and round-trips bf16 and
  Q8_0 leaves bit for bit without ``ml_dtypes``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.data.pipeline import make_stream as jax_make_stream
from repro.models import model as jax_model
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (
    OptimizerConfig, RunConfig, ShapeConfig)
from repro_torch.convert import from_jax_params
from repro_torch.core import tree
from repro_torch.core.qformats import QTensor
from repro_torch.data.pipeline import DataCursor, make_stream
from repro_torch.optim.adamw import (
    adamw_init, adamw_update, clip_by_global_norm, global_norm, lr_schedule)
from repro_torch.optim.compression import ef_compress_grads, ef_init
from repro_torch.train.checkpoint import (
    latest_checkpoint, load_checkpoint, remove_old_checkpoints,
    save_checkpoint)
from repro_torch.train.fault import (
    PreemptionHandler, RestartPolicy, StragglerMonitor, run_with_restarts)
from repro_torch.train.step import init_train_state
from repro_torch.train.trainer import Trainer

CPU = torch.device("cpu")
SHAPE = ShapeConfig("t", 32, 8, "train")
JAX_SHAPE = JaxShapeConfig("t", 32, 8, "train")


# ---------------------------------------------------------------------------
# data (tests/test_data.py)
# ---------------------------------------------------------------------------
def _stream(arch="phi3-mini-3.8b", **kw):
    return make_stream(get_smoke_config(arch), SHAPE, vocab_cap=97, **kw)


def _np(b):
    return {k: v.numpy() for k, v in b.items()}


@pytest.mark.parametrize("arch,hosts", [
    ("phi3-mini-3.8b", 1), ("phi3-mini-3.8b", 4), ("whisper-tiny", 1),
    ("whisper-tiny", 2), ("llava-next-mistral-7b", 1)])
def test_batches_equal_reference_bit_for_bit(arch, hosts):
    for host in range(hosts):
        ours = make_stream(get_smoke_config(arch), SHAPE, seed=3,
                           vocab_cap=97, num_hosts=hosts, host_id=host)
        ref = jax_make_stream(jax_smoke_config(arch), JAX_SHAPE, seed=3,
                              vocab_cap=97, num_hosts=hosts, host_id=host)
        for step in (0, 5):
            got, want = _np(ours.batch_at(step)), ref.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                w = np.asarray(want[k])
                assert got[k].dtype == w.dtype and got[k].shape == w.shape
                assert got[k].tobytes() == w.tobytes(), (k, step, host)


def test_deterministic_replay():
    s1, s2 = _stream(), _stream()
    for step in (0, 1, 7, 1000):
        assert torch.equal(s1.batch_at(step)["tokens"],
                           s2.batch_at(step)["tokens"])


def test_steps_differ():
    s = _stream()
    assert not torch.equal(s.batch_at(0)["tokens"], s.batch_at(1)["tokens"])


def test_resume_equals_continuous():
    s = _stream()
    run_a = [s.batch_at(i)["tokens"] for i in range(5)]
    s2 = _stream()
    assert torch.equal(run_a[3], s2.batch_at(3)["tokens"])
    assert torch.equal(run_a[4], s2.batch_at(4)["tokens"])


def test_host_sharding_disjoint_and_complete():
    parts = [_stream(num_hosts=4, host_id=h).batch_at(0)["tokens"]
             for h in range(4)]
    assert all(p.shape[0] == 2 for p in parts)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(parts[i], parts[j])


def test_labels_are_shifted_tokens():
    b = _stream().batch_at(0)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert bool((b["labels"][:, -1] == -1).all())


def test_sequences_are_learnable():
    row = _stream().batch_at(0)["tokens"][0].tolist()
    seen = {}
    for cur, nxt in zip(row[:-1], row[1:]):
        if cur in seen:
            assert seen[cur] == nxt
        seen[cur] = nxt


def test_whisper_stream_has_mel_and_vlm_patches():
    b = _stream("whisper-tiny").batch_at(0)
    assert b["mel"].shape == (8, 32, get_smoke_config("whisper-tiny").n_mels)
    assert b["mel"].dtype == torch.float32
    assert torch.equal(b["mel"], _stream("whisper-tiny").batch_at(0)["mel"])
    p = _stream("llava-next-mistral-7b").batch_at(0)
    assert "patches" in p and p["patches"].ndim == 3


def test_cursor_and_hosts_must_divide():
    c = DataCursor(step=5, seed=1)
    assert c.advance(3).step == 8 and c.advance(3).seed == 1
    with pytest.raises(ValueError):
        make_stream(get_smoke_config("phi3-mini-3.8b"), SHAPE, num_hosts=3)


def test_stream_lands_on_its_device():
    b = make_stream(get_smoke_config("phi3-mini-3.8b"), SHAPE,
                    device="cpu").batch_at(0)
    assert all(t.device == CPU for t in b.values())


# ---------------------------------------------------------------------------
# checkpoint (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------
@pytest.fixture()
def ckpt_dir(tmp_path):
    return str(tmp_path / "ckpt")


@pytest.fixture(scope="module")
def state():
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-14b"),
                              param_dtype="bfloat16")
    return init_train_state(torch.Generator().manual_seed(0), cfg,
                            OptimizerConfig(state_dtype="q8_0",
                                            grad_compress="int8_ef"),
                            64, device="cpu")


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def test_save_load_bit_exact(ckpt_dir, state):
    save_checkpoint(ckpt_dir, state, step=3, cursor_step=3)
    path = latest_checkpoint(ckpt_dir)
    assert path.endswith("step_3")
    template = tree.map_with_path(lambda _, t: _meta(t), state)
    restored, manifest = load_checkpoint(path, template, device="cpu")
    assert manifest["cursor"]["step"] == 3
    assert isinstance(restored.opt.mu["embed"]["table"], QTensor)
    dtypes = set()
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
        dtypes.add(a.dtype)
    assert {torch.bfloat16, torch.int8, torch.float32} <= dtypes


def test_layout_is_the_references(ckpt_dir, state):
    path = save_checkpoint(ckpt_dir, state, step=2, cursor_step=2, seed=5,
                           metadata={"model": "m"})
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert set(man) == {"step", "cursor", "metadata", "leaves"}
    assert man["cursor"] == {"step": 2, "seed": 5}
    assert man["metadata"] == {"model": "m"}
    paths = [leaf["path"] for leaf in man["leaves"]]
    assert paths[0].startswith("params/") and "opt/count" in paths
    assert "opt/mu/embed/table/qs" in paths and "seed" in paths
    with np.load(os.path.join(path, "data.npz")) as data:
        assert sorted(data.files) == sorted(p.replace("/", "__")
                                            for p in paths)
        first = man["leaves"][0]
        raw = data[first["path"].replace("/", "__")]
        assert raw.dtype == np.uint8 and raw.ndim == 1
    assert not any(n.startswith(".tmp") for n in os.listdir(ckpt_dir))


def test_latest_picks_max_step(ckpt_dir, state):
    for s in (1, 10, 2):
        save_checkpoint(ckpt_dir, state, step=s)
    assert latest_checkpoint(ckpt_dir).endswith("step_10")


def test_atomicity_tmp_dirs_ignored(ckpt_dir, state):
    save_checkpoint(ckpt_dir, state, step=1)
    os.makedirs(os.path.join(ckpt_dir, ".tmp_step_99"))
    assert latest_checkpoint(ckpt_dir).endswith("step_1")


def test_overwrite_same_step(ckpt_dir, state):
    save_checkpoint(ckpt_dir, state, step=1)
    save_checkpoint(ckpt_dir, state, step=1)
    assert latest_checkpoint(ckpt_dir).endswith("step_1")


def test_shape_mismatch_rejected(ckpt_dir, state):
    save_checkpoint(ckpt_dir, state, step=1)
    other = init_train_state(torch.Generator().manual_seed(0),
                             get_smoke_config("phi3-mini-3.8b"),
                             OptimizerConfig(), 64, device="cpu")
    with pytest.raises((ValueError, KeyError)):
        load_checkpoint(latest_checkpoint(ckpt_dir), other)


def test_retention(ckpt_dir, state):
    for s in range(6):
        save_checkpoint(ckpt_dir, state, step=s)
    remove_old_checkpoints(ckpt_dir, keep=2)
    assert sorted(os.listdir(ckpt_dir)) == ["step_4", "step_5"]


def test_elastic_restore_onto_a_device_in_place(ckpt_dir, state):
    """A restore lands every leaf on the device asked for; a template
    leaf of the same type there is overwritten in place."""
    save_checkpoint(ckpt_dir, state, step=1)
    template = tree.map_with_path(lambda _, t: torch.zeros_like(t), state)
    before = [t.data_ptr() for t in tree.leaves(template)]
    restored, _ = load_checkpoint(latest_checkpoint(ckpt_dir), template)
    assert [t.data_ptr() for t in tree.leaves(restored)] == before
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert b.device == CPU and torch.equal(a, b)


# ---------------------------------------------------------------------------
# fault (tests/test_fault.py)
# ---------------------------------------------------------------------------
def test_restarts_until_success():
    calls = []

    def make(attempt):
        def fn():
            calls.append(attempt)
            if attempt < 2:
                raise RuntimeError("node died")
            return "done"
        return fn
    assert run_with_restarts(make, RestartPolicy(max_restarts=3,
                                                 backoff_s=0),
                             sleep=lambda s: None) == "done"
    assert calls == [0, 1, 2]


def test_exhausted_restarts_reraise_and_bugs_not_retried():
    def make(attempt):
        def fn():
            raise RuntimeError("always")
        return fn
    with pytest.raises(RuntimeError):
        run_with_restarts(make, RestartPolicy(max_restarts=2, backoff_s=0),
                          sleep=lambda s: None)
    calls = []

    def make_bug(attempt):
        def fn():
            calls.append(attempt)
            raise TypeError("bug")
        return fn
    with pytest.raises(TypeError):
        run_with_restarts(make_bug, RestartPolicy(max_restarts=5,
                                                  backoff_s=0),
                          sleep=lambda s: None)
    assert calls == [0]


def test_backoff_grows():
    sleeps = []

    def make(attempt):
        def fn():
            raise RuntimeError("x")
        return fn
    with pytest.raises(RuntimeError):
        run_with_restarts(make, RestartPolicy(max_restarts=3, backoff_s=0.1,
                                              backoff_factor=2.0),
                          sleep=sleeps.append)
    np.testing.assert_allclose(sleeps, [0.1, 0.2, 0.4], rtol=1e-6)


def test_straggler_flagged_and_ewma_kept():
    mon = StragglerMonitor(warmup_steps=5)
    for s in range(20):
        assert not mon.observe(s, 0.1 + 0.001 * (s % 3))
    assert mon.observe(20, 1.0)
    assert mon.events and mon.events[0]["step"] == 20
    mon = StragglerMonitor(warmup_steps=5)
    for s in range(10):
        mon.observe(s, 0.1)
    mean_before = mon.mean
    mon.observe(10, 5.0)
    assert mon.mean == pytest.approx(mean_before)
    assert not mon.observe(11, 0.1)


def test_gradual_drift_tolerated():
    mon = StragglerMonitor(warmup_steps=5, k_sigma=3.0)
    t, flags = 0.1, 0
    for s in range(100):
        t *= 1.01
        flags += mon.observe(s, t)
    assert flags <= 2


def test_preemption_handler_flag():
    h = PreemptionHandler(install=False)
    assert not h.requested
    h._on_sigterm(None, None)
    assert h.requested


def _run(ckpt_dir, steps, fault_hook=None):
    run = RunConfig(model=get_smoke_config("phi3-mini-3.8b"),
                    shape=ShapeConfig("t", 32, 4, "train"),
                    optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=50),
                    steps=steps, checkpoint_every=2, checkpoint_dir=ckpt_dir)
    tr = Trainer(run, device="cpu", vocab_cap=64, fault_hook=fault_hook)
    tr.train()
    return tr


def test_crash_resume_end_to_end(tmp_path):
    """A failure at step 5; a fresh Trainer resumes from step 4 and its
    losses equal the uninterrupted run's (the CPU is deterministic)."""
    gold = {h["step"]: h["loss"] for h in _run(str(tmp_path / "a"),
                                               8).history}

    def bomb(step):
        if step == 5:
            raise RuntimeError("injected node failure")
    with pytest.raises(RuntimeError):
        _run(str(tmp_path / "b"), 8, fault_hook=bomb)
    resumed = {h["step"]: h["loss"] for h in _run(str(tmp_path / "b"),
                                                  8).history}
    assert sorted(resumed) == [4, 5, 6, 7]
    for s in (4, 5, 6, 7):
        assert resumed[s] == gold[s], s


# ---------------------------------------------------------------------------
# optimizer (tests/test_optim.py)
# ---------------------------------------------------------------------------
def _quadratic(state_dtype="float32", compress=False, steps=300):
    # the reference test's target: np.linspace in f32 (torch.linspace
    # differs in last bits, and with Q8_0 moments the run is chaotic: a
    # second-moment block that quantizes to zero divides by eps alone)
    target = torch.from_numpy(np.linspace(-1, 1, 64).reshape(2, 32).astype(
        np.float32))
    params = {"w": torch.zeros((2, 32))}
    cfg = OptimizerConfig(lr=5e-2, warmup_steps=0, total_steps=400,
                          weight_decay=0.0, state_dtype=state_dtype)
    opt = adamw_init(params, cfg)
    ef = ef_init(params)
    for _ in range(steps):
        g = {"w": 2 * (params["w"] - target)}
        if compress:
            g, ef, _ = ef_compress_grads(g, ef)
        params, opt, _ = adamw_update(g, opt, params, cfg)
    return float(((params["w"] - target) ** 2).sum())


def test_adamw_converges():
    assert _quadratic() < 1e-2


@pytest.mark.parametrize("state_dtype", ["bfloat16", "q8_0"])
def test_adamw_quantized_moments_converge(state_dtype):
    assert _quadratic(state_dtype) < 5e-2


def test_q8_moments_actually_quantized():
    params = {"w": torch.ones((4, 64))}
    cfg = OptimizerConfig(state_dtype="q8_0")
    opt = adamw_init(params, cfg)
    assert isinstance(opt.mu["w"], QTensor)
    _, opt2, _ = adamw_update({"w": torch.full((4, 64), 0.5)}, opt, params,
                              cfg)
    assert isinstance(opt2.mu["w"], QTensor)
    assert opt2.mu["w"].qs.dtype == torch.int8


def test_lr_schedule_shape_and_equal_to_reference():
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = JaxOptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, torch.tensor(s))) for s in range(0, 101, 5)]
    ref = [float(jax_adamw.lr_schedule(jcfg, jnp.asarray(s)))
           for s in range(0, 101, 5)]
    np.testing.assert_allclose(lrs, ref, rtol=1e-6, atol=0)
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1e-3, rel=0.02)
    assert lrs[-1] == pytest.approx(1e-4, rel=0.05)
    assert lrs[1] < lrs[2]


def test_global_norm_clip():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    np.testing.assert_allclose(float(global_norm(g)), np.sqrt(90 + 160),
                               rtol=1e-6)
    clipped, _ = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    unclipped, _ = clip_by_global_norm(g, 100.0)
    np.testing.assert_allclose(unclipped["a"].numpy(), 3.0, rtol=1e-6)


def test_weight_decay_skips_1d_and_follows_reference_ranks():
    """1-D leaves are not decayed; a layer's norm scale, 2-D in the
    reference's stacked layout, is."""
    params = {"w": torch.ones((2, 32)), "norm": torch.ones((32,)),
              "stack": {"blocks": [{"norm1": {"scale": torch.ones((32,))}}]}}
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=0, weight_decay=1.0)
    opt = adamw_init(params, cfg)
    zero_g = tree.map_with_path(lambda _, t: torch.zeros_like(t), params)
    p2, _, _ = adamw_update(zero_g, opt, params, cfg)
    assert float((p2["norm"] - 1.0).abs().max()) < 1e-7
    assert float(p2["w"].max()) < 1.0
    assert float(p2["stack"]["blocks"][0]["norm1"]["scale"].max()) < 1.0


def test_ef_compression_ratio():
    grads = {"w": torch.ones((64, 128))}
    _, _, stats = ef_compress_grads(grads, ef_init(grads))
    assert 3.0 < 1.0 / stats["ratio"] < 4.2


def test_ef_error_feedback_carries_residual():
    big, tiny = 1.0, 1.0 / 10_000.0
    g = {"w": torch.tensor([[big] + [tiny] * 31])}
    ef = ef_init(g)
    passed = torch.zeros((1, 32))
    for _ in range(200):
        out, ef, _ = ef_compress_grads(g, ef)
        passed = passed + out["w"]
    assert float(passed[0, 5]) == pytest.approx(200 * tiny, rel=0.2)


def test_ef_convergence_matches_uncompressed():
    plain = _quadratic(steps=250)
    assert _quadratic(compress=True, steps=250) < max(10 * plain, 5e-2)


# ---------------------------------------------------------------------------
# optimizer parity with the reference on equal inputs
# ---------------------------------------------------------------------------
def _ref_setup(arch, state_dtype, compress):
    cfg = jax_smoke_config(arch)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), cfg, 32)
    rng = np.random.default_rng(7)
    jgrads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
            np.float32) * 0.1, p.dtype), jparams) for _ in range(2)]
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10,
                state_dtype=state_dtype, grad_clip=1.0,
                grad_compress="int8_ef" if compress else "none")
    return jparams, jgrads, JaxOptimizerConfig(**ocfg), OptimizerConfig(**ocfg)


def _to_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, what):
    w = np.asarray(want, np.float32)
    g = got.to(torch.float32).numpy()
    assert g.shape == w.shape, what
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=1e-6 * max(float(np.abs(w).max()), 1.0),
                               err_msg=what)


def _port_opt(jopt):
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(from_jax_params(_to_np(jopt.mu), device="cpu"),
                      from_jax_params(_to_np(jopt.nu), device="cpu"),
                      torch.from_numpy(np.array(jopt.count)))


def _moments_close(got, want, what):
    """f32 moments to 1e-6 of the leaf's largest magnitude; a bf16 moment
    to that plus one bf16 step (2^-7 of its magnitude: the f32 value before
    the rounding may differ in its last bits, XLA fusing products into
    FMAs); a Q8_0 moment to one quantization step, its block's scale."""
    is_q = lambda x: isinstance(x, QTensor)  # noqa: E731
    for a, b in zip(tree.leaves(got, is_leaf=is_q),
                    tree.leaves(want, is_leaf=is_q), strict=True):
        assert type(a) is type(b), what
        if isinstance(a, QTensor):
            da = a.qs.to(torch.float32) * a.scales[..., None]
            db = b.qs.to(torch.float32) * b.scales[..., None]
            step = torch.maximum(a.scales, b.scales)[..., None]
            assert bool(((da - db).abs() <= step * (1 + 1e-6)).all()), what
        elif a.dtype == torch.bfloat16:
            a, b = a.to(torch.float32), b.to(torch.float32)
            bad = (a - b).abs() > (torch.maximum(a.abs(), b.abs()) * 2 ** -7
                                   + 1e-6 * float(b.abs().max()))
            assert not bool(bad.any()), (what, a[bad], b[bad])
        else:
            assert a.dtype == b.dtype
            _close(a, b.numpy(), what)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "q8_0"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "whisper-tiny"])
def test_adamw_and_ef_equal_reference_on_equal_inputs(arch, state_dtype):
    """Two steps, each from the reference's state of that step (converted):
    the compressed gradients, the new parameters (1e-6 of each leaf's
    largest magnitude), moments, error trees and metrics."""
    jparams, jgrads, jcfg, cfg = _ref_setup(arch, state_dtype,
                                            compress=True)
    jopt, jef = jax_adamw.adamw_init(jparams, jcfg), None
    jef = jax_compression.ef_init(jparams)
    for jg in jgrads:
        params = from_jax_params(_to_np(jparams), device="cpu")
        opt = _port_opt(jopt)
        ef = from_jax_params(_to_np(jef), device="cpu")
        g = from_jax_params(_to_np(jg), device="cpu")
        jg, jef, jstats = jax_compression.ef_compress_grads(jg, jef)
        g, ef, stats = ef_compress_grads(g, ef)
        assert stats == jstats
        for a, b in zip(tree.leaves(g),
                        tree.leaves(from_jax_params(_to_np(jg),
                                                    device="cpu"))):
            _close(a, b.numpy(), "compressed grad")
        for a, b in zip(tree.leaves(ef),
                        tree.leaves(from_jax_params(_to_np(jef),
                                                    device="cpu"))):
            _close(a, b.numpy(), "ef")
        jparams, jopt, jm = jax_adamw.adamw_update(jg, jopt, jparams, jcfg)
        params, opt, m = adamw_update(g, opt, params, cfg)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
        assert int(opt.count) == int(jopt.count)
        for a, b in zip(tree.leaves(params),
                        tree.leaves(from_jax_params(_to_np(jparams),
                                                    device="cpu"))):
            _close(a, b.numpy(), "params")
        for name in ("mu", "nu"):
            _moments_close(getattr(opt, name),
                           from_jax_params(_to_np(getattr(jopt, name)),
                                           device="cpu"), name)
    assert int(jopt.count) == 2
