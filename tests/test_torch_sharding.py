"""Sharded serving (slot-DP over a device mesh) against the reference, on
the CPU: ``repro_torch.launch.mesh``, ``repro_torch.sharding`` and the
sharded paths of ``repro_torch.serve`` held against ``repro.launch.mesh``,
``repro.sharding`` and the reference's serving engine.

- the rules: ``param_specs``, ``serve_param_specs`` and ``batch_specs`` of
  every config in the registry, dense and Q8_0, on four abstract meshes,
  leaf by leaf (the trees built from shapes alone: the reference's
  through ``jax.eval_shape``, the port's as meta tensors); the state specs
  (``cache_specs``, ``slot_state_specs``, ``paged_state_specs``) in
  meaning on the smoke states, the divisibility fallbacks included. The
  port keeps a list of layers where the reference stacks them: a layer's
  spec is the stacked leaf's without its layer-axis entry;
- ``ctx._resolve`` over a grid of tokens, dims and meshes, and
  ``constrain``'s rank check; mesh signatures, plan keys and the ledger's
  per-device split, remainders included; the shard-aware pick order;
- the reference's own sharded gate (``tests/test_sharded_serve.py``'s
  trace: whisper-tiny smoke, 6 mels of 16 frames, max_new 3-9, 4 slots,
  Q8_0 + offload and dense) at data = 4 and 2 over ``cpu`` entries:
  tokens equal to the reference's unsharded scheduler's, one step build,
  plan keys disjoint from the unsharded engine's, ``sum(by_device)`` the
  ledger's FLOPs with every device listed, ledger totals equal to the
  unsharded port's; the paged pool, ``SpecScheduler`` and its round
  schedulers, the one-shot split, and every LM family's smoke config
  through the slot scheduler at data = 2 (the MoE drop case pinned: to
  the reference's unsharded scheduler, and over ragged arrivals, where
  the reference's sharded scheduler parts from it, to that one);
- the refusals, the telemetry's ``device`` series and the CLI's
  ``--mesh``.

Tokens, counts, keys and specs are exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ALL_ARCHS as JAX_ARCHS
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.core.offload import OffloadLedger as JaxLedger
from repro.core.plan import PlanEntry as JaxPlanEntry
from repro.core.plan import plan_key as jax_plan_key
from repro.core.qformats import QTensor as JaxQTensor
from repro.core.qformats import quantize_tree as jax_quantize_tree
from repro.launch.mesh import abstract_mesh as jax_abstract_mesh
from repro.models import model as jax_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.engine import _keep_dense as jax_keep_dense
from repro.serve.kvcache import SlotKVPool as JaxSlotKVPool
from repro.serve.paging import PagedKVPool as JaxPagedKVPool
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from repro.sharding import ctx as jax_ctx
from repro.sharding import rules as jax_rules
from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.configs.registry import ALL_ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.core.offload import OffloadEngine, OffloadLedger
from repro_torch.core import tree as tree_lib
from repro_torch.core.plan import PlanEntry, plan_key
from repro_torch.core.qformats import QTensor
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import (
    abstract_mesh, make_production_mesh, make_serve_mesh, make_smoke_mesh)
from repro_torch.models import model
from repro_torch.models.attention import ModelShards
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import SlotKVPool
from repro_torch.serve.paging import PagedKVPool
from repro_torch.serve.speculative import SpecScheduler
from repro_torch.sharding import ctx, rules

CPU = torch.device("cpu")
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 1), ("data", "model")),
          ((2, 2), ("data", "model"))]
MESH_IDS = ["16x16", "2x16x16", "4x1", "2x2"]


def _cpu_mesh(data, model_=1):
    return make_serve_mesh(data=data, model=model_,
                           devices=[CPU] * (data * model_))


# ---------------------------------------------------------------------------
# the rules, leaf by leaf, on trees of shapes
# ---------------------------------------------------------------------------
def _meta(shape) -> torch.Tensor:
    return torch.empty(tuple(shape), device="meta")


def _conv(tree, drop: int = 0):
    """A reference (sub)tree of shapes as the port's leaf types, the
    leading ``drop`` dims (a stacked layer axis) left out."""
    if isinstance(tree, dict):
        return {k: _conv(v, drop) for k, v in tree.items()}
    if isinstance(tree, JaxQTensor):
        return QTensor(_meta(tree.qs.shape[drop:]),
                       _meta(tree.scales.shape[drop:]))
    return _meta(tree.shape[drop:])


def _layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    if isinstance(tree, JaxQTensor):
        tree = tree.qs
    return tree.shape[0]


def _port_tree(ref):
    """The port's layout of a reference parameter tree (``convert``'s):
    the stacked blocks split into one dict a layer."""
    out = {}
    for key, sub in ref.items():
        if key in ("enc_blocks", "dec_blocks"):
            out[key] = [_conv(sub, 1) for _ in range(_layers(sub))]
        elif key == "stack":
            pat = sub["blocks"]
            n = len(pat) * _layers(pat[0])
            out[key] = {"blocks": [_conv(pat[i % len(pat)], 1)
                                   for i in range(n)]}
        else:
            out[key] = _conv(sub)
    return out


_TREES = {}


def _trees(arch, quant):
    """(the reference's tree of shapes, the port's) at full width."""
    key = (arch, quant)
    if key not in _TREES:
        cfg = jax_config(arch)

        def build():
            p = jax_model.init_params(jax.random.PRNGKey(0), cfg,
                                      448 if cfg.family == "audio" else 0)
            return (jax_quantize_tree(p, jax_keep_dense)
                    if quant == "q8_0" else p)

        ref = jax.eval_shape(build)
        _TREES[key] = (ref, _port_tree(ref))
    return _TREES[key]


def _ref_specs(specs):
    """{path: spec entries} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax_rules._path_str(p): tuple(s) for p, s in flat}


def _strip(entries):
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _get(tree, path):
    for part in path:
        if isinstance(tree, dict):
            tree = tree[part]
        elif hasattr(tree, "_fields"):
            tree = getattr(tree, part)
        else:
            tree = tree[int(part)]
    return tree


def _paths(tree):
    out = []
    tree_lib.map_with_path(lambda p, x: out.append(p), tree)
    return out


def _ref_param_path(path, period):
    """The reference leaf of a port parameter path, and whether it is
    stacked (its spec then carries a layer-axis entry first)."""
    if path[0] in ("enc_blocks", "dec_blocks"):
        return "/".join((path[0],) + path[2:]), True
    if path[:2] == ("stack", "blocks"):
        return "/".join(("stack", "blocks", str(int(path[2]) % period))
                        + path[3:]), True
    return "/".join(path), False


@pytest.mark.parametrize("quant", ["none", "q8_0"])
@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_param_and_serve_specs_equal_reference_leaf_by_leaf(arch, quant):
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS)
    ref, port = _trees(arch, quant)
    period = len(ref["stack"]["blocks"]) if "stack" in ref else 1
    for shape, axes in MESHES:
        jm, tm = jax_abstract_mesh(shape, axes), abstract_mesh(shape, axes)
        for jfn, tfn in ((jax_rules.param_specs, rules.param_specs),
                         (jax_rules.serve_param_specs,
                          rules.serve_param_specs)):
            want = _ref_specs(jfn(ref, jm))
            got = tfn(port, tm)
            paths = _paths(port)
            assert len(want) <= len(paths)
            for path in paths:
                rpath, stacked = _ref_param_path(path, period)
                w = want[rpath]
                if stacked:
                    w = _strip(w[1:])
                assert tuple(_get(got, path)) == w, (shape, path)


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_batch_specs_equal_reference(arch):
    cfg = jax_config(arch)
    for shape, axes in MESHES:
        jm, tm = jax_abstract_mesh(shape, axes), abstract_mesh(shape, axes)
        for b, s in ((1, 4096), (2, 64), (32, 4096), (256, 2048)):
            shapes = {"tokens": (b, s), "labels": (b, s)}
            if cfg.family == "audio":
                shapes["mel"] = (b, 3000, cfg.n_mels)
            if cfg.family == "vlm":
                shapes["patches"] = (b, 1152, cfg.vision_embed_dim)
            want = jax_rules.batch_specs(
                {k: jax.ShapeDtypeStruct(v, np.float32)
                 for k, v in shapes.items()}, jm)
            got = rules.batch_specs({k: _meta(v) for k, v in shapes.items()},
                                    tm)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (shape, b, s)


def test_spec_for_path_guards_and_strips():
    mesh = abstract_mesh((4, 4), ("data", "model"))
    # the duplicate-axis guard: the first dim wins the model axis
    assert rules._spec_from_template(((rules.MODEL,), (rules.MODEL,)),
                                     (8, 8), mesh) == rules.P("model")
    # trailing Nones stripped; a qs leg keeps the dense rule aligned
    assert rules.spec_for_path("attn/q/w/qs", (8, 1, 32), mesh) == \
        rules.P("model")
    assert rules.spec_for_path("attn/o/w/scales", (8, 8), mesh) == \
        rules.P("data", "model")
    assert rules.spec_for_path("norm1/scale", (8,), mesh) == rules.P()
    for s, a in ((("data", "model"), (2, 2)), (("pod", "data"), (2, 3))):
        jm, tm = jax_abstract_mesh(a, s), abstract_mesh(a, s)
        for path, shape in (("moe/w_up", (8, 6, 4)), ("x/y", (6,)),
                            ("lm_head/w/qs", (6, 2, 32)), ("x/z", (6, 4))):
            assert tuple(rules.spec_for_path(path, shape, tm)) == \
                tuple(jax_rules.spec_for_path(path, shape, jm))


# ---------------------------------------------------------------------------
# the state specs, in meaning, on the smoke states
# ---------------------------------------------------------------------------
_SMOKE = {}


def _smoke(arch):
    """(reference cfg, reference params, port cfg, port params): the
    smoke config's seeded weights, crossed over by ``convert``."""
    if arch not in _SMOKE:
        jcfg = jax_smoke_config(arch)
        jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg,
                                   64 if jcfg.family == "audio" else 0)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        _SMOKE[arch] = (jcfg, jp, get_smoke_config(arch), tp)
    return _SMOKE[arch]


def _ref_state_path(path, period):
    """The reference leaf of a port decode-state path: a whisper layer
    list's index dropped, an LM layer's index to its pattern position."""
    p = list(path)
    if p[0] == "layer_states":
        if p[1] in ("self_kv", "cross_kv"):
            del p[2]
        elif p[1].isdigit():
            p[1] = str(int(p[1]) % period)
    return "/".join(p)


def _state_pairs(jstate, tstate):
    period = (len(jstate.layer_states)
              if isinstance(jstate.layer_states, list) else 1)
    return [(path, _ref_state_path(path, period),
             path[0] == "layer_states") for path in _paths(tstate)]


STATE_ARCHS = ["whisper-tiny", "qwen2.5-14b", "mamba2-780m",
               "jamba-v0.1-52b"]


@pytest.mark.parametrize("n_slots", [4, 3, 8])
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_slot_state_specs_shard_the_same_leaves(arch, n_slots):
    """Both shard the same leaves over "data", along their slot axis (the
    reference's axis 1 of a stacked layer leaf, the port's axis 0): 3
    slots on 4 stay replicated."""
    jcfg, jp, tcfg, _ = _smoke(arch)
    f = 8 if jcfg.family == "audio" else None
    jst = JaxSlotKVPool(jcfg, jp, n_slots, 16, n_frames=f).state
    tst = model.zeros_slot_state(tcfg, n_slots, f, 16, device="cpu")
    for shape, axes in MESHES[2:] + [((2, 1), ("data", "model"))]:
        want = _ref_specs(jax_model.slot_state_specs(
            jst, jax_abstract_mesh(shape, axes)))
        got = model.slot_state_specs(tst, abstract_mesh(shape, axes))
        sharded = 0
        for path, rpath, layer in _state_pairs(jst, tst):
            w = want[rpath]
            w = _strip(w[1:]) if layer else w
            assert tuple(_get(got, path)) == w, (shape, path)
            sharded += w == ("data",)
        data = dict(zip(axes, shape))["data"]
        assert bool(sharded) == (data > 1 and n_slots % data == 0)


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_cache_specs_equal_reference_without_the_layer_axis(arch):
    jcfg, jp, tcfg, tp = _smoke(arch)
    kv = dict(kv_heads=jcfg.num_kv_heads, head_dim=jcfg.head_dim)
    for b in (1, 4):
        if jcfg.family == "audio":
            mem = np.zeros((b, 8, jcfg.d_model), np.float32)
            jst = jax_model.init_serve_state(jp, jcfg, b, 16, memory=mem)
            tst = model.zeros_serve_state(tcfg, b, 8, 16, device="cpu")
        else:
            jst = jax_model.init_serve_state(jp, jcfg, b, 16)
            tst = model.zeros_serve_state(tcfg, b, 0, 16, device="cpu")
        for shape, axes in MESHES[2:] + [((1, 4), ("data", "model"))]:
            want = _ref_specs(jax_rules.cache_specs(
                jst, jax_abstract_mesh(shape, axes), **kv))
            got = rules.cache_specs(tst, abstract_mesh(shape, axes), **kv)
            for path, rpath, layer in _state_pairs(jst, tst):
                w = want[rpath]
                w = _strip(w[1:]) if layer else w
                assert tuple(_get(got, path)) == w, (b, shape, path)


@pytest.mark.parametrize("n_slots", [4, 3])
def test_paged_state_specs_equal_reference(n_slots):
    jcfg, jp, tcfg, _ = _smoke("whisper-tiny")
    geom = dict(page_size=4, n_pages=1 + 3 * n_slots)
    jst = JaxPagedKVPool(jcfg, jp, n_slots, 12, n_frames=8, **geom).state
    tst = PagedKVPool(tcfg, n_slots, 12, n_frames=8, device="cpu",
                      **geom).state
    for shape, axes in MESHES[2:] + [((1, 1), ("data", "model"))]:
        want = _ref_specs(jax_rules.paged_state_specs(
            jst, jax_abstract_mesh(shape, axes)))
        got = rules.paged_state_specs(tst, abstract_mesh(shape, axes))
        for path in _paths(tst):
            assert tuple(_get(got, path)) == want["/".join(path)], path


# ---------------------------------------------------------------------------
# ctx, meshes, keys and the ledger's split
# ---------------------------------------------------------------------------
TOKENS = ["batch", "seq", "model_force", "data", "model", "pod", None,
          "bogus"]
DIMS = [1, 2, 3, 4, 6, 8, 16, 32, 48, 51865]


@pytest.mark.parametrize("shape,axes", MESHES + [((1, 1),
                                                  ("data", "model"))],
                         ids=MESH_IDS + ["1x1"])
def test_ctx_resolve_equals_reference(shape, axes):
    jm, tm = jax_abstract_mesh(shape, axes), abstract_mesh(shape, axes)
    for tok in TOKENS:
        for d in DIMS:
            assert ctx._resolve(tok, d, tm) == jax_ctx._resolve(tok, d, jm), \
                (tok, d)
    assert ctx.batch_shard_size(tm) == jax_ctx.batch_shard_size(jm)


def test_constrain_checks_rank_and_returns_x():
    x = torch.zeros(8, 3)
    assert ctx.constrain(x, "batch") is x           # no mesh: no check
    mesh = abstract_mesh((4, 1), ("data", "model"))
    with ctx.activation_sharding(mesh):
        assert ctx.current_mesh() is mesh
        assert ctx.constrain(x, "batch", None) is x
        assert ctx.resolve_spec(x.shape, "batch", None) == ("data", None)
        assert ctx.resolve_spec((3, 3), "batch", None) is None
        with pytest.raises(ValueError, match="2 tokens"):
            ctx.constrain(torch.zeros(2, 3, 4), "batch", None)
    assert ctx.current_mesh() is None
    assert ctx.batch_shards() == 1
    with ctx.shard_program(4):
        assert ctx.batch_shards() == 4
    assert ctx.batch_shards() == 1


def test_meshes_mirror_the_references():
    prod = make_production_mesh()
    assert prod.axis_names == ("data", "model") and prod.size == 256
    multi = make_production_mesh(multi_pod=True)
    assert rules.mesh_signature(multi) == (("pod", 2), ("data", 16),
                                           ("model", 16))
    m = _cpu_mesh(4)
    assert m.shape == {"data": 4, "model": 1}
    assert m.axis_devices("data") == [CPU] * 4
    assert m.physical_devices == [CPU]
    assert make_smoke_mesh([CPU] * 4).shape == {"data": 2, "model": 2}
    assert make_smoke_mesh([CPU] * 8).shape == {"data": 2, "model": 4}
    assert make_smoke_mesh([CPU]).shape == {"data": 1, "model": 1}
    assert make_serve_mesh(devices=[CPU] * 4, model=2).shape == \
        {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="does not divide"):
        make_serve_mesh(model=3, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_serve_mesh(data=4, model=2, devices=[CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_serve_mesh()


def test_mesh_signatures_and_plan_keys_are_the_references():
    for shape, axes in MESHES:
        jm, tm = jax_abstract_mesh(shape, axes), abstract_mesh(shape, axes)
        sig = rules.mesh_signature(tm)
        assert sig == jax_rules.mesh_signature(jm)
        for args, kw in ((("step", "q8_0", 4, 16), {}),
                         (("prefill", "none", 1, 1500), {}),
                         (("step", "q8_0", 12, 1500),
                          {"pages": (4, 49, 1500, 13)}),
                         (("verify", "q8_0", 4, 1500),
                          {"pages": (4, 9, 1500, 3), "role": "verify",
                           "k": 4}),
                         (("step", "none", 4, 1500), {"role": "draft"})):
            want = jax_plan_key(*args, mesh=jm, **kw)
            assert plan_key(*args, mesh=tm, **kw) == want
            assert plan_key(*args, mesh=sig, **kw) == want
            assert plan_key(*args, mesh=None, **kw) == \
                jax_plan_key(*args, **kw) == plan_key(*args, **kw)
    assert rules.mesh_signature(None) is None


def test_by_device_splits_as_the_reference_remainders_included():
    sigs = [None, (("data", 4), ("model", 1)), (("data", 2), ("model", 2)),
            (("pod", 2), ("data", 3), ("model", 1))]
    led, jled = OffloadLedger(), JaxLedger()
    shapes = [(3, 5, 7), (1, 384, 51865), (4, 1536, 384), (13, 33, 1)]
    for i, ((m, k, n), sig) in enumerate(
            [(s, g) for s in shapes for g in sigs]):
        off = i % 3 != 0
        common = dict(name=f"l{i}", m=m, k=k, n=n, dtype="q8_0",
                      offload=off, burst=256, tuned=False,
                      kernel="q8_matvec", tiling=None,
                      k_main=k - k % 32, k_res=k % 32, mesh=sig)
        led.account(PlanEntry(backend="hopper", **common), times=i + 1)
        jled.account(JaxPlanEntry(backend="xla_ref", **common), times=i + 1)
    s = led.totals
    assert s.by_device == jled.totals.by_device
    assert sum(s.by_device.values()) == \
        s.offloaded_flops + s.fallback_flops + s.residual_flops
    assert set(s.by_device) == {f"dev{i}" for i in range(6)}


@pytest.mark.parametrize("n_slots,data", [(8, 4), (6, 2), (4, 4), (6, 4)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_aware_pick_order_equals_reference(n_slots, data, seed):
    tcfg = _smoke("whisper-tiny")[2]
    pool = SlotKVPool(tcfg, n_slots, 4, n_frames=2, device="cpu",
                      mesh=_cpu_mesh(data))
    ref = object.__new__(JaxSlotKVPool)
    ref.n_slots = n_slots
    ref.n_shards = data if n_slots % data == 0 else 1
    ref.shard_size = n_slots // ref.n_shards
    ref._init_free()
    assert (pool.n_shards, pool.shard_size) == (ref.n_shards,
                                                ref.shard_size)
    rng = np.random.default_rng(seed)
    held = []
    for _ in range(40):
        if held and (not pool.n_free or rng.random() < 0.4):
            slot = held.pop(int(rng.integers(len(held))))
            pool.release(slot, reset=False)
            ref.release(slot, reset=False)
        else:
            got, want = pool.acquire(), ref.acquire()
            assert got == want
            assert pool.slot_shard(got) == ref.slot_shard(want)
            held.append(got)
        assert pool.n_free == ref.n_free


# ---------------------------------------------------------------------------
# the reference's sharded gate, in process, and the other schedulers
# ---------------------------------------------------------------------------
F = 16


def _gate_trace(cfg):
    """``tests/test_sharded_serve.py``'s trace: 6 mels of 16 frames, then
    max_new in 3-9, from default_rng(0)."""
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((1, F, cfg.n_mels)).astype(np.float32)
            for _ in range(6)]
    return mels, [int(rng.integers(3, 10)) for _ in range(6)]


_REF = {}


def _ref_tokens(quant="q8_0"):
    """The reference's unsharded slot scheduler's tokens on the gate's
    trace (cached). Its paged scheduler and speculative waves give these
    tokens too (its own parity gates): greedy decode per request."""
    if quant not in _REF:
        jcfg, jp, _, _ = _smoke("whisper-tiny")
        mels, budgets = _gate_trace(jcfg)
        jeng = JaxServeEngine(jcfg, jp, max_len=24, quant=quant, eos_id=-1,
                              offload=JaxOffloadEngine(interpret=True,
                                                       prefer_pallas=False))
        sched = JaxScheduler(jeng, n_slots=4, n_frames=F)
        _REF[quant] = _drain(sched, mels, budgets)
    return _REF[quant]


def _draft():
    """whisper-tiny smoke drafting, its weights from seed 1."""
    if "draft" not in _SMOKE:
        jcfg = jax_smoke_config("whisper-tiny")
        jp = jax_model.init_params(jax.random.PRNGKey(1), jcfg, 64)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        _SMOKE["draft"] = (jcfg, jp, get_smoke_config("whisper-tiny"), tp)
    return _SMOKE["draft"]


def _engine(mesh, quant="q8_0", telemetry=None, arch="whisper-tiny",
            max_len=24):
    _, _, tcfg, tp = _smoke(arch)
    return ServeEngine(tcfg, tp, max_len=max_len, quant=quant, eos_id=-1,
                       offload=OffloadEngine(), device="cpu", mesh=mesh,
                       telemetry=telemetry)


def _drain(sched, mels, budgets):
    rids = [sched.submit(m, max_new=n) for m, n in zip(mels, budgets)]
    got = sched.run()
    return [got[r].tokens for r in rids]


def _totals(eng):
    s = eng.offload.stats
    return (s.offloaded_calls, s.fallback_calls, s.offloaded_flops,
            s.fallback_flops, s.residual_flops)


@pytest.mark.parametrize("data", [4, 2])
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_sharded_gate_matches_reference(quant, data):
    tcfg = _smoke("whisper-tiny")[2]
    mels, budgets = _gate_trace(tcfg)
    want = _ref_tokens(quant)
    one = _engine(None, quant)
    assert _drain(one.scheduler(4, F), mels, budgets) == want
    eng = _engine(_cpu_mesh(data), quant)
    sched = eng.scheduler(4, F)
    assert _drain(sched, mels, budgets) == want
    # one step build for the whole schedule, however many shards ran it
    assert eng._step_builds == one._step_builds == 1
    assert sched.pool.n_shards == data and sched.pool.shard_size == 4 // data
    assert not set(one._plans.plans) & set(eng._plans.plans)
    sig = (("data", data), ("model", 1))
    assert all(k[-1] == ("mesh", sig) or ("mesh", sig) in k
               for k in eng._plans.plans)
    assert all(e.mesh == sig for p in eng._plans.plans.values() for e in p)
    by_dev = eng.energy_report([], 700.0)["dispatch"]["by_device"]
    st = eng.offload.stats
    assert sum(by_dev.values()) == \
        st.offloaded_flops + st.fallback_flops + st.residual_flops
    assert set(by_dev) == {f"dev{i}" for i in range(data)}
    # the step's plan committed once a step: the unsharded run's totals
    assert _totals(eng) == _totals(one)
    assert eng.offload.ledger.commits == one.offload.ledger.commits
    # every entry of the sharded step is the whole step's (M = 4 rows)
    step = eng._plans.plans[sched._step_key]
    assert {e.m for e in step} == {4}
    assert [(e.name, e.kernel, e.burst, e.k_main, e.offload) for e in step] \
        == [(e.name, e.kernel, e.burst, e.k_main, e.offload)
            for e in one._plans.plans[one.scheduler()._step_key]]


def test_distinct_devices_pool_keeps_the_tokens():
    """Four logical CPU devices of distinct index stand for four cards:
    one pool tensor a device, each shard's rows and token buffer there."""
    tcfg = _smoke("whisper-tiny")[2]
    mels, budgets = _gate_trace(tcfg)
    mesh = make_serve_mesh(devices=[torch.device("cpu", i)
                                    for i in range(4)])
    eng = _engine(mesh)
    sched = eng.scheduler(4, F)
    assert len(sched.pool.states) == 4 and len(sched._tokens) == 4
    assert [sched.pool.locate(s) for s in range(4)] == \
        [(torch.device("cpu", s), 0) for s in range(4)]
    assert _drain(sched, mels, budgets) == _ref_tokens()


@pytest.mark.parametrize("data", [4, 2])
def test_sharded_paged_scheduler_matches_reference(data):
    tcfg = _smoke("whisper-tiny")[2]
    mels, budgets = _gate_trace(tcfg)
    want = _ref_tokens()
    one = _engine(None)
    assert _drain(one.paged_scheduler(4, F, page_size=4), mels,
                  budgets) == want
    eng = _engine(_cpu_mesh(data))
    # an arena whose pages divide: every self page from its slot's shard
    sched = eng.paged_scheduler(4, F, page_size=4, n_pages=1 + 4 * 6 + 3)
    pool = sched.pool
    assert pool.n_shards == data and pool.self_alloc.n_shards == data
    owned = []
    real_alloc = pool.alloc_self_page

    def alloc(slot):
        page = real_alloc(slot)
        owned.append((pool.slot_shard(slot), pool.self_alloc.page_shard(page)))
        return page

    pool.alloc_self_page = alloc
    rids = [sched.submit(m, max_new=n) for m, n in zip(mels, budgets)]
    steps = 0
    while sched.n_queued or sched.n_active:
        sched.admit()
        steps += bool(sched.decode_step())
    got = sched.run()
    assert [got[r].tokens for r in rids] == want
    assert owned and all(a == b for a, b in owned)
    assert eng._step_builds == 1
    # commits = prefills + steps + replays: the step's plan once a step
    assert eng.offload.ledger.commits == \
        sched.prefills + steps + sched.replays


@pytest.mark.parametrize("mode", ["wave", "continuous", "paged"])
def test_sharded_speculative_matches_reference(mode):
    """The verifier's greedy tokens: the gate's first three requests, each
    cut to 5 tokens. As the reference's, ``SpecScheduler``'s waves serve
    on a mesh (the one-shot engine splits each wave's 4 rows over the two
    data shards) and the round schedulers refuse one."""
    tcfg = _smoke("whisper-tiny")[2]
    mels, budgets = _gate_trace(tcfg)
    mels, budgets = mels[:3], [min(n, 5) for n in budgets[:3]]
    want = [t[:n] for t, n in zip(_ref_tokens()[:3], budgets)]
    _, _, tdcfg, tdp = _draft()
    for mesh in (None, _cpu_mesh(2)):
        spec = _engine(mesh).speculative(tdcfg, tdp, k=3)
        if mode == "wave":
            sched = SpecScheduler(spec, n_slots=4)
        elif mesh is not None:
            with pytest.raises(NotImplementedError, match="single-device"):
                (spec.continuous(4, F) if mode == "continuous"
                 else spec.paged(4, F, page_size=4))
            continue
        elif mode == "continuous":
            sched = spec.continuous(4, F)
        else:
            sched = spec.paged(4, F, page_size=4)
        assert _drain(sched, mels, budgets) == want
        if mesh is not None:
            v = spec.verifier
            assert spec.draft.mesh is mesh
            assert [p[:2] for p in spec._parts(4, F)] == [(0, 2), (2, 2)]
            # the draft step built once for both shards (on the CPU the
            # engine counts step builds only)
            assert spec.draft._step_builds == 1 and v._verify_builds <= 1
            # the window's plan is the wave's: M = 4 rows x (k + 1)
            vkey = v._key("verify", 4, F, role="verify", k=3)
            assert {e.m for e in v._plans.plans[vkey]} == {16}
            by_dev = v.offload.stats.by_device
            assert set(by_dev) == {"dev0", "dev1"}
            assert sum(by_dev.values()) == sum(v.offload.stats.by_role.values())


def test_one_shot_transcribe_splits_over_the_data_shards():
    jcfg, jp, tcfg, _ = _smoke("whisper-tiny")
    mels, _ = _gate_trace(tcfg)
    batch = np.concatenate(mels[:4])
    jeng = JaxServeEngine(jcfg, jp, max_len=24, quant="q8_0", eos_id=-1)
    want = [r.tokens for r in jeng.transcribe(batch, max_new=5)]
    eng = _engine(_cpu_mesh(2))
    got = eng.transcribe(batch, max_new=5)
    assert [r.tokens for r in got] == want
    # split: each shard's rows on its own buffers, the plan the batch's
    assert eng._shard_rows(4) == [(0, CPU, 0, 2), (1, CPU, 2, 2)]
    key = eng._key("step", 4, F)
    assert key[-1] == ("mesh", (("data", 2), ("model", 1)))
    assert {e.m for e in eng._plans.plans[key]} == {4}
    # batch 3 does not divide: one run on the first device, mesh-keyed
    assert eng._shard_rows(3) == [(None, CPU, 0, 3)]
    assert [r.tokens for r in eng.transcribe(batch[:3], max_new=5)] == \
        want[:3]


def test_sharded_plans_name_the_kernel_each_shard_launches(monkeypatch):
    """32 slots at data 2, and a one-shot batch of 32 split over data 2,
    with a tuner attached: a step has 32 rows (``q8_matmul``'s range) and
    each shard launches 16 (``q8_matvec``'s). Every plan entry keeps the
    step's M and names the kernel its shard launched, with the tuner's
    tile for that kernel, launch by launch; the tokens are the unsharded
    engine's."""
    from repro_torch.backends import hopper
    from repro_torch.tuning import Autotuner
    ran = []
    for name in ("q8_matvec", "q8_matmul"):
        def rec(x, qs, scales, tile=None, _name=name,
                _real=getattr(hopper, name)):
            ran.append((_name, x.shape[0], tile))
            return _real(x, qs, scales, tile=tile)
        monkeypatch.setattr(hopper, name, rec)
    _, _, tcfg, tp = _smoke("whisper-tiny")
    rng = np.random.default_rng(3)
    mels = [rng.standard_normal((1, F, tcfg.n_mels)).astype(np.float32)
            for _ in range(32)]
    out = []
    for mesh in (None, _cpu_mesh(2)):
        eng = ServeEngine(tcfg, tp, max_len=8, quant="q8_0", eos_id=-1,
                          offload=OffloadEngine(tuner=Autotuner(
                              device="cpu", mode="analytic")),
                          device="cpu", mesh=mesh)
        n = 1 if mesh is None else 2
        sched = eng.scheduler(32, F)
        rids = [sched.submit(m, max_new=3) for m in mels]
        sched.admit()
        ran.clear()
        sched.decode_step()
        step = eng._plans.plans[sched._step_key]
        assert {e.m for e in step} == {32}
        want = [(e.kernel, 32 // n, e.tiling) for e in step
                if e.backend == "hopper"]
        assert ran == want * n
        assert {e.kernel for e in step} == \
            {"q8_matmul" if mesh is None else "q8_matvec"}
        got = sched.run()
        ran.clear()
        res = eng.transcribe(np.concatenate(mels), max_new=3)
        pre = eng._plans.plans[eng._key("prefill", 32, F)]
        step = eng._plans.plans[eng._key("step", 32, F)]
        # every shard's prefill, then each shard's 3 steps (the dense
        # frontend's linear runs bf16_matmul, not spied on)
        want = [(e.kernel, e.m // n, e.tiling) for e in pre
                if e.backend == "hopper" and e.dtype == "q8_0"] * n
        want += [(e.kernel, e.m // n, e.tiling) for e in step
                 if e.backend == "hopper"] * 3 * n
        assert ran == want
        out.append(([got[r].tokens for r in rids], [r.tokens for r in res]))
    assert out[0] == out[1]


def test_served_programs_resolve_constrain_on_the_mesh(monkeypatch):
    """A sharded engine runs its programs' Python with its mesh active,
    so every linear's ``ctx.constrain`` resolves its tokens on that mesh
    and checks their rank; an unsharded engine resolves nothing."""
    seen = []
    real = ctx.resolve_spec

    def spy(shape, *tokens, mesh=None):
        seen.append((ctx.current_mesh(), len(shape), tokens))
        return real(shape, *tokens, mesh=mesh)

    monkeypatch.setattr(ctx, "resolve_spec", spy)
    tcfg = _smoke("whisper-tiny")[2]
    mels, budgets = _gate_trace(tcfg)
    _drain(_engine(None).scheduler(4, F), mels[:2], budgets[:2])
    assert seen == []
    mesh = _cpu_mesh(2)
    eng = _engine(mesh)
    _drain(eng.scheduler(4, F), mels[:2], budgets[:2])
    eng.transcribe(np.concatenate(mels[:4]), max_new=2)
    assert seen and all(m is mesh and r == len(t) and t[0] == "batch"
                        for m, r, t in seen)
    assert ctx.current_mesh() is None
    # a token list of the wrong rank raises inside a served program
    monkeypatch.setattr(ctx, "resolve_spec", real)
    real_constrain = ctx.constrain
    monkeypatch.setattr(ctx, "constrain",
                        lambda x, *tokens: real_constrain(x, *tokens, None))
    with pytest.raises(ValueError, match="tokens for rank"):
        eng.transcribe(np.concatenate(mels[:4]), max_new=2)


@pytest.mark.parametrize("n_slots,data", [(4, 2), (6, 4), (8, 4)])
def test_pools_lay_out_as_their_spec_trees(monkeypatch, n_slots, data):
    """The slot pool's shards are ``model.slot_state_specs``'s split and
    the paged pool's ``rules.paged_state_specs``'s (slots, self and cross
    page ranges): the tested specs lay the pools out. Specs that shard
    nothing leave one shard."""
    from repro_torch.serve import kvcache, paging
    tcfg = _smoke("whisper-tiny")[2]
    mesh = _cpu_mesh(data)
    split = data if n_slots % data == 0 else 1
    pool = SlotKVPool(tcfg, n_slots, 4, n_frames=F, device="cpu", mesh=mesh)
    assert (pool.n_shards, pool.shard_size) == (split, n_slots // split)
    n_pages = 2 * data + 1
    paged = PagedKVPool(tcfg, n_slots, 8, n_frames=F, page_size=4,
                        n_pages=n_pages, n_cross_pages=4 * data,
                        device="cpu", mesh=mesh)
    assert paged.n_shards == split
    assert paged.self_alloc.n_shards == 1          # 2 data + 1 pages
    assert paged.cross_alloc.n_shards == data
    monkeypatch.setattr(kvcache.model_lib, "slot_state_specs",
                        lambda state, mesh: tree_lib.map_with_path(
                            lambda _, t: rules.P(), state))
    monkeypatch.setattr(paging, "paged_state_specs",
                        lambda state, mesh: tree_lib.map_with_path(
                            lambda _, t: rules.P(), state))
    assert SlotKVPool(tcfg, n_slots, 4, n_frames=F, device="cpu",
                      mesh=mesh).n_shards == 1
    again = PagedKVPool(tcfg, n_slots, 8, n_frames=F, page_size=4,
                        n_pages=n_pages, n_cross_pages=4 * data,
                        device="cpu", mesh=mesh)
    assert (again.n_shards, again.cross_alloc.n_shards) == (1, 1)


def _lm_trace(cfg, n=5, seed=0):
    """n prompts of 3 tokens (one prefill shape), max_new in 2-6."""
    rng = np.random.default_rng(seed)
    budgets = rng.integers(2, 7, n).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, (3,)).astype(np.int32)
               for _ in range(n)]
    return prompts, budgets


def _no_drops(cfg):
    """A MoE config whose capacity holds every choice of a 4-row step
    (C = 4 of E = 4, top-2), so that nothing is dropped."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=2.0))


LM_FAMILIES = [("qwen2.5-14b", "q8_0"), ("olmoe-1b-7b", "none"),
               ("mamba2-780m", "q8_0"), ("jamba-v0.1-52b", "none"),
               ("llava-next-mistral-7b", "q8_0")]


@pytest.mark.parametrize("arch,quant", LM_FAMILIES,
                         ids=[a for a, _ in LM_FAMILIES])
def test_every_lm_family_shards_to_the_references_tokens(arch, quant):
    """Tokens equal the reference's unsharded scheduler's where nothing is
    dropped: the MoE smoke configs' capacity raised to hold a step."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    jcfg, tcfg = _no_drops(jcfg), _no_drops(tcfg)
    prompts, budgets = _lm_trace(tcfg)
    jeng = JaxServeEngine(jcfg, jp, max_len=32, quant=quant,
                          offload=JaxOffloadEngine(prefer_pallas=False))
    want = _drain(JaxScheduler(jeng, n_slots=4), prompts, budgets)
    eng = ServeEngine(tcfg, tp, max_len=32, quant=quant,
                      offload=OffloadEngine(), device="cpu",
                      mesh=_cpu_mesh(2))
    sched = eng.scheduler(4)
    assert _drain(sched, prompts, budgets) == want
    assert sched.pool.n_shards == 2 and eng._step_builds == 1
    by_dev = eng.offload.stats.by_device
    assert set(by_dev) == {"dev0", "dev1"}


@pytest.mark.parametrize("case", ["drops", "no-drops"])
def test_moe_drop_case_claims_per_shard(case):
    """arctic's smoke config drops (C = 2 of 4 rows' top-2 choices at
    the 4-slot step). Sharded at data = 2, the step's one group spans the
    shards, so the step runs as one program over the whole pool, whose
    claim is the whole step's: its tokens equal the reference's unsharded
    scheduler's, and one slot step is built and run a step. Where no
    group can drop (capacity factor 2), each shard claims among its own
    rows as before, one program a shard, to the unsharded scheduler's
    tokens (the reference's: ``test_every_lm_family_shards_...``). Over
    distinct devices the drop case is refused (ROADMAP item 14b)."""
    arch = "arctic-480b"
    jcfg, jp, tcfg, tp = _smoke(arch)
    prompts, budgets = _lm_trace(tcfg)
    if case == "drops":
        jeng = JaxServeEngine(jcfg, jp, max_len=32, quant="none",
                              offload=JaxOffloadEngine(prefer_pallas=False))
        ref = _drain(JaxScheduler(jeng, n_slots=4), prompts, budgets)
    else:   # the unsharded scheduler's, which the reference's equals
        tcfg = _no_drops(tcfg)
        ref = _drain(ServeEngine(tcfg, tp, max_len=32, quant="none",
                                 device="cpu").scheduler(4),
                     prompts, budgets)
    eng = ServeEngine(tcfg, tp, max_len=32, quant="none",
                      offload=OffloadEngine(), device="cpu",
                      mesh=_cpu_mesh(2))
    sched = eng.scheduler(4)
    assert sched._joint == (case == "drops")
    assert _drain(sched, prompts, budgets) == ref
    assert eng._step_builds == 1
    from repro_torch.models import moe
    p = tp["stack"]["blocks"][0]["moe"]
    x = torch.zeros((2, 1, tcfg.d_model))
    cap = 2 if case == "drops" else 4
    # the capacity a shard computes is the whole step's
    assert moe.route(p, tcfg, torch.zeros((4, 1, tcfg.d_model)))[0].cap \
        == cap
    with ctx.shard_program(2):
        if case == "drops":
            with pytest.raises(RuntimeError, match="lockstep"):
                moe.route(p, tcfg, x)
        else:
            assert moe.route(p, tcfg, x)[0].cap == cap
    if case == "drops":
        with pytest.raises(NotImplementedError, match="14b"):
            ServeEngine(tcfg, tp, max_len=32, quant="none", device="cpu",
                        mesh=make_serve_mesh(devices=[
                            torch.device("cpu", i) for i in range(2)])
                        ).scheduler(4)


_RAGGED_SCRIPT = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from repro.configs.registry import get_smoke_config
from repro.core.offload import OffloadEngine
from repro.launch.mesh import make_serve_mesh
from repro.models import model as model_lib
from repro.serve.engine import ServeEngine
from repro.serve.scheduler import ContinuousBatchingScheduler

cfg = get_smoke_config("arctic-480b")
params = model_lib.init_params(jax.random.PRNGKey(0), cfg, 0)
prompts, budgets = json.loads(os.environ["RAGGED_TRACE"])
eng = ServeEngine(cfg, params, max_len=32, quant="none",
                  offload=OffloadEngine(prefer_pallas=False),
                  mesh=make_serve_mesh(2))
sched = ContinuousBatchingScheduler(eng, n_slots=4)
rids = [sched.submit(np.asarray(p, np.int32), max_new=n)
        for p, n in zip(prompts, budgets)]
got = sched.run()
print(json.dumps([[int(t) for t in got[r].tokens] for r in rids]))
"""


def test_moe_drop_case_over_ragged_arrivals_is_the_reference_sharded():
    """arctic's drop case over ragged prompts (3 or 5 tokens) and budgets:
    a sharded pool picks slots across its shards (the reference's pick
    order), so the step's rows come in another order than the unsharded
    pool's, and the step's claim, k-major then in row order, drops other
    pairs. The port's sharded scheduler equals the reference's sharded
    one (two forced host devices, in a subprocess) and parts from the
    unsharded one, as the reference's does (its unsharded scheduler is
    the port's: ``test_every_lm_family_shards_...``)."""
    import json
    import os
    import subprocess
    import sys
    _, _, tcfg, tp = _smoke("arctic-480b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, int(rng.choice((3, 5))))
               .astype(np.int32) for _ in range(5)]
    budgets = [int(rng.integers(2, 6)) for _ in range(5)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", RAGGED_TRACE=json.dumps(
        [[p.tolist() for p in prompts], budgets]))
    run = subprocess.run([sys.executable, "-c", _RAGGED_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    one = _drain(ServeEngine(tcfg, tp, max_len=32, quant="none",
                             device="cpu").scheduler(4), prompts, budgets)
    eng = ServeEngine(tcfg, tp, max_len=32, quant="none",
                      offload=OffloadEngine(), device="cpu",
                      mesh=_cpu_mesh(2))
    sched = eng.scheduler(4)
    assert sched._joint
    assert _drain(sched, prompts, budgets) == ref
    assert one != ref


# ---------------------------------------------------------------------------
# refusals, telemetry and the CLI
# ---------------------------------------------------------------------------
def test_refusals_name_item_14b():
    """What is still refused: a paged pool whose data shards lie on
    distinct devices, and an abstract mesh. Over model > 1 the paged pool
    and speculative serving build (``tests/test_torch_serve_tp_paged.py``
    holds their tokens), while the speculative round schedulers refuse
    any mesh, as the reference's do."""
    _, _, tcfg, tp = _smoke("whisper-tiny")
    mesh = make_serve_mesh(devices=[torch.device("cpu", i)
                                    for i in range(4)])
    eng = _engine(mesh)
    with pytest.raises(NotImplementedError, match="14b"):
        eng.paged_scheduler(4, F, page_size=4)
    with pytest.raises(ValueError, match="abstract"):
        ServeEngine(tcfg, tp, device="cpu",
                    mesh=abstract_mesh((2, 1), ("data", "model")))
    tp_eng = ServeEngine(tcfg, tp, device="cpu", mesh=_cpu_mesh(1, 2))
    sched = tp_eng.paged_scheduler(4, F, page_size=4)
    assert isinstance(sched.pool.state.layer_states, ModelShards)
    spec = tp_eng.speculative(tcfg, tp, k=2)
    assert spec.draft.mesh is tp_eng.mesh
    for make in (lambda: spec.continuous(2, F),
                 lambda: spec.paged(2, F, page_size=4)):
        with pytest.raises(NotImplementedError, match="single-device"):
            make()


def test_cli_refuses_speculative_on_a_mesh(capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "whisper-tiny", "--device", "cpu",
                        "--power-w", "700", "--mesh", "--speculative"])
    assert "sharded mesh" in capsys.readouterr().err


def test_telemetry_device_series_equal_by_device():
    tcfg = _smoke("whisper-tiny")[2]
    mels, budgets = _gate_trace(tcfg)
    tele = obs.Telemetry()
    eng = _engine(_cpu_mesh(4), telemetry=tele)
    try:
        sched = eng.scheduler(4, F)
        _drain(sched, mels, budgets)
        tele.sync_ledger_metrics()
        c = tele.metrics.counter("repro_ledger_flops_total")
        by_dev = eng.offload.stats.by_device
        assert len(by_dev) == 4
        for dev, v in by_dev.items():
            assert c.value(device=dev) == v
        assert tele.metrics.gauge("repro_step_traces").value() == 1
        assert tele.ledger_consistent()["exact"]
    finally:
        obs.activate(None)


def test_cli_serves_on_a_cpu_mesh(capsys):
    assert serve_cli.main(["--arch", "whisper-tiny", "--device", "cpu",
                           "--power-w", "700", "--mesh", "--continuous",
                           "--offload", "--requests", "2",
                           "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "serving mesh: {'data': 1, 'model': 1} over 1 device(s)" in out
    assert '"by_device"' in out
