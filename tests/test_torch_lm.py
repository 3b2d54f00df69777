"""The port's dense decoder-only LM family against the reference, on the
CPU at the smoke configs, with identical weights (the reference's
``init_params`` through ``convert.py``) and numpy-seeded prompts:

- the four dense archs' and the two MoE archs' configs: ``reduced`` field
  for field, ``n_params``/``n_active_params`` and ``enumerate_lm`` equal
  to the reference's; every reference arch in the registry, an unknown
  id raising ``KeyError``;
- ``rmsnorm``, ``apply_rope`` (lockstep and per-row positions), SwiGLU and
  a biased ``linear`` within 1e-6 of the reference's;
- ``quantize_kv``/``dequantize_kv`` bit-equal, and the Q8_0 weights
  quantized a chunk of rows at a time bit-equal; ``gc_paused`` (around
  every graph capture) holding the collector off and restoring it;
- on qwen2.5-14b and phi3-mini-3.8b smoke, Q8_0 and dense, bursts
  None/256/32: ``serve_step`` logits within 1e-5 of the largest over a
  prefill and steps; ``generate`` tokens exact at batch 1 and at batch 2
  with different prompts, its plan entries and ledger totals equal; with
  EOS on; every dense smoke arch's ``generate``; ``kv_quant="q8"``;
- the slot scheduler with LM prompts: tokens and ``TokenEvent`` order
  equal the reference scheduler's on a seeded schedule and every
  request's batch-1 ``generate``; its KV bytes; the refusals (paged pool,
  speculative serving, verify windows, a prompt past ``max_len``);
- the CLI with ``--arch qwen2.5-14b --device cpu``;
- span names and per-span FLOPs equal ``repro.obs``'s on a ``generate``
  and an LM drain.

Tokens, counts, bytes and FLOPs are exact.
"""
import collections
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core import coverage as jax_coverage
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from repro_torch import obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs import base, registry
from repro_torch.convert import _tensor, from_jax_params
from repro_torch.core import coverage
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import DispatchPlan
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, layers, model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import SlotKVPool
from repro_torch.serve.scheduler import ContinuousBatchingScheduler

DENSE = ["qwen2.5-14b", "phi3-mini-3.8b", "internlm2-20b", "qwen1.5-110b"]
MOE = ["olmoe-1b-7b", "arctic-480b"]
SERVED = ["qwen2.5-14b", "phi3-mini-3.8b"]
BURSTS = [None, 256, 32]
MAX_LEN = 32
# the reference's plain backend maps to the port's Hopper kernels; the
# host arm is the host arm
BACKEND_NAMES = {"pallas_tpu": "hopper", "xla_ref": "hopper",
                 "host_residual": "host_residual"}
PLAN_FIELDS = ("name", "m", "k", "n", "dtype", "offload", "burst", "tuned",
               "kernel", "tiling", "k_main", "k_res")


@pytest.fixture(autouse=True)
def _no_active_handle():
    obs.activate(None)
    jax_obs.activate(None)
    yield
    obs.activate(None)
    jax_obs.activate(None)


_PARAMS = {}


def _smoke(arch, **overrides):
    """(reference cfg, reference params, port cfg, port params) of the
    smoke config, the same weights, made once an arch."""
    if arch not in _PARAMS:
        jcfg = jax_smoke_config(arch)
        jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        _PARAMS[arch] = (jp, tp)
    jp, tp = _PARAMS[arch]
    return (dataclasses.replace(jax_smoke_config(arch), **overrides), jp,
            dataclasses.replace(get_smoke_config(arch), **overrides), tp)


def _pair(arch, quant="q8_0", burst=256, eos_id=None, telemetry=False,
          **overrides):
    """A reference engine and a port engine on the same weights."""
    jcfg, jp, tcfg, tp = _smoke(arch, **overrides)
    joff = (None if burst is None
            else JaxOffloadEngine(prefer_pallas=False, burst=burst))
    toff = None if burst is None else OffloadEngine(burst=burst)
    return (JaxServeEngine(jcfg, jp, max_len=MAX_LEN, quant=quant,
                           offload=joff, eos_id=eos_id,
                           telemetry=jax_obs.Telemetry() if telemetry
                           else None),
            ServeEngine(tcfg, tp, max_len=MAX_LEN, quant=quant,
                        offload=toff, eos_id=eos_id, device="cpu",
                        telemetry=obs.Telemetry() if telemetry else None))


_SHARED = {}


def _shared_pair(arch, quant="q8_0", burst=256):
    """Engines shared by the cases that only read tokens, plans and
    ledgers: the reference's programs compile once an engine."""
    key = (arch, quant, burst)
    if key not in _SHARED:
        _SHARED[key] = _pair(arch, quant, burst)
    return _SHARED[key]


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(a) -> torch.Tensor:
    return _tensor(np.asarray(a))


def _stats(offload):
    """The ledger's totals, the backends by the port's names; the
    reference's per-device split (its serving mesh) left out."""
    d = dataclasses.asdict(offload.stats)
    d.pop("by_device", None)
    d["by_backend"] = collections.Counter(
        {BACKEND_NAMES.get(k, k): v for k, v in d["by_backend"].items()})
    return d


def _entries(plan):
    return [tuple(getattr(e, f) for f in PLAN_FIELDS)
            + (BACKEND_NAMES.get(e.backend, e.backend),) for e in plan]


# ---------------------------------------------------------------------------
# Configs, the registry and the coverage arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_configs_reduced_params_and_coverage_match_reference(arch):
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch)),
                      (base.reduced(get_config(arch), num_layers=3),
                       jax_base.reduced(jax_config(arch), num_layers=3))):
        for f in dataclasses.fields(port):
            got, want = getattr(port, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(got):    # the MoE block's data
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, f.name
        assert port.attention_layers == ref.attention_layers
        assert port.moe_layers == ref.moe_layers
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()
        assert port.padded_vocab == ref.padded_vocab
        for seq, new, batch in ((0, 3, 1), (16, 0, 2), (7, 5, 4)):
            assert [dataclasses.astuple(m) for m in
                    coverage.enumerate_lm(port, seq, new, batch)] == \
                [dataclasses.astuple(m) for m in
                 jax_coverage.enumerate_lm(ref, seq, new, batch)]


def test_moe_and_ssm_data_reduce_as_the_reference_does():
    """The MoE and SSM configs: ``reduced`` cuts them as the reference
    does; models of the MoE, SSM, hybrid and VLM families are built, and
    an unknown family is refused."""
    for arch in ("olmoe-1b-7b", "arctic-480b", "mamba2-780m",
                 "jamba-v0.1-52b"):
        ref = jax_config(arch)
        moe = (None if ref.moe is None
               else base.MoEConfig(**dataclasses.asdict(ref.moe)))
        ssm = (None if ref.ssm is None
               else base.SSMConfig(**dataclasses.asdict(ref.ssm)))
        cfg = dataclasses.replace(get_config("qwen2.5-14b"), moe=moe, ssm=ssm)
        got = base.reduced(cfg, family="dense")
        want = jax_base.reduced(dataclasses.replace(
            jax_config("qwen2.5-14b"), moe=ref.moe, ssm=ref.ssm))
        assert dataclasses.asdict(got.moe or base.MoEConfig(0, 0, 0)) == \
            dataclasses.asdict(want.moe or jax_base.MoEConfig(0, 0, 0))
        assert dataclasses.asdict(got.ssm or base.SSMConfig(0)) == \
            dataclasses.asdict(want.ssm or jax_base.SSMConfig(0))
        cfg = dataclasses.replace(get_config("qwen2.5-14b"),
                                  family=ref.family, moe=moe, ssm=ssm)
        assert cfg.moe_layers == jax_base.ModelConfig(
            **{f.name: getattr(cfg, f.name)
               for f in dataclasses.fields(cfg)}).moe_layers
        assert cfg.attention_layers == (
            () if ref.family == base.SSM else tuple(range(cfg.num_layers)))
    assert dataclasses.replace(get_config("qwen2.5-14b"),
                               family=base.VLM).family == base.VLM
    with pytest.raises(ValueError, match="unknown family"):
        dataclasses.replace(get_config("qwen2.5-14b"), family="cnn")


def test_registry_serves_every_reference_arch_and_refuses_unknown_ids():
    """Every arch the reference knows is in the port's registry (llava's
    VLM the last to come), nothing is left for a later slice, and an
    unknown id raises ``KeyError``."""
    assert registry.LATER == {}
    assert set(registry.ALL_ARCHS) == set(jax_registry.ALL_ARCHS)
    for arch in jax_registry.ALL_ARCHS:
        assert get_config(arch).name == jax_config(arch).name
        assert get_smoke_config(arch).name == jax_smoke_config(arch).name
    assert get_config("llava-next-mistral-7b").family == base.VLM
    for get in (get_config, get_smoke_config):
        with pytest.raises(KeyError, match="unknown"):
            get("no-such-arch")


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------
def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("piece", ["rmsnorm", "rope_lockstep", "rope_rows",
                                   "swiglu", "biased_linear"])
def test_layers_match_reference(piece):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    if piece == "rmsnorm":
        scale = rng.standard_normal(16).astype(np.float32)
        got = layers.norm_apply({"scale": torch.from_numpy(scale)},
                                torch.from_numpy(x), "rmsnorm")
        want = jax_layers.norm_apply({"scale": jnp.asarray(scale)},
                                     jnp.asarray(x), "rmsnorm")
        _close(got, want)
        assert set(layers.init_norm(16, kind="rmsnorm")) == {"scale"}
    elif piece.startswith("rope"):
        pos = (np.array([[5, 6, 7, 8]]) if piece == "rope_lockstep" else
               np.array([[0, 1, 2, 3], [9, 10, 11, 12], [500, 501, 502, 503]]))
        for theta in (10_000.0, 1_000_000.0):
            got = layers.apply_rope(torch.from_numpy(x),
                                    torch.from_numpy(pos), theta)
            want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta)
            _close(got, want)
            _close(layers.rope_frequencies(16, theta),
                   jax_layers.rope_frequencies(16, theta))
    elif piece == "swiglu":
        p = {n: (rng.standard_normal(shape) * 0.2).astype(np.float32)
             for n, shape in (("up", (32, 16)), ("gate", (32, 16)),
                              ("down", (16, 32)))}
        got = layers.mlp_apply({n: {"w": torch.from_numpy(w)}
                                for n, w in p.items()},
                               torch.from_numpy(x), "swiglu")
        want = jax_layers.mlp_apply({n: {"w": jnp.asarray(w)}
                                     for n, w in p.items()},
                                    jnp.asarray(x), "swiglu")
        _close(got, want)
    else:
        w = rng.standard_normal((24, 16)).astype(np.float32)
        b = rng.standard_normal(24).astype(np.float32)
        for engine in (None, OffloadEngine(burst=32)):
            got = layers.linear({"w": torch.from_numpy(w),
                                 "b": torch.from_numpy(b)},
                                torch.from_numpy(x), engine)
            want = jax_layers.linear({"w": jnp.asarray(w),
                                      "b": jnp.asarray(b)}, jnp.asarray(x))
            _close(got, want)
        p = layers.init_linear(torch.Generator().manual_seed(0), 16, 24,
                               bias=True)
        assert p["w"].shape == (24, 16) and torch.equal(
            p["b"], torch.zeros(24, dtype=torch.bfloat16))


def test_quantize_kv_is_bit_equal_to_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 5, 3, 16)) * 3).astype(np.float32)
    x[0, 1, 2] = 0.0                                 # a zero head: scale 0
    q, s = attention.quantize_kv(torch.from_numpy(x))
    jq, js = jax_attention.quantize_kv(jnp.asarray(x))
    assert torch.equal(q, _t(jq)) and torch.equal(s, _t(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        assert torch.equal(attention.dequantize_kv(q, s, dt),
                           _t(jax_attention.dequantize_kv(jq, js, jdt)))


@pytest.mark.parametrize("shape", [(40, 96), (3, 13, 64), (5, 2, 7, 32)])
def test_quantize_in_row_chunks_is_bit_equal_to_reference(monkeypatch, shape):
    """Large weights (the 152,064-row readout) are quantized a chunk of
    rows at a time: with chunks of a few rows the blocks are the
    reference's, bit for bit, over any leading dims."""
    from repro.core.qformats import quantize_q8_0 as jax_quantize
    from repro_torch.core import qformats
    w = (np.random.default_rng(sum(shape)).standard_normal(shape) * 0.3
         ).astype(np.float32)
    monkeypatch.setattr(qformats, "CHUNK_VALUES", 3 * shape[-1])
    got = qformats.quantize_q8_0(torch.from_numpy(w))
    want = jax_quantize(jnp.asarray(w))
    assert torch.equal(got.qs, _t(want.qs))
    assert torch.equal(got.scales.view(torch.int32),
                       _t(want.scales).view(torch.int32))


@pytest.mark.parametrize("was_enabled", [True, False])
def test_gc_paused_holds_the_collector_off_and_restores_it(was_enabled):
    """Every graph capture runs with the cyclic collector paused (a dead
    engine's graph destroyed mid-capture invalidates the capture); the
    collector's state is restored after, also when the scope raises."""
    import gc

    from repro_torch.core.device import gc_paused
    before = gc.isenabled()
    (gc.enable if was_enabled else gc.disable)()
    try:
        with pytest.raises(KeyError):
            with gc_paused():
                assert not gc.isenabled()
                raise KeyError("inside")
        assert gc.isenabled() == was_enabled
    finally:
        (gc.enable if before else gc.disable)()


# ---------------------------------------------------------------------------
# serve_step and generate against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("burst", BURSTS)
@pytest.mark.parametrize("quant", ["q8_0", "none"])
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_logits_and_caches_match_reference(arch, quant, burst):
    """``serve_step`` five times over two prompts (the prefill, the caches
    advancing in place) against the reference's compiled prefill (its scan
    of ``serve_step``): the last logits within 1e-5 of the largest, and
    each layer's K/V and counters. Where the dense path runs the bf16
    kernel (burst 32 divides every smoke K), both operands of every linear
    round to bf16, and a sum that differs in its last f32 bit can round to
    the neighbouring bf16 value: there the tolerance is 1e-2, the bf16
    tolerance of the Whisper tests."""
    jeng, teng = _shared_pair(arch, quant, burst)
    tol = 1e-2 if (quant, burst) == ("none", 32) else 1e-5
    prompts = _prompts(teng.cfg, 2, 5)
    jl, jst = jeng._prefill_jit(jeng._serve_params, jnp.asarray(prompts))
    st = model.init_serve_state(teng._serve_params, teng.cfg, 2, MAX_LEN)
    k0 = st.layer_states[0].k
    # recorded apart, so that the shared engine's ledger stays untouched,
    # as the reference's compiled call leaves its own
    rec = (teng.offload.recording(DispatchPlan()) if teng.offload
           else contextlib.nullcontext())
    with torch.no_grad(), rec:
        for t in range(5):
            tl, st = model.serve_step(teng._serve_params, teng.cfg,
                                      torch.from_numpy(prompts[:, t:t + 1]
                                                       ).long(), st,
                                      engine=teng.offload)
    _close(tl, jl, tol)
    assert st.layer_states[0].k is k0                   # in place
    assert int(st.step) == int(jst.step) == 5
    jkv = jst.layer_states[0]
    for i, c in enumerate(st.layer_states):
        assert int(c.length) == int(jkv.length[i]) == 5
        _close(c.k, jkv.k[i], tol)
        _close(c.v, jkv.v[i], tol)


@pytest.mark.parametrize("burst", BURSTS)
@pytest.mark.parametrize("quant", ["q8_0", "none"])
@pytest.mark.parametrize("arch", SERVED)
def test_generate_matches_reference(arch, quant, burst):
    """Batch 1, then batch 2 with different prompts, on one engine pair:
    tokens and steps exact, every plan's entries and the ledger equal."""
    jeng, teng = _shared_pair(arch, quant, burst)
    prompts = _prompts(teng.cfg, 2, 5)
    for p in (prompts[:1], prompts):
        want = jeng.generate(p, max_new=6)
        got = teng.generate(p, max_new=6)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert [r.steps for r in got] == [r.steps for r in want] == \
            [6] * len(p)
    assert teng._step_captures == 0 and not teng._graphs
    if burst is None:
        return
    assert set(teng._plans.plans) == set(jeng._plans.plans) >= {
        ("prefill", quant, 1, 5), ("step", quant, 1),
        ("prefill", quant, 2, 5), ("step", quant, 2)}
    for key, jplan in jeng._plans.plans.items():
        assert _entries(teng._plans.plans[key]) == _entries(jplan), key
    assert len(teng._plans.plans[("step", quant, 1)]) == \
        7 * teng.cfg.num_layers + 1
    assert _stats(teng.offload) == _stats(jeng.offload)
    assert teng.offload.ledger.commits == jeng.offload.ledger.commits
    assert (teng._plans.hits, teng._plans.misses) == \
        (jeng._plans.hits, jeng._plans.misses)


@pytest.mark.parametrize("quant", ["q8_0", "none"])
@pytest.mark.parametrize("arch", SERVED)
def test_generate_with_eos_matches_reference(arch, quant):
    """EOS on: the token a row generates at its third step is the EOS id,
    so that row stops there (truncated, its own ``steps``) while the other
    runs on, as in the reference."""
    _, teng = _shared_pair(arch, quant)
    prompts = _prompts(teng.cfg, 2, 5, seed=2)
    eos = teng.generate(prompts, max_new=6)[0].tokens[2]
    jeng, teng = _pair(arch, quant, eos_id=eos)
    want = jeng.generate(prompts, max_new=6)
    got = teng.generate(prompts, max_new=6)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.steps for r in got] == [r.steps for r in want]
    assert got[0].tokens[-1] == eos and got[0].steps <= 3
    assert _stats(teng.offload) == _stats(jeng.offload)


@pytest.mark.parametrize("arch", DENSE)
def test_every_dense_smoke_arch_generates_the_references_tokens(arch):
    jeng, teng = _pair(arch, "q8_0", None)
    prompts = _prompts(teng.cfg, 2, 3, seed=5)
    assert [r.tokens for r in teng.generate(prompts, max_new=4)] == \
        [r.tokens for r in jeng.generate(prompts, max_new=4)]


@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_kv_quant_generate_matches_reference(quant):
    jeng, teng = _pair("qwen2.5-14b", quant, kv_quant="q8")
    st = teng._lm_static_for(1).state
    assert all(isinstance(c, attention.QKVCache) for c in st.layer_states)
    assert st.layer_states[0].k_qs.dtype == torch.int8
    prompts = _prompts(teng.cfg, 2, 5, seed=6)
    assert [r.tokens for r in teng.generate(prompts, max_new=6)] == \
        [r.tokens for r in jeng.generate(prompts, max_new=6)]


# ---------------------------------------------------------------------------
# The slot scheduler with LM prompts
# ---------------------------------------------------------------------------
def _lm_requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 7, n)
    budgets = rng.integers(2, 8, n).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, (int(s),)).astype(np.int32)
               for s in lens]
    return prompts, budgets


def _drive(sched, prompts, budgets):
    """Three requests, an admission and a step, then the rest: returns
    (tokens by submission index, the event stream)."""
    events = []
    rids = [sched.submit(p, max_new=n)
            for p, n in zip(prompts[:3], budgets[:3])]
    sched.admit()
    events += sched.decode_step()
    rids += [sched.submit(p, max_new=n)
             for p, n in zip(prompts[3:], budgets[3:])]
    res = sched.run(on_token=events.append)
    return [res[r].tokens for r in rids], \
        [(e.rid, e.token, e.step, e.done) for e in events]


@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_scheduler_matches_reference_and_batch1_generate(quant):
    jeng, teng = _shared_pair("qwen2.5-14b", quant)
    prompts, budgets = _lm_requests(teng.cfg, 6)
    got, gev = _drive(ContinuousBatchingScheduler(teng, n_slots=2),
                      prompts, budgets)
    want, wev = _drive(JaxScheduler(jeng, n_slots=2), prompts, budgets)
    assert got == want and gev == wev
    assert got == [teng.generate(p[None], max_new=n)[0].tokens
                   for p, n in zip(prompts, budgets)]


def test_scheduler_ledger_and_kv_bytes_match_reference():
    """The same drain on fresh engines: one commit an admission and a
    step, equal ledger totals, committed and peak used KV bytes, with the
    int8 cache too."""
    for kv in ("none", "q8"):
        jeng, teng = _pair("qwen2.5-14b", "q8_0", kv_quant=kv)
        prompts, budgets = _lm_requests(teng.cfg, 4, seed=1)
        out = []
        for eng, make in ((teng, ContinuousBatchingScheduler),
                          (jeng, JaxScheduler)):
            sched = make(eng, n_slots=3)
            for p, n in zip(prompts, budgets):
                sched.submit(p, max_new=n)
            steps = 0
            while sched.n_queued or sched.n_active:
                sched.admit()
                steps += bool(sched.decode_step())
            assert eng.offload.ledger.commits == 4 + steps
            out.append((sched.kv_committed_bytes, sched.kv_used_peak,
                        sched.active_peak, steps))
        assert out[0] == out[1]
        assert _stats(teng.offload) == _stats(jeng.offload)
        pool = SlotKVPool(teng.cfg, 3, MAX_LEN, device="cpu")
        assert pool.committed_kv_bytes() == out[0][0]


def test_lm_paths_the_reference_refuses_are_refused():
    jeng, teng = _shared_pair("qwen2.5-14b")
    with pytest.raises(NotImplementedError):
        teng.paged_scheduler(2, page_size=4, n_pages=8)
    with pytest.raises(NotImplementedError):
        jeng.paged_scheduler(2, page_size=4, n_pages=8)
    tiny = get_smoke_config("whisper-tiny")
    with pytest.raises(NotImplementedError):
        teng.speculative(tiny, teng.params)
    st = model.init_serve_state(teng._serve_params, teng.cfg, 1, MAX_LEN)
    with pytest.raises(NotImplementedError):
        model.verify_step(teng._serve_params, teng.cfg,
                          torch.zeros((1, 2), dtype=torch.long), st)
    with pytest.raises(ValueError, match="max_len"):
        teng.generate(_prompts(teng.cfg, 1, 30), max_new=3)
    sched = ContinuousBatchingScheduler(teng, n_slots=2)
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(np.zeros(30, np.int32), max_new=3)
    with pytest.raises(ValueError, match="ONE request"):
        sched.submit(np.zeros((2, 3), np.int32))
    with pytest.raises(ValueError, match="transcribe"):
        ServeEngine(tiny, model.init_params(torch.Generator().manual_seed(0),
                                            tiny, device="cpu"),
                    device="cpu").generate(np.zeros((1, 2), np.int32))


def test_engine_submit_and_run_wrappers():
    _, teng = _pair("phi3-mini-3.8b", "none", None)
    prompts, budgets = _lm_requests(teng.cfg, 3, seed=3)
    rids = [teng.submit(p, max_new=n, n_slots=2)
            for p, n in zip(prompts, budgets)]
    assert teng.scheduler().n_frames is None
    got = teng.run()
    assert [got[r].tokens for r in rids] == [
        teng.generate(p[None], max_new=n)[0].tokens
        for p, n in zip(prompts, budgets)]


def test_cli_serves_a_dense_lm(capsys):
    assert serve_cli.main(["--arch", "qwen2.5-14b", "--device", "cpu",
                           "--power-w", "700", "--offload", "--requests",
                           "2", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "req1: 3 tokens" in out and '"ledger_commits": 2' in out
    assert serve_cli.main(["--arch", "qwen2.5-14b", "--device", "cpu",
                           "--power-w", "700", "--continuous", "--slots",
                           "2", "--requests", "3", "--max-new", "2"]) == 0
    assert "continuous batching: 2 slots, 6 tokens streamed" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "qwen2.5-14b", "--device", "cpu",
                        "--power-w", "700", "--speculative"])


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("drain", ["generate", "continuous"])
def test_spans_match_reference(drain):
    """Span names (with category and track) and each ledger span's FLOPs
    and calls, span for span, equal the reference's; the ledger exact."""
    jeng, teng = _pair("qwen2.5-14b", "q8_0", telemetry=True)
    prompts, budgets = _lm_requests(teng.cfg, 4, seed=4)
    for eng, make in ((jeng, JaxScheduler), (teng,
                                             ContinuousBatchingScheduler)):
        if drain == "generate":
            eng.generate(_prompts(eng.cfg, 2, 4), max_new=3)
            eng.generate(_prompts(eng.cfg, 1, 6, seed=1), max_new=2)
        else:
            sched = make(eng, n_slots=2)
            for p, n in zip(prompts, budgets):
                sched.submit(p, max_new=n)
            sched.run()
    jt, tt = jeng.telemetry, teng.telemetry
    assert tt.ledger_consistent()["exact"] and jt.ledger_consistent()["exact"]
    assert tt.tracer.all_closed() and tt.tracer.check_nesting() == []
    assert collections.Counter((s.name, s.cat, s.track)
                               for s in tt.tracer.spans) == \
        collections.Counter((s.name, s.cat, s.track)
                            for s in jt.tracer.spans)
    got = [(s.name, s.args["flops"], s.args["calls"])
           for s in tt.tracer.spans if "flops" in s.args]
    want = [(s.name, s.args["flops"], s.args["calls"])
            for s in jt.tracer.spans if "flops" in s.args]
    assert got == want and got
    assert [(e.name, e.track, e.args) for e in tt.tracer.events] == \
        [(e.name, e.track, e.args) for e in jt.tracer.events]
