"""The port's state-space (mamba2-780m) and hybrid (jamba-v0.1-52b)
families against the reference, on the CPU at the smoke configs (mamba2:
2 SSM layers, d_model 64, 8 SSD heads of 16, d_state 16; jamba: a pattern
of 2, an SSM layer with a dense FFN and an attention layer with a MoE
FFN), with identical weights (the reference's ``init_params`` through
``convert.py``) and numpy-seeded inputs:

- the configs: the published ones, the smoke ones and jamba's one-repeat
  cut field for field, the parameter counts, ``layer_pattern`` and
  ``enumerate_lm`` (which has SSM terms for the prefill only, in both);
  an SSM or hybrid config without an ``SSMConfig`` refused;
- ``init_ssm``'s layout, dtypes and fixed values; ``convert.py`` carrying
  the SSM leaves across (layer i is repeat ``i // P`` of position
  ``i % P``); the Q8_0 tree's quantized leaves equal the reference's;
- ``ssm_decode_step`` against the reference's over 16 carried steps, the
  output, conv window and SSD state within 1e-5 (f32), at the smoke
  config and at mamba2's and jamba's SSM ratios;
- ``serve_step`` logits and layer states over a prefill; in bf16 within
  2e-2 of the largest logit; ``generate`` tokens, plans and ledger
  (mamba2 Q8_0 and bf16, jamba bf16 with four identical rows, whose
  capacity drops the reference shares; bursts None/256/32);
- the slot scheduler's tokens and ``TokenEvent`` order against
  ``repro.serve.scheduler`` and batch-1 ``generate``; committed and used
  state bytes, with ``max_len`` equal to the SSD head count (the
  reference's positional test then takes the SSD state for positional);
- the refusals (jamba in Q8_0 at the engine and the CLI, where the
  reference fails; the paged pool and speculative serving for both); the
  CLI; span names and per-span FLOPs against ``repro.obs``.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.configs import base as jax_base
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core import coverage as jax_coverage
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.core.qformats import QTensor as JaxQTensor
from repro.core.qformats import quantize_tree as jax_quantize_tree
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer
from repro.serve import engine as jax_engine
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.kvcache import SlotKVPool as JaxSlotKVPool
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from repro_torch import obs
from repro_torch.configs import base, get_config, get_smoke_config
from repro_torch.convert import _tensor, from_jax_params
from repro_torch.core import coverage
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.qformats import QTensor, quantize_tree
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model, ssm, transformer
from repro_torch.serve import engine as engine_lib
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import SlotKVPool
from repro_torch.serve.scheduler import ContinuousBatchingScheduler

MAMBA = "mamba2-780m"
JAMBA = "jamba-v0.1-52b"
ARCHS = [MAMBA, JAMBA]
BURSTS = [None, 256, 32]
MAX_LEN = 32
# the reference's plain backend maps to the port's Hopper kernels
BACKEND_NAMES = {"pallas_tpu": "hopper", "xla_ref": "hopper",
                 "host_residual": "host_residual"}
PLAN_FIELDS = ("name", "m", "k", "n", "dtype", "offload", "burst", "tuned",
               "kernel", "tiling", "k_main", "k_res")
SSM_LEAVES = ("in_proj/w", "out_proj/w", "conv_w", "conv_b", "A_log", "D",
              "dt_bias", "norm/scale")


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
    smoke config with ``overrides`` (both packages' ``reduced``), the same
    weights, made once an arch and override set."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PARAMS:
        jcfg = jax_base.reduced(jax_config(arch), **overrides)
        jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        _PARAMS[key] = (jcfg, jp, base.reduced(get_config(arch),
                                               **overrides), tp)
    return _PARAMS[key]


def _pair(arch, quant="none", burst=256, eos_id=None, telemetry=False,
          max_len=MAX_LEN):
    """A reference engine and a port engine on the same weights."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    joff = (None if burst is None
            else JaxOffloadEngine(prefer_pallas=False, burst=burst))
    toff = None if burst is None else OffloadEngine(burst=burst)
    return (JaxServeEngine(jcfg, jp, max_len=max_len, quant=quant,
                           offload=joff, eos_id=eos_id,
                           telemetry=jax_obs.Telemetry() if telemetry
                           else None),
            ServeEngine(tcfg, tp, max_len=max_len, quant=quant,
                        offload=toff, eos_id=eos_id, device="cpu",
                        telemetry=obs.Telemetry() if telemetry else None))


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _stats(offload):
    d = dataclasses.asdict(offload.stats)
    d.pop("by_device", None)
    d["by_backend"] = collections.Counter(
        {BACKEND_NAMES.get(k, k): v for k, v in d["by_backend"].items()})
    return d


def _entries(plan):
    return [tuple(getattr(e, f) for f in PLAN_FIELDS)
            + (BACKEND_NAMES.get(e.backend, e.backend),) for e in plan]


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# Configs, init and conversion
# ---------------------------------------------------------------------------
def _asdict(cfg):
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_pattern_counts_and_coverage_match_reference(arch):
    """The published config, the smoke config and jamba's one-repeat cut
    (8 layers) field for field; the parameter counts, the attention and
    MoE layers, the layer pattern and ``enumerate_lm`` (prefill SSM terms,
    none in the decode loop: the reference's) equal the reference's. An
    SSM or hybrid config needs an ``SSMConfig``."""
    cut = dict(num_layers=8) if arch == JAMBA else {}
    for port, ref in (
            (get_config(arch), jax_config(arch)),
            (get_smoke_config(arch), jax_smoke_config(arch)),
            (dataclasses.replace(get_config(arch), **cut),
             dataclasses.replace(jax_config(arch), **cut))):
        assert _asdict(port) == {k: v for k, v in _asdict(ref).items()
                                 if k in _asdict(port)}
        assert (port.n_params(), port.n_active_params()) == \
            (ref.n_params(), ref.n_active_params())
        assert port._param_terms() == ref._param_terms()
        assert (port.attention_layers, port.moe_layers) == \
            (ref.attention_layers, ref.moe_layers)
        assert [tuple(s) for s in transformer.layer_pattern(port)] == \
            [tuple(s) for s in jax_transformer.layer_pattern(ref)]
        for seq, new, batch in ((0, 3, 1), (16, 0, 2), (7, 5, 4)):
            assert [dataclasses.astuple(m) for m in
                    coverage.enumerate_lm(port, seq, new, batch)] == \
                [dataclasses.astuple(m) for m in
                 jax_coverage.enumerate_lm(ref, seq, new, batch)]
    assert not any(m.name.startswith("ssm") for m in
                   coverage.enumerate_lm(get_config(arch), 0, 4, 1))
    pattern = transformer.layer_pattern(get_config(arch))
    smoke = transformer.layer_pattern(get_smoke_config(arch))
    if arch == MAMBA:
        assert pattern == smoke == (transformer.LayerSpec("ssm", "none"),)
        assert get_config(arch).padded_vocab == 50_288
    else:
        assert [s.mixer for s in pattern] == ["ssm"] * 4 + ["attn"] + \
            ["ssm"] * 3
        assert [s.ffn for s in pattern] == ["dense", "moe"] * 4
        assert smoke == (transformer.LayerSpec("ssm", "dense"),
                         transformer.LayerSpec("attn", "moe"))
        # one repeat at full width: 13.3 G parameters, 26.5 GB of bf16
        one = dataclasses.replace(get_config(arch), num_layers=8)
        assert 13.2e9 < one.n_params() < 13.4e9
    with pytest.raises(ValueError, match="SSMConfig"):
        dataclasses.replace(get_config(arch), ssm=None)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_ssm_layout_dtypes_and_values_match_reference(arch):
    """At the arch's SSM config (d_state, head_dim, d_conv) on a d_model
    of 256: every leaf's shape and type (bf16 weights, f32 A_log, D and
    dt_bias) as the reference's, the fixed leaves' values within 1e-6,
    the conv's scale; each layer's blocks by its spec."""
    cfg = dataclasses.replace(get_config(arch), d_model=256)
    jcfg = dataclasses.replace(jax_config(arch), d_model=256)
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    jp = jax_ssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    assert set(p) == set(jp)
    for path in SSM_LEAVES:
        got, want = _leaf(p, path), _leaf(jp, path)
        assert tuple(got.shape) == tuple(want.shape), path
        assert got.dtype == getattr(torch, str(want.dtype)), path
        if path in ("A_log", "D", "dt_bias", "norm/scale", "conv_b"):
            _close(got, want, 1e-6)
    assert p["in_proj"]["w"].shape[0] == (
        2 * 512 + 2 * cfg.ssm.d_state + 512 // cfg.ssm.head_dim)
    std = p["conv_w"].float().std().item()
    assert abs(std - cfg.ssm.d_conv ** -0.5) < 0.05
    blocks = transformer.init_decoder_stack(
        torch.Generator().manual_seed(0), get_smoke_config(arch))["blocks"]
    want = [{"norm1", s.mixer} | ({"norm2", s.ffn if s.ffn == "moe"
                                   else "ffn"} if s.ffn != "none" else set())
            for s in transformer.layer_specs(get_smoke_config(arch))]
    assert [set(b) for b in blocks] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_ssm_leaves(arch):
    """Layer i of the port's stack holds repeat ``i // P`` of position
    ``i % P`` of the reference's stacked leaves, every SSM leaf as it is
    (a 4-layer mamba2 and jamba's 4-layer smoke cut: two repeats)."""
    jcfg = jax_base.reduced(jax_config(arch), num_layers=4)
    jp = jax_model.init_params(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    period = len(jax_transformer.layer_pattern(jcfg))
    seen = 0
    for i, blk in enumerate(tp["stack"]["blocks"]):
        jblk = jp["stack"]["blocks"][i % period]
        assert set(blk) == set(jblk)
        if "ssm" not in blk:
            continue
        seen += 1
        for path in SSM_LEAVES:
            assert torch.equal(_leaf(blk["ssm"], path),
                               _tensor(np.asarray(_leaf(jblk["ssm"],
                                                        path))[i // period]))
    assert seen == (4 if arch == MAMBA else 2)


def _qpaths_port(tree, period, path=()):
    if isinstance(tree, QTensor):
        return {path}
    if isinstance(tree, dict):
        return set().union(*(_qpaths_port(v, period, path + (k,))
                             for k, v in tree.items()))
    if isinstance(tree, list):
        return set().union(*(_qpaths_port(
            v, period, path + ((i % period,) if path[-1:] == ("blocks",)
                               else (i,))) for i, v in enumerate(tree)))
    return set()


def _qpaths_ref(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxQTensor))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p)
            for p, leaf in flat if isinstance(leaf, JaxQTensor)}


@pytest.mark.parametrize("arch", ARCHS)
def test_q8_0_tree_quantizes_the_reference_leaves(arch):
    """Under the whisper.cpp predicate the port quantizes exactly the
    reference's leaves (the linears, the embedding, the expert stacks);
    the conv, A_log, dt_bias, D and norms stay dense; the quantized bits
    equal the reference's."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    jq = jax_quantize_tree(jp, jax_engine._keep_dense)
    tq = quantize_tree(tp, engine_lib._keep_dense)
    period = len(transformer.layer_pattern(tcfg))
    got, want = _qpaths_port(tq, period), _qpaths_ref(jq)
    assert got == want
    assert ("stack", "blocks", 0, "ssm", "in_proj", "w") in got
    assert not any(k in p for p in got for k in
                   ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm"))
    tw = tq["stack"]["blocks"][0]["ssm"]["in_proj"]["w"]
    jw = jq["stack"]["blocks"][0]["ssm"]["in_proj"]["w"]
    assert torch.equal(tw.qs, _tensor(np.asarray(jw.qs)[0]))
    assert torch.equal(tw.scales, _tensor(np.asarray(jw.scales)[0]))


# ---------------------------------------------------------------------------
# ssm_decode_step against the reference
# ---------------------------------------------------------------------------
SSM_RATIOS = {
    "smoke": {},
    # mamba2's d_state 128 and head_dim 64, at d_model 128 (4 heads)
    "mamba2": dict(d_model=128, ssm=jax_base.SSMConfig(
        d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=8)),
    # jamba's d_state 16 and head_dim 64
    "jamba": dict(d_model=128, ssm=jax_base.SSMConfig(
        d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=8)),
}


@pytest.mark.parametrize("ratios", list(SSM_RATIOS))
def test_ssm_decode_step_matches_reference_over_carried_steps(ratios):
    """Two rows, 16 steps, each from the state the last one left: the
    output and the conv window and SSD state within 1e-5 of the
    reference's (f32), the state advanced in place in the same tensors,
    its length counted."""
    over = SSM_RATIOS[ratios]
    jcfg = jax_base.reduced(jax_config(MAMBA), **over)
    tover = dict(over)
    if "ssm" in tover:
        tover["ssm"] = base.SSMConfig(**dataclasses.asdict(over["ssm"]))
    tcfg = base.reduced(get_config(MAMBA), **tover)
    jp = jax_ssm.init_ssm(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = jax.tree_util.tree_map(lambda a: _tensor(np.asarray(a)), jp)
    rng = np.random.default_rng(7)
    js = jax_ssm.SSMState.zeros(2, jcfg.ssm, jcfg.d_model)
    ts = ssm.SSMState.zeros(2, tcfg.ssm, tcfg.d_model, device="cpu")
    conv, ssd = ts.conv, ts.ssd
    for _ in range(16):
        u = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, js = jax_ssm.ssm_decode_step(jp, jcfg, jnp.asarray(u), js)
        ty, ts = ssm.ssm_decode_step(tp, tcfg, torch.from_numpy(u), ts)
        assert ty.dtype == torch.float32 and ty.shape == (2, 1, tcfg.d_model)
        _close(ty, jy, 1e-5)
        _close(ts.conv, js.conv, 1e-5)
        _close(ts.ssd, js.ssd, 1e-5)
    assert ts.conv is conv and ts.ssd is ssd
    assert int(ts.length) == int(js.length) == 16
    assert float(np.abs(np.asarray(js.ssd)).max()) > 0.01


# ---------------------------------------------------------------------------
# serve_step, generate and the scheduler against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["mamba2-q8_0", "mamba2-none", "jamba-none",
                                  "mamba2-bf16", "jamba-bf16"])
def test_prefill_logits_and_states_match_reference(case):
    """``serve_step`` over two 5-token prompts against the reference's
    compiled prefill: logits within 1e-5 of the largest (f32 smoke) and
    2e-2 in bf16 (``reduced(..., dtype="bfloat16", param_dtype=
    "bfloat16")``: the decode's casts to bf16 around the f32 recurrence),
    and every layer's state (conv window, SSD state, K/V) against the
    reference's stacked leaves."""
    arch = MAMBA if case.startswith("mamba2") else JAMBA
    quant = "q8_0" if case.endswith("q8_0") else "none"
    bf16 = case.endswith("bf16")
    over = dict(dtype="bfloat16", param_dtype="bfloat16") if bf16 else {}
    jcfg, jp, tcfg, tp = _smoke(arch, **over)
    jeng = JaxServeEngine(jcfg, jp, max_len=MAX_LEN, quant=quant,
                          offload=None, eos_id=None)
    teng = ServeEngine(tcfg, tp, max_len=MAX_LEN, quant=quant, offload=None,
                       eos_id=None, device="cpu")
    prompts = _prompts(tcfg, 2, 5)
    jl, jst = jeng._prefill_jit(jeng._serve_params, jnp.asarray(prompts))
    tl, tst = teng.prefill(torch.from_numpy(prompts).long())
    tol = 2e-2 if bf16 else 1e-5
    _close(tl, jl, tol)
    period = len(transformer.layer_pattern(tcfg))
    for i, st in enumerate(tst.layer_states):
        ref = jst.layer_states[i % period]
        assert type(st).__name__ == type(ref).__name__
        for field in st._fields:
            if field == "length":
                assert int(st.length) == int(np.asarray(ref.length)[i // period])
                continue
            got = getattr(st, field)
            want = np.asarray(getattr(ref, field).astype(jnp.float32))
            assert got.dtype == getattr(torch, str(getattr(ref, field).dtype))
            _close(got, want[i // period], tol)
    assert int(tst.step) == 5


def _generate_cases():
    cases = [(MAMBA, q, b) for q in ("q8_0", "none") for b in BURSTS]
    return cases + [(JAMBA, "none", b) for b in BURSTS]


@pytest.mark.parametrize("arch,quant,burst", _generate_cases())
def test_generate_matches_reference(arch, quant, burst):
    """Batch 1 and 2 (jamba also four identical prompts, whose capacity
    drops both packages share) on one engine pair: tokens and steps
    exact, every plan's entries and the ledger equal; the plan names are
    the SSM layer's ``ssm.in_proj``/``ssm.out_proj`` beside the others;
    mamba2's eager loop (``prefill``/``step``, no KV cache to fill past
    ``max_len``) gives the tokens ``generate`` gives."""
    jeng, teng = _pair(arch, quant, burst)
    prompts = _prompts(teng.cfg, 2, 5)
    batches = [prompts[:1], prompts]
    if arch == JAMBA:
        batches.append(np.repeat(prompts[:1], 4, axis=0))
    for p in batches:
        want = jeng.generate(p, max_new=6)
        got = teng.generate(p, max_new=6)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert [r.steps for r in got] == [r.steps for r in want]
    if arch == JAMBA:
        rows = [r.tokens for r in got]
        assert rows[0] == rows[1] and rows[2] == rows[3]
    assert teng._step_captures == 0 and not teng._graphs
    if burst is not None:
        _plans_and_ledger_match(arch, quant, jeng, teng)
    if arch == MAMBA:
        with torch.no_grad():
            logits, state = teng.prefill(torch.from_numpy(prompts).long())
            tok = teng._argmax(logits[:, -1])[:, None]
            rows = []
            for _ in range(MAX_LEN):            # past max_len: no KV cache
                logits, state = teng.step(tok, state)
                tok = teng._argmax(logits[:, -1])[:, None]
                rows.append(tok)
        eager = torch.cat(rows, dim=1).tolist()
        assert [r[:6] for r in eager] == [r.tokens for r in got]


def _plans_and_ledger_match(arch, quant, jeng, teng):
    assert set(teng._plans.plans) == set(jeng._plans.plans)
    for key, jplan in jeng._plans.plans.items():
        assert _entries(teng._plans.plans[key]) == _entries(jplan), key
    names = {e.name for e in teng._plans.plans[("step", quant, 1)]}
    want = {"ssm.in_proj", "ssm.out_proj", "lm_head"}
    if arch == JAMBA:
        want |= {"dec.attn.q", "dec.attn.k", "dec.attn.v", "dec.attn.o",
                 "ffn.up", "ffn.gate", "ffn.down"}
    assert names == want
    assert _stats(teng.offload) == _stats(jeng.offload)
    assert teng.offload.ledger.commits == jeng.offload.ledger.commits


def _requests(cfg, n, seed=0, longest=6):
    """``n`` prompts of 2 to ``longest`` tokens and budgets of 2 to
    ``longest + 1`` tokens."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, longest + 1, n)
    budgets = rng.integers(2, longest + 2, n).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, (int(s),)).astype(np.int32)
               for s in lens]
    return prompts, budgets


def _drive(sched, prompts, budgets):
    """Three requests, an admission and a step, then the rest: (tokens by
    submission index, the event stream)."""
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


@pytest.mark.parametrize("arch,quant", [(MAMBA, "q8_0"), (MAMBA, "none"),
                                        (JAMBA, "none")])
def test_scheduler_matches_reference_and_batch1_generate(arch, quant):
    """Six requests over 3 slots, a second wave mid-drain: tokens and the
    event stream equal the reference scheduler's (a request's SSM state
    spliced into its slot and zeroed at the next load), and mamba2's
    equal every request's batch-1 ``generate`` (jamba's MoE layers take
    capacity from the free rows too, in both packages)."""
    jeng, teng = _pair(arch, quant)
    prompts, budgets = _requests(teng.cfg, 6)
    got, gev = _drive(ContinuousBatchingScheduler(teng, n_slots=3),
                      prompts, budgets)
    want, wev = _drive(JaxScheduler(jeng, n_slots=3), prompts, budgets)
    assert got == want and gev == wev
    assert _stats(teng.offload) == _stats(jeng.offload)
    if arch == MAMBA:
        assert got == [teng.generate(p[None], max_new=n)[0].tokens
                       for p, n in zip(prompts, budgets)]


@pytest.mark.parametrize("max_len", [MAX_LEN, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_ledger_and_state_bytes_match_reference(arch, max_len):
    """One drain on fresh engines: one commit an admission and a step,
    committed and peak used bytes equal the reference's; the pools' used
    bytes equal for given lengths. At ``max_len`` 8, the smoke SSD's head
    count, the reference's shape test counts the SSD state as positional
    (a quirk the port keeps), and the port's count moves with it."""
    jeng, teng = _pair(arch, "none", max_len=max_len)
    prompts, budgets = _requests(teng.cfg, 4, seed=1, longest=3)
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
    jcfg, jp, tcfg, _ = _smoke(arch)
    pool = SlotKVPool(tcfg, 3, max_len, device="cpu")
    jpool = JaxSlotKVPool(jcfg, jp, 3, max_len)
    assert pool.committed_kv_bytes() == jpool.committed_kv_bytes() == \
        out[0][0]
    for lengths in ({0: 3}, {0: 1, 2: 7}, {0: 8, 1: 2, 2: 5}):
        assert pool.used_kv_bytes(lengths) == jpool.used_kv_bytes(lengths)
    heads = tcfg.ssm.n_heads(tcfg.d_model)
    assert heads == 8
    ssd_leaf = pool.state.layer_states[0].ssd
    assert (ssd_leaf.shape[1] == max_len) == (max_len == heads)


# ---------------------------------------------------------------------------
# Refusals and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_paths_the_reference_refuses_are_refused(arch):
    """The paged pool and speculative serving raise for both families, as
    the reference's; jamba in Q8_0 (its expert stacks quantized) fails in
    the reference's ``moe_ffn`` and is refused at the port's engine and
    CLI before any step; mamba2 serves Q8_0."""
    jeng, teng = _pair(arch, "none")
    for eng in (teng, jeng):
        with pytest.raises(NotImplementedError):
            eng.paged_scheduler(2, page_size=4, n_pages=8)
    with pytest.raises(NotImplementedError):
        teng.speculative(teng.cfg, teng.params)
    st = model.init_serve_state(teng._serve_params, teng.cfg, 1, MAX_LEN)
    with pytest.raises(NotImplementedError):
        model.verify_step(teng._serve_params, teng.cfg,
                          torch.zeros((1, 2), dtype=torch.long), st)
    jcfg, jp, tcfg, tp = _smoke(arch)
    if arch == MAMBA:
        ServeEngine(tcfg, tp, max_len=MAX_LEN, device="cpu")
        return
    jq = JaxServeEngine(jcfg, jp, max_len=MAX_LEN, eos_id=None)
    with pytest.raises(AttributeError, match="astype"):
        jq.generate(_prompts(jcfg, 1, 3), max_new=2)
    for quant in (None, "q8_0"):
        with pytest.raises(NotImplementedError, match="moe.py:121"):
            ServeEngine(tcfg, tp, max_len=MAX_LEN, quant=quant,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="quant='none'"):
        serve_cli.main(["--arch", arch, "--device", "cpu", "--power-w",
                        "700", "--requests", "2", "--max-new", "3"])


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_both_families(arch, capsys):
    """``--arch mamba2-780m`` in Q8_0 (its default) and
    ``--arch jamba-v0.1-52b --quant none``: one static batch with the
    ledger, then the scheduler over 2 slots."""
    quant = ["--quant", "none"] if arch == JAMBA else []
    argv = ["--arch", arch, "--device", "cpu", "--power-w", "700"] + quant
    assert serve_cli.main(argv + ["--offload", "--requests", "2",
                                  "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "req1: 3 tokens" in out and '"ledger_commits": 2' in out
    assert serve_cli.main(argv + ["--continuous", "--slots", "2",
                                  "--requests", "3", "--max-new", "2"]) == 0
    assert "continuous batching: 2 slots, 6 tokens streamed" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("drain", ["generate", "continuous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spans_match_reference(arch, drain):
    """Span names (with category and track) and each ledger span's FLOPs
    and calls equal the reference's, the SSM layers' linears included;
    the ledger exact."""
    jeng, teng = _pair(arch, "q8_0" if arch == MAMBA else "none",
                       telemetry=True)
    prompts, budgets = _requests(teng.cfg, 4, seed=4)
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
