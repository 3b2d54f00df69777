"""The port's mixture-of-experts family against the reference, on the CPU
at the smoke configs (olmoe-1b-7b: 4 experts of 64, top-2; arctic-480b:
4 experts, top-2, and its dense residual branch), with identical weights
(the reference's ``init_params`` through ``convert.py``) and
numpy-seeded inputs:

- the configs the port adds: the published ones and phase 15c's
  one-layer arctic field for field, the parameter counts (olmoe's
  6,919,096,320 pinned), ``enumerate_lm``, the capacity of a decode batch;
- ``init_moe``'s layout, scales and chunked draw; ``convert.py`` carrying
  the MoE leaves across;
- ``moe_ffn`` against ``repro.models.moe.moe_ffn`` over S in {1, 7, 16},
  capacity factors 0.25 / 1.25 / 8.0 and grouped (G > 1) and ragged (one
  group) dispatch: the dispatch one-hot (the keep masks and the slots)
  exact, y within 1e-5 in f32 and 1e-2 of the largest output in bf16,
  the load-balance loss within 1e-6; the no-drop oracle against the
  reference's, and ``moe_ffn`` against it where nothing drops;
- ``serve_step`` logits over a prefill, ``generate`` tokens, plans and
  ledger at batch 1, 2 and 4 (four identical prompts: drops), bursts
  None/256/32;
- the slot scheduler's tokens and ``TokenEvent`` order against
  ``repro.serve.scheduler``, and the arctic drop case pinned;
- Q8_0: the reference fails (``AttributeError``), the port refuses
  (``NotImplementedError``) before any step, in the engine and the CLI;
- span names and per-span FLOPs of an olmoe drain against ``repro.obs``.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core import coverage as jax_coverage
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from repro_torch import obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import _tensor, from_jax_params
from repro_torch.core import coverage
from repro_torch.core.offload import OffloadEngine
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model, moe, transformer
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler

MOE = ["olmoe-1b-7b", "arctic-480b"]
BURSTS = [None, 256, 32]
MAX_LEN = 32
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


def _pair(arch, burst=256, eos_id=None, telemetry=False):
    """A reference engine and a port engine on the same weights, bf16
    serving (``quant="none"``)."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    joff = (None if burst is None
            else JaxOffloadEngine(prefer_pallas=False, burst=burst))
    toff = None if burst is None else OffloadEngine(burst=burst)
    return (JaxServeEngine(jcfg, jp, max_len=MAX_LEN, quant="none",
                           offload=joff, eos_id=eos_id,
                           telemetry=jax_obs.Telemetry() if telemetry
                           else None),
            ServeEngine(tcfg, tp, max_len=MAX_LEN, quant="none",
                        offload=toff, eos_id=eos_id, device="cpu",
                        telemetry=obs.Telemetry() if telemetry else None))


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want).astype(np.float32)
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


# ---------------------------------------------------------------------------
# Configs, init and conversion
# ---------------------------------------------------------------------------
def _asdict(cfg):
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", MOE)
def test_configs_counts_and_capacity_match_reference(arch):
    """The published config, the smoke config and phase 15c's one-layer
    cut field for field, with their counts and ``enumerate_lm``; every
    layer a MoE layer; at a decode step (one token a row) a batch up to
    51 rows gets the same capacity, so nothing in a row's shapes follows
    the batch."""
    one = dataclasses.replace(get_config(arch), num_layers=1)
    jone = dataclasses.replace(jax_config(arch), num_layers=1)
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch)),
                      (one, jone)):
        assert _asdict(port) == {k: v for k, v in _asdict(ref).items()
                                 if k in _asdict(port)}
        assert (port.n_params(), port.n_active_params()) == \
            (ref.n_params(), ref.n_active_params())
        assert port.moe_layers == ref.moe_layers == tuple(
            range(port.num_layers))
        assert {s.ffn for s in transformer.layer_specs(port)} == {"moe"}
        assert [dataclasses.astuple(m) for m in
                coverage.enumerate_lm(port, 7, 5, 4)] == \
            [dataclasses.astuple(m) for m in
             jax_coverage.enumerate_lm(ref, 7, 5, 4)]
    full = get_config(arch).moe
    caps = {moe._capacity(b, full) for b in range(1, 52)}
    assert caps == {jax_moe._capacity(b, jax_config(arch).moe)
                    for b in range(1, 52)} == {full.experts_per_token}
    if arch == "olmoe-1b-7b":
        assert get_config(arch).n_params() == 6_919_096_320
    with pytest.raises(ValueError, match="MoEConfig"):
        dataclasses.replace(get_config(arch), moe=None)


@pytest.mark.parametrize("arch", MOE)
def test_init_moe_layout_scales_and_chunked_draw(arch, monkeypatch):
    """The reference's layout and dtypes, drawn a chunk of experts at a
    time (a chunk of one expert here), each stack at its scale."""
    cfg = get_smoke_config(arch)
    m = cfg.moe
    monkeypatch.setattr(moe, "DRAW_CHUNK_VALUES", cfg.d_model * m.d_ff)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    jp = jax_moe.init_moe(jax.random.PRNGKey(0),
                          jax_smoke_config(arch), jnp.bfloat16)
    got = {k: (tuple(v.shape), v.dtype) for k, v in
           (("router", p["router"]["w"]), ("w_up", p["w_up"]),
            ("w_gate", p["w_gate"]), ("w_down", p["w_down"]))}
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            (("router", jp["router"]["w"]), ("w_up", jp["w_up"]),
             ("w_gate", jp["w_gate"]), ("w_down", jp["w_down"]))}
    assert got == {k: (s, getattr(torch, d)) for k, (s, d) in want.items()}
    assert ("dense" in p) == ("dense" in jp) == (arch == "arctic-480b")
    for key, scale in (("w_up", cfg.d_model ** -0.5),
                       ("w_down", m.d_ff ** -0.5)):
        std = p[key].float().std().item()
        assert abs(std - scale) < 0.1 * scale
        # every expert drawn apart: no two chunks repeat
        assert not torch.equal(p[key][0], p[key][1])
    blocks = transformer.init_decoder_stack(torch.Generator().manual_seed(0),
                                            cfg)["blocks"]
    assert all(set(b) == {"norm1", "attn", "norm2", "moe"} for b in blocks)


@pytest.mark.parametrize("arch", MOE)
def test_convert_carries_the_moe_leaves(arch):
    """Layer i of the port's stack holds repeat i of the reference's
    stacked ``moe`` leaves, the (E, in, out) stacks as they are."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    jblk = jp["stack"]["blocks"][0]["moe"]
    for i, blk in enumerate(tp["stack"]["blocks"]):
        for key in ("w_up", "w_gate", "w_down"):
            assert torch.equal(blk["moe"][key], _tensor(jblk[key][i]))
        assert torch.equal(blk["moe"]["router"]["w"],
                           _tensor(jblk["router"]["w"][i]))
        assert ("dense" in blk["moe"]) == (arch == "arctic-480b")
        if "dense" in blk["moe"]:
            assert torch.equal(blk["moe"]["dense"]["up"]["w"],
                               _tensor(jblk["dense"]["up"]["w"][i]))


# ---------------------------------------------------------------------------
# moe_ffn against the reference
# ---------------------------------------------------------------------------
class _Capture:
    """Stands in for the reference's sharding context: records what
    ``moe_ffn`` constrains (its dispatch one-hot first, then its combine)
    and returns it unchanged."""

    def __init__(self):
        self.seen = []

    def constrain(self, x, *_):
        self.seen.append(x)
        return x


def _dispatch(r: moe.Routing, n_exp: int) -> np.ndarray:
    """The port's routing as the reference's (G, Tg, E, C) dispatch
    one-hot: a 1 where a kept choice holds its slot."""
    g, tg, k = r.experts.shape
    out = np.zeros((g, tg, n_exp, r.cap), np.float32)
    gi, ti, ji = np.nonzero(r.keep.numpy())
    out[gi, ti, r.experts.numpy()[gi, ti, ji], r.pos.numpy()[gi, ti, ji]] = 1
    return out


def _layer(arch, seed=1, **moe_overrides):
    """One MoE layer's weights (f32), the same in both packages, and the
    configs with ``moe_overrides``."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, **moe_overrides))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, **moe_overrides))
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree_util.tree_map(lambda a: _tensor(np.asarray(a)), jp)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("grouping", ["grouped", "ragged"])
@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("s", [1, 7, 16])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, s, cf, grouping, monkeypatch):
    """Two rows of S tokens. Grouped: a dispatch group of S tokens (S = 1:
    one token), so G = 2 (at S = 16 a group of 4, G = 8); ragged: a group
    of 3, which divides no T here but 2, so one group. The dispatch one-hot
    is exact (which choices are kept, and in which slot), in f32 and in
    bf16; y within 1e-5 of the largest output in f32 and 1e-2 in bf16,
    where the combine weights round to bf16; the load-balance loss within
    1e-6."""
    group = (4 if s == 16 else s) if grouping == "grouped" else 3
    jcfg, jp, tcfg, tp = _layer(arch, capacity_factor=cf,
                                dispatch_group=group)
    x = np.random.default_rng(s).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    drops = 0
    for dt, tol in (("float32", 1e-5), ("bfloat16", 1e-2)):
        cap = _Capture()
        monkeypatch.setattr(jax_moe, "ctx", cap)
        jy, jaux = jax_moe.moe_ffn(jp, dataclasses.replace(jcfg, dtype=dt),
                                   jnp.asarray(x).astype(dt))
        monkeypatch.undo()
        tx = torch.from_numpy(x).to(getattr(torch, dt))
        r, aux = moe.route(tp, tcfg, tx)
        assert r.cap == np.asarray(cap.seen[0]).shape[-1]
        assert np.array_equal(_dispatch(r, tcfg.moe.num_experts),
                              np.asarray(cap.seen[0]).astype(np.float32))
        assert (r.experts.shape[0] > 1) == (grouping == "grouped")
        y, aux2 = moe.moe_ffn(tp, tcfg, tx)
        assert y.dtype == tx.dtype and float(aux2) == float(aux)
        _close(y, jy, tol)
        assert abs(float(aux) - float(jaux)) <= 1e-6
        drops = int((~r.keep).sum())
    if cf == 0.25 and s > 1:
        assert drops > 0
    elif cf == 8.0:
        assert drops == 0


@pytest.mark.parametrize("arch", MOE)
def test_dense_oracle_matches_reference_and_moe_ffn_without_drops(arch):
    """The oracle (every expert over every token) against the reference's
    oracle within 1e-5; where the capacity holds every choice (factor
    8.0), ``moe_ffn`` equals it within 1e-5; where it does not (0.25), a
    token whose choice was dropped differs."""
    jcfg, jp, tcfg, tp = _layer(arch, capacity_factor=8.0)
    x = np.random.default_rng(9).standard_normal(
        (2, 7, jcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    want = moe.moe_ffn_dense_oracle(tp, tcfg, tx)
    _close(want, jax_moe.moe_ffn_dense_oracle(jp, jcfg, jnp.asarray(x)),
           1e-5)
    y, _ = moe.moe_ffn(tp, tcfg, tx)
    _close(y, want.numpy(), 1e-5)
    tight = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.25))
    r, _ = moe.route(tp, tight, tx)
    y, _ = moe.moe_ffn(tp, tight, tx)
    dropped = (~r.keep).any(-1).reshape(2, 7)
    assert dropped.any()
    err = (y - want).abs().amax(-1)
    assert (err[dropped] > 1e-3).all() and (err[~dropped] < 1e-5).all()


# ---------------------------------------------------------------------------
# serve_step, generate and the scheduler against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_prefill_logits_match_reference(arch):
    """``serve_step`` over two 5-token prompts, its caches advancing in
    place, against the reference's compiled prefill: logits within 1e-5 of
    the largest, the MoE layers' drops included (cap 2 at two rows)."""
    jeng, teng = _pair(arch, None)
    prompts = _prompts(teng.cfg, 2, 5)
    jl, _ = jeng._prefill_jit(jeng._serve_params, jnp.asarray(prompts))
    st = model.init_serve_state(teng._serve_params, teng.cfg, 2, MAX_LEN)
    with torch.no_grad():
        for t in range(5):
            tl, st = model.serve_step(
                teng._serve_params, teng.cfg,
                torch.from_numpy(prompts[:, t:t + 1]).long(), st)
    _close(tl, jl, 1e-5)
    assert int(st.step) == 5


@pytest.mark.parametrize("burst", BURSTS)
@pytest.mark.parametrize("arch", MOE)
def test_generate_matches_reference(arch, burst):
    """Batch 1, batch 2 and four identical prompts on one engine pair:
    tokens and steps exact, every plan's entries and the ledger equal.
    The four identical rows overflow their experts' capacity (cap 2 at
    four rows): rows 2-3 lose their choices, so they differ from rows 0-1,
    in both packages alike."""
    jeng, teng = _pair(arch, burst)
    prompts = _prompts(teng.cfg, 2, 5)
    same = np.repeat(prompts[:1], 4, axis=0)
    for p in (prompts[:1], prompts, same):
        want = jeng.generate(p, max_new=6)
        got = teng.generate(p, max_new=6)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert [r.steps for r in got] == [r.steps for r in want]
    rows = [r.tokens for r in got]
    assert rows[0] == rows[1] and rows[2] == rows[3] and rows[0] != rows[2]
    assert teng._step_captures == 0 and not teng._graphs
    if burst is None:
        return
    assert set(teng._plans.plans) == set(jeng._plans.plans)
    for key, jplan in jeng._plans.plans.items():
        assert _entries(teng._plans.plans[key]) == _entries(jplan), key
    names = {e.name for e in teng._plans.plans[("step", "none", 1)]}
    dense = {"ffn.up", "ffn.gate", "ffn.down"} if arch == "arctic-480b" \
        else set()
    assert names == {"dec.attn.q", "dec.attn.k", "dec.attn.v", "dec.attn.o",
                     "lm_head"} | dense
    assert _stats(teng.offload) == _stats(jeng.offload)
    assert teng.offload.ledger.commits == jeng.offload.ledger.commits
    assert (teng._plans.hits, teng._plans.misses) == \
        (jeng._plans.hits, jeng._plans.misses)


def _requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 7, n)
    budgets = rng.integers(2, 8, n).tolist()
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


@pytest.mark.parametrize("arch", MOE)
def test_scheduler_matches_reference(arch):
    """Six requests over 3 slots, a second wave mid-drain: tokens and the
    event stream equal the reference scheduler's (free rows run the MoE
    layers too and take capacity, in both), and its ledger."""
    jeng, teng = _pair(arch)
    prompts, budgets = _requests(teng.cfg, 6)
    got, gev = _drive(ContinuousBatchingScheduler(teng, n_slots=3),
                      prompts, budgets)
    want, wev = _drive(JaxScheduler(jeng, n_slots=3), prompts, budgets)
    assert got == want and gev == wev
    assert _stats(teng.offload) == _stats(jeng.offload)


def test_scheduler_drops_as_the_reference_pinned():
    """arctic smoke, four identical prompts over 4 slots: cap 2, so two
    rows keep their choices and two lose them. Rows 0-1 give the batch-1
    tokens; rows 2-3 the reference scheduler's other tokens, pinned."""
    jeng, teng = _pair("arctic-480b", None)
    p = np.array([3, 5, 7, 9], np.int32)
    out = []
    for eng, make in ((teng, ContinuousBatchingScheduler),
                      (jeng, JaxScheduler)):
        sched = make(eng, n_slots=4)
        rids = [sched.submit(p, max_new=6) for _ in range(4)]
        res = sched.run()
        out.append([res[r].tokens for r in rids])
    assert out[0] == out[1] == [[488] * 6] * 2 + \
        [[200, 488, 488, 488, 279, 423]] * 2
    assert teng.generate(p[None], max_new=6)[0].tokens == [488] * 6


# ---------------------------------------------------------------------------
# Q8_0: refused where the reference fails
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_q8_0_moe_is_refused_where_the_reference_fails(arch, capsys):
    """The reference quantizes the expert stacks and fails in ``moe_ffn``;
    the port raises ``NotImplementedError`` at the engine's construction,
    before any step (the config's default quant is Q8_0), and the CLI
    refuses Q8_0 and serves ``--quant none``."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    jeng = JaxServeEngine(jcfg, jp, max_len=MAX_LEN, eos_id=None)
    with pytest.raises(AttributeError, match="astype"):
        jeng.generate(_prompts(jcfg, 1, 3), max_new=2)
    for quant in (None, "q8_0"):
        with pytest.raises(NotImplementedError, match="moe.py:121"):
            ServeEngine(tcfg, tp, max_len=MAX_LEN, quant=quant,
                        device="cpu")
    argv = ["--arch", arch, "--device", "cpu", "--power-w", "700",
            "--requests", "2", "--max-new", "3"]
    with pytest.raises(NotImplementedError, match="quant='none'"):
        serve_cli.main(argv)
    assert serve_cli.main(argv + ["--quant", "none", "--offload"]) == 0
    out = capsys.readouterr().out
    assert "req1: 3 tokens" in out and '"ledger_commits": 2' in out


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("drain", ["generate", "continuous"])
def test_spans_match_reference(drain):
    """An olmoe drain: span names (with category and track) and each
    ledger span's FLOPs and calls equal the reference's (the engine's
    linears only, in both), the ledger exact."""
    jeng, teng = _pair("olmoe-1b-7b", telemetry=True)
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
