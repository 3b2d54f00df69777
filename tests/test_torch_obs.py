"""The port's telemetry (``repro_torch.obs`` and its hooks in the serving
path) against the reference's ``repro.obs``, on the CPU at the smoke
config, with identical weights (``convert.py``) and numpy-seeded mels:

- ``percentile`` equals the reference's and numpy's (hypothesis);
- the Prometheus text is byte-equal to the reference's, and the
  ``trace_event`` JSON and the snapshot equal to it, for the same op
  sequence on a virtual clock (hypothesis); phases close and spans nest
  under any lifecycle interleaving; ledger spans refuse to nest;
- the disabled path constructs no ``Telemetry``, ``Tracer`` or ``Span``
  (their constructors patched to raise) through one-shot, continuous,
  paged and speculative-paged drains;
- one-shot, continuous, paged (preemption and prefix sharing) and
  speculative (one-shot and paged, tight arena) drains with telemetry on:
  the ledger exact, every rid closed, the nesting held, the trace valid
  (``tools/check_trace.py``), tokens, every counter, histogram counts,
  the instants in order and the multiset of span names equal the
  reference's, and each ledger span's FLOPs and calls equal the
  reference's span for span, prefills up to the reference's cross-K/V
  quirk (computed exactly);
- ``repro_dispatch_total``: once per linear per program build in the
  port, twice in the reference (its ``record_plan``'s ``eval_shape`` and
  its ``jit`` trace), both computed exactly from the plans;
- the CLI's ``--trace-out`` and ``--metrics-out`` with ``--device cpu``.

Tokens, counts and FLOPs are exact.
"""
import collections
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests._hyp import given, settings, st

from repro import obs as jax_obs
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.models import model as jax_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import obs
from repro_torch.backends import executor
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.offload import OffloadEngine
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import trace as trace_mod
from repro_torch.serve.engine import ServeEngine

N_FRAMES = 8
K = 3
# the reference's plain backend maps to the port's Hopper kernels; the
# host arm is the host arm
BACKEND_NAMES = {"pallas_tpu": "hopper", "xla_ref": "hopper",
                 "host_residual": "host_residual"}
# counters fed from the ledger at snapshot time, and the dispatch
# counter: held by their own exact rules below
LEDGER_FED = ("repro_ledger_flops_total", "repro_ledger_calls_total")
DISPATCH = "repro_dispatch_total"
# ledger spans that hold a prefill, and the engine whose prefill plan
# gives the reference's cross-K/V shortfall
PREFILL_SPANS = {"prefill": "verifier", "spec_prefill": "both",
                 "spec_draft_admit": "draft"}


def _load_check_trace():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "tools", "check_trace.py")
    spec = importlib.util.spec_from_file_location("check_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHECK_TRACE = _load_check_trace()


@pytest.fixture(autouse=True)
def _no_active_handle():
    """Every test starts and ends with no process-global handle in
    either package, so that no drain counts into another's registry."""
    obs.activate(None)
    jax_obs.activate(None)
    yield
    obs.activate(None)
    jax_obs.activate(None)


@pytest.fixture(scope="module")
def ladder():
    jt, jb = jax_smoke_config("whisper-tiny"), jax_smoke_config("whisper-base")
    jtp = jax_model.init_params(jax.random.PRNGKey(0), jt, 64)
    jbp = jax_model.init_params(jax.random.PRNGKey(1), jb, 64)

    def port(p):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, p),
                               device="cpu")
    return dict(jt=jt, jtp=jtp, jb=jb, jbp=jbp,
                tt=get_smoke_config("whisper-tiny"), ttp=port(jtp),
                tb=get_smoke_config("whisper-base"), tbp=port(jbp))


def _mels(n, seed=0, shared=()):
    """``n`` seeded (1, F, n_mels) mels; the indices in ``shared`` repeat
    mel 0 (identical utterances: prefix hits on the paged pool)."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((1, N_FRAMES, 8)).astype(np.float32)
           for _ in range(n)]
    return [out[0] if i in shared else m for i, m in enumerate(out)]


class _VClock:
    """Deterministic strictly increasing clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-6
        return self.t


def _engines(ladder, arch="tiny", quant="q8_0", burst=96, telemetry=True,
             max_len=32):
    """A reference engine and a port engine on the same weights, each with
    its own telemetry (or none) and offload engine (None when ``burst``
    is None)."""
    jcfg, jp, tcfg, tp = (
        (ladder["jt"], ladder["jtp"], ladder["tt"], ladder["ttp"])
        if arch == "tiny" else
        (ladder["jb"], ladder["jbp"], ladder["tb"], ladder["tbp"]))
    joff = (None if burst is None
            else JaxOffloadEngine(prefer_pallas=False, burst=burst))
    toff = None if burst is None else OffloadEngine(burst=burst)
    jtele = jax_obs.Telemetry() if telemetry else None
    ttele = obs.Telemetry() if telemetry else None
    return (JaxServeEngine(jcfg, jp, max_len=max_len, quant=quant,
                           offload=joff, eos_id=-1, telemetry=jtele),
            ServeEngine(tcfg, tp, max_len=max_len, quant=quant,
                        offload=toff, eos_id=-1, device="cpu",
                        telemetry=ttele))


# ---------------------------------------------------------------------------
# the registry, the tracer and the exports on the same op sequence
# ---------------------------------------------------------------------------
@settings(max_examples=100, deadline=None)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6,
                          allow_nan=False, allow_infinity=False),
                min_size=1, max_size=100),
       st.floats(min_value=0, max_value=100))
def test_percentile_matches_reference_and_numpy(values, q):
    got = obs.percentile(values, q)
    assert got == jax_obs.percentile(values, q)
    assert got == pytest.approx(float(np.percentile(values, q)),
                                rel=1e-9, abs=1e-9)


def test_percentile_edges():
    assert obs.percentile([], 50) == 0.0
    assert obs.percentile([3.0], 95) == 3.0
    assert obs.percentile([1, 2, 3, 4], 50) == 2.5


# one op: (kind, rid, value); a lifecycle op applies only where legal,
# mirroring the schedulers (queued -> decode -> finish, or preempt back
# to queued)
_OPS = st.lists(st.tuples(st.integers(0, 8), st.integers(0, 3),
                          st.floats(min_value=0, max_value=1e3,
                                    allow_nan=False)), max_size=50)


def _apply(tele, ops):
    """Drive one Telemetry through ``ops`` and drain it; returns it."""
    state = {}
    for kind, rid, v in ops:
        if rid not in state:
            tele.instant("submit", rid=rid)
            tele.begin(rid, "queued")
            tele.inc("repro_requests_submitted_total")
            state[rid] = "queued"
        if kind == 0 and state[rid] == "queued":
            tele.end(rid, "queued", wait_s=v)
            with tele.span("prefill", cat="lifecycle",
                           track=obs.request_track(rid), rid=rid,
                           ledger=True):
                pass
            tele.begin(rid, "decode")
            state[rid] = "decode"
        elif kind == 1 and state[rid] == "decode":
            tele.instant("preempt", rid=rid)
            tele.inc("repro_preemptions_total")
            tele.end(rid, "decode", preempted=True, steps=int(v))
            tele.begin(rid, "queued")
            state[rid] = "queued"
        elif kind == 2 and state[rid] == "decode":
            tele.instant("evict", rid=rid)
            tele.end(rid, "decode", steps=int(v))
            state.pop(rid)
        elif kind == 3:
            h = tele.ledger_open()
            tele.ledger_close(h, "decode_step", cat="step",
                              args={"active": rid})
            tele.observe("repro_step_seconds", v * 1e-3)
        elif kind == 4:
            tele.observe("repro_queue_wait_seconds", v)
        elif kind == 5:
            tele.gauge("repro_kv_pages_free", v, kind="self")
        elif kind == 6:
            tele.inc("repro_tokens_total", int(v))
        elif kind == 7:
            with tele.span("plan_build", cat="engine",
                           args={"key": str(("step", rid))}):
                tele.inc("repro_dispatch_total", segment="main",
                         backend="hopper", kernel="q8_matvec")
        else:
            tele.instant("spec_trim", pages=rid)
            tele.inc("repro_spec_pages_trimmed_total", rid)
    for rid, phase in sorted(state.items()):
        if phase == "queued":
            tele.end(rid, "queued")
            tele.begin(rid, "decode")
        tele.end(rid, "decode")
    return tele


@settings(max_examples=60, deadline=None)
@given(_OPS)
def test_exports_equal_reference_on_same_ops(ops):
    """Prometheus text byte for byte, trace_event JSON and snapshot equal
    to the reference's on a virtual clock; every phase closed and the
    spans nested under any interleaving of the lifecycle ops."""
    got = _apply(obs.Telemetry(clock=_VClock()), ops)
    want = _apply(jax_obs.Telemetry(clock=_VClock()), ops)
    assert got.metrics.render_prometheus() == \
        want.metrics.render_prometheus()
    assert obs.export.trace_events(got.tracer) == \
        jax_obs.export.trace_events(want.tracer)
    assert json.dumps(got.snapshot(), default=str, sort_keys=True) == \
        json.dumps(want.snapshot(), default=str, sort_keys=True)
    tr = got.tracer
    assert tr.all_closed() and tr.rids_closed == tr.rids_opened
    assert tr.check_nesting() == []
    events = obs.export.trace_events(tr)
    assert CHECK_TRACE.validate(events) == []
    assert not [e for e in events["traceEvents"] if e["ph"] == "B"]
    for h in got.metrics.snapshot()["histograms"].values():
        assert sum(c for _, c in h["buckets"]) == h["count"]


def test_open_phase_exports_dangling_begin_like_reference():
    got, want = (m.Telemetry(clock=_VClock()) for m in (obs, jax_obs))
    for t in (got, want):
        t.begin(0, "queued")
    assert got.tracer.open_phases() == [(0, "queued")]
    ev = obs.export.trace_events(got.tracer)
    assert ev == jax_obs.export.trace_events(want.tracer)
    assert CHECK_TRACE.validate(ev) != []        # the leak is flagged


def test_writers_are_atomic_and_equal_reference(tmp_path):
    ops = [(0, 0, 1.0), (3, 1, 2.0), (2, 0, 3.0), (6, 0, 5.0)]
    got = _apply(obs.Telemetry(clock=_VClock()), ops)
    want = _apply(jax_obs.Telemetry(clock=_VClock()), ops)
    for name in ("t.json", "m.prom"):
        a, b = tmp_path / ("port_" + name), tmp_path / ("ref_" + name)
        if name.endswith(".json"):
            got.write_trace(str(a))
            want.write_trace(str(b))
        else:
            got.write_metrics(str(a))
            want.write_metrics(str(b))
        assert a.read_text() == b.read_text()
    assert sorted(os.listdir(tmp_path)) == ["port_m.prom", "port_t.json",
                                            "ref_m.prom", "ref_t.json"]


def test_ledger_spans_refuse_to_nest():
    tele = obs.Telemetry(clock=_VClock())
    with pytest.raises(RuntimeError, match="double-claim"):
        with tele.span("a", ledger=True):
            with tele.span("b", ledger=True):
                pass
    tele = obs.Telemetry(clock=_VClock())
    h = tele.ledger_open()
    with pytest.raises(RuntimeError, match="double-claim"):
        tele.ledger_open()
    with pytest.raises(RuntimeError, match="double-claim"):
        with tele.span("c", ledger=True):
            pass
    tele.ledger_close(h, "a")
    with tele.span("c", ledger=True):      # the guard is released
        pass
    # an exception inside a ledger span propagates: telemetry catches
    # nothing, and the span still closes
    with pytest.raises(ValueError):
        with tele.span("d", ledger=True):
            raise ValueError("boom")
    assert [s.name for s in tele.tracer.spans] == ["a", "c", "d"]
    assert tele.ledger_consistent()["exact"]


def test_quiet_dispatch_scope_counts_nothing():
    tele = obs.Telemetry()
    obs.activate(tele)
    x = torch.randn(2, 64)
    w = torch.randn(16, 64)
    executor.matmul(x, w, burst=32)
    with executor.quiet_dispatch():
        executor.matmul(x, w, burst=32)
        with executor.quiet_dispatch():
            executor.matmul(x, w, burst=32)
    executor.matmul(x, w, burst=32)
    c = tele.metrics.counter(DISPATCH)
    assert c.series() == {
        '{backend="hopper",kernel="bf16_matmul",segment="main"}': 2.0}
    obs.activate(None)
    executor.matmul(x, w, burst=32)            # no handle: a no-op
    assert c.value(backend="hopper", kernel="bf16_matmul",
                   segment="main") == 2.0


def test_eager_linear_claims_on_the_active_handle(ladder):
    """Eager ``OffloadEngine.linear`` accounts land outside any span and
    are claimed, so the attribution stays exact under mixed eager and
    program use; a foreign ledger claims nothing."""
    _, eng = _engines(ladder)
    tele = eng.telemetry
    x, w = torch.randn(3, 64), torch.randn(32, 64)
    eng.offload.linear(x, w, name="probe")
    OffloadEngine(burst=96).linear(x, w)       # another ledger
    eng.transcribe(_mels(1)[0], max_new=2)
    cons = tele.ledger_consistent()
    assert cons["exact"] and cons["claimed_calls"] == cons["ledger_calls"]
    assert tele.claimed_calls >= 1


# ---------------------------------------------------------------------------
# the disabled path allocates no obs object
# ---------------------------------------------------------------------------
def _bomb(*a, **k):
    raise AssertionError("obs object constructed on the disabled path")


@pytest.mark.parametrize("drain", ["transcribe", "continuous", "paged",
                                   "spec_paged"])
def test_disabled_path_constructs_no_obs_object(ladder, monkeypatch, drain):
    monkeypatch.setattr(obs.Telemetry, "__init__", _bomb)
    monkeypatch.setattr(trace_mod.Tracer, "__init__", _bomb)
    monkeypatch.setattr(trace_mod.Span, "__init__", _bomb)
    monkeypatch.setattr(trace_mod._SpanCtx, "__init__", _bomb)
    arch = "base" if drain.startswith("spec") else "tiny"
    _, eng = _engines(ladder, arch=arch, telemetry=False)
    mels = _mels(4, shared=(2,))
    if drain == "transcribe":
        res = eng.transcribe(np.concatenate(mels[:2]), max_new=3)
        assert [len(r.tokens) for r in res] == [3, 3]
        return
    if drain == "continuous":
        sch = eng.scheduler(2, N_FRAMES)
    elif drain == "paged":
        sch = eng.paged_scheduler(3, N_FRAMES, page_size=4, n_pages=5)
    else:
        spec = eng.speculative(ladder["tt"], ladder["ttp"], k=K)
        sch = spec.paged(3, N_FRAMES, page_size=4, n_pages=7,
                         cross_page_size=N_FRAMES, n_cross_pages=4)
    rids = [sch.submit(m, max_new=6) for m in mels]
    res = sch.run()
    assert set(res) == set(rids)
    assert all(len(r.tokens) == 6 for r in res.values())
    if drain == "paged":
        assert sch.preemptions > 0 and sch.shared_hits > 0


# ---------------------------------------------------------------------------
# instrumented drains against the reference's
# ---------------------------------------------------------------------------
def _cross_extra(eng, b):
    """(FLOPs, calls) of one batch-``b`` prefill's ``dec.cross.k``/``.v``
    linears that the reference's plan leaves out: its ``vmap`` over layers
    records them once, the port records every layer's."""
    plan = eng._plans.plans[eng._key("prefill", b, N_FRAMES)]
    cross = [e for e in plan if e.name.startswith("dec.cross")]
    keep = eng.cfg.num_layers
    return (sum(e.flops for e in cross) * (keep - 1) // keep,
            len(cross) * (keep - 1) // keep)


def _drive(drain, jeng, teng, ladder):
    """The same trace through both engines; returns per package its
    tokens by rid, the scheduler (or None) and the spec engine (or
    None)."""
    out = []
    for eng in (jeng, teng):
        spec = sch = None
        if drain == "transcribe":
            res = eng.transcribe(np.concatenate(_mels(2)), max_new=4)
            res += eng.transcribe(np.concatenate(_mels(2, seed=1)),
                                  max_new=3)
            toks = {i: r.tokens for i, r in enumerate(res)}
        elif drain == "spec_oneshot":
            dcfg, dp = ((ladder["jt"], ladder["jtp"]) if eng is jeng
                        else (ladder["tt"], ladder["ttp"]))
            spec = eng.speculative(dcfg, dp, k=K)
            res = spec.transcribe(np.concatenate(_mels(2)), max_new=6)
            toks = {i: r.tokens for i, r in enumerate(res)}
        else:
            mels = _mels(6, shared=(3, 5))
            budgets = np.random.default_rng(7).integers(3, 10, 6).tolist()
            if drain == "continuous":
                sch = eng.scheduler(2, N_FRAMES)
            elif drain == "paged":
                sch = eng.paged_scheduler(3, N_FRAMES, page_size=4,
                                          n_pages=6)
            else:
                dcfg, dp = ((ladder["jt"], ladder["jtp"]) if eng is jeng
                            else (ladder["tt"], ladder["ttp"]))
                spec = eng.speculative(dcfg, dp, k=K)
                sch = spec.paged(3, N_FRAMES, page_size=4, n_pages=7,
                                 cross_page_size=N_FRAMES, n_cross_pages=4)
            rids = [sch.submit(m, max_new=n) for m, n in zip(mels, budgets)]
            # three admitted and one step before the rest queue up
            sch.admit()
            sch.decode_step()
            res = sch.run()
            assert set(res) == set(rids)
            toks = {r: v.tokens for r, v in res.items()}
        out.append((toks, sch, spec))
    return out


def _ledger_spans(tele):
    return [(s.name, s.args["flops"], s.args["calls"])
            for s in tele.tracer.spans if "flops" in s.args]


DRAINS = ["transcribe", "continuous", "paged", "spec_oneshot", "spec_paged"]


@pytest.mark.parametrize("drain", DRAINS)
def test_drain_matches_reference(ladder, drain, tmp_path):
    arch = "base" if drain.startswith("spec") else "tiny"
    jeng, teng = _engines(ladder, arch=arch, max_len=32)
    (jtoks, jsch, jspec), (ttoks, tsch, tspec) = _drive(drain, jeng, teng,
                                                       ladder)
    assert ttoks == jtoks
    jt, tt = jeng.telemetry, teng.telemetry
    tr = tt.tracer

    # the invariants
    cons = tt.ledger_consistent()
    assert cons["exact"], cons
    assert cons["claimed_flops"] > 0 and cons["claimed_calls"] > 0
    assert jt.ledger_consistent()["exact"]
    assert tr.all_closed() and tr.open_phases() == []
    assert tr.rids_closed == tr.rids_opened == jt.tracer.rids_closed
    if tsch is not None:
        assert tr.rids_closed == set(ttoks)
    assert tr.check_nesting() == []
    path = tt.write_trace(str(tmp_path / "t.json"))
    with open(path) as f:
        assert CHECK_TRACE.validate(json.load(f)) == []
    snap = tt.snapshot()
    json.dumps(snap, default=str)
    for h in snap["metrics"]["histograms"].values():
        assert sum(c for _, c in h["buckets"]) == h["count"]
    if drain in ("paged", "spec_paged"):
        assert tsch.preemptions > 0 and tsch.preemptions == jsch.preemptions
        names = {e.name for e in tr.events}
        assert {"preempt", "replay"} <= names
        assert tt.metrics.counter("repro_preemptions_total").value() == \
            tsch.preemptions
    if drain == "paged":
        assert tsch.shared_hits > 0
        assert "prefix_hit" in {e.name for e in tr.events}

    # counters, histogram counts, instants and span names: the reference's
    tm, jm = tt.metrics.snapshot(), jt.metrics.snapshot()
    assert set(tm["counters"]) == set(jm["counters"])
    for name in tm["counters"]:
        if name not in LEDGER_FED + (DISPATCH,):
            assert tm["counters"][name] == jm["counters"][name], name
    for name in tm["histograms"]:
        assert tm["histograms"][name]["count"] == \
            jm["histograms"][name]["count"], name
    assert [(e.name, e.track, e.args) for e in tr.events] == \
        [(e.name, e.track, e.args) for e in jt.tracer.events]
    assert collections.Counter((s.name, s.cat, s.track) for s in tr.spans) \
        == collections.Counter((s.name, s.cat, s.track)
                               for s in jt.tracer.spans)

    # each ledger span's FLOPs and calls, span for span, prefills up to
    # the reference's cross-K/V shortfall
    b = 2 if drain in ("transcribe", "spec_oneshot") else 1
    extra = {"verifier": _cross_extra(teng, b)}
    if tspec is not None:
        extra["draft"] = _cross_extra(tspec.draft, b)
        extra["both"] = tuple(a + c for a, c in zip(extra["verifier"],
                                                     extra["draft"]))
    got, want = _ledger_spans(tt), _ledger_spans(jt)
    assert len(got) == len(want)
    for (name, f, c), (jname, jf, jc) in zip(got, want):
        assert name == jname
        ef, ec = extra[PREFILL_SPANS[name]] if name in PREFILL_SPANS \
            else (0, 0)
        assert (f - jf, c - jc) == (ef, ec), name

    # the ledger-fed counters expose the port's own ledger
    s = teng.offload.stats
    lf = tt.metrics.counter("repro_ledger_flops_total")
    assert lf.value(kind="offloaded") == s.offloaded_flops
    assert lf.value(device="dev0") == \
        s.offloaded_flops + s.fallback_flops + s.residual_flops
    assert sum(lf.value(role=r) for r in s.by_role) == \
        lf.value(device="dev0")
    lc = tt.metrics.counter("repro_ledger_calls_total")
    assert {k: lc.value(backend=k) for k in s.by_backend} == s.by_backend


# ---------------------------------------------------------------------------
# repro_dispatch_total: once per build here, twice in the reference
# ---------------------------------------------------------------------------
def _dispatch_from_plans(eng, names=lambda b: b):
    """The dispatches of one run of every program the engine planned:
    each entry's main segment (its backend) and its residual (the host
    arm), by kernel."""
    c = collections.Counter()
    for plan in eng._plans.plans.values():
        for e in plan:
            if e.k_main:
                c[("main", names(e.backend), e.kernel)] += 1
            if e.k_res:
                c[("residual", "host_residual", e.kernel)] += 1
    return c


def _dispatch_series(tele):
    c = tele.metrics.counter(DISPATCH)
    return collections.Counter(
        {(dict(k)["segment"], dict(k)["backend"], dict(k)["kernel"]): int(v)
         for k, v in c._values.items()})


@pytest.mark.parametrize("drain", ["transcribe", "continuous", "paged"])
def test_dispatch_total_once_per_build(ladder, drain):
    """The port counts each linear once per program build (a key's first
    run on the CPU, a capture's warm-up on the card); the reference counts
    it twice, once in ``record_plan``'s ``eval_shape`` and once in the
    ``jit`` trace. Both are computed exactly from the plans, and they
    differ, beyond the factor 2, by the cross-K/V linears the reference's
    plan records once instead of once a layer."""
    jeng, teng = _engines(ladder)
    _drive(drain, jeng, teng, ladder)
    got, want = _dispatch_series(teng.telemetry), \
        _dispatch_series(jeng.telemetry)
    port = _dispatch_from_plans(teng)
    ref = _dispatch_from_plans(jeng, BACKEND_NAMES.get)
    assert {s for s, _, _ in got} == {"main", "residual"}
    assert got == port
    assert want == collections.Counter(
        {(s, b, k): 2 * v
         for (s, b, k), v in _dispatch_from_plans(jeng).items()})
    b = 2 if drain == "transcribe" else 1
    plan = teng._plans.plans[teng._key("prefill", b, N_FRAMES)]
    layers = teng.cfg.num_layers
    extra = collections.Counter()
    for e in plan:
        if e.name.startswith("dec.cross"):
            if e.k_main:
                extra[("main", e.backend, e.kernel)] += 1
            if e.k_res:
                extra[("residual", "host_residual", e.kernel)] += 1
    extra = collections.Counter({k: v * (layers - 1) // layers
                                 for k, v in extra.items()})
    assert port - ref == extra and not ref - port


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [[], ["--continuous", "--slots", "2"],
                                  ["--speculative", "-k", "3"]],
                         ids=["oneshot", "continuous", "speculative"])
def test_cli_trace_and_metrics_out(capsys, tmp_path, mode):
    arch = "whisper-base" if "--speculative" in mode else "whisper-tiny"
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    assert serve_cli.main(["--arch", arch, "--offload", "--device", "cpu",
                           "--power-w", "700", "--requests", "2",
                           "--max-new", "3", "--trace-out", str(trace),
                           "--metrics-out", str(prom)] + mode) == 0
    out = capsys.readouterr().out
    assert f"trace written: {trace}" in out
    assert f"metrics written: {prom}" in out
    with open(trace) as f:
        assert CHECK_TRACE.validate(json.load(f)) == []
    text = prom.read_text()
    assert "# TYPE repro_dispatch_total counter" in text
    assert "repro_ledger_flops_total{device=\"dev0\"}" in text
    report = json.loads(out[out.rindex("\n{") + 1:])
    tele = report["telemetry"]
    assert tele["ledger_consistency"]["exact"]
    assert tele["ledger_consistency"]["claimed_flops"] > 0
    assert tele["trace"]["open_phases"] == []
    assert tele["trace"]["requests_closed"] == \
        (2 if "--continuous" in mode else 0)
    obs.activate(None)
    # either flag alone turns telemetry on; neither leaves it off
    assert serve_cli.main(["--arch", "whisper-tiny", "--device", "cpu",
                           "--power-w", "700", "--requests", "1",
                           "--max-new", "2", "--metrics-out",
                           str(tmp_path / "only.prom")]) == 0
    out = capsys.readouterr().out
    assert "telemetry" in json.loads(out[out.rindex("\n{") + 1:])
    assert serve_cli.main(["--arch", "whisper-tiny", "--device", "cpu",
                           "--power-w", "700", "--requests", "1",
                           "--max-new", "2"]) == 0
    out = capsys.readouterr().out
    assert "telemetry" not in json.loads(out[out.rindex("\n{") + 1:])
