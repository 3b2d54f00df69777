"""Telemetry on a CUDA device: the serving paths with ``Telemetry()``
compute exactly what they compute without it. Telemetry-on tokens equal
telemetry-off tokens and a batch-1 ``transcribe``'s, with one slot-step
capture a pool and the same kernel launches from Python at the captures;
the ledger is exact and every rid closed on the card (one-shot,
continuous, paged with preemption and prefix sharing, speculative
paged); the trace passes ``tools/check_trace.py``; the dispatch counter
moves once per linear per capture; and telemetry adds no host sync: a
drive makes the same ``.tolist()``, ``.item()``, ``.cpu()``,
``bool()`` and ``torch.cuda.synchronize`` calls with it as without it.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_obs_gpu.py
"""
import collections
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.kernels import bf16_matmul, q8_matmul, q8_matvec
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine

COUNTED = (q8_matmul.q8_matmul, q8_matvec.q8_matvec, bf16_matmul.bf16_matmul)
F_SMOKE = 16


def _check_trace():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(root, "tools", "check_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


@pytest.fixture(autouse=True)
def _no_active_handle():
    obs.activate(None)
    yield
    obs.activate(None)


def _engine(dev, telemetry, full=False, arch="whisper-tiny", max_len=24,
            seed=0):
    cfg = get_config(arch) if full else get_smoke_config(arch)
    params = model.init_params(torch.Generator().manual_seed(seed), cfg,
                               device="cpu")
    return ServeEngine(cfg, params, max_len=max_len, quant="q8_0",
                       offload=OffloadEngine(), eos_id=-1, device=dev,
                       telemetry=obs.Telemetry() if telemetry else None)


def _mels(cfg, n, f, seed=1, shared=()):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((1, f, cfg.n_mels)).astype(np.float32)
           for _ in range(n)]
    return [out[0] if i in shared else m for i, m in enumerate(out)]


def _launches():
    return [fn.launches for fn in COUNTED]


def _drain(sched, mels, max_news):
    rids = [sched.submit(m, max_new=n) for m, n in zip(mels, max_news)]
    sched.admit()
    sched.decode_step()
    res = sched.run()
    return [res[r].tokens for r in rids]


def _invariants(tele, rids=None):
    cons = tele.ledger_consistent()
    assert cons["exact"], cons
    assert cons["claimed_flops"] > 0
    tr = tele.tracer
    assert tr.all_closed() and tr.open_phases() == []
    assert tr.check_nesting() == []
    if rids is not None:
        assert tr.rids_closed == tr.rids_opened == set(rids)
    assert _check_trace().validate(obs.export.trace_events(tr)) == []
    for h in tele.metrics.snapshot()["histograms"].values():
        assert sum(c for _, c in h["buckets"]) == h["count"]


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_telemetry_changes_no_token_and_no_capture(full):
    """A slot pool drained with telemetry on and off: the same tokens,
    each a batch-1 ``transcribe``'s, one slot-step capture a pool and the
    same kernel launches from Python (the captures' runs)."""
    dev = _cuda_or_skip()
    f = 1500 if full else F_SMOKE
    out = {}
    for on in (False, True):
        eng = _engine(dev, on, full=full)
        mels = _mels(eng.cfg, 6, f)
        budgets = [5, 9, 3, 7, 4, 6]
        caps0, l0 = eng._step_captures, _launches()
        sched = eng.scheduler(4, f)
        toks = _drain(sched, mels, budgets)
        caps = eng._step_captures - caps0
        launched = [b - a for a, b in zip(l0, _launches())]
        ref = [eng.transcribe(m, max_new=n)[0].tokens
               for m, n in zip(mels, budgets)]
        assert toks == ref
        out[on] = (toks, caps, launched)
        if on:
            _invariants(eng.telemetry, rids=range(6))
            steps = [s for s in eng.telemetry.tracer.spans
                     if s.name == "decode_step"]
            assert len(steps) == eng.telemetry.metrics.histogram(
                "repro_step_seconds").count > 0
    assert out[True] == out[False]
    assert out[True][1] == 1


@pytest.mark.gpu
def test_transcribe_spans_and_dispatch_once_per_capture():
    """One-shot ``transcribe`` twice at one key: ``plan_build`` spans for
    the two captures only, ``prefill`` and ``decode`` ledger spans a
    request, the ledger exact; the dispatch counter equals one run of each
    captured program's plan."""
    dev = _cuda_or_skip()
    eng = _engine(dev, True)
    mel = np.concatenate(_mels(eng.cfg, 2, F_SMOKE))
    a = eng.transcribe(mel, max_new=5)
    b = eng.transcribe(mel, max_new=5)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    tele = eng.telemetry
    _invariants(tele)
    names = collections.Counter(s.name for s in tele.tracer.spans)
    assert names == {"plan_build": 2, "prefill": 2, "decode": 2}
    want = collections.Counter()
    for prog in eng._graphs.values():
        for e in prog.plan:
            if e.k_main:
                want[("main", e.backend, e.kernel)] += 1
            if e.k_res:
                want[("residual", "host_residual", e.kernel)] += 1
    got = collections.Counter({
        (dict(k)["segment"], dict(k)["backend"], dict(k)["kernel"]): int(v)
        for k, v in tele.metrics.counter(
            "repro_dispatch_total")._values.items()})
    assert got == want and sum(got.values()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("drain", ["paged", "spec_paged"])
def test_paged_and_speculative_exact_on_the_card(drain):
    """The tight paged pool (preemptions, prefix hits, replays) and the
    speculative paged scheduler with telemetry: tokens equal batch-1
    ``transcribe``'s, the ledger exact, every rid closed, the trace
    valid, the preemption counter equal to the scheduler's."""
    dev = _cuda_or_skip()
    arch = "whisper-base" if drain == "spec_paged" else "whisper-tiny"
    eng = _engine(dev, True, arch=arch, max_len=32, seed=1)
    mels = _mels(eng.cfg, 6, F_SMOKE, shared=(3, 5))
    budgets = [5, 9, 3, 7, 4, 6]
    if drain == "paged":
        sched = eng.paged_scheduler(3, F_SMOKE, page_size=4, n_pages=6,
                                    cross_page_size=F_SMOKE,
                                    n_cross_pages=4)
    else:
        dcfg = get_smoke_config("whisper-tiny")
        dparams = model.init_params(torch.Generator().manual_seed(0), dcfg,
                                    device="cpu")
        spec = eng.speculative(dcfg, dparams, k=3)
        sched = spec.paged(3, F_SMOKE, page_size=4, n_pages=7,
                           cross_page_size=F_SMOKE, n_cross_pages=4)
    toks = _drain(sched, mels, budgets)
    assert sched.preemptions > 0
    tele = eng.telemetry
    _invariants(tele, rids=range(6))
    assert tele.metrics.counter("repro_preemptions_total").value() == \
        sched.preemptions
    events = {e.name for e in tele.tracer.events}
    assert {"preempt", "replay"} <= events
    if drain == "paged":
        assert "prefix_hit" in events
    else:
        assert "spec_round" in {s.name for s in tele.tracer.spans}
        # the scheduler's rounds feed the step gauge with the window's
        # captures, as the reference's feed it its verify traces
        assert tele.metrics.gauge("repro_step_traces").value() == \
            spec.verifier._verify_captures == 1
    ref = [eng.transcribe(m, max_new=n)[0].tokens
           for m, n in zip(mels, budgets)]
    assert toks == ref


class _Calls:
    """Counts the host reads and syncs a drive makes."""

    def __init__(self, monkeypatch):
        self.n = collections.Counter()
        for name in ("tolist", "item", "cpu", "__bool__"):
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._wrap(name, orig))
        monkeypatch.setattr(torch.cuda, "synchronize", self._wrap(
            "synchronize", torch.cuda.synchronize))

    def _wrap(self, name, orig):
        def f(*a, **k):
            self.n[name] += 1
            return orig(*a, **k)
        return f


@pytest.mark.gpu
def test_telemetry_adds_no_host_sync(monkeypatch):
    """A warm pool drains the same trace with telemetry on and off: the
    same count of every host read and sync, per call site kind."""
    dev = _cuda_or_skip()
    counts = {}
    for on in (False, True):
        eng = _engine(dev, on)
        mels = _mels(eng.cfg, 6, F_SMOKE)
        budgets = [5, 9, 3, 7, 4, 6]
        sched = eng.scheduler(4, F_SMOKE)
        _drain(sched, mels, budgets)               # captures, warm
        with monkeypatch.context() as m:
            calls = _Calls(m)
            toks = _drain(sched, mels, budgets)
            eng.transcribe(np.concatenate(mels[:2]), max_new=4)
        counts[on] = (toks, dict(calls.n))
    assert counts[True] == counts[False]
    assert counts[True][1]["tolist"] > 0
