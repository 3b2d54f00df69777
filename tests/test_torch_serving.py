"""The serving engine's programs and accounting against the reference, on
the CPU at the smoke config, with identical weights (``convert.py``) and a
numpy-seeded mel:

- the static-buffer prefill and step programs, called directly on the CPU
  (on a card they are the bodies of the captured graphs), give the
  reference's greedy tokens on Q8_0 and dense, with no offload engine and
  at bursts 256 and 32, for two requests in a row on one engine;
- the device-length ``KVCache`` gives the reference's logits step by step,
  advancing in place (the same storage every step);
- ``plan_key``, ``PlanCache``, the plans' summaries, the ledger after N
  requests (``commit(plan, times)``), the offload rates and
  ``energy_report`` against the reference's engine.

Tolerance 1e-4 on logits (f32 smoke config: the frameworks sum in another
order; observed about 1e-6). Tokens and counts are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.core.plan import DispatchPlan as JaxDispatchPlan
from repro.core.plan import PlanCache as JaxPlanCache
from repro.core.plan import plan_key as jax_plan_key
from repro.models import model as jax_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import DispatchPlan, PlanCache, plan_key
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("whisper-tiny")
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg, 64)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    mel = np.random.default_rng(0).standard_normal(
        (2, 16, jcfg.n_mels)).astype(np.float32)
    return jcfg, jparams, get_smoke_config("whisper-tiny"), tparams, mel


def _engines(burst):
    if burst is None:
        return None, None
    return JaxOffloadEngine(prefer_pallas=False, burst=burst), \
        OffloadEngine(burst=burst)


@pytest.mark.parametrize("quant", ["q8_0", "none"])
@pytest.mark.parametrize("burst", [None, 256, 32])
def test_programs_give_reference_tokens_twice(smoke, quant, burst):
    """Two requests in a row on one engine: the second starts from the
    buffers the first left, which the prefill program resets."""
    jcfg, jparams, tcfg, tparams, mel = smoke
    jeng, teng = _engines(burst)
    want = JaxServeEngine(jcfg, jparams, max_len=64, quant=quant,
                          offload=jeng).transcribe(mel, max_new=8)
    te = ServeEngine(tcfg, tparams, max_len=64, quant=quant, offload=teng,
                     device="cpu")
    for _ in range(2):
        got = te.transcribe(mel, max_new=8)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert [r.steps for r in got] == [r.steps for r in want]
    assert te._step_captures == 0 and not te._graphs    # nothing captured


@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_device_length_cache_gives_reference_logits(smoke, quant):
    """The static buffers after the prefill program, then teacher-forced
    steps: logits within 1e-4 of the reference's, lengths and ``step``
    advanced on the device in place, and every buffer the same storage."""
    jcfg, jparams, tcfg, tparams, mel = smoke
    je = JaxServeEngine(jcfg, jparams, max_len=16, quant=quant)
    te = ServeEngine(tcfg, tparams, max_len=16, quant=quant, device="cpu")
    _, jst = je._prefill_jit(je._serve_params, jnp.asarray(mel))
    st = te._static_for(2, 16)
    st.mel.copy_(torch.from_numpy(mel))
    te._prefill_fn(st)
    ls = st.state.layer_states
    ptrs = [t.data_ptr() for kv in ls.self_kv for t in kv] + \
        [st.state.step.data_ptr()]
    for i, tok in enumerate((1, 5, 7, 11)):
        jlog, jst = je._decode_jit(je._serve_params,
                                   jnp.full((2, 1), tok, jnp.int32), jst)
        tlog, state = model.serve_step(te._serve_params, tcfg,
                                       torch.full((2, 1), tok), st.state)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert state.step is st.state.step
        assert int(st.state.step) == i + 1
        assert [int(kv.length) for kv in ls.self_kv] == \
            [i + 1] * tcfg.num_layers
        assert all(kv.length.dtype == torch.int32 for kv in ls.self_kv)
    assert [t.data_ptr() for kv in ls.self_kv for t in kv] + \
        [st.state.step.data_ptr()] == ptrs


def test_kv_cache_full_raises_before_the_step(smoke):
    _, _, tcfg, tparams, mel = smoke
    te = ServeEngine(tcfg, tparams, max_len=2, device="cpu")
    with pytest.raises(ValueError, match="KV cache full"):
        te.transcribe(mel, max_new=3)
    _, state = te.prefill(torch.from_numpy(mel))
    for tok in (1, 2):
        _, state = te.step(torch.full((2, 1), tok), state)
    with pytest.raises(ValueError, match="KV cache full"):
        te.step(torch.full((2, 1), 3), state)
    assert int(state.step) == 2


@pytest.mark.parametrize("args", [("prefill", "q8_0", 2, 16),
                                  ("step", "none", 1, 1500),
                                  ("step", None, 4), ("prefill", "q8_0", 1)])
def test_plan_key_matches_reference(args):
    assert plan_key(*args) == jax_plan_key(*args)


def test_plan_cache_hits_a_repeated_key_and_misses_a_new_one():
    cache, ref = PlanCache(), JaxPlanCache()
    built = []

    def build():
        built.append(1)
        return DispatchPlan()

    for key in ("a", "a", "b", "a"):
        plan = cache.get_or_build(key, build)
        ref.get_or_build(key, JaxDispatchPlan)
        assert plan.key == key
    assert (cache.hits, cache.misses, len(cache)) == (2, 2, 2)
    assert (ref.hits, ref.misses, len(ref)) == (2, 2, 2)
    assert len(built) == 2


def _snapshot(stats):
    return dataclasses.asdict(stats)


@pytest.mark.parametrize("burst", [256, 32])
def test_ledger_after_n_requests_matches_reference(smoke, burst):
    """After three requests the ledger, accounted only by plan commits,
    holds three times one request's totals, and equals the reference's up
    to its one quirk: its plan traces ``precompute_cross_kv``'s ``vmap``
    over layers once, so it records ``dec.cross.k``/``dec.cross.v`` once per
    prefill where the port runs, and records, every layer. Plan cache and
    commit counters equal the reference's."""
    jcfg, jparams, tcfg, tparams, mel = smoke
    jeng, teng = _engines(burst)
    je = JaxServeEngine(jcfg, jparams, max_len=64, offload=jeng, eos_id=-1)
    te = ServeEngine(tcfg, tparams, max_len=64, offload=teng, eos_id=-1,
                     device="cpu")
    n = 3
    je.transcribe(mel, max_new=3)
    te.transcribe(mel, max_new=3)
    one = _snapshot(teng.stats)
    for _ in range(n - 1):
        je.transcribe(mel, max_new=3)
        te.transcribe(mel, max_new=3)
    a, b = _snapshot(teng.stats), _snapshot(jeng.stats)
    assert a == {k: ({kk: vv * n for kk, vv in v.items()}
                     if isinstance(v, dict) else v * n)
                 for k, v in one.items()}
    layers = tcfg.num_layers
    extra = layers - 1
    cross = te._plans.plans[("prefill", "q8_0", 2, 16)].entries[-2:]
    assert a["offloaded_calls"] == b["offloaded_calls"] + n * 2 * extra
    assert a["fallback_calls"] == b["fallback_calls"]
    for f in ("offloaded_flops", "residual_flops", "fallback_flops"):
        assert a[f] == b[f] + n * extra * sum(getattr(e, f) for e in cross)
    assert a["by_kernel"] == {
        k: v * (layers if k.startswith("dec.cross") else 1)
        for k, v in b["by_kernel"].items()}
    assert teng.ledger.commits == jeng.ledger.commits == 2 * n
    assert (te._plans.hits, te._plans.misses, len(te._plans)) == \
        (je._plans.hits, je._plans.misses, len(je._plans))
    step = ("step", "q8_0", 2, 16)
    tplan, jplan = te._plans.plans[step], je._plans.plans[step]
    assert tplan.summary() == jplan.summary() and len(tplan) == len(jplan)
    assert tplan.signature() == tuple(tplan.entries)


def test_offload_rates_match_reference():
    """Eager calls with one capacity fallback (offload=False)."""
    rng = np.random.default_rng(0)
    port = OffloadEngine(vmem_budget_kb=64)
    ref = JaxOffloadEngine(vmem_budget_kb=64, prefer_pallas=False)
    for m, k, n in [(1, 384, 384), (40, 384, 64), (2000, 64, 32)]:
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
        port.linear(torch.from_numpy(x), torch.from_numpy(w))
        ref.linear(jnp.asarray(x), jnp.asarray(w))
    a, b = port.stats, ref.stats
    assert a.fallback_calls == b.fallback_calls == 1
    assert a.offload_rate() == b.offload_rate()
    assert a.offload_flop_rate() == pytest.approx(b.offload_flop_rate(),
                                                  rel=1e-12)
    assert OffloadEngine().stats.offload_rate() == 0.0


def test_energy_report_matches_reference(smoke):
    jcfg, jparams, tcfg, tparams, mel = smoke
    jeng, teng = _engines(256)
    je = JaxServeEngine(jcfg, jparams, max_len=64, offload=jeng, eos_id=-1)
    te = ServeEngine(tcfg, tparams, max_len=64, offload=teng, eos_id=-1,
                     device="cpu")
    jres = je.transcribe(mel, max_new=3) + je.transcribe(mel, max_new=3)
    tres = te.transcribe(mel, max_new=3) + te.transcribe(mel, max_new=3)
    got = te.energy_report(tres, 700.0)
    want = je.energy_report(jres, 700.0)
    assert set(got) == {"requests", "total_s", "mean_s", "pdp_j", "edp_js",
                        "offload_rate", "dispatch"}
    assert set(got["dispatch"]) == set(want["dispatch"]) == {
        "plans", "plan_hits", "plan_misses", "ledger_commits", "by_backend",
        "by_role", "by_device"}
    for key in ("plans", "plan_hits", "plan_misses", "ledger_commits"):
        assert got["dispatch"][key] == want["dispatch"][key], key
    s = teng.stats
    assert got["dispatch"]["by_device"] == {
        "dev0": s.offloaded_flops + s.fallback_flops + s.residual_flops}
    assert set(got["dispatch"]["by_role"]) == set(
        want["dispatch"]["by_role"]) == {"main"}
    assert got["dispatch"]["by_role"]["main"] == \
        s.offloaded_flops + s.fallback_flops + s.residual_flops
    assert got["requests"] == want["requests"] == 4
    assert got["offload_rate"] == want["offload_rate"]
    total = sum(r.total_s for r in tres)
    assert got["total_s"] == total and got["mean_s"] == total / 4
    assert got["pdp_j"] == total * 700.0
    assert got["edp_js"] == total * 700.0 * total
    bare = ServeEngine(tcfg, tparams, max_len=64, device="cpu")
    rep = bare.energy_report(bare.transcribe(mel, max_new=2), 50.0)
    assert "dispatch" not in rep and rep["offload_rate"] == 0.0
    with pytest.raises(TypeError):
        te.energy_report(tres)          # no default power
