"""The port's autotuner and calibrated cost model (``repro_torch.tuning``)
against the reference's (``repro.tuning``), on the CPU at the smoke size:

- ``fit``, ``trimmed_mean`` and ``rank_correlation`` give the reference's
  values on the same numpy samples (rel 1e-12: the same float64 numpy);
- with the same tuning records in both packages' caches (bursts copied,
  each port record holding the kernel's untuned launch), ``plan_linear``
  entries agree on burst, tuned, k_main, k_res and offload, the backend
  mapped by name; tuned smoke-config ``transcribe`` is token-exact with
  the reference's tuned ``transcribe`` on Q8_0 and dense, with the same
  plans and tuned-call counts;
- ``warm_tuning`` tunes as many distinct shapes as the reference's;
- the Hopper space is admissible and deterministic and every pick lies in
  its own space (hypothesis cases through ``tests/_hyp.py``, with fixed
  examples beside them); the stores round-trip and refuse a foreign
  schema, a cache of the JAX package among them;
- ``REGISTRY.force`` pins a main segment where a backend can take it, and
  the reference's ``REPRO_BACKEND`` (its CI sets ``xla_ref`` for a whole
  process) leaves the port's routing alone; ``Autotuner()`` needs a card unless ``device="cpu"`` is passed; the
  ``KVCache.zeros`` and ``zeros_decode_state`` constructors need a device.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core import bursts as jax_bursts
from repro.core import mixed_exec as jax_mixed
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.core.plan import plan_linear as jax_plan_linear
from repro.models import model as jax_model
from repro.models.whisper import warm_tuning as jax_warm_tuning
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.tuning import Autotuner as JaxAutotuner
from repro.tuning import CalibratedCoefficients as JaxCalibration
from repro.tuning import BackendCoefficients as JaxCoefficients
from repro.tuning import TuningCache as JaxTuningCache
from repro.tuning import TuningKey as JaxTuningKey
from repro.tuning import TuningRecord as JaxTuningRecord
from repro.tuning import calibrate as jax_calibrate
from repro.tuning.replay import trimmed_mean as jax_trimmed_mean
from repro_torch.backends import REGISTRY, executor
from repro_torch.backends.base import MAIN, RESIDUAL, KernelRequest
from repro_torch.backends.hopper import HopperBackend
from repro_torch.backends.host_residual import HostResidualBackend
from repro_torch.backends.registry import BackendRegistry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import bursts, mixed_exec
from repro_torch.core.coverage import MulMat
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import DispatchPlan, plan_linear
from repro_torch.core.qformats import quantize_q8_0
from repro_torch.kernels import tiles
from repro_torch.kernels.bf16_matmul import bf16_matmul, bf16_matmul_plain
from repro_torch.kernels.q8_matmul import q8_matmul, q8_matmul_plain
from repro_torch.kernels.q8_matvec import q8_matvec, q8_matvec_plain
from repro_torch.models import whisper as whisper_lib
from repro_torch.models.attention import KVCache
from repro_torch.serve.engine import ServeEngine
from repro_torch.tuning import (
    Autotuner, BackendCoefficients, CalibratedCoefficients, TuningCache,
    TuningKey, TuningRecord, analytic_cost, analytic_features, budget_grid,
    calibrate, default_candidate, enumerate_candidates, fit_backend,
    make_operands, rank_correlation, replay, replay_candidate, sibling_path,
    sweep_grid, trimmed_mean)
from repro_torch.tuning import cost as cost_lib
from repro_torch.tuning.space import (
    default_launch, launch_candidate, launches, row_launch)

REL = dict(rel=1e-12)         # same float64 numpy arithmetic on both sides
BACKEND_NAMES = {"pallas_tpu": "hopper", "xla_ref": "hopper",
                 "host_residual": "host_residual"}
KERNS = ("q8_matmul", "q8_matvec", "bf16_matmul")
MS = (8, 16, 24, 1504, 3000)
NS = (13, 384, 1152, 1536, 51872)
KS = (32, 64, 80, 384, 1536)
BUDGETS = tuple(budget_grid())


def _cpu_tuner(**kw):
    return Autotuner(device="cpu", mode="analytic", **kw)


def _port_tuner(jax_tuner, budget=tiles.SMEM_OPTIN_BYTES) -> Autotuner:
    """A CPU tuner holding the reference tuner's records: the same keys and
    bursts, each with the kernel's untuned launch (which every shape
    admits), and the same memoized shapes where nothing fitted (the
    reference's space has none at N = 51,872, which the Hopper kernels
    mask; the port's would). A key at a padded M of at most 16 is copied
    to each batch tile it covers, where the port asks for its launch
    tile (``tiles.tile_m``)."""
    def keys(k):
        ms = [k.m] + ([t for t in (1, 2, 4, 8, 16) if t < k.m]
                      if k.m <= tiles.MAX_ROW_M else [])
        return [TuningKey(k.kernel, m, k.n, k.k, k.dtype, budget)
                for m in ms]
    t = _cpu_tuner(smem_budget_bytes=budget)
    for k, rec in jax_tuner.cache.entries.items():
        for key in keys(k):
            c = launch_candidate(k.kernel, key.m, k.n, k.k, rec.block_k,
                                 default_launch(k.kernel, key.m, k.n, k.k))
            t.cache.put(key, TuningRecord(c.block_m, c.block_n, c.block_k,
                                          rec.cost_s, c.claim_bytes,
                                          rec.source, c.launch))
    t._no_tiling.update(key for k in jax_tuner._no_tiling for key in keys(k))
    return t


# --------------------------------------------------------------- calibrate
def _samples(seed, n=12, noise=0.05):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        flops, nbytes, steps = (rng.uniform(1e6, 1e10), rng.uniform(1e4, 1e8),
                                float(rng.integers(1, 40)))
        t = flops / 5e14 + nbytes / 2e12 + steps * 8e-7
        rows.append((flops, nbytes, steps, t * (1 + noise * rng.normal())))
    return rows


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (1, 0.05), (2, 0.3)])
def test_fit_matches_reference(seed, noise):
    rows = _samples(seed, noise=noise)
    got = calibrate.fit(rows, backend="hopper")
    want = jax_calibrate.fit(rows, backend="hopper")
    for f in ("eff_flops", "eff_bw", "overhead_s", "median_rel_err"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), **REL), f
    assert got.n_samples == want.n_samples == len(rows)
    if noise == 0.0:                     # noise-free: exact recovery
        assert got.eff_flops == pytest.approx(5e14, rel=1e-6)
        assert got.overhead_s == pytest.approx(8e-7, rel=1e-6)


def test_fit_needs_three_samples():
    with pytest.raises(ValueError):
        calibrate.fit(_samples(0, n=2))


@pytest.mark.parametrize("ts", [[3.0], [2.0, 1.0], [5.0, 1.0, 2.0],
                                [1.0, 9.0, 2.0, 3.0, 2.5],
                                [4.0, 1.0, 1.0, 7.0, 2.0, 3.0, 100.0, 2.0]])
def test_trimmed_mean_matches_reference(ts):
    assert trimmed_mean(ts) == pytest.approx(jax_trimmed_mean(ts),
                                             **REL)


@pytest.mark.parametrize("a,b", [
    ([1, 2, 3, 4], [10, 20, 30, 40]),
    ([1, 2, 3, 4], [4, 3, 2, 1]),
    ([1, 1, 2, 3, 3], [5, 4, 4, 1, 2]),
    ([2, 2, 2], [1, 2, 3]),
    ([0.3, 0.1, 0.2, 0.9, 0.5, 0.5], [3.0, 1.0, 2.5, 8.0, 4.0, 6.0]),
])
def test_rank_correlation_matches_reference(a, b):
    assert rank_correlation(a, b) == pytest.approx(
        jax_calibrate.rank_correlation(a, b), **REL)


# ---------------------------------------------------- plans with equal records
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("m,k,n", [(1, 384, 384), (1, 1536, 384),
                                   (1, 384, 51872), (1500, 384, 1536),
                                   (1500, 1536, 384), (1500, 80, 384),
                                   (3000, 1536, 384), (16, 96, 100)])
def test_plan_entries_agree_with_equal_records(quantized, m, k, n):
    jt = JaxAutotuner(mode="analytic")
    want = jax_plan_linear("site", m, k, n, quantized=quantized,
                           vmem_budget_kb=8 * 1024, default_burst=256,
                           tuner=jt, backend="pallas_tpu")
    tt = _port_tuner(jt)
    got = plan_linear("site", m, k, n, quantized=quantized,
                      vmem_budget_kb=8 * 1024, default_burst=256, tuner=tt)
    for f in ("burst", "tuned", "k_main", "k_res", "offload", "kernel"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.backend == BACKEND_NAMES[want.backend]
    assert (got.tiling is None) == (want.tiling is None)
    assert tt.searches == 0             # every answer from the records
    if got.tiling is not None:          # the record's launch, pinned
        assert got.tiling == default_launch(got.kernel, tiles.tile_m(got.m),
                                            n, got.k_main)
    if got.tuned:
        assert got.k_res == 0 and k % got.burst == 0


def test_untuned_plans_unchanged():
    """No tuner: burst 256, untuned, no tile; K = 384 splits 256 + 128."""
    e = plan_linear("x", 1500, 384, 384, quantized=True,
                    vmem_budget_kb=8 * 1024, default_burst=256)
    assert (e.burst, e.tuned, e.tiling, e.k_main, e.k_res) == \
        (256, False, None, 256, 128)


# ------------------------------------------------------- tuned transcribe
@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("whisper-tiny")
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg, 64)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    mel = np.random.default_rng(0).standard_normal(
        (2, 16, jcfg.n_mels)).astype(np.float32)
    return jcfg, jparams, get_smoke_config("whisper-tiny"), tparams, mel


@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_tuned_transcribe_matches_reference(smoke, quant):
    """The reference engine tunes (analytic); the port's tuner holds the
    same records: tokens, plans (routing fields) and tuned calls agree,
    and every linear with a main segment runs on a tuned entry with no
    residual."""
    jcfg, jparams, tcfg, tparams, mel = smoke
    jt = JaxAutotuner(mode="analytic")
    je = JaxServeEngine(jcfg, jparams, max_len=64, quant=quant,
                        offload=JaxOffloadEngine(prefer_pallas=False,
                                                 tuner=jt))
    want = je.transcribe(mel, max_new=8)
    tt = _port_tuner(jt)
    te = ServeEngine(tcfg, tparams, max_len=64, quant=quant,
                     offload=OffloadEngine(tuner=tt), device="cpu")
    got = te.transcribe(mel, max_new=8)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert tt.searches == 0
    # the port projects every decoder layer's cross K/V in the prefill,
    # the reference the first layer's (tests/test_torch_serving.py): those
    # extra calls close each prefill plan, tuned like the rest
    ts, js = te.offload.stats, je.offload.stats
    assert js.tuned_calls > 0
    assert ts.tuned_calls - js.tuned_calls == \
        ts.offloaded_calls - js.offloaded_calls >= 0
    for key, jplan in je._plans.plans.items():
        tplan = te._plans.plans[key]
        for a, b in zip(tplan.entries, jplan.entries):
            for f in ("burst", "tuned", "k_main", "k_res", "offload"):
                assert getattr(a, f) == getattr(b, f), (key, a.name, f)
            assert a.backend == BACKEND_NAMES[b.backend]
        for a in tplan.entries[len(jplan):]:
            assert a.name.startswith("dec.cross") and a.tuned
        assert all(a.k_res == 0 for a in tplan.entries if a.tuned)
    rep = te.energy_report(got, 700.0)
    assert set(rep["tuning"]) == set(je.energy_report(want, 700.0)["tuning"])
    assert rep["tuning"]["tuned_calls"] == te.offload.stats.tuned_calls


@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_tuned_transcribe_close_to_untuned(smoke, quant):
    """A tuned burst moves the split, not the function: tokens agree with
    the untuned engine's on the CPU."""
    _, _, tcfg, tparams, mel = smoke
    base = ServeEngine(tcfg, tparams, max_len=64, quant=quant,
                       offload=OffloadEngine(), device="cpu")
    tuned = ServeEngine(tcfg, tparams, max_len=64, quant=quant,
                        offload=OffloadEngine(tuner=_cpu_tuner()),
                        device="cpu")
    assert [r.tokens for r in tuned.transcribe(mel, max_new=6)] == \
        [r.tokens for r in base.transcribe(mel, max_new=6)]
    assert tuned.offload.stats.tuned_calls > 0
    assert base.offload.stats.tuned_calls == 0


@pytest.mark.parametrize("quant", ["q8_0", "none"])
@pytest.mark.parametrize("frames,tokens,batch", [(1500, 27, 1), (96, 4, 2),
                                                 (16, 8, 3)])
def test_warm_tuning_counts_match_reference(quant, frames, tokens, batch):
    cfg = get_config("whisper-tiny")
    jt = JaxAutotuner(mode="analytic")
    want = jax_warm_tuning(jax_get_config("whisper-tiny"),
                           JaxOffloadEngine(tuner=jt), n_frames=frames,
                           n_tokens=tokens, batch=batch, quant=quant)
    tt = _cpu_tuner()
    got = whisper_lib.warm_tuning(cfg, OffloadEngine(tuner=tt),
                                  n_frames=frames, n_tokens=tokens,
                                  batch=batch, quant=quant)
    assert got == want > 0
    assert len(tt.cache) > 0 and tt.searches >= len(tt.cache)
    assert whisper_lib.warm_tuning(cfg, OffloadEngine()) == 0


def test_engine_warms_before_timers_and_saves_once(smoke, tmp_path):
    """Construction warms the canonical shapes and saves; a transcribe
    warms its own keys (a search: saved again); the next is all hits."""
    _, _, tcfg, tparams, mel = smoke
    path = str(tmp_path / "cache.json")
    tt = _cpu_tuner(cache_path=path)
    eng = ServeEngine(tcfg, tparams, max_len=64,
                      offload=OffloadEngine(tuner=tt), device="cpu")
    n0 = tt.searches
    assert n0 > 0 and os.path.exists(path)
    eng.transcribe(mel, max_new=4)
    n1 = tt.searches
    mtime = os.stat(path).st_mtime_ns
    eng.transcribe(mel, max_new=4)
    assert tt.searches == n1 and os.stat(path).st_mtime_ns == mtime
    again = _cpu_tuner(cache_path=path)
    assert again.cache.entries == tt.cache.entries


# ------------------------------------------------------------------- space
def _check_admissible(kernel, m, n, k, budget):
    cands = enumerate_candidates(kernel, m, n, k, smem_budget_bytes=budget)
    for c in cands:
        assert k % c.block_k == 0
        if kernel.startswith("q8"):
            assert c.block_k % 32 == 0
        assert c.claim_bytes <= budget
        rl = row_launch(kernel, m)
        if rl is None:
            table = (tiles.Q8_WGMMA_TILES if kernel == "q8_matmul"
                     else tiles.BF16_WGMMA_TILES)
            own = (tiles.q8_wgmma_smem_bytes if kernel == "q8_matmul"
                   else tiles.bf16_wgmma_smem_bytes)
            if c.launch == ():        # bf16_matmul's converting launch
                assert kernel == "bf16_matmul" and k % 8
                assert c.claim_bytes == tiles.CVT_SMEM_BYTES
            else:
                assert c.launch in table and c.claim_bytes == own(c.launch)
        else:
            rl.check(c.launch, k)
            assert c.claim_bytes == rl.smem_bytes(c.launch, m)
    assert cands == enumerate_candidates(kernel, m, n, k,
                                         smem_budget_bytes=budget)
    return cands


@given(st.sampled_from(KERNS), st.sampled_from(MS), st.sampled_from(NS),
       st.sampled_from(KS), st.sampled_from(BUDGETS))
@settings(max_examples=40, deadline=None)
def test_every_candidate_admissible(kernel, m, n, k, budget):
    if kernel == "q8_matvec" and m > 16:
        return
    _check_admissible(kernel, m, n, k, budget)


@pytest.mark.parametrize("kernel,m,n,k", [
    ("q8_matmul", 1504, 1536, 384), ("q8_matmul", 1504, 384, 1536),
    ("q8_matvec", 8, 384, 384), ("q8_matvec", 8, 51872, 384),
    ("q8_matvec", 16, 384, 1536), ("bf16_matmul", 1504, 384, 80),
    ("bf16_matmul", 8, 384, 1536), ("bf16_matmul", 1504, 384, 1536)])
def test_admissibility_example(kernel, m, n, k):
    cands = _check_admissible(kernel, m, n, k, tiles.SMEM_OPTIN_BYTES)
    # at least two launches at each of whisper-tiny's shapes
    assert len({c.launch for c in cands}) >= 2
    assert cands[0].launch == default_launch(kernel, m, n, k)


def test_claims_and_defaults_are_todays_launches():
    """The constants the CUDA sources use: 40,704 B for q8_matmul's 64 x 32
    tile with 3 slots, about 30 KB at 2 slots (the paper's 32 KB point),
    55,808 B at 64 x 64 x 3; 82,944 B for bf16_matmul's 5-slot ring."""
    assert tiles.q8_wgmma_smem_bytes((32, 3)) == 40704
    assert tiles.q8_wgmma_smem_bytes((32, 2)) == 30208
    assert tiles.q8_wgmma_smem_bytes((64, 3)) == 55808
    assert tiles.bf16_wgmma_smem_bytes((64, 5)) == 82944
    assert default_candidate("q8_matmul", 1504, 384, 384).launch == (32, 3)
    assert default_candidate("bf16_matmul", 1504, 384, 384).launch == (64, 5)
    assert default_candidate("q8_matmul", 1504, 384, 384).block_k == 256
    # q8_matvec.cu's heuristic: split 4 at K = 1536, 4 rows a half-warp at
    # the readout, one warp of two rows at N = 384
    assert default_launch("q8_matvec", 8, 384, 1536) == (1, 4, 4)
    assert default_launch("q8_matvec", 8, 51872, 384) == (4, 4, 1)
    assert default_launch("q8_matvec", 8, 384, 384) == (1, 1, 1)
    assert default_launch("bf16_matmul", 8, 51872, 384) == (4, 4, 1)


def test_budget_grid_and_the_coverage_cliff():
    """16 KB admits no q8_matmul launch (a cell left out of the grid), 32 KB
    only 64 x 32 with 2 slots; each larger budget admits at least as many
    launches."""
    assert budget_grid() == [16384, 32768, 65536, 131072, 232448]
    m, n, k = 1504, 1536, 384
    counts = [len({c.launch for c in enumerate_candidates(
        "q8_matmul", m, n, k, smem_budget_bytes=b)}) for b in budget_grid()]
    assert counts[0] == 0 and counts == sorted(counts)
    assert {c.launch for c in enumerate_candidates(
        "q8_matmul", m, n, k, smem_budget_bytes=32768)} == {(32, 2)}
    grid = sweep_grid("q8_matmul", m, n, k, budgets=budget_grid(),
                      block_ks=(32, 64, 128, 256, 384))
    assert {b for b, _ in grid} == set(budget_grid()[1:])
    assert {r.cand.block_k for _, r in grid} == {32, 64, 128, 384}
    for budget, r in grid:
        assert r.cand.claim_bytes <= budget


@given(st.sampled_from(KERNS), st.sampled_from(MS), st.sampled_from(NS),
       st.sampled_from(KS), st.sampled_from(BUDGETS), st.booleans())
@settings(max_examples=25, deadline=None)
def test_tuner_pick_is_in_its_own_space(kernel, m, n, k, budget, calibrated):
    if kernel == "q8_matvec" and m > 16:
        return
    _check_pick(kernel, m, n, k, budget, calibrated)


def _check_pick(kernel, m, n, k, budget, calibrated):
    cal = None
    if calibrated:
        cal = CalibratedCoefficients()
        cal.put(BackendCoefficients("hopper", 4e14, 2e12, 7e-7))
    t = _cpu_tuner(smem_budget_bytes=budget, calibration=cal)
    rec = t.search(kernel, m, n, k)
    cands = enumerate_candidates(kernel, m, n, k, smem_budget_bytes=budget)
    if not cands:
        assert rec is None
        return
    assert (rec.block_m, rec.block_n, rec.block_k, rec.claim_bytes,
            rec.launch) in {(c.block_m, c.block_n, c.block_k, c.claim_bytes,
                             c.launch) for c in cands}
    assert rec.source == ("calibrated" if calibrated else "analytic")


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("kernel,m,n,k,budget", [
    ("q8_matmul", 1504, 1536, 384, 65536), ("q8_matmul", 1504, 384, 384,
                                            16384),
    ("q8_matvec", 8, 384, 1536, 232448), ("bf16_matmul", 8, 51872, 384,
                                          32768),
    ("bf16_matmul", 1504, 384, 80, 65536),
    ("bf16_matmul", 1504, 64, 1500, 32768)])
def test_pick_in_space_example(kernel, m, n, k, budget, calibrated):
    _check_pick(kernel, m, n, k, budget, calibrated)


def test_a_k_the_tensor_cores_cannot_take_has_the_tiled_launch():
    """bf16_matmul above M = 16 at K = 1500 (the attention's value product
    in the coverage enumeration): rows of 3,000 bytes that cp.async cannot
    copy, so the one launch is the converting one, (), which takes no tile; a
    plan entry tuned there carries no tile, and 16 KB admits nothing."""
    cands = _check_admissible("bf16_matmul", 1504, 64, 1500,
                              tiles.SMEM_OPTIN_BYTES)
    assert {c.launch for c in cands} == {()}
    assert cands[0].block_k == 750 and all(1500 % c.block_k == 0
                                           for c in cands)
    assert enumerate_candidates("bf16_matmul", 1504, 64, 1500,
                                smem_budget_bytes=16 * 1024) == []
    e = plan_linear("pv", 1500, 1500, 64, quantized=False,
                    vmem_budget_kb=8 * 1024, default_burst=256,
                    tuner=_cpu_tuner())
    assert (e.tuned, e.tiling, e.k_res) == (True, None, 0)
    x = torch.ones((20, 1500))
    w = torch.ones((8, 1500))
    torch.testing.assert_close(bf16_matmul(x, w, tile=()),
                               bf16_matmul_plain(x, w), rtol=0, atol=0)


def test_nothing_fits_keeps_default_and_memoizes():
    """At 16 KB no q8_matmul launch fits: the entry keeps the engine's
    burst and the kernel's own launch and says it was not tuned; the
    fruitless search is not repeated."""
    t = _cpu_tuner(smem_budget_bytes=16384)
    e1 = plan_linear("x", 1500, 384, 384, quantized=True,
                     vmem_budget_kb=8 * 1024, default_burst=256, tuner=t)
    n = t.searches
    e2 = plan_linear("x", 1500, 384, 384, quantized=True,
                     vmem_budget_kb=8 * 1024, default_burst=256, tuner=t)
    assert e1 == e2 and t.searches == n == 2
    assert (e1.burst, e1.tuned, e1.tiling, e1.k_res) == (256, False, None,
                                                         128)
    assert mixed_exec.select_burst(384, t, kernel="q8_matmul", m=1504, n=384,
                                   dtype="q8_0", default=128) == 128


@pytest.mark.parametrize("k,burst", [(384, 256), (384, 128), (80, 40),
                                     (1536, 768), (0, 32), (13, 32)])
def test_residual_fraction_and_select_burst_match_reference(k, burst):
    assert mixed_exec.residual_fraction(k, burst) == \
        jax_mixed.residual_fraction(k, burst)
    assert mixed_exec.select_burst(k, None, default=burst) == \
        jax_mixed.select_burst(k, None, default=burst) == burst


def test_tile_sweep_report_on_hopper_claims():
    """The residual fractions are the reference's at the bursts both score;
    the claim is a Hopper block's staging of one burst, refused above the
    most one block may claim."""
    from repro.core.coverage import enumerate_whisper as jax_enumerate
    from repro_torch.core.coverage import enumerate_whisper
    mine = bursts.tile_sweep_report(enumerate_whisper(get_config(
        "whisper-tiny")))
    theirs = {p.burst: p for p in jax_bursts.tile_sweep_report(
        jax_enumerate(jax_get_config("whisper-tiny")))}
    assert [p.burst for p in mine] == list(bursts.HOPPER_TILE_BURSTS)
    for p in mine:
        if p.burst in theirs:
            assert p.residual_flop_frac == pytest.approx(
                theirs[p.burst].residual_flop_frac, **REL)
        assert p.smem_claim_bytes == 64 * p.burst * 2 + 32 * p.burst + \
            32 * (p.burst // 32) * 4
    assert bursts.select_tile_burst(enumerate_whisper(get_config(
        "whisper-tiny"))) in bursts.HOPPER_TILE_BURSTS
    huge = bursts.tile_sweep_report(enumerate_whisper(get_config(
        "whisper-tiny")), block_m=1024, block_n=1024, bursts=(512,))
    assert huge[0].smem_claim_bytes > tiles.SMEM_OPTIN_BYTES
    assert huge[0].score >= 1e6


# --------------------------------------------------------------- the stores
def _key_strategy():
    return st.builds(TuningKey, st.sampled_from(KERNS), st.sampled_from(MS),
                     st.sampled_from(NS), st.sampled_from(KS),
                     st.sampled_from(("q8_0", "bf16")),
                     st.sampled_from(BUDGETS))


def _rec_strategy():
    return st.builds(TuningRecord, st.integers(1, 64), st.integers(1, 256),
                     st.integers(32, 1024),
                     st.floats(1e-7, 1.0, allow_nan=False),
                     st.integers(0, 2**18),
                     st.sampled_from(("analytic", "calibrated", "measured")),
                     st.sampled_from(((32, 3), (64, 2), (1, 4, 1))))


def _roundtrip_cache(entries, tmp):
    c = TuningCache()
    for k, r in entries.items():
        c.entries[k] = r
    path = c.save(os.path.join(tmp, "c.json"))
    assert TuningCache.load(path).entries == c.entries
    assert TuningCache.from_dict(json.loads(json.dumps(c.to_dict()))
                                 ).entries == c.entries


@given(st.dictionaries(_key_strategy(), _rec_strategy(), max_size=6))
@settings(max_examples=25, deadline=None)
def test_cache_roundtrips_identity(entries):
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        _roundtrip_cache(entries, d)


def test_cache_roundtrip_example(tmp_path):
    key = TuningKey("q8_matmul", 1504, 384, 384, "q8_0", 232448)
    rec = TuningRecord(64, 32, 384, 4.7e-6, 40704, "measured", (32, 3))
    _roundtrip_cache({key: rec}, str(tmp_path))
    # merge: measured beats calibrated beats analytic, then lower cost
    c = TuningCache({key: dataclasses.replace(rec, source="analytic",
                                              cost_s=1e-9)})
    c.put(key, rec)
    assert c.entries[key] == rec
    c.put(key, dataclasses.replace(rec, cost_s=1e-6))
    assert c.entries[key].cost_s == 1e-6


def test_calibration_store_roundtrip(tmp_path):
    cal = CalibratedCoefficients()
    cal.put(BackendCoefficients("hopper", 4.1e14, 1.9e12, 6.5e-7, 30, 0.12))
    path = cal.save(str(tmp_path / "x.calibration.json"))
    assert CalibratedCoefficients.load(path) == cal
    assert sibling_path(str(tmp_path / "x.json")) == path


def test_schema_guards(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 99, "entries": {}}))
    with pytest.raises(ValueError):
        TuningCache.load(str(bad))
    with pytest.warns(UserWarning):
        assert len(TuningCache.load_or_empty(str(bad))) == 0
    (tmp_path / "torn.json").write_text('{"schema": "hopper-1", "entr')
    with pytest.warns(UserWarning):
        assert len(TuningCache.load_or_empty(str(tmp_path / "torn.json"))) == 0
    with pytest.raises(ValueError):
        CalibratedCoefficients.load(str(bad))
    with pytest.warns(UserWarning):
        assert CalibratedCoefficients.load_or_none(str(bad)) is None
    assert len(TuningCache.load_or_empty(str(tmp_path / "none.json"))) == 0


def test_jax_cache_and_calibration_load_as_empty(tmp_path):
    """Files the JAX package wrote (Pallas tiles, TPU/XLA fits) are refused
    with a warning: an empty cache, no calibration."""
    jc = JaxTuningCache()
    jc.put(JaxTuningKey("q8_matmul", 1504, 384, 384, "q8_0", 2**23),
           JaxTuningRecord(94, 128, 128, 1e-6, 2**20, "analytic"))
    path = jc.save(str(tmp_path / "jax.json"))
    jcal = JaxCalibration()
    jcal.put(JaxCoefficients("xla_ref", 1e12, 1e10, 1e-6))
    jcal.save(jax_calibrate.sibling_path(path))
    with pytest.warns(UserWarning):
        assert len(TuningCache.load_or_empty(path)) == 0
    with pytest.warns(UserWarning):
        t = _cpu_tuner(cache_path=path)
    assert len(t.cache) == 0 and t.calibration is None


def test_tuner_autoloads_sibling_calibration(tmp_path):
    cal = CalibratedCoefficients()
    cal.put(BackendCoefficients("hopper", 4e14, 2e12, 7e-7))
    path = str(tmp_path / "t.json")
    cal.save(sibling_path(path))
    t = _cpu_tuner(cache_path=path)
    assert t.calibration == cal
    rec = t.search("q8_matmul", 1504, 384, 384)
    assert rec.source == "calibrated"


# ------------------------------------------------------ replay and the fit
def test_replay_deterministic_and_seeded():
    a = replay("q8_matvec", 8, 96, 64, "q8_0", reps=3, device="cpu")
    b = replay("q8_matvec", 8, 96, 64, "q8_0", reps=3, device="cpu")
    c = replay("q8_matvec", 8, 96, 64, "q8_0", reps=3, seed=1, device="cpu")
    assert a.checksum == b.checksum != c.checksum
    assert a.backend == "hopper" and a.tiling is None
    assert len(a.times_s) == 3 and a.time_s > 0
    x, w = make_operands("q8_matmul", 24, 64, 64, "q8_0", device="cpu")
    assert x.dtype == torch.bfloat16 and w.qs.dtype == torch.int8
    x, w = make_operands("bf16_matmul", 8, 64, 64, "bf16", device="cpu")
    assert x.dtype == w.dtype == torch.bfloat16


def test_replay_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cand = enumerate_candidates("q8_matvec", 8, 96, 64)[0]
    for call in (lambda: replay("q8_matvec", 8, 96, 64, "q8_0", reps=1),
                 lambda: replay_candidate(cand, 8, 96, 64, "q8_0", reps=1),
                 lambda: make_operands("q8_matvec", 8, 96, 64, "q8_0")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert replay("q8_matvec", 8, 96, 64, "q8_0", reps=1,
                  device="cpu").backend == "hopper"


def test_replay_records_pinned_tiling_and_its_features():
    cand = enumerate_candidates("q8_matvec", 8, 384, 1536)[3]
    s = replay_candidate(cand, 8, 384, 1536, "q8_0", reps=3, device="cpu")
    assert s.tiling == cand.launch
    assert (s.flops, s.bytes_hbm, s.steps) == analytic_features(cand, 8, 384,
                                                                1536)
    base = replay("q8_matvec", 8, 384, 1536, "q8_0", reps=3, device="cpu")
    assert base.checksum == s.checksum          # a tile is not a function


def test_fit_from_replays_is_storable(tmp_path):
    samples = [replay_candidate(c, m, n, k, "q8_0", reps=3, device="cpu")
               for m, n, k in ((1504, 64, 64), (8, 384, 384),
                               (8, 1536, 1536))
               for c in enumerate_candidates(
                   "q8_matmul" if m > 16 else "q8_matvec", m, n, k)[:2]]
    coeffs = fit_backend(samples, "hopper")
    assert coeffs.n_samples == len(samples) and coeffs.eff_flops > 0
    cal = CalibratedCoefficients()
    cal.put(coeffs)
    assert CalibratedCoefficients.load(cal.save(str(tmp_path / "c.json"))) \
        == cal


def test_cost_reports_and_hw_are_the_h100s():
    assert cost_lib.H100.name == "NVIDIA H100 80GB HBM3"
    assert cost_lib.H100.peak_flops("q8_matvec") == 67e12
    assert cost_lib.H100.peak_flops("q8_matmul") == 989e12
    c = default_candidate("q8_matmul", 1504, 384, 1536)
    r = analytic_cost(c, 1504, 384, 1536)
    assert r.cost_s == max(r.compute_s, r.memory_s) + r.launch_s
    assert r.pdp_j(700.0) == pytest.approx(r.cost_s * 700.0)
    with pytest.raises(ValueError):
        cost_lib.measured_cost(c, 1504, 384, 1536, device="cpu")


# ----------------------------------------------------------- dispatch
def test_offload_engine_consumes_cached_tuning():
    t = _cpu_tuner()
    launch = (4, 2, 1)
    t.cache.put(TuningKey("q8_matvec", 8, 32, 64, "q8_0",
                          t.smem_budget_bytes),
                TuningRecord(8, 16, 64, 1e-6, 256, "measured", launch))
    eng = OffloadEngine(burst=256, tuner=t)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    wq = quantize_q8_0(torch.from_numpy(
        (rng.standard_normal((32, 64)) * 0.1).astype(np.float32)))
    y = eng.linear(x, wq, name="seeded")
    torch.testing.assert_close(y, OffloadEngine(burst=32).linear(x, wq),
                               rtol=1e-6, atol=1e-6)
    entry = eng.plan_entry(8, 64, 32, quantized=True, name="seeded")
    assert (entry.tuned, entry.tiling, entry.burst, entry.k_res) == \
        (True, launch, 64, 0)
    assert eng.stats.tuned_calls == 1 and t.searches == 0
    assert t.cache.hits >= 2          # the burst, then the tile


def test_launch_tile_is_chosen_at_the_batch_tile_the_step_runs():
    """The burst is the padded-M key's (the reference's parity); the launch
    tile of a M <= 16 launch is the key of the batch tile it runs: a decode
    step's M = 1, not M = 8."""
    t = _cpu_tuner()
    bud = t.smem_budget_bytes
    t.cache.put(TuningKey("q8_matvec", 8, 64, 384, "q8_0", bud),
                TuningRecord(8, 32, 384, 1e-6, 256, "measured", (4, 1, 1)))
    t.cache.put(TuningKey("q8_matvec", 1, 64, 384, "q8_0", bud),
                TuningRecord(1, 32, 384, 1e-6, 64, "measured", (1, 4, 1)))
    e = plan_linear("x", 1, 384, 64, quantized=True, vmem_budget_kb=8192,
                    default_burst=256, tuner=t)
    assert (e.burst, e.tiling, e.k_res, t.searches) == (384, (1, 4, 1), 0, 0)
    assert [tiles.tile_m(m) for m in (1, 2, 3, 8, 9, 16, 17, 1500)] == \
        [1, 2, 4, 8, 16, 16, 24, 1504]
    warm = _cpu_tuner()
    warm.warm([MulMat("x", m=1, k=384, n=64)], dtype="q8_0")
    keys = {(k.m, k.k) for k in warm.cache.entries}
    assert keys == {(8, 384), (1, 384)}


@pytest.mark.parametrize("m", [1, 40])
def test_f32_dense_operands_take_no_tensor_core_tile(m):
    """Above M = 16 an f32 dense operand runs the converting launch, which
    takes no tile: its plan entry keeps the burst and leaves the launch
    alone; at M <= 16 every operand type takes the gemv launch's tile."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((m, 80)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 80)) * 0.1).astype(
        np.float32)).to(torch.bfloat16)
    eng = OffloadEngine(tuner=_cpu_tuner())
    plan = DispatchPlan()
    with eng.recording(plan):
        y32 = eng.linear(x, w, name="frontend")
        eng.linear(x.to(torch.bfloat16), w, name="frontend")
    f32, b16 = plan.entries
    assert f32.tuned and b16.tuned and f32.k_res == 0 and f32.burst == 80
    assert b16.tiling is not None
    assert (f32.tiling is None) == (m > tiles.MAX_ROW_M)
    torch.testing.assert_close(y32, bf16_matmul_plain(x, w), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("k,n", [(384, 384), (1536, 384)])
def test_f32_x_q8_0_entries_above_16_rows_take_no_tile(k, n):
    """A Q8_0 weight with f32 x above M = 16 runs ``q8_split_tc_kernel``,
    which takes no tile (as the dense f32 case): with an analytic tuner
    attached its entry at M = 28 has no tiling, and its burst, k_main,
    k_res and offload are still the reference's; bf16 x there keeps the
    tensor-core launch's tile."""
    m = 28
    jt = JaxAutotuner(mode="analytic")
    want = jax_plan_linear("site", m, k, n, quantized=True,
                           vmem_budget_kb=8 * 1024, default_burst=256,
                           tuner=jt, backend="pallas_tpu")
    got = plan_linear("site", m, k, n, quantized=True,
                      vmem_budget_kb=8 * 1024, default_burst=256,
                      tuner=_port_tuner(jt), f32_operand=True)
    for f in ("burst", "k_main", "k_res", "offload"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.kernel == "q8_matmul" and got.tiling is None

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = quantize_q8_0(torch.from_numpy(
        (rng.standard_normal((n, k)) * 0.1).astype(np.float32)))
    eng = OffloadEngine(tuner=_cpu_tuner())
    plan = DispatchPlan()
    with eng.recording(plan):
        y = eng.linear(x, w, name="dec.q")
        eng.linear(x.to(torch.bfloat16), w, name="dec.q")
    f32, b16 = plan.entries
    assert f32.kernel == b16.kernel == "q8_matmul"
    assert f32.tiling is None and b16.tiling is not None
    assert f32.burst == b16.burst
    torch.testing.assert_close(y, q8_matmul_plain(x, w.qs.reshape(n, k),
                                                  w.scales),
                               rtol=1e-5, atol=1e-5)


def test_measured_search_keeps_the_kernels_launch_within_the_margin(
        monkeypatch):
    """A measured launch replaces the kernel's own only when it is faster
    by more than ``MEASURED_MARGIN``; the burst stays the largest."""
    from repro_torch.tuning import tuner as tuner_lib
    m, n, k = 1, 384, 384
    own = default_launch("q8_matvec", m, n, k)
    other = next(t for t in launches("q8_matvec", m, n, k) if t != own)
    for gain, want in ((0.5 * tuner_lib.MEASURED_MARGIN, own),
                       (2 * tuner_lib.MEASURED_MARGIN, other)):
        t = _cpu_tuner()
        monkeypatch.setattr(t, "resolved_mode", lambda: "measured")

        def fake(reports, m, n, k, gain=gain):
            out = []
            for r in reports:
                c = 1.0 - gain * (r.cand.launch == other)
                out.append(cost_lib.CostReport(r.cand, c, c, 0.0, c,
                                               "measured"))
            return out
        monkeypatch.setattr(t, "_measure", fake)
        rec = t.search("q8_matvec", m, n, k)
        assert (rec.launch, rec.block_k) == (want, k)


def test_a_dividing_burst_launches_no_residual(monkeypatch):
    calls = []
    real = HostResidualBackend.build

    def spy(self, req):
        calls.append(req)
        return real(self, req)
    monkeypatch.setattr(HostResidualBackend, "build", spy)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 384)).astype(np.float32))
    wq = quantize_q8_0(torch.from_numpy(
        (rng.standard_normal((64, 384)) * 0.1).astype(np.float32)))
    tuned = OffloadEngine(tuner=_cpu_tuner())
    y = tuned.linear(x, wq)
    assert calls == []
    y0 = OffloadEngine().linear(x, wq)             # 256 + 128: one residual
    assert len(calls) == 1 and calls[0].k == 128
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)


def test_executor_passes_the_tile_to_the_kernel(monkeypatch):
    seen = []
    import repro_torch.backends.hopper as hopper

    def fake(x, qs, scales, *, tile=None):
        seen.append(tile)
        return q8_matmul_plain(x, qs, scales)
    monkeypatch.setattr(hopper, "q8_matmul", fake)
    x = torch.zeros((40, 384))
    wq = quantize_q8_0(torch.ones((64, 384)))
    executor.matmul(x, wq, burst=384, tiling=(64, 2))
    executor.matmul(x, wq, burst=384)
    assert seen == [(64, 2), None]


# ----------------------------------------------------------- the wrappers
@pytest.mark.parametrize("case", ["q8_matmul", "q8_matvec", "bf16_gemv",
                                  "bf16_wgmma"])
def test_tiles_keep_the_function_and_bad_tiles_raise(case):
    rng = np.random.default_rng(2)
    m = 40 if case in ("q8_matmul", "bf16_wgmma") else 4
    k = 384
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((96, k)) * 0.1).astype(
        np.float32))
    if case == "bf16_wgmma":      # the tensor-core launch: bf16 x and W
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if case.startswith("q8"):
        wq = quantize_q8_0(w)
        fn, plain = ((q8_matmul, q8_matmul_plain) if case == "q8_matmul"
                     else (q8_matvec, q8_matvec_plain))
        kern = case
        args = (x, wq.flat_qs(), wq.scales)
    else:
        fn, plain, kern, args = bf16_matmul, bf16_matmul_plain, \
            "bf16_matmul", (x, w)
    for t in launches(kern, m, 96, k):
        torch.testing.assert_close(fn(*args, tile=t), plain(*args),
                                   rtol=0, atol=0)
    bad = {"q8_matmul": (48, 3), "q8_matvec": (1, 4, 4),
           "bf16_gemv": (64, 5), "bf16_wgmma": (1, 1, 1)}[case]
    with pytest.raises(ValueError):
        fn(*args, tile=bad)
    if case == "bf16_wgmma":      # an f32 operand: the converting launch
        with pytest.raises(ValueError, match="takes no tile"):
            fn(x.float(), w, tile=tiles.BF16_WGMMA_TILES[0])


# ----------------------------------------------- forcing, devices, faults
class _Probe:
    """A backend that takes any main segment when forced or pinned."""
    name = "probe"

    def supports(self, req):
        return req.segment == MAIN

    def auto(self, req):
        return False

    def build(self, req):
        return lambda x, w: torch.zeros((x.shape[0], req.n))


def test_force_context_pins_main_segments_only():
    reg = BackendRegistry()
    reg.register(HopperBackend())
    reg.register(HostResidualBackend())
    reg.register(_Probe())
    main = KernelRequest(kernel="q8_matvec", m=1, n=8, k=64, dtype="q8_0")
    tail = dataclasses.replace(main, segment=RESIDUAL)
    assert reg.resolve(main).name == "hopper"
    with reg.force("probe"):
        assert reg.resolve(main).name == "probe"
        assert reg.resolve(main, pin="hopper").name == "probe"  # force > pin
        assert reg.resolve(tail).name == "host_residual"        # never a tail
        with reg.force("hopper"):                               # innermost
            assert reg.resolve(main).name == "hopper"
    assert reg.resolve(main).name == "hopper"
    with pytest.raises(KeyError):
        with reg.force("no_such_backend"):
            pass


def test_the_references_repro_backend_leaves_the_port_alone(monkeypatch):
    """The reference's CI runs a whole process under REPRO_BACKEND=xla_ref,
    a name the port does not register: the port's linears still plan and
    run on its own backends, tuned and untuned, with the same output."""
    monkeypatch.setenv("REPRO_BACKEND", "xla_ref")
    for kern, dtype in (("q8_matmul", "q8_0"), ("bf16_matmul", "bf16")):
        req = KernelRequest(kernel=kern, m=1500, n=384, k=384, dtype=dtype)
        assert REGISTRY.resolve(req).name == "hopper"
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 384)).astype(np.float32))
    wq = quantize_q8_0(torch.from_numpy(
        (rng.standard_normal((64, 384)) * 0.1).astype(np.float32)))
    tuned = OffloadEngine(tuner=_cpu_tuner())
    y = tuned.linear(x, wq, name="x")
    e = tuned.plan_entry(2, 384, 64, quantized=True, name="x")
    assert e.backend == "hopper" and e.tuned and e.k_res == 0
    torch.testing.assert_close(y, OffloadEngine().linear(x, wq),
                               rtol=1e-5, atol=1e-5)


def test_autotuner_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Autotuner()
    t = Autotuner(device="cpu")
    assert t.resolved_mode() == "analytic"
    with pytest.raises(ValueError):
        Autotuner(device="cpu", mode="measured")
    with pytest.raises(ValueError):
        Autotuner(device="cpu", mode="fast")


def test_decode_state_constructors_need_a_device():
    cfg = get_smoke_config("whisper-tiny")
    with pytest.raises(TypeError):
        KVCache.zeros(1, 4, 2, 8)
    with pytest.raises(TypeError):
        whisper_lib.zeros_decode_state(cfg, 1, 8, 4)
    kv = KVCache.zeros(1, 4, 2, 8, device="cpu")
    assert kv.k.device.type == "cpu" and kv.length.dtype == torch.int32
    st_ = whisper_lib.zeros_decode_state(cfg, 1, 8, 4, device="cpu")
    assert len(st_.self_kv) == cfg.num_layers
