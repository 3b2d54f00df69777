"""The port's measurement layer against the reference: the paper's energy
constants and equations (``core/energy.py``), the coverage enumerator and
its CDF (``core/coverage.py``), the burst sweep (``core/bursts.py``),
Amdahl's law and the share profiler (``core/amdahl.py``), and the Q8_0
reconstruction error (``core/qformats.py``). Pure arithmetic is compared
exactly or within 1e-6 relative (float sums in another order); the card's
power-limit reader is checked to raise rather than guess.
"""
import dataclasses
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core import amdahl as jax_amdahl
from repro.core import bursts as jax_bursts
from repro.core import coverage as jax_coverage
from repro.core import energy as jax_energy
from repro.core.qformats import quantize_q8_0 as jax_quantize
from repro.core.qformats import reconstruction_error as jax_recon
from repro_torch.configs import get_config
from repro_torch.core import amdahl, bursts, coverage, energy
from repro_torch.core.qformats import quantize_q8_0, reconstruction_error

REL = 1e-6
ARCHS = ["whisper-tiny", "whisper-base", "whisper-small"]
CONSTANTS = ["P_ARM_A72_W", "P_ARM_IDLE_W", "P_JETSON_W", "P_RTX4090_W",
             "P_IMAX_FPGA_W", "P_IMAX_LANE_FP16_W", "P_IMAX_LANE_Q8_W",
             "LMM_POWER_FP16_W", "LMM_POWER_Q8_W", "BURST_POWER_LANE_W",
             "BURST_ACTIVE_PES", "BURST_T_MAIN_S", "PAPER_LATENCY_28NM_S",
             "PAPER_PDP_J"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_energy_constants_match_reference(name):
    assert getattr(energy, name) == getattr(jax_energy, name)


def test_energy_equations_match_reference():
    for t, p in [(0.0, 5.0), (1.5, 0.647), (35.8, 1.5427)]:
        assert energy.pdp(t, p) == jax_energy.pdp(t, p)
        assert energy.edp(t, p) == jax_energy.edp(t, p)
    for ta, tm, pa in [(21.2, 35.8, 1.5427), (0.0, 3.0, 2.0), (3.0, 3.0, 1.0)]:
        assert energy.pdp_mixed(ta, tm, pa) == jax_energy.pdp_mixed(ta, tm, pa)
        assert energy.edp_mixed(ta, tm, pa, 0.3) == \
            jax_energy.edp_mixed(ta, tm, pa, 0.3)
    with pytest.raises(ValueError):
        energy.pdp_mixed(2.0, 1.0, 1.0)
    for b in (8, 16, 32):
        for lanes in (1, 2):
            assert energy.system_power_burst(b, lanes) == \
                jax_energy.system_power_burst(b, lanes)
    for size in energy.LMM_POWER_FP16_W:
        for path in ("fp16", "q8_0"):
            assert energy.lmm_power(size, path, 2) == \
                jax_energy.lmm_power(size, path, 2)
    with pytest.raises(KeyError):
        energy.lmm_power(48)


def test_card_report_is_the_measured_time_at_the_given_power():
    rep = energy.card_report(0.0358, 182.4, "NVIDIA H100 80GB HBM3")
    ref = jax_energy.EnergyReport("x", 0.0358, 182.4)
    assert rep.platform == "NVIDIA H100 80GB HBM3"
    assert rep.pdp_j == ref.pdp_j and rep.edp_js == ref.edp_js
    with pytest.raises(ValueError):
        energy.card_report(1.0, 0.0, "card")


def test_power_limit_reader_parses_or_raises(monkeypatch):
    """The power limit is nvidia-smi's number or an error: no default."""
    calls = []

    def fake(out=None, exc=None):
        def run(cmd, **kw):
            calls.append(cmd)
            if exc is not None:
                raise exc
            return subprocess.CompletedProcess(cmd, 0, stdout=out, stderr="")
        return run

    monkeypatch.setattr(subprocess, "run", fake("700.00\n"))
    assert energy.card_power_limit_w(0) == 700.0
    assert calls[-1][-2:] == ["-i", "0"]
    for bad in (fake(exc=FileNotFoundError("nvidia-smi")), fake("[N/A]\n"),
                fake(""), fake("0.00\n"),
                fake(exc=subprocess.CalledProcessError(9, "nvidia-smi"))):
        monkeypatch.setattr(subprocess, "run", bad)
        with pytest.raises(RuntimeError):
            energy.card_power_limit_w(1)


def _fields(mms):
    return [dataclasses.astuple(m) for m in mms]


@pytest.mark.parametrize("arch", ARCHS)
def test_enumerate_whisper_matches_reference(arch):
    for frames, tokens in [(1500, 27), (3000, 1), (16, 5)]:
        got = coverage.enumerate_whisper(get_config(arch), frames, tokens)
        want = jax_coverage.enumerate_whisper(jax_config(arch), frames, tokens)
        assert _fields(got) == _fields(want)
        assert [(m.flops, m.dots, m.act_bytes_dense(), m.act_bytes_padded())
                for m in got] == \
            [(m.flops, m.dots, m.act_bytes_dense(), m.act_bytes_padded())
             for m in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_coverage_cdf_and_fallback_time_match_reference(arch):
    got = coverage.enumerate_whisper(get_config(arch))
    want = jax_coverage.enumerate_whisper(jax_config(arch))
    for weight in ("calls", "dots", "flops"):
        assert coverage.coverage_cdf(got, weight=weight) == \
            jax_coverage.coverage_cdf(want, weight=weight)
        for budget in (1, 8, 32, 8 * 1024):
            for optimized in (False, True):
                assert coverage.coverage(
                    got, budget, optimized=optimized, weight=weight,
                    agg_units=1) == jax_coverage.coverage(
                    want, budget, optimized=optimized, weight=weight,
                    agg_units=1)
    for budget in coverage.LMM_SIZES_KB:
        assert coverage.fallback_time_fraction(got, budget) == \
            jax_coverage.fallback_time_fraction(want, budget)
    with pytest.raises(ValueError):
        coverage.coverage(got, 32, weight="bytes")
    assert coverage.coverage([], 32) == 0.0
    assert coverage.fallback_time_fraction([], 32) == 1.0


def test_paper_burst_sweep_matches_reference_and_picks_16():
    for lanes in (1, 2):
        got, want = bursts.paper_burst_sweep(lanes), \
            jax_bursts.paper_burst_sweep(lanes)
        assert [dataclasses.astuple(p) for p in got] == \
            [dataclasses.astuple(p) for p in want]
    pts = bursts.paper_burst_sweep()
    assert bursts.optimal_burst(pts, "pdp").burst == 16
    assert bursts.optimal_burst(pts, "edp").burst == 16
    # the paper's rounded 42.2 J and 1511 J*s, recomputed from its
    # rounded times and powers (1509.8 J*s: within 0.1%)
    best = bursts.optimal_burst(pts)
    assert best.pdp_j == pytest.approx(42.2, abs=0.05)
    assert best.edp_js == pytest.approx(1511, rel=1e-3)


def test_amdahl_matches_reference():
    assert amdahl.PAPER_SHARE == jax_amdahl.PAPER_SHARE
    for f in (0.0, 0.5, 0.871, 0.906, 1.0):
        assert amdahl.amdahl_bound(f) == jax_amdahl.amdahl_bound(f)
        for s in (1.0, 2.5, 8.0, 1e6):
            assert amdahl.amdahl_speedup(f, s) == pytest.approx(
                jax_amdahl.amdahl_speedup(f, s), rel=REL)
    assert amdahl.amdahl_bound(0.871) == pytest.approx(7.75, abs=0.01)
    for bad in ((-0.1, 2.0), (1.1, 2.0), (0.5, 0.0)):
        with pytest.raises(ValueError):
            amdahl.amdahl_speedup(*bad)


def test_profile_shares_matches_reference(monkeypatch):
    """The share arithmetic, with the two timings fixed: full 10, no-GEMM
    1.3 -> share 0.87, bound 1/0.13."""
    def fixed(fn, iters=5, warmup=2, device=None):
        return fn()
    monkeypatch.setattr(amdahl, "timeit_median", fixed)
    monkeypatch.setattr(jax_amdahl, "timeit_median",
                        lambda fn, iters=5, warmup=2: fn())
    got = amdahl.profile_shares(lambda: 10.0, lambda: 1.3)
    want = jax_amdahl.profile_shares(lambda: 10.0, lambda: 1.3)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=REL)
    assert got["dot_share"] == pytest.approx(0.87, rel=REL)


def test_timeit_median_runs_warmup_and_iters():
    calls = []
    t = amdahl.timeit_median(lambda: calls.append(1), iters=5, warmup=2,
                             device=torch.device("cpu"))
    assert len(calls) == 7 and t >= 0.0


@pytest.mark.parametrize("shape,scale", [((64, 96), 1.0), ((3, 8, 64), 0.02)])
def test_reconstruction_error_matches_reference(shape, scale):
    w = (np.random.default_rng(7).standard_normal(shape) * scale
         ).astype(np.float32)
    got = reconstruction_error(torch.from_numpy(w),
                               quantize_q8_0(torch.from_numpy(w)))
    wj = jnp.asarray(w)
    want = jax_recon(wj, jax_quantize(wj))
    assert got.keys() == want.keys()
    assert got["n_values"] == want["n_values"] == w.size
    for key in ("mae", "rmse", "max_abs", "rel_l2"):
        assert got[key] == pytest.approx(want[key], rel=REL), key
