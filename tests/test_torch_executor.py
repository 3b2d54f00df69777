"""The port's dispatch layer against the reference: ``executor.matmul``
against the reference executor pinned to ``xla_ref``, ``plan_linear``
entries, ledger accounting, and the registry's forced > pinned >
capability precedence.

Tolerance 1e-5 (f32): both sides contract the same f32 (or bf16-rounded)
operands segment by segment and differ only in summation order.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import executor as jax_executor
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.core.plan import plan_linear as jax_plan_linear
from repro.core.qformats import QTensor as JQTensor
from repro_torch.backends import MAIN, REGISTRY, RESIDUAL, KernelRequest, executor
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import DispatchPlan, plan_linear
from repro_torch.core.qformats import QTensor, quantize_q8_0

TOL = dict(rtol=1e-5, atol=1e-5)
PLAN_FIELDS = ("name", "m", "k", "n", "dtype", "offload", "burst", "tuned",
               "kernel", "k_main", "k_res")
BACKEND_NAMES = {"pallas_tpu": "hopper", "host_residual": "host_residual"}


def _jax_q(tq: QTensor) -> JQTensor:
    return JQTensor(jnp.asarray(tq.qs.numpy()), jnp.asarray(tq.scales.numpy()))


@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
@pytest.mark.parametrize("rows,k,burst", [
    (1, 384, 256),      # decode: matvec main + 128-wide residual
    (4, 1536, 256),     # no residual
    (20, 96, 64),       # matmul main + one-block residual
    (4, 64, 128),       # k < burst: all on the host arm
])
def test_matmul_q8_vs_reference(lead, rows, k, burst):
    rng = np.random.default_rng(k + rows)
    x = rng.standard_normal((*lead, rows, k)).astype(np.float32)
    w = (rng.standard_normal((48, k)) * 0.05).astype(np.float32)
    tq = quantize_q8_0(torch.from_numpy(w))
    got = executor.matmul(torch.from_numpy(x), tq, burst=burst)
    want = jax_executor.matmul(jnp.asarray(x), _jax_q(tq), burst=burst,
                               backend="xla_ref")
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_matmul_takes_activations_with_strided_columns():
    """A transposed activation (column stride != 1) gives the contiguous
    answer: the executor hands the kernels unit-stride rows."""
    x = torch.randn(384, 3).t()
    tq = quantize_q8_0(torch.randn(40, 384) * 0.05)
    np.testing.assert_allclose(executor.matmul(x, tq).numpy(),
                               executor.matmul(x.contiguous(), tq).numpy(),
                               **TOL)


@pytest.mark.parametrize("lead", [(), (2, 5)])
@pytest.mark.parametrize("k", [64, 96, 130, 383])      # incl. ragged K
def test_matmul_dense_vs_reference(lead, k):
    """Dense main segments run the bf16 semantics on both sides (the
    port's on bf16_matmul, whose plain version runs for CPU tensors);
    tails run in f32 on the host arm."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((*lead, 4, k)).astype(np.float32)
    w = (rng.standard_normal((32, k)) * 0.05).astype(np.float32)
    got = executor.matmul(torch.from_numpy(x), torch.from_numpy(w), burst=32)
    want = jax_executor.matmul(jnp.asarray(x), jnp.asarray(w), burst=32,
                               backend="xla_ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 1500, 3000])
@pytest.mark.parametrize("k,n", [(80, 384), (384, 384), (384, 1536),
                                 (1536, 384), (384, 51872)])
@pytest.mark.parametrize("quantized", [True, False])
def test_plan_linear_matches_reference(m, k, n, quantized):
    kw = dict(quantized=quantized, vmem_budget_kb=8 * 1024, default_burst=256)
    got = plan_linear("site", m, k, n, **kw)
    want = jax_plan_linear("site", m, k, n, tuner=None, backend="xla_ref",
                           **kw)
    for f in PLAN_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    # the reference pinned to its reference backend; every main segment of
    # the port, Q8_0 or dense, a capacity fallback too, takes the Hopper
    # kernels
    if got.k_main:
        assert got.backend == "hopper"
    else:
        assert got.backend == BACKEND_NAMES[want.backend]
    assert got.offloaded_flops == want.offloaded_flops
    assert got.residual_flops == want.residual_flops
    assert got.fallback_flops == want.fallback_flops


def test_ledger_matches_reference_eager_engine():
    """The same eager linear calls account the same totals and counts."""
    rng = np.random.default_rng(0)
    calls = [("a", (1, 384), 384), ("b", (1500, 384), 1536),
             ("c", (3000, 1536), 384), ("d", (2, 80), 64)]
    port, ref = OffloadEngine(), JaxOffloadEngine(prefer_pallas=False)
    for name, xs, n in calls:
        x = rng.standard_normal(xs).astype(np.float32)
        w = (rng.standard_normal((n, xs[-1])) * 0.05).astype(np.float32)
        if xs[-1] % 32 == 0:
            tq = quantize_q8_0(torch.from_numpy(w))
            tw, jw = tq, _jax_q(tq)
        else:
            tw, jw = torch.from_numpy(w), jnp.asarray(w)
        y = port.linear(torch.from_numpy(x), tw, name=name)
        want = ref.linear(jnp.asarray(x), jw, name=name)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    a, b = port.stats, ref.stats
    for f in ("offloaded_calls", "fallback_calls", "offloaded_flops",
              "fallback_flops", "residual_flops", "by_kernel"):
        assert getattr(a, f) == getattr(b, f), f
    # "c" is a capacity fallback (offload=False) but still runs on hopper
    assert a.by_backend == {"hopper": 3, "host_residual": 1}
    assert sum(b.by_backend.values()) == sum(a.by_backend.values())


def test_recording_keeps_the_routing_of_a_run():
    """A recorded run lands in the plan and not in the ledger, as in the
    reference; committing the plan accounts it, once per run."""
    eng = OffloadEngine(burst=32)
    tq = quantize_q8_0(torch.randn(16, 64))
    plan = DispatchPlan(key="k")
    with eng.recording(plan):
        eng.linear(torch.randn(2, 64), tq, name="x")
        eng.linear(torch.randn(40, 64), tq, name="y")
    eng.linear(torch.randn(2, 64), tq, name="z")        # not recorded
    assert [(e.name, e.kernel) for e in plan] == [("x", "q8_matvec"),
                                                  ("y", "q8_matmul")]
    assert eng.stats.offloaded_calls == 1
    eng.ledger.commit(plan, times=3)
    assert eng.stats.offloaded_calls == 1 + 2 * 3
    assert eng.stats.by_kernel == {"x": 3, "y": 3, "z": 1}
    assert eng.ledger.commits == 1


def test_registry_precedence():
    q = KernelRequest(kernel="q8_matvec", m=1, n=8, k=64, dtype="q8_0")
    dense = dataclasses.replace(q, dtype="bf16", kernel="bf16_matmul")
    assert REGISTRY.names() == ("hopper", "host_residual")
    assert REGISTRY.resolve(q).name == "hopper"              # capability
    assert REGISTRY.resolve(dense).name == "hopper"
    assert REGISTRY.resolve(dense, pin="hopper").name == "hopper"  # pinned
    with REGISTRY.force("host_residual"):                   # forced > pinned
        tail = dataclasses.replace(q, segment=RESIDUAL)
        assert REGISTRY.resolve(tail).name == "host_residual"
        dense_tail = dataclasses.replace(dense, segment=RESIDUAL)
        assert REGISTRY.resolve(dense_tail, pin="hopper").name == \
            "host_residual"        # residual segments skip force and pin
        # a backend that cannot take the request falls through
        assert REGISTRY.resolve(dense).name == "hopper"
    with pytest.raises(KeyError):                            # removed
        REGISTRY.resolve(dense, pin="torch_ref")
    assert q.segment == MAIN


@pytest.mark.parametrize("name", ["host_residual"])
def test_no_force_or_pin_sends_q8_main_to_plain_code(name):
    """Only the Hopper kernels take a Q8_0 main segment, so a forced or
    pinned plain backend falls through to them."""
    for kern, m in (("q8_matvec", 1), ("q8_matmul", 3000)):
        q = KernelRequest(kernel=kern, m=m, n=384, k=1536, dtype="q8_0")
        assert REGISTRY.resolve(q, pin=name).name == "hopper"
        with REGISTRY.force(name):
            assert REGISTRY.resolve(q).name == "hopper"
            assert REGISTRY.resolve(q, pin=name).name == "hopper"


@pytest.mark.parametrize("case", ["capability", "pinned", "forced",
                                  "forced_and_pinned"])
@pytest.mark.parametrize("m", [1, 1500])
def test_dense_main_segment_runs_on_hopper(case, m):
    """Every dense main segment, at decode and prefill M, resolves to the
    Hopper backend (``bf16_matmul``): a forced or pinned host_residual
    cannot take it and falls through. The former ``torch_ref`` backend,
    which ran it in plain PyTorch on the card, is gone."""
    req = KernelRequest(kernel="bf16_matmul", m=m, n=384, k=256,
                        dtype="bf16")
    pin = "host_residual" if case in ("pinned", "forced_and_pinned") else None
    if case.startswith("forced"):
        with REGISTRY.force("host_residual"):
            backend = REGISTRY.resolve(req, pin=pin)
    else:
        backend = REGISTRY.resolve(req, pin=pin)
    assert backend.name == "hopper"
    assert backend.build(req).__name__ == "bf16_matmul"
    assert not REGISTRY.get("host_residual").supports(req)
    entry = plan_linear("site", m, 384, 384, quantized=False,
                        vmem_budget_kb=8 * 1024, default_burst=256)
    assert (entry.backend, entry.kernel, entry.k_main) == \
        ("hopper", "bf16_matmul", 256)


def test_capacity_fallback_runs_on_hopper_and_matches_reference():
    """An entry that fails the reference's local-memory rule keeps
    offload=False in the ledger, yet its Q8_0 main segment takes the Hopper
    backend; the result equals the reference engine's (which runs it on
    xla_ref)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 384)).astype(np.float32)
    w = (rng.standard_normal((64, 384)) * 0.05).astype(np.float32)
    tq = quantize_q8_0(torch.from_numpy(w))
    port = OffloadEngine(vmem_budget_kb=1)
    ref = JaxOffloadEngine(vmem_budget_kb=1, prefer_pallas=False)
    plan = DispatchPlan(key="k")
    with port.recording(plan):
        y = port.linear(torch.from_numpy(x), tq, name="big")
    want = ref.linear(jnp.asarray(x), _jax_q(tq), name="big")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    (entry,) = plan.entries
    assert not entry.offload and entry.kernel == "q8_matmul"
    assert entry.backend == "hopper"
    port.ledger.commit(plan)
    assert port.stats.fallback_calls == ref.stats.fallback_calls == 1
    assert port.stats.by_backend == {"hopper": 1}
    with pytest.raises(KeyError):
        with REGISTRY.force("no_such_backend"):
            pass
