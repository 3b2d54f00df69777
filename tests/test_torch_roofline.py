"""The port's roofline analysis (``repro_torch.roofline``) against the
reference's (``repro.roofline``), on the CPU.

- ``model_flops`` equals the reference's for every arch of the dry-run
  matrix at every shape; ``shape_applicable`` and ``dryrun_cells`` agree
  cell for cell.
- ``roofline_terms`` and ``RooflineReport`` give the reference's numbers
  when handed the reference's hardware figures (v5e, only here).
- The counter (``op_cost.OpCounter``) against the reference's HLO walk
  (``analyze_hlo_text``) on the same tiny programs: the (64, 128) x (128,
  256) dot of ``tests/test_roofline.py`` (FLOPs and bytes equal), and a
  9-iteration loop of tanh(c @ w), whose HLO also runs the loop's counter
  on the device (one add an iteration, 9 FLOPs the eager loop does on the
  host).
- Kernel prices: each wrapper under a counter records its route's FLOPs
  and bytes (the table of ``roofline/op_cost.py``), and none of its plain
  version's operations; without a counter nothing is recorded. A smoke
  whisper transcribe's counted kernel FLOPs equal its plan entries'
  2 m k n, and its bytes follow the table.
- Attribution over a mesh: a data shard's forward and its backward land
  on its entries, a tensor-parallel model shard's on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import ALL_SHAPES as JAX_SHAPES
from repro.configs.base import shape_applicable as jax_shape_applicable
from repro.configs.registry import ASSIGNED as JAX_ASSIGNED
from repro.configs.registry import dryrun_cells as jax_dryrun_cells
from repro.configs.registry import get_config as jax_get_config
from repro.roofline import analysis as jax_analysis
from repro.roofline.hlo_cost import analyze_hlo_text
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ALL_SHAPES, SHAPES_BY_NAME, \
    shape_applicable
from repro_torch.configs.registry import ASSIGNED, dryrun_cells
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.qformats import quantize_q8_0
from repro_torch.kernels.bf16_matmul import bf16_matmul
from repro_torch.kernels.flash_attention import flash_attention_bwd, \
    flash_attention_fwd
from repro_torch.kernels.q8_matmul import q8_matmul
from repro_torch.kernels.q8_matvec import q8_matvec
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import attention, layers
from repro_torch.models import model as model_lib
from repro_torch.roofline import analysis, op_cost
from repro_torch.serve.engine import ServeEngine
from repro_torch.tuning import cost as tuning_cost

#: the reference's hardware figures, handed to the port's arithmetic
V5E = analysis.HW("v5e", hbm_bw=jax_analysis.V5E.hbm_bw,
                  peak_bf16=jax_analysis.V5E.peak_flops,
                  peak_f32=jax_analysis.V5E.peak_flops,
                  link_bw=jax_analysis.V5E.link_bw)


# ---------------------------------------------------------------------------
# model_flops, shapes and cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape, jshape in zip(ALL_SHAPES, JAX_SHAPES):
        assert shape == SHAPES_BY_NAME[jshape.name]
        assert (shape.seq_len, shape.global_batch, shape.kind,
                shape.is_decode) == (jshape.seq_len, jshape.global_batch,
                                     jshape.kind, jshape.is_decode)
        assert analysis.model_flops(cfg, shape) == \
            jax_analysis.model_flops(jcfg, jshape)
        assert shape_applicable(cfg, shape) == \
            jax_shape_applicable(jcfg, jshape)
        assert cfg.uses_full_attention == jcfg.uses_full_attention


def test_dryrun_cells_equal_the_reference():
    assert sorted(ASSIGNED) == sorted(JAX_ASSIGNED)
    assert sorted(dryrun_cells()) == sorted(jax_dryrun_cells())


# ---------------------------------------------------------------------------
# The roofline arithmetic
# ---------------------------------------------------------------------------
def _coll(mod):
    c = mod.CollectiveStats()
    c.add("all-gather", 1 << 20, 16, "g")
    c.add("all-reduce", 3 << 18, 4, "r")
    c.add("reduce-scatter", 1 << 16, 16, "s")
    c.add("collective-permute", 4096, 2, "p")
    return c


def test_collectives_and_terms_equal_the_reference():
    mine, ref = _coll(analysis), _coll(jax_analysis)
    assert (mine.raw_bytes, mine.wire_bytes, mine.count, mine.by_op,
            mine.by_op_count) == (ref.raw_bytes, ref.wire_bytes, ref.count,
                                  ref.by_op, ref.by_op_count)
    got = analysis.roofline_terms(3.1e12, 7.7e9, mine, chips=256, hw=V5E)
    want = jax_analysis.roofline_terms(3.1e12, 7.7e9, ref, chips=256)
    assert got == want
    with pytest.raises(ValueError, match="unknown collective"):
        mine.add("broadcast", 1, 2, "")


def test_report_equals_the_reference():
    kw = dict(arch="phi3-mini-3.8b", shape="train_4k", mesh="pod_16x16",
              chips=256, flops_per_device=4.2e13, bytes_per_device=9.1e10,
              collective_raw_bytes=3_000_000, collective_wire_bytes=2.5e6,
              compute_s=0.21, memory_s=0.11, collective_s=0.06,
              collective_wire_s=0.05, bottleneck="compute",
              model_flops_total=8.1e15, useful_flop_ratio=0.75)
    mine = analysis.RooflineReport(**kw, hw=V5E)
    ref = jax_analysis.RooflineReport(**kw)
    assert mine.step_s == ref.step_s
    assert mine.roofline_fraction == ref.roofline_fraction
    d = mine.to_dict()
    assert d["roofline_fraction"] == ref.to_dict()["roofline_fraction"]
    assert d["hw"]["name"] == "v5e"
    # the port's default card: the H100's figures, one home for them
    assert analysis.H100 is tuning_cost.H100
    assert analysis.RooflineReport(**kw).roofline_fraction == \
        pytest.approx(ref.roofline_fraction * 197e12 / 989e12)


# ---------------------------------------------------------------------------
# The counter against the reference's HLO walk
# ---------------------------------------------------------------------------
def _hlo(f, *structs):
    return analyze_hlo_text(jax.jit(f).lower(*structs).compile().as_text())


def test_dot_counted_as_the_reference_counts_it():
    m, k, n = 64, 128, 256
    ref = _hlo(lambda a, b: a @ b, jax.ShapeDtypeStruct((m, k), jnp.float32),
               jax.ShapeDtypeStruct((k, n), jnp.float32))
    with FakeTensorMode():
        a, b = torch.empty(m, k), torch.empty(k, n)
        with op_cost.OpCounter() as c:
            a @ b
    assert c.flops[0] == ref.flops == 2 * m * k * n
    assert c.bytes[0] == ref.bytes
    assert c.matmul_flops[0] == c.flops[0] and c.ops[0] == 1


def test_loop_counted_as_the_reference_counts_it():
    n_iter, m = 9, 128

    def f(x, w):
        return jax.lax.fori_loop(0, n_iter, lambda i, c: jnp.tanh(c @ w), x)
    ref = _hlo(f, jax.ShapeDtypeStruct((m, m), jnp.float32),
               jax.ShapeDtypeStruct((m, m), jnp.float32))
    assert n_iter in ref.while_trips.values()
    c_, w = torch.randn(m, m), torch.randn(m, m)
    with op_cost.OpCounter() as c:
        for _ in range(n_iter):
            c_ = torch.tanh(c_ @ w)
    # the HLO's loop counter: one add an iteration on the device
    assert c.flops[0] + n_iter == ref.flops
    assert c.matmul_flops[0] == n_iter * 2 * m ** 3


def test_composites_count_their_parts_under_inference_mode():
    a, b = torch.randn(2, 64, 32), torch.randn(2, 32, 16)
    with op_cost.OpCounter() as c, torch.inference_mode():
        torch.einsum("bij,bjk->bik", a, b)
        a @ b
    assert c.matmul_flops[0] == 2 * (2 * 2 * 64 * 32 * 16)


# ---------------------------------------------------------------------------
# Kernel prices
# ---------------------------------------------------------------------------
def _q8(n, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = quantize_q8_0(torch.randn((n, k), generator=g) * 0.05)
    return w.flat_qs(), w.scales


@pytest.mark.parametrize("case", ["q8_matvec", "q8_matmul-bf16",
                                  "q8_matmul-f32", "bf16-gemv",
                                  "bf16-wgmma", "bf16-cvt"])
def test_kernel_prices_follow_the_table(case):
    m, n, k = (4 if case in ("q8_matvec", "bf16-gemv") else 40), 96, 128
    x = torch.randn((m, k))
    if case.startswith("q8"):
        qs, sc = _q8(n, k)
        fn = q8_matvec if case == "q8_matvec" else q8_matmul
        xdt = torch.bfloat16 if case == "q8_matmul-bf16" else torch.float32
        args = (x.to(xdt), qs, sc)
        weight = n * k + n * (k // 32) * 4
        route, executed = {"q8_matvec": ("q8_matvec_kernel", 1),
                           "q8_matmul-bf16": ("q8_wgmma_kernel", 1),
                           "q8_matmul-f32": ("q8_split_tc_kernel", 3)}[case]
    else:
        fn = bf16_matmul
        wdt = torch.float32 if case == "bf16-cvt" else torch.bfloat16
        args = (x.to(torch.bfloat16) if case != "bf16-cvt" else x,
                torch.randn((n, k)).to(wdt))
        weight = n * k * args[1].element_size()
        route, executed = {"bf16-gemv": "gemv_bf16_kernel",
                           "bf16-wgmma": "wgmma_kernel",
                           "bf16-cvt": "bf16_cvt_tc_kernel"}[case], 1
    want = fn(*args)
    with op_cost.OpCounter() as c:
        got = fn(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    flops = 2 * m * n * k
    moved = weight + m * k * args[0].element_size() + m * n * 4
    assert c.kernel_totals() == {route: {
        "calls": 1.0, "flops": flops, "executed": executed * flops,
        "bytes": moved, "weight_bytes": weight}}
    # the plain version's operations are not counted: the launch alone
    assert c.ops[0] == 1 and c.flops[0] == executed * flops
    assert c.matmul_flops[0] == c.flops[0]


def test_plain_version_alone_counts_its_operations():
    """The same arithmetic outside the wrapper counts each of its own
    operations: the wrapper's record replaces them, never adds to them."""
    from repro_torch.kernels.q8_matvec import q8_matvec_plain
    qs, sc = _q8(64, 128)
    x = torch.randn((2, 128))
    with op_cost.OpCounter() as c:
        q8_matvec_plain(x, qs, sc)
    assert c.ops[0] > 1 and not c.kernels
    with op_cost.OpCounter() as c:
        q8_matvec(x, qs, sc)
    assert c.ops[0] == 1 and list(c.kernels) == ["q8_matvec_kernel"]


def test_no_record_without_a_counter():
    qs, sc = _q8(64, 128)
    assert op_cost.active() is None
    q8_matvec(torch.randn((1, 128)), qs, sc)
    op_cost.collective("all-gather", 10, 4)        # a no-op
    with op_cost.at(shard=3):                      # a no-op
        pass


@pytest.mark.parametrize("causal", [False, True])
def test_flash_prices_through_the_autograd_core(causal):
    bh, sq, sk, d = 3, 48, 80 if not causal else 48, 32
    q, k, v = (torch.randn((bh, s, d), requires_grad=True)
               for s in (sq, sk, sk))
    with op_cost.OpCounter() as c:
        out = attention._FlashCore.apply(q, k, v, causal, True)
        out.sum().backward()
    pairs = op_cost.causal_pairs(sq, sk, causal)
    assert pairs == (sq * (sq + 1) // 2 if causal else sq * sk)
    tot = c.kernel_totals()
    fwd, bwd = tot["flash_fwd_kernel"], tot["flash_bwd_simt"]
    assert fwd["flops"] == 4 * bh * d * pairs
    assert fwd["bytes"] == 4 * (bh * sq * d + 2 * bh * sk * d
                                + bh * sq * d + bh * sq)
    assert bwd["flops"] == 10 * bh * d * pairs
    assert bwd["bytes"] == 4 * (3 * bh * sq * d + 2 * bh * sk * d + bh * sq
                                + bh * sq * d + 2 * bh * sk * d)
    assert fwd["calls"] == bwd["calls"] == 1
    # outside the wrapper: a direct call of the forward prices the same
    with op_cost.OpCounter() as c2, torch.no_grad():
        flash_attention_fwd(q, k, v, causal=causal)
    assert c2.kernel_totals()["flash_fwd_kernel"]["flops"] == fwd["flops"]


def test_f32_products_price_the_cards_route():
    x = torch.randn((3, 5, 64)).to(torch.bfloat16)
    w = torch.randn((48, 64)).to(torch.bfloat16)
    with op_cost.OpCounter() as c:
        y = layers._dot_f32(x, w)
    assert y.dtype == torch.float32
    assert c.kernel_totals() == {"f32_product": {
        "calls": 1.0, "flops": 2 * 15 * 48 * 64,
        "executed": 2 * 15 * 48 * 64,
        "bytes": 15 * 64 * 2 + 48 * 64 * 2 + 15 * 48 * 4,
        "weight_bytes": 48 * 64 * 2}}
    with op_cost.OpCounter() as c:          # an f32 product: as it runs
        layers._dot_f32(x.float(), w.float())
    assert not c.kernels and c.matmul_flops[0] == 2 * 15 * 48 * 64


def test_whisper_transcribe_counted_by_its_plans():
    """A smoke whisper transcribe on the CPU (Q8_0, burst 32: every
    linear's K on the kernels): the kernels' FLOPs are the plan entries'
    2 m k n, their weight bytes 1.125 a weight, over the prefill once and
    each step it ran."""
    cfg = get_smoke_config("whisper-tiny")
    params = model_lib.init_params(torch.Generator().manual_seed(0), cfg,
                                   64, device="cpu")
    eng = ServeEngine(cfg, params, max_len=16, quant="q8_0",
                      offload=OffloadEngine(burst=32), eos_id=None,
                      device="cpu")
    mel = np.random.default_rng(0).standard_normal(
        (1, 16, cfg.n_mels)).astype(np.float32)
    max_new = 3
    with op_cost.OpCounter() as c:
        res = eng.transcribe(mel, max_new=max_new)
    assert res[0].steps == max_new
    plans = {k[0]: p for k, p in eng._plans.plans.items()}
    runs = {"prefill": 1, "step": max_new}
    entries = [(e, runs[ph]) for ph, p in plans.items() for e in p.entries
               if e.k_main]
    assert entries and all(e.k_res == 0 for e, _ in entries)
    tot = c.kernel_totals()
    assert set(tot) <= {"q8_matvec_kernel", "q8_split_tc_kernel"}
    assert sum(t["flops"] for t in tot.values()) == sum(
        r * e.flops for e, r in entries)
    assert sum(t["weight_bytes"] for t in tot.values()) == sum(
        r * e.n * e.k * 1.125 for e, r in entries)
    assert sum(t["bytes"] for t in tot.values()) == sum(
        r * (e.n * e.k * 1.125 + e.m * e.k * 4 + e.m * e.n * 4)
        for e, r in entries)
    assert sum(t["calls"] for t in tot.values()) == sum(
        r for _, r in entries)


# ---------------------------------------------------------------------------
# Attribution over a mesh
# ---------------------------------------------------------------------------
def test_forward_and_backward_land_on_their_entries():
    mesh = abstract_mesh((2, 2), ("data", "model"))
    f = 2 * 16 * 128 * 128
    with FakeTensorMode():
        w = torch.empty(128, 128, requires_grad=True)
        x = torch.empty(16, 128)
        with op_cost.OpCounter(mesh) as c:
            losses = []
            for i in range(2):
                with op_cost.at(shard=i):
                    h = x @ w
                    for m in range(2):
                        with op_cost.at(model=m):
                            h = h @ w
                    losses.append(h.sum())
            torch.autograd.grad(losses[0] + losses[1], [w])
            with op_cost.at(entries=[1, 3]):
                torch.empty(4).add_(1)
    # entry (i, 0): x @ w and model 0's product, forward (1 + 1) and
    # backward (1 + 2); entry (i, 1): model 1's, forward 1, backward 2
    np.testing.assert_array_equal(c.matmul_flops, [5 * f, 3 * f] * 2)
    assert c.busiest() == 0
    assert c.flops[1] > c.matmul_flops[1] and c.flops[3] > c.matmul_flops[3]


def test_fake_calls_give_the_plain_versions_shapes():
    """Over fake tensors a priced wrapper's checks and empty outputs
    stand in for its plain version: the same shapes and types as the
    plain version's on real tensors, the same record."""
    qs, sc = _q8(96, 128)
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((2, s, 32), generator=g) for s in (24, 40, 40))
    out, lse = flash_attention_fwd(q, k, v, causal=False, return_lse=True)
    calls = [(q8_matvec, (torch.randn((3, 128)), qs, sc), {}),
             (q8_matmul, (torch.randn((40, 128)).to(torch.bfloat16), qs, sc),
              {}),
             (bf16_matmul, (torch.randn((40, 128)),
                            torch.randn((96, 128)).to(torch.bfloat16)), {}),
             (flash_attention_fwd, (q, k, v), {"causal": False,
                                               "return_lse": True}),
             (flash_attention_bwd, (q, k, v, out, torch.randn_like(out),
                                    lse), {"causal": False})]
    for fn, args, kw in calls:
        with op_cost.OpCounter() as real:
            want = fn(*args, **kw)
        mode = FakeTensorMode()
        fake_args = [mode.from_tensor(a) for a in args]
        with mode, op_cost.OpCounter() as c:
            got = fn(*fake_args, **kw)
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        for a, b in pairs:
            assert (a.shape, a.dtype) == (b.shape, b.dtype), fn.__name__
        assert c.kernel_totals() == real.kernel_totals()
        assert c.ops[0] == 1
    with pytest.raises(ValueError):          # the checks still run
        mode = FakeTensorMode()
        with mode, op_cost.OpCounter():
            q8_matvec(mode.from_tensor(torch.randn((3, 64))),
                      mode.from_tensor(qs), mode.from_tensor(sc))


@pytest.mark.parametrize("remat", [False, True])
def test_recomputed_forward_lands_where_the_forward_ran(remat):
    """Under activation checkpointing the backward recomputes the block:
    its part outside the model shards' frames lands on the data shard's
    first entry, as in the forward, whichever node asked for it."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop
    mesh = abstract_mesh((2, 2), ("data", "model"))
    f = 2 * 16 * 128 * 128

    def block(h, w):
        h = torch.tanh(h @ w)                         # whole: entry (i, 0)
        out = 0
        for m in range(2):
            with op_cost.at(model=m):
                out = out + h @ w
        return out
    # the whole block recomputed (no early stop): every product once more
    with FakeTensorMode(), set_checkpoint_early_stop(False):
        w = torch.empty(128, 128, requires_grad=True)
        x = torch.empty(16, 128)
        with op_cost.OpCounter(mesh) as c:
            losses = []
            for i in range(2):
                with op_cost.at(shard=i):
                    y = (checkpoint(block, x, w, use_reentrant=False)
                         if remat else block(x, w))
                    losses.append(y.sum())
            torch.autograd.grad(losses[0] + losses[1], [w])
    # (i, 0): the whole product and model 0's, forward 2, backward 1 + 2,
    # and with remat the forward once more; (i, 1): model 1's, 1 + 2 (+ 1)
    extra = 1 if remat else 0
    np.testing.assert_array_equal(
        c.matmul_flops, [(5 + 2 * extra) * f, (3 + extra) * f] * 2)
