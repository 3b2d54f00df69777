"""The port's Whisper slice against the reference, on identical weights
carried over by ``convert.py``: encoder memory, per-step logits, greedy
tokens with and without the offload engine, dispatch plans and ledger
totals on the smoke config, the dense path with flash attention, and
full-width whisper-tiny cases (Q8_0, and dense with flash attention).

Smoke-config tolerance 1e-4 (f32): the two frameworks sum in different
orders through two encoder and two decoder layers; observed differences
are around 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.core.qformats import quantize_tree as jax_quantize_tree
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro.models import whisper as jax_whisper
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.engine import _keep_dense as jax_keep_dense
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.qformats import quantize_tree
from repro_torch.models import attention, model, whisper
from repro_torch.serve.engine import ServeEngine, _keep_dense

TOL = dict(rtol=1e-4, atol=1e-4)
PLAN_FIELDS = ("name", "m", "k", "n", "dtype", "offload", "burst", "kernel",
               "k_main", "k_res")


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


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("burst", [None, 32])
def test_encoder_memory_and_step_logits(smoke, quant, burst):
    """Encoder memory, then four teacher-forced decode steps: logits
    allclose at every step (engine=None, or an offload engine whose
    burst of 32 sends every main segment to the kernels' plain
    versions)."""
    jcfg, jparams, tcfg, tparams, mel = smoke
    if quant:
        jparams = jax_quantize_tree(jparams, jax_keep_dense)
        tparams = quantize_tree(tparams, _keep_dense)
    jeng, teng = _engines(burst)
    jmem = jax_whisper.encode(jparams, jcfg, jnp.asarray(mel), engine=jeng)
    tmem = whisper.encode(tparams, tcfg, torch.from_numpy(mel), engine=teng)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    jst = jax_model.init_serve_state(jparams, jcfg, 2, 16, memory=jmem,
                                     engine=jeng)
    tst = model.init_serve_state(tparams, tcfg, 2, 16, memory=tmem,
                                 engine=teng)
    for tok in (1, 5, 7, 11):
        jlog, jst = jax_model.serve_step(
            jparams, jcfg, jnp.full((2, 1), tok, jnp.int32), jst, engine=jeng)
        tlog, tst = model.serve_step(
            tparams, tcfg, torch.full((2, 1), tok), tst, engine=teng)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert tst.step == 4 and tst.layer_states.self_kv[0].length == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [4, 6, 2048])
def test_chunked_attention_matches_reference(chunk, dtype):
    """The encoder's query-chunked attention, in several chunks (4), in
    one chunk because 6 does not divide 24, and in one whole chunk; bf16
    inputs cast their probabilities to bf16 as the reference does
    (tolerance 1e-2 there: one bf16 rounding of values of O(1))."""
    rng = np.random.default_rng(chunk)
    q, k, v = (rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(dtype)
                  for a in (tq, tk, tv))
    got = attention._chunked_attention(tq, tk, tv, chunk=chunk)
    want = jax_attention._chunked_attention(jq, jk, jv, causal=False,
                                            chunk=chunk)
    assert got.dtype == tq.dtype
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(causal, dtype):
    """The port's _flash_attention (the (B, H) fold, the GQA repeat and the
    kernel's plain version) against the reference's, at Sq = Sk = 40, which
    the kernel's key blocks of 64 do not divide (the reference's k-blocks
    fall back to one block of 40). f32 at 2e-5; bf16 at 1e-2, one bf16
    rounding of values of O(1), as the chunked test above."""
    rng = np.random.default_rng(40 + causal)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(dtype)
                  for a in (tq, tk, tv))
    got = attention._flash_attention(tq, tk, tv, causal=causal)
    want = jax_attention._flash_attention(jq, jk, jv, causal=causal,
                                          chunk=2048)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-2))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("burst", [None, 256, 32])
def test_dense_flash_greedy_tokens_exact(smoke, burst):
    """quant="none" with attn_impl="flash": the encoder's attention runs
    flash_attention_fwd (its plain version here), every dense main segment
    bf16_matmul; tokens exact with the reference's, with and without an
    offload engine."""
    jcfg, jparams, tcfg, tparams, mel = smoke
    jcfg = dataclasses.replace(jcfg, attn_impl="flash")
    tcfg = dataclasses.replace(tcfg, attn_impl="flash")
    jeng, teng = _engines(burst)
    jres = JaxServeEngine(jcfg, jparams, max_len=64, quant="none",
                          offload=jeng).transcribe(mel, max_new=8)
    tres = ServeEngine(tcfg, tparams, max_len=64, quant="none", offload=teng,
                       device="cpu").transcribe(mel, max_new=8)
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert [r.steps for r in tres] == [r.steps for r in jres]


@pytest.mark.parametrize("quant", ["q8_0", "none"])
@pytest.mark.parametrize("burst", [None, 256, 32])
def test_greedy_tokens_exact(smoke, quant, burst):
    jcfg, jparams, tcfg, tparams, mel = smoke
    jeng, teng = _engines(burst)
    jres = JaxServeEngine(jcfg, jparams, max_len=64, quant=quant,
                          offload=jeng).transcribe(mel, max_new=8)
    tres = ServeEngine(tcfg, tparams, max_len=64, quant=quant, offload=teng,
                       device="cpu").transcribe(mel, max_new=8)
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert [r.steps for r in tres] == [r.steps for r in jres]


@pytest.mark.parametrize("burst", [256, 32])
def test_plans_and_ledger_match_reference(smoke, burst):
    """Prefill and step plans equal the reference's entry for entry, and
    the ledger totals are equal, up to one quirk of the reference: its
    plan recording traces ``precompute_cross_kv``'s ``vmap`` over layers
    once, so it records ``dec.cross.k``/``dec.cross.v`` once per prefill
    where the port, which runs every layer, accounts them per layer."""
    jcfg, jparams, tcfg, tparams, mel = smoke
    jeng, teng = _engines(burst)
    je = JaxServeEngine(jcfg, jparams, max_len=64, offload=jeng, eos_id=-1)
    te = ServeEngine(tcfg, tparams, max_len=64, offload=teng, eos_id=-1,
                     device="cpu")
    je.transcribe(mel, max_new=3)
    te.transcribe(mel, max_new=3)
    layers = tcfg.num_layers
    for phase in ("prefill", "step"):
        jplan = je._plans.plans[(phase, "q8_0", 2, 16)].entries
        tplan = te._plans.plans[(phase, "q8_0", 2, 16)].entries
        if phase == "prefill":   # collapse the port's per-layer cross K/V
            tplan = tplan[:-2 * layers] + tplan[-2:]
        assert [tuple(getattr(e, f) for f in PLAN_FIELDS) for e in tplan] == \
            [tuple(getattr(e, f) for f in PLAN_FIELDS) for e in jplan]
    cross = te._plans.plans[("prefill", "q8_0", 2, 16)].entries[-2:]
    extra = layers - 1
    a, b = teng.stats, jeng.stats
    assert a.offloaded_calls == b.offloaded_calls + 2 * extra
    assert a.fallback_calls == b.fallback_calls
    for f in ("offloaded_flops", "residual_flops", "fallback_flops"):
        assert getattr(a, f) == getattr(b, f) + extra * sum(
            getattr(e, f) for e in cross), f
    assert a.by_kernel == {k: v * (layers if k.startswith("dec.cross") else 1)
                           for k, v in b.by_kernel.items()}


def test_entry_points_raise_without_a_card(smoke):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, tparams, _ = smoke
    with pytest.raises(RuntimeError):
        ServeEngine(tcfg, tparams)
    with pytest.raises(RuntimeError):
        model.init_params(torch.Generator().manual_seed(0), tcfg)


def _full_width_vs_reference(quant, attn_impl, mem_tol, logit_tol):
    """whisper-tiny at its published widths in float32, 1500 frames,
    through an offload engine (burst 256: every K = 384 linear splits
    256 + 128), four greedy steps. Encoder memory within ``mem_tol`` and
    step logits within ``logit_tol`` of the reference; tokens exact
    wherever the reference's top-1/top-2 margin exceeds ``logit_tol``."""
    over = dict(dtype="float32", param_dtype="float32", attn_impl=attn_impl)
    jcfg = dataclasses.replace(jax_config("whisper-tiny"), **over)
    tcfg = dataclasses.replace(get_config("whisper-tiny"), **over)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    mel = np.random.default_rng(1).standard_normal(
        (1, 1500, 80)).astype(np.float32)
    je = JaxServeEngine(jcfg, jparams, max_len=16, quant=quant,
                        offload=JaxOffloadEngine(prefer_pallas=False))
    te = ServeEngine(tcfg, tparams, max_len=16, quant=quant,
                     offload=OffloadEngine(), device="cpu")
    del jparams, tparams
    jmem, jst = je._prefill_jit(je._serve_params, jnp.asarray(mel))
    tmem, tst = te.prefill(torch.from_numpy(mel))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), rtol=mem_tol,
                               atol=mem_tol)
    tok = 1
    for _ in range(4):
        jlog, jst = je._decode_jit(je._serve_params,
                                   jnp.full((1, 1), tok, jnp.int32), jst)
        tlog, tst = te.step(torch.full((1, 1), tok), tst)
        jl = np.asarray(jlog)[0, 0, :jcfg.vocab_size]
        tl = tlog.numpy()[0, 0, :tcfg.vocab_size]
        np.testing.assert_allclose(tl, jl, rtol=logit_tol, atol=logit_tol)
        top2 = np.sort(jl)[-2:]
        if top2[1] - top2[0] > logit_tol:
            assert int(tl.argmax()) == int(jl.argmax())
        tok = int(jl.argmax())        # teacher-force the reference's token


def test_full_width_whisper_tiny():
    """Q8_0 weights, chunked encoder attention. Tolerance 1e-4: f32 sums
    in another order through eight layers and the 51,872-wide readout;
    observed about 1e-6."""
    _full_width_vs_reference("q8_0", "chunked", TOL["atol"], TOL["atol"])


def test_full_width_whisper_tiny_dense_flash():
    """Dense weights (the FP16 path) and flash encoder attention.
    Tolerance 2e-2 on the encoder memory (values up to about 4.6) and 1e-2
    on the logits (up to about 1.6): bf16_matmul rounds both operands to
    bf16 on both sides, so an f32 activation that the two frameworks sum
    to different last bits can round to neighbouring bf16 values (a
    relative step of 2^-8) and carry through the layers. Observed 8.4e-3
    and 4.5e-3, the same with chunked attention: the flash kernel's key
    blocks of 64 against the reference's one block of 1500 add nothing
    visible in f32."""
    _full_width_vs_reference("none", "flash", 2e-2, 1e-2)
