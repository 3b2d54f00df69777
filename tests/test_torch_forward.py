"""The port's full-sequence model API (``forward``, ``hidden_forward``,
``loss_fn``) against the reference's, on the CPU at every arch's smoke
config (``scan_layers=False``), with identical weights (the reference's
``init_params`` through ``convert.py``) and numpy-seeded batches:

- logits, hidden states and losses with ``engine=None`` and through the
  offload engine in Q8_0 and bf16 (bursts None/256/32): f32 within 1e-5
  of the largest logit, the bf16 kernel's route (Q8_0 off, an engine on)
  within 2e-2; the MoE load-balance loss; the plan entries each forward
  records, entry for entry;
- ``attn_impl="flash"`` against the reference's flash and the port's
  chunked attention, model-wide;
- ``_chunked_attention`` and ``_flash_attention`` (its plain version here)
  on the reference's five attention shapes, at 1e-5;
- ``ssd_scan`` against ``ssd_reference`` at chunks 4/8/16/32, and both
  against the reference's, with a carried state;
- ``_ce_of_logits`` with pad columns and masked labels; ``loss_fn``'s
  chunked readout (S = 1024, ``ce_chunk`` 512);
- Whisper's ``decode_train``;
- a teacher-forced ``forward`` against the ``serve_step`` loop (dense,
  SSM, MoE at a no-drop capacity, hybrid, VLM, Whisper), as the
  reference's ``test_prefill_decode_consistency`` holds its own.

The MoE models run in bf16 only: the reference's ``moe_ffn`` fails on
Q8_0 expert stacks (ROADMAP Quirks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ALL_ARCHS as JAX_ARCHS
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.core.plan import DispatchPlan as JaxDispatchPlan
from repro.core.qformats import quantize_tree as jax_quantize_tree
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.models import whisper as jax_whisper
from repro.serve.engine import _keep_dense as jax_keep_dense
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import DispatchPlan
from repro_torch.core.qformats import quantize_tree
from repro_torch.models import attention, model, ssm, whisper
from repro_torch.serve.engine import _keep_dense

ARCHS = sorted(JAX_ARCHS)
MOE_ARCHS = ("arctic-480b", "jamba-v0.1-52b", "olmoe-1b-7b")
BURSTS = [None, 256, 32]
B, S, PATCHES = 2, 16, 4
PLAN_FIELDS = ("name", "m", "k", "n", "kernel", "burst")


def _cases():
    for arch in ARCHS:
        for quant in ("q8_0", "none"):
            if quant == "q8_0" and arch in MOE_ARCHS:
                continue
            for burst in BURSTS:
                yield arch, quant, burst


_PARAMS = {}


def _smoke(arch, **overrides):
    """(reference cfg, reference params, port cfg, port params), the same
    weights, made once an arch."""
    if arch not in _PARAMS:
        jp = jax_model.init_params(jax.random.PRNGKey(0),
                                   jax_smoke_config(arch), 64)
        _PARAMS[arch] = (jp, from_jax_params(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    jp, tp = _PARAMS[arch]
    return (dataclasses.replace(jax_smoke_config(arch), **overrides), jp,
            dataclasses.replace(get_smoke_config(arch), **overrides), tp)


def _quantized(arch, quant):
    """Both trees, quantized to Q8_0 by each package's own rule when
    ``quant == "q8_0"``."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    if quant == "q8_0":
        return (jax_quantize_tree(jp, jax_keep_dense),
                quantize_tree(tp, _keep_dense))
    return jp, tp


def _batch(cfg, b=B, s=S, seed=0):
    """(reference batch, port batch): the same numpy-drawn tokens, labels
    (a few masked with -1), and a VLM's patches or Whisper's mel."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, :2] = -1
    arrays = {"tokens": toks, "labels": labels}
    if cfg.family == "audio":
        arrays["mel"] = rng.standard_normal(
            (b, s, cfg.n_mels)).astype(np.float32)
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (b, PATCHES, cfg.vision_embed_dim)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in arrays.items()}
    return jb, tb


def _engines(burst):
    if burst is None:
        return None, None
    return (JaxOffloadEngine(prefer_pallas=False, burst=burst),
            OffloadEngine(burst=burst))


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _entries(plan):
    return [tuple(getattr(e, f) for f in PLAN_FIELDS) for e in plan]


# ---------------------------------------------------------------------------
# The model API
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,quant,burst", list(_cases()))
def test_forward_hidden_and_loss_match_reference(arch, quant, burst):
    """``forward``, ``hidden_forward`` and ``loss_fn`` against the
    reference's on the same weights and batch, and the plan entries that
    one forward records on each side. Where the dense weights run on the
    bf16 kernel (quant "none" through an engine) both operands of every
    linear round to bf16, and the tolerance is 2e-2; else 1e-5."""
    jcfg, _, tcfg, _ = _smoke(arch)
    jp, tp = _quantized(arch, quant)
    jb, tb = _batch(tcfg)
    tol = 2e-2 if (quant, burst is None) == ("none", False) else 1e-5
    je, te = _engines(burst)

    jl, jaux = jax_model.forward(jp, jcfg, jb, engine=je)
    jh, _ = jax_model.hidden_forward(jp, jcfg, jb, engine=je)
    jloss, jm = jax_model.loss_fn(jp, jcfg, jb, engine=je)
    with torch.inference_mode():
        tl, taux = model.forward(tp, tcfg, tb, engine=te)
        th, _ = model.hidden_forward(tp, tcfg, tb, engine=te)
        tloss, tm = model.loss_fn(tp, tcfg, tb, engine=te)
    assert tl.shape == (B, S, tcfg.padded_vocab)
    _close(tl, jl, tol)
    _close(th, jh, tol)
    _close(tloss, jloss, tol)
    _close(tm["ce"], jm["ce"], tol)
    _close(taux, jaux, 1e-5)
    assert float(tm["ntok"]) == float(jm["ntok"]) == B * (S - 2)
    if arch in MOE_ARCHS:
        assert float(taux) > 0
    if burst is None:
        return
    jplan, tplan = JaxDispatchPlan(), DispatchPlan()
    with je.recording(jplan):
        jax_model.forward(jp, jcfg, jb, engine=je)
    with te.recording(tplan), torch.inference_mode():
        model.forward(tp, tcfg, tb, engine=te)
    assert _entries(tplan) == _entries(jplan) and len(tplan)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "llava-next-mistral-7b",
                                  "jamba-v0.1-52b", "whisper-tiny"])
def test_flash_forward_matches_reference_and_chunked(arch):
    """``attn_impl="flash"`` model-wide: the port's logits within 1e-5 of
    the reference's flash forward, and of its own chunked forward (the
    reference holds its two at 1e-4)."""
    jcfg, jp, tcfg, tp = _smoke(arch, attn_impl="flash")
    jb, tb = _batch(tcfg, seed=1)
    with torch.inference_mode():
        tl, _ = model.forward(tp, tcfg, tb)
        tc, _ = model.forward(tp, dataclasses.replace(
            tcfg, attn_impl="chunked"), tb)
    _close(tl, jax_model.forward(jp, jcfg, jb)[0], 1e-5)
    _close(tl, tc, 1e-5)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 64, 64, 4, 2, 16, True),
    (1, 128, 128, 8, 8, 32, True),
    (2, 32, 96, 4, 1, 16, False),     # cross-attention shape
    (2, 1, 64, 4, 2, 16, True),       # single-query
    (2, 48, 48, 4, 4, 16, True),      # ragged vs the reference's k_chunk
])
def test_attention_impls_match_reference(b, sq, sk, hq, hkv, d, causal):
    """The reference's ``tests/test_attention_impls.py`` shapes: the
    port's chunked and flash attention (the kernel's plain version on the
    CPU) within 1e-5 of the reference's and of each other."""
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want_c = jax_attention._chunked_attention(jq, jk, jv, causal, chunk=32)
    want_f = jax_attention._flash_attention(jq, jk, jv, causal, chunk=32,
                                            k_chunk=32)
    got_c = attention._chunked_attention(tq, tk, tv, causal, chunk=32)
    got_f = attention._flash_attention(tq, tk, tv, causal=causal)
    _close(got_c, want_c, 1e-5)
    _close(got_f, want_f, 1e-5)
    _close(got_f, got_c, 1e-5)


def test_chunked_attention_q_offset_matches_reference():
    """A causal query window that starts at ``q_offset``: query i sees keys
    up to q_offset + i."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    want = jax_attention._chunked_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), True, chunk=4,
        q_offset=16)
    got = attention._chunked_attention(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
        True, chunk=4, q_offset=16)
    _close(got, want, 1e-5)


def test_cross_attention_takes_kv_from_memory_unmasked():
    """``attention`` with ``memory``: K/V from the memory, no causal mask
    and no RoPE, against the reference on llava's smoke attention."""
    jcfg, jp, tcfg, tp = _smoke("llava-next-mistral-7b")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 10, tcfg.d_model)).astype(np.float32)
    jattn = jax.tree_util.tree_map(lambda a: a[0],
                                   jp["stack"]["blocks"][0]["attn"])
    for memory in (None, mem):
        want = jax_attention.attention(
            jattn, jcfg, jnp.asarray(x),
            memory=None if memory is None else jnp.asarray(memory))
        got = attention.attention(
            tp["stack"]["blocks"][0]["attn"], tcfg, torch.from_numpy(x),
            memory=None if memory is None else torch.from_numpy(memory))
        _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# The chunked SSD scan
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, b=2, s=32, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, init


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_scan_matches_recurrence_and_reference(chunk):
    """The chunked scan against the naive recurrence (the reference holds
    its two at 2e-4) and both against the reference's, from a zero and
    from a carried state: y and the final state within 1e-5."""
    arrays = _ssd_inputs(chunk)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    for init in (None, -1):
        jinit = None if init is None else j[init]
        tinit = None if init is None else t[init]
        jy, jst = jax_ssm.ssd_scan(*j[:5], chunk, initial_state=jinit)
        ty, tst = ssm.ssd_scan(*t[:5], chunk, initial_state=tinit)
        ry, rst = ssm.ssd_reference(*t[:5], initial_state=tinit)
        jry, jrst = jax_ssm.ssd_reference(*j[:5], initial_state=jinit)
        _close(ty, jy, 1e-5)
        _close(tst, jst, 1e-5)
        _close(ry, jry, 1e-5)
        _close(rst, jrst, 1e-5)
        _close(ty, ry, 2e-4)
        _close(tst, rst, 2e-4)


def test_ssm_mixer_matches_reference():
    """mamba2's smoke mixer over a full sequence (in_proj, the causal conv,
    the scan, the gated norm, out_proj) within 1e-5."""
    jcfg, jp, tcfg, tp = _smoke("mamba2-780m")
    u = np.random.default_rng(8).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    jssm = jax.tree_util.tree_map(lambda a: a[0],
                                  jp["stack"]["blocks"][0]["ssm"])
    want = jax_ssm.ssm_mixer(jssm, jcfg, jnp.asarray(u))
    got = ssm.ssm_mixer(tp["stack"]["blocks"][0]["ssm"], tcfg,
                        torch.from_numpy(u))
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------
def test_ce_of_logits_masks_pad_columns_and_labels():
    """Pad columns (>= vocab_size) are out of the log-sum-exp, labels < 0
    out of both sums: the sums within 1e-5 of the reference's."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32) * 4
    logits[..., 32:] += 50.0            # pad columns that would dominate
    labels = rng.integers(0, 32, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    want = jax_model._ce_of_logits(jnp.asarray(logits), jnp.asarray(labels),
                                   32)
    got = model._ce_of_logits(torch.from_numpy(logits),
                              torch.from_numpy(labels).long(), 32)
    _close(got[0], want[0], 1e-5)
    assert float(got[1]) == float(want[1]) == 8.0


def test_loss_fn_chunks_the_readout():
    """S = 1024 with ``ce_chunk`` 512: two readout chunks whose CE sums add
    to the reference's scan within 1e-5, and equal to the port's unchunked
    loss. The reference's scan records lm_head once (its body is traced
    once); the port runs, and records, one readout a chunk."""
    jcfg, jp, tcfg, tp = _smoke("qwen2.5-14b")
    jb, tb = _batch(tcfg, b=1, s=1024, seed=3)
    je, te = _engines(256)
    want, _ = jax_model.loss_fn(jp, jcfg, jb, engine=je, ce_chunk=512)
    tplan = DispatchPlan()
    with torch.inference_mode(), te.recording(tplan):
        got, metrics = model.loss_fn(tp, tcfg, tb, engine=te, ce_chunk=512)
    with torch.inference_mode():
        whole, _ = model.loss_fn(tp, tcfg, tb, engine=te, ce_chunk=1024)
    _close(got, want, 1e-5)
    _close(got, whole, 1e-5)
    assert float(metrics["ntok"]) == 1022
    heads = [e for e in tplan if e.name == "lm_head"]
    assert [e.m for e in heads] == [512, 512]


def test_decode_train_matches_reference():
    """Whisper's teacher-forced decoder over encoder memory: logits and the
    hidden states (``return_hidden``) within 1e-5."""
    jcfg, jp, tcfg, tp = _smoke("whisper-tiny")
    rng = np.random.default_rng(6)
    mem = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    for hidden in (False, True):
        want = jax_whisper.decode_train(jp, jcfg, jnp.asarray(toks),
                                        jnp.asarray(mem),
                                        return_hidden=hidden)
        got = whisper.decode_train(tp, tcfg, torch.from_numpy(toks).long(),
                                   torch.from_numpy(mem),
                                   return_hidden=hidden)
        _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# The forward against the decode loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mamba2-780m",
                                  "olmoe-1b-7b", "jamba-v0.1-52b",
                                  "llava-next-mistral-7b", "whisper-tiny"])
def test_teacher_forced_forward_matches_serve_step_loop(arch):
    """The reference's ``test_prefill_decode_consistency`` on the port:
    teacher-forced logits equal ``serve_step`` fed the same tokens one at
    a time, within 2e-4 (a MoE's capacity made no-drop, since drops are
    sequence-level by design; a VLM's forward on tokens alone, as it is
    served)."""
    _, _, tcfg, tp = _smoke(arch)
    if tcfg.moe is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=8.0))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, (2, 10)).astype(np.int64))
    batch = {"tokens": toks, "labels": toks}
    memory = None
    if tcfg.family == "audio":
        batch["mel"] = torch.from_numpy(rng.standard_normal(
            (2, 12, tcfg.n_mels)).astype(np.float32))
        memory = whisper.encode(tp, tcfg, batch["mel"])
    with torch.inference_mode():
        full, _ = model.forward(tp, tcfg, batch)
        st = model.init_serve_state(tp, tcfg, 2, 32, memory=memory)
        steps = []
        for t in range(toks.shape[1]):
            lg, st = model.serve_step(tp, tcfg, toks[:, t:t + 1], st)
            steps.append(lg[:, 0])
    _close(full, torch.stack(steps, dim=1), 2e-4)
