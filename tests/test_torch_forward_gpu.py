"""The full-sequence forward on a CUDA device: ``flash_attention_fwd`` at
the head sizes the LMs need (32, 96, 128), causal and not, ragged Sq and
Sk, f32 and bf16, against its plain version, and at llava's and phi3's
causal prefill (BH = 32, S = 4096); the D = 16 and 64 instantiations
keeping the bits they had; other head sizes refused; llava-next-mistral-7b
at full width cut to 2 layers, weights drawn on the card: ``forward`` and
``loss_fn`` against the port's plain run on the CPU, flash against
chunked, every linear and attention launched on the kernels; the patch
splice (``_embed_inputs``, its projector at M = 1152 on ``q8_matmul``'s
f32 launch) against the CPU; llava's captured ``generate`` equal to the
eager loop; a step capture that fails raises, and nothing falls back.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_forward_gpu.py
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.kernels import bf16_matmul, q8_matmul, q8_matvec
from repro_torch.kernels.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine

LLAVA = "llava-next-mistral-7b"
FULL_LAYERS = 2
# card vs CPU, of the CPU's largest logit: the model runs in bf16, and a
# sum that differs in its last f32 bits can round to the neighbouring bf16
# value (2^-8 relative) and carry through the layers; the dense path's
# every linear rounds its operands to bf16 too
Q8_TOL, BF16_TOL = 1e-2, 3e-2
# flash against chunked attention on the card (bf16 probabilities against
# other running maxima), of the largest logit, and the losses apart
FLASH_TOL, LOSS_TOL = 3e-2, 1e-2

# sha256 (first 16 hex digits) of the f32 output bytes of the D = 16 and
# 64 instantiations on ``_flash_operands``' inputs, from the kernel as it
# was built before head sizes 32, 96 and 128 were added (NVIDIA H100 80GB
# HBM3): (bh, sq, sk, d, dtype, causal, offset) -> digest; offset 1 hands
# the kernel bf16 rows 2 bytes off 16, its SIMT route
KEPT_BITS = {
    (6, 1500, 1500, 64, "bfloat16", False, 0): "4b30c2c77b9f00bb",
    (6, 1500, 1500, 64, "bfloat16", True, 0): "5458ab52c7169c2c",
    (3, 101, 37, 16, "bfloat16", True, 0): "dfc0ad67ff70f12a",
    (2, 130, 70, 64, "float32", True, 0): "9a7a7da5b4afd562",
    (3, 45, 200, 16, "float32", False, 0): "2e937711d95dfded",
    (2, 100, 100, 64, "bfloat16", True, 1): "566b23ed691dfd57",
}


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _flash_operands(bh, sq, sk, d, dtype, dev, offset=0, seed=0):
    """q (bh, sq, d), k and v (bh, sk, d) drawn with numpy from ``seed``,
    in ``dtype`` on ``dev``; ``offset`` > 0 shifts each row's start by that
    many elements (rows no longer 16-byte aligned)."""
    rng = np.random.default_rng(seed + sq + sk + d)
    out = []
    for s in (sq, sk, sk):
        a = rng.standard_normal((bh, s, d + offset)).astype(np.float32)
        out.append(torch.from_numpy(a).to(dev, getattr(torch, dtype))
                   [..., offset:])
    return out


def flash_digest(bh, sq, sk, d, dtype, causal, offset, dev) -> str:
    """The first 16 hex digits of the sha256 of the kernel's f32 output
    bytes on ``_flash_operands``' inputs."""
    q, k, v = _flash_operands(bh, sq, sk, d, dtype, dev, offset)
    out = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,sk,causal", [
    (3, 37, 101, False),            # ragged Sq and Sk
    (2, 130, 70, True),             # causal, Sq > Sk, both ragged
    (2, 200, 200, True),            # causal, a partial last stage
    (3, 40, 90, True),              # a 16-row warp tile that is all padding
])
@pytest.mark.parametrize("d", [32, 96, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_new_head_sizes_vs_plain(bh, sq, sk, causal, d, dtype):
    """The new instantiations against the plain version: 1e-4 in f32 (sums
    in another order), 1e-2 in bf16 (a probability next to a bf16 rounding
    boundary can round the other way on the card's exp), relative to the
    largest output."""
    dev = _cuda_or_skip()
    q, k, v = _flash_operands(bh, sq, sk, d, dtype, dev)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = flash_attention_fwd_plain(q, k, v, causal=causal)
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert (got - want).abs().max().item() <= \
        tol * max(1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [96, 128])
def test_flash_lm_prefill_vs_plain(d):
    """phi3-mini's (D = 96) and llava's (D = 128) causal prefill at S =
    4096, 32 heads, bf16, as the forward folds them: within 1e-2."""
    dev = _cuda_or_skip()
    rng = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn((1, 4096, 32, d), generator=rng, device=dev).to(
        torch.bfloat16).transpose(1, 2).reshape(32, 4096, d)
        for _ in range(3))
    got = flash_attention_fwd(q, k, v, causal=True)
    want = flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        1e-2 * max(1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(KEPT_BITS))
def test_flash_d16_d64_keep_their_bits(case):
    """The D = 16 and 64 instantiations (tensor-core, f32 SIMT and the
    unaligned bf16 SIMT routes) give the bits they gave before the new
    head sizes: the shared-memory layout changed, the arithmetic did
    not."""
    dev = _cuda_or_skip()
    assert flash_digest(*case, dev) == KEPT_BITS[case]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [48, 256])
def test_flash_refuses_other_head_sizes(d):
    dev = _cuda_or_skip()
    q, k, v = _flash_operands(2, 16, 16, d, "bfloat16", dev)
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="head size"):
        flash_attention_fwd(q, k, v, causal=True)
    assert flash_attention_fwd.launches == before


@pytest.fixture(scope="module")
def llava2():
    """llava at full width cut to FULL_LAYERS layers, bf16 weights drawn
    on the card from seed 0."""
    dev = _cuda_or_skip()
    cfg = dataclasses.replace(get_config(LLAVA), num_layers=FULL_LAYERS)
    return cfg, model.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)


def _batch(cfg, s, p, dev, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s)))
    patches = torch.from_numpy(rng.standard_normal(
        (1, p, cfg.vision_embed_dim)).astype(np.float32))
    labels = toks.roll(-1, 1)
    labels[:, -1] = -1
    return {k: v.to(dev) for k, v in (("tokens", toks), ("labels", labels),
                                      ("patches", patches))}


def _rel(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return (got - want).abs().max().item() / max(1.0,
                                                 want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_llava_forward_two_layers_card_vs_cpu(llava2, quant):
    """S = 256 tokens, 128 patches (the reference's min(patches, S // 2)):
    the card's logits and loss against the CPU's (each through the offload
    engine, its kernels on the card and their plain versions on the CPU),
    the flash forward against the chunked one, and the launches: every
    linear of the 2 layers, the projector and lm_head once a forward
    (lm_head once a CE chunk in ``loss_fn``), flash once a layer."""
    dev = _cuda_or_skip()
    cfg, params = llava2
    eng = ServeEngine(cfg, params, max_len=8, quant=quant,
                      offload=OffloadEngine(), device=dev)
    sp = eng._serve_params
    sp_cpu = model.to_device(sp, torch.device("cpu"))
    batch = _batch(cfg, 256, 128, dev)
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    kernel = q8_matmul.q8_matmul if quant == "q8_0" \
        else bf16_matmul.bf16_matmul
    per_forward = 7 * FULL_LAYERS + 2
    with torch.inference_mode():
        before = kernel.launches
        logits, _ = model.forward(sp, cfg, batch, engine=eng.offload)
        torch.cuda.synchronize()
        assert kernel.launches - before == per_forward
        loss, metrics = model.loss_fn(sp, cfg, batch, engine=eng.offload)
        want, _ = model.forward(sp_cpu, cfg, batch_cpu, engine=OffloadEngine())
        want_loss, _ = model.loss_fn(sp_cpu, cfg, batch_cpu,
                                     engine=OffloadEngine())
        fcfg = dataclasses.replace(cfg, attn_impl="flash")
        before = flash_attention_fwd.launches
        flash, _ = model.forward(sp, fcfg, batch, engine=eng.offload)
        flash_loss, _ = model.loss_fn(sp, fcfg, batch, engine=eng.offload)
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches - before == 2 * FULL_LAYERS
    assert logits.shape == (1, 256, cfg.padded_vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(loss)
    tol = Q8_TOL if quant == "q8_0" else BF16_TOL
    assert _rel(logits, want) <= tol
    assert abs(float(loss) - float(want_loss)) <= tol * float(want_loss)
    assert _rel(flash, logits) <= FLASH_TOL
    assert abs(float(flash_loss) - float(loss)) <= LOSS_TOL
    assert float(metrics["ntok"]) == 255


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_embed_inputs_card_vs_cpu(llava2, quant):
    """llava's patch splice at the reference's full count: 1152 f32
    patches of width 1024 through the projector (M = 1152, K = 1024, N =
    4096: ``q8_matmul``'s f32 launch in Q8_0, ``bf16_matmul`` in bf16)
    over the first 1152 of 2304 positions, within 1e-2 of the CPU's
    largest value (the splice is cast to bf16)."""
    dev = _cuda_or_skip()
    cfg, params = llava2
    eng = ServeEngine(cfg, params, max_len=8, quant=quant,
                      offload=OffloadEngine(), device=dev)
    sp = eng._serve_params
    sub = {k: sp[k] for k in ("embed", "projector")}
    batch = _batch(cfg, 2304, 1152, dev, seed=1)
    kernel = q8_matmul.q8_matmul if quant == "q8_0" \
        else bf16_matmul.bf16_matmul
    with torch.inference_mode():
        before = kernel.launches
        got = model._embed_inputs(sub, cfg, batch, eng.offload)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = model._embed_inputs(
            model.to_device(sub, torch.device("cpu")), cfg,
            {k: v.cpu() for k, v in batch.items()}, OffloadEngine())
    assert got.dtype == torch.bfloat16 and _rel(got, want) <= 1e-2
    assert torch.equal(got[:, 1152:].cpu(), want[:, 1152:])


def _smoke_engine(dev, quant):
    cfg = get_smoke_config(LLAVA)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    return ServeEngine(cfg, params, max_len=32, quant=quant,
                       offload=OffloadEngine(burst=32), eos_id=None,
                       device=dev)


def _eager(eng, prompts, max_new):
    logits, state = eng.prefill(torch.from_numpy(prompts).long().cuda())
    tok = eng._argmax(logits[:, -1])[:, None]
    rows = []
    for _ in range(max_new):
        logits, state = eng.step(tok, state)
        tok = eng._argmax(logits[:, -1])[:, None]
        rows.append(tok)
    return torch.cat(rows, dim=1).cpu().tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_llava_captured_generate_equals_eager(quant):
    """llava served on tokens alone: captured ``generate`` at batch 1 and
    2 gives the eager loop's tokens, its decode kernel launched from
    Python only at the capture (two passes of a 7 x 2 + 1 linear step)."""
    dev = _cuda_or_skip()
    eng = _smoke_engine(dev, quant)
    kernel = q8_matvec.q8_matvec if quant == "q8_0" \
        else bf16_matmul.bf16_matmul
    for b in (1, 2):
        prompts = np.random.default_rng(b).integers(
            0, eng.cfg.vocab_size, (b, 6)).astype(np.int32)
        want = _eager(eng, prompts, 8)
        before = kernel.launches
        got = eng.generate(prompts, max_new=8)
        assert [r.tokens for r in got] == want
        assert kernel.launches - before == 2 * (7 * 2 + 1)


@pytest.mark.gpu
def test_failed_llava_step_capture_raises_without_fallback():
    """A step program that syncs the host cannot be captured: generate
    raises, no graph is kept, nothing is committed. Last in the file: the
    card is left after a failed capture."""
    dev = _cuda_or_skip()
    eng = _smoke_engine(dev, "q8_0")
    step_fn = eng._lm_step_fn

    def syncing_step(st):
        step_fn(st)
        torch.cuda.synchronize()

    eng._lm_step_fn = syncing_step
    with pytest.raises(RuntimeError):
        eng.generate(np.zeros((1, 4), np.int32), max_new=2)
    assert not eng._graphs and eng.offload.ledger.commits == 0
