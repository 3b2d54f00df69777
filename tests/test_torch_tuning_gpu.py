"""The autotuner's launches on a CUDA device: every admissible tile of
``q8_matmul``, ``q8_matvec`` and ``bf16_matmul`` at whisper-tiny's shapes
against the kernel's plain version (tolerance 1e-4 of the largest output,
as the kernel tests: the launches sum in other orders), the launch with no
tile equal bit for bit to the one with the tile ``kernels/tiles.py`` says
the kernel chooses itself, a measured search that picks inside its own
space, the converting launch (the frontend's f32 x) against its plain
version and refusing a tile, and tuned ``transcribe`` on the card: its captured
tokens equal the tuned eager loop's, and replays consult no tuner.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_tuning_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.qformats import quantize_q8_0
from repro_torch.kernels import tiles
from repro_torch.kernels.bf16_matmul import bf16_matmul, bf16_matmul_plain
from repro_torch.kernels.q8_matmul import q8_matmul, q8_matmul_plain
from repro_torch.kernels.q8_matvec import q8_matvec, q8_matvec_plain
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine
from repro_torch.tuning import Autotuner, enumerate_candidates
from repro_torch.tuning.space import default_launch, launches

TOL = 1e-4
MAX_NEW = 8
# (kernel, M, N, K): whisper-tiny's main segments once a tuned burst leaves
# no residual (K = 384 whole), the dense frontend's K = 80, and a batch
SHAPES = [
    ("q8_matmul", 1500, 384, 384), ("q8_matmul", 1500, 1536, 384),
    ("q8_matmul", 1500, 384, 1536), ("q8_matmul", 65, 72, 96),
    ("q8_matvec", 1, 384, 384), ("q8_matvec", 1, 1536, 384),
    ("q8_matvec", 1, 384, 1536), ("q8_matvec", 1, 51872, 384),
    ("q8_matvec", 5, 100, 1536),
    ("bf16_matmul", 1500, 384, 384), ("bf16_matmul", 1500, 1536, 384),
    ("bf16_matmul", 1500, 384, 1536), ("bf16_matmul", 1500, 384, 80),
    ("bf16_matmul", 1, 384, 384), ("bf16_matmul", 1, 1536, 384),
    ("bf16_matmul", 1, 384, 1536), ("bf16_matmul", 1, 51872, 384),
    ("bf16_matmul", 1500, 64, 1500),       # K cp.async cannot take
]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _tile_cases():
    for kernel, m, n, k in SHAPES:
        for t in launches(kernel, tiles.tile_m(m), n, k):
            yield pytest.param(kernel, m, n, k, t,
                               id=f"{kernel}-{m}-{n}-{k}-" +
                               ("x".join(map(str, t)) or "converting"))


def _call(kernel, m, n, k, dev):
    """The kernel and its plain version on the serving path's operand
    types (bf16 x at M > 16 and on the dense path, f32 x on Q8_0
    decode; bf16 dense weights)."""
    gen = torch.Generator(device=dev).manual_seed(m * 7 + n + k)
    xdt = torch.float32 if kernel == "q8_matvec" else torch.bfloat16
    x = torch.randn((m, k), generator=gen, device=dev).to(xdt)
    w = torch.randn((n, k), generator=gen, device=dev) * 0.05
    if kernel == "bf16_matmul":
        args = (x, w.to(torch.bfloat16))
        return args, bf16_matmul, bf16_matmul_plain
    wq = quantize_q8_0(w)
    args = (x, wq.flat_qs(), wq.scales)
    if kernel == "q8_matmul":
        return args, q8_matmul, q8_matmul_plain
    return args, q8_matvec, q8_matvec_plain


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,m,n,k,tile", list(_tile_cases()))
def test_every_tile_against_plain(kernel, m, n, k, tile):
    dev = _cuda_or_skip()
    args, fn, plain = _call(kernel, m, n, k, dev)
    got = fn(*args, tile=tile)
    want = plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,m,n,k", SHAPES)
def test_no_tile_is_the_default_launch(kernel, m, n, k):
    """``tiles.py``'s idea of the kernel's own choice is the kernel's: the
    launch with no tile and the one with that tile give the same bits."""
    dev = _cuda_or_skip()
    args, fn, _ = _call(kernel, m, n, k, dev)
    tile = default_launch(kernel, tiles.tile_m(m), n, k)
    assert torch.equal(fn(*args), fn(*args, tile=tile))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,m,n,k", [
    ("q8_matmul", 1504, 1536, 384), ("q8_matvec", 8, 384, 1536),
    ("bf16_matmul", 1504, 384, 384), ("bf16_matmul", 8, 51872, 384),
    ("bf16_matmul", 1504, 64, 1500)])
def test_measured_search_picks_inside_its_space(kernel, m, n, k):
    _cuda_or_skip()
    t = Autotuner(mode="measured")
    rec = t.search(kernel, m, n, k)
    cands = enumerate_candidates(kernel, m, n, k)
    assert rec.source == "measured" and rec.cost_s > 0
    assert (rec.block_k, rec.launch) in {(c.block_k, c.launch)
                                         for c in cands}
    assert rec.block_k == max(c.block_k for c in cands)  # ties: largest


@pytest.mark.gpu
def test_tiled_f32_launch_against_plain_and_refuses_a_tile():
    """The frontend's product (M = 1500, K = 80, f32 mel as x) runs the
    converting launch: it agrees with the plain version, and a ring depth is
    refused by the wrapper (f32 x) and by the C entry (bf16 rows that
    cp.async cannot copy)."""
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((1500, 80), generator=gen, device=dev)
    w = (torch.randn((384, 80), generator=gen, device=dev) * 0.05).to(
        torch.bfloat16)
    xb = torch.randn((1500, 81), generator=gen, device=dev).to(
        torch.bfloat16)[:, :80]                     # rows 162 bytes apart
    for a in (x, xb):
        got, want = bf16_matmul(a, w), bf16_matmul_plain(a, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= TOL * max(1.0, want.abs().max().item()), err
    with pytest.raises(ValueError, match="takes no tile"):
        bf16_matmul(x, w, tile=tiles.BF16_WGMMA_TILES[0])
    with pytest.raises(RuntimeError, match="launch failed"):
        bf16_matmul(xb, w, tile=tiles.BF16_WGMMA_TILES[0])


def _engine(dev, path, full):
    cfg = get_config("whisper-tiny") if full else \
        get_smoke_config("whisper-tiny")
    if path == "dense+flash":
        cfg = dataclasses.replace(cfg, quant="none", attn_impl="flash")
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    tuner = Autotuner(mode="measured")
    return ServeEngine(cfg, params, max_len=MAX_NEW + 8,
                       quant="q8_0" if path == "q8_0" else "none",
                       offload=OffloadEngine(tuner=tuner), eos_id=None,
                       device=dev)


def _eager_tokens(eng, mel):
    _, state = eng.prefill(torch.from_numpy(mel).to(eng.device))
    tok = torch.full((mel.shape[0], 1), 1, device=eng.device)
    out = []
    for _ in range(MAX_NEW):
        logits, state = eng.step(tok, state)
        tok = eng._argmax(logits[:, -1])[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).cpu().tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("path", ["q8_0", "dense+flash"])
def test_tuned_captured_tokens_equal_tuned_eager(path, full):
    """Tuned plans (measured on the card) in the captured programs and in
    the eager loop: the same launches on the same operands, so the same
    tokens; every K = 384 linear runs whole, with no residual."""
    dev = _cuda_or_skip()
    eng = _engine(dev, path, full)
    b, f = (1, eng.cfg.encoder_ctx) if full else (2, 64)
    mel = np.random.default_rng(1).standard_normal(
        (b, f, eng.cfg.n_mels)).astype(np.float32)
    res = eng.transcribe(mel, max_new=MAX_NEW)
    assert [r.tokens for r in res] == _eager_tokens(eng, mel)
    assert eng._step_captures == 1
    f32 = eng.cfg.param_dtype == "float32"     # the smoke config's
    for plan in eng._plans.plans.values():
        for e in plan.entries:
            if e.k == 384:
                # every launch takes a tile but the converting f32 one
                takes = e.dtype == "q8_0" or e.m <= 16 or not f32
                assert e.tuned and e.k_res == 0
                assert (e.tiling is not None) == takes


@pytest.mark.gpu
def test_replays_consult_no_tuner():
    """After the capture, replaying the prefill and the step moves none of
    the tuner's counters: the tile chosen at the warm-up is in the graph."""
    dev = _cuda_or_skip()
    eng = _engine(dev, "q8_0", False)
    mel = np.random.default_rng(2).standard_normal(
        (1, 64, eng.cfg.n_mels)).astype(np.float32)
    eng.transcribe(mel, max_new=4)
    t = eng.offload.tuner
    before = (t.cache.hits, t.cache.misses, t.searches)
    st = eng._static[(1, 64)]
    eng._run(eng._key("prefill", 1, 64), None)
    st.token.fill_(1)
    for _ in range(4):
        eng._run(eng._key("step", 1, 64), None)
    torch.cuda.synchronize()
    assert (t.cache.hits, t.cache.misses, t.searches) == before
