"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device, at the shapes of the whisper-tiny main paths (Q8_0, and dense with
flash attention), of the f32-operand products (a whisper-base verify
window, llava's projector, the whisper frontend) and at ragged and strided
ones; the Q8_0 product of f32 x within 2e-5 of a float64 product; two
launches of each converting launch bit for bit equal; full-width whisper-tiny
transcribe at batch 2 running every Q8_0 linear through them, and the
dense + flash transcribe running every dense linear and every encoder
attention through them.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.qformats import QTensor, quantize_q8_0
from repro_torch.kernels.bf16_matmul import bf16_matmul, bf16_matmul_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)
from repro_torch.kernels.q8_matmul import q8_matmul, q8_matmul_plain
from repro_torch.kernels.q8_matvec import q8_matvec, q8_matvec_plain
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine


def _operands(m, n, k, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * scale).astype(np.float32)
    return x, w


# Card tolerance 1e-4: the kernel sums in another order (fused multiply-adds,
# warp-tree reductions) over K up to 4096, at outputs of O(1).
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _q8_param(name, m, n, k, k_full, x_offset=0, route=""):
    """One case of test_kernel_vs_plain_on_card; x_offset > 0 makes x's
    base and row stride x_offset elements off 16 bytes; ``route`` names
    the launch the case is there for."""
    tag = (f"-{route}" if route else "") + (
        f"-xoff{x_offset}" if x_offset else "")
    return pytest.param(name, m, n, k, k_full, x_offset,
                        id=f"{name}-{m}-{n}-{k}-{k_full}{tag}")


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,n,k,k_full,x_offset", [
    _q8_param("q8_matvec", 1, 384, 256, 384),       # decode q/k/v/o, cross q/o
    _q8_param("q8_matvec", 1, 1536, 256, 384),      # decode ffn.up
    _q8_param("q8_matvec", 1, 384, 1536, 1536),     # decode ffn.down
    _q8_param("q8_matvec", 1, 51872, 256, 384),     # decode dec.vocab
    _q8_param("q8_matvec", 16, 100, 96, 96),        # ragged N, full batch tile
    _q8_param("q8_matvec", 3, 33, 4096, 4096),      # long K, split over warps
    _q8_param("q8_matvec", 5, 384, 1536, 1536),     # batch rows, split K
    _q8_param("q8_matvec", 16, 384, 1536, 1536),
    _q8_param("q8_matvec", 2, 100, 32, 32),         # K of one Q8_0 block
    _q8_param("q8_matvec", 1, 1, 256, 256),         # one output row
    _q8_param("q8_matvec", 4, 33, 512, 512),        # N = 33, split by 2
    _q8_param("q8_matvec", 3, 96, 256, 256, 1),     # unaligned x rows
    _q8_param("q8_matmul", 1500, 384, 256, 384),    # prefill q/k/v/o, cross k/v
    _q8_param("q8_matmul", 1500, 1536, 256, 384),   # prefill ffn.up
    _q8_param("q8_matmul", 1500, 384, 1536, 1536),  # prefill ffn.down
    _q8_param("q8_matmul", 17, 70, 32, 64),         # ragged M and N
    _q8_param("q8_matmul", 100, 64, 96, 96),        # K = 96: a ragged 64-step
    _q8_param("q8_matmul", 70, 64, 32, 32),         # K = 32: one Q8_0 block
    _q8_param("q8_matmul", 65, 72, 256, 256),       # ragged 64 x 64 tiles
    # unaligned x: the converting launch (bf16 x as its one part)
    _q8_param("q8_matmul", 300, 96, 256, 256, 1, route="converting"),
    _q8_param("q8_matmul", 28, 512, 512, 512),      # window q/k/v/o, cross q/o
    _q8_param("q8_matmul", 28, 2048, 512, 512),     # window ffn.up
    _q8_param("q8_matmul", 28, 512, 2048, 2048),    # window ffn.down
    _q8_param("q8_matmul", 28, 51872, 512, 512),    # window dec.vocab
    _q8_param("q8_matmul", 1152, 4096, 1024, 1024),  # llava's projector
    _q8_param("q8_matmul", 17, 33, 160, 192),       # ragged, K split in 2
])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_kernel_vs_plain_on_card(name, m, n, k, k_full, x_offset, xdtype):
    dev = _cuda_or_skip()
    fn, plain = ((q8_matvec, q8_matvec_plain) if name == "q8_matvec"
                 else (q8_matmul, q8_matmul_plain))
    x, w = _operands(m, n, k_full + x_offset, seed=m + n + k)
    xt = torch.from_numpy(x).to(dev, xdtype)[:, x_offset:x_offset + k]
    assert (xt.data_ptr() % 16 == 0) == (x_offset == 0)
    tq = quantize_q8_0(torch.from_numpy(np.ascontiguousarray(
        w[:, :k_full])).to(dev))
    main = QTensor(tq.qs[:, :k // 32], tq.scales[:, :k // 32])
    before = fn.launches
    got = fn(xt, main.flat_qs(), main.scales)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(xt, main.flat_qs(), main.scales)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_full_width_batch2_transcribe_launches_every_q8_linear():
    """At batch 2 the encoder's ffn.down (M = 3000, K = 1536) fails the
    reference's local-memory rule, so its plan entries say offload=False;
    they still run on the Hopper kernels. transcribe runs each program's
    Python twice (the warm-up and the capture) and then replays it, so
    q8_matmul launches twice per Q8_0 prefill linear and q8_matvec twice
    per Q8_0 linear of a decode step, whatever the number of steps."""
    dev = _cuda_or_skip()
    cfg = get_config("whisper-tiny")
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    mel = np.random.default_rng(1).standard_normal(
        (2, cfg.encoder_ctx, cfg.n_mels)).astype(np.float32)
    eng = ServeEngine(cfg, params, max_len=8, offload=OffloadEngine(),
                      eos_id=None, device=dev)
    max_new = 2
    q8_matmul.launches = q8_matvec.launches = 0
    res = eng.transcribe(mel, max_new=max_new)
    torch.cuda.synchronize()
    pre, step = (
        [e for e in eng._plans.plans[(phase, "q8_0", 2,
                                      cfg.encoder_ctx)].entries
         if e.dtype == "q8_0" and e.k_main]
        for phase in ("prefill", "step"))
    assert len(pre) == 32 and len(step) == 33
    assert sum(not e.offload for e in pre) == 4          # enc ffn.down
    assert {e.backend for e in pre + step} == {"hopper"}
    assert q8_matmul.launches == 2 * len(pre)
    assert q8_matvec.launches == 2 * len(step)
    assert [r.steps for r in res] == [max_new, max_new]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,k_full", [
    (1, 384, 256, 384),        # decode q/k/v/o, cross q/o
    (1, 1536, 256, 384),       # decode ffn.up
    (1, 384, 1536, 1536),      # decode ffn.down
    (1, 51872, 256, 384),      # decode dec.vocab
    (1500, 384, 256, 384),     # prefill q/k/v/o, cross k/v
    (1500, 1536, 256, 384),    # prefill ffn.up
    (1500, 384, 1536, 1536),   # prefill ffn.down
    (11, 70, 100, 130),        # skinny M, ragged N and K, unaligned rows
    (17, 70, 37, 40),          # tiled M, ragged M, N and K
    (1500, 384, 80, 80),       # the whisper frontend (f32 mel)
    (1152, 4096, 1024, 1024),  # llava's projector (f32 patches)
    (28, 512, 512, 512),       # a whisper-base verify window
    (70, 130, 100, 104),       # ragged M and N, K not a whole number of 8
])
@pytest.mark.parametrize("xdtype,wdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_bf16_matmul_vs_plain_on_card(m, n, k, k_full, xdtype, wdtype):
    """Tolerance 1e-4: both sides multiply the same bf16-rounded operands
    exactly and sum in f32 in another order, over K up to 1536, at outputs
    of O(1)."""
    dev = _cuda_or_skip()
    x, w = _operands(m, n, k_full, seed=m + n + k)
    xt = torch.from_numpy(x).to(dev, xdtype)
    wt = torch.from_numpy(w).to(dev, wdtype)
    before = bf16_matmul.launches
    got = bf16_matmul(xt[:, :k], wt[:, :k])     # strided K-slices
    torch.cuda.synchronize()
    assert bf16_matmul.launches == before + 1
    want = bf16_matmul_plain(xt[:, :k], wt[:, :k])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,k_full,offset", [
    (300, 96, 200, 208, 0),       # K a whole number of 8, not of the K step
    (300, 96, 100, 104, 0),       # K not a whole number of 8: converting
    (300, 96, 256, 384, 1),       # x's base 2 bytes off 16: converting
    (100, 37, 64, 64, 0),         # odd N: odd row stride, scalar stores
    (17, 1536, 1536, 1536, 0),    # tiled M, narrow tiles, long K
    (1500, 1536, 1536, 1536, 0),  # wide tiles, long K
])
def test_bf16_matmul_bf16_edges_on_card(m, n, k, k_full, offset):
    """bf16 x times bf16 W at the edges of the tensor-core launch and of
    the dispatch between it and the converting one; tolerance 1e-4 as in
    test_bf16_matmul_vs_plain_on_card."""
    dev = _cuda_or_skip()
    x, w = _operands(m, n, k_full + offset, seed=m + n + k + offset)
    xt = torch.from_numpy(x).to(dev, torch.bfloat16)[:, offset:offset + k]
    wt = torch.from_numpy(w).to(dev, torch.bfloat16)[:, :k]
    assert (xt.data_ptr() % 16 == 0) == (offset == 0)
    before = bf16_matmul.launches
    got = bf16_matmul(xt, wt)
    torch.cuda.synchronize()
    assert bf16_matmul.launches == before + 1
    torch.testing.assert_close(got, bf16_matmul_plain(xt, wt), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,k_full,x_offset", [
    (2, 384, 1536, 1536, 0),      # batch rows, K split over 4 warps
    (5, 384, 1536, 1536, 0),
    (16, 384, 1536, 1536, 0),
    (3, 33, 4096, 4096, 0),       # long K, each lane several steps
    (16, 100, 96, 96, 0),         # ragged N, full batch tile
    (2, 100, 32, 32, 0),          # K of 32: a quarter of a warp's step
    (3, 96, 100, 104, 0),         # K not a whole number of 8
    (1, 1, 256, 256, 0),          # one output row
    (4, 33, 512, 512, 0),         # N = 33, split by 2
    (3, 96, 256, 256, 1),         # x's base and stride off 16 bytes
])
@pytest.mark.parametrize("xdtype,wdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_bf16_matmul_decode_edges_on_card(m, n, k, k_full, x_offset, xdtype,
                                          wdtype):
    """The M <= 16 launch at the edges of its grid, its K split and its
    masks; tolerance 1e-4 as in test_bf16_matmul_vs_plain_on_card."""
    dev = _cuda_or_skip()
    x, w = _operands(m, n, k_full + x_offset, seed=m + n + k + x_offset)
    xt = torch.from_numpy(x).to(dev, xdtype)[:, x_offset:x_offset + k]
    wt = torch.from_numpy(w).to(dev, wdtype)[:, :k]
    assert (xt.data_ptr() % 16 == 0) == (x_offset == 0)
    before = bf16_matmul.launches
    got = bf16_matmul(xt, wt)
    torch.cuda.synchronize()
    assert bf16_matmul.launches == before + 1
    torch.testing.assert_close(got, bf16_matmul_plain(xt, wt), rtol=1e-4,
                               atol=1e-4)


def _qkv(bh, sq, sk, d, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dev, dtype) for s in (sq, sk, sk))
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (6, 1500, 1500, 64, False),     # the whisper-tiny encoder
    (6, 1500, 1500, 64, True),
    (3, 37, 101, 64, False),        # ragged Sq and Sk
    (3, 101, 37, 16, True),         # Sq > Sk, causal
    (2, 64, 128, 16, True),         # whole blocks
    (2, 45, 200, 16, False),        # D 16, ragged Sq and Sk
    (4, 33, 65, 64, False),         # one row and one key past a block
    (2, 130, 70, 64, True),         # causal, Sq > Sk, both ragged
    (3, 40, 90, 64, True),          # a 16-row warp tile that is all padding
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_vs_plain_on_card(bh, sq, sk, d, causal, dtype):
    """Tolerance 1e-5 in f32 (sums in another order, outputs of O(1));
    1e-2 in bf16, where a probability that lands next to a bf16 rounding
    boundary can round the other way on the card's exp than on PyTorch's
    (one bf16 step, 2^-8 relative, of one weight)."""
    dev = _cuda_or_skip()
    q, k, v = _qkv(bh, sq, sk, d, dtype, dev, seed=sq + sk + d)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = flash_attention_fwd_plain(q, k, v, causal=causal)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_attention_reads_folded_heads_without_copy():
    """The encoder hands the kernel (B, S, H, D) activations folded to
    (B*H, S, D) views: strided operands give the contiguous answer."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 300, 6, 64)).astype(
        np.float32)).to(dev, torch.bfloat16)
    folded = x.transpose(1, 2).reshape(6, 300, 64)
    assert folded.stride() == (64, 384, 1)
    got = flash_attention_fwd(folded, folded, folded, causal=False)
    want = flash_attention_fwd(*(folded.contiguous(),) * 3, causal=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_flash_attention_folded_encoder_view_vs_plain():
    """The encoder's own operands: (1, 1500, 6, 64) bf16 projections folded
    to (6, 1500, 64) views with an S stride of 384. Tolerance as in
    test_flash_attention_vs_plain_on_card."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1500, 6, 64)).astype(
        np.float32)).to(dev, torch.bfloat16).transpose(1, 2).reshape(
        6, 1500, 64) for _ in range(3))
    assert q.stride() == (64, 384, 1)
    got = flash_attention_fwd(q, k, v, causal=False)
    torch.testing.assert_close(
        got, flash_attention_fwd_plain(q, k, v, causal=False), rtol=1e-2,
        atol=1e-2)
    contiguous = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=False)
    torch.testing.assert_close(got, contiguous, rtol=0, atol=0)


@pytest.mark.gpu
def test_flash_attention_unaligned_bf16_rows():
    """bf16 operands whose base is 2 bytes off 16 cannot be copied 16 bytes
    at a time; they still give the plain version's answer (tolerance as in
    test_flash_attention_vs_plain_on_card)."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(7)
    full = torch.from_numpy(rng.standard_normal((3, 2, 100, 65)).astype(
        np.float32)).to(dev, torch.bfloat16)
    q, k, v = (full[i, :, :, 1:] for i in range(3))
    assert q.data_ptr() % 16 != 0
    got = flash_attention_fwd(q, k, v, causal=True)
    torch.testing.assert_close(
        got, flash_attention_fwd_plain(q, k, v, causal=True), rtol=1e-2,
        atol=1e-2)


@pytest.mark.gpu
def test_full_width_dense_flash_transcribe_launches_every_kernel():
    """Dense bf16 whisper-tiny with attn_impl="flash": bf16_matmul launches
    once per dense prefill linear with a main segment (32) and once per
    dense linear of a decode step (33); flash_attention_fwd once per
    encoder layer; no Q8_0 kernel runs. transcribe runs each program's
    Python twice (the warm-up and the capture) and then replays it, so
    each count is doubled, whatever the number of steps."""
    dev = _cuda_or_skip()
    cfg = dataclasses.replace(get_config("whisper-tiny"), quant="none",
                              attn_impl="flash")
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    mel = np.random.default_rng(1).standard_normal(
        (1, cfg.encoder_ctx, cfg.n_mels)).astype(np.float32)
    eng = ServeEngine(cfg, params, max_len=8, offload=OffloadEngine(),
                      eos_id=None, device=dev)
    max_new = 2
    bf16_matmul.launches = flash_attention_fwd.launches = 0
    q8_matmul.launches = q8_matvec.launches = 0
    res = eng.transcribe(mel, max_new=max_new)
    torch.cuda.synchronize()
    pre, step = ([e for e in eng._plans.plans[(phase, "none", 1,
                                                cfg.encoder_ctx)].entries
                  if e.k_main] for phase in ("prefill", "step"))
    assert len(pre) == 32 and len(step) == 33
    assert {e.backend for e in pre + step} == {"hopper"}
    assert {e.dtype for e in pre + step} == {"bf16"}
    assert bf16_matmul.launches == 2 * (32 + 33)
    assert flash_attention_fwd.launches == 2 * cfg.num_encoder_layers
    assert q8_matmul.launches == q8_matvec.launches == 0
    assert [r.steps for r in res] == [max_new]


# (m, n, k): the converting launches' shapes on the served paths and
# ragged ones; the Q8_0 launch splits K over 8, 2 and 8 CTAs of a cluster
# at the first three, and not at the readout or the projector
CONVERTING_SHAPES = [(28, 512, 512), (28, 2048, 512), (28, 512, 2048),
                     (28, 51872, 512), (1152, 4096, 1024), (37, 40, 96),
                     (17, 33, 160)]


def _q8_operands(m, n, k, dev, seed):
    x, w = _operands(m, n, k, seed=seed)
    tq = quantize_q8_0(torch.from_numpy(w).to(dev))
    return torch.from_numpy(x).to(dev), tq


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", CONVERTING_SHAPES)
def test_q8_f32_x_within_2e_5_of_float64(m, n, k):
    """f32 x through q8_matmul's converting launch (x split into three
    bf16 parts) against a float64 product of the same dequantized weight,
    within the reference oracle's 2e-5 of the largest output
    (tests/test_kernels.py). x rounded to bf16 alone misses this by about
    two orders of magnitude (tests/test_torch_kernels.py's CPU model of
    the route, and tools/q8_split_ablation.py on the card)."""
    dev = _cuda_or_skip()
    x, tq = _q8_operands(m, n, k, dev, seed=m + n + k)
    got = q8_matmul(x, tq.flat_qs(), tq.scales)
    w = (tq.qs.float() * tq.scales[..., None]).reshape(n, k)
    want = x.double() @ w.double().t()
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    assert err <= 2e-5 * want.abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", CONVERTING_SHAPES)
@pytest.mark.parametrize("kernel", ["q8_matmul", "bf16_matmul"])
def test_converting_launches_bit_for_bit(kernel, m, n, k):
    """Two launches of a converting launch on the same f32 x give the same
    bits: one fixed order of the sums, no float atomics, a K split summed
    in rank order."""
    dev = _cuda_or_skip()
    x, tq = _q8_operands(m, n, k, dev, seed=m * n + k)
    if kernel == "q8_matmul":
        args, fn = (x, tq.flat_qs(), tq.scales), q8_matmul
    else:
        w = (tq.qs.float() * tq.scales[..., None]).reshape(n, k)
        args, fn = (x, w.to(torch.bfloat16)), bf16_matmul
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
