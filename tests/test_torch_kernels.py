"""The port's kernels: each plain PyTorch version against the reference's
oracle (``repro.kernels.ref``) and its Pallas kernel in interpret mode, on
the same numpy-seeded inputs. The CUDA kernels are held against their
plain versions on the card in test_torch_kernels_gpu.py.

CPU tolerance 1e-5 (f32): both sides contract the same dequantized f32
(or bf16-rounded) weights in f32 and differ only in summation order;
outputs are O(1). Flash attention in f32 at 2e-5, the reference's own gate
(tests/test_flash_kernel.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qformats import QTensor as JQTensor
from repro.kernels import ref as jax_ref
from repro.kernels.bf16_matmul import bf16_matmul as pallas_bf16_matmul
from repro.kernels.flash_attention import (
    flash_attention_fwd as pallas_flash_attention_fwd)
from repro.kernels.q8_matmul import q8_matmul as pallas_q8_matmul
from repro.kernels.q8_matvec import q8_matvec as pallas_q8_matvec
from repro_torch.core.qformats import QTensor, dequantize_q8_0, quantize_q8_0
from repro_torch.kernels import ref, tiles
from repro_torch.kernels.bf16_matmul import bf16_matmul, bf16_matmul_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)
from repro_torch.kernels.q8_matmul import q8_matmul
from repro_torch.kernels.q8_matvec import q8_matvec
from tests._hyp import given, settings, st

TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(m, n, k, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * scale).astype(np.float32)
    return x, w


def _both(x, w):
    """The port's and the reference's Q8_0 weight from the same numpy W."""
    tq = quantize_q8_0(torch.from_numpy(w))
    jq = JQTensor(jnp.asarray(tq.qs.numpy()), jnp.asarray(tq.scales.numpy()))
    return torch.from_numpy(x), tq, jnp.asarray(x), jq


# shapes of tests/test_kernels.py, with the Pallas tiles used there
MATMUL_SHAPES = [
    (8, 64, 64, 8, 64, 32),
    (16, 128, 256, 16, 64, 64),
    (32, 256, 128, 16, 128, 128),
    (128, 256, 512, 64, 128, 256),
    (8, 512, 96, 8, 256, 32),
]
MATVEC_SHAPES = [(8, 128, 64, 64), (8, 512, 384, 512), (16, 1536, 384, 512)]


@pytest.mark.parametrize("m,n,k,bm,bn,bk", MATMUL_SHAPES)
def test_q8_matmul_plain_vs_reference(m, n, k, bm, bn, bk):
    x, w = _operands(m, n, k, seed=m * n + k)
    xt, tq, xj, jq = _both(x, w)
    got = q8_matmul(xt, tq.flat_qs(), tq.scales).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ref.q8_matmul_ref(xj, jq)),
                               **TOL)
    pallas = pallas_q8_matmul(xj, jq.flat_qs(), jq.scales, block_m=bm,
                              block_n=bn, block_k=bk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("b,n,k,bn", MATVEC_SHAPES)
def test_q8_matvec_plain_vs_reference(b, n, k, bn):
    x, w = _operands(b, n, k, seed=b + n)
    xt, tq, xj, jq = _both(x, w)
    got = q8_matvec(xt, tq.flat_qs(), tq.scales).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ref.q8_matvec_ref(xj, jq)),
                               **TOL)
    pallas = pallas_q8_matvec(xj, jq.flat_qs(), jq.scales, block_n=bn,
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("kernel,m,n,k", [
    ("q8_matmul", 13, 100, 64),      # ragged M and N
    ("q8_matmul", 1500, 40, 96),     # the prefill M, unpadded
    ("q8_matvec", 1, 96, 128),       # decode row
    ("q8_matvec", 5, 72, 32),        # ragged M and N
])
def test_plain_ragged_vs_reference(kernel, m, n, k):
    """The Hopper kernels mask ragged M and N themselves; their plain
    versions take the same unpadded shapes. The Pallas kernel runs with
    whole-dimension tiles here, since it needs tiles that divide."""
    x, w = _operands(m, n, k, seed=m + n + k)
    xt, tq, xj, jq = _both(x, w)
    fn = q8_matmul if kernel == "q8_matmul" else q8_matvec
    got = fn(xt, tq.flat_qs(), tq.scales).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ref.q8_matmul_ref(xj, jq)),
                               **TOL)
    if kernel == "q8_matmul":
        pallas = pallas_q8_matmul(xj, jq.flat_qs(), jq.scales, block_m=m,
                                  block_n=n, block_k=k, interpret=True)
    else:
        pallas = pallas_q8_matvec(xj, jq.flat_qs(), jq.scales, block_n=n,
                                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("fn", [q8_matmul, q8_matvec])
def test_plain_bf16_activations(fn):
    """bf16 x is converted inline: both packages see the same bf16 bits."""
    x, w = _operands(8, 64, 128, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tq = quantize_q8_0(torch.from_numpy(w))
    jq = JQTensor(jnp.asarray(tq.qs.numpy()), jnp.asarray(tq.scales.numpy()))
    want = jax_ref.q8_matmul_ref(jnp.asarray(xb.float().numpy()), jq)
    got = fn(xb, tq.flat_qs(), tq.scales)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fn", [q8_matmul, q8_matvec])
def test_plain_reads_k_slice_without_copy(fn):
    """The executor hands the kernel the burst-aligned K-slice of a wider
    weight and activation: strided views give the contiguous answer."""
    x, w = _operands(4, 48, 384, seed=7)
    xt = torch.from_numpy(x)
    tq = quantize_q8_0(torch.from_numpy(w))
    main = QTensor(tq.qs[:, :8], tq.scales[:, :8])        # K = 256 of 384
    qs = main.flat_qs()
    assert qs.stride(0) == 384 and qs.data_ptr() == tq.qs.data_ptr()
    got = fn(xt[:, :256], qs, main.scales)
    want = ref.q8_matmul_ref(xt[:, :256].contiguous(),
                             QTensor(main.qs.contiguous(),
                                     main.scales.contiguous()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("fn", [q8_matmul, q8_matvec])
def test_cpu_tensors_take_the_plain_version(fn):
    x, w = _operands(2, 32, 64, seed=1)
    tq = quantize_q8_0(torch.from_numpy(w))
    before = fn.launches
    fn(torch.from_numpy(x), tq.flat_qs(), tq.scales)
    assert fn.launches == before       # the count moves only on a launch


@pytest.mark.parametrize("fn", [q8_matmul, q8_matvec])
def test_wrapper_rejects_what_the_kernel_does_not_take(fn):
    tq = quantize_q8_0(torch.zeros(32, 64))
    with pytest.raises(ValueError):     # contraction mismatch
        fn(torch.zeros(2, 32), tq.flat_qs(), tq.scales)
    with pytest.raises(TypeError):      # int activations
        fn(torch.zeros(2, 64, dtype=torch.int32), tq.flat_qs(), tq.scales)
    meta = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError):     # neither CPU nor CUDA
        fn(meta, tq.flat_qs().to("meta"), tq.scales.to("meta"))


def test_q8_matvec_rejects_more_than_16_rows():
    tq = quantize_q8_0(torch.zeros(32, 64))
    with pytest.raises(ValueError):
        q8_matvec(torch.zeros(17, 64), tq.flat_qs(), tq.scales)


def _per_block_tensor_core_route(x, qs, scales):
    """The arithmetic of q8_matmul's tensor-core launch, in plain PyTorch:
    bf16 x times the int8 values of qs held as bf16, summed in f32 over
    each 32-value Q8_0 block, then each block's partial sum times its
    scale, added over the blocks in order."""
    m, k = x.shape
    xb = x.to(torch.bfloat16).float().reshape(m, k // 32, 32)
    qb = qs.to(torch.bfloat16).float().reshape(qs.shape[0], k // 32, 32)
    assert torch.equal(qb, qs.float().reshape_as(qb))   # int8 exact in bf16
    partial = torch.einsum("mbj,nbj->mnb", xb, qb)      # (M, N, K/32) f32
    out = torch.zeros(m, qs.shape[0])
    for b in range(k // 32):
        out += scales[:, b] * partial[:, :, b]
    return out


@pytest.mark.parametrize("m,n,k", [(13, 40, 96), (65, 72, 96),
                                   (37, 24, 1536)])
def test_tensor_core_route_computes_the_reference(m, n, k):
    """Per-block partial sums scaled afterwards compute x @ (q * s).T: each
    product of a bf16 value and an int8 value is exact in f32, so the two
    differ only in the order of the f32 sums and in rounding q * s once per
    value (the reference) or s * partial once per block (the route), both
    2^-24 relative a step. Tolerance 1e-5 as TOL, at outputs of O(1) (up to
    about 2 at K = 1536); the ragged M and N are the kernel's masked tiles."""
    x, w = _operands(m, n, k, seed=m + n + k)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tq = quantize_q8_0(torch.from_numpy(w))
    got = _per_block_tensor_core_route(xb, tq.flat_qs(), tq.scales)
    np.testing.assert_allclose(
        got.numpy(), ref.q8_flat_ref(xb, tq.flat_qs(), tq.scales).numpy(),
        **TOL)
    jq = JQTensor(jnp.asarray(tq.qs.numpy()), jnp.asarray(tq.scales.numpy()))
    want = jax_ref.q8_matmul_ref(jnp.asarray(xb.float().numpy()), jq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)



@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2**32 - 1), min_size=1, max_size=64))
def test_split_bf16x3_is_exact(bits):
    """q8_matmul's converting launch splits an f32 x into hi = bf16(x),
    mid = bf16(x - hi) and lo = bf16(x - hi - mid). Over f32 bit patterns
    whose parts stay normal (finite, hi finite, |x| at least 2^-102 or
    0): both f32 differences are exact, lo loses nothing in bf16, and
    hi + mid + lo == x."""
    x = torch.from_numpy(np.array(bits, dtype=np.uint32).view(np.float32))
    hi, mid, lo = ref.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    keep = (torch.isfinite(x) & torch.isfinite(hi.float())
            & ((x == 0) | (x.abs() >= 2.0**-102)))
    x64, h, mi, lo64 = (t.double()[keep] for t in (x, hi, mid, lo))
    r = x[keep] - hi.float()[keep]                       # in f32
    assert torch.equal(r.double(), x64 - h)
    r2 = r - mid.float()[keep]
    assert torch.equal(r2.double(), x64 - h - mi)
    assert torch.equal(lo64, r2.double())                # exact in bf16
    assert torch.equal(h + mi + lo64, x64)


def _split_tensor_core_route(x, qs, scales, parts=3):
    """The arithmetic of q8_matmul's converting launch for f32 x, in plain
    PyTorch: x split into hi, mid and lo (``ref.split_bf16x3``), each
    part's products with the int8 values summed in f32 over each Q8_0
    block, the smallest part first, then each block's sum times its
    scale, added over the blocks in order. ``parts`` < 3 drops lo (and
    mid): the ablation of the split."""
    m, k = x.shape
    n = qs.shape[0]
    qb = qs.float().reshape(n, k // 32, 32)
    partial = torch.zeros(m, n, k // 32)
    for part in reversed(ref.split_bf16x3(x)[:parts]):
        partial += torch.einsum("mbj,nbj->mnb",
                                part.float().reshape(m, k // 32, 32), qb)
    out = torch.zeros(m, n)
    for b in range(k // 32):
        out += scales[:, b] * partial[:, :, b]
    return out


@pytest.mark.parametrize("m,n,k", [(28, 512, 512), (28, 96, 2048),
                                   (37, 40, 96)])
def test_split_route_holds_f32_x_to_float64(m, n, k):
    """The three-part route against a float64 product of the same
    dequantized weight, within the reference oracle's 2e-5 of the largest
    output (tests/test_kernels.py), and against the JAX oracle at TOL;
    with x rounded to bf16 alone (hi), the same check fails: the split is
    what keeps the f32 function (M = 28: a whisper-base verify window)."""
    x, w = _operands(m, n, k, seed=m * n + k)
    xt = torch.from_numpy(x)
    tq = quantize_q8_0(torch.from_numpy(w))
    want = xt.double() @ dequantize_q8_0(tq).double().t()
    lim = 2e-5 * want.abs().max().item()
    got = _split_tensor_core_route(xt, tq.flat_qs(), tq.scales)
    assert (got.double() - want).abs().max().item() <= lim
    hi_only = _split_tensor_core_route(xt, tq.flat_qs(), tq.scales, parts=1)
    assert (hi_only.double() - want).abs().max().item() > lim
    jq = JQTensor(jnp.asarray(tq.qs.numpy()), jnp.asarray(tq.scales.numpy()))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_ref.q8_matmul_ref(jnp.asarray(x), jq)),
        **TOL)


@pytest.mark.parametrize("m,n,k,want", [
    (28, 512, 512, (32, 8)),      # whisper-base window: 16 tiles, 8 steps
    (28, 2048, 512, (32, 2)),     # 64 tiles
    (28, 512, 2048, (32, 8)),     # 16 tiles, 32 steps
    (28, 51872, 512, (64, 1)),    # the readout: 811 tiles of 64
    (1152, 4096, 1024, (64, 1)),  # llava's projector
    (100, 96, 96, (32, 2)),       # 6 tiles, 2 steps
    (17, 64, 32, (32, 1)),        # one step: nothing to share
])
def test_q8_split_launch_choice(m, n, k, want):
    """The converting launch's tile N and K split (``split_launch`` of
    q8_matmul.cu, mirrored in ``tiles.q8_split_launch``) at the window's,
    the projector's and ragged shapes."""
    assert tiles.q8_split_launch(m, n, k) == want


def test_q8_split_launch_stays_in_one_wave():
    """Over a grid of shapes: a split is 1, 2, 4 or 8 CTAs, each with a
    K step, only on 64 x 32 tiles, and a split grid fits one wave of the
    132 SMs; a 64 x 64 grid is taken only where it already fills them."""
    for m in (17, 28, 64, 65, 200, 1152, 1500):
        for n in (1, 33, 96, 512, 2048, 4096, 51872):
            for k in (32, 64, 96, 512, 1536, 2048, 4096):
                bn, split = tiles.q8_split_launch(m, n, k)
                rows, steps = -(-m // 64), (k // 32 + 1) // 2
                assert split in (1, 2, 4, 8) and split <= steps
                assert (bn == 64) == (-(-n // 64) * rows >= tiles.SMS)
                if split > 1:
                    assert bn == 32
                    assert -(-n // 32) * rows * split <= tiles.SMS
    assert tiles.CVT_SMEM_BYTES == 33792

# bf16_matmul: (m, n, k, k_full, Pallas tiles); k < k_full is the strided
# K-slice of a wider operand the executor hands the kernel
BF16_SHAPES = [
    (8, 64, 64, 64, 8, 64, 64),
    (32, 128, 256, 384, 16, 64, 128),
    (64, 256, 512, 512, 64, 128, 256),
    (1, 96, 256, 384, 1, 96, 256),      # decode row
]


@pytest.mark.parametrize("m,n,k,k_full,bm,bn,bk", BF16_SHAPES)
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_bf16_matmul_plain_vs_reference(m, n, k, k_full, bm, bn, bk, xdtype):
    """f32 or bf16 x, bf16 W, K-sliced views: the plain version against the
    reference's oracle and its Pallas kernel (both round the operands to
    bf16 inside, so an f32 x is the same function as its bf16 rounding)."""
    x, w = _operands(m, n, k_full, seed=m + n + k)
    xt = torch.from_numpy(x).to(getattr(torch, xdtype))
    wt = torch.from_numpy(w).to(torch.bfloat16)
    xs, ws = xt[:, :k], wt[:, :k]
    assert k == k_full or (xs.stride(0) == k_full and ws.stride(0) == k_full)
    got = bf16_matmul(xs, ws)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    xj = jnp.asarray(xs.float().numpy()).astype(xdtype)
    wj = jnp.asarray(ws.float().numpy()).astype(jnp.bfloat16)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_ref.matmul_bf16_ref(xj, wj)),
                               **TOL)
    pallas = pallas_bf16_matmul(xj, wj, block_m=bm, block_n=bn, block_k=bk,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_bf16_matmul_plain_ragged_and_f32_weight():
    """Ragged M, N and K (the CUDA kernel masks them; the Pallas kernel
    needs whole-dimension tiles) and an f32 weight, rounded to bf16 inside
    as the f32 test configs need."""
    x, w = _operands(13, 100, 100, seed=11)
    got = bf16_matmul(torch.from_numpy(x), torch.from_numpy(w))
    want = pallas_bf16_matmul(jnp.asarray(x), jnp.asarray(w), block_m=13,
                              block_n=100, block_k=100, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _qkv(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((bh, s, d)).astype(np.float32)
                 for s in (sq, sk, sk))


def test_bf16_widening_by_shift_is_exact():
    """bf16_matmul's decode launch widens the two bf16 values of a packed
    32-bit word to f32 by moving each into the upper half (the low one
    shifted by 16, the high one with the low half cleared). For every one
    of the 65,536 bf16 bit patterns, in both halves, that is PyTorch's own
    bf16 -> f32 conversion bit for bit, NaNs and infinities included."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    words = bits | (bits[::-1] << 16)
    as_f32 = torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16).float().numpy().view(np.uint32)
    np.testing.assert_array_equal((words << 16).astype(np.uint32), as_f32)
    np.testing.assert_array_equal(words & 0xFFFF0000, as_f32[::-1])


@pytest.mark.parametrize("bh,sq,sk,d,bq,bk,causal", [
    (2, 64, 64, 32, 32, 32, True),      # the shapes of tests/test_flash_kernel
    (1, 128, 128, 64, 64, 64, True),
    (2, 64, 128, 32, 32, 64, False),
    (3, 96, 96, 16, 32, 32, True),
    (6, 256, 256, 64, 128, 128, False),
    (2, 192, 128, 16, 64, 128, True),   # Sq > Sk
])
def test_flash_attention_plain_vs_pallas(bh, sq, sk, d, bq, bk, causal):
    """f32 at 2e-5: in f32 the probabilities are not rounded, so key blocks
    of 64 (the plain version's) and of ``bk`` (the Pallas kernel's) give
    the same function up to summation order."""
    q, k, v = _qkv(bh, sq, sk, d, seed=sq + sk + d)
    got = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    assert got.dtype == torch.float32 and got.shape == (bh, sq, d)
    want = pallas_flash_attention_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, block_q=bq,
        block_k=bk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_plain_bf16_matches_pallas_at_its_blocks():
    """bf16 inputs: the probabilities are rounded to bf16 against the
    running max of their key block. With the Pallas kernel's key block set
    to the plain version's (64), the two round the same values; the
    tolerance 1e-2 covers a probability at a rounding boundary that the
    two exps round apart (one bf16 step, 2^-8 relative)."""
    q, k, v = _qkv(2, 128, 192, 32, seed=9)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_fwd(tq, tk, tv, causal=False)
    want = pallas_flash_attention_fwd(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (tq, tk, tv)),
        causal=False, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2,
                               atol=1e-2)


def test_flash_attention_plain_ragged_matches_one_block():
    """Sq = Sk = 100, which no Pallas tile of 64 divides: the plain version
    walks a ragged last key block; the Pallas kernel, given one whole
    block, computes the same f32 function."""
    q, k, v = _qkv(3, 100, 100, 16, seed=4)
    for causal in (False, True):
        got = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal)
        want = pallas_flash_attention_fwd(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
            block_q=100, block_k=100, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_new_kernels_cpu_tensors_take_the_plain_version():
    x, w = _operands(2, 32, 64, seed=1)
    q, k, v = _qkv(2, 8, 8, 16, seed=1)
    before = (bf16_matmul.launches, flash_attention_fwd.launches)
    got = bf16_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got, bf16_matmul_plain(torch.from_numpy(x),
                                              torch.from_numpy(w)))
    got = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    assert torch.equal(got, flash_attention_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v))))
    # the counts move only on a launch
    assert (bf16_matmul.launches, flash_attention_fwd.launches) == before


def test_new_kernels_reject_what_they_do_not_take():
    with pytest.raises(ValueError):     # contraction mismatch
        bf16_matmul(torch.zeros(2, 32), torch.zeros(8, 64))
    with pytest.raises(TypeError):      # int activations
        bf16_matmul(torch.zeros(2, 64, dtype=torch.int32), torch.zeros(8, 64))
    with pytest.raises(ValueError):     # neither CPU nor CUDA
        bf16_matmul(torch.zeros(2, 64, device="meta"),
                    torch.zeros(8, 64, device="meta"))
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):     # k and v disagree
        flash_attention_fwd(q, q, torch.zeros(2, 9, 16))
    with pytest.raises(TypeError):      # mixed types
        flash_attention_fwd(q, q, q.to(torch.bfloat16))
    with pytest.raises(ValueError):     # unit stride along D
        flash_attention_fwd(q, q, torch.zeros(2, 16, 8).transpose(1, 2))
    with pytest.raises(ValueError):     # neither CPU nor CUDA
        flash_attention_fwd(*(torch.zeros(2, 8, 16, device="meta"),) * 3)


def test_library_name_covers_sources_headers_and_flags(tmp_path, monkeypatch):
    """A kernel library is named by a hash of its source, every shared
    header in csrc/ and the nvcc flags: editing any of them names a new
    library, so a stale one is never loaded. Nothing is compiled here."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    src = tmp_path / "bf16_matmul.cu"
    header = tmp_path / "hopper_mma.cuh"
    src.write_text("// kernel\n")
    header.write_text("// helpers\n")
    names = [_build.library_path("bf16_matmul").name]
    header.write_text("// helpers, edited\n")
    names.append(_build.library_path("bf16_matmul").name)
    src.write_text("// kernel, edited\n")
    names.append(_build.library_path("bf16_matmul").name)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    names.append(_build.library_path("bf16_matmul").name)
    assert len(set(names)) == 4
    assert all(n.startswith("bf16_matmul-") and n.endswith(".so")
               for n in names)
    # an unrelated file beside them leaves the name alone
    (tmp_path / "notes.txt").write_text("x")
    assert _build.library_path("bf16_matmul").name == names[-1]


def test_sweep_configurations_name_constants_of_the_sources():
    """sweep_kernels.py builds each kernel with configuration constants
    replaced: every configuration it lists names constants the source has,
    its first is the source as shipped, and an unknown name raises."""
    import importlib.util
    import os
    from repro_torch.kernels import _build
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "sweep_kernels.py")
    spec = importlib.util.spec_from_file_location("sweep_kernels", path)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    for name, (stem, configs) in sweep.CONFIGS.items():
        assert name in _build.KERNELS and _build.KERNELS[name][0] == stem
        src = (_build.CSRC / f"{stem}.cu").read_text()
        assert configs[0] == {} and sweep.variant_source(src, {}) == src
        for consts in configs[1:]:
            out = sweep.variant_source(src, consts)
            assert out != src
            assert all(f"{k} = {v}" in out for k, v in consts.items())
            changed = {a for a, b in zip(src.splitlines(), out.splitlines())
                       if a != b}
            assert changed and all(line.startswith("constexpr int ")
                                   for line in changed)
        with pytest.raises(KeyError):
            sweep.variant_source(src, {"kNoSuchConstant": 1})


def test_sweep_sets_declarations_not_comments():
    """A constant named in a comment before its declaration (as a source's
    header describes its configuration) stays as written; the declaration,
    alone or one of several, takes the new value."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "sweep_kernels.py")
    spec = importlib.util.spec_from_file_location("sweep_kernels", path)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    src = ("// a ring of kStages = 3 steps\n"
           "constexpr int kStages = 3;\n"
           "constexpr int kA = 1, kB = 2;\n")
    assert sweep.variant_source(src, {"kStages": 5, "kB": 4}) == (
        "// a ring of kStages = 3 steps\n"
        "constexpr int kStages = 5;\n"
        "constexpr int kA = 1, kB = 4;\n")
