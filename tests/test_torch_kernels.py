"""The port's Q8_0 kernels: each plain PyTorch version against the
reference's oracle (``repro.kernels.ref``) and its Pallas kernel in
interpret mode, on the same numpy-seeded inputs. The CUDA kernels are held
against their plain versions on the card in test_torch_kernels_gpu.py.

CPU tolerance 1e-5 (f32): both sides contract the same dequantized f32
weights in f32 and differ only in summation order; outputs are O(1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qformats import QTensor as JQTensor
from repro.kernels import ref as jax_ref
from repro.kernels.q8_matmul import q8_matmul as pallas_q8_matmul
from repro.kernels.q8_matvec import q8_matvec as pallas_q8_matvec
from repro_torch.core.qformats import QTensor, quantize_q8_0
from repro_torch.kernels import ref
from repro_torch.kernels.q8_matmul import q8_matmul
from repro_torch.kernels.q8_matvec import q8_matvec

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
