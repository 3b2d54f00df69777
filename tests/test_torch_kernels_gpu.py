"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device, at the shapes of the whisper-tiny main path and at ragged ones, and
full-width whisper-tiny transcribe at batch 2 running every Q8_0 linear
through them.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.qformats import QTensor, quantize_q8_0
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


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,n,k,k_full", [
    ("q8_matvec", 1, 384, 256, 384),       # decode q/k/v/o, cross q/o
    ("q8_matvec", 1, 1536, 256, 384),      # decode ffn.up
    ("q8_matvec", 1, 384, 1536, 1536),     # decode ffn.down
    ("q8_matvec", 1, 51872, 256, 384),     # decode dec.vocab
    ("q8_matvec", 16, 100, 96, 96),        # ragged N, full batch tile
    ("q8_matvec", 3, 33, 4096, 4096),      # K beyond one shared-memory chunk
    ("q8_matmul", 1500, 384, 256, 384),    # prefill q/k/v/o, cross k/v
    ("q8_matmul", 1500, 1536, 256, 384),   # prefill ffn.up
    ("q8_matmul", 1500, 384, 1536, 1536),  # prefill ffn.down
    ("q8_matmul", 17, 70, 32, 64),         # ragged M and N
])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_kernel_vs_plain_on_card(name, m, n, k, k_full, xdtype):
    dev = _cuda_or_skip()
    fn, plain = ((q8_matvec, q8_matvec_plain) if name == "q8_matvec"
                 else (q8_matmul, q8_matmul_plain))
    x, w = _operands(m, n, k_full, seed=m + n + k)
    xt = torch.from_numpy(x).to(dev, xdtype)
    tq = quantize_q8_0(torch.from_numpy(w).to(dev))
    main = QTensor(tq.qs[:, :k // 32], tq.scales[:, :k // 32])
    before = fn.launches
    got = fn(xt[:, :k], main.flat_qs(), main.scales)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(xt[:, :k], main.flat_qs(), main.scales)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_full_width_batch2_transcribe_launches_every_q8_linear():
    """At batch 2 the encoder's ffn.down (M = 3000, K = 1536) fails the
    reference's local-memory rule, so its plan entries say offload=False;
    they still run on the Hopper kernels. q8_matmul launches once per Q8_0
    prefill linear and q8_matvec once per Q8_0 linear of each decode step."""
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
        [e for e in eng.plans[(phase, 2, cfg.encoder_ctx)].entries
         if e.dtype == "q8_0" and e.k_main]
        for phase in ("prefill", "step"))
    assert len(pre) == 32 and len(step) == 33
    assert sum(not e.offload for e in pre) == 4          # enc ffn.down
    assert {e.backend for e in pre + step} == {"hopper"}
    assert q8_matmul.launches == len(pre)
    assert q8_matvec.launches == max_new * len(step)
    assert [r.steps for r in res] == [max_new, max_new]
