"""Flash-2 attention forward: q (BH, Sq, D), k and v (BH, Sk, D) -> (BH,
Sq, D) f32, an online softmax over key blocks with an optional causal mask.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_fwd``, body ``_flash_fwd_kernel``) with its arithmetic:
f32 scores scaled by D^-0.5 after the contraction, masked scores at
NEG_INF = -1e30, the probabilities rounded to v's type before the PV
product against the running max of their key block, and the denominator
floored at 1e-30. Unlike the TPU kernel, which needs tiles that divide Sq
and Sk (1500 does not), the CUDA kernel (``csrc/flash_attention.cu``)
masks ragged Sq and Sk itself. It is bound by operations at the whisper
encoder's shapes and at llava's causal prefill (BH = 32, S = 4096, D =
128). bf16 q, k and v with 16-byte aligned rows run on the
tensor cores (``mma.sync``, 16 query rows a warp, k and v through a
``cp.async`` ring); f32 operands and unaligned rows run on f32 FMAs. Both
walk the keys in blocks of ``BLOCK_K``.

``flash_attention_fwd`` runs ``flash_attention_fwd_plain`` only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_K = 64          # keys per online-softmax step, as in the CUDA kernel
# the head sizes the CUDA kernel is built for: the Whisper ladder's 64, the
# LMs' 128 (llava and the other attention LMs) and 96 (phi3-mini), and the
# smoke and test configs' 16 and 32
HEAD_DIMS = (16, 32, 64, 96, 128)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              causal: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the same key blocks, the
    same casts, in f32."""
    _build.check_attention_operands(q, k, v)
    sq, d = q.shape[1:]
    sk = k.shape[1]
    scale = d ** -0.5
    qf = q.to(torch.float32)
    m = torch.full((q.shape[0], sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((q.shape[0], sq, 1), device=q.device)
    acc = torch.zeros((q.shape[0], sq, d), device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, sk, BLOCK_K):
        if causal and k0 > sq - 1:      # wholly masked: adds exactly zero
            break
        kb = k[:, k0:k0 + BLOCK_K].to(torch.float32)
        vb = v[:, k0:k0 + BLOCK_K]
        s = (qf @ kb.transpose(1, 2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            s = torch.where(kpos[None, :] <= qpos, s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * corr + p.to(v.dtype).to(torch.float32) @ vb.to(
            torch.float32)
    return acc / torch.clamp(l, min=1e-30)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, D), k/v (BH, Sk, D), all f32 or all bf16 -> (BH, Sq, D)
    f32. The BH and S strides are free; Sq and Sk may be ragged."""
    _build.check_attention_operands(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head size {d} not in "
                         f"{HEAD_DIMS}")
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=q.device)
    _build.call("flash_attention_fwd", q.device,
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                int(q.dtype == torch.bfloat16),
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), out.data_ptr(),
                bh, sq, sk, d, int(causal))
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
