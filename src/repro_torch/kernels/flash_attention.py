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

With ``return_lse=True`` the forward also returns each query row's
logsumexp ``m + log(max(l, 1e-30))`` (BH, Sq) f32, from its running max
and denominator, as the reference's flash forward does; serving asks for
none and its launches write none. The output carries no autograd graph,
so a call with grad mode on and an input that requires grad raises:
differentiate through ``models.attention._FlashCore``, whose backward is
``flash_attention_bwd``.

``flash_attention_bwd`` is the flash-2 backward (``csrc/
flash_attention_bwd.cu``), which no TPU kernel backs: the reference
differentiates its flash attention through a custom VJP in plain JAX
(``repro/models/attention.py``, ``_flash_bwd``). It recomputes the
probabilities a key block at a time from (q, k, lse), in three launches
(delta = rowsum(dO o); dK and dV a key block a block; dQ a query block a
block) with no float atomics, so that its result does not depend on
scheduling. bf16 operands run on the tensor cores (``mma.sync``; dS,
f32 in the reference, enters the dK and dQ products as a bf16 hi and lo
pair; rows off a 16-byte boundary are copied first), f32 on f32 FMAs.
``flash_attention_bwd_plain`` is ``_flash_bwd``'s arithmetic in the
port's key blocks of ``BLOCK_K``, including the probabilities rounded to
dO's type before the dV product.

Each wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import op_cost

NEG_INF = -1e30
BLOCK_K = 64          # keys per online-softmax step, as in the CUDA kernel
# the head sizes the CUDA kernel is built for: the Whisper ladder's 64, the
# LMs' 128 (llava and the other attention LMs) and 96 (phi3-mini), and the
# smoke and test configs' 16 and 32
HEAD_DIMS = (16, 32, 64, 96, 128)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              return_lse: bool = False):
    """The kernel's arithmetic in plain PyTorch: the same key blocks, the
    same casts, in f32. With ``return_lse``, (out, lse)."""
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
    l = torch.clamp(l, min=1e-30)
    out = acc / l
    return (out, (m + torch.log(l))[..., 0]) if return_lse else out


def _fake_fwd(q, k, v, *, causal: bool = True, return_lse: bool = False):
    _build.check_attention_operands(q, k, v)
    _check_no_graph(q, k, v)
    out = q.new_empty(q.shape, dtype=torch.float32)
    return (out, q.new_empty(q.shape[:2], dtype=torch.float32)) \
        if return_lse else out


@op_cost.priced(op_cost.flash_fwd_price, _fake_fwd)
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, return_lse: bool = False):
    """q (BH, Sq, D), k/v (BH, Sk, D), all f32 or all bf16 -> (BH, Sq, D)
    f32, and with ``return_lse`` the (BH, Sq) f32 logsumexp too. The BH
    and S strides are free; Sq and Sk may be ragged."""
    _build.check_attention_operands(q, k, v)
    _check_no_graph(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         return_lse=return_lse)
    bh, sq, d = q.shape
    sk = k.shape[1]
    _check_head_dim("flash_attention_fwd", d)
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=q.device)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _build.call("flash_attention_fwd", q.device,
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                int(q.dtype == torch.bfloat16),
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                bh, sq, sk, d, int(causal))
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def _check_no_graph(q, k, v) -> None:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention_fwd has no autograd graph: "
                           "differentiate through models.attention."
                           "_FlashCore")


def _check_head_dim(name: str, d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head size {d} not in {HEAD_DIMS}")


def _check_bwd_operands(q, k, v, out, dout, lse) -> None:
    _build.check_attention_operands(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {tuple(q.shape[:2])}")
    if not (out.dtype == dout.dtype == q.dtype):
        raise TypeError("out and dout must be in q's type")
    if not (out.device == dout.device == lse.device == q.device):
        raise ValueError("every operand must lie on q's device")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True):
    """The reference's ``_flash_bwd`` in plain PyTorch, over the kernel's
    key blocks of ``BLOCK_K``: (dq, dk, dv) in the inputs' types."""
    _check_bwd_operands(q, k, v, out, dout, lse)
    sq, d = q.shape[1:]
    sk = k.shape[1]
    scale = d ** -0.5
    qf = q.to(torch.float32)
    dof = dout.to(torch.float32)
    delta = (dof * out.to(torch.float32)).sum(dim=-1, keepdim=True)
    lse = lse[..., None]
    qpos = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, BLOCK_K):
        if causal and k0 > sq - 1:      # wholly masked: adds exactly zero
            break
        kb = k[:, k0:k0 + BLOCK_K].to(torch.float32)
        vb = v[:, k0:k0 + BLOCK_K].to(torch.float32)
        s = (qf @ kb.transpose(1, 2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            s = torch.where(kpos[None, :] <= qpos, s,
                            torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse)
        dv[:, k0:k0 + BLOCK_K] = (p.to(dout.dtype).to(torch.float32)
                                  .transpose(1, 2) @ dof)
        dp = dof @ vb.transpose(1, 2)
        ds = p * (dp - delta) * scale
        dq = dq + ds @ kb
        dk[:, k0:k0 + BLOCK_K] = ds.transpose(1, 2) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _align_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (BH, S, D), or a fresh contiguous copy of it when its rows do
    not all start on 16-byte boundaries, as the tensor-core kernels'
    cp.async copies need (``contiguous()`` would return such a tensor
    itself when it is contiguous but starts off a boundary)."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * size % 16 == 0
                                      for s in t.stride()[:2]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _fake_bwd(q, k, v, out, dout, lse, *, causal: bool = True):
    _check_bwd_operands(q, k, v, out, dout, lse)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@op_cost.priced(op_cost.flash_bwd_price, _fake_bwd)
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True):
    """The flash-2 backward: q (BH, Sq, D), k/v (BH, Sk, D), the forward's
    output ``out`` and its cotangent ``dout`` (BH, Sq, D), all f32 or all
    bf16, and the forward's ``lse`` (BH, Sq) f32 -> contiguous (dq, dk,
    dv) in the inputs' types. The BH and S strides are free; only an
    ``out``, ``dout`` or ``lse`` whose last stride is not 1, or a bf16
    operand whose rows are not 16-byte aligned, is copied (q, k and v must
    have unit stride along D, as in the forward)."""
    _check_bwd_operands(q, k, v, out, dout, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                         causal=causal)
    bh, sq, d = q.shape
    sk = k.shape[1]
    _check_head_dim("flash_attention_bwd", d)
    out, dout, lse = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (out, dout, lse))
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v, out, dout = (_align_rows(t) for t in (q, k, v, out, dout))
    dq = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty((bh, sk, d), dtype=q.dtype, device=q.device)
              for _ in range(2))
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _build.call("flash_attention_bwd", q.device,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                int(bf16),
                *(s for t in (q, k, v, out, dout) for s in t.stride()[:2]),
                lse.stride(0), bh, sq, sk, d, int(causal))
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route["mma" if bf16 else "simt"] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
# launches by route: "mma" (bf16, on the tensor cores) and "simt" (f32, on
# f32 FMAs)
flash_attention_bwd.launches_by_route = {"mma": 0, "simt": 0}
