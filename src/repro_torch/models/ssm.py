"""Mamba2 / SSD (state-space duality) mixer, decode path — arXiv:2405.21060.

The port's counterpart of the reference's ``models/ssm.py`` for serving:
the carried state (``SSMState``), the parameters (``init_ssm``) and the
one-token recurrent update (``ssm_decode_step``). Used by ``mamba2-780m``
(every layer) and ``jamba-v0.1-52b`` (7 of each 8 layers). The reference's
chunked full-sequence scan serves its ``forward`` (training and long
prefills); its LM serving prefill, which the port follows, is the decode
step run once a prompt token, so the scan is not here.

A step: ``in_proj`` emits ``[z, x, B, C, dt]``; the (x, B, C) channels
pass a causal depthwise conv over a rolling window of the last
``d_conv`` inputs and a SiLU; each head's (P, N) state decays by
``exp(dt * A)`` and takes ``dt * x B^T``; the readout ``C . state`` plus
``D * x``, gated by ``silu(z)``, goes through an RMS norm and
``out_proj``. The two linears are the offloadable products (their plan
entries are ``ssm.in_proj`` and ``ssm.out_proj``, as the reference's);
the rest are small elementwise ops and one reduction.

Precision is the reference's: ``zxbcdt`` is left in the linear's type
(the decode casts nothing there, where the full-sequence mixer casts to
the input's type), the conv window and everything after it run in f32,
``y`` is cast to the input's type before the gated norm, and the output
to the input's type. The state is f32 whatever the model's type.

A row's bits do not depend on the batch: on the card an einsum becomes a
batched GEMM that cuBLAS picks by its row count. So the conv is its
``d_conv`` products added in index order (the reference's full-sequence
mixer writes it so), the state update an outer product by broadcasting,
and the readout an elementwise product summed over N.

The step writes the new conv window and state into the state's own
tensors and advances its ``length`` in place: a captured step rereads the
storage it was captured with.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import layers


class SSMState(NamedTuple):
    """Carried decode state of one SSD layer, every tensor with the batch
    on axis 0."""
    conv: torch.Tensor     # (B, d_conv - 1, conv_dim) f32: the last inputs
    ssd: torch.Tensor      # (B, H, P, N) f32: the recurrent state
    length: torch.Tensor   # () or (B,) int32: tokens absorbed so far

    @classmethod
    def zeros(cls, b: int, ssm: SSMConfig, d_model: int, *,
              device) -> "SSMState":
        """The empty state, f32 whatever the model's type: the reference
        builds its decode state with ``SSMState.zeros``' default type."""
        di = ssm.d_inner(d_model)
        conv_dim = di + 2 * ssm.n_groups * ssm.d_state
        return cls(
            conv=torch.zeros((b, ssm.d_conv - 1, conv_dim),
                             dtype=torch.float32, device=device),
            ssd=torch.zeros((b, ssm.n_heads(d_model), ssm.head_dim,
                             ssm.d_state), dtype=torch.float32,
                            device=device),
            length=torch.zeros((), dtype=torch.int32, device=device))


def init_ssm(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.bfloat16) -> dict:
    """The reference's layout, drawn from ``gen`` on its device:
    ``in_proj`` (d -> 2 di + 2 G N + H), ``out_proj`` (di -> d), the
    depthwise ``conv_w`` (d_conv, conv_dim) ~ N(0, 1/d_conv) and a zero
    ``conv_b`` in ``dtype``; ``A_log`` = log(linspace(1, 16, H)), ``D`` =
    1 and ``dt_bias`` = softplus^-1(linspace(1e-3, 1e-1, H)) in f32; the
    gated RMS norm's scale over di."""
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.d_inner(d)
    nh = ssm.n_heads(d)
    gn = ssm.n_groups * ssm.d_state
    conv_dim = di + 2 * gn
    dev = gen.device
    return {
        "in_proj": layers.init_linear(gen, d, 2 * di + 2 * gn + nh,
                                      dtype=dtype),
        "out_proj": layers.init_linear(gen, di, d, dtype=dtype),
        "conv_w": (torch.randn((ssm.d_conv, conv_dim), generator=gen,
                               device=dev) * ssm.d_conv ** -0.5).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        # A is a per-head scalar: A = -exp(A_log) < 0
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.linspace(
            1e-3, 1e-1, nh, dtype=torch.float32, device=dev))),
        "norm": layers.init_norm(di, dtype, kind="rmsnorm", device=dev),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    linear cut-off above a threshold (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_decode_step(p: dict, cfg: ModelConfig, u: torch.Tensor,
                    state: SSMState, *, engine=None
                    ) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrent update, the reference's ``ssm_decode_step``.
    u: (B, 1, d_model) -> (out (B, 1, d_model) in u's type, state), the
    state's conv window, SSD state and length advanced in place."""
    ssm = cfg.ssm
    b = u.shape[0]
    di = ssm.d_inner(cfg.d_model)
    gn = ssm.n_groups * ssm.d_state
    nh = ssm.n_heads(cfg.d_model)
    zxbcdt = layers.linear(p["in_proj"], u[:, 0], engine, "ssm.in_proj")
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * gn, nh], dim=-1)

    # rolling conv window: state.conv holds the previous d_conv - 1 inputs
    window = torch.cat([state.conv, xbc.to(torch.float32)[:, None]], dim=1)
    w = p["conv_w"].to(torch.float32)
    conv = window[:, 0] * w[0]
    for i in range(1, ssm.d_conv):
        conv = conv + window[:, i] * w[i]
    xbc_a = F.silu(conv + p["conv_b"].to(torch.float32))
    state.conv.copy_(window[:, 1:])

    x, bm, cm = torch.split(xbc_a, [di, gn, gn], dim=-1)
    x = x.reshape(b, nh, ssm.head_dim)
    rep = nh // ssm.n_groups
    bh = bm.reshape(b, ssm.n_groups, ssm.d_state).repeat_interleave(rep, 1)
    ch = cm.reshape(b, ssm.n_groups, ssm.d_state).repeat_interleave(rep, 1)
    a = -torch.exp(p["A_log"])
    dt1 = _softplus(dt.to(torch.float32) + p["dt_bias"])        # (B, H)

    decay = torch.exp(dt1 * a[None, :])
    upd = bh[:, :, None, :] * (x * dt1[..., None])[..., None]   # (B,H,P,N)
    state.ssd.mul_(decay[..., None, None]).add_(upd)
    y = (ch[:, :, None, :] * state.ssd).sum(-1)                 # (B, H, P)
    y = y + x * p["D"][None, :, None]
    y = y.reshape(b, di)

    y = y * F.silu(z.to(torch.float32))
    y = layers.norm_apply(p["norm"], y.to(u.dtype), "rmsnorm")
    out = layers.linear(p["out_proj"], y[:, None], engine, "ssm.out_proj")
    state.length.add_(1)
    return out.to(u.dtype), state

