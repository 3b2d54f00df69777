"""Mamba2 / SSD (state-space duality) mixer — arXiv:2405.21060.

The port's counterpart of the reference's ``models/ssm.py``: the carried
state (``SSMState``), the parameters (``init_ssm``), the one-token
recurrent update (``ssm_decode_step``) that serving runs once a token, and
the full-sequence mixer (``ssm_mixer``) of the model API's ``forward`` on
the chunked SSD scan (``ssd_scan``, with its naive oracle
``ssd_reference``). Used by ``mamba2-780m`` (every layer) and
``jamba-v0.1-52b`` (7 of each 8 layers). The reference's scan is plain
einsums outside any Pallas kernel, and so is the port's.

A step: ``in_proj`` emits ``[z, x, B, C, dt]``; the (x, B, C) channels
pass a causal depthwise conv over a rolling window of the last
``d_conv`` inputs and a SiLU; each head's (P, N) state decays by
``exp(dt * A)`` and takes ``dt * x B^T``; the readout ``C . state`` plus
``D * x``, gated by ``silu(z)``, goes through an RMS norm and
``out_proj``. The two linears are the offloadable products (their plan
entries are ``ssm.in_proj`` and ``ssm.out_proj``, as the reference's);
the rest are small elementwise ops and one reduction.

Precision is the reference's: the decode step leaves ``zxbcdt`` in the
linear's type, where the full-sequence mixer casts it to the input's
type; the conv window and everything after it run in f32, ``y`` is cast
to the input's type before the gated norm, and the output to the input's
type. The state is f32 whatever the model's type.

A decode row's bits do not depend on the batch: on the card an einsum
becomes a batched GEMM that cuBLAS picks by its row count. So the conv is
its ``d_conv`` products added in index order (the reference's
full-sequence mixer writes it so), the state update an outer product by
broadcasting, and the readout an elementwise product summed over N. The
full-sequence scan is not a served path and keeps the reference's
einsums.

The step writes the new conv window and state into the state's own
tensors and advances its ``length`` in place: a captured step rereads the
storage it was captured with.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Chunked SSD scan (forward over a full sequence)
# ---------------------------------------------------------------------------
def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum a[..., j+1:i+1].
    a: (..., T). Returns (..., T, T) with -inf above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, torch.full_like(seg, float("-inf")))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_in: torch.Tensor, c_out: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD over a full sequence (Mamba2 Alg. 1, blocked-matmul
    form), the reference's ``ssd_scan``.

    x: (b, s, h, p) per-head inputs; dt: (b, s, h) positive step sizes;
    a: (h,) negative decay rates; b_in, c_out: (b, s, g, n) input and
    output projections (groups broadcast to heads). Returns (y (b, s, h,
    p), final state (b, h, p, n)), f32. The reference's multi-operand
    einsums are contracted a pair at a time."""
    b, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    if s % chunk:
        chunk = s  # single chunk for ragged shapes, as the reference does
    nc = s // chunk
    rep = h // g
    f32 = torch.float32

    xdt = x.to(f32) * dt[..., None]                            # (b,s,h,p)
    da = dt * a[None, None, :]                                 # (b,s,h) <= 0
    xc = xdt.reshape(b, nc, chunk, h, p)
    dac = da.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)      # (b,h,c,l)
    bc = b_in.to(f32).reshape(b, nc, chunk, g, n).repeat_interleave(rep, 3)
    cc = c_out.to(f32).reshape(b, nc, chunk, g, n).repeat_interleave(rep, 3)

    da_cum = torch.cumsum(dac, dim=-1)                         # (b,h,c,l)
    lmat = torch.exp(_segsum(dac))                             # (b,h,c,l,s)

    # 1) intra-chunk (diagonal blocks)
    scores = torch.einsum("bclhn,bcshn->bchls", cc, bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp",
                          scores * lmat.permute(0, 2, 1, 3, 4), xc)

    # 2) per-chunk states: each position's decayed contribution at the
    # chunk's end
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)        # (b,h,c,l)
    states = torch.einsum("bclhn,bclhp->bchpn", bc,
                          xc * decay_states.permute(0, 2, 3, 1)[..., None])

    # 3) the recurrence over the chunk boundaries
    if initial_state is None:
        init = torch.zeros((b, 1, h, p, n), dtype=f32, device=x.device)
    else:
        init = initial_state.to(f32)[:, None]
    states = torch.cat([init, states], dim=1)                  # (b,c+1,h,p,n)
    pad = F.pad(da_cum[..., -1], (1, 0))     # (b,h,c+1)
    decay_chunk = torch.exp(_segsum(pad))                      # (b,h,c+1,c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4) each chunk's incoming state, read out within the chunk
    state_decay_out = torch.exp(da_cum)                        # (b,h,c,l)
    y_off = (torch.einsum("bclhn,bchpn->bclhp", cc, prev_states)
             * state_decay_out.permute(0, 2, 3, 1)[..., None])

    return (y_diag + y_off).reshape(b, s, h, p), final_state


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_in: torch.Tensor, c_out: torch.Tensor,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The naive per-step recurrence, the oracle of ``ssd_scan``:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T; y_t = C_t . h_t."""
    b, s, h, p = x.shape
    rep = h // b_in.shape[2]
    f32 = torch.float32
    bh = b_in.to(f32).repeat_interleave(rep, 2)
    ch = c_out.to(f32).repeat_interleave(rep, 2)
    state = (torch.zeros((b, h, p, b_in.shape[3]), dtype=f32,
                         device=x.device)
             if initial_state is None else initial_state.to(f32))
    ys = []
    for t in range(s):
        xt = x[:, t].to(f32)
        dtt = dt[:, t].to(f32)
        decay = torch.exp(dtt * a[None, :])
        upd = torch.einsum("bhn,bhp->bhpn", bh[:, t], xt * dtt[..., None])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], state))
    return torch.stack(ys, dim=1), state


def ssm_mixer(p: dict, cfg: ModelConfig, u: torch.Tensor, *,
              engine=None) -> torch.Tensor:
    """The full-sequence SSD mixer, the reference's ``ssm_mixer``:
    u (B, S, d_model) -> (B, S, d_model) in u's type. in_proj, the causal
    depthwise conv (its d_conv products added in index order) and SiLU,
    the chunked SSD scan from a zero state, ``D * x``, the gate and the
    RMS norm, out_proj."""
    ssm = cfg.ssm
    b, s, _ = u.shape
    di = ssm.d_inner(cfg.d_model)
    gn = ssm.n_groups * ssm.d_state
    nh = ssm.n_heads(cfg.d_model)
    f32 = torch.float32
    zxbcdt = layers.linear(p["in_proj"], u, engine, "ssm.in_proj")
    z, xbc, dt = torch.split(zxbcdt.to(u.dtype), [di, di + 2 * gn, nh],
                             dim=-1)

    w = p["conv_w"].to(f32)                                    # (d_conv, C)
    xpad = F.pad(xbc.to(f32), (0, 0, ssm.d_conv - 1, 0))
    conv = xpad[:, 0:s] * w[0]
    for i in range(1, ssm.d_conv):
        conv = conv + xpad[:, i:i + s] * w[i]
    xbc = F.silu(conv + p["conv_b"].to(f32))

    x, bm, cm = torch.split(xbc, [di, gn, gn], dim=-1)
    x = x.reshape(b, s, nh, ssm.head_dim)
    bm = bm.reshape(b, s, ssm.n_groups, ssm.d_state)
    cm = cm.reshape(b, s, ssm.n_groups, ssm.d_state)
    a = -torch.exp(p["A_log"])
    dt = _softplus(dt.to(f32) + p["dt_bias"])

    y, _ = ssd_scan(x, dt, a, bm, cm, ssm.chunk)
    y = y + x * p["D"][None, None, :, None]
    y = y.reshape(b, s, di)

    y = y * F.silu(z.to(f32))                     # gated RMS norm (Mamba2)
    y = layers.norm_apply(p["norm"], y.to(u.dtype), "rmsnorm")
    return layers.linear(p["out_proj"], y, engine,
                         "ssm.out_proj").to(u.dtype)


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

