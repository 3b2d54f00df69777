"""Shared building blocks: linear, layer and RMS norms, GELU and SwiGLU
MLPs, rotary and positional tables, and embeddings.

Functional style over parameter dicts of tensors. Weights are stored
(out_features, in_features) — the kernels' W[N, K] layout. ``engine``
routes a linear through the offload dispatcher (Q8_0 kernel main segment
plus host residual); without one, Q8_0 weights are dequantized in place
(the reference's XLA path).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.qformats import QTensor, dequantize_q8_0

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.bfloat16) -> dict:
    """W (d_out, d_in) ~ N(0, 1/d_in) and an optional zero bias, drawn on
    the generator's device."""
    dev = gen.device
    p = {"w": (torch.randn((d_out, d_in), generator=gen, device=dev)
               * d_in ** -0.5).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p


def linear(p: dict, x: torch.Tensor, engine=None,
           name: str = "linear") -> torch.Tensor:
    """y = x @ W^T (+ b). ``name`` identifies the call site in the
    dispatcher's plan entries and ledger."""
    w = p["w"]
    if engine is not None:
        y = engine.linear(x, w, name=name).to(x.dtype)
    elif isinstance(w, QTensor):
        y = x @ dequantize_q8_0(w).to(x.dtype).t()
    else:
        y = _dot(x, w)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T in the promoted type of the two, as ``jax.lax.dot_general``
    promotes mixed operands."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt).t()


def init_norm(d: int, dtype=torch.bfloat16, *, kind: str = "layernorm",
              device=None) -> dict:
    """A norm's scale (ones) and, for a layer norm, its bias (zeros)."""
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p: dict, x: torch.Tensor, kind: str = "layernorm",
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm (population variance) or RMS norm in f32, cast back to
    the input's type (the reference's ``norm_apply``). Each runs as one
    fused call, ``layer_norm`` or ``rms_norm``, whose CUDA kernel reduces
    each row in a block of its own: a row's bits do not depend on how many
    rows the batch holds. The statistics as separate reductions would not
    do: their launch shape, and with it the order of a row's sums, follows
    the row count, and a row of a 12-row slot step got other bits than in
    a batch-1 step."""
    xf = x.to(torch.float32)
    scale = p["scale"].to(torch.float32)
    if kind == "rmsnorm":
        out = F.rms_norm(xf, (x.shape[-1],), scale, eps)
    elif kind == "layernorm":
        bias = p["bias"].to(torch.float32) if "bias" in p else None
        out = F.layer_norm(xf, (x.shape[-1],), scale, bias, eps)
    else:
        raise ValueError(f"norm {kind!r}: 'layernorm' or 'rmsnorm'")
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """The rotary inverse frequencies ``theta ** -(2i / head_dim)``, f32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding of x (..., S, H, D) at integer ``positions``
    broadcastable to (..., S): the angles in f32, the split-halves
    rotation of the reference (the first D/2 channels against the last),
    cast back to x's type. Elementwise, so a row's bits do not depend on
    the batch."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table (n, d), f32. The divisor
    ``d // 2 - 1 + 1e-9`` is the reference's, kept exactly."""
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32)[None, :]
    inv = torch.exp(-torch.log(torch.tensor(10_000.0)) * dim
                    / (d // 2 - 1 + 1e-9))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp(gen: torch.Generator, d: int, d_ff: int,
             dtype=torch.bfloat16, *, act: str = "gelu") -> dict:
    """up and down projections, and a SwiGLU's gate (drawn last)."""
    p = {"up": init_linear(gen, d, d_ff, dtype=dtype),
         "down": init_linear(gen, d_ff, d, dtype=dtype)}
    if act == "swiglu":
        p["gate"] = init_linear(gen, d, d_ff, dtype=dtype)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str = "gelu",
              engine=None) -> torch.Tensor:
    """GELU: down(gelu(up(x))); SwiGLU: down(silu(gate(x)) * up(x)), the
    product in f32, cast to x's type before ``down``, as the reference."""
    up = linear(p["up"], x, engine, "ffn.up")
    if act == "swiglu":
        gate = linear(p["gate"], x, engine, "ffn.gate")
        h = F.silu(gate.to(torch.float32)) * up.to(torch.float32)
    elif act == "gelu":
        h = gelu(up.to(torch.float32))
    else:
        raise ValueError(f"act {act!r}: 'gelu' or 'swiglu'")
    return linear(p["down"], h.to(x.dtype), engine, "ffn.down")


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16) -> dict:
    return {"table": (torch.randn((vocab, d), generator=gen,
                                  device=gen.device) * 0.02).to(dtype)}


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    t = p["table"]
    if isinstance(t, QTensor):
        # row-wise dequant of the Q8_0 table: only the gathered rows
        rows = t.qs[ids].to(torch.float32) * t.scales[ids][..., None]
        return rows.reshape(*ids.shape, t.k)
    return t[ids]


def unembed(p: dict, x: torch.Tensor, engine=None) -> torch.Tensor:
    """Tied readout: logits = x @ table^T (the paper's ``dec.vocab``
    kernel class — its single largest dot product)."""
    t = p["table"]
    if engine is not None or isinstance(t, QTensor):
        return linear({"w": t}, x, engine, "dec.vocab")
    return _dot(x, t)
