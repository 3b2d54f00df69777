"""Shared building blocks: linear, layer and RMS norms, GELU and SwiGLU
MLPs, rotary and positional tables, and embeddings.

Functional style over parameter dicts of tensors. Weights are stored
(out_features, in_features) — the kernels' W[N, K] layout. ``engine``
routes a linear through the offload dispatcher (Q8_0 kernel main segment
plus host residual); without one, Q8_0 weights are dequantized in place
(the reference's XLA path).

In a data shard of a mesh training step whose vocabulary is split over
"model" (``sharding.rules.vocab_layout``), the embedding table is a
``VocabShards``: ``embed`` looks each id up on the model shard that holds
its row, and ``models.model`` reads the readout's logits a shard at a
time.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.qformats import QTensor, dequantize_q8_0
from repro_torch.roofline import op_cost
from repro_torch.sharding import ctx

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
           name: str = "linear", *, f32_out: bool = False,
           f32_grad: bool = False) -> torch.Tensor:
    """y = x @ W^T (+ b). ``name`` identifies the call site in the
    dispatcher's plan entries and ledger. ``f32_out`` returns the product
    in f32, not rounded to the operands' type (``_dot_f32``): a model
    shard's partial of a row-parallel product, which the mesh step sums
    in f32 before it rounds once (``models/transformer.py``).
    ``f32_grad``: x is the f32 upcast of a tensor of W's 16-bit type (a
    model shard's copy of a column-parallel product's input), multiplied
    at W's type, its gradient an f32 product (``_dot_f32_grad``)."""
    w = p["w"]
    if engine is not None:
        # a row-parallel shard's partial: the engine plans the whole K
        y = (engine.linear(x, w, name=name, row_parallel=True) if f32_out
             else engine.linear(x, w, name=name))
        y = y.to(torch.float32 if f32_out else x.dtype)
    elif isinstance(w, QTensor):
        y = x @ dequantize_q8_0(w).to(x.dtype).t()
    elif f32_out:
        y = _dot_f32(x, w)
    elif f32_grad:
        y = _dot_f32_grad(x, w)
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


class _F32Product(torch.autograd.Function):
    """x @ w^T of two CUDA tensors of one 16-bit type with an f32 output
    (``torch.mm(..., out_dtype=torch.float32)``: sums of exact products
    in f32, never rounded to the operands' type); its backward the
    operands' type's products, as ``x @ w^T``'s, the incoming f32
    gradient cast to that type first (exact where it is the upcast of
    the rounded output's gradient)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dy @ w
        dw = dy.reshape(-1, dy.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return dx, dw


@op_cost.priced(op_cost.f32_product_price("f32_product"))
def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T with an f32 output: ``_dot``'s product where the operands
    promote to f32; for two CUDA tensors of one 16-bit type
    ``_F32Product``; elsewhere (a 16-bit product on the CPU) the operands
    upcast, whose products are exact in f32 too."""
    dt = torch.promote_types(x.dtype, w.dtype)
    if dt == torch.float32:
        return _dot(x, w)
    if x.is_cuda and w.is_cuda and x.dtype == w.dtype:
        return _F32Product.apply(x, w)
    return x.to(torch.float32) @ w.to(torch.float32).t()


class _F32GradProduct(torch.autograd.Function):
    """x @ w^T of an f32 CUDA x that holds values of w's 16-bit type, in
    that type (``x.to(w.dtype) @ w^T``, the product's own rounding); its
    input gradient an f32 product (``torch.mm(dy, w,
    out_dtype=torch.float32)``), never rounded to the 16-bit type, so
    that the gradients that reach x from several products sum in f32."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.to(w.dtype)
        ctx.save_for_backward(x, w)
        return x @ w.t()

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        rows = dy.reshape(-1, dy.shape[-1])
        dx = torch.mm(rows, w, out_dtype=torch.float32)
        dw = rows.t() @ x.reshape(-1, x.shape[-1])
        return dx.reshape(*dy.shape[:-1], w.shape[1]), dw


@op_cost.priced(op_cost.f32_product_price("f32_grad_product"))
def _dot_f32_grad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T in w's 16-bit type from an f32 x that holds values of that
    type, its input gradient in f32: for two CUDA tensors
    ``_F32GradProduct``; elsewhere the f32 product rounded to w's type,
    whose gradient is an f32 product too."""
    if x.is_cuda and w.is_cuda:
        return _F32GradProduct.apply(x, w)
    return (x @ w.to(torch.float32).t()).to(w.dtype)


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
              engine=None, *, partial: bool = False,
              f32_grad: bool = False) -> torch.Tensor:
    """GELU: down(gelu(up(x))); SwiGLU: down(silu(gate(x)) * up(x)), the
    product in f32, cast to x's type before ``down``, as the reference.
    ``partial``: one model shard's FFN columns, whose ``down`` output is
    a partial of the row-parallel product, returned in f32. ``f32_grad``:
    x is the f32 upcast of the weights' 16-bit type (``linear``), which
    stands for x's type."""
    up = linear(p["up"], x, engine, "ffn.up", f32_grad=f32_grad)
    if act == "swiglu":
        gate = linear(p["gate"], x, engine, "ffn.gate", f32_grad=f32_grad)
        h = F.silu(gate.to(torch.float32)) * up.to(torch.float32)
    elif act == "gelu":
        h = gelu(up.to(torch.float32))
    else:
        raise ValueError(f"act {act!r}: 'gelu' or 'swiglu'")
    return linear(p["down"], h.to(up.dtype if f32_grad else x.dtype),
                  engine, "ffn.down", f32_out=partial)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16) -> dict:
    return {"table": (torch.randn((vocab, d), generator=gen,
                                  device=gen.device) * 0.02).to(dtype)}


@dataclasses.dataclass(frozen=True)
class VocabShards:
    """A vocabulary leaf, (V, d) (the embedding table or ``lm_head``'s
    weight), split over M model shards by its rows: shard m holds
    ``parts[m]``, the next V / M rows, on ``devices[m]``."""
    parts: Tuple[torch.Tensor, ...]
    devices: Tuple[torch.device, ...]

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, int, torch.device]]:
        """(shard m's rows, the first one's index, its device), in
        model-shard order."""
        lo = 0
        for w, dev in zip(self.parts, self.devices, strict=True):
            yield w, lo, dev
            lo += w.shape[0]


def _rows(w, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a table: a Q8_0 table's dequantized in f32."""
    if isinstance(w, QTensor):
        rows = w.qs[idx].to(torch.float32) * w.scales[idx][..., None]
        return rows.reshape(*idx.shape, w.k)
    return w[idx]


def _embed_shards(t: VocabShards, ids: torch.Tensor) -> torch.Tensor:
    """Each model shard looks up the ids in its rows and gives zero rows
    elsewhere, charged to its model entry; the partials are summed in f32
    in model-shard order on ids' device (exact: one is non-zero) and
    rounded back to the table's type. Reported as an all-reduce."""
    acc = None
    for m, (w, lo, dev) in enumerate(t):
        with op_cost.at(model=m):
            local = ids.to(dev).long() - lo
            own = (local >= 0) & (local < w.shape[0])
            got = _rows(w, local.clamp(0, w.shape[0] - 1))
            rows = torch.where(own[..., None], got,
                               torch.zeros((), dtype=got.dtype, device=dev))
            op_cost.collective("all-reduce", rows.numel() * 4,
                               len(t.parts), "vocab embed")
        rows = rows.to(ids.device, torch.float32)
        acc = rows if acc is None else acc + rows
    return acc.to(got.dtype)


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    t = p["table"]
    if isinstance(t, VocabShards):
        return _embed_shards(t, ids)
    if isinstance(t, QTensor):
        # row-wise dequant of the Q8_0 table: only the gathered rows
        rows = t.qs[ids].to(torch.float32) * t.scales[ids][..., None]
        return rows.reshape(*ids.shape, t.k)
    return t[ids]


def vocab_logits(w: VocabShards, x: torch.Tensor, engine=None,
                 name: str = "dec.vocab") -> torch.Tensor:
    """The readout ``x @ W^T`` with W's rows split over model shards:
    each shard m computes the logits of its rows of the padded vocabulary
    on its device (model shard m of a column-parallel linear, charged to
    its model entry), and the logits are gathered onto x's device in
    shard order (reported as an all-gather). Each column is the unsplit
    readout's product."""
    out = []
    n = len(w.parts)
    for m, (wm, _, dev) in enumerate(w):
        with op_cost.at(model=m), ctx.model_shard_scope(m, n):
            y = unembed({"table": wm}, x.to(dev), engine, name)
            op_cost.collective("all-gather",
                               y.numel() * y.element_size() * n, n,
                               "vocab logits")
        out.append(y.to(x.device))
    return torch.cat(out, dim=-1)


def unembed(p: dict, x: torch.Tensor, engine=None,
            name: str = "dec.vocab") -> torch.Tensor:
    """Tied readout: logits = x @ table^T (the paper's ``dec.vocab``
    kernel class — its single largest dot product); a split table's by
    ``vocab_logits``."""
    t = p["table"]
    if isinstance(t, VocabShards):
        return vocab_logits(t, x, engine, name)
    if engine is not None or isinstance(t, QTensor):
        return linear({"w": t}, x, engine, name)
    return _dot(x, t)
