"""Int8 error-feedback gradient compression, the reference's
``repro/optim/compression.py``: each compressible gradient leaf (2-D or
more, the last dim a multiple of 32) has the carried error added, is
quantized to Q8_0 blocks and dequantized, and keeps the quantization
residual as the next step's error; other leaves pass through in f32. On
one device nothing crosses a wire: the compression changes the numerics
exactly as it would before a data-parallel all-reduce, and ``stats``
counts the bytes such a reduce would move. Ranks are the reference's
(``core.tree.reference_rank``): a layer's norm scale is 2-D there, and
compressed.

``ef_compress_split`` compresses a reduced gradient stored split over a
mesh (``sharding.rules.Pieces``) part by part, its error accumulators
split alike and updated in place. A Q8_0 block must not straddle a part:
where a leaf's last dim is split into parts that are not a multiple of
32 wide, the leaf is compressed whole on its first piece's device and
written back into every piece.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tree
from repro_torch.core.qformats import QBLOCK, dequantize_q8_0, quantize_q8_0
from repro_torch.sharding import rules


def _compressible(path, g: torch.Tensor) -> bool:
    return tree.reference_rank(path, g) >= 2 and g.shape[-1] % QBLOCK == 0


def ef_init(params) -> dict:
    """Error accumulators: f32 zeros for compressible leaves, a () f32
    zero for the rest (a uniform tree)."""
    return tree.map_with_path(
        lambda path, p: torch.zeros(p.shape if _compressible(path, p) else (),
                                 dtype=torch.float32, device=p.device),
        params)


@torch.no_grad()
def ef_compress_grads(grads, ef: dict) -> Tuple[dict, dict, dict]:
    """(compressed f32 grads, new error tree, {"wire_bytes", "raw_bytes",
    "ratio"}): the int8 payload and fp16 scales against f32."""
    raw = wire = 0
    flat_g, flat_e = tree.leaves_with_path(grads), tree.leaves(ef)
    out_g, out_e = [], []
    for (path, g), e in zip(flat_g, flat_e, strict=True):
        g = g.to(torch.float32)
        if not _compressible(path, g):
            out_g.append(g)
            out_e.append(e)
            continue
        acc = g + e
        q = quantize_q8_0(acc)
        deq = dequantize_q8_0(q)
        raw += g.numel() * 4
        wire += q.qs.numel() + 2 * q.scales.numel()
        out_g.append(deq)
        out_e.append(acc - deq)
    stats = {"wire_bytes": wire, "raw_bytes": raw,
             "ratio": wire / max(raw, 1)}
    return (tree.unflatten_like(grads, out_g),
            tree.unflatten_like(ef, out_e), stats)


def _compress(g: torch.Tensor, e: torch.Tensor):
    """(the dequantized Q8_0 blocks of g + e, the new error)."""
    acc = g.to(torch.float32) + e
    deq = dequantize_q8_0(quantize_q8_0(acc))
    return deq, acc - deq


@torch.no_grad()
def ef_compress_split(grads, ef, ef_specs, mesh):
    """``ef_compress_grads`` over a split f32 gradient tree (laid out as
    the parameters) and error tree (specs ``ef_specs``): returns the
    compressed gradient ``Pieces``; ``ef`` is updated in place. A leaf is
    compressible where its error accumulator is not a scalar (``ef_init``
    decided on the whole leaf)."""
    out = []
    for g, e, sp in zip(tree.leaves(grads, is_leaf=rules.is_pieces),
                        tree.leaves(ef, is_leaf=rules.is_pieces),
                        tree.leaves(ef_specs, is_leaf=rules.is_spec),
                        strict=True):
        if e[0].ndim == 0:
            out.append(g)
            continue
        shape = rules.whole_shape(e, sp, mesh)
        if (len(sp) < len(shape)
                or (shape[-1] // mesh.parts(sp)[-1]) % QBLOCK == 0):
            pieces = []
            for gk, ek in zip(g, e):
                deq, err = _compress(gk, ek)
                ek.copy_(err)
                pieces.append(deq)
            out.append(rules.Pieces(pieces))
            continue
        lay = rules.leaf_layout(shape, sp, mesh)
        dev = lay.devices[0]
        deq, err = _compress(rules.gather_leaf(g, sp, mesh, dev),
                             rules.gather_leaf(e, sp, mesh, dev))
        rules.scatter_leaf(err, e, sp, mesh)
        out.append(rules.Pieces(deq[r].to(d, copy=True) for r, d in
                                zip(lay.regions, lay.devices)))
    return tree.unflatten_like(grads, out, is_leaf=rules.is_pieces)
