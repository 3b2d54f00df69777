"""GGML-compatible Q8_0 block quantization, in PyTorch.

Q8_0: blocks of 32 values; per-block scale d = amax/127 stored in fp16;
quantized values q = round(x/d) in int8 (GGML ``roundf``: half away from
zero). The arithmetic below mirrors the reference step for step so that
``qs`` and ``scales`` are bit-exact with it: the fp16 round-trip of the
scale, the ``d > 0`` guard, and scales held as f32.

Storage convention for a weight matrix W[N, K] (out_features, in_features):
  qs:     int8  [N, K//32, 32]   (kernels consume the flattened [N, K] view)
  scales: f32   [N, K//32]       (values round-trip through fp16, as GGML)
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

QBLOCK = 32  # GGML Q8_0 block size


class QTensor(NamedTuple):
    """A Q8_0-quantized tensor. Leading dims arbitrary; last dim blocked."""
    qs: torch.Tensor        # int8, shape (..., K//QBLOCK, QBLOCK)
    scales: torch.Tensor    # f32 (fp16-valued), shape (..., K//QBLOCK)

    @property
    def k(self) -> int:
        return self.qs.shape[-2] * self.qs.shape[-1]

    @property
    def shape(self) -> Tuple[int, ...]:
        return (*self.qs.shape[:-2], self.k)

    def flat_qs(self) -> torch.Tensor:
        """int8 view with blocks flattened back into K: shape (..., K).
        A view, never a copy: a K-slice of a QTensor keeps the full row
        stride, which the kernels take as an argument."""
        return self.qs.view(*self.qs.shape[:-2], self.k)

    def to(self, device) -> "QTensor":
        return QTensor(self.qs.to(device), self.scales.to(device))


#: rows of a large tensor are quantized in chunks of about this many
#: values, so that the f32 temporaries stay near 1 GB whatever the tensor
#: (qwen2.5-14b's 152,064 x 5,120 readout would take four 3.1 GB ones);
#: every block is computed alone, so chunking changes no bit
CHUNK_VALUES = 1 << 26


def quantize_q8_0(w: torch.Tensor) -> QTensor:
    """Quantize along the last axis in blocks of 32. K must divide by 32."""
    *lead, k = w.shape
    if k % QBLOCK != 0:
        raise ValueError(f"K={k} not a multiple of {QBLOCK}; pad or use "
                         "mixed_exec.split_aligned for the residual")
    rows = w.numel() // k if k else 0
    step = max(1, CHUNK_VALUES // max(k, 1))
    if rows > step:
        flat = w.reshape(rows, k)
        qs = torch.empty((rows, k // QBLOCK, QBLOCK), dtype=torch.int8,
                         device=w.device)
        scales = torch.empty((rows, k // QBLOCK), dtype=torch.float32,
                             device=w.device)
        for r0 in range(0, rows, step):
            part = _quantize_blocks(flat[r0:r0 + step])
            qs[r0:r0 + step] = part.qs
            scales[r0:r0 + step] = part.scales
        return QTensor(qs=qs.reshape(*lead, k // QBLOCK, QBLOCK),
                       scales=scales.reshape(*lead, k // QBLOCK))
    return _quantize_blocks(w)


def _quantize_blocks(w: torch.Tensor) -> QTensor:
    """``quantize_q8_0`` of one tensor or one chunk of rows, at once."""
    *lead, k = w.shape
    blocks = w.to(torch.float32).reshape(*lead, k // QBLOCK, QBLOCK)
    amax = blocks.abs().amax(dim=-1)
    # divide by a full tensor, not a Python scalar: CUDA's division by a
    # scalar multiplies by its reciprocal, which is not bit-exact
    d = (amax / torch.full_like(amax, 127.0)
         ).to(torch.float16).to(torch.float32)               # GGML stores fp16
    inv = torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
    q = blocks * inv[..., None]
    q = torch.sign(q) * torch.floor(q.abs() + 0.5)          # half away from 0
    q = q.clamp(-127, 127).to(torch.int8)
    return QTensor(qs=q, scales=d)


def dequantize_q8_0(t: QTensor) -> torch.Tensor:
    """Exact inverse map (float32)."""
    w = t.qs.to(torch.float32) * t.scales[..., None]
    return w.reshape(t.shape)


def reconstruction_error(w: torch.Tensor, t: QTensor) -> dict:
    """The §4.2 error metrics of one tensor (or a flattened stack) against
    its Q8_0 form: mean and root-mean-square error, the largest error,
    and the relative L2 error, all in f32."""
    w = w.to(torch.float32)
    err = dequantize_q8_0(t) - w
    rel_l2 = (torch.linalg.vector_norm(err.reshape(-1))
              / (torch.linalg.vector_norm(w.reshape(-1)) + 1e-30))
    return {"mae": float(err.abs().mean()),
            "rmse": float(torch.sqrt((err ** 2).mean())),
            "max_abs": float(err.abs().max()),
            "rel_l2": float(rel_l2),
            "n_values": w.numel()}


Path = Tuple[object, ...]


def quantize_tree(params, predicate: Optional[Callable[[Path, torch.Tensor],
                                                       bool]] = None,
                  _path: Path = ()):
    """Quantize every >=2D float leaf whose last dim divides QBLOCK.

    ``params`` nests dicts and lists of tensors. ``predicate(path, leaf)``
    can veto quantization (e.g. keep norms and positional tables dense, as
    whisper.cpp does); ``path`` is the tuple of dict keys and list indices
    leading to the leaf. Returns the same nesting with quantized leaves as
    ``QTensor``.
    """
    if isinstance(params, dict):
        return {k: quantize_tree(v, predicate, (*_path, k))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)) and not isinstance(params, QTensor):
        return type(params)(quantize_tree(v, predicate, (*_path, i))
                            for i, v in enumerate(params))
    leaf = params
    if not isinstance(leaf, torch.Tensor):
        return leaf
    if leaf.ndim < 2 or leaf.shape[-1] % QBLOCK != 0:
        return leaf
    if not leaf.is_floating_point():
        return leaf
    if predicate is not None and not predicate(_path, leaf):
        return leaf
    return quantize_q8_0(leaf)
