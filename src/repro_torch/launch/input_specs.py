"""Fake-tensor stand-ins for every model input of every (architecture x
input-shape) cell, the port's counterpart of the reference's
``launch/input_specs.py``: shapes, types and devices, no storage. The
dry-run (``launch/dryrun.py``) runs the port's programs over them.

Where the reference builds ``jax.ShapeDtypeStruct`` trees with
``jax.eval_shape``, the port runs its own constructors (``init_params``,
``quantize_tree``, ``init_serve_state``) under a ``FakeTensorMode``
(``fake_mode()``) on an explicit device: the CPU by default (autograd over
fake CUDA tensors needs a build with CUDA). Every function takes the mode
its tensors belong to; a tensor of one mode cannot meet another's.

Semantics, the reference's:
  train/prefill  a full-sequence batch (teacher-forced for whisper);
  decode/long    ONE new token against a KV cache of ``seq_len`` (the
                 state from ``abstract_serve_state``, its step at
                 ``seq_len - 1``);
  [audio]/[vlm]  the modality frontends are stubs: mel frames and patch
                 embeddings arrive precomputed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import tree
from repro_torch.models import layers
from repro_torch.models import model as model_lib


def fake_mode() -> FakeTensorMode:
    """A mode whose tensors have shapes, types and devices and no
    storage."""
    return FakeTensorMode()


def batch_specs_struct(cfg: ModelConfig, shape: ShapeConfig, *,
                       mode: FakeTensorMode, device="cpu"
                       ) -> Dict[str, torch.Tensor]:
    """Full-sequence batch tensors (train / prefill kinds)."""
    b, s = shape.global_batch, shape.seq_len
    with mode:
        out = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                     device=device),
               "labels": torch.zeros((b, s), dtype=torch.int32,
                                     device=device)}
        if cfg.family == "audio":
            out["mel"] = torch.zeros((b, s, cfg.n_mels), dtype=torch.float32,
                                     device=device)
        if cfg.family == "vlm" and cfg.vision_patches:
            p = min(cfg.vision_patches, s // 2)
            out["patches"] = torch.zeros((b, p, cfg.vision_embed_dim),
                                         dtype=torch.float32, device=device)
    return out


def token_struct(shape: ShapeConfig, *, mode: FakeTensorMode,
                 device="cpu") -> torch.Tensor:
    with mode:
        return torch.zeros((shape.global_batch, 1), dtype=torch.int32,
                           device=device)


def abstract_params(cfg: ModelConfig, shape: ShapeConfig, *,
                    mode: FakeTensorMode, quantize=None, device="cpu"):
    """The parameter tree of fake tensors (``quantize``, a function of the
    tree, quantizes it)."""
    with mode:
        p = model_lib.init_params(torch.Generator().manual_seed(0), cfg,
                                  max_positions=shape.seq_len, device=device)
        if quantize is not None:
            p = quantize(p)
    return p


def abstract_serve_state(cfg: ModelConfig, shape: ShapeConfig, params, *,
                         mode: FakeTensorMode):
    """The decode state of fake tensors with a cache of length seq_len and
    its step at seq_len - 1 (the decode cells' premise: the cache is
    already full; one new token runs)."""
    b, s = shape.global_batch, shape.seq_len
    with mode:
        memory = None
        if cfg.family == "audio":
            memory = torch.zeros((b, cfg.encoder_ctx, cfg.d_model),
                                 dtype=layers.DTYPES[cfg.dtype],
                                 device=_device_of(params))
        with torch.no_grad():
            st = model_lib.init_serve_state(params, cfg, b, s, memory=memory)
        st.step.fill_(s - 1)
    return st


def _device_of(params) -> torch.device:
    return tree.leaves(params)[0].device


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                mode: Optional[FakeTensorMode] = None, quantize=None,
                device="cpu") -> Dict[str, Any]:
    """Everything the dry-run needs for one cell, keyed by role, with the
    mode its tensors belong to under "mode"."""
    mode = mode or fake_mode()
    out: Dict[str, Any] = {"mode": mode, "params": abstract_params(
        cfg, shape, mode=mode, quantize=quantize, device=device)}
    if shape.is_decode:
        out["token"] = token_struct(shape, mode=mode, device=device)
        out["state"] = abstract_serve_state(cfg, shape, out["params"],
                                            mode=mode)
    else:
        out["batch"] = batch_specs_struct(cfg, shape, mode=mode,
                                          device=device)
    return out
