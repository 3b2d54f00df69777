"""AdamW over the port's parameter trees, with the reference's warmup and
cosine schedule, global-norm clipping and moment storage in f32, bf16 or
Q8_0 blocks (``core.qformats``: int8 values with an fp16-valued scale a
block of 32, dequantized for the update and requantized after).

The reference's ``repro/optim/adamw.py`` step for step, in f32: the
clipped gradient, the two moments, their bias corrections, the decoupled
weight decay (skipped for 1-D leaves: norms and biases) and
``(p.f32 - lr * step).to(p.dtype)``. Ranks are the reference's
(``core.tree.reference_rank``): a layer's norm scale, 2-D in the
reference's stacked layout, is decayed and may keep Q8_0 moments there,
and so here. Where the reference returns new
arrays, the update writes the parameters and the moments in place (a
full-width phi3-mini state is 46 GB; a second copy would not fit on the
card), under ``torch.no_grad()``, and returns the same trees. The clip is
applied a leaf at a time inside the update, so no f32 copy of the whole
gradient tree is made; the arithmetic is the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import tree
from repro_torch.core.qformats import (
    QBLOCK, QTensor, dequantize_q8_0, quantize_q8_0)


class AdamWState(NamedTuple):
    mu: dict              # first moment, stored per cfg.state_dtype
    nu: dict              # second moment
    count: torch.Tensor   # () int32 step counter


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def _quantizable(leaf: torch.Tensor, rank: int) -> bool:
    return (rank >= 2 and leaf.shape[-1] % QBLOCK == 0
            and leaf.is_floating_point())


def _store(x: torch.Tensor, like: torch.Tensor, rank: int,
           state_dtype: str):
    if state_dtype == "q8_0" and _quantizable(like, rank):
        return quantize_q8_0(x)
    if state_dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.to(torch.float32)


def _load(x) -> torch.Tensor:
    if isinstance(x, QTensor):
        return dequantize_q8_0(x)
    return x.to(torch.float32)


def _write(dst, src) -> None:
    """A stored moment overwritten in place by its new value."""
    if isinstance(dst, QTensor):
        dst.qs.copy_(src.qs)
        dst.scales.copy_(src.scales)
    else:
        dst.copy_(src)


def adamw_init(params, cfg: Optional[OptimizerConfig] = None) -> AdamWState:
    cfg = cfg or OptimizerConfig()

    def zero(path, p):
        return _store(torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), p,
                      tree.reference_rank(path, p), cfg.state_dtype)

    dev = tree.leaves(params)[0].device
    return AdamWState(mu=tree.map_with_path(zero, params),
                      nu=tree.map_with_path(zero, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of peak (f32)."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.lr * (0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares."""
    total = 0
    for g in tree.leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.minimum(torch.ones_like(gn), max_norm / (gn + 1e-9))


def clip_by_global_norm(grads, max_norm: float):
    """(the f32 gradients scaled to at most ``max_norm``, the norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree.map_with_path(
        lambda _, g: g.to(torch.float32) * scale, grads), gn


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: OptimizerConfig
                 ) -> Tuple[dict, AdamWState, dict]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}), the
    parameters and moments updated in place."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    count = state.count + 1
    t = count.to(torch.float32)
    lr = lr_schedule(cfg, count)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    flat_p = tree.leaves_with_path(params)
    flat_g = tree.leaves(grads)
    flat_mu = tree.leaves(state.mu, is_leaf=_is_q)
    flat_nu = tree.leaves(state.nu, is_leaf=_is_q)
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError("grads, moments and params disagree")
    for (path, p), g, mu_s, nu_s in zip(flat_p, flat_g, flat_mu, flat_nu):
        rank = tree.reference_rank(path, p)
        g = g.to(torch.float32) * scale
        mu = cfg.b1 * _load(mu_s) + (1.0 - cfg.b1) * g
        nu = cfg.b2 * _load(nu_s) + (1.0 - cfg.b2) * g * g
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if rank >= 2:
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
        _write(mu_s, _store(mu, p, rank, cfg.state_dtype))
        _write(nu_s, _store(nu, p, rank, cfg.state_dtype))
    state = AdamWState(state.mu, state.nu, count)
    return params, state, {"grad_norm": gn, "lr": lr}
