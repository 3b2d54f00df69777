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

``adamw_update_split`` is the same step over a state stored split over a
mesh (``sharding.rules.Pieces``): the global norm sums each distinct
part's squares, leaf by leaf in the tree's order and part by part, on the
first piece's device; the update is elementwise, so each held part is
updated on its own device, with the decay rank of the whole leaf. Where a
moment's Q8_0 legs are not split as the parameter is (its blocks would
straddle a part), that leaf is updated whole on its first piece's device
and written back into every piece.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import tree
from repro_torch.core.qformats import (
    QBLOCK, QTensor, dequantize_q8_0, quantize_q8_0)
from repro_torch.roofline import op_cost
from repro_torch.sharding import rules


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
        _update_leaf(p, g, mu_s, nu_s, tree.reference_rank(path, p), scale,
                     lr, bc1, bc2, cfg)
    state = AdamWState(state.mu, state.nu, count)
    return params, state, {"grad_norm": gn, "lr": lr}


def _update_leaf(p, g, mu_s, nu_s, rank: int, scale, lr, bc1, bc2,
                 cfg: OptimizerConfig) -> None:
    """One leaf (or one part of it) updated in place, with its moments."""
    g = g.to(torch.float32) * scale
    mu = cfg.b1 * _load(mu_s) + (1.0 - cfg.b1) * g
    nu = cfg.b2 * _load(nu_s) + (1.0 - cfg.b2) * g * g
    step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
    if rank >= 2:
        step = step + cfg.weight_decay * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
    _write(mu_s, _store(mu, p, rank, cfg.state_dtype))
    _write(nu_s, _store(nu, p, rank, cfg.state_dtype))


def _moment_pieces(m) -> list:
    """A split moment's stored parts, each a tensor or a ``QTensor`` of
    its legs' parts."""
    if isinstance(m, QTensor):
        return [QTensor(qs, sc) for qs, sc in zip(m.qs, m.scales)]
    return list(m)


def _moment_spec(spec):
    """A moment's spec in the parameter's terms: a Q8_0 moment's legs are
    split as ``qs``'s leading dims (its K / 32 blocks for the
    parameter's K)."""
    return spec.qs if isinstance(spec, QTensor) else spec


def _gather_moment(m, spec, mesh, device):
    if isinstance(m, QTensor):
        return QTensor(rules.gather_leaf(m.qs, spec.qs, mesh, device),
                       rules.gather_leaf(m.scales, spec.scales, mesh, device))
    return rules.gather_leaf(m, spec, mesh, device)


def _scatter_moment(whole, m, spec, mesh) -> None:
    if isinstance(m, QTensor):
        rules.scatter_leaf(whole.qs, m.qs, spec.qs, mesh)
        rules.scatter_leaf(whole.scales, m.scales, spec.scales, mesh)
    else:
        rules.scatter_leaf(whole, m, spec, mesh)


def global_norm_split(grads, specs, mesh) -> torch.Tensor:
    """``global_norm`` of a split gradient tree: each leaf's distinct
    parts' f32 sums of squares, in order, added on the first piece's
    device."""
    total = 0
    dev0 = None
    for g, sp in zip(tree.leaves(grads, is_leaf=rules.is_pieces),
                     tree.leaves(specs, is_leaf=rules.is_spec)):
        shape = rules.whole_shape(g, sp, mesh)
        lay = rules.leaf_layout(shape, sp, mesh)
        holders = rules.part_entries(shape, sp, mesh)
        if dev0 is None:
            dev0 = lay.devices[0]
        for k in lay.firsts():
            with op_cost.at(entries=holders[lay.part[k]]):
                total = total + torch.sum(torch.square(
                    g[k].to(torch.float32))).to(dev0)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update_split(grads, state: AdamWState, params,
                       cfg: OptimizerConfig, *, specs, mesh
                       ) -> Tuple[dict, AdamWState, dict]:
    """``adamw_update`` over a state split over ``mesh``: ``grads`` (f32
    ``Pieces`` laid out as the parameters), ``state`` and ``params`` split
    by ``specs`` (a ``TrainState`` of specs); everything updated in
    place."""
    gn = global_norm_split(grads, specs.params, mesh)
    scale = _clip_scale(gn, cfg.grad_clip)
    count = state.count[0] + 1
    t = count.to(torch.float32)
    lr = lr_schedule(cfg, count)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    on = {}

    def at(dev):
        if dev not in on:
            on[dev] = [x.to(dev) for x in (scale, lr, bc1, bc2)]
        return on[dev]

    flat_p = tree.leaves_with_path(params, is_leaf=rules.is_pieces)
    flat_g = tree.leaves(grads, is_leaf=rules.is_pieces)
    flat_mu = tree.leaves(state.mu, is_leaf=_is_q_or_pieces)
    flat_nu = tree.leaves(state.nu, is_leaf=_is_q_or_pieces)
    sp_p = tree.leaves(specs.params, is_leaf=rules.is_spec)
    sp_mu = tree.leaves(specs.opt.mu, is_leaf=_is_q_or_spec)
    sp_nu = tree.leaves(specs.opt.nu, is_leaf=_is_q_or_spec)
    if not (len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu)
            == len(sp_p) == len(sp_mu) == len(sp_nu)):
        raise ValueError("grads, moments, params and specs disagree")
    for (path, p), g, mu, nu, sp, smu, snu in zip(
            flat_p, flat_g, flat_mu, flat_nu, sp_p, sp_mu, sp_nu):
        shape = rules.whole_shape(p, sp, mesh)
        rank = len(shape) + int(tree.in_layer_list(path))
        lay = rules.leaf_layout(shape, sp, mesh)
        holders = rules.piece_entries(shape, sp, mesh)
        if _moment_spec(smu) == sp and _moment_spec(snu) == sp:
            for pk, gk, muk, nuk, dev, who in zip(
                    p, g, _moment_pieces(mu), _moment_pieces(nu),
                    lay.devices, holders):
                with op_cost.at(entries=who):
                    _update_leaf(pk, gk, muk, nuk, rank, *at(dev), cfg)
            continue
        dev = lay.devices[0]
        pw = rules.gather_leaf(p, sp, mesh, dev).clone()
        muw, nuw = (_gather_moment(m, s, mesh, dev)
                    for m, s in ((mu, smu), (nu, snu)))
        _update_leaf(pw, rules.gather_leaf(g, sp, mesh, dev), muw, nuw,
                     rank, *at(dev), cfg)
        rules.scatter_leaf(pw, p, sp, mesh)
        _scatter_moment(muw, mu, smu, mesh)
        _scatter_moment(nuw, nu, snu, mesh)
    for c in state.count:
        c.add_(1)
    return params, state, {"grad_norm": gn, "lr": lr}


def _is_q_or_pieces(x) -> bool:
    return _is_q(x) or rules.is_pieces(x)


def _is_q_or_spec(x) -> bool:
    return _is_q(x) or rules.is_spec(x)
