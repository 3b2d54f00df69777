"""Carry a reference parameter tree over to the port's layout.

``from_jax_params`` takes the reference's Whisper or LM parameter tree
with every leaf already converted to numpy (``np.asarray``) — this module
imports no JAX — and returns the port's tree: the same dict keys, with
the reference's layer-stacked blocks (a leading layer axis on every leaf)
split into a list of per-layer dicts. Whisper's ``enc_blocks`` and
``dec_blocks`` each stack all layers; an LM's ``stack/blocks`` is a list
of P pattern positions, each stacked over R repeats (a smoke config,
``scan_layers=False``, still stacks: R = num_layers), and layer i of the
port is repeat ``i // P`` of position ``i % P``. A MoE layer's leaves
(``moe/router/w``, the (E, in, out) expert stacks ``moe/w_up``,
``w_gate`` and ``w_down``, ``moe/dense/*``) and an SSM layer's leaves
(``ssm/in_proj/w``, ``ssm/out_proj/w``, ``ssm/conv_w``, ``ssm/conv_b``,
``ssm/A_log``, ``ssm/D``, ``ssm/dt_bias``, ``ssm/norm/scale``) unstack like
any other: a hybrid's pattern mixes both kinds of position. A VLM's
``projector`` (``w`` (d_model, E_vis) and its bias ``b``) is unstacked and
crosses as it is. Tests use it to run both packages on identical weights.

``from_jax_train_state`` carries a reference ``TrainState`` (numpy leaves)
across: its params, the AdamW moments ``mu`` and ``nu`` (trees shaped like
the params, Q8_0 moment leaves included: the reference's ``QTensor``, any
NamedTuple of ``qs`` and ``scales``, becomes the port's), the step
``count``, the error-feedback tree (a scalar accumulator, never stacked,
is every layer's), and a seed in place of the reference's key.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.qformats import QTensor

STACKED = ("enc_blocks", "dec_blocks")


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: reinterpret
        return torch.from_numpy(
            np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _is_q(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == (
        "qs", "scales")


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if _is_q(tree):
        return QTensor(_tensor(tree.qs).to(device),
                       _tensor(tree.scales).to(device))
    return _tensor(tree).to(device)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if _is_q(tree):
        return type(tree)(tree.qs[i], tree.scales[i])
    if np.ndim(tree) == 0:          # an unstacked scalar: every layer's
        return tree
    return tree[i]


def _layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    if _is_q(tree):
        tree = tree.qs
    return np.asarray(tree).shape[0]


def from_jax_params(tree: dict, *, device="cuda") -> dict:
    """Reference Whisper or LM params (numpy leaves) -> the port's
    params."""
    dev = resolve_device(device)
    out = {}
    for key, sub in tree.items():
        if key in STACKED:
            out[key] = [_convert(_unstack(sub, i), dev)
                        for i in range(_layers(sub))]
        elif key == "stack":
            pattern = sub["blocks"]
            n = len(pattern) * _layers(pattern[0])
            out[key] = {"blocks": [
                _convert(_unstack(pattern[i % len(pattern)],
                                  i // len(pattern)), dev)
                for i in range(n)]}
        else:
            out[key] = _convert(sub, dev)
    return out


def from_jax_train_state(state, *, seed: int = 0, device="cuda"):
    """A reference ``TrainState`` (numpy leaves; its ``opt`` an
    ``AdamWState`` of mu, nu and count) -> the port's ``TrainState``, the
    seed ``seed`` in place of the reference's key."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState
    dev = resolve_device(device)
    opt = state.opt
    return TrainState(
        params=from_jax_params(state.params, device=dev),
        opt=AdamWState(from_jax_params(opt.mu, device=dev),
                       from_jax_params(opt.nu, device=dev),
                       _tensor(opt.count).to(dev)),
        ef=from_jax_params(state.ef, device=dev) if state.ef else {},
        seed=torch.tensor(seed, dtype=torch.int64, device=dev))
