"""Decoder-only stack of the dense, MoE, SSM and hybrid LM families.

The reference groups its layers into a repeating pattern of length P
(``layer_pattern``: the attention and MoE periods of heterogeneous
stacks), stacks each pattern position's parameters over R = num_layers /
P repeats and scans over R. The port keeps the pattern and its names, but
its layers are a Python list of per-layer dicts (``params["blocks"][i]``,
layer i of pattern position ``i % P``) and its decode state a list of one
cache a layer: no stacking and no scan. On the card a step is captured
whole into a CUDA graph, which removes the Python loop's cost that the
scan saves the reference's trace.

A layer's mixer is attention or the SSD recurrence (``models/ssm.py``),
and its FFN dense, MoE (``models/moe.py``) or none: jamba's pattern of 8
puts attention at position 4 and MoE at the odd positions, mamba2's is
one SSM layer with no FFN. The decode state holds one entry a layer, a
KV cache for an attention layer and an ``SSMState`` for an SSM layer.
``apply_decoder_stack`` runs the same layers over a whole sequence (the
model API's ``forward``), the SSM layers by the chunked SSD scan.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.models import layers, moe as moe_lib, ssm as ssm_lib
from repro_torch.models.attention import (
    KVCache, QKVCache, attention, decode_attention, init_attention)


class LayerSpec(NamedTuple):
    mixer: str   # "attn" | "ssm"
    ffn: str     # "dense" | "moe" | "none"


def layer_pattern(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """The reference's repeating layer pattern (its ``layer_pattern``)."""
    p = 1
    if cfg.family == "hybrid":
        p = math.lcm(cfg.attn_every, cfg.moe_every if cfg.moe else 1)
    elif cfg.moe is not None and cfg.moe_every > 1:
        p = cfg.moe_every
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} "
                         f"not divisible by pattern {p}")
    specs = []
    for i in range(p):
        if cfg.family == "ssm":
            mixer = "ssm"
        elif cfg.family == "hybrid":
            mixer = "attn" if i % cfg.attn_every == cfg.attn_offset else "ssm"
        else:
            mixer = "attn"
        if cfg.moe is not None and i % cfg.moe_every == cfg.moe_offset:
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "dense"
        else:
            ffn = "none"
        specs.append(LayerSpec(mixer, ffn))
    return tuple(specs)


def n_repeats(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(layer_pattern(cfg))


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """Each layer's spec, in order: layer i is position ``i % P`` of the
    pattern."""
    return list(layer_pattern(cfg)) * n_repeats(cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                dtype) -> dict:
    dev = gen.device
    p = {"norm1": layers.init_norm(cfg.d_model, dtype, kind=cfg.norm,
                                   device=dev)}
    if spec.mixer == "attn":
        p["attn"] = init_attention(gen, cfg, dtype)
    else:
        p["ssm"] = ssm_lib.init_ssm(gen, cfg, dtype)
    if spec.ffn != "none":
        p["norm2"] = layers.init_norm(cfg.d_model, dtype, kind=cfg.norm,
                                      device=dev)
        if spec.ffn == "moe":
            p["moe"] = moe_lib.init_moe(gen, cfg, dtype)
        else:
            p["ffn"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                       act=cfg.act)
    return p


def init_decoder_stack(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """{"blocks": [one parameter dict a layer]}, drawn from ``gen`` on its
    device, layer by layer."""
    dtype = layers.DTYPES[cfg.param_dtype]
    return {"blocks": [_init_block(gen, cfg, spec, dtype)
                       for spec in layer_specs(cfg)]}


# ---------------------------------------------------------------------------
# Full-sequence apply (forward and loss)
# ---------------------------------------------------------------------------
def _apply_block(p: dict, cfg: ModelConfig, spec: LayerSpec,
                 x: torch.Tensor, *, positions, engine, attn_chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over a full sequence: the pre-norm mixer (causal
    attention or the chunked SSD scan), then the pre-norm FFN, each added
    to the residual stream in x's type. Returns (x, the layer's MoE
    load-balance loss, 0 for another FFN)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.norm_apply(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        mixed = attention(p["attn"], cfg, h, positions=positions,
                          causal=True, chunk=attn_chunk, engine=engine)
    else:
        mixed = ssm_lib.ssm_mixer(p["ssm"], cfg, h, engine=engine)
    x = x + mixed.to(x.dtype)
    if spec.ffn != "none":
        h = layers.norm_apply(p["norm2"], x, cfg.norm)
        if spec.ffn == "moe":
            y, aux = moe_lib.moe_ffn(p["moe"], cfg, h, engine=engine)
        else:
            y = layers.mlp_apply(p["ffn"], h, cfg.act, engine=engine)
        x = x + y.to(x.dtype)
    return x, aux


def grad_wanted(*trees) -> bool:
    """Whether autograd records a graph through these inputs: grad mode is
    on and one of their tensors requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree.leaves(trees))


# the matrix products without batch dims, whose outputs ``remat="dots"``
# keeps: the reference's ``dots_with_no_batch_dims_saveable`` (the
# attention's batched einsums are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable[..., Any], cfg: ModelConfig) -> Callable[..., Any]:
    """The reference's ``_remat``: ``fn`` under activation checkpointing
    by ``cfg.remat`` — "full" keeps only its inputs and recomputes the rest
    in the backward, "dots" also keeps the outputs of its matrix products,
    "none" runs it as it is. Only where a gradient is recorded
    (``grad_wanted``): without one, a served or inference call runs ``fn``
    plainly."""
    if cfg.remat == "none":
        return fn

    def run(*args):
        if not grad_wanted(args):
            return fn(*args)
        if cfg.remat == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts,
                                  _dots_policy))
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def apply_decoder_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                        positions: Optional[torch.Tensor] = None,
                        engine=None, attn_chunk: int = 2048
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) through every layer in order -> (y, the MoE
    load-balance losses summed over the layers, f32). The reference's
    ``apply_decoder_stack`` with ``scan_layers=False``: each repeat of the
    layer pattern (P layers) is one ``remat`` unit, and the losses are
    summed a repeat at a time, as the reference's scan sums them."""
    pattern = layer_pattern(cfg)

    def repeat_fn(x, blocks):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, spec in zip(blocks, pattern, strict=True):
            x, a = _apply_block(p, cfg, spec, x, positions=positions,
                                engine=engine, attn_chunk=attn_chunk)
            aux = aux + a
        return x, aux

    repeat_fn = remat(repeat_fn, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks, n = params["blocks"], len(pattern)
    if len(blocks) != cfg.num_layers:
        raise ValueError(f"{len(blocks)} layers for {cfg.num_layers}")
    for r in range(n_repeats(cfg)):
        x, a = repeat_fn(x, blocks[r * n:(r + 1) * n])
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Decode (one token, carried state)
# ---------------------------------------------------------------------------
LayerState = Union[KVCache, QKVCache, ssm_lib.SSMState]


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, *, device) -> List[LayerState]:
    """One empty state a layer on ``device`` (no default), with a scalar
    length: an attention layer's cache (``QKVCache`` when ``cfg.kv_quant
    == "q8"``, else ``KVCache``), an SSM layer's ``SSMState`` (f32, as
    the reference's, which passes no type)."""
    cache_cls = QKVCache if cfg.kv_quant == "q8" else KVCache
    return [cache_cls.zeros(batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                            dtype, device=device)
            if spec.mixer == "attn" else
            ssm_lib.SSMState.zeros(batch, cfg.ssm, cfg.d_model, device=device)
            for spec in layer_specs(cfg)]


def decode_step_stack(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      states: List[LayerState], *, engine=None
                      ) -> Tuple[torch.Tensor, List[LayerState]]:
    """x: (B, 1, d) through every layer: the pre-norm mixer, attention
    over the layer's cache or the SSD recurrence over its state (either
    advanced in place), then the pre-norm FFN (dense, or
    MoE with its load-balance loss dropped, as the reference's decode
    drops it), each added to the residual stream in x's type. Returns (y,
    states), ``states`` the same caches."""
    for p, spec, st in zip(params["blocks"], layer_specs(cfg), states,
                           strict=True):
        h = layers.norm_apply(p["norm1"], x, cfg.norm)
        if spec.mixer == "attn":
            mixed, _ = decode_attention(p["attn"], cfg, h, st, engine=engine)
        else:
            mixed, _ = ssm_lib.ssm_decode_step(p["ssm"], cfg, h, st,
                                               engine=engine)
        x = x + mixed.to(x.dtype)
        if spec.ffn != "none":
            h = layers.norm_apply(p["norm2"], x, cfg.norm)
            if spec.ffn == "moe":
                y, _ = moe_lib.moe_ffn(p["moe"], cfg, h, engine=engine)
            else:
                y = layers.mlp_apply(p["ffn"], h, cfg.act, engine=engine)
            x = x + y.to(x.dtype)
    return x, states
