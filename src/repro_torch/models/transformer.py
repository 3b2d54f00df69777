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

As a data shard of a mesh training step (``sharding.ctx.train_shard``),
the blocks hold the stored pieces of their leaves: each block gathers them
inside its ``remat`` unit (``sharding.rules.gather_block``), and runs an
attention or dense FFN that ``sharding.rules.tp_layout`` splits as M model
shards (``tensor_parallel``): shard m computes its Hq / M query and Hkv /
M KV heads, or its d_ff / M FFN columns, on its own mesh entry's device
from the normed input copied there, and the row-parallel products'
partial outputs, each in f32 (``layers.linear(..., f32_out=True)``), are
summed in f32 in model-shard order on the data shard's first device
(``sum_partials``) and rounded once to the residual stream's type there,
where the norms, the MoE routing and the SSD layers stay. A MoE layer
whose experts ``tp_layout`` splits runs shard m's E / M experts on its
device (``models.moe.expert_parallel``), and arctic's dense branch beside
them as a split dense FFN (``moe_ffn``). In 16-bit, the shards' copies
of the normed input are its f32 upcast (``shard_inputs``), so that the
column-parallel products' input gradients, f32 products
(``layers.linear(..., f32_grad=True)``), sum in f32 and round once.

A serving engine over "model" hands the same functions its data shard's
serving tree (``sharding.rules.serve_tree``): each block holds its split
sub-blocks' slices under ``rules.TP_KEY`` (``gather_for_shard`` reads
them), and the decode step (``decode_step_stack``) runs them as
``tensor_parallel``, each model shard's attention over its own KV cache
(``kv_zeros``: ``ModelShards`` of Hkv / M heads). Without a gradient
the shards' inputs keep their type.
"""
from __future__ import annotations

import dataclasses
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
    KVCache, ModelShards, QKVCache, attention, decode_attention,
    init_attention, shard_list)
from repro_torch.roofline import op_cost
from repro_torch.sharding import ctx, rules


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
@functools.lru_cache(maxsize=64)
def _shard_cfg(cfg: ModelConfig, m: int) -> ModelConfig:
    """The head-count view of ``cfg`` that one of ``m`` model shards
    computes: Hq / m query and Hkv / m KV heads of the same width."""
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                               num_kv_heads=cfg.num_kv_heads // m)


def sum_partials(partials: List[torch.Tensor], device) -> torch.Tensor:
    """The model shards' partial outputs of a row-parallel product summed
    in f32, in model-shard order, on ``device``."""
    acc = partials[0].to(device, torch.float32)
    for y in partials[1:]:
        acc = acc + y.to(device, torch.float32)
    op_cost.collective("all-reduce", acc.numel() * 4, len(partials),
                       "sum_partials")
    return acc


def shard_inputs(part: dict, inputs: tuple) -> Tuple[tuple, bool]:
    """(the inputs that the model shards copy, whether they are f32
    upcasts). Where the float inputs and the slices' weights have one
    16-bit type, each float input is upcast once (exactly), so that the
    column-parallel products' input gradients, each an f32 product
    (``layers.linear(..., f32_grad=True)``), sum over the shards in f32
    and round once to that type in the upcast's backward. Without grad
    mode (serving) the inputs go as they are: the shards' launches take
    the type the unsplit linear takes."""
    if not torch.is_grad_enabled():
        return inputs, False
    wt = next(iter(part.values()))["w"].dtype
    floats = [t for t in inputs if t is not None and t.is_floating_point()]
    if wt.itemsize != 2 or any(t.dtype != wt for t in floats):
        return inputs, False
    return tuple(t.to(torch.float32) if t is not None
                 and t.is_floating_point() else t for t in inputs), True


def tensor_parallel(fn: Callable[..., torch.Tensor], p: dict,
                    parts: Optional[list], cfg: ModelConfig, devices,
                    *inputs, shard_args: Optional[list] = None
                    ) -> torch.Tensor:
    """``fn(p, cfg, *inputs)`` where ``parts`` is None. Else ``fn(...,
    partial=True)`` over the model shards: shard m on ``devices[m]`` over
    its slices ``parts[m]``, the head-count view of ``cfg`` and its
    copies of the tensor ``inputs`` (``shard_inputs``: 16-bit inputs in
    f32, with ``f32_grad=True``); its output the f32 partial of a
    row-parallel product, without a bias (a shard's slices hold none).
    The partials are summed (``sum_partials``) on the first input's
    device, and the bias in ``p`` (the row-parallel linear's, if any)
    added in f32 after; the caller casts the sum once to the residual
    stream's type. ``shard_args``: one tuple a model shard (the whole
    sub-block's single one where ``parts`` is None) passed after the
    inputs as they are, never moved: a serving step's cache slices. Each
    shard runs as ``ctx.model_shard`` m of M, which the offload engine
    reads."""
    if parts is None:
        return fn(p, cfg, *inputs, *(shard_args[0] if shard_args else ()))
    m_cfg = _shard_cfg(cfg, len(parts))
    device = inputs[0].device
    inputs, f32_grad = shard_inputs(parts[0], inputs)
    partials = []
    for m, (part, dev) in enumerate(zip(parts, devices, strict=True)):
        extra = shard_args[m] if shard_args else ()
        with op_cost.at(model=m), ctx.model_shard_scope(m, len(parts)):
            partials.append(fn(part, m_cfg, *(t if t is None else t.to(dev)
                                              for t in inputs), *extra,
                               partial=True, f32_grad=f32_grad))
    y = sum_partials(partials, device)
    for lin in p.values():
        y = y + lin["b"].to(y.dtype)
    return y


def _apply_block(p: dict, cfg: ModelConfig, spec: LayerSpec,
                 x: torch.Tensor, *, positions, engine, attn_chunk: int,
                 shard=None, specs=None, layout=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over a full sequence: the pre-norm mixer (causal
    attention or the chunked SSD scan), then the pre-norm FFN, each added
    to the residual stream in x's type. Returns (x, the layer's MoE
    load-balance loss, 0 for another FFN). With ``shard`` (a
    ``ctx.TrainShard``), ``p`` holds the stored pieces laid out by
    ``specs``: they are gathered here, and the sub-blocks ``layout``
    splits run as ``tensor_parallel``."""
    p, parts, devices = gather_for_shard(p, shard, specs, layout)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.norm_apply(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        def attn(q, c, hh, pos, **kw):
            return attention(q, c, hh, positions=pos, causal=True,
                             chunk=attn_chunk, engine=engine, **kw)
        mixed = tensor_parallel(attn, p["attn"], parts.get("attn"), cfg,
                                devices, h, positions)
    else:
        mixed = ssm_lib.ssm_mixer(p["ssm"], cfg, h, engine=engine)
    x = x + mixed.to(x.dtype)
    if spec.ffn != "none":
        h = layers.norm_apply(p["norm2"], x, cfg.norm)
        mlp = mlp_fn(engine)
        if spec.ffn == "moe":
            y, aux = moe_ffn(p["moe"], cfg, h, parts.get("moe"), devices,
                             mlp, engine)
        else:
            y = tensor_parallel(mlp, p["ffn"], parts.get("ffn"), cfg,
                                devices, h)
        x = x + y.to(x.dtype)
    return x, aux


def moe_ffn(p: dict, cfg: ModelConfig, h: torch.Tensor,
            parts: Optional[list], devices, mlp: Callable[..., torch.Tensor],
            engine) -> Tuple[torch.Tensor, torch.Tensor]:
    """A MoE layer: ``moe_lib.moe_ffn`` whole where ``parts`` is None;
    else its experts split over the model shards where ``parts`` hold
    their slices (expert parallelism), and arctic's dense branch, where
    they hold its slices, as a split dense FFN (``tensor_parallel`` of
    ``mlp``)."""
    experts = dense = None
    if parts is not None and "w_up" in parts[0]:
        experts = parts
    if parts is not None and "dense" in parts[0]:
        def dense(x):
            return tensor_parallel(mlp, p["dense"],
                                   [q["dense"] for q in parts], cfg,
                                   devices, x)
    return moe_lib.moe_ffn(p, cfg, h, engine=engine, experts=experts,
                           devices=devices, dense=dense)


def gather_for_shard(p: dict, shard, specs, layout):
    """(a block's leaves, its split sub-blocks' slices, the model shards'
    devices): under a mesh step's ``shard``, gathered from the pieces in
    ``p`` (``rules.gather_block``); a serving block over "model"
    (``rules.serve_tree``) with the slices it holds under
    ``rules.TP_KEY``; else ``p`` as it is."""
    if shard is None:
        tp = p.get(rules.TP_KEY)
        return (p, {}, None) if tp is None else (p, tp.parts, tp.devices)
    p, parts = rules.gather_block(p, specs, shard.mesh, shard.devices,
                                  layout)
    return p, parts, shard.devices


def shard_layouts(cfg: ModelConfig, shard, path, n: int
                  ) -> Tuple[list, list]:
    """(the specs of the ``n`` blocks at ``path`` of the parameter tree,
    each block's ``rules.tp_layout``, counted in ``rules.TP_BLOCKS``) for
    a data shard of a mesh step; n Nones each outside one."""
    if shard is None:
        return [None] * n, [None] * n
    specs = shard.specs
    for k in path:
        specs = specs[k]
    layouts = [rules.tp_layout(cfg, sp, shard.mesh) for sp in specs]
    for lay in layouts:
        rules.TP_BLOCKS.update(lay.items())
    return specs, layouts


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
    plainly. The recompute runs under the data-shard count of the forward
    (``ctx.shard_program``: a MoE layer's capacity), which the backward
    does not see otherwise: on the card the autograd engine recomputes on
    its device thread. It replays the forward's MoE capacity claims
    (``moe.claims``): a claim the data shards made together in lockstep
    cannot be made again by one shard alone."""
    if cfg.remat == "none":
        return fn

    def run(*args):
        if not grad_wanted(args):
            return fn(*args)
        shards = ctx.batch_shards()
        log = moe_lib.ClaimLog()

        def unit(*a):
            with ctx.shard_program(shards), moe_lib.claims(log):
                return fn(*a)
        if cfg.remat == "dots":
            return checkpoint(unit, *args, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts,
                                  _dots_policy))
        return checkpoint(unit, *args, use_reentrant=False)
    return run


def apply_decoder_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                        positions: Optional[torch.Tensor] = None,
                        engine=None, attn_chunk: int = 2048
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) through every layer in order -> (y, the MoE
    load-balance losses summed over the layers, f32). The reference's
    ``apply_decoder_stack`` with ``scan_layers=False``: each repeat of the
    layer pattern (P layers) is one ``remat`` unit, and the losses are
    summed a repeat at a time, as the reference's scan sums them. As a
    data shard of a mesh step, a unit gathers its blocks' leaves inside
    it (``_apply_block``)."""
    pattern = layer_pattern(cfg)
    blocks, n = params["blocks"], len(pattern)
    if len(blocks) != cfg.num_layers:
        raise ValueError(f"{len(blocks)} layers for {cfg.num_layers}")
    shard = ctx.current_train_shard()
    specs, layouts = shard_layouts(cfg, shard, ("stack", "blocks"),
                                   len(blocks))

    def repeat_fn(x, blocks, r):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (p, spec) in enumerate(zip(blocks, pattern, strict=True)):
            x, a = _apply_block(p, cfg, spec, x, positions=positions,
                                engine=engine, attn_chunk=attn_chunk,
                                shard=shard, specs=specs[r * n + i],
                                layout=layouts[r * n + i])
            aux = aux + a
        return x, aux

    repeat_fn = remat(repeat_fn, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(n_repeats(cfg)):
        x, a = repeat_fn(x, blocks[r * n:(r + 1) * n], r)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Decode (one token, carried state)
# ---------------------------------------------------------------------------
LayerState = Union[KVCache, QKVCache, ssm_lib.SSMState]


def kv_zeros(cfg: ModelConfig, cache_cls, batch: int, max_len: int,
             dtype, *, device, kv_devices=None):
    """An empty attention cache of ``cfg``'s KV heads on ``device``, or,
    with ``kv_devices`` (a serving data shard's model devices, where its
    attention is split over them), one cache a model shard of Hkv / M
    heads on its device (``ModelShards``)."""
    if kv_devices is None:
        return cache_cls.zeros(batch, max_len, cfg.num_kv_heads,
                               cfg.head_dim, dtype, device=device)
    hkv = cfg.num_kv_heads // len(kv_devices)
    return ModelShards(cache_cls.zeros(batch, max_len, hkv, cfg.head_dim,
                                       dtype, device=d) for d in kv_devices)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, *, device,
                      kv_devices=None) -> List[LayerState]:
    """One empty state a layer on ``device`` (no default), with a scalar
    length: an attention layer's cache (``QKVCache`` when ``cfg.kv_quant
    == "q8"``, else ``KVCache``; split over ``kv_devices`` where given,
    ``kv_zeros``), an SSM layer's ``SSMState`` (f32, as the reference's,
    which passes no type)."""
    cache_cls = QKVCache if cfg.kv_quant == "q8" else KVCache
    return [kv_zeros(cfg, cache_cls, batch, max_len, dtype, device=device,
                     kv_devices=kv_devices)
            if spec.mixer == "attn" else
            ssm_lib.SSMState.zeros(batch, cfg.ssm, cfg.d_model, device=device)
            for spec in layer_specs(cfg)]


def decode_attn_fn(engine):
    """``decode_attention``'s output as ``tensor_parallel`` calls it: (a
    sub-block's leaves, its cfg, x, the cache[, the cross K/V])."""
    def attn(p, c, h, cache, memory_kv=None, **kw):
        return decode_attention(p, c, h, cache, memory_kv=memory_kv,
                                engine=engine, **kw)[0]
    return attn


def mlp_fn(engine):
    """``layers.mlp_apply`` as ``tensor_parallel`` calls it."""
    def mlp(p, c, h, **kw):
        return layers.mlp_apply(p, h, c.act, engine=engine, **kw)
    return mlp


def decode_step_stack(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      states: List[LayerState], *, engine=None
                      ) -> Tuple[torch.Tensor, List[LayerState]]:
    """x: (B, 1, d) through every layer: the pre-norm mixer, attention
    over the layer's cache or the SSD recurrence over its state (either
    advanced in place), then the pre-norm FFN (dense, or
    MoE with its load-balance loss dropped, as the reference's decode
    drops it), each added to the residual stream in x's type. Returns (y,
    states), ``states`` the same caches. A serving block over "model"
    (``rules.serve_tree``) runs its split attention, dense FFN and
    experts as ``tensor_parallel`` and ``moe_ffn`` run a training
    block's, each model shard's attention over its own cache."""
    attn, mlp = decode_attn_fn(engine), mlp_fn(engine)
    for p, spec, st in zip(params["blocks"], layer_specs(cfg), states,
                           strict=True):
        p, parts, devices = gather_for_shard(p, None, None, None)
        h = layers.norm_apply(p["norm1"], x, cfg.norm)
        if spec.mixer == "attn":
            mixed = tensor_parallel(attn, p["attn"], parts.get("attn"), cfg,
                                    devices, h, shard_args=[
                                        (c,) for c in shard_list(st)])
        else:
            mixed, _ = ssm_lib.ssm_decode_step(p["ssm"], cfg, h, st,
                                               engine=engine)
        x = x + mixed.to(x.dtype)
        if spec.ffn != "none":
            h = layers.norm_apply(p["norm2"], x, cfg.norm)
            if spec.ffn == "moe":
                y, _ = moe_ffn(p["moe"], cfg, h, parts.get("moe"), devices,
                               mlp, engine)
            else:
                y = tensor_parallel(mlp, p["ffn"], parts.get("ffn"), cfg,
                                    devices, h)
            x = x + y.to(x.dtype)
    return x, states
