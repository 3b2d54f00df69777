"""Whisper encoder-decoder backbone (the paper's workload).

The conv frontend is a stub: precomputed mel frames go through one linear
projection in place of the two stride-2 convolutions. Everything
downstream — encoder self-attention stack, decoder self- and
cross-attention, tied vocabulary readout — routes every linear through the
offload engine when one is passed.

``decode_train`` runs the decoder teacher-forced over a whole token
sequence (the model API's ``forward`` and ``loss_fn``). Decode follows
whisper.cpp's split: the encoder runs once per utterance,
each decoder layer's cross K/V is projected once from the encoder memory
(``dec.cross.k``/``dec.cross.v``), then tokens decode autoregressively
against the cached self-attention KV. Layers are a Python loop over a list
of per-layer parameter dicts. A paged decode state
(``WhisperPagedDecodeState``) keeps both KV kinds in page arenas stacked
over the layers, as the reference does; over "model" one a model shard
(``ModelShards``), its arenas of its heads.

A serving engine over "model" (``sharding.rules.serve_tree``) gives each
block its split attentions' and FFN's slices: the encoder, the cross
K/V projection and the decoder step run them over the model shards
(``transformer.tensor_parallel``), each model shard's self-attention
over its own cache and its cross-attention over its own cross K/V
(``ModelShards``), and the readout over the split vocabulary
(``layers.vocab_logits``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.attention import (
    KVCache, ModelShards, PagedKVCache, attention, first_shard,
    init_attention, map_shards, paged_window_gather, shard_list)
from repro_torch.models.transformer import decode_attn_fn, \
    gather_for_shard, kv_zeros, mlp_fn, remat, shard_layouts, \
    tensor_parallel
from repro_torch.roofline import op_cost
from repro_torch.sharding import ctx


class WhisperDecodeState(NamedTuple):
    self_kv: List[KVCache]                               # one per decoder layer
    cross_kv: List[Tuple[torch.Tensor, torch.Tensor]]    # (B, F, Hkv, hd) x2


class WhisperPagedDecodeState(NamedTuple):
    """Paged slot-pool decode state: the self-attention KV and each
    utterance's cross K/V live in page arenas, stacked over the R layers
    as in the reference (a page holds ``page`` positions of all layers, so
    a splice is one copy a page), reached through one block table a slot
    shared by every layer. Physical page 0 of each arena is the trash page
    free slots write and read through. ``length`` holds each layer's
    per-slot position; layer i reads and advances the view ``length[i]``
    in place."""
    self_k: torch.Tensor        # (R, P, page, Hkv, hd) self-KV page arena
    self_v: torch.Tensor        # (R, P, page, Hkv, hd)
    cross_k: torch.Tensor       # (R, Pc, cpage, Hkv, hd) cross-KV page arena
    cross_v: torch.Tensor       # (R, Pc, cpage, Hkv, hd)
    block_table: torch.Tensor   # (B, max_pages) int32: self logical -> physical
    cross_table: torch.Tensor   # (B, n_cross_pages) int32: frames -> physical
    length: torch.Tensor        # (R, B) int32: tokens valid per layer and slot


def _init_enc_block(gen, cfg: ModelConfig, dtype) -> dict:
    return {
        "norm1": layers.init_norm(cfg.d_model, dtype),
        "attn": init_attention(gen, cfg, dtype),
        "norm2": layers.init_norm(cfg.d_model, dtype),
        "ffn": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def _init_dec_block(gen, cfg: ModelConfig, dtype) -> dict:
    return {
        "norm1": layers.init_norm(cfg.d_model, dtype),
        "self_attn": init_attention(gen, cfg, dtype),
        "norm_x": layers.init_norm(cfg.d_model, dtype),
        "cross_attn": init_attention(gen, cfg, dtype),
        "norm2": layers.init_norm(cfg.d_model, dtype),
        "ffn": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def init_whisper(gen: torch.Generator, cfg: ModelConfig,
                 max_positions: int = 0) -> dict:
    """Random weights drawn from ``gen`` on the generator's device, with
    the reference's shapes, scales and layout (not its random numbers)."""
    dtype = layers.DTYPES[cfg.param_dtype]
    d = cfg.d_model
    maxp = max(max_positions, cfg.encoder_ctx, 448)
    return {
        "frontend": layers.init_linear(gen, cfg.n_mels, d, bias=True,
                                       dtype=dtype),
        "enc_pos": {"table": layers.sinusoidal_positions(maxp, d).to(dtype)},
        "enc_blocks": [_init_enc_block(gen, cfg, dtype)
                       for _ in range(cfg.num_encoder_layers)],
        "enc_norm": layers.init_norm(d, dtype),
        "embed": layers.init_embedding(gen, cfg.padded_vocab, d, dtype),
        "dec_pos": {"table": (torch.randn((maxp, d), generator=gen,
                                          device=gen.device) * 0.01
                              ).to(dtype)},
        "dec_blocks": [_init_dec_block(gen, cfg, dtype)
                       for _ in range(cfg.num_layers)],
        "dec_norm": layers.init_norm(d, dtype),
    }


def encode(params: dict, cfg: ModelConfig, mel: torch.Tensor, *,
           engine=None, attn_chunk: int = 2048) -> torch.Tensor:
    """mel: (B, F, n_mels) precomputed frames -> (B, F, d) memory."""
    x = layers.linear(params["frontend"], mel.to(torch.float32), engine,
                      "enc.frontend")
    x = layers.gelu(x)
    f = x.shape[1]
    dtype = layers.DTYPES[cfg.dtype]
    x = (x + params["enc_pos"]["table"][:f].to(torch.float32)).to(dtype)

    shard = ctx.current_train_shard()
    specs, layouts = shard_layouts(cfg, shard, ("enc_blocks",),
                                   len(params["enc_blocks"]))

    def attn(p, c, h, **kw):
        return attention(p, c, h, causal=False, chunk=attn_chunk,
                         engine=engine, **kw)

    def block(x, p, i):
        p, parts, devs = gather_for_shard(p, shard, specs[i],
                                           layouts[i])
        h = layers.norm_apply(p["norm1"], x, cfg.norm)
        x = x + tensor_parallel(attn, p["attn"], parts.get("attn"), cfg,
                                devs, h).to(x.dtype)
        h = layers.norm_apply(p["norm2"], x, cfg.norm)
        return x + tensor_parallel(mlp_fn(engine), p["ffn"],
                                   parts.get("ffn"), cfg, devs, h
                                   ).to(x.dtype)

    block = remat(block, cfg)
    for i, p in enumerate(params["enc_blocks"]):
        x = block(x, p, i)
    return layers.norm_apply(params["enc_norm"], x, cfg.norm)


def decode_train(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 memory: torch.Tensor, *, engine=None,
                 attn_chunk: int = 2048,
                 return_hidden: bool = False) -> torch.Tensor:
    """The teacher-forced decoder over a whole sequence, the reference's
    ``decode_train``: tokens (B, T) -> logits (B, T, V), each layer's
    causal self-attention, cross-attention over the encoder ``memory``
    (B, F, d), then its MLP. ``return_hidden`` skips the final norm and
    the readout (the chunked loss reads them a chunk at a time)."""
    t = tokens.shape[1]
    x = layers.embed(params["embed"], tokens)
    x = x + params["dec_pos"]["table"][:t].to(x.dtype)

    shard = ctx.current_train_shard()
    specs, layouts = shard_layouts(cfg, shard, ("dec_blocks",),
                                   len(params["dec_blocks"]))

    def self_attn(p, c, h, **kw):
        return attention(p, c, h, causal=True, chunk=attn_chunk,
                         engine=engine, **kw)

    def cross_attn(p, c, h, memory, **kw):
        return attention(p, c, h, memory=memory, chunk=attn_chunk,
                         engine=engine, **kw)

    def block(x, p, memory, i):
        p, parts, devs = gather_for_shard(p, shard, specs[i],
                                           layouts[i])
        h = layers.norm_apply(p["norm1"], x, cfg.norm)
        x = x + tensor_parallel(self_attn, p["self_attn"],
                                parts.get("self_attn"), cfg, devs, h
                                ).to(x.dtype)
        h = layers.norm_apply(p["norm_x"], x, cfg.norm)
        x = x + tensor_parallel(cross_attn, p["cross_attn"],
                                parts.get("cross_attn"), cfg, devs, h,
                                memory).to(x.dtype)
        h = layers.norm_apply(p["norm2"], x, cfg.norm)
        return x + tensor_parallel(mlp_fn(engine), p["ffn"],
                                   parts.get("ffn"), cfg, devs, h
                                   ).to(x.dtype)

    block = remat(block, cfg)
    for i, p in enumerate(params["dec_blocks"]):
        x = block(x, p, memory, i)
    if return_hidden:
        return x
    x = layers.norm_apply(params["dec_norm"], x, cfg.norm)
    return layers.unembed(params["embed"], x, engine)


def precompute_cross_kv(params: dict, cfg: ModelConfig, memory: torch.Tensor,
                        *, engine=None
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Project each decoder layer's cross K/V once per utterance (the
    paper's ``dec.cross.kv`` kernel class). Returns [(B,F,Hkv,hd) x2] per
    layer, in ``cfg.dtype``; a serving block whose cross-attention is
    split over "model" gives each model shard's heads, on its device
    (``ModelShards``)."""
    b, f, _ = memory.shape
    dtype = layers.DTYPES[cfg.dtype]

    def kv(p, hkv, x):
        k = layers.linear(p["k"], x, engine, "dec.cross.k")
        v = layers.linear(p["v"], x, engine, "dec.cross.v")
        return (k.reshape(b, f, hkv, cfg.head_dim).to(dtype),
                v.reshape(b, f, hkv, cfg.head_dim).to(dtype))
    out = []
    for p in params["dec_blocks"]:
        p, parts, devs = gather_for_shard(p, None, None, None)
        split = parts.get("cross_attn")
        if split is None:
            out.append(kv(p["cross_attn"], cfg.num_kv_heads, memory))
            continue
        shards = []
        for m, (part, dev) in enumerate(zip(split, devs)):
            with op_cost.at(model=m), ctx.model_shard_scope(m, len(split)):
                shards.append(kv(part, cfg.num_kv_heads // len(split),
                                 memory.to(dev)))
        out.append(ModelShards(shards))
    return out


def init_whisper_decode_state(params: dict, cfg: ModelConfig,
                              memory: torch.Tensor, max_len: int, *,
                              engine=None,
                              dtype=torch.bfloat16) -> WhisperDecodeState:
    """Zero self-KV caches (lengths 0 on the memory's device) and the cross
    K/V projected from ``memory``."""
    b = memory.shape[0]
    return WhisperDecodeState(
        self_kv=[KVCache.zeros(b, max_len, cfg.num_kv_heads, cfg.head_dim,
                               dtype, device=memory.device)
                 for _ in range(cfg.num_layers)],
        cross_kv=precompute_cross_kv(params, cfg, memory, engine=engine))


def zeros_decode_state(cfg: ModelConfig, batch: int, frames: int,
                       max_len: int, *, device,
                       dtype=torch.bfloat16,
                       kv_devices=None) -> WhisperDecodeState:
    """A decode state of zeros for ``batch`` utterances of ``frames``
    frames on ``device`` (no default): the static buffers that a captured
    prefill fills and a captured decode step reads. With ``kv_devices``
    (a serving data shard's model devices, its attention split over
    them) each layer's self-KV cache and cross K/V are one a model shard,
    its heads on its device (``ModelShards``)."""
    def cross(d, hkv):
        return tuple(torch.zeros((batch, frames, hkv, cfg.head_dim),
                                 dtype=dtype, device=d) for _ in range(2))

    def layer_cross():
        if kv_devices is None:
            return cross(device, cfg.num_kv_heads)
        return ModelShards(cross(d, cfg.num_kv_heads // len(kv_devices))
                           for d in kv_devices)
    return WhisperDecodeState(
        self_kv=[kv_zeros(cfg, KVCache, batch, max_len, dtype, device=device,
                          kv_devices=kv_devices)
                 for _ in range(cfg.num_layers)],
        cross_kv=[layer_cross() for _ in range(cfg.num_layers)])


def zeros_slot_decode_state(cfg: ModelConfig, n_slots: int, frames: int,
                            max_len: int, *, device,
                            dtype=torch.bfloat16,
                            kv_devices=None) -> WhisperDecodeState:
    """The slot-layout twin of ``zeros_decode_state``: ``n_slots`` rows,
    each layer's cache with ``(n_slots,)`` lengths, so that every slot of a
    continuous-batching pool decodes at its own position."""
    st = zeros_decode_state(cfg, n_slots, frames, max_len, device=device,
                            dtype=dtype, kv_devices=kv_devices)
    return st._replace(self_kv=[
        map_shards(lambda c: c._replace(length=torch.zeros(
            (n_slots,), dtype=torch.int32, device=c.k.device)), kv)
        for kv in st.self_kv])


def zeros_paged_decode_state(cfg: ModelConfig, n_slots: int, max_pages: int,
                             n_pages: int, page_size: int,
                             n_cross_per_req: int, n_cross_pages: int,
                             cross_page_size: int, *, device,
                             dtype=torch.bfloat16, kv_devices=None):
    """A paged decode state of zeros on ``device`` (no default): the arenas
    of ``n_pages`` self pages and ``n_cross_pages`` cross pages, and
    ``n_slots`` table rows all pointing at the trash page. With
    ``kv_devices`` (a serving data shard's model devices, its attention
    split over them) one such state a model shard (``ModelShards``): its
    arenas of Hkv / M heads, its own copy of the tables and lengths, on
    its device; the page numbering is one for all of them."""
    r, hd = cfg.num_layers, cfg.head_dim

    def state(dev, hkv):
        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)
        return WhisperPagedDecodeState(
            self_k=zeros(r, n_pages, page_size, hkv, hd),
            self_v=zeros(r, n_pages, page_size, hkv, hd),
            cross_k=zeros(r, n_cross_pages, cross_page_size, hkv, hd),
            cross_v=zeros(r, n_cross_pages, cross_page_size, hkv, hd),
            block_table=zeros(n_slots, max_pages, dt=torch.int32),
            cross_table=zeros(n_slots, n_cross_per_req, dt=torch.int32),
            length=zeros(r, n_slots, dt=torch.int32))
    if kv_devices is None:
        return state(device, cfg.num_kv_heads)
    return ModelShards(state(d, cfg.num_kv_heads // len(kv_devices))
                       for d in kv_devices)


def is_paged(layer_states) -> bool:
    """Whether ``layer_states`` is a paged decode state, whole or one a
    model shard."""
    return isinstance(first_shard(layer_states), WhisperPagedDecodeState)


def warm_tuning(cfg: ModelConfig, engine, *, n_frames: int = 1500,
                n_tokens: int = 27, batch: int = 1,
                quant: Optional[str] = None) -> int:
    """Pre-tune every matrix-product shape of one Whisper inference (the
    coverage enumerator's invocation classes, batch-scaled), so that a
    request does not stall on a tuning search, as the reference does.
    ``quant`` is the serving quantization (the engine's, which may override
    ``cfg.quant``); it selects which kernels' keys are warmed. Returns the
    number of distinct shapes tuned; 0 if the engine carries no tuner."""
    if engine is None or getattr(engine, "tuner", None) is None:
        return 0
    from repro_torch.core.coverage import MulMat, enumerate_whisper
    q = quant if quant is not None else cfg.quant
    dtype = "q8_0" if q == "q8_0" else "bf16"
    mulmats = [MulMat(m.name, m=m.m * batch, k=m.k, n=m.n)
               for m in enumerate_whisper(cfg, n_frames, n_tokens)]
    return engine.tuner.warm(mulmats, dtype=dtype)


def _embed_window(params: dict, tokens: torch.Tensor,
                  length: torch.Tensor) -> torch.Tensor:
    """tokens (B, W) embedded, plus window position j's learned positional
    row ``length + j``: a scalar ``length`` in lockstep (the window's
    start clamped to the table, as the reference's ``dynamic_slice``
    clamps it), or ``(B,)`` in the slot layout, where each row reads its
    own rows, clamped to the table's last row (a free slot's position
    keeps rising after its request left; an index past the table would be
    a device assert on the card). At W = 1 these are the decode step's
    operations, one for one."""
    x = layers.embed(params["embed"], tokens)
    table = params["dec_pos"]["table"]
    w = tokens.shape[1]
    last = table.shape[0] - 1
    if length.dim():                               # per-slot positions (B,)
        if w == 1:
            pos = length.clamp(max=last)
            return x + table.index_select(0, pos)[:, None].to(x.dtype)
        posw = (length[:, None] + torch.arange(w, device=length.device)
                ).clamp(max=last)
        return x + table[posw].to(x.dtype)
    if w == 1:
        return x + table.index_select(0, length.reshape(1)).to(x.dtype)
    start = length.clamp(max=table.shape[0] - w)
    return x + table.index_select(
        0, start + torch.arange(w, device=length.device)).to(x.dtype)


def _decoder_stack(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   state: WhisperDecodeState, *, engine=None
                   ) -> Tuple[torch.Tensor, WhisperDecodeState]:
    """The decoder blocks and the readout over an embedded, positioned
    (B, W, d) input on the contiguous state, shared by the one-token step
    and the W-token verify window: each layer's ``decode_attention``
    appends its W self-KV entries and masks the window's causality, so
    W = 1 is the decode step."""
    attn, mlp = decode_attn_fn(engine), mlp_fn(engine)
    for p, kv, ck_cv in zip(params["dec_blocks"], state.self_kv,
                            state.cross_kv):
        p, parts, devs = gather_for_shard(p, None, None, None)
        caches = shard_list(kv)
        h = layers.norm_apply(p["norm1"], x, cfg.norm)
        x = x + tensor_parallel(attn, p["self_attn"], parts.get("self_attn"),
                                cfg, devs, h, shard_args=[
                                    (c,) for c in caches]).to(x.dtype)
        h = layers.norm_apply(p["norm_x"], x, cfg.norm)
        x = x + tensor_parallel(attn, p["cross_attn"],
                                parts.get("cross_attn"), cfg, devs, h,
                                shard_args=list(zip(
                                    caches, shard_list(ck_cv)))
                                ).to(x.dtype)
        h = layers.norm_apply(p["norm2"], x, cfg.norm)
        x = x + tensor_parallel(mlp, p["ffn"], parts.get("ffn"), cfg, devs,
                                h).to(x.dtype)
    x = layers.norm_apply(params["dec_norm"], x, cfg.norm)
    logits = layers.unembed(params["embed"], x, engine)
    return logits, state


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                state: WhisperDecodeState, *, engine=None
                ) -> Tuple[torch.Tensor, WhisperDecodeState]:
    """token: (B, 1) int -> (logits (B, 1, V), state'). The positions are
    the first layer's self-KV length, read on the device: a scalar when
    every row decodes in lockstep, ``(B,)`` in the slot-pool layout, where
    each row reads its own positional row (clamped to the table's last
    row: a free slot's position keeps rising after its request left).
    The self-KV caches advance in place, so ``state'`` holds the same
    tensors as ``state``. A ``WhisperPagedDecodeState`` takes the paged
    twin (``_verify_step_paged`` at W = 1)."""
    return verify_step(params, cfg, token, state, engine=engine)


def verify_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                state: WhisperDecodeState, *, engine=None
                ) -> Tuple[torch.Tensor, WhisperDecodeState]:
    """Score a W-token window in one forward: tokens (B, W) int ->
    (logits (B, W, V), state') with every layer's self-KV advanced by W,
    in place. ``logits[:, j]`` is the next-token distribution after
    ``tokens[:, :j + 1]``, what ``decode_step`` gives fed those tokens one
    at a time, which makes speculative acceptance token-exact against the
    greedy verifier. The window's base is the first layer's self-KV
    length, scalar (lockstep) or per row (slot layout), as in
    ``decode_step``, which is this function at W = 1. A
    ``WhisperPagedDecodeState`` takes the paged twin."""
    if is_paged(state):
        return _verify_step_paged(params, cfg, tokens, state, engine=engine)
    x = _embed_window(params, tokens, first_shard(state.self_kv[0]).length)
    return _decoder_stack(params, cfg, x, state, engine=engine)


def _paged_stack(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state, *, engine=None):
    """The decoder blocks over an embedded, positioned (B, W, d) input on
    the paged state: the self-KV writes and reads go through the block
    table (``PagedKVCache``, layer i on its arena and ``length[i]``
    views), and each layer's cross K/V is gathered from its pages through
    ``cross_table`` into the contiguous (B, F, Hkv, hd) view. F is a whole
    number of cross pages (a pool invariant), so position t of the
    gathered view is position t of the contiguous one and every token is
    unchanged. Over "model" (a ``ModelShards`` state), as
    ``_decoder_stack``: each model shard's attention over its own arenas,
    tables and lengths, the FFN split where its block holds slices."""
    attn, mlp = decode_attn_fn(engine), mlp_fn(engine)
    states = shard_list(state)
    for i, p in enumerate(params["dec_blocks"]):
        p, parts, devs = gather_for_shard(p, None, None, None)
        caches = [PagedKVCache(s.self_k[i], s.self_v[i], s.block_table,
                               s.length[i]) for s in states]
        cross = [(paged_window_gather(s.cross_k[i], s.cross_table),
                  paged_window_gather(s.cross_v[i], s.cross_table))
                 for s in states]
        h = layers.norm_apply(p["norm1"], x, cfg.norm)
        x = x + tensor_parallel(attn, p["self_attn"], parts.get("self_attn"),
                                cfg, devs, h, shard_args=[
                                    (c,) for c in caches]).to(x.dtype)
        h = layers.norm_apply(p["norm_x"], x, cfg.norm)
        x = x + tensor_parallel(attn, p["cross_attn"],
                                parts.get("cross_attn"), cfg, devs, h,
                                shard_args=list(zip(caches, cross))
                                ).to(x.dtype)
        h = layers.norm_apply(p["norm2"], x, cfg.norm)
        x = x + tensor_parallel(mlp, p["ffn"], parts.get("ffn"), cfg, devs,
                                h).to(x.dtype)
    x = layers.norm_apply(params["dec_norm"], x, cfg.norm)
    return layers.unembed(params["embed"], x, engine), state


def _verify_step_paged(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       state, *, engine=None):
    """The paged twin of ``verify_step`` (and at W = 1 of ``decode_step``):
    embedding and per-slot positions (the first layer's lengths, clamped
    as the contiguous slot step clamps them), then the paged stack, whose
    self-KV writes scatter the W entries through the block table."""
    x = _embed_window(params, tokens, first_shard(state).length[0])
    return _paged_stack(params, cfg, x, state, engine=engine)
