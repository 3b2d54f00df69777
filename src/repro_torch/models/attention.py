"""Attention for the port: full-sequence self- and cross-attention (the
Whisper encoder, Whisper's teacher-forced decoder, and every LM's
``forward``), either query-chunked (``attn_impl="chunked"``) or flash
(``"flash"``, on the ``flash_attention_fwd`` kernel), causal or not, and
single-step KV-cache decode attention, which the Whisper decoder and the
LMs share.

The chunked and decode paths are plain einsum and softmax ops, as the
reference writes them. The reference contracts with
``preferred_element_type=f32``; here the operands are upcast to f32 before
each contraction, which is the same function (bf16 products are exact in
f32). The probabilities are cast to the value type before the second
contraction, as in the reference. Decode attention is the reference's
grouped contraction: ``g = Hq / Hkv`` query heads share each K/V head
(GQA), and the repeated K/V is never materialized. An LM's self branch
rotates q and the new k by RoPE at positions ``length + j``.

A decode step of several rows runs its two contractions one row at a
time: on the card an einsum becomes a batched GEMM whose kernel, and so
whose order of summation, depends on how many rows the batch holds. Each
row of a continuous-batching slot step then gets the bits a batch-1 step
gives it, and the greedy tokens agree; a batch-1 step is unchanged. A
speculative verify window of W positions extends the rule to positions:
each (row, position) is contracted alone, as the W = 1 step of that row
would contract it, so position j's logits are the bits the j-th
sequential step gives.

The paged cache (``PagedKVCache``) keeps K/V in a page arena that every
row reaches through its block table: a step scatters its new entries
into the arena in place (``paged_window_update``) and gathers each row's
pages back into the contiguous view (``paged_window_gather``), so the
attention's arithmetic is the contiguous layout's. The int8 cache
(``QKVCache``, ``kv_quant="q8"``) stores K/V as int8 with one f32 scale a
position and head (``quantize_kv``) and dequantizes the whole cache to
the model's type before the contractions (``dequantize_kv``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.models import layers

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.bfloat16) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "q": layers.init_linear(gen, d, hq * hd, bias=cfg.qkv_bias, dtype=dtype),
        "k": layers.init_linear(gen, d, hkv * hd, bias=cfg.qkv_bias, dtype=dtype),
        "v": layers.init_linear(gen, d, hkv * hd, bias=cfg.qkv_bias, dtype=dtype),
        "o": layers.init_linear(gen, hq * hd, d, dtype=dtype),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


def _repeat_kv_heads(kv: torch.Tensor, hq: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hq, D)."""
    hkv = kv.shape[2]
    if hkv == hq:
        return kv
    return kv.repeat_interleave(hq // hkv, dim=2)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = False, chunk: int = 2048,
                       q_offset: int = 0) -> torch.Tensor:
    """Query-chunked attention, flat heads, the reference's
    ``_chunked_attention``. q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D).
    Returns (B, Sq, Hq, D) in q's type. ``causal`` masks key s for query
    i where s > ``q_offset`` + i, at NEG_INF before the softmax."""
    sq, hq, d = q.shape[1:]
    sk = k.shape[1]
    scale = d ** -0.5
    chunk = min(chunk, sq)
    if sq % chunk:
        chunk = sq  # single chunk for ragged shapes, as the reference does
    k = _repeat_kv_heads(k, hq).to(torch.float32)
    vf = _repeat_kv_heads(v, hq).to(torch.float32)
    outs = []
    for ci in range(sq // chunk):
        qi = q[:, ci * chunk:(ci + 1) * chunk].to(torch.float32)
        logits = torch.einsum("bqhd,bshd->bhqs", qi, k) * scale
        if causal:      # the encoder's (non-causal) launches stay as they were
            kpos = torch.arange(sk, device=q.device)
            qpos = q_offset + ci * chunk + torch.arange(chunk,
                                                        device=q.device)
            logits = torch.where(kpos[None, :] <= qpos[:, None], logits,
                                 torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd",
                           probs.to(v.dtype).to(torch.float32), vf)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


class _FlashCore(torch.autograd.Function):
    """Flash attention over folded (BH, S, D) operands with its flash-2
    backward, the reference's ``_flash_core`` custom VJP: the forward
    (``flash_attention_fwd``) returns the output in q's type and, where a
    gradient is wanted, keeps q, k, v, that output and the logsumexp; the
    backward recomputes the probabilities from them
    (``flash_attention_bwd``: the kernel for CUDA tensors, its plain
    version for CPU ones). Without a gradient to take the forward asks
    for no logsumexp, so an inference launch is the serving one."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, grad: bool):
        ctx.causal = causal
        if not grad:
            return flash_attention_fwd(q, k, v, causal=causal).to(q.dtype)
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.to(q.dtype), lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = False) -> torch.Tensor:
    """Online-softmax (flash-2) attention on the ``flash_attention_fwd``
    kernel, differentiable through ``_FlashCore``: the reference's
    ``_flash_attention`` with its (B, H) fold and GQA repeat, causal or
    not (the kernel masks key s for query i where s > i). q: (B, Sq, Hq,
    D); k/v: (B, Sk, Hkv, D). Returns (B, Sq, Hq, D) in q's type. The
    kernel walks keys in blocks of 64 and masks ragged lengths, where the
    reference's k-blocks must divide Sk (one block at 1500 frames): in
    bf16 the two round the probabilities against different running
    maxima."""
    b, sq, hq, d = q.shape
    k = _repeat_kv_heads(k, hq)
    v = _repeat_kv_heads(v, hq)

    def fold(t):          # (B, S, H, D) -> (B*H, S, D); a view when B = 1
        return t.transpose(1, 2).reshape(b * hq, t.shape[1], d)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    out = _FlashCore.apply(fold(q), fold(k), fold(v), causal, grad)
    return out.reshape(b, hq, sq, d).transpose(1, 2)


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              positions: Optional[torch.Tensor] = None,
              memory: Optional[torch.Tensor] = None,
              causal: bool = True, chunk: int = 2048,
              engine=None, partial: bool = False,
              f32_grad: bool = False) -> torch.Tensor:
    """Self- or cross-attention over a full sequence, the reference's
    ``attention``, by ``cfg.attn_impl``. x: (B, S, d) -> (B, S, d).
    ``memory`` (B, F, d), the encoder's states, makes it cross-attention:
    K/V are projected from it and nothing is masked or rotated. Otherwise
    ``causal`` masks later keys, and with ``cfg.pos_embedding == "rope"``
    q and k are rotated at ``positions`` (default 0..S-1). ``partial``:
    one model shard's heads, whose ``o`` output is a partial of the
    row-parallel product, returned in f32. ``f32_grad``: x (and
    ``memory``) are f32 upcasts of the weights' 16-bit type, multiplied
    at that type, with f32 input gradients (``layers.linear``)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if memory is None else memory
    q = _split_heads(layers.linear(p["q"], x, engine, "attn.q",
                                   f32_grad=f32_grad), hq)
    k = _split_heads(layers.linear(p["k"], src, engine, "attn.k",
                                   f32_grad=f32_grad), hkv)
    v = _split_heads(layers.linear(p["v"], src, engine, "attn.v",
                                   f32_grad=f32_grad), hkv)
    if memory is None and cfg.pos_embedding == "rope":
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    causal = memory is None and causal
    if cfg.attn_impl == "flash":
        out = _flash_attention(q, k, v, causal=causal)
    else:
        out = _chunked_attention(q, k, v, causal=causal, chunk=chunk)
    return layers.linear(p["o"], out.reshape(b, s, hq * hd), engine, "attn.o",
                         f32_out=partial)


class KVCache(NamedTuple):
    """Contiguous decode cache. ``length`` is an int32 device tensor, as in
    the reference, so that a decode step reads its positions on the device
    and a captured step replays at whatever positions the cache has
    reached: a scalar ``()`` when every row sits at the same position
    (lockstep decode), or ``(B,)`` in the slot-pool layout, where
    continuous batching keeps each row at its own decode position."""
    k: torch.Tensor       # (B, S_max, Hkv, D)
    v: torch.Tensor       # (B, S_max, Hkv, D)
    length: torch.Tensor  # () or (B,) int32: tokens currently valid

    @classmethod
    def zeros(cls, b: int, s_max: int, hkv: int, hd: int,
              dtype=torch.bfloat16, *, device) -> "KVCache":
        """An empty cache on ``device``, which the caller names: there is
        no default."""
        return cls(torch.zeros((b, s_max, hkv, hd), dtype=dtype, device=device),
                   torch.zeros((b, s_max, hkv, hd), dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def _cache_update(buf: torch.Tensor, val: torch.Tensor,
                  length: torch.Tensor) -> torch.Tensor:
    """Write ``val``'s W positions into ``buf`` from the device index
    ``length`` on, with no host read. Updates ``buf`` in place — the cache
    is the decode step's largest buffer, and a captured step rereads the
    storage it was captured with — and returns it.

    A scalar ``length`` writes every row at one index; the caller checks
    that the cache has room (it knows the step count on the host), and an
    index past the end is not checked here. A ``(B,)`` length writes row
    b's W entries from ``length[b]`` on, the start clamped to ``S_max -
    W``: a free slot of the pool keeps decoding after its request left and
    can pass the end, and an index out of range would be a device-side
    assert on the card. The reference's ``dynamic_update_slice`` clamps a
    start that would overrun the same way; an active row never reaches the
    clamp (the scheduler's budget keeps it within the cache)."""
    w = val.shape[1]
    if length.dim() == 0:
        idx = length.to(torch.long) + torch.arange(w, device=buf.device)
        return buf.index_copy_(1, idx, val.to(buf.dtype))
    rows = torch.arange(buf.shape[0], device=buf.device)
    start = length.clamp(max=buf.shape[1] - w).to(torch.long)
    if w == 1:                  # the decode step's launches, unchanged
        return buf.index_put_((rows, start), val[:, 0].to(buf.dtype))
    idx = start[:, None] + torch.arange(w, device=buf.device)[None, :]
    return buf.index_put_((rows[:, None], idx), val.to(buf.dtype))


class PagedKVCache(NamedTuple):
    """Paged decode cache: K/V live in a page arena shared by every row,
    each row reaching its pages through its ``block_table`` row. Physical
    page 0 is the trash page: the table rows of free slots all point at
    it, so the fixed-shape batch keeps writing garbage rows without owning
    memory. ``length`` is per row ``(B,)``; all four tensors are updated
    in place (a captured step rereads their storage)."""
    k_pages: torch.Tensor       # (P, page, Hkv, D) physical page arena
    v_pages: torch.Tensor       # (P, page, Hkv, D)
    block_table: torch.Tensor   # (B, max_pages) int32: logical -> physical
    length: torch.Tensor        # (B,) int32: tokens currently valid


class QKVCache(NamedTuple):
    """Int8 decode cache: K/V as int8 with one f32 scale a (position,
    head) over the head_dim block, the reference's ``QKVCache``. All five
    tensors are updated in place, like ``KVCache``'s."""
    k_qs: torch.Tensor        # int8 (B, S_max, Hkv, D)
    v_qs: torch.Tensor        # int8 (B, S_max, Hkv, D)
    k_scale: torch.Tensor     # f32  (B, S_max, Hkv)
    v_scale: torch.Tensor     # f32  (B, S_max, Hkv)
    length: torch.Tensor      # () or (B,) int32

    @classmethod
    def zeros(cls, b: int, s_max: int, hkv: int, hd: int, dtype=None, *,
              device) -> "QKVCache":
        """An empty int8 cache on ``device`` (``dtype`` is ignored: the
        storage is int8 and f32, as in the reference)."""
        def z(*shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)
        return cls(z(b, s_max, hkv, hd, dt=torch.int8),
                   z(b, s_max, hkv, hd, dt=torch.int8),
                   z(b, s_max, hkv, dt=torch.float32),
                   z(b, s_max, hkv, dt=torch.float32),
                   z(dt=torch.int32))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) -> (int8 qs, f32 scale (B, S, H)): symmetric, one
    scale ``max |x| / 127`` a head vector, values rounded half to even and
    clipped to [-127, 127], as the reference. Both divisions are by a
    tensor: the card's division by a Python scalar multiplies by its
    reciprocal, which is not the reference's rounding."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0)
    inv = torch.where(scale > 0, torch.ones_like(scale) / scale,
                      torch.zeros_like(scale))
    q = torch.round(xf * inv[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(qs: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (qs.to(torch.float32) * scale[..., None]).to(dtype)


def paged_window_update(pages: torch.Tensor, block_table: torch.Tensor,
                        length: torch.Tensor,
                        val: torch.Tensor) -> torch.Tensor:
    """Scatter a per-row W-token window into the page arena, in place, and
    return the arena. ``val`` is (B, W, Hkv, D); row b's window position j
    lands at logical position ``length[b] + j``: physical page
    ``block_table[b, (length[b] + j) // page]``, offset ``(length[b] + j)
    % page``, each entry resolving its own pair (a window may straddle a
    page boundary). The indices are computed on the device, with no host
    read. The logical page is clamped to the table's width, as the
    reference does: a free slot's position keeps rising, its table row
    points at the trash page, and an index past the table would be a
    device assert on the card. Free rows then write the trash page at the
    same offsets, duplicate indices whose winner is undefined; no active
    row reads page 0. Active rows own their pages, so their indices never
    collide."""
    ps = pages.shape[1]
    n_log = block_table.shape[1]
    w = val.shape[1]
    pos = (length.to(torch.long)[:, None]
           + torch.arange(w, device=pages.device)[None, :])      # (B, W)
    lp = (pos // ps).clamp(max=n_log - 1)
    phys = torch.gather(block_table.to(torch.long), 1, lp)
    return pages.index_put_((phys, pos % ps), val.to(pages.dtype))


def paged_window_gather(pages: torch.Tensor,
                        block_table: torch.Tensor) -> torch.Tensor:
    """Each row's pages gathered into its contiguous ``(n_log * page,
    ...)`` view: token t sits at position t, so the validity mask is the
    contiguous layout's and the attention unchanged (token-exact)."""
    b, n_log = block_table.shape
    return pages[block_table.to(torch.long)].reshape(
        b, n_log * pages.shape[1], *pages.shape[2:])


def _rows_apart(fn, a: torch.Tensor, c: torch.Tensor,
                w: int = 1) -> torch.Tensor:
    """``fn(a, c)`` over the rows of ``a``, which are (row, window
    position) pairs, ``w`` a row of ``c``: with more than one, one at a
    time, each exactly the batch-1, W = 1 contraction against its row of
    ``c``."""
    if a.shape[0] == 1:
        return fn(a, c)
    return torch.cat([fn(a[r:r + 1], c[r // w:r // w + 1])
                      for r in range(a.shape[0])])


class ModelShards(tuple):
    """A decode cache (or a layer's cross K/V) split over the model shards
    of a serving engine over "model": entry m is model shard m's, its
    Hkv / M heads on its own device. A plain tuple, which ``core.tree``
    and ``state_tensors`` walk."""


def shard_list(cache) -> list:
    """The model shards' caches: [cache] where it is whole."""
    return list(cache) if isinstance(cache, ModelShards) else [cache]


def first_shard(cache):
    """Model shard 0's cache, or the whole cache."""
    return cache[0] if isinstance(cache, ModelShards) else cache


def map_shards(fn, cache):
    """``fn`` of each model shard's cache, kept split."""
    if isinstance(cache, ModelShards):
        return ModelShards(fn(c) for c in cache)
    return fn(cache)


def decode_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: Union[KVCache, QKVCache, PagedKVCache], *,
                     memory_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     engine=None, partial: bool = False,
                     f32_grad: bool = False
                     ) -> Tuple[torch.Tensor,
                                Union[KVCache, QKVCache, PagedKVCache]]:
    """One decode step over a window of W positions. x: (B, W, d); W = 1
    is the autoregressive step, W = k + 1 the speculative verify window.
    Self-attention appends the W new K/V entries to ``cache`` and query j
    attends over positions <= length + j (its own entry, no later one);
    with ``memory_kv`` (the precomputed cross K/V) it attends over the
    encoder memory. Returns (out, cache): the self-attention cache is
    advanced by W in place (its K/V and length keep their storage), where
    the reference returns a new one. ``cache.length`` may be ``()``
    (lockstep) or ``(B,)`` (slot pool): each row then writes and attends
    at its own position. With ``cfg.pos_embedding == "rope"`` (the LMs) q
    and the new k are rotated at positions ``length + j`` first. A
    ``PagedKVCache`` writes its entries through the block table and
    attends over each row's gathered pages; a ``QKVCache`` stores them
    quantized and attends over the dequantized cache. ``partial``: one
    model shard's heads (``cfg`` their head-count view, ``cache`` its
    slice), whose ``o`` output is a partial of the row-parallel product,
    returned in f32 (``f32_grad`` is taken for ``attention``'s sake and
    has no use without a gradient)."""
    del f32_grad
    b, w = x.shape[0], x.shape[1]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(layers.linear(p["q"], x, engine, "dec.attn.q"), hq)
    if memory_kv is None:
        knew = _split_heads(layers.linear(p["k"], x, engine, "dec.attn.k"), hkv)
        vnew = _split_heads(layers.linear(p["v"], x, engine, "dec.attn.v"), hkv)
        if cfg.pos_embedding == "rope":
            pos = cache.length[..., None]          # (B, 1) or (1,)
            if w > 1:
                pos = pos + torch.arange(w, device=x.device)
            q = layers.apply_rope(q, pos, cfg.rope_theta)
            knew = layers.apply_rope(knew, pos, cfg.rope_theta)
        if isinstance(cache, PagedKVCache):
            for pages, new in ((cache.k_pages, knew), (cache.v_pages, vnew)):
                paged_window_update(pages, cache.block_table, cache.length,
                                    new)
            k = paged_window_gather(cache.k_pages, cache.block_table)
            v = paged_window_gather(cache.v_pages, cache.block_table)
        elif isinstance(cache, QKVCache):
            kq, ks = quantize_kv(knew)
            vq, vs = quantize_kv(vnew)
            for buf, val in ((cache.k_qs, kq), (cache.v_qs, vq),
                             (cache.k_scale, ks), (cache.v_scale, vs)):
                _cache_update(buf, val, cache.length)
            k = dequantize_kv(cache.k_qs, cache.k_scale, x.dtype)
            v = dequantize_kv(cache.v_qs, cache.v_scale, x.dtype)
        else:
            k = _cache_update(cache.k, knew, cache.length)
            v = _cache_update(cache.v, vnew, cache.length)
        # query j of row b sees keys s <= length[b] + j: a (B, W, S)
        # mask, or (W, S) in lockstep, one mask row a (row, position)
        # pair of the contractions below; W = 1 needs no offsets
        pos_idx = torch.arange(k.shape[1], device=x.device)
        qpos = cache.length[..., None]                 # (B, 1) or (1,)
        if w > 1:
            qpos = qpos + torch.arange(w, device=x.device)
        if cache.length.dim():                         # (B * W, 1, 1, 1, S)
            valid = (pos_idx[None, None, :] <= qpos[:, :, None]).reshape(
                b * w, 1, 1, 1, -1)
        elif w > 1:
            valid = (pos_idx[None, :] <= qpos[:, None]).repeat(b, 1)[
                :, None, None, None, :]
        else:
            valid = pos_idx <= cache.length
        cache.length.add_(w)
    else:
        k, v = memory_kv
        valid = None
    g = hq // hkv
    # one row a (row, position) pair: (B * W, 1, Hkv, G, D)
    qg = q.reshape(b * w, 1, hkv, g, hd).to(torch.float32)
    logits = _rows_apart(lambda qi, ki: torch.einsum("bqhgd,bshd->bhgqs",
                                                     qi, ki),
                         qg, k.to(torch.float32), w) * hd ** -0.5
    if valid is not None:
        logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = _rows_apart(lambda pi, vi: torch.einsum("bhgqs,bshd->bqhgd", pi, vi),
                      probs.to(v.dtype).to(torch.float32),
                      v.to(torch.float32), w)
    out = out.to(x.dtype).reshape(b, w, hq * hd)
    return layers.linear(p["o"], out, engine, "dec.attn.o",
                         f32_out=partial), cache
