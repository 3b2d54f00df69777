"""The model API of the port: the audio (Whisper) and decoder-only LM
(dense, MoE, SSM, hybrid, VLM) branches of the reference's family
dispatch.

  init_params(gen, cfg, max_positions, device) -> param dict
  hidden_forward(params, cfg, batch)           -> (hidden, moe_aux)
  forward(params, cfg, batch)                  -> (logits, moe_aux)
  loss_fn(params, cfg, batch)                  -> (loss, metrics)
  loss_terms(params, cfg, batch)               -> (ce_sum, ntok, moe_aux)
  init_serve_state(params, cfg, batch, max_len, memory=...) -> ServeState
  zeros_serve_state(cfg, batch, frames, max_len, device=...) -> ServeState
  zeros_slot_state(cfg, n_slots, frames, max_len, device=...) -> ServeState
  prefill(params, cfg, tokens, state)          -> (last logits, state') LM
  zeros_paged_state(cfg, n_slots, ..., device=...) -> ServeState (paged)
  slot_layout(state, batch)                    -> ServeState (slot layout)
  slot_state_specs(state, mesh)                -> spec tree (sharded pool)
  slot_view(state, lo, n)                      -> ServeState (rows lo..lo+n)
  state_kv_bytes(state)                        -> committed bytes
  serve_step(params, cfg, token, state)        -> (logits, state')
  verify_step(params, cfg, tokens, state)      -> (logits (B, W, V), state')
  set_slot_lengths(state, new_len)             -> None (in place)

An LM's layer state is a list of one state a layer (an attention layer's
``KVCache``, or ``QKVCache`` with ``kv_quant="q8"``; an SSM layer's
``SSMState``), where the reference stacks the layers of each pattern
position's leaves; every tensor still has the batch on axis 0, so the
slot splice (``serve/kvcache.py``) treats every family alike, and each
layer's ``length`` is its counter (per row in the slot layout). An LM's
prefill is the reference's: a loop of ``serve_step`` over the prompt's
tokens (the reference's ``lax.scan``), not a full-sequence forward.

``forward`` and ``loss_fn`` run a whole sequence at once; ``loss_fn`` is
what training differentiates (``train/step.py``), its layers and CE
chunks under activation checkpointing by ``cfg.remat``. The batch is a
dict of tensors, the reference's conventions:

  LM families : {"tokens": (B, S) int, "labels": (B, S) int}
  vlm         : + {"patches": (B, P, E_vis) f32}, projected and spliced
                over the first P token positions
  audio       : {"mel": (B, F, n_mels) f32, "tokens": (B, T), "labels"}

The VLM serves on tokens alone, as the reference does: ``serve_step`` and
``prefill`` never read patches, so only ``hidden_forward`` runs the
projector.
"""
from __future__ import annotations

import functools
from typing import Any, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import LAYER_LISTS, map_with_path
from repro_torch.models import layers, transformer, whisper
from repro_torch.models.attention import map_shards, shard_list
from repro_torch.roofline import op_cost
from repro_torch.sharding import ctx, rules


class ServeState(NamedTuple):
    """Decode state: the family's layer states and the number of steps
    taken, an int32 device tensor advanced in place: ``()`` in the
    reference's standard layout, ``(B,)`` in the slot layout of a
    continuous-batching pool, where every counter (``step`` and each
    layer's cache length) is per row."""
    layer_states: Any     # WhisperDecodeState | [a state a layer] (LM)
    step: torch.Tensor    # () or (B,) int32


def to_device(tree, device: torch.device):
    """A parameter tree (dicts and lists of tensors or QTensors) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                max_positions: int = 0, *, device="cuda") -> dict:
    """Random weights from ``gen`` (drawn on the generator's device), placed
    on ``device``. An LM's tree is the reference's (``embed``, ``stack``
    with one dict a layer, ``final_norm``, ``lm_head`` unless tied), drawn
    tensor by tensor: with a CUDA generator no weight passes through host
    memory."""
    dev = resolve_device(device)
    if cfg.family == "audio":
        return to_device(whisper.init_whisper(gen, cfg, max_positions), dev)
    pdtype = layers.DTYPES[cfg.param_dtype]
    params = {
        "embed": layers.init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                       pdtype),
        "stack": transformer.init_decoder_stack(gen, cfg),
        "final_norm": layers.init_norm(cfg.d_model, pdtype, kind=cfg.norm,
                                       device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_linear(gen, cfg.d_model,
                                               cfg.padded_vocab, dtype=pdtype)
    if cfg.family == "vlm":
        params["projector"] = layers.init_linear(
            gen, cfg.vision_embed_dim, cfg.d_model, bias=True, dtype=pdtype)
    return to_device(params, dev)


def _readout(params: dict, cfg: ModelConfig, x: torch.Tensor,
             engine=None) -> torch.Tensor:
    """An LM's final norm and vocabulary readout (tied or ``lm_head``);
    a readout split over "model" by ``layers.vocab_logits``."""
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x, engine)
    w = params["lm_head"]["w"]
    if isinstance(w, layers.VocabShards):
        return layers.vocab_logits(w, x, engine, "lm_head")
    return layers.linear(params["lm_head"], x, engine, "lm_head")


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict,
                  engine=None) -> torch.Tensor:
    """The token embeddings in the model's type; a VLM's ``patches`` (B,
    P, E_vis) go through the projector (``vlm.projector``), are cast to
    that type and replace the first P positions."""
    x = layers.embed(params["embed"], batch["tokens"]).to(
        layers.DTYPES[cfg.dtype])
    if cfg.family == "vlm" and "patches" in batch:
        proj = layers.linear(params["projector"], batch["patches"], engine,
                             "vlm.projector").to(x.dtype)
        x = torch.cat([proj, x[:, proj.shape[1]:]], dim=1)
    return x


def hidden_forward(params: dict, cfg: ModelConfig, batch: dict, *,
                   engine=None, attn_chunk: int = 2048
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backbone only: (final hidden states before the readout, the MoE
    load-balance loss, f32). Whisper encodes ``mel`` and runs the decoder
    teacher-forced over ``tokens``; an LM embeds (a VLM splicing its
    patches) and runs the decoder stack at positions 0..S-1."""
    if cfg.family == "audio":
        memory = whisper.encode(params, cfg, batch["mel"], engine=engine,
                                attn_chunk=attn_chunk)
        h = whisper.decode_train(params, cfg, batch["tokens"], memory,
                                 engine=engine, attn_chunk=attn_chunk,
                                 return_hidden=True)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    x = _embed_inputs(params, cfg, batch, engine)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return transformer.apply_decoder_stack(params["stack"], cfg, x,
                                           positions=positions,
                                           engine=engine,
                                           attn_chunk=attn_chunk)


def whisper_readout(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    engine=None) -> torch.Tensor:
    """Whisper's final decoder norm and tied vocabulary readout."""
    x = layers.norm_apply(params["dec_norm"], x, cfg.norm)
    return layers.unembed(params["embed"], x, engine)


def forward(params: dict, cfg: ModelConfig, batch: dict, *, engine=None,
            attn_chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, padded vocab), the MoE load-balance loss)."""
    h, aux = hidden_forward(params, cfg, batch, engine=engine,
                            attn_chunk=attn_chunk)
    readout = whisper_readout if cfg.family == "audio" else _readout
    return readout(params, cfg, h, engine), aux


def _ce_of_logits(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's masked cross-entropy sums (the sum over labelled
    positions, their count), in f32: the pad columns (>= vocab_size) are
    masked out of the log-sum-exp, and labels < 0 out of both sums."""
    logits = logits.to(torch.float32)
    v = logits.shape[-1]
    if v > vocab_size:                     # the vocabulary's pad columns
        col = torch.arange(v, device=logits.device)
        logits = torch.where(col < vocab_size, logits,
                             torch.full_like(logits, -1e30))
    mask = (labels >= 0).to(torch.float32)
    safe = labels.clamp(min=0).to(torch.long)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def _ce_of_shards(w: layers.VocabShards, x: torch.Tensor,
                  labels: torch.Tensor, vocab_size: int, engine=None,
                  name: str = "lm_head"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_ce_of_logits`` of the readout ``x @ W^T`` with W's rows split
    over model shards (``w``): each shard m computes its (..., V / M)
    logits on its device, in f32, masks the pad columns it holds, and
    gives its row max, its sum of ``exp(l - max)`` and the gold logit
    where it holds the label (0 elsewhere), charged to its model entry.
    These are combined on x's device in f32, in model-shard order, into
    ``logz - gold``; labels < 0 are masked out of both sums. The maxima
    are constants to autograd (they cancel in ``logz``), so the gradient
    is the softmax's. The combine is reported as an all-reduce."""
    dev = x.device
    stats = []
    for m, (wm, lo, d) in enumerate(w):
        with op_cost.at(model=m):
            logits = layers.linear({"w": wm}, x.to(d), engine, name).to(
                torch.float32)
            v = wm.shape[0]
            if lo + v > vocab_size:            # pad columns on this shard
                col = torch.arange(lo, lo + v, device=d)
                logits = torch.where(col < vocab_size, logits,
                                     torch.full_like(logits, -1e30))
            top = logits.amax(-1).detach()
            sumexp = torch.exp(logits - top[..., None]).sum(-1)
            local = labels.to(d).long() - lo
            own = (local >= 0) & (local < v)
            gold = torch.gather(logits, -1,
                                local.clamp(0, v - 1)[..., None])[..., 0]
            gold = torch.where(own, gold, torch.zeros_like(gold))
            op_cost.collective("all-reduce", 3 * top.numel() * 4,
                               len(w.parts), "vocab ce")
        stats.append((top.to(dev), sumexp.to(dev), gold.to(dev)))
    top = stats[0][0]
    for t, _, _ in stats[1:]:
        top = torch.maximum(top, t)
    total = gold = None
    for t, se, g in stats:
        term = se * torch.exp(t - top)
        total = term if total is None else total + term
        gold = g if gold is None else gold + g
    logz = top + torch.log(total)
    mask = (labels >= 0).to(torch.float32)
    return ((logz - gold) * mask).sum(), mask.sum()


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *, engine=None,
            attn_chunk: int = 2048, ce_chunk: int = 512
            ) -> Tuple[torch.Tensor, dict]:
    """Next-token cross-entropy over ``labels`` (already shifted; label
    -1 masked) plus the MoE load-balance loss: (total, {"ce", "moe_aux",
    "ntok"}); the CE is the sum over labelled positions over their count
    (at least 1), from ``loss_terms``."""
    ce_sum, ntok, aux = loss_terms(params, cfg, batch, engine=engine,
                                   attn_chunk=attn_chunk, ce_chunk=ce_chunk)
    ntok = ntok.clamp(min=1.0)
    loss = ce_sum / ntok
    return loss + aux, {"ce": loss, "moe_aux": aux, "ntok": ntok}


def loss_terms(params: dict, cfg: ModelConfig, batch: dict, *,
               engine=None, attn_chunk: int = 2048, ce_chunk: int = 512
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sums ``loss_fn`` divides: (the masked CE summed over labelled
    positions, their count, the MoE load-balance loss), f32 scalars; a
    mesh step adds the first two over its data shards before it divides
    (``train/step.py``). The readout and its CE run a ``ce_chunk`` of the
    sequence at a time where it divides S and S > ``ce_chunk``, as the
    reference's sequence chunking: the logits never exceed (B, ce_chunk,
    V), and the readout launches once a chunk. Where a gradient is
    recorded, each chunk runs under activation checkpointing, as the
    reference's ``jax.checkpoint``: its logits are recomputed in the
    backward, not kept. As a data shard of a mesh step
    (``ctx.train_shard``), ``params`` are the stored pieces: the leaves
    outside the layer lists (embedding, norms, readout, position tables,
    frontend, projector) are gathered onto the shard's devices here, and
    each block gathers its own as it runs. Where ``rules.vocab_layout``
    splits the vocabulary, each model shard's rows of the embedding and
    the readout are gathered onto its own device (``layers.VocabShards``):
    the embedding is looked up a shard at a time and each CE chunk's
    logits computed a shard at a time (``_ce_of_shards``); the other
    leaves are gathered whole onto the first device."""
    shard = ctx.current_train_shard()
    if shard is not None:
        why = rules.vocab_layout(cfg, shard.specs, shard.mesh)
        rules.TP_BLOCKS[(rules.VOCAB_KEY, why)] += 1
        params = _gather_outside_blocks(params, shard.specs, shard.mesh,
                                        shard.devices, why == rules.SPLIT)
    h, aux = hidden_forward(params, cfg, batch, engine=engine,
                            attn_chunk=attn_chunk)
    labels = batch["labels"]
    audio = cfg.family == "audio"
    readout = whisper_readout if audio else _readout
    s = h.shape[1]
    n_chunks = s // ce_chunk if (s % ce_chunk == 0 and s > ce_chunk) else 1
    size = s // n_chunks
    tied = audio or cfg.tie_embeddings
    w = params["embed"]["table"] if tied else params["lm_head"]["w"]

    def chunk_ce(h_i, l_i):
        if isinstance(w, layers.VocabShards):
            x = layers.norm_apply(params["dec_norm" if audio else
                                         "final_norm"], h_i, cfg.norm)
            return _ce_of_shards(w, x, l_i, cfg.vocab_size, engine,
                                 "dec.vocab" if tied else "lm_head")
        return _ce_of_logits(readout(params, cfg, h_i, engine), l_i,
                             cfg.vocab_size)

    if n_chunks > 1 and transformer.grad_wanted(h):
        chunk_ce = functools.partial(checkpoint, chunk_ce,
                                     use_reentrant=False)
    ce_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    ntok = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        cs, nt = chunk_ce(h[:, i * size:(i + 1) * size],
                          labels[:, i * size:(i + 1) * size])
        ce_sum, ntok = ce_sum + cs, ntok + nt
    return ce_sum, ntok, aux


#: the vocabulary leaves' paths in a parameter tree
VOCAB_PATHS = (("embed", "table"), ("lm_head", "w"))


def _gather_outside_blocks(params: dict, specs: dict, mesh, devices,
                           split_vocab: bool, path=()) -> dict:
    """A split parameter tree with every leaf outside the layer lists
    gathered whole onto ``devices[0]`` (``rules.gather_part``), the layer
    lists' pieces kept; with ``split_vocab``, each vocabulary leaf's model
    part m on ``devices[m]`` (``layers.VocabShards``)."""
    if path in LAYER_LISTS:
        return params
    if rules.is_pieces(params):
        if split_vocab and path in VOCAB_PATHS:
            return layers.VocabShards(tuple(rules.gather_model_parts(
                params, specs, mesh, devices)), tuple(devices))
        return rules.gather_part(params, specs, mesh, devices[0])
    return {k: _gather_outside_blocks(v, specs[k], mesh, devices,
                                      split_vocab, path + (k,))
            for k, v in params.items()}


def _lm_state(cfg: ModelConfig, batch: int, max_len: int, device,
              per_row: bool, kv_devices=None) -> ServeState:
    caches = transformer.init_decode_state(cfg, batch, max_len,
                                           layers.DTYPES[cfg.dtype],
                                           device=device,
                                           kv_devices=kv_devices)
    shape = (batch,) if per_row else ()
    if per_row:
        caches = [map_shards(lambda c: c._replace(length=torch.zeros(
            shape, dtype=torch.int32, device=c.length.device)), c)
            for c in caches]
    return ServeState(layer_states=caches, step=torch.zeros(
        shape, dtype=torch.int32, device=device))


def _device_of(params: dict) -> torch.device:
    t = params["embed"]["table"]
    return (t.qs if hasattr(t, "qs") else t).device


def init_serve_state(params: dict, cfg: ModelConfig, batch: int,
                     max_len: int, *, memory: Optional[torch.Tensor] = None,
                     engine=None) -> ServeState:
    """The decode state at step 0: an LM's empty caches on the weights'
    device, or whisper's empty self caches and the cross K/V projected
    from ``memory``."""
    if cfg.family != "audio":
        return _lm_state(cfg, batch, max_len, _device_of(params),
                         per_row=False)
    if memory is None:
        raise ValueError("whisper decode needs encoder memory")
    st = whisper.init_whisper_decode_state(params, cfg, memory, max_len,
                                           engine=engine,
                                           dtype=layers.DTYPES[cfg.dtype])
    return ServeState(layer_states=st, step=torch.zeros(
        (), dtype=torch.int32, device=memory.device))


def zeros_serve_state(cfg: ModelConfig, batch: int, frames: int,
                      max_len: int, *, device, kv_devices=None
                      ) -> ServeState:
    """A ServeState of zeros: the static buffers of the serving engine's
    captured prefill and decode step at (batch, frames); an LM's caches
    (``frames`` unused). ``kv_devices``: a data shard's model devices,
    over which its attention caches split (``transformer.kv_zeros``)."""
    if cfg.family != "audio":
        return _lm_state(cfg, batch, max_len, device, per_row=False,
                         kv_devices=kv_devices)
    st = whisper.zeros_decode_state(cfg, batch, frames, max_len,
                                    dtype=layers.DTYPES[cfg.dtype],
                                    device=device, kv_devices=kv_devices)
    return ServeState(layer_states=st, step=torch.zeros(
        (), dtype=torch.int32, device=device))


def zeros_slot_state(cfg: ModelConfig, n_slots: int, frames: int,
                     max_len: int, *, device, kv_devices=None
                     ) -> ServeState:
    """A slot-layout ServeState of zeros: the pool of a continuous-batching
    scheduler, ``n_slots`` rows of ``frames`` cross-K/V frames and
    ``max_len`` self-KV positions, with ``(n_slots,)`` counters (an LM's
    pool has no frames); its attention caches split over ``kv_devices``
    where given."""
    if cfg.family != "audio":
        return _lm_state(cfg, n_slots, max_len, device, per_row=True,
                         kv_devices=kv_devices)
    st = whisper.zeros_slot_decode_state(cfg, n_slots, frames, max_len,
                                         dtype=layers.DTYPES[cfg.dtype],
                                         device=device,
                                         kv_devices=kv_devices)
    return ServeState(layer_states=st, step=torch.zeros(
        (n_slots,), dtype=torch.int32, device=device))


def zeros_paged_state(cfg: ModelConfig, n_slots: int, *, max_pages: int,
                      n_pages: int, page_size: int, n_cross_per_req: int,
                      n_cross_pages: int, cross_page_size: int,
                      device, kv_devices=None) -> ServeState:
    """A paged ServeState of zeros: the arenas, block tables and ``(R,
    n_slots)`` lengths of a paged pool (``serve/paging.py``), with
    ``(n_slots,)`` steps on ``device``; one paged layer state a model
    shard of ``kv_devices`` where given
    (``whisper.zeros_paged_decode_state``). ``serve_step`` dispatches on
    its layer state."""
    st = whisper.zeros_paged_decode_state(
        cfg, n_slots, max_pages, n_pages, page_size, n_cross_per_req,
        n_cross_pages, cross_page_size, dtype=layers.DTYPES[cfg.dtype],
        device=device, kv_devices=kv_devices)
    return ServeState(layer_states=st, step=torch.zeros(
        (n_slots,), dtype=torch.int32, device=device))


def slot_layout(state: ServeState, batch: int) -> ServeState:
    """Standard -> slot layout: every scalar counter (``step`` and each
    layer's length) becomes a ``(batch,)`` vector holding its value.
    Returns a new ServeState: the counters are new tensors, the data
    tensors (self and cross K/V, SSM states) are the same tensors as
    ``state``'s.
    Counters already per row pass through, so it is idempotent."""
    def per_row(t: torch.Tensor) -> torch.Tensor:
        return t.expand(batch).clone() if t.dim() == 0 else t
    def kv(c):
        return map_shards(lambda x: x._replace(length=per_row(x.length)), c)
    ls = state.layer_states
    if isinstance(ls, list):                       # an LM's layer states
        return ServeState(layer_states=[kv(c) for c in ls],
                          step=per_row(state.step))
    return ServeState(
        layer_states=ls._replace(self_kv=[kv(c) for c in ls.self_kv]),
        step=per_row(state.step))


def slot_state_specs(state: ServeState, mesh) -> ServeState:
    """Partition specs of a slot-layout ``ServeState``: the slot axis
    shards over the mesh's "data" axis whenever the pool's width divides
    by its size; every other dim stays replicated. The port keeps the slot
    axis on axis 0 of every tensor, where the reference's stacked
    ``layer_states`` leaves keep it on axis 1 (and ``step`` on axis 0): the
    same leaves are split, along their slot axis."""
    from repro_torch.sharding.rules import P
    dsize = mesh.shape["data"] if "data" in mesh.axis_names else 1

    def spec(path, t):
        if dsize <= 1 or t.dim() == 0 or t.shape[0] % dsize:
            return P()
        return P("data")

    return map_with_path(spec, state)


def slot_view(state: ServeState, lo: int, n: int) -> ServeState:
    """Rows ``lo`` to ``lo + n`` of a slot-layout or paged state, as
    views: a data shard's part of a pool, which its program reads and
    writes in place. A paged state's arenas stay whole (its block tables
    hold the arena's own page numbers); its tables, lengths (slot axis 1)
    and steps are narrowed, every model shard's alike."""
    ls = state.layer_states
    if whisper.is_paged(ls):
        ls = map_shards(lambda s: s._replace(
            block_table=s.block_table.narrow(0, lo, n),
            cross_table=s.cross_table.narrow(0, lo, n),
            length=s.length.narrow(1, lo, n)), ls)
    else:
        ls = map_with_path(lambda _, t: t.narrow(0, lo, n), ls)
    return ServeState(layer_states=ls, step=state.step.narrow(0, lo, n))


def state_tensors(state: Any) -> List[torch.Tensor]:
    """Every tensor of a decode state (NamedTuples, lists and tuples of
    tensors), in field order."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for part in state for t in state_tensors(part)]


def state_kv_bytes(state: Any) -> int:
    """Committed bytes of a decode state: its KV buffers and counters (a
    paged state's arenas, block tables and lengths). The reference stacks
    the layers of a contiguous leaf where the port keeps a list per layer;
    the bytes are the same."""
    return sum(t.numel() * t.element_size() for t in state_tensors(state))


def serve_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
               state: ServeState, *, engine=None
               ) -> Tuple[torch.Tensor, ServeState]:
    """token: (B, 1) int -> (logits (B, 1, V), state'). The state advances
    in place: ``state'`` holds the same tensors as ``state``. A paged
    state takes the paged step (``whisper.decode_step`` dispatches). An
    LM embeds the token in the model's type, runs the decoder stack and
    the readout."""
    if cfg.family == "audio":
        logits, _ = whisper.decode_step(params, cfg, token,
                                        state.layer_states, engine=engine)
    else:
        x = layers.embed(params["embed"], token).to(layers.DTYPES[cfg.dtype])
        x, _ = transformer.decode_step_stack(params["stack"], cfg, x,
                                             state.layer_states,
                                             engine=engine)
        logits = _readout(params, cfg, x, engine)
    state.step.add_(1)
    return logits, state


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            state: ServeState, *, engine=None
            ) -> Tuple[torch.Tensor, ServeState]:
    """An LM's prefill, the reference's: ``serve_step`` over the prompt's
    tokens (B, S), one at a time, filling the caches in place. Returns the
    last token's logits (B, 1, V) and the state."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, state = serve_step(params, cfg, tokens[:, t:t + 1], state,
                                   engine=engine)
    return logits, state


def verify_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                state: ServeState, *, engine=None
                ) -> Tuple[torch.Tensor, ServeState]:
    """Score a W-token verify window in one forward: tokens (B, W) int ->
    (logits (B, W, V), state') with every cache length and ``step``
    advanced by W, in place. ``logits[:, j]`` is what ``serve_step`` gives
    after ``tokens[:, :j + 1]`` fed one at a time. Audio only, as the
    reference: an LM serves one token a step."""
    if cfg.family != "audio":
        raise NotImplementedError(
            "speculative verify windows are wired for the audio family "
            "(the Whisper ladder); LM families still serve_step one token")
    logits, _ = whisper.verify_step(params, cfg, tokens, state.layer_states,
                                    engine=engine)
    state.step.add_(tokens.shape[1])
    return logits, state


def set_slot_lengths(state: ServeState, new_len: torch.Tensor) -> None:
    """The speculative rollback: every per-slot counter (``step`` and each
    layer's cache length) set to ``new_len`` (B,), in place. After a
    verify window advanced them by W, the accepted prefix keeps fewer of
    its entries; the entries past ``new_len`` stay (masked, then
    overwritten by the next window). In the paged layout only ``length``
    (every model shard's) and ``step`` rewind: tables and arenas are left
    as they are (the paged scheduler trims the pages a rejected suffix
    crossed into). No tensor is created or replaced: a captured program
    rereads the counters' storage."""
    ls = state.layer_states
    if whisper.is_paged(ls):
        for s in shard_list(ls):                   # every model shard's
            s.length.copy_(new_len)                # broadcast over layers
    else:
        for kv in ls.self_kv:
            for c in shard_list(kv):
                c.length.copy_(new_len)
    state.step.copy_(new_len)
