"""Mixture-of-experts FFN with capacity-based dispatch (GShard/Switch
style), the port's counterpart of the reference's ``models/moe.py``.

Used by olmoe-1b-7b (64 experts, top-8) and arctic-480b (128 experts,
top-2, plus a dense residual MLP beside them). The formulation is the
reference's: tokens route within groups of ``moe.dispatch_group`` (one
group on ragged shapes); each group gives every expert C capacity slots
(``_capacity``); the (token, choice) pairs claim slots k-major (every
token's first choice before any second choice), then in token order; a
pair past its expert's capacity is dropped (its combine weight is zero).
The experts then run over all (E, C) slots of a group, empty slots
included, so a step streams every expert's weights; the combine sums each
token's kept choices weighted by their renormalised router probabilities.
The expert products are library batched matmuls: the reference's einsums
lie outside any Pallas kernel. Arctic's dense branch goes through the
offload engine (``layers.mlp_apply``).

Precision is the reference's: the router, its softmax, top-k and
renormalisation in f32; the combine weights rounded to x's type; the
expert products in x's type, the SwiGLU (or GELU) in f32 on them, cast
back; the combine summed in f32 and rounded once to x's type.

The routing stays on the device and every shape follows from the token
count alone, so a decode step with MoE layers is captured into a CUDA
graph whole. Where nothing is dropped a row's bits do not depend on the
batch: the router's rows are padded to one shape (``ROUTER_ROWS``), C is
the same for every decode batch up to 51 rows of olmoe or arctic, dispatch
and combine are gathers, and the sums over a row's k choices are
elementwise adds in index order. Where the batch fills an expert's slots
the drops, as the reference's, depend on the other rows. Under sharded
serving and mesh training (``sharding.ctx.shard_program``) C comes from
the whole step's token count, as the reference's one program computes
it, and the claim is the whole step's: where a data shard's tokens are a
whole number of the step's groups, its groups are the step's; where a
group of the step spans shards and can drop (``spans_shards``),
the shards, run in lockstep (``sharding/lockstep.py``), join their
(token, choice) pairs in shard order and each keeps its rows of the
step's claim (``_joint_claim``); where no group can drop, each shard
claims among its own rows, which keeps every choice all the same. A
forward recomputed in the backward replays its forward's claims
(``claims``).

A training step over a mesh forms the load-balance loss of the whole
batch, not a shard's: while ``router_stats()`` collects, each routed
layer adds its statistics (``RouterStats``: the router's probabilities
summed over the tokens, the tokens' top-1 counts, the token count) to
the list it yields, and ``load_balance_loss`` forms the Switch loss from
the statistics summed over the shards, as one program over the whole
batch does. Where ``sharding.rules.tp_layout`` splits a layer's experts
over the data shard's M model shards (expert parallelism), the routing,
the dispatch gather and the combine run on the data shard's first device
as they do whole; shard m's E / M experts run on its own device over
their slots, moved there and back (``expert_parallel``: an all-to-all
each way in the reference's program). A slot belongs to one expert, so
nothing is summed across the shards and the forward is the whole layer's;
the capacity, the claim order and the drops do not change. Arctic's dense
branch then runs as a split dense FFN (``models/transformer.py``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.roofline import op_cost
from repro_torch.sharding import ctx

#: f32 values an expert stack's draw holds at a time (256 MiB): arctic's
#: whole (128, 7168, 4864) stack in f32 would be a 17.8 GB temporary
DRAW_CHUNK_VALUES = 1 << 26
#: the router's rows are padded to a multiple of this before its product
ROUTER_ROWS = 16


def _draw_experts(gen: torch.Generator, shape: Tuple[int, int, int],
                  scale: float, dtype) -> torch.Tensor:
    """An (E, in, out) stack ~ N(0, scale^2) drawn in f32 on the
    generator's device and cast to ``dtype``, a chunk of experts at a
    time."""
    e, a, b = shape
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    step = max(1, DRAW_CHUNK_VALUES // (a * b))
    for i in range(0, e, step):
        n = min(step, e - i)
        out[i:i + n] = (torch.randn((n, a, b), generator=gen,
                                    device=gen.device) * scale).to(dtype)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.bfloat16) -> dict:
    """The reference's layout and scales: ``router`` (E, d) f32 ~ N(0,
    1/d); ``w_up`` and ``w_gate`` (E, d, d_ff) ~ N(0, 1/d); ``w_down`` (E,
    d_ff, d) ~ N(0, 1/d_ff); arctic's ``dense`` MLP. Drawn from ``gen`` on
    its device."""
    moe = cfg.moe
    d, dff, n_exp = cfg.d_model, moe.d_ff, moe.num_experts
    p = {"router": layers.init_linear(gen, d, n_exp, dtype=torch.float32),
         "w_up": _draw_experts(gen, (n_exp, d, dff), d ** -0.5, dtype),
         "w_down": _draw_experts(gen, (n_exp, dff, d), dff ** -0.5, dtype)}
    if cfg.act == "swiglu":
        p["w_gate"] = _draw_experts(gen, (n_exp, d, dff), d ** -0.5, dtype)
    if moe.dense_residual_d_ff:
        p["dense"] = layers.init_mlp(gen, d, moe.dense_residual_d_ff, dtype,
                                     act=cfg.act)
    return p


class RouterStats(NamedTuple):
    """One routed layer's load-balance statistics over a batch: the
    router's probabilities summed over the tokens (E,) f32, with their
    gradient; the tokens' top-1 expert counts (E,) f32; the token count."""
    prob_sum: torch.Tensor
    top1: torch.Tensor
    tokens: int


_COLLECT = threading.local()


@contextmanager
def router_stats():
    """Yields a list to which every layer routed in the scope appends its
    ``RouterStats``, in execution order."""
    prev = getattr(_COLLECT, "out", None)
    _COLLECT.out = out = []
    try:
        yield out
    finally:
        _COLLECT.out = prev


def load_balance_loss(shards: Sequence[List[RouterStats]], cfg: ModelConfig,
                      device) -> torch.Tensor:
    """The Switch load-balance loss of a batch split over data shards,
    summed over its layers as ``apply_decoder_stack`` sums them: each
    layer's statistics added over the shards (in order, on ``device``)
    before its mean probability and top-1 fraction are formed. ``shards``
    holds each shard's ``router_stats`` list."""
    moe = cfg.moe
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for layer in zip(*shards, strict=True):
        probs = sum(st.prob_sum.to(device) for st in layer)
        top1 = sum(st.top1.to(device) for st in layer)
        tokens = sum(st.tokens for st in layer)
        aux = aux + (moe.num_experts * ((probs / tokens) * (top1 / tokens)
                                        ).sum() * moe.load_balance_coef)
    return aux


def _capacity(tokens_per_group: int, moe) -> int:
    cap = int(tokens_per_group * moe.experts_per_token
              * moe.capacity_factor / moe.num_experts)
    return max(cap, moe.experts_per_token)


def router_probs(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Softmax over the experts of the f32 router logits: (..., d) ->
    (..., E) f32. The rows are padded to a multiple of ROUTER_ROWS for the
    product: the library picks its kernel by shape, and at one shape each
    row is summed in one order, whatever the batch beside it."""
    xf = x.float().reshape(-1, x.shape[-1])
    t = xf.shape[0]
    pad = -t % ROUTER_ROWS
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, xf.shape[1]))])
    logits = layers.linear(p["router"], xf)[:t]
    return torch.softmax(logits, dim=-1).reshape(*x.shape[:-1], -1)


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities and their experts, ties to the lower
    index as ``jax.lax.top_k`` breaks them: a stable descending sort."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def _sum_choices(t: torch.Tensor) -> torch.Tensor:
    """The sum over dim -2 (a row's k choices), one elementwise add at a
    time in index order: a reduction kernel's split would follow the row
    count."""
    out = t[..., 0, :]
    for j in range(1, t.shape[-2]):
        out = out + t[..., j, :]
    return out


class Routing(NamedTuple):
    """A group's routing, each (G, Tg, k): the renormalised top-k weights
    (f32), their experts, each choice's slot in its expert's queue, and
    whether that slot lies within the capacity ``cap``."""
    weights: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def route(p: dict, cfg: ModelConfig, x: torch.Tensor
          ) -> Tuple[Routing, torch.Tensor]:
    """x (B, S, d) -> (the grouped routing, the Switch load-balance loss)."""
    moe = cfg.moe
    b, s, _ = x.shape
    n_exp, k = moe.num_experts, moe.experts_per_token
    experts = torch.arange(n_exp, device=x.device)

    probs = router_probs(p, cfg, x)                       # (B, S, E) f32
    topw, topi = _top_k(probs, k)
    topw = topw / _sum_choices(topw[..., None])           # renormalise

    # load-balance auxiliary loss (Switch eq. 4)
    me = probs.reshape(-1, n_exp).mean(0)                 # mean probability
    onehot = (topi[..., 0].reshape(-1, 1) == experts).float()
    ce = onehot.mean(0)
    aux = n_exp * (me * ce).sum() * moe.load_balance_coef
    collect = getattr(_COLLECT, "out", None)
    if collect is not None:
        collect.append(RouterStats(probs.reshape(-1, n_exp).sum(0),
                                   onehot.sum(0), onehot.shape[0]))

    t = b * s
    n = ctx.batch_shards()
    tg_all = _group(t * n, moe)
    cap = _capacity(tg_all, moe)
    log = getattr(_CLAIMS, "log", None)
    if log is not None and log.replaying:
        pos, keep, cap_local = log.next()
        g, tg = pos.shape[:2]
        return Routing(topw.reshape(g, tg, k), topi.reshape(g, tg, k), pos,
                       keep, cap_local), aux
    if spans_shards(cfg, t, n):
        gi, pos, keep, cap_local = _joint_claim(topi, t, n, tg_all, cap,
                                                n_exp)
        g, tg = 1, t
    else:
        # the shard's own groups: the whole step's where t is a whole
        # number of the step's groups, or where no group can drop (a
        # token takes an expert once, so a group of at most C tokens
        # keeps every choice)
        tg = _group(t, moe)
        g = t // tg
        gi = topi.reshape(g, tg, k)
        pos = _claim(gi, experts)
        keep = pos < cap
        cap_local = cap
    if log is not None:
        log.add(pos, keep, cap_local)
    return Routing(topw.reshape(g, tg, k), gi, pos, keep, cap_local), aux


def _group(t: int, moe) -> int:
    """The dispatch group of ``t`` tokens: ``dispatch_group``, or all
    ``t`` where it does not divide them (ragged shapes: one group)."""
    tg = min(moe.dispatch_group, t)
    return t if t % tg else tg


def spans_shards(cfg, t: int, n: int) -> bool:
    """Whether a step of ``n`` data shards of ``t`` tokens (rows) each has
    a MoE layer whose capacity claim spans the shards and can drop
    (``claim_spans_shards``): the shards then claim together, in lockstep
    or as one program."""
    return (cfg.moe is not None and n > 1
            and claim_spans_shards(cfg.moe, t, n))


def claim_spans_shards(moe, t: int, n: int) -> bool:
    """Whether, with ``t`` tokens in each of ``n`` data shards, a group of
    the whole step's claim spans shards and can drop: a shard's tokens are
    not a whole number of the step's groups, and a group holds more
    tokens than an expert's capacity (or the shard's own group does)."""
    tg_all = _group(t * n, moe)
    return (t % tg_all != 0
            and max(tg_all, _group(t, moe)) > _capacity(tg_all, moe))


def _claim(gi: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """Each (token, choice)'s place in its expert's queue in its group, gi
    (G, Tg, k): k-major, so that higher-priority choices claim capacity
    first, then in token order."""
    g, tg, k = gi.shape
    flat = gi.transpose(1, 2).reshape(g, k * tg)
    queue = (flat[..., None] == experts).long().cumsum(1)    # (G, k*Tg, E)
    return (queue.gather(2, flat[..., None])[..., 0] - 1
            ).reshape(g, k, tg).transpose(1, 2)


def _joint_claim(topi: torch.Tensor, t: int, n: int, tg_all: int, cap: int,
                 n_exp: int):
    """The whole step's claim, from data shard i of ``n`` (``t`` tokens
    each, in lockstep: ``sharding.ctx.lockstep``): every shard's (t, k)
    choices joined in shard order (an all-gather of ints), claimed over
    the step's groups of ``tg_all`` as one program claims them, and this
    shard's rows kept. Returns the shard's tokens as one group: (its
    choices (1, t, k), their slots (1, t, k), kept, the slots an expert
    has there): a token of the j-th step group the shard reaches takes
    slot ``j * cap + pos``, so the groups' slots stay apart. Over fake
    tensors (the dry-run's counter, outside a lockstep) the shard's own
    choices stand in for the others', which no value depends on."""
    k = topi.shape[-1]
    mine = topi.reshape(t, k)
    op_cost.collective("all-gather", mine.numel() * mine.element_size() * n,
                       n, "moe claim")
    ls = ctx.current_lockstep()
    if ls is not None:
        index = ls.index
        every = [c.to(mine.device) for c in ls.exchange(mine)]
    elif op_cost.active() is not None:
        index, every = 0, [mine] * n
    else:
        raise RuntimeError(
            "a MoE layer's capacity claim spans the data shards: run them "
            "in lockstep (sharding/lockstep.py)")
    whole = torch.cat(every).reshape(t * n // tg_all, tg_all, k)
    experts = torch.arange(n_exp, device=mine.device)
    pos = _claim(whole, experts).reshape(t * n, k)[index * t:(index + 1) * t]
    keep = pos < cap
    first = index * t // tg_all
    group = torch.arange(index * t, (index + 1) * t,
                         device=mine.device) // tg_all - first
    groups = ((index + 1) * t - 1) // tg_all - first + 1
    pos = pos + (group * cap)[:, None]
    return mine[None], pos[None], keep[None], cap * groups


class ClaimLog:
    """The claims of one ``remat`` unit's forward, in order, which its
    recompute in the backward replays (``claims``)."""

    def __init__(self):
        self.items: list = []
        self.replaying = False
        self._i = 0

    def add(self, *claim) -> None:
        self.items.append(claim)

    def next(self):
        claim = self.items[self._i]
        self._i += 1
        return claim


_CLAIMS = threading.local()


@contextmanager
def claims(log: ClaimLog):
    """The scope's MoE layers record their capacity claims into ``log``,
    or replay them, in order, where ``log`` recorded before: a forward
    recomputed under activation checkpointing reuses its forward's claim,
    which its data shards made together (``models/transformer.py``'s
    ``remat``)."""
    prev = getattr(_CLAIMS, "log", None)
    log.replaying, log._i = bool(log.items), 0
    _CLAIMS.log = log
    try:
        yield
    finally:
        _CLAIMS.log = prev


def _experts(p: dict, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """Every expert over its slots: xe (G, E, C, d) -> (G, E, C, d), in
    xe's type."""
    g, n_exp, c, d = xe.shape
    dt = xe.dtype
    xs = xe.transpose(0, 1).reshape(n_exp, g * c, d)
    up = torch.bmm(xs, p["w_up"].to(dt))
    if cfg.act == "swiglu":
        gate = torch.bmm(xs, p["w_gate"].to(dt))
        h = F.silu(gate.float()) * up.float()
    else:
        h = layers.gelu(up.float())
    ye = torch.bmm(h.to(dt), p["w_down"].to(dt))
    return ye.reshape(n_exp, g, c, d).transpose(0, 1)


def expert_parallel(parts: Sequence[dict], cfg: ModelConfig,
                    xe: torch.Tensor, devices) -> torch.Tensor:
    """``_experts`` split over M model shards: xe (G, E, C, d) ->
    (G, E, C, d) on xe's device. Shard m takes experts m E/M to (m + 1)
    E/M: their slots moved to ``devices[m]``, its slices ``parts[m]`` of
    the expert stacks there, its outputs moved back and joined along E in
    shard order. Each move is reported as an all-to-all, charged to the
    shard's model entry with its products."""
    n = len(parts)
    per = xe.shape[1] // n
    out = []
    for m, (part, dev) in enumerate(zip(parts, devices, strict=True)):
        with op_cost.at(model=m):
            xm = xe[:, m * per:(m + 1) * per].to(dev)
            op_cost.collective("all-to-all", xm.numel() * xm.element_size(),
                               n, "moe dispatch")
            ym = _experts(part, cfg, xm).to(xe.device)
            op_cost.collective("all-to-all", ym.numel() * ym.element_size(),
                               n, "moe combine")
        out.append(ym)
    return torch.cat(out, dim=1)


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, *, engine=None,
            experts: Optional[Sequence[dict]] = None, devices=None,
            dense: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y in x's type, the load-balance loss): grouped
    capacity-based top-k dispatch, every expert over its C slots, the
    combine, and arctic's dense branch through ``engine``. With
    ``experts`` (a model shard's slices of the expert stacks each, on
    ``devices``), the experts run split (``expert_parallel``); with
    ``dense`` (x -> the dense branch's output, as a split dense FFN gives
    it), the dense branch is that."""
    b, s, d = x.shape
    dt = x.dtype
    r, aux = route(p, cfg, x)
    g, tg, k = r.experts.shape
    n_exp, cap = cfg.moe.num_experts, r.cap
    dev = x.device

    # dispatch: slot (e, c) of group g holds token src[g, e, c], an empty
    # slot the zero row tg; dropped choices all land in the spare column
    slot = r.experts * (cap + 1) + torch.where(r.keep, r.pos, cap)
    src = torch.full((g, n_exp * (cap + 1)), tg, dtype=torch.long,
                     device=dev)
    tok = torch.arange(tg, device=dev).view(1, tg, 1).expand(g, tg, k)
    src.scatter_(1, slot.reshape(g, -1), tok.reshape(g, -1))
    src = src.view(g, n_exp, cap + 1)[..., :cap].reshape(g, n_exp * cap, 1)
    xin = torch.cat([x.reshape(g, tg, d), x.new_zeros((g, 1, d))], dim=1)
    xe = xin.gather(1, src.expand(g, n_exp * cap, d)).view(g, n_exp, cap, d)
    if experts is None:
        ye = _experts(p, cfg, xe)
    else:
        ye = expert_parallel(experts, cfg, xe, devices)

    # combine: each token's k slots, weighted in x's type, summed in f32
    grp = torch.arange(g, device=dev).view(g, 1, 1)
    picked = ye[grp, r.experts, torch.where(r.keep, r.pos, 0)]  # (G,Tg,k,d)
    w = (r.weights * r.keep).to(dt)
    y = _sum_choices(w[..., None].float() * picked.float()).to(dt)
    y = y.reshape(b, s, d)
    if dense is not None:
        y = y + dense(x).to(dt)
    elif "dense" in p:             # arctic's always-on dense residual branch
        y = y + layers.mlp_apply(p["dense"], x, cfg.act, engine)
    return y.to(dt), aux


def moe_ffn_dense_oracle(p: dict, cfg: ModelConfig,
                         x: torch.Tensor) -> torch.Tensor:
    """No-drop reference: every expert over every token in f32, weighted
    by its renormalised top-k probability (tests only)."""
    moe = cfg.moe
    probs = router_probs(p, cfg, x)
    topw, topi = _top_k(probs, moe.experts_per_token)
    topw = topw / topw.sum(-1, keepdim=True)
    xf = x.float()
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(moe.num_experts):
        up = xf @ p["w_up"][e].float()
        if cfg.act == "swiglu":
            h = F.silu(xf @ p["w_gate"][e].float()) * up
        else:
            h = layers.gelu(up)
        ye = h @ p["w_down"][e].float()
        w_e = torch.where(topi == e, topw, 0.0).sum(-1)
        y = y + ye * w_e[..., None]
    if "dense" in p:
        y = y + layers.mlp_apply(p["dense"], x, cfg.act).float()
    return y.to(x.dtype)
