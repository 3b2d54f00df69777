"""The training step: loss -> gradients -> (optional int8 error-feedback
compression) -> AdamW, the reference's ``repro/train/step.py``.

``TrainState`` holds the parameters, the AdamW state, the error-feedback
accumulators and a carried seed (an int64 device scalar advanced once a
step) where the reference carries a JAX key. The step runs eagerly:
``loss_fn`` under autograd (its layers and CE chunks under activation
checkpointing by ``cfg.remat``), ``torch.autograd.grad`` over the
parameter leaves, then the optimizer, which updates the parameters and
moments in place (``optim/adamw.py``). With ``microbatches`` K > 1 the
batch is split on dim 0 and the K gradients are summed in
``grad_accum_dtype`` (f32) and divided by K, as the reference's scan does,
so the activations of one microbatch are live at a time.

Over a device mesh (``make_train_step(..., mesh=, specs=)``), the state is
stored split by ``train_state_specs`` (``sharding.rules.split_tree``) and
a step computes the unsharded step's function on one controller:

  * the batch's rows split over the data shards as ``batch_specs`` splits
    dim 0 over ("pod", "data"); where it would split the sequence instead
    (B not a multiple of the shards), the whole batch runs on the first
    shard;
  * each data shard differentiates its own ``detach()`` views of the
    stored pieces, never a whole copy of the parameters: under
    ``ctx.train_shard`` its ``loss_terms`` gathers the leaves outside the
    blocks onto its first device once, and each block gathers its own
    leaves inside its ``remat`` unit (``sharding.rules.gather_block``),
    so that under ``remat="full"`` the backward gathers them again and a
    step holds the gathered leaves of the units being computed only;
  * a block's attention and dense FFN run split over the shard's model
    entries where ``sharding.rules.tp_layout`` says so (heads and d_ff
    dividing the model size): model shard m computes its heads and FFN
    columns on its own entry's device, and the row-parallel products' (o,
    down) partial outputs are summed in f32 in model-shard order on the
    shard's first device, their bias added once after; a MoE layer's
    experts run split as well where E divides the model size (shard m's
    E / M experts over their dispatched slots on its device: expert
    parallelism), and the embedding and the readout's CE where the
    stored vocabulary divides it (each shard over its rows,
    ``models/model.py``); the SSD mixer runs whole on the first device
    (``models/transformer.py``). Each model shard's gradients reach its
    own pieces through the ``.to`` moves and the gathers' ``torch.cat``,
    as autograd differentiates them: nothing here knows the split;
  * each shard forms ``loss_terms`` on its rows under
    ``shard_program(n)`` (a MoE layer's capacity is the whole step's) and
    its routers' statistics; the loss, formed on the first shard's device,
    is the reference's: the CE summed over every shard over the global
    token count (at least 1), plus the load-balance loss of the summed
    statistics (``moe.load_balance_loss``); one ``torch.autograd.grad``
    runs over every shard's views;
  * each part's gradients are summed in f32, in data-shard order, onto
    the device of its first piece, copied to its replicas, and each
    shard's gradients freed as they are summed (a reduce-scatter);
  * the compression and AdamW run on the held parts
    (``optim/compression.py``, ``optim/adamw.py``).

With ``microbatches`` K > 1 each microbatch is split over the shards as
the whole batch would be, its gradients summed in f32 and divided by K.
The shards' programs run through ``sharding/lockstep.py``: in shard
order, one at a time, each until it ends or needs the others' values.
Where a MoE layer's capacity claim spans the data shards
(``moe.spans_shards``: a shard's tokens not a whole number of the step's
dispatch groups, and a group able to drop), they join their expert
choices there, so that the drops are the unsharded step's
(``models/moe.py``); elsewhere each runs to its end in turn.
"""
from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core import tree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import physical_device
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, \
    adamw_update_split
from repro_torch.optim.compression import ef_compress_grads, \
    ef_compress_split, ef_init
from repro_torch.roofline import op_cost
from repro_torch.sharding import ctx, lockstep, rules


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Any              # int8-EF accumulators ({} when compression is off)
    seed: torch.Tensor   # () int64, carried in place of the reference's key

    @property
    def step(self) -> torch.Tensor:
        return self.opt.count


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     opt_cfg: Optional[OptimizerConfig] = None,
                     max_positions: int = 0, *, device="cuda") -> TrainState:
    """Parameters drawn from ``gen`` (on its device) and placed on
    ``device``, zero moments and accumulators, and ``gen``'s seed."""
    opt_cfg = opt_cfg or OptimizerConfig()
    params = model_lib.init_params(gen, cfg, max_positions, device=device)
    dev = tree.leaves(params)[0].device
    return TrainState(
        params=params,
        opt=adamw_init(params, opt_cfg),
        ef=ef_init(params) if opt_cfg.grad_compress == "int8_ef" else {},
        seed=torch.tensor(gen.initial_seed(), dtype=torch.int64,
                          device=dev))


@contextmanager
def _differentiable(leaves):
    """The floating leaves require grad for the scope, and no longer
    after: the state is never left holding a graph."""
    float_leaves = [t for t in leaves if t.is_floating_point()]
    for t in float_leaves:
        t.requires_grad_(True)
    try:
        yield
    finally:
        for t in float_leaves:
            t.requires_grad_(False)


def value_and_grad(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   *, engine=None, attn_chunk: int = 2048):
    """(loss, aux, grads) of ``loss_fn`` at ``params``: the gradients in
    the parameters' types, zeros for a leaf the loss does not reach."""
    leaves = tree.leaves(params)
    with torch.enable_grad(), _differentiable(leaves):
        loss, aux = model_lib.loss_fn(params, cfg, batch, engine=engine,
                                      attn_chunk=attn_chunk)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, tree.unflatten_like(params, grads)


def split_train_state(state: TrainState, mesh
                      ) -> Tuple[TrainState, TrainState]:
    """(the state stored split over ``mesh`` by ``train_state_specs``,
    those specs)."""
    specs = rules.train_state_specs(state, mesh)
    return rules.split_tree(state, specs, mesh), specs


def _shards(batch: Dict[str, torch.Tensor], mesh):
    """[(a data shard's index, its model entries' physical devices, its
    rows)]: dim 0 split evenly where ``batch_specs`` splits it, else the
    whole batch on the first shard."""
    grid = [[physical_device(d) for d in row]
            for row in mesh.shard_devices()]
    specs = rules.batch_specs(batch, mesh)
    split = all(len(sp) and sp[0] is not None for sp in
                tree.leaves(specs, is_leaf=rules.is_spec))
    if not split or len(grid) == 1:
        return [(0, grid[0], slice(None))]
    n = next(iter(batch.values())).shape[0] // len(grid)
    return [(i, devs, slice(i * n, (i + 1) * n))
            for i, devs in enumerate(grid)]


def mesh_value_and_grad(cfg: ModelConfig, params, batch, specs, mesh, *,
                        engine=None, attn_chunk: int = 2048):
    """(loss, aux, grads) of the unsharded ``loss_fn`` at the split
    ``params`` (their specs ``specs``) over ``mesh``'s data shards: the
    gradients f32 ``Pieces`` laid out as the parameters."""
    loss, aux, per_shard = _shard_grads(cfg, params, specs, mesh, batch,
                                        _shards(batch, mesh), engine=engine,
                                        attn_chunk=attn_chunk)
    return loss, aux, reduce_grads(per_shard, params, specs, mesh)


def _shard_grads(cfg: ModelConfig, params, specs, mesh, batch, shards, *,
                 engine, attn_chunk: int):
    """Every shard's loss terms on its rows and devices, over its own
    views of the stored pieces, the loss formed from their sums on the
    first shard's device, one ``autograd.grad`` over every shard's views:
    (loss, aux, each shard's gradients, a list a leaf of one gradient a
    piece, None for a piece that takes none)."""
    dev0 = shards[0][1][0]
    flat = tree.leaves(params, is_leaf=rules.is_pieces)

    def shard(i, devs, rows):
        views = [rules.Pieces(t.detach().requires_grad_(
            t.is_floating_point()) for t in x) for x in flat]
        with moe_lib.router_stats() as st, \
                ctx.train_shard(i, devs, specs, mesh), op_cost.at(shard=i):
            term = model_lib.loss_terms(
                tree.unflatten_like(params, views, is_leaf=rules.is_pieces),
                cfg, {k: v[rows].to(devs[0]) for k, v in batch.items()},
                engine=engine, attn_chunk=attn_chunk)
        return term, st, views

    with torch.enable_grad(), ctx.shard_program(len(shards)):
        bodies = [functools.partial(shard, *sh) for sh in shards]
        # the program cost counter's dispatch mode sees one thread: there
        # the shards run in turn, and a claim that spans them stands in
        # one shard's choices for the others' (``moe._joint_claim``)
        out = (lockstep.run(bodies) if op_cost.active() is None
               else [body() for body in bodies])
        terms, stats, shard_views = (list(x) for x in zip(*out))
        ntok = sum(t[1].to(dev0) for t in terms).clamp(min=1.0)
        ce = sum(t[0].to(dev0) for t in terms) / ntok
        aux = (moe_lib.load_balance_loss(stats, cfg, dev0)
               if cfg.moe is not None else
               torch.zeros((), dtype=torch.float32, device=dev0))
        loss = ce + aux
        got = list(torch.autograd.grad(
            loss, [t for views in shard_views for x in views for t in x
                   if t.requires_grad], allow_unused=True))
    got.reverse()
    per_shard = [[[got.pop() if t.requires_grad else None for t in x]
                  for x in views] for views in shard_views]
    aux = {"ce": ce.detach(), "moe_aux": aux.detach(),
           "ntok": ntok.detach()}
    return loss.detach(), aux, per_shard


def reduce_grads(per_shard, params, specs, mesh):
    """Each part's gradients summed in f32, in data-shard order (within a
    shard, over the pieces of the part it read), onto the device of the
    part's first piece and copied to its replicas; each shard's gradients
    freed once summed: f32 ``Pieces`` laid out as ``params``."""
    grads = []
    for j, (x, sp) in enumerate(zip(
            tree.leaves(params, is_leaf=rules.is_pieces),
            tree.leaves(specs, is_leaf=rules.is_spec))):
        shape = rules.whole_shape(x, sp, mesh)
        lay = rules.leaf_layout(shape, sp, mesh)
        holders = rules.part_entries(shape, sp, mesh)
        over = ("reduce-scatter" if any(a in mesh_lib.BATCH_AXES
                                        for a in _spec_axes(sp))
                else "all-reduce")
        out = [None] * len(x)
        for k0 in lay.firsts():
            dev = lay.devices[k0]
            same = [k for k, p in enumerate(lay.part) if p == lay.part[k0]]
            acc = None
            n = 0
            with op_cost.at(entries=holders[lay.part[k0]]):
                for shard in per_shard:
                    got = False
                    for k in same:
                        g = shard[j][k]
                        if g is None:
                            continue
                        got = True
                        if acc is None:
                            acc = g.to(dev, torch.float32, copy=True)
                        else:
                            acc.add_(g.to(dev))
                    n += got
                if acc is None:
                    acc = torch.zeros(x[k0].shape, dtype=torch.float32,
                                      device=dev)
                op_cost.collective(over, acc.numel() * 4, n, "reduce_grads")
                for k in same:                    # the part's replicas
                    out[k] = acc if k == k0 else acc.to(lay.devices[k],
                                                        copy=True)
        for shard in per_shard:
            shard[j] = None
        grads.append(rules.Pieces(out))
    return tree.unflatten_like(params, grads, is_leaf=rules.is_pieces)


def _spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a partition spec names."""
    return tuple(a for e in spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,)))


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[OptimizerConfig] = None,
                    *, engine=None, attn_chunk: int = 2048,
                    microbatches: int = 1,
                    grad_accum_dtype=torch.float32,
                    mesh=None, specs: Optional[TrainState] = None):
    """Returns ``train_step(state, batch) -> (state', metrics)``; with
    ``mesh`` and the state's ``specs`` (``split_train_state``), the step
    of a state stored split over ``mesh``."""
    opt_cfg = opt_cfg or OptimizerConfig()
    compress = opt_cfg.grad_compress == "int8_ef"
    if mesh is not None:
        return _mesh_train_step(cfg, opt_cfg, mesh, specs, engine=engine,
                                attn_chunk=attn_chunk,
                                microbatches=microbatches,
                                grad_accum_dtype=grad_accum_dtype)

    def grads_of(params, batch):
        def one(mb):
            return value_and_grad(cfg, params, mb, engine=engine,
                                  attn_chunk=attn_chunk)
        if microbatches == 1:
            return one(batch)
        return _accumulate(one, params, batch, microbatches,
                           grad_accum_dtype)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, aux, grads = grads_of(state.params, batch)
        new_ef = state.ef
        if compress:
            grads, new_ef, _ = ef_compress_grads(grads, state.ef)
        params, opt, opt_metrics = adamw_update(grads, state.opt,
                                                state.params, opt_cfg)
        metrics = {"loss": loss.to(torch.float32), **aux, **opt_metrics}
        return TrainState(params, opt, new_ef, state.seed + 1), metrics

    return train_step


def _accumulate(one, params, batch: Dict[str, torch.Tensor], k: int,
                grad_accum_dtype):
    """The reference's scan over ``k`` microbatches (dim 0 of ``batch``
    split evenly): each one's ``one(microbatch) -> (loss, aux, grads)``,
    the gradients summed in ``grad_accum_dtype`` and divided by ``k``, the
    losses averaged (a mean of means)."""
    n = next(iter(batch.values())).shape[0]
    if n % k:
        raise ValueError(f"batch {n} does not split into {k} microbatches")
    size = n // k
    gacc = lsum = asum = None
    for i in range(k):
        loss, aux, g = one({name: x[i * size:(i + 1) * size]
                            for name, x in batch.items()})
        flat = [x.to(grad_accum_dtype) for x in tree.leaves(g)]
        if gacc is None:
            zeros = torch.zeros((), dtype=torch.float32, device=loss.device)
            gacc = [torch.zeros_like(x) for x in flat]
            lsum, asum = zeros, zeros
        gacc = [a + b for a, b in zip(gacc, flat)]
        lsum, asum = lsum + loss, asum + aux["moe_aux"]
    grads = tree.unflatten_like(params, [g / k for g in gacc])
    aux = {"ce": lsum / k - asum / k, "moe_aux": asum / k,
           "ntok": torch.zeros((), dtype=torch.float32, device=lsum.device)}
    return lsum / k, aux, grads


def _mesh_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, mesh,
                     specs: TrainState, *, engine, attn_chunk: int,
                     microbatches: int, grad_accum_dtype):
    if specs is None:
        raise ValueError("a mesh step needs the state's specs "
                         "(split_train_state)")
    compress = opt_cfg.grad_compress == "int8_ef"
    pspecs = specs.params

    def grads_of(params, batch):
        def one(mb):
            return mesh_value_and_grad(cfg, params, mb, pspecs, mesh,
                                       engine=engine, attn_chunk=attn_chunk)
        if microbatches == 1:
            return one(batch)
        return _accumulate(one, params, batch, microbatches,
                           grad_accum_dtype)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, aux, grads = grads_of(state.params, batch)
        if compress:
            grads = ef_compress_split(grads, state.ef, specs.ef, mesh)
        params, opt, opt_metrics = adamw_update_split(
            grads, state.opt, state.params, opt_cfg, specs=specs, mesh=mesh)
        with torch.no_grad():
            for seed in state.seed:
                seed.add_(1)
        metrics = {"loss": loss.to(torch.float32), **aux, **opt_metrics}
        return TrainState(params, opt, state.ef, state.seed), metrics

    return train_step
