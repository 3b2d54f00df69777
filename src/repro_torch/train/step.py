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
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core import tree
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compression import ef_compress_grads, ef_init


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


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[OptimizerConfig] = None,
                    *, engine=None, attn_chunk: int = 2048,
                    microbatches: int = 1,
                    grad_accum_dtype=torch.float32):
    """Returns ``train_step(state, batch) -> (state', metrics)``."""
    opt_cfg = opt_cfg or OptimizerConfig()
    compress = opt_cfg.grad_compress == "int8_ef"

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(cfg, params, batch, engine=engine,
                                  attn_chunk=attn_chunk)
        k = microbatches
        n = next(iter(batch.values())).shape[0]
        if n % k:
            raise ValueError(f"batch {n} does not split into {k} "
                             "microbatches")
        size = n // k
        gacc = lsum = asum = None
        for i in range(k):
            mb = {name: x[i * size:(i + 1) * size]
                  for name, x in batch.items()}
            loss, aux, g = value_and_grad(cfg, params, mb, engine=engine,
                                          attn_chunk=attn_chunk)
            flat = [x.to(grad_accum_dtype) for x in tree.leaves(g)]
            if gacc is None:
                zeros = torch.zeros((), dtype=torch.float32,
                                    device=loss.device)
                gacc = [torch.zeros_like(x) for x in flat]
                lsum, asum = zeros, zeros
            gacc = [a + b for a, b in zip(gacc, flat)]
            lsum, asum = lsum + loss, asum + aux["moe_aux"]
        grads = tree.unflatten_like(params, [g / k for g in gacc])
        aux = {"ce": lsum / k - asum / k, "moe_aux": asum / k,
               "ntok": torch.zeros((), dtype=torch.float32,
                                   device=lsum.device)}
        return lsum / k, aux, grads

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
