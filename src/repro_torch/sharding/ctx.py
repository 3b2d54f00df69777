"""Activation-sharding context, the port's copy of the reference's
``sharding/ctx.py``: model code names the mesh axes of its big activations
without threading a mesh through every call signature.

``activation_sharding(mesh)`` activates the mesh; ``constrain(x, ...)``
resolves one token a dim, divisibility-checked:

    constrain(x, "batch", None, "model", None)

tokens: "batch" -> (pod, data) merged, "seq" -> every non-pod axis that
divides, "model_force" -> the model axis however it divides, an axis name
-> that axis, None -> unconstrained. A token whose axis size does not
divide the dim falls back to None (whisper's 6 heads on a 16-way model
axis), so one call site stays valid for every architecture.

The reference hands the resolved spec to its compiler as a sharding
constraint. The port has no compiler to give a hint to: ``constrain``
returns ``x`` unchanged, still raises the reference's ``ValueError`` on a
rank mismatch, and ``resolve_spec`` returns the spec it would pin.

``shard_program(n)`` is the port's own: while active, the program running
is one of ``n`` data shards of a batch whose rows split evenly over them
(sharded serving runs one captured program a shard, ``serve/``). Code
that must see the whole step reads ``batch_shards()``: the offload engine
plans each linear at the global M (``core/offload.py``), a MoE layer
computes its capacity from the global token count (``models/moe.py``).

``model_shard(m, n)`` is the port's own too: while active, the code
running computes model shard ``m`` of ``n`` of a sub-block split over
"model" (``models.transformer.tensor_parallel``, the split vocabulary's
readout): the offload engine plans each linear at the whole sub-block's
N or K and records it once, from shard 0 (``core/offload.py``).

``lockstep(index, exchange)`` marks the scope's program as data shard
``index`` of a step whose shards run in lockstep (``sharding/lockstep.py``):
``exchange(value)`` hands every shard's value, in shard order, to each,
the port's all-gather. A MoE layer whose capacity claim spans the data
shards joins their expert choices through it (``models/moe.py``).

``train_shard(data_index, model_devices, specs, mesh)`` is the port's own
too: while active, the program running is data shard ``data_index`` of a
mesh training step, whose parameters are the stored pieces
(``sharding.rules.Pieces``) laid out by ``specs``, and whose model shards
run on ``model_devices`` (the mesh entries of that data shard, in model
order). The model code reads it with ``current_train_shard()`` outside a
``remat`` unit and hands it in: a block gathers its own leaves inside the
unit, and computes split over the model shards what
``sharding.rules.tp_layout`` marks as split (``models/transformer.py``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

_STATE = threading.local()


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextmanager
def activation_sharding(mesh):
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def batch_shards() -> int:
    """The number of data shards the running program's batch is one of
    (1 outside ``shard_program``)."""
    return getattr(_STATE, "shards", 1)


@contextmanager
def shard_program(n: int):
    """Mark the scope's program as one of ``n`` equal data shards of its
    batch."""
    prev = batch_shards()
    _STATE.shards = int(n)
    try:
        yield
    finally:
        _STATE.shards = prev


def model_shard() -> Tuple[int, int]:
    """(the model shard the running code computes, the number of model
    shards of its sub-block): (0, 1) outside ``model_shard``."""
    return getattr(_STATE, "model", (0, 1))


@contextmanager
def model_shard_scope(m: int, n: int):
    """Mark the scope's code as model shard ``m`` of ``n``."""
    prev = model_shard()
    _STATE.model = (int(m), int(n))
    try:
        yield
    finally:
        _STATE.model = prev


class Lockstep(NamedTuple):
    """A data shard of a step run in lockstep: its index and the
    exchange (value -> every shard's value, in shard order)."""
    index: int
    exchange: Any


def current_lockstep() -> Optional[Lockstep]:
    return getattr(_STATE, "lockstep", None)


@contextmanager
def lockstep(index: int, exchange):
    prev = current_lockstep()
    _STATE.lockstep = Lockstep(int(index), exchange)
    try:
        yield
    finally:
        _STATE.lockstep = prev


def snapshot() -> dict:
    """This thread's context (every scope above), to re-enter in another
    thread (``restored``)."""
    return dict(vars(_STATE))


@contextmanager
def restored(snap: dict):
    """The scope runs in the context ``snapshot`` took."""
    prev = dict(vars(_STATE))
    vars(_STATE).clear()
    vars(_STATE).update(snap)
    try:
        yield
    finally:
        vars(_STATE).clear()
        vars(_STATE).update(prev)


class TrainShard(NamedTuple):
    """One data shard of a mesh training step: its index, its model
    shards' devices (model order; the first holds the residual stream),
    the parameters' spec tree and the mesh."""
    index: int
    devices: Tuple[Any, ...]
    specs: Any
    mesh: Any


def current_train_shard() -> Optional[TrainShard]:
    """The active ``train_shard``, or None outside one."""
    return getattr(_STATE, "train_shard", None)


@contextmanager
def train_shard(data_index: int, model_devices, specs, mesh):
    """Mark the scope's program as data shard ``data_index`` of a mesh
    training step (``TrainShard``)."""
    prev = current_train_shard()
    _STATE.train_shard = TrainShard(int(data_index), tuple(model_devices),
                                    specs, mesh)
    try:
        yield
    finally:
        _STATE.train_shard = prev


def _resolve(token, dim: int, mesh):
    if token is None:
        return None
    if token == "batch":
        axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        size = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        if size > 1 and dim % size == 0:
            return axes if len(axes) > 1 else axes[0]
        # fall back to the data axis alone (e.g. batch 8 on a 32-way pod+data)
        if "data" in mesh.axis_names and dim % mesh.shape["data"] == 0 \
                and mesh.shape["data"] > 1:
            return "data"
        return None
    if token == "seq":
        # long-context S dim: absorb every non-pod axis that divides
        axes = tuple(a for a in ("data", "model")
                     if a in mesh.axis_names and mesh.shape[a] > 1)
        size = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        if axes and dim % size == 0:
            return axes if len(axes) > 1 else axes[0]
        if "model" in mesh.axis_names and dim % mesh.shape["model"] == 0:
            return "model"
        return None
    if token == "model_force":
        # uneven sharding: the reference's compiler pads the dim to the
        # axis size (Megatron-style head padding, e.g. 40 heads -> 16x3)
        return "model" if "model" in mesh.axis_names else None
    if token in mesh.axis_names:
        return token if dim % mesh.shape[token] == 0 else None
    return None


def batch_shard_size(mesh) -> int:
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def resolve_spec(shape, *tokens, mesh=None) -> Optional[Tuple]:
    """The spec ``constrain`` would pin for a tensor of ``shape`` on
    ``mesh`` (the active one by default): one entry a dim, None where it
    stays unconstrained; None when no mesh is active or nothing resolves.
    Raises ``ValueError`` when the tokens do not match the rank."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    if len(tokens) != len(shape):
        raise ValueError(f"{len(tokens)} tokens for rank-{len(shape)} tensor")
    entries = tuple(_resolve(t, d, mesh) for t, d in zip(tokens, shape))
    return entries if any(e is not None for e in entries) else None


def constrain(x, *tokens):
    """``x`` unchanged: the port has no compiler to hint. Under an active
    mesh the tokens are resolved as the reference resolves them, and a
    rank mismatch raises its ``ValueError``."""
    if current_mesh() is not None:
        resolve_spec(tuple(x.shape), *tokens)
    return x
