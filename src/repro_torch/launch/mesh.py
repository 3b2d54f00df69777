"""Mesh definitions for sharded serving and training.

The reference's meshes are JAX device meshes. The port's ``Mesh`` is a
named grid of ``torch.device`` entries, read as the reference reads its
own: ``axis_names`` in order and ``shape[name]`` the axis's size. The
entries are logical devices, and one physical device may stand at several
of them: the CPU tests build four ``cpu`` entries, ``chip_smoke.py`` four
``cuda:0`` entries, so the sharded machinery (placement, per-shard
programs, shard-local admission, the ledger's split) runs with one card.
``physical_devices`` lists the distinct devices behind the entries.
``owners(spec)`` says which part of a leaf laid out by a partition spec
each entry holds (the sharded training state, ``sharding/rules.py``),
``batch_devices()`` lists the data shards' entries of a training step, and
``shard_devices()`` each data shard's entries along "model".

An abstract mesh (``abstract_mesh``, ``make_production_mesh``) has axis
sizes and no devices: the sharding rules need nothing else.

Mesh shapes (the reference's):
  single-pod : (16, 16)    axes ("data", "model")        = 256 devices
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model") = 512 devices
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def physical_device(device) -> torch.device:
    """The physical device behind a logical entry: ``cuda`` with no index
    is the current card; a CPU entry keeps its index, so that entries
    ``cpu:0`` and ``cpu:1`` stand for two devices, as two cards would
    (their tensors share the host's memory)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        return torch.device("cuda", idx)
    return dev


#: the axes a batch's rows split over, outermost first
BATCH_AXES = ("pod", "data")


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry's axis names: () for None."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Mesh:
    """A named grid of logical devices. ``devices`` is an object array of
    ``torch.device`` of shape ``sizes`` (None for an abstract mesh)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} axis sizes for axes "
                             f"{tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(str(a) for a in axis_names)
        self.shape: Dict[str, int] = {a: int(s) for a, s in
                                      zip(self.axis_names, sizes)}
        self.devices = None
        if devices is not None:
            flat = [torch.device(d) for d in devices]
            if len(flat) != self.size:
                raise ValueError(f"mesh {tuple(sizes)} needs {self.size} "
                                 f"devices, got {len(flat)}")
            grid = np.empty(len(flat), dtype=object)
            grid[:] = flat
            self.devices = grid.reshape(tuple(int(s) for s in sizes))

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))

    @property
    def is_abstract(self) -> bool:
        return self.devices is None

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The logical devices along ``axis``, every other axis at index
        0: the data shards' devices of a serving mesh."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        idx = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return list(self.devices[idx].reshape(-1))

    def parts(self, spec) -> Tuple[int, ...]:
        """The number of parts each dim named by ``spec`` (a partition
        spec: one entry a leading dim, None, an axis name or a tuple of
        axis names) is split into: the product of its axes' sizes."""
        return tuple(int(np.prod([self.shape[a] for a in _axes(e)]))
                     for e in spec)

    def owners(self, spec) -> List[Tuple[int, ...]]:
        """For each logical entry, in row-major order, the part of each dim
        of ``spec`` it holds: its row-major index over that dim's axes.
        Entries that differ only along axes the spec does not name hold the
        same parts (replicas)."""
        out = []
        for idx in np.ndindex(*[self.shape[a] for a in self.axis_names]):
            at = dict(zip(self.axis_names, idx))
            parts = []
            for e in spec:
                p = 0
                for a in _axes(e):
                    p = p * self.shape[a] + at[a]
                parts.append(p)
            out.append(tuple(parts))
        return out

    def batch_devices(self) -> List[torch.device]:
        """The logical entries of the data shards of a training step, one
        for each index over the batch axes ("pod", "data") in row-major
        order, every other axis at index 0: each data shard's first
        entry of ``shard_devices``."""
        return [row[0] for row in self.shard_devices()]

    def shard_devices(self) -> List[List[torch.device]]:
        """For each data shard (``batch_devices`` order), its logical
        entries along "model", in model order: the devices its model
        shards compute on (one entry where the mesh has no model axis)."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        names = [a for a in self.axis_names
                 if a in BATCH_AXES or a == "model"]
        grid = self.devices[tuple(slice(None) if a in names else 0
                                  for a in self.axis_names)]
        if "model" in names:
            grid = np.moveaxis(grid, names.index("model"), -1)
        else:
            grid = grid[..., None]
        return [list(row) for row in grid.reshape(-1, grid.shape[-1])]

    @property
    def physical_devices(self) -> List[torch.device]:
        """The distinct physical devices behind the entries, in order of
        first appearance."""
        if self.devices is None:
            return []
        out: List[torch.device] = []
        for d in self.devices.reshape(-1):
            p = physical_device(d)
            if p not in out:
                out.append(p)
        return out

    def __repr__(self) -> str:
        kind = "abstract" if self.is_abstract else \
            f"{len(self.physical_devices)} physical"
        return f"Mesh({self.shape}, {kind})"


def abstract_mesh(shape, axes) -> Mesh:
    """A mesh of axis sizes and no devices, for the sharding rules."""
    return Mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, abstract: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def _visible(devices) -> List[torch.device]:
    """``devices``, or every visible card when None; with no card the
    caller must name the devices (the port never moves to the CPU
    silently)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices= (for "
                           "example [torch.device('cpu')] * 4) to build a "
                           "mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_serve_mesh(data: int = 0, model: int = 1, *,
                    devices=None) -> Mesh:
    """The serving mesh: slot-DP over "data", optional TP over "model".
    ``data=0`` takes every device onto the data axis. ``devices`` (logical
    entries, which may repeat a device) defaults to every visible card. A
    data-only mesh keeps each row's reduction order that of one device,
    which makes the sharded tokens equal the unsharded ones."""
    devs = _visible(devices)
    n = len(devs)
    if data <= 0:
        if n % model:
            raise ValueError(f"model={model} does not divide the "
                             f"{n}-device count; pass data= explicitly "
                             "to serve on a device subset")
        data = max(n // model, 1)
    if data * model > n:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                         f"devices, have {n}")
    return Mesh((data, model), ("data", "model"), devs[:data * model])


def make_smoke_mesh(devices=None) -> Mesh:
    """The smallest nontrivial mesh over ``devices`` (default: every
    visible card): (2, 4) from 8 entries, (2, 2) from 4, else (1, 1)."""
    devs = _visible(devices)
    n = len(devs)
    if n >= 8:
        shape = (2, 4)
    elif n >= 4:
        shape = (2, 2)
    else:
        shape = (1, 1)
    return Mesh(shape, ("data", "model"), devs[:shape[0] * shape[1]])
