"""Atomic, elastic checkpoints of a training state, in the reference's
layout (``repro/train/checkpoint.py``):

  <dir>/step_<N>/manifest.json   leaf paths, shapes, dtypes, step, cursor,
                                 user metadata
  <dir>/step_<N>/data.npz        each leaf's raw bytes as uint8, keyed by
                                 its path with "/" written "__"

  * Atomic: written to ``<dir>/.tmp_step_<N>`` and then ``os.rename``d, so
    a crash mid-save never corrupts the latest complete checkpoint.
  * Bit-exact: every leaf round-trips through its raw bytes (bf16 through
    ``view(torch.uint8)`` and back, with no ``ml_dtypes``).
  * Elastic: a restore takes a template state and loads every leaf onto
    ``device`` (by default the template leaf's); leaves are keyed by their
    path in the tree, not by where they lived. A state stored split over
    a mesh (``sharding.rules.Pieces``) is saved whole, a leaf gathered at
    a time, as the reference's one process writes whole arrays; given a
    mesh and specs (the reference's ``shardings=``), a restore splits
    each leaf onto its owners. So a checkpoint written on any mesh, or
    on none, restores onto any other, bit for bit.

The archive is written a leaf at a time (one ``.npy`` member per leaf,
which ``np.load`` reads back by key), so a save holds two leaves in host
memory at most: a full-width phi3-mini state is 46 GB with f32 moments.
One thread writes a leaf (the zip's CRC and the file write, each in one
call over the whole buffer) while the caller's thread copies the next
one off the device; a load reads the next member while the current one
is copied onto the device. A restore onto a template leaf of the same
type on the same device copies into it in place, so the state is never
held twice on the card.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.sharding import rules

_STEP_RE = re.compile(r"^step_(\d+)$")
_DTYPES = {str(d).split(".")[-1]: d for d in (
    torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int8,
    torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool)}


def _sanitize(s: str) -> str:
    return s.replace("/", "__")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _raw(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a uint8 numpy array (host copy)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()


def _write_member(zf: zipfile.ZipFile, name: str, raw: np.ndarray) -> None:
    """``raw`` as the ``.npy`` member ``name``: its header, then its bytes
    in one write."""
    with zf.open(name, "w", force_zip64=True) as f:
        np.lib.format.write_array_header_1_0(
            f, np.lib.format.header_data_from_array_1_0(raw))
        f.write(raw.data)


def save_checkpoint(ckpt_dir: str, state, *, step: int,
                    cursor_step: int = 0, seed: int = 0,
                    metadata: Optional[Dict[str, Any]] = None,
                    mesh=None, specs=None) -> str:
    """Two-phase atomic save. Returns the final checkpoint path. A state
    split over ``mesh`` by ``specs`` is written whole."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step),
                "cursor": {"step": int(cursor_step), "seed": int(seed)},
                "metadata": metadata or {}, "leaves": []}
    with zipfile.ZipFile(os.path.join(tmp, "data.npz"), "w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf, \
            ThreadPoolExecutor(max_workers=1) as writer:
        pending = None
        for path, leaf in _whole_leaves(state, mesh, specs):
            key = "/".join(path)
            manifest["leaves"].append({"path": key,
                                       "shape": list(leaf.shape),
                                       "dtype": _dtype_name(leaf)})
            raw = _raw(leaf)         # while the previous leaf is written
            if pending is not None:
                pending.result()
            pending = writer.submit(_write_member, zf,
                                    _sanitize(key) + ".npy", raw)
        if pending is not None:
            pending.result()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def _whole_leaves(state, mesh, specs):
    """(path, whole leaf) of every leaf in order; a split leaf gathered
    onto the host when it is reached."""
    if mesh is None:
        yield from tree.leaves_with_path(state)
        return
    flat = tree.leaves_with_path(state, is_leaf=rules.is_pieces)
    for (path, pieces), spec in zip(
            flat, tree.leaves(specs, is_leaf=rules.is_spec), strict=True):
        yield path, rules.gather_leaf(pieces, spec, mesh, "cpu")


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [(int(m.group(1)), name) for name in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(name))]
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


def load_checkpoint(path: str, template, *, device=None, mesh=None,
                    specs=None) -> Tuple[Any, Dict[str, Any]]:
    """Restore onto ``template``'s tree structure (whole leaves, which may
    be on the ``meta`` device): every leaf checked against its shape, then
    loaded onto ``device`` (default: the template leaf's device; a
    template leaf of the same type there is overwritten in place), or,
    given ``mesh`` and ``specs`` (``train_state_specs`` of the template),
    split onto its owners there. Returns (state, manifest)."""
    if mesh is not None:
        spec_leaves = tree.leaves(specs, is_leaf=rules.is_spec)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    leaves = tree.leaves_with_path(template)
    keys = []
    for tpath, tleaf in leaves:     # every leaf checked before any read
        key = "/".join(tpath)
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        got_shape = tuple(by_path[key]["shape"])
        if tuple(tleaf.shape) != got_shape:
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{got_shape} vs template {tuple(tleaf.shape)}")
        keys.append(key)
    out = []
    with np.load(os.path.join(path, "data.npz")) as data, \
            ThreadPoolExecutor(max_workers=1) as reader:
        ahead = [reader.submit(data.__getitem__, _sanitize(k))
                 for k in keys[:1]]
        for i, (key, (_, tleaf)) in enumerate(zip(keys, leaves)):
            raw = torch.from_numpy(ahead.pop().result())
            if i + 1 < len(keys):    # the next member, while this one lands
                ahead.append(reader.submit(data.__getitem__,
                                           _sanitize(keys[i + 1])))
            meta = by_path[key]
            dtype = _DTYPES[meta["dtype"]]
            loaded = raw.view(dtype).reshape(tuple(meta["shape"]))
            if mesh is not None:
                out.append(rules.split_leaf(loaded, spec_leaves[i], mesh))
                continue
            dev = torch.device(device) if device is not None else \
                tleaf.device
            if (tleaf.device == dev and tleaf.dtype == dtype
                    and dev.type != "meta"):
                out.append(tleaf.copy_(loaded))
            else:
                out.append(loaded.to(dev))
    return tree.unflatten_like(template, out), manifest


def remove_old_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    """Bounded disk use: keep the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted((int(m.group(1)), name)
                   for name in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.match(name)))
    for _, name in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
