"""Sharding rule engine: parameter, batch and cache trees -> partition
specs, the port's copy of the reference's ``sharding/rules.py``.

Strategy (MaxText-style 2D sharding on a fixed mesh):

  * "model" axis   tensor parallelism: attention heads, d_ff, vocabulary,
                   MoE experts (EP), the SSD inner dim.
  * "data" axis    batch DP and FSDP weight sharding: the other matrix dim
                   of every big weight shards here.
  * "pod" axis     pure DP across pods: parameters replicated pod-wise.

Every rule is divisibility-checked against the mesh: a dim that does not
divide falls back down its candidate list (whisper's vocabulary of 51,865
on a 16-way model axis is replicated). Rules are keyed on regexes over the
'/'-joined path of a leaf ('attn/q/w', 'moe/w_up', ...); a Q8_0 weight's
legs ('.../w/qs', '.../w/scales') inherit the dense weight's rule.

A spec ``P`` is a tuple with one entry a dim: None (replicated), an axis
name, or a tuple of axis names; trailing Nones are stripped, as the
reference's ``PartitionSpec`` is built. The port has no compiler to place
arrays from specs: ``place`` puts a tree on a mesh's physical devices by
its serving specs (a leaf split over "model" as ``Slices`` of the parts a
device holds), ``serve_tree`` builds from that one data shard's serving
weights (its split sub-blocks' slices under ``TP_KEY``, as
``gather_block`` gives a training block's), and the serving pools place
their state themselves (``serve/kvcache.py``, ``serve/paging.py``).

A training state over a mesh is stored split by its specs
(``split_tree``): each tensor leaf becomes ``Pieces``, a tuple of the
parts the mesh's logical entries hold, one tensor for each distinct (part,
physical device), so entries that repeat a device share what they hold
alike. ``gather_leaf``/``gather_tree`` put a whole leaf back together on a
device, ``scatter_leaf`` writes a whole value into a leaf's pieces, and
``entry_bytes`` counts what each logical entry holds.

A mesh training step gathers a block's leaves as the block runs
(``gather_block``): ``gather_part`` joins a leaf's parts on one device by
``torch.cat``, which autograd differentiates back to the pieces, either
whole or as one model part (over "data" alone: FSDP). ``tp_layout`` says
which of a block's mixers and FFNs are computed split over "model": an
attention whose q/k/v outputs and o input are split there and whose query
and KV heads both divide the model size, a dense FFN (arctic's MoE dense
branch too) whose up/gate outputs and down input are split there and
whose d_ff divides, and a MoE layer's experts (expert parallelism) where
the expert stacks are split there on their expert dim and the experts
divide the model size. ``vocab_layout`` says whether the embedding and
the readout are computed split over their vocabulary rows. The SSD mixer
is computed whole (what is left of the reference's tensor parallelism:
the mixer's inner dim over "model", and heads that do not divide).
``TP_BLOCKS`` counts the outcomes.

Layout. The port keeps a list of per-layer dicts (``enc_blocks``,
``dec_blocks``, ``stack/blocks``) and a list of per-layer decode states
where the reference stacks the layers on a leading axis. A per-layer
leaf's spec here is the reference's spec of the stacked leaf with that
axis left out: the rule is applied to the leaf's shape behind a layer
axis of size 1, whose entry is then dropped. The templates right-align,
so this changes only a rule-less 1-D leaf, to which the reference's 2-D
fallback applies once it is stacked.

"""
from __future__ import annotations

import collections
import functools
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.roofline import op_cost


class P(tuple):
    """A partition spec: one entry a dim (None, an axis name, or a tuple
    of axis names), as the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# Candidate tokens: each dim gets a list of candidates, first divisible wins.
#   "model"  -> the model axis
#   "fsdp"   -> the data axis (weight sharding within a pod)
#   "batch"  -> (pod, data) combined (activations' batch dim)
#   "expert" -> the model axis (EP), kept distinct for readability
#   None     -> replicated
MODEL, FSDP, BATCH, EXPERT = "model", "fsdp", "batch", "expert"

# (regex over '/'-joined path, trailing-dims candidates, innermost last)
_RULES: Sequence[Tuple[str, Optional[Tuple[Tuple[Optional[str], ...],
                                           ...]]]] = (
    # --- embeddings / readout ---
    (r"embed/table$",        ((MODEL,), (FSDP,))),
    (r"lm_head/w$",          ((MODEL,), (FSDP,))),
    (r"(enc_pos|dec_pos)/table$", ((), (FSDP,))),
    (r"projector/w$",        ((FSDP,), ())),
    (r"frontend/w$",         ((FSDP,), ())),
    # --- attention (w stored (out, in)) ---
    (r"attn/q/w$",           ((MODEL,), (FSDP,))),
    (r"attn/[kv]/w$",        ((MODEL,), (FSDP,))),
    (r"attn/o/w$",           ((FSDP,), (MODEL,))),
    (r"attn/[qkvo]/b$",      ((MODEL,),)),
    # --- dense FFN ---
    (r"(up|gate)/w$",        ((MODEL,), (FSDP,))),
    (r"down/w$",             ((FSDP,), (MODEL,))),
    (r"(up|gate|down)/b$",   ((MODEL,),)),
    # --- MoE (expert-stacked (E, in, out)) ---
    (r"moe/router/w$",       ((), (FSDP,))),
    (r"moe/w_(up|gate)$",    ((EXPERT,), (FSDP,), ())),
    (r"moe/w_down$",         ((EXPERT,), (), (FSDP,))),
    # --- SSD mixer ---
    (r"ssm/in_proj/w$",      ((MODEL,), (FSDP,))),
    (r"ssm/out_proj/w$",     ((FSDP,), (MODEL,))),
    (r"ssm/conv_[wb]$",      None),        # tiny; replicate
    (r"ssm/(A_log|D|dt_bias)$", None),
    # --- norms and everything 1D ---
    (r"norm", None),
)



def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _resolve(token: Optional[str], mesh):
    """Token -> (mesh axes tuple, total size)."""
    if token is None:
        return None, 1
    if token in (MODEL, EXPERT):
        return ("model",), _axis_size(mesh, "model")
    if token == FSDP:
        return ("data",), _axis_size(mesh, "data")
    if token == BATCH:
        axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        size = int(np.prod([_axis_size(mesh, a) for a in axes])) if axes else 1
        return axes or None, size
    raise ValueError(token)


def _dim_entry(candidates, dim: int, mesh):
    """First divisible candidate for one dim. candidates: tuple of tokens."""
    for tok in candidates:
        axes, size = _resolve(tok, mesh)
        if axes is None:
            return None
        if size > 1 and dim % size == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def _strip(entries: List) -> P:
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _spec_from_template(template, shape, mesh) -> P:
    """Right-align the trailing-dim template against ``shape`` (leading
    stacked-layer dims replicate) and divisibility-check each entry."""
    if template is None:
        return P()
    ndim = len(shape)
    t = len(template)
    entries = [None] * (ndim - t) if ndim >= t else []
    tpl = template[-ndim:] if t > ndim else template
    for cand, dim in zip(tpl, shape[ndim - len(tpl):]):
        entries.append(_dim_entry(cand, dim, mesh))
    # a mesh axis may appear at most once per spec: first dim wins
    seen = set()
    for i, e in enumerate(entries):
        axes = e if isinstance(e, tuple) else ((e,) if e else ())
        if any(a in seen for a in axes):
            entries[i] = None
        seen.update(axes)
    return _strip(entries)


_FALLBACK_2D = ((MODEL,), (FSDP,))


def spec_for_path(path_str: str, shape, mesh) -> P:
    """The rule lookup for one leaf. QTensor legs map onto the dense rule."""
    # Q8_0 leaves: '<w-path>/qs' (N, K/32, 32) and '<w-path>/scales' (N, K/32)
    q_m = re.search(r"(.*)/(qs|scales)$", path_str)
    lookup = q_m.group(1) if q_m else path_str
    template = _FALLBACK_2D if len(shape) >= 2 else None
    for pattern, tpl in _RULES:
        if re.search(pattern, lookup):
            template = tpl
            break
    if q_m and template is not None:
        # qs = W with its last dim split (..., K) -> (..., K/32, 32): a
        # replicated intra-block entry keeps every leading rule aligned
        # (right-alignment then puts the dense K rule on the K/32 dim);
        # scales = W with K -> K/32: the dense template applies unchanged
        if q_m.group(2) == "qs":
            template = (*template, ())
    return _spec_from_template(template, shape, mesh)


def _unstacked(spec: P) -> P:
    """A stacked leaf's spec without its leading layer-axis entry."""
    return _strip(list(spec)[1:])


# ---------------------------------------------------------------------------
# Spec trees of parameters and training states (``core.tree`` walks them)
# ---------------------------------------------------------------------------
def _leaf_spec(path: Tuple[str, ...], tree_path: Tuple[str, ...], x,
               mesh) -> P:
    """The spec of the leaf at ``path`` whose parameter-tree path is
    ``tree_path``: a layer's leaf is looked up at its stacked shape and
    loses the layer-axis entry."""
    shape = tuple(getattr(x, "shape", ()))
    if not shape:
        return P()
    if tree_lib.in_layer_list(tree_path):
        return _unstacked(spec_for_path("/".join(path), (1,) + shape, mesh))
    return spec_for_path("/".join(path), shape, mesh)


def param_specs(params, mesh):
    """Spec tree matching ``params`` (a QTensor's legs get theirs)."""
    return tree_lib.map_with_path(lambda p, x: _leaf_spec(p, p, x, mesh), params)


#: the parameter-shaped subtrees of a ``TrainState``
_STATE_TREES = (("params",), ("opt", "mu"), ("opt", "nu"), ("ef",))


def train_state_specs(train_state, mesh):
    """A ``TrainState`` (params, opt {mu, nu, count}, ef, seed) -> specs,
    the reference's ``train_state_specs``: each moment and error leaf takes
    its parameter's rule (the rules match path suffixes), a Q8_0 moment's
    legs theirs; scalars replicate."""
    def leaf(path, x):
        pre = next((p for p in _STATE_TREES if path[:len(p)] == p), ())
        return _leaf_spec(path, path[len(pre):], x, mesh)
    return tree_lib.map_with_path(leaf, train_state)


# ---------------------------------------------------------------------------
# Leaves stored split over a mesh's logical devices
# ---------------------------------------------------------------------------
class Pieces(tuple):
    """A leaf stored split over a mesh by its spec: one tensor for each
    distinct (part, physical device) that the mesh's logical entries hold,
    in the order the entries (row-major) first name them. On a mesh of
    distinct devices that is one tensor an entry; where entries repeat a
    device, replicas of a part there are stored once. A plain tuple, which
    ``core.tree`` walks: ``tree.leaves`` of a split state lists every
    stored tensor once."""


def is_pieces(x) -> bool:
    return isinstance(x, Pieces)


def is_spec(x) -> bool:
    return isinstance(x, P)


class LeafLayout(NamedTuple):
    """Where a leaf of ``shape`` laid out by a spec lives on a mesh: each
    stored piece's region of the whole leaf, physical device and part
    (an index among the distinct parts), and each logical entry's piece."""
    shape: Tuple[int, ...]
    regions: Tuple[Tuple[slice, ...], ...]
    devices: Tuple[torch.device, ...]
    part: Tuple[int, ...]
    entry_piece: Tuple[int, ...]

    def firsts(self) -> List[int]:
        """The first stored piece of each distinct part, in part order."""
        seen: Dict[int, int] = {}
        for k, p in enumerate(self.part):
            seen.setdefault(p, k)
        return [seen[p] for p in sorted(seen)]


def leaf_layout(shape, spec: P, mesh) -> LeafLayout:
    """The layout of a whole leaf of ``shape`` split by ``spec`` over
    ``mesh``'s logical entries."""
    return _layout(tuple(int(d) for d in shape), P(*spec), mesh)


@functools.lru_cache(maxsize=1 << 14)
def _layout(shape: Tuple[int, ...], spec: P, mesh) -> LeafLayout:
    from repro_torch.launch.mesh import physical_device
    parts = mesh.parts(spec)
    for d, n in zip(shape, parts):
        if d % n:
            raise ValueError(f"dim {d} does not split into {n} parts "
                             f"({spec})")
    grid = [int(np.prod(parts[i + 1:])) for i in range(len(parts))]
    regions, devices, part, index = [], [], [], {}
    entry_piece = []
    for dev, own in zip(mesh.devices.reshape(-1), mesh.owners(spec)):
        phys = physical_device(dev)
        flat = sum(o * g for o, g in zip(own, grid))
        if (flat, phys) not in index:
            index[(flat, phys)] = len(regions)
            regions.append(tuple(
                slice(o * (d // n), (o + 1) * (d // n))
                for o, d, n in zip(own, shape, parts)))
            devices.append(phys)
            part.append(flat)
        entry_piece.append(index[(flat, phys)])
    return LeafLayout(shape, tuple(regions), tuple(devices), tuple(part),
                      tuple(entry_piece))


@functools.lru_cache(maxsize=1 << 14)
def piece_entries(shape: Tuple[int, ...], spec: P, mesh
                  ) -> Tuple[np.ndarray, ...]:
    """For each stored piece of a leaf of ``shape`` laid out by ``spec``,
    the logical entries (row-major) that hold it: where the counter of
    ``roofline/op_cost.py`` charges work on the piece."""
    lay = leaf_layout(shape, spec, mesh)
    out: List[List[int]] = [[] for _ in lay.regions]
    for e, k in enumerate(lay.entry_piece):
        out[k].append(e)
    return tuple(np.asarray(x, dtype=np.int64) for x in out)


@functools.lru_cache(maxsize=1 << 14)
def part_entries(shape: Tuple[int, ...], spec: P, mesh
                 ) -> Dict[int, np.ndarray]:
    """{part: the logical entries that hold it, on any device}."""
    lay = leaf_layout(shape, spec, mesh)
    out: Dict[int, List[int]] = {}
    for e, k in enumerate(lay.entry_piece):
        out.setdefault(lay.part[k], []).append(e)
    return {p: np.asarray(x, dtype=np.int64) for p, x in out.items()}


def whole_shape(pieces: Pieces, spec: P, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape: the first piece's, each split dim times its
    number of parts."""
    shape = list(pieces[0].shape)
    for i, n in enumerate(mesh.parts(spec)):
        shape[i] *= n
    return tuple(shape)


def split_leaf(x: torch.Tensor, spec: P, mesh) -> Pieces:
    """``x`` stored split by ``spec``: each piece a contiguous copy of its
    region on its physical device."""
    lay = leaf_layout(x.shape, spec, mesh)
    out = []
    for region, dev in zip(lay.regions, lay.devices):
        piece = torch.empty(tuple(r.stop - r.start for r in region)
                            + tuple(x.shape[len(region):]), dtype=x.dtype,
                            device=dev)
        out.append(piece.copy_(x[region]))
    return Pieces(out)


def gather_leaf(pieces: Pieces, spec: P, mesh, device) -> torch.Tensor:
    """The whole leaf on ``device`` (``gather_part``)."""
    return gather_part(pieces, spec, mesh, device)


def scatter_leaf(whole: torch.Tensor, pieces: Pieces, spec: P,
                 mesh) -> None:
    """Every piece overwritten, in place, by its region of ``whole``."""
    lay = leaf_layout(whole.shape, spec, mesh)
    for piece, region in zip(pieces, lay.regions):
        piece.copy_(whole[region])
    if op_cost.active() is not None:
        op_cost.collective("reduce-scatter",
                           pieces[0].numel() * pieces[0].element_size(),
                           len(set(lay.part)), "scatter_leaf")


def gather_part(pieces: Pieces, spec: P, mesh, device,
                model: Optional[int] = None) -> torch.Tensor:
    """The whole leaf on ``device``, or with ``model=m`` its part m along
    the dim ``spec`` splits over "model" (every other axis gathered): each
    part needed, from a piece on that device where there is one, else from
    the part's first piece, moved there by ``.to`` and joined by
    ``torch.cat`` (``_gather_plan``). Differentiable: the backward hands
    each piece the gradient of its own region."""
    from repro_torch.launch.mesh import physical_device
    device = torch.device(device)
    plan = _gather_plan(whole_shape(pieces, spec, mesh), P(*spec), mesh,
                        physical_device(device), model)

    def join(node):
        if isinstance(node, int):
            return pieces[node].to(device)
        dim, nodes = node
        return torch.cat([join(n) for n in nodes], dim)
    out = join(plan)
    if op_cost.active() is not None:
        op_cost.collective("all-gather", out.numel() * out.element_size(),
                           _plan_parts(plan), "gather_part")
    return out


def _plan_parts(node) -> int:
    """The pieces a ``_gather_plan`` joins."""
    return 1 if isinstance(node, int) else sum(_plan_parts(n)
                                               for n in node[1])


@functools.lru_cache(maxsize=1 << 14)
def _gather_plan(shape: Tuple[int, ...], spec: P, mesh, phys,
                 model: Optional[int]):
    """``gather_part``'s join: a piece's index, or (a dim, the joins of
    its parts along it in order); one part along a dim joins nothing."""
    lay = leaf_layout(shape, spec, mesh)
    parts = mesh.parts(spec)
    mdims = [i for i, e in enumerate(spec) if e == "model"]
    if model is not None and not mdims:
        raise ValueError(f"spec {spec} does not split a dim over 'model'")
    grid = {}
    for k0 in lay.firsts():
        at = tuple(r.start // (d // n)
                   for r, d, n in zip(lay.regions[k0], lay.shape, parts))
        if model is not None and any(at[i] != model for i in mdims):
            continue
        grid[at] = next((j for j, p in enumerate(lay.part)
                         if p == lay.part[k0] and lay.devices[j] == phys),
                        k0)

    def plan(prefix, dim):
        if dim == len(parts):
            return grid[prefix]
        nodes = [plan(prefix + (c,), dim + 1)
                 for c in sorted({a[dim] for a in grid if a[:dim] == prefix})]
        return nodes[0] if len(nodes) == 1 else (dim, nodes)
    return plan((), 0)


# ---------------------------------------------------------------------------
# Tensor-parallel blocks of a mesh training step
# ---------------------------------------------------------------------------
SPLIT = "split"
#: why a block's mixer or FFN runs whole
ONE_SHARD = "one model shard"
HEADS = "heads do not divide the model axis"
D_FF = "d_ff does not divide the model axis"
NOT_SPLIT = "its leaves are not split over 'model'"
EXPERTS = "the experts do not divide the model axis"
VOCAB = "the stored vocabulary does not divide the model axis"
SSD = "the SSD mixer over 'model' is not ported"

ATTENTIONS = ("attn", "self_attn", "cross_attn")
#: the row-parallel linears: input dim split, partial outputs summed,
#: their bias added once after the sum
ROW_PARALLEL = ("o", "down")
#: a MoE layer's expert stacks, (E, in, out), split over "model" on E
EXPERT_LEAVES = ("w_up", "w_gate", "w_down")
#: the layout key of arctic's dense branch beside the experts
MOE_DENSE = "moe/dense"
#: the layout key of the embedding and the readout
VOCAB_KEY = "vocab"

#: blocks computed by mesh training steps: {(sub-block key, SPLIT or the
#: reason it ran whole): count}, one a block a data shard a forward, and
#: the vocabulary's once a data shard a forward
TP_BLOCKS: collections.Counter = collections.Counter()


def _on_model(spec, dim: int) -> bool:
    """Whether ``spec`` splits ``dim`` over "model"; a Q8_0 weight's
    specs (a ``QTensor`` of them) where both legs do."""
    if isinstance(spec, tuple) and hasattr(spec, "_fields"):
        return all(_on_model(s, dim) for s in spec)
    return is_spec(spec) and len(spec) > dim and spec[dim] == "model"


def _split_linears(specs: dict, column, row) -> bool:
    """Whether every leaf of the column-parallel linears is split over
    "model" on dim 0, and every row-parallel weight on dim 1."""
    return (all(_on_model(s, 0) for lin in column if lin in specs
                for s in specs[lin].values())
            and all(_on_model(specs[lin]["w"], 1) for lin in row))


def _outcome(m: int, undivided: Optional[str], split: bool) -> str:
    """``ONE_SHARD`` on one model shard, else ``undivided`` (the reason a
    width does not divide, or None), else ``SPLIT`` where the leaves are
    split over "model", else ``NOT_SPLIT``."""
    if m == 1:
        return ONE_SHARD
    if undivided:
        return undivided
    return SPLIT if split else NOT_SPLIT


def tp_layout(cfg, block_specs: dict, mesh) -> Dict[str, str]:
    """For each mixer and FFN of a block whose leaves' specs are
    ``block_specs`` (keyed as the block's dict: "attn", "self_attn",
    "cross_attn", "ffn", "moe", "ssm"; arctic's dense branch under
    ``MOE_DENSE``): ``SPLIT`` where a mesh step computes it split over
    ``mesh``'s "model" axis, else why it runs whole on the data shard's
    first device."""
    m = _axis_size(mesh, "model")
    out = {}
    for key, sp in block_specs.items():
        if key in ATTENTIONS:
            out[key] = _outcome(
                m, (cfg.num_heads % m or cfg.num_kv_heads % m) and HEADS,
                _split_linears(sp, ("q", "k", "v"), ("o",)))
        elif key == "ffn":
            out[key] = _outcome(m, cfg.d_ff % m and D_FF,
                                _split_linears(sp, ("up", "gate"),
                                               ("down",)))
        elif key == "moe":
            out[key] = _outcome(
                m, cfg.moe.num_experts % m and EXPERTS,
                all(_on_model(sp[n], 0) for n in EXPERT_LEAVES if n in sp))
            if "dense" in sp:
                out[MOE_DENSE] = _outcome(
                    m, cfg.moe.dense_residual_d_ff % m and D_FF,
                    _split_linears(sp["dense"], ("up", "gate"), ("down",)))
        elif key == "ssm":
            out[key] = ONE_SHARD if m == 1 else SSD
    return out


def vocab_layout(cfg, specs: dict, mesh) -> str:
    """``SPLIT`` where a mesh step computes the embedding and the readout
    split over ``mesh``'s "model" axis, each model shard over its rows of
    the stored (padded) vocabulary: the embedding table and any
    ``lm_head`` split there on dim 0 in the parameter specs ``specs``.
    Else why they run whole."""
    m = _axis_size(mesh, "model")
    leaves = [specs["embed"]["table"]] + (
        [specs["lm_head"]["w"]] if "lm_head" in specs else [])
    return _outcome(m, cfg.padded_vocab % m and VOCAB,
                    all(_on_model(s, 0) for s in leaves))


def tp_summary(cfg, specs, mesh) -> Dict[str, int]:
    """{"<sub-block>: <SPLIT or why it runs whole>": its number of layers}
    over every layer list of a parameter spec tree, and
    {"vocab: <outcome>": 1}."""
    counts: collections.Counter = collections.Counter()
    for path in tree_lib.LAYER_LISTS:
        blocks = specs
        for k in path:
            blocks = blocks.get(k, {}) if isinstance(blocks, dict) else {}
        for sp in blocks or ():
            counts.update(f"{k}: {why}"
                          for k, why in tp_layout(cfg, sp, mesh).items())
    counts[f"{VOCAB_KEY}: {vocab_layout(cfg, specs, mesh)}"] += 1
    return dict(counts)


def _gather_whole(sub, specs, mesh, device):
    return tree_lib.unflatten_like(
        sub, [gather_part(x, s, mesh, device)
              for x, s in _zip_specs(sub, specs, is_leaf=is_pieces)],
        is_leaf=is_pieces)


def gather_model_parts(pieces: Pieces, spec: P, mesh, devices) -> list:
    """Model part m of a leaf on ``devices[m]`` for each m
    (``gather_part(..., model=m)``), each charged to model entry m."""
    out = []
    for m, dev in enumerate(devices):
        with op_cost.at(model=m):
            out.append(gather_part(pieces, spec, mesh, dev, model=m))
    return out


def _gather_linears(sub: dict, sp: dict, mesh, devices
                    ) -> Tuple[dict, list]:
    """A split attention's or FFN's linears: (its row-parallel biases,
    whole on ``devices[0]``; one tree of slices a model shard m on
    ``devices[m]``)."""
    whole = {lin: {"b": gather_part(lp["b"], sp[lin]["b"], mesh,
                                    devices[0])}
             for lin, lp in sub.items() if lin in ROW_PARALLEL and "b" in lp}
    parts: list = [{} for _ in devices]
    for lin, lp in sub.items():
        for m in range(len(devices)):
            parts[m][lin] = {}
        for leaf, x in lp.items():
            if lin in ROW_PARALLEL and leaf == "b":
                continue
            for m, t in enumerate(gather_model_parts(x, sp[lin][leaf],
                                                     mesh, devices)):
                parts[m][lin][leaf] = t
    return whole, parts


def _gather_moe(sub: dict, sp: dict, mesh, devices,
                layout: Dict[str, str]) -> Tuple[dict, Optional[list]]:
    """A MoE layer's leaves: (the router and whatever runs whole, on
    ``devices[0]``; None where nothing is split, else one dict a model
    shard m on ``devices[m]``: its E/M experts' slices of the expert
    stacks where ``layout`` splits the experts, and under "dense" its
    slices of arctic's dense branch where ``layout`` splits that)."""
    whole: dict = {}
    parts: list = [{} for _ in devices]
    for name, x in sub.items():
        if name == "dense" and layout.get(MOE_DENSE) == SPLIT:
            whole[name], dense = _gather_linears(x, sp[name], mesh, devices)
            for m, d in enumerate(dense):
                parts[m][name] = d
        elif name in EXPERT_LEAVES and layout.get("moe") == SPLIT:
            for m, t in enumerate(gather_model_parts(x, sp[name], mesh,
                                                     devices)):
                parts[m][name] = t
        else:
            whole[name] = _gather_whole(x, sp[name], mesh, devices[0])
    return whole, (parts if parts[0] else None)


def gather_block(block: dict, specs: dict, mesh, devices,
                 layout: Dict[str, str]) -> Tuple[dict, Dict[str, list]]:
    """A block's stored leaves (``Pieces``, laid out by ``specs``) as one
    data shard computes them, its model shards on ``devices``: (the
    leaves computed on ``devices[0]``, gathered whole; {each sub-block
    ``layout`` splits: one tree a model shard m, its slices on
    ``devices[m]``, gathered over "data" alone and charged to model entry
    m}). A split attention's or FFN's column-parallel leaves and
    row-parallel weights are its slices; its row-parallel biases stay in
    the whole tree, to be added once after the partial outputs' sum. A
    MoE layer's router stays whole; its experts' slices and those of
    arctic's dense branch are split as ``layout`` says
    (``_gather_moe``)."""
    whole, parts = {}, {}
    for key, sub in block.items():
        sp = specs[key]
        if key == "moe":
            whole[key], moe_parts = _gather_moe(sub, sp, mesh, devices,
                                                layout)
            if moe_parts is not None:
                parts[key] = moe_parts
        elif layout.get(key) == SPLIT:
            whole[key], parts[key] = _gather_linears(sub, sp, mesh, devices)
        else:
            whole[key] = _gather_whole(sub, sp, mesh, devices[0])
    return whole, parts


def _zip_specs(tree, specs, is_leaf=None):
    leaves = tree_lib.leaves(tree, is_leaf=is_leaf)
    spec_leaves = tree_lib.leaves(specs, is_leaf=is_spec)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves against "
                         f"{len(spec_leaves)} specs")
    return list(zip(leaves, spec_leaves))


def split_tree(tree, specs, mesh):
    """``tree`` with every tensor leaf stored split by its spec
    (``specs`` matches ``tree``, as ``train_state_specs`` returns it)."""
    return tree_lib.unflatten_like(
        tree, [split_leaf(x, s, mesh) for x, s in _zip_specs(tree, specs)])


def gather_tree(tree, specs, mesh, device):
    """A split tree's whole leaves on ``device``."""
    return tree_lib.unflatten_like(
        tree, [gather_leaf(x, s, mesh, device)
               for x, s in _zip_specs(tree, specs, is_leaf=is_pieces)],
        is_leaf=is_pieces)


def is_split(tree) -> bool:
    """Whether ``tree``'s leaves are stored split (``Pieces``)."""
    return any(is_pieces(x) for x in tree_lib.leaves(tree,
                                                      is_leaf=is_pieces))


def entry_bytes(tree, specs, mesh) -> List[int]:
    """The bytes each logical entry of ``mesh`` (row-major) holds of a
    split tree: for each leaf, the piece it reads."""
    out = [0] * mesh.size
    for pieces, spec in _zip_specs(tree, specs, is_leaf=is_pieces):
        lay = leaf_layout(whole_shape(pieces, spec, mesh), spec, mesh)
        for e, k in enumerate(lay.entry_piece):
            out[e] += pieces[k].numel() * pieces[k].element_size()
    return out


def spec_bytes(tree, specs, mesh) -> int:
    """What each logical entry holds of a whole tree laid out by
    ``specs``: each leaf's bytes over its number of parts."""
    return sum(x.numel() * x.element_size()
               // int(np.prod(mesh.parts(s)))
               for x, s in _zip_specs(tree, specs))


# ---------------------------------------------------------------------------
# Batch / activation / cache specs
# ---------------------------------------------------------------------------
def _batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_specs(batch: dict, mesh):
    """Shard every batch leaf's dim 0 over (pod, data) when divisible;
    otherwise (a batch of 1) shard the sequence dim over data."""
    axes = _batch_axes(mesh)
    bsize = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1

    def leaf(path, x):
        shape = tuple(x.shape)
        if not shape:
            return P()
        if shape[0] % bsize == 0 and bsize > 1:
            return P(axes if len(axes) > 1 else axes[0])
        if len(shape) >= 2 and shape[1] % _axis_size(mesh, "data") == 0:
            return P(None, "data")
        return P()

    return tree_lib.map_with_path(leaf, batch)


def _cache_leaf(ps: str, shape, mesh) -> P:
    """The reference's decode-state rule for one stacked (R, B, ...) leaf
    at path ``ps``."""
    axes = _batch_axes(mesh)
    bsize = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    baxis = axes if len(axes) > 1 else (axes[0] if axes else None)
    msize = _axis_size(mesh, "model")
    dsize = _axis_size(mesh, "data")
    if len(shape) <= 1:
        return P()
    entries: List = [None] * len(shape)
    bdim = 1  # leading dim is the stacked layer dim R
    batch_ok = shape[bdim] % bsize == 0 and bsize > 1
    if batch_ok:
        entries[bdim] = baxis
    leaf_name = ps.rsplit("/", 1)[-1]
    if "conv" in ps:  # (R, B, K, conv_dim)
        if len(shape) >= 4 and shape[-1] % msize == 0:
            entries[-1] = "model"
    elif leaf_name in ("k_scale", "v_scale") and len(shape) == 4:
        # int8-KV scales (R, B, S, Hkv): mirror the payload's S policy
        if shape[3] % msize == 0:
            entries[3] = "model"
        elif batch_ok and shape[2] % msize == 0:
            entries[2] = "model"
        elif not batch_ok:
            s_axes = tuple(a for a, sz in (("data", dsize),
                                           ("model", msize)) if sz > 1)
            sz = int(np.prod([mesh.shape[a] for a in s_axes])) or 1
            if s_axes and shape[2] % sz == 0:
                entries[2] = s_axes if len(s_axes) > 1 else s_axes[0]
    elif len(shape) == 5:
        is_kv = leaf_name in ("k", "v", "k_qs", "v_qs") or "kv" in ps
        if is_kv:  # (R, B, S, Hkv, hd)
            if shape[3] % msize == 0:
                entries[3] = "model"
                if not batch_ok and shape[2] % dsize == 0 and dsize > 1:
                    entries[2] = "data"
            else:
                # S-sharding; B=1 cells put (data, model) both on S
                if batch_ok:
                    s_axes = ("model",)
                else:
                    s_axes = tuple(a for a, sz in (("data", dsize),
                                                   ("model", msize))
                                   if sz > 1)
                sz = int(np.prod([mesh.shape[a] for a in s_axes])) or 1
                if s_axes and shape[2] % sz == 0:
                    entries[2] = s_axes if len(s_axes) > 1 else s_axes[0]
        else:      # ssd state (R, B, H, P, N)
            if shape[2] % msize == 0:
                entries[2] = "model"
    return _strip(entries)


def cache_specs(state, mesh, kv_heads: int, head_dim: int):
    """Decode-state specs. The reference's rule on its stacked (R, B, ...)
    leaves: the batch shards over (pod, data) when divisible; the model
    axis lands on Hkv when it divides, else on S (each model shard owns a
    cache slice); SSM states shard H over model, conv windows their
    channel dim. Every leaf under ``layer_states`` is one layer's (the
    port's list), so its spec is the stacked leaf's with the layer axis
    left out; other leaves (``step``) take the rule as they are."""
    del kv_heads, head_dim            # the reference reads shapes alone

    def leaf(path, x):
        shape = tuple(x.shape)
        ps = "/".join(path).lower()
        if "layer_states" in path:
            return _unstacked(_cache_leaf(ps, (1,) + shape, mesh))
        return _cache_leaf(ps, shape, mesh)

    return tree_lib.map_with_path(leaf, state)


# ---------------------------------------------------------------------------
# Serving specs
# ---------------------------------------------------------------------------
def _strip_axes(spec: P, drop=("data",)) -> P:
    entries = []
    for e in spec:
        axes = e if isinstance(e, tuple) else ((e,) if e is not None else ())
        kept = tuple(a for a in axes if a not in drop)
        entries.append(kept if len(kept) > 1 else
                       (kept[0] if kept else None))
    return _strip(entries)


def serve_param_specs(params, mesh):
    """Serving-weight specs: the training rules with the FSDP ("data")
    axis stripped, so weights are tensor-parallel over "model" where
    divisible and replicated over the slot-DP data axis. FSDP sharding is
    the wrong trade for decode: every layer's weight read would become a
    gather a step, while the slot pool's batch axis is what scales with
    traffic."""
    return _map_specs(_strip_axes, param_specs(params, mesh))


def _map_specs(fn: Callable[[P], Any], specs):
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_map_specs(fn, v) for v in specs))
    return type(specs)(_map_specs(fn, v) for v in specs)


def paged_state_specs(state, mesh):
    """Specs of a paged serve state: the page arenas shard their page axis
    over "data" (pages are the unit of KV memory), the block tables and
    counters the slot axis; nothing splits over "model", as in the
    reference. Structural by leaf name, divisibility-checked per leaf.
    The port's paged state stacks its layers as the reference's does, so
    the specs are the reference's. A state split over "model" (one paged
    state a model shard, its arenas of Hkv / M heads, where the serving
    tree's attention is split: ``attention_split``) gets each shard the
    same specs, so that ``spec_bytes`` counts every shard's arenas."""
    dsize = _axis_size(mesh, "data")

    def leaf(path, x):
        name = path[-1]
        if dsize <= 1:
            return P()
        if name in ("self_k", "self_v", "cross_k", "cross_v"):
            # (R, P, page, Hkv, hd): shard the physical-page axis
            return P(None, "data") if x.shape[1] % dsize == 0 else P()
        if name in ("block_table", "cross_table"):
            # (n_slots, max_pages): shard slots
            return P("data") if x.shape[0] % dsize == 0 else P()
        if name == "length":
            # (R, n_slots)
            return P(None, "data") if x.shape[1] % dsize == 0 else P()
        if name == "step":
            # (n_slots,)
            return P("data") if x.shape[0] % dsize == 0 else P()
        return P()

    return tree_lib.map_with_path(leaf, state)


def mesh_signature(mesh) -> Optional[Tuple[Tuple[str, int], ...]]:
    """Hashable identity of a mesh's (axis, size) layout: the sharding
    component of plan keys and ``PlanEntry.mesh``. A sharded program and
    its unsharded twin at the same shapes never share a plan-cache entry.
    None for ``mesh=None``, so unsharded keys are unchanged."""
    if mesh is None:
        return None
    return tuple((str(a), int(mesh.shape[a])) for a in mesh.axis_names)


class Slices(tuple):
    """A leaf split over "model" as one physical device holds it
    (``place``): entry m is model part m along dim ``dim``, None where
    the device holds no copy of it. Where the device holds every part,
    ``whole`` is the one copy the parts are views of."""
    whole: Optional[torch.Tensor] = None
    dim: int = 0


def _placed_leaf(x) -> bool:
    return isinstance(x, (Slices, torch.Tensor))


def _model_dim(spec: P) -> Optional[int]:
    """The dim ``spec`` splits over "model" (None: replicated). A spec
    naming another axis raises: serving weights split over "model"
    alone (``serve_param_specs``)."""
    dims = [i for i, e in enumerate(spec) if e is not None]
    if not dims:
        return None
    if any(spec[i] != "model" for i in dims) or len(dims) > 1:
        raise NotImplementedError(
            f"placing a leaf split as {spec} is not ported: serving "
            "weights split over 'model' alone (ROADMAP item 14b)")
    return dims[0]


def _place_leaf(x: torch.Tensor, spec: P, mesh, holds: Dict) -> Dict:
    """{physical device: what it holds of ``x``} (``place``)."""
    dim = _model_dim(spec)
    if dim is None:
        return {d: x.to(d) for d in holds}
    n = mesh.shape["model"]
    size = x.shape[dim] // n
    out = {}
    for d, parts in holds.items():
        if len(parts) == n:
            whole = x.to(d)
            sl = Slices(whole.narrow(dim, m * size, size) for m in range(n))
            sl.whole = whole
        else:
            sl = Slices(
                torch.empty(x.narrow(dim, m * size, size).shape,
                            dtype=x.dtype, device=d).copy_(
                                x.narrow(dim, m * size, size))
                if m in parts else None for m in range(n))
        sl.dim = dim
        out[d] = sl
    return out


def place(tree, mesh, specs) -> dict:
    """The tree on the mesh: {physical device: what it holds of ``tree``},
    one entry a distinct physical device. A replicated leaf is whole on
    each (``.to``: no copy on the device it already lies on); a leaf that
    ``specs`` (``serve_param_specs``) splits over "model" is a ``Slices``
    of the model parts the device's logical entries hold: contiguous
    copies of them on distinct devices (1/M of the leaf each), and on a
    device that holds every part (four logical entries of one card), one
    whole copy, the parts views of it. A spec that names another axis
    raises ``NotImplementedError`` (ROADMAP item 14b)."""
    from repro_torch.launch.mesh import physical_device
    holds: Dict = {d: set() for d in mesh.physical_devices}
    for row in mesh.shard_devices():
        for m, e in enumerate(row):
            holds[physical_device(e)].add(m)
    per_dev: Dict = {d: [] for d in holds}
    for x, spec in _zip_specs(tree, specs):
        for d, held in _place_leaf(x, spec, mesh, holds).items():
            per_dev[d].append(held)
    return {d: tree_lib.unflatten_like(tree, leaves)
            for d, leaves in per_dev.items()}


# ---------------------------------------------------------------------------
# A data shard's serving weights over "model"
# ---------------------------------------------------------------------------
#: the key under which a serving block holds its split sub-blocks' slices
TP_KEY = "tp"


class TPParts(NamedTuple):
    """A serving block's split sub-blocks: {sub-block key: one tree a
    model shard m, its slices on ``devices[m]``} (``gather_block``'s
    second half, placed once)."""
    parts: Dict[str, list]
    devices: Tuple[torch.device, ...]


def _whole_of(col: tuple, device) -> torch.Tensor:
    """One leaf whole on ``device`` from what the data shard's model
    devices hold (``col``, in model order): a replica, the whole copy of
    a ``Slices``, or its parts joined there (distinct devices)."""
    x = col[0]
    if not isinstance(x, Slices):
        return x
    if x.whole is not None:
        return x.whole
    parts = [next(c[m] for c in col if c[m] is not None)
             for m in range(len(x))]
    return torch.cat([t.to(device) for t in parts], x.dim)


def _part_of(col: tuple, m: int) -> torch.Tensor:
    """Model part m of a leaf, on model device m (a replica where the
    leaf is not split)."""
    x = col[m]
    return x[m] if isinstance(x, Slices) else x


def _rebuild(trees: list, fn) -> Any:
    """``trees[0]``'s structure, each leaf ``fn`` of the leaves at its
    place in every tree of ``trees`` (one a model device)."""
    cols = list(zip(*(tree_lib.leaves(t, is_leaf=_placed_leaf)
                      for t in trees)))
    return tree_lib.unflatten_like(trees[0], [fn(c) for c in cols],
                                   is_leaf=_placed_leaf)


def _serve_linears(subs: list, devices) -> Tuple[dict, list]:
    """A split attention's or FFN's linears (``_gather_linears``): (its
    row-parallel biases whole on ``devices[0]``; one tree a model shard
    m of its slices on ``devices[m]``)."""
    whole = {lin: {"b": _whole_of(tuple(s[lin]["b"] for s in subs),
                                  devices[0])}
             for lin, lp in subs[0].items()
             if lin in ROW_PARALLEL and "b" in lp}
    parts = []
    for m in range(len(devices)):
        parts.append({lin: {leaf: _rebuild([s[lin][leaf] for s in subs],
                                           lambda c, m=m: _part_of(c, m))
                            for leaf in lp
                            if not (lin in ROW_PARALLEL and leaf == "b")}
                      for lin, lp in subs[0].items()})
    return whole, parts


def _serve_block(cfg, blocks: list, specs: dict, mesh, devices) -> dict:
    """A serving block of one data shard, from its placement on each
    model device (``blocks``, in model order): whole on ``devices[0]``
    what ``tp_layout`` runs whole, and the split sub-blocks' slices under
    ``TP_KEY``, as ``gather_block`` gives a training block."""
    layout = tp_layout(cfg, specs, mesh)
    whole, parts = {}, {}
    for key in blocks[0]:
        subs = [b[key] for b in blocks]
        if key == "moe":
            w, p = {}, [{} for _ in devices]
            for name in subs[0]:
                ss = [x[name] for x in subs]
                if name == "dense" and layout.get(MOE_DENSE) == SPLIT:
                    w[name], dense = _serve_linears(ss, devices)
                    for m, d in enumerate(dense):
                        p[m][name] = d
                elif name in EXPERT_LEAVES and layout.get("moe") == SPLIT:
                    for m in range(len(devices)):
                        p[m][name] = _rebuild(
                            ss, lambda c, m=m: _part_of(c, m))
                else:
                    w[name] = _rebuild(ss, lambda c: _whole_of(c,
                                                               devices[0]))
            whole[key] = w
            if p[0]:
                parts[key] = p
        elif layout.get(key) == SPLIT:
            whole[key], parts[key] = _serve_linears(subs, devices)
        else:
            whole[key] = _rebuild(subs, lambda c: _whole_of(c, devices[0]))
    if parts:
        whole[TP_KEY] = TPParts(parts, tuple(devices))
    return whole


def attention_split(tree) -> bool:
    """Whether a serving tree's attention runs split over "model" (its
    KV caches, cross K/V and page arenas then split by their heads):
    every attention block alike, since they share their widths."""
    for path in tree_lib.LAYER_LISTS:
        blocks = tree
        for k in path:
            blocks = blocks.get(k, {}) if isinstance(blocks, dict) else {}
        for b in blocks or ():
            tp = b.get(TP_KEY)
            if tp is not None and any(k in ATTENTIONS for k in tp.parts):
                return True
    return False


def serve_tree(cfg, placed: dict, specs, mesh, devices,
               vocab_shards: Callable[[list, tuple], Any]):
    """The serving weights of the data shard whose model shards run on
    ``devices`` (physical, in model order), from ``place``'s ``placed``:
    each block as ``_serve_block`` builds it, the vocabulary leaves
    (embedding table, ``lm_head``) as ``vocab_shards(parts, devices)``
    where ``vocab_layout`` splits them, every other leaf whole on
    ``devices[0]``."""
    split_vocab = vocab_layout(cfg, specs, mesh) == SPLIT

    def walk(trees, sp, path):
        if path in tree_lib.LAYER_LISTS:
            return [_serve_block(cfg, list(bs), bsp, mesh, devices)
                    for bs, bsp in zip(zip(*trees), sp)]
        if split_vocab and path in (("embed", "table"), ("lm_head", "w")):
            return vocab_shards(
                [_rebuild(trees, lambda c, m=m: _part_of(c, m))
                 for m in range(len(devices))], tuple(devices))
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees], sp[k], path + (k,))
                    for k in trees[0]}
        return _rebuild(trees, lambda c: _whole_of(c, devices[0]))
    return walk([placed[d] for d in devices], specs, ())


def _spec_leaves(specs) -> List[P]:
    if isinstance(specs, P):
        return [specs]
    vals = specs.values() if isinstance(specs, dict) else specs
    return [s for v in vals for s in _spec_leaves(v)]
