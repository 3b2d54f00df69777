"""A program cost counter: the port's counterpart of the reference's
``roofline/hlo_cost.py``.

The reference walks the post-SPMD HLO text of a compiled program. The
port's programs are eager PyTorch, so ``OpCounter`` is a
``TorchDispatchMode`` that watches every ATen operation as it runs, over
fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes,
types and devices, no storage) or over real CPU tensors, and attributes
each to a logical entry of a mesh (one entry without a mesh). For each
entry it counts:

  * FLOPs: the matrix operations by the formulas that
    ``torch.utils.flop_counter`` registers (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, convolutions, scaled dot-product attention); every other
    operation one FLOP per output element, the reference's second-order
    term, except views and the operations that only allocate or copy
    (``_FREE``);
  * bytes: each operation's operand bytes plus its result bytes, the
    HBM-traffic proxy the reference builds from top-scope instructions (in
    eager PyTorch each operation is a launch of its own). Views count
    nothing; an operation that overwrites an operand (``copy_``,
    ``fill_``, ``zero_``) does not read it;
  * collective bytes: the port's collective sites (``sharding/rules.py``'s
    gathers and scatter, ``train/step.py``'s ``reduce_grads``, the summed
    partial outputs of ``models/transformer.py``'s tensor parallelism,
    the expert-parallel MoE's moves of its slots (``models/moe.py``,
    all-to-all), the MoE capacity claim that joins the data shards'
    expert choices (all-gather), the split vocabulary's sums
    (``models/layers.py``'s embedding, ``models/model.py``'s CE:
    all-reduce) and its served logits (``layers.vocab_logits``:
    all-gather)) report themselves
    through ``collective`` into the entry's
    ``CollectiveStats``; with no counter active the call does nothing;
  * live and peak bytes: every storage an operation allocates is charged
    to its entry until the storage dies (``StorageWeakRef``); the peak is
    taken over time. Whenever the live bytes pass the peak, the storages
    charged since the last full sweep are checked for death, and all of
    them once ``SWEEP_EVERY`` operations have run since that sweep (so an
    older storage that died within the last few operations may still be
    counted: the peak errs high by at most those);
  * kernel calls: each hand-written kernel's wrapper is ``priced``: under
    a counter it records the FLOPs and bytes of the launch the card would
    make (its route, as ``chip_smoke.py``'s bounds price it), and the
    plain version's operations inside it (which run for CPU tensors) are
    not counted; over fake tensors, which hold no values, the wrapper's
    checks and empty outputs of its shapes stand in for the plain
    version. The wrapper's own rule is untouched: a CUDA tensor still
    launches the kernel or raises, and without a counter nothing is
    recorded.

Attribution. A logical entry is named by its coordinates, never by a
device index (a ``torch.device`` index is 8 bits, too narrow for 256 or
512 entries, and the dry-run stands every entry on one fake device): the
sharded code says where it runs through ``at(shard=, model=)`` (a data
shard of a mesh training step and a model shard of a split sub-block,
its experts or its vocabulary rows, with the gathers of its slices;
entry = shard x model-size + model, the order of
``Mesh.shard_devices``, row-major for the production meshes) or
``at(entries=)`` (work every listed entry does alike: each replica of a
part updating its own copy). The backward runs after every forward frame
has closed, so each autograd node remembers the coordinates in force when
the forward made it: a frame records the thread's autograd sequence
number where it opens and closes, and an operation run by a node in the
backward (``torch._C._current_autograd_node``) takes the coordinates of
the frame its sequence number fell in, then those of any frame open now.
A forward recomputed under ``torch.utils.checkpoint`` (grad mode on
inside the backward) keeps only the node's data shard: it opens its
model shards' frames again. Calls of ``torch.autograd.grad`` are made
outside every frame.

Not ported: the reference's trip counts (``_trip_count``) scale the body
of an XLA ``while`` loop that its HLO lists once; an eager program runs
every iteration of its loops, so the counter sees each one, and the
scan-slicing adjustments (``_param_slice_bytes``) have no analog either:
an eager slice is a view, and its reader counts the slice's bytes.
"""
from __future__ import annotations

import bisect
import functools
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode, _pop_mode, \
    _push_mode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import CollectiveStats

aten = torch.ops.aten

#: operations that only allocate, fill or copy: no FLOPs (the reference
#: leaves its parameter, constant, copy and bitcast instructions out)
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.zeros,
         aten.zeros_like, aten.ones, aten.ones_like, aten.full,
         aten.full_like, aten.new_empty, aten.new_empty_strided,
         aten.new_zeros, aten.new_ones, aten.new_full, aten.scalar_tensor,
         aten.copy_, aten.clone, aten.fill_, aten.zero_, aten.arange,
         aten.lift_fresh_copy}
#: operations that overwrite their first operand without reading it
_OVERWRITE = {aten.copy_, aten.fill_, aten.zero_}

#: operations between two full sweeps of dead storages, at least, and
#: the young storages that force one
SWEEP_EVERY = 16
YOUNG = 4096

_ACTIVE: Optional["OpCounter"] = None


def active() -> Optional["OpCounter"]:
    """The counter that is counting now, or None."""
    return _ACTIVE


def _next_sequence_nr() -> int:
    """The autograd sequence number the thread's next node will take (a
    throwaway node on a real CPU scalar, outside every dispatch mode)."""
    with torch._C._DisableTorchDispatch(), torch.enable_grad():
        t = torch.zeros((), requires_grad=True)
        return (t * 1).grad_fn._sequence_nr() + 1


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """Whether ``func`` is a composite of other ATen operations (one
    without a formula of its own)."""
    return (func.namespace == "aten"
            and func._overloadpacket not in flop_registry
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the operations run under it, per logical entry of ``mesh``
    (one entry without a mesh): ``flops``, ``bytes``, ``matmul_flops``,
    ``ops``, ``live`` and ``peak`` are arrays over the entries,
    ``collectives`` a ``CollectiveStats`` an entry and ``kernels`` {the
    kernel the card launches: {"calls", "flops", "executed", "bytes",
    "weight_bytes"}: arrays over the entries} (``kernel``). Enter it
    inside a ``FakeTensorMode`` to count a program over fake tensors."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.n = mesh.size if mesh is not None else 1
        self.model = int(mesh.shape.get("model", 1)) if mesh is not None \
            else 1
        n = self.n
        self.flops = np.zeros(n)
        self.matmul_flops = np.zeros(n)
        self.bytes = np.zeros(n)
        self.ops = np.zeros(n, dtype=np.int64)
        self.live = np.zeros(n)
        self.peak = np.zeros(n)
        self.collectives: List[CollectiveStats] = [CollectiveStats()
                                                   for _ in range(n)]
        self.kernels: Dict[str, Dict[str, np.ndarray]] = {}
        self._frames: List[dict] = []
        self._mark_seq: List[int] = [0]
        self._mark_coords: List[dict] = [{}]
        # storages charged since the last full sweep, and the survivors
        # of earlier ones: {storage: (weak ref, bytes, entries)}
        self._young: Dict[int, Tuple[StorageWeakRef, int, object]] = {}
        self._old: Dict[int, Tuple[StorageWeakRef, int, object]] = {}
        self._since_sweep = 0
        self._quiet = 0
        self._prev = None

    # ----- activation -----
    def __enter__(self):
        global _ACTIVE
        self._prev, _ACTIVE = _ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE = self._prev
            self._sweep_all()

    # ----- attribution -----
    def _frame_coords(self, out: Optional[dict] = None) -> dict:
        """``out`` (none by default) updated by the open frames in turn:
        an ``entries`` frame replaces every coordinate, a coordinate frame
        replaces ``entries``."""
        out = dict(out or {})
        for f in self._frames:
            if "entries" in f:
                out = dict(f)
            else:
                out.pop("entries", None)
                out.update(f)
        return out

    def _mark(self) -> None:
        if torch.is_grad_enabled():
            self._mark_seq.append(_next_sequence_nr())
            self._mark_coords.append(self._frame_coords())

    @contextmanager
    def frame(self, **coords):
        self._frames.append(coords)
        self._mark()
        try:
            yield
        finally:
            self._frames.pop()
            self._mark()

    def coords(self) -> dict:
        """The coordinates the next operation is charged to."""
        node = torch._C._current_autograd_node()
        if node is None:
            return self._frame_coords()
        i = bisect.bisect_right(self._mark_seq, node._sequence_nr()) - 1
        base = self._mark_coords[max(i, 0)]
        if torch.is_grad_enabled():
            # a forward recomputed in the backward (remat; the backward's
            # own ops run without grad): its model shards' frames open
            # again, and outside them it runs on the data shard's entry
            base = {k: v for k, v in base.items() if k != "model"}
        return self._frame_coords(base)

    def entries(self):
        """The entry (an int) or entries (an index array) charged now."""
        c = self.coords()
        if "entries" in c:
            return c["entries"]
        e = c.get("shard", 0) * self.model + c.get("model", 0)
        if not 0 <= e < self.n:
            raise IndexError(f"entry {e} ({c}) outside the {self.n} of the "
                             "counter's mesh")
        return e

    # ----- records -----
    def _charge_live(self, tensors, e) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            seen = self._young.get(key) or self._old.get(key)
            if seen is not None and not seen[0].expired():
                continue
            nb = st.nbytes()
            self._young[key] = (StorageWeakRef(st), nb, e)
            self.live[e] += nb
        self._since_sweep += 1
        if np.any(self.live[e] > self.peak[e]):
            self._sweep(self._young)
            if np.any(self.live > self.peak) and (
                    self._since_sweep >= SWEEP_EVERY
                    or len(self._young) > YOUNG):
                self._sweep_all()
            np.maximum(self.peak, self.live, out=self.peak)

    def _sweep(self, tracked: dict) -> None:
        dead = [k for k, (ref, _, _) in tracked.items() if ref.expired()]
        for k in dead:
            _, nb, e = tracked.pop(k)
            self.live[e] -= nb

    def _sweep_all(self) -> None:
        """Every dead storage swept; the young survivors become old."""
        self._sweep(self._young)
        self._sweep(self._old)
        self._old.update(self._young)
        self._young = {}
        self._since_sweep = 0

    def collective(self, op: str, nbytes: int, group: int,
                   what: str = "") -> None:
        e = self.entries()
        for i in np.atleast_1d(e):
            self.collectives[int(i)].add(op, int(nbytes), int(group),
                                         f"{op} {what}")

    def kernel(self, name: str, flops: float, nbytes: float,
               weight_bytes: float = 0.0, executed: Optional[float] = None,
               out=None) -> None:
        """Record one launch of kernel ``name``: the function's ``flops``,
        the ``nbytes`` it moves (``weight_bytes`` of them its matrix
        operand's) and the FLOPs its route executes (``executed``, by
        default ``flops``), which the entry's FLOPs take."""
        e = self.entries()
        executed = flops if executed is None else executed
        rec = self.kernels.get(name)
        if rec is None:
            rec = self.kernels[name] = {
                k: np.zeros(self.n) for k in ("calls", "flops", "executed",
                                              "bytes", "weight_bytes")}
        rec["calls"][e] += 1
        rec["flops"][e] += flops
        rec["executed"][e] += executed
        rec["bytes"][e] += nbytes
        rec["weight_bytes"][e] += weight_bytes
        self.flops[e] += executed
        self.matmul_flops[e] += executed
        self.bytes[e] += nbytes
        self.ops[e] += 1
        if out is not None:
            self._charge_live([t for t in tree_leaves(out)
                               if isinstance(t, torch.Tensor)], e)

    def busiest(self) -> int:
        """The entry with the most FLOPs (ties: the most bytes, then the
        lowest index)."""
        return int(np.lexsort((-np.arange(self.n), self.bytes,
                               self.flops))[-1])

    def kernel_totals(self, entry: Optional[int] = None) -> Dict[str, dict]:
        """{kernel: {"calls", "flops", "executed", "bytes",
        "weight_bytes"}} summed over the entries, or at ``entry``."""
        return {name: {k: float(v.sum() if entry is None else v[entry])
                       for k, v in rec.items()}
                for name, rec in self.kernels.items()}

    # ----- the dispatch -----
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # a composite (einsum, matmul under inference mode) reaches
            # the mode whole: count the operations it is made of
            _push_mode(self)
            try:
                out = func.decompose(*args, **kwargs)
            finally:
                _pop_mode()
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._quiet or func.is_view:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return out
        packet = func._overloadpacket
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        mutable = func._schema.is_mutable
        if not mutable:
            in_keys = {t.untyped_storage()._cdata for t in ins}
            if all(t.untyped_storage()._cdata in in_keys for t in outs):
                return out                  # an alias of an operand
        e = self.entries()
        reads = ins[1:] if packet in _OVERWRITE else ins
        nbytes = sum(_nbytes(t) for t in reads) + sum(_nbytes(t)
                                                      for t in outs)
        formula = flop_registry.get(packet)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out)
            self.matmul_flops[e] += f
        elif packet in _FREE:
            f = 0
        else:
            f = sum(t.numel() for t in outs)
        self.flops[e] += f
        self.bytes[e] += nbytes
        self.ops[e] += 1
        if not mutable:
            self._charge_live(outs, e)
        return out


# ---------------------------------------------------------------------------
# The sites' side of the counter: each a no-op with no counter active
# ---------------------------------------------------------------------------
@contextmanager
def at(**coords):
    """Charge the scope's operations (and, in the backward, those of the
    autograd nodes it makes) to the entry at ``shard=``/``model=``, or to
    every index of ``entries=`` alike."""
    c = _ACTIVE
    if c is None:
        yield
        return
    if "entries" in coords:
        coords["entries"] = np.unique(np.asarray(coords["entries"],
                                                 dtype=np.int64))
    with c.frame(**coords):
        yield


def collective(op: str, nbytes: int, group: int, what: str = "") -> None:
    """Report a collective of the reference's ``op`` name, ``nbytes``
    result bytes over a group of ``group`` entries, at the entries
    charged now."""
    c = _ACTIVE
    if c is not None and not c._quiet and group > 1:
        c.collective(op, nbytes, group, what)


def priced(cost: Callable[..., Optional[tuple]],
           fake: Optional[Callable[..., Any]] = None):
    """Decorate a kernel's wrapper: under a counter, ``cost(*args,
    **kwargs)`` -> (the kernel the card launches, FLOPs, bytes, weight
    bytes, executed FLOPs) is recorded for each call (``OpCounter.kernel``)
    and the operations inside the call are not counted; a None cost
    counts the call's operations as they run. Where every tensor argument
    is a fake tensor, which has no values to compute, ``fake(*args,
    **kwargs)`` (the wrapper's checks, then empty outputs of its shapes
    and types) stands in for the call. Without a counter the wrapper runs
    as it is."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            c = _ACTIVE
            if c is None or c._quiet:
                return fn(*args, **kwargs)
            price = cost(*args, **kwargs)
            if price is None:
                return fn(*args, **kwargs)
            run = fn
            if fake is not None and all(
                    isinstance(t, FakeTensor) for t in tree_leaves(
                        (args, kwargs)) if isinstance(t, torch.Tensor)):
                run = fake
            c._quiet += 1
            try:
                out = run(*args, **kwargs)
            finally:
                c._quiet -= 1
            c.kernel(*price, out=out)
            return out
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# The kernels' prices: the launch the card makes, as chip_smoke.py's
# bounds count it (each input read once, each output written once)
# ---------------------------------------------------------------------------
def _rows_aligned(t: torch.Tensor) -> bool:
    return t.stride(0) * t.element_size() % 16 == 0


def q8_price(kernel: str, x, qs, scales, **_):
    """``q8_matvec``/``q8_matmul``: 2 M N K; the int8 payload and an f32
    scale a block of 32 (1.125 bytes a weight), x in its type, the f32
    output. ``q8_matmul``'s f32 x (or bf16 rows off 16 bytes) runs
    ``q8_split_tc_kernel``, which multiplies three bf16 parts of x: it
    executes three times the function's FLOPs on the tensor cores."""
    m, k = x.shape
    n = qs.shape[0]
    flops = 2.0 * m * n * k
    weight = n * k + n * (k // 32) * 4
    moved = weight + m * k * x.element_size() + m * n * 4
    if kernel == "q8_matvec":
        return "q8_matvec_kernel", flops, moved, weight, flops
    if x.dtype == torch.bfloat16 and _rows_aligned(x):
        return "q8_wgmma_kernel", flops, moved, weight, flops
    return "q8_split_tc_kernel", flops, moved, weight, 3 * flops


def bf16_price(x, w, **_):
    """``bf16_matmul``: 2 M N K; W and x in their types, the f32 output;
    the route by M and the operands (``bf16_matmul``'s docstring)."""
    m, k = x.shape
    n = w.shape[0]
    weight = n * k * w.element_size()
    moved = weight + m * k * x.element_size() + m * n * 4
    if m <= 16:
        route = "gemv_bf16_kernel"
    elif (x.dtype == w.dtype == torch.bfloat16 and _rows_aligned(x)
          and _rows_aligned(w) and k % 8 == 0):
        route = "wgmma_kernel"
    else:
        route = "bf16_cvt_tc_kernel"
    return route, 2.0 * m * n * k, moved, weight, 2.0 * m * n * k


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """The query-key pairs the mask leaves: query i sees keys 0..i."""
    if not causal:
        return sq * sk
    full = min(sq, sk)
    return full * (full + 1) // 2 + max(sq - sk, 0) * sk


def _flash_aligned(*ts) -> bool:
    return all(t.dtype == torch.bfloat16 and t.stride(-1) == 1
               and all(s * 2 % 16 == 0 for s in t.stride()[:2])
               for t in ts)


def flash_fwd_price(q, k, v, *, causal: bool = True,
                    return_lse: bool = False, **_):
    """Two contractions of 2 D FLOPs a query-key pair the mask leaves; q,
    k, v in their type, the f32 output (and logsumexp)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    moved = (_nbytes(q) + _nbytes(k) + _nbytes(v) + bh * sq * d * 4
             + (bh * sq * 4 if return_lse else 0))
    route = ("flash_fwd_mma_kernel" if _flash_aligned(q, k, v)
             else "flash_fwd_kernel")
    flops = 4.0 * bh * d * causal_pairs(sq, sk, causal)
    return route, flops, moved, 0.0, flops


def flash_bwd_price(q, k, v, out, dout, lse, *, causal: bool = True, **_):
    """The function's own five contractions of 2 D FLOPs a pair (the
    bf16 route's hi/lo split of dS is not priced); q, k, v, out, dout and
    lse read once, dq, dk and dv written once."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    moved = (sum(_nbytes(t) for t in (q, k, v, out, dout, lse))
             + _nbytes(q) + 2 * _nbytes(k))
    route = ("flash_bwd_mma" if q.dtype == torch.bfloat16
             else "flash_bwd_simt")
    flops = 10.0 * bh * d * causal_pairs(sq, sk, causal)
    return route, flops, moved, 0.0, flops


def f32_product_price(route: str):
    """``layers._dot_f32``/``_dot_f32_grad``'s forward product where the
    card runs it as ``_F32Product``/``_F32GradProduct`` (16-bit operands
    of one type; the product of an f32 x that holds w's type): 2 M N K,
    the operands in the card's types and the output's. None (counted as
    it runs) for an f32 product."""
    def price(x, w):
        if route == "f32_product" and not (x.dtype == w.dtype
                                           and x.element_size() == 2):
            return None
        if route == "f32_grad_product" and w.element_size() != 2:
            return None
        rows = x.numel() // x.shape[-1]
        n, k = w.shape
        out_size = 4 if route == "f32_product" else w.element_size()
        moved = _nbytes(x) + _nbytes(w) + rows * n * out_size
        flops = 2.0 * rows * n * k
        return route, flops, moved, float(_nbytes(w)), flops
    return price
