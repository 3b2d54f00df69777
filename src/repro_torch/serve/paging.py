"""Paged KV pool: prefix sharing, preemption and admission control.

The contiguous ``SlotKVPool`` commits ``n_slots x max_len`` self-KV and
``n_slots x n_frames`` cross-KV up front: short requests pay for the
longest, identical utterances duplicate their cross-KV whole (at 1500
frames that is 9.2 MB an utterance for whisper-tiny against 24.6 KB for
a self page of 4 positions), and the scheduler never admits more requests
than slots. This module keeps all KV in ONE page arena per kind (self,
cross) of fixed shape, each slot reaching its pages through a row of an
int32 block table that the decode step gathers through
(``attention.PagedKVCache``): every admission, eviction and preemption is
a host-side table edit plus at most one splice, and the captured slot
step sees one set of tensors forever.

  ``PageAllocator``   refcounted physical pages, on the host. Page 0 is
                      the trash page that free slots write and read
                      through.
  ``PagedKVPool``     the two arenas, the block tables and the
                      allocators. Identical padded utterances hash to the
                      same cross page list (whole-utterance identity:
                      whisper's encoder is bidirectional, so a partial mel
                      prefix fixes no cross-KV prefix); self pages carry
                      refcounts and copy-on-write for token-prefix sharing.
  ``PagedScheduler``  the continuous-batching scheduler with admission
                      against pages instead of slots: logical slots
                      oversubscribe the arena, a pass before each step
                      allocates the pages that writes cross into
                      (copy-on-write first), and exhaustion preempts the
                      slot losing the fewest pages. A preempted request is
                      recomputed: its prefill runs again and its tokens
                      are fed one at a time through the batch-1 decode
                      step (greedy decode is deterministic, so the replay
                      is token-exact), its time and plan commits
                      attributed to it.

On a CUDA device the pool's tensors are allocated once and every splice,
attach, copy-on-write and table upload writes into them in place, so the
scheduler's slot step, captured into a CUDA graph at the pool's first
admission (while every table row points at the trash page), reads the
current tables on every replay. A preempted request's replay runs the
graph of ``transcribe``'s batch-1 step over the engine's static prefill
buffers, captured with the batch-1 prefill graph when the pool is first
used, before any request owns those buffers.

``PagedKVPool.trim_self_pages`` is the paged half of the speculative
rollback (``serve/speculative.py``).

Telemetry (the engine's, handed to the pool as ``pool.telemetry``): a
``cow_split`` instant per copy-on-write; on admission a ``prefix_hit``
instant and an ``attach`` ledger span (zero FLOPs: no linear runs) or a
``prefill`` ledger span; a ``replay`` ledger span and instant per
recomputed request; a ``preempt`` instant that closes the request's
``decode`` phase and reopens ``queued``; and the page gauges by kind
(self, cross), set when the allocators' host-side counts change. Not
ported from the reference: the serving mesh (one shard).
"""
from __future__ import annotations

import hashlib
import time
from bisect import insort
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.model import ServeState
from repro_torch.serve.engine import ServeEngine, _sync
from repro_torch.serve.scheduler import (
    ContinuousBatchingScheduler, TokenEvent, _ActiveSlot, _QueuedRequest)


class PagesExhausted(RuntimeError):
    """Arena out of free pages: the scheduler's cue to preempt."""


class PageAllocator:
    """Refcounted physical-page allocator, on the host.

    The first ``reserve`` pages are never handed out: page 0 is the trash
    page that every free slot's table row points back to, so garbage rows
    of the fixed-shape batch write into memory nobody owns. ``n_shards``
    partitions the allocatable pages into contiguous ranges; allocation
    takes the preferred shard when it has a free page, else the shard with
    the most free pages (ties: the lowest), and the lowest page within it,
    so a sequence of operations always allocates the same pages.

    Invariants: ``alloc`` never returns a page whose refcount is above 0;
    free plus allocated is always the allocatable arena; a ``release`` to
    refcount 0 returns the page to the free list.
    """

    def __init__(self, n_pages: int, n_shards: int = 1, reserve: int = 1):
        if n_pages <= reserve:
            raise ValueError(f"arena of {n_pages} pages leaves nothing to "
                             f"allocate past the {reserve} reserved")
        if n_shards < 1 or n_pages % n_shards:
            n_shards = 1
        self.n_pages = n_pages
        self.reserve = reserve
        self.n_shards = n_shards
        self._shard_size = n_pages // n_shards
        self.refcount = np.zeros(n_pages, np.int64)
        self._free: List[List[int]] = [
            [p for p in range(s * self._shard_size,
                              (s + 1) * self._shard_size) if p >= reserve]
            for s in range(n_shards)]
        self._n_free = n_pages - reserve

    @property
    def n_allocatable(self) -> int:
        return self.n_pages - self.reserve

    @property
    def n_free(self) -> int:
        return self._n_free

    @property
    def n_allocated(self) -> int:
        return self.n_allocatable - self._n_free

    def page_shard(self, page: int) -> int:
        return page // self._shard_size

    def can_alloc(self, n: int) -> bool:
        return self._n_free >= n

    def alloc(self, prefer: Optional[int] = None) -> int:
        """Claim a free page at refcount 1; raises ``PagesExhausted`` when
        the arena is dry (it never grows: the shapes are fixed)."""
        if self._n_free == 0:
            raise PagesExhausted(f"all {self.n_allocatable} pages allocated")
        if prefer is not None and self._free[prefer % self.n_shards]:
            shard = prefer % self.n_shards
        else:
            shard = max(range(self.n_shards),
                        key=lambda s: (len(self._free[s]), -s))
        page = self._free[shard].pop(0)
        if self.refcount[page]:
            raise RuntimeError(f"free list held live page {page}")
        self.refcount[page] = 1
        self._n_free -= 1
        return page

    def retain(self, page: int) -> None:
        """Add a reference (prefix sharing, page aliasing)."""
        if self.refcount[page] <= 0:
            raise ValueError(f"retain of unallocated page {page}")
        self.refcount[page] += 1

    def release(self, page: int) -> bool:
        """Drop a reference; at refcount 0 the page returns to its shard's
        free list at once (an evicted request's pages can admit the queue
        head in the same pass). Returns True when the page was freed."""
        if self.refcount[page] <= 0:
            raise ValueError(f"release of unallocated page {page}")
        self.refcount[page] -= 1
        if self.refcount[page]:
            return False
        insort(self._free[self.page_shard(page)], page)
        self._n_free += 1
        return True


# ---------------------------------------------------------------------------
# Arena ops: in-place device copies at page indices the host knows
# ---------------------------------------------------------------------------
def _write_pages(arena: torch.Tensor, rows: torch.Tensor,
                 table_row) -> None:
    """Write ``rows`` (R, n * page, ...) into ``arena`` (R, P, page, ...)
    page by page, logical page lp to physical page ``table_row[lp]``, in
    place. Where two logical pages map to one physical page (unallocated
    ones all map to the trash page) the later wins, as the reference's
    writes in order."""
    last = {int(p): lp for lp, p in enumerate(table_row)}
    phys = torch.tensor(list(last), device=arena.device)
    lps = torch.tensor(list(last.values()), device=arena.device)
    pages = rows.reshape(arena.shape[0], len(table_row), *arena.shape[2:])
    arena[:, phys] = pages[:, lps].to(arena.dtype)


def paged_insert(state: ServeState, slot: int, bt_row, ct_row,
                 req: ServeState, *, write_cross: bool) -> None:
    """Splice a batch-1 contiguous prefill or replay state into the
    arenas at ``slot``'s pages, in place. The self-KV is copied in
    page-sized chunks of the request's cache into ``bt_row``'s physical
    pages (logical pages past the allocation point at the trash page,
    which absorbs them), the tail page zero-padded; ``write_cross`` gates
    the cross-KV copy (False on a prefix-share hit, whose pages already
    hold it). The slot's lengths take the request's first-layer length and
    its step the request's. ``bt_row``/``ct_row`` are host integers."""
    ls, wd = state.layer_states, req.layer_states
    ps = ls.self_k.shape[2]
    s_req = wd.self_kv[0].k.shape[1]
    n = min(len(bt_row), -(-s_req // ps))
    for arena, parts in ((ls.self_k, [kv.k for kv in wd.self_kv]),
                         (ls.self_v, [kv.v for kv in wd.self_kv])):
        rows = torch.stack([t[0] for t in parts])       # (R, S, Hkv, hd)
        if n * ps > s_req:
            rows = torch.cat([rows, rows.new_zeros(
                (rows.shape[0], n * ps - s_req, *rows.shape[2:]))], dim=1)
        _write_pages(arena, rows[:, :n * ps], bt_row[:n])
    if write_cross:
        for arena, parts in ((ls.cross_k, [k for k, _ in wd.cross_kv]),
                             (ls.cross_v, [v for _, v in wd.cross_kv])):
            _write_pages(arena, torch.stack([t[0] for t in parts]), ct_row)
    ls.length[:, slot] = wd.self_kv[0].length.reshape(())
    state.step[slot] = req.step.reshape(())


def paged_attach(state: ServeState, slot: int) -> None:
    """Zero ``slot``'s lengths and step: the whole device-side cost of
    admitting a prefix-share hit (its cross pages already hold the right
    values; its first self page starts empty)."""
    state.layer_states.length[:, slot] = 0
    state.step[slot] = 0


def paged_copy_page(state: ServeState, src: int, dst: int) -> None:
    """Copy-on-write split: self-KV physical page ``src`` copied into
    ``dst`` (all layers, K and V), so that the writer's table can point at
    a private page while every other holder keeps reading ``src``."""
    ls = state.layer_states
    for arena in (ls.self_k, ls.self_v):
        arena[:, dst] = arena[:, src]


def _mel_digest(payload: np.ndarray) -> str:
    """Identity hash of one padded utterance, the prefix-sharing key: the
    reference's blake2b of the padded float32 payload."""
    return hashlib.blake2b(np.ascontiguousarray(payload).tobytes(),
                           digest_size=16).hexdigest()


class PagedKVPool:
    """The paged arenas, block tables and their host-side bookkeeping.

    Self-KV arena: ``(R, n_pages, page_size, Hkv, hd)`` x2, one block
    table row of ``max_pages = ceil(max_len / page_size)`` logical pages a
    slot. Cross-KV arena: ``(R, n_cross_pages, cross_page_size, ...)`` x2,
    ``n_frames / cross_page_size`` pages per distinct utterance, shared
    by content hash. The block tables are kept on the host (numpy) and
    ``sync()`` copies them into the state's device tables, in place, once
    before a decode step when they changed, so that evictions and
    preemptions are host edits. The state (``model.zeros_paged_state``) is
    built once on ``device`` (which the caller names) and never replaced.
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 n_frames: Optional[int] = None, *, page_size: int = 8,
                 n_pages: Optional[int] = None,
                 cross_page_size: Optional[int] = None,
                 n_cross_pages: Optional[int] = None, device):
        if n_frames is None:
            raise ValueError("audio paged pool needs a fixed n_frames "
                             "capacity (utterances are padded to it)")
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size}")
        cross_page_size = (n_frames if cross_page_size is None
                           else cross_page_size)
        if n_frames % cross_page_size:
            # a ragged tail page would shift the gathered cross positions
            raise ValueError(f"cross_page_size {cross_page_size} must "
                             f"divide n_frames {n_frames}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.n_frames = n_frames
        self.page_size = page_size
        self.cross_page_size = cross_page_size
        self.max_pages = -(-max_len // page_size)
        self.n_cross_per_req = n_frames // cross_page_size
        if n_pages is None:
            n_pages = 1 + n_slots * self.max_pages     # no oversubscription
        if n_cross_pages is None:
            n_cross_pages = 1 + n_slots * self.n_cross_per_req
        self.n_pages = n_pages
        self.n_cross_pages = n_cross_pages
        self.state: ServeState = model_lib.zeros_paged_state(
            cfg, n_slots, max_pages=self.max_pages, n_pages=n_pages,
            page_size=page_size, n_cross_per_req=self.n_cross_per_req,
            n_cross_pages=n_cross_pages, cross_page_size=cross_page_size,
            device=device)
        ls = self.state.layer_states
        self.page_bytes = 2 * ls.self_k[:, 0].numel() * \
            ls.self_k.element_size()
        self.cross_page_bytes = 2 * ls.cross_k[:, 0].numel() * \
            ls.cross_k.element_size()

        self._slots = PageAllocator(n_slots, reserve=0)
        self.self_alloc = PageAllocator(n_pages, reserve=1)
        self.cross_alloc = PageAllocator(n_cross_pages, reserve=1)
        self._bt = np.zeros((n_slots, self.max_pages), np.int32)
        self._ct = np.zeros((n_slots, self.n_cross_per_req), np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._slot_cross: List[Optional[Tuple[str, List[int]]]] = (
            [None] * n_slots)
        self._shared: Dict[str, List[int]] = {}
        self._dirty = False
        # the owning scheduler hands down its nullable telemetry, so that
        # page-level events (cow_split) record
        self.telemetry = None

    @property
    def plan_geometry(self) -> Tuple[int, int, int, int]:
        """The page-shape part of this pool's plan keys: paged and
        contiguous programs never share a ``PlanCache`` entry."""
        return (self.page_size, self.n_pages, self.cross_page_size,
                self.n_cross_pages)

    # -- slot free list (the lowest free slot first) ---------------------
    @property
    def n_free(self) -> int:
        return self._slots.n_free

    def acquire(self) -> int:
        return self._slots.alloc()

    # -- admission control -------------------------------------------------
    def has_shared(self, digest: str) -> bool:
        return digest in self._shared

    def can_alloc(self, n_self: int, n_cross: int) -> bool:
        return (self.self_alloc.can_alloc(n_self)
                and self.cross_alloc.can_alloc(n_cross))

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages[slot])

    def alloc_self_page(self, slot: int) -> int:
        """Append ``slot``'s next logical page. Raises ``PagesExhausted``
        when the arena is dry."""
        page = self.self_alloc.alloc()
        lp = len(self._slot_pages[slot])
        if lp >= self.max_pages:
            self.self_alloc.release(page)
            raise ValueError(f"slot {slot} already at max_pages")
        self._slot_pages[slot].append(page)
        self._bt[slot, lp] = page
        self._dirty = True
        return page

    def alias_self_page(self, dst: int, src: int, lp: int) -> int:
        """Map ``dst``'s next logical page onto ``src``'s physical page at
        ``lp`` (refcount + 1): the token-prefix sharing hook; a write
        splits it first (``ensure_private``)."""
        if len(self._slot_pages[dst]) != lp:
            raise ValueError("alias must extend dst's table contiguously")
        page = self._slot_pages[src][lp]
        self.self_alloc.retain(page)
        self._slot_pages[dst].append(page)
        self._bt[dst, lp] = page
        self._dirty = True
        return page

    def ensure_private(self, slot: int, lp: int) -> int:
        """Copy-on-write: if ``slot``'s page at logical index ``lp`` is
        shared (refcount above 1), copy it into a fresh page and point only
        this slot's table at the copy; the shared page is never written.
        A private page is returned as it is."""
        page = self._slot_pages[slot][lp]
        if self.self_alloc.refcount[page] <= 1:
            return page
        fresh = self.self_alloc.alloc()
        paged_copy_page(self.state, page, fresh)
        self.self_alloc.release(page)
        self._slot_pages[slot][lp] = fresh
        self._bt[slot, lp] = fresh
        self._dirty = True
        if self.telemetry is not None:
            self.telemetry.instant("cow_split", slot=slot, lp=lp,
                                   src=int(page), dst=int(fresh))
            self.telemetry.inc("repro_cow_splits_total")
        return fresh

    def attach_shared(self, slot: int, digest: str) -> None:
        """Prefix-share hit: point ``slot``'s cross table at the existing
        page list (refcount + 1 each): no encoder run, no copy."""
        pages = self._shared[digest]
        for p in pages:
            self.cross_alloc.retain(p)
        self._slot_cross[slot] = (digest, list(pages))
        self._ct[slot, :] = pages
        self._dirty = True

    def alloc_cross_pages(self, slot: int, digest: str) -> List[int]:
        """First sight of ``digest``: allocate its cross pages and publish
        them for sharing. Raises ``PagesExhausted`` when dry."""
        pages: List[int] = []
        try:
            for _ in range(self.n_cross_per_req):
                pages.append(self.cross_alloc.alloc())
        except PagesExhausted:
            for p in pages:
                self.cross_alloc.release(p)
            raise
        self._shared[digest] = list(pages)
        self._slot_cross[slot] = (digest, list(pages))
        self._ct[slot, :] = pages
        self._dirty = True
        return pages

    def release(self, slot: int, reset: bool = False) -> None:
        """Evict ``slot``: every page reference returns to its allocator
        before this returns, so the same scheduler pass can admit into the
        freed pages; the digest is unpublished with its last reference.
        The slot's table rows point at the trash page again, so its
        garbage rows stop writing pages that may be reallocated (synced
        before the next step). ``reset`` is accepted for the slot pool's
        interface: the table rows are the reset."""
        del reset
        for p in self._slot_pages[slot]:
            self.self_alloc.release(p)
        self._slot_pages[slot] = []
        entry = self._slot_cross[slot]
        if entry is not None:
            digest, pages = entry
            for p in pages:
                self.cross_alloc.release(p)
            if self.cross_alloc.refcount[pages[0]] == 0:
                self._shared.pop(digest, None)
            self._slot_cross[slot] = None
        self._bt[slot, :] = 0
        self._ct[slot, :] = 0
        self._dirty = True
        self._slots.release(slot)

    def trim_self_pages(self, slot: int, n_keep: int) -> int:
        """Release ``slot``'s self pages past logical index ``n_keep - 1``:
        the paged half of the speculative rollback. A rejected window
        suffix may have crossed into pages the pre-round capacity pass
        allocated; once the rollback rewound the length, a page whose
        first position is at or past it holds only dead entries, so it
        returns to the allocator (its table entries point at the trash
        page again, synced before the next step). A shared page drops one
        reference. Returns the number of references released."""
        dropped = self._slot_pages[slot][n_keep:]
        if not dropped:
            return 0
        del self._slot_pages[slot][n_keep:]
        for p in dropped:
            self.self_alloc.release(p)
        self._bt[slot, n_keep:] = 0
        self._dirty = True
        return len(dropped)

    # -- device side ---------------------------------------------------------
    def sync(self) -> None:
        """Copy the host tables into the state's device tables, in place,
        when they changed: once before a decode step, however many edits
        came between steps. The copy is from pageable memory, which
        returns once the copy is done, so the host may edit its tables
        right after."""
        if not self._dirty:
            return
        ls = self.state.layer_states
        ls.block_table.copy_(torch.from_numpy(self._bt))
        ls.cross_table.copy_(torch.from_numpy(self._ct))
        self._dirty = False

    def insert(self, slot: int, req_state: ServeState,
               write_cross: bool = True) -> None:
        """Splice a batch-1 contiguous prefill or replay state into the
        arenas at ``slot``'s allocated pages, in place."""
        paged_insert(self.state, slot, self._bt[slot].tolist(),
                     self._ct[slot].tolist(), req_state,
                     write_cross=write_cross)

    def attach_reset(self, slot: int) -> None:
        """The device half of a share-hit admission: zero the slot's
        counters (its tables were set on the host)."""
        paged_attach(self.state, slot)

    # -- memory accounting -----------------------------------------------------
    def committed_kv_bytes(self) -> int:
        return model_lib.state_kv_bytes(self.state)

    def used_kv_bytes(self, lengths=None) -> int:
        """Allocated pages times page bytes: exact by construction.
        ``lengths`` is accepted for the slot pool's interface and
        ignored."""
        del lengths
        return (self.self_alloc.n_allocated * self.page_bytes
                + self.cross_alloc.n_allocated * self.cross_page_bytes)


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------
@dataclass
class _PreemptedRequest(_QueuedRequest):
    """A preempted request back at the head of the queue: its streamed
    tokens for the replay, and the time already attributed to it (the
    attribution stays exact by steps lived through preemption)."""
    tokens: List[int] = field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # queue wait accumulates over preemption rounds (requeue_t is this
    # round's base; submit_t stays the first submit, for the TTFT)
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0
    requeue_t: float = 0.0


class PagedScheduler(ContinuousBatchingScheduler):
    """Continuous batching over a ``PagedKVPool``.

    It inherits the decode, evict and attribution loop: the slot step is
    the same program at the pool's width, over the paged state, and its
    plan key carries the page geometry. What changes:

      admission  gates on free pages, not free slots: a logical slot is
                 admitted when its first self page and (on a prefix miss)
                 its cross pages fit the arenas. A prefix hit runs no
                 prefill, no kernel and no ledger commit: it attaches the
                 shared pages.
      pre-step   slots crossing a page boundary get their next page
                 (copy-on-write splitting shared pages first); exhaustion
                 preempts the active slot losing the fewest pages, which
                 goes back to the front of the queue with its tokens.
      evict      pages return to the allocators before the next admission
                 pass, so an EOS admits the queue head at once.

    Counters: ``preemptions``, ``shared_hits`` and ``replays`` (requests
    recomputed with tokens), ``replayed_steps`` (the batch-1 steps they
    ran) and ``prefills`` (prefill programs run: misses and replays).
    """

    def __init__(self, engine: ServeEngine, n_slots: int = 4,
                 n_frames: Optional[int] = None, *, page_size: int = 8,
                 n_pages: Optional[int] = None,
                 cross_page_size: Optional[int] = None,
                 n_cross_pages: Optional[int] = None):
        self._page_cfg = dict(page_size=page_size, n_pages=n_pages,
                              cross_page_size=cross_page_size,
                              n_cross_pages=n_cross_pages)
        super().__init__(engine, n_slots=n_slots, n_frames=n_frames)
        self.pool.telemetry = self.telemetry
        self._kv_gauge_state = None
        self.preemptions = 0
        self.shared_hits = 0
        self.prefills = 0
        self.replays = 0
        self.replayed_steps = 0
        # padded payloads of requests in flight, kept for the replay a
        # preemption may need; dropped when the request finishes
        self._payloads: Dict[int, np.ndarray] = {}

    def _make_pool(self) -> PagedKVPool:
        eng = self.engine
        return PagedKVPool(eng.cfg, self.n_slots, eng.max_len,
                           n_frames=self.n_frames, device=eng.device,
                           **self._page_cfg)

    def _make_step_key(self):
        return self.engine._key("step", self.n_slots, self.n_frames,
                                pages=self.pool.plan_geometry)

    def _prepare_replay(self) -> None:
        """On a CUDA device, capture ``transcribe``'s batch-1 prefill and
        step graphs at (1, F) if the engine has not: the step graph
        replays a preempted request's tokens. Called at the pool's
        admissions, when no request owns the static buffers those graphs
        run over (a capture's warm-up writes into them)."""
        eng = self.engine
        with torch.no_grad():
            eng._prepare(eng._static_for(1, self.n_frames),
                         eng._key("prefill", 1, self.n_frames),
                         eng._key("step", 1, self.n_frames))

    # -- admission ------------------------------------------------------------
    def admit(self) -> List[int]:
        admitted = []
        eng = self.engine
        pool = self.pool
        tele = self.telemetry
        if self.queue and pool.n_free:
            self._capture_step()
            self._prepare_replay()
        while self.queue and pool.n_free:
            req = self.queue[0]
            digest = _mel_digest(req.payload)
            replay = isinstance(req, _PreemptedRequest)
            ntok = len(req.tokens) if replay else 0
            need_self = min(ntok // pool.page_size + 1, pool.max_pages)
            shared = pool.has_shared(digest)
            need_cross = 0 if shared else pool.n_cross_per_req
            if not pool.can_alloc(need_self, need_cross):
                if not self._active:
                    raise RuntimeError(
                        f"arena too small: request {req.rid} needs "
                        f"{need_self} self + {need_cross} cross pages with "
                        f"nothing left to preempt "
                        f"(free: {pool.self_alloc.n_free}/"
                        f"{pool.cross_alloc.n_free})")
                break                                  # wait for evictions
            self.queue.popleft()
            wait_base = req.requeue_t if replay else req.submit_t
            queue_wait = (req.queue_wait_s if replay else 0.0) + (
                time.perf_counter() - wait_base if wait_base else 0.0)
            if tele is not None:
                tele.end(req.rid, "queued", wait_s=queue_wait)
                tele.observe("repro_queue_wait_seconds", queue_wait)
            slot = pool.acquire()
            if shared and not replay:
                # prefix hit: no encoder and no prefill, so no ledger
                # commit either (no linear ran: committing plan work here
                # would break the attribution); the ledger span's zero
                # FLOP delta is the checkable form of that claim
                self.shared_hits += 1
                if tele is not None:
                    tele.instant("prefix_hit", rid=req.rid)
                    tele.inc("repro_prefix_hits_total")
                with obs.maybe_span(tele, "attach", cat="lifecycle",
                                    track=obs.request_track(req.rid),
                                    rid=req.rid, ledger=True):
                    t0 = time.perf_counter()
                    pool.attach_shared(slot, digest)
                    for _ in range(need_self):
                        pool.alloc_self_page(slot)
                    pool.attach_reset(slot)
                    _sync(eng.device)
                    prefill_s = time.perf_counter() - t0
                    self._busy_s += prefill_s
                first = req.sot_id
                active = _ActiveSlot(rid=req.rid, max_new=req.max_new,
                                     prefill_s=prefill_s,
                                     submit_t=req.submit_t,
                                     queue_wait_s=queue_wait)
            else:
                with obs.maybe_span(tele, "prefill", cat="lifecycle",
                                    track=obs.request_track(req.rid),
                                    rid=req.rid, ledger=True):
                    state, plan, prefill_s = eng.prefill_one(
                        torch.from_numpy(req.payload))
                    self.prefills += 1
                    self._busy_s += prefill_s
                    if eng.offload is not None:
                        eng.offload.ledger.commit(plan, times=1)
                if tele is not None:
                    tele.observe("repro_prefill_seconds", prefill_s)
                if shared:
                    pool.attach_shared(slot, digest)
                else:
                    pool.alloc_cross_pages(slot, digest)
                for _ in range(need_self):
                    pool.alloc_self_page(slot)
                decode_s = 0.0
                if replay and req.tokens:
                    decode_s = self._replay(req)
                pool.insert(slot, state, write_cross=not shared)
                first = (req.tokens[-1] if replay and req.tokens
                         else req.sot_id)
                active = _ActiveSlot(
                    rid=req.rid, max_new=req.max_new,
                    tokens=list(req.tokens) if replay else [],
                    steps=ntok,
                    prefill_s=prefill_s + (req.prefill_s if replay else 0.0),
                    decode_s=decode_s + (req.decode_s if replay else 0.0),
                    submit_t=req.submit_t,
                    queue_wait_s=queue_wait,
                    ttft_s=req.ttft_s if replay else 0.0)
            if tele is not None:
                tele.begin(req.rid, "decode")
            self._token[slot].fill_(int(first))
            self._active[slot] = active
            admitted.append(req.rid)
        if admitted:
            self._note_kv_usage()
        return admitted

    def _replay(self, req: _PreemptedRequest) -> float:
        """Preempt-and-recompute: rebuild the request's self-KV in the
        engine's batch-1 static buffers (its prefill state, just run) by
        feeding its SOT and all but its last streamed token one at a time
        through the batch-1 step program (on the card, a replay of
        ``transcribe``'s step graph at ``plan_key("step", quant, 1, F)``).
        Greedy decode is deterministic, so the state continues token for
        token. The replay's time and the step plan, committed
        ``len(inputs)`` times, go to this request. Returns the seconds."""
        eng = self.engine
        st = eng._static_for(1, self.n_frames)
        key = eng._key("step", 1, self.n_frames)
        inputs = [req.sot_id] + req.tokens[:-1]
        recorded = None
        tele = self.telemetry
        with obs.maybe_span(tele, "replay", cat="lifecycle",
                            track=obs.request_track(req.rid), rid=req.rid,
                            ledger=True, args={"tokens": len(inputs)}), \
                torch.no_grad():
            _sync(eng.device)
            t0 = time.perf_counter()
            for tok in inputs:
                st.token.fill_(tok)
                plan = eng._run(key, lambda: eng._step_fn(st))
                recorded = plan if recorded is None else recorded
            _sync(eng.device)
            replay_s = time.perf_counter() - t0
            self._busy_s += replay_s
            self.replays += 1
            self.replayed_steps += len(inputs)
            if eng.offload is not None:
                eng.offload.ledger.commit(eng._plan(key, recorded),
                                          times=len(inputs))
        if tele is not None:
            tele.instant("replay", rid=req.rid, tokens=len(inputs))
            tele.inc("repro_replays_total")
            tele.observe("repro_replay_seconds", replay_s)
        return replay_s

    # -- the capacity pass before each step -------------------------------------
    def _pick_victim(self) -> int:
        """Preemption victim: the active slot losing the fewest pages (the
        least recompute thrown away); ties: the lowest slot."""
        return min(self._active,
                   key=lambda s: (len(self.pool._slot_pages[s]), s))

    def _preempt(self, slot: int) -> None:
        a = self._active.pop(slot)
        self.preemptions += 1
        tele = self.telemetry
        if tele is not None:
            tele.instant("preempt", rid=a.rid)
            tele.inc("repro_preemptions_total")
            tele.end(a.rid, "decode", preempted=True, steps=a.steps)
            tele.begin(a.rid, "queued")
        # the FRONT of the queue: a preempted request has streamed tokens
        # already; its payload stays kept, it may be preempted again
        self.queue.appendleft(_PreemptedRequest(
            rid=a.rid, payload=self._payloads[a.rid], max_new=a.max_new,
            submit_t=a.submit_t, tokens=list(a.tokens),
            prefill_s=a.prefill_s, decode_s=a.decode_s,
            queue_wait_s=a.queue_wait_s, ttft_s=a.ttft_s,
            requeue_t=time.perf_counter()))
        self.pool.release(slot)

    def submit(self, payload, max_new: int = 32, sot_id: int = 1) -> int:
        rid = super().submit(payload, max_new=max_new, sot_id=sot_id)
        if self.queue and self.queue[-1].rid == rid:
            self._payloads[rid] = self.queue[-1].payload
        return rid

    def _page_capacity_pass(self, w: int = 1) -> None:
        """Give every active slot private pages for its next ``w`` write
        positions (``w == 1``: the decode step), allocating the page a
        write crosses into, copy-on-write first. Exhaustion preempts the
        slot losing the fewest pages until the others fit."""
        pool = self.pool
        for slot in sorted(self._active):
            if slot not in self._active:
                continue                               # preempted below
            a = self._active[slot]
            lp0 = a.steps // pool.page_size            # first page written
            lp1 = min((a.steps + w - 1) // pool.page_size,
                      pool.max_pages - 1)              # writes clamp past cap
            for lp in range(lp0, lp1 + 1):
                while slot in self._active:
                    try:
                        if len(pool._slot_pages[slot]) <= lp:
                            pool.alloc_self_page(slot)
                            continue
                        pool.ensure_private(slot, lp)  # CoW before the write
                        break
                    except PagesExhausted:
                        self._preempt(self._pick_victim())
                if slot not in self._active:
                    break

    def decode_step(self) -> List[TokenEvent]:
        if not self._active:
            return []
        self._page_capacity_pass()
        self.pool.sync()
        events = super().decode_step()
        for ev in events:
            if ev.done:                   # finished: no replay can follow
                self._payloads.pop(ev.rid, None)
        if self.telemetry is not None:
            self._note_page_gauges()
        return events

    def _note_page_gauges(self) -> None:
        """The page gauges by kind, set when the allocators' host-side
        counts changed (on admissions and evictions, not every step)."""
        pool = self.pool
        g = (pool.self_alloc.n_free, pool.cross_alloc.n_free,
             pool.self_alloc.n_allocated, pool.cross_alloc.n_allocated,
             int(np.count_nonzero(pool.self_alloc.refcount > 1)),
             int(np.count_nonzero(pool.cross_alloc.refcount > 1)))
        if g != self._kv_gauge_state:
            self._kv_gauge_state = g
            tele = self.telemetry
            tele.gauge("repro_kv_pages_free", g[0], kind="self")
            tele.gauge("repro_kv_pages_free", g[1], kind="cross")
            tele.gauge("repro_kv_pages_used", g[2], kind="self")
            tele.gauge("repro_kv_pages_used", g[3], kind="cross")
            tele.gauge("repro_kv_pages_shared", g[4], kind="self")
            tele.gauge("repro_kv_pages_shared", g[5], kind="cross")
