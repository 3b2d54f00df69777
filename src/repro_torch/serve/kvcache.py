"""Fixed-shape slot KV-cache pool for continuous batching.

The pool allocates ONE slot-layout decode state of ``n_slots`` rows (for
whisper with ``n_frames`` cross-K/V frames; for an LM its layer states:
KV caches, int8 with ``kv_quant="q8"``, and SSM conv windows and states)
at construction and never
reshapes it or replaces its tensors: admission and eviction are copies
into row ``slot`` of the pool's own tensors, so the scheduler's captured
slot step (a CUDA graph on the card) keeps reading the storage it was
captured with, across any admission and eviction schedule.

  slot_insert(pool, slot, req)  copy a single-request prefill state
                                (whisper's encoder and cross-K/V, or an
                                LM's prompt prefill; standard layout,
                                batch 1) into row
                                ``slot``; its scalar counters land in the
                                pool's per-slot vectors.
  slot_reset(pool, slot)        zero row ``slot`` (KV buffers and
                                counters), bounding a free slot's counter
                                drift between occupants.

The reference returns a new state from each op; here both write in place
(device-to-device copies on the pool's device) and return nothing.

Free slots keep decoding garbage — the fixed-shape contract: the batch
always computes all ``n_slots`` rows — and every insert overwrites the
entire slot row, so stale state never leaks into a new request. A free
slot's positions keep rising after its request left; the cache write and
the position lookup clamp them (``models/attention.py``), which changes
garbage rows only.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional


from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.model import ServeState
from repro_torch.models.transformer import layer_pattern


def slot_insert(pool: ServeState, slot: int, req: ServeState) -> None:
    """Copy the single-request decode state ``req`` (standard or slot
    layout, batch 1) into row ``slot`` of the slot-layout ``pool``, in
    place: every data tensor's row and every counter's entry (every
    tensor of a decode state has the batch on axis 0). Other rows are not
    touched."""
    for p, r in zip(model_lib.state_tensors(pool),
                    model_lib.state_tensors(req), strict=True):
        p.narrow(0, slot, 1).copy_(r.reshape((1,) + tuple(p.shape[1:])))


def slot_reset(pool: ServeState, slot: int) -> None:
    """Zero row ``slot`` of every tensor of ``pool`` (KV buffers, lengths,
    step), in place. Not needed for correctness — ``slot_insert``
    overwrites the whole row — but it pins a freed slot's counters back to
    0, so that an idle slot's position does not drift toward the end of
    the cache between occupants."""
    for p in model_lib.state_tensors(pool):
        p.narrow(0, slot, 1).zero_()


class SlotKVPool:
    """The preallocated slot pool and its host-side free list.

    ``state`` is a slot-layout ``ServeState`` of fixed shape ``(n_slots,
    max_len, ...)`` built once, of zeros, on ``device`` (which the caller
    names); for whisper the cross-K/V rows hold ``n_frames`` frames, the
    capacity every admitted utterance is padded to (an LM's pool has no
    frames). ``acquire`` and
    ``release`` manage the free list (the lowest free slot first, as the
    reference's unsharded pool); ``insert`` is the splice a scheduler
    calls on admission.
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 n_frames: Optional[int] = None, *, device):
        if cfg.family == "audio" and n_frames is None:
            raise ValueError("audio slot pool needs a fixed n_frames "
                             "capacity (utterances are padded to it)")
        self.n_slots = n_slots
        self.max_len = max_len
        self.n_frames = n_frames
        self.state: ServeState = model_lib.zeros_slot_state(
            cfg, n_slots, n_frames, max_len, device=device)
        # an LM's layer pattern length: the reference stacks its state's
        # leaves by pattern position
        self._period = (len(layer_pattern(cfg)) if cfg.family != "audio"
                        else 1)
        self._free: List[int] = list(range(n_slots))

    # -- free-slot bookkeeping (host side) -----------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        """Claim the lowest free slot (raises IndexError when full)."""
        if not self._free:
            raise IndexError("pool full: no free slot")
        return self._free.pop(0)

    def release(self, slot: int, reset: bool = True) -> None:
        """Return ``slot`` to the free list. ``reset=False`` skips zeroing
        the row — safe because ``insert`` overwrites the entire slot before
        reuse and freed rows' garbage is never read (the scheduler's path
        uses it)."""
        if reset:
            slot_reset(self.state, slot)
        bisect.insort(self._free, slot)

    # -- memory accounting ---------------------------------------------
    def committed_kv_bytes(self) -> int:
        """Bytes preallocated for the whole pool state — what this
        contiguous layout commits regardless of occupancy."""
        return model_lib.state_kv_bytes(self.state)

    def used_kv_bytes(self, lengths: Dict[int, int]) -> int:
        """Bytes of committed state holding live request data, given the
        active slots' decode lengths: positional KV rows count in
        proportion to their filled length, fixed-size rows (whisper's
        cross K/V, SSM states and the lengths) whole per active slot. A
        leaf is positional when its axis after the batch is ``max_len``
        long: the reference's test, which also takes an ``SSMState.ssd``
        whose head count equals ``max_len`` for positional (a reference
        quirk, kept). Summed field by field over the layers of each
        pattern position, in the reference's leaf order, so that the
        result equals the reference's for its stacked state (an LM's: a
        position's fields, K/V data, their int8 scales and lengths, or
        conv window, SSD state and length)."""
        if not lengths:
            return 0
        n_active = len(lengths)
        frac = sum(min(n, self.max_len)
                   for n in lengths.values()) / self.max_len
        ls = self.state.layer_states
        if isinstance(ls, list):                   # an LM's layer states
            p = self._period
            fields = [[st[f] for st in ls[j::p]]
                      for j in range(p) for f in range(len(ls[j]))]
        else:
            fields = [[kv.k for kv in ls.self_kv],
                      [kv.v for kv in ls.self_kv],
                      [kv.length for kv in ls.self_kv],
                      [k for k, _ in ls.cross_kv],
                      [v for _, v in ls.cross_kv]]
        total = 0.0
        for leaves in fields:
            per_slot = sum(t.numel() // t.shape[0] * t.element_size()
                           for t in leaves)
            if leaves[0].dim() >= 2 and leaves[0].shape[1] == self.max_len:
                total += per_slot * frac
            else:
                total += per_slot * n_active
        return int(total)

    # -- state ops ------------------------------------------------------
    def insert(self, slot: int, req_state: ServeState) -> None:
        """Splice a batch-1 prefill state into ``slot``, in place."""
        slot_insert(self.state, slot, req_state)
