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

Sharded pools: with a serving mesh the slot axis splits over the mesh's
"data" axis into ``n_shards`` ranges of ``shard_size`` slots, as
``model.slot_state_specs`` lays the pool out: the slot axis splits when
``n_slots`` divides by the axis size, else the pool is one shard, as the
reference falls back to replicated. Each pool tensor is one tensor a
distinct physical device, holding the rows of that device's shards in
shard order, and a shard's program reads ``shard_states[s]``, views of
its rows (``model.slot_view``): a mesh of one physical device keeps one
whole pool, its rows in slot order. ``acquire`` admits into the shard
with the most free slots (ties: the lowest), the reference's pick order,
so load spreads over the mesh; insert, reset and release copy into
the owning shard's rows.

Over "model" (``kv_devices``: a data device's model devices, where its
attention is split over them) each attention layer's K and V are one
cache a model shard, its Hkv / M heads on its device, as ``cache_specs``
splits Hkv over "model" (``ModelShards``); where attention runs whole,
the cache is whole on the data shard's first device. Every tensor keeps
the slot axis first, so the splice and the views are unchanged.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional


from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import physical_device
from repro_torch.models import model as model_lib
from repro_torch.models.attention import first_shard, shard_list
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
    ``release`` manage the free lists (unsharded, the lowest free slot
    first, as the reference's pool); ``insert`` is the splice a scheduler
    calls on admission. ``mesh`` shards the slot axis (the module's
    docstring); ``state`` is then the first device's tensors, the whole
    pool when the mesh has one physical device.
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 n_frames: Optional[int] = None, *, device, mesh=None,
                 kv_devices: Optional[Dict] = None):
        if cfg.family == "audio" and n_frames is None:
            raise ValueError("audio slot pool needs a fixed n_frames "
                             "capacity (utterances are padded to it)")
        self.n_slots = n_slots
        self.max_len = max_len
        self.n_frames = n_frames
        self.mesh = mesh
        self.n_shards = 1
        if mesh is not None:
            # the layout is the pool's spec tree's, read off a state of
            # the pool's shapes on the meta device (no memory)
            specs = model_lib.slot_state_specs(model_lib.zeros_slot_state(
                cfg, n_slots, n_frames, max_len, device="meta"), mesh)
            self.n_shards = spec_shards(specs.step, 0, mesh)
        devs = ([physical_device(d) for d in mesh.axis_devices("data")]
                if self.n_shards > 1 else [physical_device(device)])
        self.shard_size = n_slots // self.n_shards
        self.shard_devices: List = devs
        self.devices = list(dict.fromkeys(devs))
        # each shard's first row in its device's tensors
        self._row0 = [devs[:s].count(d) * self.shard_size
                      for s, d in enumerate(devs)]
        kv_devices = kv_devices or {}
        self.states: Dict = {
            d: model_lib.zeros_slot_state(
                cfg, devs.count(d) * self.shard_size, n_frames, max_len,
                device=d, kv_devices=kv_devices.get(d))
            for d in self.devices}
        self.state: ServeState = self.states[self.devices[0]]
        self.shard_states: List[ServeState] = [
            model_lib.slot_view(self.states[d], self._row0[s],
                                self.shard_size)
            for s, d in enumerate(devs)]
        # an LM's layer pattern length: the reference stacks its state's
        # leaves by pattern position
        self._period = (len(layer_pattern(cfg)) if cfg.family != "audio"
                        else 1)
        self._init_free()

    # -- free-slot bookkeeping (host side) -----------------------------
    def _init_free(self) -> None:
        """Per-shard sorted free lists: ``acquire`` is O(n_shards)."""
        self._free_by_shard: List[List[int]] = [
            list(range(s * self.shard_size, (s + 1) * self.shard_size))
            for s in range(self.n_shards)]
        self._n_free = self.n_slots

    @property
    def n_free(self) -> int:
        return self._n_free

    def slot_shard(self, slot: int) -> int:
        """The data shard owning ``slot`` (0 when unsharded)."""
        return slot // self.shard_size

    def locate(self, slot: int):
        """(the device, the row in that device's tensors) of ``slot``."""
        s = self.slot_shard(slot)
        return (self.shard_devices[s],
                self._row0[s] + slot - s * self.shard_size)

    def acquire(self) -> int:
        """Claim a free slot (raises IndexError when full): in the shard
        with the most free slots, ties to the lowest shard, its lowest
        free slot; unsharded, the lowest free slot."""
        if self._n_free == 0:
            raise IndexError("pool full: no free slot")
        shard = max(range(self.n_shards),
                    key=lambda s: (len(self._free_by_shard[s]), -s))
        self._n_free -= 1
        return self._free_by_shard[shard].pop(0)

    def release(self, slot: int, reset: bool = True) -> None:
        """Return ``slot`` to its shard's free list. ``reset=False`` skips
        zeroing the row — safe because ``insert`` overwrites the entire
        slot before reuse and freed rows' garbage is never read (the
        scheduler's path uses it)."""
        if reset:
            dev, row = self.locate(slot)
            slot_reset(self.states[dev], row)
        bisect.insort(self._free_by_shard[self.slot_shard(slot)], slot)
        self._n_free += 1

    # -- memory accounting ---------------------------------------------
    def committed_kv_bytes(self) -> int:
        """Bytes preallocated for the whole pool state — what this
        contiguous layout commits regardless of occupancy."""
        return sum(model_lib.state_kv_bytes(st)
                   for st in self.states.values())

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
            fields = [[c[f] for st in ls[j::p] for c in shard_list(st)]
                      for j in range(p)
                      for f in range(len(first_shard(ls[j])))]
        else:
            kvs = [c for kv in ls.self_kv for c in shard_list(kv)]
            cross = [c for kv in ls.cross_kv for c in shard_list(kv)]
            fields = [[kv.k for kv in kvs], [kv.v for kv in kvs],
                      [kv.length for kv in kvs], [k for k, _ in cross],
                      [v for _, v in cross]]
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
        """Splice a batch-1 prefill state (on the slot's device) into
        ``slot``, in place."""
        dev, row = self.locate(slot)
        slot_insert(self.states[dev], row, req_state)



def spec_shards(spec, axis: int, mesh) -> int:
    """The ranges a leaf's partition spec splits its ``axis`` into: the
    mesh's "data" size where the spec names that axis there, else 1."""
    return (mesh.shape["data"]
            if len(spec) > axis and spec[axis] == "data" else 1)
