"""Speculative decoding across the Whisper ladder: a cheap draft model
proposes ``k`` tokens a round, the verifier scores the ``k + 1``-token
window in one forward, and greedy acceptance keeps the longest draft
prefix the verifier agrees with, then the verifier's own token, so the
emitted tokens are exactly the verifier's greedy ``transcribe``'s
(``accept_spec`` is the pure rule).

The paper's PDP advantage narrows from whisper-tiny to base and small as
their steps grow; this spends whisper-tiny steps to amortize the bigger
model's.

Two models, one ledger: each engine keeps its own ``PlanCache`` with
role-tagged keys (``plan_key(..., role=, k=)``: draft and verify programs
never share an entry with the plain greedy plans), and both commit into
the verifier's ``OffloadLedger`` with ``role="draft"`` or ``"verify"``,
so ``OffloadStats.by_role`` splits the FLOPs exactly.

A round (``SpeculativeEngine.transcribe``, and ``_SpecRoundsMixin`` in
the schedulers):
  draft   k + 1 runs of the draft step program over the draft's slot
          state: the first k produce the drafts, the last writes the
          k-th draft's KV entry, so that a full accept leaves the draft
          cache whole. The step reads its token from a column of the
          window buffer and writes its argmax to the next column.
  verify  one run of the verify program: the (B, k + 1) window scored in
          one forward, the verifier's argmaxes and the drafts written to
          one output buffer.
  sync    the round's one host read (that buffer), then ``accept_spec``,
          the emit loop and EOS/``max_new``.
  rollback  in-place copies: every counter of both models set to the
          emitted length (``model.set_slot_lengths``; stale window entries
          past it stay, masked, then overwritten), the next pending token
          into window column 0, the column index back to 0.
  commits the draft step plan ``k + 1`` times at role "draft", the verify
          plan once at role "verify".

On a CUDA device the draft step and the verify window are each captured
into a CUDA graph at the first request of a (batch, frames) point (k is
the engine's), and a scheduler's at its pool's first admission while no
slot is live; after that they are only replayed, whatever the accept
lengths: a rollback writes into the counters the graphs were captured on
and never replaces a tensor. A capture that fails raises. On the CPU the
programs are called directly, each run recorded apart. The prefills are
``transcribe``'s own programs and plan keys.

Telemetry (the verifier's; the draft engine has none, as in the
reference): the one-shot path's prefills and their commits are one
``spec_prefill`` ledger span, and every round, one-shot or scheduled, is
one ``spec_round`` ledger span from before the draft steps to after the
round's host sync and both commits, with the ``repro_spec_rounds_total``,
``_drafted_total`` and ``_accepted_total`` counters. A scheduler's draft
admission (prefill and, after a preemption, replay, with their commits)
is a ``spec_draft_admit`` ledger span on the request's track and a
``spec_admit`` instant; the paged scheduler's post-round trim a
``spec_trim`` instant. The one-shot path's ``repro_spec_verify_traces``
gauge and the schedulers' ``repro_step_traces`` read the verifier's
window builds.

A serving mesh (the verifier's, which ``ServeEngine.speculative`` shares
with the draft), as the reference serves one: the one-shot
``SpeculativeEngine.transcribe`` splits its batch over the data shards,
one draft step and verify window captured a shard, the round's plans
committed once, and ``SpecScheduler``'s waves run through it. Over
"model" each engine runs its split blocks over the data shard's model
shards by its own widths (the draft's attention may run whole where the
verifier's splits), each its own ``ModelShards`` caches, which the
rollback (``model.set_slot_lengths``) rewinds shard by shard. The round
schedulers (``SpecContinuousScheduler``, ``PagedSpecScheduler``) are
single-device and refuse a mesh, as the reference's do.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Hashable, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import DispatchPlan
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import (
    GenerationResult, ServeEngine, _Program, _sync)
from repro_torch.serve.kvcache import SlotKVPool
from repro_torch.serve.paging import PagedScheduler
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, TokenEvent
from repro_torch.sharding import ctx as shard_ctx


def accept_spec(drafts: np.ndarray, vtoks: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pure greedy-acceptance rule.

    drafts: (B, k) draft proposals d_1..d_k; vtoks: (B, k+1) verifier
    argmaxes over the window [t_0, d_1..d_k] — ``vtoks[:, j]`` is what
    greedy decode on the verifier emits after the first ``j+1`` window
    tokens. Returns ``(accept_len, committed, n_emit)``:
      accept_len (B,)     longest prefix with drafts[j] == vtoks[j]
      committed (B, k+1)  the emitted tokens: the accepted drafts, then the
                          verifier's token at the first mismatch (or its
                          bonus token after a full accept); entries past
                          ``n_emit`` are padding
      n_emit (B,)         accept_len + 1 (every round emits a token)"""
    drafts = np.asarray(drafts)
    vtoks = np.asarray(vtoks)
    b, k = drafts.shape
    if vtoks.shape != (b, k + 1):
        raise ValueError(f"vtoks must be (B, k+1); got {vtoks.shape} "
                         f"for drafts {drafts.shape}")
    mismatch = drafts != vtoks[:, :k]
    accept_len = np.where(mismatch.any(axis=1), mismatch.argmax(axis=1),
                          k).astype(np.int64)
    committed = np.concatenate(
        [drafts, np.zeros((b, 1), drafts.dtype)], axis=1)
    rows = np.arange(b)
    committed[rows, accept_len] = vtoks[rows, accept_len]
    return accept_len, committed, accept_len + 1


class _Rounds:
    """The buffers and programs of speculative rounds over two slot-layout
    states at one width B: the window (B, k + 2) — column 0 the pending
    token, 1..k the drafts, k + 1 scratch for the last draft step's
    argmax — the draft step's column index, the verify output (B, 2k + 1)
    and the rollback's host-to-device staging. ``programs`` holds the two
    captured graphs on a CUDA device (None until captured, and on the
    CPU).

    ``dev`` is the device of the buffers and programs (the verifier's by
    default). The rounds of one of ``shards`` data shards of a one-shot
    batch of ``key_b`` rows (``SpeculativeEngine.transcribe`` on a mesh)
    run their programs inside ``sharding.ctx.shard_program`` under the
    whole batch's keys; only the first shard's captures count a build
    (``build``)."""

    def __init__(self, spec: "SpeculativeEngine", v_state, d_state,
                 b: int, f: int, pages=None, *, dev=None,
                 key_b: Optional[int] = None, shards: int = 1,
                 build: bool = True):
        v, d, k = spec.verifier, spec.draft, spec.k
        dev = v._phys if dev is None else dev
        key_b = b if key_b is None else key_b
        self.spec = spec
        self.dev, self.shards, self.build = dev, shards, build
        self.v_state, self.d_state = v_state, d_state
        self.window = torch.zeros((b, k + 2), dtype=torch.long, device=dev)
        self.col = torch.zeros((1,), dtype=torch.long, device=dev)
        self.out = torch.zeros((b, 2 * k + 1), dtype=torch.long, device=dev)
        self.new_len = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.d_key = d._key("step", key_b, f, role="draft")
        self.v_key = v._key("verify", key_b, f, pages=pages, role="verify",
                            k=k)
        self.programs: Optional[Tuple[_Program, _Program]] = None
        self.d_plan: Optional[DispatchPlan] = None
        self.v_plan: Optional[DispatchPlan] = None

    def _draft(self) -> None:
        with shard_ctx.shard_program(self.shards):
            self.spec.draft._draft_fn(self.d_state, self.window, self.col,
                                      self.dev)

    def _verify(self) -> None:
        with shard_ctx.shard_program(self.shards):
            self.spec.verifier._verify_fn(self.v_state, self.window,
                                          self.out, self.dev)

    def capture(self) -> None:
        """On a CUDA device, capture the draft step and the verify window
        (once), on ``dev``. Their warm-up runs write garbage into the
        states' KV and advance their counters, which the caller resets
        before use."""
        spec = self.spec
        if self.programs is not None or spec.verifier.device.type != "cuda":
            return
        with torch.no_grad():
            self.programs = (
                spec.draft._capture(self.d_key, self._draft, device=self.dev,
                                    build=self.build),
                spec.verifier._capture(self.v_key, self._verify,
                                       device=self.dev, build=self.build))
        self.col.zero_()

    @staticmethod
    def _run(eng: ServeEngine, prog: Optional[_Program], key: Hashable,
             fn: Callable[[], None]) -> DispatchPlan:
        if prog is not None:
            prog.graph.replay()
            return prog.plan
        with torch.no_grad():
            return eng._record_run(key, fn)

    def launch(self) -> None:
        """The k + 1 draft steps and the verify window, launched. The
        first round after ``d_plan`` was cleared looks both plans up under
        the role keys (caching its runs' on a miss)."""
        spec = self.spec
        v, d, k = spec.verifier, spec.draft, spec.k
        dprog, vprog = self.programs or (None, None)
        for _ in range(k + 1):
            dplan = self._run(d, dprog, self.d_key, self._draft)
        vplan = self._run(v, vprog, self.v_key, self._verify)
        if self.d_plan is None:
            self.d_plan = d._plan(self.d_key, dplan)
            self.v_plan = v._plan(self.v_key, vplan)

    def round(self) -> np.ndarray:
        """``launch``, then the round's one host sync. Returns ``out`` on
        the host: (B, 2k + 1), the verifier's k + 1 argmaxes, then the k
        drafts."""
        self.launch()
        return self.out.cpu().numpy()

    def commit(self) -> None:
        """One round's accounting: the draft step k + 1 times, the window
        once, into the shared ledger by role."""
        spec = self.spec
        v, d = spec.verifier, spec.draft
        if d.offload is not None:
            d.offload.ledger.commit(self.d_plan, times=spec.k + 1,
                                    role="draft")
        if v.offload is not None:
            v.offload.ledger.commit(self.v_plan, times=1, role="verify")

    def rollback(self, new_len: np.ndarray, pending: np.ndarray) -> None:
        """Both models' counters to ``new_len``, the next pending tokens
        into window column 0 and the column index to 0: in-place copies
        into the buffers the programs were captured on."""
        with torch.no_grad():
            self.new_len.copy_(torch.from_numpy(
                np.asarray(new_len, np.int32)))
            model_lib.set_slot_lengths(self.v_state, self.new_len)
            model_lib.set_slot_lengths(self.d_state, self.new_len)
            self.window[:, 0].copy_(torch.from_numpy(
                np.asarray(pending, np.int64)))
            self.col.zero_()


class _Part(NamedTuple):
    """One data shard of the one-shot path's batch: its first row, its
    rows, the verifier's and the draft's static buffers of ``transcribe``
    and the round buffers over both in the slot layout."""
    lo: int
    rows: int
    st_v: Any
    st_d: Any
    rounds: _Rounds


@dataclass
class SpeculativeEngine:
    """Two-model speculative decoder: ``draft`` proposes ``k`` tokens a
    round, ``verifier`` scores the k + 1 window in one forward, greedy
    acceptance keeps the tokens exactly those of
    ``verifier.transcribe()``. Build it with ``ServeEngine.speculative()``
    (which shares the verifier's ledger); constructing it directly works
    when the caller owns both engines."""
    verifier: ServeEngine
    draft: ServeEngine
    k: int = 4
    # lifetime counters: the acceptance report
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    _statics: Dict[Tuple[int, int], List["_Part"]] = field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        # the guards run cheapest first, so a setup wrong in several ways
        # fails in a fixed order: k, max_len, vocabulary, family
        if self.k < 1:
            raise ValueError("k must be >= 1")
        cap = min(self.verifier.max_len, self.draft.max_len)
        if cap < self.k + 2:
            raise ValueError(
                f"max_len too small for k={self.k}: one round feeds a "
                f"k+1-token window plus the bonus entry, so max_len must "
                f"be >= k + 2 = {self.k + 2} (verifier "
                f"{self.verifier.max_len}, draft {self.draft.max_len})")
        vc, dc = self.verifier.cfg, self.draft.cfg
        if dc.vocab_size != vc.vocab_size:
            raise ValueError(
                f"draft and verifier must share a vocabulary to compare "
                f"tokens: {dc.vocab_size} != {vc.vocab_size}")
        if vc.family != "audio" or dc.family != "audio":
            raise NotImplementedError(
                "speculative serving is wired for the audio family "
                "(the Whisper ladder)")

    def _parts(self, b: int, f: int) -> List["_Part"]:
        """The one-shot path's data shards of a batch of B at F frames
        (one, the whole batch, off a mesh or where B does not split:
        ``ServeEngine._shard_rows``), made once."""
        parts = self._statics.get((b, f))
        if parts is None:
            v, d = self.verifier, self.draft
            shards = v._shard_rows(b)
            parts = self._statics[(b, f)] = []
            for s, dev, lo, rows in shards:
                st_v = v._static_for(rows, f, dev, s)
                st_d = d._static_for(rows, f, dev, s)
                parts.append(_Part(lo, rows, st_v, st_d, _Rounds(
                    self, model_lib.slot_layout(st_v.state, rows),
                    model_lib.slot_layout(st_d.state, rows), rows, f,
                    dev=st_v.device, key_b=b, shards=len(shards),
                    build=s in (None, 0))))
        return parts

    def transcribe(self, mel, sot_id: int = 1,
                   max_new: int = 32) -> List[GenerationResult]:
        """The speculative twin of ``ServeEngine.transcribe``, with its
        token contract (the generated tokens only, each row cut at its
        first EOS inclusive), token-exact with the verifier's greedy
        decode of the same batch. ``mel``: (B, F, n_mels) numpy array or
        tensor. On a mesh whose data axis divides B, each data shard runs
        its rows' rounds on its device, as ``ServeEngine.transcribe``
        splits its batch: every shard's rounds are launched before the
        round's host reads, and each round's plans are committed once."""
        v, d, k = self.verifier, self.draft, self.k
        mel_t = torch.as_tensor(mel, dtype=torch.float32)
        b, f = int(mel_t.shape[0]), int(mel_t.shape[1])
        need = max_new + k + 1           # window writes reach position G + k
        if v.max_len < need or d.max_len < need:
            raise ValueError(
                f"max_len must be >= max_new + k + 1 = {need} "
                f"(verifier {v.max_len}, draft {d.max_len})")
        parts = self._parts(b, f)
        rows_s = parts[0].rows           # the rows a shard's launches run
        searches = v._warm_tuning(n_frames=f, batch=rows_s,
                                  n_tokens=max_new)
        v._warm_tuning(n_frames=f, batch=rows_s * (k + 1), n_tokens=max_new)
        pre_v, pre_d = v._key("prefill", b, f), d._key("prefill", b, f)
        tele = v.telemetry
        with torch.no_grad(), shard_ctx.shard_program(len(parts)):
            for lo, rows, st_v, st_d, rounds in parts:
                rounds.d_plan = rounds.v_plan = None   # one lookup a request
                st_v.mel.copy_(mel_t[lo:lo + rows])
                st_d.mel.copy_(mel_t[lo:lo + rows])
                v._prepare(st_v, pre_v)
                d._prepare(st_d, pre_d)
                rounds.capture()
            with obs.maybe_span(tele, "spec_prefill", cat="engine",
                                ledger=True, args={"batch": b, "frames": f}):
                prefill_s = 0.0
                for _, _, st_v, st_d, _ in parts:
                    rec_v, pre_s_v = v._timed_prefill(st_v, pre_v)
                    rec_d, pre_s_d = d._timed_prefill(st_d, pre_d)
                    prefill_s += pre_s_v + pre_s_d
                if v.offload is not None:
                    v.offload.ledger.commit(v._plan(pre_v, rec_v), times=1,
                                            role="verify")
                if d.offload is not None:
                    d.offload.ledger.commit(d._plan(pre_d, rec_d), times=1,
                                            role="draft")

        toks: List[List[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        prev_len = np.zeros(b, np.int64)
        for lo, rows, *_, rounds in parts:
            rounds.rollback(prev_len[lo:lo + rows], np.full(rows, sot_id))
        eos = v.eos_id if (v.eos_id is not None and v.eos_id >= 0) else None
        rows_b = np.arange(b)
        t0 = time.perf_counter()
        while not done.all():
            # one ledger span a round: the draft and verify runs, the
            # round's host sync and both commits
            h = tele.ledger_open() if tele is not None else None
            active_mask = ~done
            for *_, rounds in parts:
                rounds.launch()
            res = np.concatenate([rounds.out.cpu().numpy()
                                  for *_, rounds in parts])
            vt, drafts = res[:, :k + 1], res[:, k + 1:]
            accept_len, committed, n_emit = accept_spec(drafts, vt)
            # fed == emitted per row, so the rollback's length is the
            # previous one plus the emitted count; finished rows freeze
            new_len = prev_len.copy()
            for i in range(b):
                if done[i]:
                    continue
                used = 0
                for t in committed[i, :n_emit[i]]:
                    toks[i].append(int(t))
                    used += 1
                    if (eos is not None and int(t) == eos) \
                            or len(toks[i]) >= max_new:
                        done[i] = True
                        break
                new_len[i] = prev_len[i] + used
            prev_len = new_len
            pending = vt[rows_b, accept_len]
            for lo, rows, *_, rounds in parts:
                rounds.rollback(new_len[lo:lo + rows], pending[lo:lo + rows])
            self.rounds += 1
            active = int(active_mask.sum())
            accepted = int(accept_len[active_mask].sum())
            self.drafted += active * k
            self.accepted += accepted
            parts[0].rounds.commit()     # the round's plans, the batch's
            if tele is not None:
                tele.ledger_close(h, "spec_round", cat="step",
                                  args={"round": self.rounds,
                                        "active": active})
                tele.inc("repro_spec_rounds_total")
                tele.inc("repro_spec_drafted_total", active * k)
                tele.inc("repro_spec_accepted_total", accepted)
        for *_, rounds in parts:
            _sync(rounds.dev)
        decode_s = time.perf_counter() - t0
        if tele is not None:
            tele.gauge("repro_spec_acceptance_rate", self.acceptance_rate())
            tele.gauge("repro_spec_verify_traces", v._verify_builds)
        v._save_tuning(searches)
        return [GenerationResult(tokens=toks[i], prefill_s=prefill_s / b,
                                 decode_s=decode_s / b, steps=len(toks[i]))
                for i in range(b)]

    # -- round-boundary scheduling: factories over the schedulers below ----
    def continuous(self, n_slots: int = 4, n_frames: Optional[int] = None
                   ) -> "SpecContinuousScheduler":
        """Continuous batching in speculative rounds over the contiguous
        slot pool: queued utterances admit into freed rows at round
        boundaries (the rollback freezes a finished row at length 0)."""
        return SpecContinuousScheduler(self, n_slots=n_slots,
                                       n_frames=n_frames)

    def paged(self, n_slots: int = 4, n_frames: Optional[int] = None,
              **page_cfg) -> "PagedSpecScheduler":
        """Speculative rounds over the paged KV pool: the window scatters
        through the block tables, the pre-round capacity pass gives every
        window position a private page (preempting when the arena is
        dry), and the post-round trim releases the pages a rejected
        suffix crossed into."""
        return PagedSpecScheduler(self, n_slots=n_slots, n_frames=n_frames,
                                  **page_cfg)

    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    def stats(self) -> Dict[str, Any]:
        """The speculative report: acceptance, the capture counters (on
        the CPU nothing is captured) and the ledger's FLOPs by role."""
        out = {"k": self.k, "rounds": self.rounds, "drafted": self.drafted,
               "accepted": self.accepted,
               "acceptance_rate": self.acceptance_rate(),
               "verify_captures": self.verifier._verify_captures,
               "draft_step_captures": self.draft._step_captures}
        if self.verifier.offload is not None:
            out["by_role"] = dict(self.verifier.offload.stats.by_role)
        return out


@dataclass
class SpecScheduler:
    """Waves over a ``SpeculativeEngine``: queued utterances run to
    completion in fixed-width waves (one shape per wave width and frame
    count, short waves padded with zero mels), so steady serving replays
    the engine's programs. The parity reference of the round-boundary
    schedulers below. On a mesh each wave's batch splits over the data
    shards (``SpeculativeEngine.transcribe``), as the reference's waves
    serve on a mesh."""
    engine: SpeculativeEngine
    n_slots: int = 4
    _queue: List[Tuple[int, np.ndarray, int, int]] = field(
        default_factory=list)
    _next_rid: int = 0

    def submit(self, mel, max_new: int = 32, sot_id: int = 1) -> int:
        arr = np.asarray(mel, np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, arr, max_new, sot_id))
        return rid

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def run(self) -> Dict[int, GenerationResult]:
        out: Dict[int, GenerationResult] = {}
        while self._queue:
            wave, self._queue = (self._queue[:self.n_slots],
                                 self._queue[self.n_slots:])
            frames = {q[1].shape[1] for q in wave}
            sots = {q[3] for q in wave}
            if len(frames) > 1 or len(sots) > 1:
                raise ValueError(
                    "a wave must share frame count and SOT token "
                    f"(got frames={sorted(frames)}, sot={sorted(sots)})")
            mels = [q[1] for q in wave]
            pad = self.n_slots - len(wave)
            if pad:
                mels.append(np.zeros((pad, *mels[0].shape[1:]), np.float32))
            batch = np.concatenate(mels, axis=0)
            max_new = max(q[2] for q in wave)
            results = self.engine.transcribe(batch, sot_id=wave[0][3],
                                             max_new=max_new)
            for (rid, _, req_max, _), r in zip(wave, results):
                row = r.tokens[:req_max]
                out[rid] = GenerationResult(
                    tokens=row, prefill_s=r.prefill_s,
                    decode_s=r.decode_s, steps=len(row))
        return out


class _SpecRoundsMixin:
    """Speculative rounds over a slot scheduler, first in the MRO over
    ``ContinuousBatchingScheduler`` or ``PagedScheduler``: the base keeps
    the queue, admission, eviction and attribution, and this swaps the
    decode step for a round at pool width (k + 1 draft steps, one verify
    window over (n_slots, k + 1), ``accept_spec``, one rollback). A round
    boundary is a safe admission point like the step boundary: the
    rollback freezes finished rows at length 0, so an admission overwrites
    a freed row whole.

    The draft mirrors the verifier's pool in a contiguous ``SlotKVPool``
    keyed by the verifier's slot ids (its own free list is not used): a
    draft row lives as long as its verifier slot. The pending token of
    every slot is window column 0, which the base's admission writes as
    its token buffer.

    On a CUDA device the pool's first admission, while no slot is live,
    captures the draft's slot step at ``plan_key("step", "none", n_slots,
    F, role="draft")`` and the verifier's window at ``plan_key("verify",
    quant, n_slots, F, [pages=], role="verify", k=k)``, each once a pool;
    they are the scheduler's graphs. Attribution is the base's: a round's
    wall time splits evenly over the slots active in it, and draft
    admissions (prefill and a preempted request's replay) go to their
    request and to the busy time, so per-request PDP sums to the
    batch's."""

    def _init_spec(self, spec: SpeculativeEngine) -> None:
        v, d = spec.verifier, spec.draft
        if v.mesh is not None or d.mesh is not None:
            # the reference's refusal (its round schedulers are
            # single-device; its waves serve on a mesh)
            raise NotImplementedError(
                "speculative round scheduling is single-device: a round "
                "runs one draft step and one verify window over the whole "
                "pool — use SpecScheduler waves on a mesh")
        self.spec = spec
        self._draft_pool = SlotKVPool(d.cfg, self.n_slots, d.max_len,
                                      n_frames=self.n_frames,
                                      device=d.device)
        self._spec_rounds = _Rounds(
            spec, self.pool.state, self._draft_pool.state, self.n_slots,
            self.n_frames, pages=getattr(self.pool, "plan_geometry", None))
        # the base's admission writes each slot's first token here
        self._token = self._spec_rounds.window[:, :1]
        self._tokens = {self._spec_rounds.dev: self._token}

    # -- admission (a round boundary is a step boundary) --------------------
    def submit(self, payload, max_new: int = 32, sot_id: int = 1) -> int:
        spec = self.spec
        need = max_new + spec.k + 1      # window writes reach position G + k
        cap = min(spec.verifier.max_len, spec.draft.max_len)
        if max_new > 0 and need > cap:
            raise ValueError(
                f"max_len must be >= max_new + k + 1 = {need} "
                f"(verifier {spec.verifier.max_len}, draft "
                f"{spec.draft.max_len})")
        return super().submit(payload, max_new=max_new, sot_id=sot_id)

    def _capture_step(self) -> None:
        """Capture the pool's draft step and verify window (on the card,
        once, before the first admission)."""
        if self._active and self._spec_rounds.programs is None \
                and self.engine.device.type == "cuda":
            raise RuntimeError("the speculative programs are captured before "
                               "the pool's first admission")
        self._spec_rounds.capture()

    def admit(self) -> List[int]:
        # the queue before the base admission pops it: the draft's mirror
        # admission needs each request's payload and SOT
        pend = {q.rid: q for q in self.queue}
        admitted = super().admit()
        if admitted:
            by_rid = {a.rid: slot for slot, a in self._active.items()}
            for rid in admitted:
                self._admit_draft(by_rid[rid], pend[rid])
        return admitted

    def _admit_draft(self, slot: int, req) -> None:
        """Mirror one admission into the draft pool: the draft's batch-1
        prefill (``transcribe``'s program), and after a preemption the
        replay of the tokens streamed so far through its batch-1 step
        program, committed at role "draft". The draft row then holds KV
        for [SOT, e_0..e_{L-2}] at length L with pending token e_{L-1},
        the verifier slot's invariant after every round."""
        d = self.spec.draft
        tele = self.telemetry
        a = self._active[slot]
        tokens = list(a.tokens)          # not empty only after a preemption
        # the ledger span scopes the draft's prefill and replay runs and
        # their commits (the draft shares the verifier's ledger, so an
        # unclaimed commit here would break the exact attribution)
        with obs.maybe_span(tele, "spec_draft_admit", cat="lifecycle",
                            track=obs.request_track(a.rid), rid=a.rid,
                            ledger=True):
            state, plan, wall = d.prefill_one(torch.from_numpy(req.payload))
            if d.offload is not None:
                d.offload.ledger.commit(plan, times=1, role="draft")
            if tokens:
                wall += self._replay_draft(req.sot_id, tokens)
        with torch.no_grad():
            self._draft_pool.insert(slot, state)
        self._busy_s += wall
        a.prefill_s += wall
        if tele is not None:
            tele.instant("spec_admit", rid=a.rid, slot=slot,
                         replayed=len(tokens))
            tele.inc("repro_spec_admissions_total")

    def _replay_draft(self, sot_id: int, tokens: List[int]) -> float:
        """A preempted request's draft replay: its SOT and all but its
        last streamed token through the draft's batch-1 step program over
        its static buffers (the prefill state just run), committed at role
        "draft". Returns the seconds."""
        d = self.spec.draft
        inputs = [sot_id] + tokens[:-1]
        st = d._static_for(1, self.n_frames)
        key = d._key("step", 1, self.n_frames)
        recorded = None
        with torch.no_grad():
            _sync(d.device)
            t0 = time.perf_counter()
            for tok in inputs:
                st.token.fill_(tok)
                run = d._run(key, lambda: d._step_fn(st))
                recorded = run if recorded is None else recorded
            _sync(d.device)
            wall = time.perf_counter() - t0
        if d.offload is not None:
            # a copy: the cache names its plans by key, and ``recorded``
            # may be the batch-1 step graph's, at the plain step key
            plan = d._plan(d._key("step", 1, self.n_frames, role="draft"),
                           DispatchPlan(entries=list(recorded)))
            d.offload.ledger.commit(plan, times=len(inputs), role="draft")
        return wall

    # -- layout hooks (the paged subclass overrides them) ---------------------
    def _pre_round(self, w: int) -> None:
        """Capacity before the round's W writes: nothing to do on the
        contiguous pool (a slot owns max_len positions)."""

    def _evict_slot(self, slot: int, rid: int) -> None:
        self.pool.release(slot, reset=False)

    def _post_round(self, new_len: np.ndarray) -> None:
        """After the rollback: nothing to do on the contiguous pool (stale
        window entries are overwritten)."""

    # -- the round ------------------------------------------------------------
    def decode_step(self) -> List[TokenEvent]:
        """One speculative round at pool width. Emits up to k + 1
        ``TokenEvent``s an active slot (each request's events in step
        order); finished requests are evicted as in the base, and their
        rows freeze at length 0."""
        if not self._active:
            return []
        spec = self.spec
        k = spec.k
        self._pre_round(k + 1)
        if not self._active:             # the capacity pass preempted all
            return []
        self._note_kv_usage()
        rounds = self._spec_rounds
        tele = self.telemetry
        if tele is not None:
            h = tele.ledger_open()
        t0 = time.perf_counter()
        res = rounds.round()
        dt = time.perf_counter() - t0
        self._busy_s += dt
        rounds.commit()
        if tele is not None:
            tele.ledger_close(h, "spec_round", cat="step",
                              args={"active": len(self._active)})
        vt, drafts = res[:, :k + 1], res[:, k + 1:]
        accept_len, committed, n_emit = accept_spec(drafts, vt)
        share = dt / len(self._active)
        now = time.perf_counter()
        eos = spec.verifier.eos_id
        events: List[TokenEvent] = []
        new_len = np.zeros(self.n_slots, np.int64)
        pending = np.zeros(self.n_slots, np.int64)
        drafted = len(self._active) * k
        accepted = 0
        for slot in sorted(self._active):
            a = self._active[slot]
            a.decode_s += share
            accepted += int(accept_len[slot])
            done = False
            for t in committed[slot, :n_emit[slot]]:
                tok = int(t)
                a.tokens.append(tok)
                a.steps += 1
                if a.steps == 1:
                    a.ttft_s = now - a.submit_t
                    if tele is not None:
                        self._buf_ttft.append(a.ttft_s)
                done = (a.steps >= a.max_new
                        or (eos is not None and tok == eos))
                events.append(TokenEvent(a.rid, tok, a.steps, done))
                if done:
                    break
            # fed == emitted per row: the rollback's length is the
            # emitted count, the next feed the last emitted token
            new_len[slot] = a.steps
            pending[slot] = a.tokens[-1]
            if done:
                self.finished[a.rid] = GenerationResult(
                    tokens=a.tokens, prefill_s=a.prefill_s,
                    decode_s=a.decode_s, steps=a.steps,
                    queue_wait_s=a.queue_wait_s, ttft_s=a.ttft_s)
                if tele is not None:
                    tele.instant("evict", rid=a.rid)
                    tele.end(a.rid, "decode", steps=a.steps)
                    self._buf_finished += 1
                del self._active[slot]
                self._evict_slot(slot, a.rid)
                new_len[slot] = 0        # freeze the freed row
                pending[slot] = 0
        rounds.rollback(new_len, pending)
        self._post_round(new_len)
        spec.rounds += 1
        spec.drafted += drafted
        spec.accepted += accepted
        if tele is not None:
            self._buf_tokens += len(events)
            self._buf_steps.append(dt)
            self._buf_shares.append(share)
            tele.inc("repro_spec_rounds_total")
            tele.inc("repro_spec_drafted_total", drafted)
            tele.inc("repro_spec_accepted_total", accepted)
            self._note_gauges(spec.verifier._verify_builds)
        return events


class SpecContinuousScheduler(_SpecRoundsMixin, ContinuousBatchingScheduler):
    """Continuous batching in speculative rounds over the contiguous slot
    pool; build it with ``SpeculativeEngine.continuous()``."""

    def __init__(self, spec: SpeculativeEngine, n_slots: int = 4,
                 n_frames: Optional[int] = None):
        super().__init__(spec.verifier, n_slots=n_slots, n_frames=n_frames)
        self._init_spec(spec)


class PagedSpecScheduler(_SpecRoundsMixin, PagedScheduler):
    """Speculative rounds over the paged KV pool; build it with
    ``SpeculativeEngine.paged()``. Three paged moves a round: the
    pre-round capacity pass gives all k + 1 window positions private pages
    (a window may straddle a page boundary, or span several pages when
    k + 1 exceeds the page size; a dry arena preempts), the window
    scatters through the block tables (``attention.paged_window_update``),
    and the post-round trim releases the pages the rejected suffix crossed
    into, so the arena's accounting is exact after every round. The draft
    stays contiguous (its whole pool is smaller than one verifier arena);
    a preempted request replays into both models when readmitted.
    ``pages_trimmed`` counts the trimmed page references."""

    def __init__(self, spec: SpeculativeEngine, n_slots: int = 4,
                 n_frames: Optional[int] = None, **page_cfg):
        super().__init__(spec.verifier, n_slots=n_slots, n_frames=n_frames,
                         **page_cfg)
        self._init_spec(spec)
        self.pages_trimmed = 0

    def _capture_step(self) -> None:
        """The spec programs, and the draft's batch-1 prefill and step
        graphs (a preempted request's draft replay), while no request
        owns the draft's batch-1 buffers."""
        super()._capture_step()
        d = self.spec.draft
        with torch.no_grad():
            d._prepare(d._static_for(1, self.n_frames),
                       d._key("prefill", 1, self.n_frames),
                       d._key("step", 1, self.n_frames))

    def _pre_round(self, w: int) -> None:
        self._page_capacity_pass(w)
        self.pool.sync()

    def _evict_slot(self, slot: int, rid: int) -> None:
        self.pool.release(slot, reset=False)
        self._payloads.pop(rid, None)

    def _post_round(self, new_len: np.ndarray) -> None:
        # after the rollback, a page whose first position is at or past
        # the new length holds only dead entries
        pool = self.pool
        released = 0
        for slot in sorted(self._active):
            keep = max(-(-int(new_len[slot]) // pool.page_size), 1)
            released += pool.trim_self_pages(slot, keep)
        self.pages_trimmed += released
        if released and self.telemetry is not None:
            self.telemetry.instant("spec_trim", pages=released)
            self.telemetry.inc("repro_spec_pages_trimmed_total", released)
