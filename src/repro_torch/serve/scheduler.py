"""Continuous-batching serve scheduler over a fixed-shape slot KV pool.

``ServeEngine.transcribe`` and ``generate`` decode static
run-to-completion batches: finished requests keep running steps and new
arrivals wait until the whole batch drains. This scheduler decodes a fixed-width slot batch
instead (``n_slots`` rows, the pool of ``serve/kvcache.py``), admits
queued requests into freed slots between steps, evicts on EOS or
``max_new``, and streams each request's tokens as they are produced.

Per step:
  admit   — one batch-1 prefill per queued request: the engine's one-shot
            prefill program at ``plan_key("prefill", quant, 1, F)`` (on
            the card the graph ``transcribe`` captures at that key), its
            state copied into a free slot (``SlotKVPool.insert``); its
            time and its one plan commit go to that request. An LM's
            prompt of S tokens runs ``generate``'s batch-1 prefill (the
            step graph at ``plan_key("step", quant, 1)`` replayed S
            times, its plan at ``plan_key("prefill", quant, 1, S)``
            committed S times), and the argmax of its last position is the
            slot's first input token, copied on the device.
  decode  — ONE run of the slot step over all ``n_slots`` rows (free
            slots compute garbage: the fixed-shape contract): the decode
            step, the argmax over the true vocabulary, the token written
            back to the scheduler's device token buffer, then one host
            sync to stream the tokens. Its plan commits once per executed
            step and its time is split over the slots active that step,
            so per-request PDP is exact by steps lived and sums to the
            batch's.
  evict   — EOS or ``max_new``: the request's ``GenerationResult`` is
            finalized from its own step count and the slot returns to
            the free list (its row is overwritten whole by the next
            admission).

The slot step is a program of its own over the pool's buffers. On a CUDA
device it is captured into a CUDA graph once per pool, at the pool's first
admission while no slot holds a request (its warm-up run on a side stream
writes garbage into free rows only), and then only replayed; a capture
that fails raises, and nothing falls back to eager steps. Its capture
counts in the engine's ``_step_captures``. Its PLAN key is
``plan_key("step", quant, n_slots, F)`` (an LM's ``plan_key("step",
quant, n_slots)``), the same ``PlanCache`` entry as a ``transcribe`` of
``n_slots`` utterances of F frames (or a ``generate`` of ``n_slots``
prompts: the slot step IS that decode step), while its graph belongs to
the scheduler: the engine's graph at that key runs over the one-shot
path's buffers. On the CPU the program is called directly, each run
recorded apart.

The engine's tuner, if any, is warmed for the pool's shapes (batch 1 and
``n_slots``) at construction, before any capture.

Telemetry (the engine's ``telemetry``, None by default): a request's
lifecycle is a ``queued`` then a ``decode`` phase on its track, with a
``prefill`` ledger span (the admission's prefill run and its commit)
between them, and ``submit``/``evict`` instants; each step is one
``decode_step`` ledger span, opened before the run and closed after the
step's one host sync and its commit, never inside the graph. The hot
path appends to plain lists and ints and sets the gauges only when the
host-side ints they read change; ``flush_telemetry`` (called by ``run()``
and ``attribution()``) drains the buffers into the registry. The
``repro_step_traces`` gauge reads the engine's step builds, the port's
counterpart of the reference's step traces.

Sharded serving (the engine's ``mesh``): the pool splits its slots into
``n_shards`` data shards (``serve/kvcache.py``). An admission's prefill
runs on the target shard's device. A step runs one program a shard over
that shard's rows of the pool and of the token buffer (one tensor a
physical device), on its device, inside ``sharding.ctx.shard_program``:
its linears are planned at the whole step's M (each entry's kernel,
burst and tile its shard's launch's) and its MoE capacity is the whole
step's. Where a MoE layer's capacity claim spans the data
shards and can drop (``moe.spans_shards``), the step is one
program over the whole pool instead, on the one physical device that
holds it, so that the claim is the whole step's (the reference's); over
distinct physical devices such a pool is refused (ROADMAP item 14b). A
serving mesh with "model" above 1 runs each data shard's model shards
inside its program (``models/transformer.py``): on a card they share,
one graph holds them all. On the card each shard's program is captured at the
pool's first admission, on its device, into one graph memory pool a
device; the key is built once (``_step_builds``) and captured n_shards
times (``_step_captures``), then only replayed. Every shard's replay is
launched before the step's host sync, which reads the token buffer once
a physical device. The step's plan, the whole step's, commits once a
step, so the ledger counts the step's FLOPs once; the ledger's
``by_device`` splits them over the mesh's devices.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import energy
from repro_torch.core.plan import DispatchPlan
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib
from repro_torch.serve.engine import GenerationResult, ServeEngine
from repro_torch.serve.kvcache import SlotKVPool
from repro_torch.sharding import ctx as shard_ctx


@dataclass
class TokenEvent:
    """One streamed token: produced by request ``rid`` at its (1-based)
    per-request step ``step``; ``done`` marks the request's last token."""
    rid: int
    token: int
    step: int
    done: bool


@dataclass
class _QueuedRequest:
    rid: int
    payload: np.ndarray          # (1, F, n_mels) mel, padded | (1, S) prompt
    max_new: int
    sot_id: int = 1
    submit_t: float = 0.0        # perf_counter at submit: queue-wait base


@dataclass
class _ActiveSlot:
    rid: int
    max_new: int
    tokens: List[int] = field(default_factory=list)
    steps: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    submit_t: float = 0.0
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0


class ContinuousBatchingScheduler:
    """Slot-batched continuous decode over a ``ServeEngine``.

    The engine supplies the prefill program, the serving weights, the plan
    cache and the offload ledger; the scheduler owns the ``SlotKVPool``,
    the slot step program, the admission queue and per-request
    attribution. ``n_frames`` (audio only) fixes the pool's mel-frame
    capacity: admitted utterances are zero-padded to it, so the prefill
    and the splice see one shape (Whisper pads every utterance to its
    30 s window the same way).
    """

    def __init__(self, engine: ServeEngine, n_slots: int = 4,
                 n_frames: Optional[int] = None):
        self._audio = engine.cfg.family == "audio"
        if self._audio and n_frames is None:
            raise ValueError("audio scheduler needs n_frames (the pool's "
                             "fixed mel-frame capacity)")
        self.engine = engine
        # the engine's nullable telemetry: every instrumentation site below
        # is one ``is not None`` test when off
        self.telemetry = engine.telemetry
        if self.telemetry is not None:
            # pre-resolved per-step instruments and a change-gated gauge
            # cache: the step is what the 3% overhead gate prices, so it
            # pays no registry lookup per metric
            m = self.telemetry.metrics
            self._step_instruments = (m.counter("repro_tokens_total"),
                                      m.histogram("repro_step_seconds"),
                                      m.histogram("repro_token_seconds"))
            self._step_gauges = (m.gauge("repro_queue_depth"),
                                 m.gauge("repro_slots_active"),
                                 m.gauge("repro_step_traces"),
                                 m.gauge("repro_kv_utilization"))
            self._gauge_state = None
            # per-step observations buffer in plain lists and ints and
            # drain into the registry off the hot path (flush_telemetry)
            self._buf_steps: List[float] = []
            self._buf_shares: List[float] = []
            self._buf_ttft: List[float] = []
            self._buf_tokens = 0
            self._buf_finished = 0
        self.n_slots = n_slots
        self.n_frames = n_frames
        self.pool = self._make_pool()
        # a MoE step whose capacity claim spans the data shards runs as
        # one program over the whole pool (one physical device holds it
        # whole, in slot order), which claims as the reference's does
        self._joint = moe_lib.spans_shards(engine.cfg, self.pool.shard_size,
                                           self.pool.n_shards)
        if self._joint and len(self.pool.devices) > 1:
            raise NotImplementedError(
                "a MoE step whose capacity claim spans data shards on "
                "distinct physical devices is not ported: one graph a "
                "device cannot join their expert choices mid-step "
                "(ROADMAP item 14b)")
        # the slot step's launches run a shard's rows
        searches = engine._warm_tuning(n_frames=n_frames, batch=1,
                                       n_tokens=engine.max_len)
        engine._warm_tuning(n_frames=n_frames, batch=self.pool.shard_size,
                            n_tokens=engine.max_len)
        engine._save_tuning(searches)
        self.queue: Deque[_QueuedRequest] = deque()
        self.finished: Dict[int, GenerationResult] = {}
        self._active: Dict[int, _ActiveSlot] = {}      # slot -> request
        # device-resident next-token buffers, one a physical device (a
        # shard's rows its view): each step feeds the previous step's
        # output back without an upload
        self._tokens = self._per_device(1, torch.long)
        self._token = self._tokens[self.pool.devices[0]]
        self._shard_tokens = self._shard_views(self._tokens)
        self._step_key = self._make_step_key()
        self._programs: List = []        # the captured slot step a shard
        self._program = None             # shard 0's (the card)
        self._step_plan: Optional[DispatchPlan] = None
        self._next_rid = 0
        # independently accumulated busy time (every prefill and every
        # batch step, measured whole): the other side of the attribution
        # invariant, not derived from per-request shares. _claimed_s is
        # the busy time of results already handed out by run().
        self._busy_s = 0.0
        self._claimed_s = 0.0
        self.kv_used_peak = 0
        self.active_peak = 0
        self._kv_committed: Optional[int] = None

    def _make_pool(self) -> SlotKVPool:
        """Pool factory: a paged scheduler overrides it to swap in its own
        pool while inheriting the admit/decode/evict loop."""
        eng = self.engine
        return SlotKVPool(eng.cfg, self.n_slots, eng.max_len,
                          n_frames=self.n_frames, device=eng.device,
                          mesh=eng.mesh, kv_devices=eng._kv_devices)

    # -- data shards --------------------------------------------------------
    def _per_device(self, width: int, dtype) -> Dict:
        """{physical device: zeros (rows of its shards, width)}."""
        pool = self.pool
        return {d: torch.zeros((pool.shard_devices.count(d)
                                * pool.shard_size, width), dtype=dtype,
                               device=d)
                for d in pool.devices}

    def _shard_views(self, bufs: Dict) -> List[torch.Tensor]:
        """Each shard's rows of the per-device buffers ``bufs``."""
        pool = self.pool
        return [bufs[d].narrow(0, pool.locate(s * pool.shard_size)[1],
                               pool.shard_size)
                for s, d in enumerate(pool.shard_devices)]

    def _slot_row(self, bufs: Dict, slot: int) -> torch.Tensor:
        """``slot``'s row of the per-device buffers ``bufs``."""
        dev, row = self.pool.locate(slot)
        return bufs[dev][row]

    def _host_rows(self, bufs: Dict) -> List:
        """The per-device buffers ``bufs`` on the host in slot order, as
        lists: one read (one host sync) a physical device, after every
        shard's work was launched."""
        pool = self.pool
        if len(pool.devices) == 1:
            return bufs[pool.devices[0]].tolist()
        host = {d: b.tolist() for d, b in bufs.items()}
        return [row for s, d in enumerate(pool.shard_devices)
                for row in host[d][pool.locate(s * pool.shard_size)[1]:][
                    :pool.shard_size]]

    def _replay_all(self, programs) -> None:
        """Launch every shard's replay (each on its device), in shard
        order; nothing waits."""
        if len(self.pool.devices) == 1:
            for prog in programs:
                prog.graph.replay()
            return
        for prog, d in zip(programs, self._program_devices(), strict=True):
            with torch.cuda.device(d):
                prog.graph.replay()

    def _capture_shards(self, key, fn) -> List:
        """On a CUDA device, capture ``fn(s)`` for every data shard ``s`` at
        plan key ``key``, each on its shard's device, the shards of a
        device in one graph memory pool: one build of the key. The shards'
        plans must agree: each records the whole step's."""
        eng = self.engine
        pool = self.pool
        pools: Dict = {}
        if pool.n_shards > 1:
            for d in pool.devices:
                with torch.cuda.device(d):
                    pools[d] = torch.cuda.graph_pool_handle()
        progs = []
        with torch.no_grad():
            for s, d in enumerate(self._program_devices()):
                progs.append(eng._capture(key, self._shard_fn(fn, s),
                                          device=d, pool=pools.get(d),
                                          build=s == 0))
        sig = progs[0].plan.signature()
        if any(p.plan.signature() != sig for p in progs[1:]):
            raise RuntimeError(f"the data shards of {key} recorded "
                               "different plans")
        return progs

    def _run_shards(self, key, fn) -> DispatchPlan:
        """On the CPU, ``fn(s)`` for every data shard under fresh
        recordings at ``key``; returns shard 0's plan (the whole step's)."""
        eng = self.engine
        plan = None
        with torch.no_grad():
            for s in range(len(self._program_devices())):
                run = eng._record_run(key, self._shard_fn(fn, s))
                plan = plan or run
        return plan

    def _program_devices(self) -> List:
        """The device of each program a step runs: one a data shard, or
        the pool's one device where the step runs as one program
        (``_joint``)."""
        pool = self.pool
        return pool.devices[:1] if self._one_program() else \
            pool.shard_devices

    def _one_program(self) -> bool:
        return self.pool.n_shards == 1 or self._joint

    def _shard_fn(self, fn, s: int):
        """Shard ``s``'s program: ``fn(s)``, or ``fn()`` itself when the
        step is one program."""
        return fn if self._one_program() else partial(fn, s)

    def _in_shard(self):
        """The context a shard's program runs in: one of n_shards."""
        n = self.pool.n_shards
        return (shard_ctx.shard_program(n) if not self._one_program()
                else nullcontext())

    def _make_step_key(self):
        """The slot step's plan key: the one-shot step's at (n_slots,
        F), an LM's at n_slots. A paged scheduler appends its pool's page
        geometry."""
        extra = (self.n_frames,) if self._audio else ()
        return self.engine._key("step", self.n_slots, *extra)

    # -- KV accounting ----------------------------------------------------
    @property
    def kv_committed_bytes(self) -> int:
        if self._kv_committed is None:
            self._kv_committed = self.pool.committed_kv_bytes()
        return self._kv_committed

    @property
    def kv_utilization_peak(self) -> float:
        c = self.kv_committed_bytes
        return self.kv_used_peak / c if c else 0.0

    def _note_kv_usage(self) -> None:
        """Sample KV usage at this step's height: every active slot is
        about to write position ``steps``, so it holds ``steps + 1``
        live entries."""
        lengths = {s: a.steps + 1 for s, a in self._active.items()}
        used = self.pool.used_kv_bytes(lengths)
        if used > self.kv_used_peak:
            self.kv_used_peak = used
        if len(self._active) > self.active_peak:
            self.active_peak = len(self._active)

    # -- queue ------------------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    @property
    def step_captures(self) -> int:
        """The engine's step captures: one for this pool's slot step (one a
        data shard on a mesh), whatever the admission schedule, beside the
        one-shot keys'."""
        return self.engine._step_captures

    def submit(self, payload, max_new: int = 32, sot_id: int = 1) -> int:
        """Queue one request; returns its request id. ``payload`` is a mel
        (F, n_mels) or (1, F, n_mels), zero-padded to the pool's
        ``n_frames``, or for an LM an int prompt (S,) or (1, S), whose
        tokens and ``max_new`` must fit the pool's ``max_len``."""
        arr = np.asarray(payload, dtype=np.float32 if self._audio
                         else np.int64)
        want = 2 if self._audio else 1
        if arr.ndim == want:
            arr = arr[None]
        if arr.ndim != want + 1 or arr.shape[0] != 1:
            # one request per submit: a stacked batch would insert
            # several rows at one slot
            raise ValueError(
                f"submit() takes ONE request — expected shape "
                f"({'F, n_mels' if self._audio else 'S'},) or batch-1, got "
                f"{arr.shape}; submit rows separately")
        if self._audio:
            f = arr.shape[1]
            if f > self.n_frames:
                raise ValueError(f"utterance has {f} frames > pool "
                                 f"capacity {self.n_frames}")
            if f < self.n_frames:
                arr = np.pad(arr, ((0, 0), (0, self.n_frames - f), (0, 0)))
        elif arr.shape[1] + max(max_new, 0) > self.engine.max_len:
            raise ValueError(f"a {arr.shape[1]}-token prompt and {max_new} "
                             f"new tokens do not fit max_len="
                             f"{self.engine.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        if max_new <= 0:
            # the empty result a one-shot max_new=0 returns: the request
            # never takes a slot, nor a prefill
            self.finished[rid] = GenerationResult(tokens=[], prefill_s=0.0,
                                                  decode_s=0.0, steps=0)
            return rid
        self.queue.append(_QueuedRequest(rid, arr, max_new, sot_id,
                                         submit_t=time.perf_counter()))
        tele = self.telemetry
        if tele is not None:
            tele.instant("submit", rid=rid)
            tele.begin(rid, "queued")
            tele.inc("repro_requests_submitted_total")
            tele.gauge("repro_queue_depth", len(self.queue))
        return rid

    # -- the slot step program --------------------------------------------
    def _step_fn(self, s: int = 0) -> None:
        """The slot step program of data shard ``s`` (the whole pool when
        unsharded): one decode step of its slots from its rows of the
        token buffer, the argmax over the true vocabulary written back to
        them, all on its device."""
        eng = self.engine
        pool = self.pool
        if self._one_program():
            state, tok = pool.state, self._token
        else:
            state, tok = pool.shard_states[s], self._shard_tokens[s]
        with self._in_shard():
            logits, _ = model_lib.serve_step(
                eng._params_on(pool.shard_devices[s]), eng.cfg, tok, state,
                engine=eng.offload)
        tok.copy_(eng._argmax(logits[:, -1])[:, None])

    def _capture_step(self) -> None:
        """On a CUDA device, capture the slot step once per pool (once a
        data shard), while no slot holds a request: the capture's warm-up
        run advances the pool and writes garbage into the free rows, which
        every admission overwrites."""
        eng = self.engine
        if self._programs or eng.device.type != "cuda":
            return
        if self._active:
            raise RuntimeError("the slot step is captured before the pool's "
                               "first admission")
        self._programs = self._capture_shards(self._step_key, self._step_fn)
        self._program = self._programs[0]

    def _run_step(self) -> DispatchPlan:
        """One run of the slot step: every shard's graph replayed on the
        card, every shard's program called on the CPU under a fresh
        recording. Returns the step's plan (on the card, the one the
        captures' warm-ups recorded)."""
        if self._programs:
            self._replay_all(self._programs)
            return self._program.plan
        return self._run_shards(self._step_key, self._step_fn)

    # -- admission ----------------------------------------------------------
    def admit(self) -> List[int]:
        """Admit queued requests into free slots (one batch-1 prefill
        each, spliced in place between decode steps). Returns the admitted
        request ids."""
        admitted = []
        eng = self.engine
        tele = self.telemetry
        if self.queue and self.pool.n_free:
            self._capture_step()
        while self.queue and self.pool.n_free:
            req = self.queue.popleft()
            queue_wait = time.perf_counter() - req.submit_t
            if tele is not None:
                tele.end(req.rid, "queued", wait_s=queue_wait)
                tele.observe("repro_queue_wait_seconds", queue_wait)
            # the ledger span scopes this request's prefill run and commit,
            # so its FLOP delta IS the prefill's attribution
            times = 1 if self._audio else req.payload.shape[1]
            with obs.maybe_span(tele, "prefill", cat="lifecycle",
                                track=obs.request_track(req.rid),
                                rid=req.rid, ledger=True):
                # the slot first: the prefill runs on its shard's device
                slot = self.pool.acquire()
                dev = self.pool.locate(slot)[0]
                if self._audio:
                    state, plan, prefill_s = eng.prefill_one(
                        torch.from_numpy(req.payload), device=dev)
                else:
                    state, first, plan, prefill_s = eng.prefill_prompt(
                        torch.from_numpy(req.payload), device=dev)
                self._busy_s += prefill_s
                if eng.offload is not None:
                    eng.offload.ledger.commit(plan, times=times)
            if tele is not None:
                tele.observe("repro_prefill_seconds", prefill_s)
                tele.begin(req.rid, "decode")
            with torch.no_grad():
                self.pool.insert(slot, state)
                if self._audio:
                    self._slot_row(self._tokens, slot).fill_(req.sot_id)
                else:                       # on the device: no host read
                    self._slot_row(self._tokens, slot).copy_(first[0])
            self._active[slot] = _ActiveSlot(rid=req.rid, max_new=req.max_new,
                                             prefill_s=prefill_s,
                                             submit_t=req.submit_t,
                                             queue_wait_s=queue_wait)
            admitted.append(req.rid)
        return admitted

    # -- decode -------------------------------------------------------------
    def decode_step(self) -> List[TokenEvent]:
        """One fixed-shape batch decode step: every slot advances (free
        slots compute garbage that is never read), active slots emit their
        next token, finished requests are evicted. Returns the step's
        ``TokenEvent`` stream in slot order."""
        if not self._active:
            return []
        self._note_kv_usage()
        eng = self.engine
        tele = self.telemetry
        # the step's ledger span scopes the run, the host sync and the one
        # plan commit: its FLOP delta is the step's exact attribution, and
        # it closes after the sync, so it times the step, not the launch.
        # ledger_open/close, not the with-form: the lighter pair is what
        # the 3% overhead gate prices
        if tele is not None:
            h = tele.ledger_open()
        t0 = time.perf_counter()
        plan = self._run_step()
        nxt = [r[0] for r in self._host_rows(self._tokens)]  # host sync
        dt = time.perf_counter() - t0
        self._busy_s += dt
        if self._step_plan is None:
            self._step_plan = eng._plan(self._step_key, plan)
        if eng.offload is not None:
            eng.offload.ledger.commit(self._step_plan, times=1)
        if tele is not None:
            tele.ledger_close(h, "decode_step", cat="step",
                              args={"active": len(self._active)})
        share = dt / len(self._active)
        now = time.perf_counter()
        eos = eng.eos_id
        events = []
        for slot in sorted(self._active):
            a = self._active[slot]
            tok = int(nxt[slot])
            a.tokens.append(tok)
            a.steps += 1
            a.decode_s += share
            if a.steps == 1:
                # time to the first generated token, from submit: queue
                # wait and prefill included
                a.ttft_s = now - a.submit_t
                if tele is not None:
                    self._buf_ttft.append(a.ttft_s)
            done = a.steps >= a.max_new or (eos is not None and tok == eos)
            events.append(TokenEvent(a.rid, tok, a.steps, done))
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
                # reset=False: the next admission overwrites the row
                self.pool.release(slot, reset=False)
        if tele is not None:
            self._buf_tokens += len(events)
            self._buf_steps.append(dt)
            self._buf_shares.append(share)
            self._note_gauges(eng._step_builds)
        return events

    # -- telemetry ------------------------------------------------------------
    def _note_gauges(self, captures: int) -> None:
        """Set the step gauges when the host-side ints they read changed
        (queue depth, active slots, ``captures`` (the step builds), the
        peak KV bytes):
        they move on admissions and evictions, not every step. No device
        tensor is read."""
        g = (len(self.queue), len(self._active), captures,
             self.kv_used_peak)
        if g != self._gauge_state:
            self._gauge_state = g
            gq, gs, gt, gu = self._step_gauges
            gq.set(g[0])
            gs.set(g[1])
            gt.set(g[2])
            gu.set(self.kv_utilization_peak)

    def flush_telemetry(self) -> None:
        """Drain the buffered per-step observations into the registry:
        the hot path appends to plain lists and bumps plain ints, and the
        registry work (bucket search) happens here. Called by ``run()``
        and ``attribution()``; call it after a manual ``admit()``/
        ``decode_step()`` loop before reading metrics."""
        tele = self.telemetry
        if tele is None:
            return
        ctok, hstep, htok = self._step_instruments
        if self._buf_tokens:
            ctok.inc(self._buf_tokens)
            self._buf_tokens = 0
        for v in self._buf_steps:
            hstep.observe(v)
        self._buf_steps.clear()
        for v in self._buf_shares:
            htok.observe(v)
        self._buf_shares.clear()
        for v in self._buf_ttft:
            tele.observe("repro_ttft_seconds", v)
        self._buf_ttft.clear()
        if self._buf_finished:
            tele.inc("repro_requests_finished_total", self._buf_finished)
            tele.inc("repro_evictions_total", self._buf_finished)
            self._buf_finished = 0

    # -- drain ----------------------------------------------------------------
    def run(self, on_token: Optional[Callable[[TokenEvent], Any]] = None
            ) -> Dict[int, GenerationResult]:
        """Drain queue and slots to completion, streaming each token
        through ``on_token``. Returns {rid: GenerationResult} and CLAIMS
        those results: each is handed out once (results of a manual
        ``admit()``/``decode_step()`` drive stay in ``finished`` until a
        ``run()`` claims them)."""
        while self.queue or self._active:
            self.admit()
            for ev in self.decode_step():
                if on_token is not None:
                    on_token(ev)
        out = dict(self.finished)
        self.finished.clear()
        self._claimed_s += sum(r.total_s for r in out.values())
        self.flush_telemetry()
        return out

    # -- attribution ----------------------------------------------------------
    def attribution(self, power_w: float) -> Dict[str, Any]:
        """Per-request PDP at ``power_w`` watts (the card's power limit or
        a sampled draw: there is no default): each unclaimed finished
        request's exact prefill time plus its share of every step it was
        live for. Per-request PDP sums to ``batch_pdp_j``, which comes
        from the independently accumulated busy time (whole prefills and
        whole steps), less the busy time of results ``run()`` already
        claimed; exact once every request has drained."""
        self.flush_telemetry()
        per_req = {rid: r.pdp_j(power_w) for rid, r in self.finished.items()}
        window_s = self._busy_s - self._claimed_s
        return {"per_request_pdp_j": per_req,
                "per_request_queue_wait_s": {
                    rid: r.queue_wait_s for rid, r in self.finished.items()},
                "per_request_ttft_s": {
                    rid: r.ttft_s for rid, r in self.finished.items()},
                "batch_pdp_j": energy.pdp(window_s, power_w),
                "busy_s": window_s,
                "drained": not (self._active or self.queue)}
