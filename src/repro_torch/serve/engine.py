"""Serving engine: one-shot batched Whisper transcription with the paper's
offload paths, Q8_0 or dense (FP16), on the H100 or (when asked) the CPU,
and the entry points of continuous batching (``scheduler``,
``submit_audio``, ``run``: ``serve/scheduler.py``).

The system the paper builds in whisper.cpp terms: weights quantized to
Q8_0 on load (or kept dense with ``quant="none"``), every linear routed
through the offload dispatcher (``core/offload.py`` — the burst-aligned
main segment on a Hopper kernel, the residual on the host arm) when one
is attached, and per-request latency for PDP/EDP accounting
(``core/energy.py``, ``energy_report``).

Compiled programs, the counterpart of the reference's ``_prefill_jit`` and
``_step_jit``: the prefill and the greedy decode step are each one
function over static buffers that the engine owns per (batch, frames)
point (``_Static``): the mel input, the self-KV caches and their device
lengths, the cross K/V, the token, the ``done`` mask and the generated
tokens. On a CUDA device each is captured once per plan key
(``plan_key("prefill" | "step", quant, batch, frames)``) into a
``torch.cuda.CUDAGraph``, after one warm-up run on a side stream that
builds the kernels and records the key's ``DispatchPlan``; ``transcribe``
replays the graphs, with one host sync a step (the ``done.all()`` test).
Capture and warm-up are set-up, outside the request's timers. A capture
that fails raises: nothing falls back to the eager loop. On the CPU the
same functions are called directly, each run recorded apart. Either way
the ledger is accounted only by committing the plans: the prefill's once,
the step's once per step taken. The eager ``prefill()`` and ``step()``
stay public. ``prefill_one`` runs the batch-1 prefill program for the
scheduler's admissions; the scheduler's slot step is a program of its own
over its pool (its graph is the scheduler's, its plan this engine's at
``plan_key("step", quant, n_slots, F)``, with the page geometry appended
for a paged pool: ``paged_scheduler``, ``serve/paging.py``).

Speculative decoding (``speculative``, ``serve/speculative.py``) adds two
programs over slot-layout buffers that its caller owns: the verify window
(``_verify_fn``: a (B, k + 1) window scored in one forward, at
``plan_key("verify", quant, B, F, role="verify", k=k)``; its captures
count in ``_verify_captures``) and the draft step (``_draft_fn``: one
step whose token is read from and written to a window column, at
``plan_key("step", quant, B, F, role="draft")``). ``_capture`` captures
either, as it captures the prefill and the step.

With an autotuner on the offload engine (``OffloadEngine(tuner=...)``),
every linear routes by a tuned plan entry: the burst and the kernel's
launch tile come from the tuner's cache. The engine warms the tuner at
construction (whisper's shapes at 1 x 1500 frames) and in ``transcribe``
for the request's batch and frames, before any timer and before any
capture, and saves the cache when a search ran (after the request, where
a plan's first query of a shape the warm-up did not enumerate searched);
a capture then records and replays the tuned launches, and a replay
consults no tuner.

Telemetry (``obs.Telemetry``, ``telemetry=``; None by default): the
engine binds the offload ledger to it after warming the tuner (warm-up
commits predate the consistency window) and makes it the process-global
active handle. ``transcribe`` wraps its prefill and its decode, each with
its plan commit, in ``prefill`` and ``decode`` ledger spans; a program's
build is a ``plan_build`` span (the capture on the card, the plan-cache
miss on the CPU). The executor's ``repro_dispatch_total`` counts each
linear once per program build: a capture's warm-up on the card, a key's
first run on the CPU (``_record_run``); every other pass runs under
``executor.quiet_dispatch()``. No telemetry call runs inside a capture.

Token contract: ``GenerationResult.tokens`` holds exactly the ``steps``
tokens the request generated — the SOT seed token is not echoed — and rows
that hit EOS before the batch drained are truncated at their first EOS with
``steps`` reported per request.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Hashable, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends import executor
from repro_torch.configs.base import ModelConfig
from repro_torch.core import energy
from repro_torch.core.device import resolve_device
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import DispatchPlan, PlanCache, plan_key
from repro_torch.core.qformats import quantize_tree
from repro_torch.models import model as model_lib
from repro_torch.models import whisper as whisper_lib


@dataclass
class GenerationResult:
    tokens: List[int]       # the ``steps`` generated tokens (no SOT)
    prefill_s: float
    decode_s: float
    steps: int
    # the scheduler's lifecycle timings: wall time queued before admission,
    # and submit -> first streamed token. The one-shot ``transcribe`` has
    # no queue, so both stay 0.0 there.
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    def pdp_j(self, power_w: float) -> float:
        """PDP at ``power_w`` watts — the caller's figure for its card."""
        return energy.pdp(self.total_s, power_w)

    def edp_js(self, power_w: float) -> float:
        return energy.edp(self.total_s, power_w)


def _keep_dense(path, leaf) -> bool:
    """Quantization predicate mirroring whisper.cpp: quantize big GEMM
    weights, keep norms / biases / positional tables dense. Biases are
    matched by their full leaf name ('b'), not a substring."""
    parts = [str(k).lower() for k in path]
    name = "/".join(parts)
    if parts and parts[-1] in ("b", "bias", "conv_w", "conv_b"):
        return False
    if any(s in name for s in ("norm", "pos", "a_log", "dt_bias", "router")):
        return False
    return True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class _Static:
    """The buffers of one (batch, frames) point, which the prefill and
    step programs read and write in place: a captured graph rereads the
    storage it was captured with."""
    mel: torch.Tensor               # (B, F, n_mels) f32
    state: model_lib.ServeState     # self-KV + lengths, cross K/V, step
    token: torch.Tensor             # (B, 1) int64: the last token
    done: torch.Tensor              # (B,) bool
    tokens: torch.Tensor            # (B, max_len) int64: step i in column i


class _Program(NamedTuple):
    graph: torch.cuda.CUDAGraph
    plan: DispatchPlan              # recorded by the warm-up run


@dataclass
class ServeEngine:
    cfg: ModelConfig
    params: Any
    max_len: int = 512
    quant: Optional[str] = None          # None -> cfg.quant
    offload: Optional[OffloadEngine] = None
    eos_id: Optional[int] = 0
    device: Any = "cuda"
    # the nullable observability handle: None keeps every instrumentation
    # site one ``is not None`` test; a Telemetry instruments the engine,
    # its schedulers and the paged pool, binds the offload ledger for
    # span FLOP attribution, and becomes the active handle
    telemetry: Optional[obs.Telemetry] = None
    _plans: PlanCache = field(default_factory=PlanCache, repr=False)
    _static: Dict[Tuple[int, int], _Static] = field(default_factory=dict,
                                                    repr=False)
    _graphs: Dict[Hashable, _Program] = field(default_factory=dict,
                                              repr=False)
    #: step graphs captured: rises only at a new (batch, frames) key, and
    #: once per continuous-batching pool (its slot step)
    _step_captures: int = field(default=0, repr=False)
    #: verify-window graphs captured: once per speculative (batch, frames,
    #: k) point, and once per speculative scheduler's pool
    _verify_captures: int = field(default=0, repr=False)
    _scheduler: Any = field(default=None, repr=False)
    #: plan keys whose program has run on the CPU (its build counted)
    _built: set = field(default_factory=set, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        params = model_lib.to_device(self.params, self.device)
        self._serve_quant = self.quant if self.quant is not None \
            else self.cfg.quant
        self._serve_params = (quantize_tree(params, _keep_dense)
                              if self._serve_quant == "q8_0" else params)
        self._eos = -1 if self.eos_id is None else int(self.eos_id)
        self._save_tuning(self._warm_tuning())
        if self.telemetry is not None:
            # bind AFTER the tuner's warm-up: its commits predate the
            # consistency window, so span-claimed FLOPs start from zero
            # exactly where the ledger baseline does
            if self.offload is not None:
                self.telemetry.bind_ledger(self.offload.ledger)
            obs.activate(self.telemetry)

    def _warm_tuning(self, **shape) -> Optional[int]:
        """Warm the offload engine's tuner (if any) for whisper's shapes
        at ``shape`` (``warm_tuning``'s frames, tokens and batch; the
        canonical 1 x 1500 frames by default). Returns the tuner's search
        count before warming, for ``_save_tuning``; None without a
        tuner."""
        tuner = self.offload.tuner if self.offload is not None else None
        if tuner is None:
            return None
        n0 = tuner.searches
        whisper_lib.warm_tuning(self.cfg, self.offload,
                                quant=self._serve_quant, **shape)
        return n0

    def _save_tuning(self, searches_before: Optional[int]) -> None:
        """Save the tuner's cache if a search ran since
        ``searches_before`` (a warm-up's, or a plan's first query of a
        shape the warm-up did not enumerate)."""
        if (searches_before is not None
                and self.offload.tuner.searches > searches_before):
            self.offload.tuner.save()

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy pick over the true vocab (vocab_pad columns excluded)."""
        return logits[..., :self.cfg.vocab_size].argmax(dim=-1)

    def _key(self, phase: str, batch: int, frames: int, *,
             pages: Optional[Tuple[Hashable, ...]] = None,
             role: Optional[str] = None,
             k: Optional[int] = None) -> Hashable:
        return plan_key(phase, self._serve_quant, batch, frames, pages=pages,
                        role=role, k=k)

    def _recording(self, plan: DispatchPlan):
        """Record the routing of a program run into ``plan`` (accounting
        nothing) when an offload engine is attached."""
        if self.offload is None:
            return nullcontext()
        return self.offload.recording(plan)

    def _plan(self, key: Hashable,
              recorded: DispatchPlan) -> Optional[DispatchPlan]:
        """The key's plan from the cache; a miss keeps ``recorded`` (on
        the CPU, in a ``plan_build`` span: the card's is the capture)."""
        if self.offload is None:
            return None
        tele = self.telemetry
        if (tele is not None and self.device.type != "cuda"
                and key not in self._plans.plans):
            with tele.span("plan_build", cat="engine",
                           args={"key": str(key)}):
                return self._plans.get_or_build(key, lambda: recorded)
        return self._plans.get_or_build(key, lambda: recorded)

    # -- eager entry points ------------------------------------------------
    def prefill(self, mel: torch.Tensor):
        """Encoder once per utterance batch, then each decoder layer's
        cross K/V (paper Fig 1), run eagerly. mel: (B, F, n_mels) on the
        engine's device. Returns (memory, decode state)."""
        with torch.inference_mode():
            memory = whisper_lib.encode(self._serve_params, self.cfg, mel,
                                        engine=self.offload)
            state = model_lib.init_serve_state(
                self._serve_params, self.cfg, mel.shape[0], self.max_len,
                memory=memory, engine=self.offload)
        return memory, state

    def step(self, token: torch.Tensor, state):
        """One eager decode step: token (B, 1) -> (logits (B, 1, V),
        state'), the state advanced in place. Raises, before the step
        runs, when the self-KV cache is full."""
        ls = state.layer_states
        if int(ls.self_kv[0].length) >= ls.self_kv[0].k.shape[1]:
            raise ValueError(f"KV cache full: {ls.self_kv[0].k.shape[1]} "
                             "positions")
        with torch.inference_mode():
            return model_lib.serve_step(self._serve_params, self.cfg, token,
                                        state, engine=self.offload)

    # -- the compiled programs ---------------------------------------------
    def _static_for(self, b: int, f: int) -> _Static:
        st = self._static.get((b, f))
        if st is None:
            dev = self.device
            st = self._static[(b, f)] = _Static(
                mel=torch.zeros((b, f, self.cfg.n_mels), device=dev),
                state=model_lib.zeros_serve_state(self.cfg, b, f,
                                                  self.max_len, device=dev),
                token=torch.zeros((b, 1), dtype=torch.long, device=dev),
                done=torch.zeros((b,), dtype=torch.bool, device=dev),
                tokens=torch.zeros((b, self.max_len), dtype=torch.long,
                                   device=dev))
        return st

    def _prefill_fn(self, st: _Static) -> None:
        """The prefill program: the encoder over ``st.mel`` and each
        layer's cross K/V written into ``st``; the self-KV caches, their
        lengths, ``step`` and ``done`` reset."""
        params, cfg, eng = self._serve_params, self.cfg, self.offload
        memory = whisper_lib.encode(params, cfg, st.mel, engine=eng)
        cross = whisper_lib.precompute_cross_kv(params, cfg, memory,
                                                engine=eng)
        ls = st.state.layer_states
        for (k, v), (k_buf, v_buf) in zip(cross, ls.cross_kv):
            k_buf.copy_(k)
            v_buf.copy_(v)
        for kv in ls.self_kv:
            kv.k.zero_()
            kv.v.zero_()
            kv.length.zero_()
        st.state.step.zero_()
        st.done.zero_()

    def _step_fn(self, st: _Static) -> None:
        """The greedy step program (the reference's ``step_fn``): one
        decode step from ``st.token``, the argmax over the true vocabulary
        written to ``st.token`` and to column ``step`` of ``st.tokens``,
        and its EOS test folded into ``st.done``, all on the device."""
        logits, _ = model_lib.serve_step(self._serve_params, self.cfg,
                                         st.token, st.state,
                                         engine=self.offload)
        nxt = self._argmax(logits[:, -1])[:, None]
        col = (st.state.step - 1).to(torch.long).reshape(1)
        st.tokens.index_copy_(1, col, nxt)
        st.token.copy_(nxt)
        st.done.logical_or_(nxt[:, 0] == self._eos)

    def _verify_fn(self, state: model_lib.ServeState, window: torch.Tensor,
                   out: torch.Tensor) -> None:
        """The verify program (the reference's ``verify_fn``): the first W
        = (out's width + 1) / 2 columns of ``window`` (B, >= W), the pending
        token and the k drafts, scored in one forward over the slot-layout
        ``state`` (every counter advanced by W); the verifier's argmax at
        each position written to ``out[:, :W]`` and the drafts to
        ``out[:, W:]``, so that the round reads both in one host sync."""
        w = (out.shape[1] + 1) // 2
        logits, _ = model_lib.verify_step(self._serve_params, self.cfg,
                                          window[:, :w], state,
                                          engine=self.offload)
        out[:, :w].copy_(self._argmax(logits))
        out[:, w:].copy_(window[:, 1:w])

    def _draft_fn(self, state: model_lib.ServeState, window: torch.Tensor,
                  col: torch.Tensor) -> None:
        """The draft step program: one decode step of every row of the
        slot-layout ``state`` from window column ``col`` (a (1,) device
        index), its argmax written to column ``col + 1`` and ``col``
        advanced, all on the device, so that k + 1 runs of one captured
        step fill the window's drafts (the last run's argmax lands in a
        scratch column)."""
        logits, _ = model_lib.serve_step(self._serve_params, self.cfg,
                                         window.index_select(1, col), state,
                                         engine=self.offload)
        window.index_copy_(1, col + 1, self._argmax(logits[:, -1])[:, None])
        col.add_(1)

    def _capture(self, key: Hashable, fn: Callable[[], None]) -> _Program:
        """Warm ``fn`` up on a side stream (its kernels build; its plan is
        recorded), then capture it into a CUDA graph. The capture pass is
        recorded apart, counts no dispatch and must route as the warm-up
        did. With telemetry, the whole build is one ``plan_build`` span,
        recorded outside the capture. Raises if the capture fails: there
        is no eager fallback."""
        dev = self.device
        plan, again = DispatchPlan(key=key), DispatchPlan(key=key)
        graph = torch.cuda.CUDAGraph()
        with obs.maybe_span(self.telemetry, "plan_build", cat="engine",
                            args={"key": str(key)}), torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), self._recording(plan):
                fn()
            torch.cuda.current_stream(dev).wait_stream(side)
            with self._recording(again), executor.quiet_dispatch(), \
                    torch.cuda.graph(graph):
                fn()
        if again.signature() != plan.signature():
            raise RuntimeError(f"capture of {key} routed differently from "
                               "its warm-up")
        if key[0] == "step":
            self._step_captures += 1
        elif key[0] == "verify":
            self._verify_captures += 1
        return _Program(graph, plan)

    def _prepare(self, st: _Static, pre_key: Hashable,
                 step_key: Optional[Hashable] = None) -> None:
        """On a CUDA device, capture the prefill (and the step, when
        ``step_key`` is given) at their keys' first request. The step's
        warm-up advances the decode state; the prefill that runs next
        resets it."""
        if self.device.type != "cuda":
            return
        if pre_key not in self._graphs:
            self._graphs[pre_key] = self._capture(
                pre_key, lambda: self._prefill_fn(st))
        if step_key is not None and step_key not in self._graphs:
            self._graphs[step_key] = self._capture(
                step_key, lambda: self._step_fn(st))

    def _run(self, key: Hashable,
             fn: Callable[[], None]) -> DispatchPlan:
        """One run of a program: its graph replayed on the card, or ``fn``
        called on the CPU under a fresh recording. Returns the plan of the
        run (on the card, the one its warm-up recorded)."""
        if self.device.type == "cuda":
            prog = self._graphs[key]
            prog.graph.replay()
            return prog.plan
        return self._record_run(key, fn)

    def _record_run(self, key: Hashable,
                    fn: Callable[[], None]) -> DispatchPlan:
        """``fn``, a program's Python, called on the CPU under a fresh
        recording; returns the run's plan. Only the key's first run here
        (the program's build) counts its dispatches."""
        plan = DispatchPlan(key=key)
        quiet = (executor.quiet_dispatch() if key in self._built
                 else nullcontext())
        self._built.add(key)
        with self._recording(plan), quiet:
            fn()
        return plan

    def _greedy_loop(self, st: _Static, step_key: Hashable,
                     max_new: int) -> Dict[str, Any]:
        recorded = None
        steps = 0
        t0 = time.perf_counter()
        for _ in range(max_new):
            plan = self._run(step_key, lambda: self._step_fn(st))
            if recorded is None:
                recorded = plan
            steps += 1
            if bool(st.done.all()):          # one host sync per step
                break
        out = st.tokens[:, :steps].cpu().numpy()
        return {"tokens": out, "decode_s": time.perf_counter() - t0,
                "steps": steps, "plan": recorded}

    def _finalize(self, r: Dict[str, Any], prefill_s: float
                  ) -> List[GenerationResult]:
        """Per-request results: each row truncated at its first EOS
        (inclusive), ``steps`` its own generated count."""
        out = r["tokens"]
        b = out.shape[0]
        eos = self.eos_id
        results = []
        for i in range(b):
            row = out[i].tolist()
            if eos is not None and eos in row:
                row = row[:row.index(eos) + 1]
            results.append(GenerationResult(
                tokens=row, prefill_s=prefill_s / b,
                decode_s=r["decode_s"] / b, steps=len(row)))
        return results

    def transcribe(self, mel, sot_id: int = 1,
                   max_new: int = 32) -> List[GenerationResult]:
        """Whisper path: encoder once per utterance batch, cross-KV
        projected once, autoregressive greedy decode (paper Fig 1), each
        phase one program run (a graph replay on the card). ``mel``: (B,
        F, n_mels) numpy array or tensor."""
        if max_new > self.max_len:
            raise ValueError(f"KV cache full: {max_new} new tokens need "
                             f"more than max_len={self.max_len} positions")
        mel_t = torch.as_tensor(mel, dtype=torch.float32)
        b, f = mel_t.shape[0], mel_t.shape[1]
        pre_key, step_key = self._key("prefill", b, f), self._key("step", b, f)
        searches = self._warm_tuning(n_frames=f, batch=b, n_tokens=max_new)
        tele = self.telemetry
        with torch.no_grad():
            st = self._static_for(b, f)
            st.mel.copy_(mel_t)
            self._prepare(st, pre_key, step_key)
            # each ledger span scopes one phase's run(s) and its commit,
            # so its FLOP delta is that phase's exact attribution
            with obs.maybe_span(tele, "prefill", cat="engine", ledger=True,
                                args={"batch": b, "frames": f}):
                recorded, prefill_s = self._timed_prefill(st, pre_key)
                if self.offload is not None:
                    self.offload.ledger.commit(self._plan(pre_key, recorded),
                                               times=1)
            st.token.fill_(sot_id)
            with obs.maybe_span(tele, "decode", cat="engine", ledger=True,
                                args={"batch": b}):
                r = self._greedy_loop(st, step_key, max_new)
                if self.offload is not None and r["plan"] is not None:
                    self.offload.ledger.commit(
                        self._plan(step_key, r["plan"]), times=r["steps"])
        self._save_tuning(searches)
        return self._finalize(r, prefill_s)

    def _timed_prefill(self, st: _Static, key: Hashable
                       ) -> Tuple[DispatchPlan, float]:
        """One run of the prefill program over ``st`` (captured first on the
        card, outside the timer, if its key has no graph yet): the run's
        plan and its seconds, host clock, synchronized."""
        self._prepare(st, key)
        _sync(self.device)
        t0 = time.perf_counter()
        recorded = self._run(key, lambda: self._prefill_fn(st))
        _sync(self.device)
        return recorded, time.perf_counter() - t0

    def prefill_one(self, mel: torch.Tensor
                    ) -> Tuple[model_lib.ServeState, Optional[DispatchPlan],
                               float]:
        """One run of the batch-1 prefill program of ``transcribe`` at
        ``plan_key("prefill", quant, 1, F)`` (a graph replay on the card):
        the continuous-batching scheduler's admission. ``mel``: (1, F,
        n_mels). Returns the program's decode state (the engine's static
        buffers, which the next run at the key overwrites: the caller
        copies it out first), the key's cached plan (None without an
        offload engine) and the run's seconds. Commits nothing."""
        key = self._key("prefill", 1, mel.shape[1])
        with torch.no_grad():
            st = self._static_for(1, mel.shape[1])
            st.mel.copy_(mel)
            recorded, prefill_s = self._timed_prefill(st, key)
        return st.state, self._plan(key, recorded), prefill_s

    # -- continuous batching: wrappers over the slot scheduler ---------------
    def scheduler(self, n_slots: Optional[int] = None,
                  n_frames: Optional[int] = None):
        """The engine's continuous-batching scheduler. With no arguments
        (or matching geometry) the existing scheduler is returned; an
        explicit geometry change builds a new pool, refusing while the old
        scheduler still holds queued or active requests or unclaimed
        results. ``n_frames``, the pool's fixed mel capacity, is needed on
        first creation (``submit_audio`` infers it from the first
        utterance); dimensions left as None keep the live scheduler's."""
        from repro_torch.serve.scheduler import ContinuousBatchingScheduler
        s = self._scheduler
        want_slots = n_slots if n_slots is not None else \
            (s.n_slots if s is not None else 4)
        want_frames = n_frames if n_frames is not None else \
            (s.n_frames if s is not None else None)
        if (s is None or s.n_slots != want_slots
                or s.n_frames != want_frames):
            if s is not None and (s.n_queued or s.n_active or s.finished):
                raise RuntimeError(
                    "scheduler geometry change with requests in flight or "
                    "unclaimed results — drain with run() first")
            self._scheduler = ContinuousBatchingScheduler(
                self, n_slots=want_slots, n_frames=want_frames)
        return self._scheduler

    def speculative(self, draft_cfg: ModelConfig, draft_params: Any, *,
                    k: int = 4, draft_quant: str = "none"):
        """A speculative-decoding engine over this verifier
        (``serve/speculative.py``): the ``draft_cfg``/``draft_params``
        model (whisper-tiny against a base or small verifier) proposes
        ``k`` tokens a round, this engine's verify program scores the
        k + 1 window, and greedy acceptance keeps the tokens exactly those
        of ``transcribe``.

        The draft is a dense ``ServeEngine`` on this engine's device with
        its ``max_len`` and ``eos_id``. With an offload engine attached,
        the draft's has the same burst and budget and shares this engine's
        ledger: one ledger for two models, its FLOPs split by role. The
        reference pins its draft to its plain backend; the port has none
        on a card, so its draft runs on the Hopper kernels too
        (``bf16_matmul``)."""
        from repro_torch.serve.speculative import SpeculativeEngine
        draft_offload = None
        if self.offload is not None:
            draft_offload = OffloadEngine(
                vmem_budget_kb=self.offload.vmem_budget_kb,
                burst=self.offload.burst, ledger=self.offload.ledger)
        draft = ServeEngine(draft_cfg, draft_params, max_len=self.max_len,
                            quant=draft_quant, offload=draft_offload,
                            eos_id=self.eos_id, device=self.device)
        return SpeculativeEngine(verifier=self, draft=draft, k=k)

    def paged_scheduler(self, n_slots: int = 4,
                        n_frames: Optional[int] = None, **page_cfg):
        """A paged-pool continuous-batching scheduler over this engine
        (``serve/paging.py``): page arenas instead of per-slot
        preallocation, whole-utterance prefix sharing, and admission that
        oversubscribes logical slots against physical pages with
        preempt-and-recompute. Built fresh per call, as the reference's:
        the page geometry (``page_size``, ``n_pages``, ``cross_page_size``,
        ``n_cross_pages``) is the workload's and the caller owns the
        instance; ``scheduler()`` stays the contiguous path."""
        from repro_torch.serve.paging import PagedScheduler
        return PagedScheduler(self, n_slots=n_slots, n_frames=n_frames,
                              **page_cfg)

    def submit_audio(self, mel, max_new: int = 32, *,
                     n_slots: Optional[int] = None,
                     n_frames: Optional[int] = None, sot_id: int = 1) -> int:
        """Queue one utterance (F, n_mels) / (1, F, n_mels), padded to the
        pool's frame capacity. ``n_frames`` fixes that capacity on the
        first call; omitted, it is this utterance's frame count."""
        if self._scheduler is None and n_frames is None:
            arr = np.asarray(mel)
            n_frames = int(arr.shape[0] if arr.ndim == 2 else arr.shape[1])
        return self.scheduler(n_slots, n_frames).submit(
            mel, max_new=max_new, sot_id=sot_id)

    def run(self, on_token=None) -> Dict[int, GenerationResult]:
        """Drain the scheduler: admit, decode and evict until queue and
        slots are empty, streaming tokens through ``on_token``. Returns
        {request id: GenerationResult}."""
        if self._scheduler is None:
            return {}
        return self._scheduler.run(on_token=on_token)

    def energy_report(self, results: List[GenerationResult],
                      platform_w: float) -> Dict[str, Any]:
        """Latency and PDP/EDP of ``results`` at ``platform_w`` watts (the
        card's power limit or a sampled draw: there is no default), the
        offload rate, and with an offload engine the dispatch counters (and
        with a tuner, its cache hits and misses, searches and tuned
        calls)."""
        total_s = sum(r.total_s for r in results)
        rep = {
            "requests": len(results),
            "total_s": total_s,
            "mean_s": total_s / max(len(results), 1),
            "pdp_j": energy.pdp(total_s, platform_w),
            "edp_js": energy.edp(total_s, platform_w),
            "offload_rate": (self.offload.stats.offload_rate()
                             if self.offload else 0.0),
        }
        if self.offload is not None:
            rep["dispatch"] = {"plans": len(self._plans),
                               "plan_hits": self._plans.hits,
                               "plan_misses": self._plans.misses,
                               "ledger_commits": self.offload.ledger.commits,
                               "by_backend": dict(
                                   self.offload.stats.by_backend),
                               # FLOPs by role (a speculative engine's
                               # draft and verify); sums to the ledger's
                               # FLOP totals
                               "by_role": dict(
                                   self.offload.stats.by_role)}
        if self.offload is not None and self.offload.tuner is not None:
            t = self.offload.tuner
            rep["tuning"] = {"cache_hits": t.cache.hits,
                             "cache_misses": t.cache.misses,
                             "searches": t.searches,
                             "tuned_calls": self.offload.stats.tuned_calls}
        return rep
