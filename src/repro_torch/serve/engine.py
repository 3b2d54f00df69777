"""Serving engine: one-shot batched Whisper transcription and LM generation
(dense, MoE, SSM and hybrid) with the paper's offload paths, Q8_0 or
dense (FP16),
on the H100 or (when asked) the CPU, and the entry points of continuous
batching (``scheduler``, ``submit_audio``, ``submit``, ``run``:
``serve/scheduler.py``).

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

An LM (``generate``) has one program a batch B: the greedy step
(``_lm_step_fn``) over static buffers of its own (``_LMStatic``: the
prompt, its length, the caches and counters, the token, ``done`` and the
generated tokens), captured on the card at ``plan_key("step", quant,
B)``. It reads its input token from the prompt buffer at its own device
position while that position is inside the prompt, else from the last
argmax, so the prefill is the reference's scan of the step: the same
graph replayed once a prompt token (the caches and counters zeroed and
the prompt copied in first), with no capture per prompt length. The
prefill's plan is the step's entries at ``plan_key("prefill", quant, B,
S)``, committed S times, as the reference's scan body; the last prefill
step's argmax is the first decode step's input, not a generated token.
``prefill_prompt`` runs the batch-1 prefill for the scheduler's LM
admissions. An SSM or hybrid LM serves the same way: its SSM layers'
conv windows and states are zeroed with the caches at each load, which
starts their recurrence. A MoE LM (and the hybrid jamba, whose FFNs are
half MoE) serves in bf16 only: the reference quantizes its expert stacks
into Q8_0 and then fails on them (``check_servable``).

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

Sharded serving (``mesh=``, a ``launch.mesh.Mesh``): slot-axis data
parallelism over the mesh's "data" axis, one controller for the whole
mesh. The weights are placed per ``sharding.serve_param_specs``,
replicated over "data", one copy a distinct physical device (four
``cuda:0`` entries share one); ``offload.mesh_sig`` is stamped and every
plan key carries the mesh (``plan_key(..., mesh=)``). The engine's
device is the mesh's first data device. A scheduler's pool splits its
slots into data shards (``serve/kvcache.py``), runs one captured slot
step a shard on that shard's device and commits the step's plan once a
step; an admission's prefill runs on the target shard's device
(``prefill_one``/``prefill_prompt`` take ``device=``). One-shot
``transcribe``/``generate`` split their batch over the data shards where
the "batch" token resolves (``sharding.ctx``), each shard's rows through
its own buffers and graphs on its device, the linears planned at the
whole batch (``ctx.shard_program``), and run on the first device
otherwise; either way the keys carry the mesh. ``_step_builds`` counts
step-key builds: once a key, however many shard graphs it captured
(``_step_captures`` counts graphs). ``energy_report()["dispatch"]``
gains ``by_device``. Where a MoE layer's capacity claim would span the
data shards and can drop (``moe.spans_shards``), a one-shot batch runs as one
program on the first device, and a scheduler's step as one program over
its pool (``serve/scheduler.py``).

Tensor parallelism over "model" (a mesh with ``model > 1``): the weights
are placed by ``serve_param_specs`` (``sharding.rules.place``: a split
leaf's parts on the model devices that hold them, views of one copy
where entries repeat a device), and each data shard's serving tree
(``rules.serve_tree``, keyed by its first device) holds whole what its
first model device computes and, under ``rules.TP_KEY``, the slices of
the attentions, dense FFNs, experts and vocabulary that
``rules.tp_layout``/``vocab_layout`` split; a width that does not divide
runs whole there, with the reason those functions give. The programs
run each split sub-block over the data shard's model shards
(``models/transformer.py``), each attention over its own KV cache slice
(``_kv_devices``); on the card a data shard's model shards share its one
captured graph, and a data shard over distinct cards is refused. The
paged pool splits its page arenas the same way (``serve/paging.py``),
and a speculative draft engine shares the verifier's mesh, placing its
own tree: the two models may hold different layouts (whisper-tiny's 6
heads whole on four model shards beside whisper-base's 8 split).

Token contract: ``GenerationResult.tokens`` holds exactly the ``steps``
tokens the request generated — the SOT seed token and an LM's prompt are
not echoed — and rows
that hit EOS before the batch drained are truncated at their first EOS with
``steps`` reported per request.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Hashable, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends import executor
from repro_torch.configs.base import ModelConfig
from repro_torch.core import energy
from repro_torch.core.device import gc_paused, resolve_device
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import DispatchPlan, PlanCache, plan_key
from repro_torch.core.qformats import quantize_tree
from repro_torch.launch.mesh import physical_device
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import whisper as whisper_lib
from repro_torch.models.attention import first_shard, shard_list
from repro_torch.models.ssm import SSMState
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding import rules as shard_rules


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


def check_servable(cfg: ModelConfig, quant: str) -> None:
    """Raise ``NotImplementedError`` for a model the port does not serve at
    ``quant``: a model with MoE layers (the MoE family, the hybrid jamba)
    in Q8_0. There the reference's ``quantize_tree``
    turns the 3-D expert stacks into ``QTensor``, and its ``moe_ffn`` then
    fails on them (``AttributeError: 'QTensor' object has no attribute
    'astype'``, ``repro/models/moe.py:121``); the port serves such a model
    with ``quant="none"`` and falls back to nothing."""
    if quant == "q8_0" and cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: a MoE model is not served in Q8_0 (the reference "
            "quantizes its expert stacks and its moe_ffn then fails: "
            "'QTensor' object has no attribute 'astype', moe.py:121); "
            "serve it with quant='none'")


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
    device: Any = None              # the physical device of the buffers
    tag: Any = None                 # a data shard's buffers: (device, shard)


@dataclass
class _LMStatic:
    """The buffers of an LM's one-shot batch point, which its step program
    reads and writes in place."""
    prompt: torch.Tensor            # (B, max_len) int64: the prompt in :S
    plen: torch.Tensor              # () int64: the prompt's length
    state: model_lib.ServeState     # the caches and lengths, step
    token: torch.Tensor             # (B, 1) int64: the last argmax
    done: torch.Tensor              # (B,) bool
    tokens: torch.Tensor            # (B, max_len) int64: step i in column i
    device: Any = None              # the physical device of the buffers
    tag: Any = None                 # a data shard's buffers: (device, shard)


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
    # the serving mesh (module docstring): None serves on ``device``
    mesh: Optional[Any] = None
    # the nullable observability handle: None keeps every instrumentation
    # site one ``is not None`` test; a Telemetry instruments the engine,
    # its schedulers and the paged pool, binds the offload ledger for
    # span FLOP attribution, and becomes the active handle
    telemetry: Optional[obs.Telemetry] = None
    _plans: PlanCache = field(default_factory=PlanCache, repr=False)
    _static: Dict[Tuple[int, int], _Static] = field(default_factory=dict,
                                                    repr=False)
    _lm_static: Dict[int, _LMStatic] = field(default_factory=dict,
                                             repr=False)
    _graphs: Dict[Hashable, _Program] = field(default_factory=dict,
                                              repr=False)
    #: step graphs captured: rises only at a new (batch, frames) key, and
    #: once per continuous-batching pool (its slot step)
    _step_captures: int = field(default=0, repr=False)
    #: verify-window graphs captured: once per speculative (batch, frames,
    #: k) point, and once per speculative scheduler's pool
    _verify_captures: int = field(default=0, repr=False)
    #: step-key builds: one a key, whatever number of data shards' graphs
    #: it captured (the reference's step traces)
    _step_builds: int = field(default=0, repr=False)
    #: verify-window builds: one a key, whatever its shards' graphs
    _verify_builds: int = field(default=0, repr=False)
    _scheduler: Any = field(default=None, repr=False)
    #: plan keys whose program has run on the CPU (its build counted)
    _built: set = field(default_factory=set, repr=False)

    def __post_init__(self):
        mesh = self.mesh
        if mesh is not None:
            if mesh.is_abstract:
                raise ValueError("serving needs a mesh of devices, not an "
                                 "abstract mesh")
            self.device = mesh.axis_devices("data")[0]
        self.device = resolve_device(self.device)
        self._phys = physical_device(self.device)
        self._serve_quant = self.quant if self.quant is not None \
            else self.cfg.quant
        check_servable(self.cfg, self._serve_quant)
        params = model_lib.to_device(self.params, self.device)
        self._serve_params = (quantize_tree(params, _keep_dense)
                              if self._serve_quant == "q8_0" else params)
        # {physical device: the serving weights there}; over "model", a
        # data shard's first device holds its serving tree
        self._placed = {self._phys: self._serve_params}
        # {a data shard's first device: its model devices where its
        # attention (and so its KV caches) split over them}
        self._kv_devices: Dict[torch.device, Optional[tuple]] = {}
        # {a data shard's first device: its model devices}
        self._model_devices: Dict[torch.device, tuple] = {}
        if mesh is not None:
            for d in mesh.physical_devices:
                resolve_device(d)
            specs = shard_rules.serve_param_specs(self._serve_params, mesh)
            placed = shard_rules.place(self._serve_params, mesh, specs)
            if mesh.shape.get("model", 1) > 1:
                self._place_model_shards(placed, specs)
            else:
                self._placed.update(placed)
                self._placed[self._phys] = self._serve_params
            if self.offload is not None:
                self.offload.mesh_sig = shard_rules.mesh_signature(mesh)
        self._eos = -1 if self.eos_id is None else int(self.eos_id)
        self._save_tuning(self._warm_tuning())
        if self.telemetry is not None:
            # bind AFTER the tuner's warm-up: its commits predate the
            # consistency window, so span-claimed FLOPs start from zero
            # exactly where the ledger baseline does
            if self.offload is not None:
                self.telemetry.bind_ledger(self.offload.ledger)
            obs.activate(self.telemetry)

    def _place_model_shards(self, placed: dict, specs) -> None:
        """Tensor parallelism over "model": each data shard's serving tree
        (``shard_rules.serve_tree``) from the placement, keyed by the
        shard's first device, and the devices its KV caches split over
        where its attention is split. A CUDA data shard whose model
        entries are distinct cards is refused: its step is one captured
        graph, which cannot span cards."""
        cfg, mesh = self.cfg, self.mesh
        for row in mesh.shard_devices():
            devs = tuple(physical_device(d) for d in row)
            if devs[0].type == "cuda" and len(set(devs)) > 1:
                raise NotImplementedError(
                    "serving over 'model' across distinct cards is not "
                    "ported: a data shard's step is one CUDA graph "
                    "(ROADMAP item 14b)")
            if devs[0] in self._model_devices:
                if self._model_devices[devs[0]] != devs:
                    raise NotImplementedError(
                        "data shards on one device with other model "
                        "devices (ROADMAP item 14b)")
                continue
            tree = shard_rules.serve_tree(cfg, placed, specs, mesh, devs,
                                          layers.VocabShards)
            self._placed[devs[0]] = tree
            self._model_devices[devs[0]] = devs
            self._kv_devices[devs[0]] = (
                devs if shard_rules.attention_split(tree) else None)

    def _warm_tuning(self, **shape) -> Optional[int]:
        """Warm the offload engine's tuner (if any) for whisper's shapes
        at ``shape`` (``warm_tuning``'s frames, tokens and batch; the
        canonical 1 x 1500 frames by default). Returns the tuner's search
        count before warming, for ``_save_tuning``; None without a
        tuner."""
        tuner = self.offload.tuner if self.offload is not None else None
        if tuner is None or self.cfg.family != "audio":
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

    def _params_on(self, device) -> Any:
        """The serving weights on ``device`` (a physical device of the
        mesh, or the engine's)."""
        return self._placed[physical_device(device)
                            if device is not None else self._phys]

    def _batch_shards(self, b: int) -> int:
        """Data shards a one-shot batch of ``b`` rows splits over: the mesh's
        data axis where ctx's "batch" token resolves for ``b``, else 1;
        1 too where a MoE layer's capacity claim would span the shards
        (``moe.spans_shards``): the batch then runs as one program."""
        mesh = self.mesh
        if mesh is None or mesh.shape.get("data", 1) <= 1:
            return 1
        if shard_ctx._resolve("batch", b, mesh) is None:
            return 1
        n = mesh.shape["data"]
        return 1 if moe_lib.spans_shards(self.cfg, b // n, n) else n

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy pick over the true vocab (vocab_pad columns excluded)."""
        return logits[..., :self.cfg.vocab_size].argmax(dim=-1)

    def _key(self, phase: str, batch: int, *extra: Hashable,
             pages: Optional[Tuple[Hashable, ...]] = None,
             role: Optional[str] = None,
             k: Optional[int] = None) -> Hashable:
        """``plan_key(phase, quant, batch, *extra)``: whisper's extra is the
        frame count; an LM's prefill's the prompt length, its step none."""
        return plan_key(phase, self._serve_quant, batch, *extra,
                        mesh=self.mesh, pages=pages, role=role, k=k)

    @contextmanager
    def _recording(self, plan: DispatchPlan):
        """Record the routing of a program run into ``plan`` (accounting
        nothing) when an offload engine is attached. On a mesh the run's
        Python runs with the mesh active, as the reference traces its
        programs (``sharding.ctx.activation_sharding``): every linear's
        output passes ``ctx.constrain``, which resolves its tokens on the
        mesh and checks their rank."""
        with (self.offload.recording(plan) if self.offload is not None
              else nullcontext()), \
                (shard_ctx.activation_sharding(self.mesh)
                 if self.mesh is not None else nullcontext()):
            yield

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
    def prefill(self, x: torch.Tensor):
        """The prefill, run eagerly. Whisper: the encoder once per utterance
        batch, then each decoder layer's cross K/V (paper Fig 1); ``x`` is
        the mel (B, F, n_mels) and it returns (memory, decode state). An
        LM: ``serve_step`` over the prompt ``x`` (B, S) int; it returns
        (the last token's logits (B, 1, V), decode state). ``x`` on the
        engine's device."""
        if self.cfg.family != "audio":
            with torch.inference_mode():
                state = model_lib.init_serve_state(
                    self._serve_params, self.cfg, x.shape[0], self.max_len)
                return model_lib.prefill(self._serve_params, self.cfg, x,
                                         state, engine=self.offload)
        with torch.inference_mode():
            memory = whisper_lib.encode(self._serve_params, self.cfg, x,
                                        engine=self.offload)
            state = model_lib.init_serve_state(
                self._serve_params, self.cfg, x.shape[0], self.max_len,
                memory=memory, engine=self.offload)
        return memory, state

    def step(self, token: torch.Tensor, state):
        """One eager decode step: token (B, 1) -> (logits (B, 1, V),
        state'), the state advanced in place. Raises, before the step
        runs, when the self-KV cache is full (an attention-free model's
        state has no positions to fill)."""
        ls = state.layer_states
        kv = next((st for st in ls if not isinstance(st, SSMState)), None) \
            if isinstance(ls, list) else ls.self_kv[0]
        kv = first_shard(kv)
        if kv is not None and int(kv.length.max()) >= kv[0].shape[1]:
            raise ValueError(f"KV cache full: {kv[0].shape[1]} positions")
        with torch.inference_mode():
            return model_lib.serve_step(self._serve_params, self.cfg, token,
                                        state, engine=self.offload)

    # -- the compiled programs ---------------------------------------------
    def _static_for(self, b: int, f: int, device=None,
                    shard: Optional[int] = None) -> _Static:
        """The buffers at (b, f) on ``device`` (the engine's by default);
        a one-shot data shard's own, tagged, with ``shard``."""
        dev = physical_device(device) if device is not None else self._phys
        tag = None if (dev == self._phys and shard is None) else (dev, shard)
        skey = (b, f) if tag is None else (b, f, tag)
        st = self._static.get(skey)
        if st is None:
            st = self._static[skey] = _Static(
                mel=torch.zeros((b, f, self.cfg.n_mels), device=dev),
                state=model_lib.zeros_serve_state(
                    self.cfg, b, f, self.max_len, device=dev,
                    kv_devices=self._kv_devices.get(dev)),
                token=torch.zeros((b, 1), dtype=torch.long, device=dev),
                done=torch.zeros((b,), dtype=torch.bool, device=dev),
                tokens=torch.zeros((b, self.max_len), dtype=torch.long,
                                   device=dev), device=dev, tag=tag)
        return st

    def _gkey(self, key: Hashable, st) -> Hashable:
        """The graph key of a program at plan key ``key`` over ``st``."""
        return key if st.tag is None else (key, st.tag)

    def _prefill_fn(self, st: _Static) -> None:
        """The prefill program: the encoder over ``st.mel`` and each
        layer's cross K/V written into ``st``; the self-KV caches, their
        lengths, ``step`` and ``done`` reset."""
        params, cfg, eng = self._params_on(st.device), self.cfg, self.offload
        memory = whisper_lib.encode(params, cfg, st.mel, engine=eng)
        cross = whisper_lib.precompute_cross_kv(params, cfg, memory,
                                                engine=eng)
        ls = st.state.layer_states
        for src, buf in zip(model_lib.state_tensors(cross),
                            model_lib.state_tensors(ls.cross_kv),
                            strict=True):
            buf.copy_(src)
        for kv in ls.self_kv:
            for c in shard_list(kv):
                c.k.zero_()
                c.v.zero_()
                c.length.zero_()
        st.state.step.zero_()
        st.done.zero_()

    def _step_fn(self, st: _Static) -> None:
        """The greedy step program (the reference's ``step_fn``): one
        decode step from ``st.token``, the argmax over the true vocabulary
        written to ``st.token`` and to column ``step`` of ``st.tokens``,
        and its EOS test folded into ``st.done``, all on the device."""
        logits, _ = model_lib.serve_step(self._params_on(st.device), self.cfg,
                                         st.token, st.state,
                                         engine=self.offload)
        nxt = self._argmax(logits[:, -1])[:, None]
        col = (st.state.step - 1).to(torch.long).reshape(1)
        st.tokens.index_copy_(1, col, nxt)
        st.token.copy_(nxt)
        st.done.logical_or_(nxt[:, 0] == self._eos)

    def _verify_fn(self, state: model_lib.ServeState, window: torch.Tensor,
                   out: torch.Tensor, device=None) -> None:
        """The verify program (the reference's ``verify_fn``): the first W
        = (out's width + 1) / 2 columns of ``window`` (B, >= W), the pending
        token and the k drafts, scored in one forward over the slot-layout
        ``state`` (every counter advanced by W); the verifier's argmax at
        each position written to ``out[:, :W]`` and the drafts to
        ``out[:, W:]``, so that the round reads both in one host sync."""
        w = (out.shape[1] + 1) // 2
        logits, _ = model_lib.verify_step(self._params_on(device), self.cfg,
                                          window[:, :w], state,
                                          engine=self.offload)
        out[:, :w].copy_(self._argmax(logits))
        out[:, w:].copy_(window[:, 1:w])

    def _draft_fn(self, state: model_lib.ServeState, window: torch.Tensor,
                  col: torch.Tensor, device=None) -> None:
        """The draft step program: one decode step of every row of the
        slot-layout ``state`` from window column ``col`` (a (1,) device
        index), its argmax written to column ``col + 1`` and ``col``
        advanced, all on the device, so that k + 1 runs of one captured
        step fill the window's drafts (the last run's argmax lands in a
        scratch column)."""
        logits, _ = model_lib.serve_step(self._params_on(device), self.cfg,
                                         window.index_select(1, col), state,
                                         engine=self.offload)
        window.index_copy_(1, col + 1, self._argmax(logits[:, -1])[:, None])
        col.add_(1)

    def _capture(self, key: Hashable, fn: Callable[[], None], *,
                 device=None, pool=None, build: bool = True) -> _Program:
        """Warm ``fn`` up on a side stream (its kernels build; its plan is
        recorded), then capture it into a CUDA graph. The capture pass is
        recorded apart, counts no dispatch and must route as the warm-up
        did. With telemetry, the whole build is one ``plan_build`` span,
        recorded outside the capture. Raises if the capture fails: there
        is no eager fallback.

        A data shard's program is captured on its ``device`` (the
        engine's by default), in that device's context and on a stream of
        its own, into the memory ``pool`` its device's shards share (a
        ``torch.cuda.graph_pool_handle()``; None: a pool of its own). The
        graphs of one key's shards are one build: only the first
        (``build``) counts a step build, a ``plan_build`` span and its
        warm-up's dispatches."""
        dev = physical_device(device) if device is not None else self._phys
        plan, again = DispatchPlan(key=key), DispatchPlan(key=key)
        graph = torch.cuda.CUDAGraph()
        span = (obs.maybe_span(self.telemetry, "plan_build", cat="engine",
                               args={"key": str(key)}) if build
                else nullcontext())
        with span, torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), self._recording(plan), \
                    (nullcontext() if build else executor.quiet_dispatch()):
                fn()
            torch.cuda.current_stream(dev).wait_stream(side)
            with self._recording(again), executor.quiet_dispatch(), \
                    gc_paused(), torch.cuda.graph(graph, pool=pool):
                fn()
        if again.signature() != plan.signature():
            raise RuntimeError(f"capture of {key} routed differently from "
                               "its warm-up")
        if key[0] == "step":
            self._step_captures += 1
            self._step_builds += build
        elif key[0] == "verify":
            self._verify_captures += 1
            self._verify_builds += build
        return _Program(graph, plan)

    def _prepare(self, st: _Static, pre_key: Hashable,
                 step_key: Optional[Hashable] = None) -> None:
        """On a CUDA device, capture the prefill (and the step, when
        ``step_key`` is given) at their keys' first request. The step's
        warm-up advances the decode state; the prefill that runs next
        resets it."""
        if self.device.type != "cuda":
            return
        first = st.tag is None or st.tag[1] in (None, 0)
        gpre = self._gkey(pre_key, st)
        if gpre not in self._graphs:
            self._graphs[gpre] = self._capture(
                pre_key, lambda: self._prefill_fn(st), device=st.device,
                build=first)
        gstep = None if step_key is None else self._gkey(step_key, st)
        if gstep is not None and gstep not in self._graphs:
            self._graphs[gstep] = self._capture(
                step_key, lambda: self._step_fn(st), device=st.device,
                build=first)

    def _run(self, key: Hashable, fn: Callable[[], None],
             st=None) -> DispatchPlan:
        """One run of a program: its graph (over ``st``'s buffers, the
        default ones when None) replayed on the card, or ``fn`` called on
        the CPU under a fresh recording. Returns the plan of the run (on
        the card, the one its warm-up recorded)."""
        if self.device.type == "cuda":
            prog = self._graphs[key if st is None else self._gkey(key, st)]
            prog.graph.replay()
            return prog.plan
        return self._record_run(key, fn)

    def _record_run(self, key: Hashable,
                    fn: Callable[[], None]) -> DispatchPlan:
        """``fn``, a program's Python, called on the CPU under a fresh
        recording; returns the run's plan. Only the key's first run here
        (the program's build) counts its dispatches and, for a step key,
        a step build."""
        plan = DispatchPlan(key=key)
        built = key in self._built
        quiet = executor.quiet_dispatch() if built else nullcontext()
        if not built and key[0] == "step":
            self._step_builds += 1
        self._built.add(key)
        with self._recording(plan), quiet:
            fn()
        return plan

    def _greedy_loop(self, st, step_key: Hashable, max_new: int,
                     fn: Optional[Callable[[], None]] = None,
                     start: int = 0) -> Dict[str, Any]:
        """Up to ``max_new`` runs of the step program (``fn``; whisper's
        ``_step_fn`` by default), one host sync a step, stopping when every
        row is done; the tokens are columns ``start`` on of ``st.tokens``."""
        fn = fn if fn is not None else (lambda: self._step_fn(st))
        recorded = None
        steps = 0
        t0 = time.perf_counter()
        for _ in range(max_new):
            plan = self._run(step_key, fn, st)
            if recorded is None:
                recorded = plan
            steps += 1
            if bool(st.done.all()):          # one host sync per step
                break
        out = st.tokens[:, start:start + steps].cpu().numpy()
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

    def _shard_rows(self, b: int):
        """The one-shot data shards of a batch of ``b`` rows: [(shard, its
        device, its first row, its rows)], one entry (None, the engine's
        device, 0, b) when the batch does not split."""
        n = self._batch_shards(b)
        if n == 1:
            return [(None, self._phys, 0, b)]
        devs = self.mesh.axis_devices("data")
        return [(s, physical_device(devs[s]), s * (b // n), b // n)
                for s in range(n)]

    def _commit_steps(self, step_key: Hashable,
                      runs: List[Dict[str, Any]]) -> None:
        """Commit the step plan once a step the batch took: the shards'
        longest loop (one plan describes the whole batch's step)."""
        if self.offload is not None and runs[0]["plan"] is not None:
            self.offload.ledger.commit(
                self._plan(step_key, runs[0]["plan"]),
                times=max(r["steps"] for r in runs))

    def _finalize_shards(self, runs: List[Dict[str, Any]], rows: List[int],
                         prefill_s: float) -> List[GenerationResult]:
        """The shards' results in row order, each shard's rows finalized
        on its own loop (a row's share of the prefill is the batch's)."""
        b = sum(rows)
        return [res for r, n in zip(runs, rows)
                for res in self._finalize(r, prefill_s * n / b)]

    def transcribe(self, mel, sot_id: int = 1,
                   max_new: int = 32) -> List[GenerationResult]:
        """Whisper path: encoder once per utterance batch, cross-KV
        projected once, autoregressive greedy decode (paper Fig 1), each
        phase one program run (a graph replay on the card). ``mel``: (B,
        F, n_mels) numpy array or tensor. On a mesh whose data axis
        divides B, each data shard runs its rows on its device (the
        module's docstring)."""
        if max_new > self.max_len:
            raise ValueError(f"KV cache full: {max_new} new tokens need "
                             f"more than max_len={self.max_len} positions")
        mel_t = torch.as_tensor(mel, dtype=torch.float32)
        b, f = mel_t.shape[0], mel_t.shape[1]
        pre_key, step_key = self._key("prefill", b, f), self._key("step", b, f)
        shards = self._shard_rows(b)
        n = len(shards)
        # a shard's launches run its rows (the whole batch unsplit)
        searches = self._warm_tuning(n_frames=f, batch=shards[0][3],
                                     n_tokens=max_new)
        tele = self.telemetry
        with torch.no_grad(), shard_ctx.shard_program(n):
            sts = []
            for s, dev, lo, rows in shards:
                st = self._static_for(rows, f, dev, s)
                st.mel.copy_(mel_t[lo:lo + rows])
                self._prepare(st, pre_key, step_key)
                sts.append(st)
            # each ledger span scopes one phase's run(s) and its commit,
            # so its FLOP delta is that phase's exact attribution
            with obs.maybe_span(tele, "prefill", cat="engine", ledger=True,
                                args={"batch": b, "frames": f}):
                prefill_s = 0.0
                for st in sts:
                    recorded, dt = self._timed_prefill(st, pre_key)
                    prefill_s += dt
                if self.offload is not None:
                    self.offload.ledger.commit(self._plan(pre_key, recorded),
                                               times=1)
            with obs.maybe_span(tele, "decode", cat="engine", ledger=True,
                                args={"batch": b}):
                runs = []
                for st in sts:
                    st.token.fill_(sot_id)
                    runs.append(self._greedy_loop(st, step_key, max_new))
                self._commit_steps(step_key, runs)
        self._save_tuning(searches)
        return self._finalize_shards(runs, [sh[3] for sh in shards],
                                     prefill_s)

    def _timed_prefill(self, st: _Static, key: Hashable
                       ) -> Tuple[DispatchPlan, float]:
        """One run of the prefill program over ``st`` (captured first on the
        card, outside the timer, if its key has no graph yet): the run's
        plan and its seconds, host clock, synchronized."""
        self._prepare(st, key)
        _sync(self.device)
        t0 = time.perf_counter()
        recorded = self._run(key, lambda: self._prefill_fn(st), st)
        _sync(st.device)
        return recorded, time.perf_counter() - t0

    def prefill_one(self, mel: torch.Tensor, device=None
                    ) -> Tuple[model_lib.ServeState, Optional[DispatchPlan],
                               float]:
        """One run of the batch-1 prefill program of ``transcribe`` at
        ``plan_key("prefill", quant, 1, F)`` (a graph replay on the card):
        the continuous-batching scheduler's admission, on ``device`` (a
        data shard's; the engine's by default). ``mel``: (1, F, n_mels).
        Returns the program's decode state (the engine's static buffers
        there, which the next run at the key overwrites: the caller copies
        it out first), the key's cached plan (None without an offload
        engine) and the run's seconds. Commits nothing."""
        key = self._key("prefill", 1, mel.shape[1])
        with torch.no_grad():
            st = self._static_for(1, mel.shape[1], device)
            st.mel.copy_(mel)
            recorded, prefill_s = self._timed_prefill(st, key)
        return st.state, self._plan(key, recorded), prefill_s

    # -- the dense LM's one-shot path -----------------------------------------
    def _lm_static_for(self, b: int, device=None,
                       shard: Optional[int] = None) -> _LMStatic:
        dev = physical_device(device) if device is not None else self._phys
        tag = None if (dev == self._phys and shard is None) else (dev, shard)
        skey = b if tag is None else (b, tag)
        st = self._lm_static.get(skey)
        if st is None:
            st = self._lm_static[skey] = _LMStatic(
                prompt=torch.zeros((b, self.max_len), dtype=torch.long,
                                   device=dev),
                plen=torch.zeros((), dtype=torch.long, device=dev),
                state=model_lib.zeros_serve_state(
                    self.cfg, b, 0, self.max_len, device=dev,
                    kv_devices=self._kv_devices.get(dev)),
                token=torch.zeros((b, 1), dtype=torch.long, device=dev),
                done=torch.zeros((b,), dtype=torch.bool, device=dev),
                tokens=torch.zeros((b, self.max_len), dtype=torch.long,
                                   device=dev), device=dev, tag=tag)
        return st

    def _lm_step_fn(self, st: _LMStatic) -> None:
        """An LM's greedy step program: the input token is the prompt's at
        the state's position while that is inside the prompt, else the
        last argmax; one ``serve_step``, its argmax over the true
        vocabulary written to ``st.token`` and to column ``step`` of
        ``st.tokens``, and its EOS test folded into ``st.done`` only past
        the prompt (the last prompt position's argmax is the first input,
        not a generated token), all on the device."""
        pos = st.state.step.to(torch.long)
        prompt_tok = st.prompt.index_select(
            1, pos.clamp(max=self.max_len - 1).reshape(1))
        decoding = pos >= st.plen
        fed = torch.where(decoding, st.token, prompt_tok)
        logits, _ = model_lib.serve_step(self._params_on(st.device), self.cfg,
                                         fed, st.state, engine=self.offload)
        nxt = self._argmax(logits[:, -1])[:, None]
        st.tokens.index_copy_(1, pos.reshape(1), nxt)
        st.token.copy_(nxt)
        st.done.logical_or_((nxt[:, 0] == self._eos) & decoding)

    def _lm_load(self, st: _LMStatic, prompts: torch.Tensor) -> None:
        """Reset ``st`` for a new batch of prompts (B, S): the caches,
        lengths, step and ``done`` zeroed in place, the prompts copied in."""
        for t in model_lib.state_tensors(st.state):
            t.zero_()
        st.done.zero_()
        st.prompt[:, :prompts.shape[1]].copy_(prompts)
        st.plen.fill_(prompts.shape[1])

    def _lm_prepare(self, b: int, global_b: Optional[int] = None,
                    device=None, shard: Optional[int] = None
                    ) -> Tuple[_LMStatic, Hashable]:
        """Buffers of ``b`` rows on ``device`` and the step key of a batch
        of ``global_b`` (``b`` by default); on a CUDA device the step
        program is captured at the key's first request over these buffers
        (the warm-up's writes are reset by the next load)."""
        st = self._lm_static_for(b, device, shard)
        key = self._key("step", b if global_b is None else global_b)
        gk = self._gkey(key, st)
        if self.device.type == "cuda" and gk not in self._graphs:
            self._graphs[gk] = self._capture(
                key, lambda: self._lm_step_fn(st), device=st.device,
                build=shard in (None, 0))
        return st, key

    def _lm_prefill(self, st: _LMStatic, pre_key: Hashable,
                    step_key: Hashable, s: int) -> Tuple[DispatchPlan, float]:
        """The prefill over the loaded prompts: the step program once a
        prompt token (its graph replayed on the card). Returns the
        prefill's plan (the step's entries at ``pre_key``) and its seconds,
        host clock, synchronized."""
        fn = (lambda: self._lm_step_fn(st))
        prog = (self._graphs[self._gkey(step_key, st)]
                if self.device.type == "cuda" else None)
        _sync(self.device)
        t0 = time.perf_counter()
        recorded = None
        for _ in range(s):
            if prog is not None:
                prog.graph.replay()
            else:
                plan = self._record_run(pre_key, fn)
                recorded = recorded or plan
        _sync(st.device)
        prefill_s = time.perf_counter() - t0
        if recorded is None:                 # the card: the step's routing
            recorded = DispatchPlan(key=pre_key, entries=list(prog.plan))
        return recorded, prefill_s

    def generate(self, prompts, max_new: int = 32) -> List[GenerationResult]:
        """The LMs. prompts: (B, S) int (already padded), numpy or
        tensor. The prefill runs the step program once a prompt token and
        the greedy loop up to ``max_new`` more, each a graph replay on the
        card. Returns one result per row; ``tokens`` are the generated
        tokens only (the module's token contract). On a mesh whose data
        axis divides B, each data shard runs its rows on its device."""
        if self.cfg.family == "audio":
            raise ValueError("generate serves the LM families; whisper "
                             "transcribes (transcribe)")
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long)
        b, s = tokens.shape
        if s + max_new > self.max_len:
            raise ValueError(f"KV cache full: a {s}-token prompt and "
                             f"{max_new} new tokens need more than "
                             f"max_len={self.max_len} positions")
        pre_key = self._key("prefill", b, s)
        tele = self.telemetry
        shards = self._shard_rows(b)
        n = len(shards)
        with torch.no_grad(), shard_ctx.shard_program(n):
            sts = []
            for sh, dev, lo, rows in shards:
                st, step_key = self._lm_prepare(rows, b, dev, sh)
                self._lm_load(st, tokens[lo:lo + rows].to(st.device))
                sts.append(st)
            with obs.maybe_span(tele, "prefill", cat="engine", ledger=True,
                                args={"batch": b, "seq": s}):
                prefill_s = 0.0
                for st in sts:
                    recorded, dt = self._lm_prefill(st, pre_key, step_key, s)
                    prefill_s += dt
                if self.offload is not None:
                    # one plan describes one step; the prefill ran s
                    self.offload.ledger.commit(self._plan(pre_key, recorded),
                                               times=s)
            with obs.maybe_span(tele, "decode", cat="engine", ledger=True,
                                args={"batch": b}):
                runs = [self._greedy_loop(st, step_key, max_new,
                                          fn=lambda st=st: self._lm_step_fn(st),
                                          start=s) for st in sts]
                self._commit_steps(step_key, runs)
        return self._finalize_shards(runs, [sh[3] for sh in shards],
                                     prefill_s)

    def prefill_prompt(self, prompt: torch.Tensor, device=None
                       ) -> Tuple[model_lib.ServeState, torch.Tensor,
                                  Optional[DispatchPlan], float]:
        """The batch-1 prefill of ``generate`` over ``prompt`` (1, S) int:
        the continuous-batching scheduler's LM admission, on ``device`` (a
        data shard's; the engine's by default). Returns the program's
        decode state (the engine's static buffers there, which the next
        run overwrites: the caller copies it out first), the first input
        token (the argmax of the last prompt position, (1, 1) on the
        device), the plan at ``plan_key("prefill", quant, 1, S)`` (None
        without an offload engine) and the run's seconds. Commits
        nothing."""
        s = prompt.shape[1]
        key = self._key("prefill", 1, s)
        with torch.no_grad():
            st, step_key = self._lm_prepare(1, device=device)
            self._lm_load(st, prompt.to(st.device))
            recorded, prefill_s = self._lm_prefill(st, key, step_key, s)
        return st.state, st.token, self._plan(key, recorded), prefill_s

    # -- continuous batching: wrappers over the slot scheduler ---------------
    def scheduler(self, n_slots: Optional[int] = None,
                  n_frames: Optional[int] = None):
        """The engine's continuous-batching scheduler. With no arguments
        (or matching geometry) the existing scheduler is returned; an
        explicit geometry change builds a new pool, refusing while the old
        scheduler still holds queued or active requests or unclaimed
        results. For whisper, ``n_frames``, the pool's fixed mel capacity,
        is needed on first creation (``submit_audio`` infers it from the
        first utterance); an LM's pool has none. Dimensions left as None
        keep the live scheduler's."""
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
        ledger: one ledger for two models, its FLOPs split by role. On a
        mesh the draft shares it and places its own serving tree (its
        attention split or whole by its own widths). The reference pins
        its draft to its plain backend; the port has none on a card, so
        its draft runs on the Hopper kernels too (``bf16_matmul``)."""
        from repro_torch.serve.speculative import SpeculativeEngine
        draft_offload = None
        if self.offload is not None:
            draft_offload = OffloadEngine(
                vmem_budget_kb=self.offload.vmem_budget_kb,
                burst=self.offload.burst, ledger=self.offload.ledger)
        draft = ServeEngine(draft_cfg, draft_params, max_len=self.max_len,
                            quant=draft_quant, offload=draft_offload,
                            eos_id=self.eos_id, device=self.device,
                            mesh=self.mesh)
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

    def submit(self, prompt, max_new: int = 32, *,
               n_slots: Optional[int] = None) -> int:
        """Queue one LM prompt (S,) / (1, S) on the scheduler."""
        return self.scheduler(n_slots).submit(prompt, max_new=max_new)

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
                                   self.offload.stats.by_role),
                               # FLOPs by mesh device (dev0 alone when
                               # unsharded); sums to the ledger's totals
                               "by_device": dict(
                                   self.offload.stats.by_device)}
        if self.offload is not None and self.offload.tuner is not None:
            t = self.offload.tuner
            rep["tuning"] = {"cache_hits": t.cache.hits,
                             "cache_misses": t.cache.misses,
                             "searches": t.searches,
                             "tuned_calls": self.offload.stats.tuned_calls}
        return rep
