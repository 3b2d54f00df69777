"""Serving engine: one-shot batched Whisper transcription with the paper's
offload paths, Q8_0 or dense (FP16), on the H100 or (when asked) the CPU.

The system the paper builds in whisper.cpp terms: weights quantized to
Q8_0 on load (or kept dense with ``quant="none"``), every linear routed
through the offload dispatcher (``core/offload.py`` — the burst-aligned
main segment on a Hopper kernel, the residual on the host arm) when one
is attached, and per-request latency for PDP/EDP accounting
(``core/energy.py``).

Token contract: ``GenerationResult.tokens`` holds exactly the ``steps``
tokens the request generated — the SOT seed token is not echoed — and rows
that hit EOS before the batch drained are truncated at their first EOS with
``steps`` reported per request.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import energy
from repro_torch.core.device import resolve_device
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import DispatchPlan
from repro_torch.core.qformats import quantize_tree
from repro_torch.models import model as model_lib
from repro_torch.models import whisper as whisper_lib


@dataclass
class GenerationResult:
    tokens: List[int]       # the ``steps`` generated tokens (no SOT)
    prefill_s: float
    decode_s: float
    steps: int

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
class ServeEngine:
    cfg: ModelConfig
    params: Any
    max_len: int = 512
    quant: Optional[str] = None          # None -> cfg.quant
    offload: Optional[OffloadEngine] = None
    eos_id: Optional[int] = 0
    device: Any = "cuda"
    #: the routing of the last prefill and of one decode step, per
    #: (phase, batch, frames) key, recorded when ``offload`` is attached
    plans: Dict[Hashable, DispatchPlan] = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        params = model_lib.to_device(self.params, self.device)
        q = self.quant if self.quant is not None else self.cfg.quant
        self._serve_params = (quantize_tree(params, _keep_dense)
                              if q == "q8_0" else params)

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy pick over the true vocab (vocab_pad columns excluded)."""
        return logits[..., :self.cfg.vocab_size].argmax(dim=-1)

    def _record(self, key: Hashable):
        """Record the routing of the next program run under ``key``."""
        if self.offload is None:
            return nullcontext()
        self.plans[key] = DispatchPlan(key=key)
        return self.offload.recording(self.plans[key])

    def prefill(self, mel: torch.Tensor):
        """Encoder once per utterance batch, then each decoder layer's
        cross K/V (paper Fig 1). mel: (B, F, n_mels) on the engine's
        device. Returns (memory, decode state)."""
        with torch.inference_mode():
            memory = whisper_lib.encode(self._serve_params, self.cfg, mel,
                                        engine=self.offload)
            state = model_lib.init_serve_state(
                self._serve_params, self.cfg, mel.shape[0], self.max_len,
                memory=memory, engine=self.offload)
        return memory, state

    def step(self, token: torch.Tensor, state):
        """One decode step: token (B, 1) -> (logits (B, 1, V), state')."""
        with torch.inference_mode():
            return model_lib.serve_step(self._serve_params, self.cfg, token,
                                        state, engine=self.offload)

    def _greedy_loop(self, state, first_token: torch.Tensor, max_new: int,
                     frames: int) -> Dict[str, Any]:
        b = first_token.shape[0]
        eos = -1 if self.eos_id is None else int(self.eos_id)
        token = first_token
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        toks = []
        t0 = time.perf_counter()
        for i in range(max_new):
            with (self._record(("step", b, frames)) if i == 0
                  else nullcontext()):
                logits, state = self.step(token, state)
            token = self._argmax(logits[:, -1])[:, None]
            done = done | (token[:, 0] == eos)
            toks.append(token)
            if bool(done.all()):             # one host sync per step
                break
        _sync(self.device)
        out = (torch.cat(toks, dim=1).cpu().numpy() if toks
               else np.zeros((b, 0), np.int64))
        return {"tokens": out, "decode_s": time.perf_counter() - t0,
                "steps": len(toks), "state": state}

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
        projected once, autoregressive greedy decode (paper Fig 1).
        ``mel``: (B, F, n_mels) numpy array or tensor."""
        mel_t = torch.as_tensor(mel, dtype=torch.float32).to(self.device)
        b, f = mel_t.shape[0], mel_t.shape[1]
        t0 = time.perf_counter()
        with self._record(("prefill", b, f)):
            _, state = self.prefill(mel_t)
        _sync(self.device)
        prefill_s = time.perf_counter() - t0
        first = torch.full((b, 1), sot_id, dtype=torch.long,
                           device=self.device)
        r = self._greedy_loop(state, first, max_new, f)
        return self._finalize(r, prefill_s)
