"""Deterministic, resumable, host-sharded synthetic data, the reference's
``repro/data/pipeline.py``: ``batch_at(step)`` is a pure function of
(seed, step, host) drawn from ``np.random.SeedSequence([seed, step,
host])`` with numpy, so every batch equals the reference's bit for bit,
and the only pipeline state a checkpoint needs is the step cursor.

Tokens follow a seeded affine map mod the vocabulary (x_{t+1} = a x_t + c,
a learnable sequence); labels are the next-token shift with -1 at the
last position. Whisper's stream adds mel frames that are a seeded
projection of the tokens plus noise; a VLM's adds patch embeddings. The
tensors land on ``device``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataCursor:
    """The pipeline's entire mutable state, checkpointed with the
    parameters."""
    step: int = 0
    seed: int = 0

    def advance(self, n: int = 1) -> "DataCursor":
        return dataclasses.replace(self, step=self.step + n)


class SyntheticLMStream:
    """Next-token-predictable synthetic tokens: x_0 ~ U(vocab), x_{t+1} =
    (a x_t + c) mod vocab with per-sequence (a, c)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 seed: int = 0, num_hosts: int = 1, host_id: int = 0,
                 vocab_cap: Optional[int] = None, device="cpu"):
        if shape.global_batch % num_hosts:
            raise ValueError("global_batch must divide num_hosts")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.local_batch = shape.global_batch // num_hosts
        self.vocab = min(cfg.vocab_size, vocab_cap or cfg.vocab_size)
        self.device = torch.device(device)

    def _rng(self, step: int) -> np.random.Generator:
        # an independent, reconstructible stream per (seed, step, host)
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _arrays(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        b, s, v = self.local_batch, self.shape.seq_len, self.vocab
        x0 = rng.integers(0, v, (b, 1), dtype=np.int64)
        a = rng.integers(1, 8, (b, 1), dtype=np.int64) * 2 + 1  # odd
        c = rng.integers(0, v, (b, 1), dtype=np.int64)
        toks = x0
        seq = np.empty((b, s), dtype=np.int64)
        seq[:, 0] = toks[:, 0]
        for i in range(1, s):
            toks = (a * toks + c) % v
            seq[:, i] = toks[:, 0]
        tokens = seq.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.family == "vlm" and self.cfg.vision_patches:
            p = min(self.cfg.vision_patches, s // 2)
            out["patches"] = rng.standard_normal(
                (b, p, self.cfg.vision_embed_dim), dtype=np.float32)
        return out

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: self._tensor(a) for k, a in self._arrays(step).items()}


class SyntheticMelStream(SyntheticLMStream):
    """Whisper: mel frames + teacher-forced decoder tokens; each token's
    frame is a fixed random embedding of its id plus noise, so the mel
    determines the tokens."""

    def _arrays(self, step: int) -> Dict[str, np.ndarray]:
        base = super()._arrays(step)
        rng = self._rng(step ^ 0x5EED)
        b, s = self.local_batch, self.shape.seq_len
        tok = base["tokens"]
        proj = np.random.default_rng(
            np.random.SeedSequence([self.seed, 7])).standard_normal(
            (self.vocab if self.vocab < 4096 else 4096, self.cfg.n_mels))
        mel = proj[tok % proj.shape[0]] + 0.1 * rng.standard_normal(
            (b, s, self.cfg.n_mels))
        return {"mel": mel.astype(np.float32), "tokens": tok,
                "labels": base["labels"]}


def make_stream(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                num_hosts: int = 1, host_id: int = 0,
                vocab_cap: Optional[int] = None, device="cpu"):
    cls = SyntheticMelStream if cfg.family == "audio" else SyntheticLMStream
    return cls(cfg, shape, seed=seed, num_hosts=num_hosts, host_id=host_id,
               vocab_cap=vocab_cap, device=device)
