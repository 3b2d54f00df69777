"""The model API of the port: the audio (Whisper) branches of the
reference's family dispatch (the port's configs are audio-only).

  init_params(gen, cfg, max_positions, device) -> param dict
  init_serve_state(params, cfg, batch, max_len, memory=...) -> ServeState
  serve_step(params, cfg, token, state)        -> (logits, state')
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import layers, whisper


class ServeState(NamedTuple):
    """Decode state: the family's layer states and the absolute position of
    the next token."""
    layer_states: Any     # WhisperDecodeState
    step: int


def to_device(tree, device: torch.device):
    """A parameter tree (dicts and lists of tensors or QTensors) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                max_positions: int = 0, *, device="cuda") -> dict:
    """Random weights from ``gen`` (drawn on the generator's device), placed
    on ``device``."""
    dev = resolve_device(device)
    return to_device(whisper.init_whisper(gen, cfg, max_positions), dev)


def init_serve_state(params: dict, cfg: ModelConfig, batch: int,
                     max_len: int, *, memory: Optional[torch.Tensor] = None,
                     engine=None) -> ServeState:
    if memory is None:
        raise ValueError("whisper decode needs encoder memory")
    st = whisper.init_whisper_decode_state(params, cfg, memory, max_len,
                                           engine=engine,
                                           dtype=layers.DTYPES[cfg.dtype])
    return ServeState(layer_states=st, step=0)


def serve_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
               state: ServeState, *, engine=None
               ) -> Tuple[torch.Tensor, ServeState]:
    """token: (B, 1) int -> (logits (B, 1, V), state')."""
    logits, st = whisper.decode_step(params, cfg, token, state.layer_states,
                                     engine=engine)
    return logits, ServeState(st, state.step + 1)
