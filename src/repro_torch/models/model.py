"""The model API of the port: the audio (Whisper) branches of the
reference's family dispatch (the port's configs are audio-only).

  init_params(gen, cfg, max_positions, device) -> param dict
  init_serve_state(params, cfg, batch, max_len, memory=...) -> ServeState
  zeros_serve_state(cfg, batch, frames, max_len, device=...) -> ServeState
  serve_step(params, cfg, token, state)        -> (logits, state')
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import layers, whisper


class ServeState(NamedTuple):
    """Decode state: the family's layer states and the number of steps
    taken, an int32 device scalar advanced in place (the reference's
    standard layout)."""
    layer_states: Any     # WhisperDecodeState
    step: torch.Tensor    # () int32


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
    return ServeState(layer_states=st, step=torch.zeros(
        (), dtype=torch.int32, device=memory.device))


def zeros_serve_state(cfg: ModelConfig, batch: int, frames: int,
                      max_len: int, *, device) -> ServeState:
    """A ServeState of zeros: the static buffers of the serving engine's
    captured prefill and decode step at (batch, frames)."""
    st = whisper.zeros_decode_state(cfg, batch, frames, max_len,
                                    dtype=layers.DTYPES[cfg.dtype],
                                    device=device)
    return ServeState(layer_states=st, step=torch.zeros(
        (), dtype=torch.int32, device=device))


def serve_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
               state: ServeState, *, engine=None
               ) -> Tuple[torch.Tensor, ServeState]:
    """token: (B, 1) int -> (logits (B, 1, V), state'). The state advances
    in place: ``state'`` holds the same tensors as ``state``."""
    logits, _ = whisper.decode_step(params, cfg, token, state.layer_states,
                                    engine=engine)
    state.step.add_(1)
    return logits, state
