"""Architecture registry of the port: ``--arch <id>`` -> (CONFIG, SMOKE).

The port serves the Whisper ladder only; the language-model archs of the
reference come with later slices.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import whisper_base, whisper_small, whisper_tiny
from repro_torch.configs.base import ModelConfig

ALL_ARCHS: Dict[str, object] = {
    "whisper-tiny": whisper_tiny,
    "whisper-base": whisper_base,
    "whisper-small": whisper_small,
}


def _module(arch: str):
    if arch not in ALL_ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
