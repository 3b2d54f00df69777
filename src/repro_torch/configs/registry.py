"""Architecture registry of the port: ``--arch <id>`` -> (CONFIG, SMOKE).

The port serves every arch of the reference: the Whisper ladder and the
dense, mixture-of-experts, state-space, hybrid and vision-language
decoder-only LMs. ``LATER`` names the reference's archs that the port does
not serve yet, each with the ROADMAP item that brings it (none now); an
id that is neither raises ``KeyError``. ``ASSIGNED`` names the ten archs
of the reference's dry-run matrix (the Whisper ladder's base and small
are extra), and ``dryrun_cells`` walks that matrix against ``ALL_SHAPES``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (
    arctic_480b, internlm2_20b, jamba_v0_1_52b, llava_next_mistral_7b,
    mamba2_780m, olmoe_1b_7b, phi3_mini_3_8b, qwen1_5_110b, qwen2_5_14b, whisper_base, whisper_small,
    whisper_tiny)
from repro_torch.configs.base import ALL_SHAPES, SHAPES_BY_NAME, \
    ModelConfig, ShapeConfig, shape_applicable

ALL_ARCHS: Dict[str, object] = {
    "whisper-tiny": whisper_tiny,
    "whisper-base": whisper_base,
    "whisper-small": whisper_small,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "qwen2.5-14b": qwen2_5_14b,
    "internlm2-20b": internlm2_20b,
    "qwen1.5-110b": qwen1_5_110b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "arctic-480b": arctic_480b,
    "mamba2-780m": mamba2_780m,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
}

#: the archs of the dry-run matrix, in the reference's order
ASSIGNED = ("llava-next-mistral-7b", "jamba-v0.1-52b", "mamba2-780m",
            "phi3-mini-3.8b", "qwen1.5-110b", "internlm2-20b", "qwen2.5-14b",
            "whisper-tiny", "arctic-480b", "olmoe-1b-7b")

#: the reference's archs the port does not serve yet, with the ROADMAP
#: item that brings each
LATER: Dict[str, str] = {}


def _module(arch: str):
    if arch in LATER:
        raise KeyError(f"arch {arch!r} is not in the port yet: it comes with "
                       f"ROADMAP item {LATER[arch]}")
    if arch not in ALL_ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def dryrun_cells():
    """Yield every (arch, shape, applicable, reason) cell of the matrix."""
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            ok, reason = shape_applicable(cfg, shape)
            yield arch, shape.name, ok, reason
