"""The serving engine's captured programs on a CUDA device: ``transcribe``
captures the prefill and the greedy step into CUDA graphs at a key's first
request and replays them after. Its tokens equal the eager greedy loop's
(the public ``prefill`` and ``step`` on the same engine) on the Q8_0 and
the dense + flash paths, at the smoke config and at full width; a repeated
key captures nothing, a new batch or frame count captures once; a capture
that fails raises, and nothing falls back to the eager loop.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_graphs_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine

MAX_NEW = 8


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _engine(dev, path="q8_0", full=False, seed=0):
    cfg = get_config("whisper-tiny") if full else \
        get_smoke_config("whisper-tiny")
    if path == "dense+flash":
        cfg = dataclasses.replace(cfg, quant="none", attn_impl="flash")
    params = model.init_params(torch.Generator().manual_seed(seed), cfg,
                               device="cpu")
    return ServeEngine(cfg, params, max_len=MAX_NEW + 8,
                       quant="q8_0" if path == "q8_0" else "none",
                       offload=OffloadEngine(), eos_id=None, device=dev)


def _mel(cfg, b, f, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, f, cfg.n_mels)).astype(np.float32)


def _eager_tokens(eng, mel, max_new=MAX_NEW):
    """The eager greedy loop through the public prefill and step."""
    _, state = eng.prefill(torch.from_numpy(mel).to(eng.device))
    tok = torch.full((mel.shape[0], 1), 1, device=eng.device)
    out = []
    for _ in range(max_new):
        logits, state = eng.step(tok, state)
        tok = eng._argmax(logits[:, -1])[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).cpu().tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("path", ["q8_0", "dense+flash"])
def test_captured_tokens_equal_eager(path, full):
    """Captured and replayed tokens equal the eager loop's, twice in a row
    on one engine (batch 2 at the smoke config, 1 x 1500 frames at full
    width). Both run the same kernels on the same operands, so the tokens
    are exact."""
    dev = _cuda_or_skip()
    eng = _engine(dev, path, full)
    b, f = (1, eng.cfg.encoder_ctx) if full else (2, 64)
    mel = _mel(eng.cfg, b, f)
    want = _eager_tokens(eng, mel)
    for _ in range(2):
        res = eng.transcribe(mel, max_new=MAX_NEW)
        assert [r.tokens for r in res] == want
        assert [r.steps for r in res] == [MAX_NEW] * b
    assert eng._step_captures == 1


@pytest.mark.gpu
def test_recaptures_only_on_a_new_key():
    """A repeated (batch, frames) key replays; a new batch or frame count
    captures once more. The plan cache counts one miss per new key and
    phase, and a hit for each repeat."""
    dev = _cuda_or_skip()
    eng = _engine(dev)
    cfg = eng.cfg
    for shape, captures in [((1, 64), 1), ((1, 64), 1), ((2, 64), 2),
                            ((1, 32), 3), ((1, 64), 3), ((2, 64), 3)]:
        eng.transcribe(_mel(cfg, *shape), max_new=4)
        assert eng._step_captures == captures, shape
    assert eng._plans.misses == 2 * 3 and eng._plans.hits == 2 * 3
    assert len(eng._plans) == 6


@pytest.mark.gpu
def test_failed_capture_raises_without_fallback():
    """A step program that syncs the host cannot be captured: transcribe
    raises and returns nothing, and no step graph exists. Last in the
    file: the card is left after a failed capture."""
    dev = _cuda_or_skip()
    eng = _engine(dev)
    step_fn = eng._step_fn

    def syncing_step(st):
        step_fn(st)
        torch.cuda.synchronize()

    eng._step_fn = syncing_step
    with pytest.raises(RuntimeError):
        eng.transcribe(_mel(eng.cfg, 1, 64), max_new=4)
    assert eng._step_captures == 0
    assert eng._key("step", 1, 64) not in eng._graphs
    assert eng.offload.ledger.commits == 0
