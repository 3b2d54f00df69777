"""The continuous-batching scheduler on a CUDA device: the slot step is
captured into a CUDA graph once per pool, at its first admission, and only
replayed after; admissions replay the one-shot batch-1 prefill graph.
Each request's tokens equal a batch-1 ``transcribe`` of the same mel, on
the Q8_0 and the dense + flash paths, at the smoke config and at full
width, a row of a slot step bit for bit a batch-1 step's; the step
captures stay flat across schedules; the slot step and a
``transcribe`` at the pool's shape keep separate graphs but one plan
entry; a free slot drifts past ``max_len`` with no device assert; a
capture that fails raises, and nothing falls back.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_scheduler_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.kernels import bf16_matmul, q8_matmul, q8_matvec
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler

COUNTED = (q8_matmul.q8_matmul, q8_matvec.q8_matvec, bf16_matmul.bf16_matmul)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _engine(dev, path="q8_0", full=False, max_len=16):
    cfg = get_config("whisper-tiny") if full else \
        get_smoke_config("whisper-tiny")
    if path == "dense+flash":
        cfg = dataclasses.replace(cfg, quant="none", attn_impl="flash")
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    return ServeEngine(cfg, params, max_len=max_len,
                       quant="q8_0" if path == "q8_0" else "none",
                       offload=OffloadEngine(), eos_id=-1, device=dev)


def _mels(cfg, n, f, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, f, cfg.n_mels)).astype(np.float32)
            for _ in range(n)]


def _launches():
    return [fn.launches for fn in COUNTED]


def _staggered(sched, mels, max_news, first, after_steps=2):
    """Submit ``first`` requests, decode a few steps, submit the rest
    mid-drain, drain. Returns the results in submission order."""
    rids = [sched.submit(m, max_new=n)
            for m, n in zip(mels[:first], max_news[:first])]
    sched.admit()
    for _ in range(after_steps):
        sched.decode_step()
    rids += [sched.submit(m, max_new=n)
             for m, n in zip(mels[first:], max_news[first:])]
    res = sched.run()
    return [res[r] for r in rids]


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["q8_0", "dense+flash"])
def test_a_rows_step_does_not_depend_on_the_batch(path):
    """At full width, row 0 of a 4-slot decode step gets exactly the
    logits and cache entries a batch-1 step gives it: the decode kernels
    read N and K only, and the attention's contractions and the host
    arm's products run row by row, each the batch-1 computation."""
    dev = _cuda_or_skip()
    eng = _engine(dev, path, full=True, max_len=56)
    cfg = eng.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    one = model.zeros_serve_state(cfg, 1, cfg.encoder_ctx, 56, device=dev)
    pool = model.zeros_slot_state(cfg, 4, cfg.encoder_ctx, 56, device=dev)
    for a, b in zip(model.state_tensors(one), model.state_tensors(pool)):
        if b.is_floating_point():
            b.copy_(torch.randn(b.shape, generator=gen, device=dev))
        else:
            b.copy_(torch.tensor([5, 2, 9, 0]))
        a.copy_(b[:1].reshape(a.shape))
    tok = torch.tensor([[11], [22], [33], [44]], device=dev)
    with torch.no_grad():
        l4, _ = model.serve_step(eng._serve_params, cfg, tok, pool,
                                 engine=eng.offload)
        l1, _ = model.serve_step(eng._serve_params, cfg, tok[:1], one,
                                 engine=eng.offload)
    assert torch.equal(l1, l4[:1])
    for a, b in zip(model.state_tensors(one), model.state_tensors(pool)):
        assert torch.equal(a.reshape(b[:1].shape), b[:1])


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("path", ["q8_0", "dense+flash"])
def test_slot_step_tokens_equal_batch1_transcribe(path, full):
    """Captured slot steps over a staggered schedule: every request's
    tokens equal its batch-1 transcribe's (both run the same kernels, at
    M = n_slots and M = 1, on the same operands rows); one capture for the
    pool, taken at its first admission."""
    dev = _cuda_or_skip()
    eng = _engine(dev, path, full)
    f = eng.cfg.encoder_ctx if full else 64
    n_slots = 4 if full else 2
    mels = _mels(eng.cfg, 6, f)
    max_news = [6, 3, 8, 5, 4, 7]
    refs = [eng.transcribe(m, max_new=n)[0].tokens
            for m, n in zip(mels, max_news)]
    captures = eng._step_captures
    sched = ContinuousBatchingScheduler(eng, n_slots=n_slots, n_frames=f)
    got = _staggered(sched, mels, max_news, first=n_slots)
    assert [r.tokens for r in got] == refs
    assert [r.steps for r in got] == max_news
    assert eng._step_captures == captures + 1
    assert sched._program is not None


@pytest.mark.gpu
def test_step_captures_stay_flat_across_schedules():
    """After the pool's first step no schedule captures again, and the
    replays launch nothing from Python."""
    dev = _cuda_or_skip()
    eng = _engine(dev)
    mels = _mels(eng.cfg, 6, 64)
    sched = ContinuousBatchingScheduler(eng, n_slots=2, n_frames=64)
    sched.submit(mels[0], max_new=2)
    sched.run()
    captures, launches = eng._step_captures, _launches()
    _staggered(sched, mels[1:5], [3, 5, 2, 4], first=2, after_steps=1)
    for m, n in zip(mels[4:], (2, 6)):
        sched.submit(m, max_new=n)
    while sched.n_queued or sched.n_active:
        sched.admit()
        sched.decode_step()
    sched.run()
    assert eng._step_captures == captures
    assert _launches() == launches


@pytest.mark.gpu
def test_transcribe_and_scheduler_keep_separate_graphs_one_plan():
    """A transcribe at (n_slots, F) captures the engine's step graph over
    the one-shot buffers; the scheduler captures its own over the pool.
    Both resolve to one PlanCache entry, and each path's tokens stay its
    own after the other ran."""
    dev = _cuda_or_skip()
    eng = _engine(dev)
    mels = _mels(eng.cfg, 2, 64, seed=3)
    batch = np.concatenate(mels, axis=0)
    want = [r.tokens for r in eng.transcribe(batch, max_new=5)]
    key = eng._key("step", 2, 64)
    sched = ContinuousBatchingScheduler(eng, n_slots=2, n_frames=64)
    rids = [sched.submit(m, max_new=5) for m in mels]
    res = sched.run()
    assert [res[r].tokens for r in rids] == want
    assert sched._program.graph is not eng._graphs[key].graph
    assert sched._step_plan is eng._plans.plans[key]
    assert [k for k in eng._plans.plans if k[0] == "step"] == [key]
    assert [r.tokens for r in eng.transcribe(batch, max_new=5)] == want


@pytest.mark.gpu
def test_free_slot_drifts_past_max_len_on_the_card():
    """A slot freed early keeps decoding while another request drains:
    its lengths pass max_len, the clamped writes raise no device assert,
    and the draining request's tokens equal its batch-1 transcribe's."""
    dev = _cuda_or_skip()
    max_len = 8
    eng = _engine(dev, max_len=max_len)
    mels = _mels(eng.cfg, 2, 64, seed=9)
    ref = eng.transcribe(mels[1], max_new=max_len)[0].tokens
    sched = ContinuousBatchingScheduler(eng, n_slots=2, n_frames=64)
    sched.submit(mels[0], max_new=max_len)
    sched.admit()
    for _ in range(5):
        sched.decode_step()
    rb = sched.submit(mels[1], max_new=max_len)
    res = sched.run()
    torch.cuda.synchronize()
    assert res[rb].tokens == ref
    lengths = [kv.length.tolist()
               for kv in sched.pool.state.layer_states.self_kv]
    assert all(row[0] > max_len for row in lengths)


@pytest.mark.gpu
def test_failed_slot_step_capture_raises_without_fallback():
    """A slot step that syncs the host cannot be captured: the first
    admission raises, nothing is admitted, and no program exists. Last in
    the file: the card is left after a failed capture."""
    dev = _cuda_or_skip()
    eng = _engine(dev)
    sched = ContinuousBatchingScheduler(eng, n_slots=2, n_frames=64)
    step_fn = sched._step_fn

    def syncing_step():
        step_fn()
        torch.cuda.synchronize()

    sched._step_fn = syncing_step
    sched.submit(_mels(eng.cfg, 1, 64)[0], max_new=2)
    with pytest.raises(RuntimeError):
        sched.admit()
    assert sched._program is None and sched.n_active == 0
    assert eng.offload.ledger.commits == 0
