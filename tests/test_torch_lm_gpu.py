"""The dense LM family on a CUDA device, at the qwen2.5-14b smoke config
and at its full width with the depth cut to 4 layers, weights drawn on
the card: ``generate`` captures one step graph a batch and replays it
once a prompt token and once a generated token; its tokens equal the
eager loop's (``prefill``/``step``), on Q8_0 and dense, and with the int8
KV cache; a second request at the same batch captures nothing and
launches nothing from Python; a row of a 4-slot step is bit for bit a
batch-1 step's; the slot scheduler's tokens equal batch-1 ``generate``'s;
a step capture that fails raises, and nothing falls back.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_lm_gpu.py
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
FULL_LAYERS = 4


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _cfg(full: bool, **overrides):
    cfg = (dataclasses.replace(get_config("qwen2.5-14b"),
                               num_layers=FULL_LAYERS) if full
           else get_smoke_config("qwen2.5-14b"))
    return dataclasses.replace(cfg, **overrides)


def _engine(dev, quant="q8_0", full=False, max_len=48, **overrides):
    cfg = _cfg(full, **overrides)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    # the smoke widths (64, 128) are below the default burst: 32 sends
    # their main segments to the kernels too
    return ServeEngine(cfg, params, max_len=max_len, quant=quant,
                       offload=OffloadEngine(burst=256 if full else 32),
                       eos_id=None, device=dev)


def _prompts(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _eager(eng, prompts, max_new):
    """The eager loop through ``prefill``/``step``: every kernel launched
    from Python."""
    logits, state = eng.prefill(torch.from_numpy(prompts).long().cuda())
    tok = eng._argmax(logits[:, -1])[:, None]
    rows = []
    for _ in range(max_new):
        logits, state = eng.step(tok, state)
        tok = eng._argmax(logits[:, -1])[:, None]
        rows.append(tok)
    return torch.cat(rows, dim=1).cpu().tolist()


def _launches():
    return [fn.launches for fn in COUNTED]


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_captured_generate_equals_eager_and_replays_only(quant, full):
    """Batch 1 and batch 2: the captured tokens equal the eager loop's;
    one step capture a batch, whose two Python passes launch the step's
    linears twice; a second request at the same batch, with another
    prompt length, captures nothing and launches nothing from Python."""
    dev = _cuda_or_skip()
    eng = _engine(dev, quant, full)
    per_step = 7 * eng.cfg.num_layers + 1
    for b in (1, 2):
        prompts = _prompts(eng.cfg, b, 6, seed=b)
        want = _eager(eng, prompts, 8)
        before = _launches()
        got = eng.generate(prompts, max_new=8)
        assert [r.tokens for r in got] == want
        assert sum(_launches()) - sum(before) == 2 * per_step
        assert eng._step_captures == b
        again = _prompts(eng.cfg, b, 9, seed=10 + b)
        before = _launches()
        got = eng.generate(again, max_new=5)
        assert _launches() == before and eng._step_captures == b
        assert [r.tokens for r in got] == _eager(eng, again, 5)
    assert set(eng._graphs) == {eng._key("step", 1), eng._key("step", 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_a_rows_step_does_not_depend_on_the_batch(quant, full):
    """Row 0 of a 4-slot decode step gets exactly the logits and cache
    entries a batch-1 step gives it: the decode kernels read N and K
    only, the RMS norm is one fused reduction a row, and the attention's
    contractions run row by row."""
    dev = _cuda_or_skip()
    eng = _engine(dev, quant, full)
    cfg = eng.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    one = model.zeros_serve_state(cfg, 1, 0, 48, device=dev)
    pool = model.zeros_slot_state(cfg, 4, 0, 48, device=dev)
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
def test_slot_step_tokens_equal_batch1_generate(full):
    """Prompts of several lengths over 4 slots, a second wave mid-drain:
    every request's tokens equal its batch-1 ``generate``'s; the pool's
    slot step is captured once, at its first admission."""
    dev = _cuda_or_skip()
    eng = _engine(dev, "q8_0", full)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, eng.cfg.vocab_size, (int(s),)).astype(
        np.int32) for s in rng.integers(3, 12, 7)]
    budgets = rng.integers(3, 10, 7).tolist()
    refs = [eng.generate(p[None], max_new=n)[0].tokens
            for p, n in zip(prompts, budgets)]
    captures = eng._step_captures
    sched = ContinuousBatchingScheduler(eng, n_slots=4)
    rids = [sched.submit(p, max_new=n)
            for p, n in zip(prompts[:4], budgets[:4])]
    sched.admit()
    sched.decode_step()
    rids += [sched.submit(p, max_new=n)
             for p, n in zip(prompts[4:], budgets[4:])]
    launches = _launches()
    res = sched.run()
    assert [res[r].tokens for r in rids] == refs
    assert eng._step_captures == captures + 1 and _launches() == launches


@pytest.mark.gpu
def test_kv_quant_generate_equals_eager():
    dev = _cuda_or_skip()
    eng = _engine(dev, "q8_0", full=True, kv_quant="q8")
    prompts = _prompts(eng.cfg, 1, 7)
    assert [r.tokens for r in eng.generate(prompts, max_new=8)] == \
        _eager(eng, prompts, 8)
    st = eng._lm_static_for(1).state.layer_states[0]
    assert st.k_qs.dtype == torch.int8 and int(st.length) == 15


@pytest.mark.gpu
def test_failed_step_capture_raises_without_fallback():
    """A step program that syncs the host cannot be captured: generate
    raises, no graph is kept, nothing is committed. Last in the file: the
    card is left after a failed capture."""
    dev = _cuda_or_skip()
    eng = _engine(dev)
    step_fn = eng._lm_step_fn

    def syncing_step(st):
        step_fn(st)
        torch.cuda.synchronize()

    eng._lm_step_fn = syncing_step
    with pytest.raises(RuntimeError):
        eng.generate(_prompts(eng.cfg, 1, 4), max_new=2)
    assert not eng._graphs and eng.offload.ledger.commits == 0
