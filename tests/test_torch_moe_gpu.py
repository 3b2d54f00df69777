"""The MoE family on a CUDA device: olmoe-1b-7b and arctic-480b at their
smoke configs and at full width (one or two layers), weights drawn on the
card: ``moe_ffn`` on the card against the port's plain run on the CPU,
with equal keep masks; captured ``generate`` equal to the eager loop; a
row of a 4-slot olmoe step bit for bit a batch-1 step's (at full width
four rows cannot fill an expert's 8 slots); four identical prompts over 4
slots, where capacity drops make rows differ, giving the CPU's tokens; a
step capture that fails raises, and nothing falls back.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_moe_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.kernels import bf16_matmul
from repro_torch.models import model, moe
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler

FULL_LAYERS = 2
# bf16 at full width: a sum that differs in its last f32 bits between the
# card and the CPU can round to the neighbouring bf16 value (2^-8 relative)
FULL_TOL = 1e-2
SMOKE_TOL = 1e-5


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _cfg(arch, full: bool, layers: int = FULL_LAYERS):
    return (dataclasses.replace(get_config(arch), num_layers=layers) if full
            else get_smoke_config(arch))


def _engine(dev, arch="olmoe-1b-7b", full=False, max_len=48):
    cfg = _cfg(arch, full)
    gen = torch.Generator(device=dev if full else "cpu").manual_seed(0)
    params = model.init_params(gen, cfg, device=dev)
    # the smoke widths (64, 128) are below the default burst: 32 sends
    # their main segments to the kernel too
    return ServeEngine(cfg, params, max_len=max_len, quant="none",
                       offload=OffloadEngine(burst=256 if full else 32),
                       eos_id=None, device=dev)


def _prompts(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _eager(eng, prompts, max_new):
    logits, state = eng.prefill(torch.from_numpy(prompts).long().cuda())
    tok = eng._argmax(logits[:, -1])[:, None]
    rows = []
    for _ in range(max_new):
        logits, state = eng.step(tok, state)
        tok = eng._argmax(logits[:, -1])[:, None]
        rows.append(tok)
    return torch.cat(rows, dim=1).cpu().tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["olmoe-smoke", "arctic-smoke",
                                  "olmoe-full", "arctic-full"])
def test_moe_ffn_on_the_card_matches_the_cpu(case):
    """One MoE layer, 4 rows of one token (a decode step's shape) and 2
    rows of 7: the keep masks and slots equal the CPU's, y within the
    tolerance of the largest output (1e-5 at the f32 smoke config, 1e-2 in
    bf16 at full width), the load-balance loss within 1e-5."""
    dev = _cuda_or_skip()
    arch = "olmoe-1b-7b" if case.startswith("olmoe") else "arctic-480b"
    full = case.endswith("full")
    cfg = _cfg(arch, full, 1)
    dtype = torch.bfloat16 if full else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init_moe(gen, cfg, dtype)
    p_cpu = model.to_device(p, torch.device("cpu"))
    tol = FULL_TOL if full else SMOKE_TOL
    with torch.no_grad():
        for b, s in ((4, 1), (2, 7)):
            x = torch.randn((b, s, cfg.d_model), generator=gen,
                            device=dev).to(dtype)
            r, aux = moe.route(p, cfg, x)
            rc, aux_c = moe.route(p_cpu, cfg, x.cpu())
            assert torch.equal(r.experts.cpu(), rc.experts)
            assert torch.equal(r.keep.cpu(), rc.keep)
            assert torch.equal(r.pos.cpu(), rc.pos)
            assert abs(float(aux) - float(aux_c)) <= 1e-5
            y, _ = moe.moe_ffn(p, cfg, x)
            yc, _ = moe.moe_ffn(p_cpu, cfg, x.cpu())
            assert torch.isfinite(y).all()
            err = (y.float().cpu() - yc.float()).abs().max().item()
            assert err <= tol * max(1.0, yc.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_captured_generate_equals_eager_and_replays_only(full):
    """olmoe at batch 1 and 2: the captured tokens equal the eager loop's;
    one step capture a batch, whose two Python passes launch the step's
    linears twice (q/k/v/o a layer and lm_head); a second request at the
    same batch captures nothing and launches nothing from Python."""
    dev = _cuda_or_skip()
    eng = _engine(dev, full=full)
    per_step = 4 * eng.cfg.num_layers + 1
    for b in (1, 2):
        prompts = _prompts(eng.cfg, b, 6, seed=b)
        want = _eager(eng, prompts, 8)
        before = bf16_matmul.bf16_matmul.launches
        got = eng.generate(prompts, max_new=8)
        assert [r.tokens for r in got] == want
        assert bf16_matmul.bf16_matmul.launches - before == 2 * per_step
        assert eng._step_captures == b
        before = bf16_matmul.bf16_matmul.launches
        again = _prompts(eng.cfg, b, 9, seed=10 + b)
        got = eng.generate(again, max_new=5)
        assert bf16_matmul.bf16_matmul.launches == before
        assert eng._step_captures == b
        assert [r.tokens for r in got] == _eager(eng, again, 5)


@pytest.mark.gpu
def test_a_rows_step_does_not_depend_on_the_batch():
    """olmoe at full width, 2 layers: row 0 of a 4-slot decode step gets
    exactly the logits and cache entries a batch-1 step gives it. Four
    rows cannot fill an expert's 8 slots, so nothing is dropped; the
    router's rows are padded to one shape, the expert products run at the
    same (E, 8, d) shape at both batches, and dispatch and combine are
    gathers and elementwise adds."""
    dev = _cuda_or_skip()
    eng = _engine(dev, full=True)
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
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_drop_case_tokens_equal_the_cpu(arch):
    """The smoke config, four identical prompts over 4 slots: cap 2, so
    rows lose choices; the card's scheduler gives the CPU scheduler's
    tokens on the same weights (the CPU tests hold those to the
    reference's), and rows 0 and 2 differ."""
    dev = _cuda_or_skip()
    cfg = get_smoke_config(arch)
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    prompt = np.array([3, 5, 7, 9], np.int32)
    out = []
    for device, burst in ((dev, 32), ("cpu", 32)):
        eng = ServeEngine(cfg, params, max_len=16, quant="none",
                          offload=OffloadEngine(burst=burst), eos_id=None,
                          device=device)
        sched = ContinuousBatchingScheduler(eng, n_slots=4)
        rids = [sched.submit(prompt, max_new=6) for _ in range(4)]
        res = sched.run()
        out.append([res[r].tokens for r in rids])
    assert out[0] == out[1]
    assert out[0][0] == out[0][1] and out[0][2] == out[0][3]
    assert out[0][0] != out[0][2]


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
