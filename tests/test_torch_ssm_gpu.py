"""The SSM and hybrid families on a CUDA device: mamba2-780m at its smoke
config and at full width cut to 4 layers (Q8_0 and bf16), jamba-v0.1-52b
at its smoke config (bf16): ``ssm_decode_step`` on the card against the
port's plain run on the CPU; captured ``generate`` equal to the eager
loop, the step's kernels launched from Python only at the capture; a row
of a 4-slot mamba2 step bit for bit a batch-1 step's (its logits and its
conv window and SSD state); the slot scheduler's tokens equal batch-1
``generate``; a step capture that fails raises, and nothing falls back.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_ssm_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.kernels import bf16_matmul, q8_matvec
from repro_torch.models import model, ssm
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler

MAMBA = "mamba2-780m"
JAMBA = "jamba-v0.1-52b"
FULL_LAYERS = 4
# bf16 at full width: a sum that differs in its last f32 bits between the
# card and the CPU can round to the neighbouring bf16 value (2^-8 relative)
FULL_TOL = 1e-2
SMOKE_TOL = 1e-5


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _cfg(arch, full: bool):
    return (dataclasses.replace(get_config(arch), num_layers=FULL_LAYERS)
            if full else get_smoke_config(arch))


def _engine(dev, arch=MAMBA, full=False, quant="q8_0", max_len=48):
    cfg = _cfg(arch, full)
    gen = torch.Generator(device=dev if full else "cpu").manual_seed(0)
    params = model.init_params(gen, cfg, device=dev)
    # the smoke widths (64, 128) are below the default burst: 32 sends
    # their main segments to the kernel too
    return ServeEngine(cfg, params, max_len=max_len, quant=quant,
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


def _rel_err(got, want):
    got, want = got.float().cpu(), want.float()
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["smoke", "mamba2-full", "jamba-full"])
def test_ssm_decode_step_on_the_card_matches_the_cpu(case):
    """One SSM layer, 4 rows, 16 carried steps through the offload engine
    (the kernels on the card, their plain versions on the CPU): the
    output, conv window and SSD state within 1e-5 of the CPU's largest
    value at the f32 smoke config and 1e-2 in bf16 at full width."""
    dev = _cuda_or_skip()
    full = case != "smoke"
    arch = JAMBA if case == "jamba-full" else MAMBA
    cfg = _cfg(arch, full)
    dtype = torch.bfloat16 if full else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    p = ssm.init_ssm(gen, cfg, dtype)
    p_cpu = model.to_device(p, torch.device("cpu"))
    tol = FULL_TOL if full else SMOKE_TOL
    eng = OffloadEngine(burst=256 if full else 32)
    st = ssm.SSMState.zeros(4, cfg.ssm, cfg.d_model, device=dev)
    st_cpu = ssm.SSMState.zeros(4, cfg.ssm, cfg.d_model, device="cpu")
    with torch.no_grad():
        for _ in range(16):
            u = torch.randn((4, 1, cfg.d_model), generator=gen,
                            device=dev).to(dtype)
            y, st = ssm.ssm_decode_step(p, cfg, u, st, engine=eng)
            yc, st_cpu = ssm.ssm_decode_step(p_cpu, cfg, u.cpu(), st_cpu,
                                             engine=eng)
            assert torch.isfinite(y).all() and y.dtype == dtype
            assert _rel_err(y, yc) <= tol
    assert _rel_err(st.conv, st_cpu.conv) <= tol
    assert _rel_err(st.ssd, st_cpu.ssd) <= tol
    assert int(st.length) == 16


def _per_step(cfg) -> int:
    """The engine's linears a step: two an SSM layer, four an attention
    layer, three a dense FFN, and lm_head."""
    from repro_torch.models import transformer
    n = 1
    for spec in transformer.layer_specs(cfg):
        n += 2 if spec.mixer == "ssm" else 4
        n += 3 if spec.ffn == "dense" else 0
    return n


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mamba2-smoke-q8_0", "mamba2-smoke-none",
                                  "mamba2-full-q8_0", "mamba2-full-none",
                                  "jamba-smoke-none"])
def test_captured_generate_equals_eager_and_replays_only(case):
    """Batch 1 and 2: the captured tokens equal the eager loop's; one step
    capture a batch, whose two Python passes launch the step's linears
    twice on the quant's decode kernel; a second request at the same
    batch captures nothing and launches nothing from Python."""
    dev = _cuda_or_skip()
    arch = JAMBA if case.startswith("jamba") else MAMBA
    quant = case.rsplit("-", 1)[1]
    eng = _engine(dev, arch, full="full" in case, quant=quant)
    kernel = q8_matvec.q8_matvec if quant == "q8_0" \
        else bf16_matmul.bf16_matmul
    per_step = _per_step(eng.cfg)
    for b in (1, 2):
        prompts = _prompts(eng.cfg, b, 6, seed=b)
        want = _eager(eng, prompts, 8)
        before = kernel.launches
        got = eng.generate(prompts, max_new=8)
        assert [r.tokens for r in got] == want
        assert kernel.launches - before == 2 * per_step
        assert eng._step_captures == b
        before = kernel.launches
        again = _prompts(eng.cfg, b, 9, seed=10 + b)
        got = eng.generate(again, max_new=5)
        assert kernel.launches == before
        assert eng._step_captures == b
        assert [r.tokens for r in got] == _eager(eng, again, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_a_rows_step_does_not_depend_on_the_batch(quant):
    """mamba2 at full width, 4 layers: row 0 of a 4-slot decode step gets
    exactly the logits, conv window and SSD state a batch-1 step gives
    it. The conv is d_conv products added in index order, the state
    update a broadcast outer product and the readout an elementwise
    product summed over N: no batched GEMM whose kernel follows the row
    count."""
    dev = _cuda_or_skip()
    eng = _engine(dev, full=True, quant=quant)
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
        for _ in range(3):
            l4, _ = model.serve_step(eng._serve_params, cfg, tok, pool,
                                     engine=eng.offload)
            l1, _ = model.serve_step(eng._serve_params, cfg, tok[:1], one,
                                     engine=eng.offload)
            assert torch.equal(l1, l4[:1])
    for a, b in zip(model.state_tensors(one), model.state_tensors(pool)):
        assert torch.equal(a.reshape(b[:1].shape), b[:1])


@pytest.mark.gpu
def test_scheduler_tokens_equal_batch1_generate():
    """mamba2 at full width (4 layers), Q8_0: 6 requests over 4 slots,
    a wave mid-drain; every request's tokens equal its batch-1
    ``generate``'s, with one slot-step capture for the pool."""
    dev = _cuda_or_skip()
    eng = _engine(dev, full=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, eng.cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 12, 6)]
    budgets = rng.integers(4, 12, 6).tolist()
    want = [eng.generate(p[None], max_new=n)[0].tokens
            for p, n in zip(prompts, budgets)]
    captures = eng._step_captures
    sched = ContinuousBatchingScheduler(eng, n_slots=4)
    rids = [sched.submit(p, max_new=n)
            for p, n in zip(prompts[:4], budgets[:4])]
    sched.admit()
    sched.decode_step()
    rids += [sched.submit(p, max_new=n)
             for p, n in zip(prompts[4:], budgets[4:])]
    res = sched.run()
    assert [res[r].tokens for r in rids] == want
    assert eng._step_captures == captures + 1


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
