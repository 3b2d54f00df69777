"""Speculative decoding on a CUDA device: the verify window and the draft
step are captured into CUDA graphs once per (batch, frames) point and
replayed whatever the accept lengths; a window position's logits are bit
for bit the sequential decode step's wherever the window's linears stay
on the decode kernels (M = B x (k + 1) <= 16), and within the first-step
tolerances above; speculative tokens equal captured ``transcribe``'s; a
paged window across a page boundary equals the contiguous one; a free
slot past ``max_len`` raises no device assert; a window that cannot be
captured raises.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_speculative_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.kernels import bf16_matmul, q8_matmul, q8_matvec
from repro_torch.models import model

COUNTED = (q8_matmul.q8_matmul, q8_matvec.q8_matvec, bf16_matmul.bf16_matmul)
# the card's logits against the CPU's first step (chip_smoke.py): Q8_0,
# and dense, whose decoder rounds every linear's output to bf16
TOL = {"q8_0": 1e-2, "none": 3e-2}


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _params(arch, full, seed):
    cfg = get_config(arch) if full else get_smoke_config(arch)
    return cfg, model.init_params(torch.Generator().manual_seed(seed), cfg,
                                  device="cpu")


def _verifier(dev, quant="q8_0", full=False, max_len=32):
    from repro_torch.serve.engine import ServeEngine
    cfg, params = _params("whisper-base", full, 1)
    return ServeEngine(cfg, params, max_len=max_len, quant=quant,
                       offload=OffloadEngine(), eos_id=-1, device=dev)


def _spec(v, k, full=False):
    cfg, params = _params("whisper-tiny", full, 0)
    return v.speculative(cfg, params, k=k)


def _slot_state(eng, b, lengths, seed=3):
    """A slot-layout state of seeded random KV with per-row lengths."""
    cfg, dev = eng.cfg, eng.device
    f = cfg.encoder_ctx
    st = model.zeros_slot_state(cfg, b, f, eng.max_len, device=dev)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for t in model.state_tensors(st):
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    model.set_slot_lengths(st, torch.tensor(lengths, dtype=torch.int32,
                                            device=dev))
    return st


def _window_and_steps(eng, st, tok):
    """The window's logits and the W sequential steps' from the same
    state, and both states after."""
    snap = [t.clone() for t in model.state_tensors(st)]
    with torch.no_grad():
        win, _ = model.verify_step(eng._serve_params, eng.cfg, tok, st,
                                   engine=eng.offload)
        after = [t.clone() for t in model.state_tensors(st)]
        for t, s in zip(model.state_tensors(st), snap):
            t.copy_(s)
        seq = torch.cat([model.serve_step(eng._serve_params, eng.cfg,
                                          tok[:, j:j + 1], st,
                                          engine=eng.offload)[0]
                         for j in range(tok.shape[1])], dim=1)
    torch.cuda.synchronize()
    return win, seq, after, model.state_tensors(st)


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("quant", ["q8_0", "none"])
@pytest.mark.parametrize("b,w", [(1, 5), (4, 4)], ids=["M5", "M16"])
def test_window_position_is_the_sequential_step_bit_for_bit(b, w, quant,
                                                            full):
    """At M = B x W <= 16 every linear of the window runs on the decode
    kernels, whose launch depends on N and K only; the host arm, the
    layer norm and each (row, position)'s attention contractions are the
    batch-1 step's. So position j's logits and cache entries are the j-th
    sequential step's, bit for bit."""
    dev = _cuda_or_skip()
    eng = _verifier(dev, quant, full)
    st = _slot_state(eng, b, [3, 9, 0, 5][:b])
    gen = torch.Generator(device="cuda").manual_seed(4)
    tok = torch.randint(0, eng.cfg.vocab_size, (b, w), device=dev,
                        generator=gen)
    win, seq, after, now = _window_and_steps(eng, st, tok)
    assert torch.equal(win, seq)
    assert all(torch.equal(a, c) for a, c in zip(after, now))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_window_at_m28_within_tolerance_and_tokens_equal(quant):
    """Batch 4 and k = 6 put the window at M = 28, on the prefill kernels:
    position j's logits stay within the first-step tolerance of the
    sequential step's, and the speculative tokens equal ``transcribe``'s
    (full width, echo-free random weights)."""
    dev = _cuda_or_skip()
    eng = _verifier(dev, quant, full=True, max_len=40)
    st = _slot_state(eng, 4, [3, 9, 0, 5])
    gen = torch.Generator(device="cuda").manual_seed(4)
    tok = torch.randint(0, eng.cfg.vocab_size, (4, 7), device=dev,
                        generator=gen)
    win, seq, _, _ = _window_and_steps(eng, st, tok)
    assert (win - seq).abs().max().item() <= TOL[quant]
    mel = np.random.default_rng(5).standard_normal(
        (4, eng.cfg.encoder_ctx, eng.cfg.n_mels)).astype(np.float32)
    want = [r.tokens for r in eng.transcribe(mel, max_new=16)]
    spec = _spec(eng, 6, full=True)
    assert [r.tokens for r in spec.transcribe(mel, max_new=16)] == want


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_spec_tokens_equal_captured_transcribe_without_recapture(quant):
    """Requests with other mels (other accept patterns, echo and not):
    tokens equal captured ``transcribe``'s; the window and the draft step
    are captured once, at the first request, and no kernel launches from
    Python after it."""
    dev = _cuda_or_skip()
    v = _verifier(dev, quant)
    spec = _spec(v, 4)
    rng = np.random.default_rng(6)
    mels = [rng.standard_normal((2, 64, v.cfg.n_mels)).astype(np.float32)
            for _ in range(3)]
    want = [[r.tokens for r in v.transcribe(m, max_new=12)] for m in mels]
    got = [[r.tokens for r in spec.transcribe(mels[0], max_new=12)]]
    captures = (v._verify_captures, spec.draft._step_captures)
    assert captures == (1, 1)
    for fn in COUNTED:
        fn.launches = 0
    got += [[r.tokens for r in spec.transcribe(m, max_new=12)]
            for m in mels[1:]]
    torch.cuda.synchronize()
    assert got == want
    assert (v._verify_captures, spec.draft._step_captures) == captures
    assert all(fn.launches == 0 for fn in COUNTED)
    # the self-draft accepts every window: another accept pattern
    self_spec = v.speculative(v.cfg, v.params, k=3, draft_quant=quant)
    assert [r.tokens for r in self_spec.transcribe(mels[0], max_new=12)] \
        == want[0]
    assert self_spec.acceptance_rate() == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_paged_window_across_a_page_boundary_equals_contiguous(quant):
    """A W = 6 window through the block tables (pages of 4: row 0's
    window spans three pages, row 1's straddles one boundary) gives the
    contiguous window's logits bit for bit, and writes the same
    entries."""
    dev = _cuda_or_skip()
    eng = _verifier(dev, quant, max_len=16)
    cfg = eng.cfg
    f = 64
    lengths = [3, 5]
    contig = model.zeros_slot_state(cfg, 2, f, 16, device=dev)
    paged = model.zeros_paged_state(cfg, 2, max_pages=4, n_pages=9,
                                    page_size=4, n_cross_per_req=1,
                                    n_cross_pages=3, cross_page_size=f,
                                    device=dev)
    gen = torch.Generator(device="cuda").manual_seed(8)
    ls, pls = contig.layer_states, paged.layer_states
    pls.block_table.copy_(torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]]))
    pls.cross_table.copy_(torch.tensor([[1], [2]]))
    for i, kv in enumerate(ls.self_kv):
        for name, buf in (("self_k", kv.k), ("self_v", kv.v)):
            buf.copy_(torch.randn(buf.shape, generator=gen, device=dev))
            arena = getattr(pls, name)[i]
            arena[1:].copy_(buf.reshape(8, 4, *buf.shape[2:]))
        for j, t in enumerate(ls.cross_kv[i]):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
            (pls.cross_k if j == 0 else pls.cross_v)[i, 1:].copy_(t)
    new = torch.tensor(lengths, dtype=torch.int32, device=dev)
    model.set_slot_lengths(contig, new)
    model.set_slot_lengths(paged, new)
    tok = torch.tensor([[5, 6, 7, 8, 9, 10], [1, 2, 3, 4, 5, 6]], device=dev)
    with torch.no_grad():
        lc, _ = model.verify_step(eng._serve_params, cfg, tok, contig,
                                  engine=eng.offload)
        lp, _ = model.verify_step(eng._serve_params, cfg, tok, paged,
                                  engine=eng.offload)
    torch.cuda.synchronize()
    assert torch.equal(lc, lp)
    for i, kv in enumerate(ls.self_kv):
        assert torch.equal(kv.k.reshape(8, 4, *kv.k.shape[2:]),
                           pls.self_k[i, 1:])


@pytest.mark.gpu
def test_free_slot_past_max_len_takes_a_window_without_assert():
    """A slot scheduler's free row whose lengths passed max_len takes a
    W = k + 1 window: the cache write clamps its start to max_len - W and
    the positions clamp to the table, no device assert; the live
    request's tokens equal its batch-1 ``transcribe``'s."""
    dev = _cuda_or_skip()
    max_len = 16
    v = _verifier(dev, max_len=max_len)
    spec = _spec(v, 4)
    mel = np.random.default_rng(9).standard_normal(
        (1, 64, v.cfg.n_mels)).astype(np.float32)
    want = v.transcribe(mel, max_new=8)[0].tokens
    sched = spec.continuous(n_slots=2, n_frames=64)
    rid = sched.submit(mel, max_new=8)
    sched.admit()
    far = torch.tensor([0, max_len + 7], dtype=torch.int32, device=dev)
    far[0] = sched.pool.state.step[0]
    model.set_slot_lengths(sched.pool.state, far)
    model.set_slot_lengths(sched._draft_pool.state, far)
    sched.decode_step()
    torch.cuda.synchronize()
    res = sched.run()
    torch.cuda.synchronize()
    assert res[rid].tokens == want


@pytest.mark.gpu
def test_failed_window_capture_raises_without_fallback():
    """A verify window that syncs the host cannot be captured: the first
    speculative request raises, no program exists and nothing was
    committed. Last in the file: the card is left after a failed
    capture."""
    dev = _cuda_or_skip()
    v = _verifier(dev)
    spec = _spec(v, 2)
    verify_fn = v._verify_fn

    def syncing_verify(*args):
        verify_fn(*args)
        torch.cuda.synchronize()

    v._verify_fn = syncing_verify
    mel = np.zeros((1, 64, v.cfg.n_mels), np.float32)
    with pytest.raises(RuntimeError):
        spec.transcribe(mel, max_new=4)
    assert all(p.rounds.programs is None
               for parts in spec._statics.values() for p in parts)
    assert v.offload.ledger.commits == 0 and v._verify_captures == 0
