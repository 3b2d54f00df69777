"""The paged KV pool on a CUDA device: the paged scheduler's slot step is
captured into a CUDA graph once per pool, at its first admission, and the
block tables it reads are device tensors that admissions, evictions and
preemptions rewrite in place between replays; a preempted request is
recomputed through the graph of ``transcribe``'s batch-1 step. Each
request's tokens equal the contiguous scheduler's and a batch-1
``transcribe``'s (Q8_0 and dense + flash, smoke and full width), a row of
a 12-row paged step is bit for bit a batch-1 step's, one slot step is
captured a pool through preemptions and replays, a request readmitted into
other pages stays token-exact, and a free slot drifts past ``max_len``
with no device assert.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_paging_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.kernels import bf16_matmul, q8_matmul, q8_matvec
from repro_torch.models import model
from repro_torch.models.attention import paged_window_gather
from repro_torch.serve.engine import ServeEngine

COUNTED = (q8_matmul.q8_matmul, q8_matvec.q8_matvec, bf16_matmul.bf16_matmul)
MAX_LEN = 24


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _engine(dev, path="q8_0", full=False, max_len=MAX_LEN):
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


def _staggered(sched, trace, first, after_steps=2, watch=None):
    """Submit ``first`` requests, decode a few steps, submit the rest,
    drain by hand; ``watch`` sees the scheduler after every step. Returns
    the tokens in submission order."""
    rids = [sched.submit(m, max_new=n) for m, n in trace[:first]]
    steps = 0
    while sched.n_queued or sched.n_active or len(rids) < len(trace):
        if steps == after_steps and len(rids) < len(trace):
            rids += [sched.submit(m, max_new=n) for m, n in trace[first:]]
        sched.admit()
        sched.decode_step()
        steps += 1
        if watch is not None:
            watch(sched)
    torch.cuda.synchronize()
    return [sched.finished[r].tokens for r in rids]


def _trace(cfg, f):
    """Nine requests over three utterances, repeats included."""
    distinct = _mels(cfg, 3, f)
    which = [0, 1, 0, 2, 1, 1, 0, 2, 0]
    max_news = [8, 12, 6, 10, 5, 16, 9, 7, 11]
    return distinct, which, [(distinct[w], n) for w, n in
                             zip(which, max_news)]


def _refs(eng, distinct, which, trace):
    full = [eng.transcribe(m, max_new=16)[0].tokens for m in distinct]
    return [full[w][:n] for w, (_, n) in zip(which, trace)]


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("path", ["q8_0", "dense+flash"])
def test_paged_tokens_equal_contiguous_and_transcribe(path, full):
    """The same staggered trace through a paged pool of 12 logical slots
    (prefix sharing, one cross page an utterance) and a contiguous pool of
    4: every request's tokens equal each other's and the first max_new of
    a batch-1 transcribe of its mel."""
    dev = _cuda_or_skip()
    eng = _engine(dev, path, full)
    f = eng.cfg.encoder_ctx if full else 64
    distinct, which, trace = _trace(eng.cfg, f)
    refs = _refs(eng, distinct, which, trace)
    paged = eng.paged_scheduler(12, f, page_size=4, n_pages=1 + 12 * 4,
                                cross_page_size=f, n_cross_pages=4)
    got = _staggered(paged, trace, first=5)
    want = _staggered(eng.scheduler(n_slots=4, n_frames=f), trace, first=5)
    assert got == want == refs
    assert paged.shared_hits > 0 and paged.active_peak > 4


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["q8_0", "dense+flash"])
def test_a_12_row_paged_step_row_equals_a_batch1_step(path):
    """At full width, row 0 of a 12-row paged step (other rows at other
    positions, on other pages, two on the trash page) gets exactly the
    logits and KV entries a batch-1 contiguous step gives it over the same
    values: the gathers rebuild the contiguous view, the decode kernels at
    M = 12 (their MT = 16 instantiations) read N and K only, and the
    attention's contractions and the host arm run row by row."""
    dev = _cuda_or_skip()
    eng = _engine(dev, path, full=True)
    cfg = eng.cfg
    f, ps, b = cfg.encoder_ctx, 4, 12
    n_log = -(-MAX_LEN // ps)
    pool = model.zeros_paged_state(
        cfg, b, max_pages=n_log, n_pages=1 + 10 * n_log, page_size=ps,
        n_cross_per_req=1, n_cross_pages=4, cross_page_size=f, device=dev)
    ls = pool.layer_states
    gen = torch.Generator(device="cuda").manual_seed(3)
    for t in (ls.self_k, ls.self_v, ls.cross_k, ls.cross_v):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    bt = torch.zeros((b, n_log), dtype=torch.int32)
    bt[:10] = 1 + torch.randperm(10 * n_log).reshape(10, n_log)
    ls.block_table.copy_(bt)
    ls.cross_table.copy_(torch.tensor([[1], [2], [3], [1], [2], [3], [1],
                                       [2], [3], [1], [0], [0]]))
    pos = torch.tensor([5, 2, 9, 0, 13, 7, 1, 22, 3, 11, 30, 40])
    ls.length.copy_(pos.expand(cfg.num_layers, b))
    pool.step.copy_(pos)
    one = model.zeros_serve_state(cfg, 1, f, n_log * ps, device=dev)
    o = one.layer_states
    for i, kv in enumerate(o.self_kv):
        kv.k.copy_(paged_window_gather(ls.self_k[i], ls.block_table)[:1])
        kv.v.copy_(paged_window_gather(ls.self_v[i], ls.block_table)[:1])
        kv.length.fill_(5)
        o.cross_kv[i][0].copy_(paged_window_gather(ls.cross_k[i],
                                                   ls.cross_table)[:1])
        o.cross_kv[i][1].copy_(paged_window_gather(ls.cross_v[i],
                                                   ls.cross_table)[:1])
    one.step.fill_(5)
    tok = torch.arange(11, 11 + 11 * b, 11, device=dev)[:, None]
    with torch.no_grad():
        l12, _ = model.serve_step(eng._serve_params, cfg, tok, pool,
                                  engine=eng.offload)
        l1, _ = model.serve_step(eng._serve_params, cfg, tok[:1], one,
                                 engine=eng.offload)
    assert torch.equal(l1, l12[:1])
    for i, kv in enumerate(o.self_kv):
        assert torch.equal(
            kv.k, paged_window_gather(ls.self_k[i], ls.block_table)[:1])
        assert torch.equal(
            kv.v, paged_window_gather(ls.self_v[i], ls.block_table)[:1])
    assert ls.length[:, 0].tolist() == [6] * cfg.num_layers
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["q8_0", "dense+flash"])
def test_one_slot_step_capture_per_pool_through_preemptions(path):
    """A tight arena preempts and replays; its pool captures one slot
    step at its first admission and the engine the batch-1 step (the
    replays' program) once, and after that first admission nothing
    launches from Python. Every request's tokens equal its transcribe's."""
    dev = _cuda_or_skip()
    eng = _engine(dev, path)
    f = 64
    distinct, which, trace = _trace(eng.cfg, f)
    refs = _refs(eng, distinct, which, trace)
    captures = eng._step_captures
    sched = eng.paged_scheduler(4, f, page_size=4, n_pages=8,
                                cross_page_size=f, n_cross_pages=4)
    rids = [sched.submit(m, max_new=n) for m, n in trace[:4]]
    sched.admit()
    after_first = _launches()
    # the slot step; the batch-1 step is transcribe's, captured above
    assert eng._step_captures == captures + 1
    assert sched._program is not None
    rids += [sched.submit(m, max_new=n) for m, n in trace[4:]]
    res = sched.run()
    torch.cuda.synchronize()
    assert [res[r].tokens for r in rids] == refs
    assert sched.preemptions > 0 and sched.replays > 0
    assert eng._step_captures == captures + 1
    assert _launches() == after_first


@pytest.mark.gpu
def test_readmitted_request_in_other_pages_stays_token_exact():
    """Tables edited between replays are read by the graph: a request
    preempted and readmitted into other physical pages (its table rows
    rewritten in place) continues token for token."""
    dev = _cuda_or_skip()
    eng = _engine(dev)
    f = 64
    distinct, which, trace = _trace(eng.cfg, f)
    refs = _refs(eng, distinct, which, trace)
    sched = eng.paged_scheduler(4, f, page_size=4, n_pages=8,
                                cross_page_size=f, n_cross_pages=4)
    seen = {}

    def watch(s):
        for slot, a in s._active.items():
            pages = tuple(s.pool.slot_pages(slot))
            first = seen.setdefault(a.rid, set())
            first.add(pages[:1])
    got = _staggered(sched, trace, first=4, after_steps=1, watch=watch)
    assert got == refs
    moved = [rid for rid, firsts in seen.items() if len(firsts) > 1]
    assert sched.preemptions > 0 and moved


@pytest.mark.gpu
def test_free_paged_slot_drifts_past_max_len_on_the_card():
    """A slot freed early keeps decoding through the trash page while
    another request drains: its lengths pass max_len, the clamped page and
    position lookups raise no device assert, and the draining request's
    tokens equal its batch-1 transcribe's."""
    dev = _cuda_or_skip()
    max_len = 8
    eng = _engine(dev, max_len=max_len)
    mels = _mels(eng.cfg, 2, 64, seed=9)
    ref = eng.transcribe(mels[1], max_new=max_len)[0].tokens
    sched = eng.paged_scheduler(2, 64, page_size=4)
    sched.submit(mels[0], max_new=max_len)
    sched.admit()
    for _ in range(5):
        sched.decode_step()
    rb = sched.submit(mels[1], max_new=max_len)
    res = sched.run()
    torch.cuda.synchronize()
    assert res[rb].tokens == ref
    assert sched.pool.state.layer_states.length[0, 0].item() > max_len
