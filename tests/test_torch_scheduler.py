"""The port's continuous batching against the reference, on the CPU at the
smoke config, with identical weights (``convert.py``) and numpy-seeded
mels: ``repro_torch.serve.scheduler`` and ``repro_torch.serve.kvcache``
held against ``repro.serve.scheduler`` and ``repro.serve.kvcache``, case
for case after ``tests/test_scheduler.py``:

- the slot layout, and ``slot_insert``/``slot_reset`` exact against the
  reference's on the same state (in place here, the pool's storage kept);
- the pool's pick order, the frames requirement, its committed and used
  KV bytes;
- per-row ``decode_attention`` and a per-slot decode step against the
  reference's with ``(B,)`` lengths, rows past the cache's end included;
- scheduler token streams and ``TokenEvent`` order equal to the
  reference scheduler's and to one-at-a-time ``transcribe`` (Q8_0 and
  dense, bursts None/256/32), under staggered and randomized arrival
  schedules; padding, the stacked-batch refusal, zero budgets, claim-once,
  EOS eviction; a free slot driven past ``max_len``;
- plan sharing with the one-shot path, ledger commits and totals against
  the reference engine's after the same drain, and per-request PDP
  summing to the batch's;
- the engine's wrappers and the CLI's ``--continuous``.

Tolerance 1e-4 on logits (f32 smoke config: the frameworks sum in another
order). Tokens, counts and bytes are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hyp import given, settings, st

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.kvcache import SlotKVPool as JaxSlotKVPool
from repro.serve.kvcache import slot_insert as jax_slot_insert
from repro.serve.kvcache import slot_reset as jax_slot_reset
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _tensor, from_jax_params
from repro_torch.core.offload import OffloadEngine
from repro_torch.kernels.ref import q8_matmul_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, model
from repro_torch.models.attention import KVCache
from repro_torch.models.whisper import WhisperDecodeState
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import SlotKVPool, slot_insert, slot_reset
from repro_torch.serve.scheduler import (
    ContinuousBatchingScheduler, TokenEvent)

TOL = dict(rtol=1e-4, atol=1e-4)
N_FRAMES = 8


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("whisper-tiny")
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg, 64)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, get_smoke_config("whisper-tiny"), tparams


def _mels(cfg, n, seed=0, frames=N_FRAMES):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, frames, cfg.n_mels)).astype(np.float32)
            for _ in range(n)]


def _pair(smoke, quant="none", burst=None, max_len=32, eos_id=-1):
    """A reference engine and a port engine on the same weights."""
    jcfg, jparams, tcfg, tparams = smoke
    joff = (None if burst is None
            else JaxOffloadEngine(prefer_pallas=False, burst=burst))
    toff = None if burst is None else OffloadEngine(burst=burst)
    return (JaxServeEngine(jcfg, jparams, max_len=max_len, quant=quant,
                           offload=joff, eos_id=eos_id),
            ServeEngine(tcfg, tparams, max_len=max_len, quant=quant,
                        offload=toff, eos_id=eos_id, device="cpu"))


_SHARED = {}


def _shared_pair(smoke, quant="none", burst=None):
    """Engines shared across cases that only compare tokens: the
    reference's jitted programs compile once per engine."""
    key = (quant, burst)
    if key not in _SHARED:
        _SHARED[key] = _pair(smoke, quant, burst)
    return _SHARED[key]


def _t(a) -> torch.Tensor:
    return _tensor(np.asarray(a))


def _port_state(jst) -> model.ServeState:
    """A reference ServeState (layer-stacked) in the port's layout (a
    list per layer)."""
    ls = jst.layer_states
    r = ls.self_kv.k.shape[0]
    ck, cv = ls.cross_kv
    return model.ServeState(
        WhisperDecodeState(
            self_kv=[KVCache(_t(ls.self_kv.k[i]), _t(ls.self_kv.v[i]),
                             _t(ls.self_kv.length[i])) for i in range(r)],
            cross_kv=[(_t(ck[i]), _t(cv[i])) for i in range(r)]),
        _t(jst.step))


def _assert_states_equal(port, ref):
    got = model.state_tensors(port)
    want = model.state_tensors(_port_state(ref))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def _events(evs):
    return [(e.rid, e.token, e.step, e.done) for e in evs]


# ---------------------------------------------------------------------------
# Slot layout and the splice ops
# ---------------------------------------------------------------------------
def test_slot_layout_broadcasts_counters(smoke):
    jcfg, jparams, tcfg, _ = smoke
    memory = jnp.zeros((3, N_FRAMES, jcfg.d_model))
    jst = jax_model.init_serve_state(jparams, jcfg, 3, 16, memory=memory)
    stt = _port_state(jst)
    slot = model.slot_layout(stt, 3)
    assert slot.step.shape == (3,) and slot.step.dtype == torch.int32
    assert [kv.length.shape for kv in slot.layer_states.self_kv] == \
        [(3,)] * tcfg.num_layers
    # data tensors are the same tensors; counters are new
    assert all(a.k is b.k and a.v is b.v for a, b in zip(
        slot.layer_states.self_kv, stt.layer_states.self_kv))
    assert slot.layer_states.cross_kv is stt.layer_states.cross_kv
    assert slot.step is not stt.step
    _assert_states_equal(slot, jax_model.slot_layout(jst, 3))
    again = model.slot_layout(slot, 3)                 # idempotent
    assert again.step is slot.step
    assert all(a.length is b.length for a, b in zip(
        again.layer_states.self_kv, slot.layer_states.self_kv))


def test_zeros_slot_state_has_the_reference_pools_shapes(smoke):
    jcfg, jparams, tcfg, _ = smoke
    pool = JaxSlotKVPool(jcfg, jparams, n_slots=3, max_len=16,
                         n_frames=N_FRAMES)
    got = model.zeros_slot_state(tcfg, 3, N_FRAMES, 16, device="cpu")
    want = _port_state(pool.state)
    for a, b in zip(model.state_tensors(got), model.state_tensors(want),
                    strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert model.state_kv_bytes(got) == \
        jax_model.state_kv_bytes(pool.state)


def test_slot_insert_and_reset_are_exact_and_in_place(smoke):
    """insert writes the request's state into exactly one slot row, reset
    zeroes exactly that row, both equal to the reference's ops on the same
    state, and the pool's tensors keep their storage."""
    jcfg, jparams, _, _ = smoke
    jpool = JaxSlotKVPool(jcfg, jparams, n_slots=3, max_len=16,
                          n_frames=N_FRAMES)
    jeng = JaxServeEngine(jcfg, jparams, max_len=16, quant="none", eos_id=-1)
    _, jreq = jeng._prefill_jit(jeng._serve_params,
                                jnp.asarray(_mels(jcfg, 1)[0]))
    # a request state with nonzero counters, so the splice of each shows
    jreq = jreq._replace(step=jreq.step + 3, layer_states=jreq.layer_states
                         ._replace(self_kv=jreq.layer_states.self_kv._replace(
                             length=jreq.layer_states.self_kv.length + 2)))
    pool = _port_state(jpool.state)
    ptrs = [t.data_ptr() for t in model.state_tensors(pool)]
    slot_insert(pool, 1, _port_state(jreq))
    after = jax_slot_insert(jpool.state, 1, jreq)
    _assert_states_equal(pool, after)
    assert int(pool.step[1]) == 3 and int(pool.step[0]) == 0
    slot_reset(pool, 1)
    _assert_states_equal(pool, jax_slot_reset(after, 1))
    assert [t.data_ptr() for t in model.state_tensors(pool)] == ptrs


@pytest.mark.parametrize("ops", ["a a a r1 a r0 r2 a a",
                                 "a a r0 a r1 r2 a a r0 r1 a"])
def test_pool_pick_order_matches_reference(smoke, ops):
    """Acquires ("a") and releases ("rN") in turn: the port's pool hands
    out the reference's slots (the lowest free one)."""
    jcfg, jparams, tcfg, _ = smoke
    ref = JaxSlotKVPool(jcfg, jparams, n_slots=3, max_len=8,
                        n_frames=N_FRAMES)
    pool = SlotKVPool(tcfg, 3, 8, N_FRAMES, device="cpu")
    got, want = [], []
    for op in ops.split():
        if op == "a":
            got.append(pool.acquire())
            want.append(ref.acquire())
        else:
            pool.release(int(op[1:]), reset=False)
            ref.release(int(op[1:]), reset=False)
        assert pool.n_free == ref.n_free
    assert got == want


def test_pool_acquire_release_and_full(smoke):
    _, _, tcfg, _ = smoke
    pool = SlotKVPool(tcfg, 2, 16, N_FRAMES, device="cpu")
    assert pool.n_free == 2
    a, b = pool.acquire(), pool.acquire()
    assert (a, b) == (0, 1) and pool.n_free == 0
    with pytest.raises(IndexError):
        pool.acquire()
    pool.release(a)
    assert pool.n_free == 1 and pool.acquire() == a


def test_pool_and_scheduler_require_frames(smoke):
    jcfg, jparams, tcfg, tparams = smoke
    with pytest.raises(ValueError):
        SlotKVPool(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError):
        JaxSlotKVPool(jcfg, jparams, n_slots=2, max_len=16)
    eng = ServeEngine(tcfg, tparams, max_len=16, quant="none", device="cpu")
    with pytest.raises(ValueError, match="n_frames"):
        ContinuousBatchingScheduler(eng, n_slots=2)


@pytest.mark.parametrize("lengths", [{0: 1}, {0: 3, 2: 16}, {1: 20, 2: 5},
                                     {0: 1, 1: 2, 2: 3}])
@pytest.mark.parametrize("max_len,frames", [(16, N_FRAMES), (8, 8)])
def test_kv_bytes_equal_the_reference_pools(smoke, lengths, max_len, frames):
    """Committed and used bytes equal the reference pool's, the latter
    exactly, also where the frame count equals max_len (the cross rows
    then count by length, as the reference's rule has it)."""
    jcfg, jparams, tcfg, _ = smoke
    ref = JaxSlotKVPool(jcfg, jparams, n_slots=3, max_len=max_len,
                        n_frames=frames)
    pool = SlotKVPool(tcfg, 3, max_len, frames, device="cpu")
    assert pool.committed_kv_bytes() == ref.committed_kv_bytes()
    assert pool.used_kv_bytes(lengths) == ref.used_kv_bytes(lengths)
    assert pool.used_kv_bytes({}) == ref.used_kv_bytes({}) == 0


# ---------------------------------------------------------------------------
# Per-row lengths in the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lengths", [[0, 5, 3], [7, 0, 9], [12, 12, 12]])
def test_per_row_decode_attention_matches_reference(smoke, lengths):
    """(B,) lengths: each row writes at its own position and attends over
    positions <= its length. Rows at or past the cache's end (S = 8) write
    at the last position, as the reference's clamped update does, and
    raise nothing."""
    jcfg, jparams, tcfg, tparams = smoke
    rng = np.random.default_rng(5)
    b, s = len(lengths), 8
    hkv, hd = tcfg.num_kv_heads, tcfg.head_dim
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["dec_blocks"])
    jout, jcache = jax_attention.decode_attention(
        jp["self_attn"], jcfg, jnp.asarray(x),
        jax_attention.KVCache(jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(length)))
    cache = KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                    torch.from_numpy(length.copy()))
    out, got = attention.decode_attention(
        tparams["dec_blocks"][0]["self_attn"], tcfg, torch.from_numpy(x),
        cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(jcache.v), **TOL)
    assert got.length.tolist() == np.asarray(jcache.length).tolist()
    assert got.k is cache.k and got.length is cache.length     # in place


def test_scalar_length_update_keeps_index_copy(smoke):
    """The lockstep path is unchanged: one index for every row."""
    buf = torch.zeros((2, 4, 1, 2))
    val = torch.ones((2, 1, 1, 2))
    attention._cache_update(buf, val, torch.tensor(2, dtype=torch.int32))
    assert buf[:, 2].eq(1).all() and buf.sum() == 4


@pytest.mark.parametrize("quant", ["none", "q8_0"])
def test_per_slot_decode_steps_match_reference(smoke, quant):
    """A slot-layout state with rows at different positions: three decode
    steps' logits within 1e-4 of the reference's, lengths and step exact,
    each row reading its own positional row."""
    jcfg, jparams, tcfg, tparams = smoke
    jeng, teng = _pair(smoke, quant, None, max_len=16)
    mel = np.concatenate(_mels(jcfg, 3, seed=4), axis=0)
    _, jst = jeng._prefill_jit(jeng._serve_params, jnp.asarray(mel))
    jst = jax_model.set_slot_lengths(jax_model.slot_layout(jst, 3),
                                     jnp.asarray([0, 4, 9], jnp.int32))
    state = _port_state(jst)
    for i, tok in enumerate(([[1], [5], [7]], [[2], [3], [4]],
                             [[9], [8], [6]])):
        jlog, jst = jax_model.serve_step(jeng._serve_params, jcfg,
                                         jnp.asarray(tok, jnp.int32), jst)
        tlog, state = model.serve_step(teng._serve_params, tcfg,
                                       torch.tensor(tok), state)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert state.step.tolist() == np.asarray(jst.step).tolist()
        assert [kv.length.tolist() for kv in state.layer_states.self_kv] \
            == np.asarray(jst.layer_states.self_kv.length).tolist()


@pytest.mark.parametrize("memory", [False, True], ids=["self", "cross"])
def test_decode_attention_rows_do_not_depend_on_the_batch(smoke, memory):
    """Row 0 of a 4-row decode attention (rows at other positions beside
    it) gets exactly the output and cache entries of a 1-row call: the
    contractions run row by row, each the batch-1 contraction (on the
    card a batched GEMM picks its kernel by the batch). The projections run
    row by row here (on the card they are the offload engine's, held in
    the card's test); the CPU's own GEMMs depend on the row count."""
    _, _, tcfg, tparams = smoke

    class RowByRow:
        def linear(self, x, w, name=""):
            rows = x.reshape(-1, x.shape[-1])
            out = torch.cat([r[None] @ w.t() for r in rows])
            return out.reshape(*x.shape[:-1], -1)
    gen = torch.Generator().manual_seed(3)
    hkv, hd = tcfg.num_kv_heads, tcfg.head_dim
    x = torch.randn((4, 1, tcfg.d_model), generator=gen)
    k, v = (torch.randn((4, 8, hkv, hd), generator=gen) for _ in range(2))
    mem = tuple(torch.randn((4, N_FRAMES, hkv, hd), generator=gen)
                for _ in range(2))
    p = tparams["dec_blocks"][0]["cross_attn" if memory else "self_attn"]
    c4 = KVCache(k.clone(), v.clone(), torch.tensor([5, 2, 7, 0],
                                                    dtype=torch.int32))
    c1 = KVCache(k[:1].clone(), v[:1].clone(),
                 torch.tensor(5, dtype=torch.int32))
    o4, _ = attention.decode_attention(p, tcfg, x, c4,
                                       memory_kv=mem if memory else None,
                                       engine=RowByRow())
    o1, _ = attention.decode_attention(
        p, tcfg, x[:1], c1,
        memory_kv=tuple(t[:1] for t in mem) if memory else None,
        engine=RowByRow())
    assert torch.equal(o1, o4[:1])
    assert torch.equal(c1.k, c4.k[:1]) and torch.equal(c1.v, c4.v[:1])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8_0"])
def test_host_arm_rows_do_not_depend_on_the_batch(quant):
    """The host arm runs a product of at most 16 rows row by row: a row's
    result is the same bits at 1, 4 or 16 rows, and equals the plain f32
    contraction (the reference's oracle)."""
    from repro_torch.backends.base import RESIDUAL, KernelRequest
    from repro_torch.backends.host_residual import HostResidualBackend
    from repro_torch.core.qformats import quantize_q8_0
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((20, 128), generator=gen)
    w = torch.randn((384, 128), generator=gen) * 0.05
    w = quantize_q8_0(w) if quant else w.to(torch.bfloat16)
    req = KernelRequest(kernel="q8_matvec" if quant else "bf16_matmul",
                        m=1, n=384, k=128, dtype="q8_0" if quant else "bf16",
                        segment=RESIDUAL)
    fn = HostResidualBackend().build(req)
    one = fn(x[:1], w)
    for m in (2, 4, 16):
        assert torch.equal(fn(x[:m], w)[:1], one)
    def oracle(rows):
        return q8_matmul_ref(rows, w) if quant else rows @ w.float().t()
    np.testing.assert_allclose(fn(x, w).numpy(), oracle(x).numpy(), **TOL)
    assert torch.equal(one, oracle(x[:1]))        # a batch-1 row: unchanged
    assert fn(x[:3], w).shape == (3, 384)


# ---------------------------------------------------------------------------
# Scheduler against the reference scheduler and one-at-a-time decode
# ---------------------------------------------------------------------------
def _drive_staggered(sched, mels, max_news, first):
    """Submit ``first`` requests, drain, then the rest; returns
    (results by submission index, events)."""
    events = []
    rids = [sched.submit(m, max_new=n)
            for m, n in zip(mels[:first], max_news[:first])]
    res = sched.run(on_token=events.append)
    rids += [sched.submit(m, max_new=n)
             for m, n in zip(mels[first:], max_news[first:])]
    res.update(sched.run(on_token=events.append))
    return [res[r] for r in rids], events


@pytest.mark.parametrize("quant", ["q8_0", "none"])
@pytest.mark.parametrize("burst", [None, 256, 32])
def test_scheduler_matches_reference_and_one_at_a_time(smoke, quant, burst):
    """The contract: slot-batched continuous decode emits, per request,
    exactly the tokens of a batch-1 ``transcribe`` of the same utterance,
    and the reference scheduler's tokens and TokenEvent stream."""
    jeng, teng = _shared_pair(smoke, quant, burst)
    mels = _mels(teng.cfg, 5)
    max_news = [4, 2, 5, 3, 4]
    refs = [teng.transcribe(m, max_new=n)[0].tokens
            for m, n in zip(mels, max_news)]
    got, gev = _drive_staggered(
        ContinuousBatchingScheduler(teng, n_slots=2, n_frames=N_FRAMES),
        mels, max_news, 3)
    want, wev = _drive_staggered(JaxScheduler(jeng, n_slots=2,
                                              n_frames=N_FRAMES),
                                 mels, max_news, 3)
    assert [r.tokens for r in got] == [r.tokens for r in want] == refs
    assert [r.steps for r in got] == max_news
    assert _events(gev) == _events(wev)
    assert all(isinstance(e, TokenEvent) for e in gev)


def test_scheduler_pads_short_utterances(smoke):
    _, teng = _shared_pair(smoke)
    short = np.random.default_rng(3).standard_normal(
        (1, 5, teng.cfg.n_mels)).astype(np.float32)
    padded = np.pad(short, ((0, 0), (0, N_FRAMES - 5), (0, 0)))
    sched = ContinuousBatchingScheduler(teng, n_slots=2, n_frames=N_FRAMES)
    r1 = sched.submit(short, max_new=3)
    r2 = sched.submit(padded[0], max_new=3)          # (F, n_mels) form
    res = sched.run()
    assert res[r1].tokens == res[r2].tokens
    assert res[r1].tokens == teng.transcribe(padded, max_new=3)[0].tokens
    with pytest.raises(ValueError):
        sched.submit(np.zeros((1, N_FRAMES + 1, teng.cfg.n_mels),
                              np.float32))


def test_submit_rejects_stacked_batches(smoke):
    _, teng = _shared_pair(smoke)
    sched = ContinuousBatchingScheduler(teng, n_slots=2, n_frames=N_FRAMES)
    with pytest.raises(ValueError, match="ONE request"):
        sched.submit(np.zeros((2, N_FRAMES, teng.cfg.n_mels), np.float32))
    with pytest.raises(ValueError):
        sched.submit(np.zeros((N_FRAMES,), np.float32))
    assert sched.n_queued == 0


def test_scheduler_streams_tokens_in_order(smoke):
    _, teng = _shared_pair(smoke)
    sched = ContinuousBatchingScheduler(teng, n_slots=2, n_frames=N_FRAMES)
    rids = [sched.submit(m, max_new=3) for m in _mels(teng.cfg, 3)]
    events = []
    res = sched.run(on_token=events.append)
    for rid in rids:
        assert [e.token for e in events if e.rid == rid] == res[rid].tokens
        assert [e.step for e in events if e.rid == rid] == [1, 2, 3]
        dones = [e.done for e in events if e.rid == rid]
        assert dones[-1] and not any(dones[:-1])


def _drive_schedule(sched, mels, max_news, gaps):
    """The reference test's arrival pattern: requests trickle in between
    decode steps. Returns {submission index: result}."""
    rid2i, queued, gi = {}, list(range(len(mels))), 0
    while queued or sched.n_queued or sched.n_active:
        if queued:
            n = gaps[gi % len(gaps)] if gi else 1
            if not (sched.n_queued or sched.n_active):
                n = max(n, 1)
            for _ in range(n):
                if queued:
                    i = queued.pop(0)
                    rid2i[sched.submit(mels[i], max_new=max_news[i])] = i
            gi += 1
        sched.admit()
        sched.decode_step()
    return {i: sched.finished[rid] for rid, i in rid2i.items()}


@settings(max_examples=5, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=4), min_size=1,
                max_size=5),
       st.lists(st.integers(min_value=0, max_value=3), min_size=5,
                max_size=5),
       st.integers(min_value=1, max_value=3))
def test_randomized_arrival_schedules(smoke, max_news, gaps, n_slots):
    """For any arrival pattern, budget mix and pool width, every request's
    stream equals the reference scheduler's under the same schedule and
    its own one-at-a-time decode."""
    jeng, teng = _shared_pair(smoke)
    mels = _mels(teng.cfg, len(max_news), seed=7)
    got = _drive_schedule(ContinuousBatchingScheduler(
        teng, n_slots=n_slots, n_frames=N_FRAMES), mels, max_news, gaps)
    want = _drive_schedule(JaxScheduler(jeng, n_slots=n_slots,
                                        n_frames=N_FRAMES),
                           mels, max_news, gaps)
    for i, mn in enumerate(max_news):
        assert got[i].tokens == want[i].tokens == \
            teng.transcribe(mels[i], max_new=mn)[0].tokens
        assert got[i].steps == mn


def test_zero_budget_request_matches_one_shot(smoke):
    _, teng = _shared_pair(smoke)
    mel = _mels(teng.cfg, 1)[0]
    sched = ContinuousBatchingScheduler(teng, n_slots=2, n_frames=N_FRAMES)
    rid = sched.submit(mel, max_new=0)
    assert sched.n_queued == 0 and sched.n_active == 0
    res = sched.run()
    ref = teng.transcribe(mel, max_new=0)[0]
    assert res[rid].tokens == ref.tokens == []
    assert res[rid].steps == ref.steps == 0


def test_run_claims_results_exactly_once(smoke):
    _, teng = _shared_pair(smoke)
    mels = _mels(teng.cfg, 2)
    sched = ContinuousBatchingScheduler(teng, n_slots=2, n_frames=N_FRAMES)
    r0 = sched.submit(mels[0], max_new=2)
    first = sched.run()
    assert set(first) == {r0} and not sched.finished
    r1 = sched.submit(mels[1], max_new=2)
    assert set(sched.run()) == {r1}
    att = sched.attribution(700.0)
    assert att["per_request_pdp_j"] == {} and att["drained"]
    assert att["busy_s"] == pytest.approx(0.0, abs=1e-9)
    with pytest.raises(TypeError):
        sched.attribution()                  # no default power


def test_scheduler_evicts_on_eos(smoke):
    jcfg, jparams, tcfg, tparams = smoke
    mel = _mels(tcfg, 1)[0]
    probe = ServeEngine(tcfg, tparams, max_len=32, quant="none", eos_id=-1,
                        device="cpu")
    first = probe.transcribe(mel, max_new=3)[0].tokens[0]
    jeng, teng = _pair(smoke, eos_id=int(first))
    sched = ContinuousBatchingScheduler(teng, n_slots=2, n_frames=N_FRAMES)
    rid = sched.submit(mel, max_new=8)
    res = sched.run()
    want = JaxScheduler(jeng, n_slots=2, n_frames=N_FRAMES)
    jrid = want.submit(mel, max_new=8)
    assert res[rid].steps == want.run()[jrid].steps == 1
    assert res[rid].tokens == [int(first)]
    assert sched.pool.n_free == 2


def test_free_slot_drifts_past_max_len_without_error(smoke):
    """A slot freed early keeps decoding garbage while another request
    drains: its lengths and positions pass ``max_len``, the writes clamp,
    and the active request's tokens stay exact (against the reference
    scheduler under the same schedule and against transcribe)."""
    max_len = 8
    jeng, teng = _pair(smoke, max_len=max_len)
    mels = _mels(teng.cfg, 2, seed=9)
    port = ContinuousBatchingScheduler(teng, n_slots=2, n_frames=N_FRAMES)
    out = []
    for sched in (port, JaxScheduler(jeng, n_slots=2, n_frames=N_FRAMES)):
        ra = sched.submit(mels[0], max_new=max_len)
        sched.admit()
        for _ in range(5):
            sched.decode_step()
        rb = sched.submit(mels[1], max_new=max_len)
        res = sched.run()
        out.append((res[ra].tokens, res[rb].tokens))
    assert out[0] == out[1]
    assert out[0][1] == teng.transcribe(mels[1], max_new=max_len)[0].tokens
    lengths = [kv.length.tolist()
               for kv in port.pool.state.layer_states.self_kv]
    assert all(row[0] > max_len for row in lengths)     # slot 0 drifted


# ---------------------------------------------------------------------------
# Plans, ledger and attribution
# ---------------------------------------------------------------------------
def test_scheduler_shares_plans_with_one_shot_path(smoke):
    """A transcribe at the pool's (batch, frames) point and the slot step
    resolve to one PlanCache entry: the scheduler adds only the batch-1
    prefill plan, as the reference's does."""
    jeng, teng = _pair(smoke, "q8_0", 256, max_len=16)
    mel = np.concatenate(_mels(teng.cfg, 2), axis=0)
    counts = []
    for eng, make in ((teng, ContinuousBatchingScheduler),
                      (jeng, JaxScheduler)):
        eng.transcribe(mel, max_new=2)
        n = len(eng._plans)
        sched = make(eng, n_slots=2, n_frames=N_FRAMES)
        sched.submit(mel[:1], max_new=2)
        sched.run()
        assert len(eng._plans) == n + 1 and eng._plans.hits >= 1
        counts.append((len(eng._plans), eng._plans.hits, eng._plans.misses))
    assert counts[0] == counts[1]
    step = ("step", "q8_0", 2, N_FRAMES)
    assert teng._plans.plans[step].summary() == \
        jeng._plans.plans[step].summary()


@pytest.mark.parametrize("burst", [256, 32])
def test_ledger_and_attribution_match_reference(smoke, burst):
    """After the same manual drain both ledgers hold one commit per
    admission plus one per executed step, and equal totals up to the
    reference's one quirk (its prefill plan records ``dec.cross.k``/``.v``
    once, where the port runs and records them every layer). Per-request
    PDP sums to the batch's."""
    jeng, teng = _pair(smoke, "q8_0", burst, max_len=16)
    mels = _mels(teng.cfg, 3)
    steps = []
    for eng, make in ((teng, ContinuousBatchingScheduler),
                      (jeng, JaxScheduler)):
        sched = make(eng, n_slots=2, n_frames=N_FRAMES)
        for m, n in zip(mels, (3, 2, 4)):
            sched.submit(m, max_new=n)
        n_steps = 0
        while sched.n_queued or sched.n_active:
            sched.admit()
            if sched.decode_step():
                n_steps += 1
        steps.append(n_steps)
        assert eng.offload.ledger.commits == 3 + n_steps
        att = sched.attribution(700.0)
        assert sum(att["per_request_pdp_j"].values()) == \
            pytest.approx(att["batch_pdp_j"], rel=1e-9)
        assert att["drained"] and len(att["per_request_ttft_s"]) == 3
        if eng is teng:
            keys = set(att)
            for rid, r in sched.finished.items():
                assert 0.0 < r.queue_wait_s < r.ttft_s
    assert steps[0] == steps[1]
    assert keys == set(att)
    a = dataclasses.asdict(teng.offload.stats)
    b = dataclasses.asdict(jeng.offload.stats)
    extra = (teng.cfg.num_layers - 1) * 3            # 3 prefills
    cross = teng._plans.plans[("prefill", "q8_0", 1, N_FRAMES)].entries[-2:]
    assert a["offloaded_calls"] == b["offloaded_calls"] + 2 * extra
    assert a["fallback_calls"] == b["fallback_calls"]
    for f in ("offloaded_flops", "residual_flops", "fallback_flops"):
        assert a[f] == b[f] + extra * sum(getattr(e, f) for e in cross)
    assert a["by_kernel"] == {
        k: v + (extra if k.startswith("dec.cross") else 0)
        for k, v in b["by_kernel"].items()}


def test_kv_accounting_after_a_drain_matches_reference(smoke):
    jeng, teng = _shared_pair(smoke)
    mels = _mels(teng.cfg, 4, seed=2)
    out = []
    for eng, make in ((teng, ContinuousBatchingScheduler),
                      (jeng, JaxScheduler)):
        sched = make(eng, n_slots=3, n_frames=N_FRAMES)
        for m, n in zip(mels, (5, 2, 3, 4)):
            sched.submit(m, max_new=n)
        sched.run()
        out.append((sched.kv_committed_bytes, sched.kv_used_peak,
                    sched.kv_utilization_peak, sched.active_peak))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Engine wrappers and the CLI
# ---------------------------------------------------------------------------
def test_engine_submit_run_wrappers(smoke):
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, max_len=32, quant="none", eos_id=-1,
                      device="cpu")
    assert eng.run() == {}
    mels = _mels(tcfg, 2)
    r0 = eng.submit_audio(mels[0], max_new=3, n_slots=2)
    assert eng._scheduler.n_frames == N_FRAMES
    assert eng.scheduler() is eng._scheduler
    r1 = eng.submit_audio(mels[1], max_new=3)       # the same pool
    with pytest.raises(RuntimeError, match="geometry"):
        eng.scheduler(n_slots=3)
    got = eng.run()
    refs = [eng.transcribe(m, max_new=3)[0].tokens for m in mels]
    assert got[r0].tokens == refs[0] and got[r1].tokens == refs[1]
    old = eng._scheduler
    assert eng.scheduler(n_slots=3) is not old           # drained: rebuilt
    assert eng._scheduler.n_frames == N_FRAMES
    assert eng._step_captures == 0 and not eng._graphs   # nothing captured


def test_cli_continuous(capsys):
    assert serve_cli.main(["--arch", "whisper-tiny", "--offload",
                           "--device", "cpu", "--power-w", "700",
                           "--continuous", "--slots", "2", "--requests", "3",
                           "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "continuous batching: 2 slots, 9 tokens streamed" in out
    # 3 admissions and 6 slot steps (2 requests, then the third)
    assert '"batch_pdp_j"' in out and '"ledger_commits": 9' in out
