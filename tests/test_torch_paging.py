"""The port's paged KV pool against the reference, on the CPU at the smoke
config, with identical weights (``convert.py``) and numpy-seeded mels and
states: ``repro_torch.serve.paging`` and the paged halves of
``repro_torch.models.attention``/``whisper`` held against
``repro.serve.paging`` and ``repro.models``, case for case after
``tests/test_paging.py``, ``tests/test_paging_properties.py`` and
``tests/test_paged_window.py``:

- ``PageAllocator`` against the reference's over seeded random operation
  sequences (refcounts, free counts, allocation order, 1 and 2 shards)
  and the rejection of dead-page operations;
- ``paged_window_update``/``paged_window_gather`` against the reference's
  (the five pinned edge cases, seeded geometries, rows independent),
  written in place;
- ``PagedKVPool``: geometry errors and defaults, committed bytes equal to
  the reference's ``state_kv_bytes``, ``paged_insert``/``paged_attach``/
  ``paged_copy_page`` exact against the reference's on the same state
  (the shared page never written), release and the digest;
- a paged decode step's logits against ``_decode_step_paged``, free rows
  on the trash page;
- ``PagedScheduler`` against the reference's on the same traces (Q8_0
  with bursts None and 256, and dense): tokens, ``shared_hits``,
  ``preemptions``, ledger commits and totals, ``active_peak``, committed
  and used KV bytes; the tight arena's preempt-and-recompute, the
  arena-too-small error, eviction admitting the queue head in the same
  pass, plan keys with page geometry, attribution, and
  ``ServeEngine.paged_scheduler``.

Tolerance 1e-4 on logits (f32 smoke config: the frameworks sum in another
order). Tokens, counts and bytes are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro.models.whisper import \
    WhisperPagedDecodeState as JaxPagedDecodeState
from repro.serve import paging as jax_paging
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _tensor, from_jax_params
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import plan_key
from repro_torch.models import attention, model
from repro_torch.models.attention import KVCache
from repro_torch.models.whisper import (
    WhisperDecodeState, WhisperPagedDecodeState)
from repro_torch.serve import paging
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paging import (
    PageAllocator, PagedKVPool, PagedScheduler, PagesExhausted)

TOL = dict(rtol=1e-4, atol=1e-4)
N_FRAMES = 8


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("whisper-tiny")
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg, 64)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, get_smoke_config("whisper-tiny"), tparams


def _mels(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, N_FRAMES, cfg.n_mels)).astype(np.float32)
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


def _t(a) -> torch.Tensor:
    return _tensor(np.asarray(a))


def _port_paged(jst) -> model.ServeState:
    """A reference paged ServeState in the port's types (the same
    stacked tensors)."""
    ls = jst.layer_states
    return model.ServeState(
        WhisperPagedDecodeState(*(_t(a) for a in ls)), _t(jst.step))


def _port_contig(jst) -> model.ServeState:
    """A reference contiguous ServeState (layer-stacked) in the port's
    layout (a list per layer)."""
    ls = jst.layer_states
    r = ls.self_kv.k.shape[0]
    ck, cv = ls.cross_kv
    return model.ServeState(
        WhisperDecodeState(
            self_kv=[KVCache(_t(ls.self_kv.k[i]), _t(ls.self_kv.v[i]),
                             _t(ls.self_kv.length[i])) for i in range(r)],
            cross_kv=[(_t(ck[i]), _t(cv[i])) for i in range(r)]),
        _t(jst.step))


def _assert_paged_equal(port, ref):
    """Every tensor of two paged states equal, trash pages included."""
    got, want = model.state_tensors(port), model.state_tensors(
        _port_paged(ref))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b), f"tensor {i} differs"


def _patterned(cfg, n_slots=2, page_size=4, n_pages=6, max_len=16):
    """A port pool and the reference's with the same geometry, whose self
    arenas hold a distinct value at every element (so any stray write
    shows), and the reference's state."""
    jpool = jax_paging.PagedKVPool(jax_smoke_config("whisper-tiny"), None,
                                   n_slots=n_slots, max_len=max_len,
                                   n_frames=N_FRAMES, page_size=page_size,
                                   n_pages=n_pages)
    ls = jpool.state.layer_states
    k = jnp.arange(ls.self_k.size, dtype=jnp.float32).reshape(
        ls.self_k.shape).astype(ls.self_k.dtype)
    jpool.state = jax_model.ServeState(
        ls._replace(self_k=k, self_v=k + 1.0), jpool.state.step)
    pool = PagedKVPool(cfg, n_slots, max_len, N_FRAMES, page_size=page_size,
                       n_pages=n_pages, device="cpu")
    for dst, src in zip(model.state_tensors(pool.state),
                        model.state_tensors(_port_paged(jpool.state))):
        dst.copy_(src)
    return pool, jpool


# ---------------------------------------------------------------------------
# PageAllocator
# ---------------------------------------------------------------------------
def _allocator_trace(cls, n_pages, n_shards, reserve, ops):
    """Run an op sequence on an allocator; record every result (or the
    exception's type) and the state after each op."""
    alloc = cls(n_pages, n_shards, reserve=reserve)
    out = []
    live = []
    for kind, pick in ops:
        try:
            if kind == 0:
                page = alloc.alloc(prefer=pick % 3 if pick % 2 else None)
                live.append(page)
                res = page
            elif kind == 1 and live:
                res = alloc.retain(live[pick % len(live)])
            elif kind == 2 and live:
                page = live[pick % len(live)]
                res = alloc.release(page)
                if alloc.refcount[page] == 0:
                    live.remove(page)
            else:
                res = None
        except (PagesExhausted, jax_paging.PagesExhausted) as e:
            res = type(e).__name__
        out.append((res, alloc.n_free, alloc.n_allocated,
                    alloc.refcount.tolist(),
                    [list(f) for f in alloc._free]))
    return out


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_reference_on_random_ops(n_shards, seed):
    """Seeded alloc/retain/release sequences: the port's allocator hands
    out the reference's pages in its order, with its refcounts, free
    lists and counts after every operation, exhaustion included."""
    rng = np.random.default_rng(seed)
    reserve = int(rng.integers(0, 2))
    n_pages = 2 * int(rng.integers(2, 9))
    ops = [(int(rng.integers(0, 3)), int(rng.integers(0, 10 ** 6)))
           for _ in range(60)]
    got = _allocator_trace(PageAllocator, n_pages, n_shards, reserve, ops)
    want = _allocator_trace(jax_paging.PageAllocator, n_pages, n_shards,
                            reserve, ops)
    assert got == want
    assert any(r == "PagesExhausted" for r, *_ in got) or seed


@pytest.mark.parametrize("cls", [PageAllocator, jax_paging.PageAllocator],
                         ids=["port", "reference"])
def test_allocator_rejects_dead_page_ops(cls):
    alloc = cls(4, reserve=1)
    with pytest.raises(ValueError):
        alloc.retain(2)                                # never allocated
    with pytest.raises(ValueError):
        alloc.release(2)
    p = alloc.alloc()
    alloc.release(p)
    with pytest.raises(ValueError):
        alloc.release(p)                               # already freed
    with pytest.raises(ValueError):
        cls(1, reserve=1)                              # nothing allocatable


def test_allocator_prefers_requested_shard():
    alloc = PageAllocator(8, n_shards=4, reserve=0)    # shards of 2 pages
    assert alloc.page_shard(alloc.alloc(prefer=2)) == 2
    assert alloc.page_shard(alloc.alloc(prefer=2)) == 2
    assert alloc.page_shard(alloc.alloc(prefer=2)) != 2
    assert PageAllocator(6, n_shards=4).n_shards == 1  # does not divide


# ---------------------------------------------------------------------------
# paged_window_update / paged_window_gather
# ---------------------------------------------------------------------------
HKV, HD = 2, 3


def _window_pair(ps, n_log, lengths, w, seed):
    b = len(lengths)
    rng = np.random.default_rng(seed)
    pages = rng.standard_normal((1 + b * n_log, ps, HKV, HD)).astype(
        np.float32)
    bt = (1 + np.arange(b * n_log)).reshape(b, n_log).astype(np.int32)
    length = np.asarray(lengths, np.int32)
    val = np.random.default_rng(seed + 1).standard_normal(
        (b, w, HKV, HD)).astype(np.float32)
    want_pages = jax_attention.paged_window_update(
        jnp.asarray(pages), jnp.asarray(bt), jnp.asarray(length),
        jnp.asarray(val))
    want = jax_attention.paged_window_gather(want_pages, jnp.asarray(bt))
    t_pages = torch.from_numpy(pages.copy())
    got_pages = attention.paged_window_update(
        t_pages, torch.from_numpy(bt), torch.from_numpy(length),
        torch.from_numpy(val))
    assert got_pages is t_pages                        # in place
    got = attention.paged_window_gather(got_pages, torch.from_numpy(bt))
    np.testing.assert_array_equal(got_pages.numpy(), np.asarray(want_pages))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # against the contiguous update of the gathered view
    ref = jax_attention._cache_update(
        jax_attention.paged_window_gather(jnp.asarray(pages),
                                          jnp.asarray(bt)),
        jnp.asarray(val), jnp.asarray(length))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ps,n_log,lengths,w", [
    (4, 3, [3, 0], 3),     # window straddles a page boundary (3..5)
    (2, 5, [1, 4], 5),     # W > page_size: window spans 3+ pages
    (4, 2, [4, 0], 4),     # window starts exactly on a boundary
    (1, 6, [2, 5], 1),     # page_size 1, the plain W = 1 step
    (5, 2, [5, 3], 5),     # fills the second page end to end
])
def test_paged_window_pinned_examples(ps, n_log, lengths, w):
    _window_pair(ps, n_log, lengths, w, seed=7)


@pytest.mark.parametrize("seed", range(6))
def test_paged_window_matches_reference_on_seeded_geometries(seed):
    rng = np.random.default_rng(100 + seed)
    ps, n_log = int(rng.integers(1, 7)), int(rng.integers(1, 6))
    w = min(int(rng.integers(1, 9)), ps * n_log)
    b = int(rng.integers(1, 5))
    lengths = rng.integers(0, ps * n_log - w + 1, size=b).tolist()
    _window_pair(ps, n_log, lengths, w, seed)


def test_paged_window_rows_independent():
    """Rows with private pages never interfere: row 1's NaN window lands
    in row 1's window only, row 0's zeros in row 0's."""
    rng = np.random.default_rng(11)
    pages = torch.from_numpy(rng.standard_normal((7, 4, HKV, HD)).astype(
        np.float32))
    bt = torch.arange(1, 7, dtype=torch.int32).reshape(2, 3)
    before = attention.paged_window_gather(pages, bt).clone()
    val = torch.zeros((2, 3, HKV, HD))
    val[1] = float("nan")
    attention.paged_window_update(pages, bt, torch.tensor([2, 6],
                                                          dtype=torch.int32),
                                  val)
    after = attention.paged_window_gather(pages, bt)
    assert torch.equal(after[0, 2:5], torch.zeros((3, HKV, HD)))
    assert torch.equal(after[0, :2], before[0, :2])
    assert torch.equal(after[0, 5:], before[0, 5:])
    assert after[1, 6:9].isnan().all()
    assert torch.equal(after[1, :6], before[1, :6])


def test_paged_window_clamps_a_free_row_past_the_table():
    """A free row's position past its table's end writes the trash page
    (its table row) at the clamped page, and raises nothing."""
    pages = torch.zeros((3, 2, 1, 1))
    bt = torch.tensor([[0, 0], [1, 2]], dtype=torch.int32)
    attention.paged_window_update(pages, bt, torch.tensor([9, 0],
                                                          dtype=torch.int32),
                                  torch.ones((2, 1, 1, 1)))
    assert pages[0, 1].item() == 1 and pages[1, 0].item() == 1
    assert pages.sum().item() == 2


# ---------------------------------------------------------------------------
# PagedKVPool
# ---------------------------------------------------------------------------
def test_pool_rejects_bad_geometry(smoke):
    _, _, tcfg, _ = smoke
    with pytest.raises(ValueError, match="power of two"):
        PagedKVPool(tcfg, 2, 16, N_FRAMES, page_size=3, device="cpu")
    with pytest.raises(ValueError, match="divide n_frames"):
        PagedKVPool(tcfg, 2, 16, N_FRAMES, cross_page_size=3, device="cpu")
    with pytest.raises(ValueError, match="n_frames"):
        PagedKVPool(tcfg, 2, 16, device="cpu")


@pytest.mark.parametrize("geom", [
    dict(page_size=4),
    dict(page_size=8, n_pages=5),
    dict(page_size=2, cross_page_size=4, n_cross_pages=3),
    dict(page_size=4, n_pages=9, cross_page_size=2, n_cross_pages=9)])
def test_pool_geometry_and_bytes_match_reference(smoke, geom):
    """Defaults (no oversubscription), plan geometry, page bytes and the
    committed bytes (the reference's ``state_kv_bytes``) are the
    reference's; used bytes count allocations."""
    jcfg, _, tcfg, _ = smoke
    ref = jax_paging.PagedKVPool(jcfg, None, 3, 16, n_frames=N_FRAMES,
                                 **geom)
    pool = PagedKVPool(tcfg, 3, 16, N_FRAMES, device="cpu", **geom)
    for attr in ("max_pages", "n_pages", "n_cross_per_req", "n_cross_pages",
                 "plan_geometry", "page_bytes", "cross_page_bytes"):
        assert getattr(pool, attr) == getattr(ref, attr), attr
    assert pool.committed_kv_bytes() == ref.committed_kv_bytes() == \
        jax_model.state_kv_bytes(ref.state)
    for a, b in zip(model.state_tensors(pool.state),
                    model.state_tensors(_port_paged(ref.state)),
                    strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert pool.used_kv_bytes() == 0
    for p in (pool, ref):
        slot = p.acquire()
        p.alloc_self_page(slot)
        p.alloc_cross_pages(slot, "d")
    assert pool.used_kv_bytes() == ref.used_kv_bytes() == \
        pool.page_bytes + pool.n_cross_per_req * pool.cross_page_bytes


def test_pool_defaults_cover_full_occupancy(smoke):
    _, _, tcfg, _ = smoke
    pool = PagedKVPool(tcfg, 3, 16, N_FRAMES, page_size=4, device="cpu")
    assert pool.max_pages == 4 and pool.n_pages == 1 + 3 * 4
    assert pool.n_cross_per_req == 1 and pool.n_cross_pages == 1 + 3
    assert pool.plan_geometry == (4, 13, N_FRAMES, 4)


@pytest.mark.parametrize("write_cross", [True, False])
@pytest.mark.parametrize("extra", [0, 3])
def test_insert_and_attach_match_reference(smoke, write_cross, extra):
    """``paged_insert`` of a prefill state (its counters moved by
    ``extra``) into slot 1's pages, then ``paged_attach`` of slot 0, equal
    the reference's ops on the same state, in place (the pool's tensors
    keep their storage)."""
    jcfg, jparams, tcfg, _ = smoke
    pool, jpool = _patterned(tcfg, n_slots=2, n_pages=8)
    jeng = JaxServeEngine(jcfg, jparams, max_len=16, quant="none", eos_id=-1)
    _, jreq = jeng._prefill_jit(jeng._serve_params,
                                jnp.asarray(_mels(jcfg, 1)[0]))
    jreq = jreq._replace(step=jreq.step + extra, layer_states=jreq
                         .layer_states._replace(self_kv=jreq.layer_states
                                                .self_kv._replace(
                             length=jreq.layer_states.self_kv.length
                             + extra)))
    for p in (pool, jpool):
        p.acquire()
        slot = p.acquire()
        p.alloc_cross_pages(slot, "d0")
        p.alloc_self_page(slot)
        p.alloc_self_page(slot)
        p.sync()
    ptrs = [t.data_ptr() for t in model.state_tensors(pool.state)]
    pool.insert(1, _port_contig(jreq), write_cross=write_cross)
    jpool.insert(1, jreq, write_cross=write_cross)
    _assert_paged_equal(pool.state, jpool.state)
    pool.attach_reset(0)
    jpool.attach_reset(0)
    _assert_paged_equal(pool.state, jpool.state)
    assert [t.data_ptr() for t in model.state_tensors(pool.state)] == ptrs
    assert int(pool.state.step[1]) == extra
    assert pool.state.layer_states.length[:, 1].tolist() == \
        [extra] * tcfg.num_layers


@pytest.mark.parametrize("n_sharers,writer", [(2, 1), (3, 0), (4, 2)])
def test_cow_split_matches_reference_and_never_mutates(smoke, n_sharers,
                                                       writer):
    """A copy-on-write split by any sharer copies the page (the
    reference's ``paged_copy_page``), repoints only the writer's table and
    leaves the shared page's bytes as they were."""
    _, _, tcfg, _ = smoke
    pool, jpool = _patterned(tcfg, n_slots=4, n_pages=10)
    for p in (pool, jpool):
        src = p.alloc_self_page(0)
        for s in range(1, n_sharers):
            p.alias_self_page(s, 0, 0)
    before = pool.state.layer_states.self_k[:, src].clone()
    fresh = pool.ensure_private(writer, 0)
    assert fresh == jpool.ensure_private(writer, 0) != src
    _assert_paged_equal(pool.state, jpool.state)
    assert torch.equal(pool.state.layer_states.self_k[:, src], before)
    assert torch.equal(pool.state.layer_states.self_k[:, fresh], before)
    assert pool.self_alloc.refcount.tolist() == \
        jpool.self_alloc.refcount.tolist()
    assert (pool._bt == jpool._bt).all()
    assert pool.ensure_private(writer, 0) == fresh     # private: no-op


def test_release_returns_references_and_unpublishes_digest(smoke):
    _, _, tcfg, _ = smoke
    pool, _ = _patterned(tcfg, n_pages=8)
    pool.alloc_cross_pages(0, "digest-a")
    pool.attach_shared(1, "digest-a")
    pool.alloc_self_page(0)
    pool.alloc_self_page(1)
    slot0, slot1 = pool.acquire(), pool.acquire()
    free_before = (pool.self_alloc.n_free, pool.cross_alloc.n_free)
    pool.release(slot0)
    assert pool.has_shared("digest-a")                 # slot 1 still holds it
    pool.release(slot1)
    assert not pool.has_shared("digest-a")
    assert pool.self_alloc.n_free == free_before[0] + 2
    assert pool.cross_alloc.n_free == free_before[1] + pool.n_cross_per_req
    assert not pool._bt[:2].any() and not pool._ct[:2].any()
    pool.sync()
    assert not pool.state.layer_states.block_table.any()


def test_sync_copies_tables_in_place(smoke):
    """``sync`` writes the host tables into the state's own device
    tables (a captured step rereads them) and only when they changed."""
    _, _, tcfg, _ = smoke
    pool = PagedKVPool(tcfg, 2, 16, N_FRAMES, page_size=4, device="cpu")
    ls = pool.state.layer_states
    bt, ct = ls.block_table, ls.cross_table
    slot = pool.acquire()
    pool.alloc_self_page(slot)
    pool.alloc_cross_pages(slot, "d")
    pool.sync()
    assert pool.state.layer_states.block_table is bt
    assert bt.tolist() == pool._bt.tolist() and ct.tolist() == \
        pool._ct.tolist()
    pool._bt[0, 1] = 7                                 # not marked dirty
    pool.sync()
    assert bt[0, 1].item() == 0


def test_mel_digest_is_the_references(smoke):
    _, _, tcfg, _ = smoke
    m = _mels(tcfg, 1)[0]
    assert paging._mel_digest(m) == jax_paging._mel_digest(m) == \
        paging._mel_digest(m.copy())
    assert paging._mel_digest(m) != paging._mel_digest(m + 1)


# ---------------------------------------------------------------------------
# The paged decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", ["none", "q8_0"])
def test_paged_decode_steps_match_reference(smoke, quant):
    """A paged state with seeded arenas, three live slots at different
    positions (one crossing into its second page) and one free slot on
    the trash page: three steps' logits within 1e-4 of the reference's
    ``_decode_step_paged``, lengths and steps exact, the arenas (the trash
    page aside) within 1e-4."""
    jcfg, jparams, tcfg, _ = smoke
    jeng, teng = _pair(smoke, quant, max_len=16)
    rng = np.random.default_rng(9)
    r, hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    ps, n_pages, max_pages = 4, 10, 4

    def arena(p, s):
        return rng.standard_normal((r, p, s, hkv, hd)).astype(np.float32)
    bt = np.asarray([[1, 2, 0, 0], [3, 0, 0, 0], [0, 0, 0, 0],
                     [4, 5, 6, 0]], np.int32)
    ct = np.asarray([[1], [2], [0], [1]], np.int32)
    length = np.tile(np.asarray([3, 2, 9, 10], np.int32), (r, 1))
    jls = JaxPagedDecodeState(
        self_k=jnp.asarray(arena(n_pages, ps)),
        self_v=jnp.asarray(arena(n_pages, ps)),
        cross_k=jnp.asarray(arena(3, N_FRAMES)),
        cross_v=jnp.asarray(arena(3, N_FRAMES)),
        block_table=jnp.asarray(bt), cross_table=jnp.asarray(ct),
        length=jnp.asarray(length))
    jst = jax_model.ServeState(jls, jnp.asarray([3, 2, 9, 10], jnp.int32))
    state = _port_paged(jst)
    for tok in ([[1], [5], [7], [2]], [[2], [3], [4], [9]],
                [[9], [8], [6], [1]]):
        jlog, jst = jax_model.serve_step(jeng._serve_params, jcfg,
                                         jnp.asarray(tok, jnp.int32), jst)
        with torch.no_grad():
            tlog, state = model.serve_step(teng._serve_params, tcfg,
                                           torch.tensor(tok), state)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert state.step.tolist() == np.asarray(jst.step).tolist()
        assert state.layer_states.length.tolist() == \
            np.asarray(jst.layer_states.length).tolist()
    for i, name in enumerate(("self_k", "self_v")):
        np.testing.assert_allclose(
            getattr(state.layer_states, name)[:, 1:].numpy(),
            np.asarray(getattr(jst.layer_states, name))[:, 1:], **TOL)
    assert state.layer_states.length[0, 2].item() == 12    # free, no error


# ---------------------------------------------------------------------------
# The paged scheduler against the reference's
# ---------------------------------------------------------------------------
def _drive_manual(sched, trace):
    """Submit a trace, drive admit/decode by hand (results stay in
    ``finished``); returns (tokens by submission, steps run)."""
    rids = [sched.submit(m, max_new=n) for m, n in trace]
    steps = 0
    while sched.n_queued or sched.n_active:
        sched.admit()
        if sched.decode_step():
            steps += 1
    return [sched.finished[r].tokens for r in rids], steps


def _stats_delta(teng, jeng, n_prefills):
    """The two ledgers' totals, the reference's plus its one quirk: its
    prefill plan records ``dec.cross.k``/``.v`` once where the port runs
    and records them every layer."""
    a = dataclasses.asdict(teng.offload.stats)
    b = dataclasses.asdict(jeng.offload.stats)
    extra = (teng.cfg.num_layers - 1) * n_prefills
    cross = teng._plans.plans[("prefill", teng._serve_quant, 1,
                               N_FRAMES)].entries[-2:]
    assert a["offloaded_calls"] == b["offloaded_calls"] + 2 * extra
    assert a["fallback_calls"] == b["fallback_calls"]
    for f in ("offloaded_flops", "residual_flops", "fallback_flops"):
        assert a[f] == b[f] + extra * sum(getattr(e, f) for e in cross)
    assert a["by_kernel"] == {
        k: v + (extra if k.startswith("dec.cross") else 0)
        for k, v in b["by_kernel"].items()}


TRACE = [(0, 6), (1, 6), (0, 3), (1, 3), (2, 3), (2, 5), (3, 4)]


@pytest.mark.parametrize("quant,burst", [("q8_0", None), ("q8_0", 256),
                                         ("none", None)])
@pytest.mark.parametrize("geom", [
    dict(n_slots=3, page_size=4),                     # no oversubscription
    dict(n_slots=3, page_size=4, n_pages=5)],         # tight: preempts
    ids=["default", "tight"])
def test_paged_scheduler_matches_reference(smoke, quant, burst, geom):
    """The same trace through the port's and the reference's paged
    schedulers: equal tokens (and each equal to a batch-1 transcribe),
    prefix hits, preemptions, replays, ledger commits and totals, peak
    activity and KV bytes."""
    jeng, teng = _pair(smoke, quant, burst)
    m = _mels(teng.cfg, 4)
    trace = [(m[i], n) for i, n in TRACE]
    refs = [teng.transcribe(mel, max_new=n)[0].tokens for mel, n in trace]
    out = []
    for eng in (teng, jeng):
        sched = eng.paged_scheduler(n_frames=N_FRAMES, **geom)
        c0 = eng.offload.ledger.commits if eng.offload else 0
        tokens, steps = _drive_manual(sched, trace)
        out.append(dict(
            tokens=tokens, steps=steps, hits=sched.shared_hits,
            preemptions=sched.preemptions,
            commits=(eng.offload.ledger.commits - c0) if eng.offload else 0,
            active_peak=sched.active_peak,
            committed=sched.kv_committed_bytes, used=sched.kv_used_peak,
            payloads=len(sched._payloads)))
        if eng is teng:
            port = sched
    assert out[0] == out[1]
    assert out[0]["tokens"] == refs
    assert out[0]["hits"] >= 1 and out[0]["payloads"] == 0
    assert (out[0]["preemptions"] > 0) == ("n_pages" in geom)
    assert port.prefills == len(trace) - port.shared_hits + port.replays
    if teng.offload is not None:
        assert out[0]["commits"] == port.prefills + out[0]["steps"] + \
            port.replays


@pytest.mark.parametrize("burst", [256, 32])
def test_ledger_totals_match_reference_through_preemption(smoke, burst):
    """Ledger totals after the same tight-arena drive (hits, preemptions
    and replays) equal the reference's up to its cross-K/V quirk; the
    port's commits are its prefills, slot steps and replays."""
    jeng, teng = _pair(smoke, "q8_0", burst, max_len=16)
    m = _mels(teng.cfg, 3, seed=2)
    trace = [(m[0], 6), (m[1], 6), (m[0], 5), (m[2], 6)]
    for eng in (teng, jeng):
        sched = eng.paged_scheduler(n_slots=3, n_frames=N_FRAMES,
                                    page_size=4, n_pages=5)
        _, steps = _drive_manual(sched, trace)
        if eng is teng:
            port, port_steps = sched, steps
        else:
            assert (sched.preemptions, sched.shared_hits) == \
                (port.preemptions, port.shared_hits)
    assert port.preemptions > 0 and port.replays > 0
    assert teng.offload.ledger.commits == jeng.offload.ledger.commits == \
        port.prefills + port_steps + port.replays
    _stats_delta(teng, jeng, port.prefills)


def test_tight_arena_preempts_and_recomputes_token_exactly(smoke):
    """Four self pages for three slots of two pages each: the capacity
    pass preempts, the replay recomputes, and every stream stays equal to
    its batch-1 transcribe; the attribution sums to the batch's."""
    _, teng = _pair(smoke, "q8_0", 256)
    mels = _mels(teng.cfg, 3)
    refs = [teng.transcribe(m, max_new=6)[0].tokens for m in mels]
    sched = teng.paged_scheduler(n_slots=3, n_frames=N_FRAMES, page_size=4,
                                 n_pages=5)
    rids = [sched.submit(m, max_new=6) for m in mels]
    res = sched.run()
    assert [res[r].tokens for r in rids] == refs
    assert all(res[r].steps == 6 for r in rids)
    assert sched.preemptions > 0 and sched.replays > 0
    assert sched.replayed_steps >= sched.replays
    assert not sched._payloads


def test_arena_too_small_raises_instead_of_livelock(smoke):
    _, teng = _pair(smoke)
    sched = teng.paged_scheduler(n_slots=2, n_frames=N_FRAMES, page_size=4,
                                 cross_page_size=4, n_cross_pages=2)
    sched.submit(_mels(teng.cfg, 1)[0], max_new=2)
    with pytest.raises(RuntimeError, match="arena too small"):
        sched.run()


def test_eviction_frees_pages_for_immediate_admission(smoke):
    """With a full arena and a queued request, the admission pass right
    after an EOS eviction admits it."""
    _, _, tcfg, tparams = smoke
    mel = _mels(tcfg, 1)[0]
    probe = ServeEngine(tcfg, tparams, max_len=16, quant="none", eos_id=-1,
                        device="cpu")
    first = probe.transcribe(mel, max_new=3)[0].tokens[0]
    eng = ServeEngine(tcfg, tparams, max_len=16, quant="none",
                      eos_id=int(first), device="cpu")
    sched = eng.paged_scheduler(n_slots=2, n_frames=N_FRAMES, page_size=4,
                                n_pages=2, n_cross_pages=2)
    r0 = sched.submit(mel, max_new=8)
    r1 = sched.submit(_mels(tcfg, 2)[1], max_new=8)
    assert sched.admit() == [r0]                       # full: r1 waits
    assert sched.n_queued == 1
    assert not sched.pool.can_alloc(1, sched.pool.n_cross_per_req)
    events = sched.decode_step()                       # r0 hits EOS
    assert any(ev.rid == r0 and ev.done for ev in events)
    assert sched.admit() == [r1]                       # freed pages, now
    assert sched.finished[r0].tokens == [int(first)]


def test_shared_hit_skips_prefill_and_its_ledger_commit(smoke):
    _, teng = _pair(smoke, "q8_0", 256, max_len=16)
    mel = _mels(teng.cfg, 1)[0]
    sched = teng.paged_scheduler(n_slots=2, n_frames=N_FRAMES, page_size=4)
    r0 = sched.submit(mel, max_new=3)
    r1 = sched.submit(mel.copy(), max_new=3)           # same bytes
    _, n_steps = _drive_manual(sched, [])
    assert sched.shared_hits == 1 and sched.prefills == 1
    assert teng.offload.ledger.commits == 1 + n_steps
    assert sched.finished[r0].tokens == sched.finished[r1].tokens
    assert not sched.pool._shared                      # retired with pages


@pytest.mark.parametrize("pages", [None, (4, 9, N_FRAMES, 3),
                                   (8, 9, N_FRAMES, 3)])
def test_plan_keys_with_page_geometry_equal_reference(smoke, pages):
    jeng, teng = _pair(smoke, "q8_0", 256, max_len=16)
    assert teng._key("step", 2, N_FRAMES, pages=pages) == \
        jeng._key("step", 2, N_FRAMES, pages=pages)
    assert plan_key("step", "q8_0", 2, N_FRAMES, pages=pages) == \
        jeng._key("step", 2, N_FRAMES, pages=pages)
    if pages is None:
        assert teng._key("step", 2, N_FRAMES) == ("step", "q8_0", 2,
                                                  N_FRAMES)
    else:
        assert teng._key("step", 2, N_FRAMES, pages=pages) != \
            teng._key("step", 2, N_FRAMES)


def test_paged_and_contiguous_steps_hold_separate_plans(smoke):
    """The paged step records its own plan at its geometry's key; the
    batch-1 prefill's is shared; the key sets equal the reference's."""
    jeng, teng = _pair(smoke, "q8_0", 256, max_len=16)
    mel = _mels(teng.cfg, 1)[0]
    for eng in (teng, jeng):
        sched = eng.scheduler(n_slots=2, n_frames=N_FRAMES)
        sched.submit(mel, max_new=2)
        sched.run()
        n = len(eng._plans)
        sched = eng.paged_scheduler(n_slots=2, n_frames=N_FRAMES,
                                    page_size=4)
        sched.submit(mel, max_new=2)
        sched.run()
        assert len(eng._plans) == n + 1
    assert set(teng._plans.plans) == set(jeng._plans.plans)
    key = teng._key("step", 2, N_FRAMES, pages=sched.pool.plan_geometry)
    assert key in teng._plans.plans and key[-1][0] == "pages"


def test_attribution_sums_to_the_batch(smoke):
    _, teng = _pair(smoke, "q8_0", 256)
    m = _mels(teng.cfg, 4)
    sched = teng.paged_scheduler(n_slots=3, n_frames=N_FRAMES, page_size=4,
                                 n_pages=5)
    _drive_manual(sched, [(m[i], n) for i, n in TRACE])
    att = sched.attribution(700.0)
    assert att["drained"] and len(att["per_request_pdp_j"]) == len(TRACE)
    assert sum(att["per_request_pdp_j"].values()) == \
        pytest.approx(att["batch_pdp_j"], rel=1e-9)
    assert sched.preemptions > 0


def test_engine_paged_scheduler_builds_fresh(smoke):
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, max_len=32, quant="none", eos_id=-1,
                      device="cpu")
    a = eng.paged_scheduler(n_slots=2, n_frames=N_FRAMES, page_size=4)
    b = eng.paged_scheduler(n_slots=2, n_frames=N_FRAMES, page_size=4)
    assert isinstance(a, PagedScheduler) and a is not b
    assert a.pool.state.layer_states.self_k is not \
        b.pool.state.layer_states.self_k
    assert eng._scheduler is None                      # not the cached one
    mels = _mels(tcfg, 2)
    rids = [a.submit(m, max_new=3) for m in mels]
    got = a.run()
    assert [got[r].tokens for r in rids] == \
        [eng.transcribe(m, max_new=3)[0].tokens for m in mels]
    assert eng._step_captures == 0 and not eng._graphs  # nothing captured
    with pytest.raises(ValueError, match="n_frames"):
        eng.paged_scheduler(n_slots=2)
