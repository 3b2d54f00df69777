"""The port's speculative decoding against the reference, on the CPU at the
smoke ladder (``get_smoke_config("whisper-tiny")`` drafts,
``"whisper-base"`` verifies), with identical weights (``convert.py``) and
numpy-seeded mels: ``repro_torch.serve.speculative`` and the window halves
of ``repro_torch.models`` held against ``repro.serve.speculative`` and
``repro.models``, case for case after ``tests/test_speculative.py``,
``tests/test_spec_scheduling.py`` and ``tests/test_paged_window.py``:

- ``accept_spec`` on the pinned cases, against sequential greedy and the
  reference's, and the hypothesis property;
- the W-window ``_cache_update`` against the reference's (pinned edge
  cases, a per-row start clamped to ``S_max - W``), in place; a paged
  window straddling pages equal to the contiguous one;
- ``verify_step`` logits against the reference's (per-row, lockstep and
  paged) and equal to W sequential ``decode_step``s (bit for bit through
  the offload engine, whose kernels' plain versions and host arm take a
  row at a time), W = 1 equal to ``decode_step`` bit for bit;
  ``set_slot_lengths`` in place against the reference's;
- speculative tokens equal to the reference's and to the verifier's own
  ``transcribe`` (dense at k = 1, 4, 8; Q8_0 with bursts None and 256; the
  self-draft full accept), EOS truncation, the guards in their order;
- plan keys with role and k, plan entries equal to the reference's (the
  draft's without ``backend``: the reference pins its draft to its plain
  backend, the port's runs on the Hopper kernels), ``by_role`` and commits
  equal to the reference's, ``energy_report``'s ``by_role``;
- ``SpecScheduler`` waves, ``SpecContinuousScheduler`` and
  ``PagedSpecScheduler`` (default and tight arena) on the reference's
  trace: tokens, preemptions, drained arenas, attribution, the submit
  guard;
- ``OffloadEngine.should_offload`` against the reference's over a seeded
  grid, and the CLI's ``--speculative``.

Tolerance 1e-4 on logits (f32 smoke config: the frameworks sum in another
order). Tokens, counts and FLOPs are exact.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hyp import given, settings, st

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.core.plan import plan_key as jax_plan_key
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro.models.whisper import \
    WhisperPagedDecodeState as JaxPagedDecodeState
from repro.serve import speculative as jax_spec
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _tensor, from_jax_params
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.plan import plan_key
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, model
from repro_torch.models.whisper import WhisperPagedDecodeState
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.speculative import (
    PagedSpecScheduler, SpecContinuousScheduler, SpecScheduler,
    SpeculativeEngine, accept_spec)

TOL = dict(rtol=1e-4, atol=1e-4)
N_FRAMES = 16
K = 3
# the reference's plain backend and its Pallas one both map to the port's
# Hopper kernels; the host arm is the host arm
BACKEND_NAMES = {"pallas_tpu": "hopper", "xla_ref": "hopper",
                 "host_residual": "host_residual"}
ENTRY_FIELDS = ("name", "m", "k", "n", "dtype", "offload", "burst", "tuned",
                "kernel", "k_main", "k_res")


@pytest.fixture(scope="module")
def ladder():
    jt, jb = jax_smoke_config("whisper-tiny"), jax_smoke_config("whisper-base")
    jtp = jax_model.init_params(jax.random.PRNGKey(0), jt)
    jbp = jax_model.init_params(jax.random.PRNGKey(1), jb)

    def port(p):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, p),
                               device="cpu")
    return dict(jt=jt, jtp=jtp, jb=jb, jbp=jbp,
                tt=get_smoke_config("whisper-tiny"), ttp=port(jtp),
                tb=get_smoke_config("whisper-base"), tbp=port(jbp))


@pytest.fixture(scope="module")
def mel(ladder):
    return np.random.default_rng(2).standard_normal(
        (2, N_FRAMES, ladder["tt"].n_mels)).astype(np.float32)


def _offloads(burst):
    """The two packages' offload engines: None, the default, or a burst."""
    if burst is None:
        return None, None
    kw = {} if burst == "default" else dict(burst=burst)
    return JaxOffloadEngine(prefer_pallas=False, **kw), OffloadEngine(**kw)


def _verifiers(ladder, quant="none", burst=None, max_len=64, eos_id=-1):
    """A reference verifier and a port verifier on the same weights."""
    joff, toff = _offloads(burst)
    return (JaxServeEngine(ladder["jb"], ladder["jbp"], max_len=max_len,
                           quant=quant, offload=joff, eos_id=eos_id),
            ServeEngine(ladder["tb"], ladder["tbp"], max_len=max_len,
                        quant=quant, offload=toff, eos_id=eos_id,
                        device="cpu"))


def _specs(ladder, jv, tv, k):
    return (jv.speculative(ladder["jt"], ladder["jtp"], k=k),
            tv.speculative(ladder["tt"], ladder["ttp"], k=k))


def _tokens(results):
    return [r.tokens for r in results]


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------
def _greedy_reference(drafts_row, vtoks_row):
    """What feeding the verifier one token at a time emits."""
    out = []
    for j, d in enumerate(drafts_row):
        out.append(int(vtoks_row[j]))
        if d != vtoks_row[j]:
            return out
    out.append(int(vtoks_row[len(drafts_row)]))
    return out


def _same_accept(drafts, vtoks):
    got = accept_spec(drafts, vtoks)
    want = jax_spec.accept_spec(drafts, vtoks)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("drafts,vtoks,accepted,emitted", [
    ([5, 6, 7], [5, 6, 7, 8], 3, [5, 6, 7, 8]),    # full accept, bonus
    ([5, 6, 7], [9, 6, 7, 8], 0, [9]),             # first-token mismatch
    ([5, 6, 7], [5, 9, 7, 8], 1, [5, 9]),          # mid-window correction
])
def test_accept_spec_pinned_cases(drafts, vtoks, accepted, emitted):
    a, c, n = _same_accept(np.array([drafts]), np.array([vtoks]))
    assert int(a[0]) == accepted and list(c[0, :n[0]]) == emitted


@pytest.mark.parametrize("k", [1, 4, 8])
def test_accept_spec_matches_sequential_greedy_and_reference(k):
    rng = np.random.default_rng(k)
    drafts = rng.integers(0, 4, size=(5, k))
    vtoks = rng.integers(0, 4, size=(5, k + 1))
    accept_len, committed, n_emit = _same_accept(drafts, vtoks)
    for r in range(5):
        ref = _greedy_reference(drafts[r], vtoks[r])
        assert list(committed[r, :n_emit[r]]) == ref
        assert accept_len[r] == len(ref) - 1


@given(st.data())
@settings(max_examples=60, deadline=None)
def test_accept_spec_property(data):
    """For any drafts and verifier tokens the committed prefix is what
    sequential greedy on the verifier emits, every round emits a token,
    and the reference agrees."""
    k = data.draw(st.integers(min_value=1, max_value=8))
    b = data.draw(st.integers(min_value=1, max_value=4))
    tok = st.integers(min_value=0, max_value=9)
    drafts = np.array(data.draw(st.lists(
        st.lists(tok, min_size=k, max_size=k), min_size=b, max_size=b)))
    vtoks = np.array(data.draw(st.lists(
        st.lists(tok, min_size=k + 1, max_size=k + 1),
        min_size=b, max_size=b)))
    accept_len, committed, n_emit = _same_accept(drafts, vtoks)
    assert (n_emit >= 1).all() and (n_emit == accept_len + 1).all()
    for r in range(b):
        assert list(committed[r, :n_emit[r]]) == _greedy_reference(
            drafts[r], vtoks[r])


def test_accept_spec_rejects_bad_shapes():
    with pytest.raises(ValueError, match="k\\+1"):
        accept_spec(np.zeros((2, 3), int), np.zeros((2, 3), int))


# ---------------------------------------------------------------------------
# the window's cache writes
# ---------------------------------------------------------------------------
HKV, HD = 2, 3


@pytest.mark.parametrize("s_max,lengths,w", [
    (8, [2, 0, 5], 3),          # per-row starts, in range
    (8, [2, 6, 7], 3),          # rows 1 and 2 clamped to S_max - W = 5
    (8, [9, 3], 1),             # W = 1: clamped to the last position
    (6, [4, 0], 6),             # a window as long as the cache
    (8, 3, 4),                  # a scalar length: every row at one index
])
def test_window_cache_update_matches_reference(s_max, lengths, w):
    rng = np.random.default_rng(s_max + w)
    per_row = isinstance(lengths, list)
    b = len(lengths) if per_row else 2
    buf = rng.standard_normal((b, s_max, HKV, HD)).astype(np.float32)
    val = rng.standard_normal((b, w, HKV, HD)).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    want = jax_attention._cache_update(jnp.asarray(buf), jnp.asarray(val),
                                       jnp.asarray(length))
    t_buf = torch.from_numpy(buf.copy())
    got = attention._cache_update(t_buf, torch.from_numpy(val),
                                  torch.from_numpy(length))
    assert got is t_buf                                # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ps,n_log,lengths,w", [
    (4, 3, [3, 0], 3),     # the window straddles a page boundary (3..5)
    (2, 5, [1, 4], 5),     # W > page size: the window spans 3 pages
    (4, 2, [4, 0], 4),     # the window starts on a boundary
    (5, 2, [5, 3], 5),     # fills the second page end to end
])
def test_paged_window_equals_the_contiguous_window(ps, n_log, lengths, w):
    """The W entries scattered through the block table and gathered back
    equal the contiguous window's write of the same view; the pages no
    entry lands on (the trash page included) are not written."""
    b = len(lengths)
    rng = np.random.default_rng(ps * 10 + w)
    pages = torch.from_numpy(rng.standard_normal(
        (1 + b * n_log, ps, HKV, HD)).astype(np.float32))
    bt = torch.arange(1, 1 + b * n_log, dtype=torch.int32).reshape(b, n_log)
    length = torch.tensor(lengths, dtype=torch.int32)
    val = torch.from_numpy(rng.standard_normal((b, w, HKV, HD)).astype(
        np.float32))
    want = attention._cache_update(
        attention.paged_window_gather(pages, bt).clone(), val, length)
    before = pages.clone()
    attention.paged_window_update(pages, bt, length, val)
    assert torch.equal(attention.paged_window_gather(pages, bt), want)
    touched = {int(bt[r, (n + j) // ps]) for r, n in enumerate(lengths)
               for j in range(w)}
    for p in set(range(pages.shape[0])) - touched:
        assert torch.equal(pages[p], before[p])


# ---------------------------------------------------------------------------
# verify_step and set_slot_lengths
# ---------------------------------------------------------------------------
def _prefilled(jv, tv, mel):
    """Both engines' decode states after a prefill of ``mel``."""
    _, jst = jv._prefill_jit(jv._serve_params, jnp.asarray(mel))
    _, tst = tv.prefill(torch.from_numpy(mel))
    return jst, tst


@pytest.mark.parametrize("per_row", [True, False])
def test_verify_step_logits_match_reference(ladder, mel, per_row):
    """A W = 4 window from per-row lengths (slot layout) or one lockstep
    length, then a W = 2 window on the advanced state: logits within 1e-4
    of the reference's, lengths and steps exact."""
    jv, tv = _verifiers(ladder)
    jst, tst = _prefilled(jv, tv, mel)
    tok = np.random.default_rng(5).integers(0, 100, (2, 6)).astype(np.int32)
    with torch.inference_mode():
        if per_row:
            jst = jax_model.set_slot_lengths(
                jax_model.slot_layout(jst, 2), jnp.asarray([3, 5], jnp.int32))
            tst = model.slot_layout(tst, 2)
            model.set_slot_lengths(tst, torch.tensor([3, 5],
                                                     dtype=torch.int32))
        for a, b in ((0, 4), (4, 6)):
            jlog, jst = jax_model.verify_step(jv._serve_params, ladder["jb"],
                                              jnp.asarray(tok[:, a:b]), jst)
            tlog, tst = model.verify_step(tv._serve_params, ladder["tb"],
                                          torch.from_numpy(tok[:, a:b]).long(),
                                          tst)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
            assert tst.step.tolist() == np.asarray(jst.step).tolist()
            assert [kv.length.tolist() for kv in tst.layer_states.self_kv] \
                == np.asarray(jst.layer_states.self_kv.length).tolist()


@pytest.mark.parametrize("quant,offload", [("q8_0", True), ("none", True),
                                           ("none", False)])
def test_window_equals_sequential_steps(ladder, mel, quant, offload):
    """A W = 5 window's logits at position j are the j-th of five
    sequential decode steps' from the same per-row lengths: bit for bit
    through the offload engine (its kernels' plain versions and the host
    arm take a row at a time), within 1e-4 with plain matmuls (their sums
    follow the row count). The states advance alike."""
    tv = ServeEngine(ladder["tb"], ladder["tbp"], max_len=32, quant=quant,
                     offload=OffloadEngine() if offload else None,
                     eos_id=-1, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(6).integers(0, 100, (2, 5)))
    with torch.inference_mode():
        _, st_ = tv.prefill(torch.from_numpy(mel))
        st_ = model.slot_layout(st_, 2)
        model.set_slot_lengths(st_, torch.tensor([3, 5], dtype=torch.int32))
        snap = [t.clone() for t in model.state_tensors(st_)]
        win, _ = model.verify_step(tv._serve_params, tv.cfg, tok, st_,
                                   engine=tv.offload)
        after = [t.clone() for t in model.state_tensors(st_)]
        for t, s in zip(model.state_tensors(st_), snap):
            t.copy_(s)
        seq = torch.cat([model.serve_step(tv._serve_params, tv.cfg,
                                          tok[:, j:j + 1], st_,
                                          engine=tv.offload)[0]
                         for j in range(5)], dim=1)
    if offload:
        assert torch.equal(win, seq)
    else:
        np.testing.assert_allclose(win.numpy(), seq.numpy(), **TOL)
    for a, b in zip(after, model.state_tensors(st_)):
        assert torch.equal(a, b) if offload else torch.allclose(a, b, **TOL)


@pytest.mark.parametrize("per_row", [True, False])
def test_one_token_verify_step_is_the_decode_step(ladder, mel, per_row):
    tv = ServeEngine(ladder["tb"], ladder["tbp"], max_len=32, quant="q8_0",
                     offload=OffloadEngine(), eos_id=-1, device="cpu")
    tok = torch.tensor([[7], [11]])
    outs = []
    with torch.inference_mode():
        for fn in (model.verify_step, model.serve_step):
            _, st_ = tv.prefill(torch.from_numpy(mel))
            if per_row:
                st_ = model.slot_layout(st_, 2)
                model.set_slot_lengths(st_, torch.tensor([2, 4],
                                                         dtype=torch.int32))
            logits, st_ = fn(tv._serve_params, tv.cfg, tok, st_,
                             engine=tv.offload)
            outs.append((logits, model.state_tensors(st_)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def _paged_states(ladder, rng):
    """A reference paged state with seeded arenas (two live slots, one
    straddling into its second page, one free slot on the trash page) and
    the port's on the same tensors."""
    cfg = ladder["tb"]
    r, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def arena(p, s):
        return rng.standard_normal((r, p, s, hkv, hd)).astype(np.float32)
    bt = np.asarray([[1, 2, 0, 0], [0, 0, 0, 0], [3, 4, 5, 0]], np.int32)
    ct = np.asarray([[1], [0], [2]], np.int32)
    lengths = np.asarray([3, 9, 6], np.int32)
    jls = JaxPagedDecodeState(
        self_k=jnp.asarray(arena(6, 4)), self_v=jnp.asarray(arena(6, 4)),
        cross_k=jnp.asarray(arena(3, N_FRAMES)),
        cross_v=jnp.asarray(arena(3, N_FRAMES)),
        block_table=jnp.asarray(bt), cross_table=jnp.asarray(ct),
        length=jnp.asarray(np.tile(lengths, (r, 1))))
    jst = jax_model.ServeState(jls, jnp.asarray(lengths))
    ls = jst.layer_states
    tst = model.ServeState(
        WhisperPagedDecodeState(*(_tensor(np.asarray(a)) for a in ls)),
        _tensor(np.asarray(jst.step)))
    return jst, tst


def test_paged_verify_step_matches_reference(ladder):
    """Two W = 3 windows through the block tables (the first straddles a
    page boundary): logits within 1e-4 of the reference's
    ``_verify_step_paged``, lengths and steps exact, the arenas off the
    trash page within 1e-4."""
    jv, tv = _verifiers(ladder)
    jst, tst = _paged_states(ladder, np.random.default_rng(9))
    for tok in ([[1, 2, 3], [4, 5, 6], [7, 8, 9]],
                [[3, 1, 2], [6, 4, 5], [9, 7, 8]]):
        jlog, jst = jax_model.verify_step(jv._serve_params, ladder["jb"],
                                          jnp.asarray(tok, jnp.int32), jst)
        with torch.no_grad():
            tlog, tst = model.verify_step(tv._serve_params, ladder["tb"],
                                          torch.tensor(tok), tst)
        np.testing.assert_allclose(tlog.numpy()[[0, 2]],
                                   np.asarray(jlog)[[0, 2]], **TOL)
        assert tst.step.tolist() == np.asarray(jst.step).tolist()
        assert tst.layer_states.length.tolist() == \
            np.asarray(jst.layer_states.length).tolist()
    for name in ("self_k", "self_v"):
        np.testing.assert_allclose(
            getattr(tst.layer_states, name)[:, 1:].numpy(),
            np.asarray(getattr(jst.layer_states, name))[:, 1:], **TOL)


def test_set_slot_lengths_in_place_matches_reference(ladder, mel):
    """Contiguous slot layout and paged: the counters take the new
    lengths in place (the same storage), as the reference's; KV, tables
    and arenas are not touched."""
    jv, tv = _verifiers(ladder)
    jst, tst = _prefilled(jv, tv, mel)
    jst, tst = jax_model.slot_layout(jst, 2), model.slot_layout(tst, 2)
    for jstate, tstate in ((jst, tst),
                           _paged_states(ladder, np.random.default_rng(3))):
        new = np.asarray([4, 1, 7][:tstate.step.shape[0]], np.int32)
        want = jax_model.set_slot_lengths(jstate, jnp.asarray(new))
        tensors = model.state_tensors(tstate)
        ptrs = [t.data_ptr() for t in tensors]
        before = [t.clone() for t in tensors]
        counters = {id(tstate.step)} | (
            {id(tstate.layer_states.length)}
            if isinstance(tstate.layer_states, WhisperPagedDecodeState)
            else {id(kv.length) for kv in tstate.layer_states.self_kv})
        model.set_slot_lengths(tstate, torch.from_numpy(new))
        assert [t.data_ptr() for t in model.state_tensors(tstate)] == ptrs
        for t, b in zip(tensors, before):
            if id(t) not in counters:
                assert torch.equal(t, b)
        assert tstate.step.tolist() == np.asarray(want.step).tolist()
        got_len = (tstate.layer_states.length.tolist()
                   if isinstance(tstate.layer_states,
                                 WhisperPagedDecodeState)
                   else [kv.length.tolist()
                         for kv in tstate.layer_states.self_kv])
        want_len = (want.layer_states.length
                    if isinstance(tstate.layer_states,
                                  WhisperPagedDecodeState)
                    else want.layer_states.self_kv.length)
        assert got_len == np.asarray(want_len).tolist()


# ---------------------------------------------------------------------------
# speculative transcribe: tokens
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dense_pair(ladder, mel):
    """The dense verifiers (no offload engine) and their greedy tokens at
    max_new 12."""
    jv, tv = _verifiers(ladder)
    ref = _tokens(jv.transcribe(mel, sot_id=1, max_new=12))
    assert _tokens(tv.transcribe(mel, sot_id=1, max_new=12)) == ref
    return jv, tv, ref


@pytest.mark.parametrize("k", [1, 4, 8])
def test_spec_tokens_dense(ladder, mel, dense_pair, k):
    """Random init: the draft disagrees nearly always, which drives the
    correction and the rollback. Tokens equal the verifier's greedy ones
    and the reference's speculative ones; the round counters too."""
    jv, tv, ref = dense_pair
    jspec, tspec = _specs(ladder, jv, tv, k)
    want = _tokens(jspec.transcribe(mel, sot_id=1, max_new=10))
    got = _tokens(tspec.transcribe(mel, sot_id=1, max_new=10))
    assert got == want == [r[:10] for r in ref]
    assert (tspec.rounds, tspec.drafted, tspec.accepted) == \
        (jspec.rounds, jspec.drafted, jspec.accepted)
    st_ = tspec.stats()
    assert st_["verify_captures"] == st_["draft_step_captures"] == 0
    assert 0 < st_["drafted"] <= tspec.rounds * k * mel.shape[0]
    assert st_["acceptance_rate"] == tspec.acceptance_rate()


@pytest.mark.parametrize("burst", [None, 256])
def test_spec_tokens_q8(ladder, mel, burst):
    jv, tv = _verifiers(ladder, "q8_0", burst)
    ref = _tokens(jv.transcribe(mel, sot_id=1, max_new=8))
    assert _tokens(tv.transcribe(mel, sot_id=1, max_new=8)) == ref
    jspec, tspec = _specs(ladder, jv, tv, 4)
    want = _tokens(jspec.transcribe(mel, sot_id=1, max_new=8))
    assert _tokens(tspec.transcribe(mel, sot_id=1, max_new=8)) == want == ref


def test_spec_self_draft_full_accept(ladder, mel, dense_pair):
    """Draft == verifier: every window accepted whole, k + 1 tokens a
    round (the bonus-token path), acceptance 1.0."""
    _, tv, ref = dense_pair
    spec = tv.speculative(ladder["tb"], ladder["tbp"], k=3)
    assert _tokens(spec.transcribe(mel, sot_id=1, max_new=12)) == ref
    assert spec.acceptance_rate() == 1.0
    assert spec.rounds == 3                     # ceil(12 / (k + 1))


def test_spec_eos_truncation(ladder):
    """A row whose verifier hits EOS mid-window is cut at the EOS
    (inclusive) and freezes; the other row decodes on."""
    mel2 = np.random.default_rng(7).standard_normal(
        (2, N_FRAMES, ladder["tt"].n_mels)).astype(np.float32)
    _, tv = _verifiers(ladder, max_len=32)
    eos = _tokens(tv.transcribe(mel2, sot_id=1, max_new=10))[0][3]
    jv, tv = _verifiers(ladder, max_len=32, eos_id=eos)
    want = _tokens(jv.transcribe(mel2, sot_id=1, max_new=10))
    assert _tokens(tv.transcribe(mel2, sot_id=1, max_new=10)) == want
    jspec, tspec = _specs(ladder, jv, tv, 4)
    assert _tokens(tspec.transcribe(mel2, sot_id=1, max_new=10)) == want \
        == _tokens(jspec.transcribe(mel2, sot_id=1, max_new=10))
    assert any(len(r) < 10 for r in want)      # the EOS fired


@pytest.mark.parametrize("case,exc,match", [
    ("k", ValueError, "k must be >= 1"),
    ("max_len", ValueError, "max_len too small"),
    ("vocab", ValueError, "vocabulary"),
    ("family", NotImplementedError, "audio family"),
])
def test_spec_guards_in_order(ladder, case, exc, match):
    """Each guard fires with the reference's exception and message, the
    cheapest first: with k = 0 and max_len = 3 the k guard wins."""
    k, max_len, dcfg = 4, 64, ladder["tt"]
    if case == "k":
        k, max_len = 0, 3
    elif case == "max_len":
        max_len = 5                                 # k + 2 = 6 > 5
    elif case == "vocab":
        dcfg = dataclasses.replace(dcfg, vocab_size=dcfg.vocab_size + 16)
    v = ServeEngine(ladder["tb"], ladder["tbp"], max_len=max_len,
                    eos_id=-1, device="cpu")
    d = ServeEngine(dcfg, ladder["ttp"], max_len=max_len, eos_id=-1,
                    device="cpu")
    if case == "family":
        # the port's configs refuse another family when they are made, so
        # the engine's config is swapped for one that has another
        with pytest.raises(ValueError, match="audio"):
            dataclasses.replace(dcfg, family="dense")
        d.cfg = copy.copy(dcfg)
        object.__setattr__(d.cfg, "family", "dense")
    with pytest.raises(exc, match=match):
        SpeculativeEngine(verifier=v, draft=d, k=k)
    jcfg = ladder["jt"]
    if case in ("vocab", "family"):
        jcfg = dataclasses.replace(
            jcfg, **({"vocab_size": jcfg.vocab_size + 16} if case == "vocab"
                     else {"family": "dense"}))
    jv = JaxServeEngine(ladder["jb"], ladder["jbp"], max_len=max_len,
                        eos_id=-1)
    jd = JaxServeEngine(jcfg, ladder["jtp"], max_len=max_len, eos_id=-1)
    with pytest.raises(exc, match=match):
        jax_spec.SpeculativeEngine(verifier=jv, draft=jd, k=k)


def test_spec_max_len_and_vocab_guards(ladder, mel):
    v = ServeEngine(ladder["tb"], ladder["tbp"], max_len=16, eos_id=-1,
                    device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        v.speculative(ladder["tt"], ladder["ttp"], k=4).transcribe(
            mel, max_new=16)
    bad = dataclasses.replace(ladder["tt"],
                              vocab_size=ladder["tt"].vocab_size + 16)
    with pytest.raises(ValueError, match="vocab"):
        v.speculative(bad, ladder["ttp"], k=4)


# ---------------------------------------------------------------------------
# plans and the ledger
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(role="verify", k=4), dict(role="draft"), dict(k=6),
    dict(pages=(4, 9, 16, 3), role="verify", k=3), dict()])
def test_plan_key_with_role_and_k_matches_reference(kw):
    assert plan_key("verify", "q8_0", 2, 16, **kw) == \
        jax_plan_key("verify", "q8_0", 2, 16, **kw)


def _cross_flops(eng, b):
    """The FLOPs of one prefill's ``dec.cross.k``/``.v`` calls that the
    reference's plan leaves out (its ``vmap`` over layers records them
    once; the port records every layer's)."""
    plan = eng._plans.plans[eng._key("prefill", b, N_FRAMES)]
    cross = [e for e in plan if e.name.startswith("dec.cross")]
    return sum(e.flops for e in cross) * (eng.cfg.num_layers - 1) \
        // eng.cfg.num_layers


@pytest.mark.parametrize("burst", ["default", 256])
def test_spec_plans_and_ledger_match_reference(ladder, mel, burst):
    """After two speculative requests (Q8_0 verifier through the offload
    engine): role-tagged keys equal the reference's in both engines' plan
    caches; the verify plan's entries equal the reference's (backends
    mapped), the draft's on every field but ``backend``; the ledger's
    commits equal the reference's, ``by_role`` too up to the reference's
    cross-K/V quirk in each prefill, and sums to the FLOP totals;
    ``energy_report`` carries it."""
    jv, tv = _verifiers(ladder, "q8_0", burst)
    jspec, tspec = _specs(ladder, jv, tv, 4)
    for _ in range(2):
        jres = jspec.transcribe(mel, sot_id=1, max_new=8)
        tres = tspec.transcribe(mel, sot_id=1, max_new=8)
        assert _tokens(tres) == _tokens(jres)
    assert tspec.draft.offload.ledger is tv.offload.ledger
    assert tspec.rounds == jspec.rounds
    for te, je in ((tv, jv), (tspec.draft, jspec.draft)):
        assert set(te._plans.plans) == set(je._plans.plans)
        assert (te._plans.hits, te._plans.misses) == \
            (je._plans.hits, je._plans.misses)
    vkey = ("verify", "q8_0", 2, N_FRAMES, ("role", "verify"), ("k", 4))
    dkey = ("step", "none", 2, N_FRAMES, ("role", "draft"))
    for te, je, key, mapped in ((tv, jv, vkey, True),
                                (tspec.draft, jspec.draft, dkey, False)):
        tplan, jplan = te._plans.plans[key], je._plans.plans[key]
        assert len(tplan) == len(jplan)
        for a, b in zip(tplan.entries, jplan.entries):
            for f in ENTRY_FIELDS:
                assert getattr(a, f) == getattr(b, f), (key, a.name, f)
            if mapped:
                assert a.backend == BACKEND_NAMES[b.backend]
    assert all(e.m == 2 * 5 for e in tv._plans.plans[vkey])
    ts, js = tv.offload.stats, jv.offload.stats
    # two requests: two prefills each, then a draft and a verify commit
    # a round
    assert tv.offload.ledger.commits == jv.offload.ledger.commits == \
        4 + 2 * tspec.rounds
    for role, eng in (("verify", tv), ("draft", tspec.draft)):
        assert ts.by_role[role] == js.by_role[role] + 2 * _cross_flops(eng, 2)
    assert set(ts.by_role) == set(js.by_role) == {"verify", "draft"}
    assert sum(ts.by_role.values()) == \
        ts.offloaded_flops + ts.fallback_flops + ts.residual_flops
    rep = tv.energy_report(tres, 700.0)
    assert rep["dispatch"]["by_role"] == ts.by_role
    assert tspec.stats()["by_role"] == ts.by_role


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def workload(ladder):
    """Six batch-1 utterances and budgets drawn from one seeded generator:
    rows finish at different rounds, so admissions reuse freed rows."""
    rng = np.random.default_rng(42)
    mels = [rng.standard_normal((1, N_FRAMES, ladder["tt"].n_mels)
                                ).astype(np.float32) for _ in range(6)]
    return mels, rng.integers(3, 10, size=6).tolist()


@pytest.fixture(scope="module")
def greedy_ref(ladder, workload, dense_pair):
    """The verifier's greedy tokens, one request at a time."""
    _, tv, _ = dense_pair
    mels, max_news = workload
    return {i: tv.transcribe(m, sot_id=1, max_new=n)[0].tokens
            for i, (m, n) in enumerate(zip(mels, max_news))}


def _submit_all(sch, workload):
    mels, max_news = workload
    return {sch.submit(m, max_new=n): i
            for i, (m, n) in enumerate(zip(mels, max_news))}


def test_spec_scheduler_waves(ladder, mel, workload, greedy_ref, dense_pair):
    """Waves of two: per-request max_new, the short wave padded, tokens
    equal the verifier's greedy ones and the reference's waves."""
    jv, tv, _ = dense_pair
    jspec, tspec = _specs(ladder, jv, tv, K)
    got, want = {}, {}
    for sch, out in ((SpecScheduler(tspec, n_slots=2), got),
                     (jax_spec.SpecScheduler(jspec, n_slots=2), want)):
        rids = _submit_all(sch, workload)
        assert sch.n_queued == 6
        out.update({rids[r]: res.tokens for r, res in sch.run().items()})
        assert sch.n_queued == 0
    assert got == want == greedy_ref
    sch = SpecScheduler(tspec, n_slots=4)
    sch.submit(mel[0], max_new=4)
    sch.submit(np.zeros((8, ladder["tt"].n_mels), np.float32), max_new=4)
    with pytest.raises(ValueError, match="frame"):
        sch.run()


def _drive_midflight(sch, workload):
    """Three requests, one round, then the other three mid-flight and the
    drain. Returns ({request index: tokens}, rows live at the second
    submission)."""
    mels, max_news = workload
    rids = {sch.submit(mels[i], max_new=max_news[i]): i for i in range(3)}
    sch.admit()
    sch.decode_step()
    rids.update({sch.submit(mels[i], max_new=max_news[i]): i
                 for i in range(3, 6)})
    live = len(sch._active)
    out = sch.run()
    return {rids[r]: res.tokens for r, res in out.items()}, live


def _attribution_sums(att):
    s = sum(att["per_request_pdp_j"].values())
    assert abs(s - att["batch_pdp_j"]) <= 1e-9 * max(1.0, att["batch_pdp_j"])


def _geom(tight):
    pages_per = 16
    return dict(page_size=4, n_pages=1 + (6 if tight else 2 * pages_per),
                cross_page_size=N_FRAMES, n_cross_pages=3 if not tight else 4)


@pytest.mark.parametrize("mode", ["continuous", "paged", "tight"])
def test_round_schedulers_match_reference(ladder, workload, greedy_ref,
                                          dense_pair, mode):
    """Round-boundary admission on the contiguous pool, the roomy paged
    arena and a tight one (3 slots, 6 self pages: the capacity pass
    preempts, the preempted requests replay into both models): tokens
    equal the verifier's greedy ones and the reference scheduler's, as do
    rounds, preemptions and live rows at the mid-flight submission; no
    capture on the CPU; the arena drained; attribution sums to the
    batch's."""
    jv, tv, _ = dense_pair
    jspec, tspec = _specs(ladder, jv, tv, K)
    if mode == "continuous":
        scheds = (tspec.continuous(n_slots=2, n_frames=N_FRAMES),
                  jspec.continuous(n_slots=2, n_frames=N_FRAMES))
        assert isinstance(scheds[0], SpecContinuousScheduler)
    else:
        n = 3 if mode == "tight" else 2
        scheds = (tspec.paged(n_slots=n, n_frames=N_FRAMES,
                              **_geom(mode == "tight")),
                  jspec.paged(n_slots=n, n_frames=N_FRAMES,
                              **_geom(mode == "tight")))
        assert isinstance(scheds[0], PagedSpecScheduler)
    out = []
    for sch in scheds:
        if mode == "tight":
            rids = _submit_all(sch, workload)
            res = sch.run()
            out.append(({rids[r]: v.tokens for r, v in res.items()}, None))
        else:
            out.append(_drive_midflight(sch, workload))
    (got, live), (want, jlive) = out
    assert got == want == greedy_ref
    assert live == jlive and (mode == "tight" or live > 0)
    assert (tspec.rounds, tspec.drafted, tspec.accepted) == \
        (jspec.rounds, jspec.drafted, jspec.accepted)
    assert tspec.stats()["verify_captures"] == 0
    tsch, jsch = scheds
    if mode != "continuous":
        assert tsch.preemptions == jsch.preemptions
        assert (tsch.preemptions > 0) == (mode == "tight")
        alloc = tsch.pool.self_alloc
        assert alloc.n_allocated == 0 and alloc.n_free == alloc.n_allocatable
        assert tsch.pages_trimmed >= 0
    _attribution_sums(tsch.attribution(700.0))


@pytest.mark.parametrize("paged", [False, True])
def test_round_schedulers_q8_by_role(ladder, workload, paged):
    """A Q8_0 verifier through the offload engine: tokens equal its own
    batch-1 greedy ones and the reference scheduler's; the verify plan's
    key carries pages, role and k; commits and ``by_role`` equal the
    reference's up to its cross-K/V quirk a prefill; ``by_role`` sums to
    the FLOP totals."""
    mels, max_news = workload
    mels, max_news = mels[:3], max_news[:3]
    jv, tv = _verifiers(ladder, "q8_0", 256)
    ref = [tv.transcribe(m, sot_id=1, max_new=n)[0].tokens
           for m, n in zip(mels, max_news)]
    ts0, js0 = dict(tv.offload.stats.by_role), dict(jv.offload.stats.by_role)
    c0 = (tv.offload.ledger.commits, jv.offload.ledger.commits)
    jspec, tspec = _specs(ladder, jv, tv, K)
    kw = _geom(False) if paged else {}
    got = []
    for spec in (tspec, jspec):
        sch = (spec.paged(n_slots=2, n_frames=N_FRAMES, **kw) if paged
               else spec.continuous(n_slots=2, n_frames=N_FRAMES))
        rids = [sch.submit(m, max_new=n) for m, n in zip(mels, max_news)]
        res = sch.run()
        got.append([res[r].tokens for r in rids])
        if spec is tspec:
            tsch = sch
            _attribution_sums(sch.attribution(700.0))
    assert got[0] == got[1] == ref
    key = tsch._spec_rounds.v_plan.key
    assert ("role", "verify") in key and ("k", K) in key
    assert any(q[0] == "pages" for q in key if isinstance(q, tuple)) == paged
    assert key != tsch._spec_rounds.d_plan.key
    assert tv.offload.ledger.commits - c0[0] == \
        jv.offload.ledger.commits - c0[1]
    ts, js = tv.offload.stats, jv.offload.stats
    n_pre = len(mels)
    # the verifier's admissions commit at role "main" (the base
    # scheduler's), the draft's at "draft"; windows at "verify"
    for role, eng in (("main", tv), ("draft", tspec.draft), ("verify", None)):
        dt = ts.by_role.get(role, 0) - ts0.get(role, 0)
        dj = js.by_role.get(role, 0) - js0.get(role, 0)
        extra = 0
        if eng is not None:
            plan = eng._plans.plans[eng._key("prefill", 1, N_FRAMES)]
            extra = sum(e.flops for e in plan
                        if e.name.startswith("dec.cross")) * \
                (eng.cfg.num_layers - 1) // eng.cfg.num_layers
        assert dt > 0 and dt == dj + n_pre * extra, role
    assert sum(ts.by_role.values()) == \
        ts.offloaded_flops + ts.fallback_flops + ts.residual_flops


def test_spec_submit_guard(ladder, dense_pair):
    _, tv, _ = dense_pair
    sch = tv.speculative(ladder["tt"], ladder["ttp"], k=K).continuous(
        n_slots=2, n_frames=N_FRAMES)
    with pytest.raises(ValueError, match="max_len"):
        sch.submit(np.zeros((1, N_FRAMES, ladder["tt"].n_mels), np.float32),
                   max_new=64)


# ---------------------------------------------------------------------------
# should_offload, the CLI
# ---------------------------------------------------------------------------
def test_should_offload_matches_reference():
    rng = np.random.default_rng(12)
    for _ in range(200):
        m, k, n = (int(rng.integers(1, 4096)), int(rng.integers(1, 4096)),
                   int(rng.integers(1, 60000)))
        budget = int(rng.choice([4, 16, 32, 64, 512, 8192]))
        assert OffloadEngine(vmem_budget_kb=budget).should_offload(
            m, k, n) == JaxOffloadEngine(
            vmem_budget_kb=budget).should_offload(m, k, n), (m, k, n, budget)
    assert OffloadEngine().should_offload(1, 384, 51872, name="dec.vocab")


def test_cli_speculative(capsys):
    assert serve_cli.main(["--arch", "whisper-base", "--offload",
                           "--device", "cpu", "--power-w", "700",
                           "--speculative", "-k", "3", "--requests", "2",
                           "--max-new", "6"]) == 0
    out = capsys.readouterr().out
    assert "speculative: draft=whisper-tiny k=3" in out
    assert '"speculative"' in out and '"by_role"' in out
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "whisper-base", "--device", "cpu",
                        "--power-w", "700", "--speculative", "--continuous"])
