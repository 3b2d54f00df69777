"""Paged and speculative serving over a mesh with "model" > 1 on the CPU:
the port's ``PagedScheduler`` (``serve/paging.py``) and
``SpeculativeEngine``/``SpecScheduler`` (``serve/speculative.py``) over
(data, model) meshes, held to the reference's unsharded paged scheduler,
``SpecScheduler`` and speculative ``transcribe`` on the same weights
(``convert.py``) and numpy-seeded mels, and to the port's unsharded runs.

- The paged pool over (1, 2), (2, 2) of repeated ``cpu`` entries and
  (1, 2) of distinct ``cpu:i`` devices, Q8_0 and dense, on a trace with
  prefix sharing and preemptions: tokens equal the reference's; prefix
  hits, preemptions, replays, commits, the ledger's totals, requests per
  committed byte and used KV bytes equal the unsharded pool's; the self
  and cross arenas are ``ModelShards`` of Hkv / 2 heads on the model
  devices; after every admission and step the shards' tables and lengths
  are equal (and the tables the host's).
- Speculative serving over (1, 2) with the whisper-base smoke verifier
  and the whisper-tiny smoke draft, Q8_0 and dense: one-shot
  ``transcribe`` and ``SpecScheduler`` waves give the reference's tokens;
  acceptance and FLOPs by role equal the unsharded engine's; ``by_role``
  sums to the ledger's totals.
- Whole attention: both packages' smoke configs at 2 heads of 32 over
  (1, 4), where the heads do not divide the model size: the paged arenas
  whole on the first device (the FFN and vocabulary split), and a draft
  of that layout beside a verifier whose 4 heads split, one mesh: the
  reference's tokens.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.models import model as jax_model
from repro.serve import speculative as jax_spec
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.offload import OffloadEngine
from repro_torch.launch.mesh import make_serve_mesh, physical_device
from repro_torch.models import model
from repro_torch.models.attention import ModelShards
from repro_torch.models.whisper import WhisperPagedDecodeState
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.speculative import SpecScheduler
from repro_torch.sharding import rules

CPU = torch.device("cpu")
F = 8
MAX_LEN = 32
K = 3
MESHES = {"1x2": (1, 2, [CPU] * 2), "2x2": (2, 2, [CPU] * 4),
          "1x2-distinct": (1, 2, [torch.device("cpu", i) for i in range(2)])}
# (utterance, max_new): repeats for prefix hits; over 4 slots and 5 self
# pages of 4 positions the capacity pass preempts
TRACE = [(0, 6), (1, 6), (0, 3), (1, 3), (2, 3), (2, 5), (3, 4)]
GEOM = dict(n_slots=4, page_size=4, n_pages=5)
# heads that do not divide 4 model shards: attention runs whole
WHOLE = dict(num_heads=2, num_kv_heads=2, head_dim=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for these small tensors, beside JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SMOKE = {}


def _smoke(arch, seed, **replace):
    """(reference cfg, reference params, port cfg, port params) of a
    whisper smoke config, its widths replaced by ``replace``."""
    key = (arch, seed, tuple(sorted(replace.items())))
    if key not in _SMOKE:
        jcfg = dataclasses.replace(jax_smoke_config(arch), **replace)
        jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg, 64)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        _SMOKE[key] = (jcfg, jp, dataclasses.replace(
            get_smoke_config(arch), **replace), tp)
    return _SMOKE[key]


def _mesh(name):
    data, m, devs = MESHES[name]
    return make_serve_mesh(data, m, devices=devs)


def _mels(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, F, cfg.n_mels)).astype(np.float32)
            for _ in range(n)]


def _engine(smoke, quant, mesh=None, burst=32):
    _, _, tcfg, tp = smoke
    return ServeEngine(tcfg, tp, max_len=MAX_LEN, quant=quant, eos_id=-1,
                       offload=OffloadEngine(burst=burst), device="cpu",
                       mesh=mesh)


def _shards_agree(pool):
    """Every model shard's tables and lengths equal the first's; after a
    sync, the tables are the host's."""
    states = pool.model_states
    for s in states[1:]:
        for a, b in ((s.block_table, states[0].block_table),
                     (s.cross_table, states[0].cross_table),
                     (s.length, states[0].length)):
            assert torch.equal(a.cpu(), b.cpu())
    if not pool._dirty:
        assert np.array_equal(states[0].block_table.cpu().numpy(), pool._bt)
        assert np.array_equal(states[0].cross_table.cpu().numpy(), pool._ct)


def _drive(sched, mels, check=None):
    """TRACE through ``sched`` by hand, ``check(pool)`` after every
    admission and step; the tokens by submission."""
    rids = [sched.submit(mels[i], max_new=n) for i, n in TRACE]
    while sched.n_queued or sched.n_active:
        sched.admit()
        if check is not None:
            check(sched.pool)
        sched.decode_step()
        if check is not None:
            check(sched.pool)
    return [sched.finished[r].tokens for r in rids]


def _totals(eng):
    s = eng.offload.stats
    return (eng.offload.ledger.commits, s.offloaded_calls, s.fallback_calls,
            s.offloaded_flops, s.fallback_flops, s.residual_flops,
            dict(s.by_kernel))


def _counters(sched):
    return dict(hits=sched.shared_hits, preemptions=sched.preemptions,
                replays=sched.replays, prefills=sched.prefills,
                active_peak=sched.active_peak, used=sched.kv_used_peak,
                committed=sched.kv_committed_bytes)


_REF = {}


def _ref_paged(smoke, quant):
    """The reference's unsharded paged scheduler's tokens, hits and
    preemptions on TRACE."""
    key = (id(smoke[1]), quant)
    if key not in _REF:
        jcfg, jp, tcfg, _ = smoke
        jeng = JaxServeEngine(jcfg, jp, max_len=MAX_LEN, quant=quant,
                              eos_id=-1, offload=JaxOffloadEngine(
                                  prefer_pallas=False, burst=32))
        sched = jeng.paged_scheduler(n_frames=F, **GEOM)
        tokens = _drive(sched, _mels(tcfg))
        _REF[key] = (tokens, sched.shared_hits, sched.preemptions)
    return _REF[key]


_ONE = {}


def _unsharded(smoke, quant):
    """The port's unsharded paged drive: (tokens, counters, totals)."""
    key = (id(smoke[1]), quant)
    if key not in _ONE:
        eng = _engine(smoke, quant)
        sched = eng.paged_scheduler(n_frames=F, **GEOM)
        tokens = _drive(sched, _mels(eng.cfg))
        _ONE[key] = (tokens, _counters(sched), _totals(eng))
    return _ONE[key]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_paged_scheduler_over_model_matches_reference(quant, mesh_name):
    smoke = _smoke("whisper-tiny", 0)
    tcfg = smoke[2]
    want, hits, preemptions = _ref_paged(smoke, quant)
    one_tokens, one_counts, one_totals = _unsharded(smoke, quant)
    mesh = _mesh(mesh_name)
    eng = _engine(smoke, quant, mesh)
    sched = eng.paged_scheduler(n_frames=F, **GEOM)
    pool = sched.pool
    got = _drive(sched, _mels(tcfg), _shards_agree)
    assert got == want == one_tokens
    counts = _counters(sched)
    assert counts == one_counts
    assert (counts["hits"], counts["preemptions"]) == (hits, preemptions)
    assert hits > 0 and preemptions > 0 and sched.replays > 0
    assert _totals(eng) == one_totals
    assert pool.n_shards == (2 if MESHES[mesh_name][0] == 2 else 1)
    # the arenas: one set a model shard, Hkv / 2 heads, its own storage
    ls = pool.state.layer_states
    assert isinstance(ls, ModelShards) and len(ls) == 2
    assert eng._kv_devices[eng._phys] == tuple(
        physical_device(d) for d in mesh.shard_devices()[0])
    ptrs = set()
    for s in ls:
        assert isinstance(s, WhisperPagedDecodeState)
        for arena in (s.self_k, s.self_v, s.cross_k, s.cross_v):
            assert arena.shape[3] == tcfg.num_kv_heads // 2
            ptrs.add(arena.untyped_storage().data_ptr())
    assert len(ptrs) == 8
    # a page's bytes are the whole model's, over both shards' arenas
    whole = model.zeros_paged_state(
        tcfg, GEOM["n_slots"], max_pages=pool.max_pages, n_pages=5,
        page_size=4, n_cross_per_req=1, n_cross_pages=pool.n_cross_pages,
        cross_page_size=F, device="cpu").layer_states
    assert pool.page_bytes == 2 * whole.self_k[:, 0].numel() * \
        whole.self_k.element_size()
    s = eng.offload.stats
    assert sum(s.by_device.values()) == \
        s.offloaded_flops + s.fallback_flops + s.residual_flops


def test_paged_specs_lay_out_every_model_shard():
    """``paged_state_specs`` gives each model shard's paged state the
    reference's specs (pages over "data" only), so that ``spec_bytes``
    counts every shard's arenas: the arenas' bytes equal the unsharded
    pool's."""
    smoke = _smoke("whisper-tiny", 0)
    mesh = _mesh("2x2")
    eng = _engine(smoke, "q8_0", mesh)
    pool = eng.paged_scheduler(n_frames=F, n_slots=4, page_size=4,
                               n_pages=10).pool
    one = _engine(smoke, "q8_0").paged_scheduler(
        n_frames=F, n_slots=4, page_size=4, n_pages=10).pool
    specs = rules.paged_state_specs(pool.state, mesh)
    for sp in specs.layer_states:
        assert tuple(sp.self_k) == (None, "data")
        assert tuple(sp.block_table) == ("data",)

    def arena_bytes(state, specs):
        ls, sls = state.layer_states, specs.layer_states
        parts = zip(ls, sls) if isinstance(ls, ModelShards) else [(ls, sls)]
        return sum(rules.spec_bytes(
            (s.self_k, s.self_v, s.cross_k, s.cross_v),
            (sp.self_k, sp.self_v, sp.cross_k, sp.cross_v), mesh)
            for s, sp in parts)
    assert arena_bytes(pool.state, specs) == arena_bytes(
        one.state, rules.paged_state_specs(one.state, mesh))
    assert pool.committed_kv_bytes() == one.committed_kv_bytes()


_SPEC_REF = {}


def _spec_mels(cfg, n=4):
    return np.random.default_rng(2).standard_normal(
        (n, F, cfg.n_mels)).astype(np.float32)


def _ref_spec(verifier, draft, quant):
    """The reference's speculative ``transcribe`` of the 2-row batch and
    its ``SpecScheduler`` waves of 2 over four requests."""
    key = (id(verifier[1]), id(draft[1]), quant)
    if key not in _SPEC_REF:
        jv = JaxServeEngine(verifier[0], verifier[1], max_len=MAX_LEN,
                            quant=quant, eos_id=-1, offload=JaxOffloadEngine(
                                prefer_pallas=False, burst=32))
        jspec = jv.speculative(draft[0], draft[1], k=K)
        mels = _spec_mels(verifier[2])
        one = [r.tokens for r in jspec.transcribe(mels[:2], max_new=6)]
        waves = jax_spec.SpecScheduler(jspec, n_slots=2)
        _SPEC_REF[key] = (one, _waves(waves, mels))
    return _SPEC_REF[key]


def _waves(sched, mels):
    rids = [sched.submit(mels[i:i + 1], max_new=n)
            for i, n in enumerate((6, 3, 5, 4))]
    got = sched.run()
    return [got[r].tokens for r in rids]


def _spec_run(verifier, draft, quant, mesh):
    """The port's speculative ``transcribe`` and waves: (one-shot tokens,
    wave tokens, the speculative engine, the verifier)."""
    v = _engine(verifier, quant, mesh)
    spec = v.speculative(draft[2], draft[3], k=K)
    mels = _spec_mels(verifier[2])
    one = [r.tokens for r in spec.transcribe(mels[:2], max_new=6)]
    return one, _waves(SpecScheduler(spec, n_slots=2), mels), spec, v


@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_speculative_over_model_matches_reference(quant):
    verifier = _smoke("whisper-base", 1)
    draft = _smoke("whisper-tiny", 0)
    want_one, want_waves = _ref_spec(verifier, draft, quant)
    one, waves, spec1, v1 = _spec_run(verifier, draft, quant, None)
    got, got_waves, spec, v = _spec_run(verifier, draft, quant,
                                        _mesh("1x2"))
    assert got == want_one == one
    assert got_waves == want_waves == waves
    assert (spec.rounds, spec.drafted, spec.accepted) == \
        (spec1.rounds, spec1.drafted, spec1.accepted)
    # both models split their attention; each caches its own heads
    for eng in (v, spec.draft):
        assert eng._kv_devices[eng._phys] is not None
    parts = spec._statics[(2, F)]
    kv = parts[0].rounds.v_state.layer_states.self_kv[0]
    assert isinstance(kv, ModelShards) and len(kv) == 2
    s, s1 = v.offload.stats, v1.offload.stats
    assert dict(s.by_role) == dict(s1.by_role)
    assert sum(s.by_role.values()) == \
        s.offloaded_flops + s.fallback_flops + s.residual_flops
    assert sum(s.by_device.values()) == sum(s.by_role.values())
    assert v.offload.ledger.commits == v1.offload.ledger.commits
    assert not set(v._plans.plans) & set(v1._plans.plans)
    # the verifier's own greedy transcribe over the same mesh
    mels = _spec_mels(verifier[2])
    assert [r.tokens for r in v.transcribe(mels[:2], max_new=6)] == got


def test_whole_attention_over_model_keeps_whole_arenas():
    """2 heads on 4 model shards: the attention runs whole, the paged
    arenas are one state on the data shard's first device, the FFN and
    the vocabulary split; the reference's paged tokens."""
    smoke = _smoke("whisper-tiny", 0, **WHOLE)
    want = _ref_paged(smoke, "q8_0")[0]
    mesh = make_serve_mesh(1, 4, devices=[torch.device("cpu", i)
                                          for i in range(4)])
    eng = _engine(smoke, "q8_0", mesh)
    assert eng._kv_devices[eng._phys] is None
    tree = eng._params_on(eng.device)
    assert set(tree["dec_blocks"][0][rules.TP_KEY].parts) == {"ffn"}
    sched = eng.paged_scheduler(n_frames=F, **GEOM)
    ls = sched.pool.state.layer_states
    assert isinstance(ls, WhisperPagedDecodeState)
    assert ls.self_k.shape[3] == 2
    assert _drive(sched, _mels(smoke[2])) == want


def test_draft_and_verifier_hold_two_layouts_on_one_mesh():
    """Over (1, 4): the verifier's 4 heads split, its draft's 2 run whole
    (whisper-tiny's 6 beside whisper-base's 8 on the card's (1, 4)); the
    speculative tokens are the reference's. Dense: a Q8_0 smoke ``o`` of
    K = 64 has two blocks of 32, which do not split four ways."""
    verifier = _smoke("whisper-base", 1)
    draft = _smoke("whisper-tiny", 0, **WHOLE)
    want_one, want_waves = _ref_spec(verifier, draft, "none")
    mesh = make_serve_mesh(1, 4, devices=[CPU] * 4)
    got, waves, spec, v = _spec_run(verifier, draft, "none", mesh)
    assert v._kv_devices[v._phys] is not None
    assert spec.draft._kv_devices[spec.draft._phys] is None
    assert got == want_one and waves == want_waves
