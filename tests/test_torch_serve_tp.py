"""Serving over a mesh with "model" > 1 on the CPU: tensor parallelism of
the port's ``ServeEngine`` (``sharding.rules.place``/``serve_tree``,
``models.transformer.tensor_parallel``), held to the reference's
unsharded engine and scheduler and to the port's unsharded engine.

- whisper-tiny's smoke config, Q8_0 and dense: ``transcribe`` and the
  4-slot scheduler over (1, 2) and (2, 2) meshes of repeated ``cpu``
  entries and over four distinct ``cpu:i`` devices: tokens equal the
  reference scheduler's and the unsharded run's; each decode step's
  logits within 1e-5 of the largest (f32); the attentions, FFNs and the
  vocabulary split, each model shard's KV cache its own heads.
- One case per LM family over (1, 2): ``generate``'s tokens equal the
  reference's.
- ``place``: on distinct devices each holds 1/M of the split leaves; on a
  repeated device one copy, the parts views of it.
- Plans and the ledger: the entries' M, N, K and FLOPs, the commits and
  the ledger's totals equal the unsharded run's; ``by_device`` sums to
  the totals, a split linear's FLOPs over its model shards' devices.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.models import model as jax_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import tree
from repro_torch.core.offload import OffloadEngine
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import layers, model
from repro_torch.models.attention import ModelShards
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import rules

CPU = torch.device("cpu")
F = 16
MESHES = {"1x2": (1, 2, [CPU] * 2), "2x2": (2, 2, [CPU] * 4),
          "2x2-distinct": (2, 2, [torch.device("cpu", i)
                                  for i in range(4)])}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for these small tensors, beside JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SMOKE = {}


def _smoke(arch):
    """(reference cfg, reference params, port cfg, port params)."""
    if arch not in _SMOKE:
        jcfg = jax_smoke_config(arch)
        jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg,
                                   64 if jcfg.family == "audio" else 0)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        _SMOKE[arch] = (jcfg, jp, get_smoke_config(arch), tp)
    return _SMOKE[arch]


def _mesh(name):
    data, m, devs = MESHES[name]
    return make_serve_mesh(data, m, devices=devs)


def _engine(mesh, quant, arch="whisper-tiny", max_len=24, eos_id=-1):
    _, _, tcfg, tp = _smoke(arch)
    return ServeEngine(tcfg, tp, max_len=max_len, quant=quant, eos_id=eos_id,
                       offload=OffloadEngine(burst=32), device="cpu",
                       mesh=mesh)


def _trace(cfg):
    """4 mels of F frames and max_new in 3-6, from default_rng(0)."""
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((1, F, cfg.n_mels)).astype(np.float32)
            for _ in range(4)]
    return mels, [int(rng.integers(3, 7)) for _ in range(4)]


def _drain(sched, payloads, budgets):
    rids = [sched.submit(p, max_new=n) for p, n in zip(payloads, budgets)]
    got = sched.run()
    return [got[r].tokens for r in rids]


_REF = {}


def _ref_tokens(quant):
    """The reference's unsharded scheduler's tokens on ``_trace``."""
    if quant not in _REF:
        jcfg, jp, _, _ = _smoke("whisper-tiny")
        mels, budgets = _trace(jcfg)
        jeng = JaxServeEngine(jcfg, jp, max_len=24, quant=quant, eos_id=-1,
                              offload=JaxOffloadEngine(interpret=True,
                                                       prefer_pallas=False))
        _REF[quant] = _drain(JaxScheduler(jeng, n_slots=4, n_frames=F),
                             mels, budgets)
    return _REF[quant]


def _totals(eng):
    s = eng.offload.stats
    return (s.offloaded_calls, s.fallback_calls, s.offloaded_flops,
            s.fallback_flops, s.residual_flops, dict(s.by_kernel))


def _shapes(plan):
    return [(e.name, e.m, e.k, e.n, e.flops, e.offload) for e in plan]


def _step_logits(eng, mel, steps=3):
    """The decode steps' logits of one utterance, each step fed the last
    argmax: the engine's one-shot prefill program, then ``serve_step``
    over its serving weights (the split ones on a mesh)."""
    st = eng._static_for(1, F)
    out = []
    with torch.no_grad():
        st.mel.copy_(torch.as_tensor(mel))
        eng._prefill_fn(st)
        tok = torch.ones((1, 1), dtype=torch.long)
        for _ in range(steps):
            logits, _ = model.serve_step(eng._params_on(st.device), eng.cfg,
                                         tok, st.state, engine=eng.offload)
            out.append(logits[:, -1])
            tok = eng._argmax(logits[:, -1])[:, None]
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_whisper_over_model_matches_reference(quant, mesh_name):
    tcfg = _smoke("whisper-tiny")[2]
    mels, budgets = _trace(tcfg)
    want = _ref_tokens(quant)
    one = _engine(None, quant)
    eng = _engine(_mesh(mesh_name), quant)
    tree0 = eng._params_on(eng.device)
    assert set(tree0["dec_blocks"][0][rules.TP_KEY].parts) == {
        "self_attn", "cross_attn", "ffn"}
    assert isinstance(tree0["embed"]["table"], layers.VocabShards)
    # transcribe: the reference scheduler's tokens are greedy decode per
    # request, which a one-shot batch gives row by row
    batch = np.concatenate(mels)
    for e in (one, eng):
        got = [r.tokens for r in e.transcribe(batch, max_new=max(budgets))]
        assert [g[:n] for g, n in zip(got, budgets)] == want
    sched = eng.scheduler(4, F)
    assert _drain(sched, mels, budgets) == want
    assert _drain(one.scheduler(4, F), mels, budgets) == want
    kv = sched.pool.state.layer_states.self_kv[0]
    assert isinstance(kv, ModelShards) and len(kv) == 2
    assert kv[0].k.shape[2] == tcfg.num_kv_heads // 2
    # the plans and the ledger: the unsharded run's, entry by entry
    assert eng.offload.ledger.commits == one.offload.ledger.commits
    assert _totals(eng) == _totals(one)
    for key, plan in one._plans.plans.items():
        mine = eng._plans.plans[eng._key(key[0], *key[2:])]
        assert _shapes(mine) == _shapes(plan)
    s = eng.offload.stats
    assert sum(s.by_device.values()) == \
        s.offloaded_flops + s.fallback_flops + s.residual_flops
    assert set(s.by_device) == {f"dev{i}" for i in range(
        MESHES[mesh_name][0] * 2)}
    # each decode step's logits (f32) within 1e-5 of the largest
    for a, b in zip(_step_logits(one, mels[0]), _step_logits(eng, mels[0])):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


LM_FAMILIES = [("phi3-mini-3.8b", "q8_0"), ("olmoe-1b-7b", "none"),
               ("mamba2-780m", "q8_0"), ("jamba-v0.1-52b", "none"),
               ("llava-next-mistral-7b", "q8_0")]


@pytest.mark.parametrize("arch,quant", LM_FAMILIES,
                         ids=[a for a, _ in LM_FAMILIES])
def test_every_lm_family_over_model_matches_reference(arch, quant):
    """``generate`` over (1, 2) against the reference's unsharded
    ``generate``: phi3's attention and FFN split, olmoe's attention and
    experts, mamba2's SSD mixer whole (and its vocabulary split), jamba's
    and llava's FFNs split (one KV head: their attention runs whole)."""
    jcfg, jp, _, _ = _smoke(arch)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (2, 3)).astype(np.int32)
    jeng = JaxServeEngine(jcfg, jp, max_len=16, quant=quant, eos_id=None,
                          offload=JaxOffloadEngine(prefer_pallas=False))
    want = [r.tokens for r in jeng.generate(prompts, max_new=4)]
    eng = _engine(_mesh("1x2"), quant, arch=arch, max_len=16, eos_id=None)
    assert [r.tokens for r in eng.generate(prompts, max_new=4)] == want


def _storages(t) -> set:
    return {x.untyped_storage().data_ptr() for x in t}


def test_place_splits_on_distinct_devices_and_views_on_one():
    _, _, tcfg, tp = _smoke("whisper-tiny")
    for devs in ([torch.device("cpu", i) for i in range(2)], [CPU] * 2):
        mesh = make_serve_mesh(1, 2, devices=devs)
        specs = rules.serve_param_specs(tp, mesh)
        placed = rules.place(tp, mesh, specs)
        assert set(placed) == set(mesh.physical_devices)
        split = whole = 0
        for x, spec in zip(tree.leaves(tp),
                           tree.leaves(specs, is_leaf=rules.is_spec)):
            n = x.numel() * x.element_size()
            split += n if spec else 0
            whole += 0 if spec else n
        for d, held in placed.items():
            got = tree.leaves(held, is_leaf=lambda x: isinstance(
                x, rules.Slices))
            if len(devs) == len(set(devs)):
                own = sum(t.numel() * t.element_size() for x in got
                          if isinstance(x, rules.Slices)
                          for t in x if t is not None)
                assert own == split // 2
            else:
                for x, leaf in zip(got, tree.leaves(tp)):
                    if isinstance(x, rules.Slices):
                        # one copy, the engine's tensor, its parts views
                        assert x.whole is leaf
                        assert _storages(x) == _storages([leaf])
            rest = sum(x.numel() * x.element_size() for x in got
                       if not isinstance(x, rules.Slices))
            assert rest == whole
