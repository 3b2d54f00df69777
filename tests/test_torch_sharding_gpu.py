"""Sharded serving on a CUDA device: slot-DP over a mesh of logical
devices that are all the one card (``make_serve_mesh(data=n,
devices=[cuda:0] * n)``). The whisper-tiny smoke config's tokens over a
4-way mesh equal the unsharded scheduler's, Q8_0 and dense + flash; the
step key is built once and captured once a shard, then only replayed; a
shard's row is bit for bit a batch-1 step's; the paged pool at data 4
gives the unsharded paged pool's tokens; over (data, model) meshes of
the card, tensor parallelism gives the unsharded tokens, the slot pool's
and the paged pool's, whose split rows keep their bits at any
occupancy; a MoE step
whose capacity claim spans the data shards runs as one program over the
pool, to the unsharded tokens; a shard capture that fails raises, and
nothing falls back.

Every test here is marked ``gpu`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_sharding_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.offload import OffloadEngine
from repro_torch.kernels import bf16_matmul, q8_matmul, q8_matvec
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine

COUNTED = (q8_matmul.q8_matmul, q8_matvec.q8_matvec, bf16_matmul.bf16_matmul)
F = 16


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _mesh(n):
    return make_serve_mesh(data=n, devices=[torch.device("cuda:0")] * n)


def _engine(dev, path="q8_0", mesh=None, max_len=24):
    cfg = get_smoke_config("whisper-tiny")
    if path == "dense+flash":
        cfg = dataclasses.replace(cfg, quant="none", attn_impl="flash")
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    return ServeEngine(cfg, params, max_len=max_len,
                       quant="q8_0" if path == "q8_0" else "none",
                       offload=OffloadEngine(), eos_id=-1, device=dev,
                       mesh=mesh)


def _trace(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    mels = [rng.standard_normal((1, F, cfg.n_mels)).astype(np.float32)
            for _ in range(n)]
    return mels, [int(rng.integers(3, 10)) for _ in range(n)]


def _drain(sched, mels, budgets):
    rids = [sched.submit(m, max_new=n) for m, n in zip(mels, budgets)]
    got = sched.run()
    return [got[r].tokens for r in rids]


def _launches():
    return [fn.launches for fn in COUNTED]


@pytest.mark.gpu
@pytest.mark.parametrize("data", [4, 2])
@pytest.mark.parametrize("path", ["q8_0", "dense+flash"])
def test_sharded_tokens_equal_the_unsharded_schedulers(path, data):
    dev = _cuda_or_skip()
    one = _engine(dev, path)
    mels, budgets = _trace(one.cfg)
    want = _drain(one.scheduler(4, F), mels, budgets)
    eng = _engine(dev, path, _mesh(data))
    sched = eng.scheduler(4, F)
    assert _drain(sched, mels, budgets) == want
    assert sched.pool.n_shards == data and len(sched._programs) == data
    by_dev = eng.offload.stats.by_device
    assert sorted(by_dev) == [f"dev{i}" for i in range(data)]
    s = eng.offload.stats
    assert sum(by_dev.values()) == \
        s.offloaded_flops + s.fallback_flops + s.residual_flops
    assert not set(one._plans.plans) & set(eng._plans.plans)


@pytest.mark.gpu
def test_n_shards_captures_then_none():
    dev = _cuda_or_skip()
    eng = _engine(dev, mesh=_mesh(4))
    mels, budgets = _trace(eng.cfg)
    sched = eng.scheduler(4, F)
    _drain(sched, mels, budgets)
    assert eng._step_captures == 4 and eng._step_builds == 1
    launches = _launches()
    again = _drain(sched, mels, budgets)
    assert eng._step_captures == 4 and _launches() == launches
    assert again == _drain(_engine(dev).scheduler(4, F), mels, budgets)


@pytest.mark.gpu
@pytest.mark.parametrize("data", [4, 2])
def test_a_shards_row_is_the_batch1_steps_bit_for_bit(data):
    """A request's self K/V at its slot after two steps of the sharded
    pool equal a batch-1 ``transcribe``'s static buffers, bit for bit."""
    dev = _cuda_or_skip()
    eng = _engine(dev, mesh=_mesh(data))
    mels, _ = _trace(eng.cfg)
    sched = eng.scheduler(4, F)
    _drain(sched, mels[:3], [2, 2, 2])          # the pool's other rows live
    rid = sched.submit(mels[3], max_new=2)
    sched.admit()
    slot = next(s for s, a in sched._active.items() if a.rid == rid)
    toks = sched.run()[rid].tokens
    dev_, row = sched.pool.locate(slot)
    kv = sched.pool.states[dev_].layer_states.self_kv[-1]
    assert eng.transcribe(mels[3], max_new=2)[0].tokens == toks
    st = eng._static[(1, F)].state.layer_states.self_kv[-1]
    torch.cuda.synchronize()
    assert torch.equal(kv.k[row, :2], st.k[0, :2])
    assert torch.equal(kv.v[row, :2], st.v[0, :2])


@pytest.mark.gpu
def test_sharded_paged_pool_matches_unsharded():
    dev = _cuda_or_skip()
    one = _engine(dev)
    mels, budgets = _trace(one.cfg)
    geom = dict(page_size=4, n_pages=28)
    want = _drain(one.paged_scheduler(4, F, **geom), mels, budgets)
    eng = _engine(dev, mesh=_mesh(4))
    sched = eng.paged_scheduler(4, F, **geom)
    assert _drain(sched, mels, budgets) == want
    assert sched.pool.n_shards == 4 and sched.pool.self_alloc.n_shards == 4
    # the paged step a shard and the batch-1 step (replays)
    assert eng._step_captures == 4 + 1 and eng._step_builds == 2


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)])
@pytest.mark.parametrize("path", ["q8_0", "dense+flash"])
def test_tensor_parallel_serving_matches_unsharded(path, sizes):
    """Over (data, model) meshes of the card: the attention, FFN and
    vocabulary split over "model", each data shard's model shards in one
    captured graph; tokens equal the unsharded scheduler's and
    ``transcribe``'s, one capture a data shard."""
    dev = _cuda_or_skip()
    one = _engine(dev, path)
    mels, budgets = _trace(one.cfg)
    want = _drain(one.scheduler(4, F), mels, budgets)
    data, m = sizes
    eng = _engine(dev, path, make_serve_mesh(
        data, m, devices=[torch.device("cuda:0")] * (data * m)))
    assert eng._kv_devices[eng._phys] is not None
    sched = eng.scheduler(4, F)
    assert _drain(sched, mels, budgets) == want
    assert eng._step_captures == data and eng._step_builds == 1
    got = eng.transcribe(mels[0], max_new=budgets[0])[0].tokens
    assert got == want[0]


def _tp_mesh(data, m):
    return make_serve_mesh(data, m,
                           devices=[torch.device("cuda:0")] * (data * m))


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)])
def test_paged_pool_over_model_matches_unsharded(sizes):
    """The paged pool over (data, model) meshes of the card: each model
    shard's arenas hold its Hkv / M heads, its model shards run in the
    data shard's one captured paged step; tokens equal the unsharded
    paged pool's (Q8_0), through prefix hits and preemptions; one paged
    step capture a data shard and the batch-1 step (replays), then no
    launch from Python."""
    dev = _cuda_or_skip()
    one = _engine(dev)
    mels, budgets = _trace(one.cfg)
    order = (0, 1, 0, 1, 2, 3, 4, 5, 2)     # repeats while the first live
    trace = [mels[i] for i in order]
    news = [budgets[i] for i in order]
    geom = dict(page_size=4, n_pages=6)
    want = _drain(one.paged_scheduler(4, F, **geom), trace, news)
    data, m = sizes
    eng = _engine(dev, mesh=_tp_mesh(data, m))
    sched = eng.paged_scheduler(4, F, **geom)
    assert _drain(sched, trace, news) == want
    assert sched.shared_hits > 0 and sched.preemptions > 0
    ls = sched.pool.state.layer_states
    assert len(ls) == m and ls[0].self_k.shape[3] == eng.cfg.num_kv_heads // m
    assert eng._step_captures == data + 1 and eng._step_builds == 2
    launches = _launches()
    assert _drain(sched, trace, news) == want
    assert _launches() == launches and eng._step_captures == data + 1


@pytest.mark.gpu
def test_a_paged_row_over_model_is_the_same_at_1_and_4_slots():
    """The batch rule over "model": a request's K and V in every model
    shard's arena after three paged steps over (1, 2) are bit for bit the
    same whether it runs alone or beside three other requests."""
    dev = _cuda_or_skip()
    mels, _ = _trace(get_smoke_config("whisper-tiny"))

    def entries(others):
        eng = _engine(dev, mesh=_tp_mesh(1, 2))
        sched = eng.paged_scheduler(4, F, page_size=4, n_pages=17)
        for mel in mels[1:1 + others]:
            sched.submit(mel, max_new=8)
        rid = sched.submit(mels[0], max_new=8)
        sched.admit()
        slot = next(s for s, a in sched._active.items() if a.rid == rid)
        for _ in range(3):
            sched.decode_step()
        torch.cuda.synchronize()
        pool = sched.pool
        pages = torch.tensor(pool.slot_pages(slot), device=dev)
        out = [torch.cat([s.self_k[:, pages], s.self_v[:, pages]]).clone()
               for s in pool.model_states]
        assert int(pool.model_states[1].length[0, slot]) == 3
        return out
    alone, beside = entries(0), entries(3)
    assert all(torch.equal(a, b) for a, b in zip(alone, beside))


@pytest.mark.gpu
def test_moe_claim_spanning_shards_is_one_program_on_the_card():
    """arctic's smoke config drops at the 4-slot step (its one dispatch
    group spans the data shards, 2 slots each). Over ragged arrivals, on
    a data-2 mesh of the card the step is one captured program over the
    whole pool (``_joint``) and its tokens equal the same mesh's on the
    CPU, which ``tests/test_torch_sharding.py`` holds to the reference's
    sharded scheduler; the unsharded pool's equal the CPU's too. The two
    part: the sharded pool picks slots across its shards, so the step's
    rows come in another order, and the claim follows row order."""
    dev = _cuda_or_skip()
    cpu = torch.device("cpu")
    cfg = get_smoke_config("arctic-480b")
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 8)))
               .astype(np.int32) for _ in range(6)]
    budgets = [int(rng.integers(3, 8)) for _ in range(6)]

    def run(device, data=None):
        mesh = (None if data is None else
                make_serve_mesh(data=data, devices=[device] * data))
        eng = ServeEngine(cfg, params, max_len=32, quant="none",
                          offload=OffloadEngine(), eos_id=-1, device=device,
                          mesh=mesh)
        sched = eng.scheduler(4)
        rids = [sched.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
        out = sched.run()
        return sched, [out[r].tokens for r in rids]
    want_one, want_mesh = run(cpu)[1], run(cpu, 2)[1]
    assert want_one != want_mesh
    assert run(dev)[1] == want_one
    sched, got = run(dev, 2)
    assert sched._joint and len(sched._programs) == 1
    assert got == want_mesh


@pytest.mark.gpu
def test_a_failing_shard_capture_raises(monkeypatch):
    """The third shard's capture fails: the admission raises, and no
    step falls back to eager runs. Last in the file: a failed capture can
    leave the device's capture state behind."""
    dev = _cuda_or_skip()
    eng = _engine(dev, mesh=_mesh(4))
    real = eng._capture
    calls = []

    def capture(key, fn, **kw):
        if key[0] == "step" and key[2] == 4:
            calls.append(key)
            if len(calls) == 3:
                raise RuntimeError("capture failed")
        return real(key, fn, **kw)

    monkeypatch.setattr(eng, "_capture", capture)
    mels, budgets = _trace(eng.cfg)
    sched = eng.scheduler(4, F)
    sched.submit(mels[0], max_new=2)
    with pytest.raises(RuntimeError, match="capture failed"):
        sched.admit()
    assert not sched._programs and not sched._active
