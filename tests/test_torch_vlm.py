"""The port's vision-language family (llava-next-mistral-7b) against the
reference, on the CPU at the smoke config, with identical weights (the
reference's ``init_params`` through ``convert.py``) and numpy-seeded
prompts and patches:

- the config, its smoke cut and a 3-layer ``reduced`` cut field for
  field, ``n_params`` and ``enumerate_lm`` equal to the reference's;
- ``init_params``' tree (the biased ``projector`` from the patch width to
  d_model) and the Q8_0 tree (the projector's weight quantized, its bias
  dense, as the reference's ``_keep_dense`` says) in the reference's
  layout;
- ``_embed_inputs``: the projected patches spliced over the first P
  positions, with and without the engine, in Q8_0 and bf16;
- ``generate`` tokens, plans and ledger at batch 1 and 2 (Q8_0 and bf16,
  bursts None/256/32), and the slot scheduler's tokens and events
  against the reference scheduler's and batch-1 ``generate``'s: the VLM
  serves on tokens alone, as the reference's does;
- the CLI with ``--arch llava-next-mistral-7b``.

Tokens, counts and plan entries are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core import coverage as jax_coverage
from repro.core.offload import OffloadEngine as JaxOffloadEngine
from repro.core.qformats import QTensor as JaxQTensor
from repro.core.qformats import quantize_tree as jax_quantize_tree
from repro.models import model as jax_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.engine import _keep_dense as jax_keep_dense
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from repro_torch.configs import base, get_config, get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import coverage
from repro_torch.core.offload import OffloadEngine
from repro_torch.core.qformats import QTensor, quantize_tree
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine, _keep_dense
from repro_torch.serve.scheduler import ContinuousBatchingScheduler

ARCH = "llava-next-mistral-7b"
BURSTS = [None, 256, 32]
MAX_LEN = 32
PLAN_FIELDS = ("name", "m", "k", "n", "dtype", "offload", "burst", "tuned",
               "kernel", "tiling", "k_main", "k_res")

_PARAMS = {}


def _smoke():
    """(reference cfg, reference params, port cfg, port params), made
    once."""
    if not _PARAMS:
        jp = jax_model.init_params(jax.random.PRNGKey(0),
                                   jax_smoke_config(ARCH))
        _PARAMS["p"] = (jp, from_jax_params(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    jp, tp = _PARAMS["p"]
    return jax_smoke_config(ARCH), jp, get_smoke_config(ARCH), tp


def _pair(quant, burst):
    jcfg, jp, tcfg, tp = _smoke()
    joff = (None if burst is None
            else JaxOffloadEngine(prefer_pallas=False, burst=burst))
    toff = None if burst is None else OffloadEngine(burst=burst)
    return (JaxServeEngine(jcfg, jp, max_len=MAX_LEN, quant=quant,
                           offload=joff),
            ServeEngine(tcfg, tp, max_len=MAX_LEN, quant=quant,
                        offload=toff, device="cpu"))


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _entries(plan):
    return [tuple(getattr(e, f) for f in PLAN_FIELDS) for e in plan]


def test_config_reduced_params_and_coverage_match_reference():
    for port, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke_config(ARCH)),
                      (base.reduced(get_config(ARCH), num_layers=3),
                       jax_base.reduced(jax_config(ARCH), num_layers=3))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.family == base.VLM
        assert port.n_params() == ref.n_params()
        assert port.padded_vocab == ref.padded_vocab
        for seq, new, batch in ((0, 3, 1), (16, 0, 2), (7, 5, 4)):
            assert [dataclasses.astuple(m) for m in
                    coverage.enumerate_lm(port, seq, new, batch)] == \
                [dataclasses.astuple(m) for m in
                 jax_coverage.enumerate_lm(ref, seq, new, batch)]


def _shapes(tree, path=()):
    """{path: (shape, quantized)} of a parameter tree (dicts, lists,
    tensors or either package's QTensor), the reference's stacked blocks
    and the port's list of layers both by layer."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, (*path, k)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, (*path, i)))
        return out
    quantized = isinstance(tree, (QTensor, JaxQTensor))
    return {path: (tuple(tree.shape), quantized)}


def test_init_params_and_q8_tree_match_reference_layout():
    """The port's own draw has the reference's leaves (the projector (d,
    E_vis) with a (d,) bias among them); the converted tree quantized by
    each package's rule quantizes the same leaves (the projector's weight,
    not its bias)."""
    jcfg, jp, tcfg, tp = _smoke()
    own = model.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    assert own["projector"]["w"].shape == (tcfg.d_model,
                                           tcfg.vision_embed_dim)
    assert own["projector"]["b"].shape == (tcfg.d_model,)

    def flat(tree, stacked):
        out = {}
        for path, (shape, q) in _shapes(tree).items():
            if stacked and path[:2] == ("stack", "blocks"):
                # reference: (pattern position, leaf...) stacked over R
                for r in range(shape[0]):
                    out[("stack", "blocks", r) + path[3:]] = (shape[1:], q)
            else:
                out[path] = (shape, q)
        return out
    assert flat(own, False) == flat(tp, False)
    jq = jax_quantize_tree(jp, jax_keep_dense)
    tq = quantize_tree(tp, _keep_dense)
    got = {p: q for p, (_, q) in flat(tq, False).items()}
    want = {p: q for p, (_, q) in flat(jq, True).items()}
    assert got == want
    assert got[("projector", "w")] and not got[("projector", "b")]


@pytest.mark.parametrize("quant,burst", [("none", None), ("q8_0", None),
                                         ("q8_0", 256), ("none", 32)])
def test_embed_inputs_splices_projected_patches(quant, burst):
    """``_embed_inputs``: positions < P hold the projected patches, the
    rest the token embeddings, within 1e-5 of the reference (2e-2 on the
    bf16 kernel's route)."""
    jcfg, jp, tcfg, tp = _smoke()
    if quant == "q8_0":
        jp, tp = (jax_quantize_tree(jp, jax_keep_dense),
                  quantize_tree(tp, _keep_dense))
    je = (None if burst is None
          else JaxOffloadEngine(prefer_pallas=False, burst=burst))
    te = None if burst is None else OffloadEngine(burst=burst)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (2, 10)).astype(np.int32)
    patches = rng.standard_normal((2, 4, tcfg.vision_embed_dim)
                                  ).astype(np.float32)
    want = jax_model._embed_inputs(
        jp, jcfg, {"tokens": jnp.asarray(toks),
                   "patches": jnp.asarray(patches)}, je)
    got = model._embed_inputs(
        tp, tcfg, {"tokens": torch.from_numpy(toks).long(),
                   "patches": torch.from_numpy(patches)}, te)
    tol = 2e-2 if (quant, burst) == ("none", 32) else 1e-5
    _close(got, want, tol)
    plain = model._embed_inputs(tp, tcfg,
                                {"tokens": torch.from_numpy(toks).long()})
    assert torch.equal(got[:, 4:], plain[:, 4:])
    assert not torch.equal(got[:, :4], plain[:, :4])


@pytest.mark.parametrize("burst", BURSTS)
@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_generate_matches_reference(quant, burst):
    """Batch 1, then batch 2 with different prompts: tokens exact, the
    plans' entries and the ledger equal. Serving reads tokens only, so no
    projector entry appears in any plan."""
    jeng, teng = _pair(quant, burst)
    prompts = _prompts(teng.cfg, 2, 5)
    for p in (prompts[:1], prompts):
        want = jeng.generate(p, max_new=6)
        got = teng.generate(p, max_new=6)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert [r.steps for r in got] == [r.steps for r in want]
    if burst is None:
        return
    assert set(teng._plans.plans) == set(jeng._plans.plans)
    for key, jplan in jeng._plans.plans.items():
        assert _entries(teng._plans.plans[key]) == _entries(jplan), key
        assert "vlm.projector" not in {e.name for e in jplan}
    assert teng.offload.ledger.commits == jeng.offload.ledger.commits


def _drive(sched, prompts, budgets):
    events = []
    rids = [sched.submit(p, max_new=n)
            for p, n in zip(prompts[:3], budgets[:3])]
    sched.admit()
    events += sched.decode_step()
    rids += [sched.submit(p, max_new=n)
             for p, n in zip(prompts[3:], budgets[3:])]
    res = sched.run(on_token=events.append)
    return [res[r].tokens for r in rids], \
        [(e.rid, e.token, e.step, e.done) for e in events]


@pytest.mark.parametrize("quant", ["q8_0", "none"])
def test_scheduler_matches_reference_and_batch1_generate(quant):
    jeng, teng = _pair(quant, 256)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, teng.cfg.vocab_size, (int(s),)).astype(
        np.int32) for s in rng.integers(2, 7, 6)]
    budgets = rng.integers(2, 8, 6).tolist()
    got, gev = _drive(ContinuousBatchingScheduler(teng, n_slots=2),
                      prompts, budgets)
    want, wev = _drive(JaxScheduler(jeng, n_slots=2), prompts, budgets)
    assert got == want and gev == wev
    assert got == [teng.generate(p[None], max_new=n)[0].tokens
                   for p, n in zip(prompts, budgets)]


def test_cli_serves_llava(capsys):
    argv = ["--arch", ARCH, "--device", "cpu", "--power-w", "700"]
    assert serve_cli.main(argv + ["--offload", "--requests", "2",
                                  "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "req1: 3 tokens" in out and '"ledger_commits": 2' in out
    assert serve_cli.main(argv + ["--quant", "none", "--continuous",
                                  "--slots", "2", "--requests", "3",
                                  "--max-new", "2"]) == 0
    assert "continuous batching: 2 slots, 6 tokens streamed" in \
        capsys.readouterr().out
