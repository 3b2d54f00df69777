"""The port's Q8_0 format against the reference: ``qs`` and ``scales``
bit-exact on random tensors, exact .5 ties, all-zero blocks and a whole
whisper-tiny parameter tree, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.qformats import QTensor as JQTensor
from repro.core.qformats import quantize_q8_0 as jax_quantize
from repro.core.qformats import quantize_tree as jax_quantize_tree
from repro.models import model as jax_model
from repro.serve.engine import _keep_dense as jax_keep_dense
from repro_torch.convert import from_jax_params
from repro_torch.core.qformats import (
    QTensor, dequantize_q8_0, quantize_q8_0, quantize_tree)
from repro_torch.serve.engine import _keep_dense


def _assert_bit_exact(tq: QTensor, jq: JQTensor):
    np.testing.assert_array_equal(tq.qs.numpy(), np.asarray(jq.qs))
    np.testing.assert_array_equal(tq.scales.numpy().view(np.uint32),
                                  np.asarray(jq.scales).view(np.uint32))


@pytest.mark.parametrize("shape,scale", [
    ((64, 384), 0.05), ((3, 40, 96), 1.0), ((1536, 384), 0.02),
    ((512, 64), 1e-3), ((100, 1536), 30.0), ((7, 32), 1e-6)])
def test_random_tensors_bit_exact(shape, scale):
    w = (np.random.default_rng(sum(shape)).standard_normal(shape) * scale
         ).astype(np.float32)
    _assert_bit_exact(quantize_q8_0(torch.from_numpy(w)),
                      jax_quantize(jnp.asarray(w)))


def test_bf16_input_bit_exact():
    w = np.random.default_rng(5).standard_normal((48, 128)).astype(np.float32)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    _assert_bit_exact(quantize_q8_0(wb),
                      jax_quantize(jnp.asarray(wb.float().numpy()
                                               ).astype(jnp.bfloat16)))


def test_exact_half_ties_round_away_from_zero():
    """amax = 127 gives d = 1 exactly, so x/d lands on exact .5 ties:
    GGML's roundf goes away from zero (banker's rounding would not)."""
    block = np.zeros(32, np.float32)
    block[0] = 127.0
    block[1:7] = [2.5, -2.5, 3.5, -3.5, 0.5, -0.5]
    w = np.stack([block, -block])
    tq = quantize_q8_0(torch.from_numpy(w))
    _assert_bit_exact(tq, jax_quantize(jnp.asarray(w)))
    assert tq.qs[0, 0, 1:7].tolist() == [3, -3, 4, -4, 1, -1]
    assert tq.scales[0, 0].item() == 1.0


def test_all_zero_blocks():
    w = np.zeros((4, 96), np.float32)
    w[1, 32:64] = np.linspace(-1, 1, 32)
    tq = quantize_q8_0(torch.from_numpy(w))
    _assert_bit_exact(tq, jax_quantize(jnp.asarray(w)))
    assert tq.scales[0].tolist() == [0.0, 0.0, 0.0]
    assert not tq.qs[0].any() and torch.isfinite(dequantize_q8_0(tq)).all()


def test_rejects_k_not_multiple_of_block():
    with pytest.raises(ValueError):
        quantize_q8_0(torch.zeros(4, 80))


def test_whisper_tree_bit_exact():
    """quantize_tree + _keep_dense over a whisper-tiny smoke tree carried
    over by convert.py: the same leaves quantize, bit for bit, and the
    frontend (K = 80), biases, norms and positional tables stay dense."""
    cfg = jax_smoke_config("whisper-tiny")
    jparams = jax_model.init_params(jax.random.PRNGKey(0), cfg, 64)
    jq = jax_quantize_tree(jparams, jax_keep_dense)
    tq = quantize_tree(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"), _keep_dense)

    def walk(t, j, path):
        if isinstance(t, dict):
            assert set(t) == set(j), path
            for k in t:
                walk(t[k], j[k], path + (k,))
        elif isinstance(t, list):
            for i, ti in enumerate(t):     # the reference stacks layers
                walk(ti, jax.tree_util.tree_map(lambda a: a[i], j),
                     path + (i,))
        elif isinstance(t, QTensor):
            assert isinstance(j, JQTensor), path
            _assert_bit_exact(t, j)
            counts["q"] += 1
        else:
            assert not isinstance(j, JQTensor), path
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            counts["dense"] += 1

    counts = {"q": 0, "dense": 0}
    walk(tq, jq, ())
    assert not isinstance(tq["frontend"]["w"], QTensor)
    assert isinstance(tq["embed"]["table"], QTensor)
    assert not isinstance(tq["dec_pos"]["table"], QTensor)
    assert counts["q"] == 1 + 6 * 2 + 10 * 2   # embed, enc and dec linears
