"""The port's simulated codecs, importance metrics and windowing against the
TPU package's, on identical inputs made with numpy from a seed.

Codecs are held BIT-EXACT (``assert_array_equal``) on fp32 inputs and
identical importance; importance metrics within 1e-7; windowing identical.
The windows forms the sweep uses are held bit-exact against the one-window
functions applied window by window.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgellm_tpu.codecs import simulate as jsim
from edgellm_tpu.eval.windowing import sliding_windows as j_windows
from edgellm_tpu.importance import metrics as jmet
from edgellm_tpu.models.transformer import AttnStats as JStats
from edgellm_tpu_torch.codecs import simulate as tsim
from edgellm_tpu_torch.eval.windowing import sliding_windows as t_windows
from edgellm_tpu_torch.importance import metrics as tmet
from edgellm_tpu_torch.models.transformer import AttnStats as TStats
from edgellm_tpu_torch.utils.ordered import ordered_cumsum, ordered_sum


def _hidden(seed, b=1, s=64, d=32):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32) * 3


def _importance(seed, s=64, ties=True):
    imp = np.random.default_rng(seed).random(s).astype(np.float32)
    if ties:  # coarse values force ties, which stable sorting must break by position
        imp = np.round(imp * 8) / 8
    return imp


@pytest.mark.parametrize("s,ratio", [(64, 0.25), (64, 0.5), (512, 0.75), (48, 0.3)])
def test_token_select_mask_bit_exact(s, ratio):
    imp = _importance(s, s)
    k = int(float(ratio) * s)
    want = np.asarray(jsim.token_select_mask(jnp.asarray(imp), ratio, s, k=k))
    got = tsim.token_select_mask(torch.from_numpy(imp), ratio, s, k=k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == k


@pytest.mark.parametrize("s,b,ratio", [(64, 1, 0.25), (64, 2, 0.5), (512, 1, 0.75),
                                       (64, 1, 1.0), (64, 1, 0.0)])
def test_int4_token_select_bit_exact(s, b, ratio):
    h = _hidden(1, b=b, s=s)
    imp = _importance(2, s)
    k = int(float(ratio) * s)
    want = np.asarray(jsim.int4_token_select(jnp.asarray(h), jnp.asarray(imp), ratio, k=k))
    got = tsim.int4_token_select(torch.from_numpy(h), torch.from_numpy(imp), ratio, k=k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [2, 3, 8])
def test_simulate_symmetric_bit_exact(bits):
    h = _hidden(7, b=2)
    mask = np.array(jsim.token_select_mask(jnp.asarray(_importance(8)), 0.5, 64, k=32))
    want = np.asarray(jsim.simulate_symmetric(jnp.asarray(h), jnp.asarray(mask), bits))
    got = tsim.simulate_symmetric(torch.from_numpy(h), torch.from_numpy(mask), bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [64, 512, 2048])
@pytest.mark.parametrize("threshold", [1.0, 0.9, 0.5, 0.3])
def test_top_rho_mask_bit_exact(s, threshold):
    dist = np.random.default_rng(s).random(s).astype(np.float32)
    dist = dist / dist.sum()
    want = np.asarray(jsim.top_rho_mask(jnp.asarray(dist), jnp.float32(threshold)))
    got = tsim.top_rho_mask(torch.from_numpy(dist), torch.tensor(np.float32(threshold)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_mask", [False, True])
def test_per_token_affine_int8_bit_exact(use_mask):
    h = _hidden(3, b=2)
    h[0, 5] = 1.5  # a constant token passes through unchanged
    mask = np.array(jsim.token_select_mask(jnp.asarray(_importance(4)), 0.5, 64, k=32))
    want = np.asarray(jsim.per_token_affine_int8(
        jnp.asarray(h), jnp.asarray(mask) if use_mask else None))
    got = tsim.per_token_affine_int8(torch.from_numpy(h),
                                     torch.from_numpy(mask) if use_mask else None)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", tsim.CHANNEL_METHODS)
@pytest.mark.parametrize("s", [64, 512])
def test_channel_wise_quant_bit_exact(method, s):
    h = _hidden(5, s=s)
    h[0, :, 3] = 0.0  # an all-zero channel takes the no-op branch
    want = np.asarray(jsim.channel_wise_quant(jnp.asarray(h), method))
    got = tsim.channel_wise_quant(torch.from_numpy(h), method)
    np.testing.assert_array_equal(got.numpy(), want)


def test_windows_forms_equal_window_by_window():
    """Each window keeps its own scales: the batched forms the sweep uses are
    bit-identical to the one-window functions."""
    w, s, d = 3, 64, 32
    h = torch.from_numpy(_hidden(6, b=w, s=s, d=d))
    imp = torch.from_numpy(np.stack([_importance(10 + i, s) for i in range(w)]))
    got = tsim.int4_token_select_windows(h, imp, 0.5, k=32)
    for i in range(w):
        want = tsim.int4_token_select(h[i:i + 1], imp[i], 0.5, k=32)[0]
        torch.testing.assert_close(got[i], want, atol=0, rtol=0)
    for method in tsim.CHANNEL_METHODS:
        got = tsim.channel_wise_quant_windows(h, method)
        for i in range(w):
            torch.testing.assert_close(got[i], tsim.channel_wise_quant(h[i:i + 1], method)[0],
                                       atol=0, rtol=0)
    mask = tsim.top_rho_mask(imp / imp.sum(-1, keepdim=True), 0.6)
    got = tsim.per_token_affine_int8(h, mask)
    for i in range(w):
        torch.testing.assert_close(got[i], tsim.per_token_affine_int8(h[i:i + 1], mask[i])[0],
                                   atol=0, rtol=0)


def test_channel_method_rejected():
    with pytest.raises(ValueError, match="unknown channel method"):
        tsim.channel_wise_quant(torch.zeros(1, 4, 4), "channel_2")


@pytest.mark.parametrize("n", [1, 16, 31, 64, 100, 512, 2048])
def test_ordered_sums_are_sums(n):
    """Fixed-order sums are still sums (any length), against float64."""
    x = np.random.default_rng(n).random((3, n)).astype(np.float32)
    np.testing.assert_allclose(ordered_sum(torch.from_numpy(x), dim=1).numpy(),
                               x.astype(np.float64).sum(1), rtol=1e-6)
    np.testing.assert_allclose(ordered_cumsum(torch.from_numpy(x), dim=1).numpy(),
                               np.cumsum(x.astype(np.float64), 1), rtol=1e-6)


def _stats(seed, L=4, b=2, h=14, s=64):
    rng = np.random.default_rng(seed)
    col = rng.random((L, b, h, s)).astype(np.float32) / s
    last = rng.random((L, b, h, s)).astype(np.float32) / s
    return col, last


@pytest.mark.parametrize("method", tmet.ATTENTION_METHODS)
def test_importance_per_layer_matches(method):
    col, last = _stats(0)
    hw = np.random.default_rng(1).random((4, 14)).astype(np.float32)
    hw /= hw.sum(1, keepdims=True)
    want = np.asarray(jmet.importance_per_layer(
        JStats(jnp.asarray(col), jnp.asarray(last)), method, jnp.asarray(hw)))
    got = tmet.importance_per_layer(TStats(torch.from_numpy(col), torch.from_numpy(last)),
                                    method, torch.from_numpy(hw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_aggregations_and_ordering_match():
    col, _ = _stats(2, L=5)
    tc = torch.from_numpy(col)
    for k in (0, 2, 4):
        np.testing.assert_allclose(tmet.aggregate_upto(tc, k).numpy(),
                                   np.asarray(jmet.aggregate_upto(jnp.asarray(col), k)),
                                   atol=1e-7, rtol=0)
        np.testing.assert_allclose(tmet.maximum_aggregation(tc, k).numpy(),
                                   np.asarray(jmet.maximum_aggregation(jnp.asarray(col), k)),
                                   atol=1e-7, rtol=0)
    imp = np.round(np.random.default_rng(3).random((2, 64)) * 4).astype(np.float32)
    np.testing.assert_array_equal(
        tmet.ordering_from_importance(torch.from_numpy(imp)).numpy(),
        np.asarray(jmet.ordering_from_importance(jnp.asarray(imp))))
    with pytest.raises(ValueError, match="head_weights"):
        tmet.importance_per_layer(TStats(tc, tc), "weighted_importance")


@pytest.mark.parametrize("n,max_length,stride", [(100, 32, 8), (150, 48, 24),
                                                 (1000, 512, 32), (33, 64, 32), (1, 8, 4)])
def test_sliding_windows_identical(n, max_length, stride):
    ids = np.random.default_rng(n).integers(0, 1000, n)
    want = list(j_windows(ids, max_length, stride))
    got = list(t_windows(ids, max_length, stride))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.index, a.begin, a.end, a.num_loss_tokens) == \
            (b.index, b.begin, b.end, b.num_loss_tokens)
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
        np.testing.assert_array_equal(a.target_ids, b.target_ids)
