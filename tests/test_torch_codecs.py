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
    got = tmet.importance_per_layer(TStats(torch.from_numpy(col), torch.from_numpy(last),
                                           tuple(range(4))),
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
        tmet.importance_per_layer(TStats(tc, tc, tuple(range(5))), "weighted_importance")


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


# ---------------------------------------------------------------------------
# Packed wire codecs (codecs/packing.py) and the plain versions of the codec
# kernels (codecs/codec_kernels.py), against the reference's jitted codecs and
# its Pallas kernels in interpret mode.
#
# Payloads are held BIT-EXACT, dtypes included, and so are the int4 and int8
# decodes: the port's int4 decode is `codes * (scale * f32(1/7))`, the form
# XLA compiles the reference's `codes / 7 * scale` into under jit. The other
# codecs' decodes are held within 1e-6 of each token's max |x| (1 ulp).
# ---------------------------------------------------------------------------

import jax

from edgellm_tpu.codecs import packing as jpk
from edgellm_tpu.codecs import pallas_kernels as jpl
from edgellm_tpu_torch.codecs import codec_kernels as tck
from edgellm_tpu_torch.codecs import packing as tpk

_TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _wire_hidden(seed, b=2, s=64, d=96, special=True):
    """(B, S, D) float32; with ``special`` the rows a codec must survive:
    all zeros, constant, and NaN / +-Inf (saturated by the codecs)."""
    h = _hidden(seed, b=b, s=s, d=d)
    if special:
        h[0, 1] = 0.0
        h[-1, 2] = 1.5
        h[0, 3, :3] = [np.nan, np.inf, -np.inf]
    return h


def _as_np(x):
    """A payload leaf of either package as numpy (bf16 widened, exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


def _same_payload(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).replace("torch.", "") == \
            str(want[k].dtype).replace("torch.", ""), k
        np.testing.assert_array_equal(_as_np(got[k]), _as_np(want[k]), err_msg=k)


def _close_decode(got: torch.Tensor, want, h: np.ndarray, exact=False):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    scale = np.abs(np.nan_to_num(h, posinf=1e30, neginf=-1e30)).max(-1, keepdims=True)
    got = got.numpy()
    with np.errstate(invalid="ignore"):  # fp16 saturates a bf16 1e30 to Inf
        assert ((got == want) | (np.abs(got - want) <= 1e-6 * scale)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", tpk.WIRE_CODECS)
def test_registry_codec_bit_exact(name, dtype):
    """Every registry codec, the kernel twins included: payload leaves bit
    for bit (dtypes too), int4 and int8 decodes bit for bit and the others
    within 1 ulp, payload_bytes equal at (1, S, D) and (B, S, D).
    ``ternary_mean``'s channel mean is bit-exact at batch 1 (the reference's
    shape); over several rows XLA sums the two axes in another order."""
    b = 1 if name.startswith("ternary_mean") else 2
    h = _wire_hidden(3, b=b)
    jc, tc = jpk.get_wire_codec(name), tpk.get_wire_codec(name)
    assert tc.name == jc.name and tc.batch_invariant == jc.batch_invariant
    want = jax.jit(jc.encode)(jnp.asarray(h).astype(_JDTYPE[dtype]))
    got = tc.encode(torch.from_numpy(h).to(_TDTYPE[dtype]))
    _same_payload(got, want)
    _close_decode(tc.decode(got), jax.jit(jc.decode)(want), h,
                  exact=name.startswith(("int4", "int8")))
    for shape in ((1, 64, 96), (3, 64, 96)):
        assert tc.payload_bytes(shape) == jc.payload_bytes(shape)


def test_ternary_mean_over_batch_rows_within_summation_order():
    """Over several batch rows the channel means differ only by summation
    order: atol 1e-6 bounds 192 float32 adds of |x| ~ 1 (n eps mean|x|)."""
    h = _wire_hidden(4, b=3, special=False) / 3
    want = jax.jit(jpk.get_wire_codec("ternary_mean").encode)(jnp.asarray(h))
    got = tpk.get_wire_codec("ternary_mean").encode(torch.from_numpy(h))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("s", [16, 32, 48, 64, 96, 100, 128, 512])
def test_ternary_mean_channel_mean_by_window_length(s):
    """At batch 1 the channel mean is bit-exact at every window length: the
    port sums in the compiled reference's order (row by row below 32 rows,
    LLVM's vector tree at 32, symmetrically padded 32-row windows above) and
    fuses the mean's multiply with the + 1e-8 as XLA's CPU backend does."""
    h = _wire_hidden(10 + s, b=1, s=s, special=False) / 3
    want = np.asarray(jax.jit(jpk.get_wire_codec("ternary_mean").encode)(
        jnp.asarray(h))["scale"])
    got = tpk.get_wire_codec("ternary_mean").encode(torch.from_numpy(h))["scale"].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ratio,high", [(0.25, "bf16"), (0.0, "fp32"), (1.0, "fp16"),
                                        (0.3, "fp32")])
@pytest.mark.parametrize("per_row", [False, True])
def test_selective_int4_bit_exact(ratio, high, per_row):
    """Shared (S,) and per-row (B, S) importance, k = 0 and k = S, with ties
    in the importance (a stable sort breaks them by position)."""
    h = _wire_hidden(5, b=3)
    imp = (np.stack([_importance(20 + i) for i in range(3)]) if per_row
           else _importance(20))
    jc, tc = jpk.selective_int4(ratio, high), tpk.selective_int4(ratio, high)
    assert tc.name == jc.name and tc.needs_importance
    want = jax.jit(jc.encode)(jnp.asarray(h), jnp.asarray(imp))
    got = tc.encode(torch.from_numpy(h), torch.from_numpy(imp))
    _same_payload(got, want)
    _close_decode(tc.decode(got), jax.jit(jc.decode)(want), h)
    for shape in ((1, 64, 96), (3, 64, 96)):
        assert tc.payload_bytes(shape) == jc.payload_bytes(shape)


def test_packing_and_sanitize_match():
    rng = np.random.default_rng(9)
    c4 = rng.integers(-8, 8, (3, 16)).astype(np.int8)
    c3 = rng.integers(-1, 2, (3, 16)).astype(np.int8)
    p4 = tpk.pack_int4(torch.from_numpy(c4))
    np.testing.assert_array_equal(p4.numpy(), np.asarray(jpk.pack_int4(jnp.asarray(c4))))
    np.testing.assert_array_equal(tpk.unpack_int4(p4).numpy(), c4)
    p3 = tpk.pack_ternary(torch.from_numpy(c3))
    np.testing.assert_array_equal(p3.numpy(), np.asarray(jpk.pack_ternary(jnp.asarray(c3))))
    np.testing.assert_array_equal(tpk.unpack_ternary(p3).numpy(), c3)
    x = np.array([np.nan, np.inf, -np.inf, 3e38, -2.0, 0.0], np.float32)
    np.testing.assert_array_equal(tpk.sanitize_hidden(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpk.sanitize_hidden(jnp.asarray(x))))


def _kernel_rows(n, d, seed):
    """(N, D) rows for the kernel functions: random, all zeros, constant, and
    NaN / +-Inf after sanitize_hidden."""
    x = _hidden(seed, b=1, s=n, d=d)[0]
    for i, row in enumerate([np.zeros(d), np.full(d, -0.75),
                             np.r_[np.nan, np.inf, -np.inf, np.ones(d - 3)]][:n]):
        x[(i * 31) % n] = row
    return np.array(jpk.sanitize_hidden(jnp.asarray(x)))  # a writable copy


@pytest.mark.parametrize("n", [1, 7, 96, 4096])
@pytest.mark.parametrize("d", [64, 896])
def test_codec_kernel_plain_versions_match_pallas(n, d):
    """K1-K4 plain versions against the (jitted) Pallas kernels in interpret
    mode, bit for bit: payloads, the int8 decode, and the int4 decode with a
    per-row and with a (1, D) channel scale."""
    x = _kernel_rows(n, d, seed=n + d)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = jpl.int4_encode_pallas(jx, interpret=True)
    got = tck.int4_encode_plain(tx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tck.int4_decode_plain(*got).numpy(),
        np.asarray(jpl.int4_decode_pallas(*want, interpret=True)))
    chan = np.linspace(0.5, 2.0, d, dtype=np.float32)[None]
    np.testing.assert_array_equal(
        tck.int4_decode_plain(got[0], torch.from_numpy(chan)).numpy(),
        np.asarray(jpl.chan_int4_decode_pallas(want[0], jnp.asarray(chan), interpret=True)))
    want = jpl.int8_affine_encode_pallas(jx, interpret=True)
    got = tck.int8_affine_encode_plain(tx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tck.int8_affine_decode_plain(*got).numpy(),
        np.asarray(jpl.int8_affine_decode_pallas(*want, interpret=True)))


def test_kernel_twins_on_the_cpu_and_unported_twins():
    """On CPU tensors a twin runs its kernels' plain versions (payloads of
    the plain codec), and every plain codec with a kernel twin in the
    reference (K1-K7) resolves to it, by name and as its variant; the
    codecs the reference has no twin of resolve to none."""
    h = torch.from_numpy(_wire_hidden(6, b=1))
    for base in ("int4_per_token", "int8_per_token", "int8_per_channel",
                 "int4_per_channel", "ternary_mean", "ternary_max"):
        twin = tpk.get_wire_codec(base + "_pallas")
        assert twin.name == base + "_pallas"
        _same_payload(twin.encode(h), tpk.get_wire_codec(base).encode(h))
        assert tck.pallas_variant(tpk.get_wire_codec(base)).name == twin.name
    for base in ("int4_global", "ternary_per_token", "bf16"):
        assert tck.pallas_variant(tpk.get_wire_codec(base)) is None
    assert tck.pallas_variant(tpk.selective_int4(0.25)) is None
    assert tck.pallas_variant(tpk.get_wire_codec("fp32")) is None
    with pytest.raises(ValueError, match="unknown wire codec"):
        tpk.get_wire_codec("int3")


def _channel_scales(x):
    """The (1, D) scales the per-channel and ternary twins feed K5-K7: the
    channel abs-max with its zero guard, and ternary_mean's mean + 1e-8
    (which may be negative or tiny)."""
    cmax = np.abs(x).max(0, keepdims=True)
    return {"max": np.where(cmax > 0, cmax, 1.0).astype(np.float32),
            "mean": (x.mean(0, keepdims=True) + np.float32(1e-8)).astype(np.float32)}


@pytest.mark.parametrize("n", [1, 7, 96, 4096])
@pytest.mark.parametrize("d", [64, 896])
def test_channel_kernel_plain_versions_match_pallas(n, d):
    """K5-K7 plain versions against the (jitted) Pallas kernels in interpret
    mode, bit for bit: K5 encode and decode and K6 encode against the channel
    abs-max, K7 encode against both ternary scales and its decode."""
    x = _kernel_rows(n, d, seed=2 * n + d)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for kind, s in _channel_scales(x).items():
        js, ts = jnp.asarray(s), torch.from_numpy(s)
        want = jpl.ternary_encode_pallas(jx, js, interpret=True)
        got = tck.ternary_encode_plain(tx, ts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=kind)
        np.testing.assert_array_equal(
            tck.ternary_decode_plain(got, ts).numpy(),
            np.asarray(jpl.ternary_decode_pallas(want, js, interpret=True)), err_msg=kind)
        if kind != "max":
            continue
        want = jpl.chan_int8_encode_pallas(jx, js, interpret=True)
        got = tck.chan_int8_encode_plain(tx, ts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            tck.chan_int8_decode_plain(got, ts).numpy(),
            np.asarray(jpl.chan_int8_decode_pallas(want, js, interpret=True)))
        np.testing.assert_array_equal(
            tck.chan_int4_encode_plain(tx, ts).numpy(),
            np.asarray(jpl.chan_int4_encode_pallas(jx, js, interpret=True)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", ["int8_per_channel", "int4_per_channel", "ternary_mean",
                                  "ternary_max"])
def test_channel_twins_match_reference_twins(base, dtype):
    """The K5-K7 twins against the reference's jitted Pallas twins
    (interpret mode on the CPU), payloads and decodes bit for bit, bf16
    hiddens included (the payload scale keeps the hidden's dtype in both)."""
    h = _wire_hidden(9, b=1, s=64, d=128)
    jc, tc = jpl.pallas_variant(jpk.get_wire_codec(base)), \
        tck.pallas_variant(tpk.get_wire_codec(base))
    assert tc.name == jc.name == base + "_pallas"
    want = jax.jit(jc.encode)(jnp.asarray(h).astype(_JDTYPE[dtype]))
    got = tc.encode(torch.from_numpy(h).to(_TDTYPE[dtype]))
    _same_payload(got, want)
    _close_decode(tc.decode(got), jax.jit(jc.decode)(want), h, exact=True)
