"""K3's folded saturation against the reference, on the CPU.

K3 (``int8_affine_encode(x, max_mag=...)``) reads a float32, bf16 or fp16
hidden as it is, widens each value exactly to float32 and saturates it
there, where the reference saturates in the hidden's dtype
(``edgellm_tpu.codecs.packing.sanitize_hidden``), widens, then encodes
(``int8_affine_encode_pallas``). The two agree bit for bit only if the
kernel clamps to ``max_mag`` rounded to the hidden's dtype
(``saturation_bound``): bf16(1e30) lies above float32(1e30), and float16
rounds 1e30 to Inf. These tests hold, bit for bit, with rows made by numpy
from a seed (NaN, +-Inf, the values beside the rounded bound, constant and
all-zero rows):

- the wrapper's plain form (what a CPU tensor computes) against the
  reference's sanitize -> widen -> Pallas encode (interpret mode);
- the kernel's arithmetic, written out in PyTorch (widen, clamp to
  +-``saturation_bound`` in float32, NaN -> 0, then K3's plain body),
  against the same reference; and with a float32 1e30 bound on a bf16
  hidden, against it and found different;
- the decode of those payloads, and the ``int8_per_token_pallas`` twin
  against the reference's twin.

Tolerance: none (NaN compares equal to NaN, as ``assert_array_equal`` does).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.codecs import packing as jpk
from edgellm_tpu.codecs import pallas_kernels as jpl
from edgellm_tpu_torch.codecs import codec_kernels as tck
from edgellm_tpu_torch.codecs import packing as tpk

DTYPES = {"float32": (torch.float32, jnp.float32, torch.int32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, torch.int16),
          "float16": (torch.float16, jnp.float16, torch.int16)}


def _edge_values(name: str) -> list:
    """The values just under, at and just above ``SATURATE_MAG`` rounded to
    the dtype, each exact in it (float16: its largest finite value and Inf)."""
    dtype, _, bits = DTYPES[name]
    at = tpk.saturation_bound(tpk.SATURATE_MAG, dtype)
    if math.isinf(at):
        return [torch.finfo(dtype).max, at]
    word = torch.tensor([at], dtype=dtype).view(bits)
    return [(word - 1).view(dtype).item(), at, (word + 1).view(dtype).item()]


def _rows(name: str, n: int, d: int, seed: int) -> np.ndarray:
    """(N, D) float32, every value exact in the dtype ``name``: random rows,
    then the rows a saturating encode must get right."""
    x = (np.random.default_rng(seed).normal(size=(n, d)) * 3).astype(np.float32)
    x = torch.from_numpy(x).to(DTYPES[name][0]).float().numpy()
    edges = _edge_values(name)
    special = [np.zeros(d), np.full(d, 1.5), np.r_[np.nan, np.ones(d - 1)],
               np.r_[np.inf, -np.inf, np.ones(d - 2)], np.r_[np.inf, np.zeros(d - 1)],
               np.r_[-np.inf, np.full(d - 1, 2.0)]]
    for v in edges:
        special += [np.r_[v, -v, x[0, 2:]], np.r_[v, x[1, 1:]], np.r_[-v, np.nan, x[2, 2:]]]
    for i, row in enumerate(special):
        x[(i * 7) % n] = row
    return x


def _reference_encode(x: np.ndarray, name: str):
    """The reference: sanitize in the hidden's dtype, widen, Pallas encode."""
    h = jpk.sanitize_hidden(jnp.asarray(x).astype(DTYPES[name][1]))
    return jpl.int8_affine_encode_pallas(h.astype(jnp.float32), interpret=True)


def _kernel_saturation(x: torch.Tensor, bound: float) -> torch.Tensor:
    """K3's saturation as the kernel computes it: widen exactly, clamp to
    +-bound in float32, then NaN -> 0."""
    w = torch.clamp(x.float(), -bound, bound)
    return torch.where(torch.isnan(w), torch.zeros_like(w), w)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,d", [(48, 64), (40, 896)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_saturating_encode_matches_reference(name, n, d):
    x = _rows(name, n, d, seed=n + d)
    h = torch.from_numpy(x).to(DTYPES[name][0])
    want = _reference_encode(x, name)
    _same(tck.int8_affine_encode(h, max_mag=tpk.SATURATE_MAG), want)
    bound = tpk.saturation_bound(tpk.SATURATE_MAG, h.dtype)
    _same(tck.int8_affine_encode_plain(_kernel_saturation(h, bound)), want)
    np.testing.assert_array_equal(  # the decode of those payloads
        tck.int8_affine_decode_plain(*tck.int8_affine_encode(h, tpk.SATURATE_MAG)).numpy(),
        np.asarray(jpl.int8_affine_decode_pallas(*want, interpret=True)))


def test_a_float32_bound_on_bf16_misses_the_reference():
    """Clamping a widened bf16 row to float32(1e30) cuts the saturated values
    short of bf16(1e30): scale and min move on every saturated row."""
    x = _rows("bfloat16", 48, 64, seed=3)
    h = torch.from_numpy(x).to(torch.bfloat16)
    fp32_bound = tpk.saturation_bound(tpk.SATURATE_MAG, torch.float32)
    assert tpk.saturation_bound(tpk.SATURATE_MAG, torch.bfloat16) > fp32_bound
    want = [np.asarray(w) for w in _reference_encode(x, "bfloat16")]
    q, scale, mn = tck.int8_affine_encode_plain(_kernel_saturation(h, fp32_bound))
    saturated = np.abs(np.nan_to_num(x, posinf=np.inf)).max(-1) >= 1e30
    assert saturated.sum() >= 8
    assert (scale.numpy()[saturated] != want[1][saturated]).all()
    assert not np.array_equal(mn.numpy(), want[2])


@pytest.mark.parametrize("name", list(DTYPES))
def test_sanitize_hidden_matches_reference(name):
    """sanitize_hidden in every hidden dtype (float16's bound is Inf: no
    clamp, NaN -> 0)."""
    x = _rows(name, 48, 64, seed=11)
    got = tpk.sanitize_hidden(torch.from_numpy(x).to(DTYPES[name][0]))
    want = jpk.sanitize_hidden(jnp.asarray(x).astype(DTYPES[name][1]))
    assert got.dtype == DTYPES[name][0]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("name", list(DTYPES))
def test_int8_twin_matches_reference_twin(name):
    """The int8_per_token twin (K3 saturating, K4) against the reference's
    jitted twin, on a (B, S, D) hidden in each dtype: payload and decode."""
    x = _rows(name, 2 * 24, 96, seed=21).reshape(2, 24, 96)
    jc = jpl.pallas_variant(jpk.get_wire_codec("int8_per_token"))
    tc = tpk.get_wire_codec("int8_per_token_pallas")
    want = jax.jit(jc.encode)(jnp.asarray(x).astype(DTYPES[name][1]))
    got = tc.encode(torch.from_numpy(x).to(DTYPES[name][0]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 or k == "q"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(tc.decode(got).numpy(),
                                  np.asarray(jax.jit(jc.decode)(want)))
