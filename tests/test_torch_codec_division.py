"""K3's quantize arithmetic, emulated exactly on the CPU.

Where a row's range allows, K3 (``csrc/int8_affine_codec.cu``, ``RowQuant``)
does not divide each value by the row's ``safe``: it multiplies by the
correctly rounded reciprocal ``inv = RN(1 / safe)`` and corrects the
product twice with FMAs (``q = fma(fma(-safe, q, v), inv, q)``), then rounds
with an add of 1.5 * 2^23 and clamps in integers. These tests emulate those
float32 steps in numpy, the FMA exactly (the product in float64, the sum
rounded to odd, then to float32), and hold them bit for bit:

- the quotient against IEEE float32 division, at quotients on and beside
  the half-way points k + 1/2 (small and up to 2^22 steps), at random ones,
  and with ``safe`` a power of two or just below one;
- the whole fast path's codes against the plain version
  (``int8_affine_encode_plain``) on rows built around those ties.

The card test ``test_int8_affine_encode_at_rounding_ties`` holds the kernel
itself against the plain version on such rows.
"""
import numpy as np
import pytest
import torch

from edgellm_tpu_torch.codecs import codec_kernels as ck

f32, f64 = np.float32, np.float64
MAGIC = f32(12582912.0)  # 1.5 * 2^23


def fma32(a, b, c):
    """float32 fma(a, b, c), exactly: a * b is exact in float64, the sum is
    rounded to odd there (TwoSum), so the rounding to float32 is single."""
    a, b, c = (t.astype(f64) for t in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = (err != 0) & ((s.view(np.int64) & 1) == 0) & np.isfinite(s)
    s = np.where(odd, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(f32)


def quotient(v, safe):
    """RowQuant's v / safe: the reciprocal's product, corrected twice."""
    inv = f32(1) / safe
    q = v * inv
    q = fma32(fma32(-safe, q, v), inv, q)
    return fma32(fma32(-safe, q, v), inv, q)


def _safes(rng, n, kind):
    e = rng.uniform(-100, 99, n)
    safe = (np.exp2(e) * rng.uniform(1, 2, n)).astype(f32)
    if kind == "binade_edges":  # powers of two and their lower neighbours
        p2 = np.exp2(np.round(e)).astype(f32)
        safe = np.where(rng.random(n) < 0.5, p2, np.nextafter(p2, f32(0)))
    return safe


@pytest.mark.parametrize("kind", ["ties_small", "ties_large", "random", "binade_edges"])
def test_reciprocal_quotient_is_ieee_division(kind):
    rng = np.random.default_rng(["ties_small", "ties_large", "random",
                                 "binade_edges"].index(kind))
    n = 1 << 19
    safe = _safes(rng, n, kind)
    if kind.startswith("ties"):
        top = 400 if kind == "ties_small" else 1 << 22
        k = rng.integers(-top, top, n)
        v = ((k + 0.5) * safe.astype(f64)).astype(f32)
        for step in (-2, -1, 1, 2):  # on and a few ulps beside the tie
            pick = rng.random(n) < 0.2
            v = np.where(pick, np.nextafter(v, f32(np.sign(step) * np.inf)), v)
    else:
        v = (rng.uniform(-(1 << 22), 1 << 22, n) * safe.astype(f64)).astype(f32)
    keep = np.abs(v.astype(f64)) <= (1 << 22) * safe.astype(f64)  # K3's range
    v, safe = v[keep], safe[keep]
    got, want = quotient(v, safe), v / safe
    normal = np.abs(v) >= f32(2.0 ** -103)  # below it only the sign reaches a code
    np.testing.assert_array_equal(got[normal], want[normal])
    np.testing.assert_array_equal(np.rint(got), np.rint(want))


def tie_rows(n, d, seed):
    """(N, D) float32 rows whose values sit on and a few ulps beside the
    half-way points k + 1/2 of their quotients x / safe (for the row's own
    safe, computed in float32 as the codec computes it); half of the rows
    are offset by up to 2^21 steps, and one in 16 by 2^23, past K3's
    reciprocal range. The card test at rounding ties uses them too."""
    rng = np.random.default_rng(seed)
    target = (np.exp2(rng.uniform(-60, 60, n)) * rng.uniform(1, 2, n)).astype(f32)
    steps = rng.integers(-(1 << 21), 1 << 21, n) * (rng.random(n) < 0.5)
    steps[: n // 16] = rng.choice([-1, 1], n // 16) * (1 << 23)
    mn = (steps * target.astype(f64)).astype(f32)
    mx = ((steps + 255) * target.astype(f64)).astype(f32)
    safe = ((mx - mn) * f32(1.0 / 255.0)).astype(f32)
    k = np.floor(mn / safe.astype(f64))[:, None] + rng.integers(1, 254, (n, d))
    x = ((k + 0.5) * safe[:, None].astype(f64)).astype(f32)
    for step in (-2, -1, 1, 2):
        pick = rng.random((n, d)) < 0.1
        x = np.where(pick, np.nextafter(x, f32(np.sign(step) * np.inf)), x)
    x = np.clip(x, mn[:, None], mx[:, None])
    x[:, 0], x[:, -1] = mn, mx
    return x


@pytest.mark.parametrize("n,d", [(512, 896), (300, 100)])
def test_fast_path_codes_equal_the_plain_version(n, d):
    """The fast path end to end on the rows inside its range (all but the
    2^23-offset ones): quotient, rint by an add of 1.5 * 2^23 (the integer
    in the sum's bits), + zp and the clamp in integers."""
    x = tie_rows(n, d, seed=d)
    mn, mx = x.min(1), x.max(1)
    scale = ((mx - mn) * f32(1.0 / 255.0)).astype(f32)
    safe = np.where(scale > 0, scale, f32(1)).astype(f32)
    zp = np.rint(f32(-128) - mn / safe).astype(f32)
    fast = ((safe >= f32(2.0 ** -100)) & (safe <= f32(2.0 ** 100))
            & ((np.abs(mn) + np.abs(mx)).astype(f32) <= safe * f32(2.0 ** 22)))
    np.testing.assert_array_equal(~fast, np.arange(n) < n // 16)
    q = quotient(x, np.broadcast_to(safe[:, None], x.shape).astype(f32))
    bits = (q + MAGIC).astype(f32).view(np.uint32).astype(np.int64)
    codes = np.clip(bits + (zp.astype(np.int64) - 0x4B400000)[:, None], -128, 127)
    want = ck.int8_affine_encode_plain(torch.from_numpy(x))[0].numpy()
    np.testing.assert_array_equal(codes[fast].astype(np.int8), want[fast])
