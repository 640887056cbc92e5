"""The port's per-token codec kernels (K1-K4) against their plain PyTorch
versions, on the card.

Marked ``cuda``: each test asks its fixture for a card and skips without one
(the kernels are CUDA C++ with no CPU mode). On a machine with an H100 and
nvcc but no JAX: ``python -m pytest --noconftest tests/test_torch_cuda_codecs.py``.

Tolerance: none. Kernel and plain version run the same float32 operations
in the same order (IEEE division, round half to even), so payloads and
decoded activations are held equal bit for bit.
"""
import numpy as np
import pytest
import torch

from edgellm_tpu_torch.codecs import codec_kernels as ck
from edgellm_tpu_torch.codecs.packing import get_wire_codec, sanitize_hidden

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _rows(n, d, seed=0):
    """(N, D) float32 with the rows a codec must survive: all zeros,
    constant, one huge value, and NaN / +-Inf saturated by sanitize_hidden."""
    x = (np.random.default_rng(seed).normal(size=(n, d)) * 3).astype(np.float32)
    special = [np.zeros(d), np.full(d, 1.5), np.r_[1e30, np.zeros(d - 1)],
               np.r_[np.nan, np.inf, -np.inf, np.ones(max(d - 3, 0))][:d]]
    for i, row in enumerate(special[:n]):
        x[(i * 7919) % n] = row
    return sanitize_hidden(torch.from_numpy(x))


SHAPES = [(1, 64), (7, 64), (511, 896), (4096, 896), (4096, 1536), (96, 2)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_int4_kernels_bit_exact(card, n, d):
    x = _rows(n, d).to(card)
    e0, d0 = ck.int4_encode.launches, ck.int4_decode.launches
    packed, scale = ck.int4_encode(x)
    want_p, want_s = ck.int4_encode_plain(x)
    torch.testing.assert_close(packed, want_p, atol=0, rtol=0)
    torch.testing.assert_close(scale, want_s, atol=0, rtol=0)
    out = ck.int4_decode(packed, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ck.int4_decode_plain(want_p, want_s), atol=0, rtol=0)
    assert (ck.int4_encode.launches, ck.int4_decode.launches) == (e0 + 1, d0 + 1)


@pytest.mark.parametrize("n,d", SHAPES)
def test_int4_decode_per_channel_scale(card, n, d):
    packed = torch.randint(0, 256, (n, d // 2), dtype=torch.uint8, device=card)
    scale = torch.rand((1, d), device=card) + 0.5
    torch.testing.assert_close(ck.int4_decode(packed, scale),
                               ck.int4_decode_plain(packed, scale), atol=0, rtol=0)


@pytest.mark.parametrize("n,d", SHAPES)
def test_int8_affine_kernels_bit_exact(card, n, d):
    x = _rows(n, d, seed=1).to(card)
    e0, d0 = ck.int8_affine_encode.launches, ck.int8_affine_decode.launches
    got = ck.int8_affine_encode(x)
    want = ck.int8_affine_encode_plain(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    out = ck.int8_affine_decode(*got)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ck.int8_affine_decode_plain(*want), atol=0, rtol=0)
    assert (ck.int8_affine_encode.launches, ck.int8_affine_decode.launches) == (e0 + 1, d0 + 1)


@pytest.mark.parametrize("name", ["int4_per_token", "int8_per_token"])
def test_kernel_twin_codecs_match_plain_codecs(card, name):
    """The twins' payloads and reconstructions equal the plain codecs' on a
    float32 hidden, and the registry's ``*_pallas`` names are the twins."""
    h = torch.from_numpy((np.random.default_rng(2).normal(size=(3, 100, 896)) * 2)
                         .astype(np.float32)).to(card)
    plain, twin = get_wire_codec(name), get_wire_codec(name + "_pallas")
    assert twin.name == name + "_pallas"
    p, q = plain.encode(h), twin.encode(h)
    assert set(p) == set(q)
    for k in p:
        torch.testing.assert_close(q[k], p[k], atol=0, rtol=0)
    torch.testing.assert_close(twin.decode(q), plain.decode(p), atol=0, rtol=0)
    assert twin.payload_bytes((3, 100, 896)) == plain.payload_bytes((3, 100, 896))


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.randn(4, 64, device=card)
    with pytest.raises(ValueError, match="float32"):
        ck.int4_encode(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        ck.int8_affine_encode(torch.randn(64, 4, device=card).T)
    with pytest.raises(ValueError, match="even width"):
        ck.int4_encode(torch.randn(4, 63, device=card))
    q, scale, mn = ck.int8_affine_encode(x)
    with pytest.raises(ValueError, match="CUDA device"):
        ck.int8_affine_decode(q, scale.cpu(), mn)
    packed, s = ck.int4_encode(x)
    with pytest.raises(ValueError, match="shape"):
        ck.int4_decode(packed, s[:2])
