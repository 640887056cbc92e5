"""The port's codec kernels (K1-K7) and its fused hop kernel (K8) against
their plain PyTorch versions, on the card.

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
from edgellm_tpu_torch.codecs import fused_hop as fh
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


@pytest.mark.parametrize("n,d", SHAPES[:-1] + [(96, 4)])
def test_channel_kernels_bit_exact(card, n, d):
    """K5 encode / decode, K6 encode and K7 encode / decode against a (1, D)
    channel abs-max scale, and K7 against ternary_mean's mean + 1e-8."""
    x = _rows(n, d, seed=3).to(card)
    cmax = x.abs().amax(dim=0, keepdim=True)
    chan = torch.where(cmax > 0, cmax, 1.0)
    mean = x.mean(dim=0, keepdim=True) + 1e-8
    before = {k.__name__: k.launches for k in (ck.chan_int8_encode, ck.chan_int8_decode,
                                               ck.chan_int4_encode, ck.ternary_encode,
                                               ck.ternary_decode)}
    q = ck.chan_int8_encode(x, chan)
    torch.testing.assert_close(q, ck.chan_int8_encode_plain(x, chan), atol=0, rtol=0)
    torch.testing.assert_close(ck.chan_int8_decode(q, chan), ck.chan_int8_decode_plain(q, chan),
                               atol=0, rtol=0)
    if d % 2 == 0:
        torch.testing.assert_close(ck.chan_int4_encode(x, chan),
                                   ck.chan_int4_encode_plain(x, chan), atol=0, rtol=0)
    for scale in (chan, mean):
        packed = ck.ternary_encode(x, scale)
        torch.testing.assert_close(packed, ck.ternary_encode_plain(x, scale), atol=0, rtol=0)
        torch.testing.assert_close(ck.ternary_decode(packed, scale),
                                   ck.ternary_decode_plain(packed, scale), atol=0, rtol=0)
    torch.cuda.synchronize()
    after = {k.__name__: k.launches for k in (ck.chan_int8_encode, ck.chan_int8_decode,
                                              ck.chan_int4_encode, ck.ternary_encode,
                                              ck.ternary_decode)}
    assert {k: after[k] - before[k] for k in after} == {
        "chan_int8_encode": 1, "chan_int8_decode": 1, "chan_int4_encode": 1,
        "ternary_encode": 2, "ternary_decode": 2}


@pytest.mark.parametrize("n,d", SHAPES)
def test_remote_hop_kernel_is_the_wire_path(card, n, d):
    """K8: the sealed buffer equals the wire path's byte for byte, the
    decode is bit-exact, ok; the receive half says not ok on a flipped byte
    or a zeroed canary, and ok with the same decode on the intact buffer."""
    x = _rows(n, d, seed=4).to(card)
    k0 = fh.remote_hop.launches
    out, ok, buf = fh.remote_hop(x)
    want_out, want_ok, want_buf = fh.remote_hop_plain(x)
    torch.cuda.synchronize()
    assert fh.remote_hop.launches == k0 + 1
    torch.testing.assert_close(buf, want_buf, atol=0, rtol=0)
    torch.testing.assert_close(out, want_out, atol=0, rtol=0)
    assert bool(ok) and bool(want_ok)
    again, ok2 = fh.remote_hop_receive(buf, n, d)
    assert bool(ok2) and torch.equal(again, out)
    for pos in (0, 5, 8, buf.numel() // 2, buf.numel() - 1):
        bad = buf.clone()
        bad[pos] ^= 0x20
        assert not bool(fh.remote_hop_receive(bad, n, d)[1]), pos
    bad = buf.clone()
    bad[:4] = 0
    assert not bool(fh.remote_hop_receive(bad, n, d)[1])


def test_fused_hops_on_the_card(card):
    """On the card the forced remote plan runs K8 and no K3/K4; the wire and
    remote hops and the separate hop decode the same values; two devices
    raise for the remote hop."""
    h = torch.from_numpy((np.random.default_rng(5).normal(size=(2, 64, 896)) * 2)
                         .astype(np.float32)).to(card)
    codec = get_wire_codec("int8_per_token_pallas")
    plan = fh.fused_hop_plan(codec, device=card)
    assert plan is None  # "auto": no probe data on this card
    e0, k0 = ck.int8_affine_encode.launches, fh.remote_hop.launches
    remote = fh.fused_hop(fh.FusedHopPlan("remote", "int8_per_token", "test"), codec, h, card)
    assert (ck.int8_affine_encode.launches, fh.remote_hop.launches) == (e0, k0 + 1)
    wire = fh.fused_hop(fh.FusedHopPlan("wire", "int8_per_token", "test"), codec, h, card)
    separate = codec.decode(codec.encode(h))
    torch.testing.assert_close(remote, separate, atol=0, rtol=0)
    torch.testing.assert_close(wire, separate, atol=0, rtol=0)
    assert fh.fused_remote_hop(codec, h.bfloat16(), card).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="two-card remote hop not ported"):
        fh.fused_remote_hop(codec, h, "cpu")


@pytest.mark.parametrize("name", ["int4_per_token", "int8_per_token", "int8_per_channel",
                                  "int4_per_channel", "ternary_mean", "ternary_max"])
def test_kernel_twin_codecs_match_plain_codecs(card, name):
    """The twins' payloads and reconstructions equal the plain codecs' on a
    float32 hidden, and the registry's ``*_pallas`` names are the twins.
    ``int4_per_channel``'s twin decodes with K2's ``codes * (scale / 7)``,
    the plain codec with ``(codes * scale) / 7``: 1 ulp apart at most, as
    the reference's twin and plain codec are."""
    h = torch.from_numpy((np.random.default_rng(2).normal(size=(3, 100, 896)) * 2)
                         .astype(np.float32)).to(card)
    plain, twin = get_wire_codec(name), get_wire_codec(name + "_pallas")
    assert twin.name == name + "_pallas"
    p, q = plain.encode(h), twin.encode(h)
    assert set(p) == set(q)
    for k in p:
        torch.testing.assert_close(q[k], p[k], atol=0, rtol=0)
    if name == "int4_per_channel":
        got, want = twin.decode(q), plain.decode(p)
        assert ((got == want) | ((got - want).abs() <= 1e-6 * want.abs())).all()
    else:
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
    with pytest.raises(ValueError, match="D % 4 == 0"):
        ck.ternary_encode(torch.randn(4, 6, device=card), torch.ones(1, 6, device=card))
    with pytest.raises(ValueError, match="shape"):
        ck.chan_int8_encode(x, torch.ones(1, 32, device=card))
