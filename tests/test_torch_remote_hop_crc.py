"""K8's checksum, a word at a time, against the reference's.

The fused hop K8 (``csrc/remote_hop.cu``) seals the ``int8_per_token``
wire buffer with the reference's checksum (``wire_format._leaf_crc``): byte
p of leaf j weighs (2 (p + salt_j) + 1) M mod 2^32, M = 2654435761. The
kernel takes M out of the sum and the bytes a 4-byte word at a time: a word
of bytes b0..b3 whose first byte sits at leaf position p adds (2 p + 1)
(b0 + b1 + b2 + b3) + 2 (b1 + 2 b2 + 3 b3) (two byte dot products and one
multiply), a row of the q leaf starts at p = r D + salt, and the block and
grid sums add in any order; the scalar body adds (2 p + 1) b a byte. Both
are emulated below in numpy uint32 arithmetic (wrapping mod 2^32 as the
kernel's) and held equal to the reference's ``_leaf_crc`` and
``payload_checksum``: random bytes under all three salts of the payload's
leaves, salts that make the positions wrap past 2^32 inside the leaf, and a
whole int8 payload laid out in the kernel's rows and words.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from edgellm_tpu.codecs import packing as jpk
from edgellm_tpu.codecs import wire_format as jwf

M = np.uint32(2654435761)
#: the payload's leaf salts j * 0x9E3779B1 mod 2^32, in sorted-key order (mn, q, scale)
SALTS = [(j * 0x9E3779B1) & 0xFFFFFFFF for j in range(3)]


def _word_crc(words: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The kernel's word_crc, less M: (2 pos + 1) * (byte sum) + 2 *
    (b1 + 2 b2 + 3 b3), in uint32."""
    b = [(words >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    total = b[0] + b[1] + b[2] + b[3]
    weighted = b[1] + np.uint32(2) * b[2] + np.uint32(3) * b[3]
    return (np.uint32(2) * pos + np.uint32(1)) * total + np.uint32(2) * weighted


def _leaf_crc_words(data: bytes, salt: int, row: int = 0) -> int:
    """A leaf's checksum as the vector body sums it: rows of ``row`` bytes
    (the whole leaf when 0), each read as little-endian 4-byte words."""
    raw = np.frombuffer(data, dtype=np.uint8)
    row = row or raw.size
    total = np.uint32(0)
    with np.errstate(over="ignore"):
        for r0 in range(0, raw.size, row):
            words = raw[r0:r0 + row].view("<u4").astype(np.uint32)
            base = np.uint32((r0 + salt) & 0xFFFFFFFF)
            pos = base + np.arange(0, 4 * words.size, 4, dtype=np.uint32)
            total = total + _word_crc(words, pos).sum(dtype=np.uint32)
        return int(total * M)


def _leaf_crc_bytes(data: bytes, salt: int) -> int:
    """... as the scalar body sums it, a byte at a time."""
    raw = np.frombuffer(data, dtype=np.uint8).astype(np.uint32)
    with np.errstate(over="ignore"):
        pos = np.uint32(salt & 0xFFFFFFFF) + np.arange(raw.size, dtype=np.uint32)
        return int(((np.uint32(2) * pos + np.uint32(1)) * raw).sum(dtype=np.uint32) * M)


def _reference(data: bytes, salt: int) -> int:
    return int(jwf._leaf_crc(jnp.asarray(np.frombuffer(data, dtype=np.uint8)), salt))


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("nbytes", [4, 64, 4096, 8 * 1536])
def test_word_checksum_matches_reference(salt, nbytes):
    data = np.random.default_rng(nbytes + salt % 97).integers(0, 256, nbytes, np.uint8).tobytes()
    want = _reference(data, salt)
    assert _leaf_crc_words(data, salt) == want
    assert _leaf_crc_words(data, salt, row=64) == want  # rows of a 64-wide q leaf
    assert _leaf_crc_bytes(data, salt) == want


@pytest.mark.parametrize("salt", [0xFFFFFFFF - 3, 0xFFFFFFF0, 0x80000000 - 8, 0xFFFFFF00])
def test_word_checksum_where_positions_wrap(salt):
    """Positions p + salt past 2^32 inside the leaf (and 2 p + 1 past it),
    with every byte value: the weights wrap mod 2^32 as the reference's."""
    data = (np.arange(512) % 256).astype(np.uint8)[::-1].tobytes()
    want = _reference(data, salt)
    assert _leaf_crc_words(data, salt) == want
    assert _leaf_crc_bytes(data, salt) == want


def test_word_checksum_of_an_int8_payload_matches_payload_checksum():
    """A sealed int8_per_token payload of (N, D) = (5, 24) (odd N: the q leaf
    at byte 8 + 4 N is only 4-byte aligned in the buffer): mn and scale a
    word per row, q in rows of D bytes, summed over the leaves, equals the
    reference's payload_checksum; a flipped byte moves it."""
    n, d = 5, 24
    x = np.random.default_rng(3).normal(size=(1, n, d)).astype(np.float32) * 3
    payload = jpk.get_wire_codec("int8_per_token").encode(jnp.asarray(x))
    leaves = {key: np.asarray(payload[key]).tobytes() for key in ("mn", "q", "scale")}
    with np.errstate(over="ignore"):
        total = (np.uint32(_leaf_crc_words(leaves["mn"], SALTS[0]))
                 + np.uint32(_leaf_crc_words(leaves["q"], SALTS[1], row=d))
                 + np.uint32(_leaf_crc_words(leaves["scale"], SALTS[2])))
    assert int(total) == int(jwf.payload_checksum(payload))
    bad = bytearray(leaves["q"])
    bad[d + 3] ^= 0x01
    assert _leaf_crc_words(bytes(bad), SALTS[1], row=d) != _leaf_crc_words(leaves["q"],
                                                                            SALTS[1], row=d)
