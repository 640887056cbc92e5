"""The boundary wire format: the bytes that cross a cut (PyTorch counterpart
of ``edgellm_tpu/codecs/wire_format.py``, byte for byte).

- :func:`seal_payload` / :func:`verify_payload` / :func:`payload_checksum`:
  the 8-byte integrity sidecar (a canary word and a weighted byte checksum)
  sealed next to a payload. Byte k of leaf j weighs
  ``(2 * (k + j * 0x9E3779B1) + 1) * 2654435761`` mod 2**32; every weight is
  odd, so any single corrupted byte changes the sum, and a dropped payload
  zeroes the canary.
- :func:`flatten_bytes` / :func:`unflatten_bytes`: every leaf's bytes,
  little-endian, concatenated in the reference's tree-flatten order, and
  the inverse against a template tree.
- :class:`WireFormat`: the flat buffer of one hop for a (codec, activation
  shape): ``[canary u32][crc u32][payload leaves]``, ``wire_nbytes ==
  payload bytes + 8``.

Leaf order is JAX's: dict keys sorted, recursively (so the sealed tree is
canary, crc, then the payload's leaves by sorted key: ``mn``, ``q``,
``scale`` for ``int8_per_token``), not Python's insertion order.

The checksum is exact uint32 arithmetic computed in int64: PyTorch's
``uint32`` is a storage dtype without arithmetic, so the sums and products
are taken in int64 and masked to 32 bits, in chunks that cannot overflow.
The sealed words are held as ``uint32`` tensors made by reinterpreting
int32 bits (a view, no uint32 kernel needed).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

#: canary word sealed next to every payload; a dropped hop arrives all-zero
#: and fails this check even when the zeroed payload's checksum is trivially 0
CANARY = 0x5EA1C0DE

#: Knuth's multiplicative-hash constant; ``(2i+1) * _CRC_MULT`` gives every
#: byte position a distinct ODD weight mod 2**32
_CRC_MULT = 2654435761

#: per-leaf salt stride of the checksum
_GOLD = 0x9E3779B1

_MASK = 0xFFFFFFFF
#: terms per partial sum: a byte times a 32-bit weight is below 2**40, so
#: 2**22 of them stay below 2**62
_CHUNK = 1 << 22


def _leaves(tree) -> list:
    """The tree's tensors in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    return next(it)


def tree_nbytes(tree: Any) -> int:
    """Byte size of a payload tree, from its leaves' shapes and dtypes."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(tree)))


def _bytes(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's bytes in memory order (little-endian), (n,) uint8."""
    return leaf.reshape(-1).contiguous().view(torch.uint8)


def _mulmod(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a * m`` mod 2**32 for int64 ``a`` and constant ``m`` below 2**32,
    without an int64 overflow (``m`` split into 16-bit halves)."""
    lo, hi = m & 0xFFFF, m >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def _leaf_crc(leaf: torch.Tensor, salt: int) -> torch.Tensor:
    """Weighted byte sum of one leaf mod 2**32, as a 0-dim int64 tensor."""
    b = _bytes(leaf).to(torch.int64)
    if b.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=leaf.device)
    pos = (torch.arange(b.numel(), dtype=torch.int64, device=b.device) + (salt & _MASK)) & _MASK
    terms = b * _mulmod((2 * pos + 1) & _MASK, _CRC_MULT)
    total = torch.zeros((), dtype=torch.int64, device=b.device)
    for part in torch.split(terms, _CHUNK):
        total = (total + part.sum()) & _MASK
    return total


def payload_checksum(payload: Any) -> torch.Tensor:
    """uint32 checksum over every byte of every leaf (a 0-dim int64 tensor in
    [0, 2**32)); the per-leaf salt keys the positional weights so leaves
    can't trade bytes."""
    crc = None
    for j, leaf in enumerate(_leaves(payload)):
        term = _leaf_crc(leaf, j * _GOLD)
        crc = term if crc is None else (crc + term) & _MASK
    return crc


def _as_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the same bits as a uint32 tensor."""
    return (((v + (1 << 31)) & _MASK) - (1 << 31)).to(torch.int32).view(torch.uint32)


def _from_u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> its values as int64."""
    return t.view(torch.int32).to(torch.int64) & _MASK


def seal_payload(payload: Any) -> dict:
    """Wrap a codec payload with its integrity sidecar (8 bytes: canary +
    checksum), the tree that crosses the wire."""
    crc = payload_checksum(payload)
    canary = torch.full((1,), CANARY, dtype=torch.int64, device=crc.device)
    return {"canary": _as_u32(canary), "crc": _as_u32(crc.reshape(1)), "p": payload}


def verify_payload(sealed: dict) -> torch.Tensor:
    """0-dim bool tensor: the arrived payload is intact (canary alive AND
    checksum equal to a fresh computation over the arrived bytes). No host
    sync: the caller selects with it on the device."""
    return ((_from_u32(sealed["canary"])[0] == CANARY)
            & (payload_checksum(sealed["p"]) == _from_u32(sealed["crc"])[0]))


def flatten_bytes(tree: Any) -> torch.Tensor:
    """Every leaf's bytes, concatenated in tree-flatten order -> (N,) uint8."""
    return torch.cat([_bytes(leaf) for leaf in _leaves(tree)])


def unflatten_bytes(stream: torch.Tensor, like: Any) -> Any:
    """Inverse of :func:`flatten_bytes` against a template tree (any tensors
    of the right shapes and dtypes, meta tensors included). Leaves are views
    of ``stream`` where their offset is aligned to their dtype, copies
    where it is not."""
    out, off = [], 0
    for leaf in _leaves(like):
        size = leaf.element_size()
        n = leaf.numel() * size
        b = stream[off:off + n]
        if off % size:
            b = b.clone()
        off += n
        out.append(b.view(leaf.dtype).reshape(leaf.shape))
    return _rebuild(like, iter(out))


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """The flat-buffer wire layout of one hop for a fixed (codec, activation
    shape): ``[canary u32][crc u32][payload leaves in tree-flatten order]``.
    ``sealed_spec`` is the sealed tree as meta tensors."""

    codec_name: str
    sealed_spec: Any

    @classmethod
    def for_codec(cls, codec, hidden_shape, dtype=torch.float32) -> "WireFormat":
        """The wire format of ``codec`` hopping one (B, S, D) activation (the
        encode runs on meta tensors: no data)."""
        payload = codec.encode(torch.empty(tuple(hidden_shape), dtype=dtype, device="meta"))
        word = torch.empty((1,), dtype=torch.uint32, device="meta")
        return cls(codec_name=codec.name,
                   sealed_spec={"canary": word, "crc": word, "p": payload})

    @property
    def payload_nbytes(self) -> int:
        """Codec payload bytes, ``WireCodec.payload_bytes``."""
        return tree_nbytes(self.sealed_spec["p"])

    @property
    def wire_nbytes(self) -> int:
        """Total flat-buffer bytes: payload + the 8-byte integrity sidecar."""
        return tree_nbytes(self.sealed_spec)

    def to_wire(self, sealed: dict) -> torch.Tensor:
        """Sealed tree -> the (wire_nbytes,) uint8 buffer that crosses the cut."""
        return flatten_bytes(sealed)

    def from_wire(self, buf: torch.Tensor) -> dict:
        """Arrived flat buffer -> sealed tree (slices against the spec); feed
        it to :func:`verify_payload` and the codec's decode."""
        return unflatten_bytes(buf, self.sealed_spec)


__all__ = ["CANARY", "tree_nbytes", "payload_checksum", "seal_payload", "verify_payload",
           "flatten_bytes", "unflatten_bytes", "WireFormat"]
