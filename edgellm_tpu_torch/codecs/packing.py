"""Packed wire codecs: the bytes that cross a pipeline cut (PyTorch
counterpart of ``edgellm_tpu/codecs/packing.py``).

Every codec has a real packed representation: ``encode`` produces integer
payload tensors (int4 nibbles two per byte, ternary codes four per byte) plus
floating scales, ``decode`` inverts the packing, and ``payload_bytes`` is
computed from the payload leaves' shapes and dtypes (the encode runs on meta
tensors, so no data is touched).

Bit-exact with the reference's jitted codecs on the same float32 input: the
same operations in the same order (divide, then multiply by the level count;
round half to even; a float32 reciprocal of 255 for the affine scale), stable
sorts for every ranking, and the summation order of ``utils.ordered`` for the
one mean that reaches a payload (``ternary_mean``). Decodes divide by a
constant level count the way XLA compiles the reference: a multiply by its
float32 reciprocal, folded into the scale first where XLA reassociates
(``codes * (scale * (1/7))`` for the per-token and global int4 codecs), which
also makes them the same on the CPU and the card. Dtypes follow the
reference's promotion rules, which differ from PyTorch's: a 0-dim float32
tensor promotes a bf16 operand in JAX but not in PyTorch, so those casts are
written out.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..utils.ordered import ordered_sum

_INV_255 = np.float32(1.0 / 255.0)
_INV_7 = np.float32(1.0 / 7.0)
_INV_127 = np.float32(1.0 / 127.0)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant as a 0-dim tensor on ``like``'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes in [-8, 7] (last axis even) into uint8, two per byte.

    Wire layout: element i pairs with element i + D/2 (low nibble = first
    half, high nibble = second half), the reference's layout."""
    half = codes.shape[-1] // 2
    u = (codes.to(torch.int32) + 8).to(torch.uint8)  # [0, 15]
    return u[..., :half] | (u[..., half:] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> int8 codes in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1)


def pack_ternary(codes: torch.Tensor) -> torch.Tensor:
    """Pack ternary codes in {-1, 0, 1} (last axis % 4 == 0) into uint8, four
    per byte, by contiguous quarters like :func:`pack_int4`."""
    quarter = codes.shape[-1] // 4
    u = (codes.to(torch.int32) + 1).to(torch.uint8)  # [0, 2], 2 bits each
    parts = [u[..., i * quarter:(i + 1) * quarter] for i in range(4)]
    return parts[0] | (parts[1] << 2) | (parts[2] << 4) | (parts[3] << 6)


def unpack_ternary(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_ternary` -> int8 codes in {-1, 0, 1}."""
    parts = [((packed >> (2 * i)) & 0x3).to(torch.int8) - 1 for i in range(4)]
    return torch.cat(parts, dim=-1)


def _nbytes(payload: dict) -> int:
    return int(sum(t.numel() * t.element_size() for t in payload.values()))


#: saturation bound for pathological encoder inputs; well inside fp32 range so
#: the scale arithmetic downstream stays finite
SATURATE_MAG = 1e30


def sanitize_hidden(h: torch.Tensor, max_mag: float = SATURATE_MAG) -> torch.Tensor:
    """Deterministic saturation before encoding: NaN -> 0, +-Inf and
    magnitudes beyond ``max_mag`` clamp to ``+-max_mag``. The identity for
    ordinary finite inputs, so no wire codec turns a poisoned activation into
    garbage bytes: every payload decodes to something finite."""
    h = torch.clamp(h, -max_mag, max_mag)  # NaN propagates through clamp...
    return torch.where(torch.isnan(h), torch.zeros_like(h), h)  # ...and lands here


def _saturating(codec: "WireCodec", max_mag: float = SATURATE_MAG) -> "WireCodec":
    """Wrap a codec's encode with :func:`sanitize_hidden`. Every registry
    codec and every kernel twin passes through this."""
    enc = codec.encode
    if codec.needs_importance:
        def wrapped(h, importance):
            return enc(sanitize_hidden(h, max_mag), importance)
    else:
        def wrapped(h):
            return enc(sanitize_hidden(h, max_mag))
    return dataclasses.replace(codec, encode=wrapped)


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One boundary codec: ``encode(hidden) -> payload`` (a dict of tensors
    that cross the cut), ``decode(payload) -> hidden`` (float32).

    ``batch_invariant``: True when encode/decode treat batch rows
    independently (per-token codecs, identity casts); codecs whose scales
    reduce over the batch or sequence axes are not. ``needs_importance``:
    ``encode`` takes (hidden, importance) (token-selective mixed precision)."""

    name: str
    encode: Callable
    decode: Callable
    batch_invariant: bool = True
    needs_importance: bool = False

    def payload_bytes(self, hidden_shape, dtype=torch.float32) -> int:
        """Encoded bytes of one ``hidden_shape`` activation, from the payload
        leaves' shapes and dtypes (encode on meta tensors, no data)."""
        h = torch.empty(tuple(hidden_shape), dtype=dtype, device="meta")
        if self.needs_importance:
            # batch > 1 implies per-row importance (the low-index side
            # channel is B x k, not k)
            b, s = hidden_shape[0], hidden_shape[1]
            imp = torch.empty((s,) if b == 1 else (b, s), dtype=torch.float32,
                              device="meta")
            return _nbytes(self.encode(h, imp))
        return _nbytes(self.encode(h))


def _identity_codec(name: str, dtype: torch.dtype) -> WireCodec:
    # saturate to the WIRE dtype's own range (fp16 overflows far below
    # SATURATE_MAG), so a huge input crosses as the dtype max, never as Inf
    max_mag = min(SATURATE_MAG, float(torch.finfo(dtype).max))
    return _saturating(WireCodec(
        name=name,
        encode=lambda h: {"x": h.to(dtype)},
        decode=lambda p: p["x"].float(),
    ), max_mag)


def _int8_per_token() -> WireCodec:
    """Per-token affine int8: D bytes + (scale, min) per token. Constant
    tokens (scale == 0) reconstruct to exactly ``min``. On a bf16 hidden the
    reference keeps ``min`` bf16 in the payload and its jitted graph takes
    ``max - min`` in float32 (XLA drops the bf16 rounding of the difference
    before the float32 multiply); the float32 scale then promotes the rest,
    written out here because PyTorch does not promote against a 0-dim
    float32 tensor."""

    def encode(h):
        mn = h.amin(dim=-1, keepdim=True)
        mx = h.amax(dim=-1, keepdim=True)
        scale = (mx.float() - mn.float()) * _f32(_INV_255, h)
        safe = torch.where(scale > 0, scale, 1.0)
        zp = torch.round(-128.0 - mn.float() / safe)
        q = torch.clamp(torch.round(h.float() / safe) + zp, -128, 127).to(torch.int8)
        return {"q": q, "scale": scale, "mn": mn}

    def decode(p):
        scale, mn = p["scale"], p["mn"].float()
        safe = torch.where(scale > 0, scale, 1.0)
        zp = torch.round(-128.0 - mn / safe)
        deq = (p["q"].float() - zp) * safe
        return torch.where(scale > 0, deq, mn)

    return WireCodec("int8_per_token", encode, decode)


def _int4_global() -> WireCodec:
    """Symmetric int4 with one global max-abs scale."""

    def encode(h):
        max_val = h.abs().amax()
        safe = torch.where(max_val > 0, max_val, 1.0)
        codes = torch.round(torch.clamp(h / safe * 7.0, -8.0, 7.0)).to(torch.int8)
        return {"packed": pack_int4(codes), "scale": safe[None]}

    def decode(p):
        scale = p["scale"][0].float()
        return unpack_int4(p["packed"]).float() * (scale * _f32(_INV_7, scale))

    return WireCodec("int4_global", encode, decode, batch_invariant=False)


def _int4_per_token() -> WireCodec:
    """Symmetric int4, one max-abs scale per token (D/2 bytes + a scale)."""

    def encode(h):
        max_val = h.abs().amax(dim=-1, keepdim=True)
        safe = torch.where(max_val > 0, max_val, 1.0)
        codes = torch.round(torch.clamp(h / safe * 7.0, -8.0, 7.0)).to(torch.int8)
        return {"packed": pack_int4(codes), "scale": safe}

    def decode(p):
        scale = p["scale"].float()
        return unpack_int4(p["packed"]).float() * (scale * _f32(_INV_7, scale))

    return WireCodec("int4_per_token", encode, decode)


def _channel_mean(h: torch.Tensor) -> torch.Tensor:
    """``mean(h, axis=(0, 1), keepdims=True)`` in h's dtype: a sum in
    ``ordered_sum``'s order times the float32 reciprocal of the count. That
    is the reference's jitted order at batch 1; over several batch rows XLA
    associates the two-axis sum another way (up to 1 ulp apart)."""
    b, s, d = h.shape
    tot = ordered_sum(h.float().reshape(b * s, d), dim=0)
    mean = tot * torch.tensor(np.float32(1.0 / (b * s)), device=h.device)
    return mean.to(h.dtype).reshape(1, 1, d)


def _ternary(kind: str) -> WireCodec:
    """Per-channel ternary: D/4 bytes per token + D channel scales."""

    def encode(h):
        if kind == "mean":
            scale = _channel_mean(h) + 1e-8
        else:
            cmax = h.abs().amax(dim=(0, 1), keepdim=True)
            scale = torch.where(cmax > 0, cmax, 1.0)
        codes = torch.clamp(torch.round(h / scale), -1, 1).to(torch.int8)
        return {"packed": pack_ternary(codes), "scale": scale}

    def decode(p):
        return unpack_ternary(p["packed"]).float() * p["scale"]

    return WireCodec(f"ternary_{kind}", encode, decode, batch_invariant=False)


def _ternary_per_token() -> WireCodec:
    """Per-token symmetric ternary: D/4 packed crumbs + one max-abs scale per
    token; batch-invariant, unlike the per-channel ternary codecs."""

    def encode(h):
        mx = h.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(mx > 0, mx, 1.0)
        codes = torch.clamp(torch.round(h / scale), -1, 1).to(torch.int8)
        return {"packed": pack_ternary(codes), "scale": scale}

    def decode(p):
        return unpack_ternary(p["packed"]).float() * p["scale"]

    return WireCodec("ternary_per_token", encode, decode)


def _int8_per_channel() -> WireCodec:
    """Per-channel symmetric int8."""

    def encode(h):
        # an all-zero channel encodes to zero codes and decodes to exactly zero
        cmax = h.abs().amax(dim=(0, 1), keepdim=True)
        safe = torch.where(cmax > 0, cmax, 1.0)
        return {"q": torch.round(h / safe * 127.0).to(torch.int8), "scale": safe}

    def decode(p):
        scale = p["scale"].float()
        return p["q"].float() * scale * _f32(_INV_127, scale)

    return WireCodec("int8_per_channel", encode, decode, batch_invariant=False)


def _int4_per_channel() -> WireCodec:
    """Per-channel symmetric int4."""

    def encode(h):
        cmax = h.abs().amax(dim=(0, 1), keepdim=True)
        safe = torch.where(cmax > 0, cmax, 1.0)
        codes = torch.round(h / safe * 7.0).to(torch.int8)
        return {"packed": pack_int4(codes), "scale": safe}

    def decode(p):
        scale = p["scale"].float()
        return unpack_int4(p["packed"]).float() * scale * _f32(_INV_7, scale)

    return WireCodec("int4_per_channel", encode, decode, batch_invariant=False)


def _quant_pack(low: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """(B, k, D) low tokens + scale -> packed (B, k, D/2) int4 nibbles."""
    codes = torch.round(torch.clamp(low / safe * 7.0, -8.0, 7.0)).to(torch.int8)
    return pack_int4(codes)


def _unpack_dequant(packed: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    safe = safe.float()
    return unpack_int4(packed).float() * (safe * _f32(_INV_7, safe))


def _selective_scale(low: torch.Tensor, nonempty: bool, per_row: bool) -> torch.Tensor:
    """max|low| with the zero / empty-k guard: (B,) per row, else 0-dim."""
    if per_row:
        mx = (low.abs().amax(dim=(1, 2)) if nonempty
              else torch.zeros((low.shape[0],), dtype=torch.float32, device=low.device))
    else:
        mx = (low.abs().amax() if nonempty
              else torch.zeros((), dtype=torch.float32, device=low.device))
    return torch.where(mx > 0, mx, 1.0)


_HIGH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def selective_int4(ratio: float, high: str = "bf16") -> WireCodec:
    """Token-selective mixed-precision boundary codec.

    The ``k = int(ratio * S)`` least-important tokens cross as symmetric int4
    with one max-abs scale over the selected slice; the others cross at
    ``high`` precision in position-ascending order. The side channel is only
    the k low-token indices as int16 (S <= 32767): the decode side places the
    high tokens at the sorted complement of that set.

    ``encode(hidden, importance)``: ``importance`` is a shared (S,) vector, or
    per row (B, S), in which case each row carries its own ordering and scale
    (each evaluation window selects alone, as the reference does at batch
    1)."""
    if not 0.0 <= ratio <= 1.0:
        raise ValueError(f"ratio must be in [0, 1], got {ratio}")
    high_dtype = _HIGH_DTYPES[high]

    def encode(h, importance):
        b, s, d = h.shape
        if s > 32767:
            raise ValueError(f"selective_int4 int16 index side channel needs "
                             f"S <= 32767, got {s}")
        k = int(ratio * s)
        if importance.dim() == 2:  # per-row ordering + scale
            order = torch.argsort(importance, dim=-1, stable=True)  # (B, S) ascending
            rows = torch.arange(b, device=h.device)[:, None]
            low = h[rows, order[:, :k]]  # (B, k, D)
            safe = _selective_scale(low, k > 0, True)  # (B,)
            high_pos = torch.sort(order[:, k:], dim=-1).values
            return {
                "low": (_quant_pack(low, safe[:, None, None]) if k else
                        torch.zeros((b, 0, d // 2), dtype=torch.uint8, device=h.device)),
                "scale": safe,
                "high": h[rows, high_pos].to(high_dtype),
                "order": order[:, :k].to(torch.int16),
            }
        order = torch.argsort(importance, stable=True)  # least important first
        low_idx = order[:k]
        high_pos = torch.sort(order[k:]).values  # position-ascending
        low = h.index_select(1, low_idx)  # (B, k, D)
        safe = _selective_scale(low, k > 0, False)
        return {
            "low": (_quant_pack(low, safe) if k else
                    torch.zeros((b, 0, d // 2), dtype=torch.uint8, device=h.device)),
            "scale": safe[None],
            "high": h.index_select(1, high_pos).to(high_dtype),
            "order": low_idx.to(torch.int16),
        }

    def decode(p):
        high_t, low_t = p["high"], p["low"]
        b, k = high_t.shape[0], low_t.shape[1]
        d = low_t.shape[2] * 2 if k else high_t.shape[2]
        s = k + high_t.shape[1]
        dev = high_t.device
        out = torch.zeros((b, s, d), dtype=torch.float32, device=dev)
        low_idx = p["order"].long()
        if low_idx.dim() == 2:  # per-row
            rows = torch.arange(b, device=dev)[:, None]
            mask = torch.ones((b, s), dtype=torch.bool, device=dev)
            mask[rows, low_idx] = False
            # sorted complement: a stable sort puts the high (mask) positions
            # first, in ascending order
            high_pos = torch.argsort((~mask).to(torch.int8), dim=-1,
                                     stable=True)[:, :s - k]
            if k:
                out[rows, low_idx] = _unpack_dequant(low_t, p["scale"][:, None, None])
            out[rows, high_pos] = high_t.float()
            return out
        mask = torch.ones((s,), dtype=torch.bool, device=dev)
        mask[low_idx] = False
        high_pos = torch.argsort((~mask).to(torch.int8), stable=True)[:s - k]
        if k:
            out[:, low_idx] = _unpack_dequant(low_t, p["scale"][0])
        out[:, high_pos] = high_t.float()
        return out

    # high tokens cross at `high` precision: saturate to THAT dtype's range
    return _saturating(
        WireCodec(f"selective_int4_r{ratio}_{high}", encode, decode,
                  batch_invariant=False, needs_importance=True),
        min(SATURATE_MAG, float(torch.finfo(high_dtype).max)))


def _kernel_twin(base_name: str) -> Callable[[], WireCodec]:
    """Lazy factory for a kernel-backed codec (codec_kernels imports this
    module, so the import happens at call time)."""

    def factory() -> WireCodec:
        from .codec_kernels import kernel_twin

        return kernel_twin(base_name)

    return factory


def get_wire_codec(name: str) -> WireCodec:
    """Codec registry, the reference's names. A ``*_pallas`` name selects the
    hand-written CUDA twin of the codec explicitly (the spelling stays the
    reference's, so every config parses the same)."""
    factories = {
        "fp32": lambda: _identity_codec("fp32", torch.float32),
        "bf16": lambda: _identity_codec("bf16", torch.bfloat16),
        "fp16": lambda: _identity_codec("fp16", torch.float16),
        "int8_per_token": lambda: _saturating(_int8_per_token()),
        "int8_per_channel": lambda: _saturating(_int8_per_channel()),
        "int4_global": lambda: _saturating(_int4_global()),
        "int4_per_token": lambda: _saturating(_int4_per_token()),
        "int4_per_channel": lambda: _saturating(_int4_per_channel()),
        "ternary_mean": lambda: _saturating(_ternary("mean")),
        "ternary_max": lambda: _saturating(_ternary("max")),
        "ternary_per_token": lambda: _saturating(_ternary_per_token()),
        "int4_per_token_pallas": _kernel_twin("int4_per_token"),
        "int8_per_token_pallas": _kernel_twin("int8_per_token"),
        "int8_per_channel_pallas": _kernel_twin("int8_per_channel"),
        "int4_per_channel_pallas": _kernel_twin("int4_per_channel"),
        "ternary_mean_pallas": _kernel_twin("ternary_mean"),
        "ternary_max_pallas": _kernel_twin("ternary_max"),
    }
    if name not in factories:
        raise ValueError(f"unknown wire codec {name!r}; options: {sorted(factories)}")
    return factories[name]()


WIRE_CODECS = ("fp32", "bf16", "fp16", "int8_per_token", "int8_per_channel",
               "int4_global", "int4_per_token", "int4_per_channel",
               "ternary_mean", "ternary_max", "ternary_per_token",
               "int4_per_token_pallas", "int8_per_token_pallas",
               "int8_per_channel_pallas", "int4_per_channel_pallas",
               "ternary_mean_pallas", "ternary_max_pallas")
