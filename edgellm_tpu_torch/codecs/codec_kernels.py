"""The wire codecs' hand-written Hopper kernels, their plain PyTorch
versions, and the kernel-backed ``WireCodec`` twins (PyTorch counterpart of
the first half of ``edgellm_tpu/codecs/pallas_kernels.py``).

- **K1** ``int4_encode`` / **K2** ``int4_decode`` (``csrc/int4_codec.cu``):
  per-row max-abs scale, int4 quantize and nibble pack; unpack and
  dequantize with a per-row (N, 1) or per-channel (1, D) scale (the TPU's
  ``chan_int4_decode_pallas`` shares K2's body).
- **K3** ``int8_affine_encode`` / **K4** ``int8_affine_decode``
  (``csrc/int8_affine_codec.cu``): per-row affine int8.
- **K5** ``chan_int8_encode`` / ``chan_int8_decode``, **K6**
  ``chan_int4_encode`` and **K7** ``ternary_encode`` / ``ternary_decode``
  (``csrc/channel_codec.cu``): quantize(+pack) and unpack(+dequantize)
  against a (1, D) channel scale, which the twins reduce over (B, S) with
  PyTorch ops outside the kernels, as the reference does in XLA.

The int4 decode is ``codes * (scale * f32(1/7))``: the reference kernel's
``codes / 7 * scale`` as XLA compiles it (a multiply by the reciprocal,
folded into the scale), so the port matches the jitted reference bit for bit.
The per-channel int8 decode ``q * scale / 127`` compiles to
``(q * scale) * f32(1/127)``, and K5 computes that.

A wrapper launches its kernel for CUDA tensors and takes the plain version
for any other tensor (the CPU, or meta tensors when ``payload_bytes`` asks
for shapes); a CUDA tensor outside the wrapper's checks raises. The plain
versions repeat the reference kernels' float32 arithmetic step for step, so
kernel, plain version and reference agree bit for bit on payloads.

The registry keeps the reference's ``*_pallas`` names: in this package such a
name means "the hand-written CUDA twin". The ``int4_per_channel`` twin
decodes with K2, ``codes * (scale * f32(1/7))``, where the plain codec
computes ``(codes * scale) * f32(1/7)``; the two can be 1 ulp apart, as the
reference's twin and plain codec are.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .packing import _INV_7, _INV_127, _INV_255, WireCodec, _channel_mean, _f32, _saturating

#: widest row an encode block can keep in shared memory (227 KB a block)
MAX_ENCODE_D = 56 * 1024


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the kernels' yardstick on the card.
# ---------------------------------------------------------------------------


def int4_encode_plain(x: torch.Tensor):
    """(N, D) float32 -> (packed (N, D/2) uint8, scale (N, 1) float32)."""
    half = x.shape[-1] // 2
    max_val = x.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(max_val > 0, max_val, 1.0)
    codes = torch.round(torch.clamp(x / safe * 7.0, -8.0, 7.0)).to(torch.int32) + 8
    return (codes[:, :half] | (codes[:, half:] << 4)).to(torch.uint8), safe


def int4_decode_plain(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(N, D/2) uint8 + (N, 1) or (1, D) float32 scale -> (N, D) float32."""
    p = packed.to(torch.int32)
    codes = torch.cat([(p & 0xF) - 8, ((p >> 4) & 0xF) - 8], dim=-1).float()
    return codes * (scale * _f32(_INV_7, scale))


def int8_affine_encode_plain(x: torch.Tensor):
    """(N, D) float32 -> (q (N, D) int8, scale (N, 1), mn (N, 1) float32)."""
    mn = x.amin(dim=-1, keepdim=True)
    mx = x.amax(dim=-1, keepdim=True)
    scale = (mx - mn) * _f32(_INV_255, x)
    safe = torch.where(scale > 0, scale, 1.0)
    zp = torch.round(-128.0 - mn / safe)
    q = torch.clamp(torch.round(x / safe) + zp, -128, 127).to(torch.int8)
    return q, scale, mn


def int8_affine_decode_plain(q: torch.Tensor, scale: torch.Tensor,
                             mn: torch.Tensor) -> torch.Tensor:
    """(N, D) int8 + (N, 1) scale and min -> (N, D) float32; rows whose scale
    is 0 decode to their min."""
    safe = torch.where(scale > 0, scale, 1.0)
    zp = torch.round(-128.0 - mn / safe)
    deq = (q.float() - zp) * safe
    return torch.where(scale > 0, deq, mn)


def chan_int8_encode_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(N, D) float32 + (1, D) channel scale -> q (N, D) int8."""
    return torch.round(x / scale * 127.0).to(torch.int8)


def chan_int8_decode_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(N, D) int8 + (1, D) channel scale -> (N, D) float32."""
    return q.float() * scale * _f32(_INV_127, scale)


def chan_int4_encode_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(N, D) float32 + (1, D) channel scale -> packed (N, D/2) uint8, with no
    clip (``|x| <= scale`` by construction)."""
    half = x.shape[-1] // 2
    codes = torch.round(x / scale * 7.0).to(torch.int32) + 8
    return (codes[:, :half] | (codes[:, half:] << 4)).to(torch.uint8)


def ternary_encode_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(N, D) float32 + (1, D) channel scale -> packed (N, D/4) uint8, one
    crumb from each D/4 quarter per byte."""
    quarter = x.shape[-1] // 4
    codes = torch.clamp(torch.round(x / scale), -1, 1).to(torch.int32) + 1
    parts = [codes[:, k * quarter:(k + 1) * quarter] << (2 * k) for k in range(4)]
    return (parts[0] | parts[1] | parts[2] | parts[3]).to(torch.uint8)


def ternary_decode_plain(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(N, D/4) uint8 + (1, D) channel scale -> (N, D) float32."""
    p = packed.to(torch.int32)
    codes = torch.cat([((p >> (2 * k)) & 0x3) - 1 for k in range(4)], dim=-1).float()
    return codes * scale


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: each library's C entry points: (argtypes, restype)
_SIGNATURES = {
    "int4_codec": {
        "edgellm_int4_encode": ([_PTR] * 3 + [_I64, _I32, _PTR], _I32),
        "edgellm_int4_decode": ([_PTR] * 3 + [_I64, _I32, _I32, _PTR], _I32),
        "edgellm_int4_error": ([_I32], ctypes.c_char_p),
    },
    "int8_affine_codec": {
        "edgellm_int8_affine_encode": ([_PTR] * 4 + [_I64, _I32, _PTR], _I32),
        "edgellm_int8_affine_decode": ([_PTR] * 4 + [_I64, _I32, _PTR], _I32),
        "edgellm_int8_affine_error": ([_I32], ctypes.c_char_p),
    },
    "channel_codec": {
        **{fn: ([_PTR] * 3 + [_I64, _I32, _PTR], _I32)
           for fn in ("edgellm_chan_int8_encode", "edgellm_chan_int8_decode",
                      "edgellm_chan_int4_encode", "edgellm_ternary_encode",
                      "edgellm_ternary_decode")},
        "edgellm_channel_codec_error": ([_I32], ctypes.c_char_p),
    },
    "remote_hop": {
        "edgellm_remote_hop": ([_PTR] * 5 + [_I64, _I32, _PTR], _I32),
        "edgellm_remote_hop_receive": ([_PTR] * 4 + [_I64, _I32, _PTR], _I32),
        "edgellm_remote_hop_error": ([_I32], ctypes.c_char_p),
    },
}


def _lib(name: str) -> ctypes.CDLL:
    lib = cuda_build.library(name)
    if not getattr(lib, "_edgellm_declared", False):
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._edgellm_declared = True
    return lib


def _check(what: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device):
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{what}: kernel inputs must share one CUDA device, got "
                         f"{t.device} (expected {device})")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the kernel reads it packed, so it must be contiguous")


def _check_rows(n: int, d: int, encode: bool):
    if n < 1 or d < 2 or d % 2:
        raise ValueError(f"codec kernels take N >= 1 rows of an even width D >= 2, "
                         f"got N={n}, D={d}")
    if encode and d > MAX_ENCODE_D:
        raise ValueError(f"encode keeps a row in shared memory: D <= {MAX_ENCODE_D}, "
                         f"got {d}")


def _launch(lib, fn: str, errfn: str, *args):
    err = getattr(lib, fn)(*args)
    if err:
        msg = getattr(lib, errfn)(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err} ({msg})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def int4_encode(x: torch.Tensor):
    """K1: (N, D) float32 -> (packed (N, D/2) uint8, scale (N, 1) float32).
    CUDA tensors launch the kernel (``int4_encode.launches`` counts them);
    other tensors take :func:`int4_encode_plain`."""
    if x.device.type != "cuda":
        return int4_encode_plain(x)
    n, d = x.shape
    _check_rows(n, d, encode=True)
    _check("x", x, torch.float32, (n, d), x.device)
    packed = torch.empty((n, d // 2), dtype=torch.uint8, device=x.device)
    scale = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    lib = _lib("int4_codec")
    int4_encode.launches += 1
    with torch.cuda.device(x.device):
        _launch(lib, "edgellm_int4_encode", "edgellm_int4_error", x.data_ptr(),
                packed.data_ptr(), scale.data_ptr(), n, d, _stream(x.device))
    return packed, scale


def int4_decode(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K2: (N, D/2) uint8 + a per-row (N, 1) or per-channel (1, D) float32
    scale -> (N, D) float32. CUDA tensors launch the kernel
    (``int4_decode.launches``); other tensors take :func:`int4_decode_plain`."""
    if packed.device.type != "cuda":
        return int4_decode_plain(packed, scale)
    n, dh = packed.shape
    d = 2 * dh
    _check_rows(n, d, encode=False)
    _check("packed", packed, torch.uint8, (n, dh), packed.device)
    per_channel = tuple(scale.shape) == (1, d)  # else per row (N, 1); D >= 2
    _check("scale", scale, torch.float32, (1, d) if per_channel else (n, 1), packed.device)
    out = torch.empty((n, d), dtype=torch.float32, device=packed.device)
    lib = _lib("int4_codec")
    int4_decode.launches += 1
    with torch.cuda.device(packed.device):
        _launch(lib, "edgellm_int4_decode", "edgellm_int4_error", packed.data_ptr(),
                scale.data_ptr(), out.data_ptr(), n, d, int(per_channel),
                _stream(packed.device))
    return out


def int8_affine_encode(x: torch.Tensor):
    """K3: (N, D) float32 -> (q (N, D) int8, scale (N, 1), mn (N, 1)
    float32). CUDA tensors launch the kernel (``int8_affine_encode.launches``);
    other tensors take :func:`int8_affine_encode_plain`."""
    if x.device.type != "cuda":
        return int8_affine_encode_plain(x)
    n, d = x.shape
    _check_rows(n, d, encode=True)
    _check("x", x, torch.float32, (n, d), x.device)
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    mn = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    lib = _lib("int8_affine_codec")
    int8_affine_encode.launches += 1
    with torch.cuda.device(x.device):
        _launch(lib, "edgellm_int8_affine_encode", "edgellm_int8_affine_error",
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), mn.data_ptr(), n, d,
                _stream(x.device))
    return q, scale, mn


def int8_affine_decode(q: torch.Tensor, scale: torch.Tensor,
                       mn: torch.Tensor) -> torch.Tensor:
    """K4: (N, D) int8 + (N, 1) scale and min -> (N, D) float32. CUDA tensors
    launch the kernel (``int8_affine_decode.launches``); other tensors take
    :func:`int8_affine_decode_plain`."""
    if q.device.type != "cuda":
        return int8_affine_decode_plain(q, scale, mn)
    n, d = q.shape
    _check_rows(n, d, encode=False)
    _check("q", q, torch.int8, (n, d), q.device)
    _check("scale", scale, torch.float32, (n, 1), q.device)
    _check("mn", mn, torch.float32, (n, 1), q.device)
    out = torch.empty((n, d), dtype=torch.float32, device=q.device)
    lib = _lib("int8_affine_codec")
    int8_affine_decode.launches += 1
    with torch.cuda.device(q.device):
        _launch(lib, "edgellm_int8_affine_decode", "edgellm_int8_affine_error",
                q.data_ptr(), scale.data_ptr(), mn.data_ptr(), out.data_ptr(), n, d,
                _stream(q.device))
    return out


def _channel_kernel(fn: str, src: torch.Tensor, scale: torch.Tensor, d: int, lanes: int,
                    encode: bool) -> torch.Tensor:
    """Launch one entry point of ``csrc/channel_codec.cu`` with a (1, D)
    float32 scale. Codes pack ``lanes`` to a byte (int8 1, int4 2, ternary
    4): an encode maps (N, D) float32 to (N, D / lanes) codes, a decode the
    reverse."""
    n = src.shape[0]
    _check_rows(n, d, encode=False)
    if d % lanes:
        raise ValueError(f"{fn}: codes pack {lanes} lanes a byte, so D % {lanes} == 0; "
                         f"got D={d}")
    codes = torch.int8 if lanes == 1 else torch.uint8
    src_dtype, out_dtype = (torch.float32, codes) if encode else (codes, torch.float32)
    src_w, out_w = (d, d // lanes) if encode else (d // lanes, d)
    _check("input", src, src_dtype, (n, src_w), src.device)
    _check("scale", scale, torch.float32, (1, d), src.device)
    out = torch.empty((n, out_w), dtype=out_dtype, device=src.device)
    lib = _lib("channel_codec")
    with torch.cuda.device(src.device):
        _launch(lib, fn, "edgellm_channel_codec_error", src.data_ptr(), scale.data_ptr(),
                out.data_ptr(), n, d, _stream(src.device))
    return out


def chan_int8_encode(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K5 encode: (N, D) float32 + (1, D) float32 scale -> (N, D) int8. CUDA
    tensors launch the kernel (``chan_int8_encode.launches``); other tensors
    take :func:`chan_int8_encode_plain`."""
    if x.device.type != "cuda":
        return chan_int8_encode_plain(x, scale)
    chan_int8_encode.launches += 1
    return _channel_kernel("edgellm_chan_int8_encode", x, scale, x.shape[-1], 1, True)


def chan_int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K5 decode: (N, D) int8 + (1, D) float32 scale -> (N, D) float32
    (``chan_int8_decode.launches``; else :func:`chan_int8_decode_plain`)."""
    if q.device.type != "cuda":
        return chan_int8_decode_plain(q, scale)
    chan_int8_decode.launches += 1
    return _channel_kernel("edgellm_chan_int8_decode", q, scale, q.shape[-1], 1, False)


def chan_int4_encode(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K6 encode: (N, D) float32 + (1, D) float32 scale -> (N, D/2) uint8
    (``chan_int4_encode.launches``; else :func:`chan_int4_encode_plain`). Its
    decode is K2 with the (1, D) scale (:func:`int4_decode`)."""
    if x.device.type != "cuda":
        return chan_int4_encode_plain(x, scale)
    chan_int4_encode.launches += 1
    return _channel_kernel("edgellm_chan_int4_encode", x, scale, x.shape[-1], 2, True)


def ternary_encode(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K7 encode: (N, D) float32 + (1, D) float32 scale -> (N, D/4) uint8
    (``ternary_encode.launches``; else :func:`ternary_encode_plain`)."""
    if x.device.type != "cuda":
        return ternary_encode_plain(x, scale)
    ternary_encode.launches += 1
    return _channel_kernel("edgellm_ternary_encode", x, scale, x.shape[-1], 4, True)


def ternary_decode(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K7 decode: (N, D/4) uint8 + (1, D) float32 scale -> (N, D) float32
    (``ternary_decode.launches``; else :func:`ternary_decode_plain`)."""
    if packed.device.type != "cuda":
        return ternary_decode_plain(packed, scale)
    ternary_decode.launches += 1
    return _channel_kernel("edgellm_ternary_decode", packed, scale, 4 * packed.shape[-1], 4,
                           False)


for _kernel in (int4_encode, int4_decode, int8_affine_encode, int8_affine_decode,
                chan_int8_encode, chan_int8_decode, chan_int4_encode, ternary_encode,
                ternary_decode):
    _kernel.launches = 0


# ---------------------------------------------------------------------------
# WireCodec twins
# ---------------------------------------------------------------------------


def pallas_wire_codec() -> WireCodec:
    """``int4_per_token`` backed by K1 / K2: the payload of the plain codec,
    bit for bit, on a float32 hidden (the hidden is cast to float32 first, as
    the reference's twin does)."""

    def encode(h):
        b, s, d = h.shape
        packed, scale = int4_encode(h.reshape(b * s, d).float().contiguous())
        return {"packed": packed.reshape(b, s, d // 2), "scale": scale.reshape(b, s, 1)}

    def decode(p):
        b, s, dh = p["packed"].shape
        out = int4_decode(p["packed"].reshape(b * s, dh), p["scale"].reshape(b * s, 1))
        return out.reshape(b, s, dh * 2)

    return WireCodec("int4_per_token_pallas", encode, decode)


def pallas_int8_per_token() -> WireCodec:
    """``int8_per_token`` backed by K3 / K4."""

    def encode(h):
        b, s, d = h.shape
        q, scale, mn = int8_affine_encode(h.reshape(b * s, d).float().contiguous())
        return {"q": q.reshape(b, s, d), "scale": scale.reshape(b, s, 1),
                "mn": mn.reshape(b, s, 1)}

    def decode(p):
        b, s, d = p["q"].shape
        out = int8_affine_decode(p["q"].reshape(b * s, d), p["scale"].reshape(b * s, 1),
                                 p["mn"].reshape(b * s, 1))
        return out.reshape(b, s, d)

    return WireCodec("int8_per_token_pallas", encode, decode)


def _channel_scale(scale: torch.Tensor) -> torch.Tensor:
    """A (1, 1, D) payload scale as the kernels' (1, D) float32."""
    return scale.reshape(1, -1).float().contiguous()


def pallas_per_channel(bits: int) -> WireCodec:
    """``int8_per_channel`` (K5) / ``int4_per_channel`` (K6 encode, K2 decode)
    with the quantize(+pack) in the kernel; the (B, S) channel abs-max and
    its zero guard are PyTorch ops, in the hidden's dtype, which the payload
    scale keeps (the reference's twin reduces in XLA the same way)."""

    def encode(h):
        b, s, d = h.shape
        cmax = h.abs().amax(dim=(0, 1), keepdim=True)
        safe = torch.where(cmax > 0, cmax, 1.0)
        flat = h.reshape(b * s, d).float().contiguous()
        if bits == 8:
            return {"q": chan_int8_encode(flat, _channel_scale(safe)).reshape(b, s, d),
                    "scale": safe}
        return {"packed": chan_int4_encode(flat, _channel_scale(safe)).reshape(b, s, d // 2),
                "scale": safe}

    def decode(p):
        if bits == 8:
            b, s, d = p["q"].shape
            out = chan_int8_decode(p["q"].reshape(b * s, d), _channel_scale(p["scale"]))
            return out.reshape(b, s, d)
        b, s, dh = p["packed"].shape
        out = int4_decode(p["packed"].reshape(b * s, dh), _channel_scale(p["scale"]))
        return out.reshape(b, s, dh * 2)

    return WireCodec(f"int{bits}_per_channel_pallas", encode, decode, batch_invariant=False)


def pallas_ternary(kind: str) -> WireCodec:
    """``ternary_mean`` / ``ternary_max`` backed by K7; the (B, S) channel
    scale (the mean plus 1e-8, or the abs-max with its zero guard) is
    reduced with PyTorch ops, as the plain codec reduces it."""

    def encode(h):
        b, s, d = h.shape
        if kind == "mean":
            scale = _channel_mean(h) + 1e-8
        else:
            cmax = h.abs().amax(dim=(0, 1), keepdim=True)
            scale = torch.where(cmax > 0, cmax, 1.0)
        packed = ternary_encode(h.reshape(b * s, d).float().contiguous(), _channel_scale(scale))
        return {"packed": packed.reshape(b, s, d // 4), "scale": scale}

    def decode(p):
        b, s, dq = p["packed"].shape
        out = ternary_decode(p["packed"].reshape(b * s, dq), _channel_scale(p["scale"]))
        return out.reshape(b, s, dq * 4)

    return WireCodec(f"ternary_{kind}_pallas", encode, decode, batch_invariant=False)


_PALLAS_FACTORIES = {
    "int4_per_token": pallas_wire_codec,
    "int8_per_token": pallas_int8_per_token,
    "int8_per_channel": lambda: pallas_per_channel(8),
    "int4_per_channel": lambda: pallas_per_channel(4),
    "ternary_mean": lambda: pallas_ternary("mean"),
    "ternary_max": lambda: pallas_ternary("max"),
}

#: The reference has no kernel twin of ``selective_int4`` either, by
#: measurement on the TPU (its note, kept for the record of why the port has
#: none): the codec is gather-bound there, and XLA fuses the int4 quantize
#: into its gather consumers. On this card the codec runs as plain PyTorch.
SELECTIVE_EXCLUSION = (
    "selective_int4 has no kernel twin BY MEASUREMENT (v5e, rounds 4-5): the "
    "codec is gather-bound; XLA fuses the int4 quantize into its gather "
    "consumers, so a pallas_call boundary only breaks that fusion (twin "
    "probed 0.97x roundtrip; split: encode 0.97x, decode 0.99x). In-kernel "
    "gathers lose structurally on TPU: VMEM row copies are sublane-granular, "
    "a one-hot-matmul gather multiplies traffic by k, a scalar-prefetch DMA "
    "gather needs a B*S-step grid. The jnp codec IS the TPU-native path.")


def kernel_twin(base: str) -> WireCodec:
    """The kernel-backed twin of base codec ``base`` (the ``<base>_pallas``
    registry entry), with the plain codecs' pathological-input saturation."""
    return _saturating(_PALLAS_FACTORIES[base]())


def pallas_variant(codec: WireCodec):
    """The kernel-backed twin of a plain wire codec, or None when the codec
    has no kernel twin (identity casts, ``int4_global``,
    ``ternary_per_token``, ``selective_int4``: the reference has none
    either). An explicit ``*_pallas`` codec is returned as it is."""
    if codec.name.endswith("_pallas"):
        return codec
    if codec.name in _PALLAS_FACTORIES:
        return kernel_twin(codec.name)
    return None


__all__ = ["int4_encode", "int4_decode", "int8_affine_encode", "int8_affine_decode",
           "chan_int8_encode", "chan_int8_decode", "chan_int4_encode", "ternary_encode",
           "ternary_decode", "int4_encode_plain", "int4_decode_plain",
           "int8_affine_encode_plain", "int8_affine_decode_plain", "chan_int8_encode_plain",
           "chan_int8_decode_plain", "chan_int4_encode_plain", "ternary_encode_plain",
           "ternary_decode_plain", "pallas_wire_codec", "pallas_int8_per_token",
           "pallas_per_channel", "pallas_ternary", "pallas_variant", "kernel_twin",
           "SELECTIVE_EXCLUSION"]
