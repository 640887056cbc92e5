"""Fused boundary hops: quantize -> seal -> transport in one shot (PyTorch
counterpart of the fused-hop half of ``edgellm_tpu/codecs/pallas_kernels.py``).

- ``"wire"`` mode (:func:`fused_wire_hop`): encode, seal, and flatten the
  sealed tree into ONE uint8 buffer (:class:`~.wire_format.WireFormat`),
  copy that buffer to the next stage's device, then slice, verify and
  decode it there. One copy per hop instead of one per payload leaf; on the
  card the codec is the kernel twin, so K3 + K4 (or K1 + K2, K5-K7) run.
- ``"remote"`` mode (:func:`fused_remote_hop`): kernel K8
  (``csrc/remote_hop.cu``, :func:`remote_hop`) quantizes each token row
  with K3's math, writes the sealed ``int8_per_token`` wire buffer with its
  checksum, and receives, verifies and dequantizes it with K4's math, in
  one launch. Its buffer equals the wire mode's byte for byte. The TPU
  kernel remote-DMAs the tiles to the neighbour chip; here both stages
  share one card, and two cards raise (the NVLink peer form is not ported).

Both modes decode exactly the bytes the separate hop would have decoded, so
a fault-free fused hop changes no value, only the dtype flow: the fused hop
returns ``hidden``'s dtype where the separate hop's select promotes a bf16
hidden to float32 (the reference's ``where`` in both).

:func:`fused_hop_plan` is the reference's gate, with the card in the TPU's
place. The port has no probe cache yet, so the default ("auto") never fuses,
as the reference decides off a probed chip; ``EDGELLM_FUSED_HOP`` forces a
mode.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import torch

from . import codec_kernels as ck
from .packing import get_wire_codec, sanitize_hidden
from .wire_format import WireFormat, flatten_bytes, seal_payload, verify_payload

#: base codecs a fused hop can carry: everything with a kernel twin
#: (``selective_int4`` has none, and its importance sidecar makes the
#: payload data-dependent, which a static wire layout can't carry)
FUSED_CAPABLE = frozenset(ck._PALLAS_FACTORIES)

#: base codecs with a single-kernel hop (K8)
REMOTE_CAPABLE = frozenset({"int8_per_token"})


@dataclasses.dataclass(frozen=True)
class FusedHopPlan:
    """One hop's fused-transport decision: ``mode`` ("wire" | "remote"),
    ``base`` (the codec name sans ``_pallas``) and why the gate said yes."""

    mode: str
    base: str
    reason: str


def _fused_base(codec) -> Optional[str]:
    name = getattr(codec, "name", None)
    if name is None:
        return None
    return name[:-len("_pallas")] if name.endswith("_pallas") else name


def fused_hop_plan(codec, *, link_active: bool = False, device=None) -> Optional[FusedHopPlan]:
    """The gating ladder for one hop codec -> a plan, or None (the separate
    encode / copy / decode hop).

    1. ``EDGELLM_FUSED_HOP=0``: off.
    2. An active faulty link owns the hop: refuse.
    3. The base codec must be FUSED_CAPABLE and carry no importance sidecar.
    4. ``EDGELLM_FUSED_HOP=wire|remote`` forces a mode (remote only for a
       REMOTE_CAPABLE base on a CUDA ``device``, the hop's source);
       ``=1`` forces the best available mode.
    5. Default: no fusion. The reference fuses by default only where its
       probe cache measured a win on the chip; the port has no probe cache
       yet, which is the reference's answer for a chip never probed."""
    env = os.environ.get("EDGELLM_FUSED_HOP", "").strip().lower()
    if env == "0" or codec is None or link_active:
        return None
    base = _fused_base(codec)
    if base not in FUSED_CAPABLE or getattr(codec, "needs_importance", False):
        return None
    remote_ok = (device is not None and torch.device(device).type == "cuda"
                 and base in REMOTE_CAPABLE)
    if env in ("wire", "remote"):
        if env == "remote" and not remote_ok:
            return None
        return FusedHopPlan(env, base, f"forced: EDGELLM_FUSED_HOP={env}")
    if env == "1":
        return FusedHopPlan("remote" if remote_ok else "wire", base,
                            "forced: EDGELLM_FUSED_HOP=1")
    return None


_WIRE_FORMATS: dict = {}


def _wire_format(codec, shape, dtype) -> WireFormat:
    key = (codec.name, tuple(shape), dtype)
    if key not in _WIRE_FORMATS:
        _WIRE_FORMATS[key] = WireFormat.for_codec(codec, shape, dtype)
    return _WIRE_FORMATS[key]


def _transport(buf: torch.Tensor, dst) -> torch.Tensor:
    """The one copy of a wire buffer that crosses the cut."""
    return buf.to(dst, copy=True)


def fused_wire_hop(codec, hidden: torch.Tensor, dst) -> torch.Tensor:
    """Fused "wire" hop to device ``dst``: encode, seal, flatten the sealed
    tree to ONE uint8 buffer, copy it, then slice, verify and decode on
    ``dst``. A corrupt arrival keeps ``hidden`` (what a zero-budget faulty
    link delivers); the select runs on the device, with no host sync. The
    result has ``hidden``'s dtype."""
    wf = _wire_format(codec, hidden.shape, hidden.dtype)
    buf = wf.to_wire(seal_payload(codec.encode(hidden)))
    arrived = wf.from_wire(_transport(buf, dst))
    ok = verify_payload(arrived)
    decoded = codec.decode(arrived["p"]).to(hidden.dtype)
    return torch.where(ok, decoded, hidden.to(dst))


# -- remote mode: K8 ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _int8_wire(n: int, d: int) -> WireFormat:
    """K8's layout: the sealed ``int8_per_token`` wire buffer of one (1, N, D)
    float32 hop (canary, crc, then the sorted leaves mn, q, scale)."""
    return WireFormat.for_codec(get_wire_codec("int8_per_token"), (1, n, d))


def remote_hop_nbytes(n: int, d: int) -> int:
    """Bytes of K8's wire buffer for (N, D) float32: 8 + 8 N + N D."""
    return _int8_wire(n, d).wire_nbytes


def _receive_plain(buf: torch.Tensor, n: int, d: int):
    arrived = _int8_wire(n, d).from_wire(buf)
    p = arrived["p"]
    out = ck.int8_affine_decode_plain(p["q"].reshape(n, d), p["scale"].reshape(n, 1),
                                      p["mn"].reshape(n, 1))
    return out, verify_payload(arrived)


def remote_hop_plain(x: torch.Tensor):
    """K8's plain version, the wire path: K3 plain, seal, flatten, then
    unflatten, verify and K4 plain -> (decoded (N, D) float32, ok 0-dim
    bool, buffer (8 + 8 N + N D,) uint8)."""
    q, scale, mn = ck.int8_affine_encode_plain(x)
    buf = flatten_bytes(seal_payload({"q": q, "scale": scale, "mn": mn}))
    out, ok = _receive_plain(buf, *x.shape)
    return out, ok, buf


def _remote_buffers(n: int, d: int, device):
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    ok = torch.empty((1,), dtype=torch.int32, device=device)
    acc = torch.empty((4,), dtype=torch.int32, device=device)  # 3 uint32 accumulators
    return out, ok, acc


def remote_hop(x: torch.Tensor):
    """K8: (N, D) float32 (sanitized) -> (decoded (N, D) float32, ok 0-dim
    bool, the sealed wire buffer (8 + 8 N + N D,) uint8). CUDA tensors
    launch the kernel once per hop (``remote_hop.launches``); other tensors
    take :func:`remote_hop_plain`."""
    if x.device.type != "cuda":
        return remote_hop_plain(x)
    n, d = x.shape
    ck._check_rows(n, d, encode=True)
    ck._check("x", x, torch.float32, (n, d), x.device)
    buf = torch.empty((remote_hop_nbytes(n, d),), dtype=torch.uint8, device=x.device)
    out, ok, acc = _remote_buffers(n, d, x.device)
    lib = ck._lib("remote_hop")
    remote_hop.launches += 1
    with torch.cuda.device(x.device):
        ck._launch(lib, "edgellm_remote_hop", "edgellm_remote_hop_error", x.data_ptr(),
                   buf.data_ptr(), out.data_ptr(), ok.data_ptr(), acc.data_ptr(), n, d,
                   ck._stream(x.device))
    return out, ok[0] != 0, buf


def remote_hop_receive(buf: torch.Tensor, n: int, d: int):
    """K8's receive half alone, over a buffer that has already arrived ->
    (decoded (N, D) float32, ok 0-dim bool): the checksum of the arrived
    bytes against the head, and K4's dequantize. CUDA tensors launch the
    kernel (``remote_hop_receive.launches``); others take the wire path."""
    if buf.device.type != "cuda":
        return _receive_plain(buf, n, d)
    ck._check_rows(n, d, encode=False)
    ck._check("buf", buf, torch.uint8, (remote_hop_nbytes(n, d),), buf.device)
    out, ok, acc = _remote_buffers(n, d, buf.device)
    lib = ck._lib("remote_hop")
    remote_hop_receive.launches += 1
    with torch.cuda.device(buf.device):
        ck._launch(lib, "edgellm_remote_hop_receive", "edgellm_remote_hop_error",
                   buf.data_ptr(), out.data_ptr(), ok.data_ptr(), acc.data_ptr(), n, d,
                   ck._stream(buf.device))
    return out, ok[0] != 0


remote_hop.launches = 0
remote_hop_receive.launches = 0


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device
    return (a.index if a.index is not None else current()) == \
        (b.index if b.index is not None else current())


def fused_remote_hop(codec, hidden: torch.Tensor, dst) -> torch.Tensor:
    """Fused "remote" hop of an ``int8_per_token`` codec: K8 over the
    sanitized float32 activation, the result cast back to ``hidden``'s
    dtype; a failed verify keeps ``hidden``. Source and destination must be
    one device: the two-card form (peer memory over NVLink) is not ported."""
    dst = torch.device(dst)
    if not _same_device(hidden.device, dst):
        raise ValueError(f"two-card remote hop not ported: {hidden.device} -> {dst}")
    b, s, d = hidden.shape
    x = sanitize_hidden(hidden).float().reshape(b * s, d).contiguous()
    out, ok, _ = remote_hop(x)
    return torch.where(ok, out.reshape(b, s, d).to(hidden.dtype), hidden)


def fused_hop(plan: FusedHopPlan, codec, hidden: torch.Tensor, dst) -> torch.Tensor:
    """Dispatch one planned fused hop (``fused_hop_plan`` decided the mode)."""
    if plan.mode == "remote":
        return fused_remote_hop(codec, hidden, dst)
    return fused_wire_hop(codec, hidden, dst)


__all__ = ["FUSED_CAPABLE", "REMOTE_CAPABLE", "FusedHopPlan", "fused_hop_plan",
           "fused_wire_hop", "fused_remote_hop", "fused_hop", "remote_hop",
           "remote_hop_plain", "remote_hop_receive", "remote_hop_nbytes"]
