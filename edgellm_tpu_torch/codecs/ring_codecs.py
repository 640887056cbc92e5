"""Sequence-sharded (ring) variants of the token-selective boundary codec
(PyTorch counterpart of ``edgellm_tpu/codecs/ring_codecs.py``).

Under the stage x seq runtime (``parallel/ring.py``) no shard holds the
whole sequence at a cut, so the token selection and the int4 scale must be
agreed across the ``n_seq`` shards. The reference runs the encode inside
``shard_map`` with two small collectives (an ``all_gather`` of the
importance scalars, a ``pmax`` of the scale); here the shards of one stage
run in turn on one device, so a ring codec's ``encode`` takes the list of
every shard's (B, S_loc, D) hidden and (S_loc,) / (B, S_loc) importance and
returns the list of their payloads, each leaf for leaf what the reference
device of that shard holds. ``decode`` is shard-local, one payload at a
time, as in the reference.

- ``mode="global"``: the reference's exact semantics. The importance shards
  are concatenated (the all_gather) and every shard takes the same stable
  argsort as the dense ``selective_int4``; the scale is the max over the
  shards' maxima of the selected tokens (the pmax). Decoded values equal the
  dense codec's bit for bit given the same importance. The selected count
  per shard depends on the data, so the low buffer is capacity-padded to
  ``min(S_loc, k)`` slots and the high tokens ship in place (a full
  ``S_loc``-token buffer): more bytes than an all-``high`` hop.
- ``mode="local"``: each shard selects its own ``int(ratio * S_loc)``
  least important tokens through the dense codec (``selective_int4``'s
  ``scale_fn`` hook), with the scale agreed over the shards, so every shard
  quantizes on one grid and the per-shard payloads are the dense codec's
  bytes per token. The selected set may differ from the dense argsort's
  (``tools/ring_mode_gap.py`` measures the NLL gap).

Payload bytes are analytic (``payload_bytes_fn``), as in the reference:
an encode over a list of shards cannot run on meta tensors of one shape.
"""
from __future__ import annotations

import dataclasses

import torch

from .packing import (SATURATE_MAG, WireCodec, _HIGH_DTYPES, _quant_pack, _unpack_dequant,
                      sanitize_hidden, select_low, selective_int4)


@dataclasses.dataclass(frozen=True)
class RingWireCodec(WireCodec):
    """A wire codec whose ``encode(shards, importance_shards)`` agrees across
    the ``n_seq`` sequence shards of one stage and returns one payload per
    shard; ``decode(payload)`` is shard-local."""

    n_seq: int = 1
    #: (full_hidden_shape, per_row) -> total payload bytes across all shards
    payload_bytes_fn: object = None

    def payload_bytes(self, hidden_shape, dtype=torch.float32, per_row: bool = True) -> int:
        """``per_row`` picks the wire format accounted: per-row (B, S)
        importance carries a (B,) scale and (B, c_low) int16 indices per
        shard, shared (S,) importance a (1,) scale and (c_low,) indices.
        ``SplitRingRuntime`` forces per-row whenever batch > 1, and at batch
        1 the two formats are the same size, so the default matches what
        crosses the hop."""
        return int(self.payload_bytes_fn(hidden_shape, per_row))


def _global_scale(lows: list, nonempty: bool, per_row: bool) -> torch.Tensor:
    """max|selected| on each shard, then the max over the shards (the
    reference's pmax) = the global max, with the dense codec's zero / empty
    guard applied after the reduction."""
    dev = lows[0].device
    if per_row:
        local = [low.abs().amax(dim=(1, 2)) if nonempty
                 else torch.zeros((low.shape[0],), dtype=torch.float32, device=dev)
                 for low in lows]
    else:
        local = [low.abs().amax() if nonempty
                 else torch.zeros((), dtype=torch.float32, device=dev) for low in lows]
    mx = torch.stack(local).amax(dim=0)
    return torch.where(mx > 0, mx, 1.0)


def _first_true(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` along the last axis:
    the first ``size`` positions where ``mask`` holds, ascending, padded with
    ``fill``."""
    pos = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)[..., :size]
    slot = torch.arange(size, device=mask.device)
    return torch.where(slot < mask.sum(dim=-1, keepdim=True), pos, fill)


def _saturating_ring(codec: RingWireCodec, max_mag: float) -> RingWireCodec:
    """The dense codecs' pathological-input saturation, shard by shard."""
    enc = codec.encode

    def wrapped(shards, importance):
        return enc([sanitize_hidden(h, max_mag) for h in shards], importance)

    return dataclasses.replace(codec, encode=wrapped)


def ring_selective_int4(ratio: float, high: str = "bf16", *, n_seq: int,
                        mode: str = "global") -> RingWireCodec:
    """Build the ring-sharded token-selective codec (see the module note)."""
    if not 0.0 <= ratio <= 1.0:
        raise ValueError(f"ratio must be in [0, 1], got {ratio}")
    if mode not in ("global", "local"):
        raise ValueError(f"mode must be 'global' or 'local', got {mode!r}")
    if n_seq < 1:
        raise ValueError(f"n_seq must be >= 1, got {n_seq}")
    high_dtype = _HIGH_DTYPES[high]
    high_bytes = torch.finfo(high_dtype).bits // 8

    # ---------- mode="global": exact dense selection ----------

    def encode_global(shards, imps):
        b, s_loc, d = shards[0].shape
        s = s_loc * n_seq
        if s > 32767:
            raise ValueError(f"selective_int4 int16 side channel needs "
                             f"S <= 32767, got {s}")
        k = int(ratio * s)  # the same float64 truncation as the dense codec
        c_low = min(s_loc, k)
        per_row = imps[0].dim() == 2
        dev = shards[0].device
        # the all_gather: every shard sorts the whole importance vector
        imp_full = torch.cat(list(imps), dim=-1)
        order = torch.argsort(imp_full, dim=-1, stable=True)
        full_mask = torch.zeros(imp_full.shape, dtype=torch.bool, device=dev)
        if k > 0:
            full_mask.scatter_(-1, order[..., :k], True)
        sel = []  # (low_idx, low) per shard; empty slots point past the shard
        for i, h in enumerate(shards):
            mask_loc = full_mask[..., i * s_loc:(i + 1) * s_loc]
            low_idx = _first_true(mask_loc, c_low, s_loc)  # (B, c_low) or (c_low,)
            take = torch.clamp(low_idx, max=s_loc - 1)
            if per_row:
                rows = torch.arange(b, device=dev)[:, None]
                low = torch.where((low_idx < s_loc)[..., None], h[rows, take], 0.0)
            else:
                low = torch.where((low_idx < s_loc)[None, :, None], h.index_select(1, take),
                                  0.0)
            sel.append((low_idx, low))
        safe = _global_scale([low for _, low in sel], k > 0, per_row)  # the pmax
        out = []
        for h, (low_idx, low) in zip(shards, sel):
            if c_low:
                packed = _quant_pack(low, safe[:, None, None] if per_row else safe)
            else:
                packed = torch.zeros((b, 0, d // 2), dtype=torch.uint8, device=dev)
            out.append({"low": packed, "scale": safe if per_row else safe[None],
                        "high": h.to(high_dtype),  # in place; low slots overwritten
                        "idx": low_idx.to(torch.int16)})
        return out

    def decode_global(p):
        high_t = p["high"]
        b, s_loc, d = high_t.shape
        if not p["low"].shape[1]:
            return high_t.float()
        idx = p["idx"].long()
        scale = p["scale"]
        # one spill row at s_loc takes the empty capacity slots (the
        # reference scatters them with mode="drop")
        out = torch.cat([high_t.float(), high_t.new_zeros((b, 1, d), dtype=torch.float32)],
                        dim=1)
        if scale.dim() == 1 and scale.shape[0] == b and idx.dim() == 2:  # per row
            low = _unpack_dequant(p["low"], scale[:, None, None])
            out[torch.arange(b, device=idx.device)[:, None], idx] = low
        else:
            out[:, idx] = _unpack_dequant(p["low"], scale[0])
        return out[:, :s_loc]

    # ---------- mode="local": shard-local selection, agreed scale ----------
    # the dense codec applied to each shard (its encode sees the local
    # sequence, so k is int(ratio * S_loc)), with only the scale reduction
    # swapped for the one the shards agree on: one wire format, no drift

    def encode_local(shards, imps):
        k_loc = int(ratio * shards[0].shape[1])
        per_row = imps[0].dim() == 2
        lows = [select_low(h, imp, k_loc)[1] for h, imp in zip(shards, imps)]
        agreed = _global_scale(lows, k_loc > 0, per_row)
        base = selective_int4(ratio, high, scale_fn=lambda low, nonempty, per_row: agreed)
        return [base.encode(h, imp) for h, imp in zip(shards, imps)]

    local_decode = selective_int4(ratio, high).decode

    def payload_bytes_fn(hidden_shape, per_row=True):
        """Total bytes across all n_seq shard payloads for one full (B, S, D)
        boundary activation. Per-row importance ships a (B,) scale and (B,
        c_low) int16 indices a shard, shared importance a (1,) scale and
        (c_low,) indices."""
        b, s, d = hidden_shape
        s_loc = s // n_seq
        rows = b if per_row else 1
        if mode == "global":
            c_low = min(s_loc, int(ratio * s))
            per_shard = (b * c_low * (d // 2)           # packed int4 capacity
                         + b * s_loc * d * high_bytes   # in-place high buffer
                         + rows * c_low * 2             # int16 local indices
                         + rows * 4)                    # fp32 scale
        else:
            k_loc = int(ratio * s_loc)
            per_shard = (b * k_loc * (d // 2) + b * (s_loc - k_loc) * d * high_bytes
                         + rows * k_loc * 2 + rows * 4)
        return n_seq * per_shard

    return _saturating_ring(RingWireCodec(
        name=f"ring_selective_int4_r{ratio}_{high}_{mode}",
        encode=encode_global if mode == "global" else encode_local,
        decode=decode_global if mode == "global" else local_decode,
        batch_invariant=False, needs_importance=True,
        n_seq=n_seq, payload_bytes_fn=payload_bytes_fn),
        min(SATURATE_MAG, float(torch.finfo(high_dtype).max)))


__all__ = ["RingWireCodec", "ring_selective_int4"]
