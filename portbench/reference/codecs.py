"""The per-token wire codecs of a split hop, as plain round trips in
float32, with the bytes a token's payload takes."""
from __future__ import annotations

import numpy as np
import torch

INV_255 = float(np.float32(1.0 / 255.0))
INV_7 = float(np.float32(1.0 / 7.0))


def int8_per_token(h: torch.Tensor) -> torch.Tensor:
    """Affine int8 a token: scale (max - min) / 255, the zero point mapping
    the minimum to -128; a constant token comes back as its minimum."""
    h = h.float()
    mn = h.amin(dim=-1, keepdim=True)
    mx = h.amax(dim=-1, keepdim=True)
    scale = (mx - mn) * INV_255
    safe = torch.where(scale > 0, scale, 1.0)
    zp = torch.round(-128.0 - mn / safe)
    q = torch.clamp(torch.round(h / safe) + zp, -128, 127)
    return torch.where(scale > 0, (q - zp) * safe, mn)


def int4_per_token(h: torch.Tensor) -> torch.Tensor:
    """Symmetric int4 a token under its max-abs scale."""
    h = h.float()
    mx = h.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(mx > 0, mx, 1.0)
    return torch.round(torch.clamp(h / safe * 7.0, -8.0, 7.0)) * (safe * INV_7)


ROUND_TRIPS = {"int8_per_token": int8_per_token, "int4_per_token": int4_per_token}


def payload_bytes(codec: str, d: int) -> int:
    """Bytes one token's payload takes on the wire: int8 codes and two
    float32 words (scale and minimum), or packed int4 codes and one float32
    scale."""
    return {"int8_per_token": d + 8, "int4_per_token": d // 2 + 4}[codec]
