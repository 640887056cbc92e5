"""Simulated (quantize -> dequantize in floating point) boundary codecs
(PyTorch counterpart of ``edgellm_tpu/codecs/simulate.py``).

Bit-exact with the reference package on the same fp32 input: the same
operations in the same order (divide, then multiply by the level count;
round half to even; a float32 reciprocal of 255 for the affine scale), stable
sorts for every ranking, and the reduction order of ``utils.ordered`` where a
sum reaches the output.

- token-selective symmetric int4 over the ``ratio`` least-important tokens,
  one global max-abs scale over the whole selected slice;
- per-token affine int8;
- per-channel symmetric 8/4-bit and ternary mean/max codecs;
- top-rho importance-mass token selection.

Each function takes the reference's shapes: hidden (B, S, D) with a token
mask or importance over S. The ``*_windows`` forms take N independent
windows at once, each with its own scales, which is what the sweep's
per-window quantization means.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.ordered import ordered_cumsum, ordered_sum

CHANNEL_METHODS = ("channel_8", "channel_4", "channel_1_mean", "channel_1_max")

_INV_255 = np.float32(1.0 / 255.0)


def token_select_mask(importance: torch.Tensor, ratio, seq_len: int,
                      k=None) -> torch.Tensor:
    """Boolean mask over the last axis marking the ``int(ratio * seq_len)``
    least-important tokens: rank every position by a stable ascending sort
    (ties break by position) and mark ranks < k. ``importance`` is (S,) or
    (N, S). Pass ``k`` computed as ``int(float(ratio) * seq_len)`` in Python
    float64 whenever the ratio is known on the host (the reference truncates
    the float64 product)."""
    order = torch.argsort(importance, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    if k is None:
        if isinstance(ratio, (int, float)):
            k = int(float(ratio) * seq_len)
        else:
            k = torch.floor(ratio * seq_len).to(torch.int64)
    return rank < k


def top_rho_mask(distribution: torch.Tensor, threshold) -> torch.Tensor:
    """Mask of tokens to QUANTIZE under the "upto ratio" (top-rho) scheme: a
    token is kept iff the exclusive prefix sum of the descending-sorted
    distribution at its position is still below ``threshold``. (S,) or
    (N, S)."""
    order = torch.argsort(-distribution, dim=-1, stable=True)
    sorted_vals = torch.gather(distribution, -1, order)
    excl_cumsum = ordered_cumsum(sorted_vals, dim=-1) - sorted_vals
    quantize_sorted = excl_cumsum >= threshold
    return torch.zeros_like(quantize_sorted).scatter(-1, order, quantize_sorted)


def _masked_symmetric_windows(hidden: torch.Tensor, mask: torch.Tensor,
                              bits: int) -> torch.Tensor:
    """Symmetric fake-quant of masked tokens, one scale per window: hidden
    (N, B, S, D), mask (N, S). Window n's scale is the max |value| over its
    selected slice (all of its B rows, all channels)."""
    qmax = 2 ** (bits - 1) - 1
    qmin = -(2 ** (bits - 1))
    m = mask[:, None, :, None]
    max_val = torch.where(m, hidden.abs(), 0.0).amax(dim=(1, 2, 3), keepdim=True)
    max_val = torch.where(max_val > 0, max_val, 1.0)  # mask empty / all-zero: no-op
    scaled = torch.clamp(hidden / max_val * qmax, qmin, qmax)
    deq = torch.round(scaled) / qmax * max_val
    return torch.where(m, deq, hidden)


def _masked_symmetric(hidden: torch.Tensor, mask: torch.Tensor, bits: int) -> torch.Tensor:
    """hidden (B, S, D), mask (S,): one global scale over the selected slice."""
    return _masked_symmetric_windows(hidden[None], mask[None], bits)[0]


def int4_token_select(hidden: torch.Tensor, importance: torch.Tensor, ratio,
                      k=None) -> torch.Tensor:
    """The reference's headline codec: symmetric int4 on the least-important
    tokens. hidden (B, S, D), importance (S,)."""
    mask = token_select_mask(importance, ratio, hidden.shape[1], k=k)
    return _masked_symmetric(hidden, mask, bits=4)


def int4_token_select_windows(hidden: torch.Tensor, importance: torch.Tensor,
                              ratio, k=None) -> torch.Tensor:
    """:func:`int4_token_select` of N windows at once: hidden (N, S, D),
    importance (N, S), each window with its own scale."""
    mask = token_select_mask(importance, ratio, hidden.shape[1], k=k)
    return _masked_symmetric_windows(hidden[:, None], mask, bits=4)[:, 0]


def simulate_symmetric(hidden: torch.Tensor, mask: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Generic masked symmetric fake-quant (int2..int8) with global max-abs scale."""
    return _masked_symmetric(hidden, mask, bits)


def per_token_affine_int8(hidden: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-token affine int8: scale = (max - min) * f32(1/255), zero point
    mapping min to -128, q = clamp(round(x / scale) + zp, -128, 127).
    ``mask`` is (S,) shared by every row, or (B, S). The scale is float32
    whatever hidden's dtype, so the result is float32 (as in the reference,
    where the float32 scale promotes the result)."""
    mn = hidden.amin(dim=-1, keepdim=True)
    mx = hidden.amax(dim=-1, keepdim=True)
    inv255 = torch.tensor(_INV_255, device=hidden.device)
    scale = (mx - mn).float() * inv255
    safe_scale = torch.where(scale > 0, scale, 1.0)
    zp = torch.round(-128.0 - mn.float() / safe_scale)
    hf = hidden.float()
    q = torch.clamp(torch.round(hf / safe_scale) + zp, -128, 127)
    deq = torch.where(scale > 0, (q - zp) * safe_scale, hf)
    if mask is None:
        return deq
    m = mask[None, :, None] if mask.dim() == 1 else mask[:, :, None]
    return torch.where(m, deq, hf)


def _channel_quant_windows(hidden: torch.Tensor, method: str) -> torch.Tensor:
    """Per-channel codecs of N windows: hidden (N, B, S, D), scales over each
    window's (B, S) slice."""
    if method not in CHANNEL_METHODS:
        raise ValueError(f"unknown channel method {method!r}; options: {CHANNEL_METHODS}")
    if method == "channel_1_mean":
        n, b, s, d = hidden.shape
        tot = ordered_sum(hidden.float().reshape(n, b * s, d), dim=1)
        mean = (tot * torch.tensor(np.float32(1.0 / (b * s)), device=hidden.device))
        scale = mean.to(hidden.dtype)[:, None, None, :] + 1e-8
        q = torch.clamp(torch.round(hidden / scale), -1, 1)
        return q * scale
    cmax = hidden.abs().amax(dim=(1, 2), keepdim=True)
    safe = torch.where(cmax > 0, cmax, 1.0)
    if method in ("channel_8", "channel_4"):
        max_levels = 127.0 if method == "channel_8" else 7.0
        q = torch.round(hidden / safe * max_levels)
        return torch.where(cmax > 0, q * safe / max_levels, hidden)
    q = torch.clamp(torch.round(hidden / safe), -1, 1)  # channel_1_max
    return torch.where(cmax > 0, q * safe, hidden)


def channel_wise_quant(hidden: torch.Tensor, method: str) -> torch.Tensor:
    """Per-channel boundary codecs, scales per channel over the (batch, seq)
    slice of hidden (B, S, D):

    - ``channel_8`` / ``channel_4``: symmetric max-abs, round to +/-127 / +/-7;
    - ``channel_1_mean``: scale = signed mean + 1e-8, round, clamp to {-1, 0, 1};
    - ``channel_1_max``: the same with the max-abs scale.
    """
    return _channel_quant_windows(hidden[None], method)[0]


def channel_wise_quant_windows(hidden: torch.Tensor, method: str) -> torch.Tensor:
    """:func:`channel_wise_quant` of N windows (N, S, D), each with its own
    channel scales."""
    return _channel_quant_windows(hidden[:, None], method)[:, 0]
