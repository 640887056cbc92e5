"""Float32 sums in one fixed association order.

Floating-point addition is not associative, so a sum's last bits depend on
the order its terms are added in. The simulated codecs promise bit-exact
outputs against the reference package on the same fp32 input, and two of
them feed a sum into their output: ``channel_1_mean`` (a per-channel mean)
and ``top_rho_mask`` (a cumulative sum compared with a threshold). These
helpers add in the order XLA's CPU backend does for the reference:

- :func:`ordered_sum`: 32-element blocks summed left to right, then the block
  partials the same way, recursively (checked bit-exact against the
  reference for any length that is a multiple of 32, which every window
  length of the repository's configs is);
- :func:`ordered_cumsum`: 16-element blocks scanned left to right, the block
  totals scanned recursively, then each block's exclusive prefix added.

Both are valid sums in any case; only their association is fixed. Each step
is one elementwise add over the other axes, so a (N, S) input costs O(S/16)
small launches on the card.
"""
from __future__ import annotations

import torch


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over axis 0, starting from 0."""
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


def ordered_sum(x: torch.Tensor, dim: int = 0, block: int = 32) -> torch.Tensor:
    """Sum over ``dim`` in 32-element blocks, recursively (see module doc)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > block:
        nb = -(-x.shape[0] // block)
        pad = nb * block - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        x = _seq_sum(x.reshape((nb, block) + tuple(x.shape[1:])).movedim(1, 0))
    return _seq_sum(x)


def ordered_cumsum(x: torch.Tensor, dim: int = -1, block: int = 16) -> torch.Tensor:
    """Inclusive cumulative sum over ``dim`` in 16-element blocks (see module doc)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= block:
        outs, acc = [], torch.zeros_like(x[..., 0])
        for i in range(n):
            acc = acc + x[..., i]
            outs.append(acc)
        return torch.stack(outs, dim=-1).movedim(-1, dim)
    nb = -(-n // block)
    pad = nb * block - n
    xp = torch.cat([x, x.new_zeros(tuple(x.shape[:-1]) + (pad,))], dim=-1) if pad else x
    xp = xp.reshape(tuple(x.shape[:-1]) + (nb, block))
    inblock = ordered_cumsum(xp, dim=-1, block=block)
    totals = ordered_cumsum(inblock[..., -1], dim=-1, block=block)
    excl = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
    out = (inblock + excl[..., None]).reshape(tuple(x.shape[:-1]) + (nb * block,))
    return out[..., :n].movedim(-1, dim)
