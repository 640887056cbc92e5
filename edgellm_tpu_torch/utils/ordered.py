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
  totals scanned recursively, then each block's exclusive prefix added;
- :func:`xla_row_sum`: the order of a jitted row reduce that XLA fuses with
  its producer (``ternary_mean``'s channel mean), read from the compiled HLO
  and the emitted LLVM IR: above 32 rows the reduce becomes a ``reduce-window``
  of 32 padded *symmetrically* (``pad=8_8`` at 48 rows, ``14_14`` at 100),
  each window summed row by row, then the window partials row by row; at
  exactly 32 rows LLVM vectorizes the row loop (8 lanes x 4 interleaved
  parts, then a halving tree over the lanes); below 32 rows it sums row by
  row.

All are valid sums in any case; only their association is fixed. Each step
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


def _vector_tree_32(x: torch.Tensor) -> torch.Tensor:
    """32 rows as LLVM's reassociating loop vectorizer adds them: four
    8-row parts combined ((p1 + p0) + p2) + p3, then the 8 lanes halved
    4 -> 2 -> 1."""
    p = x.reshape((4, 8) + tuple(x.shape[1:]))
    v = p[3] + ((p[1] + p[0]) + p[2])
    v = v[:4] + v[4:]
    v = v[:2] + v[2:]
    return v[0] + v[1]


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over dim 0 in the order XLA's CPU backend compiles a
    fused row reduce (see module doc; the 32-row vector tree was read at
    widths of 64 and more, the widths the codecs see)."""
    s = x.shape[0]
    if s == 32:
        return _vector_tree_32(x)
    if s < 32:
        return _seq_sum(x)
    nb = -(-s // 32)
    pad = nb * 32 - s
    lo = pad // 2
    if pad:
        zeros = lambda n: x.new_zeros((n,) + tuple(x.shape[1:]))
        x = torch.cat([zeros(lo), x, zeros(pad - lo)])
    parts = _seq_sum(x.reshape((nb, 32) + tuple(x.shape[1:])).movedim(1, 0))
    return _seq_sum(parts) if nb <= 32 else xla_row_sum(parts)


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
