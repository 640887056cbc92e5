"""JAX's counter-based sampling randomness, reproduced bit for bit in PyTorch.

The serving stack's per-stream guarantee rests on the reference's PRNG: a
stream's draws depend only on (its seed, the step index), so a stream gives
the same tokens batched, alone, or evicted and resumed. This module computes
what ``jax.random.key`` / ``fold_in`` / ``bits`` / ``categorical`` compute with
the default threefry-2x32 generator in its partitionable bit layout
(``jax_threefry_partitionable=True``, the default of the JAX the reference
runs on), with no stateful ``torch.Generator`` anywhere:

- a key is the pair of uint32 words ``(k1, k2)``; ``key(seed)`` is
  ``(seed >> 32, seed & 0xffffffff)``;
- ``fold_in(key, data)`` is threefry-2x32 of the count pair ``(0, data)``;
- the random bits of element ``i`` of a shape are
  ``x1 ^ x2`` of threefry-2x32 of the counts ``(i >> 32, i & 0xffffffff)``
  (flat index ``i``, so a (1, V) draw equals a (V,) draw);
- ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2),
  minus 1; ``gumbel`` is ``-log(-log(u))`` of a uniform in [tiny, 1);
  ``categorical`` is the argmax of logits plus Gumbel noise.

uint32 arithmetic runs in int64 with 32-bit masks (PyTorch has no unsigned
32-bit arithmetic), as ``codecs/wire_format.py`` does. The bits are exact;
the Gumbel noise goes through ``torch.log``, which may differ from XLA's
``log`` by an ulp, so a sampled token can differ from the reference's only
where two candidates tie to within that.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s two key words for an int32 seed (a
    non-negative one up to 2**32 - 1 too)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is outside the 32-bit range of the reference's keys")
    return (0, seed & _M32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the count words ``x1``, ``x2`` under the
    key words ``k1``, ``k2`` (ints or int64 tensors broadcasting against the
    counts) -> the two output words, int64 tensors in [0, 2**32)."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x = [(x1 + k1) & _M32, (x2 + k2) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` for a batch: keys (N, 2) int64 key words, data
    (N,) non-negative ints -> (N, 2) new key words."""
    zero = torch.zeros_like(data, dtype=torch.int64)
    o1, o2 = threefry2x32(keys[:, 0], keys[:, 1], zero, data.to(torch.int64) & _M32)
    return torch.stack([o1, o2], dim=1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each of the (N, 2) keys ->
    (N, n) int64 in [0, 2**32)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    o1, o2 = threefry2x32(keys[:, :1], keys[:, 1:], i >> 32, i & _M32)
    return o1 ^ o2


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for each of the (N, 2) keys -> (N,
    num, 2): in the partitionable layout key j is threefry-2x32 of the
    count pair ``(0, j)``, i.e. ``fold_in(key, j)``."""
    j = torch.arange(num, dtype=torch.int64, device=keys.device)[None, :]
    o1, o2 = threefry2x32(keys[:, :1], keys[:, 1:], j >> 32, j & _M32)
    return torch.stack([o1, o2], dim=-1)


_ONE_BITS = int(np.array(1.0, np.float32).view(np.uint32))
_TINY = float(np.finfo(np.float32).tiny)


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` for each key -> (N, n) float32 in
    [0, 1): the top 23 random bits as the mantissa of a float in [1, 2),
    minus 1. Element 0 is the draw of a shape-() ``uniform(key)``."""
    bits = (random_bits(keys, n) >> 9) | _ONE_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(keys: torch.Tensor, p: float, n: int) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (n,))`` for each key -> (N, n) bool:
    a float32 uniform draw below ``p`` (rounded to float32, as the
    reference's weakly typed ``p`` is); a multi-dimensional shape is its
    flat (row-major) draw."""
    return uniform(keys, n) < torch.tensor(p, dtype=torch.float32, device=keys.device)


def randint(keys: torch.Tensor, n: int, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` (int32) for each key
    -> (N, n) int64 values in [minval, maxval): JAX's ``_randint``, which
    splits the key, draws a high and a low 32-bit word per element and
    reduces ``(hi % span) * (2**32 % span) + lo % span`` modulo the span in
    uint32 arithmetic (for a power-of-two span the high word drops out)."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError(f"randint range [{minval}, {maxval}) is outside int32")
    span = maxval - minval if maxval > minval else 1  # an empty range gives minval
    k = split(keys)
    lo = random_bits(k[:, 1], n) % span
    mult = ((((1 << 16) % span) ** 2) & _M32) % span  # the uint32 product wraps
    if mult:
        hi = random_bits(k[:, 0], n) % span
        lo = ((hi * mult) & _M32) + lo
    off = (lo & _M32) % span
    return ((minval + off + 2 ** 31) & _M32) - 2 ** 31


def uniform_tiny(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1.0)`` for each
    key -> (N, n) float32, the draw ``jax.random.gumbel`` makes."""
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=keys.device)
    # floats * (maxval - minval) + minval, with maxval - minval == 1.0 in fp32
    return torch.maximum(tiny, uniform(keys, n) + tiny)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over (N, V) float32 logits -> (N,) int64
    token ids, the argmax of the logits plus Gumbel noise. With (N, 2) keys
    row i draws from key i (the batcher's per-slot keys); with one (1, 2)
    key the noise is one draw over the flat (N, V) shape, as
    ``categorical(key, logits)`` with (N, V) logits draws it. (V,) logits
    with one key give a 0-dim id, the draw of (1, V); ``-inf`` logits are
    never drawn."""
    if logits.dim() == 1:
        return categorical(keys, logits[None])[0]
    n, v = logits.shape
    if keys.shape[0] == n:
        u = uniform_tiny(keys, v)
    elif keys.shape[0] == 1:
        u = uniform_tiny(keys, n * v).reshape(n, v)
    else:
        raise ValueError(f"{keys.shape[0]} keys for {n} rows of logits")
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1)


__all__ = ["key", "threefry2x32", "fold_in", "split", "random_bits", "uniform", "bernoulli",
           "randint", "uniform_tiny", "categorical"]
