"""fp32 K-stats' column pass, its arithmetic emulated on the CPU, against the
JAX reference.

The card's fp32 column pass (``csrc/attention_stats.cu``, ``attn_col_tf32``)
computes S^T = K q^T on the tensor cores as 3xTF32 products in fp32
K-attn's term order: every operand x becomes hi = tf32(x) and lo = tf32(x -
hi) (``cvt.rna``: to nearest, ties away from zero), and k.q = k_hi.q_lo +
k_lo.q_hi + k_hi.q_hi, the small terms first. Then p = exp(s * scale - lse)
with the row log-sum-exp of the forward (the kernel: ex2.approx of
fmaf(s, scale, -lse) * log2 e, within 2e-8 of exp), and each key's column sum
runs in a fixed order: the lane t (of the 4 that hold a key's accumulator
row) sums the queries q with q % 8 in {2t, 2t + 1} in ascending order, and
the four lanes combine as (l0 + l1) + (l2 + l3); col = sum * f32(1 / S).
That order does not depend on the query tile, 64 rows at hd 64 and 32 at
hd 128. The emulation below repeats that arithmetic in torch (products of
TF32 values are exact in fp32; the dot products run in another order than
the tensor cores', ~1e-7 apart) and is held to the reference's
``_attn_packed_stats`` / ``_attn_blocked_stats`` (their Pallas kernels in
interpret mode, as tests/test_flash_attention.py runs them on the CPU)
within chip_smoke.py's STATS_TOL, atol 1e-5 (the probabilities lie in [0,
1]): this shows without a card that the column pass's 3xTF32 scores, read
against the LSE of the same scores, meet it, at unit-variance inputs and at
inputs scaled until |s / sqrt(hd)| reaches 30, where p of a row's top key
is near 1. Each emulated last row sums to 1 within 1e-4. The emulation is a
test aid and lives only here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgellm_tpu.models import flash_attention as jfa
from edgellm_tpu_torch.models import flash_attention as tfa

#: chip_smoke.py's kernel-vs-plain tolerance of the stats, (atol, rtol)
STATS_TOL = dict(atol=1e-5, rtol=0)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32``: half of the last kept bit added
    to the magnitude, then the 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _emulate_col(q: torch.Tensor, k: torch.Tensor):
    """fp32 K-stats' column pass as the kernel computes it, from (B, S, H,
    hd) q and (B, S, KV, hd) k -> (col_mean, last_row) each (B, H, S), and
    the LSE it read (of the same 3xTF32 scores)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    kh = k.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)  # (B, H, S keys, hd)
    qh = q.permute(0, 2, 3, 1)                                # (B, H, hd, S queries)
    k_hi, k_lo = _split(kh)
    q_hi, q_lo = _split(qh)
    st = k_hi @ q_lo + k_lo @ q_hi + k_hi @ q_hi  # (B, H, key, query)
    scale = np.float32(1.0 / np.sqrt(np.float32(hd)))
    visible = torch.arange(s)[:, None] <= torch.arange(s)[None, :]  # key <= query
    # the forward's row LSE over the same scores: max * scale + log(sum)
    sq = torch.where(visible, st, -torch.inf)
    m = sq.amax(dim=2)  # (B, H, query)
    lse = m * scale + torch.log(torch.exp(sq * scale - (m * scale)[:, :, None, :]).sum(dim=2))
    # the exponent fmaf(s, scale, -lse): the product exact in float64, one rounding
    arg = (st.double() * float(scale) - lse.double()[:, :, None, :]).float()
    p = torch.where(visible, torch.exp(arg), torch.zeros(()))
    lanes = torch.zeros((4, b, h, s), dtype=torch.float32)
    for query in range(s):  # lane t holds queries 8j + 2t + e, summed in order
        t = (query % 8) // 2
        lanes[t] = lanes[t] + p[..., query]
    col = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) * np.float32(1.0 / s)
    return col, p[..., s - 1], lse


def _inputs(seed, b, s, h, kv, hd, top=None):
    """numpy q, k from a seed; with ``top`` both scaled so that the largest
    visible |q.k| / sqrt(hd) is ``top``."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, hd))
    k = rng.normal(size=(b, s, kv, hd))
    if top is not None:
        kr = np.repeat(k, h // kv, axis=2)
        sc = np.einsum("bqhd,bthd->bhqt", q, kr) / np.sqrt(hd)
        peak = np.abs(np.where(np.tri(s, dtype=bool), sc, 0.0)).max()
        q, k = q * np.sqrt(top / peak), k * np.sqrt(top / peak)
    return q.astype(np.float32), k.astype(np.float32)


def _reference(q, k, plan=None):
    """The reference's stats kernel (interpret mode) -> (col, last)."""
    b, s, h, hd = q.shape
    v = np.zeros_like(k)
    if plan is None:
        _, (col, last) = jfa.causal_attention_stats(jnp.asarray(q), jnp.asarray(k),
                                                    jnp.asarray(v), interpret=True)
        return np.asarray(col), np.asarray(last)
    args = (jnp.asarray(q.reshape(b, s, h * hd)), jnp.asarray(np.transpose(k, (0, 2, 1, 3))),
            jnp.asarray(np.transpose(v, (0, 2, 1, 3))))
    _, col, last = jfa._attn_blocked_stats(*args, hd=hd, qb=plan[0], hps=plan[1],
                                           interpret=True)
    return np.asarray(col), np.asarray(last)


def _check(q, k, plan=None):
    col, last, _ = _emulate_col(torch.from_numpy(q), torch.from_numpy(k))
    want_col, want_last = _reference(q, k, plan)
    np.testing.assert_allclose(col.numpy(), want_col, **STATS_TOL)
    np.testing.assert_allclose(last.numpy(), want_last, **STATS_TOL)
    np.testing.assert_allclose(last.sum(dim=-1).numpy(), 1.0, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 130])
@pytest.mark.parametrize("h,kv", [(2, 1), (4, 2)])
def test_column_pass_emulation_matches_reference(h, kv, s, hd):
    q, k = _inputs(s + 7 * h + hd, 1, s, h, kv, hd)
    _check(q, k)


@pytest.mark.parametrize("s,hd", [(65, 64), (130, 64), (63, 128), (130, 128)])
def test_column_pass_emulation_at_scaled_scores(s, hd):
    """|s / sqrt(hd)| up to 30: rows whose top key takes p near 1, as the
    attention sinks of real checkpoints do (N(0, 0.02) random weights never
    give them)."""
    q, k = _inputs(s + hd, 1, s, 4, 2, hd, top=30.0)
    col, last, lse = _emulate_col(torch.from_numpy(q), torch.from_numpy(k))
    assert float(last.max()) > 0.5  # the last row is peaked
    _check(q, k)


@pytest.mark.parametrize("hd,qb,hps", [(64, 64, 4), (128, 64, 2)])
def test_column_pass_emulation_matches_blocked_reference(hd, qb, hps):
    q, k = _inputs(hd + qb, 2, 128, 4, 2, hd)
    _check(q, k, plan=(qb, hps))


@pytest.mark.parametrize("s", [65, 130])
@pytest.mark.parametrize("h,kv,hd", [(14, 2, 64), (12, 2, 128), (8, 8, 64)])
def test_column_pass_emulation_at_model_head_ratios(h, kv, hd, s):
    """The sweeps' head layouts: Qwen2-0.5B (7 query heads a KV head, hd 64),
    Qwen2-1.5B (6, hd 128) and Pythia-70M (no GQA); a block of the column
    pass owns one query head, reading K of that head's KV head."""
    q, k = _inputs(s + h + hd, 1, s, h, kv, hd)
    _check(q, k)
