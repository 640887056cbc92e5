"""fp32 K-attn's arithmetic, emulated on the CPU, against the JAX reference.

The card's fp32 body (``csrc/causal_attention.cu``, ``attn_fwd_tf32``) runs
both products on the tensor cores as 3xTF32 splits: every operand x becomes
hi = tf32(x) and lo = tf32(x - hi), rounded as ``cvt.rna`` rounds (to
nearest, ties away from zero, on the 13 dropped mantissa bits), and a.b =
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi. Its rows are the query heads of a GQA
group packed position-major, and the key range of a long row tile is cut
into splits (``attn_split_plan``) whose softmax states a second kernel
merges; p = exp(score * scale - row max * scale), as the reference's
softmax. The emulation below repeats that arithmetic in torch (products of
TF32 values are exact in fp32; the sums run in another order than the
kernel's, ~1e-7 apart) and is held to the reference's fp32
``causal_attention`` (its Pallas kernel in interpret mode) within the fp32
tolerance of the card checks, atol/rtol 2e-5: this shows without a card that
3xTF32 products meet it. The emulation is a test aid and lives only here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgellm_tpu.models import flash_attention as jfa
from edgellm_tpu_torch.models import flash_attention as tfa

OUT_TOL = dict(atol=2e-5, rtol=2e-5)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32``: half of the last kept bit added
    to the magnitude, then the 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b by the 3xTF32 split, the small terms first."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _emulate_kernel(q, k, v, sms=tfa.H100_SMS):
    """fp32 K-attn as the kernel computes it -> (out (B, S, H, hd), row LSE
    (B, H, S), splits)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep, n_rows = h // kv, s * h // kv
    rows, keys, _ = tile = tfa.ATTN_F32_TILES[hd]
    splits, per = tfa.attn_split_plan(b, s, h, kv, sms, tile)
    scale = np.float32(1.0 / np.sqrt(hd))
    # (B, KV, S * rep, hd): row f is position f // rep of head g * rep + f % rep
    qp = q.reshape(b, s, kv, rep, hd).permute(0, 2, 1, 3, 4).reshape(b, kv, n_rows, hd)
    kt, vt = k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3)  # (B, KV, hd, S), (B, KV, S, hd)
    scores = _mm3(qp, kt)
    visible = torch.arange(s)[None, :] <= (torch.arange(n_rows) // rep)[:, None]
    out = torch.empty_like(qp)
    lse = torch.empty(b, kv, n_rows)
    for r0 in range(0, n_rows, rows):
        r1 = min(n_rows, r0 + rows)
        n_kt = (min(n_rows - 1, r0 + rows - 1) // rep) // keys + 1
        parts = []
        for sp in range(-(-n_kt // per)):
            k0, k1 = sp * per * keys, min(s, min(n_kt, (sp + 1) * per) * keys)
            x = torch.where(visible[r0:r1, k0:k1], scores[..., r0:r1, k0:k1], -torch.inf)
            m = x.amax(dim=-1)
            bias = torch.where(torch.isinf(m), 0.0, m * scale)
            p = torch.exp(x * scale - bias[..., None])
            parts.append((m, p.sum(dim=-1), _mm3(p, vt[..., k0:k1, :])))
        big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l_sum, acc = 0.0, 0.0
        for m, l_sp, acc_sp in parts:  # in split order (one split: weight 1)
            w = torch.exp(m * scale - big * scale)
            l_sum = l_sum + l_sp * w
            acc = acc + acc_sp * w[..., None]
        out[..., r0:r1, :] = acc / l_sum[..., None]
        lse[..., r0:r1] = big * scale + torch.log(l_sum)
    out = out.reshape(b, kv, s, rep, hd).permute(0, 2, 1, 3, 4).reshape(b, s, h, hd)
    lse = lse.reshape(b, kv, s, rep).permute(0, 1, 3, 2).reshape(b, h, s)
    return out, lse, splits


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 3 * ulp / 2,
                      1.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 1.0, 0.0])
    assert torch.equal(_tf32_rna(x), want)
    hi, lo = _split(torch.tensor([np.pi], dtype=torch.float32))
    assert abs((hi + lo).item() - np.float32(np.pi)) <= 2.0 ** -22 * np.pi


@pytest.mark.parametrize("b,s,h,kv,hd", [
    (1, 12, 14, 2, 64),    # split9's prefill: one split
    (2, 72, 14, 2, 64),    # split13's: one split
    (1, 160, 14, 2, 64),   # Qwen2-0.5B heads, two splits and the merge
    (1, 160, 12, 2, 128),  # Qwen2-1.5B heads, two splits
    (1, 512, 14, 2, 64),   # the large split9 prefill: three splits
])
def test_3xtf32_emulation_matches_reference(b, s, h, kv, hd):
    rng = np.random.default_rng(s + h + hd)
    q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32) for n in (h, kv, kv))
    out, lse, splits = _emulate_kernel(*map(torch.from_numpy, (q, k, v)))
    assert splits == (1 if s <= 72 else 2 if s == 160 else 3)
    want = np.asarray(jfa.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           interpret=True))
    np.testing.assert_allclose(out.numpy(), want, **OUT_TOL)
    # the row LSE that fp32 K-stats' column pass reads, against float64
    sc = np.einsum("bqhd,bthd->bhqt", q.astype(np.float64),
                   np.repeat(k, h // kv, axis=2).astype(np.float64)) / np.sqrt(hd)
    sc = np.where(np.tri(s, dtype=bool), sc, -np.inf)
    top = sc.max(axis=-1)
    want_lse = top + np.log(np.exp(sc - top[..., None]).sum(axis=-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,s,h,kv,hd", [
    (1, 1, 14, 2, 64), (1, 12, 14, 2, 64), (1, 72, 14, 2, 64), (1, 512, 14, 2, 64),
    (8, 512, 14, 2, 64), (8, 512, 12, 2, 128), (32, 512, 14, 2, 64), (1, 2048, 8, 8, 64),
    (4, 2048, 8, 8, 64), (3, 100, 4, 2, 64),
])
def test_split_plan_covers_the_keys(b, s, h, kv, hd):
    """Every row tile's key tiles fall in whole runs of ``per`` (the last
    split reaches the last key tile and no split is empty); the serve
    prefills at S = 12 and 72 and every batch of 8 or more stay one split."""
    tile = tfa.ATTN_F32_TILES[hd]
    splits, per = tfa.attn_split_plan(b, s, h, kv, tile=tile)
    max_kt = -(-s // tile[1])
    assert (splits - 1) * per < max_kt <= splits * per
    if s <= 72 or b >= 8:
        assert splits == 1
    if (b, s) == (1, 512):
        assert splits > 1  # B=1 S=512 spreads over the card
