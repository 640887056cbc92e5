"""The port's causal attention against the TPU package's Pallas kernels.

Same inputs, made with numpy from a seed, go through ``_attn_packed(_stats)``
and ``_attn_blocked(_stats)`` in interpret mode (as tests/test_flash_attention.py
runs them on the CPU) and through the port's ``causal_attention(_stats)``,
which take their plain PyTorch versions for CPU tensors. fp32 throughout.

Tolerances: outputs atol/rtol 1e-5 (two fp32 softmax formulations; the
reference normalizes before PV, the same as the plain version, so only
summation order differs); stats atol 1e-6 (probabilities in [0, 1]).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgellm_tpu.models import flash_attention as jfa
from edgellm_tpu_torch.models import flash_attention as tfa

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
STATS_TOL = dict(atol=1e-6, rtol=0)


def _inputs(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    return q, k, v


def _jax_args(q, k, v):
    b, s, h, hd = q.shape
    return (jnp.asarray(q.reshape(b, s, h * hd)),
            jnp.asarray(np.transpose(k, (0, 2, 1, 3))),
            jnp.asarray(np.transpose(v, (0, 2, 1, 3))))


CASES = [  # (b, s, h, kv, hd)
    (2, 64, 4, 4, 64),    # MHA, hd 64
    (2, 64, 4, 2, 64),    # GQA rep 2
    (1, 32, 14, 2, 64),   # the Qwen2-0.5B head layout
    (2, 48, 4, 2, 128),   # hd 128 (Qwen2-1.5B), S not a power of two
]


@pytest.mark.parametrize("b,s,h,kv,hd", CASES)
def test_attention_matches_packed_kernel(b, s, h, kv, hd):
    q, k, v = _inputs(0, b, s, h, kv, hd)
    want = np.asarray(jfa._attn_packed(*_jax_args(q, k, v), hd=hd, interpret=True))
    got = tfa.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy().reshape(b, s, h * hd), want, **OUT_TOL)


@pytest.mark.parametrize("b,s,h,kv,hd", CASES)
def test_attention_stats_match_packed_stats_kernel(b, s, h, kv, hd):
    q, k, v = _inputs(1, b, s, h, kv, hd)
    want_out, want_col, want_last = jfa._attn_packed_stats(
        *_jax_args(q, k, v), hd=hd, interpret=True)
    out, (col, last) = tfa.causal_attention_stats(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy().reshape(b, s, h * hd), np.asarray(want_out),
                               **OUT_TOL)
    np.testing.assert_allclose(col.numpy(), np.asarray(want_col), **STATS_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), **STATS_TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,qb,hps", [
    (2, 128, 4, 4, 64, 64, 4),   # query-blocked, all heads per step
    (2, 128, 4, 2, 64, 32, 2),   # query-blocked + GQA head-group split
    (1, 64, 8, 2, 128, 64, 4),   # head-group split only, hd 128
])
def test_attention_and_stats_match_blocked_kernels(b, s, h, kv, hd, qb, hps):
    q, k, v = _inputs(2, b, s, h, kv, hd)
    args = _jax_args(q, k, v)
    want = np.asarray(jfa._attn_blocked(*args, hd=hd, qb=qb, hps=hps, interpret=True))
    want_out, want_col, want_last = jfa._attn_blocked_stats(
        *args, hd=hd, qb=qb, hps=hps, interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plan = ("blocked", (qb, hps))
    got = tfa.causal_attention(tq, tk, tv, plan=plan)
    out, (col, last) = tfa.causal_attention_stats(tq, tk, tv, plan=plan)
    np.testing.assert_allclose(got.numpy().reshape(b, s, h * hd), want, **OUT_TOL)
    np.testing.assert_allclose(out.numpy().reshape(b, s, h * hd), np.asarray(want_out),
                               **OUT_TOL)
    np.testing.assert_allclose(col.numpy(), np.asarray(want_col), **STATS_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), **STATS_TOL)


@pytest.mark.parametrize("s,h,kv,hd,itemsize", [
    (512, 14, 2, 64, 2), (512, 14, 2, 64, 4), (512, 12, 2, 128, 2),
    (2048, 8, 8, 64, 2), (2048, 14, 2, 64, 2), (512, 32, 8, 64, 2),
    (4096, 8, 8, 64, 2), (512, 8, 8, 80, 2), (512, 14, 4, 64, 2),
    (1100, 8, 8, 64, 2), (1536, 8, 8, 64, 4), (64, 4, 4, 16, 4),
])
def test_kernel_plan_matches_reference_envelope(s, h, kv, hd, itemsize):
    """The same shapes reach a kernel in both packages."""
    want = jfa.kernel_plan(s, h, kv, hd, backend_check=False, itemsize=itemsize)
    assert tfa.kernel_plan(s, h, kv, hd, itemsize=itemsize) == want


def test_shape_without_plan_raises_like_reference():
    q, k, v = _inputs(3, 1, 8, 2, 2, 64)
    with pytest.raises(ValueError, match="head-aligned GQA"):
        tfa.causal_attention(torch.from_numpy(q), torch.from_numpy(k[:, :, :1].repeat(3, 2)),
                             torch.from_numpy(v[:, :, :1].repeat(3, 2)))
    big = torch.zeros((1, 4096, 2, 64))
    with pytest.raises(ValueError, match="no kernel covers"):
        tfa.causal_attention_stats(big, big, big)


def test_eager_blocks_equal_single_block():
    """The eager stats path streams query blocks; every block size gives the
    single-block (full probabilities) result."""
    q, k, v = map(torch.from_numpy, _inputs(4, 2, 64, 4, 2, 16))
    out0, (col0, last0) = tfa.attention_plain(q, k, v, q_blk=64)
    for blk in (8, 16, 32):
        out, (col, last) = tfa.attention_plain(q, k, v, q_blk=blk)
        torch.testing.assert_close(out, out0, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(col, col0, atol=1e-7, rtol=0)
        torch.testing.assert_close(last, last0, atol=0, rtol=0)


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    """The kernel contract: one CUDA device, fp32/bf16, hd 64/128, packed q."""
    q, k, v = map(torch.from_numpy, _inputs(5, 1, 16, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._check_inputs(q, k, v, None)
    with pytest.raises(ValueError, match="do not match"):
        tfa._check_inputs(q, k[:, :8], v[:, :8], None)


def test_bound_counts_bytes_and_causal_flops():
    """Qwen2-0.5B at B=8, S=512, bf16: ~16.8 MB of bytes (~5.0 us at
    3.35 TB/s) against ~3.8 us of causal FLOPs at 989 TFLOP/s -> bytes bound."""
    nbytes, flops = tfa.causal_attention_bytes_flops(8, 512, 14, 2, 64, itemsize=2)
    assert abs(nbytes - 16.78e6) < 0.01e6
    ms, by = tfa.bound_ms(nbytes, flops, torch.bfloat16)
    assert by == "bytes" and abs(ms - 5.01e-3) < 0.01e-3
    assert abs(flops / 989e12 * 1e6 - 3.8) < 0.05
