"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks its fixture for a card and skips without one
(the kernels are CUDA C++ with no CPU mode). On a machine with an H100 and
nvcc but no JAX: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` imports jax; this file needs nothing from it).

Tolerances: fp32 outputs atol 2e-5 (online vs two-pass softmax, other
summation order); bf16 outputs atol 2e-2 (the plain version rounds the
probabilities to bf16 before PV, the kernel does not); stats atol 1e-5 for
both dtypes (fp32 in both, from the same rounded inputs).
"""
import numpy as np
import pytest
import torch

from edgellm_tpu_torch.models import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
STATS_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(card, b, s, h, kv, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        card, dtype)
    return mk(b, s, h, hd), mk(b, s, kv, hd), mk(b, s, kv, hd)


SHAPES = [  # (b, s, h, kv, hd)
    (2, 512, 14, 2, 64),    # Qwen2-0.5B
    (1, 2048, 8, 8, 64),    # Pythia-70M window
    (2, 512, 12, 2, 128),   # Qwen2-1.5B
    (3, 100, 4, 2, 64),     # ragged S (not a multiple of the 64-row tile)
    (1, 1, 4, 4, 128),      # one token
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd", SHAPES)
def test_kernels_match_plain(card, dtype, b, s, h, kv, hd):
    q, k, v = _inputs(card, b, s, h, kv, hd, dtype)
    n0 = fa.causal_attention.launches
    out = fa.causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.causal_attention.launches == n0 + 1
    torch.testing.assert_close(out.float(), fa.causal_attention_plain(q, k, v).float(),
                               **TOL[dtype])
    out_s, (col, last) = fa.causal_attention_stats(q, k, v)
    want_out, (want_col, want_last) = fa.causal_attention_stats_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out_s.float(), want_out.float(), **TOL[dtype])
    torch.testing.assert_close(col, want_col, **STATS_TOL)
    torch.testing.assert_close(last, want_last, **STATS_TOL)
    # deterministic: no atomics
    assert torch.equal(fa.causal_attention_stats(q, k, v)[1][0], col)


def test_strided_kv_read_without_copy(card):
    """K/V as non-contiguous views (heads interleaved in a fused projection)."""
    b, s, h, kv, hd = 2, 256, 4, 2, 64
    fused = torch.randn(b, s, 2 * kv, hd, device=card)
    k, v = fused[:, :, :kv], fused[:, :, kv:]
    q = torch.randn(b, s, h, hd, device=card)
    assert not k.is_contiguous()
    torch.testing.assert_close(fa.causal_attention(q, k, v),
                               fa.causal_attention_plain(q, k, v), **TOL[torch.float32])


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    q, k, v = _inputs(card, 1, 64, 4, 2, 64, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.causal_attention(q, k, v)
    q, k, v = _inputs(card, 1, 64, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.causal_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.causal_attention(q, k.cpu(), v)
