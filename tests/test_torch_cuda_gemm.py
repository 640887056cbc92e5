"""The 3xTF32 GEMM (``csrc/gemm_tf32x3.cu``) on the card, against float64,
cuBLAS fp32 and its plain version.

Marked ``cuda``: each test asks its fixture for a card and skips without one
(the kernel is CUDA C++ with no CPU mode). On a machine with an H100 and
nvcc: ``python -m pytest --noconftest tests/test_torch_cuda_gemm.py``.

The bar: at every shape the model runs (both configurations' projections,
MLP and head blocks, at the sweep's and the split's row counts) and at
ragged M and N, the kernel's widest error against a float64 product is at
most twice cuBLAS fp32's (TF32 off) on the same operands, and it agrees with
its plain version (the same TF32 terms, summed by cuBLAS in fp32) within
fp32's error of the product.
"""
import numpy as np
import pytest
import torch

from edgellm_tpu_torch.models import gemm
from edgellm_tpu_torch.models import transformer as tr

pytestmark = pytest.mark.cuda

#: (M, N, K): qwen2-0.5b's suffix (16384 rows) and statistics forward (4096),
#: qwen2-1.5b's split stages (4096), the blocked head's vocab blocks, and
#: ragged M
SHAPES = [
    *[(m, n, k) for m in (16384, 4096)
      for n, k in ((4864, 896), (896, 4864), (896, 896), (128, 896))],
    *[(4096, n, k) for n, k in ((8960, 1536), (1536, 8960), (1536, 1536), (256, 1536))],
    (10824, 4748, 896), (4096, 4748, 1536),
    (4095, 4748, 896), (4097, 896, 896), (4097, 200, 1000),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(card, m, n, k, seed=0):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=card)
    w = torch.randn((k, n), generator=gen, device=card) * 0.02
    return a, w


def _errors(got, a, w):
    """(widest error of ``got``, of cuBLAS fp32) against the float64 product."""
    ref = a.double() @ w.double()
    lib = a @ w
    torch.cuda.synchronize()
    return (got.double() - ref).abs().max().item(), (lib.double() - ref).abs().max().item()


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_kernel_against_float64_and_cublas(card, m, n, k):
    a, w = _operands(card, m, n, k)
    planes, n0 = tr.prepared_planes(w)
    n_launch = gemm.gemm_tf32x3.launches
    got = gemm.gemm_tf32x3(a, planes, n0, n)
    torch.cuda.synchronize()
    assert gemm.gemm_tf32x3.launches == n_launch + 1
    assert got.shape == (m, n) and torch.isfinite(got).all()
    err, lib_err = _errors(got, a, w)
    assert err <= 2 * lib_err, (err, lib_err)
    plain = gemm.gemm_tf32x3_plain(a, planes, n0, n)
    torch.cuda.synchronize()
    assert (got - plain).abs().max().item() <= 2 * lib_err + 1e-7


@pytest.mark.parametrize("m,n,k", [(128, 8, 4), (130, 9, 12), (257, 300, 36)])
def test_tiny_shapes_within_the_split_bound(card, m, n, k):
    """A few K values: fp32's own error is the output's rounding, so the
    kernel is held to what the split itself allows, 2^-21 of |A| @ |B|
    (three products each within 2^-22 of a.b, the dropped lo.lo below),
    above the output's rounding."""
    a, w = _operands(card, m, n, k, seed=7)
    planes, n0 = tr.prepared_planes(w)
    got = gemm.gemm_tf32x3(a, planes, n0, n)
    torch.cuda.synchronize()
    ref = a.double() @ w.double()
    bound = 2 ** -21 * (a.double().abs() @ w.double().abs()) + 2 ** -24 * ref.abs()
    assert ((got.double() - ref).abs() <= bound).all()


def test_head_blocks_read_the_embedding_planes(card):
    """Vocab blocks of a tied head (``embed[a:b].T``, 4748 rows, so every
    other block starts 4 rows into an 8-row swizzle group) against float64."""
    v, d, vb = 151936, 896, 4748
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    embed = torch.randn((v, d), generator=gen, device=card) * 0.02
    post = torch.randn((4096, d), generator=gen, device=card)
    full, _ = tr.prepared_planes(embed.T)
    for i in (0, 1, 2, 31):
        block = embed[i * vb:(i + 1) * vb].T
        planes, n0 = tr.prepared_planes(block)
        assert planes is full and n0 == i * vb
        got = gemm.gemm_tf32x3(post, planes, n0, vb)
        torch.cuda.synchronize()
        err, lib_err = _errors(got, post, block)
        assert err <= 2 * lib_err, (i, err, lib_err)


def test_deterministic_and_rows_independent_of_m(card):
    """Two launches are bit for bit equal, and a row does not depend on how
    many rows the product has (no split-K, no atomics)."""
    a, w = _operands(card, 4097, 896, 4864, seed=2)
    planes, n0 = tr.prepared_planes(w)
    one = gemm.gemm_tf32x3(a, planes, n0, 896)
    two = gemm.gemm_tf32x3(a, planes, n0, 896)
    part = gemm.gemm_tf32x3(a[:4095].contiguous(), planes, n0, 896)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    assert torch.equal(one[:4095], part)


def test_linear_routes_and_counts(card):
    """fp32 products of enough rows and tiles take the kernel; fewer rows
    and bf16 keep cuBLAS, counted by reason."""
    a, w = _operands(card, 4096, 1024, 96, seed=3)
    routed = dict(tr.linear.routed)
    n_launch = gemm.gemm_tf32x3.launches
    big = tr.linear(a.view(2, 2048, 96), w)
    small = tr.linear(a[:gemm.MIN_ROWS - 1], w)
    half = tr.linear(a.bfloat16(), w.bfloat16())
    torch.cuda.synchronize()
    assert gemm.gemm_tf32x3.launches == n_launch + 1
    assert tr.linear.routed["small_m"] == routed["small_m"] + 1
    assert tr.linear.routed["bf16"] == routed["bf16"] + 1
    assert big.shape == (2, 2048, 1024) and small.shape == (gemm.MIN_ROWS - 1, 1024)
    assert torch.equal(half, a.bfloat16() @ w.bfloat16())
    err, lib_err = _errors(big.reshape(4096, 1024), a, w)
    assert err <= 2 * lib_err


def test_changed_weight_is_prepared_again(card):
    a, w = _operands(card, 4096, 256, 128, seed=4)
    before = tr.linear(a, w)
    w.mul_(2.0)
    after = tr.linear(a, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(after, 2 * before, rtol=1e-6, atol=1e-6)


def test_refused_launch_raises(card):
    a, w = _operands(card, 256, 128, 128, seed=5)
    planes, n0 = tr.prepared_planes(w)
    with pytest.raises(ValueError, match="contiguous"):
        gemm.gemm_tf32x3(a.T, planes, n0, 128)
    with pytest.raises(ValueError, match="K"):
        gemm.gemm_tf32x3(a[:, :64].contiguous(), planes, n0, 128)
    with pytest.raises(ValueError, match="outside"):
        gemm.gemm_tf32x3(a, planes, n0, 129)
    torch.cuda.synchronize()


def test_errors_stay_fp32_grade_over_long_reductions(card):
    """At K = 8960 (qwen2-1.5b's down projection) the error does not grow
    with K as truncated tensor-core adds into one accumulator would: each
    stage's 32 values sum in a fresh accumulator."""
    rel = []
    for k in (896, 8960):
        a, w = _operands(card, 256, 256, k, seed=6)
        planes, n0 = tr.prepared_planes(w)
        got = gemm.gemm_tf32x3(a, planes, n0, 256)
        err, lib_err = _errors(got, a, w)
        rel.append(err / lib_err)
    assert max(rel) <= 2, rel
    assert np.isfinite(rel).all()
