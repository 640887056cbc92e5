"""The grouped 3xTF32 GEMM (``csrc/gemm_tf32x3.cu``,
``gemm.grouped_gemm_tf32x3``) and the expert layer it runs on the card.

Marked ``cuda``: each test asks its fixture for a card and skips without one
(the kernel is CUDA C++ with no CPU mode). On a machine with an H100 and
nvcc: ``python -m pytest --noconftest tests/test_torch_cuda_moe_gemm.py``.

The bar, as for the dense kernel: at the LFM2 cell's shapes (16 experts of
~1024 rows, gate / up 2048 -> 3584 and down 1792 -> 2048), at ragged row
counts and with experts that have no rows, each expert's rows are within
3x cuBLAS fp32's widest error (TF32 off) of the float64 product, rows outside
every expert are not written, and the layer adds no host sync.
"""
import pytest
import torch

from edgellm_tpu_torch.models import configs, gemm, moe
from edgellm_tpu_torch.models import transformer as tr

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(card, counts, k, n, seed=0, tail=5):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    w = torch.randn((len(counts), k, n), generator=gen, device=card) * 0.02
    offsets = torch.tensor([0] + list(torch.tensor(counts).cumsum(0).tolist()),
                           dtype=torch.int32, device=card)
    a = torch.randn((sum(counts) + tail, k), generator=gen, device=card)
    return a, w, offsets


def _check(a, w, offsets, got):
    off = offsets.tolist()
    for e in range(w.shape[0]):
        r0, r1 = off[e], off[e + 1]
        if r1 == r0:
            continue
        ref = a[r0:r1].double() @ w[e].double()
        lib = (a[r0:r1] @ w[e]).double()
        err = (got[r0:r1].double() - ref).abs().max().item()
        lib_err = (lib - ref).abs().max().item()
        assert err <= 3 * lib_err, (e, err, lib_err)


@pytest.mark.parametrize("k,n", [(2048, 3584), (1792, 2048)])
def test_cell_shapes_against_float64_and_cublas(card, k, n):
    counts = [1024 + 37 * (i % 5) - 60 for i in range(16)]
    a, w, offsets = _case(card, counts, k, n)
    planes = gemm.prepare_grouped_planes(w)
    before = gemm.grouped_gemm_tf32x3.launches
    got = gemm.grouped_gemm_tf32x3(a, planes, offsets)
    torch.cuda.synchronize()
    assert gemm.grouped_gemm_tf32x3.launches == before + 1
    _check(a, w, offsets, got)
    plain = gemm.grouped_gemm_tf32x3_plain(a, planes, offsets)
    end = offsets[-1].item()
    assert (got[:end] - plain[:end]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("counts", [[0, 300, 0, 0, 129, 1], [0, 0, 0, 0], [5000]])
def test_ragged_and_empty_experts(card, counts):
    """Experts with no rows cost no tile and are skipped; rows after the last
    expert are left as they were."""
    a, w, offsets = _case(card, counts, 256, 200, seed=1)
    got = gemm.grouped_gemm_tf32x3(a, gemm.prepare_grouped_planes(w), offsets,
                                   a.new_full((a.shape[0], 200), float("nan")))
    torch.cuda.synchronize()
    _check(a, w, offsets, got)
    end = offsets[-1].item()
    assert not got[:end].isnan().any() and got[end:].isnan().all()


def test_rows_independent_of_the_other_experts(card):
    """An expert's rows are bit for bit the same whatever rows the other
    experts have (no split-K, no atomics)."""
    a, w, offsets = _case(card, [700, 300], 512, 384, seed=2)
    planes = gemm.prepare_grouped_planes(w)
    one = gemm.grouped_gemm_tf32x3(a, planes, offsets)
    alone = gemm.grouped_gemm_tf32x3(a[:700].contiguous(), gemm.GroupedPlanes(
        planes.hi[:1].contiguous(), planes.lo[:1].contiguous(), planes.k, planes.rows),
        offsets[:2].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(one[:700], alone[:700])


def test_expert_layer_matches_plain_and_does_not_sync(card):
    """The whole expert layer at a tiny width on the card against its CPU
    run (fp32 products in another order: 1e-5), with CUDA's sync debug mode
    set to error for the layer's calls, counted and not; the counted call
    gives the same result and drops no row."""
    cfg = configs.PORT_PRESETS["tiny-lfm2"]
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lp = params["layers"][3]
    x = torch.randn(4, 128, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    want = moe.moe_ffn(cfg, lp, x, tr.prepared_grouped_planes, tr.linear)
    lpc = {k: v.to(card) for k, v in lp.items()}
    xc = x.to(card)
    moe.moe_ffn(cfg, lpc, xc, tr.prepared_grouped_planes, tr.linear)  # planes, warm
    torch.cuda.synchronize()
    moe.read_counters(reset=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.moe_ffn(cfg, lpc, xc, tr.prepared_grouped_planes, tr.linear)
        with moe.counting():
            counted = moe.moe_ffn(cfg, lpc, xc, tr.prepared_grouped_planes, tr.linear)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    assert torch.equal(counted, got)
    c = moe.read_counters(reset=True)
    assert c["moe_rows_routed"] == x.shape[0] * x.shape[1] * cfg.num_experts_per_tok
    assert c["moe_rows_dropped"] == 0
