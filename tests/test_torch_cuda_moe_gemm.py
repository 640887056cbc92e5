"""The grouped 3xTF32 GEMM (``csrc/gemm_tf32x3.cu``,
``gemm.grouped_gemm_tf32x3``), the expert layer's gather and combine
(``csrc/moe_rows.cu``) and the layer they run on the card.

Marked ``cuda``: each test asks its fixture for a card and skips without one
(the kernels are CUDA C++ with no CPU mode). On a machine with an H100 and
nvcc: ``python -m pytest --noconftest tests/test_torch_cuda_moe_gemm.py``.

The bar, as for the dense kernel: at the LFM2 cell's shapes (16 experts of
~1024 rows, gate / up 2048 -> 3584 and down 1792 -> 2048), at ragged row
counts and with experts that have no rows, each expert's rows are within
3x cuBLAS fp32's widest error (TF32 off) of the float64 product, rows outside
every expert are not written, and the layer adds no host sync. The gate /
up launch over glu planes stores silu(gate) * up within a few fp32 ulps of
the unfused launch followed by ``F.silu(g) * u``; the gather and combine
match the PyTorch passes they replace (the combine within one ulp an add)
and never read a row of a pair routed to another card.
"""
import pytest
import torch
import torch.nn.functional as F

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


#: the fused gate / up against the unfused launch and F.silu(g) * u: fp32
#: ulps of the unfused value (the same column sums, SiLU with IEEE expf and
#: division on both sides)
GLU_ULPS = 4


def _ulps_apart(got, want):
    """The widest |got - want| in fp32 ulps of |want| (at least the smallest
    normal's)."""
    unit = torch.finfo(torch.float32).eps * want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return ((got - want).abs() / unit).max().item() if want.numel() else 0.0


@pytest.mark.parametrize("counts,k,f", [
    ([1024 + 37 * (i % 5) - 60 for i in range(16)], 2048, 1792),  # the cell's gate / up
    ([0, 300, 0, 0, 129, 1], 256, 200),                            # ragged, F % 64 != 0
    ([0, 0, 0, 0], 256, 128), ([5000], 256, 64)])
def test_fused_gate_up_matches_unfused_then_silu_up(card, counts, k, f):
    """Glu planes: the launch stores silu(gate) * up (M, F) at the held
    experts' rows, within :data:`GLU_ULPS` of the unfused launch followed
    by PyTorch's SiLU·up; rows past the held experts' stay unwritten; two
    launches are bit for bit equal."""
    a, w, offsets = _case(card, counts, k, 2 * f, seed=3)
    h = gemm.grouped_gemm_tf32x3(a, gemm.prepare_grouped_planes(w), offsets)
    glu = gemm.prepare_grouped_planes(w, glu=True)
    got = gemm.grouped_gemm_tf32x3(a, glu, offsets, a.new_full((a.shape[0], f), float("nan")))
    again = gemm.grouped_gemm_tf32x3(a, glu, offsets)
    torch.cuda.synchronize()
    end = offsets[-1].item()
    want = F.silu(h[:end, :f]) * h[:end, f:]
    assert _ulps_apart(got[:end], want) <= GLU_ULPS
    assert got[end:].isnan().all()
    assert torch.equal(again[:end], got[:end])


def _routing(card, tokens=16 * 512, k=4, routed=32, held=16, offset=16, d=2048, seed=4):
    """The cell's routing on the second card of two (experts 16-31 held):
    (x (T, D), held_mask (T, k), order, offsets)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    experts = torch.rand((tokens, routed), generator=gen, device=card).topk(k, dim=-1).indices
    local = experts - offset
    order, offsets = moe.dispatch(experts, offset, held)
    x = torch.randn((tokens, d), generator=gen, device=card)
    return x, (local >= 0) & (local < held), order, offsets


#: (tokens, D): the cell's statistics forward, and a width whose 16-byte
#: pieces do not fill a warp's last pass
ROWS_SHAPES = [(16 * 512, 2048), (300, 200)]


@pytest.mark.parametrize("tokens,d", ROWS_SHAPES)
def test_gather_matches_index_select_and_records_rows(card, tokens, d):
    """The gather copies the held pairs' rows as ``index_select`` did and
    records the old inverse order for them, -1 for the others."""
    x, held_mask, order, offsets = _routing(card, tokens=tokens, d=d)
    k = held_mask.shape[1]
    before = moe.gather_rows.launches
    rows, pos = moe.gather_rows(x, order, offsets, k)
    torch.cuda.synchronize()
    assert moe.gather_rows.launches == before + 1
    n = offsets[-1].item()
    assert 0 < n < order.numel()
    assert torch.equal(rows[:n], x.index_select(0, order[:n] // k))
    old_pos = torch.empty_like(order)
    old_pos[order] = torch.arange(order.numel(), device=card)
    held = held_mask.reshape(-1)
    assert torch.equal(pos.long()[held], old_pos[held]) and (pos[~held] == -1).all()


@pytest.mark.parametrize("tokens,d", ROWS_SHAPES)
def test_combine_matches_where_sum_and_never_reads_rows_held_elsewhere(card, tokens, d):
    """The combine against the old gather / multiply / where / sum, within
    one fp32 ulp of the terms' magnitude an add, with a NaN planted in every
    row past the held pairs' (never read); two launches are bit for bit
    equal, and its bf16 output is its fp32 one rounded."""
    x, held_mask, order, offsets = _routing(card, tokens=tokens, d=d)
    t, k = held_mask.shape
    _, pos = moe.gather_rows(x, order, offsets, k)
    n = offsets[-1].item()
    y = torch.randn((order.numel(), x.shape[1]), device=card)
    y[n:] = float("nan")
    w = torch.rand((t, k), device=card)
    w = w / w.sum(dim=-1, keepdim=True)
    before = moe.combine_rows.launches
    got = moe.combine_rows(y, pos, w, torch.float32)
    again = moe.combine_rows(y, pos, w, torch.float32)
    bf16 = moe.combine_rows(y, pos, w, torch.bfloat16)
    torch.cuda.synchronize()
    assert moe.combine_rows.launches == before + 3
    old_pos = torch.empty_like(order)
    old_pos[order] = torch.arange(order.numel(), device=card)
    picked = y.index_select(0, old_pos).reshape(t, k, -1)
    terms = torch.where(held_mask[..., None], picked * w[..., None], 0.0)
    want = terms.sum(dim=1)
    tol = k * torch.finfo(torch.float32).eps * terms.abs().sum(dim=1)
    assert not got.isnan().any()
    assert bool(((got - want).abs() <= tol).all())
    assert torch.equal(got, again) and torch.equal(bf16, got.to(torch.bfloat16))


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
    pairs = x.shape[0] * x.shape[1] * cfg.num_experts_per_tok
    assert c["moe_rows_routed"] == c["moe_pairs"] == pairs
    assert c["moe_rows_dropped"] == 0
