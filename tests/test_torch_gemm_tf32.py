"""The 3xTF32 GEMM's arithmetic, its prepared planes and the routing of the
model's products, on the CPU.

The card's kernel (``csrc/gemm_tf32x3.cu``) computes the model's fp32
products as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, every operand split into
hi = tf32(x), lo = tf32(x - hi) as ``cvt.rna`` rounds, in fp32 sums.
``gemm.gemm_tf32x3_plain`` repeats that arithmetic in torch; here it is held
to a float64 product at every (N, K) the benchmark's cells run (qwen2-0.5b's
and qwen2-1.5b's projections, MLP and head blocks) with few rows: its widest
error is at most twice the plain fp32 product's, while 1xTF32 (one rounded
product) reads hundreds of times that. The planes are checked element by
element against the layout the kernel's shared-memory stage expects, and
the model's routing (``transformer.linear``) against its counters.
"""
import gc

import pytest
import torch

from edgellm_tpu_torch.models import gemm
from edgellm_tpu_torch.models import transformer as tr

#: (N, K) of the cells' products: qwen2-0.5b gate/up, down, q/o, k/v;
#: qwen2-1.5b the same; the head's 4748-row vocab blocks at both widths
CELL_SHAPES = [(4864, 896), (896, 4864), (896, 896), (128, 896),
               (8960, 1536), (1536, 8960), (1536, 1536), (256, 1536),
               (4748, 896), (4748, 1536)]


def _operands(m, n, k, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(m, k, generator=gen), torch.randn(k, n, generator=gen) * 0.02


def _widest(got, ref):
    return (got.double() - ref).abs().max().item()


@pytest.mark.parametrize("n,k", CELL_SHAPES)
def test_emulation_within_twice_fp32_of_float64(n, k):
    a, w = _operands(8, n, k, seed=n * 7 + k)
    ref = a.double() @ w.double()
    got = gemm.gemm_tf32x3_plain(a, gemm.prepare_planes(w.T))
    fp32 = _widest(a @ w, ref)
    assert _widest(got, ref) <= 2 * fp32
    # the bound separates: one TF32 product is far outside it
    assert _widest(gemm.tf32_rna(a) @ gemm.tf32_rna(w), ref) > 100 * fp32


def test_split_matches_cvt_rna():
    """hi and lo are TF32 (13 low mantissa bits clear), rounded to nearest
    with ties away from zero, and hi + lo is x within 2^-22 relative."""
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -12, 1.0 + 2 ** -12])
    hi, _ = gemm.split_tf32(x)
    assert hi.tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0 + 2 ** -10, 1.0]
    y = torch.randn(4096) * torch.exp(torch.randn(4096) * 4)
    hi, lo = gemm.split_tf32(y)
    for t in (hi, lo):
        assert ((t.view(torch.int32) & 0x1FFF) == 0).all()
    assert (((hi + lo) - y).abs() <= 2 ** -22 * y.abs()).all()


@pytest.mark.parametrize("r,k", [(128, 896), (37, 100), (4748, 64), (8, 4)])
def test_planes_layout(r, k):
    """Each value of B^T lies where the kernel's stage expects it: chunk
    k // 32, row n, position p of its chunk with PLANE_ORDER[p] = k % 32,
    16-byte piece swizzled to piece ^ (n % 8); padding is zero."""
    rows = torch.randn(r, k)
    planes = gemm.prepare_planes(rows)
    kc, rp = -(-k // 32), -(-r // 8) * 8
    assert planes.hi.shape == planes.lo.shape == (kc, rp, 32)
    assert (planes.k, planes.rows) == (k, r)
    order = torch.tensor(gemm.PLANE_ORDER)
    assert sorted(gemm.PLANE_ORDER) == list(range(32))
    pos_of = torch.empty(32, dtype=torch.long)
    pos_of[order] = torch.arange(32)
    n = torch.arange(r)[:, None]
    kk = torch.arange(k)[None, :]
    pos = pos_of[kk % 32]
    phys = ((pos // 4) ^ (n % 8)) * 4 + pos % 4
    hi, lo = gemm.split_tf32(rows)
    assert torch.equal(planes.hi[kk // 32, n, phys], hi)
    assert torch.equal(planes.lo[kk // 32, n, phys], lo)
    mask = torch.ones(kc, rp, 32, dtype=torch.bool)
    mask[kk // 32, n, phys] = False
    assert (planes.hi[mask] == 0).all() and (planes.lo[mask] == 0).all()
    got_hi, got_lo = gemm.unpack_planes(planes, 3 if r > 3 else 0)
    assert torch.equal(got_hi, hi[3 if r > 3 else 0:]) and torch.equal(got_lo, lo[3 if r > 3 else 0:])
    rel = ((got_hi + got_lo) - rows[3 if r > 3 else 0:]).abs()
    assert (rel <= 2 ** -22 * rows[3 if r > 3 else 0:].abs()).all()


def test_prepared_planes_cached_and_invalidated():
    w = torch.randn(96, 40) * 0.02
    first, n0 = tr.prepared_planes(w)
    again, _ = tr.prepared_planes(w)
    assert first is again and n0 == 0
    w[0, 0] += 1.0  # an in-place change moves the weight's version
    changed, _ = tr.prepared_planes(w)
    assert changed is not first
    hi, lo = gemm.unpack_planes(changed)
    assert torch.allclose(hi + lo, w.T, rtol=2 ** -22, atol=0)
    assert tr.prepared_planes(w)[0] is changed


def test_stacked_layers_and_head_blocks():
    """A layer view of a stacked weight has planes of its own, kept while
    the stack lives; every vocab block of a tied head reads the embedding's
    planes at its first row."""
    stack = torch.randn(3, 64, 32)
    per_layer = [tr.prepared_planes(stack[i])[0] for i in range(3)]
    assert len({id(p) for p in per_layer}) == 3
    assert tr.prepared_planes(stack[1])[0] is per_layer[1]
    for i, p in enumerate(per_layer):
        hi, lo = gemm.unpack_planes(p)
        assert torch.allclose(hi + lo, stack[i].T, rtol=2 ** -22, atol=0)
    embed = torch.randn(100, 48)
    full, n_full = tr.prepared_planes(embed.T)
    for a, b in ((0, 25), (25, 50), (75, 100)):
        planes, n0 = tr.prepared_planes(embed[a:b].T)
        assert planes is full and n0 == a and n_full == 0
        x = torch.randn(5, 48)
        want = x.double() @ embed[a:b].T.double()
        got = gemm.gemm_tf32x3(x, planes, n0, b - a)  # CPU: the plain version
        assert _widest(got, want) <= 2 * _widest(x @ embed[a:b].T, want) + 1e-7
    n_roots = len(tr._PLANES)
    del stack, per_layer, embed, full, planes
    gc.collect()
    assert len(tr._PLANES) <= n_roots - 2


@pytest.mark.parametrize("device,a,b,rows,cols,want", [
    ("cpu", torch.float32, torch.float32, 4096, 4864, "cpu"),
    ("cuda", torch.bfloat16, torch.bfloat16, 4096, 4864, "bf16"),
    ("cuda", torch.float32, torch.bfloat16, 4096, 151936, "bf16"),
    ("cuda", torch.float32, torch.float32, 127, 8960, "small_m"),  # below a row tile
    ("cuda", torch.float32, torch.float32, 8, 4864, "small_m"),  # a decode step
    ("cuda", torch.float32, torch.float32, 512, 896, "small_m"),  # 28 tiles
    ("cuda", torch.float32, torch.float32, 1024, 128, "small_m"),  # 8 tiles
    # below 48 tiles cuBLAS was the faster at some (N, K) on the H100: the
    # table's statistics forward's k / v (4096 x 128, 32 tiles) keep it
    ("cuda", torch.float32, torch.float32, 4096, 128, "small_m"),
    ("cuda", torch.float32, torch.float32, 128, 4864, "small_m"),  # 38 tiles
    ("cuda", torch.float32, torch.float32, 384, 1536, "small_m"),  # 36 tiles
    ("cuda", torch.float32, torch.float32, 6016, 128, "small_m"),  # 47 tiles
    # from 48 tiles the kernel: the table's baseline head blocks (256 rows),
    # split4's k / v (4096 x 256), the suffix's MLP
    ("cuda", torch.float32, torch.float32, 6017, 128, None),
    ("cuda", torch.float32, torch.float32, 512, 1536, None),
    ("cuda", torch.float32, torch.float32, 256, 4748, None),
    ("cuda", torch.float32, torch.float32, 4096, 256, None),
    ("cuda", torch.float32, torch.float32, 16384, 4864, None),
])
def test_route(device, a, b, rows, cols, want):
    assert gemm.route(device, a, b, rows, cols) == want


def test_linear_on_cpu_is_the_plain_product():
    x, w = torch.randn(2, 300, 64), torch.randn(64, 40)
    before = dict(tr.linear.routed)
    assert torch.equal(tr.linear(x, w), x @ w)
    assert torch.equal(tr.head_matmul(x[0], w), x[0] @ w)
    assert tr.linear.routed["cpu"] == before["cpu"] + 2
    assert tr.linear.routed["small_m"] == before["small_m"]
    assert tr.linear.routed["bf16"] == before["bf16"]


def test_plain_version_on_cpu_tensors():
    a, w = _operands(130, 72, 40, seed=9)
    planes = gemm.prepare_planes(w.T)
    n_launch = gemm.gemm_tf32x3.launches
    assert torch.equal(gemm.gemm_tf32x3(a, planes), gemm.gemm_tf32x3_plain(a, planes))
    assert gemm.gemm_tf32x3.launches == n_launch


def _bf16_model():
    from edgellm_tpu_torch.models import tiny_config

    cfg = tiny_config("qwen2", num_layers=4)
    return cfg, tr.init_params(cfg, torch.Generator().manual_seed(5), dtype=torch.bfloat16,
                               device="cpu")


def test_promoted_stage_copies_kept_across_placements():
    """A bf16 model's stages behind an unfused hop hold float32 copies: a
    second placement returns the same copies (so their planes are prepared
    once), and a changed source weight gets a fresh copy."""
    from edgellm_tpu_torch.parallel.split import SplitConfig, SplitRuntime

    cfg, params = _bf16_model()
    rt = SplitRuntime(cfg, SplitConfig((1,), ("int8_per_token",)), ["cpu", "cpu"])
    first, again = rt.place_params(params), rt.place_params(params)
    late = first["stages"][1]  # layers 2 and 3
    assert all(lp["wq"].dtype == torch.float32 for lp in late)
    assert all(b[name] is t for a, b in zip(late, again["stages"][1]) for name, t in a.items())
    params["layers"][3]["wq"][0, 0] += 1.0  # an in-place change of the source
    changed = rt.place_params(params)["stages"][1]
    assert changed[1]["wq"] is not late[1]["wq"] and changed[1]["w_up"] is late[1]["w_up"]
    assert all(torch.equal(c["wq"], p["wq"].float())
               for c, p in zip(changed, params["layers"][2:], strict=True))
    late[1]["w_up"].zero_()  # a changed copy is not handed out again
    assert torch.equal(rt.place_params(params)["stages"][1][1]["w_up"],
                       params["layers"][3]["w_up"].float())


def test_views_are_not_kept_and_tensor_parallel_cuts_are():
    cfg, params = _bf16_model()
    layers = [{name: t.float() for name, t in lp.items()} for lp in params["layers"]]
    wq = layers[0]["wq"]
    n_made = len(tr._MADE)
    view = tr.made_once(wq, ("stage",), lambda: wq[1:3])
    assert view._base is wq and len(tr._MADE) <= n_made + 1
    assert not any(tr._MADE.get(wq, {}).values())
    first, again = tr.tp_shard_layers(layers, 2), tr.tp_shard_layers(layers, 2)
    for lp, shards, shards_again in zip(layers, first, again, strict=True):
        for a, b in zip(shards, shards_again, strict=True):
            assert a["wq"] is b["wq"] and a["wq"].is_contiguous()
            assert a["wq"].shape[-1] == lp["wq"].shape[-1] // 2
            # a row cut of a layer's (in, out) weight is a contiguous view
            assert a["w_down"]._base is lp["w_down"] and a["w_down"].is_contiguous()
    del first, again, shards, shards_again, a, b, lp, view, wq, layers
    gc.collect()
    assert len(tr._MADE) <= n_made
