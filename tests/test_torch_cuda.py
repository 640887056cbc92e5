"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks its fixture for a card and skips without one
(the kernels are CUDA C++ with no CPU mode). On a machine with an H100 and
nvcc but no JAX: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` imports jax; this file needs nothing from it).

Tolerances: fp32 outputs atol 2e-5 (online vs two-pass softmax, other
summation order, the kernel's 3xTF32 products within ~2^-22 of fp32's); bf16
outputs atol 1.6e-2, just above the 1.5625e-2 the H100 read (both round the
probabilities to bf16 before PV, the kernel the unnormalized ones: an output
may land one bf16 step at |out| < 4 from the plain version's); stats atol
1e-5 for both dtypes (fp32 in both, from the same rounded inputs).
"""
import numpy as np
import pytest
import torch

from edgellm_tpu_torch.models import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=1.6e-2, rtol=0.0)}
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
    # the bf16 kernels' tile edges: 64-key stages, 64- and 128-row query blocks
    *[(2, s, 14, 2, 64) for s in (63, 64, 65, 127, 128, 129)],
    *[(1, s, 12, 2, 128) for s in (63, 65, 129)],
    (4, 12, 14, 2, 64),     # the serve prefill lengths (split9, split13)
    (4, 72, 14, 2, 64),
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


#: fp32 shapes whose rows the key split cuts (the merge kernel runs): B=1
#: prefills at Qwen2-0.5B heads and a Pythia-70M window; and split4's stage
#: shape at Qwen2-1.5B heads (hd 128, one split)
F32_SPLIT_SHAPES = [(1, 512, 14, 2, 64), (1, 2048, 8, 8, 64), (8, 512, 12, 2, 128)]


@pytest.mark.parametrize("b,s,h,kv,hd", F32_SPLIT_SHAPES)
def test_fp32_split_kernels_match_plain_and_repeat(card, b, s, h, kv, hd):
    """fp32 K-attn (3xTF32 products, key splits merged in split order) and
    K-stats against their plain versions; two launches bit for bit equal;
    each call counted once, as an fp32 launch."""
    q, k, v = _inputs(card, b, s, h, kv, hd, torch.float32, seed=s + hd)
    n0, f0 = fa.causal_attention.launches, fa.causal_attention.launches_by_dtype["float32"]
    out, again = fa.causal_attention(q, k, v), fa.causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.causal_attention.launches == n0 + 2
    assert fa.causal_attention.launches_by_dtype["float32"] == f0 + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, fa.causal_attention_plain(q, k, v), **TOL[torch.float32])
    out_s, (col, last) = fa.causal_attention_stats(q, k, v)
    want_out, (want_col, want_last) = fa.causal_attention_stats_plain(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out_s, out)
    torch.testing.assert_close(col, want_col, **STATS_TOL)
    torch.testing.assert_close(last, want_last, **STATS_TOL)


#: fp32 K-stats' column pass at the shapes of chip_smoke.py's kernel phase
#: (the sweep's Qwen2-0.5B and Qwen2-1.5B stats prefixes at B=8, the Pythia-70M
#: window) and at its tile edges: 128-key blocks, 64-row (hd 64) and 32-row
#: (hd 128) query tiles, a last key block whose second warpgroup is empty
COL_SHAPES = [(8, 512, 14, 2, 64), (8, 512, 12, 2, 128), (4, 2048, 8, 8, 64),
              *[(2, s, 14, 2, 64) for s in (1, 63, 65, 127, 128, 129, 193, 12, 72)],
              *[(2, s, 12, 2, 128) for s in (1, 31, 33, 63, 65, 129, 72)]]


def _scaled(card, b, s, h, kv, hd, top, seed):
    """fp32 q, k, v with q and k scaled so that the largest |q.k| / sqrt(hd)
    over the visible pairs is about ``top``: rows whose top key takes p near
    1, as real checkpoints' attention sinks do."""
    q, k, v = _inputs(card, b, s, h, kv, hd, torch.float32, seed=seed)
    sc = torch.einsum("bqhd,bthd->bhqt", q, k.repeat_interleave(h // kv, dim=2)) / hd ** 0.5
    peak = torch.where(torch.ones(s, s, dtype=torch.bool, device=card).tril(), sc, 0).abs().max()
    f = (top / peak).sqrt()
    return q * f, k * f, v


@pytest.mark.parametrize("top", [None, 30.0])
@pytest.mark.parametrize("b,s,h,kv,hd", COL_SHAPES)
def test_fp32_column_pass_matches_plain_and_repeats(card, b, s, h, kv, hd, top):
    """The fp32 column pass (3xTF32 on wgmma) against the plain version within
    STATS_TOL, at unit-variance inputs and at scores up to |s / sqrt(hd)| =
    30; each last row sums to 1 within 1e-4 (the scores are the forward's);
    two launches bit for bit equal."""
    if top is None:
        q, k, v = _inputs(card, b, s, h, kv, hd, torch.float32, seed=s + hd)
    else:
        q, k, v = _scaled(card, b, s, h, kv, hd, top, seed=s + hd + 1)
    n0 = fa.causal_attention_stats.launches
    out, (col, last) = fa.causal_attention_stats(q, k, v)
    want_out, (want_col, want_last) = fa.causal_attention_stats_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.causal_attention_stats.launches == n0 + 1
    torch.testing.assert_close(col, want_col, **STATS_TOL)
    torch.testing.assert_close(last, want_last, **STATS_TOL)
    torch.testing.assert_close(last.sum(dim=-1), torch.ones_like(last[..., 0]), atol=1e-4,
                               rtol=0)
    again = fa.causal_attention_stats(q, k, v)[1]
    assert torch.equal(again[0], col) and torch.equal(again[1], last)


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


def test_wrapper_raises_on_misaligned_bf16_copies(card):
    """The bf16 kernels copy 16-byte chunks: a K/V view whose sequence stride
    is not a multiple of 16 bytes, or whose base is off by one element,
    raises instead of launching."""
    b, s, h, kv, hd = 1, 64, 4, 2, 64
    q = torch.randn(b, s, h, hd, device=card).to(torch.bfloat16)
    padded = torch.randn(b, s, kv * hd + 4, device=card).to(torch.bfloat16)
    k = padded[:, :, :kv * hd].unflatten(2, (kv, hd))  # sequence stride 264 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.causal_attention(q, k, k)
    flat = torch.randn(b * s * kv * hd + 1, device=card).to(torch.bfloat16)
    shifted = flat[1:].view(b, s, kv, hd)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.causal_attention_stats(q, shifted, shifted)


def test_wrapper_raises_on_misaligned_fp32_copies(card):
    """The fp32 body copies 16-byte chunks too: a K/V view whose sequence
    stride is not a multiple of 16 bytes raises instead of launching."""
    b, s, h, kv, hd = 1, 64, 4, 2, 64
    q = torch.randn(b, s, h, hd, device=card)
    padded = torch.randn(b, s, kv * hd + 2, device=card)
    k = padded[:, :, :kv * hd].unflatten(2, (kv, hd))  # sequence stride 520 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.causal_attention(q, k, k)


def test_bf16_lm_head_runs_bf16_operands_with_fp32_output(card):
    """A bf16 model's LM head on the card (``unembed`` and the vocab-streamed
    ``nll_tail``) multiplies bf16 operands into fp32 (``aten::mm.dtype``) and
    reaches no fp32 GEMM; its logits stay within the fp32 summation-order
    bound, 2 * D * 2^-24 * (|post| @ |head|), of the widened fp32 product
    (the same exact products summed in another order)."""
    import dataclasses

    from torch.utils._python_dispatch import TorchDispatchMode

    from edgellm_tpu_torch.models import PRESETS, init_params
    from edgellm_tpu_torch.models import transformer as tr

    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=1)
    gen = torch.Generator(device=card).manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=card)
    hidden = torch.randn(2, 40, cfg.hidden_size, generator=gen, device=card).to(torch.bfloat16)
    targets = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device=card)
    aten = torch.ops.aten
    gemm_ops = {aten.mm.default, aten.mm.dtype, aten.addmm.default, aten.bmm.default,
                aten.bmm.dtype, aten.baddbmm.default}

    class Gemms(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in gemm_ops:
                self.seen.append((func, [a.dtype for a in args if isinstance(a, torch.Tensor)]))
            return func(*args, **(kwargs or {}))

    with Gemms() as rec:
        logits = tr.unembed(cfg, params, hidden)
        nll = tr.nll_tail(cfg, params, hidden, targets, 32, per_example=True)
    torch.cuda.synchronize()
    assert logits.dtype == torch.float32 and nll.dtype == torch.float32
    assert len(rec.seen) == 1 + cfg.vocab_size // tr._vocab_block_size(cfg.vocab_size)
    assert all(f is aten.mm.dtype and d == [torch.bfloat16] * 2 for f, d in rec.seen), rec.seen
    post = tr._final_norm(cfg, params, hidden).reshape(-1, cfg.hidden_size).float()
    head = params["embed"].T.float()
    bound = 2 * cfg.hidden_size * 2.0 ** -24 * (post.abs() @ head.abs())
    diff = (logits.reshape(-1, cfg.vocab_size) - post @ head).abs()
    assert bool((diff <= bound).all()), (diff.max().item(), bound.min().item())
    head_only = {k: params[k].cpu() for k in ("embed", "final_norm_scale")}
    want = tr.nll_tail(cfg, head_only, hidden.cpu(), targets.cpu(), 32, per_example=True)
    torch.testing.assert_close(nll.cpu(), want, atol=0.0, rtol=1e-5)


#: the native sample lengths of chip_smoke.py's distances run: fp32 K-stats'
#: tile edges, and for fp32 Qwen2-0.5B every one in the blocked plan
NATIVE_LENGTHS = (2, 12, 63, 65, 127, 129, 300, 512, 1024)


def _qwen_width_3_layers(card):
    """Qwen2-0.5B at full width, 3 layers, fp32 random weights -> (cfg,
    params on the card, params on the CPU)."""
    import dataclasses

    from edgellm_tpu_torch.models import PRESETS, init_params, params_to

    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=3)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0), device=card)
    return cfg, params, params_to(params, device="cpu")


def test_layer_distributions_on_card_match_plain(card):
    """``layer_importance_distributions`` at native lengths: fp32 K-stats on
    the card (one launch a layer a sample) against the plain version on the
    CPU, the distributions and the pairwise matrix within 1e-5."""
    from edgellm_tpu_torch.analysis import (layer_importance_distributions,
                                            pairwise_layer_distances)

    cfg, params, params_cpu = _qwen_width_3_layers(card)
    rng = np.random.default_rng(0)
    samples = [rng.integers(0, cfg.vocab_size, n) for n in NATIVE_LENGTHS]
    assert all(fa.kernel_plan(n, 14, 2, 64, itemsize=4) is not None for n in NATIVE_LENGTHS)
    n0 = fa.causal_attention_stats.launches
    got = layer_importance_distributions(cfg, params, samples, device=card)
    assert fa.causal_attention_stats.launches - n0 == cfg.num_layers * len(samples)
    want = layer_importance_distributions(cfg, params_cpu, samples, device="cpu")
    for g_layer, w_layer in zip(got, want):
        for g, w in zip(g_layer, w_layer):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    np.testing.assert_allclose(pairwise_layer_distances(got), pairwise_layer_distances(want),
                               atol=1e-5, rtol=0)


def test_chunk_relevance_on_card_matches_cpu(card):
    """The relevance backward pass (plain torch ops, no kernel launched) on
    the card against the CPU for 2 windows of 512: the argmax tokens the
    seeds picked first, then the (L, H) relevance within rtol 1e-3, atol
    1e-6 * max|R|. Runs at torch's default (no TF32) matmul precision."""
    from edgellm_tpu_torch.importance.relevance import chunk_relevance

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, params, params_cpu = _qwen_width_3_layers(card)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 512)))
    n0 = fa.causal_attention.launches + fa.causal_attention_stats.launches
    got, tokens = chunk_relevance(cfg, params, ids.to(card), with_tokens=True)
    assert fa.causal_attention.launches + fa.causal_attention_stats.launches == n0
    want, want_tokens = chunk_relevance(cfg, params_cpu, ids, with_tokens=True)
    assert torch.equal(tokens.cpu(), want_tokens)
    assert got.shape == (3, 14)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("codec,atol", [("fp32", 1e-4), ("int8_per_token", 1e-3)])
def test_generate_split_on_card_matches_cpu(card, codec, atol):
    """Split decode at Qwen2-0.5B width, 3 layers, cut 1: the teacher-forced
    prefill, decode-step and verify-burst logits on the card (fp32 K-attn,
    K3 / K4 on the int8 hop) against the CPU (plain versions), and greedy
    ``generate_split`` tokens, vanilla and speculative, identical."""
    from edgellm_tpu_torch.codecs import codec_kernels as ck
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
    from edgellm_tpu_torch.serve.decode import generate_split
    from edgellm_tpu_torch.serve.speculative import SpecConfig

    cfg, params, params_cpu = _qwen_width_3_layers(card)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 14))
    got = {}
    for dev, p in ((card, params), ("cpu", params_cpu)):
        rt = SplitRuntime(cfg, SplitConfig((1,), (codec,)), [dev, dev])
        placed = rt.place_params(p)
        tids = torch.from_numpy(ids).to(dev)
        n3 = ck.int8_affine_encode.launches
        pre, cache = rt.prefill_decode(placed, tids[:, :8], 24)
        logits = [pre[:, -1]]
        for t in range(8, 11):
            step, cache = rt.decode_step(placed, cache, tids[:, t])
            logits.append(step)
        burst, cache = rt.verify_step(placed, cache, tids[:, 11:14])
        hops = ck.int8_affine_encode.launches - n3
        assert hops == (5 if dev == card and codec == "int8_per_token" else 0)
        assert cache["length"] == 14 and all(k.device.type == torch.device(dev).type
                                             for k in cache["k"])
        got[dev] = (torch.cat([torch.stack(logits, 1), burst], 1).cpu(),
                    generate_split(rt, placed, ids[:1, :8], 10, capacity=24).cpu(),
                    generate_split(rt, placed, ids[:1, :8], 10, capacity=24,
                                   speculative=SpecConfig(k=4), raw_params=p).cpu())
    torch.testing.assert_close(got[card][0], got["cpu"][0], atol=atol, rtol=0)
    assert torch.equal(got[card][1], got["cpu"][1])
    assert torch.equal(got[card][2], got["cpu"][2]) and torch.equal(got[card][2], got[card][1])


def test_decode_and_verify_hops_reach_k3_contiguous(card, monkeypatch):
    """K3 reads a CUDA hidden's rows in place: the split prefill's (1, 8, D),
    a decode step's (1, 1, D) and a verify burst's (1, 4, D) stage outputs
    reach it contiguous, and a strided hidden is refused, not copied."""
    from edgellm_tpu_torch.codecs import codec_kernels as ck
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
    from edgellm_tpu_torch.parallel import split as split_mod

    cfg, params, _ = _qwen_width_3_layers(card)
    rt = SplitRuntime(cfg, SplitConfig((1,), ("int8_per_token",)), [card, card])
    placed = rt.place_params(params)
    seen = []
    real = split_mod._hop

    def spy(codec, hidden, imp, dst):
        seen.append((tuple(hidden.shape), hidden.is_contiguous()))
        return real(codec, hidden, imp, dst)

    monkeypatch.setattr(split_mod, "_hop", spy)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12))).to(card)
    n3 = ck.int8_affine_encode.launches
    _, cache = rt.prefill_decode(placed, ids[:, :8], 16)
    _, cache = rt.decode_step(placed, cache, ids[:, 8])
    rt.verify_step(placed, cache, ids[:, 8:12])
    d = cfg.hidden_size
    assert seen == [((1, 8, d), True), ((1, 1, d), True), ((1, 4, d), True)]
    assert ck.int8_affine_encode.launches - n3 == 3
    strided = torch.randn((2, 2, cfg.hidden_size), device=card)[:, ::2]
    assert strided.shape == (2, 1, cfg.hidden_size) and not strided.is_contiguous()
    with pytest.raises(ValueError, match="must be contiguous"):
        rt.codecs[0].encode(strided)


def _split_paged_forced(cfg, params, dev, codec, kv_codec, prompts, forced):
    """Teacher-forced logits of the split ragged step at cut 1: every prompt
    prefilled (``prefill_decode``) and adopted into its own slot of a page
    size 16 pool, then every step fed ``forced[:, t]`` -> (T, B, V) on the
    CPU."""
    from edgellm_tpu_torch.models.paged_kv import PagedKVCache
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime

    rt = SplitRuntime(cfg, SplitConfig((1,), (codec,)), [dev, dev])
    placed = rt.place_params(params)
    b, steps = forced.shape
    host = PagedKVCache(cfg, num_pages=1 + 8 * b, page_size=16, max_slots=b, pages_per_slot=8,
                        device=dev, materialize=False, kv_codec=kv_codec)
    pool = rt.init_paged_pool(1 + 8 * b, 16, kv_codec=kv_codec)
    for p in prompts:
        slot = host.alloc_slot()
        _, cache = rt.prefill_decode(placed, torch.from_numpy(p[None]).to(dev), 128)
        host.ensure(slot, len(p))
        pool = rt.adopt_paged(pool, cache, 0, host._flat_indices(slot, len(p)), len(p))
        host.lengths[slot] = len(p)
    out = []
    for t in range(steps):
        for slot in range(b):
            host.ensure_writable(slot, int(host.lengths[slot]) + 1)
        table, lengths = host.device_tables()
        logits, pool = rt.decode_step_paged(placed, pool, table, lengths,
                                            torch.from_numpy(forced[:, t]).to(dev))
        out.append(logits.cpu())
        host.lengths += 1
    return torch.stack(out)


@pytest.mark.parametrize("codec,kv_codec,atol", [("fp32", "fp", 1e-4),
                                                 ("int8_per_token", "fp", 1e-2),
                                                 ("int8_per_token", "int4_per_channel", 1e-2)])
def test_split_paged_step_on_card_matches_cpu(card, codec, kv_codec, atol):
    """The split ragged step at Qwen2-0.5B width, 3 layers, cut 1, four
    streams of ragged prompts teacher-forced over 5 steps: on the card (K13
    or K14 a layer a step, K3 / K4 at N = 4 on the int8 hop) against the
    CPU (plain versions). Tolerance: summation order alone over an fp32 hop
    and fp pages (1e-4); with an int8 hop or int4 pages a value on a
    rounding boundary puts its code a step from the CPU's, and the prompts'
    206 hop tokens hold several such values: one moved a logit 2.3e-3 on the
    H100, so 1e-2."""
    from edgellm_tpu_torch.codecs import codec_kernels as ck

    cfg, params, params_cpu = _qwen_width_3_layers(card)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 37, 64, 100)]
    forced = rng.integers(1, cfg.vocab_size, (4, 5))
    attn = fa.paged_decode_attention if kv_codec == "fp" else fa.paged_decode_attention_quant
    n_attn, n3 = attn.launches, ck.int8_affine_encode.launches
    got = _split_paged_forced(cfg, params, card, codec, kv_codec, prompts, forced)
    assert attn.launches - n_attn == cfg.num_layers * 5
    assert ck.int8_affine_encode.launches - n3 == (9 if codec == "int8_per_token" else 0)
    want = _split_paged_forced(cfg, params_cpu, "cpu", codec, kv_codec, prompts, forced)
    torch.testing.assert_close(got, want, atol=atol, rtol=atol)


def test_kv_tier_eval_on_card_matches_cpu(card):
    """``run_kv_tier_eval`` at the int4 tier, Qwen2-0.5B width, 3 layers:
    K14 once a layer a position on the card, and the PPL of the CPU's plain
    version within rtol 1e-3."""
    from edgellm_tpu_torch.eval import run_kv_tier_eval

    cfg, params, params_cpu = _qwen_width_3_layers(card)
    corpus = np.random.default_rng(6).integers(0, cfg.vocab_size, 96)
    kw = dict(kv_codec="int4_per_channel", max_length=32, stride=16, page_size=16,
              window_batch=2, max_chunks=3)
    n0 = fa.paged_decode_attention_quant.launches
    got = run_kv_tier_eval(cfg, params, corpus, device=card, **kw)
    # chunk 0 alone, then one group of two full windows: 2 groups of T = 32
    assert fa.paged_decode_attention_quant.launches - n0 == cfg.num_layers * 31 * 2
    want = run_kv_tier_eval(cfg, params_cpu, corpus, device="cpu", **kw)
    assert got["chunks"] == want["chunks"] == 3 and got["n_tokens"] == want["n_tokens"]
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-3)


def test_bf16_weights_over_fp32_pages_on_card(card):
    """bf16 weights over the batcher's default float32 pages: K13 takes a
    bf16 q over float32 pages widened (its output the widened call's,
    rounded to bf16); the split step's bf16 stage 0 hands it such a q (one
    launch a layer a step in all), and the teacher-forced logits stay within 5e-2 of the
    CPU's plain version: bf16 GEMMs round on the two devices in other places
    (one bf16 step is 0.4 % of a value; an int8 hop over bf16 stages read
    3.7e-2 on the H100), and the plain version rounds the probabilities to
    bf16 as the reference's gather path does."""
    from edgellm_tpu_torch.models.transformer import params_to

    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(3, 1, 14, 64)).astype(np.float32)).to(card)
    kp, vp = (torch.from_numpy(rng.normal(size=(7, 16, 2, 64)).astype(np.float32)).to(card)
              for _ in range(2))
    table = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32, device=card)
    lengths = torch.tensor([5, 32, 17], dtype=torch.int32, device=card)
    plan = fa.paged_plan(q, kp, table)
    got = fa.paged_decode_attention(q.bfloat16(), kp, vp, table, lengths, plan=plan)
    widened = fa.paged_decode_attention(q.bfloat16().float(), kp, vp, table, lengths, plan=plan)
    assert got.dtype == torch.bfloat16 and torch.equal(got, widened.bfloat16())
    cfg, params, _ = _qwen_width_3_layers(card)
    bf_card = params_to(params, dtype=torch.bfloat16)
    bf_cpu = params_to(bf_card, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (6, 33)]
    forced = rng.integers(1, cfg.vocab_size, (2, 3))
    n0 = fa.paged_decode_attention.launches
    got = _split_paged_forced(cfg, bf_card, card, "fp32", "fp", prompts, forced)
    assert fa.paged_decode_attention.launches - n0 == cfg.num_layers * 3
    want = _split_paged_forced(cfg, bf_cpu, "cpu", "fp32", "fp", prompts, forced)
    torch.testing.assert_close(got, want, atol=5e-2, rtol=5e-2)
