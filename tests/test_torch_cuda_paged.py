"""K13 and K14, the paged decode kernels, against their plain PyTorch versions
on the card, and the ragged decode step through them against the CPU.

Marked ``cuda``: each test asks its fixture for a card and skips without one
(the kernels are CUDA C++ with no CPU mode). On a machine with an H100 and
nvcc but no JAX: ``python -m pytest --noconftest tests/test_torch_cuda_paged.py``.

Tolerances: K13 fp32 atol/rtol 2e-5 (online vs two-pass softmax, other
summation order, the splits' merge); bf16 1.2e-2 (the plain version rounds
the probabilities to bf16 before PV, the kernel does not); K14 fp32 1e-5
(both dequantize the same codes the same way, then the same fp32 math as
K13). Repeated launches are bit for bit equal.
"""
import numpy as np
import pytest
import torch

from edgellm_tpu_torch.models import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=1.2e-2, rtol=1.2e-2)}
QUANT_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def paged_inputs(device, b, h, kv, hd, ps, pps, dtype, seed=0, kv_codec="fp"):
    """Random pages and a ragged page table: slot lengths from 1 to the full
    span, every other slot's table a distinct page list, the last slot
    inactive (an all-zero row on the trash page, length 1)."""
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 1
    k = rng.normal(size=(num_pages, ps, kv, hd)).astype(np.float32)
    v = rng.normal(size=(num_pages, ps, kv, hd)).astype(np.float32)
    q = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32)).to(device, dtype)
    perm = rng.permutation(np.arange(1, num_pages))[:b * pps].reshape(b, pps)
    lengths = rng.integers(1, pps * ps + 1, size=b)
    lengths[0], lengths[min(1, b - 1)] = 1, pps * ps
    table = np.where(np.arange(pps)[None, :] * ps < lengths[:, None], perm, 0)
    table[-1], lengths[-1] = 0, 1
    t = lambda a, dt: torch.from_numpy(a).to(device, dt)
    extra = {}
    if kv_codec == "fp":
        kp, vp = t(k, dtype), t(v, dtype)
    else:
        kp, ks = fa.quantize_kv_rows(t(k, torch.float32), kv_codec)
        vp, vs = fa.quantize_kv_rows(t(v, torch.float32), kv_codec)
        extra = dict(k_scale=ks, v_scale=vs)
    return q, kp, vp, t(table.astype(np.int32), torch.int32), \
        t(lengths.astype(np.int32), torch.int32), extra


SHAPES = [  # (b, h, kv, hd, ps, pps)
    (6, 14, 2, 64, 8, 3),      # split9's geometry, Qwen2-0.5B heads
    (8, 14, 2, 64, 16, 16),    # Qwen2-0.5B, span 256
    (4, 12, 2, 128, 16, 128),  # Qwen2-1.5B, span 2048
    (3, 4, 4, 64, 40, 2),      # ps not a multiple of the 32-row stage
    (32, 14, 2, 64, 16, 40),   # the large split9 geometry, span 640: 5 splits
    (32, 14, 2, 64, 16, 128),  # Qwen2-0.5B, span 2048 at 32 slots: 5 splits
    (2, 32, 2, 64, 40, 6),     # a group of 16 heads: two head chunks, 3 splits
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,hd,ps,pps", SHAPES)
def test_k13_matches_plain(card, dtype, b, h, kv, hd, ps, pps):
    q, kp, vp, table, lengths, _ = paged_inputs(card, b, h, kv, hd, ps, pps, dtype)
    n0 = fa.paged_decode_attention.launches
    out = fa.paged_decode_attention(q, kp, vp, table, lengths,
                                    plan=fa.paged_plan(q, kp, table))
    torch.cuda.synchronize()
    assert fa.paged_decode_attention.launches == n0 + 1
    want = fa.paged_decode_attention_plain(q, kp, vp, table, lengths)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("kv_codec", ["int8_per_channel", "int4_per_channel"])
@pytest.mark.parametrize("b,h,kv,hd,ps,pps", SHAPES)
def test_k14_matches_plain(card, kv_codec, b, h, kv, hd, ps, pps):
    q, kp, vp, table, lengths, sc = paged_inputs(card, b, h, kv, hd, ps, pps,
                                                 torch.float32, kv_codec=kv_codec)
    n0 = fa.paged_decode_attention_quant.launches
    out = fa.paged_decode_attention_quant(q, kp, vp, sc["k_scale"], sc["v_scale"], table,
                                          lengths, kv_codec=kv_codec,
                                          plan=fa.paged_plan(q, kp, table, kv_codec))
    torch.cuda.synchronize()
    assert fa.paged_decode_attention_quant.launches == n0 + 1
    want = fa.paged_decode_attention_quant_plain(q, kp, vp, sc["k_scale"], sc["v_scale"],
                                                 table, lengths, kv_codec=kv_codec)
    torch.testing.assert_close(out, want, **QUANT_TOL)


@pytest.mark.parametrize("kv_codec", ["fp", "int8_per_channel", "int4_per_channel"])
@pytest.mark.parametrize("b,h,kv,hd,ps,pps", [(32, 14, 2, 64, 16, 40), (32, 12, 2, 128, 16, 128)])
def test_split_launches_are_bit_identical(card, kv_codec, b, h, kv, hd, ps, pps):
    """With several splits (the merge in split order, no atomics) two
    launches on the same inputs give the same bits, and agree with the plain
    model of the split schedule."""
    assert fa.paged_split_plan(b, h, kv, ps, pps, fa._sm_count(card))[0] > 1
    q, kp, vp, table, lengths, sc = paged_inputs(card, b, h, kv, hd, ps, pps, torch.float32,
                                                 seed=3, kv_codec=kv_codec)
    if kv_codec == "fp":
        run = lambda: fa.paged_decode_attention(q, kp, vp, table, lengths,  # noqa: E731
                                                plan=fa.paged_plan(q, kp, table))
    else:
        run = lambda: fa.paged_decode_attention_quant(  # noqa: E731
            q, kp, vp, sc["k_scale"], sc["v_scale"], table, lengths, kv_codec=kv_codec,
            plan=fa.paged_plan(q, kp, table, kv_codec))
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = fa.paged_decode_split_plain(q, kp, vp, table, lengths, kv_codec=kv_codec,
                                       sms=fa._sm_count(card), **sc)
    torch.testing.assert_close(first, want, **(TOL[torch.float32] if kv_codec == "fp"
                                                else QUANT_TOL))


def test_wrappers_refuse_what_the_kernel_does_not_take(card):
    q, kp, vp, table, lengths, _ = paged_inputs(card, 2, 4, 2, 64, 8, 2, torch.float32)
    plan = fa.paged_plan(q, kp, table)
    q32, kp32, vp32 = (t[..., :32].contiguous() for t in (q, kp, vp))
    with pytest.raises(ValueError, match="no kernel covers"):
        fa.paged_decode_attention(q32, kp32, vp32, table, lengths,
                                  plan=fa.paged_plan(q32, kp32, table))
    with pytest.raises(ValueError, match="int32"):
        fa.paged_decode_attention(q, kp, vp, table.long(), lengths, plan=plan)
    with pytest.raises(ValueError, match="q's dtype"):
        fa.paged_decode_attention(q, kp.bfloat16(), vp.bfloat16(), table, lengths, plan=plan)
    with pytest.raises(ValueError, match="lengths"):
        fa.paged_decode_attention(q, kp, vp, table, lengths[:1].contiguous(), plan=plan)
    with pytest.raises(ValueError, match="page_table"):
        fa.paged_decode_attention(q, kp, vp, table[:1].contiguous(), lengths, plan=plan)
    shifted = torch.randn(kp.numel() + 1, device=card)[1:].view(kp.shape)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.paged_decode_attention(q, shifted, vp, table, lengths, plan=plan)
    _, kc, vc, _, _, sc = paged_inputs(card, 2, 4, 2, 64, 8, 2, torch.float32,
                                       kv_codec="int8_per_channel")
    with pytest.raises(ValueError, match="scales"):
        fa.paged_decode_attention_quant(q, kc, vc, sc["k_scale"][:1].contiguous(),
                                        sc["v_scale"], table, lengths,
                                        kv_codec="int8_per_channel",
                                        plan=fa.paged_plan(q, kc, table, "int8_per_channel"))


def test_entry_point_refuses_other_heads_a_block(card, monkeypatch):
    """The C entry point takes the wrapper's heads a block and refuses a
    value its kernel was not built for, so the split plan and the kernel
    cannot drift apart."""
    q, kp, vp, table, lengths, _ = paged_inputs(card, 2, 4, 2, 64, 8, 2, torch.float32)
    plan = fa.paged_plan(q, kp, table)
    monkeypatch.setattr(fa, "PAGED_HEADS_PER_BLOCK", 4)
    with pytest.raises(RuntimeError, match="heads a block"):
        fa.paged_decode_attention(q, kp, vp, table, lengths, plan=plan)


@pytest.mark.parametrize("kv_codec", ["fp", "int8_per_channel", "int4_per_channel"])
def test_paged_step_on_the_card_matches_the_cpu(card, kv_codec):
    """Three decode steps of a 2-layer Qwen2-width model through K13 / K14
    against the same steps on the CPU (plain versions): logits within 1e-4,
    the written fp pages within 1e-5 and quantized codes at most one step
    apart (a row that rounds on a .5 boundary)."""
    import dataclasses

    from edgellm_tpu_torch.models import PRESETS, init_params
    from edgellm_tpu_torch.models.paged_kv import PagedKVCache, paged_decode_step, \
        paged_decode_step_quant
    from edgellm_tpu_torch.models.transformer import params_to

    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=2, vocab_size=512)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        p = params_to(params, device=dev)
        pool = PagedKVCache(cfg, num_pages=9, page_size=8, max_slots=3, pages_per_slot=4,
                            device=dev, kv_codec=kv_codec)
        for slot, n in ((0, 5), (1, 17)):
            pool.alloc_slot()
            pool.ensure(slot, n + 3)
            pool.lengths[slot] = n
        logits = []
        for step in range(3):
            table, lengths = pool.device_tables()
            toks = torch.tensor([3 + step, 7 + step, 0], device=dev)
            if kv_codec == "fp":
                out = paged_decode_step(cfg, p, pool.pool.k, pool.pool.v, table, lengths, toks)
            else:
                out = paged_decode_step_quant(cfg, p, *pool.pool, table, lengths, toks,
                                              kv_codec=kv_codec)
            logits.append(out[0][:2].cpu())
            pool.lengths[:2] += 1
        runs[dev] = (torch.stack(logits), [a[:, 1:].cpu() for a in pool.pool])
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], atol=1e-4, rtol=1e-4)
    for got, want in zip(runs["cuda"][1], runs["cpu"][1]):
        if got.is_floating_point():
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        else:  # int4 codes differ by at most one step in either nibble
            diff = ((got.int() & 0xF) - (want.int() & 0xF)).abs().max()
            diff = max(diff, ((got.int() >> 4) - (want.int() >> 4)).abs().max()) \
                if kv_codec == "int4_per_channel" else (got.int() - want.int()).abs().max()
            assert int(diff) <= 1
