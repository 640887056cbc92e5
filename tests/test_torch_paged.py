"""The port's paged KV layer held against the JAX package on the CPU: the
KV-at-rest row codec, the plain K13 / K14 against the reference's gather
fallback and its Pallas kernels in interpret mode, ``PagedKVCache``
bookkeeping, and the ragged decode steps.

Weights cross with ``params_from_jax_numpy`` and pools with
``paged_cache_from_state``; inputs come from numpy seeds. Tolerances: the
row codec bit for bit; attention fp32 1e-5 (summation order; the kernels'
online softmax); decode-step logits 1e-4 (a few layers of fp32 GEMMs in
another order) and pools 1e-5 (quantized codes at most one step apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgellm_tpu.models import flash_attention as jfa
from edgellm_tpu.models import paged_kv as jpk
from edgellm_tpu.models import tiny_config as j_tiny
from edgellm_tpu.models.transformer import init_params as j_init
from edgellm_tpu_torch.models import flash_attention as tfa
from edgellm_tpu_torch.models import paged_kv as tpk
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import paged_cache_from_state, params_from_jax_numpy

TIERS = ("int8_per_channel", "int4_per_channel")


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("kv_codec", TIERS)
@pytest.mark.parametrize("shape", [(5, 2, 64), (3, 7, 4, 16), (1, 1, 128)])
def test_kv_row_codec_bit_exact(kv_codec, shape):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32) * 3
    x[0, 0] = 0.0  # an all-zero row: zero codes, scale 0
    qj = jax.jit(jfa.quantize_kv_rows, static_argnums=1)
    dj = jax.jit(jfa.dequantize_kv_rows, static_argnums=2)
    want_c, want_s = qj(jnp.asarray(x), kv_codec)
    got_c, got_s = tfa.quantize_kv_rows(torch.from_numpy(x), kv_codec)
    assert got_c.dtype == (torch.int8 if kv_codec == "int8_per_channel" else torch.uint8)
    np.testing.assert_array_equal(got_c.numpy(), _np(want_c))
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))
    np.testing.assert_array_equal(tfa.dequantize_kv_rows(got_c, got_s, kv_codec).numpy(),
                                  _np(dj(want_c, want_s, kv_codec)))


def _paged(seed, b, h, kv, hd, ps, pps):
    """Random pages, a ragged page table (lengths 1 .. span, an inactive
    slot on the trash page) and q, as numpy."""
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 1
    k = rng.normal(size=(num_pages, ps, kv, hd)).astype(np.float32)
    v = rng.normal(size=(num_pages, ps, kv, hd)).astype(np.float32)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))[:b * pps].reshape(b, pps)
    lengths = rng.integers(1, pps * ps + 1, size=b)
    lengths[0], lengths[1] = 1, pps * ps
    table = np.where(np.arange(pps)[None, :] * ps < lengths[:, None], perm, 0)
    table[-1], lengths[-1] = 0, 1
    return q, k, v, table.astype(np.int32), lengths.astype(np.int32)


PAGED_SHAPES = [(4, 14, 2, 64, 8, 3), (3, 4, 2, 128, 16, 2), (4, 4, 4, 64, 8, 4)]


def _reference_paged(monkeypatch, flag, fn, *args, **kw):
    """The reference's function with ``EDGELLM_ATTN`` set to ``flag``
    ("xla": the gather fallback; "pallas": the Pallas kernel, interpret mode
    on the CPU), jit caches cleared around it."""
    monkeypatch.setenv("EDGELLM_ATTN", flag)
    jax.clear_caches()
    try:
        return _np(fn(*args, **kw))
    finally:
        monkeypatch.delenv("EDGELLM_ATTN")
        jax.clear_caches()


@pytest.mark.parametrize("flag", ["xla", "pallas"])
@pytest.mark.parametrize("b,h,kv,hd,ps,pps", PAGED_SHAPES)
def test_plain_k13_matches_reference(monkeypatch, flag, b, h, kv, hd, ps, pps):
    q, k, v, table, lengths = _paged(b + hd, b, h, kv, hd, ps, pps)
    want = _reference_paged(monkeypatch, flag, jfa.paged_decode_attention, jnp.asarray(q),
                            jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                            jnp.asarray(lengths))
    t = lambda a: torch.from_numpy(np.array(a))
    plan = tfa.paged_plan(t(q), t(k), t(table))
    assert plan == ("paged", (pps, ps))
    got = tfa.paged_decode_attention(t(q), t(k), t(v), t(table), t(lengths), plan=plan)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("flag", ["xla", "pallas"])
@pytest.mark.parametrize("kv_codec", TIERS)
@pytest.mark.parametrize("b,h,kv,hd,ps,pps", PAGED_SHAPES[:2])
def test_plain_k14_matches_reference(monkeypatch, flag, kv_codec, b, h, kv, hd, ps, pps):
    q, k, v, table, lengths = _paged(b + hd + 1, b, h, kv, hd, ps, pps)
    kc, ks = (_np(a) for a in jfa.quantize_kv_rows(jnp.asarray(k), kv_codec))
    vc, vs = (_np(a) for a in jfa.quantize_kv_rows(jnp.asarray(v), kv_codec))
    want = _reference_paged(
        monkeypatch, flag, jfa.paged_decode_attention_quant, jnp.asarray(q),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(lengths), kv_codec=kv_codec)
    t = lambda a: torch.from_numpy(np.array(a))
    plan = tfa.paged_plan(t(q), t(kc), t(table), kv_codec)
    assert plan == ("paged_quant", (pps, ps))
    got = tfa.paged_decode_attention_quant(t(q), t(kc), t(vc), t(ks), t(vs), t(table),
                                           t(lengths), kv_codec=kv_codec, plan=plan)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_decode_plan_gates():
    """The reference's shape gates, with quantized pages aligned at 8 (the
    TPU's 32 is a rule of its int8 tiling)."""
    assert tfa.decode_plan(24, 14, 2, 64, 4, pages=(3, 8)) == ("paged", (3, 8))
    assert tfa.decode_plan(80, 14, 2, 64, 4, pages=(10, 8), kv_codec="int4_per_channel") \
        == ("paged_quant", (10, 8))
    for args, kw in [((24, 14, 2, 64, 4), {}),                         # contiguous
                     ((24, 14, 2, 32, 4), dict(pages=(3, 8))),         # head dim
                     ((24, 14, 4, 64, 4), dict(pages=(3, 8))),         # ragged GQA
                     ((24, 14, 2, 64, 4), dict(pages=(4, 8))),         # pps * ps != span
                     ((36, 14, 2, 64, 4), dict(pages=(3, 12))),        # ps % 8
                     ((4096, 14, 2, 64, 4), dict(pages=(256, 16))),    # span cap
                     ((2048, 14, 4, 128, 4), dict(pages=(128, 16)))]:  # byte budget
        assert tfa.decode_plan(*args, **kw) is None, (args, kw)
    with pytest.raises(ValueError, match="unknown KV-at-rest tier"):
        tfa.decode_plan(24, 14, 2, 64, 4, pages=(3, 8), kv_codec="int2")


# ---------------------------------------------------------------------------
# The split schedule of K13 / K14 (plain model of the kernel's two passes)
# ---------------------------------------------------------------------------

#: (b, h, kv, hd, ps, pps): page sizes 8 / 16 / 40 and head dims 64 / 128,
#: each cut into several splits
SPLIT_SHAPES = [(3, 14, 2, 64, 8, 16), (3, 4, 2, 64, 16, 8), (2, 4, 4, 64, 40, 6),
                (3, 12, 2, 128, 16, 12)]


def _shared_paged(seed, b, h, kv, hd, ps, pps):
    """As :func:`_paged`, but with a pool of half the pages: slots draw
    pages with repeats, sharing them as prefix sharing makes them; slot 0
    has length 1, slot 1 the full span."""
    rng = np.random.default_rng(seed)
    num_pages = max(2, b * pps // 2)
    k = rng.normal(size=(num_pages, ps, kv, hd)).astype(np.float32)
    v = rng.normal(size=(num_pages, ps, kv, hd)).astype(np.float32)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    lengths = rng.integers(1, pps * ps + 1, size=b)
    lengths[0], lengths[1] = 1, pps * ps
    pages = rng.integers(1, num_pages, size=(b, pps))
    table = np.where(np.arange(pps)[None, :] * ps < lengths[:, None], pages, 0)
    return q, k, v, table.astype(np.int32), lengths.astype(np.int32)


@pytest.mark.parametrize("b,h,kv,hd,ps,pps", [
    (32, 14, 2, 64, 16, 40),     # the large split9 geometry (span 640)
    (32, 14, 2, 64, 16, 128),    # span 2048, Qwen2-0.5B
    (32, 12, 2, 128, 16, 128),   # span 2048, Qwen2-1.5B
    (6, 14, 2, 64, 8, 3),        # split9
    (8, 14, 2, 64, 8, 10),       # split14
    (2, 4, 4, 64, 40, 6), (3, 32, 2, 64, 8, 16)])
def test_split_plan_covers_each_live_page_once(b, h, kv, hd, ps, pps):
    """Every live page of every length lies in exactly one split, in logical
    order, and the splits that hold one are exactly the live ones of the
    plain model's partials; a split past the length covers nothing; splits
    hold whole pages of at least 64 rows (or the whole span); at 32 slots
    the grid has at least as many blocks as the H100's 132 SMs."""
    splits, per = tfa.paged_split_plan(b, h, kv, ps, pps)
    assert 1 <= splits <= pps and (splits - 1) * per < pps <= splits * per
    assert per * ps >= min(tfa.PAGED_MIN_SPLIT_ROWS, pps * ps)
    chunks = -(-(h // kv) // tfa.PAGED_HEADS_PER_BLOCK)
    if b == 32:
        assert b * kv * chunks * splits >= tfa.H100_SMS
    lengths = sorted(n for n in {1, ps - 1, ps, ps + 1, per * ps, per * ps + 1,
                                 pps * ps - 1, pps * ps} if 1 <= n <= pps * ps)
    span = torch.zeros((len(lengths), pps * ps, 1, 8))
    q = torch.zeros((len(lengths), 1, 1, 8))
    *_, live = tfa.paged_split_partials(q, span, span, torch.tensor(lengths, dtype=torch.int32),
                                        per * ps)
    assert live.shape == (len(lengths), splits)
    for length, live_row in zip(lengths, live.tolist()):
        live_pages = -(-length // ps)
        ranges = [(s * per, min((s + 1) * per, pps, live_pages)) for s in range(splits)]
        covered = [p for p0, p1 in ranges for p in range(p0, p1)]
        assert covered == list(range(live_pages))
        assert [p1 > p0 for p0, p1 in ranges] == live_row


@pytest.mark.parametrize("flag", ["xla", "pallas"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("b,h,kv,hd,ps,pps", SPLIT_SHAPES)
def test_split_plain_k13_matches_reference(monkeypatch, flag, shared, b, h, kv, hd, ps, pps):
    """Split, then merge the partials: the plain model of K13's schedule
    against the reference's paged decode attention (gather fallback and
    Pallas kernel), lengths 1 and the full span among them, distinct or
    shared pages."""
    assert tfa.paged_split_plan(b, h, kv, ps, pps)[0] > 1
    make = _shared_paged if shared else _paged
    q, k, v, table, lengths = make(b + hd + ps, b, h, kv, hd, ps, pps)
    want = _reference_paged(monkeypatch, flag, jfa.paged_decode_attention, jnp.asarray(q),
                            jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                            jnp.asarray(lengths))
    t = lambda a: torch.from_numpy(np.array(a))
    got = tfa.paged_decode_split_plain(t(q), t(k), t(v), t(table), t(lengths))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_codec", TIERS)
@pytest.mark.parametrize("b,h,kv,hd,ps,pps", SPLIT_SHAPES)
def test_split_plain_k14_matches_reference(monkeypatch, kv_codec, b, h, kv, hd, ps, pps):
    q, k, v, table, lengths = _shared_paged(b + hd + ps + 1, b, h, kv, hd, ps, pps)
    kc, ks = (_np(a) for a in jfa.quantize_kv_rows(jnp.asarray(k), kv_codec))
    vc, vs = (_np(a) for a in jfa.quantize_kv_rows(jnp.asarray(v), kv_codec))
    want = _reference_paged(
        monkeypatch, "xla", jfa.paged_decode_attention_quant, jnp.asarray(q),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(lengths), kv_codec=kv_codec)
    t = lambda a: torch.from_numpy(np.array(a))
    got = tfa.paged_decode_split_plain(t(q), t(kc), t(vc), t(table), t(lengths),
                                       kv_codec=kv_codec, k_scale=t(ks), v_scale=t(vs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_split_past_the_length_contributes_nothing():
    """A split that starts at or past a slot's length is not live, holds no
    mass (l = 0, acc = 0), and the merge ignores whatever its state holds."""
    b, h, kv, hd, ps, pps = 3, 14, 2, 64, 8, 16
    q, k, v, table, lengths = (torch.from_numpy(a) for a in _paged(5, b, h, kv, hd, ps, pps))
    lengths[2] = 70  # splits of 64 rows: the second split holds 6 live rows
    _, per = tfa.paged_split_plan(b, h, kv, ps, pps)
    assert per * ps == 64
    k_span, v_span = tfa._span_rows(q, k, v, None, None, table, "fp")
    m, l, acc, live = tfa.paged_split_partials(q, k_span, v_span, lengths, per * ps)
    assert live.tolist() == [[True, False], [True, True], [True, True]]
    assert torch.isneginf(m[0, 1]).all() and (l[0, 1] == 0).all() and (acc[0, 1] == 0).all()
    assert torch.isfinite(m[2, 1]).all() and (l[2, 1] > 0).all()
    out = tfa.merge_split_partials(m, l, acc, live, torch.float32)
    junk = torch.randn(acc[0, 1].shape)
    m[0, 1], l[0, 1], acc[0, 1] = 50.0, 3.0, junk
    assert torch.equal(tfa.merge_split_partials(m, l, acc, live, torch.float32), out)
    want = tfa.paged_decode_attention_plain(q, k, v, table, lengths)
    np.testing.assert_allclose(out.reshape(want.shape).numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_decode_and_verify_attention_match_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.array(a))
    for length in (5, np.asarray([3, 12], np.int32)):
        want = _np(jax.jit(jfa.decode_attention)(jnp.asarray(q), jnp.asarray(kc),
                                                 jnp.asarray(vc), jnp.asarray(length)))
        got = tfa.decode_attention(t(q), t(kc), t(vc),
                                   t(length) if isinstance(length, np.ndarray) else length)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    qk = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    want = _np(jfa.verify_attention(jnp.asarray(qk), jnp.asarray(kc), jnp.asarray(vc), 4))
    np.testing.assert_allclose(tfa.verify_attention(t(qk), t(kc), t(vc), 4).numpy(), want,
                               atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# PagedKVCache bookkeeping
# ---------------------------------------------------------------------------

JCFG = j_tiny("qwen2", num_layers=2, hidden_size=64, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=2, hidden_size=64, num_heads=4, vocab_size=128)


def _host_state(cache):
    """What the bookkeeping holds, as plain python / numpy."""
    return {"page_table": cache.page_table.copy(), "lengths": cache.lengths.copy(),
            "active": cache.active.copy(), "free": list(cache._free),
            "owner": cache._owner.copy(), "refcount": cache._refcount.copy(),
            "index_holds": cache._index_holds.copy(),
            "prefix": None if cache.prefix is None else cache.prefix.to_array(),
            "counters": dict(cache.prefix_counters)}


def _assert_same_books(tc, jc):
    got, want = _host_state(tc), _host_state(jc)
    for key in got:
        if isinstance(got[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key
    tc.check_invariants()
    jc.check_invariants()


@pytest.mark.parametrize("kv_codec", ["fp", "int8_per_channel"])
def test_paged_cache_bookkeeping_matches_reference(kv_codec):
    """One script of alloc / ensure / adopt / prefix share + register / COW
    / state round trip / free / defrag on both caches: identical tables,
    lengths, free lists, owners, refcounts, index and counters after every
    operation, and identical gathered rows."""
    pc = dict(min_shared_block=2, max_index_pages=0)
    mk = lambda mod, **kw: mod.PagedKVCache(
        JCFG if mod is jpk else TCFG, num_pages=14, page_size=4, max_slots=4,
        pages_per_slot=5, prefix_cache=mod.PrefixCacheConfig(**pc), kv_codec=kv_codec, **kw)
    jc, tc = mk(jpk), mk(tpk, device="cpu")
    rng = np.random.default_rng(0)
    shape = lambda n: (2, n, 2, 16)
    prompts = [rng.integers(1, 128, 9), None, rng.integers(1, 128, 6)]
    prompts[1] = np.concatenate([prompts[0][:6], rng.integers(1, 128, 5)])

    def both(name, *args):
        out = getattr(jc, name)(*args), getattr(tc, name)(*args)
        _assert_same_books(tc, jc)
        return out

    rows = {}
    for i, p in enumerate(prompts):
        slot = both("alloc_slot")[0]
        matched = both("share_prefix", slot, p, len(p) - 1)[0]
        n = len(p)
        k = rng.normal(size=shape(n - matched)).astype(np.float32)
        v = rng.normal(size=shape(n - matched)).astype(np.float32)
        if matched:
            jc.adopt_rows(slot, jnp.asarray(k), jnp.asarray(v), matched, n)
            tc.adopt_rows(slot, torch.from_numpy(k), torch.from_numpy(v), matched, n)
        else:
            jc.adopt(slot, jnp.asarray(k), jnp.asarray(v), n)
            tc.adopt(slot, torch.from_numpy(k), torch.from_numpy(v), n)
        _assert_same_books(tc, jc)
        both("register_prefix", slot, p)
        rows[slot] = n
    assert tc.prefix_counters["hits"] == 1
    both("ensure_writable", 1, rows[1] + 1)   # the shared tail page forks
    assert tc.prefix_counters["cow_forks"] >= 1
    state = jc.state_dict()
    back = paged_cache_from_state(TCFG, state, prefix_cache=tpk.PrefixCacheConfig(**pc),
                                  device="cpu")
    jback = mk(jpk)
    jback.load_state_dict(state)
    _assert_same_books(back, jback)
    again = back.state_dict()
    for key, want in state.items():
        np.testing.assert_array_equal(np.asarray(again[key]), np.asarray(want), err_msg=key)
    both("ensure", 0, 17)
    both("free_slot", 2)
    both("defrag")
    gather = "gather_slot" if kv_codec == "fp" else "gather_slot_packed"
    for slot in (0, 1):
        g_t, g_j = getattr(tc, gather)(slot), getattr(jc, gather)(slot)
        for key in g_j:
            np.testing.assert_array_equal(np.asarray(g_t[key]), np.asarray(g_j[key]))
    both("release_prefix")
    assert tc.prefix.num_nodes == 0


def test_paged_cache_out_of_pages_and_tier_refusals():
    tc = tpk.PagedKVCache(TCFG, num_pages=3, page_size=4, max_slots=2, pages_per_slot=4,
                          device="cpu")
    slot = tc.alloc_slot()
    with pytest.raises(tpk.OutOfPages):
        tc.ensure(slot, 12)
    tc.check_invariants()  # nothing was allocated
    assert tc.num_free_pages == 2
    with pytest.raises(tpk.KVTierMismatchError, match="transcoding is refused"):
        tc.adopt_packed(slot, None, None, None, None, 1)
    state = tpk.PagedKVCache(TCFG, num_pages=3, page_size=4, max_slots=2, pages_per_slot=4,
                             device="cpu", kv_codec="int4_per_channel").state_dict()
    with pytest.raises(tpk.KVTierMismatchError):
        tc.load_state_dict(state)
    with pytest.raises(ValueError, match="unknown kv_codec"):
        tpk.resolve_kv_codec("int2")
    assert tpk.kv_page_bytes(TCFG, 8, "int4_per_channel") \
        == jpk.kv_page_bytes(JCFG, 8, "int4_per_channel")
    assert tpk.num_pages_for_bytes(TCFG, 7864320, 8, "int4_per_channel") \
        == jpk.num_pages_for_bytes(JCFG, 7864320, 8, "int4_per_channel")


# ---------------------------------------------------------------------------
# The ragged decode steps against the reference
# ---------------------------------------------------------------------------


def _step_cfgs(hd):
    h = 4
    return (j_tiny("qwen2", num_layers=2, hidden_size=h * hd, num_heads=h, vocab_size=96),
            t_tiny("qwen2", num_layers=2, hidden_size=h * hd, num_heads=h, vocab_size=96))


@pytest.mark.parametrize("kv_codec", ["fp", "int8_per_channel", "int4_per_channel"])
@pytest.mark.parametrize("hd", [16, 64])
def test_paged_decode_step_matches_reference(kv_codec, hd):
    """Three ragged steps (two live slots, one inactive on the trash page)
    from the same pool, weights and tokens: logits within 1e-4, the written
    pages (trash page aside) within 1e-5 or one code step."""
    jcfg, tcfg = _step_cfgs(hd)
    jparams = j_init(jcfg, jax.random.key(1))
    tparams = params_from_jax_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jparams),
                                    device="cpu")
    jc = jpk.PagedKVCache(jcfg, num_pages=9, page_size=8, max_slots=3, pages_per_slot=4,
                          kv_codec=kv_codec)
    rng = np.random.default_rng(hd)
    for n in (5, 17):
        slot = jc.alloc_slot()
        shape = (2, n, 2, hd)
        jc.adopt(slot, jnp.asarray(rng.normal(size=shape).astype(np.float32)),
                 jnp.asarray(rng.normal(size=shape).astype(np.float32)), n)
        jc.ensure(slot, n + 3)
    tc = paged_cache_from_state(tcfg, jc.state_dict(), device="cpu")
    jpool = tuple(jc.pool)
    for step in range(3):
        toks = np.asarray([3 + step, 7 + step, 0], np.int32)
        jt, jl = jc.device_tables()
        tt, tl = tc.device_tables()
        if kv_codec == "fp":
            jl_, *jpool = jpk.paged_decode_step(jcfg, jparams, *jpool, jt, jl, jnp.asarray(toks))
            tl_ = tpk.paged_decode_step(tcfg, tparams, *tc.pool, tt, tl,
                                        torch.from_numpy(toks))[0]
        else:
            jl_, *jpool = jpk.paged_decode_step_quant(jcfg, jparams, *jpool, jt, jl,
                                                      jnp.asarray(toks), kv_codec=kv_codec)
            tl_ = tpk.paged_decode_step_quant(tcfg, tparams, *tc.pool, tt, tl,
                                              torch.from_numpy(toks), kv_codec=kv_codec)[0]
        np.testing.assert_allclose(tl_[:2].numpy(), _np(jl_)[:2], atol=1e-4, rtol=1e-4)
        jc.lengths[:2] += 1
        tc.lengths[:2] += 1
    for got, want in zip(tc.pool, jpool):
        got, want = got[:, 1:].numpy(), _np(want)[:, 1:]
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        elif kv_codec == "int4_per_channel":
            for shift in (0, 4):
                d = ((got.astype(np.int32) >> shift) & 0xF) - ((want.astype(np.int32) >> shift)
                                                               & 0xF)
                assert np.abs(d).max() <= 1
        else:
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_paged_step_garbage_on_the_trash_page_stays_masked():
    """Rows past a slot's length (here NaN-free garbage written into every
    unused row) never reach its output: the same logits as a zeroed pool."""
    _, tcfg = _step_cfgs(64)
    from edgellm_tpu_torch.models import init_params

    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    outs = []
    for fill in (0.0, 7.5):
        tc = tpk.PagedKVCache(tcfg, num_pages=6, page_size=8, max_slots=2, pages_per_slot=2,
                              device="cpu")
        tc.pool.k.fill_(fill)
        tc.pool.v.fill_(fill)
        slot = tc.alloc_slot()
        tc.adopt(slot, torch.ones((2, 3, 2, 64)), torch.ones((2, 3, 2, 64)), 3)
        tc.ensure(slot, 4)
        tt, tl = tc.device_tables()
        outs.append(tpk.paged_decode_step(tcfg, params, *tc.pool, tt, tl,
                                          torch.tensor([5, 0]))[0][0])
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    assert dataclasses.is_dataclass(tpk.PrefixCacheConfig())


def test_prefill_decode_and_suffix_prefill_match_reference():
    """The decode half of the transformer against the reference: prefill
    logits and cache, three contiguous decode steps, and the suffix prefill
    a prefix-sharing admit runs (``block_verify``), within 1e-4; the cache
    state dict round-trips."""
    from edgellm_tpu.models import transformer as jtr
    from edgellm_tpu.serve import decode as jdec
    from edgellm_tpu_torch.models import transformer as ttr
    from edgellm_tpu_torch.serve import decode as tdec

    jcfg, tcfg = _step_cfgs(16)
    jparams = j_init(jcfg, jax.random.key(2))
    tparams = params_from_jax_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jparams),
                                    device="cpu")
    ids = np.random.default_rng(5).integers(1, 96, (2, 9)).astype(np.int32)
    jl, jc = jtr.prefill(jcfg, jparams, jnp.asarray(ids), 16)
    tl, tc = ttr.prefill(tcfg, tparams, torch.from_numpy(ids).long(), 16)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc.k.numpy(), _np(jc.k), atol=1e-5, rtol=1e-5)
    assert tc.length == int(jc.length) == 9 and tc.capacity == 16
    for tok in (3, 50, 7):
        toks = np.asarray([tok, tok + 1], np.int32)
        jl, jc = jtr.decode_step(jcfg, jparams, jc, jnp.asarray(toks))
        tl, tc = ttr.decode_step(tcfg, tparams, tc, torch.from_numpy(toks).long())
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    state = ttr.cache_state_dict(tc)
    back = ttr.KVCache(**ttr.cache_from_state_dict(state, device="cpu"))
    assert back.length == 12 and torch.equal(back.v, tc.v)
    # the suffix prefill over a cache holding the first 5 prompt rows
    jcache = jtr.KVCache(jc.k.at[:, :, 5:].set(0), jc.v.at[:, :, 5:].set(0),
                         jnp.asarray(5, jnp.int32))
    tk, tv = tc.k.clone(), tc.v.clone()
    tk[:, :, 5:] = 0
    tv[:, :, 5:] = 0
    jl, jc2 = jdec._prefill_suffix_impl(jcfg, jparams, jnp.asarray(ids[:, 5:]), jcache, None)
    tl, tc2 = tdec._prefill_suffix_impl(tcfg, tparams, torch.from_numpy(ids[:, 5:]).long(),
                                        ttr.KVCache(tk, tv, 5), None)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc2.k[:, :, :9].numpy(), _np(jc2.k)[:, :, :9], atol=1e-5,
                               rtol=1e-5)
    assert tc2.length == int(jc2.length) == 9
