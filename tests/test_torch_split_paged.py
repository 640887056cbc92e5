"""The port's split-paged batcher held against the JAX package's on the CPU:
``SplitRuntime``'s paged half (``init_paged_pool``, ``adopt_paged*``,
``copy_paged_pages``, ``gather_paged*``, ``decode_step_paged``) and the
continuous batcher's ``split_runtime=`` mode.

One set of weights (the reference's ``init_params`` at the size of
``tests/test_torch_split_decode.py``: 6 layers, D = 32, 4 heads, V = 128)
crosses with ``params_from_jax_numpy``; the reference runs on the 8-device
CPU mesh of ``tests/conftest.py``. ``EDGELLM_FUSED_HOP`` is pinned to the
separate hop while a runtime is built (both packages read it then).

Tolerances: teacher-forced logits within 2e-5 with fp32 hops (the forwards
agree to ~1e-6), 1e-3 with int8 hops (a hidden that rounds on a code
boundary moves one code); fp pool rows within 1e-5; quantized codes at most
one step apart, their scales within 1e-5. The port's own round trips (adopt
-> gather, the packed payloads, COW copies) bit for bit. Token streams
exactly: greedy tokens are argmaxes of those logits and sampled tokens use
the same random bits (``utils/prng.py``).
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as j_tiny
from edgellm_tpu.models.paged_kv import PagedKVCache as JPagedKVCache
from edgellm_tpu.models.paged_kv import PrefixCacheConfig as JPrefix
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh
from edgellm_tpu.serve import batching as jb
from edgellm_tpu_torch.codecs.packing import selective_int4
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.models.paged_kv import (KVTierMismatchError, PagedKVCache,
                                               PrefixCacheConfig)
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve import batching as tb
from edgellm_tpu_torch.serve.decode import generate_split
from edgellm_tpu_torch.utils import prng

JCFG = j_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TIERS = ("fp", "int8_per_channel", "int4_per_channel")
LOGIT_TOL = {"fp32": 2e-5, "int8_per_token": 1e-3, "int8_per_channel": 1e-3}
ROW_TOL = 1e-5


@contextlib.contextmanager
def _separate_hops():
    saved = os.environ.get("EDGELLM_FUSED_HOP")
    os.environ["EDGELLM_FUSED_HOP"] = "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("EDGELLM_FUSED_HOP")
        else:
            os.environ["EDGELLM_FUSED_HOP"] = saved


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.key(1))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


_RUNTIMES: dict = {}


def _runtimes(weights, cuts, codecs):
    """(reference runtime, its placed weights, port runtime, its placed
    weights), built once a plan for the module (the reference's compiled
    steps stay cached on its runtime)."""
    key = (cuts, codecs)
    if key not in _RUNTIMES:
        jp, tp = weights
        n = len(cuts) + 1
        with _separate_hops():
            jrt = JSplitRuntime(JCFG, JSplitConfig(cuts=cuts, hop_codecs=codecs),
                                make_stage_mesh(n))
            trt = SplitRuntime(TCFG, SplitConfig(cuts=cuts, hop_codecs=codecs), ["cpu"] * n)
        _RUNTIMES[key] = (jrt, jrt.place_params(jp), trt, trt.place_params(tp))
    return _RUNTIMES[key]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 128, n).astype(np.int32)


def _adopt_both(jrt, jplaced, trt, tplaced, host, jpool, tpool, prompt, capacity):
    """One prompt prefilled on both runtimes and adopted into a fresh slot
    of the shared host allocator -> (slot, jpool, tpool)."""
    n = prompt.size
    _, jcache = jrt.prefill_decode(jplaced, jnp.asarray(prompt[None]), capacity)
    _, tcache = trt.prefill_decode(tplaced, torch.from_numpy(prompt[None]).long(), capacity)
    slot = host.alloc_slot()
    host.ensure(slot, n)
    dest = host._flat_indices(slot, n)
    jpool = jrt.adopt_paged(jpool, jcache, 0, dest, n)
    tpool = trt.adopt_paged(tpool, tcache, 0, dest, n)
    host.lengths[slot] = n
    return slot, jpool, tpool, tcache


def _assert_packed_close(got: tuple, want: tuple, kv_codec: str):
    """Quantized payloads: codes at most one step apart (each int4 nibble
    apart), scales within ROW_TOL."""
    for g, w in zip(got[:2], want[:2]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if kv_codec == "int4_per_channel":
            for shift in (0, 4):
                d = ((g >> shift) & 0xF).astype(np.int16) - ((w >> shift) & 0xF)
                assert np.abs(d).max() <= 1
        else:
            assert np.abs(g.astype(np.int16) - w).max() <= 1
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, np.asarray(w), atol=ROW_TOL, rtol=ROW_TOL)


# ---------------------------------------------------------------------------
# Pools: shapes, adopt / gather / COW against the reference, round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_codec", TIERS)
def test_init_paged_pool_shapes_and_dtypes(weights, kv_codec):
    """Per-stage pools of each stage's own layers: the reference's
    (n_stages, stage_size, ...) pool stage by stage without the padding
    layers, the same dtypes, zeroed, and the tier tag."""
    jrt, _, trt, _ = _runtimes(weights, (2, 4), ("int8_per_token",) * 2)
    jpool = jrt.init_paged_pool(9, 4, kv_codec=kv_codec)
    tpool = trt.init_paged_pool(9, 4, kv_codec=kv_codec)
    assert set(tpool) == set(jpool)
    assert trt.stage_size == jrt.stage_size == 3
    for name, arrs in zip(("k", "v", "k_scale", "v_scale"), trt._pool_arrays(tpool)):
        want = jpool[name]
        assert len(arrs) == 3
        for s, ((a, b), arr) in enumerate(zip(trt.bounds, arrs)):
            assert tuple(arr.shape) == (b - a,) + tuple(want.shape[2:])
            assert str(arr.dtype).split(".")[-1] == str(want.dtype)
            assert not arr.any()
    assert trt._pool_codec(tpool) == jrt._pool_codec(jpool) == kv_codec
    with pytest.raises(ValueError, match="num_pages >= 2"):
        trt.init_paged_pool(1, 4)


@pytest.mark.parametrize("kv_codec", TIERS)
def test_adopt_gather_copy_match_reference_and_round_trip(weights, kv_codec):
    """Two prompts adopted at cuts (2, 4) (stages of 3, 2 and 1 layers: two
    padded): ``gather_paged`` equals the reference's rows (padding layers
    zero) and, on the fp tier, the prefill cache's rows bit for bit;
    ``copy_paged_pages`` moves the reference's pages; the packed payload
    round-trips bit for bit through ``adopt_paged_rows_packed`` and the fp
    one through ``adopt_paged_rows``."""
    jrt, jplaced, trt, tplaced = _runtimes(weights, (2, 4), ("int8_per_token",) * 2)
    host = PagedKVCache(TCFG, num_pages=13, page_size=4, max_slots=4, pages_per_slot=4,
                        device="cpu", materialize=False, kv_codec=kv_codec)
    jpool = jrt.init_paged_pool(13, 4, kv_codec=kv_codec)
    tpool = trt.init_paged_pool(13, 4, kv_codec=kv_codec)
    slots, caches = [], []
    for seed, n in ((1, 7), (2, 10)):
        slot, jpool, tpool, tcache = _adopt_both(jrt, jplaced, trt, tplaced, host, jpool,
                                                 tpool, _prompt(seed, n), 16)
        slots.append(slot)
        caches.append(tcache)
    for slot, cache in zip(slots, caches):
        n = int(host.lengths[slot])
        idx = host._flat_indices(slot, n)
        got = trt.gather_paged(tpool, idx)
        want = jrt.gather_paged(jpool, idx)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (3, 3, n, 2, 8) and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, atol=1e-3 if kv_codec != "fp" else ROW_TOL,
                                       rtol=0)
        for s, (a, b) in enumerate(trt.bounds):
            assert not got[0][s, b - a:].any() and not got[1][s, b - a:].any()
            if kv_codec == "fp":
                np.testing.assert_array_equal(got[0][s, :b - a], cache["k"][s][:, 0, :n].numpy())
                np.testing.assert_array_equal(got[1][s, :b - a], cache["v"][s][:, 0, :n].numpy())
        if kv_codec != "fp":
            packed = trt.gather_paged_packed(tpool, idx)
            want_packed = jrt.gather_paged_packed(jpool, idx)
            real = [np.concatenate([p[s, :b - a] for s, (a, b) in enumerate(trt.bounds)])
                    for p in packed]
            want_real = [np.concatenate([np.asarray(p)[s, :b - a]
                                         for s, (a, b) in enumerate(trt.bounds)])
                         for p in want_packed]
            _assert_packed_close(real, want_real, kv_codec)
    # COW: copy slot 0's first page onto a free page, on both sides
    src, dst = [int(host.page_table[slots[0], 0])], [12]
    jpool = jrt.copy_paged_pages(jpool, src, dst)
    tpool = trt.copy_paged_pages(tpool, src, dst)
    idx = np.arange(12 * 4, 13 * 4)
    for g, w in zip(trt.gather_paged(tpool, idx), jrt.gather_paged(jpool, idx)):
        np.testing.assert_allclose(g, w, atol=1e-3 if kv_codec != "fp" else ROW_TOL, rtol=0)
    np.testing.assert_array_equal(trt.gather_paged(tpool, idx)[0],
                                  trt.gather_paged(tpool, np.arange(src[0] * 4,
                                                                    src[0] * 4 + 4))[0])
    # round trips into a fresh slot
    n = int(host.lengths[slots[1]])
    idx = host._flat_indices(slots[1], n)
    slot = host.alloc_slot()
    host.ensure(slot, n)
    dest = host._flat_indices(slot, n)
    if kv_codec == "fp":
        k_seq, v_seq = trt.gather_paged(tpool, idx)
        trt.adopt_paged_rows(tpool, k_seq, v_seq, dest)
        for a, b in zip(trt.gather_paged(tpool, dest), (k_seq, v_seq)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(KVTierMismatchError, match="quantized"):
            trt.gather_paged_packed(tpool, idx)
        with pytest.raises(KVTierMismatchError, match="quantized"):
            trt.adopt_paged_rows_packed(tpool, k_seq, v_seq, k_seq, v_seq, dest)
    else:
        packed = trt.gather_paged_packed(tpool, idx)
        trt.adopt_paged_rows_packed(tpool, *packed, dest)
        for a, b in zip(trt.gather_paged_packed(tpool, dest), packed):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The ragged split step against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cuts,codec,kv_codec", [
    ((2,), "fp32", "fp"), ((2,), "int8_per_token", "fp"),
    ((2,), "int8_per_channel", "int8_per_channel"), ((2,), "int8_per_token", "int4_per_channel"),
    ((2, 4), "int8_per_token", "fp"), ((2, 4), "fp32", "int8_per_channel"),
    ((2, 4), "int8_per_channel", "fp"), ((2, 4), "int8_per_token", "int4_per_channel"),
])
def test_decode_step_paged_matches_reference(weights, cuts, codec, kv_codec):
    """Three streams of ragged prompt lengths in slots 0, 1 and 3 of four
    (slot 2 inactive, on the trash page), teacher-forced over 6 ragged
    steps: every step's logits and then every slot's pool rows against the
    reference's."""
    codecs = (codec,) * len(cuts)
    jrt, jplaced, trt, tplaced = _runtimes(weights, cuts, codecs)
    host = PagedKVCache(TCFG, num_pages=16, page_size=4, max_slots=4, pages_per_slot=5,
                        device="cpu", materialize=False, kv_codec=kv_codec)
    jpool = jrt.init_paged_pool(16, 4, kv_codec=kv_codec)
    tpool = trt.init_paged_pool(16, 4, kv_codec=kv_codec)
    active = []
    for i, n in enumerate((5, 9, 0, 3)):
        if n == 0:
            host.alloc_slot()  # slot 2 stays inactive
            continue
        slot, jpool, tpool, _ = _adopt_both(jrt, jplaced, trt, tplaced, host, jpool, tpool,
                                            _prompt(10 + i, n), 20)
        active.append(slot)
    host.free_slot(2)
    forced = np.random.default_rng(4).integers(1, 128, (6, 4)).astype(np.int32)
    for t in range(6):
        for slot in active:
            host.ensure(slot, int(host.lengths[slot]) + 1)
        pt, lens = host.device_tables()
        want, jpool = jrt.decode_step_paged(jplaced, jpool, jnp.asarray(pt.numpy()),
                                            jnp.asarray(lens.numpy()), jnp.asarray(forced[t]))
        got, tpool = trt.decode_step_paged(tplaced, tpool, pt, lens,
                                           torch.from_numpy(forced[t]))
        assert got.dtype == torch.float32 and got.shape == (4, 128)
        np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active],
                                   atol=LOGIT_TOL[codec], rtol=LOGIT_TOL[codec])
        for slot in active:
            host.lengths[slot] += 1
    for slot in active:
        idx = host._flat_indices(slot, int(host.lengths[slot]))
        if kv_codec == "fp":
            for g, w in zip(trt.gather_paged(tpool, idx), jrt.gather_paged(jpool, idx)):
                np.testing.assert_allclose(g, w, atol=ROW_TOL, rtol=0)
        else:
            got_p = trt.gather_paged_packed(tpool, idx)
            want_p = jrt.gather_paged_packed(jpool, idx)
            real = lambda p: [np.concatenate([np.asarray(a)[s, :b - c] for s, (c, b)  # noqa
                                              in enumerate(trt.bounds)]) for a in p]
            _assert_packed_close(real(got_p), real(want_p), kv_codec)


def test_decode_step_paged_bf16_weights(weights):
    """bf16 weights over the batcher's default float32 pools: the bf16 stage
    0 rounds where the reference rounds its own; stage 1 computes in float32
    behind the separate hop; logits within 1e-2 of the reference's."""
    jp = j_init(JCFG, jax.random.key(1), dtype=jnp.bfloat16)
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                               dtype=torch.bfloat16)
    with _separate_hops():
        jrt = JSplitRuntime(JCFG, JSplitConfig((2,), ("int8_per_token",)), make_stage_mesh(2))
        trt = SplitRuntime(TCFG, SplitConfig((2,), ("int8_per_token",)), ["cpu"] * 2)
    jplaced, tplaced = jrt.place_params(jp), trt.place_params(tp)
    host = PagedKVCache(TCFG, num_pages=9, page_size=4, max_slots=2, pages_per_slot=4,
                        device="cpu", materialize=False)
    jpool, tpool = jrt.init_paged_pool(9, 4), trt.init_paged_pool(9, 4)
    assert [p.dtype for p in tpool["k"]] == [torch.float32] * 2
    assert all(lp["wq"].dtype == torch.float32 for lp in tplaced["stages"][1])
    for seed, n in ((1, 6), (2, 3)):
        _, jpool, tpool, _ = _adopt_both(jrt, jplaced, trt, tplaced, host, jpool, tpool,
                                         _prompt(seed, n), 16)
    for t in range(3):
        for slot in (0, 1):
            host.ensure(slot, int(host.lengths[slot]) + 1)
        pt, lens = host.device_tables()
        toks = np.asarray([5 + t, 9 + t], np.int32)
        want, jpool = jrt.decode_step_paged(jplaced, jpool, jnp.asarray(pt.numpy()),
                                            jnp.asarray(lens.numpy()), jnp.asarray(toks))
        got, tpool = trt.decode_step_paged(tplaced, tpool, pt, lens, torch.from_numpy(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2, rtol=0)
        host.lengths[:2] += 1


# ---------------------------------------------------------------------------
# The split batcher against the reference's
# ---------------------------------------------------------------------------


def _workload(seed, n=5, shared=0):
    """(prompts, temperatures, seeds): prompts of three lengths (each length
    is one reference prefill executable), every other stream at T = 0.7."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 128, shared)
    prompts = [np.concatenate([head, rng.integers(1, 128, (3, 5, 8)[i % 3])]).astype(np.int32)
               for i in range(n)]
    return prompts, [0.7 if i % 2 else 0.0 for i in range(n)], list(range(20, 20 + n))


def _run_batchers(weights, cuts, codecs, bkw, prompts, temps, seeds, new=6, evict_at=None):
    jrt, jplaced, trt, tplaced = _runtimes(weights, cuts, codecs)
    jp, tp = weights
    out = []
    for mod, cfg, params, rt, placed in ((tb, TCFG, tp, trt, tplaced),
                                         (jb, JCFG, jp, jrt, jplaced)):
        kw = dict(bkw)
        if "prefix_cache" in kw and mod is jb:
            kw["prefix_cache"] = JPrefix(**vars(kw["prefix_cache"]))
        b = mod.ContinuousBatcher(cfg, params, mod.BatchingConfig(**kw), split_runtime=rt,
                                  placed_params=placed)
        sids = [b.submit(p, new, temperature=t, rng_seed=s)
                for p, t, s in zip(prompts, temps, seeds)]
        for step in range(200):
            if step == evict_at:
                b.evict(sids[0])
            if not b.step() and not b._waiting:
                break
        b.pool.check_invariants()
        out.append(([np.asarray(b.results[s]) for s in sids], b.report()))
    return out


@pytest.mark.parametrize("case", ["roomy", "tight", "prefix", "evict_int4"])
def test_split_batcher_streams_equal_reference_batcher(weights, case):
    """Greedy and sampled streams of the split batcher, token for token
    against the reference's ``ContinuousBatcher(split_runtime=...)``: a
    roomy pool, a tight one (evictions, fp payloads), prefix sharing (hits,
    a suffix through ``verify_step``, COW forks) and a forced evict /
    resume over int4 pages (packed payloads); the same scheduling counters."""
    cuts, codecs = ((2,), ("int8_per_token",)) if case != "evict_int4" else (
        (2, 4), ("int8_per_token", "int8_per_channel"))
    bkw = {"roomy": dict(page_size=4, num_pages=24, max_slots=3, pages_per_slot=5),
           "tight": dict(page_size=4, num_pages=9, max_slots=3, pages_per_slot=5),
           "prefix": dict(page_size=4, num_pages=24, max_slots=3, pages_per_slot=6,
                          prefix_cache=PrefixCacheConfig(min_shared_block=4)),
           "evict_int4": dict(page_size=4, num_pages=24, max_slots=3, pages_per_slot=5,
                              kv_codec="int4_per_channel")}[case]
    prompts, temps, seeds = _workload(3, shared=9 if case == "prefix" else 0)
    (got, trep), (want, jrep) = _run_batchers(
        weights, cuts, codecs, bkw, prompts, temps, seeds,
        evict_at=2 if case == "evict_int4" else None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for key in ("streams", "finished", "steps", "admitted", "evicted", "span",
                "token_capacity"):
        assert trep[key] == jrep[key], key
    assert trep["mode"] == "paged_split" and trep["cuts"] == list(cuts)
    if case in ("tight", "evict_int4"):
        assert trep["evicted"] > 0
    if case == "prefix":
        assert trep["prefix"]["hits"] == jrep["prefix"]["hits"] >= 1
        for key in ("saved_tokens", "cow_forks", "shared_pages", "index_nodes"):
            assert trep["prefix"][key] == jrep["prefix"][key], key


@pytest.mark.parametrize("kv_codec", ["fp", "int8_per_channel"])
def test_split_batcher_per_token_hops_equal_generate_split(weights, kv_codec):
    """Per-token hops are row-local, so every stream of the split batcher
    (evicted or prefix-shared too) equals the stream alone through the
    port's ``generate_split`` on the fp tier; on the int8 tier the greedy
    streams do here too (the codes' error moves no argmax)."""
    _, _, trt, tplaced = _runtimes(weights, (1, 3), ("int8_per_token", "fp32"))
    _, tp = weights
    prompts, temps, seeds = _workload(5, n=6, shared=4)
    b = tb.ContinuousBatcher(TCFG, tp, tb.BatchingConfig(
        page_size=4, num_pages=9, max_slots=3, pages_per_slot=6, kv_codec=kv_codec,
        prefix_cache=PrefixCacheConfig(min_shared_block=2)), split_runtime=trt,
        placed_params=tplaced)
    sids = [b.submit(p, 6, temperature=t, rng_seed=s) for p, t, s in zip(prompts, temps, seeds)]
    res = b.run()
    b.pool.check_invariants()
    rep = b.report()
    assert rep["evicted"] > 0 and rep["prefix"]["hits"] > 0
    for sid, p, t, s in zip(sids, prompts, temps, seeds):
        if kv_codec != "fp" and t > 0:
            continue
        alone = generate_split(trt, tplaced, p[None], 6, capacity=24, temperature=t,
                               rng_key=prng.key(s))
        np.testing.assert_array_equal(res[sid], alone[0].numpy())


def test_split_batcher_refusals_match_reference(weights):
    """Every refusal the reference keeps raises with its message; a
    bookkeeping-only allocator refuses every method that needs its pool."""
    jrt, jplaced, trt, tplaced = _runtimes(weights, (2,), ("int8_per_token",))
    jp, tp = weights
    for kw, bcfg in (({"split_runtime": "rt"}, {}),
                     ({"split_runtime": "rt", "placed_params": "placed"},
                      {"compute_dtype": "bf16"})):
        jkw = {k: {"rt": jrt, "placed": jplaced}[v] for k, v in kw.items()}
        tkw = {k: {"rt": trt, "placed": tplaced}[v] for k, v in kw.items()}
        with pytest.raises(ValueError) as want:
            jb.ContinuousBatcher(JCFG, jp, jb.BatchingConfig(
                **{k: jnp.bfloat16 for k in bcfg}), **jkw)
        with pytest.raises(ValueError) as got:
            tb.ContinuousBatcher(TCFG, tp, tb.BatchingConfig(
                **{k: torch.bfloat16 for k in bcfg}), **tkw)
        assert str(got.value) == str(want.value)
    sel = SplitRuntime(TCFG, SplitConfig((2,), (selective_int4(0.5),)), ["cpu"] * 2)
    with pytest.raises(ValueError, match="token-selective"):
        tb.ContinuousBatcher(TCFG, tp, split_runtime=sel, placed_params=sel.place_params(tp))
    host = PagedKVCache(TCFG, num_pages=5, page_size=4, max_slots=2, pages_per_slot=2,
                        device="cpu", materialize=False, kv_codec="int8_per_channel")
    jhost = JPagedKVCache(JCFG, num_pages=5, page_size=4, max_slots=2, pages_per_slot=2,
                          materialize=False, kv_codec="int8_per_channel")
    assert host.pool is None and jhost.pool is None
    rows = np.zeros((6, 2, 2, 8), np.float32)
    for name, call in (("adopt", lambda c: c.adopt(0, rows, rows, 2)),
                       ("adopt_rows", lambda c: c.adopt_rows(0, rows, rows, 0, 2)),
                       ("gather_slot", lambda c: c.gather_slot(0)),
                       ("gather_slot_packed", lambda c: c.gather_slot_packed(0)),
                       ("defrag", lambda c: c.defrag()),
                       ("state_dict", lambda c: c.state_dict())):
        for cache in (host, jhost):
            cache.alloc_slot() if not cache.active[0] else None
            with pytest.raises(ValueError, match=f"{name} needs a materialized pool"):
                call(cache)
    # growth needs no pool: ensure_writable allocates and copies nothing
    assert host.ensure_writable(0, 4) == [] and host.pages_for(4) == len(host._slot_pages[0])
