"""The port's split decode held against the JAX package's on the CPU:
``SplitRuntime.prefill_decode`` / ``decode_step`` / ``verify_step``, the
per-stage cache dtypes, the decode and verify hop bytes, and
``generate_split``.

One set of weights (the reference's ``init_params`` at the size of its
``tests/test_decode.py`` ``SPLIT_CFG``: 6 layers, D = 32, 4 heads, V = 128)
crosses with ``params_from_jax_numpy``; the reference runs on the 8-device
CPU mesh of ``tests/conftest.py``. ``EDGELLM_FUSED_HOP`` is pinned per case:
the reference's default reads its own probe cache.

Tolerances: float32 logits within 2e-5 (the reference's own split-decode
tolerance; the forwards agree to ~1e-6 and the codecs are bit-exact). Token
streams exactly: greedy tokens are argmaxes of those logits, sampled tokens
use the same random bits (``utils/prng.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.codecs.packing import selective_int4 as j_selective_int4
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as j_tiny
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh
from edgellm_tpu.serve.decode import generate_split as j_generate_split
from edgellm_tpu_torch.codecs.packing import selective_int4
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve.decode import generate, generate_split
from edgellm_tpu_torch.utils import prng

JCFG = j_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _separate_hops(monkeypatch):
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.key(1))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _ids(seed, b, s):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(np.int32)


def _runtimes(cuts, codecs):
    n = len(cuts) + 1
    jrt = JSplitRuntime(JCFG, JSplitConfig(cuts=cuts, hop_codecs=codecs), make_stage_mesh(n))
    trt = SplitRuntime(TCFG, SplitConfig(cuts=cuts, hop_codecs=codecs), ["cpu"] * n)
    return jrt, trt


def _teacher_forced(rt, placed, ids, prompt_len, capacity, as_np):
    """Prefill logits and every teacher-forced decode step's logits."""
    pre, cache = rt.prefill_decode(placed, ids[:, :prompt_len], capacity)
    steps = []
    for t in range(prompt_len, ids.shape[1]):
        logits, cache = rt.decode_step(placed, cache, ids[:, t])
        steps.append(as_np(logits))
    return as_np(pre), steps, cache


@pytest.mark.parametrize("cuts,codecs", [
    ((2,), ("int8_per_token",)), ((2,), ("fp32",)),
    ((1, 3), ("int8_per_token", "int8_per_token")), ((1, 3), ("fp32", "int4_per_token")),
])
def test_split_decode_logits_match_reference(weights, cuts, codecs):
    jp, tp = weights
    jrt, trt = _runtimes(cuts, codecs)
    ids = _ids(21, 2, 14)
    want_pre, want_steps, _ = _teacher_forced(jrt, jrt.place_params(jp), jnp.asarray(ids),
                                              7, 16, np.asarray)
    got_pre, got_steps, cache = _teacher_forced(
        trt, trt.place_params(tp), torch.from_numpy(ids).long(), 7, 16,
        lambda t: t.numpy())
    np.testing.assert_allclose(got_pre, want_pre, **TOL)
    assert len(got_steps) == len(want_steps) == 7
    for got, want in zip(got_steps, want_steps):
        assert got.shape == (2, 128)
        np.testing.assert_allclose(got, want, **TOL)
    assert cache["length"] == 14 and cache["capacity"] == 16
    assert [k.shape[0] for k in cache["k"]] == [b - a for a, b in trt.bounds]


def test_split_decode_bf16_weights_cache_dtype_and_rows(weights):
    """bf16 weights behind a separate hop: stage 1 computes in float32 and
    the reference stores its K/V in the one cache's bf16; the port's stage-1
    cache is bf16 too, with the reference's rows, and the logits agree."""
    jp = j_init(JCFG, jax.random.key(1), dtype=jnp.bfloat16)
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                               dtype=torch.bfloat16)
    jrt, trt = _runtimes((2,), ("int8_per_token",))
    ids = _ids(5, 1, 10)
    jplaced, tplaced = jrt.place_params(jp), trt.place_params(tp)
    want_pre, jcache = jrt.prefill_decode(jplaced, jnp.asarray(ids[:, :6]), 12)
    got_pre, tcache = trt.prefill_decode(tplaced, torch.from_numpy(ids[:, :6]).long(), 12)
    for t in range(6, 10):
        want, jcache = jrt.decode_step(jplaced, jcache, jnp.asarray(ids[:, t]))
        got, tcache = trt.decode_step(tplaced, tcache, torch.from_numpy(ids[:, t]).long())
    assert jcache["k"].dtype == jnp.bfloat16
    assert [k.dtype for k in tcache["k"]] == [torch.bfloat16] * 2
    assert [v.dtype for v in tcache["v"]] == [torch.bfloat16] * 2
    # stage 1 computes in fp32
    assert all(lp["wq"].dtype == torch.float32 for lp in tplaced["stages"][1])
    # bf16 stage 0 rounds at other places in the two frameworks (as in
    # test_torch_split): rows within two bf16 steps at |x| < 0.5, logits
    # within 1e-2
    for s, (a, b) in enumerate(trt.bounds):
        for name in ("k", "v"):
            want_rows = np.asarray(jcache[name][s, :b - a].astype(jnp.float32))
            assert np.abs(want_rows).max() < 0.5
            np.testing.assert_allclose(tcache[name][s].float().numpy(), want_rows,
                                       atol=2 ** -8, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2, rtol=0)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), atol=1e-2, rtol=0)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_verify_step_equals_k_decode_steps(weights, k):
    """One verify burst of k tokens writes the rows and returns the logits
    of k stepwise decode steps, and the reference's verify_step's."""
    jp, tp = weights
    jrt, trt = _runtimes((1, 3), ("int8_per_token", "fp32"))
    ids = _ids(8, 1, 6 + k)
    placed = trt.place_params(tp)
    tids = torch.from_numpy(ids).long()
    _, c1 = trt.prefill_decode(placed, tids[:, :6], 12)
    burst, c1 = trt.verify_step(placed, c1, tids[:, 6:])
    _, c2 = trt.prefill_decode(placed, tids[:, :6], 12)
    for j in range(k):
        step, c2 = trt.decode_step(placed, c2, tids[:, 6 + j])
        np.testing.assert_allclose(burst[:, j].numpy(), step.numpy(), **TOL)
    assert c1["length"] == c2["length"] == 6 + k
    for a, b in zip(c1["k"] + c1["v"], c2["k"] + c2["v"]):
        torch.testing.assert_close(a, b, **TOL)
    jplaced = jrt.place_params(jp)
    _, jc = jrt.prefill_decode(jplaced, jnp.asarray(ids[:, :6]), 12)
    want, _ = jrt.verify_step(jplaced, jc, jnp.asarray(ids[:, 6:]))
    np.testing.assert_allclose(burst.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("codecs", [("int8_per_token", "int4_per_token"),
                                    ("fp32", "int8_per_channel")])
def test_decode_and_verify_hop_bytes_equal_reference(codecs):
    jrt, trt = _runtimes((1, 3), codecs)
    for b in (1, 2, 5):
        assert trt.decode_hop_bytes(b) == jrt.decode_hop_bytes(b)
        for k in (1, 4):
            assert trt.verify_hop_bytes(b, k) == jrt.verify_hop_bytes(b, k)
    assert trt.decode_hop_bytes(2)[0] == 2 * (TCFG.hidden_size + 8) or codecs[0] == "fp32"


def test_split_decode_refuses_token_selective_hops(weights):
    _, tp = weights
    rt = SplitRuntime(TCFG, SplitConfig(cuts=(2,), hop_codecs=(selective_int4(0.5),)),
                      ["cpu", "cpu"])
    jrt = JSplitRuntime(JCFG, JSplitConfig(cuts=(2,), hop_codecs=(j_selective_int4(0.5),)),
                        make_stage_mesh(2))
    ids = torch.from_numpy(_ids(3, 1, 4)).long()
    with pytest.raises(ValueError, match="importance") as got:
        rt.prefill_decode(rt.place_params(tp), ids, 8)
    with pytest.raises(ValueError, match="importance") as want:
        jrt.prefill_decode(jrt.place_params(weights[0]), jnp.asarray(ids.numpy()), 8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="capacity"):
        SplitRuntime(TCFG, SplitConfig((2,), ("fp32",)), ["cpu"] * 2).prefill_decode(
            rt.place_params(tp), ids, 3)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("cuts,codecs", [((2,), ("int8_per_token",)),
                                         ((1, 3), ("int8_per_token", "int4_per_token"))])
def test_generate_split_tokens_equal_reference(weights, cuts, codecs, temperature):
    jp, tp = weights
    jrt, trt = _runtimes(cuts, codecs)
    prompt = _ids(13, 2, 6)
    for seed in (0, 7):
        want = j_generate_split(jrt, jrt.place_params(jp), prompt, 9, capacity=16,
                                temperature=temperature, rng_key=jax.random.key(seed))
        stats: dict = {}
        got = generate_split(trt, trt.place_params(tp), prompt, 9, capacity=16,
                             temperature=temperature, rng_key=prng.key(seed), stats=stats)
        assert got.dtype == torch.int32 and got.shape == (2, 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == {"capacity", "prefill_s", "decode_s", "decode_steps",
                          "decode_tokens_per_s"}
    assert stats["capacity"] == 16 and stats["decode_steps"] == 8


def test_generate_split_fp32_hop_equals_generate(weights):
    """An fp32 hop is lossless: greedy split tokens equal the unsplit
    ``generate``'s, and so do those of the survivable loop with every
    recovery feature off (its counters all zero) and of a call observed by
    a link-health tracker (no link: one empty observation)."""
    from edgellm_tpu_torch.codecs.fec import LinkHealth
    from edgellm_tpu_torch.serve.recovery import RecoveryConfig

    _, tp = weights
    rt = SplitRuntime(TCFG, SplitConfig((2,), ("fp32",)), ["cpu"] * 2)
    prompt = _ids(4, 3, 5)
    want = generate(TCFG, tp, prompt, 8).numpy()
    np.testing.assert_array_equal(generate_split(rt, rt.place_params(tp), prompt, 8).numpy(),
                                  want)
    stats = {}
    for kw in ({"recovery": RecoveryConfig()}, {"link_health": LinkHealth()}):
        got = generate_split(rt, rt.place_params(tp), prompt, 8, stats=stats, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    assert not any(stats["recovery_counters"].values())
    assert stats["link_health"]["observations"] == 1 and stats["link_health"]["tier"] == 0
    with pytest.raises(ValueError, match="capacity overflow"):
        generate_split(rt, rt.place_params(tp), prompt, 8, capacity=10)
