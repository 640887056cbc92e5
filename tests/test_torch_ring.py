"""The port's ring attention and stage x seq runtime (``parallel/ring.py``)
against the TPU package's, on the CPU.

One set of weights (the JAX package's ``init_params``, carried across with
``params_from_jax_numpy``) and one batch of ids (numpy seed) go through both
packages; the JAX side runs on the 8-device CPU mesh of
``tests/conftest.py``, each ``shard_map`` call jitted (the reference's
``forward_sp``, ``importance_sp`` and ``SplitRingRuntime`` are jitted
already; the bare ``ring_attention`` is wrapped in ``jax.jit`` here).

Tolerances: attention outputs and logits atol / rtol 1e-5 (the two read
~5e-7 apart: both sum the same float32 blocks in the same ring order); the
statistics and importance atol 1e-6, the reference's own ring-vs-dense
bound (they read ~1e-8 apart); a split whose hop rounds to bf16 (the ring
selective codecs' high tokens) atol 1e-4, since a value the two forwards put
on either side of a bf16 rounding boundary moves one bf16 step
(``tests/test_torch_split.py``'s rule; the reference's own ring-vs-dense
bound is 2e-4). Skipping the masked blocks is held bit for bit, and so are
bytes per token and the faulty link's counters.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from edgellm_tpu.codecs.faults import FaultConfig as JFaultConfig
from edgellm_tpu.codecs.faults import LinkPolicy as JLinkPolicy
from edgellm_tpu.codecs.packing import get_wire_codec as j_get_wire_codec
from edgellm_tpu.codecs.ring_codecs import ring_selective_int4 as j_ring_selective_int4
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as jtiny
from edgellm_tpu.parallel import ring as jring
from edgellm_tpu.utils.jax_compat import shard_map
from edgellm_tpu_torch.codecs.faults import FaultConfig, LinkPolicy
from edgellm_tpu_torch.codecs.packing import get_wire_codec, selective_int4
from edgellm_tpu_torch.codecs.ring_codecs import ring_selective_int4
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models import forward
from edgellm_tpu_torch.models.transformer import params_to
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.obs.metrics import CounterSource
from edgellm_tpu_torch.parallel import SplitRingRuntime, forward_sp, importance_sp, ring_attention
from edgellm_tpu_torch.serve.recovery import StageLostError

TIGHT = dict(atol=1e-5, rtol=1e-5)
STATS_ATOL = 1e-6
BF16_HOP = dict(atol=1e-4, rtol=1e-4)
METHODS = ("regular_importance", "last_row", "aggregate_till", "weighted_importance")


def _cfgs(family, layers):
    kw = dict(num_layers=layers, hidden_size=32, num_heads=4, vocab_size=128)
    return jtiny(family, **kw), tcfg.tiny_config(family, **kw)


@pytest.fixture(scope="module")
def models():
    """qwen2 (4 layers, GQA: 2 KV heads) and gpt_neox (3 layers), the
    reference tests' sizes, with the same weights in both packages."""
    out = {}
    for family, layers, seed in (("qwen2", 4, 2), ("gpt_neox", 3, 3)):
        jc, tc = _cfgs(family, layers)
        jp = j_init(jc, jax.random.key(seed))
        tp = params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        out[family] = (jc, tc, jp, tp)
    return out


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(8).integers(0, 128, (2, 32))


def _shards(x: np.ndarray, n: int, axis: int = 1) -> list:
    return [torch.from_numpy(np.ascontiguousarray(p)) for p in np.split(x, n, axis=axis)]


def _qkv(seed=0, b=2, s=32, h=4, kv=2, hd=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


def _ref_ring(n, q, k, v, kv_codec=None):
    fn = jax.jit(shard_map(
        lambda q, k, v: jring.ring_attention(q, k, v, "seq", capture_stats=True,
                                             kv_codec=kv_codec),
        mesh=jring.make_seq_mesh(n), in_specs=(P(None, "seq"),) * 3,
        out_specs=(P(None, "seq"), (P(None, None, "seq"), P(None, None, "seq")))))
    out, (col, last) = fn(q, k, v)
    return np.asarray(out), np.asarray(col), np.asarray(last)


def _port_ring(n, q, k, v, **kw):
    outs, stats = ring_attention(_shards(q, n), _shards(k, n), _shards(v, n),
                                 capture_stats=True, **kw)
    return (torch.cat(outs, dim=1).numpy(), torch.cat([c for c, _ in stats], -1).numpy(),
            torch.cat([last for _, last in stats], -1).numpy())


@pytest.mark.parametrize("n_ring,kv_codec", [(2, None), (4, None), (4, "int8_per_token")])
def test_ring_attention_matches_reference(n_ring, kv_codec):
    """Outputs and statistics against the reference's ring under a jitted
    shard_map, GQA (4 query heads over 2 KV heads), with and without the
    ring's K / V codec."""
    q, k, v = _qkv()
    want = _ref_ring(n_ring, q, k, v, None if kv_codec is None else j_get_wire_codec(kv_codec))
    got = _port_ring(n_ring, q, k, v,
                     kv_codec=None if kv_codec is None else get_wire_codec(kv_codec))
    np.testing.assert_allclose(got[0], want[0], **TIGHT)
    np.testing.assert_allclose(got[1], want[1], atol=STATS_ATOL)
    np.testing.assert_allclose(got[2], want[2], atol=STATS_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_codec", [None, "int8_per_token"])
def test_skipping_masked_blocks_is_bit_exact(kv_codec, dtype):
    """The blocks wholly after a shard's queries (and, in the statistics
    pass, the query shards before a key block) add exact zeros: leaving them
    out gives the same bits, outputs and statistics."""
    n = 4
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(seed=1, s=64))
    parts = [list(torch.chunk(x, n, dim=1)) for x in (q, k, v)]
    codec = None if kv_codec is None else get_wire_codec(kv_codec)
    skip = ring_attention(*parts, capture_stats=True, kv_codec=codec)
    full = ring_attention(*parts, capture_stats=True, kv_codec=codec, skip_masked=False)
    for a, b in zip(skip[0], full[0]):
        assert a.dtype == dtype and torch.equal(a, b)
    for (ca, la), (cb, lb) in zip(skip[1], full[1]):
        assert torch.equal(ca, cb) and torch.equal(la, lb)


@pytest.mark.parametrize("family", ["qwen2", "gpt_neox"])
def test_forward_sp_matches_reference_and_dense(models, ids, family):
    """forward_sp over 4 shards against the reference's, and against the
    port's dense forward within the reference's ring-vs-dense 2e-4."""
    jc, tc, jp, tp = models[family]
    want = np.asarray(jring.forward_sp(jc, jp, jnp.asarray(ids), jring.make_seq_mesh(4)))
    got = forward_sp(tc, tp, torch.as_tensor(ids), 4, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    dense, _ = forward(tc, tp, torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="divisible"):
        forward_sp(tc, tp, torch.zeros((1, 30), dtype=torch.long), 4, device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_importance_sp_matches_reference(models, ids, method):
    """importance_sp over 4 shards, every method, against the reference's."""
    jc, tc, jp, tp = models["qwen2"]
    hw = None
    if method == "weighted_importance":
        hw = np.random.default_rng(3).random((jc.num_layers, jc.num_heads)).astype(np.float32)
        hw /= hw.sum(axis=1, keepdims=True)
    want = np.asarray(jring.importance_sp(jc, jp, jnp.asarray(ids), jring.make_seq_mesh(4),
                                          method, head_weights=hw))
    got = importance_sp(tc, tp, torch.as_tensor(ids), 4, method, head_weights=hw,
                        device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=STATS_ATOL)
    if method == "weighted_importance":
        with pytest.raises(ValueError, match="requires head_weights"):
            importance_sp(tc, tp, torch.as_tensor(ids), 4, method, device="cpu")


@pytest.fixture(scope="module")
def hop_imp(models, ids):
    """Per-row (2, S) last-row importance at cut 1, the reference's."""
    jc, _, jp, _ = models["qwen2"]
    return np.asarray(jring.importance_sp(jc, jp, jnp.asarray(ids), jring.make_seq_mesh(4),
                                          "last_row"))[1]


#: stage x seq hops: name -> (the port's codec, the reference's codec, tolerance)
RUNTIME_HOPS = {
    "fp32": ("fp32", "fp32", TIGHT),
    "int8_per_token": ("int8_per_token", "int8_per_token", TIGHT),
    "ring_global": (lambda: ring_selective_int4(0.25, "bf16", n_seq=4, mode="global"),
                    lambda: j_ring_selective_int4(0.25, "bf16", n_seq=4, mode="global"),
                    BF16_HOP),
    "ring_local": (lambda: ring_selective_int4(0.25, "bf16", n_seq=4, mode="local"),
                   lambda: j_ring_selective_int4(0.25, "bf16", n_seq=4, mode="local"),
                   BF16_HOP),
}


@pytest.mark.parametrize("hop", sorted(RUNTIME_HOPS))
def test_split_ring_runtime_matches_reference(models, ids, hop_imp, hop):
    """SplitRingRuntime (stage 2 x seq 4, cut 1) against the reference's:
    logits, and bytes per token exactly."""
    jc, tc, jp, tp = models["qwen2"]
    t_codec, j_codec, tol = RUNTIME_HOPS[hop]
    t_codec, j_codec = (c() if callable(c) else c for c in (t_codec, j_codec))
    imps = [hop_imp] if hop.startswith("ring") else None
    jrt = jring.SplitRingRuntime(jc, (1,), (j_codec,), jring.make_sp_stage_mesh(2, 4))
    want = np.asarray(jrt.forward(jrt.place_params(jp), jnp.asarray(ids), hop_importance=imps))
    rt = SplitRingRuntime(tc, (1,), (t_codec,), 4, "cpu")
    got = rt.forward(rt.place_params(tp), torch.as_tensor(ids),
                     hop_importance=None if imps is None else [torch.tensor(hop_imp)])
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert rt.bytes_per_token(32) == jrt.bytes_per_token(32)
    assert rt.hop_bytes(2, 32) == jrt.hop_bytes(2, 32)


def test_ring_runtime_zero_fault_bit_exact_and_faulty_counters(models):
    """The reference's ring-under-faults case (``tests/test_faults.py``):
    stage 2 x seq 2, an int8_per_token hop; a zero-rate link gives the
    link-free logits bit for bit with one hop a shard; at drop_rate 0.5,
    seed 11, four retries, six fault steps, the counters (summed over the
    shards) equal the reference's."""
    jc, tc, jp, tp = models["qwen2"]
    rids = np.random.default_rng(3).integers(0, 128, (1, 16))
    base = SplitRingRuntime(tc, (2,), ["int8_per_token"], 2, "cpu")
    out0 = base.forward(base.place_params(tp), torch.as_tensor(rids))
    rt = SplitRingRuntime(tc, (2,), ["int8_per_token"], 2, "cpu",
                          faults=FaultConfig(byte_budget=10**9), policy=LinkPolicy(max_retries=1))
    out1 = rt.forward(rt.place_params(tp), torch.as_tensor(rids), fault_step=2)
    assert torch.equal(out0, out1)
    assert rt.link_counters()["hops"].tolist() == [2]
    assert rt.link_counters()["detected"].tolist() == [0]

    jrt = jring.SplitRingRuntime(jc, (2,), ["int8_per_token"], jring.make_sp_stage_mesh(2, 2),
                                 faults=JFaultConfig(drop_rate=0.5, seed=11),
                                 policy=JLinkPolicy(max_retries=3))
    trt = SplitRingRuntime(tc, (2,), ["int8_per_token"], 2, "cpu",
                           faults=FaultConfig(drop_rate=0.5, seed=11),
                           policy=LinkPolicy(max_retries=3))
    jpl, tpl = jrt.place_params(jp), trt.place_params(tp)
    for step in range(6):
        want = np.asarray(jrt.forward(jpl, jnp.asarray(rids), fault_step=step))
        got = trt.forward(tpl, torch.as_tensor(rids), fault_step=step)
        np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    jc_, tc_ = jrt.link_counters(), trt.link_counters()
    assert sorted(jc_) == sorted(tc_)
    assert {k: np.asarray(v).tolist() for k, v in tc_.items()} == \
        {k: np.asarray(v).tolist() for k, v in jc_.items()}
    assert tc_["hops"].tolist() == [12] and tc_["detected"][0] > 0


def test_ring_runtime_refusals_and_surface(models, ids):
    """The reference's refusals, stage loss, the CounterSource surface, and
    a sharded hop timing on the CPU."""
    _, tc, _, tp = models["qwen2"]
    with pytest.raises(ValueError, match="per-token or ring-aware"):
        SplitRingRuntime(tc, (1,), ("int4_global",), 2, "cpu")
    with pytest.raises(ValueError, match="ring-aware"):
        SplitRingRuntime(tc, (1,), (selective_int4(0.25),), 2, "cpu")
    with pytest.raises(ValueError, match="ring codec"):
        SplitRingRuntime(tc, (1,), (ring_selective_int4(0.25, n_seq=4),), 2, "cpu")
    with pytest.raises(ValueError, match="positive integer"):
        SplitRingRuntime(tc, (1,), ("fp32",), 0, "cpu")
    rt = SplitRingRuntime(tc, (1,), (ring_selective_int4(0.25, n_seq=4),), 4, "cpu")
    placed = rt.place_params(tp)
    with pytest.raises(ValueError, match="requires an importance vector"):
        rt.forward(placed, torch.as_tensor(ids))
    with pytest.raises(ValueError, match="needs per-row"):
        rt.forward(placed, torch.as_tensor(ids), hop_importance=[torch.zeros(32)])
    with pytest.raises(ValueError, match="divisible"):
        rt.forward(placed, torch.as_tensor(ids[:, :30]), hop_importance=[torch.zeros(2, 30)])
    assert isinstance(rt, CounterSource)
    assert rt.decode_hop_bytes(4) == [] and rt.link_counters() is None
    bf16 = rt.place_params(params_to(tp, dtype=torch.bfloat16))
    assert all(lp["wq"].dtype == torch.bfloat16 for lp in bf16["stages"][0])  # the hop
    assert all(lp["wq"].dtype == torch.float32 for lp in bf16["stages"][1])  # promotes the rest
    assert len(rt.time_hops(1, 32, iters=2)) == 1
    with pytest.raises(ValueError, match="divisible"):
        rt.time_hops(1, 30)
    rt.mark_stage_lost(1)
    with pytest.raises(StageLostError):
        rt.forward(placed, torch.as_tensor(ids), hop_importance=[torch.zeros(2, 32)])
    with pytest.raises(ValueError, match="out of range"):
        rt.mark_stage_lost(2)
