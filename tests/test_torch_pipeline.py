"""The port's µ-batch pipeline held against the JAX package's on the CPU:
``PipelineConfig``, the pipelined ``SplitRuntime`` (``forward``,
``decode_step`` through ``generate_split``, ``decode_step_paged`` through
the batcher), the link's per-µ-batch counters, ``run_split_eval(pipeline=)``
and the checkpoints' ``num_microbatches``.

One set of weights (the reference's ``init_params`` at its
``tests/test_pipeline.py`` size: 6 layers, D = 32, 4 heads, V = 128)
crosses with ``params_from_jax_numpy``; the reference runs on the 8-device
CPU mesh of ``tests/conftest.py``, three stages (cuts 1 and 3). Each
reference runtime is built once per module (its executables compile once).

Tolerances: float32 logits within 2e-5 of the reference's (the split
decode's tolerance); the port's pipelined logits equal its own sequential
logits bit for bit (each µ-batch runs the same per-row math on contiguous
row views); tokens and link counters exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.codecs.faults import FaultConfig as JFaultConfig
from edgellm_tpu.codecs.faults import LinkPolicy as JLinkPolicy
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as j_tiny
from edgellm_tpu.parallel import PipelineConfig as JPipelineConfig
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh
from edgellm_tpu.serve.batching import BatchingConfig as JBatchingConfig
from edgellm_tpu.serve.batching import ContinuousBatcher as JBatcher
from edgellm_tpu.serve.decode import generate_split as j_generate_split
from edgellm_tpu_torch.codecs.faults import FaultConfig, LinkPolicy
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import PipelineConfig, SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve.batching import BatchingConfig, ContinuousBatcher
from edgellm_tpu_torch.serve.decode import generate_split, resume_split
from edgellm_tpu_torch.serve.recovery import CheckpointError, DecodeCheckpoint, RecoveryConfig

JCFG = j_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
CUTS, CODECS = (1, 3), ("int8_per_token", "int8_per_token")
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _separate_hops(monkeypatch):
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.key(1))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def mesh():
    return make_stage_mesh(3)


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(5).integers(0, 128, (4, 12)).astype(np.int32)


def _t(m=None, **kw):
    return SplitRuntime(TCFG, SplitConfig(CUTS, CODECS), ["cpu"] * 3,
                        pipeline=PipelineConfig(m) if m else None, **kw)


def _j(mesh, m=None, **kw):
    return JSplitRuntime(JCFG, JSplitConfig(cuts=CUTS, hop_codecs=CODECS), mesh,
                         pipeline=JPipelineConfig(m) if m else None, **kw)


def _err(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


# ---------- PipelineConfig ----------

@pytest.mark.parametrize("m,n", [(1, 2), (2, 3), (4, 3), (8, 2)])
def test_pipeline_config_matches_reference(m, n):
    """``enabled``, ``validate_batch`` and ``summary`` equal the
    reference's; bad values raise its words."""
    got, want = PipelineConfig(m), JPipelineConfig(m)
    assert got.enabled == want.enabled and got.summary(n) == want.summary(n)
    for batch in (m, 2 * m, 3 * m):
        assert got.validate_batch(batch) == want.validate_batch(batch)
    for batch in (0, m + 1 if m > 1 else 0):
        assert (_err(lambda: got.validate_batch(batch, "forward batch"))
                == _err(lambda: want.validate_batch(batch, "forward batch")))
    assert _err(lambda: PipelineConfig(0)) == _err(lambda: JPipelineConfig(0))


def test_pipeline_refusals_match_reference(weights, mesh, ids):
    """A batch that does not split, one stage and a batch-variant codec
    raise as the reference raises."""
    jp, tp = weights
    jrt, trt = _j(mesh, 4), _t(4)
    bad = np.zeros((3, 8), np.int32)
    assert (_err(lambda: trt.forward(trt.place_params(tp), torch.from_numpy(bad).long()))
            == _err(lambda: jrt.forward(jrt.place_params(jp), jnp.asarray(bad))))
    one = SplitConfig((), ())
    assert (_err(lambda: SplitRuntime(TCFG, one, ["cpu"], pipeline=PipelineConfig(2)))
            == _err(lambda: JSplitRuntime(JCFG, JSplitConfig((), ()), make_stage_mesh(1),
                                          pipeline=JPipelineConfig(2))))
    for codec in ("int4_global", "ternary_max", "int8_per_channel", "int4_per_channel"):
        mixed = (codec, "int8_per_token")
        got = _err(lambda: SplitRuntime(TCFG, SplitConfig(CUTS, mixed), ["cpu"] * 3,
                                        pipeline=PipelineConfig(2)))
        want = _err(lambda: JSplitRuntime(JCFG, JSplitConfig(CUTS, mixed), mesh,
                                          pipeline=JPipelineConfig(2)))
        assert got == want and "µ-batches" in got
    # M == 1 is the sequential schedule, also for a batch-variant codec
    assert not SplitRuntime(TCFG, SplitConfig(CUTS, ("int4_global", "fp32")), ["cpu"] * 3,
                            pipeline=PipelineConfig(1)).pipelined


# ---------- the pipelined forward ----------

@pytest.mark.parametrize("m", [2, 4])
def test_pipelined_forward_matches_reference(weights, mesh, ids, m):
    """Within the split tolerance of the reference's pipelined forward, and
    bit for bit the port's own sequential forward (the reference's claim)."""
    jp, tp = weights
    jrt, trt, seq = _j(mesh, m), _t(m), _t()
    want = np.asarray(jrt.forward(jrt.place_params(jp), jnp.asarray(ids)))
    placed = trt.place_params(tp)
    got = trt.forward(placed, torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, seq.forward(placed, torch.from_numpy(ids).long()).numpy())
    assert trt.pipeline_summary() == jrt.pipeline_summary()
    assert trt.pipelined and not seq.pipelined


def test_pipelined_forward_with_per_row_importance(weights):
    """A token-selective hop ships per-row importance: each µ-batch hop
    takes its own rows, so the pipelined logits equal the sequential ones."""
    from edgellm_tpu_torch.codecs.packing import selective_int4

    _, tp = weights
    split = SplitConfig(CUTS, (selective_int4(0.5), "int8_per_token"))
    pipe = SplitRuntime(TCFG, split, ["cpu"] * 3, pipeline=PipelineConfig(2))
    seq = SplitRuntime(TCFG, split, ["cpu"] * 3)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (4, 16))).long()
    imp = [torch.from_numpy(np.random.default_rng(3).random((4, 16)).astype(np.float32)), None]
    placed = seq.place_params(tp)
    np.testing.assert_array_equal(pipe.forward(placed, ids, hop_importance=imp).numpy(),
                                  seq.forward(placed, ids, hop_importance=imp).numpy())


# ---------- pipelined decode ----------

def test_pipelined_generate_split_matches_reference(weights, mesh, ids):
    """B = 4, M = 2: the reference's tokens, the port's unpipelined tokens,
    ``stats["pipeline"]`` and the µ-batched decode bytes."""
    jp, tp = weights
    jrt, trt = _j(mesh, 2), _t(2)
    want = np.asarray(j_generate_split(jrt, jrt.place_params(jp), jnp.asarray(ids), 6,
                                       capacity=20))
    stats: dict = {}
    got = generate_split(trt, trt.place_params(tp), ids, 6, capacity=20, stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    seq = _t()
    np.testing.assert_array_equal(
        got.numpy(), generate_split(seq, seq.place_params(tp), ids, 6, capacity=20).numpy())
    assert stats["pipeline"] == jrt.pipeline_summary()
    for b in (4, 3):
        assert trt.pipelined_decode_hop_bytes(b) == jrt.pipelined_decode_hop_bytes(b)
    assert trt.wire_summary(4, 12) == jrt.wire_summary(4, 12)


#: one row a µ-batch (M = B = 4) turns a decode step's (B, D) x (D, F)
#: products into vector-matrix ones, which torch's CPU kernels sum in
#: another order: logits and cache rows there agree within this (8.9e-8
#: read); at two rows a µ-batch bit for bit
ONE_ROW_TOL = dict(atol=1e-6, rtol=0)


@pytest.mark.parametrize("m", [2, 4])
def test_pipelined_decode_steps_equal_sequential(weights, m):
    """Teacher-forced decode steps at B = 4: every step's logits and the
    per-stage caches the sequential run's, bit for bit at M = 2 and within
    :data:`ONE_ROW_TOL` at one row a µ-batch."""
    _, tp = weights
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 128, (4, 10))).long()
    runs = []
    for rt in (_t(m), _t()):
        placed = rt.place_params(tp)
        _, cache = rt.prefill_decode(placed, ids[:, :5], 12)
        steps = []
        for t in range(5, 10):
            logits, cache = rt.decode_step(placed, cache, ids[:, t])
            steps.append(logits.numpy())
        runs.append((steps, [k.numpy() for k in cache["k"]]))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        if m == 4:
            np.testing.assert_allclose(a, b, **ONE_ROW_TOL)
        else:
            np.testing.assert_array_equal(a, b)


def _batcher_tokens(batcher, vocab):
    rng = np.random.default_rng(3)
    for i in range(4):
        batcher.submit(rng.integers(1, vocab, size=4 + i).astype(np.int32), 6, rng_seed=i)
    return {k: np.asarray(v).tolist() for k, v in batcher.run().items()}


def test_pipelined_paged_decode_matches_reference(weights, mesh):
    """The split-paged batcher over a pipelined runtime (max_slots 4, M =
    2): the reference's pipelined batcher's tokens and the port's
    unpipelined ones; the report's ``pipeline`` block."""
    jp, tp = weights
    kw = dict(max_slots=4, num_pages=16, page_size=4, pages_per_slot=6)
    jrt = _j(mesh, 2)
    want = _batcher_tokens(JBatcher(JCFG, jp, JBatchingConfig(**kw), split_runtime=jrt,
                                    placed_params=jrt.place_params(jp)), 128)
    got = {}
    for m in (2, None):
        trt = _t(m)
        b = ContinuousBatcher(TCFG, tp, BatchingConfig(**kw), split_runtime=trt,
                              placed_params=trt.place_params(tp))
        got[m] = _batcher_tokens(b, 128)
        if m:
            assert b.report()["pipeline"] == jrt.pipeline_summary()
        else:
            assert "pipeline" not in b.report()
    assert got[2] == got[None] == want


def test_pipelined_batcher_refusals_match_reference(weights, mesh):
    """``max_slots % M`` and a quantized pool under a pipelined runtime
    raise the reference's words; the paged step refuses a quantized pool."""
    jp, tp = weights
    jrt, trt = _j(mesh, 4), _t(4)
    for kw in (dict(max_slots=6), dict(max_slots=4, kv_codec="int8_per_channel")):
        got = _err(lambda: ContinuousBatcher(TCFG, tp, BatchingConfig(**kw), split_runtime=trt,
                                             placed_params=trt.place_params(tp)))
        want = _err(lambda: JBatcher(JCFG, jp, JBatchingConfig(**kw), split_runtime=jrt,
                                     placed_params=jrt.place_params(jp)))
        assert got == want
    pool = trt.init_paged_pool(8, 4, kv_codec="int8_per_channel")
    with pytest.raises(ValueError, match="unpipelined split runtime only"):
        trt.decode_step_paged(trt.place_params(tp), pool, np.zeros((4, 2), np.int32),
                              np.zeros(4, np.int32), np.zeros(4, np.int64))


# ---------- the link under the pipeline ----------

def _faulty(maker, m=2):
    return maker(m, faults=FaultConfig(drop_rate=0.3, seed=0),
                 policy=LinkPolicy(max_retries=5))


def test_microbatch_counters_match_reference(weights, mesh, ids):
    """Four faulty pipelined forwards: the (M, n_hops) counter rows bit for
    bit the reference's, summing to ``link_counters``; the logits within
    tolerance (same drops, same recoveries)."""
    jp, tp = weights
    jrt = _j(mesh, 2, faults=JFaultConfig(drop_rate=0.3, seed=0),
             policy=JLinkPolicy(max_retries=5))
    trt = _faulty(_t)
    jplaced, tplaced = jrt.place_params(jp), trt.place_params(tp)
    for step in range(4):
        want = np.asarray(jrt.forward(jplaced, jnp.asarray(ids), fault_step=step))
        got = trt.forward(tplaced, torch.from_numpy(ids).long(), fault_step=step).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    per_mb, jper_mb = trt.microbatch_counters(), jrt.microbatch_counters()
    assert set(per_mb) == set(jper_mb)
    for k in per_mb:
        np.testing.assert_array_equal(per_mb[k], np.asarray(jper_mb[k]))
        np.testing.assert_array_equal(per_mb[k].sum(axis=0), trt.link_counters()[k])
    np.testing.assert_array_equal(per_mb["hops"], np.full((2, 2), 4))
    assert per_mb["retried"].sum() > 0


def test_microbatch_fault_replay_and_unpipelined(weights, ids):
    """A replay draws the same faults (same logits, same counters); an
    unpipelined runtime has no µ-batch counters."""
    _, tp = weights
    outs = []
    for _ in range(2):
        rt = _faulty(_t)
        outs.append((rt.forward(rt.place_params(tp), torch.from_numpy(ids).long(),
                                fault_step=1).numpy(), rt.microbatch_counters()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    for k in outs[0][1]:
        np.testing.assert_array_equal(outs[0][1][k], outs[1][1][k])
    seq = _t(None, faults=FaultConfig(drop_rate=0.3, seed=0), policy=LinkPolicy(max_retries=5))
    assert seq.microbatch_counters() is None and seq.link_counters() is not None
    assert _t(2).microbatch_counters() is None


# ---------- the eval ----------

def test_pipelined_eval_pads_partial_tail_group(weights, mesh):
    """7 windows at window_batch 2 leave a 1-window tail: padded up to the
    µ-batch grid (zero loss weight). Scored tokens equal the sequential
    run's and the reference's pipelined run's, NLL within tolerance."""
    from edgellm_tpu.eval.split_eval import run_split_eval as j_split_eval
    from edgellm_tpu_torch.eval import run_split_eval

    jp, tp = weights
    toks = np.random.default_rng(7).integers(0, 128, size=80).astype(np.int32)
    kw = dict(cuts=CUTS, hop_codecs=CODECS, max_length=16, stride=8, window_batch=2,
              time_hops=False)
    want = j_split_eval(JCFG, jp, toks, mesh=mesh, pipeline=JPipelineConfig(2), **kw)
    seq = run_split_eval(TCFG, tp, toks, device="cpu", **kw)
    got = run_split_eval(TCFG, tp, toks, device="cpu", pipeline={"num_microbatches": 2}, **kw)
    assert got["n_tokens"] == seq["n_tokens"] == want["n_tokens"]
    assert got["chunks"] == seq["chunks"] == want["chunks"]
    assert got["pad_fraction"] == want["pad_fraction"] > 0.0
    assert got["measured_hop_bytes_total"] == want["measured_hop_bytes_total"]
    assert got["pipeline"] == want["pipeline"]
    np.testing.assert_allclose(got["total_nll"], want["total_nll"], rtol=1e-5)
    np.testing.assert_allclose(got["total_nll"], seq["total_nll"], rtol=1e-5)


def test_pipelined_eval_refuses_batch_variant_ladder(weights, mesh):
    from edgellm_tpu.eval.split_eval import run_split_eval as j_split_eval
    from edgellm_tpu_torch.eval import run_split_eval

    jp, tp = weights
    toks = np.arange(64, dtype=np.int32) % 128
    kw = dict(cuts=CUTS, hop_codecs=CODECS, max_length=16, stride=8, window_batch=2)
    got = _err(lambda: run_split_eval(
        TCFG, tp, toks, device="cpu", faults=FaultConfig(drop_rate=0.1, seed=0),
        link_policy=LinkPolicy(max_retries=1, tiers=("int4_global",)),
        pipeline=PipelineConfig(2), **kw))
    want = _err(lambda: j_split_eval(
        JCFG, jp, toks, mesh=mesh, faults=JFaultConfig(drop_rate=0.1, seed=0),
        link_policy=JLinkPolicy(max_retries=1, tiers=("int4_global",)),
        pipeline=JPipelineConfig(2), **kw))
    assert got == want and "ladder" in got
    assert (_err(lambda: run_split_eval(TCFG, tp, toks, device="cpu",
                                        pipeline=PipelineConfig(4), **kw))
            == "window_batch 2 must be a positive multiple of num_microbatches=4 "
               "(each µ-batch needs >= 1 row)")


# ---------- checkpoints ----------

def test_decode_checkpoint_records_microbatches_and_refuses_another(weights, tmp_path):
    """A pipelined ``generate_split`` checkpoint records ``num_microbatches``;
    it resumes onto the same schedule with the uninterrupted tokens and is
    refused by a runtime with another M."""
    _, tp = weights
    ids = np.random.default_rng(4).integers(0, 128, (4, 6)).astype(np.int32)
    rt = _t(2)
    placed = rt.place_params(tp)
    full = generate_split(rt, placed, ids, 8, capacity=16).numpy()
    path = str(tmp_path / "d.ckpt")
    generate_split(rt, placed, ids, 8, capacity=16,
                   recovery=RecoveryConfig(checkpoint_path=path, halt_at_step=3))
    assert DecodeCheckpoint.load(path).meta["num_microbatches"] == 2
    np.testing.assert_array_equal(resume_split(_t(2), placed, path).numpy(), full)
    for other in (_t(4), _t()):
        with pytest.raises(CheckpointError, match="pipeline µ-batch count"):
            resume_split(other, placed, path)


def test_stream_checkpoint_records_microbatch(weights, tmp_path):
    """A running stream's split checkpoint records ``num_microbatches`` and
    its slot's ``microbatch``; a batcher with another M refuses it."""
    _, tp = weights
    kw = dict(max_slots=4, num_pages=16, page_size=4, pages_per_slot=6)

    def batcher(m):
        rt = _t(m)
        return ContinuousBatcher(TCFG, tp, BatchingConfig(**kw), split_runtime=rt,
                                 placed_params=rt.place_params(tp))

    b = batcher(2)
    sids = [b.submit(np.arange(1, 6 + i), 6, rng_seed=i) for i in range(4)]
    b.step()
    meta = {}
    for sid in sids:
        path = str(tmp_path / f"s{sid}.ckpt")
        b.checkpoint_stream(sid, path)
        meta[sid] = DecodeCheckpoint.load(path).meta
        assert meta[sid]["num_microbatches"] == 2
        assert meta[sid]["microbatch"] == b._streams[sid].slot // 2
    assert {m["microbatch"] for m in meta.values()} == {0, 1}
    with pytest.raises(CheckpointError, match="num_microbatches"):
        batcher(4).restore_stream(str(tmp_path / f"s{sids[0]}.ckpt"))
    restored = batcher(2)
    sid = restored.restore_stream(str(tmp_path / f"s{sids[0]}.ckpt"))
    want = batcher(None)
    wsid = want.submit(np.arange(1, 6), 6, rng_seed=0)
    assert restored.run()[sid].tolist() == want.run()[wsid].tolist()


def test_bf16_pipelined_forward_keeps_the_sequential_dtypes(weights, mesh, ids):
    """A reference caveat: on bf16 weights the reference's µ-batch register
    turns float32 after the first separate hop, so its stage 0 computes
    µ-batches 1.. in float32 and only µ-batch 0's rows equal its sequential
    forward. The port runs every µ-batch through the sequential path's
    dtypes: its pipelined bf16 logits equal its sequential ones bit for
    bit, and µ-batch 0 matches the reference's pipelined rows as closely as
    the sequential forwards match."""
    jp, _ = weights
    jpb = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, jp)
    jseq, jpipe = _j(mesh), _j(mesh, 2)
    want_seq = np.asarray(jseq.forward(jseq.place_params(jpb), jnp.asarray(ids)))
    want_pipe = np.asarray(jpipe.forward(jpipe.place_params(jpb), jnp.asarray(ids)))
    np.testing.assert_array_equal(want_seq[:2], want_pipe[:2])
    assert np.abs(want_seq[2:] - want_pipe[2:]).max() > 0  # the caveat
    tpb = params_from_jax_numpy(
        TCFG, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jpb), device="cpu")
    tpb = jax.tree_util.tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, tpb)
    seq, pipe = _t(), _t(2)
    x = torch.from_numpy(ids).long()
    got_seq = seq.forward(seq.place_params(tpb), x).numpy()
    got_pipe = pipe.forward(pipe.place_params(tpb), x).numpy()
    np.testing.assert_array_equal(got_seq, got_pipe)
    bound = np.abs(got_seq - want_seq).max()
    assert np.abs(got_pipe[:2] - want_pipe[:2]).max() <= bound
