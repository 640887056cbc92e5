"""The port's survivable decode held against the JAX package's on the CPU:
``DecodeCheckpoint`` bytes and loads both ways (bf16 leaves as raw words,
no ``ml_dtypes`` on the port's side), ``generate_split`` / ``generate``
with a ``RecoveryConfig`` (halt, periodic checkpoints, the watchdog, stage
failure and failover to a re-planned split or one survivor), ``resume_split``
and the speculative resume.

One set of weights (the reference's ``init_params``: 6 layers, D = 32, 4
heads, V = 128) crosses with ``params_from_jax_numpy``; the reference runs on
the 8-device CPU mesh of ``tests/conftest.py``. fp32 hops, so the token
streams of both packages agree.

Tolerances: checkpoint files byte for byte (the same generation state gives
the same bytes in either package); tokens exactly; restored caches bit for
bit.
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
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh
from edgellm_tpu.serve import decode as jd
from edgellm_tpu.serve import recovery as jr
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve import decode as td
from edgellm_tpu_torch.serve import recovery as tr
from edgellm_tpu_torch.serve.speculative import SpecConfig
from edgellm_tpu_torch.utils import prng
from edgellm_tpu_torch.utils.clock import FakeClock

JCFG = j_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
NEW, TEMP, CAP = 8, 0.7, 16
CUTS3 = ((1, 3), ("fp32", "fp32"))  # stages of 2, 2 and 2 layers
CUTS2 = ((1,), ("fp32",))           # stages of 2 and 4: stage 0 padded to 4


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


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(3).integers(0, 128, (2, 6)).astype(np.int32)


def _runtimes(weights, plan):
    jp, tp = weights
    cuts, codecs = plan
    n = len(cuts) + 1
    with _separate_hops():
        jrt = JSplitRuntime(JCFG, JSplitConfig(cuts=cuts, hop_codecs=codecs), make_stage_mesh(n))
        trt = SplitRuntime(TCFG, SplitConfig(cuts=cuts, hop_codecs=codecs), ["cpu"] * n)
    return jrt, jrt.place_params(jp), trt, trt.place_params(tp)


def _port(trt, tplaced, ids, tp, **kw):
    return td.generate_split(trt, tplaced, ids, NEW, capacity=CAP, temperature=TEMP,
                             rng_key=prng.key(4), raw_params=tp, **kw).numpy()


def _ref(jrt, jplaced, ids, jp, **kw):
    return np.asarray(jd.generate_split(jrt, jplaced, jnp.asarray(ids), NEW, capacity=CAP,
                                        temperature=TEMP, rng_key=jax.random.key(4),
                                        raw_params=jp, **kw))


# ---------------------------------------------------------------------------
# the checkpoint format
# ---------------------------------------------------------------------------


def test_checkpoint_damage_raises_typed(tmp_path):
    path = str(tmp_path / "ck.bin")
    tr.DecodeCheckpoint({"a": np.arange(100, dtype=np.float32)}, {"x": 1}).save(path)
    assert not os.path.exists(path + ".part")
    blob = open(path, "rb").read()
    for name, data, match in (("short", blob[:8], "truncated"),
                              ("cut", blob[:-3], "truncated"),
                              ("magic", b"\x00" * 64, "magic"),
                              ("crc", blob[:-5] + bytes([blob[-5] ^ 0xFF]) + blob[-4:],
                               "CRC32")):
        p = str(tmp_path / name)
        open(p, "wb").write(data)
        with pytest.raises(tr.CheckpointError, match=match):
            tr.DecodeCheckpoint.load(p)
        with pytest.raises(jr.CheckpointError, match=match):
            jr.DecodeCheckpoint.load(p)
    with pytest.raises(tr.CheckpointError, match="cannot read"):
        tr.DecodeCheckpoint.load(str(tmp_path / "missing"))


def test_checkpoint_bytes_equal_and_bf16_round_trips_both_ways(tmp_path):
    """The same leaves and meta give the same file in both packages; a bf16
    leaf goes as its raw 16-bit words under "bfloat16" (the port reads it
    back as a CPU bf16 tensor, the reference through ml_dtypes)."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    bf = torch.from_numpy(f32).to(torch.bfloat16)
    meta = {"step": 3, "model": {"family": "qwen2"}, "temperature": 0.7}
    t_path, j_path = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    tr.DecodeCheckpoint({"x": f32, "b": bf, "n": np.int32(5), "k": np.array([0, 4], np.uint32)},
                        meta).save(t_path)
    jr.DecodeCheckpoint({"x": f32, "b": jnp.asarray(f32, jnp.bfloat16), "n": np.int32(5),
                         "k": np.array([0, 4], np.uint32)}, meta).save(j_path)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()
    got = tr.DecodeCheckpoint.load(j_path)
    assert got.arrays["b"].dtype == torch.bfloat16
    assert torch.equal(got.arrays["b"].view(torch.int16), bf.view(torch.int16))
    np.testing.assert_array_equal(got.arrays["x"], f32)
    assert got.meta == meta and got.arrays["n"].shape == () and got.arrays["n"] == 5
    want = jr.DecodeCheckpoint.load(t_path)
    np.testing.assert_array_equal(np.asarray(want.arrays["b"], np.float32),
                                  bf.float().numpy())
    assert got.to_bytes() == open(j_path, "rb").read()


@pytest.mark.parametrize("plan", [CUTS2, CUTS3], ids=["padded", "even"])
def test_split_checkpoint_bytes_equal_the_reference_and_load_both_ways(weights, ids, plan,
                                                                       tmp_path):
    """The reference halts at step 3; the port loads its file, writes the
    same generation state back (the padded per-stage cache, the uint32 key
    words, int32 length and tokens) byte for byte, and resumes it to the
    reference's uninterrupted tokens. The other way round: the reference
    resumes the port's own halt checkpoint to the same tokens."""
    jp, tp = weights
    jrt, jplaced, trt, tplaced = _runtimes(weights, plan)
    clean = _ref(jrt, jplaced, ids, jp)
    j_path, t_path = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    _ref(jrt, jplaced, ids, jp, recovery=jr.RecoveryConfig(checkpoint_path=j_path,
                                                           halt_at_step=3))
    ckpt = tr.DecodeCheckpoint.load(j_path)
    prompt, key, step, toks, cache = td.load_resume_state(trt, tplaced, ckpt, j_path)
    assert [k.shape[0] for k in cache["k"]] == [b - a for a, b in trt.bounds]
    meta = ckpt.meta
    run_meta = {k: meta[k] for k in ("capacity", "temperature", "max_new_tokens",
                                     "fault_step", "prompt_len", "batch")}
    td._write_checkpoint(tr.RecoveryConfig(checkpoint_path=t_path), trt,
                         tr.RecoveryCounters(**meta["recovery_counters"]), prompt, toks,
                         cache, key, step, run_meta)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()
    stats = {}
    full = td.resume_split(trt, tplaced, j_path, stats=stats)
    np.testing.assert_array_equal(full.numpy(), clean)
    assert stats["resumed_from_step"] == 3 and stats["recovery_counters"]["resume_ok"] == 1
    os.remove(t_path)
    part = _port(trt, tplaced, ids, tp, recovery=tr.RecoveryConfig(checkpoint_path=t_path,
                                                                   halt_at_step=3))
    np.testing.assert_array_equal(part, clean[:, :4])
    np.testing.assert_array_equal(np.asarray(jd.resume_split(jrt, jplaced, t_path)), clean)


def test_local_generate_checkpoint_bytes_and_resume(weights, ids, tmp_path):
    """``generate(recovery=)`` on a LocalRuntime: the reference's halt file
    rewritten byte for byte by the port, and each resumes the other's."""
    jp, tp = weights
    kw = dict(capacity=CAP, temperature=TEMP)
    clean = np.asarray(jd.generate(JCFG, jp, jnp.asarray(ids), NEW, rng_key=jax.random.key(4),
                                   **kw))
    j_path, t_path = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jd.generate(JCFG, jp, jnp.asarray(ids), NEW, rng_key=jax.random.key(4), **kw,
                recovery=jr.RecoveryConfig(checkpoint_path=j_path, halt_at_step=2))
    part = td.generate(TCFG, tp, ids, NEW, rng_key=prng.key(4), **kw,
                       recovery=tr.RecoveryConfig(checkpoint_path=t_path, halt_at_step=2))
    np.testing.assert_array_equal(part.numpy(), clean[:, :3])
    lrt = tr.LocalRuntime(TCFG)
    ckpt = tr.DecodeCheckpoint.load(j_path)
    prompt, key, step, toks, cache = td.load_resume_state(lrt, tp, ckpt, j_path)
    meta = ckpt.meta
    td._write_checkpoint(tr.RecoveryConfig(checkpoint_path=str(tmp_path / "re.ckpt")), lrt,
                         tr.RecoveryCounters(**meta["recovery_counters"]), prompt, toks, cache,
                         key, step, {k: meta[k] for k in ("capacity", "temperature",
                                                          "max_new_tokens", "fault_step",
                                                          "prompt_len", "batch")})
    assert open(tmp_path / "re.ckpt", "rb").read() == open(j_path, "rb").read()
    np.testing.assert_array_equal(td.resume_split(lrt, tp, j_path).numpy(), clean)
    np.testing.assert_array_equal(
        np.asarray(jd.resume_split(jr.LocalRuntime(JCFG), jp, t_path)), clean)


def test_bf16_split_cache_checkpoint_round_trips_bit_for_bit(weights, ids, tmp_path):
    """bf16 weights: the cache leaves are bf16 raw words in the file; the
    port's resume restores every stage's cache bit for bit and continues
    to the uninterrupted tokens; the reference reads the same file."""
    jp, _ = weights
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                               dtype=torch.bfloat16)
    with _separate_hops():
        trt = SplitRuntime(TCFG, SplitConfig(*CUTS2), ["cpu"] * 2)
    placed = trt.place_params(tp)
    clean = _port(trt, placed, ids, tp)
    path = str(tmp_path / "bf.ckpt")
    _port(trt, placed, ids, tp, recovery=tr.RecoveryConfig(checkpoint_path=path,
                                                           halt_at_step=4))
    ckpt = tr.DecodeCheckpoint.load(path)
    assert ckpt.arrays["cache/k"].dtype == torch.bfloat16
    assert tuple(ckpt.arrays["cache/k"].shape) == (2, 4, 2, CAP, 2, 8)
    assert not ckpt.arrays["cache/k"][0, 2:].any()  # stage 0's padding layers
    cache = trt.load_cache_state({"k": ckpt.arrays["cache/k"], "v": ckpt.arrays["cache/v"],
                                  "length": ckpt.arrays["cache/length"]})
    again = trt.cache_state(cache)
    assert torch.equal(again["k"].view(torch.int16), ckpt.arrays["cache/k"].view(torch.int16))
    np.testing.assert_array_equal(td.resume_split(trt, placed, path).numpy(), clean)
    want = jr.DecodeCheckpoint.load(path)
    assert str(want.arrays["cache/k"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(want.arrays["cache/k"], np.float32),
                                  ckpt.arrays["cache/k"].float().numpy())


def test_resume_refuses_another_plan_and_a_twin_codec_checkpoint(weights, ids, tmp_path):
    """A checkpoint resumes only onto its plan: other cuts, or hop codecs
    named as a card runs them (``*_pallas``, which a CPU runtime built
    from plain names does not run), raise ``CheckpointError``."""
    _, tp = weights
    with _separate_hops():
        twin = SplitRuntime(TCFG, SplitConfig((1,), ("int8_per_token_pallas",)), ["cpu"] * 2)
        plain = SplitRuntime(TCFG, SplitConfig((1,), ("int8_per_token",)), ["cpu"] * 2)
        other = SplitRuntime(TCFG, SplitConfig((3,), ("int8_per_token",)), ["cpu"] * 2)
    path = str(tmp_path / "twin.ckpt")
    _port(twin, twin.place_params(tp), ids, tp,
          recovery=tr.RecoveryConfig(checkpoint_path=path, halt_at_step=1))
    assert tr.DecodeCheckpoint.load(path).meta["hop_codecs"] == ["int8_per_token_pallas"]
    with pytest.raises(tr.CheckpointError, match="hop codecs"):
        td.resume_split(plain, plain.place_params(tp), path)
    with pytest.raises(tr.CheckpointError, match="split cuts"):
        td.resume_split(other, other.place_params(tp), path)


# ---------------------------------------------------------------------------
# the survivable loop: periodic checkpoints, the watchdog, failover
# ---------------------------------------------------------------------------


def test_periodic_checkpoints_and_watchdog(weights, ids, tmp_path):
    """Checkpoints every 3 steps leave the last one at step 6, which resumes
    to the clean tokens; a watchdog on a clock that jumps past its deadline
    writes a best-effort checkpoint and raises ``DecodeTimeout``."""
    _, tp = weights
    _, _, trt, tplaced = _runtimes(weights, CUTS3)
    clean = _port(trt, tplaced, ids, tp)
    path = str(tmp_path / "p.ckpt")
    stats = {}
    out = _port(trt, tplaced, ids, tp, stats=stats,
                recovery=tr.RecoveryConfig(checkpoint_path=path, checkpoint_every=3))
    np.testing.assert_array_equal(out, clean)
    assert stats["recovery_counters"]["checkpoints_written"] == 3  # steps 0, 3, 6
    assert tr.DecodeCheckpoint.load(path).meta["step"] == 6
    np.testing.assert_array_equal(td.resume_split(trt, tplaced, path).numpy(), clean)

    class Jumpy(FakeClock):
        def __call__(self):
            return self.advance(4.0)

    wd_path = str(tmp_path / "wd.ckpt")
    stats = {}
    with pytest.raises(tr.DecodeTimeout):
        _port(trt, tplaced, ids, tp, stats=stats,
              recovery=tr.RecoveryConfig(checkpoint_path=wd_path, deadline_s=1.0,
                                         clock=Jumpy()))
    assert stats["recovery_counters"]["watchdog_fires"] == 1
    assert tr.DecodeCheckpoint.load(wd_path).meta["step"] == 0
    np.testing.assert_array_equal(td.resume_split(trt, tplaced, wd_path).numpy(), clean)


@pytest.mark.parametrize("plan,stage,at_step", [(CUTS3, 2, 3), (CUTS3, 1, 0),
                                                (CUTS3, 0, NEW - 1), (CUTS2, 0, 2)],
                         ids=["3to2-step3", "3to2-prefill", "3to2-last", "2to1-local"])
def test_stage_failure_failover_tokens_match_reference(weights, ids, plan, stage, at_step):
    """A stage lost mid-generation: the split re-plans onto the surviving
    stage devices (or one ``LocalRuntime``), the whole prefix re-prefills,
    and the tokens and recovery counters equal the reference's run of the
    same ``StageFailure`` (and, over fp32 hops, the clean run's)."""
    jp, tp = weights
    jrt, jplaced, trt, tplaced = _runtimes(weights, plan)
    clean = _port(trt, tplaced, ids, tp)
    jstats, tstats = {}, {}
    want = _ref(jrt, jplaced, ids, jp, stats=jstats, recovery=jr.RecoveryConfig(
        stage_failure=jr.StageFailure(stage=stage, at_step=at_step)))
    got = _port(trt, tplaced, ids, tp, stats=tstats, recovery=tr.RecoveryConfig(
        stage_failure=tr.StageFailure(stage=stage, at_step=at_step)))
    np.testing.assert_array_equal(got, want)
    assert tstats["recovery_counters"] == jstats["recovery_counters"]
    rc = tstats["recovery_counters"]
    assert rc["failovers"] == rc["replans"] == 1
    assert rc["recompute_tokens"] == 2 * (6 + at_step)
    np.testing.assert_array_equal(got, clean)
    assert trt.lost_stage == stage


def test_stage_failure_refusals(weights, ids):
    """Without ``raw_params`` a failover cannot re-place the weights; with
    ``replan=False`` the loss is fatal; every entry point of a dark runtime
    raises ``StageLostError``; a LocalRuntime has no stage to lose."""
    _, tp = weights
    _, _, trt, tplaced = _runtimes(weights, CUTS2)
    rec = tr.RecoveryConfig(stage_failure=tr.StageFailure(stage=1, at_step=1))
    with pytest.raises(ValueError, match="raw_params"):
        td.generate_split(trt, tplaced, ids, NEW, recovery=rec)
    _, _, trt, tplaced = _runtimes(weights, CUTS2)
    with pytest.raises(tr.StageLostError):
        _port(trt, tplaced, ids, tp, recovery=tr.RecoveryConfig(
            stage_failure=tr.StageFailure(stage=1, at_step=1), replan=False))
    x = torch.from_numpy(ids).long()
    for call in (lambda: trt.forward(tplaced, x), lambda: trt.prefill_decode(tplaced, x, CAP),
                 lambda: trt.init_paged_pool(4, 4)):
        with pytest.raises(tr.StageLostError, match="stage 1 is dark"):
            call()
    with pytest.raises(ValueError, match="out of range"):
        trt.mark_stage_lost(2)
    with pytest.raises(ValueError, match="single device"):
        tr.LocalRuntime(TCFG).mark_stage_lost(0)


def test_speculative_halt_and_resume_equal_the_uninterrupted_run(weights, ids, tmp_path):
    """The speculative loop checkpoints on a burst boundary; the speculative
    resume (``resume_split(speculative=)``) continues to the uninterrupted
    speculative run's tokens, greedy and sampled; a stage failure is
    refused, as in the reference."""
    _, tp = weights
    _, _, trt, tplaced = _runtimes(weights, CUTS3)
    spec = SpecConfig(k=3)
    prompt = ids[:1]
    for temp in (0.0, TEMP):
        kw = dict(capacity=CAP, temperature=temp, rng_key=prng.key(9), raw_params=tp,
                  speculative=spec)
        clean = td.generate_split(trt, tplaced, prompt, NEW, **kw).numpy()
        path = str(tmp_path / f"spec{temp}.ckpt")
        stats = {}
        part = td.generate_split(trt, tplaced, prompt, NEW, stats=stats, **kw,
                                 recovery=tr.RecoveryConfig(checkpoint_path=path,
                                                            halt_at_step=3))
        halted = stats["halted_at_step"]
        assert halted >= 3 and part.shape[1] == halted + 1
        np.testing.assert_array_equal(part.numpy(), clean[:, :halted + 1])
        meta = tr.DecodeCheckpoint.load(path).meta
        assert meta["speculative"] == {"k": 3, "draft_source": "stage0", "draft_layers": 2}
        rstats = {}
        full = td.resume_split(trt, tplaced, path, speculative=spec, raw_params=tp,
                               stats=rstats)
        np.testing.assert_array_equal(full.numpy(), clean)
        assert rstats["recovery_counters"]["resume_ok"] == 1
    with pytest.raises(ValueError, match="stage-failure"):
        td.generate_split(trt, tplaced, prompt, NEW, capacity=CAP, raw_params=tp,
                          speculative=spec, recovery=tr.RecoveryConfig(
                              stage_failure=tr.StageFailure(stage=1, at_step=2)))
