"""The port's serving stack held against the JAX package on the CPU: the
sampling PRNG bit for bit, the continuous batcher's streams against the
reference batcher and against the port's own ``generate``, eviction and
resume, the serving front's outcomes, and the serve CLI.

Weights cross with ``params_from_jax_numpy`` (or both CLIs load one HF
checkpoint). Token streams are compared exactly: greedy streams are
argmaxes of logits that agree to ~1e-6, and sampled streams use the same
random bits; the Gumbel noise goes through ``torch.log`` against XLA's
``log`` (an ulp apart), which moves a sampled token only on a near tie, and
none occurs on these seeds.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgellm_tpu import run as jrun
from edgellm_tpu.models import tiny_config as j_tiny
from edgellm_tpu.models.paged_kv import PrefixCacheConfig as JPrefix
from edgellm_tpu.models.transformer import init_params as j_init
from edgellm_tpu.serve import batching as jb
from edgellm_tpu.serve import frontend as jf
from edgellm_tpu.utils.clock import FakeClock as JClock
from edgellm_tpu_torch import run as trun
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.models.paged_kv import OutOfPages, PrefixCacheConfig
from edgellm_tpu_torch.serve import batching as tb
from edgellm_tpu_torch.serve import frontend as tf
from edgellm_tpu_torch.serve.decode import generate
from edgellm_tpu_torch.utils import prng
from edgellm_tpu_torch.utils.clock import FakeClock

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# PRNG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 23, 2 ** 31 - 1, -7])
def test_prng_bits_equal_jax(seed):
    jk = jax.random.key(seed)
    assert prng.key(seed) == tuple(int(x) for x in np.asarray(jax.random.key_data(jk)))
    steps = np.asarray([0, 1, 2, 77, 10 ** 6])
    folded = prng.fold_in(torch.tensor([prng.key(seed)] * len(steps)), torch.from_numpy(steps))
    for i, t in enumerate(steps):
        jt = jax.random.fold_in(jk, int(t))
        assert tuple(folded[i].tolist()) == tuple(
            int(x) for x in np.asarray(jax.random.key_data(jt)))
        np.testing.assert_array_equal(
            prng.random_bits(folded[i:i + 1], 101)[0].numpy(),
            np.asarray(jax.random.bits(jt, (101,), jnp.uint32)).astype(np.int64))
        np.testing.assert_array_equal(
            prng.uniform_tiny(folded[i:i + 1], 101)[0].numpy(),
            np.asarray(jax.random.uniform(jt, (101,), minval=np.finfo(np.float32).tiny,
                                          maxval=1.0)))


def test_prng_categorical_per_row_and_flat():
    """Per-row keys (the batcher) and one key over a flat (B, V) draw
    (``generate`` with a batch of prompts) against ``jax.random.categorical``."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(4, 300)) * 2).astype(np.float32)
    keys = [jax.random.fold_in(jax.random.key(s), 3) for s in range(4)]
    want = [int(jax.jit(jax.random.categorical)(k, jnp.asarray(row)))
            for k, row in zip(keys, logits)]
    tk = torch.tensor([[int(x) for x in np.asarray(jax.random.key_data(k))] for k in keys])
    assert prng.categorical(tk, torch.from_numpy(logits)).tolist() == want
    flat = np.asarray(jax.jit(jax.random.categorical)(keys[0], jnp.asarray(logits)))
    assert prng.categorical(tk[:1], torch.from_numpy(logits)).tolist() == flat.tolist()
    with pytest.raises(ValueError, match="seed"):
        prng.key(2 ** 40)


# ---------------------------------------------------------------------------
# The continuous batcher
# ---------------------------------------------------------------------------

JCFG = j_tiny("qwen2", num_layers=3, hidden_size=64, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=3, hidden_size=64, num_heads=4, vocab_size=128)


@pytest.fixture(scope="module")
def weights():
    jparams = j_init(JCFG, jax.random.key(0))
    tparams = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jparams),
                                    device="cpu")
    return jparams, tparams


def _workload(seed, n=6, shared=0):
    """(prompts, temperatures, seeds): ragged prompts, every other stream
    sampled at temperature 0.7, with an optional shared first block."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 128, shared)
    prompts = [np.concatenate([head, rng.integers(1, 128, int(rng.integers(2, 9)))])
               .astype(np.int32) for _ in range(n)]
    return prompts, [0.7 if i % 2 else 0.0 for i in range(n)], list(range(10, 10 + n))


GEOMETRIES = {  # (page_size, num_pages, max_slots, pages_per_slot)
    "roomy": (8, 16, 3, 4),
    "tight": (4, 9, 3, 6),   # forces evictions
}


def _run_port(tparams, bkw, prompts, temps, seeds, new=7):
    b = tb.ContinuousBatcher(TCFG, tparams, tb.BatchingConfig(**bkw))
    sids = [b.submit(p, new, temperature=t, rng_seed=s)
            for p, t, s in zip(prompts, temps, seeds)]
    res = b.run()
    b.pool.check_invariants()
    return [res[s] for s in sids], b.report()


def _run_reference(jparams, bkw, prompts, temps, seeds, new=7):
    jkw = dict(bkw)
    if "prefix_cache" in jkw:
        jkw["prefix_cache"] = JPrefix(**vars(jkw["prefix_cache"]))
    b = jb.ContinuousBatcher(JCFG, jparams, jb.BatchingConfig(**jkw))
    sids = [b.submit(p, new, temperature=t, rng_seed=s)
            for p, t, s in zip(prompts, temps, seeds)]
    res = b.run()
    return [np.asarray(res[s]) for s in sids], b.report()


@pytest.mark.parametrize("kv_codec", ["fp", "int8_per_channel", "int4_per_channel"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_batched_streams_equal_reference_batcher(weights, geometry, kv_codec):
    """Greedy and sampled streams, evictions included, token for token
    against the reference's ContinuousBatcher; the same scheduling counters."""
    jparams, tparams = weights
    ps, pn, ms, pps = GEOMETRIES[geometry]
    bkw = dict(page_size=ps, num_pages=pn, max_slots=ms, pages_per_slot=pps,
               kv_codec=kv_codec)
    prompts, temps, seeds = _workload(1)
    got, trep = _run_port(tparams, bkw, prompts, temps, seeds)
    want, jrep = _run_reference(jparams, bkw, prompts, temps, seeds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for key in ("streams", "finished", "steps", "admitted", "evicted", "span",
                "token_capacity"):
        assert trep[key] == jrep[key], key
    np.testing.assert_allclose(trep["occupancy_mean"], jrep["occupancy_mean"], rtol=1e-12)
    if geometry == "tight":
        assert trep["evicted"] > 0


def test_prefix_shared_streams_equal_reference_batcher(weights):
    jparams, tparams = weights
    bkw = dict(page_size=4, num_pages=24, max_slots=3, pages_per_slot=6,
               prefix_cache=PrefixCacheConfig(min_shared_block=4))
    prompts, temps, seeds = _workload(2, shared=9)
    got, trep = _run_port(tparams, bkw, prompts, temps, seeds)
    want, jrep = _run_reference(jparams, bkw, prompts, temps, seeds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert trep["prefix"]["hits"] == jrep["prefix"]["hits"] > 0
    for key in ("saved_tokens", "cow_forks", "shared_pages", "index_nodes"):
        assert trep["prefix"][key] == jrep["prefix"][key], key


@pytest.mark.parametrize("geometry,prefix", [("roomy", False), ("tight", False),
                                             ("roomy", True)])
def test_batched_streams_equal_generate(weights, geometry, prefix):
    """The batcher's core invariant in the port: every stream, greedy or
    sampled, evicted or prefix-shared, equals its solo ``generate`` run."""
    _, tparams = weights
    ps, pn, ms, pps = GEOMETRIES[geometry]
    bkw = dict(page_size=ps, num_pages=pn + (12 if prefix else 0), max_slots=ms,
               pages_per_slot=pps)
    if prefix:
        bkw["prefix_cache"] = PrefixCacheConfig(min_shared_block=2)
    prompts, temps, seeds = _workload(3, shared=6 if prefix else 0)
    got, rep = _run_port(tparams, bkw, prompts, temps, seeds)
    for g, p, t, s in zip(got, prompts, temps, seeds):
        alone = generate(TCFG, tparams, p[None], 7, temperature=t, rng_key=prng.key(s))
        np.testing.assert_array_equal(g, alone[0].numpy())
    assert (rep["evicted"] > 0) == (geometry == "tight")
    assert rep["jit_misses"] == 0


def test_explicit_evict_resumes_token_identically(weights):
    _, tparams = weights
    prompts, temps, seeds = _workload(4, n=3)
    for kv_codec in ("fp", "int4_per_channel"):
        bcfg = tb.BatchingConfig(page_size=4, num_pages=20, max_slots=3, pages_per_slot=5,
                                 kv_codec=kv_codec)
        runs = []
        for evict_at in (None, 3):
            b = tb.ContinuousBatcher(TCFG, tparams, bcfg)
            sids = [b.submit(p, 7, temperature=t, rng_seed=s)
                    for p, t, s in zip(prompts, temps, seeds)]
            for step in range(40):
                if step == evict_at:
                    b.evict(sids[1])
                    assert b._streams[sids[1]].resume is not None
                if not b.step() and not b._waiting:
                    break
            runs.append([b.results[s] for s in sids])
            assert b.report()["evicted"] == (1 if evict_at else 0)
        for a, c in zip(*runs):
            np.testing.assert_array_equal(a, c)


def test_batcher_refusals():
    tparams = {"embed": torch.zeros((128, 64))}
    b = tb.ContinuousBatcher(TCFG, tparams, tb.BatchingConfig(page_size=4, num_pages=3,
                                                              max_slots=1, pages_per_slot=2))
    with pytest.raises(ValueError, match="slot span"):
        b.submit(np.ones(8, np.int32), 2)
    with pytest.raises(ValueError, match="empty prompt"):
        b.submit([], 2)
    with pytest.raises(ValueError, match="split_runtime needs placed_params"):
        tb.ContinuousBatcher(TCFG, tparams, split_runtime=object())
    assert tb.BatchingConfig(checkpoint_dir="/nowhere").checkpoint_dir == "/nowhere"
    with pytest.raises(tb.CheckpointError, match="no cache state to snapshot"):
        b.checkpoint_stream(b.submit(np.ones(3, np.int32), 2), "/nowhere/s.ckpt")
    b.discard(0)
    with pytest.raises(KeyError):  # a discarded stream has no handoff, as in the reference
        b.prefill_hold(0)
    b.submit(np.ones(3, np.int32), 4)
    b.submit(np.ones(3, np.int32), 4)
    with pytest.raises(OutOfPages, match="no stream can make progress"):
        b._try_admit = lambda sid: False  # a wedged pool
        b.run()


# ---------------------------------------------------------------------------
# The serving front
# ---------------------------------------------------------------------------


def _front_scenario(mod_front, mod_batch, cfg, params, clock_cls, prefix=None):
    """Submit a mix the front must sort: a shed-free queue with expiring
    deadlines, an oversized prompt, a full queue, then drain."""
    clock = clock_cls()
    kw = dict(page_size=4, num_pages=12, max_slots=2, pages_per_slot=4)
    batcher = mod_batch.ContinuousBatcher(cfg, params, mod_batch.BatchingConfig(**kw))
    front = mod_front.ServeFront(cfg, params, clock=clock, batcher=batcher,
                                 config=mod_front.ServeFrontConfig(
                                     admission=type(mod_front.ServeFrontConfig().admission)(
                                         max_queue_depth=5)))
    rng = np.random.default_rng(7)
    for i in range(7):
        clock.advance(0.25)
        n = 20 if i == 2 else 5
        front.submit(mod_front.Request(prompt_ids=rng.integers(1, 128, n).astype(np.int32),
                                       max_new_tokens=4, temperature=0.0 if i % 2 else 0.7,
                                       deadline_s=1.0 if i == 0 else 30.0, rng_seed=i,
                                       priority=1))
    clock.advance(0.9)  # request 0 waited past its deadline
    records = front.drain_batched()
    return records, front.report()


def test_serve_front_drain_batched_outcomes_match_reference(weights):
    jparams, tparams = weights
    got, trep = _front_scenario(tf, tb, TCFG, tparams, FakeClock)
    want, jrep = _front_scenario(jf, jb, JCFG, jparams, JClock)
    key = lambda r: (r.request_id, r.outcome, r.reason, r.backend, r.granted_tokens,
                     r.capacity, r.batch)
    assert sorted(map(key, got)) == sorted(map(key, want))
    outcomes = {r.outcome for r in got}
    assert {"completed", "timed_out", "rejected"} <= outcomes
    for g in got:
        w = next(r for r in want if r.request_id == g.request_id)
        if g.tokens is not None:
            np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    for k in ("requests", "finished", "tokens_out", "outcomes", "reasons", "queue_depth"):
        assert trep[k] == jrep[k], k
    assert trep["ttft_s"] == jrep["ttft_s"] and trep["latency_s"] == jrep["latency_s"]


def test_serve_front_refusals():
    """The front refuses as the reference does: a runtime and a ladder
    together, an empty ladder; the batched route needs its batcher; the
    per-request route drains an empty queue, its recovery fields arming a
    per-request ``RecoveryConfig`` (``req<rid>.ckpt``, no mid-call re-plan)."""
    with pytest.raises(tf.ServeFrontConfigError, match="not both"):
        tf.ServeFront(TCFG, {}, split_runtime=object(), split_ladder=[object()])
    with pytest.raises(tf.ServeFrontConfigError, match="may not be empty"):
        tf.ServeFront(TCFG, {}, split_ladder=[])
    front = tf.ServeFront(TCFG, {}, clock=FakeClock())
    with pytest.raises(tf.ServeFrontConfigError, match="needs a continuous batcher"):
        front.drain_batched()
    assert front.drain() == [] and front._recovery_cfg(1) is None
    for field, value in (("checkpoint_dir", "/nonexistent"), ("step_deadline_s", 5.0)):
        cfg = tf.ServeFrontConfig(**{field: value}, checkpoint_every=2)
        front = tf.ServeFront(TCFG, {}, config=cfg, clock=FakeClock())
        assert front.drain() == []
        rec = front._recovery_cfg(7)
        assert rec.replan is False and rec.clock is front.clock
        if field == "checkpoint_dir":
            assert rec.checkpoint_path == "/nonexistent/req7.ckpt" and rec.checkpoint_every == 2
        else:
            assert rec.checkpoint_path is None and rec.deadline_s == 5.0
    with pytest.raises(ValueError, match="capacity_round"):
        tf.ServeFrontConfig(capacity_round=0)


# ---------------------------------------------------------------------------
# The per-request route: the split front, speculative decode and the soak
# ---------------------------------------------------------------------------


def _split_pair(cuts=(1,), codecs=("int8_per_token",)):
    from edgellm_tpu.parallel import SplitConfig as JSplitConfig
    from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
    from edgellm_tpu.parallel import make_stage_mesh
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime

    n = len(cuts) + 1
    return (JSplitRuntime(JCFG, JSplitConfig(cuts=cuts, hop_codecs=codecs), make_stage_mesh(n)),
            SplitRuntime(TCFG, SplitConfig(cuts=cuts, hop_codecs=codecs), ["cpu"] * n))


@pytest.mark.parametrize("codec", ["fp32", "int8_per_token"])
def test_front_split_tokens_identical_to_direct_generate_split(weights, codec, monkeypatch):
    """One request through ``ServeFront(split_runtime=...).drain()``: the
    split plan, its bucketed capacity, and the tokens of a direct
    ``generate_split`` and of the reference front's drain."""
    from edgellm_tpu_torch.serve.decode import generate_split

    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")
    jparams, tparams = weights
    jrt, trt = _split_pair(codecs=(codec,))
    p = np.random.default_rng(12).integers(1, 128, 7).astype(np.int32)
    recs = {}
    for mod, cfg, params, rt, clock in ((tf, TCFG, tparams, trt, FakeClock),
                                        (jf, JCFG, jparams, jrt, JClock)):
        front = mod.ServeFront(cfg, params, split_runtime=rt, clock=clock())
        front.submit(mod.Request(prompt_ids=p, max_new_tokens=6, temperature=0.7, rng_seed=9))
        recs[mod] = front.drain()[0]
    rec, want = recs[tf], recs[jf]
    assert rec.outcome == "completed" and rec.backend == "split"
    assert rec.plan == {"mode": "split", "cuts": [1], "hop_codecs": [codec]} == want.plan
    assert rec.capacity == want.capacity == 16
    direct = generate_split(trt, trt.place_params(tparams), p[None], 6, capacity=rec.capacity,
                            temperature=0.7, rng_key=prng.key(9))
    np.testing.assert_array_equal(rec.tokens, direct.numpy())
    np.testing.assert_array_equal(rec.tokens, np.asarray(want.tokens))


def _soak_front(mod, clock_cls, cfg, params, rt, spec, soak_mod):
    clock = clock_cls()
    front = mod.ServeFront(cfg, params, split_runtime=rt, clock=clock, speculative=spec)
    # arrivals 10 virtual seconds apart: the clock advances by measured
    # service time, so the outcomes do not hang on the host's load
    soak = soak_mod.SoakConfig(n_requests=6, arrival_rate=0.1, prompt_len=8,
                               max_new_tokens=6, deadline_s=120.0, temperature=0.7)
    art = soak_mod.run_soak(front, soak, clock=clock)
    return art, {r.request_id: (r.outcome, None if r.tokens is None else np.asarray(r.tokens))
                 for r in front.records}


@pytest.mark.parametrize("speculative", [False, True])
def test_run_soak_on_a_split_front_matches_reference(weights, speculative, monkeypatch):
    """``run_soak`` over a split front (vanilla, and speculative with k = 4)
    at temperature 0.7: the artifact's keys, outcomes and identity audit, and
    every request's tokens by request id, equal the reference's. Timings and
    goodput follow the measured service time and are not compared."""
    from edgellm_tpu.serve import soak as jsoak
    from edgellm_tpu.serve import speculative as jspec
    from edgellm_tpu_torch.serve import soak as tsoak
    from edgellm_tpu_torch.serve import speculative as tspec

    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")
    jparams, tparams = weights
    jrt, trt = _split_pair()
    got, got_toks = _soak_front(tf, FakeClock, TCFG, tparams, trt,
                                tspec.SpecConfig(k=4) if speculative else None, tsoak)
    want, want_toks = _soak_front(jf, JClock, JCFG, jparams, jrt,
                                  jspec.SpecConfig(k=4) if speculative else None, jsoak)
    assert set(got) == set(want)
    assert got["requests"] == want["requests"] == 6
    assert got["outcomes"] == want["outcomes"] == {"completed": 6}
    assert got["token_identity"] == want["token_identity"]
    assert got["token_identity"]["ok"] and got["token_identity"]["checked"] == 6
    assert got["soak"] == want["soak"] and got["kill"] is None and got["burst"] is None
    assert got["flight_dumps"] is None
    assert sorted(got_toks) == sorted(want_toks)
    for rid, (outcome, toks) in got_toks.items():
        assert outcome == want_toks[rid][0]
        np.testing.assert_array_equal(toks, want_toks[rid][1])
    with pytest.raises(TypeError, match="FakeClock"):
        tsoak.run_soak(tf.ServeFront(TCFG, tparams), tsoak.SoakConfig(), clock=lambda: 0.0)


def test_front_stage_loss_fails_over_to_local(weights, monkeypatch):
    """A stage lost mid-request (the runtime raises ``StageLostError``): the
    stage's breaker trips, two stages leave nothing to re-plan onto, and the
    request fails over to the local ``generate`` with its tokens."""
    from edgellm_tpu_torch.serve.recovery import StageLostError

    _, tparams = weights
    _, trt = _split_pair()

    def lost(*args, **kwargs):
        raise StageLostError(1)

    monkeypatch.setattr(trt, "prefill_decode", lost)
    front = tf.ServeFront(TCFG, tparams, split_runtime=trt, clock=FakeClock())
    p = np.arange(1, 6, dtype=np.int32)
    front.submit(tf.Request(prompt_ids=p, max_new_tokens=4))
    rec = front.drain()[0]
    assert (rec.outcome, rec.reason, rec.backend) == ("failed_over", "stage_lost:1", "local")
    assert front.failovers == 1 and front.breakers["stage1"].state == "open"
    np.testing.assert_array_equal(rec.tokens, generate(TCFG, tparams, p[None], 4).numpy())


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------

def _config(name, **soak):
    p = json.loads((REPO / "configs" / name).read_text())
    p["serving"]["soak"].update(soak)
    return p


SERVE_CONFIGS = ["split9_qwen_paged.json", "split13_qwen_prefix.json", "split14_qwen_kvq.json"]


@pytest.mark.parametrize("name", SERVE_CONFIGS)
def test_serve_cli_matches_reference_cli(name, tmp_path, capsys):
    """The committed serve configs with tiny-qwen2 on the CPU (fewer requests
    for time): the printed line has the reference CLI's keys and counts."""
    p = json.dumps(_config(name, n_requests=10))
    argv = ["--params", p, "--model", "tiny-qwen2", "--device", "cpu"]
    assert trun.main(argv + ["--output-dir", str(tmp_path / "t")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jrun.main(argv[:4] + ["--output-dir", str(tmp_path / "j")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in got:
        if key not in ("decode_tokens_per_s", "artifact"):
            assert got[key] == want[key], key
    saved = json.loads((tmp_path / "t" / "serve_report.json").read_text())
    assert saved["requests"] == 10 and len(saved["records"]) == 10
    assert saved["batcher"]["jit_misses"] == 0


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A 3-layer Qwen2-architecture checkpoint both CLIs load."""
    from safetensors.torch import save_file
    from transformers import Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(0)
    model = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=256, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=128, max_position_embeddings=256,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True)).eval()
    path = tmp_path_factory.mktemp("qwen2_3l")
    model.config.to_json_file(str(path / "config.json"))
    save_file({k: v.contiguous() for k, v in model.state_dict().items()
               if k != "lm_head.weight"}, str(path / "model.safetensors"))
    return path


def _reference_serve_tokens(path, p):
    """The reference CLI's batched serve branch on a checkpoint, keeping the
    records (its printed line drops the tokens)."""
    from edgellm_tpu.models.safetensors_io import load_checkpoint
    from edgellm_tpu.serve.soak import SoakConfig

    cfg, params = load_checkpoint(str(path))
    soak = SoakConfig(**p["serving"]["soak"])
    clock = JClock()
    kw = dict(p["batching"])
    if "prefix_cache" in p:
        kw["prefix_cache"] = JPrefix(**p["prefix_cache"])
    if "kv_at_rest" in p:
        from edgellm_tpu.models.paged_kv import num_pages_for_bytes

        kw["kv_codec"] = p["kv_at_rest"]["codec"]
        kw["num_pages"] = num_pages_for_bytes(cfg, p["kv_at_rest"]["pool_bytes"],
                                              kw["page_size"], kv_codec=kw["kv_codec"])
    front = jf.ServeFront(cfg, params, config=jrun._serve_front_config(p["serving"]),
                          clock=clock, batcher=jb.ContinuousBatcher(cfg, params,
                                                                    jb.BatchingConfig(**kw)))
    rng = np.random.default_rng(soak.seed)
    gaps = rng.exponential(1.0 / soak.arrival_rate, size=soak.n_requests)
    shared = (rng.integers(1, cfg.vocab_size, size=soak.shared_prefix_len).astype(np.int32)
              if soak.shared_prefix_len else None)
    for i in range(soak.n_requests):
        clock.advance(float(gaps[i]))
        pi = rng.integers(1, cfg.vocab_size, size=soak.prompt_len).astype(np.int32)
        if shared is not None:
            pi[:soak.shared_prefix_len] = shared
        front.submit(jf.Request(prompt_ids=pi, max_new_tokens=soak.max_new_tokens,
                                temperature=soak.temperature, deadline_s=soak.deadline_s,
                                rng_seed=i))
    return {r.request_id: (r.outcome, None if r.tokens is None else np.asarray(r.tokens))
            for r in front.drain_batched()}


@pytest.mark.parametrize("name", SERVE_CONFIGS)
def test_serve_cli_greedy_tokens_equal_reference(name, hf_checkpoint, tmp_path):
    """With ``soak.temperature: 0`` and one checkpoint, every request's
    outcome and emitted tokens equal the reference's batched serve run."""
    from edgellm_tpu_torch.models.safetensors_io import load_checkpoint

    p = _config(name, n_requests=8, temperature=0.0)
    cfg, params = load_checkpoint(str(hf_checkpoint), device="cpu")
    out = lambda f: str(tmp_path / f)
    summary = trun.run_serve(cfg, params, p, out)
    want = _reference_serve_tokens(hf_checkpoint, p)
    got = {r.request_id: (r.outcome, r.tokens) for r in summary["_records"]}
    assert sorted(got) == sorted(want)
    for rid, (outcome, toks) in got.items():
        assert outcome == want[rid][0] == "completed"
        np.testing.assert_array_equal(toks, want[rid][1])


@pytest.mark.parametrize("key,value,message", [
    ("link_health", {}, "link_health requires an enabled 'faults' config"),
    ("gray", {}, "gray hardening \\(straggler demotion, request hedging\\) is a router policy"),
    ("cluster", {}, None),
    ("disagg", {"queue_bound": 0}, "disagg: queue_bound must be an integer >= 1"),
    ("pipeline", {}, "pipeline schedules micro-batches across the split boundary"),
    ("faults", {}, None),
])
def test_unported_serve_keys_are_named(key, value, message):
    """The serve keys once named as still to port validate as the reference
    validates them, with its messages: the link's (``faults`` alone passes,
    ``link_health`` needs an enabled ``faults``), the pipeline's (it needs
    ``cuts``), disagg's (a field is held to its bound), the router's
    (``cluster`` with its defaults passes) and the gray plane's (``gray``
    needs a ``cluster`` block)."""
    p = {**_config("split9_qwen_paged.json"), key: value}
    if message is None:
        trun._validate_params_json(p)
        jrun._validate_params_json(p)
        return
    with pytest.raises(SystemExit, match=message) as got:
        trun._validate_params_json(p)
    with pytest.raises(SystemExit) as want:
        jrun._validate_params_json(p)
    assert str(got.value) == str(want.value)


def test_serve_validation_messages_match_reference():
    base = _config("split9_qwen_paged.json")
    for bad in ({**base, "batching": {**base["batching"], "page_sz": 8}},
                {**base, "batching": {**base["batching"], "pages_per_slot": 1}},
                {**base, "serving": {**base["serving"], "capacity_round": 0}},
                {**base, "serving": {**base["serving"], "admission": {"max_queue_depth": 0}}},
                {**base, "prefix_cache": {"min_shared_block": -1}},
                {**base, "kv_at_rest": {"codec": "int2"}},
                {**base, "kv_at_rest": {"pool_bytes": 10}},
                {k: v for k, v in base.items() if k != "serving"}):
        with pytest.raises(SystemExit) as want:
            jrun._validate_params_json(bad)
        with pytest.raises(SystemExit) as got:
            trun._validate_params_json(bad)
        assert str(got.value) == str(want.value)


def test_serve_without_batching_and_serve_report_die_not_ported(tmp_path):
    """Serve without ``batching`` is the per-request route, ported with its
    recovery and stage-kill fields and the faulty link: each validates as
    the reference validates it; a kill out of range dies with its message;
    ``--serve-report`` prints the front's report after the JSON line."""
    p = {k: v for k, v in _config("split9_qwen_paged.json").items() if k != "batching"}
    trun._validate_params_json(p)
    for ok in ({**p, "serving": {**p["serving"], "checkpoint_dir": "ckpt"}},
               {**p, "serving": {**p["serving"], "step_deadline_s": 2.0}},
               {**p, "serving": {**p["serving"], "soak": {"kill_stage": 1}}},
               {**p, "faults": {"drop_rate": 0.1}}):
        trun._validate_params_json(ok)
        jrun._validate_params_json(ok)
    bad = {**p, "cuts": [1], "hop_codecs": ["fp32"],
           "serving": {**p["serving"], "soak": {"kill_stage": 2}}}
    for validate in (trun._validate_params_json, jrun._validate_params_json):
        with pytest.raises(SystemExit, match="kill_stage 2 out of range for 2 pipeline"):
            validate(bad)
    proc = subprocess.run(
        [sys.executable, "-m", "edgellm_tpu_torch.run", "--params",
         "configs/split9_qwen_paged.json", "--model", "tiny-qwen2", "--device", "cpu",
         "--serve-report", "--output-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[0])["outcomes"] == {"completed": 24}
    assert lines[1] == "serve report:" and "  outcome completed      24" in lines
    assert any(line.startswith("  retry budget spent=0") for line in lines)


#: the reference's checks of the per-request route's blocks: both CLIs refuse
#: each with the same message
PER_REQUEST_BAD = [
    {"speculative": {"k": 4}},
    {"cuts": [1], "hop_codecs": ["int8_per_token"], "speculative": []},
    {"cuts": [1], "hop_codecs": ["int8_per_token"], "speculative": {"window": 4}},
    {"cuts": [1], "hop_codecs": ["int8_per_token"], "speculative": {"k": 0}},
    {"cuts": [1], "hop_codecs": ["int8_per_token"], "speculative": {},
     "fused_hops": "remote"},
    {"cuts": [1], "hop_codecs": ["int8_per_token"], "speculative": {},
     "batching": {"page_size": 8, "num_pages": 64, "max_slots": 4, "pages_per_slot": 4}},
    {"cuts": [1]},
    {"cuts": [1, 2], "hop_codecs": ["int8_per_token"]},
    {"cuts": [1], "hop_codecs": ["int3"]},
    {"prefix_cache": {}},
    {"kv_at_rest": {"codec": "int8_per_channel"}},
]


@pytest.mark.parametrize("extra", PER_REQUEST_BAD, ids=range(len(PER_REQUEST_BAD)))
def test_per_request_serve_validation_messages_match_reference(extra):
    base = {k: v for k, v in _config("split11_qwen_spec.json").items()
            if k not in ("cuts", "hop_codecs", "fused_hops", "speculative")}
    bad = {**base, **extra}
    with pytest.raises(SystemExit) as want:
        jrun._validate_params_json(bad)
    with pytest.raises(SystemExit) as got:
        trun._validate_params_json(bad)
    assert str(got.value) == str(want.value)
