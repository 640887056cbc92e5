"""The port's speculative split decode held against the JAX package's on the
CPU: ``SpecConfig`` and its messages, ``spec_capacity``, the draft's bound,
greedy tokens (equal to the vanilla ``generate_split`` and to the reference's
``generate_speculative``), sampled tokens with their accept decisions and
``speculative`` stats, and ``prng.uniform`` against ``jax.random.uniform``.

Weights: the reference's ``init_params`` at its ``tests/test_speculative.py``
size (6 layers, D = 32, 4 heads, V = 128, cut 2, ``int8_per_token``), carried
with ``params_from_jax_numpy``. ``EDGELLM_FUSED_HOP`` is pinned to the
separate hop (the reference's default reads its own probe cache).

At temperature > 0 the accept decision of draft j is ``u < p(d_j)`` with
``p = softmax(logits / T)``: ``u`` is the same bits on both sides, but the
two softmaxes may differ by an ulp, so every decision is compared before the
tokens (a decision whose margin is within that ulp would be reported with
its seed and margin, not hidden by a tolerance).
"""
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
from edgellm_tpu.serve import speculative as jspec
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve import speculative as tspec
from edgellm_tpu_torch.serve.decode import generate_split
from edgellm_tpu_torch.utils import prng

JCFG = j_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
CUTS, CODECS = (2,), ("int8_per_token",)
PROMPT, MAX_NEW = 10, 9


@pytest.fixture(autouse=True)
def _separate_hops(monkeypatch):
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")


@pytest.fixture(scope="module")
def setup():
    jp = j_init(JCFG, jax.random.key(1))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jrt = JSplitRuntime(JCFG, JSplitConfig(cuts=CUTS, hop_codecs=CODECS), make_stage_mesh(2))
    trt = SplitRuntime(TCFG, SplitConfig(cuts=CUTS, hop_codecs=CODECS), ["cpu", "cpu"])
    return dict(jp=jp, tp=tp, jrt=jrt, trt=trt, jplaced=jrt.place_params(jp),
                tplaced=trt.place_params(tp))


def _ids(seed=11, batch=1):
    return np.random.default_rng(seed).integers(0, 128, (batch, PROMPT)).astype(np.int32)


@pytest.mark.parametrize("kwargs, msg", [
    ({"k": 0}, "k must be in"),
    ({"k": tspec.MAX_SPEC_K + 1}, "k must be in"),
    ({"k": True}, "k must be an int"),
    ({"k": "4"}, "k must be an int"),
    ({"draft_source": "ngram"}, "unknown draft_source"),
    ({"draft_layers": 0}, "draft_layers must be"),
    ({"draft_layers": False}, "draft_layers must be"),
])
def test_spec_config_messages_equal_reference(kwargs, msg):
    with pytest.raises(ValueError, match=msg) as got:
        tspec.SpecConfig(**kwargs)
    with pytest.raises(ValueError, match=msg) as want:
        jspec.SpecConfig(**kwargs)
    assert str(got.value) == str(want.value)
    assert (tspec.MAX_SPEC_K, tspec.DRAFT_SOURCES) == (jspec.MAX_SPEC_K, jspec.DRAFT_SOURCES)


@pytest.mark.parametrize("prompt,new,k", [(10, 9, 1), (10, 9, 4), (10, 9, 8), (8, 12, 4),
                                          (3, 1, 16)])
def test_spec_capacity_equals_reference(prompt, new, k):
    assert tspec.spec_capacity(prompt, new, k) == jspec.spec_capacity(prompt, new, k)
    # split11's shape: 22 rows, under the 32 its capacity_round of 16 gives
    assert tspec.spec_capacity(8, 12, 4) == 22


def test_draft_layers_bounded_by_stage0(setup):
    cut = CUTS[0]
    dcfg, dparams = tspec.draft_from_params(TCFG, setup["tp"], tspec.SpecConfig(), cut=cut)
    assert dcfg.num_layers == cut + 1
    assert len(dparams["layers"]) == cut + 1
    assert all(d["wq"].data_ptr() == t["wq"].data_ptr()
               for d, t in zip(dparams["layers"], setup["tp"]["layers"]))
    assert dparams["embed"] is setup["tp"]["embed"]
    dcfg, _ = tspec.draft_from_params(TCFG, setup["tp"], tspec.SpecConfig(draft_layers=1),
                                      cut=cut)
    assert dcfg.num_layers == 1
    for spec in (tspec.SpecConfig(draft_layers=cut + 2),):
        with pytest.raises(ValueError, match="stage 0 owns") as got:
            tspec.draft_from_params(TCFG, setup["tp"], spec, cut=cut)
        with pytest.raises(ValueError, match="stage 0 owns") as want:
            jspec.draft_from_params(JCFG, setup["jp"], jspec.SpecConfig(draft_layers=cut + 2),
                                    cut=cut)
        assert str(got.value) == str(want.value)


def test_generate_speculative_guards(setup):
    s = setup
    spec = tspec.SpecConfig(k=4)
    run = lambda ids, **kw: tspec.generate_speculative(s["trt"], s["tplaced"], ids, MAX_NEW,
                                                      **kw)
    with pytest.raises(ValueError, match="enabled"):
        run(_ids(), spec=tspec.SpecConfig(enabled=False), raw_params=s["tp"])
    with pytest.raises(ValueError, match="raw_params"):
        run(_ids(), spec=spec)
    with pytest.raises(ValueError, match="batch"):
        run(_ids(batch=2), spec=spec, raw_params=s["tp"])
    with pytest.raises(ValueError, match="cache overflow"):
        run(_ids(), spec=spec, raw_params=s["tp"], capacity=PROMPT + MAX_NEW)
    from edgellm_tpu_torch.serve.recovery import RecoveryConfig, StageFailure

    with pytest.raises(ValueError, match="stage-failure"):
        run(_ids(), spec=spec, raw_params=s["tp"],
            recovery=RecoveryConfig(stage_failure=StageFailure(stage=1, at_step=1)))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_spec_tokens_equal_vanilla_and_reference(setup, k):
    s = setup
    cap = tspec.spec_capacity(PROMPT, MAX_NEW, 4)
    for seed in (11, 12, 13):
        ids = _ids(seed)
        vanilla = generate_split(s["trt"], s["tplaced"], ids, MAX_NEW, capacity=cap)
        stats: dict = {}
        got = generate_split(s["trt"], s["tplaced"], ids, MAX_NEW, capacity=cap,
                             speculative=tspec.SpecConfig(k=k), raw_params=s["tp"],
                             stats=stats)
        jstats: dict = {}
        want = jspec.generate_speculative(s["jrt"], s["jplaced"], jnp.asarray(ids), MAX_NEW,
                                          spec=jspec.SpecConfig(k=k), capacity=cap,
                                          raw_params=s["jp"], stats=jstats)
        assert got.shape == (1, MAX_NEW) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), vanilla.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        sp, jsp = stats["speculative"], jstats["speculative"]
        assert set(sp) == set(jsp)
        for key in ("k", "draft_layers", "bursts", "drafted", "accepted", "rejected",
                    "acceptance_rate", "hops_per_token"):
            assert sp[key] == jsp[key], key
        assert sp["drafted"] == (k - 1) * sp["bursts"]
        assert sp["hops_per_token"] == sp["bursts"] / (MAX_NEW - 1) <= 1.0
        assert set(stats) == set(jstats) and stats["decode_steps"] == jstats["decode_steps"]


def _record_port(monkeypatch):
    """Wrap the port's accept pass: (feed, verify logits, accepted) a burst."""
    bursts = []
    real = tspec._accept

    def spy(vlogits, feed, key, n, k, temperature):
        emitted, acc = real(vlogits, feed, key, n, k, temperature)
        bursts.append((list(feed), vlogits[0].clone(), n, acc))
        return emitted, acc

    monkeypatch.setattr(tspec, "_accept", spy)
    return bursts


def _record_reference(jrt):
    """Wrap the reference runtime's verify_step: (fed ids, verify logits) a
    burst."""
    bursts = []
    real = jrt.verify_step

    def spy(placed, cache, token_ids):
        logits, cache = real(placed, cache, token_ids)
        bursts.append((np.asarray(token_ids)[0].tolist(), np.asarray(logits)[0]))
        return logits, cache

    jrt.verify_step = spy
    return bursts


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_sampled_spec_decisions_tokens_and_stats_equal_reference(setup, monkeypatch, seed):
    """T = 0.7 through the residual-resampling branch: the same drafts, then
    every accept decision (``u`` bit for bit, ``p(d_j)`` within an ulp, the
    same side of ``u``), then the tokens and the ``speculative`` stats."""
    s, k, temperature = setup, 4, 0.7
    jrt = JSplitRuntime(JCFG, JSplitConfig(cuts=CUTS, hop_codecs=CODECS), make_stage_mesh(2))
    jplaced = jrt.place_params(s["jp"])
    port, ref = _record_port(monkeypatch), _record_reference(jrt)
    ids = _ids(20 + seed)
    stats, jstats = {}, {}
    got = tspec.generate_speculative(s["trt"], s["tplaced"], ids, MAX_NEW,
                                     spec=tspec.SpecConfig(k=k), temperature=temperature,
                                     rng_key=prng.key(seed), raw_params=s["tp"], stats=stats)
    want = jspec.generate_speculative(jrt, jplaced, jnp.asarray(ids), MAX_NEW,
                                      spec=jspec.SpecConfig(k=k), temperature=temperature,
                                      rng_key=jax.random.key(seed), raw_params=s["jp"],
                                      stats=jstats)
    assert len(port) == len(ref) > 0
    key = jax.random.key(seed)
    decisions = 0
    for (feed, tlog, n, acc), (jfeed, jlog) in zip(port, ref):
        assert feed == jfeed
        np.testing.assert_allclose(tlog.numpy(), jlog, atol=2e-5, rtol=2e-5)
        taken = 0
        for j in range(1, k):
            pkey = jax.random.fold_in(key, n + j - 1)
            u = float(jax.random.uniform(jax.random.fold_in(pkey, 1)))
            tkey = torch.tensor([prng.key(seed)])
            tkey = prng.fold_in(prng.fold_in(tkey, torch.tensor([n + j - 1])),
                                torch.tensor([1]))
            assert float(prng.uniform(tkey, 1)[0, 0]) == u
            p_ref = float(jax.nn.softmax(jnp.asarray(jlog[j - 1]) / temperature)[feed[j]])
            x = tlog[j - 1] / torch.tensor(temperature, dtype=torch.float32)
            e = torch.exp(x - x.max())
            p_port = float((e / e.sum())[feed[j]])
            assert abs(p_port - p_ref) <= 4 * np.spacing(np.float32(max(p_ref, 1e-30)))
            assert (u < p_port) == (u < p_ref), (seed, n, j, u, p_port, p_ref)
            decisions += 1
            if not u < p_port:
                break
            taken += 1
        assert taken == acc
    assert decisions >= len(port)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("bursts", "drafted", "accepted", "rejected", "acceptance_rate",
                 "hops_per_token"):
        assert stats["speculative"][name] == jstats["speculative"][name], name


@pytest.mark.parametrize("seed", [0, 1, 23, 2 ** 31 - 1])
def test_prng_uniform_bit_equal_jax(seed):
    keys = prng.fold_in(torch.tensor([prng.key(seed)] * 3), torch.tensor([0, 5, 77]))
    for i, t in enumerate((0, 5, 77)):
        jk = jax.random.fold_in(jax.random.key(seed), t)
        np.testing.assert_array_equal(prng.uniform(keys[i:i + 1], 257)[0].numpy(),
                                      np.asarray(jax.random.uniform(jk, (257,))))
        assert float(prng.uniform(keys[i:i + 1], 1)[0, 0]) == float(jax.random.uniform(jk))


def test_prng_categorical_1d_with_neg_inf_equals_jax():
    """The residual draw: (V,) log-probabilities with zeroed entries (-inf)
    never land on them and pick JAX's token."""
    rng = np.random.default_rng(2)
    for trial in range(20):
        probs = rng.dirichlet(np.ones(128)).astype(np.float32)
        probs[rng.integers(0, 128, 5)] = 0.0
        with np.errstate(divide="ignore"):
            logits = np.log(probs)
        jk = jax.random.fold_in(jax.random.key(trial), 2)
        want = int(jax.random.categorical(jk, jnp.asarray(logits)))
        tk = torch.tensor([[int(x) for x in np.asarray(jax.random.key_data(jk))]])
        got = prng.categorical(tk, torch.from_numpy(logits))
        assert got.dim() == 0 and int(got) == want and probs[want] > 0
