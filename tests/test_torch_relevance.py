"""The port's LRP head relevance (``edgellm_tpu_torch.importance.relevance``)
against the JAX package's on the CPU.

One set of weights (the JAX package's ``init_params``, carried across with
``params_from_jax_numpy``) and token ids made with numpy from a seed go
through both packages: Qwen2 widths with 3 layers, 4 heads, 2 KV heads and
hd 64, plus a tiny GPT-NeoX (parallel residual, LayerNorm, partial rotary,
GELU).

Tolerances: the forward's logits and probabilities atol / rtol 1e-5 (the
same fp32 math, other summation order); the relevance rtol 1e-4 with atol
1e-6 * max|R|, after the per-row argmax tokens were found equal: the seed
is an argmax, so it is discontinuous in the weights, and the relevance is
compared only where both picked the same logit.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.importance import relevance as jrel
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as jtiny
from edgellm_tpu_torch.importance import relevance as trel
from edgellm_tpu_torch.models.configs import tiny_config as ttiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
REL_RTOL, REL_ATOL = 1e-4, 1e-6

#: (family, tiny_config keyword arguments): Qwen2 widths (hd 64, GQA 4 / 2)
#: and a tiny NeoX
MODELS = {
    "qwen2": ("qwen2", dict(num_layers=3, hidden_size=256, num_heads=4, num_kv_heads=2)),
    "neox": ("gpt_neox", dict(num_layers=3, hidden_size=64, num_heads=4)),
}


def _pair(name, seed=0, dtype=jnp.float32):
    family, kw = MODELS[name]
    jcfg, tcfg = jtiny(family, **kw), ttiny(family, **kw)
    jp = j_init(jcfg, jax.random.key(seed), dtype=dtype)
    tp = params_from_jax_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                               dtype=torch.bfloat16 if dtype == jnp.bfloat16 else None)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen2")


def _close_relevance(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=REL_RTOL, atol=REL_ATOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(2,), (3, 5), (2, 4, 8)])
def test_uniform_mul_gradients_equal_the_references(shape):
    rng = np.random.default_rng(len(shape))
    a, b, g = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    out = trel.uniform_mul(ta, tb)
    ga, gb = torch.autograd.grad(out, (ta, tb), grad_outputs=torch.tensor(g))
    jout, vjp = jax.vjp(jrel.uniform_mul, jnp.asarray(a), jnp.asarray(b))
    ja, jb = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ga.numpy(), 0.5 * g * b)
    np.testing.assert_array_equal(gb.numpy(), 0.5 * g * a)


@pytest.mark.parametrize("batch", [1, 2])
def test_lrp_forward_matches_reference(model, batch):
    jcfg, jp, tcfg, tp = model
    ids = np.random.default_rng(batch).integers(0, jcfg.vocab_size, size=(batch, 24))
    off = np.zeros((jcfg.num_layers, batch, jcfg.num_heads, 24, 24), np.float32)
    want_logits, want_probs = jrel.lrp_forward(jcfg, jp, jnp.asarray(ids), jnp.asarray(off))
    logits, probs = trel.lrp_forward(tcfg, tp, torch.from_numpy(ids), torch.from_numpy(off))
    assert logits.shape == want_logits.shape and probs.shape == want_probs.shape
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **FWD_TOL)
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(want_probs), **FWD_TOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_chunk_relevance_matches_reference(model, batch):
    jcfg, jp, tcfg, tp = model
    ids = np.random.default_rng(10 + batch).integers(0, jcfg.vocab_size, size=(batch, 32))
    want = np.asarray(jrel._chunk_relevance(jcfg)(jp, jnp.asarray(ids)))
    got, tokens = trel.chunk_relevance(tcfg, tp, torch.from_numpy(ids), with_tokens=True)
    off = jnp.zeros((jcfg.num_layers, batch, jcfg.num_heads, 32, 32))
    want_tokens = np.asarray(jrel.lrp_forward(jcfg, jp, jnp.asarray(ids), off)[0][:, -1]
                             .argmax(-1))
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    assert got.shape == want.shape == (jcfg.num_layers, jcfg.num_heads)
    assert got.dtype == torch.float32
    _close_relevance(got.numpy(), want)


def test_chunk_relevance_is_the_sum_of_its_rows(qwen):
    """The seed is per row, so a batch's relevance is its rows' sum."""
    _, _, tcfg, tp = qwen
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab_size, (3, 32)))
    whole = trel.chunk_relevance(tcfg, tp, ids)
    rows = sum(trel.chunk_relevance(tcfg, tp, ids[i:i + 1]) for i in range(3))
    torch.testing.assert_close(whole, rows, rtol=1e-5, atol=1e-6 * rows.abs().max().item())


@pytest.mark.parametrize("window_batch", [1, 3])
def test_run_relevance_extraction_matches_reference(model, window_batch):
    jcfg, jp, tcfg, tp = model
    corpus = np.random.default_rng(9).integers(0, jcfg.vocab_size, 130)
    kw = dict(max_length=32, stride=16, max_chunks=5, window_batch=window_batch)
    want_stats, got_stats = {}, {}
    want = jrel.run_relevance_extraction(jcfg, jp, corpus, stats=want_stats, **kw)
    got = trel.run_relevance_extraction(tcfg, tp, corpus, stats=got_stats, device="cpu", **kw)
    assert got.shape == want.shape == (jcfg.num_layers, jcfg.num_heads)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    _close_relevance(got, want)
    assert set(got_stats) == set(want_stats) == {"chunks", "wall_s", "it_per_s"}
    assert got_stats["chunks"] == want_stats["chunks"] == 5


def test_window_batched_relevance_equals_unbatched(qwen):
    _, _, tcfg, tp = qwen
    corpus = np.random.default_rng(11).integers(0, tcfg.vocab_size, 150)
    want = trel.run_relevance_extraction(tcfg, tp, corpus, max_length=32, stride=16,
                                         device="cpu")
    got = trel.run_relevance_extraction(tcfg, tp, corpus, max_length=32, stride=16,
                                        window_batch=4, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_relevance_checkpoint_resume(qwen, tmp_path):
    """A run cut at 4 chunks and resumed gives the uncut run's weights; the
    checkpoint and the metrics stream carry the reference's keys."""
    jcfg, jp, tcfg, tp = qwen
    corpus = np.random.default_rng(12).integers(0, tcfg.vocab_size, 150)
    kw = dict(max_length=32, stride=16, window_batch=2)
    want = trel.run_relevance_extraction(tcfg, tp, corpus, device="cpu", **kw)
    paths = {}
    for pkg, cfg, params, extra in (("torch", tcfg, tp, dict(device="cpu")),
                                    ("jax", jcfg, jp, {})):
        rel = trel if pkg == "torch" else jrel
        ckpt, metrics = str(tmp_path / f"{pkg}.json"), str(tmp_path / f"{pkg}.jsonl")
        rel.run_relevance_extraction(cfg, params, corpus, max_chunks=4, checkpoint_path=ckpt,
                                     checkpoint_every=2, metrics_path=metrics, **kw, **extra)
        paths[pkg] = ckpt, metrics
    with open(paths["torch"][0]) as f:
        cut = json.load(f)
    with open(paths["jax"][0]) as f:
        jcut = json.load(f)
    assert set(cut) == set(jcut) and cut["axes"] == jcut["axes"]
    assert cut["chunks"] == jcut["chunks"] == 4 and cut["next_chunk"] == jcut["next_chunk"]
    got = trel.run_relevance_extraction(tcfg, tp, corpus, checkpoint_path=paths["torch"][0],
                                        checkpoint_every=2, metrics_path=paths["torch"][1],
                                        device="cpu", **kw)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    lines = [json.loads(line) for line in open(paths["torch"][1])]
    jlines = [json.loads(line) for line in open(paths["jax"][1])]
    assert set(lines[0]) == set(jlines[0]) == {"chunk", "chunks", "it_per_s"}
    assert lines[-1]["final"] and lines[-1]["chunks"] > 4 and lines[-1]["it_per_s"] > 0


def test_relevance_with_bf16_params_matches_reference_bf16(tmp_path):
    """bf16 parameters: both packages keep the residual stream fp32 and widen
    each weight at its use, so the runs agree as the fp32 ones do."""
    jcfg, jp, tcfg, tp = _pair("qwen2", seed=1, dtype=jnp.bfloat16)
    assert all(lp["wq"].dtype == torch.bfloat16 for lp in tp["layers"])
    corpus = np.random.default_rng(13).integers(0, tcfg.vocab_size, 100)
    kw = dict(max_length=32, stride=16, window_batch=2)
    ids = np.stack([corpus[:32], corpus[16:48]])
    off = jnp.zeros((jcfg.num_layers, 2, jcfg.num_heads, 32, 32))
    want_tokens = np.asarray(jrel.lrp_forward(jcfg, jp, jnp.asarray(ids), off)[0][:, -1]
                             .argmax(-1))
    _, tokens = trel.chunk_relevance(tcfg, tp, torch.from_numpy(ids), with_tokens=True)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    want = jrel.run_relevance_extraction(jcfg, jp, corpus, **kw)
    got = trel.run_relevance_extraction(tcfg, tp, corpus, device="cpu", **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    _close_relevance(got, want)
