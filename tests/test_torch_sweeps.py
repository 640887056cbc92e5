"""The port's three sweeps against the TPU package's, end to end on the CPU.

One set of weights (the JAX package's ``init_params``, carried across with
``params_from_jax_numpy``) and one synthetic corpus (numpy seed) go through
``run_token_sweep``, ``run_channel_sweep`` and ``run_initial_sweep`` of both
packages at the geometry of ``configs/smoke.json`` (window 64, stride 32).

Tolerance: PPL rtol 1e-5. The two forwards agree to ~1e-6 in the logits, so
NLLs agree far inside it; the risk is a rank flip between two tokens whose
importance differs by less than the stats' ~1e-9 disagreement, which moves a
token across the quantization boundary. The seeds below were checked to
have none; the codecs themselves are bit-exact (test_torch_codecs).
"""
import json

import numpy as np
import pytest
import torch

import jax

from edgellm_tpu.eval import harness as jh
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import PRESETS as JPRESETS
from edgellm_tpu.models.configs import tiny_config as jtiny
from edgellm_tpu_torch.eval import harness as th
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models.convert import params_from_jax_numpy

with open("configs/smoke.json") as f:
    SMOKE = json.load(f)
PPL_RTOL = 1e-5


def _pair(jcfg, tcfg_, seed):
    jp = j_init(jcfg, jax.random.key(seed))
    tp = params_from_jax_numpy(tcfg_, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def qwen():
    jp, tp = _pair(JPRESETS["tiny-qwen2"], tcfg.PRESETS["tiny-qwen2"], 0)
    corpus = np.random.default_rng(11).integers(0, 256, 64 + 32 * 7)
    return jp, tp, corpus


def _sweep_kw(**over):
    kw = dict(methods=SMOKE["methods"] + ["weighted_importance"],
              layers_of_interest=SMOKE["layers_of_interest"], ratios=SMOKE["ratios"],
              max_length=SMOKE["max_length"], stride=SMOKE["stride"])
    kw.update(over)
    return kw


def _head_weights(n_layers=6, h=4):
    hw = np.random.default_rng(5).random((n_layers, h)).astype(np.float32)
    return hw / hw.sum(1, keepdims=True)


@pytest.mark.parametrize("codec", ["int4_token_select", "affine_int8_rank",
                                   "affine_int8_top_rho"])
def test_token_sweep_matches_reference(qwen, codec):
    jp, tp, corpus = qwen
    kw = _sweep_kw(head_weights=_head_weights(), codec=codec)
    want = jh.run_token_sweep(JPRESETS["tiny-qwen2"], jp, corpus, window_batch=4, **kw)
    got = th.run_token_sweep(tcfg.PRESETS["tiny-qwen2"], tp, corpus, window_batch=4,
                             device="cpu", **kw)
    assert (got.chunks, got.n_tokens) == (want.chunks, want.n_tokens)
    assert got.axes == want.axes
    np.testing.assert_allclose(got.ppl(), want.ppl(), rtol=PPL_RTOL)
    # quantization moved the NLL: the comparison is not of two fp baselines
    assert not np.allclose(got.ppl()[..., -1], got.ppl()[..., 0], rtol=1e-7)


def test_channel_sweep_matches_reference(qwen):
    jp, tp, corpus = qwen
    kw = dict(methods=["channel_8", "channel_4", "channel_1_mean", "channel_1_max"],
              layers_of_interest=[1, 3], max_length=64, stride=32)
    want = jh.run_channel_sweep(JPRESETS["tiny-qwen2"], jp, corpus, window_batch=3, **kw)
    got = th.run_channel_sweep(tcfg.PRESETS["tiny-qwen2"], tp, corpus, window_batch=3,
                               device="cpu", **kw)
    assert (got.chunks, got.n_tokens) == (want.chunks, want.n_tokens)
    np.testing.assert_allclose(got.ppl(), want.ppl(), rtol=PPL_RTOL)


def test_initial_sweep_matches_reference():
    """The Pythia "initial" experiment's every ordering variant on a tiny
    GPT-NeoX (configs/pythia_initial.json's specs and ratios)."""
    with open("configs/pythia_initial.json") as f:
        pi = json.load(f)
    jcfg = jtiny("gpt_neox", num_layers=5)
    tc = tcfg.tiny_config("gpt_neox", num_layers=5)
    jp, tp = _pair(jcfg, tc, 1)
    corpus = np.random.default_rng(12).integers(0, 256, 64 + 32 * 5)
    kw = dict(layers_of_interest=pi["layers_of_interest"], ratios=pi["ratios"],
              max_length=64, stride=32)
    want = jh.run_initial_sweep(jcfg, jp, corpus, window_batch=2, **kw)
    got = th.run_initial_sweep(tc, tp, corpus, window_batch=2, device="cpu", **kw)
    assert (got.chunks, got.axes) == (want.chunks, want.axes)
    np.testing.assert_allclose(got.ppl(), want.ppl(), rtol=PPL_RTOL)


def test_checkpoint_resume_is_exact(qwen, tmp_path):
    """Killed after every group and resumed until done: the totals equal the
    uninterrupted run's bit for bit."""
    _, tp, corpus = qwen
    cfg = tcfg.PRESETS["tiny-qwen2"]
    kw = _sweep_kw(methods=["regular_importance", "last_row"], device="cpu")
    full = th.run_token_sweep(cfg, tp, corpus, **kw)
    ckpt = str(tmp_path / "ckpt.json")
    done = 0
    while done < full.chunks:
        part = th.run_token_sweep(cfg, tp, corpus, checkpoint_path=ckpt,
                                  checkpoint_every=1, max_chunks=done + 2, **kw)
        assert part.chunks > done
        done = part.chunks
    np.testing.assert_array_equal(part.total_nll, full.total_nll)
    assert part.n_tokens == full.n_tokens
    other = _sweep_kw(methods=["last_row"], device="cpu")
    with pytest.raises(ValueError, match="different sweep configuration"):
        th.run_token_sweep(cfg, tp, corpus, checkpoint_path=ckpt, **other)


@pytest.mark.parametrize("driver", ["token", "channel", "initial"])
def test_window_batching_is_exact(qwen, driver):
    """window_batch > 1 changes the batch, not the math (the short tail
    window and chunk 0 run alone either way). rtol 1e-6: batched CPU matmuls
    may block differently."""
    _, tp, corpus = qwen
    cfg = tcfg.PRESETS["tiny-qwen2"]
    corpus = corpus[:-7]  # a short corpus-tail window
    if driver == "token":
        run, kw = th.run_token_sweep, _sweep_kw(methods=["regular_importance", "last_row"])
    elif driver == "channel":
        run, kw = th.run_channel_sweep, dict(methods=["channel_4", "channel_1_mean"],
                                             layers_of_interest=[1], max_length=64,
                                             stride=32)
    else:
        run, kw = th.run_initial_sweep, dict(layers_of_interest=[1, "upto ratio"],
                                             ratios=[0, 5, 10], max_length=64, stride=32)
    single = run(cfg, tp, corpus, window_batch=1, device="cpu", **kw)
    batched = run(cfg, tp, corpus, window_batch=3, device="cpu", **kw)
    assert (batched.chunks, batched.n_tokens) == (single.chunks, single.n_tokens)
    np.testing.assert_allclose(batched.total_nll, single.total_nll, rtol=1e-6)


def test_window_groups_match_reference():
    """Same groups, same order, same tails: chunk 0 alone, full windows in
    batches, the short corpus-tail window alone, resume and caps honoured."""
    ids = np.arange(64 + 32 * 9 - 5)
    for kw in (dict(window_batch=4), dict(window_batch=1), dict(window_batch=3, start_chunk=2),
               dict(window_batch=4, max_count=6)):
        want = [[c.index for c in g] for g in jh._iter_window_groups(
            ids, 64, 32, tail_of=jh._scoring_tail, **kw)]
        got = [[c.index for c in g] for g in th._iter_window_groups(
            ids, 64, 32, tail_of=th._scoring_tail, **kw)]
        assert got == want


def test_oom_backoff_halves_on_cuda_oom():
    seen = []

    def run(wb):
        seen.append(wb)
        if wb > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "ok"

    assert th.run_with_oom_backoff(run, 8) == ("ok", 2)
    assert seen == [8, 4, 2]
    with pytest.raises(ValueError):
        th.run_with_oom_backoff(lambda wb: (_ for _ in ()).throw(ValueError("x")), 8)


def test_table_and_json(qwen, tmp_path):
    _, tp, corpus = qwen
    mpath = str(tmp_path / "m.jsonl")
    res = th.run_token_sweep(tcfg.PRESETS["tiny-qwen2"], tp, corpus, device="cpu",
                             metrics_path=mpath, checkpoint_every=2,
                             **_sweep_kw(methods=["last_row"], layers_of_interest=[1]))
    table = res.table()
    assert "last_row" in table and "r=0.25" in table and "weighting=token_weighted" in table
    assert json.loads(json.dumps(res.to_json()))["chunks"] == res.chunks
    lines = [json.loads(l) for l in open(mpath)]
    assert lines[-1]["final"] and lines[-1]["chunks"] == res.chunks
