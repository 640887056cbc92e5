"""The port's KV-at-rest PPL harness held against the JAX package's on the
CPU: ``run_kv_tier_eval`` and ``run_kv_tier_sweep`` (``eval/split_eval.py``)
teacher-force every window through a paged pool at the fp, int8 and int4
tiers.

One set of weights (the reference's ``init_params`` at 4 layers, D = 32)
crosses with ``params_from_jax_numpy``; a seeded corpus long enough for a
full window batch, a lone chunk-0 window and the short corpus tail.

Tolerances: the counts (``n_tokens``, ``chunks``) and page bytes exactly;
PPL within rtol 1e-5 on the fp tier (the paged steps agree to ~1e-6) and
1e-3 on the quantized tiers, where a row that rounds on a .5 boundary may
put one code a step from the reference's.
"""
import numpy as np
import pytest
import torch

import jax

from edgellm_tpu.eval.split_eval import run_kv_tier_eval as j_eval
from edgellm_tpu.eval.split_eval import run_kv_tier_sweep as j_sweep
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as j_tiny
from edgellm_tpu_torch.eval import run_kv_tier_eval, run_kv_tier_sweep
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy

JCFG = j_tiny("qwen2", num_layers=4, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=4, hidden_size=32, num_heads=4, vocab_size=128)
PPL_RTOL = {"fp": 1e-5, "int8_per_channel": 1e-3, "int4_per_channel": 1e-3}
#: window 16, stride 8: chunk 0 alone, then groups of two full windows, and
#: the 12-token corpus tail alone (one executable per (W, T) in the
#: reference)
KW = dict(max_length=16, stride=8, page_size=8, window_batch=2)


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.key(3))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def corpus():
    return np.random.default_rng(7).integers(1, 128, 52).astype(np.int32)


@pytest.mark.parametrize("kv_codec", ["fp", "int8_per_channel", "int4_per_channel"])
def test_kv_tier_eval_matches_reference(weights, corpus, kv_codec):
    jp, tp = weights
    want = j_eval(JCFG, jp, corpus, kv_codec=kv_codec, **KW)
    got = run_kv_tier_eval(TCFG, tp, corpus, kv_codec=kv_codec, device="cpu", **KW)
    assert set(got) == set(want)
    for key in ("kv_codec", "n_tokens", "chunks", "page_size", "window_batch",
                "kv_page_bytes", "kv_page_bytes_fp"):
        assert got[key] == want[key], key
    assert got["chunks"] == 6 and got["n_tokens"] == 46
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=PPL_RTOL[kv_codec])
    np.testing.assert_allclose(got["total_nll"], want["total_nll"], rtol=PPL_RTOL[kv_codec])
    assert np.isfinite(got["ppl"])


def test_kv_tier_sweep_matches_reference(weights, corpus, tmp_path):
    """The sweep's rows in tier order, each with ``ppl_delta_vs_fp`` beside
    the reference's; the quantized tiers' pages cost less than fp's; the
    metrics stream gets one final record a tier."""
    jp, tp = weights
    kw = dict(KW, max_chunks=3)
    tiers = ("fp", "int8_per_channel", "int4_per_channel")
    want = j_sweep(JCFG, jp, corpus, tiers=tiers, **kw)
    metrics = tmp_path / "kv.jsonl"
    got = run_kv_tier_sweep(TCFG, tp, corpus, tiers=tiers, device="cpu",
                            metrics_path=str(metrics), **kw)
    assert [r["kv_codec"] for r in got] == list(tiers)
    assert got[0]["ppl_delta_vs_fp"] == 0.0
    for g, w in zip(got, want):
        assert g["chunks"] == w["chunks"] == 3 and g["n_tokens"] == w["n_tokens"]
        np.testing.assert_allclose(g["ppl_delta_vs_fp"], w["ppl_delta_vs_fp"], atol=2e-3)
    assert got[2]["kv_page_bytes"] < got[1]["kv_page_bytes"] < got[0]["kv_page_bytes_fp"]
    assert len(metrics.read_text().splitlines()) == 3
    no_fp = run_kv_tier_sweep(TCFG, tp, corpus, tiers=("int8_per_channel",), device="cpu",
                              **kw)
    assert "ppl_delta_vs_fp" not in no_fp[0]
    with pytest.raises(ValueError, match="unknown kv_codec"):
        run_kv_tier_eval(TCFG, tp, corpus, kv_codec="int2", device="cpu", **kw)


def test_kv_tier_eval_bf16_weights_score_like_fp32(weights, corpus):
    """bf16 weights (the reference promotes against its float32 fp-tier
    pages): the port's fp tier within bf16's reach of the fp32 run."""
    _, tp = weights
    bf = {k: (v.to(torch.bfloat16) if k != "layers" else
              [{n: t.to(torch.bfloat16) for n, t in lp.items()} for lp in v])
          for k, v in tp.items()}
    got = run_kv_tier_eval(TCFG, bf, corpus, kv_codec="fp", device="cpu", **KW)
    ref = run_kv_tier_eval(TCFG, tp, corpus, kv_codec="fp", device="cpu", **KW)
    np.testing.assert_allclose(got["ppl"], ref["ppl"], rtol=2e-2)
