"""The port's split runtime and split eval against the TPU package's, on the
CPU.

One set of weights (the JAX package's ``init_params``, carried across with
``params_from_jax_numpy``) and one synthetic corpus (numpy seed) go through
``SplitRuntime.forward`` and ``run_split_eval`` of both packages; the JAX side
runs on the 8-device CPU mesh of ``tests/conftest.py``.

Tolerances: float32 logits rtol 1e-5 (atol 1e-5): the two forwards agree to
~3e-7, and the codecs are bit-exact (test_torch_codecs). A hop that rounds to
bf16 or fp16 can move a value the two forwards put on either side of a
rounding boundary by one half-precision step, so splits with such a hop are
held to atol 1e-4. PPL rtol 1e-5; byte totals exactly equal (both count the
same payload leaves).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.eval.split_eval import parse_hop_codec as j_parse_hop_codec
from edgellm_tpu.eval.split_eval import run_split_eval as j_split_eval
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import PRESETS as JPRESETS
from edgellm_tpu.models.configs import tiny_config as jtiny
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh
from edgellm_tpu_torch.codecs.packing import WireCodec, get_wire_codec
from edgellm_tpu_torch.eval import parse_hop_codec, run_split_eval
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models import forward, nll_from_logits
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import split as tsplit
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime, apply_default_codec_backend

PPL_RTOL = 1e-5


def _pair(jcfg, tcfg_, seed, dtype=jnp.float32):
    jp = j_init(jcfg, jax.random.key(seed), dtype=dtype)
    tp = params_from_jax_numpy(tcfg_, jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                               dtype=torch.bfloat16 if dtype == jnp.bfloat16 else None)
    return jp, tp


@pytest.fixture(scope="module")
def qwen():
    jp, tp = _pair(JPRESETS["tiny-qwen2"], tcfg.PRESETS["tiny-qwen2"], 0)
    return JPRESETS["tiny-qwen2"], tcfg.PRESETS["tiny-qwen2"], jp, tp


@pytest.fixture(scope="module")
def neox():
    jc, tc = jtiny("gpt_neox", num_layers=4), tcfg.tiny_config("gpt_neox", num_layers=4)
    jp, tp = _pair(jc, tc, 1)
    return jc, tc, jp, tp


def _imp(seed, b, s):
    imp = np.random.default_rng(seed).random((b, s)).astype(np.float32)
    return np.round(imp * 8) / 8  # ties, broken by position


#: (model, cuts, hop codecs): every registry codec that has a plain path
#: crosses at least one cut, in 2- and 3-stage splits of both families
FORWARD_CASES = [
    ("qwen", (1,), ("int8_per_token",)),
    ("qwen", (1, 3), ("int8_per_token", "int4_per_token")),
    ("qwen", (2, 4), ("fp32", "bf16")),
    ("qwen", (0, 2), ("fp16", "int4_global")),
    ("qwen", (1, 2), ("int8_per_channel", "int4_per_channel")),
    ("qwen", (3, 4), ("ternary_max", "ternary_per_token")),
    ("neox", (1,), ("int4_per_token",)),
    ("neox", (0, 2), ("ternary_mean", "selective_int4:0.25:bf16")),
    ("neox", (1, 2), ("int8_per_token_pallas", "int4_per_token_pallas")),
]


@pytest.mark.parametrize("model,cuts,codecs", FORWARD_CASES,
                         ids=["-".join((m,) + c) for m, _, c in FORWARD_CASES])
def test_split_forward_matches_reference(qwen, neox, model, cuts, codecs):
    jc, tc, jp, tp = qwen if model == "qwen" else neox
    ids = np.random.default_rng(len(codecs)).integers(0, 256, (2, 64))
    jcodecs = [j_parse_hop_codec(c) for c in codecs]
    imps = [_imp(i, 2, 64) if c.startswith("selective") else None
            for i, c in enumerate(codecs)]
    jrt = JSplitRuntime(jc, JSplitConfig(cuts, tuple(jcodecs)), make_stage_mesh(len(cuts) + 1))
    want = np.asarray(jrt.forward(jrt.place_params(jp), jnp.asarray(ids),
                                  hop_importance=[None if i is None else jnp.asarray(i)
                                                  for i in imps]))
    rt = SplitRuntime(tc, SplitConfig(cuts, tuple(parse_hop_codec(c) for c in codecs)),
                      ["cpu"] * (len(cuts) + 1))
    assert [c.name for c in rt.codecs] == [c.name for c in jrt.codecs]
    got = rt.forward(rt.place_params(tp), torch.from_numpy(ids), hop_importance=imps)
    assert got.dtype == torch.float32
    half = any(c in ("bf16", "fp16") or c.endswith(("bf16", "fp16")) for c in codecs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4 if half else 1e-5)
    assert rt.hop_bytes(2, 64) == jrt.hop_bytes(2, 64)
    assert rt.bytes_per_token(64) == jrt.bytes_per_token(64)


def test_dtype_reaching_each_stage_in_bf16(monkeypatch):
    """bf16 weights: stage 0 runs in bf16; the reference's select promotes
    the decoded float32 hidden at the first cut, so every later stage runs in
    float32, the dtype JAX promotes bf16 and float32 to."""
    jc, tc = JPRESETS["tiny-qwen2"], tcfg.PRESETS["tiny-qwen2"]
    jp, tp = _pair(jc, tc, 2, dtype=jnp.bfloat16)
    seen = []
    real = tsplit.run_layers

    def spy(cfg, params, hidden, **kw):
        seen.append(hidden.dtype)
        return real(cfg, params, hidden, **kw)

    monkeypatch.setattr(tsplit, "run_layers", spy)
    rt = SplitRuntime(tc, SplitConfig((1, 3), ("int8_per_token", "int4_per_token")),
                      ["cpu"] * 3)
    ids = np.random.default_rng(0).integers(0, 256, (2, 32))
    got = rt.forward(rt.place_params(tp), torch.from_numpy(ids))
    promoted = jnp.result_type(jnp.bfloat16, jnp.float32)
    assert seen == [torch.bfloat16, torch.float32, torch.float32]
    assert str(promoted) == "float32"
    jrt = JSplitRuntime(jc, JSplitConfig((1, 3), ("int8_per_token", "int4_per_token")),
                        make_stage_mesh(3))
    want = np.asarray(jrt.forward(jrt.place_params(jp), jnp.asarray(ids)))
    # bf16 stage 0 rounds at other places in the two frameworks: a loose check
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)


@pytest.fixture(scope="module")
def corpus():
    return np.random.default_rng(11).integers(0, 256, 64 + 32 * 7)


EVAL_CASES = {
    "fp32": dict(cuts=[2], hop_codecs=["fp32"]),
    "int8": dict(cuts=[2], hop_codecs=["int8_per_token"]),
    "selective": dict(cuts=[2], hop_codecs=["selective_int4:0.25:bf16"],
                      importance_method="regular_importance"),
    "two_hop": dict(cuts=[1, 3], hop_codecs=["int8_per_token", "int4_per_token"]),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_split_eval_matches_reference(qwen, corpus, case):
    jc, tc, jp, tp = qwen
    kw = dict(max_length=64, stride=32, window_batch=4, **EVAL_CASES[case])
    want = j_split_eval(jc, jp, corpus, **kw)
    got = run_split_eval(tc, tp, corpus, device="cpu", **kw)
    assert set(got) == set(want)
    assert (got["chunks"], got["n_tokens"]) == (want["chunks"], want["n_tokens"])
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=PPL_RTOL)
    for key in ("measured_hop_bytes_total", "bytes_per_token_per_hop",
                "measured_bytes_per_fwd_token_per_hop", "real_fwd_tokens",
                "pad_fraction", "cuts", "hop_codecs", "mesh"):
        assert got[key] == want[key], key
    assert [t["codec"] for t in got["per_hop_timing"]] == got["hop_codecs"]
    if case == "fp32":  # an fp32 cut is the unsplit model
        assert got["ppl"] == pytest.approx(_unsplit_ppl(tc, tp, corpus), rel=PPL_RTOL)


def _unsplit_ppl(cfg, params, corpus) -> float:
    from edgellm_tpu_torch.eval.windowing import sliding_windows

    nll, n = 0.0, 0
    for chunk in sliding_windows(corpus, 64, 32):
        logits, _ = forward(cfg, params, torch.from_numpy(chunk.input_ids))
        nll += float(nll_from_logits(logits, torch.from_numpy(chunk.target_ids))) \
            * chunk.num_loss_tokens
        n += chunk.num_loss_tokens
    return float(np.exp(nll / n))


@pytest.mark.parametrize("case", ["int8", "selective"])
def test_split_eval_window_batch_and_resume_are_exact(qwen, corpus, case, tmp_path):
    """window_batch 1 and 4 give the same PPL and bytes; a run killed after
    every group and resumed until done equals the uninterrupted run."""
    _, tc, _, tp = qwen
    corpus = corpus[:-7]  # a short corpus-tail window
    kw = dict(max_length=64, stride=32, time_hops=False, device="cpu", **EVAL_CASES[case])
    single = run_split_eval(tc, tp, corpus, window_batch=1, **kw)
    batched = run_split_eval(tc, tp, corpus, window_batch=4, **kw)
    assert batched["chunks"] == single["chunks"]
    np.testing.assert_allclose(batched["ppl"], single["ppl"], rtol=1e-6)
    assert batched["measured_hop_bytes_total"][0] >= single["measured_hop_bytes_total"][0]
    ckpt, metrics = str(tmp_path / "ckpt.json"), str(tmp_path / "m.jsonl")
    done = 0
    while done < batched["chunks"]:
        part = run_split_eval(tc, tp, corpus, window_batch=4, checkpoint_path=ckpt,
                              checkpoint_every=1, metrics_path=metrics,
                              max_chunks=done + 3, **kw)
        assert part["chunks"] > done
        done = part["chunks"]
    assert part["total_nll"] == batched["total_nll"]
    assert part["measured_hop_bytes_total"] == batched["measured_hop_bytes_total"]
    lines = [json.loads(l) for l in open(metrics)]
    assert lines[-1]["final"] and lines[-1]["chunks"] == batched["chunks"]
    with pytest.raises(ValueError, match="different sweep configuration"):
        run_split_eval(tc, tp, corpus, window_batch=2, checkpoint_path=ckpt, **kw)


UNPORTED_EVAL = {"faults": {"drop_rate": 0.1}, "link_policy": {}, "fec": {},
                 "hedge": {}, "link_health": {}, "deadline_s": 10.0,
                 "stage_failure": {"stage": 1, "at_step": 0}, "recovery": {},
                 "pipeline": object(), "n_seq": 2}


@pytest.mark.parametrize("arg", sorted(UNPORTED_EVAL))
def test_unported_split_eval_args_raise(qwen, corpus, arg):
    _, tc, _, tp = qwen
    with pytest.raises(ValueError, match=f"{arg}.*not ported yet"):
        run_split_eval(tc, tp, corpus, cuts=[2], hop_codecs=["int8_per_token"],
                       max_length=64, stride=32, device="cpu", **{arg: UNPORTED_EVAL[arg]})


@pytest.mark.parametrize("arg", ["faults", "policy", "fec", "hedge", "pipeline",
                                 "n_data", "n_model"])
def test_unported_runtime_args_raise(arg):
    split = SplitConfig((1,), ("int8_per_token",))
    with pytest.raises(ValueError, match=f"{arg}.*not ported yet"):
        SplitRuntime(tcfg.PRESETS["tiny-qwen2"], split, ["cpu"] * 2, **{arg: 2})


def test_parse_hop_codec_and_split_config():
    assert parse_hop_codec("int8_per_token") == "int8_per_token"
    assert parse_hop_codec("selective_int4:0.5:fp16").name == "selective_int4_r0.5_fp16"
    with pytest.raises(ValueError, match="not ported yet"):
        parse_hop_codec("int4_per_token", n_seq=4)
    with pytest.raises(ValueError, match="no longer exists"):
        parse_hop_codec("selective_int4_pallas:0.25")
    with pytest.raises(ValueError, match="stage x seq"):
        parse_hop_codec("selective_int4:0.25:bf16:local")
    split = SplitConfig((3, 7), ("int8_per_token", "int4_per_token"))
    assert split.stage_bounds(12) == [(0, 4), (4, 8), (8, 12)]
    assert split.replan(12, 2).cuts == JSplitConfig((3, 7), ("a", "b")).replan(12, 2).cuts
    with pytest.raises(ValueError, match="strictly increasing"):
        SplitConfig((3, 3), ("fp32", "fp32"))
    with pytest.raises(ValueError, match="out of range"):
        split.stage_bounds(8)


def test_codec_backend_and_real_copies():
    """On a CUDA device the split runs the kernel twin of every codec that
    has one (resolving names needs no card), the per-channel and ternary
    codecs included; on the CPU the plain codecs. Each hop decodes a copy of
    the payload, never the encoder's own tensors."""
    names = ["int8_per_token", "int4_per_token", "fp32"]
    on_card = apply_default_codec_backend(names + [parse_hop_codec("selective_int4:0.25")],
                                          "cuda")
    assert [c.name for c in on_card] == ["int8_per_token_pallas", "int4_per_token_pallas",
                                         "fp32", "selective_int4_r0.25_bf16"]
    for base in ("int8_per_channel", "int4_per_channel", "ternary_mean", "ternary_max"):
        assert [c.name for c in apply_default_codec_backend(names + [base], "cuda")] == \
            [c.name for c in on_card[:3]] + [base + "_pallas"]
        assert [c.name for c in apply_default_codec_backend(names + [base], "cpu")] == \
            names + [base]
    sent, received = [], []
    base = get_wire_codec("fp32")

    def enc(h):
        p = base.encode(h)
        sent.append(p["x"].data_ptr())
        return p

    def dec(p):
        received.append(p["x"].data_ptr())
        return base.decode(p)

    spy = WireCodec("spy", enc, dec)
    h = torch.randn(1, 8, 16)
    out = tsplit.run_pipeline_stages(2, [spy], lambda s, x: x + 1.0, h)
    assert sent and received and sent[0] != received[0]
    torch.testing.assert_close(out, (h + 1.0) + 1.0, atol=0, rtol=0)
