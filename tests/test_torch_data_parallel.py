"""The "data" mesh axis of the port's split runtime and split eval against
the TPU package's, on the CPU.

One set of weights (the reference's ``init_params`` on tiny-qwen2, carried
across with ``params_from_jax_numpy``) and one synthetic corpus (numpy
seed). The reference runs on the spoofed 8-device CPU mesh of
``tests/conftest.py`` at ("stage", "data", "model") = (n_stages, 2, 1) or
(3, 1, 2); the port runs its data groups (and model shards) in turn on the
CPU. Tolerances: logits atol 1e-5 (the forwards agree to ~3e-7 and the int8
hop is bit-exact), 1e-4 over the selective hop, whose bf16 part can move a
value the two forwards put on either side of a rounding boundary by one
bf16 step (as in ``test_torch_split``); the PPL within rtol 1e-5; token
counts, byte totals, mesh sizes, recovery blocks and link counters exactly
(they depend on the plans, the shapes and the PRNG alone). Refusals carry the reference's
messages word for word.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.codecs.faults import FaultConfig as JFaultConfig
from edgellm_tpu.codecs.faults import LinkPolicy as JLinkPolicy
from edgellm_tpu.eval.split_eval import parse_hop_codec as j_parse_hop_codec
from edgellm_tpu.eval.split_eval import run_split_eval as j_split_eval
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import PRESETS as JPRESETS
from edgellm_tpu.parallel import PipelineConfig as JPipelineConfig
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh as j_mesh
from edgellm_tpu_torch.codecs.faults import FaultConfig, LinkPolicy
from edgellm_tpu_torch.eval import parse_hop_codec, run_split_eval
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import PipelineConfig, SplitConfig, SplitRuntime, make_stage_mesh

ATOL, PPL_RTOL = 1e-5, 1e-5
KW = dict(max_length=32, stride=16, time_hops=False)
SELECTIVE = "selective_int4:0.25:bf16"
EXACT = ("n_tokens", "chunks", "measured_hop_bytes_total", "real_fwd_tokens", "mesh", "cuts")


@pytest.fixture(scope="module")
def model():
    jc, tc = JPRESETS["tiny-qwen2"], tcfg.PRESETS["tiny-qwen2"]
    jp = j_init(jc, jax.random.key(0))
    tp = params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    corpus = np.random.default_rng(7).integers(0, tc.vocab_size, 32 + 10 * 16)
    return jc, tc, jp, tp, corpus


def _imp(b, s):
    return np.round(np.random.default_rng(2).random((b, s)).astype(np.float32) * 8) / 8


@pytest.mark.parametrize("codec", ["int8_per_token", SELECTIVE])
def test_forward_n_data_2_matches_reference(model, codec):
    """Two data groups: the reference's logits, a selective hop's per-row
    importance riding with its rows."""
    jc, tc, jp, tp, _ = model
    ids = np.random.default_rng(1).integers(0, tc.vocab_size, (4, 32))
    imp = [_imp(4, 32)] if codec == SELECTIVE else None
    jrt = JSplitRuntime(jc, JSplitConfig((2,), (j_parse_hop_codec(codec),)), j_mesh(2, 2, 1))
    want = np.asarray(jrt.forward(jrt.place_params(jp), jnp.asarray(ids),
                                  hop_importance=None if imp is None else [jnp.asarray(imp[0])]))
    rt = SplitRuntime(tc, SplitConfig((2,), (parse_hop_codec(codec),)), ["cpu"] * 2, n_data=2)
    with torch.inference_mode():
        got = rt.forward(rt.place_params(tp), torch.as_tensor(ids),
                         hop_importance=None if imp is None else [torch.as_tensor(imp[0])])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 if imp else ATOL, rtol=0)


@pytest.mark.parametrize("codec", ["int8_per_token", SELECTIVE])
def test_split_eval_n_data_2_matches_reference_and_unbatched(model, codec):
    """``run_split_eval`` at window batch 4 over two data groups (the tail
    group padded to the data axis): PPL, token counts, bytes and ``mesh``
    the reference's; the PPL the unbatched one-group run's."""
    jc, tc, jp, tp, corpus = model
    kw = dict(cuts=[2], hop_codecs=[codec], **KW,
              importance_method="last_row" if codec == SELECTIVE else None)
    want = j_split_eval(jc, jp, corpus, window_batch=4, mesh=j_mesh(2, 2, 1), **kw)
    got = run_split_eval(tc, tp, corpus, window_batch=4, device="cpu",
                         mesh=make_stage_mesh(2, 2, 1, device="cpu"), **kw)
    for key in EXACT:
        assert got[key] == want[key], key
    assert got["mesh"] == {"stage": 2, "data": 2, "model": 1}
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=PPL_RTOL)
    single = run_split_eval(tc, tp, corpus, window_batch=1, device="cpu", **kw)
    np.testing.assert_allclose(got["ppl"], single["ppl"], rtol=PPL_RTOL)
    assert got["n_tokens"] == single["n_tokens"]


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


REFUSALS = {
    # a batch-wide codec scale under the data axis
    "batch_wide_codec": (
        lambda jc: JSplitRuntime(jc, JSplitConfig((2,), ("int4_global",)), j_mesh(2, 2, 1)),
        lambda tc: SplitRuntime(tc, SplitConfig((2,), ("int4_global",)), ["cpu"] * 2,
                                n_data=2)),
    # the µ-batch pipeline with a model axis
    "pipeline": (
        lambda jc: JSplitRuntime(jc, JSplitConfig((2,), ("int8_per_token",)), j_mesh(2, 1, 2),
                                 pipeline=JPipelineConfig(2)),
        lambda tc: SplitRuntime(tc, SplitConfig((2,), ("int8_per_token",)), ["cpu"] * 2,
                                n_model=2, pipeline=PipelineConfig(2))),
}


@pytest.mark.parametrize("case", ["batch_wide_codec", "pipeline", "not_a_multiple", "decode"])
def test_refusals_match_reference(model, case):
    """Each refusal raises with the reference's message: a batch-wide codec
    under data parallelism, the pipeline with either axis above 1, a window
    batch the data axis does not divide, and every decode entry."""
    jc, tc, jp, tp, corpus = model
    if case in REFUSALS:
        want_fn, got_fn = REFUSALS[case]
        assert _message(lambda: got_fn(tc)) == _message(lambda: want_fn(jc))
        return
    if case == "not_a_multiple":
        kw = dict(cuts=[2], hop_codecs=["int8_per_token"], window_batch=3, **KW)
        want = _message(lambda: j_split_eval(jc, jp, corpus, mesh=j_mesh(2, 2, 1), **kw))
        got = _message(lambda: run_split_eval(tc, tp, corpus, device="cpu",
                                              mesh=make_stage_mesh(2, 2, 1, device="cpu"), **kw))
        assert got == want and "must be a multiple of the mesh data axis size 2" in got
        return
    jrt = JSplitRuntime(jc, JSplitConfig((2,), ("int8_per_token",)), j_mesh(2, 2, 1))
    rt = SplitRuntime(tc, SplitConfig((2,), ("int8_per_token",)), ["cpu"] * 2, n_data=2)
    ids = np.zeros((2, 4), np.int64)
    want = _message(lambda: jrt.prefill_decode(jrt.place_params(jp), jnp.asarray(ids), 8))
    placed = rt.place_params(tp)
    assert _message(lambda: rt.prefill_decode(placed, torch.as_tensor(ids), 8)) == want
    for call in (lambda: rt.decode_step(placed, {}, torch.zeros(2, dtype=torch.long)),
                 lambda: rt.verify_step(placed, {}, torch.zeros((2, 2), dtype=torch.long)),
                 lambda: rt.init_paged_pool(4, 4)):
        assert _message(call) == want
    assert "split decode supports stage-only meshes" in want


def test_reference_checkpoint_resumes_in_the_port(model, tmp_path):
    """A checkpoint the reference writes at n_data 2 after two chunks
    resumes in the port (the resume axes hold the real mesh sizes) and
    finishes at the reference's uninterrupted PPL; and the reverse."""
    jc, tc, jp, tp, corpus = model
    kw = dict(cuts=[2], hop_codecs=["int8_per_token"], window_batch=2, **KW)
    jm, tm = j_mesh(2, 2, 1), make_stage_mesh(2, 2, 1, device="cpu")
    full = j_split_eval(jc, jp, corpus, mesh=jm, **kw)
    ckpt = tmp_path / "ref.json"
    j_split_eval(jc, jp, corpus, mesh=jm, max_chunks=2, checkpoint_path=str(ckpt),
                 checkpoint_every=1, **kw)
    assert json.loads(ckpt.read_text())["axes"]["mesh"] == {"stage": 2, "data": 2, "model": 1}
    got = run_split_eval(tc, tp, corpus, device="cpu", mesh=tm, checkpoint_path=str(ckpt),
                         checkpoint_every=1, **kw)
    assert got["chunks"] == full["chunks"] and got["n_tokens"] == full["n_tokens"]
    np.testing.assert_allclose(got["ppl"], full["ppl"], rtol=PPL_RTOL)
    ckpt2 = tmp_path / "port.json"
    run_split_eval(tc, tp, corpus, device="cpu", mesh=tm, max_chunks=2,
                   checkpoint_path=str(ckpt2), checkpoint_every=1, **kw)
    back = j_split_eval(jc, jp, corpus, mesh=jm, checkpoint_path=str(ckpt2),
                        checkpoint_every=1, **kw)
    np.testing.assert_allclose(back["ppl"], full["ppl"], rtol=PPL_RTOL)


def test_split6_failover_keeps_the_model_axis(model):
    """split6's failover shape (three stages, stage 2 lost at chunk 4) at
    n_model 2: the re-plan keeps the model axis, and the recovery block,
    token count and byte totals equal the reference's."""
    jc, tc, jp, tp, corpus = model
    kw = dict(cuts=[1, 3], hop_codecs=["int8_per_token"] * 2, window_batch=2, max_chunks=8,
              stage_failure={"stage": 2, "at_step": 4}, recovery={"replan": True}, **KW)
    want = j_split_eval(jc, jp, corpus, mesh=j_mesh(3, 1, 2), **kw)
    got = run_split_eval(tc, tp, corpus, device="cpu",
                         mesh=make_stage_mesh(3, 1, 2, device="cpu"), **kw)
    for key in EXACT + ("recovery",):
        assert got[key] == want[key], key
    assert got["recovery"]["failover_mesh"] == {"stage": 2, "data": 1, "model": 2}
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=PPL_RTOL)


def test_faulty_link_at_n_data_2(model):
    """The link at two data groups: each group draws its masks at its own
    (B / 2) shape from the same key, so the logits match the reference's and
    the counters are the reference's (one group's: see the module note of
    ``parallel/split.py``), call by call."""
    jc, tc, jp, tp, _ = model
    ids = np.random.default_rng(4).integers(0, tc.vocab_size, (4, 32))
    jrt = JSplitRuntime(jc, JSplitConfig((2,), ("int8_per_token",)), j_mesh(2, 2, 1),
                        faults=JFaultConfig(drop_rate=0.4, bitflip_rate=1e-3, seed=5),
                        policy=JLinkPolicy(max_retries=1))
    rt = SplitRuntime(tc, SplitConfig((2,), ("int8_per_token",)), ["cpu"] * 2, n_data=2,
                      faults=FaultConfig(drop_rate=0.4, bitflip_rate=1e-3, seed=5),
                      policy=LinkPolicy(max_retries=1))
    jpl, placed = jrt.place_params(jp), rt.place_params(tp)
    for step in range(4):
        want = np.asarray(jrt.forward(jpl, jnp.asarray(ids), fault_step=step))
        with torch.inference_mode():
            got = rt.forward(placed, torch.as_tensor(ids), fault_step=step).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        assert ({k: np.asarray(v).tolist() for k, v in rt.link_counters().items()}
                == {k: np.asarray(v).tolist() for k, v in jrt.link_counters().items()})
    assert int(rt.link_counters()["hops"][0]) == 4
