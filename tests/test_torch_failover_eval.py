"""The split eval's survivability, the port against the JAX package on the
CPU: split6_qwen_failover.json's shape (three stages, stage 2 lost at chunk
4, re-planned onto the survivors, a 120 s deadline) on tiny-qwen2 with its
cuts inside the 6 layers, at window batch 4, so the loss lands on the second
window group while the first is still in flight under the two-deep submit
pipeline; the same beside a faulty link; the failover limit and the
watchdog.

One set of weights (the reference's ``init_params`` on tiny-qwen2, carried
across with ``params_from_jax_numpy``) and one synthetic corpus (numpy
seed). Tolerances: the recovery block, the token count and the byte totals
exactly (they depend on the plans and shapes alone); the PPL within rtol
1e-5 (the fp32 forwards agree to ~1e-6; the int8 hops are bit-exact).
"""
import numpy as np
import pytest

import jax

from edgellm_tpu.eval.split_eval import run_split_eval as j_split_eval
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import PRESETS as JPRESETS
from edgellm_tpu.serve.recovery import StageLostError as JStageLostError
from edgellm_tpu_torch.eval import run_split_eval
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.serve.recovery import DecodeTimeout, StageLostError
from edgellm_tpu_torch.utils.clock import FakeClock

PPL_RTOL = 1e-5
#: split6_qwen_failover.json with its cuts inside tiny-qwen2's 6 layers
FAILOVER = dict(cuts=[1, 3], hop_codecs=["int8_per_token", "int8_per_token"], max_length=64,
                stride=16, window_batch=4, max_chunks=14, time_hops=False,
                deadline_s=120.0, stage_failure={"stage": 2, "at_step": 4},
                recovery={"replan": True, "max_failovers": 1})
LINK = dict(faults=dict(drop_rate=0.3, seed=2), link_policy=dict(max_retries=1))
EXACT = ("recovery", "n_tokens", "chunks", "measured_hop_bytes_total", "cuts", "hop_codecs",
         "mesh", "real_fwd_tokens")


@pytest.fixture(scope="module")
def model():
    jc, tc = JPRESETS["tiny-qwen2"], tcfg.PRESETS["tiny-qwen2"]
    jp = j_init(jc, jax.random.key(0))
    tp = params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    corpus = np.random.default_rng(0).integers(0, tc.vocab_size, 64 + 13 * 16)
    return jc, tc, jp, tp, corpus


@pytest.mark.parametrize("link", [False, True], ids=["clean", "faulty_link"])
def test_failover_recovery_block_and_ppl_equal_reference(model, link):
    """The loss at chunk 4 re-plans 3 -> 2 stages (cut 2): the recovery
    block (counters, two plan generations, the re-planned cuts and codecs,
    the byte totals of the new plan), the token count, the first plan's
    byte totals and, under a link, its counters equal the reference's; the
    PPL within rtol 1e-5. No window is counted twice or dropped: the token
    count is the clean run's."""
    jc, tc, jp, tp, corpus = model
    kw = {**FAILOVER, **(LINK if link else {})}
    want = j_split_eval(jc, jp, corpus, **kw)
    got = run_split_eval(tc, tp, corpus, device="cpu", **kw)
    for key in EXACT + (("link_counters",) if link else ()):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=PPL_RTOL)
    rec = got["recovery"]
    assert rec["counters"]["failovers"] == rec["counters"]["replans"] == 1
    assert rec["plan_generations"] == 2 and rec["replanned_cuts"] == [2]
    assert rec["failover_mesh"] == {"stage": 2, "data": 1, "model": 1}
    clean = {k: v for k, v in kw.items()
             if k not in ("deadline_s", "stage_failure", "recovery")}
    base = run_split_eval(tc, tp, corpus, device="cpu", **clean)
    assert got["n_tokens"] == base["n_tokens"] and got["chunks"] == base["chunks"] == 14
    np.testing.assert_allclose(got["ppl"], base["ppl"], rtol=1e-3)


def test_failover_limit_and_replan_off_are_fatal(model):
    """``replan: False`` leaves the loss fatal in both packages."""
    jc, tc, jp, tp, corpus = model
    kw = {**FAILOVER, "recovery": {"replan": False}}
    with pytest.raises(JStageLostError):
        j_split_eval(jc, jp, corpus, **kw)
    with pytest.raises(StageLostError, match="stage 2 is dark"):
        run_split_eval(tc, tp, corpus, device="cpu", **kw)


def test_eval_watchdog_fires_on_a_stalled_chunk(model, tmp_path):
    """A clock that jumps past the deadline between drained chunks: the
    watchdog writes the resume checkpoint and raises ``DecodeTimeout``."""
    _, tc, _, tp, corpus = model

    class Jumpy(FakeClock):
        def __call__(self):
            return self.advance(5.0)

    path = tmp_path / "ck.json"
    kw = {k: v for k, v in FAILOVER.items() if k not in ("stage_failure", "recovery")}
    with pytest.raises(DecodeTimeout, match="eval chunk"):
        run_split_eval(tc, tp, corpus, device="cpu", checkpoint_path=str(path),
                       **{**kw, "deadline_s": 1.0}, _clock=Jumpy())
    assert path.exists()
