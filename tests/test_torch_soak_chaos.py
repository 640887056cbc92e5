"""The soak's chaos on the port's per-request route, held against the JAX
package on the CPU: a stage killed mid-soak (the front re-plans the split
onto the surviving stage devices, faults and policy carried over), a
corruption burst swapped in over an arrival window, the faulty link's
counters on every runtime that served, the retry budget, and the identity
audit's counts; then configs/split8_qwen_serve.json through both CLIs at
tiny depth (its cuts inside tiny-qwen2's 6 layers) with ``--serve-report``.

The direct soak runs one set of weights (the reference's ``init_params``)
through both fronts; its arrivals are at least 13 virtual seconds apart, in
one priority without deadlines, with breakers that never open, so no
outcome hangs on the measured service times. Tolerances: the
outcomes, reasons, kill and burst blocks' stages, identity counts (not its
``ok``: a substituted hop makes a request differ from its clean replay, in
the reference as in the port), the link counters of each runtime and the
retry budget exactly (they depend on the seeds, plans and shapes only).
"""
import json

import numpy as np
import pytest

import jax

from edgellm_tpu import run as jrun
from edgellm_tpu.codecs.faults import FaultConfig as JFaultConfig
from edgellm_tpu.codecs.faults import LinkPolicy as JLinkPolicy
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as j_tiny
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh
from edgellm_tpu.serve import frontend as jf
from edgellm_tpu.serve import overload as jo
from edgellm_tpu.serve import soak as jsoak
from edgellm_tpu.serve.decode import generate_split as j_generate_split
from edgellm_tpu.utils.clock import FakeClock as JClock
from edgellm_tpu_torch import run as trun
from edgellm_tpu_torch.codecs.faults import FaultConfig, LinkPolicy
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve import frontend as tf
from edgellm_tpu_torch.serve import overload as to
from edgellm_tpu_torch.serve import soak as tsoak
from edgellm_tpu_torch.serve.decode import generate_split
from edgellm_tpu_torch.utils import prng
from edgellm_tpu_torch.utils.clock import FakeClock

JCFG = j_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
CUTS, CODECS = (1, 3), ("int8_per_token", "int8_per_token")
#: split8's link, and a burst link that drops three copies in ten, with no retry
LINK = (dict(drop_rate=0.05, seed=0), dict(max_retries=4))
BURST = (dict(drop_rate=0.3, seed=1), dict(max_retries=0))
SOAK = dict(n_requests=12, arrival_rate=0.01, seed=2, prompt_len=8, max_new_tokens=6,
            deadline_s=None, temperature=0.7, priority_levels=1, kill_stage=1,
            burst_start_frac=0.15, burst_end_frac=0.35)


def _front(pkg, weights):
    """A warmed front of one package over split8's link, its burst
    runtime, and the clock."""
    jp, tp = weights
    if pkg == "ref":
        mk = lambda link: JSplitRuntime(  # noqa: E731
            JCFG, JSplitConfig(cuts=CUTS, hop_codecs=CODECS), make_stage_mesh(3),
            faults=JFaultConfig(**link[0]), policy=JLinkPolicy(**link[1]))
        f, o, clock, cfg, params, gen = jf, jo, JClock(), JCFG, jp, j_generate_split
        key = jax.random.key(0)
    else:
        mk = lambda link: SplitRuntime(  # noqa: E731
            TCFG, SplitConfig(cuts=CUTS, hop_codecs=CODECS), ["cpu"] * 3,
            faults=FaultConfig(**link[0]), policy=LinkPolicy(**link[1]))
        f, o, clock, cfg, params, gen = tf, to, FakeClock(), TCFG, tp, generate_split
        key = prng.key(0)
    rt, burst = mk(LINK), mk(BURST)
    for r in (rt, burst):  # warm (the reference compiles), then forget the counters
        gen(r, r.place_params(params), np.zeros((1, 8), np.int32), 6, capacity=16,
            temperature=0.7, rng_key=key)
        r.link_counters(reset=True)
    # breakers that never open: every request reaches the split it is routed
    # to, so the kill meets a live request
    config = f.ServeFrontConfig(breaker=o.BreakerConfig(failure_threshold=1000,
                                                        burn_threshold=1e9))
    return f.ServeFront(cfg, params, split_runtime=rt, config=config, clock=clock), burst, clock


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.key(1))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _counters(rt) -> dict:
    return {k: [int(x) for x in v] for k, v in rt.link_counters().items()}


def test_soak_kill_burst_and_link_counters_match_reference(weights, monkeypatch):
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")
    arts, fronts = {}, {}
    for pkg, mod in (("port", tsoak), ("ref", jsoak)):
        front, burst, clock = _front(pkg, weights)
        normal = front.split_runtime
        arts[pkg] = mod.run_soak(front, mod.SoakConfig(**SOAK), clock=clock,
                                 burst_runtime=burst)
        fronts[pkg] = (front, normal, burst)
    got, want = arts["port"], arts["ref"]
    assert got["outcomes"] == want["outcomes"]
    assert got["report"]["reasons"] == want["report"]["reasons"]
    assert got["report"]["failovers"] == want["report"]["failovers"] == 1
    assert got["kill"]["stage"] == want["kill"]["stage"] == 1
    assert got["burst"] is not None and want["burst"] is not None
    for key in ("checked", "matched", "mismatched_ids"):
        assert got["token_identity"][key] == want["token_identity"][key], key
    assert got["retry_budget"]["spent"] == want["retry_budget"]["spent"]
    assert got["report"]["breakers"] == want["report"]["breakers"]
    (tfront, tnormal, tburst), (jfront, jnormal, jburst) = fronts["port"], fronts["ref"]
    for t_rt, j_rt in ((tnormal, jnormal), (tburst, jburst),
                       (tfront.split_runtime, jfront.split_runtime)):
        assert _counters(t_rt) == _counters(j_rt)
    assert list(tfront.split_runtime.split.cuts) == [2] and tnormal.lost_stage == 1
    assert tfront.split_runtime.faults == tnormal.faults
    assert sum(_counters(tburst)["substituted"]) > 0
    # the front's sum over its calls (beyond the reference's report keys)
    lc = got["report"]["link_counters"]
    assert lc["hops"] == sum(sum(_counters(r)["hops"]) for r in
                             (tnormal, tburst, tfront.split_runtime))


def _split8_tiny() -> dict:
    p = json.loads(open("configs/split8_qwen_serve.json").read())
    p["cuts"] = [1, 3]
    return p


def test_cli_split8_kill_failover_and_serve_report(tmp_path, capsys, monkeypatch):
    """split8 as shipped, its cuts inside tiny-qwen2: every request is
    accounted for in both CLIs, each kills stage 1 once and fails over onto
    two stages (cut 2); the port's ``--serve-report`` prints the reference's
    lines, then the plan, the link counters and the kill."""
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")
    argv = ["--params", json.dumps(_split8_tiny()), "--model", "tiny-qwen2", "--serve-report"]
    assert trun.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    got = json.loads(out[0])
    assert jrun.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out.strip().splitlines()
    want = json.loads(jout[0])
    assert set(got) == set(want) and got["requests"] == want["requests"] == 24
    assert sum(got["outcomes"].values()) == 24
    art = json.loads((tmp_path / "t" / "serve_report.json").read_text())
    jart = json.loads((tmp_path / "j" / "serve_report.json").read_text())
    assert art["kill"]["stage"] == jart["kill"]["stage"] == 1
    assert art["report"]["failovers"] == jart["report"]["failovers"] == 1
    assert art["report"]["reasons"].get("stage_lost:1") == 1
    assert art["token_identity"]["checked"] > 0
    assert out[1] == jout[1] == "serve report:"
    plan = next(line for line in out if line.startswith("  plan "))
    assert "cuts=[2]" in plan and "failovers=1" in plan
    assert any(line.startswith("  link    hops=") for line in out)
    assert any(line.startswith("  kill    stage=1") for line in out)
    ref_kinds = {line.split()[0] for line in jout[2:]}
    assert ref_kinds <= {line.split()[0] for line in out[2:]}
