"""The split eval over the faulty link, the port against the TPU package, on
the CPU.

One set of weights (the reference's ``init_params`` on tiny-qwen2, carried
across with ``params_from_jax_numpy``) and one synthetic corpus (numpy
seed) go through both packages' ``run_split_eval`` with split6- and
split7-shaped link settings, their rates raised (and, for the split6 shape,
a byte budget the int8 payload exceeds and the int4 one fits) so that every
counter fires at this size: ``link_counters``, ``tier_switches``,
``final_tier``, ``degraded_chunks`` and ``link_health`` are equal (they
depend only on the PRNG and the payload sizes), the PPL within rtol 1e-4
(the splits' tolerance). One reference run per shape, shared through
module-scoped fixtures.
"""
import json

import numpy as np
import pytest

import jax

from edgellm_tpu.eval.split_eval import run_fault_sweep as j_fault_sweep
from edgellm_tpu.eval.split_eval import run_split_eval as j_split_eval
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import PRESETS as JPRESETS
from edgellm_tpu_torch import run as trun
from edgellm_tpu_torch.eval import run_fault_sweep, run_split_eval
from edgellm_tpu_torch.models import configs as tcfg
from edgellm_tpu_torch.models.convert import params_from_jax_numpy

PPL_RTOL = 1e-4
KW = dict(cuts=[2], hop_codecs=["int8_per_token"], max_length=64, stride=16,
          window_batch=2, time_hops=False)
LADDER = ["int4_per_token", "ternary_per_token"]
#: split6_qwen_chaos.json's shape: bit flips and drops, two retries, the
#: streak controller over the int8 -> int4 -> ternary ladder
SPLIT6 = dict(faults=dict(bitflip_rate=2e-4, drop_rate=0.2, byte_budget=6000, seed=0),
              link_policy=dict(max_retries=2, on_fail="substitute", tiers=LADDER,
                               degrade_after=2, recover_after=3))
#: split7_qwen_lossy.json's shape: FEC, two hedged routes, the SLO tracker
#: (one retry where the config has two: the reference unrolls every attempt
#: and route, and its compile time grows with them)
SPLIT7 = dict(faults=dict(bitflip_rate=1e-4, drop_rate=0.3, seed=1),
              link_policy=dict(max_retries=1, on_fail="substitute", tiers=LADDER),
              fec=dict(group_size=4, n_groups=4), hedge=dict(routes=2),
              link_health=dict(window=3, error_budget=0.05, degrade_burn=1.0,
                               promote_burn=0.25, min_dwell_s=0.0))
LINK_RESULT_KEYS = ("link_counters", "tier_switches", "final_tier", "degraded_chunks",
                    "tier_ladder", "faults", "link_policy")


@pytest.fixture(scope="module")
def model():
    jc, tc = JPRESETS["tiny-qwen2"], tcfg.PRESETS["tiny-qwen2"]
    jp = j_init(jc, jax.random.key(0))
    tp = params_from_jax_numpy(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    corpus = np.random.default_rng(0).integers(0, tc.vocab_size, 64 + 31 * 16)
    return jc, tc, jp, tp, corpus


@pytest.fixture(scope="module")
def split6(model):
    jc, tc, jp, tp, corpus = model
    return (j_split_eval(jc, jp, corpus, **KW, **SPLIT6),
            run_split_eval(tc, tp, corpus, device="cpu", **KW, **SPLIT6))


@pytest.fixture(scope="module")
def split7(model):
    jc, tc, jp, tp, corpus = model
    return (j_split_eval(jc, jp, corpus, **KW, **SPLIT7),
            run_split_eval(tc, tp, corpus, device="cpu", **KW, **SPLIT7))


@pytest.mark.parametrize("shape", ["split6", "split7"])
def test_link_counters_and_tier_trail_equal_reference(split6, split7, shape):
    want, got = split6 if shape == "split6" else split7
    for key in LINK_RESULT_KEYS:
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=PPL_RTOL)
    assert got["chunks"] == want["chunks"] == 32
    assert got["measured_hop_bytes_total"] == want["measured_hop_bytes_total"]
    counters = got["link_counters"]
    assert got["tier_switches"] and got["degraded_chunks"] > 0
    if shape == "split6":
        # every counter fires, and the ladder steps down twice
        assert all(counters[k][0] > 0 for k in counters), counters
        assert len(got["tier_switches"]) >= 2
    else:
        assert got["link_health"] == want["link_health"]
        assert got["fec"] == want["fec"] and got["hedge"] == want["hedge"]
        for key in ("detected", "repaired", "hedge_wins", "recovered", "retried"):
            assert counters[key][0] > 0, key


@pytest.mark.parametrize("shape", ["split6", "split7"])
def test_link_by_tier_accounts_every_copy_sent(split6, split7, shape):
    """The port's per-tier accounting sums to the reference's counters."""
    want, got = split6 if shape == "split6" else split7
    tiers = [t for t in got["link_by_tier"] if t is not None]
    assert [t["hop_codecs"] for t in tiers][0] == ["int8_per_token"]
    assert len(got["link_by_tier"]) == len(got["tier_ladder"]) == 3
    for key, total in want["link_counters"].items():
        assert sum(t["counters"][key][0] for t in tiers) == total[0]


def test_zero_rate_faults_equal_the_clean_split(model):
    """An all-zero ``faults`` config builds no link: the clean split's PPL
    bit for bit, and no link keys in the result."""
    _, tc, _, tp, corpus = model
    clean = run_split_eval(tc, tp, corpus, device="cpu", max_chunks=8, **KW)
    zero = run_split_eval(tc, tp, corpus, device="cpu", max_chunks=8,
                          faults={"drop_rate": 0.0, "seed": 3}, link_policy={"max_retries": 1},
                          **KW)
    assert zero["total_nll"] == clean["total_nll"] and zero["ppl"] == clean["ppl"]
    assert "link_counters" not in zero
    with pytest.raises(ValueError, match="require an enabled faults config"):
        run_split_eval(tc, tp, corpus, device="cpu", faults={"drop_rate": 0.0},
                       fec={}, **KW)


def test_fault_sweep_knobs_rates_and_clean_baseline(model):
    """``run_fault_sweep`` at drop rates 0, 0.2 and 0.6 on both packages:
    the same knobs and rates, equal link counters at every point and the
    PPL within rtol 1e-4; the rate-0 point is the clean split's bit for
    bit."""
    jc, tc, jp, tp, corpus = model
    kw = {**KW, "max_chunks": 8}
    sweep_kw = dict(rates=[0.0, 0.2, 0.6], knob="drop_rate", seed=4,
                    link_policy={"max_retries": 1}, fec={"group_size": 2, "n_groups": 2}, **kw)
    sweep = run_fault_sweep(tc, tp, corpus, device="cpu", **sweep_kw)
    want = j_fault_sweep(jc, jp, corpus, **sweep_kw)
    assert [(r["fault_knob"], r["fault_rate"]) for r in sweep] == [
        (r["fault_knob"], r["fault_rate"]) for r in want] == [
        ("drop_rate", 0.0), ("drop_rate", 0.2), ("drop_rate", 0.6)]
    for got, ref in zip(sweep, want):
        assert got.get("link_counters") == ref.get("link_counters")
        np.testing.assert_allclose(got["ppl"], ref["ppl"], rtol=PPL_RTOL)
    clean = run_split_eval(tc, tp, corpus, device="cpu", **kw)
    assert sweep[0]["total_nll"] == clean["total_nll"] and "link_counters" not in sweep[0]
    subs = [r["link_counters"]["substituted"][0] for r in sweep[1:]]
    assert subs[1] >= subs[0] and sweep[2]["link_counters"]["hops"] == [4]
    assert all(r["link_counters"]["detected"][0] > 0 for r in sweep[1:])
    with pytest.raises(ValueError, match="unknown fault knob"):
        run_fault_sweep(tc, tp, corpus, rates=[0.1], knob="jitter", device="cpu", **kw)


def test_cli_runs_a_link_config_and_prints_the_fault_report(model, tmp_path, capsys):
    """split7's committed config with its cut inside tiny-qwen2's 6 layers,
    through the CLI on the CPU: the results file carries the link keys, and
    ``--fault-report`` prints the registry table and the tier trail."""
    p = json.loads(open("configs/split7_qwen_lossy.json").read())
    p.update(cuts=[2], max_length=64, stride=16)
    p["faults"]["bitflip_rate"] = 1e-3
    rc = trun.main(["--params", json.dumps(p), "--model", "tiny-qwen2", "--device", "cpu",
                    "--output-dir", str(tmp_path), "--max-chunks", "16", "--window-batch", "2",
                    "--fault-report"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    result = json.loads((tmp_path / "split_eval_results.json").read_text())
    assert json.loads(out[0]) == result
    assert out[1] == "fault report (obs metrics registry):"
    table = {line.split()[0]: float(line.split()[1]) for line in out[2:]
             if line.startswith("  edgellm_")}
    for key, per_hop in result["link_counters"].items():
        assert table.get(f'edgellm_link_{key}_total{{hop="total"}}') == sum(per_hop)
    assert table["edgellm_link_health_window"] == result["link_health"]["window"]
    if result["tier_switches"]:
        assert out[-1].startswith("  tier switches: ")
    # faults off: the reference's line
    trun._print_fault_report({"ppl": 1.0})
    assert capsys.readouterr().out.strip() == \
        "fault report: no link counters recorded (faults were off)"
