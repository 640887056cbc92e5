"""The disaggregated server's chaos soak (``serve/soak.py``
``run_disagg_soak``), the port against the JAX package on the CPU.

The same seeded workload (requests regenerated from their index) runs
through both packages' ``DisaggServer`` while the scheduled chaos fires: a
prefill worker killed mid-migration (through ``page_hook``), a worker
killed by index, the decode worker killed, the link failed, and a seeded
bit-flip window on the migration link healed by FEC. The artifacts agree:
the kill events, completed and lost counts, the burst window, the identity
audit against a fault-free colocated batcher (all checked requests
matching), and the server's whole ``disagg`` report (link counters, wire
bytes, migrations, re-driven pages, recompute, re-admissions, degrade
reason). ``DisaggSoakConfig``'s refusals carry the reference's messages.
Tolerances: exact.
"""
import dataclasses

import numpy as np
import pytest

import jax

from edgellm_tpu.codecs.fec import FECConfig as JFECConfig
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as j_tiny
from edgellm_tpu.serve import batching as jb
from edgellm_tpu.serve import disagg as jd
from edgellm_tpu.serve import soak as jsoak
from edgellm_tpu_torch.codecs.fec import FECConfig
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.serve import batching as tb
from edgellm_tpu_torch.serve import disagg as td
from edgellm_tpu_torch.serve import soak as tsoak

JCFG = j_tiny("qwen2", num_layers=2, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=2, hidden_size=32, num_heads=4, vocab_size=128)
GEOM = dict(page_size=8, num_pages=17, max_slots=4, pages_per_slot=4)

#: leg -> (DisaggSoakConfig fields, DisaggConfig fields, kv tier)
LEGS = {
    "all_legs": (dict(n_requests=12, seed=7, min_prompt_len=3, max_prompt_len=14,
                      max_new_tokens=5,
                      kills=((0.2, "prefill"), (0.5, "decode"), (0.85, "link")),
                      burst_start_frac=0.3, burst_end_frac=0.5, burst_bitflip_rate=0.01),
                 dict(num_prefill_workers=3, queue_bound=4, degrade_after=50, fec=True),
                 "fp"),
    "worker_by_index_int8": (dict(n_requests=8, seed=3, min_prompt_len=9, max_prompt_len=12,
                                  max_new_tokens=5,
                                  kills=((0.25, "prefill:1"), (0.5, "prefill"),
                                         (0.75, "decode"))),
                             dict(num_prefill_workers=3, fec=True), "int8_per_channel"),
}


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.key(1))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return {"ref": jp, "port": tp}


def _soak(pkg, weights, leg):
    skw, dkw, kv_codec = LEGS[leg]
    dkw = dict(dkw)
    mods = (jd, jb, jsoak, JFECConfig, JCFG) if pkg == "ref" else (td, tb, tsoak, FECConfig,
                                                                    TCFG)
    dmod, bmod, smod, fec_cls, cfg = mods
    if dkw.pop("fec", False):
        dkw["fec"] = fec_cls(enabled=True)
    bcfg = bmod.BatchingConfig(**GEOM, kv_codec=kv_codec)
    srv = dmod.DisaggServer(cfg, weights[pkg], bcfg, dmod.DisaggConfig(**dkw))
    soak = smod.DisaggSoakConfig(vocab_size=cfg.vocab_size, **skw)
    return smod.run_disagg_soak(
        srv, soak, reference_factory=lambda: bmod.ContinuousBatcher(cfg, weights[pkg], bcfg))


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_disagg_soak_matches_reference(weights, leg):
    """Every chaos leg on both servers: nothing accepted lost, every
    completed request identical to its colocated replay, and the artifacts'
    counters equal."""
    want = _soak("ref", weights, leg)
    got = _soak("port", weights, leg)
    for key in ("soak", "requests", "completed", "accepted_lost", "kills", "burst",
                "token_identity", "disagg"):
        assert got[key] == want[key], key
    assert got["accepted_lost"] == 0 and got["token_identity"]["ok"]
    assert got["token_identity"]["checked"] == got["requests"]
    kills = got["kills"]
    assert any(k["target"].startswith("prefill") and k["mid_migration"] for k in kills)
    assert any(k["target"] == "decode" for k in kills)
    rep = got["disagg"]
    assert rep["readmitted"] >= 1
    if leg == "all_legs":
        assert rep["degrade_reason"] == "migration_link_dead"
        assert rep["link"]["detected"] > 0
        assert got["burst"] == {"start_index": 3, "end_index": 6, "bitflip_rate": 0.01}
    else:
        assert {"target": "prefill:1", "mid_migration": False, "at_index": 2} in kills
        assert rep["live_prefill_workers"] == 1


@pytest.mark.parametrize("kw", [
    {"kills": ((0.5, "gpu"),)}, {"burst_start_frac": 0.8, "burst_end_frac": 0.2},
    {"min_prompt_len": 9, "max_prompt_len": 3}, {"n_requests": 0}, {"max_new_tokens": 0},
    {"sampled_frac": 1.5}, {"burst_end_frac": 1.5}, {"burst_bitflip_rate": -0.1},
    {"kills": ((1.5, "decode"),)}, {"steps_per_arrival": -1},
    {"kills": ((0.5, "prefill:0"), (0.9, "link"))}])
def test_disagg_soak_config_matches_reference(kw):
    try:
        want = jsoak.DisaggSoakConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsoak.DisaggSoakConfig(**kw)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(tsoak.DisaggSoakConfig(**kw)) == dataclasses.asdict(want)


def test_disagg_requests_regenerate_as_reference():
    """Request i is the reference's from its index alone: prompt, tokens
    budget, temperature and seed."""
    soak = dict(n_requests=16, seed=11, min_prompt_len=2, max_prompt_len=30, sampled_frac=0.5)
    ts, js = tsoak.DisaggSoakConfig(**soak), jsoak.DisaggSoakConfig(**soak)
    for i in range(16):
        (tp, tn, tt, tr), (jp, jn, jt, jr) = tsoak._disagg_request(ts, i), \
            jsoak._disagg_request(js, i)
        np.testing.assert_array_equal(tp, jp)
        assert (tn, tt, tr) == (jn, jt, jr)
