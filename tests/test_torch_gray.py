"""The gray-failure plane: the ``StragglerDetector`` (``serve/overload.py``),
the router's straggler demotion, hedging and deadline propagation
(``serve/cluster.py``) and the gray soak, the port against the JAX package
on the CPU.

Every unmarked case of the reference's ``tests/test_gray.py`` runs its
scenario through both packages (their ``FakeClock`` s, ``SimReplicaFront`` s
and ``ClusterFront`` s), keeps the reference test's assertions on the port
and holds the port's outcome to the reference's: the detector's quantiles,
sample counts, verdicts and summaries; every record and token stream; the
router's totals and ``gray`` report; the soak artifacts byte for byte as
``json.dumps`` writes them, hedged and unhedged. ``_linear_quantile`` is
one function in the port (``disagg`` imports it from ``overload``) and
equals the reference's bit for bit. Config refusals carry the reference's
messages word for word. Tolerances: exact throughout (the numpy checks the
reference makes keep its ``rel=1e-12``).
"""
import dataclasses
import json
import types

import numpy as np
import pytest

from edgellm_tpu.serve import cluster as jcluster
from edgellm_tpu.serve import disagg as jdisagg
from edgellm_tpu.serve import frontend as jfront
from edgellm_tpu.serve import overload as jov
from edgellm_tpu.serve import soak as jsoak
from edgellm_tpu.utils.clock import FakeClock as JClock
from edgellm_tpu_torch.serve import cluster as tcluster
from edgellm_tpu_torch.serve import disagg as tdisagg
from edgellm_tpu_torch.serve import frontend as tfront
from edgellm_tpu_torch.serve import overload as tov
from edgellm_tpu_torch.serve import soak as tsoak
from edgellm_tpu_torch.utils.clock import FakeClock as TClock

#: each package's router, overload plane, soak, disagg, request type and clock
PKGS = {
    "ref": types.SimpleNamespace(c=jcluster, ov=jov, soak=jsoak, dg=jdisagg,
                                 Request=jfront.Request, Clock=JClock),
    "port": types.SimpleNamespace(c=tcluster, ov=tov, soak=tsoak, dg=tdisagg,
                                  Request=tfront.Request, Clock=TClock),
}


def _prompt(seed, n=16, vocab=50_000):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=n).astype(np.int32)


def _fleet(m, n=2, clock=None, sim_cfg=None, **cfg_kw):
    clock = clock if clock is not None else m.Clock()
    scfg = sim_cfg if sim_cfg is not None else m.c.SimReplicaConfig()
    cluster = m.c.ClusterFront(
        lambda rid, gen: m.c.SimReplicaFront(scfg, clock=clock, replica_id=rid),
        m.c.ClusterConfig(num_replicas=n, **cfg_kw), clock=clock)
    return cluster, clock


def _drive_front(front, clock, max_steps=10_000):
    """Drain one SimReplicaFront to quiescence on the virtual clock."""
    recs = []
    for _ in range(max_steps):
        got = front.drain()
        if got:
            recs.extend(got)
            continue
        ev = front.next_event_s()
        if ev is None:
            return recs
        clock.set_time(max(ev, clock.now))
    raise AssertionError("sim front never drained")


def _recs(records) -> list:
    return [(r.as_dict(), None if r.tokens is None else np.asarray(r.tokens).tolist())
            for r in records]


def _both(scenario) -> dict:
    got = {name: scenario(m) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]
    return got


def _raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------


def test_gray_config_validation():
    def scenario(m):
        m.c.GrayConfig()
        return [_raised(lambda kw=kw: m.c.GrayConfig(**kw)) for kw in (
            {"enabled": 1}, {"p95_multiple": 1.0}, {"hedge_delay_quantile": 1.0},
            {"min_dwell_s": -1.0}, {"max_hedge_fraction": 1.5}, {"min_samples": 0},
            {"min_samples": True}, {"window_s": 0.0})]

    assert {n for n, _ in _both(scenario)["port"]} == {"ClusterConfigError"}


def test_straggler_config_validation():
    def scenario(m):
        return [_raised(fn) for fn in (
            lambda: m.ov.StragglerConfig(p95_multiple=0.5),
            lambda: m.ov.StragglerConfig(quantile=1.0),
            lambda: m.ov.StragglerConfig(window_s=True),
            lambda: m.ov.StragglerConfig(min_samples=9, max_samples=8),
            lambda: m.ov.StragglerConfig(max_samples=0),
            lambda: m.ov.StragglerConfig(min_dwell_s=-0.1),
            lambda: m.c.SimReplicaConfig(deadline_propagation=1))]

    got = _both(scenario)["port"]
    assert [n for n, _ in got] == ["ValueError"] * 6 + ["ClusterConfigError"]


# ---------------------------------------------------------------------------
# detector quantile math vs the numpy reference, with window expiry
# ---------------------------------------------------------------------------


def test_detector_quantiles_match_numpy_under_window_expiry():
    def scenario(m):
        ck = m.Clock()
        det = m.ov.StragglerDetector(m.ov.StragglerConfig(window_s=10.0, min_samples=4),
                                     clock=ck)
        rng = np.random.default_rng(0)
        samples = {"a": [], "b": []}
        for _ in range(25):
            ck.advance(0.7)
            for k, mult in (("a", 1.0), ("b", 3.0)):
                v = float(rng.gamma(2.0, 0.05)) * mult
                det.observe(k, v)
                samples[k].append((ck.now, v))
        horizon = ck.now - 10.0
        pooled, got = [], []
        for k in ("a", "b"):
            vals = [v for t, v in samples[k] if t > horizon]
            assert 0 < len(vals) < len(samples[k])
            assert det.sample_count(k) == len(vals)
            for q in (0.5, 0.9, 0.95, 0.99):
                got.append(det.quantile(k, q))
                assert got[-1] == pytest.approx(float(np.quantile(vals, q)), rel=1e-12)
            pooled.extend(vals)
        got.append(det.fleet_quantile(0.5))
        assert got[-1] == pytest.approx(float(np.quantile(pooled, 0.5)), rel=1e-12)
        only_a = [v for t, v in samples["a"] if t > horizon]
        got.append(det.fleet_quantile(0.95, exclude={"b"}))
        assert got[-1] == pytest.approx(float(np.quantile(only_a, 0.95)), rel=1e-12)
        ck.advance(20.0)
        assert det.quantile("a") is None and det.sample_count("b") == 0
        assert det.fleet_quantile() is None
        return got, det.summary()

    _both(scenario)


def test_linear_quantile_matches_numpy_exactly():
    rng = np.random.default_rng(3)
    for n in (1, 2, 5, 17):
        vals = sorted(rng.standard_exponential(n).tolist())
        for q in (0.0, 0.25, 0.5, 0.95, 1.0):
            got = tov._linear_quantile(vals, q)
            assert got == pytest.approx(float(np.quantile(vals, q)), rel=1e-12, abs=1e-15)
            assert got == jov._linear_quantile(vals, q)
    # one function: the disaggregated server's slow-link detector uses it
    assert tdisagg._linear_quantile is tov._linear_quantile


# ---------------------------------------------------------------------------
# verdicts: flag, dwell hysteresis, re-promotion on re-measure only
# ---------------------------------------------------------------------------


def test_detector_flags_slow_peer_and_repromotes_on_remeasure():
    def scenario(m):
        ck = m.Clock()
        det = m.ov.StragglerDetector(m.ov.StragglerConfig(
            p95_multiple=3.0, min_samples=4, min_dwell_s=0.0, window_s=1000.0), clock=ck)
        trail = []
        for _ in range(4):
            ck.advance(0.1)
            det.observe("a", 0.1)
            det.observe("b", 0.1)
        assert det.stragglers() == ()
        for _ in range(8):
            ck.advance(0.1)
            det.observe("a", 0.1)
            det.observe("b", 1.0)
        assert det.is_straggler("b") and not det.is_straggler("a")
        assert det.summary()["demotions"] == 1
        trail.append(det.summary())
        ck.advance(5000.0)
        assert det.is_straggler("b")
        for _ in range(4):
            ck.advance(0.1)
            det.observe("a", 0.1)
            det.observe("b", 0.1)
        assert not det.is_straggler("b")
        assert det.summary()["promotions"] == 1
        trail.append(det.summary())
        return trail

    _both(scenario)


def test_detector_min_dwell_blocks_flapping():
    def scenario(m):
        ck = m.Clock()
        det = m.ov.StragglerDetector(m.ov.StragglerConfig(
            p95_multiple=3.0, min_samples=4, min_dwell_s=5.0, window_s=2.0), clock=ck)
        for i in range(12):
            ck.advance(0.1)
            det.observe("a", 0.1)
            det.observe("b", 1.0 if i >= 8 else 0.1)
        assert det.is_straggler("b")
        flagged_at = ck.now
        while ck.now - flagged_at < 3.0:
            ck.advance(0.1)
            det.observe("a", 0.1)
            det.observe("b", 0.1)
        assert det.is_straggler("b")
        while ck.now - flagged_at < 6.0:
            ck.advance(0.1)
            det.observe("a", 0.1)
            det.observe("b", 0.1)
        assert not det.is_straggler("b")
        s = det.summary()
        assert s == {"keys": 2, "flagged": [], "observed": s["observed"], "demotions": 1,
                     "promotions": 1}
        return s, ck.now

    _both(scenario)


def test_detector_needs_a_fleet_and_min_samples():
    def scenario(m):
        ck = m.Clock()
        det = m.ov.StragglerDetector(m.ov.StragglerConfig(min_samples=4, min_dwell_s=0.0),
                                     clock=ck)
        for _ in range(8):
            ck.advance(0.1)
            det.observe("b", 5.0)
        assert not det.is_straggler("b")
        det2 = m.ov.StragglerDetector(m.ov.StragglerConfig(min_samples=4, min_dwell_s=0.0),
                                      clock=ck)
        for _ in range(3):
            ck.advance(0.1)
            det2.observe("a", 0.1)
            det2.observe("b", 5.0)
        assert not det2.is_straggler("b")
        return det.summary(), det2.summary(), _raised(lambda: det.observe("a", -1.0))

    assert _both(scenario)["port"][2][0] == "ValueError"


# ---------------------------------------------------------------------------
# deadline propagation inside a replica (typed refusal of expired work)
# ---------------------------------------------------------------------------


def test_sim_replica_refuses_expired_work_with_typed_reason():
    def scenario(m):
        ck = m.Clock()
        front = m.c.SimReplicaFront(m.c.SimReplicaConfig(deadline_propagation=True),
                                    clock=ck, replica_id=0)
        front.submit(m.Request(prompt_ids=_prompt(1), max_new_tokens=64, deadline_s=0.05))
        recs = _drive_front(front, ck)
        assert [r.outcome for r in recs] == ["timed_out"]
        assert recs[0].reason == m.ov.DeadlineExpired.reason == "deadline_expired"
        assert recs[0].deadline_met is not True
        assert 0 < recs[0].recovery["tokens_done"] < 64
        return _recs(recs), front.report()

    _both(scenario)


def test_deadline_propagation_off_by_default_serves_late():
    def scenario(m):
        ck = m.Clock()
        front = m.c.SimReplicaFront(m.c.SimReplicaConfig(), clock=ck, replica_id=0)
        front.submit(m.Request(prompt_ids=_prompt(1), max_new_tokens=64, deadline_s=0.05))
        recs = _drive_front(front, ck)
        assert [r.outcome for r in recs] == ["completed"]
        assert recs[0].deadline_met is False
        return _recs(recs)

    _both(scenario)


def test_sim_replica_cancel_exactly_once():
    def scenario(m):
        ck = m.Clock()
        front = m.c.SimReplicaFront(m.c.SimReplicaConfig(), clock=ck, replica_id=0)
        keep = front.submit(m.Request(prompt_ids=_prompt(1), max_new_tokens=4))
        drop = front.submit(m.Request(prompt_ids=_prompt(2), max_new_tokens=4))
        assert front.cancel(drop) is True
        assert front.cancel(drop) is False
        assert front.cancel(999_999) is False
        recs = _drive_front(front, ck)
        assert [r.request_id for r in recs] == [keep]
        running = front.submit(m.Request(prompt_ids=_prompt(3), max_new_tokens=8))
        front.drain()
        assert front.cancel(running) is True
        assert _drive_front(front, ck) == []
        return _recs(recs), front.report()

    _both(scenario)


# ---------------------------------------------------------------------------
# deadline re-check at (re-)placement; parked re-placement in arrival order
# ---------------------------------------------------------------------------


def test_parked_request_expires_at_replacement_not_served_late():
    def scenario(m):
        rs = m.c.RespawnConfig(backoff_base_s=100.0, jitter_frac=0.0)
        cluster, clock = _fleet(m, 2, respawn=rs)
        crid = cluster.submit(m.Request(prompt_ids=_prompt(1), max_new_tokens=8,
                                        deadline_s=5.0))
        cluster.kill_replica(0, "chaos")
        cluster.kill_replica(1, "chaos")
        assert cluster.pending == 1
        clock.advance(200.0)
        recs = m.c.drive_cluster(cluster, clock)
        assert [r.request_id for r in recs] == [crid]
        assert recs[0].outcome == "timed_out" and recs[0].reason == "deadline_expired"
        assert recs[0].deadline_met is False
        assert cluster.totals["deadline_expired"] == 1 and cluster.pending == 0
        return _recs(recs), dict(cluster.totals)

    _both(scenario)


def test_parked_requests_replace_in_arrival_order():
    def scenario(m):
        rs = m.c.RespawnConfig(backoff_base_s=100.0, jitter_frac=0.0)
        cluster, clock = _fleet(m, 2, respawn=rs)
        first = cluster.submit(m.Request(prompt_ids=_prompt(1), max_new_tokens=4))
        second = cluster.submit(m.Request(prompt_ids=_prompt(2), max_new_tokens=4))
        cluster.kill_replica(0, "chaos")
        cluster.kill_replica(1, "chaos")
        assert cluster.pending == 2
        clock.advance(200.0)
        recs = m.c.drive_cluster(cluster, clock)
        assert [r.request_id for r in recs] == [first, second]
        assert all(r.outcome == "completed" for r in recs)
        return _recs(recs), dict(cluster.totals), list(cluster.kills)

    _both(scenario)


# ---------------------------------------------------------------------------
# hedging: exactly-once settlement, token identity, bounded overhead
# ---------------------------------------------------------------------------

SLOWDOWNS = ((0.3, 0, 20.0),)
SOAK_KW = dict(n_requests=300, arrival_rate=30.0, deadline_s=0.5, seed=7)


def _gray(m):
    return m.c.GrayConfig(enabled=True, min_dwell_s=0.5, min_samples=8, window_s=30.0,
                          max_hedge_fraction=0.4)


def _gray_soak(m, gray, slowdowns, **kw):
    clock = m.Clock()
    scfg = m.c.SimReplicaConfig(deadline_propagation=gray.enabled)
    cluster = m.c.ClusterFront(
        lambda rid, gen: m.c.SimReplicaFront(scfg, clock=clock, replica_id=rid),
        m.c.ClusterConfig(num_replicas=3, gray=gray), clock=clock)
    art = m.soak.run_cluster_soak(cluster, m.soak.ClusterSoakConfig(slowdowns=slowdowns, **kw),
                                  clock=clock)
    return art, cluster


def _text(art) -> str:
    return json.dumps(art, sort_keys=True, default=float)


#: the hedged and unhedged gray soaks of each package, run once per module
_SOAKS: dict = {}


def _soaks(name):
    if name not in _SOAKS:
        m = PKGS[name]
        _SOAKS[name] = {"hedged": _gray_soak(m, _gray(m), SLOWDOWNS, **SOAK_KW),
                        "unhedged": _gray_soak(m, m.c.GrayConfig(), SLOWDOWNS, **SOAK_KW)}
    return _SOAKS[name]


def test_hedged_soak_exactly_once_and_token_identity():
    art, cluster = _soaks("port")["hedged"]
    n = SOAK_KW["n_requests"]
    assert sum(art["outcomes"].values()) == n
    assert art["outcomes"].get("failed", 0) == 0 and cluster.pending == 0
    assert art["hedges"] > 0
    t = cluster.totals
    assert t["hedge_wins_primary"] + t["hedge_wins_hedge"] == t["hedges"]
    assert t["hedge_cancelled"] + t["hedge_discarded"] == t["hedges"]
    assert art["hedge_fraction"] <= 0.4 + 1e-9
    ident = art["token_identity"]
    assert ident["ok"] and ident["checked"] > 0 and ident["mismatched_ids"] == []
    base, _ = _soaks("port")["unhedged"]
    assert base["hedges"] == 0
    assert base["slo_goodput"] < 0.9 < art["slo_goodput"]
    assert art["slo_goodput"] > base["slo_goodput"]
    # both artifacts equal the reference's byte for byte
    for leg in ("hedged", "unhedged"):
        assert _text(_soaks("port")[leg][0]) == _text(_soaks("ref")[leg][0])
    assert dict(cluster.totals) == dict(_soaks("ref")["hedged"][1].totals)


def test_hedge_disabled_fleet_runs_no_gray_machinery():
    def scenario(m):
        art, cluster = _gray_soak(m, m.c.GrayConfig(), (), **SOAK_KW)
        assert art["gray"] is None
        assert art["hedges"] == 0 and art["deadline_expired"] == 0
        assert cluster.report()["gray"] is None
        assert sum(art["outcomes"].values()) == SOAK_KW["n_requests"]
        return _text(art)

    _both(scenario)


def test_gray_soak_is_byte_deterministic():
    a1 = _soaks("port")["hedged"][0]
    a2, _ = _gray_soak(PKGS["port"], _gray(PKGS["port"]), SLOWDOWNS, **SOAK_KW)
    assert _text(a1) == _text(a2) == _text(_soaks("ref")["hedged"][0])


def test_soak_slowdown_schedule_validation():
    def scenario(m):
        return [_raised(fn) for fn in (
            lambda: m.soak.ClusterSoakConfig(slowdowns=((1.5, 0, 2.0),)),
            lambda: m.soak.ClusterSoakConfig(slowdowns=((0.5, 0, 0.5),)),
            lambda: m.c.SimReplicaFront(m.c.SimReplicaConfig(),
                                        clock=m.Clock()).set_service_multiplier(0.0))]

    assert {n for n, _ in _both(scenario)["port"]} == {"ValueError"}


def test_disagg_slow_link_config_validation():
    def scenario(m):
        out = [_raised(lambda kw=kw: m.dg.DisaggConfig(**kw)) for kw in (
            {"slow_link_p95_multiple": 0.5}, {"slow_link_min_samples": 1},
            {"slow_link_window_s": 0.0}, {"transfer_s_per_page": -0.1})]
        m.dg.DisaggConfig(slow_link_p95_multiple=0.0)   # 0 disables the detector
        return out

    assert {n for n, _ in _both(scenario)["port"]} == {"ValueError"}


# ---------------------------------------------------------------------------
# cluster report/artifact surface
# ---------------------------------------------------------------------------


def test_gray_report_surface():
    art, cluster = _soaks("port")["hedged"]
    rep = cluster.report()
    assert sorted(rep["gray"]) == ["detector", "flagged", "hedge_delay_s"]
    assert rep["gray"]["detector"]["observed"] > 0
    assert art["gray"] == rep["gray"]
    for key in ("hedges", "hedge_wins", "hedge_discarded", "hedge_fraction",
                "deadline_expired", "slo_goodput"):
        assert key in art
    met = round(art["slo_goodput"] * SOAK_KW["n_requests"])
    assert met <= art["outcomes"].get("completed", 0)
    assert _text(rep) == _text(_soaks("ref")["hedged"][1].report())


def test_gray_config_threads_through_cluster_config():
    def scenario(m):
        cc = m.c.ClusterConfig(num_replicas=2, gray=_gray(m))
        assert cc.gray.enabled
        err = _raised(lambda: m.c.ClusterConfig(num_replicas=2, gray={"enabled": True}))
        assert dataclasses.asdict(m.c.ClusterConfig(num_replicas=2))["gray"]["enabled"] is False
        return dataclasses.asdict(cc), err

    _both(scenario)
