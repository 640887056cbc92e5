"""The replica router (``serve/cluster.py``) and its cluster soak
(``serve/soak.py`` ``run_cluster_soak``), the port against the JAX package
on the CPU.

Every case of the reference's ``tests/test_cluster.py`` runs its scenario
through both packages' ``ClusterFront`` over their ``SimReplicaFront`` s on
their ``FakeClock`` s, keeps the reference test's assertions on the port,
and holds the port's outcome to the reference's: every record (ids,
outcomes, reasons, virtual times, plans, recovery) and every token stream,
the router's totals, kills with their respawn times (numpy's seeded jitter
draws), replica states, autoscale events, flight-dump file names, and the
soak's whole artifact byte for byte as ``json.dumps`` writes it (the
artifact's paths relative to each run's directory). Config refusals carry
the reference's messages word for word. Tolerances: exact throughout.
"""
import json
import os
import types

import numpy as np
import pytest

from edgellm_tpu.serve import cluster as jcluster
from edgellm_tpu.serve import frontend as jfront
from edgellm_tpu.serve import soak as jsoak
from edgellm_tpu.utils.clock import FakeClock as JClock
from edgellm_tpu_torch.serve import cluster as tcluster
from edgellm_tpu_torch.serve import frontend as tfront
from edgellm_tpu_torch.serve import soak as tsoak
from edgellm_tpu_torch.utils.clock import FakeClock as TClock

#: each package's router, soak, request type and clock
PKGS = {
    "ref": types.SimpleNamespace(c=jcluster, soak=jsoak, Request=jfront.Request, Clock=JClock),
    "port": types.SimpleNamespace(c=tcluster, soak=tsoak, Request=tfront.Request, Clock=TClock),
}


def _prompt(seed, n=16, vocab=50_000):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=n).astype(np.int32)


def _fleet(m, n=2, clock=None, sim_cfg=None, **cfg_kw):
    clock = clock if clock is not None else m.Clock()
    scfg = sim_cfg if sim_cfg is not None else m.c.SimReplicaConfig()
    fronts = {}

    def factory(rid, gen):
        f = m.c.SimReplicaFront(scfg, clock=clock, replica_id=rid)
        fronts[(rid, gen)] = f
        return f

    cluster = m.c.ClusterFront(factory, m.c.ClusterConfig(num_replicas=n, **cfg_kw),
                               clock=clock)
    return cluster, clock, fronts


def _recs(records) -> list:
    """Records as comparable plain data: every field, the tokens in full."""
    return [(r.as_dict(), None if r.tokens is None else np.asarray(r.tokens).tolist())
            for r in records]


def _fleet_state(cluster) -> dict:
    """Everything the router reports, plus its kill log and totals."""
    return {"report": json.loads(json.dumps(cluster.report(), default=float)),
            "totals": dict(cluster.totals), "kills": list(cluster.kills),
            "autoscale": list(cluster.autoscale_events), "pending": cluster.pending}


def _both(scenario, *args) -> dict:
    """``scenario(pkg, *args)`` on each package; asserts the port's result
    equals the reference's and returns both."""
    got = {name: scenario(m, *args) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]
    return got


def _raised(fn):
    """(exception type name, message) of ``fn()``'s error."""
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------


def test_config_validation_rejects_bad_fields():
    def scenario(m):
        out = []
        for fn in (lambda: m.c.ClusterConfig(num_replicas=0),
                   lambda: m.c.ClusterConfig(max_readmissions=-1),
                   lambda: m.c.ClusterConfig(min_affinity_tokens=0),
                   lambda: m.c.RespawnConfig(backoff_factor=0.5),
                   lambda: m.c.RespawnConfig(backoff_base_s=0.0),
                   lambda: m.c.RespawnConfig(jitter_frac=1.5),
                   lambda: m.c.RespawnConfig(half_open_probes=0),
                   lambda: m.c.AutoscalerConfig(min_replicas=3, max_replicas=2),
                   lambda: m.c.AutoscalerConfig(scale_down_pressure=0.9),
                   lambda: m.c.AutoscalerConfig(min_dwell_s=-1.0),
                   lambda: m.c.ClusterConfig(respawn={"backoff_base_s": 1.0}),
                   lambda: m.c.SimReplicaConfig(chunk_tokens=0)):
            name, msg = _raised(fn)
            assert name == "ClusterConfigError"
            out.append(msg)
        assert issubclass(m.c.ClusterConfigError, ValueError)
        return out

    _both(scenario)


# ---------------------------------------------------------------------------
# placement: affinity, least-loaded fallback, deterministic tiebreak
# ---------------------------------------------------------------------------


def test_affinity_routes_to_the_warm_replica():
    def scenario(m):
        cluster, clock, _ = _fleet(m, 2, min_affinity_tokens=4)
        shared = _prompt(7, n=16)
        first = cluster.submit(m.Request(prompt_ids=shared, max_new_tokens=4))
        recs = m.c.drive_cluster(cluster, clock)
        assert [r.request_id for r in recs] == [first]
        warm_replica = recs[0].plan["replica"]
        follow = np.concatenate([shared, _prompt(8, n=8)]).astype(np.int32)
        cluster.submit(m.Request(prompt_ids=follow, max_new_tokens=4))
        recs2 = m.c.drive_cluster(cluster, clock)
        assert recs2[0].plan["replica"] == warm_replica
        assert cluster.totals["affinity"] == 1
        return _recs(recs + recs2), _fleet_state(cluster)

    _both(scenario)


def test_least_loaded_fallback_with_deterministic_tiebreak():
    def scenario(m):
        cluster, clock, _ = _fleet(m, 3, min_affinity_tokens=4)
        crids = [cluster.submit(m.Request(prompt_ids=_prompt(i), max_new_tokens=4))
                 for i in range(3)]
        placed = [cluster._placements[c].replica_id for c in crids]
        assert placed == [0, 1, 2]
        assert cluster.totals["least_loaded"] == 3
        recs = m.c.drive_cluster(cluster, clock)
        assert len(recs) == 3
        return placed, _recs(recs), _fleet_state(cluster)

    _both(scenario)


def test_short_shared_prefix_does_not_trigger_affinity():
    def scenario(m):
        cluster, clock, _ = _fleet(m, 2, min_affinity_tokens=8,
                                   sim_cfg=m.c.SimReplicaConfig(prefix_block=4))
        p = _prompt(3, n=16)
        cluster.submit(m.Request(prompt_ids=p, max_new_tokens=4))
        recs = m.c.drive_cluster(cluster, clock)
        follow = np.concatenate([p[:4], _prompt(9, n=12)]).astype(np.int32)
        cluster.submit(m.Request(prompt_ids=follow, max_new_tokens=4))
        recs += m.c.drive_cluster(cluster, clock)
        assert cluster.totals["affinity"] == 0
        assert cluster.totals["least_loaded"] == 2
        return _recs(recs), _fleet_state(cluster)

    _both(scenario)


# ---------------------------------------------------------------------------
# fleet capacity scales with N
# ---------------------------------------------------------------------------


def test_two_replicas_finish_in_about_half_the_virtual_time():
    def scenario(m):
        def span(n_replicas):
            cluster, clock, _ = _fleet(m, n_replicas)
            t0 = clock.now
            for i in range(8):
                cluster.submit(m.Request(prompt_ids=_prompt(i), max_new_tokens=16))
            recs = m.c.drive_cluster(cluster, clock)
            assert len(recs) == 8
            return clock.now - t0, _recs(recs)

        one, two = span(1), span(2)
        assert two[0] < 0.75 * one[0]
        return one, two

    _both(scenario)


# ---------------------------------------------------------------------------
# replica kill: zero accepted loss, token identity at greedy AND sampled
# ---------------------------------------------------------------------------


def _kill_workload(m, n=12):
    """Half greedy, half sampled with a recorded per-request seed."""
    return [m.Request(prompt_ids=_prompt(100 + i), max_new_tokens=16,
                      temperature=0.7 if i % 2 else 0.0, rng_seed=1000 + i if i % 2 else 0)
            for i in range(n)]


def _reference_tokens(m, req):
    """The fault-free single-replica reference."""
    cluster, clock, _ = _fleet(m, 1)
    cluster.submit(req)
    recs = m.c.drive_cluster(cluster, clock)
    assert len(recs) == 1 and recs[0].outcome == "completed"
    return np.asarray(recs[0].tokens).reshape(-1)


def test_replica_kill_token_identity_greedy_and_sampled(tmp_path):
    def scenario(m, name):
        reqs = _kill_workload(m, 12)
        cluster, clock, _ = _fleet(m, 2, checkpoint_dir=str(tmp_path / name / "ckpt"),
                                   flight_dir=str(tmp_path / name / "flight"))
        crid_to_req = {cluster.submit(r): r for r in reqs}
        partial = cluster.drain(max_requests=3)
        nxt = cluster.next_event_s()
        while len(partial) < 3:
            if nxt is not None and nxt > clock.now:
                clock.set_time(nxt)
            partial.extend(cluster.drain(max_requests=3 - len(partial)))
            nxt = cluster.next_event_s()
        cluster.kill_replica(0, "chaos")
        records = partial + m.c.drive_cluster(cluster, clock)
        assert sorted(r.request_id for r in records) == sorted(crid_to_req)
        assert all(r.outcome == "completed" for r in records)
        for rec in records:
            assert np.array_equal(np.asarray(rec.tokens).reshape(-1),
                                  _reference_tokens(m, crid_to_req[rec.request_id]))
        assert cluster.totals["readmitted"] > 0
        assert len(cluster.kills) == 1
        dumps = [os.path.relpath(d, tmp_path / name) for d in cluster.flight_dumps()]
        ckpt_dir = tmp_path / name / "ckpt"
        ckpts = sorted(os.listdir(ckpt_dir)) if ckpt_dir.exists() else []
        return _recs(records), _fleet_state(cluster), dumps, ckpts

    got = {name: scenario(m, name) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]
    assert len(got["port"][2]) == 1


def test_mid_flight_checkpoint_resume_has_zero_recompute():
    def scenario(m):
        cluster, clock, fronts = _fleet(m, 2)
        req = m.Request(prompt_ids=_prompt(42), max_new_tokens=16)
        cluster.submit(req)
        for _ in range(8):
            if not cluster.drain():
                nxt = cluster.next_event_s()
                if nxt is None:
                    break
                clock.set_time(nxt)
            if fronts[(0, 0)]._current is not None and fronts[(0, 0)]._current.tokens:
                break
        done_before = len(fronts[(0, 0)]._current.tokens)
        assert 0 < done_before < 16
        cluster.kill_replica(0, "chaos")
        recs = m.c.drive_cluster(cluster, clock)
        assert len(recs) == 1 and recs[0].outcome == "completed"
        assert np.array_equal(np.asarray(recs[0].tokens).reshape(-1),
                              m.c.sim_reference_tokens(np.asarray(req.prompt_ids), 16)[0])
        assert cluster.totals["recompute_tokens"] == 0
        assert recs[0].recovery["readmissions"] == 1
        return done_before, _recs(recs), _fleet_state(cluster)

    _both(scenario)


def test_sim_reference_tokens_chain_resumes_bit_identically():
    """The crc chain itself (greedy, sampled, resumed mid-sequence from its
    chain value) equals the reference's for several prompts."""
    def scenario(m):
        out = []
        for seed in range(4):
            prompt = _prompt(seed, n=5 + seed)
            for temp, rs in ((0.0, 0), (0.7, 11 + seed)):
                full, h = m.c.sim_reference_tokens(prompt, 12, temperature=temp, rng_seed=rs)
                head, h4 = m.c.sim_reference_tokens(prompt, 4, temperature=temp, rng_seed=rs)
                tail, h2 = m.c.sim_reference_tokens(prompt, 12, temperature=temp, rng_seed=rs,
                                                    start=4, chain=h4)
                assert np.array_equal(np.concatenate([head, tail]), full) and h2 == h
                out.append((full.tolist(), h))
        return out

    _both(scenario)


# ---------------------------------------------------------------------------
# respawn: exponential backoff + jitter, half-open probes
# ---------------------------------------------------------------------------


def test_respawn_backoff_grows_and_half_open_probes_gate_rejoin():
    def scenario(m):
        rs = m.c.RespawnConfig(backoff_base_s=1.0, backoff_factor=2.0, backoff_max_s=30.0,
                               jitter_frac=0.25, half_open_probes=2)
        cluster, clock, fronts = _fleet(m, 2, respawn=rs)
        cluster.kill_replica(0, "chaos")
        r0 = cluster.replicas[0]
        first_backoff = r0.respawn_at - clock.now
        assert 1.0 <= first_backoff <= 1.25
        clock.advance(first_backoff / 2)
        cluster.submit(m.Request(prompt_ids=_prompt(1), max_new_tokens=4))
        assert r0.state == "dead"
        clock.advance(first_backoff)
        cluster.submit(m.Request(prompt_ids=_prompt(2), max_new_tokens=4))
        assert r0.state == "probing" and r0.generation == 1 and (0, 1) in fronts
        assert cluster.totals["probe"] >= 1
        cluster.submit(m.Request(prompt_ids=_prompt(3), max_new_tokens=4))
        recs = m.c.drive_cluster(cluster, clock)
        assert all(r.outcome == "completed" for r in recs)
        assert r0.state == "live" and r0.backoff_attempt == 0
        cluster.kill_replica(0, "chaos")
        second_backoff = r0.respawn_at - clock.now
        assert 1.0 <= second_backoff <= 1.25
        return first_backoff, second_backoff, _recs(recs), _fleet_state(cluster)

    _both(scenario)


def test_repeated_kills_back_off_exponentially():
    def scenario(m):
        rs = m.c.RespawnConfig(backoff_base_s=1.0, backoff_factor=2.0, backoff_max_s=30.0,
                               jitter_frac=0.0, half_open_probes=1)
        cluster, clock, _ = _fleet(m, 2, respawn=rs)
        r0 = cluster.replicas[0]
        backoffs = []
        for _ in range(3):
            cluster.kill_replica(0, "chaos")
            backoffs.append(r0.respawn_at - clock.now)
            clock.set_time(r0.respawn_at)
            cluster._tick()
            assert r0.state == "probing"
            r0.state = "live"
        assert backoffs == [1.0, 2.0, 4.0]
        return backoffs, _fleet_state(cluster)

    _both(scenario)


def test_failed_half_open_probe_rekills_the_replica():
    def scenario(m):
        rs = m.c.RespawnConfig(backoff_base_s=1.0, backoff_factor=2.0, jitter_frac=0.0,
                               half_open_probes=1)
        cluster, clock, fronts = _fleet(m, 2, respawn=rs)
        cluster.kill_replica(0, "chaos")
        clock.set_time(cluster.replicas[0].respawn_at)
        cluster._tick()
        assert cluster.replicas[0].state == "probing"
        fronts[(0, 1)].inject_fault("stage_lost:0")
        cluster.submit(m.Request(prompt_ids=_prompt(5), max_new_tokens=4))
        recs = m.c.drive_cluster(cluster, clock)
        assert all(r.outcome == "completed" for r in recs)
        assert cluster.replicas[0].state in ("dead", "probing")
        assert len(cluster.kills) >= 2 and cluster.kills[1]["reason"] == "probe_failed"
        return _recs(recs), _fleet_state(cluster)

    _both(scenario)


# ---------------------------------------------------------------------------
# flight recorder: exactly one post-mortem per induced failure
# ---------------------------------------------------------------------------


def test_exactly_one_flight_dump_per_kill(tmp_path):
    def scenario(m, name):
        cluster, clock, _ = _fleet(m, 3, flight_dir=str(tmp_path / name))
        for i in range(6):
            cluster.submit(m.Request(prompt_ids=_prompt(i), max_new_tokens=8))
        cluster.kill_replica(0, "chaos")
        cluster.kill_replica(1, "chaos")
        recs = m.c.drive_cluster(cluster, clock)
        dumps = cluster.flight_dumps()
        assert len(dumps) == 2 == len(cluster.kills)
        assert all(os.path.exists(d) for d in dumps)
        return ([os.path.relpath(d, tmp_path / name) for d in dumps], _recs(recs),
                _fleet_state(cluster))

    got = {name: scenario(m, name) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# no live replica: typed refusal, accepted work parks instead of dropping
# ---------------------------------------------------------------------------


def test_no_live_replica_refuses_new_and_parks_accepted():
    def scenario(m):
        rs = m.c.RespawnConfig(backoff_base_s=100.0, jitter_frac=0.0)
        cluster, clock, _ = _fleet(m, 2, respawn=rs)
        accepted = cluster.submit(m.Request(prompt_ids=_prompt(1), max_new_tokens=8))
        cluster.kill_replica(0, "chaos")
        cluster.kill_replica(1, "chaos")
        refused = cluster.submit(m.Request(prompt_ids=_prompt(2), max_new_tokens=8))
        recs = cluster.drain()
        assert [r.request_id for r in recs] == [refused]
        assert recs[0].outcome == "rejected" and recs[0].reason == "no_live_replica"
        assert cluster.pending == 1
        health = cluster.health_summary()
        clock.advance(200.0)
        recs2 = m.c.drive_cluster(cluster, clock)
        assert [r.request_id for r in recs2] == [accepted]
        assert recs2[0].outcome == "completed"
        return _recs(recs + recs2), health, cluster.health_summary(), _fleet_state(cluster)

    _both(scenario)


# ---------------------------------------------------------------------------
# autoscaler: pressure-driven with min-dwell hysteresis
# ---------------------------------------------------------------------------


def test_autoscaler_scales_up_and_respects_min_dwell():
    def scenario(m):
        asc = m.c.AutoscalerConfig(enabled=True, min_replicas=2, max_replicas=4,
                                   scale_up_pressure=0.5, scale_down_pressure=0.05,
                                   min_dwell_s=30.0)
        sim = m.c.SimReplicaConfig(max_queue_depth=4)
        cluster, clock, _ = _fleet(m, 2, autoscaler=asc, sim_cfg=sim)
        for i in range(8):
            cluster.submit(m.Request(prompt_ids=_prompt(i), max_new_tokens=4))
        assert not cluster.autoscale_events and len(cluster.replicas) == 2
        clock.advance(asc.min_dwell_s + 1.0)
        cluster.submit(m.Request(prompt_ids=_prompt(99), max_new_tokens=4))
        assert len([e for e in cluster.autoscale_events if e["direction"] == "up"]) == 1
        assert len(cluster.replicas) == 3
        cluster.submit(m.Request(prompt_ids=_prompt(100), max_new_tokens=4))
        assert len(cluster.replicas) == 3
        clock.advance(asc.min_dwell_s + 1.0)
        cluster.submit(m.Request(prompt_ids=_prompt(101), max_new_tokens=4))
        assert len(cluster.replicas) == 4
        recs = m.c.drive_cluster(cluster, clock)
        assert all(r.outcome == "completed" for r in recs)
        clock.advance(asc.min_dwell_s + 1.0)
        cluster._tick()
        assert len([e for e in cluster.autoscale_events if e["direction"] == "down"]) == 1
        assert len(cluster.replicas) == 3
        return _recs(recs), _fleet_state(cluster)

    _both(scenario)


# ---------------------------------------------------------------------------
# cluster chaos soak (small-n shape of the million-request run)
# ---------------------------------------------------------------------------


def _chaos_soak(m, root):
    soak = m.soak.ClusterSoakConfig(
        n_requests=400, arrival_rate=60.0, seed=3, prompt_len=16, shared_prefix_len=8,
        num_prefix_groups=8, max_new_tokens=16, deadline_s=120.0, sampled_frac=0.5,
        sample_temperature=0.7, kills=((0.3, 0), (0.55, 1)), burst_start_frac=0.4,
        burst_end_frac=0.6, burst_corrupt_rate=0.05)
    clock = m.Clock()
    cluster = m.c.ClusterFront(
        lambda rid, gen: m.c.SimReplicaFront(m.c.SimReplicaConfig(), clock=clock,
                                             replica_id=rid),
        m.c.ClusterConfig(num_replicas=3, flight_dir=str(root / "flight"),
                          checkpoint_dir=str(root / "ckpt"),
                          respawn=m.c.RespawnConfig(backoff_base_s=0.2, jitter_seed=1)),
        clock=clock)
    return soak, m.soak.run_cluster_soak(cluster, soak, clock=clock)


def test_cluster_soak_chaos_identity_and_zero_loss(tmp_path):
    texts = {}
    for name, m in PKGS.items():
        soak, art = _chaos_soak(m, tmp_path / name)
        assert sum(art["outcomes"].values()) == soak.n_requests
        ti = art["token_identity"]
        assert ti["ok"] and ti["checked"] == art["outcomes"]["completed"] > 0
        assert art["reasons"].get("substituted_payload", 0) > 0
        assert art["readmitted"] > 0
        assert len(art["kills"]) == 2 and len(art["flight_dumps"]) == 2
        assert all(ev["recovery_s"] is not None for ev in art["kills"])
        assert art["respawns"] == 2
        assert art["goodput_buckets"]["tokens"]
        texts[name] = json.dumps(art, sort_keys=True, default=float).replace(
            str(tmp_path / name), "<run>")
    assert texts["port"] == texts["ref"]


def test_cluster_soak_requires_fake_clock():
    def scenario(m):
        cluster, _, _ = _fleet(m, 2)
        return _raised(lambda: m.soak.run_cluster_soak(
            cluster, m.soak.ClusterSoakConfig(n_requests=1), clock=None))

    assert _both(scenario)["port"][0] == "TypeError"


def test_soak_config_validation():
    def scenario(m):
        return [_raised(lambda kw=kw: m.soak.ClusterSoakConfig(**kw)) for kw in (
            {"shared_prefix_len": 20, "prompt_len": 16}, {"kills": ((1.5, 0),)},
            {"burst_start_frac": 0.6, "burst_end_frac": 0.4}, {"n_requests": 0},
            {"arrival_rate": 0.0}, {"num_prefix_groups": 0}, {"sampled_frac": 1.5},
            {"burst_corrupt_rate": 2.0}, {"goodput_bucket_s": 0.0},
            {"priority_levels": 0})]

    assert all(name == "ValueError" for name, _ in _both(scenario)["port"])
