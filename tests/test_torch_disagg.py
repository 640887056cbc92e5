"""Disaggregated prefill / decode (``serve/disagg.py``) and its pieces in the
pool and the batcher, the port against the JAX package on the CPU.

Every scenario of the reference's ``tests/test_disagg.py`` runs the same
workload through both ``DisaggServer``s (one set of weights, the
reference's ``init_params``, crossed with ``params_from_jax_numpy``): the
tokens of every request equal the reference server's and the port's
colocated batcher's, and the whole ``report()["disagg"]`` (wire bytes, the
link's detected / repaired / retried / hedge-win / failed counts, the
migration scoreboard, the degrade reason) equals the reference's. The
chaos covers FEC with and without hedging, a healed chunk, a link hot
enough that nothing verifies (nothing corrupt adopted), a faulty link with
FEC and hedges, each kill leg and each degrade reason (the slow link's on
a fake clock). Then the link alone,
the migration holds, the row gathers, the typed refusals, the config and
submission checks (messages equal), the bounded queue, the flight
recorder's one dump per migration-fatal failure and the serve front
draining a disaggregated server. Tolerances: exact throughout.
"""
import dataclasses

import numpy as np
import pytest

import jax

from edgellm_tpu.codecs.faults import FaultConfig as JFaultConfig
from edgellm_tpu.codecs.fec import FECConfig as JFECConfig
from edgellm_tpu.codecs.fec import HedgeConfig as JHedgeConfig
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as j_tiny
from edgellm_tpu.models.paged_kv import PagedKVCache as JPagedKVCache
from edgellm_tpu.obs import flight as jflight
from edgellm_tpu.serve import batching as jb
from edgellm_tpu.serve import disagg as jd
from edgellm_tpu.utils.clock import FakeClock as JClock
from edgellm_tpu_torch.codecs.faults import FaultConfig
from edgellm_tpu_torch.codecs.fec import FECConfig, HedgeConfig
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.models.paged_kv import KVTierMismatchError, PagedKVCache
from edgellm_tpu_torch.obs import flight as tflight
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve import batching as tb
from edgellm_tpu_torch.serve import disagg as td
from edgellm_tpu_torch.serve.recovery import CheckpointError, CheckpointTierMismatchError
from edgellm_tpu_torch.utils.clock import FakeClock

JCFG = j_tiny("qwen2", num_layers=2, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=2, hidden_size=32, num_heads=4, vocab_size=128)
GEOM = dict(page_size=8, num_pages=17, max_slots=4, pages_per_slot=4)

#: each package's link configs by name
LINK = {"ref": (JFaultConfig, JFECConfig, JHedgeConfig), "port": (FaultConfig, FECConfig,
                                                                  HedgeConfig)}


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 128, size=n).astype(np.int32)


#: the reference's workload: multi-page prompts, greedy and sampled, a
#: one-token request, different seeds
REQS = [(_prompt(5, 1), 6, 0.0, 0), (_prompt(11, 2), 8, 0.7, 3),
        (_prompt(9, 4), 5, 1.1, 9), (_prompt(3, 3), 1, 0.0, 7)]


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.key(1))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return {"ref": jp, "port": tp}


def _bcfg(pkg, kv_codec="fp", **kw):
    mod = jb if pkg == "ref" else tb
    return mod.BatchingConfig(**GEOM, kv_codec=kv_codec, **kw)


def _dcfg(pkg, fec=None, hedge=None, faults=None, **kw):
    faults_cls, fec_cls, hedge_cls = LINK[pkg]
    mod = jd if pkg == "ref" else td
    return mod.DisaggConfig(fec=None if fec is None else fec_cls(**fec),
                            hedge=None if hedge is None else hedge_cls(**hedge),
                            faults=None if faults is None else faults_cls(**faults), **kw)


def _server(pkg, weights, kv_codec="fp", bkw=None, **dkw):
    """A DisaggServer of ``pkg``; a modeled transfer time runs on the
    package's FakeClock."""
    mod, cfg = (jd, JCFG) if pkg == "ref" else (td, TCFG)
    clock = {} if "transfer_s_per_page" not in dkw else {
        "clock": (JClock if pkg == "ref" else FakeClock)()}
    return mod.DisaggServer(cfg, weights[pkg], _bcfg(pkg, kv_codec, **(bkw or {})),
                            _dcfg(pkg, **dkw), **clock)


def _submit(srv, reqs):
    return [srv.submit(p, m, temperature=t, rng_seed=s) for p, m, t, s in reqs]


def _colocated(weights, kv_codec, reqs=REQS):
    bat = tb.ContinuousBatcher(TCFG, weights["port"], _bcfg("port", kv_codec))
    sids = _submit(bat, reqs)
    res = bat.run()
    return [res[s] for s in sids]


def _kill_mid_migration(srv):
    """Arm the reference test's hook: the worker that moved page 0 of a
    multi-page prompt dies before its page 1."""
    armed = {"done": False}

    def hook(wid, sid, page):
        if not armed["done"] and page == 0 and REQS[sid][0].size > 8:
            armed["done"] = True
            srv.kill_prefill_worker(wid)

    srv.page_hook = hook
    return armed


def _run_scenario(srv, name):
    """The reference test's drive of scenario ``name`` -> (tokens, extra)."""
    extra = {}
    if name.startswith("prefill_kill"):
        armed = _kill_mid_migration(srv)
    if name == "fec_heals_chunk":
        srv.link.corrupt_chunk_once = 0
    if name == "all_workers_dead":
        srv.kill_prefill_worker(0)
        srv.kill_prefill_worker(1)
    if name == "link_dead":
        srv.fail_link()
    if name == "link_dead_mid":
        sids = _submit(srv, REQS[:2])
        srv.step()
        srv.fail_link()
        sids += _submit(srv, REQS[2:])
    elif name == "slow_link":
        # healthy transfers freeze the baseline, then the link goes gray
        sids = _submit(srv, REQS)
        srv.run()
        srv.slow_link(10.0)
        sids += _submit(srv, REQS)
    elif name == "queue_bound":
        reqs = [(_prompt(5, i), 3, 0.0, i) for i in range(6)]
        sids = _submit(srv, reqs)
        depth = 0
        for _ in range(200):
            srv.step()
            depth = max(depth, len(srv.queue))
            if not srv._unfinished():
                break
        extra["max_depth"] = depth
    else:
        sids = _submit(srv, REQS)
    if name.startswith("decode_kill"):
        for _ in range(3):
            srv.step()
        srv.kill_decode_worker()
    res = srv.run()
    if name.startswith("prefill_kill"):
        extra["armed"] = armed["done"]
    return [res[s] for s in sids], extra


#: name -> (kv tier, DisaggConfig fields, BatchingConfig fields)
SCENARIOS = {
    "identity_fp": ("fp", {}, {}),
    "identity_int8": ("int8_per_channel", {}, {}),
    "fec_hedge": ("int8_per_channel", dict(fec={"enabled": True}, hedge={"enabled": True}), {}),
    "fec_heals_chunk": ("int8_per_channel", dict(fec={"enabled": True}), {}),
    "beyond_repair": ("int8_per_channel", dict(max_retries=1, degrade_after=2,
                                               faults={"bitflip_rate": 0.5, "seed": 9}), {}),
    "faulty_fec_hedge": ("int8_per_channel", dict(fec={"enabled": True},
                                                  hedge={"enabled": True},
                                                  faults={"bitflip_rate": 4e-4, "seed": 4}), {}),
    "faulty_sealed": ("fp", dict(max_retries=3, degrade_after=10,
                                 faults={"drop_rate": 0.3, "seed": 2}), {}),
    "prefill_kill_ckpt": ("fp", {}, {}),
    "prefill_kill_no_ckpt": ("fp", dict(prefill_checkpoint=False), {}),
    "all_workers_dead": ("fp", {}, {}),
    "decode_kill_ckpt": ("fp", {}, {"checkpoint_dir": "ckpt"}),
    "decode_kill_replay": ("int8_per_channel", {}, {}),
    "link_dead": ("fp", {}, {}),
    "link_dead_mid": ("fp", {}, {}),
    "disabled": ("fp", dict(enabled=False), {}),
    "slow_link": ("fp", dict(num_prefill_workers=1, transfer_s_per_page=0.01,
                             slow_link_p95_multiple=3.0, slow_link_min_samples=4,
                             slow_link_window_s=1e9), {}),
    "queue_bound": ("fp", dict(queue_bound=1), {}),
}


def _expect(name, rep, extra):
    """The reference test's own claims about scenario ``name``."""
    link = rep["link"]
    if name.startswith("identity"):
        assert rep["migrations"] == 3 and rep["migrated_pages"] >= 4
        assert not rep["degraded"] and link["failed"] == 0 and rep["recompute_tokens"] == 0
    elif name == "fec_heals_chunk":
        assert (link["detected"], link["repaired"], link["retried"], link["failed"]) == \
            (1, 1, 0, 0)
    elif name == "beyond_repair":
        assert link["failed"] >= 1 and link["detected"] >= 2 and rep["migrations"] == 0
        assert rep["degrade_reason"] == "migration_failures"
    elif name == "faulty_fec_hedge":
        assert link["detected"] > 0 and link["repaired"] > 0 and not rep["degraded"]
    elif name == "faulty_sealed":
        assert link["retried"] > 0 and link["detected"] > 0
    elif name == "prefill_kill_ckpt":
        assert extra["armed"] and rep["live_prefill_workers"] == 1
        assert rep["redriven_pages"] > 0 and rep["recompute_tokens"] == 0
    elif name == "prefill_kill_no_ckpt":
        assert rep["recompute_tokens"] > 0 and rep["redriven_pages"] == 0
    elif name == "all_workers_dead":
        assert rep["degrade_reason"] == "prefill_workers_lost"
    elif name.startswith("decode_kill"):
        assert rep["readmitted"] >= 1
    elif name in ("link_dead", "link_dead_mid"):
        assert rep["degrade_reason"] == "migration_link_dead"
    elif name == "disabled":
        assert rep["migrations"] == 0
    elif name == "slow_link":
        assert rep["degrade_reason"] == "migration_link_slow"
        assert rep["transfer_baseline_s"] is not None
    elif name == "slow_link":
        # healthy transfers freeze the baseline, then the link goes gray
        sids = _submit(srv, REQS)
        srv.run()
        srv.slow_link(10.0)
        sids += _submit(srv, REQS)
    elif name == "queue_bound":
        assert extra["max_depth"] <= 1


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_disagg_scenario_matches_reference(weights, tmp_path, name):
    """One scenario through both servers: the port's tokens equal the
    reference's and (every request but the queue case's own workload) the
    port's colocated batcher's; ``report()["disagg"]`` equal."""
    kv_codec, dkw, bkw = SCENARIOS[name]
    got = {}
    for pkg in ("ref", "port"):
        bk = dict(bkw)
        if "checkpoint_dir" in bk:
            bk["checkpoint_dir"] = str(tmp_path / pkg)
        srv = _server(pkg, weights, kv_codec, bk, **dkw)
        toks, extra = _run_scenario(srv, name)
        got[pkg] = (toks, srv.report()["disagg"], extra)
    (jt, jrep, jextra), (tt, trep, textra) = got["ref"], got["port"]
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)
    if name != "queue_bound":
        want = _colocated(weights, kv_codec)
        for a, b in zip(tt, want * (len(tt) // len(want))):
            np.testing.assert_array_equal(a, b)
    assert trep == jrep
    assert textra == jextra
    _expect(name, trep, textra)


# ---------- the link alone ----------

@pytest.mark.parametrize("case", ["sealed", "fec", "fec_hedged", "exhausted", "dead"])
def test_link_send_matches_reference(case):
    """A page payload through each package's ``MigrationLink``: the arrived
    bytes, the counters and the wire bytes (``migration_wire_nbytes`` of
    the payload) equal, and an exhausted or dead link raises the
    reference's message."""
    payload = {"k_codes": np.arange(2 * 8 * 2 * 4, dtype=np.int8).reshape(2, 8, 2, 4),
               "k_scale": np.linspace(0.5, 2.0, 32, dtype=np.float32).reshape(2, 8, 2)}
    kw = {"sealed": {}, "fec": dict(fec={"enabled": True}),
          "fec_hedged": dict(fec={"enabled": True}, hedge={"enabled": True},
                             faults={"bitflip_rate": 4e-3, "seed": 3}),
          "exhausted": dict(faults={"bitflip_rate": 0.5, "seed": 3}, max_retries=1),
          "dead": {}}[case]
    out = {}
    for pkg, mod in (("ref", jd), ("port", td)):
        faults_cls, fec_cls, hedge_cls = LINK[pkg]
        link = mod.MigrationLink(
            fec=fec_cls(**kw["fec"]) if "fec" in kw else None,
            hedge=hedge_cls(**kw["hedge"]) if "hedge" in kw else None,
            faults=faults_cls(**kw["faults"]) if "faults" in kw else None,
            max_retries=kw.get("max_retries", 2), seed=5)
        if case == "dead":
            link.fail()
        try:
            arrived = [link.send(payload, sid=0, page=p) for p in range(3)]
            err = None
        except mod.MigrationError as e:
            arrived, err = None, str(e)
        out[pkg] = (arrived, err, dict(link.counters))
    (ja, je, jc), (ta, te, tc) = out["ref"], out["port"]
    assert te == je and tc == jc
    if case in ("exhausted", "dead"):
        assert te is not None and ("never adopted" in te or "link is down" in te)
        return
    assert te is None
    if case == "fec_hedged":  # every rung of the ladder ran
        assert tc["repaired"] > 0 and tc["hedge_wins"] > 0
    for jpage, tpage in zip(ja, ta):
        assert sorted(tpage) == sorted(jpage)
        for k in jpage:
            np.testing.assert_array_equal(tpage[k], payload[k])
            np.testing.assert_array_equal(tpage[k], np.asarray(jpage[k]))
    fec = FECConfig(enabled=True) if "fec" in kw else None
    one = sum(v.nbytes for v in payload.values())
    assert tc["wire_bytes"] == tc["transmissions"] * td.migration_wire_nbytes(one, fec)
    assert td.migration_wire_nbytes(one, fec) == jd.migration_wire_nbytes(
        one, JFECConfig(enabled=True) if fec else None)


# ---------- the pool's migration holds and row gathers ----------

def _pools(kv_codec):
    geom = dict(num_pages=9, page_size=4, max_slots=2, pages_per_slot=2, kv_codec=kv_codec)
    return JPagedKVCache(JCFG, **geom), PagedKVCache(TCFG, device="cpu", **geom)


def test_held_slot_refuses_free_and_defers_defrag():
    """The reference's hold semantics and messages, both packages in step."""
    msgs = []
    for pool in _pools("fp"):
        slot = pool.alloc_slot()
        pool.ensure(slot, 4)
        pool.hold_slot(slot)
        assert pool.held_slots == [slot]
        with pytest.raises(ValueError, match="held for an in-flight migration") as e1:
            pool.free_slot(slot)
        assert pool.defrag() == 0 and pool.deferred_defrags == 1
        pool.release_slot_hold(slot)
        pool.free_slot(slot)
        with pytest.raises(ValueError, match="hold") as e2:
            pool.release_slot_hold(slot)
        pool.check_invariants()
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kv_codec", ["fp", "int8_per_channel"])
def test_row_gathers_concatenate_to_the_slot_gather(weights, kv_codec):
    """A prefilled slot's page chunks (``gather_rows``) concatenated along
    the row axis are ``_gather_state``'s arrays exactly, locally and over a
    split runtime (the per-stage layout); the local chunks have the
    reference's keys, shapes and dtypes."""
    prompt = _prompt(11, 2)
    got = {}
    for pkg, mod, cfg in (("ref", jb, JCFG), ("port", tb, TCFG)):
        bat = mod.ContinuousBatcher(cfg, weights[pkg], _bcfg(pkg, kv_codec))
        st = bat.prefill_hold(bat.submit(prompt, 4))
        got[pkg] = [bat.gather_rows(st.slot, a, min(a + 8, 11)) for a in (0, 8)]
        state = bat._gather_state(st.slot)
        for k in got[pkg][0]:
            np.testing.assert_array_equal(
                np.concatenate([np.asarray(c[k]) for c in got[pkg]], axis=1),
                np.asarray(state[k]))
    for jc, tc in zip(got["ref"], got["port"]):
        assert {k: (v.shape, v.dtype) for k, v in tc.items()} == \
            {k: (np.asarray(v).shape, np.asarray(v).dtype) for k, v in jc.items()}
    rt = SplitRuntime(TCFG, SplitConfig(cuts=(0,), hop_codecs=("int8_per_token",)),
                      ["cpu"] * 2)
    bat = tb.ContinuousBatcher(TCFG, weights["port"], _bcfg("port", kv_codec),
                               split_runtime=rt, placed_params=rt.place_params(weights["port"]))
    st = bat.prefill_hold(bat.submit(prompt, 4))
    chunks = [bat.gather_rows(st.slot, a, min(a + 8, 11)) for a in (0, 8)]
    state = bat._gather_state(st.slot)
    for k in chunks[0]:
        np.testing.assert_array_equal(np.concatenate([c[k] for c in chunks], axis=2), state[k])


def test_release_handoff_frees_staging_state(weights):
    bat = tb.ContinuousBatcher(TCFG, weights["port"], _bcfg("port"))
    sid = bat.submit(_prompt(5, 1), 4, temperature=0.0, rng_seed=0)
    st = bat.prefill_hold(sid)
    assert st is not None and st.status == "running"
    assert bat.pool.held_slots == [st.slot]
    with pytest.raises(ValueError, match="is not waiting"):
        bat.prefill_hold(sid)
    bat.release_handoff(sid)
    assert bat.pool.held_slots == [] and sid not in bat._streams
    bat.pool.check_invariants()


@pytest.mark.parametrize("cuts", [(), (0,)], ids=["local", "split"])
def test_split_disagg_adopts_bytes_and_keeps_tokens(weights, cuts):
    """Over a split runtime (int8 pages, the per-stage packed adopt) and
    locally with prefix sharing on: disagg tokens equal the colocated
    batcher's, and an adopted prompt re-publishes its pages, so the decode
    pool's index answers a probe of it afterwards."""
    from edgellm_tpu_torch.models.paged_kv import PrefixCacheConfig

    tp = weights["port"]
    bkw = {} if cuts else {"prefix_cache": PrefixCacheConfig()}

    def split_kw():
        if not cuts:
            return {}
        rt = SplitRuntime(TCFG, SplitConfig(cuts=cuts, hop_codecs=("int8_per_token",)),
                          ["cpu"] * 2)
        return dict(split_runtime=rt, placed_params=rt.place_params(tp))

    bcfg = _bcfg("port", "int8_per_channel", **bkw)
    ref = tb.ContinuousBatcher(TCFG, tp, bcfg, **split_kw())
    ref_sids = _submit(ref, REQS)
    want = ref.run()
    srv = td.DisaggServer(TCFG, tp, bcfg, td.DisaggConfig(fec=FECConfig(enabled=True)),
                          **split_kw())
    sids = _submit(srv, REQS)
    res = srv.run()
    for s, r in zip(sids, ref_sids):
        np.testing.assert_array_equal(res[s], want[r])
    rep = srv.report()
    assert rep["disagg"]["migrations"] == 3 and rep["mode"] == ("paged_split" if cuts
                                                                 else "paged")
    if not cuts:
        assert srv.probe_prefix(REQS[1][0]) >= 8


# ---------- typed refusals ----------

def test_typed_refusals_match_reference():
    """A packed payload into an fp pool, a packed row gather of an fp pool,
    a cross-tier state dict, and the split runtime's packed gather and
    adopt on an fp pool: each typed, the reference's fields and words."""
    _, fp = _pools("fp")
    jfp, _ = _pools("fp")
    z, s = np.zeros((2, 4, 2, 2), np.int8), np.zeros((2, 4, 2), np.float32)
    with pytest.raises(KVTierMismatchError) as ei:
        fp.adopt_packed(0, z, z, s, s, 4)
    assert (ei.value.offered, ei.value.pool, ei.value.where) == ("quantized", "fp",
                                                                 "adopt_packed")
    msgs = []
    for pool in (jfp, fp):
        with pytest.raises(ValueError, match="quantized tiers") as e:
            pool.gather_slot_rows_packed(0, 0, 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    _, q = _pools("int8_per_channel")
    with pytest.raises(KVTierMismatchError) as ei:
        fp.load_state_dict(q.state_dict())
    assert (ei.value.offered, ei.value.pool, ei.value.where) == ("int8_per_channel", "fp",
                                                                 "load_state_dict")
    rt = SplitRuntime(TCFG, SplitConfig(cuts=(0,), hop_codecs=("fp32",)), ["cpu"] * 2)
    pool = rt.init_paged_pool(9, 4)
    with pytest.raises(KVTierMismatchError) as ei:
        rt.gather_paged_packed(pool, np.zeros(2, np.int32))
    assert ei.value.where == "gather_paged_packed"
    z, s = np.zeros((2, 1, 2, 2, 8), np.int8), np.zeros((2, 1, 2, 2), np.float32)
    with pytest.raises(KVTierMismatchError) as ei:
        rt.adopt_paged_rows_packed(pool, z, z, s, s, np.zeros(2, np.int32))
    assert (ei.value.where, ei.value.pool) == ("adopt_paged_rows_packed", "fp")


def test_restore_stream_refuses_cross_tier_typed(weights, tmp_path):
    bat = tb.ContinuousBatcher(TCFG, weights["port"], _bcfg("port", "int8_per_channel"))
    sid = bat.submit(_prompt(5, 1), 6, temperature=0.0, rng_seed=0)
    bat.step()
    path = bat.checkpoint_stream(sid, str(tmp_path / "s.ckpt"))
    fbat = tb.ContinuousBatcher(TCFG, weights["port"], _bcfg("port"))
    with pytest.raises(CheckpointTierMismatchError) as ei:
        fbat.restore_stream(path)
    assert isinstance(ei.value, KVTierMismatchError) and isinstance(ei.value, CheckpointError)
    assert (ei.value.offered, ei.value.pool) == ("int8_per_channel", "fp")


# ---------- configuration and submissions ----------

@pytest.mark.parametrize("kw", [
    {"num_prefill_workers": 0}, {"prefill_batch": 0}, {"queue_bound": 0},
    {"max_retries": -1}, {"degrade_after": 0}, {"enabled": "yes"}, {"fec": "on"},
    {"hedge": 2}, {"faults": {"bitflip_rate": 0.1}}, {"link_seed": 1.5},
    {"prefill_checkpoint": 1}, {"transfer_s_per_page": -1.0},
    {"slow_link_p95_multiple": 1.0}, {"slow_link_min_samples": 1},
    {"slow_link_window_s": 0}, {"num_prefill_workers": True}, {}])
def test_disagg_config_validation_matches_reference(kw):
    """The reference's parametrized refusals (and more of its checks), each
    with the reference's message; a valid config's fields equal."""
    try:
        want = jd.DisaggConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            td.DisaggConfig(**kw)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(td.DisaggConfig(**kw)) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(td.DisaggConfig)] == \
        [f.name for f in dataclasses.fields(jd.DisaggConfig)]


def test_disagg_server_validates_submissions(weights):
    srvs = {pkg: _server(pkg, weights) for pkg in ("ref", "port")}
    bad = [((np.array([], np.int32), 4), {}), ((_prompt(4), 0), {}),
           ((_prompt(4), 4), {"temperature": -1.0}), ((_prompt(4), 33), {})]
    for args, kw in bad:
        msgs = []
        for srv in srvs.values():
            with pytest.raises(ValueError) as e:
                srv.submit(*args, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------- the flight recorder and the front ----------

def test_exactly_one_flight_dump_on_migration_fatal(weights, tmp_path):
    """One migration-fatal failure, one artifact: the port's reads back with
    the reference's failure and extras."""
    arts = {}
    for pkg, fl in (("ref", jflight), ("port", tflight)):
        rec = fl.FlightRecorder(str(tmp_path / pkg))
        fl.configure_flight(rec)
        try:
            srv = _server(pkg, weights, "int8_per_channel", max_retries=0, degrade_after=10,
                          faults={"bitflip_rate": 0.5, "seed": 5})
            sid = srv.submit(_prompt(5, 1), 3, temperature=0.0, rng_seed=0)
            srv.run()
            srv.pop_result(sid)
            dumps = rec.dumps()
            assert len(dumps) == 1
            arts[pkg] = fl.load_flight(dumps[0])
        finally:
            fl.configure_flight(None)
    keep = ("reason", "seq", "failure", "sid", "wid", "phase", "counters", "active_requests")
    assert {k: arts["port"][k] for k in keep} == {k: arts["ref"][k] for k in keep}
    assert arts["port"]["failure"]["type"] == "MigrationError"


def test_serve_front_drains_a_disagg_server(weights):
    """``drain_batched`` over a DisaggServer: completed records with the
    plan's disagg scoreboard, ``disagg_state`` and the report's entry,
    a degrade surfacing through the same probe; a colocated front has
    none."""
    from edgellm_tpu_torch.serve import frontend as tf
    from edgellm_tpu_torch.utils.clock import FakeClock

    srv = _server("port", weights)
    front = tf.ServeFront(TCFG, weights["port"], batcher=srv, clock=FakeClock())
    for prompt, mnt, temp, seed in REQS[:2]:
        front.submit(tf.Request(prompt_ids=prompt, max_new_tokens=mnt, temperature=temp,
                                rng_seed=seed))
    recs = front.drain_batched()
    assert [r.outcome for r in recs] == ["completed", "completed"]
    assert recs[0].plan["mode"] == "disagg" and recs[0].plan["disagg"]["degraded"] is False
    assert front.report()["disagg"] == {"degraded": False, "degrade_reason": None}
    srv.fail_link()
    assert front.disagg_state() == {"degraded": True, "degrade_reason": "migration_link_dead"}
    plain = tf.ServeFront(TCFG, weights["port"], batcher=tb.ContinuousBatcher(
        TCFG, weights["port"], _bcfg("port")), clock=FakeClock())
    assert plain.disagg_state() is None and "disagg" not in plain.report()


def test_cluster_demotes_degraded_disagg_replicas(weights):
    """The router's placement sort demotes a replica whose disaggregated
    front degraded to colocated serving, in both packages (a sim front
    reporting a ``disagg_state``: the same placements, the same replica
    summaries); then on the port's real fronts: two ``ServeFront`` s over
    ``DisaggServer`` s, replica 0's link failed, a fresh request placed on
    replica 1, its summary carrying the typed reason, and both replicas'
    requests completed."""
    from edgellm_tpu.serve import cluster as jc
    from edgellm_tpu.serve import frontend as jf
    from edgellm_tpu_torch.serve import cluster as tc
    from edgellm_tpu_torch.serve import frontend as tf

    prompt = np.random.default_rng(5).integers(1, 50_000, size=16).astype(np.int32)
    got = {}
    for pkg, c, f, clock in (("ref", jc, jf, JClock()), ("port", tc, tf, FakeClock())):
        class DisaggSimFront(c.SimReplicaFront):
            degraded = False

            def disagg_state(self):
                return {"degraded": self.degraded,
                        "degrade_reason": "migration_link_dead" if self.degraded else None}

        fronts = {}

        def factory(rid, gen, _cls=DisaggSimFront, _clock=clock, _fronts=fronts):
            _fronts[rid] = _cls(c.SimReplicaConfig(), clock=_clock, replica_id=rid)
            return _fronts[rid]

        cluster = c.ClusterFront(factory, c.ClusterConfig(num_replicas=2), clock=clock)
        fronts[0].degraded = True
        crid = cluster.submit(f.Request(prompt_ids=prompt, max_new_tokens=4))
        assert cluster._placements[crid].replica_id == 1
        summaries = {r.id: r.summary() for r in cluster.replicas.values()}
        assert summaries[0]["disagg"]["degrade_reason"] == "migration_link_dead"
        assert summaries[1]["disagg"]["degraded"] is False
        fronts[0].degraded = False
        crid2 = cluster.submit(f.Request(prompt_ids=prompt[::-1].copy(), max_new_tokens=4))
        assert cluster._placements[crid2].replica_id == 0
        got[pkg] = summaries, [(p.crid, p.replica_id) for p in cluster._placements.values()]
    assert got["port"] == got["ref"]

    clock = FakeClock()
    servers = {}

    def real_factory(rid, gen):
        servers[rid] = _server("port", weights)
        return tf.ServeFront(TCFG, weights["port"], batcher=servers[rid], clock=clock)

    cluster = tc.ClusterFront(real_factory, tc.ClusterConfig(num_replicas=2), clock=clock)
    servers[0].fail_link()
    short = prompt[:9] % 128
    crid = cluster.submit(tf.Request(prompt_ids=short, max_new_tokens=4))
    assert cluster._placements[crid].replica_id == 1
    assert cluster.replicas[0].summary()["disagg"] == {
        "degraded": True, "degrade_reason": "migration_link_dead"}
    crid2 = cluster.submit(tf.Request(prompt_ids=short[::-1].copy(), max_new_tokens=4))
    # the penalty outranks queue depth: the degraded replica loses even to
    # a busier healthy peer
    assert cluster._placements[crid2].replica_id == 1
    recs = cluster.drain()
    assert sorted(r.request_id for r in recs) == [crid, crid2]
    assert all(r.outcome == "completed" and r.plan["replica"] == 1 for r in recs)
