"""The port's CLI on the replica router's configs (split15, split17) on the
CPU, against the reference CLI.

configs/split15_qwen_cluster.json, configs/split17_qwen_gray.json, split15
with one cut (mode "cluster_batched_split") and split15's ``cluster`` block
over split16's ``disagg`` block and int8 ``kv_at_rest`` pages (mode
"disagg_cluster_batched") run through both CLIs on one 2-layer checkpoint
with fewer requests: the printed line and the whole cluster_report.json
(every replica's summary, the router's totals, the ``gray`` report with
the detector's counts and hedge delay, every record) equal the reference's
exactly, and so does every request's token stream. Both CLIs drive the
fleet on a fake clock, so no field is a wall time. The reference's
``cluster`` and ``gray`` refusals die with its words.
"""
import dataclasses
import json

import numpy as np
import pytest

from edgellm_tpu import run as jrun
from edgellm_tpu.serve import frontend as jfront
from edgellm_tpu_torch import run as trun
from edgellm_tpu_torch.serve import frontend as tfront
from test_torch_cli import REPO
from test_torch_cli_disagg import qwen2_2l  # noqa: F401  (the shared checkpoint fixture)


def _config(name: str) -> dict:
    return json.loads((REPO / "configs" / name).read_text())


def _split15(n_requests: int, **extra) -> dict:
    p = _config("split15_qwen_cluster.json")
    p["serving"]["soak"]["n_requests"] = n_requests
    p.update(extra)
    return p


def _leg(leg: str) -> dict:
    """Each leg at the fewest requests that still reach every replica."""
    if leg == "split17":
        p = _config("split17_qwen_gray.json")
        p["serving"]["soak"]["n_requests"] = 6
        return p
    if leg == "cut":
        return _split15(4, cuts=[0], hop_codecs=["int8_per_token"])
    if leg == "disagg":
        p16 = _config("split16_qwen_disagg.json")
        return _split15(4, disagg=p16["disagg"], kv_at_rest=p16["kv_at_rest"])
    return _split15(4)


MODES = {"split15": "cluster_batched", "split17": "cluster_batched",
         "cut": "cluster_batched_split", "disagg": "disagg_cluster_batched"}


@pytest.mark.parametrize("leg", list(MODES))
def test_cli_cluster_matches_reference_cli(leg, qwen2_2l, tmp_path, capsys,  # noqa: F811
                                           monkeypatch):
    p = _leg(leg)
    got = {}
    for pkg, run, front_mod, extra in (("port", trun, tfront, ["--device", "cpu"]),
                                       ("ref", jrun, jfront, [])):
        toks: dict = {}
        real = front_mod.ServeFront.drain_batched

        def keep(self, *a, _real=real, _toks=toks, **kw):
            recs = _real(self, *a, **kw)
            _toks.update({(id(self), r.request_id): np.asarray(r.tokens).tolist()
                          for r in recs if r.tokens is not None})
            return recs

        monkeypatch.setattr(front_mod.ServeFront, "drain_batched", keep)
        argv = ["--params", json.dumps(p), "--weights", str(qwen2_2l),
                "--output-dir", str(tmp_path / pkg)] + extra
        assert run.main(argv) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        report = json.loads((tmp_path / pkg / "cluster_report.json").read_text())
        line.pop("artifact")
        got[pkg] = (line, report, sorted(toks.values()))
    assert got["port"] == got["ref"]
    line, report, toks = got["port"]
    n = p["serving"]["soak"]["n_requests"]
    assert line["mode"] == MODES[leg] and line["outcomes"] == {"completed": n}
    assert line["replicas"] == p["cluster"]["num_replicas"] and len(toks) == n
    # every replica served: the least-loaded placement spreads the arrivals
    assert all(r["completed"] > 0 for r in report["cluster"]["replicas"].values())
    if leg == "split17":
        gray = report["cluster"]["gray"]
        assert sorted(gray) == ["detector", "flagged", "hedge_delay_s"]
        assert gray["detector"]["observed"] == n
    else:
        assert report["cluster"]["gray"] is None
    if leg == "disagg":
        assert all(r["disagg"] == {"degraded": False, "degrade_reason": None}
                   for r in report["cluster"]["replicas"].values())


@pytest.mark.parametrize("patch", [
    {"experiment": "split", "max_length": 512, "stride": 32, "cuts": [1],
     "hop_codecs": ["int8_per_token"], "serving": None, "batching": None,
     "prefix_cache": None},
    {"batching": None, "prefix_cache": None}, {"speculative": {"k": 4}, "cuts": [1],
                                               "hop_codecs": ["fp32"]},
    {"cluster": [2]}, {"cluster": {"num_replicaz": 2}}, {"cluster": {"respawn": 3}},
    {"cluster": {"respawn": {"backoff_bass_s": 1.0}}}, {"cluster": {"autoscaler": {"x": 1}}},
    {"cluster": {"breaker": {"x": 1}}}, {"cluster": {"retry_budget": {"x": 1}}},
    {"cluster": {"num_replicas": 1}}, {"cluster": {"num_replicas": 0}},
    {"cluster": {"respawn": {"backoff_factor": 0.5}}},
    {"cluster": {"autoscaler": {"min_replicas": 3, "max_replicas": 2}}},
    {"cluster": {"max_readmissions": -1}},
    {"serving": {"soak": {"kill_stage": 0}}},
    {"cluster": None, "gray": {}}, {"gray": [1]}, {"gray": {"p95_multiplez": 3.0}},
    {"gray": {"p95_multiple": 1.0}}, {"gray": {"enabled": 1}},
    {"gray": {"hedge_delay_quantile": 1.0}}, {"gray": {"max_hedge_fraction": 2.0}},
    {"gray": {"min_samples": 0}}])
def test_cluster_and_gray_validation_matches_reference(patch):
    """The reference's refusals of the ``cluster`` and ``gray`` blocks (serve
    only, needs ``batching``, not beside ``speculative``, unknown fields at
    both levels, each field's bound, ``num_replicas < 2``,
    ``serving.soak.kill_stage``, ``gray`` without ``cluster``) in its
    words."""
    p = _config("split17_qwen_gray.json")
    for k, v in patch.items():
        if v is None:
            p.pop(k, None)
        elif k == "serving":
            p["serving"]["soak"].update(v["soak"])
        else:
            p[k] = v
    with pytest.raises(SystemExit) as want:
        jrun._validate_params_json(p)
    with pytest.raises(SystemExit) as got:
        trun._validate_params_json(p)
    assert str(got.value) == str(want.value)


def test_cluster_and_gray_configs_nest_as_the_reference():
    """``_cluster_config`` builds the nested policy objects; ``_gray_config``
    arms a present block unless it says otherwise."""
    from edgellm_tpu_torch.serve.cluster import RespawnConfig

    cl = _config("split15_qwen_cluster.json")["cluster"]
    tcfg, jcfg = trun._cluster_config(cl), jrun._cluster_config(cl)
    assert isinstance(tcfg.respawn, RespawnConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    gy = _config("split17_qwen_gray.json")["gray"]
    assert trun._gray_config(gy).enabled and not trun._gray_config(
        {**gy, "enabled": False}).enabled
    assert dataclasses.asdict(trun._gray_config(gy)) == dataclasses.asdict(
        jrun._gray_config(gy))
