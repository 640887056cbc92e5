"""The port's CLI on the disaggregated serve config (split16) and the obs
plane's CLI wiring on the CPU, against the reference CLI.

configs/split16_qwen_disagg.json (int8 pages, two prefill workers with two
staging slots each, FEC on the migration link) runs through both CLIs on
one 2-layer checkpoint with fewer requests: the printed line (mode
"disagg_batched", ``disagg_migrations``, ``disagg_degraded``) and
serve_report.json's ``disagg`` scoreboard equal the reference's, and every
request's tokens equal the reference front's. With a hot link and
``flight_recorder: true`` every migration fails, falls back colocated and
leaves one artifact under ``<output-dir>/flight_recorder``, as many as the
reference CLI writes. The reference's disagg validation cases die with its
words; ``--obs-port 0`` with ``--trace-report`` prints the endpoint's URL
line and the per-request span trees, as the reference's end-to-end test
reads them. Timings are not compared.
"""
import json
import os

import numpy as np
import pytest
import torch

from edgellm_tpu import run as jrun
from edgellm_tpu.serve import frontend as jfront
from edgellm_tpu_torch import obs
from edgellm_tpu_torch import run as trun
from edgellm_tpu_torch.serve import frontend as tfront
from test_torch_cli import REPO


@pytest.fixture(scope="module")
def qwen2_2l(tmp_path_factory):
    """A 2-layer Qwen2-architecture checkpoint both CLIs load."""
    from safetensors.torch import save_file
    from transformers import Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(0)
    model = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True)).eval()
    path = tmp_path_factory.mktemp("qwen2_2l")
    model.config.to_json_file(str(path / "config.json"))
    save_file({k: v.contiguous() for k, v in model.state_dict().items()
               if k != "lm_head.weight"}, str(path / "model.safetensors"))
    return path


def _split16(**disagg) -> dict:
    p = json.loads((REPO / "configs" / "split16_qwen_disagg.json").read_text())
    p["serving"]["soak"]["n_requests"] = 6
    p["disagg"].update(disagg)
    return p


def _both_clis(p, weights, tmp_path, capsys, monkeypatch):
    """Both CLIs on ``p`` -> {pkg: (printed line, serve_report.json, tokens by
    request id)}."""
    out = {}
    for pkg, run, front_mod, extra in (("port", trun, tfront, ["--device", "cpu"]),
                                       ("ref", jrun, jfront, [])):
        records = []
        real = front_mod.ServeFront.drain_batched

        def keep(self, *a, _real=real, **kw):
            recs = _real(self, *a, **kw)
            records.extend(recs)
            return recs

        monkeypatch.setattr(front_mod.ServeFront, "drain_batched", keep)
        argv = ["--params", json.dumps(p), "--weights", str(weights),
                "--output-dir", str(tmp_path / pkg)] + extra
        assert run.main(argv) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        report = json.loads((tmp_path / pkg / "serve_report.json").read_text())
        toks = {r.request_id: np.asarray(r.tokens).tolist() for r in records}
        out[pkg] = (line, report, toks)
    return out


@pytest.mark.parametrize("case", ["shipped", "hot_link_flight"])
def test_cli_split16_matches_reference_cli(case, qwen2_2l, tmp_path, capsys, monkeypatch):
    """split16 through both CLIs: the same printed counts, mode and disagg
    keys, the same ``disagg`` scoreboard (wire bytes, link counters,
    migrations and pages), the same tokens for every request; under a hot
    link one flight artifact per failed migration, as the reference."""
    if case == "shipped":
        p = _split16()
    else:
        p = _split16(max_retries=0, degrade_after=100,
                     faults={"bitflip_rate": 0.5, "seed": 1})
        p["observability"] = {"flight_recorder": True, "metrics": False, "tracing": False,
                              "latency": False}
    got = _both_clis(p, qwen2_2l, tmp_path, capsys, monkeypatch)
    (tl, tr, tt), (jl, jr, jt) = got["port"], got["ref"]
    assert set(tl) == set(jl)
    for key in tl:
        if key not in ("decode_tokens_per_s", "artifact"):
            assert tl[key] == jl[key], key
    assert tr["batcher"]["disagg"] == jr["batcher"]["disagg"]
    assert [(r["outcome"], r["reason"], r["plan"]) for r in tr["records"]] == \
        [(r["outcome"], r["reason"], r["plan"]) for r in jr["records"]]
    assert tt == jt and len(tt) == 6
    assert tl["mode"] == "disagg_batched" and tl["outcomes"] == {"completed": 6}
    rep = tr["batcher"]["disagg"]
    if case == "shipped":
        assert tl["disagg_migrations"] == 6 and tl["disagg_degraded"] is False
        # 20-token prompts over 8-row pages: 3 pages a request, one send each
        assert rep["migrated_pages"] == 18 == rep["link"]["transmissions"]
    else:
        arts = sorted(os.listdir(tmp_path / "port" / "flight_recorder"))
        assert len(arts) == rep["link"]["failed"] == 6 == len(
            os.listdir(tmp_path / "ref" / "flight_recorder"))
        assert arts[0] == "flight-0001-MigrationError.bin"
        art = obs.load_flight(str(tmp_path / "port" / "flight_recorder" / arts[0]))
        assert art["phase"] == "migration" and art["failure"]["type"] == "MigrationError"
        assert obs.get_flight_recorder() is None  # the run's recorder detached after it


@pytest.mark.parametrize("patch", [
    {"experiment": "split", "max_length": 512, "stride": 32, "cuts": [1],
     "hop_codecs": ["int8_per_token"], "serving": None, "batching": None, "kv_at_rest": None},
    {"batching": None}, {"speculative": {"k": 4}}, {"disagg": [2]},
    {"disagg": {"num_prefill_workerz": 2}}, {"disagg": {"fec": {"chunkz": 4}}},
    {"disagg": {"hedge": 3}}, {"disagg": {"num_prefill_workers": 0}},
    {"disagg": {"queue_bound": 0}}, {"disagg": {"max_retries": -1}},
    {"disagg": {"faults": {"bitflip_rate": 2.0}}}, {"disagg": {"link_seed": "x"}}])
def test_disagg_validation_matches_reference(patch):
    """The reference's disagg refusals (serve only, not beside
    ``speculative``, needs ``batching``, unknown fields nested ones
    included, each field's bound) in its words."""
    p = json.loads((REPO / "configs" / "split16_qwen_disagg.json").read_text())
    for k, v in patch.items():
        if v is None:
            p.pop(k, None)
        else:
            p[k] = v
    with pytest.raises(SystemExit) as want:
        jrun._validate_params_json(p)
    with pytest.raises(SystemExit) as got:
        trun._validate_params_json(p)
    assert str(got.value) == str(want.value)


def test_disagg_config_nests_the_ladder_configs():
    from edgellm_tpu_torch.codecs.faults import FaultConfig
    from edgellm_tpu_torch.codecs.fec import FECConfig, HedgeConfig

    dcfg = trun._disagg_config({"num_prefill_workers": 3, "fec": {"enabled": True},
                                "hedge": {"enabled": True, "routes": 2},
                                "faults": {"bitflip_rate": 0.01}})
    assert dcfg.num_prefill_workers == 3
    assert isinstance(dcfg.fec, FECConfig) and dcfg.fec.enabled
    assert isinstance(dcfg.hedge, HedgeConfig) and dcfg.hedge.routes == 2
    assert isinstance(dcfg.faults, FaultConfig)


def test_run_serve_trace_report_and_obs_port_e2e(tmp_path, capsys):
    """``--trace-report`` and ``--obs-port 0`` on the per-request serve soak:
    the endpoint's URL line is printed, the report groups spans per request
    with the hop attribution, and the endpoint is stopped after the run."""
    p = {"experiment": "serve", "cuts": [1], "hop_codecs": ["int8_per_token"],
         "serving": {"soak": {"n_requests": 2, "prompt_len": 8, "max_new_tokens": 4}}}
    assert trun.main(["--params", json.dumps(p), "--model", "tiny-qwen2", "--device", "cpu",
                      "--output-dir", str(tmp_path / "out"), "--obs-port", "0",
                      "--trace-report"]) == 0
    out = capsys.readouterr().out
    assert "obs endpoint -> http://127.0.0.1:" in out
    assert "(/metrics /healthz /snapshot.json /trace)" in out
    assert "trace report: 2 request(s)" in out
    assert "  r1:" in out and "  r2:" in out and "serve.execute" in out
    assert "cut=1 codec=int8_per_token" in out and "outcome=clean" in out
    assert obs.server.get_global() is None and not obs.enabled()
