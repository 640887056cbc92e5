"""The port's CLI on the serve experiment on the CPU against the reference
CLI: the split-paged batcher (``cuts`` beside ``batching``, with and
without split12's µ-batch pipeline), its refusals, and the per-request
split route of split11."""
import json

import numpy as np
import pytest

from edgellm_tpu import run as jrun
from edgellm_tpu_torch import run as trun
from test_torch_cli import REPO, hf_checkpoint  # noqa: F401  (a module fixture)


#: the committed batched serve configs, each with a cut inside tiny-qwen2's
#: 6 layers (no shipped config carries cuts beside batching)
SPLIT_SERVE = ["split9_qwen_paged.json", "split13_qwen_prefix.json", "split14_qwen_kvq.json"]


def _split_serve(name: str, **extra) -> dict:
    p = json.loads((REPO / "configs" / name).read_text())
    p.update(cuts=[2], hop_codecs=["int8_per_token"], fused_hops="off", **extra)
    p["serving"]["soak"]["n_requests"] = 10
    return p


@pytest.mark.parametrize("name", SPLIT_SERVE)
def test_cli_serve_cuts_beside_batching_matches_reference_cli(name, tmp_path, capsys,
                                                              monkeypatch):
    """``cuts`` beside ``batching`` on the CPU: the split-paged batcher
    serves every request, the printed line has the reference CLI's keys and
    counts (mode "batched_split"), and serve_report.json holds the
    batcher's "paged_split" report (split13: prefix hits)."""
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")  # the CLIs set it; restored after
    argv = ["--params", json.dumps(_split_serve(name)), "--model", "tiny-qwen2"]
    assert trun.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "t")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jrun.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in got:
        if key not in ("decode_tokens_per_s", "artifact"):
            assert got[key] == want[key], key
    assert got["mode"] == "batched_split" and got["outcomes"] == {"completed": 10}
    rep = json.loads((tmp_path / "t" / "serve_report.json").read_text())["batcher"]
    assert rep["mode"] == "paged_split" and rep["cuts"] == [2]
    assert rep["hop_codecs"] == ["int8_per_token"] and rep["jit_misses"] == 0
    if name == "split13_qwen_prefix.json":
        assert rep["prefix"]["hits"] >= 1


def test_cli_serve_cuts_beside_batching_still_refuses_unported():
    """Beside ``cuts`` and ``batching`` the µ-batch pipeline, the faulty
    link and the batcher's checkpoints validate, as in the reference; the
    reference's own refusals (the pipeline beside ``speculative``, beside a
    ``max_slots`` it does not divide, beside a quantized ``kv_at_rest``;
    speculative decoding beside the batcher) come in its words, and the
    flight recorder validates as the reference validates it."""
    base = _split_serve("split9_qwen_paged.json")
    trun._validate_params_json(base)
    pipe = {**base, "pipeline": {"num_microbatches": 2}}
    for ok in (pipe, {**base, "faults": {"drop_rate": 0.1}},
               {**base, "batching": {**base["batching"], "checkpoint_dir": "ckpt"}}):
        trun._validate_params_json(ok)
        jrun._validate_params_json(ok)
    for bad in ({**pipe, "speculative": {"k": 4}}, {**pipe, "pipeline": {"num_microbatches": 4}},
                {**pipe, "kv_at_rest": {"codec": "int8_per_channel"}},
                {**pipe, "pipeline": {"num_microbatches": 0}},
                {**pipe, "pipeline": {"stages": 2}}, {**pipe, "pipeline": 2}):
        with pytest.raises(SystemExit) as want:
            jrun._validate_params_json(bad)
        with pytest.raises(SystemExit) as got:
            trun._validate_params_json(bad)
        assert str(got.value) == str(want.value) and "pipeline" in str(got.value)
    flight = {**pipe, "observability": {"flight_recorder": True}}
    trun._validate_params_json(flight)
    jrun._validate_params_json(flight)
    spec = {**base, "speculative": {"k": 4}}
    with pytest.raises(SystemExit) as want:
        jrun._validate_params_json(spec)
    with pytest.raises(SystemExit) as got:
        trun._validate_params_json(spec)
    assert str(got.value) == str(want.value) and "drop 'speculative' or 'batching'" in str(
        got.value)


#: configs/split11_qwen_spec.json's keys at hf_checkpoint's depth (4 layers:
#: cut 2, as SPLIT_CLI cuts the split configs), fewer requests for time, and
#: arrivals 20 virtual seconds apart: the virtual clock advances by measured
#: service time, so denser arrivals would queue (and shed) by the host's load
SPLIT11_CLI = {"cuts": [2], "serving": {"soak": {"n_requests": 8, "arrival_rate": 0.05}}}


@pytest.mark.parametrize("speculative", [True, False])
def test_cli_split11_per_request_route_matches_reference(speculative, hf_checkpoint, tmp_path,
                                                         capsys, monkeypatch):
    """split11 through both CLIs on one checkpoint (and without its
    ``speculative`` block, the vanilla per-request split route): the same
    ``requests``, ``outcomes`` and ``token_identity_ok``, and every
    request's tokens in the port's ``serve_report.json`` equal to the
    reference front's records. Timings are not compared."""
    from edgellm_tpu.serve import soak as jsoak

    p = json.loads((REPO / "configs/split11_qwen_spec.json").read_text())
    p["cuts"] = SPLIT11_CLI["cuts"]
    p["serving"]["soak"].update(SPLIT11_CLI["serving"]["soak"])
    if not speculative:
        del p["speculative"]
    trun._validate_params_json(p, "cuda")
    fronts = []
    real = jsoak.run_soak

    def keep_front(front, soak, **kw):
        fronts.append(front)
        return real(front, soak, **kw)

    monkeypatch.setattr(jsoak, "run_soak", keep_front)
    argv = ["--params", json.dumps(p), "--weights", str(hf_checkpoint)]
    assert trun.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "t")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jrun.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in ("requests", "outcomes", "token_identity_ok"):
        assert got[key] == want[key], key
    assert got["outcomes"] == {"completed": 8} and got["token_identity_ok"] is True
    saved = json.loads((tmp_path / "t" / "serve_report.json").read_text())
    want_toks = {str(r.request_id): np.asarray(r.tokens).tolist() for r in fronts[0].records}
    assert saved["tokens"] == want_toks and len(want_toks) == 8
    assert saved["token_identity"]["checked"] == 8
    if speculative:
        assert saved["soak"]["temperature"] == 0.7  # the residual-resampling branch


def test_cli_serve_pipelined_split_batcher_matches_reference_cli(hf_checkpoint, tmp_path,
                                                                 capsys, monkeypatch):
    """split9's batcher with cut 2 and ``pipeline: {num_microbatches: 2}``
    (six slots, two µ-batches) through both CLIs on one checkpoint: the
    reference CLI's printed counts and, in serve_report.json, the pipeline
    summary; every request's tokens equal the port's unpipelined run's."""
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")
    p = _split_serve("split9_qwen_paged.json", pipeline={"num_microbatches": 2})
    argv = ["--params", json.dumps(p), "--weights", str(hf_checkpoint)]
    assert trun.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "t")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jrun.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in set(got) - {"decode_tokens_per_s", "artifact"}:
        assert got[key] == want[key], key
    assert got["outcomes"] == {"completed": 10} and got["mode"] == "batched_split"
    reports = {d: json.loads((tmp_path / d / "serve_report.json").read_text())
               for d in ("t", "j")}
    assert reports["t"]["batcher"]["pipeline"] == reports["j"]["batcher"]["pipeline"]
    assert reports["t"]["batcher"]["pipeline"]["num_microbatches"] == 2
    from edgellm_tpu_torch.models.safetensors_io import load_checkpoint

    cfg, params = load_checkpoint(str(hf_checkpoint), device="cpu")
    toks = {}
    for name, pp in (("pipelined", p), ("plain", {k: v for k, v in p.items()
                                                   if k != "pipeline"})):
        summary = trun.run_serve(cfg, params, pp, lambda f: str(tmp_path / f"{name}_{f}"))
        toks[name] = {r.request_id: np.asarray(r.tokens).tolist() for r in summary["_records"]}
    assert toks["pipelined"] == toks["plain"] and len(toks["plain"]) == 10
