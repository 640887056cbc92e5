"""The port's CLI on the split experiment (``experiment: "split"``) on the
CPU against the reference CLI: the shipped split configs' shapes at
tiny-model depth, the faulty link and ``--fault-report``, the mesh axes,
the codecs whose kernels run only on the card, ``fused_hops``, the split6
failover, and split12's µ-batch pipeline with the obs flags
(``--metrics-out``, ``--trace-out``, ``--trace-report``, ``--profile``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from edgellm_tpu import run as jrun
from edgellm_tpu_torch import run as trun
from test_torch_cli import REPO, hf_checkpoint  # noqa: F401  (a module fixture)


#: the shipped split configs' shapes at tiny-model depth (cuts within 6 layers)
SPLIT_CLI = {
    "split1": ("tiny-qwen2", {"experiment": "split", "cuts": [2],
                              "hop_codecs": ["int8_per_token"]}),
    "split4": ("tiny-qwen2", {"experiment": "split", "cuts": [1, 3],
                              "hop_codecs": ["int8_per_token", "int4_per_token"]}),
    "split2": ("tiny-qwen2", {"experiment": "split", "cuts": [2],
                              "hop_codecs": ["selective_int4:0.25:bf16"],
                              "importance_method": "regular_importance"}),
    "split0": ("tiny-neox", {"experiment": "split", "cuts": [1], "hop_codecs": ["fp32"]}),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CLI))
def test_cli_split_configs(tmp_path, capsys, name):
    """Split params of the shipped configs' shape on the CPU: the results
    file with a finite PPL, the checkpoint and the metrics stream."""
    model, p = SPLIT_CLI[name]
    p = {**p, "max_length": 64, "stride": 32}
    rc = trun.main(["--params", json.dumps(p), "--model", model, "--device", "cpu",
                    "--output-dir", str(tmp_path), "--max-chunks", "5",
                    "--window-batch", "2"])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    saved = json.loads((tmp_path / "split_eval_results.json").read_text())
    assert saved == printed
    assert saved["chunks"] == 5 and np.isfinite(saved["ppl"]) and saved["ppl"] > 1
    assert saved["cuts"] == p["cuts"] and len(saved["per_hop_ms"]) == len(p["cuts"])
    assert json.loads((tmp_path / "split_checkpoint.json").read_text())["chunks"] == 5
    lines = (tmp_path / "split_metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["final"]


def test_split_config_with_faults_exits_naming_the_key(tmp_path):
    """A split config with ``faults`` runs (the faulty link is ported): exit
    0, the result's link counters, and ``--fault-report``'s table naming
    every counter key; ``hedge`` without an enabled ``faults`` exits
    non-zero with the reference's message."""
    params = json.dumps({"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
                         "max_length": 64, "stride": 32, "faults": {"drop_rate": 0.5}})
    proc = subprocess.run(
        [sys.executable, "-m", "edgellm_tpu_torch.run", "--params", params,
         "--model", "tiny-qwen2", "--device", "cpu", "--output-dir", str(tmp_path),
         "--max-chunks", "4", "--window-batch", "2", "--fault-report"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.splitlines()[0])
    assert result["link_counters"]["hops"] == [2]
    assert "fault report (obs metrics registry):" in proc.stdout
    for key in result["link_counters"]:
        assert f"edgellm_link_{key}_total" in proc.stdout
    params = json.dumps({"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
                         "hedge": {"routes": 2}})
    proc = subprocess.run(
        [sys.executable, "-m", "edgellm_tpu_torch.run", "--params", params,
         "--model", "tiny-qwen2", "--device", "cpu", "--output-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "hedge requires an enabled 'faults' config" in proc.stderr


#: split keys the faulty link, survivability, the µ-batch pipeline and the
#: stage x seq runtime retired from the unported list, with what the
#: reference's validation now says of each alone (None: it validates)
LINK_KEY_ALONE = {"link_policy": None,
                  "hedge": "hedge requires an enabled 'faults' config",
                  "deadline": None, "stage_failure": None, "recovery": None,
                  "pipeline": None, "n_seq": None}


@pytest.mark.parametrize("key,value", [
    ("link_policy", {}), ("hedge", {}), ("pipeline", {"num_microbatches": 2}),
    ("deadline", 10.0), ("stage_failure", {"stage": 1, "at_step": 1}), ("recovery", {}),
    ("n_seq", 4), ("n_data", 2), ("n_model", 2)])
def test_unported_split_keys_are_named(key, value):
    """Unported split keys die naming themselves; the link, recovery,
    pipeline and ``n_seq`` keys (ported) validate as the reference validates
    them alone."""
    p = {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"], key: value}
    if key in LINK_KEY_ALONE:
        assert key not in trun.UNPORTED_SPLIT_KEYS
        if LINK_KEY_ALONE[key] is None:
            trun._validate_params_json(p)
            jrun._validate_params_json(p)
            return
        for validate in (trun._validate_params_json, jrun._validate_params_json):
            with pytest.raises(SystemExit, match=LINK_KEY_ALONE[key]):
                validate(p)
        return
    with pytest.raises(SystemExit, match=f"{key} is not ported yet"):
        trun._validate_params_json(p)


def test_split_mesh_axes_of_one_and_unported_twins():
    """Mesh axes of one validate, and so does every kernel twin by its
    ``*_pallas`` name (K5-K7 included) and every fused_hops mode."""
    base = {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token_pallas"]}
    trun._validate_params_json({**base, "n_seq": 1, "n_data": 1, "n_model": 1})
    for twin in ("int8_per_channel_pallas", "int4_per_channel_pallas",
                 "ternary_mean_pallas", "ternary_max_pallas"):
        trun._validate_params_json({**base, "hop_codecs": [twin]}, "cuda")
    for mode in ("auto", "off", "wire", "remote"):
        trun._validate_params_json({**base, "fused_hops": mode}, "cuda")
    with pytest.raises(SystemExit, match="importance_method must be one of"):
        trun._validate_params_json({**base, "importance_method": "attention"})
    with pytest.raises(SystemExit, match="prefix_cache only applies to experiment 'serve'"):
        trun._validate_params_json({**base, "prefix_cache": {}})


@pytest.mark.parametrize("codec,label", [("int8_per_channel", "K5"), ("int4_per_channel", "K6"),
                                         ("ternary_mean", "K7"), ("ternary_max", "K7")])
def test_split_codec_without_its_kernel_dies_on_the_card_only(codec, label, hf_checkpoint,
                                                              tmp_path, capsys):
    """The per-channel and ternary hop codecs validate for a run on the card
    (their kernel twins, ``label``) and on the CPU; the CPU run of the CLI
    gives the reference's PPL and bytes on the same checkpoint and synthetic
    corpus (window batch 1: ternary_mean's channel mean is bit-exact on one
    full window)."""
    from edgellm_tpu.eval.split_eval import run_split_eval as j_split_eval
    from edgellm_tpu.models.safetensors_io import load_checkpoint as j_load

    p = {"experiment": "split", "cuts": [1, 2], "hop_codecs": ["int8_per_token", codec],
         "max_length": 64, "stride": 32}
    trun._validate_params_json(p, "cuda")
    trun._validate_params_json(p, "cpu")
    rc = trun.main(["--params", json.dumps(p), "--weights", str(hf_checkpoint),
                    "--device", "cpu", "--output-dir", str(tmp_path), "--max-chunks", "3",
                    "--window-batch", "1", "--synthetic-corpus-len", "160"])
    assert rc == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcfg, jparams = j_load(str(hf_checkpoint))
    corpus = np.random.default_rng(0).integers(0, 256, 160)
    want = j_split_eval(jcfg, jparams, corpus, cuts=p["cuts"], hop_codecs=p["hop_codecs"],
                        max_length=64, stride=32, max_chunks=3, window_batch=1)
    assert got["chunks"] == want["chunks"] == 3
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)
    assert got["hop_codecs"] == want["hop_codecs"] == p["hop_codecs"]
    assert got["measured_hop_bytes_total"] == want["measured_hop_bytes_total"]


@pytest.mark.parametrize("mode", ["auto", "off", "wire", "remote"])
def test_cli_fused_hops_modes(mode, tmp_path, capsys, monkeypatch):
    """configs/split10_qwen_fused.json's key on the CPU: every mode runs,
    maps onto EDGELLM_FUSED_HOP as the reference's CLI does, and gives the
    unfused PPL (the hops decode the same bytes)."""
    monkeypatch.setenv("EDGELLM_FUSED_HOP", "")
    p = {"experiment": "split", "cuts": [2], "hop_codecs": ["int8_per_token"],
         "max_length": 64, "stride": 32}
    argv = ["--model", "tiny-qwen2", "--device", "cpu", "--output-dir", str(tmp_path),
            "--max-chunks", "3", "--window-batch", "2"]
    assert trun.main(["--params", json.dumps(p)] + argv) == 0
    unfused = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trun.main(["--params", json.dumps({**p, "fused_hops": mode})] + argv) == 0
    fused = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.environ.get("EDGELLM_FUSED_HOP") == {"auto": None, "off": "0", "wire": "wire",
                                                   "remote": "remote"}[mode]
    assert fused["ppl"] == unfused["ppl"]
    assert fused["measured_hop_bytes_total"] == unfused["measured_hop_bytes_total"]


def test_cli_split6_failover_recovery_block_matches_reference(tmp_path, capsys):
    """configs/split6_qwen_failover.json through both CLIs, its cuts inside
    tiny-qwen2's 6 layers and ``--deadline-s`` over its ``deadline``: the
    printed result's recovery block (stage 2 lost at chunk 4, one failover
    and re-plan onto cut 2, the byte totals of the new plan, the mesh) and
    token count equal the reference CLI's (the weights differ: each CLI
    draws its own from ``--seed``); ``--fault-report`` has no link to
    report, as in the reference."""
    p = json.loads((REPO / "configs/split6_qwen_failover.json").read_text())
    p.update(cuts=[1, 3], max_length=64, stride=16)
    argv = ["--params", json.dumps(p), "--model", "tiny-qwen2", "--max-chunks", "12",
            "--window-batch", "4", "--deadline-s", "90", "--fault-report"]
    assert trun.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert jrun.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out.strip().splitlines()
    got, want = json.loads(out[0]), json.loads(jout[0])
    assert got["recovery"] == want["recovery"]
    assert got["recovery"]["deadline_s"] == 90.0 and got["recovery"]["replanned_cuts"] == [2]
    assert got["recovery"]["counters"]["failovers"] == 1
    for key in ("n_tokens", "chunks", "mesh", "measured_hop_bytes_total", "cuts"):
        assert got[key] == want[key], key
    assert np.isfinite(got["ppl"])
    assert out[1:] == jout[1:] == ["fault report: no link counters recorded (faults were off)"]


def test_fault_report_prints_the_recovery_counters_as_the_reference(capsys):
    """``--fault-report``'s table carries the recovery counters beside the
    link counters, line for line the reference's."""
    result = {"link_counters": {"hops": [12, 6], "detected": [2, 0], "retried": [2, 0],
                                "recovered": [2, 0], "substituted": [0, 0],
                                "budget_dropped": [0, 0]},
              "recovery": {"counters": {"failovers": 1, "replans": 1, "recompute_tokens": 0,
                                        "resume_ok": 0, "checkpoints_written": 0,
                                        "watchdog_fires": 0}}}
    trun._print_fault_report(result)
    got = capsys.readouterr().out
    jrun._print_fault_report(result)
    assert got == capsys.readouterr().out
    assert "edgellm_recovery_failovers_total" in got and "edgellm_recovery_replans_total" in got


@pytest.fixture(scope="module")
def hf6_checkpoint(tmp_path_factory):
    """A 6-layer Qwen2-architecture checkpoint both CLIs read into the same
    weights: split12's two cuts fit inside it as [1, 3]."""
    import torch
    from safetensors.torch import save_file
    from transformers import Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(1)
    model = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=256, hidden_size=64, num_hidden_layers=6, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True)).eval()
    path = tmp_path_factory.mktemp("qwen2_6l")
    model.config.to_json_file(str(path / "config.json"))
    save_file({k: v.contiguous() for k, v in model.state_dict().items()
               if k != "lm_head.weight"}, str(path / "model.safetensors"))
    return path


def _prom_families(text: str) -> dict:
    """Prometheus text -> {family: [sample lines]} (parses every line)."""
    fams: dict = {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            fams[line.split()[2]] = []
        elif not line.startswith("# HELP "):
            name = line.split("{")[0].split()[0]
            float(line.rsplit(" ", 1)[1])
            fams[next(f for f in fams if name == f or name.startswith(f + "_"))].append(line)
    return fams


def test_cli_split12_pipeline_with_obs_flags_matches_reference_cli(hf6_checkpoint, tmp_path,
                                                                 capsys, monkeypatch):
    """configs/split12_qwen_pipeline.json's keys (two int8_per_token hops,
    four µ-batches) with cuts [1, 3] through both CLIs on one checkpoint,
    with ``--metrics-out``, ``--trace-out`` and ``--trace-report``: PPL
    within the split tolerance (rtol 1e-5), the same tokens, bytes and
    pipeline summary, the same metric families with equal wire-byte
    counters, the same span names, the same report line. The port's
    ``--profile`` trace holds those spans as ``record_function`` ranges,
    and a run without the flags gives the same result."""
    from edgellm_tpu import obs as jobs
    from edgellm_tpu_torch import obs as tobs

    monkeypatch.setenv("EDGELLM_FUSED_HOP", "0")
    p = json.loads((REPO / "configs/split12_qwen_pipeline.json").read_text())
    p.update(cuts=[1, 3], max_length=64, stride=32)
    argv = ["--params", json.dumps(p), "--weights", str(hf6_checkpoint), "--max-chunks", "6",
            "--window-batch", "4", "--synthetic-corpus-len", "400", "--trace-report"]
    runs = {}
    for name, cli, o in (("t", trun, tobs), ("j", jrun, jobs)):
        d = tmp_path / name
        o.get_registry().clear()
        o.get_tracer().clear()
        extra = ["--device", "cpu", "--profile", str(d / "prof")] if name == "t" else []
        try:
            assert cli.main(argv + extra + ["--output-dir", str(d),
                                            "--metrics-out", str(d / "m.prom"),
                                            "--trace-out", str(d / "t.json")]) == 0
        finally:
            o.disable()
        out = capsys.readouterr().out.strip().splitlines()
        runs[name] = (json.loads(out[0]), out[-1], _prom_families((d / "m.prom").read_text()),
                      {e["name"] for e in json.loads((d / "t.json").read_text())["traceEvents"]})
        o.get_registry().clear()
        o.get_tracer().clear()
    (got, got_rep, got_m, got_s), (want, want_rep, want_m, want_s) = runs["t"], runs["j"]
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)
    for key in ("n_tokens", "chunks", "measured_hop_bytes_total", "pipeline", "pad_fraction",
                "cuts", "hop_codecs", "mesh"):
        assert got[key] == want[key], key
    assert got["pipeline"]["num_microbatches"] == 4 and got["pad_fraction"] > 0
    assert set(got_m) == set(want_m) and "edgellm_wire_bytes_total" in got_m
    assert got_m["edgellm_wire_bytes_total"] == want_m["edgellm_wire_bytes_total"]
    assert got_s == want_s and {"split.hop", "eval.submit_group"} <= got_s
    assert got_rep == want_rep and got_rep.startswith("trace report: no request-attributed")
    prof = json.loads((tmp_path / "t" / "prof" / "torch_trace.json").read_text())
    assert got_s <= {e.get("name") for e in prof["traceEvents"]}
    assert not tobs.enabled()
    assert trun.main(argv[:-1] + ["--device", "cpu", "--output-dir", str(tmp_path / "q")]) == 0
    plain = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert plain["total_nll"] == got["total_nll"] and not tobs.get_registry().names()
