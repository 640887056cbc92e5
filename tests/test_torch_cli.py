"""The port's CLI (``python -m edgellm_tpu_torch.run``) on the CPU, its
params.json validation against the reference CLI's messages, and the package
boundary: the port imports neither JAX nor the JAX package."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from edgellm_tpu import run as jrun
from edgellm_tpu_torch import run as trun

REPO = Path(__file__).resolve().parent.parent


def test_cli_smoke_config_end_to_end(tmp_path, capsys):
    """configs/smoke.json with tiny-qwen2 on the CPU: the table, the JSON
    line, the results file, and the same PPL as calling the sweep directly
    on the same seeded weights."""
    rc = trun.main(["--params", "configs/smoke.json", "--model", "tiny-qwen2",
                    "--device", "cpu", "--output-dir", str(tmp_path),
                    "--max-chunks", "6", "--window-batch", "4", "--seed", "3"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["chunks"] == 6
    assert "regular_importance" in "\n".join(out[:-1])
    saved = json.loads((tmp_path / "avg_ppl_results.json").read_text())
    np.testing.assert_allclose(saved["ppl"], summary["ppl"], rtol=1e-4)

    from edgellm_tpu_torch.eval import run_token_sweep
    from edgellm_tpu_torch.models import PRESETS, init_params

    cfg = PRESETS["tiny-qwen2"]
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    corpus = np.random.default_rng(3).integers(0, cfg.vocab_size, 4096)
    smoke = json.loads((REPO / "configs/smoke.json").read_text())
    res = run_token_sweep(cfg, params, corpus, methods=smoke["methods"],
                          layers_of_interest=smoke["layers_of_interest"],
                          ratios=smoke["ratios"], max_length=smoke["max_length"],
                          stride=smoke["stride"], max_chunks=6, window_batch=4,
                          device="cpu")
    np.testing.assert_allclose(saved["ppl"], res.ppl(), rtol=1e-12)


@pytest.mark.parametrize("config", ["qwen_channel_wise.json", "pythia_initial.json"])
def test_cli_other_sweeps(tmp_path, capsys, config):
    model = "tiny-neox" if "pythia" in config else "tiny-qwen2"
    p = json.loads((REPO / "configs" / config).read_text())
    p["max_length"], p["stride"] = 64, 32
    p["layers_of_interest"] = [l if isinstance(l, str) else min(l, 3)
                               for l in p["layers_of_interest"]]
    rc = trun.main(["--params", json.dumps(p), "--model", model, "--device", "cpu",
                    "--output-dir", str(tmp_path), "--max-chunks", "3"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["chunks"] == 3


def test_weighted_importance_needs_head_weights(tmp_path):
    with pytest.raises(SystemExit, match="requires --head-weights"):
        trun.main(["--params", "configs/qwen_token_sweep.json", "--model", "tiny-qwen2",
                   "--device", "cpu", "--output-dir", str(tmp_path), "--max-chunks", "1"])


#: params.json mistakes a sweep can make: both CLIs must refuse each with the
#: same message
BAD_PARAMS = [
    ["not", "an", "object"],
    {"ratios": [0.5], "layers_of_interest": [1], "hop_codec": "int8"},
    {"experiment": "warp", "layers_of_interest": [1]},
    {"layers_of_interest": [1]},
    {"methods": ["channel_8"]},
    {"experiment": "initial", "ratios": [1]},
    {"ratios": [0.5], "layers_of_interest": [1], "max_length": 0},
    {"ratios": [0.5], "layers_of_interest": [1], "stride": True},
    {"ratios": 0.5, "layers_of_interest": [1]},
    {"ratios": [0.5], "layers_of_interest": [1], "budget": {"aot_peak_bytes": -1}},
    {"ratios": [0.5], "layers_of_interest": [1], "budget": {"peak": 1}},
    {"ratios": [0.5], "layers_of_interest": [1], "budget": {}},
    {"ratios": [0.5], "layers_of_interest": [1], "budget": 3},
    {"ratios": [0.5], "layers_of_interest": [1], "faults": {}},
    {"ratios": [0.5], "layers_of_interest": [1], "deadline": 3},
    {"ratios": [0.5], "layers_of_interest": [1], "serving": {}},
    {"ratios": [0.5], "layers_of_interest": [1], "batching": {}},
    {"ratios": [0.5], "layers_of_interest": [1], "fused_hops": "auto"},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "fused_hops": "fast"},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "fused_hops": "wire", "faults": {"drop_rate": 0.1}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "fused_hops": "remote", "hedge": {}},
    {"experiment": "split", "hop_codecs": ["int8_per_token"], "fused_hops": "auto"},
    {"experiment": "split", "cuts": [1]},
    {"experiment": "split", "cuts": [], "hop_codecs": []},
    {"experiment": "split", "cuts": [1, True], "hop_codecs": ["fp32", "fp32"]},
    {"experiment": "split", "cuts": [1, 2], "hop_codecs": ["fp32"]},
    {"experiment": "split", "cuts": 1, "hop_codecs": ["fp32"]},
    {"experiment": "split", "cuts": [1], "hop_codecs": [3]},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int3"]},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["selective_int4:x"]},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["selective_int4_pallas:0.25"]},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["selective_int4:0.25:bf16:local"]},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["fp32"], "n_seq": 0},
    {"experiment": "distances", "max_compiles": 0},
    {"experiment": "relevance", "stride": 0},
    {"experiment": "relevance", "batching": {}},
    # the faulty link's keys under experiment "split"
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"], "faults": 0.1},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "faults": {"drop": 0.1}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "faults": {"drop_rate": 2.0}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "link_policy": {"on_fail": "retry"}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "link_policy": {"tiers": ["int3_per_token"]}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "faults": {"drop_rate": 0.1}, "fec": {"group_size": 0}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "faults": {"drop_rate": 0.1}, "fec": {"parity": 2}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "faults": {"drop_rate": 0.0}, "link_health": {}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"], "fec": {}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "faults": {"drop_rate": 0.1}, "link_health": {"promote_burn": 2.0}},
    {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
     "faults": {"drop_rate": 0.1}, "hedge": []},
]


@pytest.mark.parametrize("params", BAD_PARAMS, ids=range(len(BAD_PARAMS)))
def test_validation_messages_match_reference(params):
    with pytest.raises(SystemExit) as want:
        jrun._validate_params_json(params)
    with pytest.raises(SystemExit) as got:
        trun._validate_params_json(params)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("config", sorted(p.name for p in (REPO / "configs").glob("*.json")))
def test_every_config_is_accepted_or_named_not_ported(config):
    """Every shipped config either validates or names its experiment as not
    ported yet; none is silently ignored."""
    p = json.loads((REPO / "configs" / config).read_text())
    exp = p.get("experiment", "")
    unported_split = exp == "split" and any(
        k in p and p[k] != 1 for k in trun.UNPORTED_SPLIT_KEYS)
    soak = p.get("serving", {}).get("soak", {})
    unported_serve = exp == "serve" and (
        any(k in p for k in trun.UNPORTED_SERVE_KEYS)
        or ("batching" not in p and soak.get("kill_stage") is not None))
    if exp in trun.NOT_PORTED or "observability" in p or unported_split or unported_serve:
        with pytest.raises(SystemExit, match="not ported yet"):
            trun._validate_params_json(p)
    else:
        trun._validate_params_json(p)


@pytest.mark.parametrize("experiment", ["serve"])
def test_unported_experiments_exit_nonzero_naming_them(experiment, tmp_path):
    """A serve config with a feature still to port (the faulty link under
    the per-request split route) exits non-zero naming it."""
    params = json.dumps({"experiment": experiment, "cuts": [1], "hop_codecs": ["fp32"],
                         "faults": {"drop_rate": 0.05}, "serving": {}})
    proc = subprocess.run(
        [sys.executable, "-m", "edgellm_tpu_torch.run", "--params", params,
         "--model", "tiny-qwen2", "--device", "cpu", "--output-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert (f"faults is not ported yet to edgellm_tpu_torch under experiment {experiment!r}"
            in proc.stderr)


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


#: split keys the faulty link retired from the unported list, with what the
#: reference's validation now says of each alone (None: it validates)
LINK_KEY_ALONE = {"link_policy": None,
                  "hedge": "hedge requires an enabled 'faults' config"}


@pytest.mark.parametrize("key,value", [
    ("link_policy", {}), ("hedge", {}), ("pipeline", {"num_microbatches": 2}),
    ("deadline", 10.0), ("stage_failure", {"stage": 1, "at_step": 1}), ("recovery", {}),
    ("n_seq", 4), ("n_data", 2), ("n_model", 2)])
def test_unported_split_keys_are_named(key, value):
    """Unported split keys die naming themselves; the link keys (ported)
    validate as the reference validates them alone."""
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
    link and the batcher's checkpoints still die "not ported yet";
    speculative decoding stays refused as the reference refuses it."""
    base = _split_serve("split9_qwen_paged.json")
    trun._validate_params_json(base)
    for bad, message in (
            ({**base, "pipeline": {"num_microbatches": 2}}, "pipeline is not ported yet"),
            ({**base, "faults": {"drop_rate": 0.1}}, "faults is not ported yet"),
            ({**base, "batching": {**base["batching"], "checkpoint_dir": "ckpt"}},
             "checkpoint_dir .* not ported yet")):
        with pytest.raises(SystemExit, match=message):
            trun._validate_params_json(bad)
    spec = {**base, "speculative": {"k": 4}}
    with pytest.raises(SystemExit) as want:
        jrun._validate_params_json(spec)
    with pytest.raises(SystemExit) as got:
        trun._validate_params_json(spec)
    assert str(got.value) == str(want.value) and "drop 'speculative' or 'batching'" in str(
        got.value)


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A 4-layer Qwen2-architecture checkpoint (config.json + safetensors)
    that both CLIs' loaders read into the same weights."""
    from safetensors.torch import save_file
    from transformers import Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(0)
    model = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=256, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True)).eval()
    path = tmp_path_factory.mktemp("qwen2_4l")
    model.config.to_json_file(str(path / "config.json"))
    save_file({k: v.contiguous() for k, v in model.state_dict().items()
               if k != "lm_head.weight"}, str(path / "model.safetensors"))
    return path


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


def test_port_runs_with_jax_and_reference_poisoned():
    """A process where importing jax or edgellm_tpu fails still imports the
    whole port and runs a tiny CPU forward and sweep."""
    code = r"""
import sys
sys.modules["jax"] = None
sys.modules["edgellm_tpu"] = None
import numpy as np, torch
import edgellm_tpu_torch.run
from edgellm_tpu_torch.models import PRESETS, init_params, forward
from edgellm_tpu_torch.eval import run_token_sweep
cfg = PRESETS["tiny-qwen2"]
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
logits, _ = forward(cfg, params, torch.zeros((1, 16), dtype=torch.long))
assert logits.shape == (1, 16, cfg.vocab_size) and torch.isfinite(logits).all()
res = run_token_sweep(cfg, params, np.arange(100) % 256, methods=["last_row"],
                      layers_of_interest=[1], ratios=[0, 0.5], max_length=32, stride=16,
                      device="cpu")
assert res.chunks > 0
from edgellm_tpu_torch.eval import run_split_eval
split = run_split_eval(cfg, params, np.arange(100) % 256, cuts=[1, 3],
                       hop_codecs=["int8_per_token_pallas", "selective_int4:0.5"],
                       importance_method="last_row", max_length=32, stride=16,
                       device="cpu")
assert np.isfinite(split["ppl"])
split = run_split_eval(cfg, params, np.arange(100) % 256, cuts=[1], hop_codecs=["int8_per_token"],
                       faults={"drop_rate": 0.5, "bitflip_rate": 1e-3}, fec={}, hedge={},
                       link_health={"window": 2}, link_policy={"tiers": ["int4_per_token"]},
                       max_length=32, stride=16, device="cpu")
assert split["link_counters"]["hops"][0] > 0 and "link_health" in split
import edgellm_tpu_torch.tools.pallas_probe, edgellm_tpu_torch.tools.attn_probe
import edgellm_tpu_torch.codecs.probe_cache, edgellm_tpu_torch.obs.metrics
import edgellm_tpu_torch.serve.frontend, edgellm_tpu_torch.serve.soak
import edgellm_tpu_torch.serve.speculative
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve import ServeFront, SoakConfig, SpecConfig, run_soak
from edgellm_tpu_torch.utils.clock import FakeClock
rt = SplitRuntime(cfg, SplitConfig((2,), ("int8_per_token",)), ["cpu", "cpu"])
clock = FakeClock()
art = run_soak(ServeFront(cfg, params, split_runtime=rt, clock=clock, speculative=SpecConfig(k=3)),
               SoakConfig(n_requests=2, max_new_tokens=5), clock=clock)
assert art["outcomes"] == {"completed": 2} and art["token_identity"]["ok"]
from edgellm_tpu_torch.serve import BatchingConfig, ContinuousBatcher
b = ContinuousBatcher(cfg, params, BatchingConfig(page_size=8, num_pages=8, max_slots=2,
                                                  pages_per_slot=2, kv_codec="int4_per_channel"))
sid = b.submit(np.arange(1, 6), 4, temperature=0.5, rng_seed=1)
assert b.run()[sid].shape == (4,)
b = ContinuousBatcher(cfg, params, BatchingConfig(page_size=8, num_pages=8, max_slots=2,
                                                  pages_per_slot=2, kv_codec="int4_per_channel"),
                      split_runtime=rt, placed_params=rt.place_params(params))
sid = b.submit(np.arange(1, 6), 4, temperature=0.5, rng_seed=1)
assert b.run()[sid].shape == (4,) and b.report()["mode"] == "paged_split"
from edgellm_tpu_torch.eval import run_kv_tier_sweep
rows = run_kv_tier_sweep(cfg, params, np.arange(60) % 256, max_length=16, stride=8,
                         page_size=8, max_chunks=2, device="cpu")
assert all(np.isfinite(r["ppl"]) for r in rows)
from edgellm_tpu_torch.importance.relevance import run_relevance_extraction
w = run_relevance_extraction(cfg, params, np.arange(100) % 256, max_length=32, stride=16,
                             max_chunks=2, device="cpu")
assert w.shape == (6, 4) and np.isfinite(w).all()
from edgellm_tpu_torch.analysis import layer_importance_distributions, pairwise_layer_distances
m = pairwise_layer_distances(layer_importance_distributions(
    cfg, params, [np.arange(20), np.arange(9)], device="cpu"))
assert m.shape == (6, 6) and np.isfinite(m[0, 1:]).all()
assert not any(m == "jax" or m.startswith(("jax.", "edgellm_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+edgellm_tpu\b(?!_torch)"
                        r"|from\s+edgellm_tpu(\.|\s)(?!_torch))", re.M)


def test_no_file_of_the_port_imports_jax_or_the_reference():
    files = sorted((REPO / "edgellm_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "attention_variants.py"]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert not _FORBIDDEN.search(text), f"{path} imports jax or edgellm_tpu"
    assert _FORBIDDEN.search("from edgellm_tpu.models import x")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from edgellm_tpu_torch.models import x")


def test_entry_points_default_to_cuda():
    import inspect

    from edgellm_tpu_torch.analysis import distances
    from edgellm_tpu_torch.eval import harness, split_eval
    from edgellm_tpu_torch.importance import relevance
    from edgellm_tpu_torch.models import hf_loader, safetensors_io, transformer

    for fn in (harness.run_token_sweep, harness.run_channel_sweep, harness.run_initial_sweep,
               transformer.init_params, hf_loader.params_from_state_dict,
               safetensors_io.load_checkpoint, split_eval.run_split_eval,
               split_eval.run_kv_tier_eval,
               relevance.run_relevance_extraction, distances.layer_importance_distributions):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    # the per-request route takes its device from the runtime and the
    # weights it is given: no entry point of it defaults to the CPU
    from edgellm_tpu_torch.serve import decode, soak, speculative

    for mod in (decode, soak, speculative):
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ == mod.__name__:
                dev = inspect.signature(fn).parameters.get("device")
                assert dev is None or dev.default in ("cuda", inspect.Parameter.empty), name
    from edgellm_tpu_torch.models import PRESETS
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime

    rt = SplitRuntime(PRESETS["tiny-qwen2"], SplitConfig((1,), ("int8_per_token",)))
    assert rt.devices == [torch.device("cuda")] * 2
    assert [c.name for c in rt.codecs] == ["int8_per_token_pallas"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "edgellm_tpu_torch.run", "--params", "configs/smoke.json",
         "--model", "tiny-qwen2"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=env)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr


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


#: the relevance run both CLI tests below read: hf_checkpoint's weights, the
#: synthetic corpus of --seed 0, 160 tokens, window 64, stride 32
REL_ARGS = ["--device", "cpu", "--max-chunks", "3", "--window-batch", "2",
            "--synthetic-corpus-len", "160"]
REL_PARAMS = {"experiment": "relevance", "max_length": 64, "stride": 32}


@pytest.fixture(scope="module")
def relevance_run(hf_checkpoint, tmp_path_factory):
    """``relevance`` through the port's CLI on the CPU -> (output dir, the
    printed summary line)."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("relevance")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trun.main(["--params", json.dumps(REL_PARAMS), "--weights", str(hf_checkpoint),
                        "--output-dir", str(out)] + REL_ARGS)
    assert rc == 0
    return out, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_relevance_writes_the_references_artifact(relevance_run, hf_checkpoint):
    """The head weights (L, H) with each row summing to 1, the reference's
    summary keys, checkpoint and metrics files, and the reference's weights
    on the same checkpoint and corpus."""
    from edgellm_tpu.importance.relevance import run_relevance_extraction as j_relevance
    from edgellm_tpu.models.safetensors_io import load_checkpoint as j_load

    out, summary = relevance_run
    weights = np.asarray(json.loads((out / "attention_head_weights.json").read_text()))
    assert summary["artifact"] == str(out / "attention_head_weights.json")
    assert set(summary) == {"artifact", "shape", "chunks", "wall_s", "it_per_s"}
    assert summary["shape"] == [4, 4] and weights.shape == (4, 4) and summary["chunks"] == 3
    np.testing.assert_allclose(weights.sum(axis=1), 1.0, atol=1e-6)
    assert json.loads((out / "relevance_checkpoint.json").read_text())["chunks"] == 3
    assert json.loads((out / "relevance_metrics.jsonl").read_text().splitlines()[-1])["final"]
    jcfg, jparams = j_load(str(hf_checkpoint))
    corpus = np.random.default_rng(0).integers(0, 256, 160)
    want = j_relevance(jcfg, jparams, corpus, max_length=64, stride=32, max_chunks=3,
                       window_batch=2)
    assert want.shape == weights.shape
    np.testing.assert_allclose(weights, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


def test_cli_weighted_sweep_on_the_ports_head_weights(relevance_run, hf_checkpoint, tmp_path,
                                                      capsys):
    """The relevance artifact feeds a token sweep with weighted_importance
    through --head-weights: the reference's run_token_sweep with the same
    head weights gives the same PPL table."""
    from edgellm_tpu.eval.harness import run_token_sweep as j_token_sweep
    from edgellm_tpu.models.safetensors_io import load_checkpoint as j_load

    out, _ = relevance_run
    p = {"methods": ["weighted_importance", "regular_importance"], "layers_of_interest": [1, 2],
         "ratios": [0, 0.5, 1], "max_length": 64, "stride": 32}
    rc = trun.main(["--params", json.dumps(p), "--weights", str(hf_checkpoint),
                    "--head-weights", str(out / "attention_head_weights.json"),
                    "--output-dir", str(tmp_path)] + REL_ARGS)
    assert rc == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcfg, jparams = j_load(str(hf_checkpoint))
    corpus = np.random.default_rng(0).integers(0, 256, 160)
    hw = np.asarray(json.loads((out / "attention_head_weights.json").read_text()))
    want = j_token_sweep(jcfg, jparams, corpus, methods=p["methods"],
                         layers_of_interest=p["layers_of_interest"], ratios=p["ratios"],
                         max_length=64, stride=32, head_weights=hw, max_chunks=3,
                         window_batch=2)
    assert got["chunks"] == want.chunks == 3
    ppl = np.asarray(got["ppl"])
    assert ppl.shape == (2, 2, 3)
    np.testing.assert_allclose(ppl, want.ppl(), rtol=1e-5)
    # the head weights changed the importance ordering the quantizer reads
    assert not np.array_equal(ppl[0], ppl[1])


@pytest.mark.parametrize("max_compiles", [None, 2])
def test_cli_distances_on_a_multi_array_npz_matches_reference(max_compiles, hf_checkpoint,
                                                              tmp_path, capsys):
    """One sample per array (a 1-token array dropped), the reference CLI's
    artifact keys and summary keys, and its matrix within 1e-6."""
    rng = np.random.default_rng(4)
    npz = tmp_path / "samples.npz"
    np.savez(npz, **{f"s{i}": rng.integers(0, 256, n) for i, n in enumerate((2, 12, 1, 30, 45))})
    p = {"experiment": "distances", "max_length": 64}
    if max_compiles is not None:
        p["max_compiles"] = max_compiles
    runs = {}
    for name, cli in (("torch", trun), ("jax", jrun)):
        argv = ["--params", json.dumps(p), "--weights", str(hf_checkpoint), "--corpus", str(npz),
                "--output-dir", str(tmp_path / name)] + (["--device", "cpu"] if name == "torch"
                                                         else [])
        assert cli.main(argv) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        runs[name] = summary, json.loads((tmp_path / name / "layer_distances.json").read_text())
    (got_line, got), (want_line, want) = runs["torch"], runs["jax"]
    assert set(got_line) == set(want_line) == {"artifact", "heatmap", "n_samples", "layers"}
    assert got_line["n_samples"] == want_line["n_samples"] == 4 and got_line["layers"] == 4
    assert set(got) == set(want)
    assert {k: got[k] for k in got if k != "matrix"} == {k: want[k] for k in want if k != "matrix"}
    assert got["clipped"] == (max_compiles is not None)
    g = np.array([[np.nan if v is None else v for v in row] for row in got["matrix"]])
    w = np.array([[np.nan if v is None else v for v in row] for row in want["matrix"]])
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def test_cli_distances_refuses_an_npz_sample_out_of_range(tmp_path):
    npz = tmp_path / "samples.npz"
    np.savez(npz, a=np.arange(10), b=np.array([3, 300, 4]))
    with pytest.raises(SystemExit, match=r"npz sample 1 has token ids outside \[0, 256\)"):
        trun.main(["--params", json.dumps({"experiment": "distances"}), "--model", "tiny-qwen2",
                   "--device", "cpu", "--corpus", str(npz), "--output-dir", str(tmp_path)])
