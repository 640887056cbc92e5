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
    if exp in trun.NOT_PORTED or "observability" in p or unported_split:
        with pytest.raises(SystemExit, match="not ported yet"):
            trun._validate_params_json(p)
    else:
        trun._validate_params_json(p)


@pytest.mark.parametrize("experiment", ["serve", "relevance", "distances"])
def test_unported_experiments_exit_nonzero_naming_them(experiment, tmp_path):
    params = json.dumps({"experiment": experiment, "cuts": [1], "hop_codecs": ["fp32"],
                         "serving": {}})
    proc = subprocess.run(
        [sys.executable, "-m", "edgellm_tpu_torch.run", "--params", params,
         "--model", "tiny-qwen2", "--device", "cpu", "--output-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert f"experiment {experiment!r} is not ported yet" in proc.stderr


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
    params = json.dumps({"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"],
                         "faults": {"drop_rate": 0.05}})
    proc = subprocess.run(
        [sys.executable, "-m", "edgellm_tpu_torch.run", "--params", params,
         "--model", "tiny-qwen2", "--device", "cpu", "--output-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "faults is not ported yet" in proc.stderr


@pytest.mark.parametrize("key,value", [
    ("link_policy", {}), ("hedge", {}), ("pipeline", {"num_microbatches": 2}),
    ("deadline", 10.0), ("stage_failure", {"stage": 1, "at_step": 1}), ("recovery", {}),
    ("n_seq", 4), ("n_data", 2), ("n_model", 2)])
def test_unported_split_keys_are_named(key, value):
    p = {"experiment": "split", "cuts": [1], "hop_codecs": ["int8_per_token"], key: value}
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
    files = sorted((REPO / "edgellm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert not _FORBIDDEN.search(text), f"{path} imports jax or edgellm_tpu"
    assert _FORBIDDEN.search("from edgellm_tpu.models import x")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from edgellm_tpu_torch.models import x")


def test_entry_points_default_to_cuda():
    import inspect

    from edgellm_tpu_torch.eval import harness, split_eval
    from edgellm_tpu_torch.models import hf_loader, safetensors_io, transformer

    for fn in (harness.run_token_sweep, harness.run_channel_sweep, harness.run_initial_sweep,
               transformer.init_params, hf_loader.params_from_state_dict,
               safetensors_io.load_checkpoint, split_eval.run_split_eval):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
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
