"""The port's CLI with the split's mesh axes and ``--distributed``, against
the reference CLI, on the CPU.

``run.main`` of both packages on one inline split config with ``n_data`` /
``n_model`` (cut 2, int8_per_token, one seeded 4-layer Qwen2 checkpoint
both CLIs read through ``--weights``, the same synthetic corpus): the
printed JSON lines agree (PPL rtol 1e-5; token counts, bytes, ``mesh``
exactly). ``--distributed`` with nothing configured
runs as one process, as the reference's does. A process where importing
jax or edgellm_tpu fails imports every module this slice added and runs a
tensor-parallel, data-parallel split and the tools.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from edgellm_tpu import run as jrun
from edgellm_tpu_torch import run as trun

REPO = Path(__file__).resolve().parent.parent
STABLE = ("n_tokens", "chunks", "measured_hop_bytes_total", "real_fwd_tokens", "mesh", "cuts",
          "bytes_per_token_per_hop")


def _line(main, argv, capsys) -> dict:
    assert main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads([ln for ln in out if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A 4-layer Qwen2-architecture checkpoint both CLIs read into the same
    weights (4 query heads over 2 KV heads: two shards divide them)."""
    import torch
    from safetensors.torch import save_file
    from transformers import Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(2)
    model = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=256, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True)).eval()
    path = tmp_path_factory.mktemp("qwen2_4l_mesh")
    model.config.to_json_file(str(path / "config.json"))
    save_file({k: v.contiguous() for k, v in model.state_dict().items()
               if k != "lm_head.weight"}, str(path / "model.safetensors"))
    return path


@pytest.mark.parametrize("axes", [{"n_data": 2}, {"n_model": 2}, {"n_data": 2, "n_model": 2}],
                         ids=["data", "model", "both"])
def test_cli_mesh_axes_match_reference(axes, hf_checkpoint, tmp_path, capsys):
    p = json.dumps({"experiment": "split", "cuts": [2], "hop_codecs": ["int8_per_token"],
                    "max_length": 32, "stride": 16, **axes})
    base = ["--params", p, "--weights", str(hf_checkpoint), "--max-chunks", "6",
            "--window-batch", "4", "--synthetic-corpus-len", "256"]
    want = _line(jrun.main, base + ["--output-dir", str(tmp_path / "j")], capsys)
    got = _line(trun.main, base + ["--device", "cpu", "--output-dir", str(tmp_path / "t")],
                capsys)
    for key in STABLE:
        assert got[key] == want[key], key
    assert got["mesh"] == {"stage": 2, "data": axes.get("n_data", 1),
                           "model": axes.get("n_model", 1)}
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)


def test_cli_distributed_without_a_coordinator(tmp_path):
    """``--distributed`` with no rendezvous configured warns and runs as
    process 0 of 1 in both CLIs (a subprocess each, so no process group
    outlives the test)."""
    p = json.dumps({"experiment": "split", "cuts": [2], "hop_codecs": ["int8_per_token"],
                    "max_length": 32, "stride": 16, "n_data": 2})
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    # the reference lays n_data 2 over every device it sees: four CPU devices
    env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    outs = []
    for module, extra in (("edgellm_tpu_torch.run", ["--device", "cpu"]),
                          ("edgellm_tpu.run", [])):
        proc = subprocess.run(
            [sys.executable, "-m", module, "--distributed", "--params", p, "--model",
             "tiny-qwen2", "--max-chunks", "2", "--window-batch", "2",
             "--output-dir", str(tmp_path / module)] + extra,
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "distributed: process 0 of 1" in proc.stdout
        assert "continuing as a single process" in proc.stderr
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert outs[0]["mesh"] == outs[1]["mesh"] == {"stage": 2, "data": 2, "model": 1}


def test_new_modules_run_with_jax_and_reference_poisoned(tmp_path):
    """Importing jax or edgellm_tpu fails, yet every module of this slice
    imports and a tensor-parallel and data-parallel split, the mesh
    builders, the preflight (with a peak reader standing in for the card's
    allocator) and both offline tools run."""
    code = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["edgellm_tpu"] = None
import numpy as np, torch
import edgellm_tpu_torch.run, edgellm_tpu_torch.tools
import edgellm_tpu_torch.analysis.aot
from edgellm_tpu_torch.parallel import distributed, make_multihost_stage_mesh, make_stage_mesh
from edgellm_tpu_torch.tools import check_reproduction, prepare_wikitext, wb_preflight
from edgellm_tpu_torch.models import PRESETS, init_params
from edgellm_tpu_torch.eval import run_split_eval
cfg = PRESETS["tiny-qwen2"]
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
res = run_split_eval(cfg, params, np.arange(200) % 256, cuts=[2], hop_codecs=["int8_per_token"],
                     max_length=32, stride=16, window_batch=4, device="cpu",
                     mesh=make_stage_mesh(2, 2, 2, device="cpu"))
assert np.isfinite(res["ppl"]) and res["mesh"] == {"stage": 2, "data": 2, "model": 2}
assert make_multihost_stage_mesh(2, device="cpu").shape == {"stage": 2, "data": 1, "model": 1}
wb = wb_preflight.preflight_token_sweep_batch(
    cfg, 8, max_length=32, stride=16, layers_of_interest=[1], ratios=[0, 0.5],
    dtype=torch.float32, params=params, device="cpu", hbm_bytes=1 << 40, budget_frac=1.0,
    peak_reader=lambda call: (call(), 1000)[1])
assert wb == 8
path = sys.argv[1] + "/r.json"
json.dump({"axes": {"methods": ["last_row"], "layers_of_interest": [3], "ratios": [0.25]},
           "ppl": [[[13.4]]]}, open(path, "w"))
assert check_reproduction.main([path]) == 0
open(sys.argv[1] + "/x.txt", "w").write("joined corpus")
assert prepare_wikitext.load_texts(sys.argv[1] + "/x.txt") == (["joined corpus"], "joined-txt")
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
