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
    """Every shipped config either validates in both CLIs or names its
    feature as not ported yet (only the data / model mesh axes, which no
    shipped config sets); none is silently ignored (split5's ``n_seq``,
    split12's ``pipeline``,
    split15's ``cluster``, split16's ``disagg``, split17's ``gray`` and
    every ``observability`` field validate)."""
    p = json.loads((REPO / "configs" / config).read_text())
    exp = p.get("experiment", "")
    unported_split = exp == "split" and any(
        k in p and p[k] != 1 for k in trun.UNPORTED_SPLIT_KEYS)
    if exp in trun.NOT_PORTED or unported_split:
        with pytest.raises(SystemExit, match="not ported yet"):
            trun._validate_params_json(p)
    else:
        jrun._validate_params_json(p)
        trun._validate_params_json(p)


@pytest.mark.parametrize("experiment", ["serve"])
def test_unported_experiments_exit_nonzero_naming_them(experiment, tmp_path):
    """The serve blocks it used to name as still to port validate as the
    reference validates them: the µ-batch pipeline, the live endpoint
    (``observability.obs_port``, ``--obs-port``), the replica router
    (``cluster``) and its gray hardening (``gray``); a one-replica
    ``cluster``, a ``gray`` without ``cluster`` and an out-of-range
    ``--obs-port`` exit non-zero with the reference's messages."""
    base = {"experiment": experiment, "cuts": [1], "hop_codecs": ["fp32"],
            "pipeline": {"num_microbatches": 2}, "serving": {}}
    batched = {**base, "batching": {"max_slots": 4}}
    for ok in (base, {**base, "observability": {"obs_port": 0, "flight_recorder": True}},
               {**batched, "cluster": {}}, {**batched, "cluster": {}, "gray": {}}):
        trun._validate_params_json(ok)
        jrun._validate_params_json(ok)
    for params, extra, name in (
            ({**batched, "cluster": {"num_replicas": 1}}, [],
             "cluster.num_replicas must be >= 2 (a one-replica cluster is the plain serve "
             "front — drop the 'cluster' block), got 1"),
            ({**batched, "gray": {}}, [],
             "gray hardening (straggler demotion, request hedging) is a router policy — add "
             "a 'cluster' block"),
            (base, ["--obs-port", "70000"],
             "--obs-port: observability.obs_port must be null or an integer in [0, 65535], "
             "got 70000")):
        proc = subprocess.run(
            [sys.executable, "-m", "edgellm_tpu_torch.run", "--params", json.dumps(params),
             "--model", "tiny-qwen2", "--device", "cpu", "--output-dir", str(tmp_path)] + extra,
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert name in proc.stderr


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


def test_port_runs_with_jax_and_reference_poisoned():
    """A process where importing jax or edgellm_tpu fails still imports the
    whole port and runs a tiny CPU forward and sweep (and the split, the
    ring, serving, the fleet and the experiments)."""
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
split = run_split_eval(cfg, params, np.arange(100) % 256, cuts=[1],
                       hop_codecs=["selective_int4:0.5:bf16:local"], importance_method="last_row",
                       max_length=30, stride=16, n_seq=4, device="cpu")
assert np.isfinite(split["ppl"]) and split["mesh"] == {"stage": 2, "seq": 4}
import edgellm_tpu_torch.tools.ring_mode_gap
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
from edgellm_tpu_torch.serve import (ClusterConfig, ClusterFront, ClusterSoakConfig, GrayConfig,
                                     Request, SimReplicaConfig, SimReplicaFront,
                                     run_cluster_soak)
clock = FakeClock()
cl = ClusterFront(lambda rid, gen: SimReplicaFront(SimReplicaConfig(), clock=clock,
                                                   replica_id=rid),
                  ClusterConfig(num_replicas=2, gray=GrayConfig(enabled=True)), clock=clock)
art = run_cluster_soak(cl, ClusterSoakConfig(n_requests=20, kills=((0.5, 0),)), clock=clock)
assert art["token_identity"]["ok"] and sum(art["outcomes"].values()) == 20
bcfg = BatchingConfig(page_size=8, num_pages=8, max_slots=2, pages_per_slot=2)
cl = ClusterFront(lambda rid, gen: ServeFront(cfg, params, clock=clock,
                                              batcher=ContinuousBatcher(cfg, params, bcfg)),
                  ClusterConfig(num_replicas=2), clock=clock)
for i in range(3):
    cl.submit(Request(prompt_ids=np.arange(1, 6) + i, max_new_tokens=4))
assert [r.outcome for r in cl.drain()] == ["completed"] * 3 and cl.pending == 0
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
