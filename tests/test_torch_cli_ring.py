"""The port's CLI on the stage x seq split (``n_seq``, split5 and split5b) on
the CPU against the reference CLI: both read one 2-layer Qwen2 checkpoint,
so the printed results agree: PPL within rtol 1e-5 (the two forwards differ
by float32 roundoff), chunks, token counts, the codec names, the mesh, bytes
per token, the byte totals and the pad accounting exactly; and every
refusal that ``n_seq`` brings, with the reference's message."""
import json

import numpy as np
import pytest

from edgellm_tpu import run as jrun
from edgellm_tpu_torch import run as trun
from test_torch_cli import REPO

#: the shipped configs; each runs with its cut inside a 2-layer model and a
#: window whose length (62) is no multiple of n_seq: every window is padded
RING_CLI = {"split5": "split5_qwen_ring_long.json",
            "split5b": "split5b_qwen_ring_selective.json"}


@pytest.fixture(scope="module")
def hf2_checkpoint(tmp_path_factory):
    """A 2-layer Qwen2-architecture checkpoint (config.json + safetensors,
    written with numpy: no transformers import) that both CLIs' loaders
    read into the same weights."""
    from safetensors.numpy import save_file

    d, f, kv, vocab, layers = 64, 128, 32, 256, 2
    config = {"model_type": "qwen2", "vocab_size": vocab, "hidden_size": d,
              "num_hidden_layers": layers, "num_attention_heads": 4, "num_key_value_heads": 2,
              "intermediate_size": f, "max_position_embeddings": 128, "rms_norm_eps": 1e-6,
              "rope_theta": 10000.0, "tie_word_embeddings": True}
    rng = np.random.default_rng(0)

    def w(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(vocab, d), "model.norm.weight": 1 + w(d)}
    for i in range(layers):
        t = f"model.layers.{i}."
        sd.update({t + "self_attn.q_proj.weight": w(d, d), t + "self_attn.q_proj.bias": w(d),
                   t + "self_attn.k_proj.weight": w(kv, d), t + "self_attn.k_proj.bias": w(kv),
                   t + "self_attn.v_proj.weight": w(kv, d), t + "self_attn.v_proj.bias": w(kv),
                   t + "self_attn.o_proj.weight": w(d, d),
                   t + "input_layernorm.weight": 1 + w(d),
                   t + "post_attention_layernorm.weight": 1 + w(d),
                   t + "mlp.gate_proj.weight": w(f, d), t + "mlp.up_proj.weight": w(f, d),
                   t + "mlp.down_proj.weight": w(d, f)})
    path = tmp_path_factory.mktemp("qwen2_2l")
    (path / "config.json").write_text(json.dumps(config))
    save_file(sd, str(path / "model.safetensors"))
    return path


def _config(name: str) -> dict:
    p = json.loads((REPO / "configs" / RING_CLI[name]).read_text())
    return {**p, "cuts": [0], "max_length": 62, "stride": 32}


@pytest.mark.parametrize("name", sorted(RING_CLI))
def test_cli_ring_configs_match_reference_cli(hf2_checkpoint, tmp_path, capsys, name):
    p = _config(name)
    assert p["n_seq"] == 4
    argv = ["--params", json.dumps(p), "--weights", str(hf2_checkpoint), "--max-chunks", "2",
            "--window-batch", "2", "--synthetic-corpus-len", "160"]
    assert trun.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "t")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jrun.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)
    for key in ("chunks", "n_tokens", "cuts", "hop_codecs", "mesh", "bytes_per_token_per_hop",
                "measured_hop_bytes_total", "real_fwd_tokens", "pad_fraction"):
        assert got[key] == want[key], key
    assert got["mesh"] == {"stage": 2, "seq": 4} and got["pad_fraction"] > 0
    # hops timed at the padded window; no decode hop on the ring
    assert [sorted(t) for t in got["per_hop_timing"]] == \
        [sorted(t) for t in want["per_hop_timing"]] == [["codec", "cut_layer", "forward_ms", "hop"]]
    assert json.loads((tmp_path / "t" / "split_eval_results.json").read_text()) == got


#: params that n_seq refuses, with the reference's words
RING_REFUSALS = {
    "n_data": ({"n_data": 2}, "combining it with n_data/n_model is not supported"),
    "n_model": ({"n_model": 2}, "combining it with n_data/n_model is not supported"),
    "pallas": ({"hop_codecs": ["selective_int4_pallas:0.25"]}, "has no ring"),
    "stage_failure": ({"stage_failure": {"stage": 1, "at_step": 1}},
                      "stage_failure needs the plain split runtime"),
    "pipeline": ({"pipeline": {"num_microbatches": 2}},
                 "pipeline needs the plain split runtime"),
}


@pytest.mark.parametrize("case", sorted(RING_REFUSALS))
def test_cli_ring_refusals_match_reference(case, tmp_path):
    """Each refusal exits non-zero in both CLIs with the same message."""
    extra, message = RING_REFUSALS[case]
    p = {**_config("split5"), **extra}
    messages = []
    for run, device in ((trun, ["--device", "cpu"]), (jrun, [])):
        with pytest.raises(SystemExit, match=message) as e:
            run.main(["--params", json.dumps(p), "--model", "tiny-qwen2", "--max-chunks", "1",
                      "--output-dir", str(tmp_path)] + device)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
