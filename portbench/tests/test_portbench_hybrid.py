"""The hybrid sweep's kind (``kinds/sweep_hybrid.py``) on the CPU at the
port's ``tiny-lfm2`` size: its window runs the program, its reference
agrees with it, the TF32 control is computed, and the expert layer's
counters and FLOP count read what they should."""
from __future__ import annotations

import json

from portbench import harness
from portbench.yardstick import flops_lfm2

TYPES = ["conv", "conv", "full_attention", "conv", "conv", "full_attention"]
TINY_LFM2 = {"name": "tiny-lfm2", "preset": "tiny-lfm2", "model_type": "lfm2_moe",
             "hidden_size": 128, "num_hidden_layers": 6, "num_attention_heads": 2,
             "num_key_value_heads": 1, "head_dim": 64, "intermediate_size": 256,
             "vocab_size": 256, "tie_word_embeddings": True, "layer_types": TYPES,
             "num_dense_layers": 2, "conv_L_cache": 3, "num_experts": 8, "expert_offset": 0,
             "router_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 64,
             "norm_eps": 1e-5, "rope_theta": 1e6, "norm_topk_prob": True,
             "routed_scaling_factor": 1}


def _ctx(seed=2 ** 35 + 3):
    mix = harness.load_json("traffic", "table-hybrid-fp32")
    mix.update(layers_of_interest=[5, 2], max_length=64, stride=16, window_batch=4,
               chunks_per_call=8, corpus_tokens=3000)
    return harness.Ctx(cell="table-hybrid-fp32.tiny", cfg=dict(TINY_LFM2), mix=mix, seed=seed,
                       seconds=0.5, trace=False, device="cpu")


def test_window_matches_reference_and_counts_rows():
    kind = harness.load_kind("sweep_hybrid")
    ctx = _ctx()
    st = kind.setup(ctx)
    win = kind.window(ctx, st, ctx.seconds, None)
    kind.release(st)
    assert win.attempted >= 1 and win.counters["window_chunks"] >= 8
    got = kind.readings(ctx, win)
    assert got["loss_tokens_gap"] == 0 and got["mean_nll_gap"] < 1e-5
    assert got["route_flip_share"] < 0.01
    assert got["moe_rows_dropped"] == 0 and got["moe_rows_routed"] > 0
    assert 0 < got["moe_rows_busiest"] < got["moe_rows_routed"]
    control = kind.readings(ctx, win, control="tf32")
    assert control["loss_tokens_gap"] == 0


def test_flops_count_held_experts_only():
    cfg = dict(TINY_LFM2)
    whole = flops_lfm2.layer_flops(cfg, 3, 64)
    half = flops_lfm2.layer_flops(dict(cfg, num_experts=4), 3, 64)
    d, f = 128, 64
    assert whole - half == 64 * (2 * 8 / 8 - 2 * 4 / 8) * 2 * 3 * d * f


def test_the_cell_is_in_the_benchmark():
    with open(harness.REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = harness.find_cell(bench, "table-hybrid-fp32.lfm2-8b-a1b-ep2")
    cfg = harness.load_json("configs", cell["config"])
    assert (cfg["num_experts"], cfg["router_experts"], cfg["published"]["num_experts"]) == \
        (16, 32, 32)
    kind = harness.load_kind(harness.load_json("traffic", cell["traffic"])["kind"])
    assert kind.port_config(cfg).num_experts == 16
    _, per_layer = harness.cell_metrics(bench, cell["name"])
    assert {"experts_roofline.sweep", "moe_ms.sweep", "route_ms.sweep", "shortconv_ms.sweep",
            "mfu.sweep", "idle_share.sweep", "kernels_per_chunk.sweep", "gemm_share.sweep",
            "kattn_roofline.sweep", "kstats_roofline.sweep", "enqueue_share.sweep",
            "driver_self_share.sweep", "stats_fwd_ms.sweep", "select_ms.sweep",
            "suffix_ms.sweep", "head_ms.sweep"} <= {m["name"] for m in per_layer}
