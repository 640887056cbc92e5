"""Shared pieces of the benchmark's CPU tests: a tiny Qwen2 configuration
(the port's ``tiny-qwen2`` preset) and each traffic mix cut to its size."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import harness

torch.set_num_threads(min(2, torch.get_num_threads()))

TINY = {"name": "tiny-qwen2", "preset": "tiny-qwen2", "hidden_size": 64,
        "num_hidden_layers": 6, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "intermediate_size": 256, "vocab_size": 256,
        "tie_word_embeddings": True, "rms_norm_eps": 1e-6, "rope_theta": 1e6}

#: each mix at the tiny model's size: the same kind and keys, small shapes
SMALL = {
    "table-fp32": dict(layers_of_interest=[4, 1, 2], max_length=64, stride=16, window_batch=4,
                       chunks_per_call=8, corpus_tokens=3000),
    "sweep-bf16": dict(layers_of_interest=[2], max_length=64, stride=16, window_batch=4,
                       chunks_per_call=8, corpus_tokens=3000, dtype="float32"),
    "split4-fp32": dict(cuts=[1, 3], max_length=64, stride=16, window_batch=4,
                        chunks_per_call=8, corpus_tokens=3000, check_calls=2),
    "serve-closed": dict(clients=6, max_slots=6, page_size=8, pages_per_slot=8, dtype="float32",
                         prompt_len={"median": 16, "sigma": 0.5, "min": 4, "max": 32},
                         output_len={"median": 8, "sigma": 0.5, "min": 2, "max": 24},
                         greedy_share=0.5, warm_steps=2, check_tokens=10_000),
}


def small_ctx(traffic: str, seed: int = 2 ** 33 + 7, seconds: float = 1.0) -> harness.Ctx:
    mix = harness.load_json("traffic", traffic)
    mix.update(SMALL[traffic])
    return harness.Ctx(cell=f"{traffic}.tiny", cfg=dict(TINY), mix=mix, seed=seed,
                       seconds=seconds, trace=False, device="cpu")


@pytest.fixture
def bench() -> dict:
    with open(harness.REPO / "BENCHMARK.json") as f:
        return json.load(f)
