"""Weights and token ids made from ``--seed``: the benchmark's inputs, handed
alike to the port and to the reference.

Weights are drawn on the card by one ``torch.Generator`` seeded with the
seed, one call a stacked leaf, in float32, then cast to the cell's dtype:
matrices N(0, 0.02) (the usual initialisation), RMSNorm scales 1 + N(0, 0.1)
and q/k/v biases N(0, 0.02), so that the norms and biases do work. The
layout is the port's own: ``x @ W`` matrices with every layer stacked along
a leading axis."""
from __future__ import annotations

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    return gen


def make_weights(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """The stacked parameter dict of a Qwen2 configuration."""
    gen = generator(seed, device)
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    F = cfg["intermediate_size"]

    def draw(std, *shape, mean=0.0):
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (t.mul_(std).add_(mean)).to(dtype)

    layers = {
        "ln1_scale": draw(0.1, L, D, mean=1.0), "ln2_scale": draw(0.1, L, D, mean=1.0),
        "wq": draw(0.02, L, D, H * hd), "wk": draw(0.02, L, D, KV * hd),
        "wv": draw(0.02, L, D, KV * hd), "wo": draw(0.02, L, H * hd, D),
        "bq": draw(0.02, L, H * hd), "bk": draw(0.02, L, KV * hd), "bv": draw(0.02, L, KV * hd),
        "w_gate": draw(0.02, L, D, F), "w_up": draw(0.02, L, D, F), "w_down": draw(0.02, L, F, D),
    }
    params = {"embed": draw(0.02, cfg["vocab_size"], D), "layers": layers,
              "final_norm_scale": draw(0.1, D, mean=1.0)}
    if not cfg["tie_word_embeddings"]:
        params["lm_head"] = draw(0.02, D, cfg["vocab_size"])
    return params


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for one named use of the seed (``stream`` keeps the
    corpus, the request draws and the check's sample apart)."""
    return np.random.default_rng([int(seed) & SEED_MASK, int(stream)])


def corpus(seed: int, n_tokens: int, vocab: int) -> np.ndarray:
    """A synthetic corpus of ``n_tokens`` ids, uniform over the vocabulary."""
    return rng(seed, 1).integers(0, vocab, size=n_tokens, dtype=np.int64)
