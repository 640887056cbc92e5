"""Weights of an LFM2-MoE configuration made from ``--seed``, handed alike to
the port and to the reference, by ``weights.py``'s rules: one
``torch.Generator`` on the card seeded with the seed, one call a leaf, in
float32, then cast to the cell's dtype. Matrices N(0, 0.02); RMSNorm scales
(the blocks', the q / k head norms' and the final one) 1 + N(0, 0.1); the
router's ``expert_bias`` N(0, 0.02); the convolution taps U(-1/sqrt(3),
1/sqrt(3)), PyTorch's default Conv1d scale for a fan-in of 3 taps, so that
the mixer does work.

The layout is the port's hybrid one: ``layers`` a list of per-layer dicts in
the ``x @ W`` layout; a convolution layer has ``conv_in`` (D, 3D), ``conv_w``
(taps, D) and ``conv_out`` (D, D), an attention layer ``wq``, ``wk``, ``wv``,
``wo``, ``q_norm`` and ``k_norm``; the dense layers ``w_gate``, ``w_up``,
``w_down``, the others ``router`` (D, router experts), ``expert_bias`` and the
held experts' ``w13`` (E, D, 2F), gate then up, and ``w2`` (E, F, D)."""
from __future__ import annotations

import torch

from portbench.weights import generator


def make_weights(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict:
    gen = generator(seed, device)
    D, hd = cfg["hidden_size"], cfg["head_dim"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    E, Fe, R = cfg["num_experts"], cfg["moe_intermediate_size"], cfg["router_experts"]
    taps = cfg["conv_L_cache"]

    def draw(std, *shape, mean=0.0):
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return t.mul_(std).add_(mean).to(dtype)

    def uniform(bound, *shape):
        t = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        return t.mul_(2 * bound).sub_(bound).to(dtype)

    layers = []
    for i, kind in enumerate(cfg["layer_types"]):
        lp = {"ln1_scale": draw(0.1, D, mean=1.0), "ln2_scale": draw(0.1, D, mean=1.0)}
        if kind == "conv":
            lp.update(conv_in=draw(0.02, D, 3 * D), conv_w=uniform(taps ** -0.5, taps, D),
                      conv_out=draw(0.02, D, D))
        else:
            lp.update(wq=draw(0.02, D, H * hd), wk=draw(0.02, D, KV * hd),
                      wv=draw(0.02, D, KV * hd), wo=draw(0.02, H * hd, D),
                      q_norm=draw(0.1, hd, mean=1.0), k_norm=draw(0.1, hd, mean=1.0))
        if i < cfg["num_dense_layers"]:
            F = cfg["intermediate_size"]
            lp.update(w_gate=draw(0.02, D, F), w_up=draw(0.02, D, F), w_down=draw(0.02, F, D))
        else:
            lp.update(router=draw(0.02, D, R), expert_bias=draw(0.02, R),
                      w13=draw(0.02, E, D, 2 * Fe), w2=draw(0.02, E, Fe, D))
        layers.append(lp)
    return {"embed": draw(0.02, cfg["vocab_size"], D), "layers": layers,
            "final_norm_scale": draw(0.1, D, mean=1.0)}
