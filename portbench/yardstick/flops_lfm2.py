"""Model FLOPs of the token sweep over an LFM2-MoE configuration, as
``flops.py`` counts them (a multiply-add is 2 FLOPs, matrix products only,
causal attention over its visible pairs, the unembed only where scored),
with each layer counted by its kind: a convolution layer's two projections
(the depthwise taps and the gates are elementwise), an attention layer's q,
k, v, o and causal attention, a dense layer's SwiGLU, an MoE layer's router
and the experts held here. An MoE layer's experts are counted at the rows
uniform routing sends to the held ones, ``num_experts_per_tok x num_experts
/ router_experts`` a token: the work of these experts' share, whatever the
seed's routing."""
from portbench.yardstick.flops import attention_flops, unembed_flops


def layer_flops(cfg: dict, i: int, s: int) -> float:
    """Layer ``i`` over one sequence of ``s`` tokens."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    if cfg["layer_types"][i] == "conv":
        mixer = 2 * (d * 3 * d + d * d) * s
    else:
        mixer = 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d) * s + attention_flops(cfg, s)
    if i < cfg["num_dense_layers"]:
        ffn = 2 * 3 * d * cfg["intermediate_size"] * s
    else:
        rows = cfg["num_experts_per_tok"] * cfg["num_experts"] / cfg["router_experts"]
        ffn = (2 * d * cfg["router_experts"] + rows * 2 * 3 * d * cfg["moe_intermediate_size"]) * s
    return float(mixer + ffn)


def layers_flops(cfg: dict, start: int, stop: int, s: int) -> float:
    return sum(layer_flops(cfg, i, s) for i in range(start, stop))


def sweep_chunk_flops(cfg: dict, s: int, tail: int, n_methods: int, layers, ratios) -> float:
    """One window of the token sweep (``flops.sweep_chunk_flops``'s count):
    the statistics forward over every layer with the ratio-0 baseline
    scored from its final hidden (when a ratio is 0), then one suffix from
    each layer of interest for every (method, nonzero ratio)."""
    n_layers = cfg["num_hidden_layers"]
    nonzero = sum(1 for r in ratios if float(r) != 0.0)
    if nonzero < len(ratios):
        total = layers_flops(cfg, 0, n_layers, s) + unembed_flops(cfg, tail)
    else:
        total = layers_flops(cfg, 0, max(int(l) for l in layers) + 1, s)
    for layer in layers:
        total += n_methods * nonzero * (layers_flops(cfg, int(layer) + 1, n_layers, s)
                                        + unembed_flops(cfg, tail))
    return total
