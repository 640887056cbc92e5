"""Model FLOPs of the work each traffic kind's inputs need: a multiply-add
is 2 FLOPs, matrix products only (norms, softmax and elementwise work are
bound by bytes). Causal attention counts the S(S+1)/2 visible (query, key)
pairs of a sequence, not the full S x S square, and an unembed counts only
the positions that are scored or sampled."""


def weight_flops_per_token(cfg: dict) -> float:
    """One decoder block's weight products for one token: q, k, v, o and the
    SwiGLU MLP's three matrices."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv, f = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["intermediate_size"]
    return float(2 * (d * h * hd + 2 * d * kv * hd + h * hd * d) + 2 * 3 * d * f)


def attention_flops(cfg: dict, s: int, past: int = 0) -> float:
    """QK^T and PV of one block for ``s`` new queries after ``past`` cached
    positions, each query seeing itself and every earlier position."""
    pairs = s * past + s * (s + 1) / 2
    return float(2 * 2 * cfg["num_attention_heads"] * cfg["head_dim"] * pairs)


def layers_flops(cfg: dict, n_layers: int, s: int, past: int = 0) -> float:
    """``n_layers`` blocks over one sequence of ``s`` new tokens."""
    return n_layers * (weight_flops_per_token(cfg) * s + attention_flops(cfg, s, past))


def unembed_flops(cfg: dict, positions: int) -> float:
    """The LM head's product for ``positions`` rows."""
    return float(2 * cfg["hidden_size"] * cfg["vocab_size"] * positions)


def sweep_chunk_flops(cfg: dict, s: int, tail: int, n_methods: int, layers,
                      ratios) -> float:
    """One window of the token sweep: the statistics forward over every
    layer with the ratio-0 baseline scored from its final hidden (when a
    ratio is 0), then one suffix from each layer of interest for every
    (method, nonzero ratio), each scoring ``tail`` positions."""
    n_layers = cfg["num_hidden_layers"]
    nonzero = sum(1 for r in ratios if float(r) != 0.0)
    if nonzero < len(ratios):
        total = layers_flops(cfg, n_layers, s) + unembed_flops(cfg, tail)
    else:
        total = layers_flops(cfg, max(int(l) for l in layers) + 1, s)
    for layer in layers:
        total += n_methods * nonzero * (layers_flops(cfg, n_layers - int(layer) - 1, s)
                                        + unembed_flops(cfg, tail))
    return total


def split_window_flops(cfg: dict, s: int) -> float:
    """One window of the split eval: every block, and the LM head over the
    ``s - 1`` positions that predict a target (the codecs do no products)."""
    return layers_flops(cfg, cfg["num_hidden_layers"], s) + unembed_flops(cfg, s - 1)


def prefill_flops(cfg: dict, s: int) -> float:
    """One prompt's prefill: every block over ``s`` tokens and the LM head
    at the last position, the one token 0 is drawn from."""
    return layers_flops(cfg, cfg["num_hidden_layers"], s) + unembed_flops(cfg, 1)


def decode_flops(cfg: dict, cache_lens) -> float:
    """One decode step of the streams whose caches hold ``cache_lens``
    positions before it: every block for one token each, attending to the
    cache and itself, and the LM head for each."""
    n = len(cache_lens)
    per_pair = 2 * 2 * cfg["num_attention_heads"] * cfg["head_dim"]
    return (cfg["num_hidden_layers"] * (weight_flops_per_token(cfg) * n
                                        + per_pair * (sum(int(p) for p in cache_lens) + n))
            + unembed_flops(cfg, n))
