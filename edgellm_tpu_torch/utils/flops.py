"""Analytic FLOP accounting for the sweep workloads (MFU / tokens-per-second).

The reference reports only wall-clock progress bars (``qwen2-0.5B_experiment
.ipynb`` cell 12, ~16 s/chunk); here the bench derives model FLOPs from the
architecture so throughput can be stated as MFU against the chip's bf16 peak.
Counts follow the standard convention: a multiply-add is 2 FLOPs; matmuls only
(norms/softmax/elementwise are bandwidth, not FLOP, bound).
"""
from __future__ import annotations

from ..models.configs import ModelConfig


def layer_flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """FLOPs one decoder block spends per token at sequence length ``seq_len``.

    Weight matmuls: q/k/v/o projections + the MLP (SwiGLU = 3 mats, GELU = 2).
    Attention: QK^T and PV are each 2*S*hd per head per query token on average
    S/2 visible keys under causal masking — counted at the full S upper bound
    the dense-softmax formulation executes (the sweep's published FLOP/s
    convention; the CUDA kernel skips the masked upper triangle).
    """
    d, hd = cfg.hidden_size, cfg.head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    proj = 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d)
    mlp_mats = 3 if cfg.family != "gpt_neox" else 2
    mlp = 2 * mlp_mats * cfg.hidden_size * cfg.intermediate_size
    attn = 2 * 2 * seq_len * h * hd  # QK^T + PV, dense causal
    return float(proj + mlp + attn)


def unembed_flops_per_position(cfg: ModelConfig) -> float:
    """Final-norm + LM-head matmul FLOPs for one scored position."""
    return float(2 * cfg.hidden_size * cfg.vocab_size)


def token_sweep_flops_per_chunk(
    cfg: ModelConfig,
    seq_len: int,
    tail: int,
    n_methods: int,
    layers_of_interest,
    n_ratios: int,
    n_zero_ratios: int = 0,
) -> float:
    """Model FLOPs the restructured token sweep performs for ONE evaluation
    window — the work actually executed, the honest numerator for MFU. The
    reference performs strictly more (a full forward incl. full unembed per
    combination, ``Qwen2-0.5B/main.py:170-178``).

    Mirrors the work ``run_token_sweep`` issues:

    - ``n_zero_ratios > 0`` (a ``DEDUP_ZERO_CODECS`` codec): the stats forward
      runs ALL layers and its final hidden is tail-scored ONCE — that single
      extra unembed IS the method- and layer-independent fp baseline; no
      baseline suffix forward exists anymore;
    - ``n_zero_ratios == 0``: no baseline is needed, so the stats forward
      stops at the deepest layer of interest;
    - per (method, layer, nonzero ratio): a layer suffix from the boundary
      plus a ``tail``-position unembed.
    """
    per_layer = layer_flops_per_token(cfg, seq_len)
    tail = min(tail, seq_len - 1)
    unembed = unembed_flops_per_position(cfg) * tail
    if n_zero_ratios > 0:
        stats_fwd = cfg.num_layers * per_layer * seq_len + unembed
    else:
        stats_fwd = (max(int(l) for l in layers_of_interest) + 1) \
            * per_layer * seq_len
    suffix = 0.0
    n_suffixes = n_methods * (n_ratios - n_zero_ratios)
    for layer in layers_of_interest:
        suffix_layers = cfg.num_layers - int(layer) - 1
        suffix += n_suffixes * (suffix_layers * per_layer * seq_len + unembed)
    return stats_fwd + suffix
