"""Model architecture configs for the supported causal-LM families (the
PyTorch port's own copy of ``edgellm_tpu/models/configs.py``: same field names
and presets, so one ``params.json`` drives both CLIs).

The reference hardcodes two HuggingFace checkpoints — ``EleutherAI/pythia-70m``
(``Experiments/Pythia-70M/pythia_model.py:25``) and
``Qwen/Qwen2-0.5B`` (``Experiments/Qwen2-0.5B/qwen_layer_wise.py:17``).  Here the
architecture is an explicit config so any GPT-NeoX- or Qwen2-family size runs,
including the Qwen2-1.5B 3-hop target (BASELINE.json configs[4]) and tiny
randomly-initialized variants used by the test suite.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for one causal LM.

    ``family`` selects the block wiring:
      - ``"gpt_neox"``: parallel-residual blocks, LayerNorm (+bias), fused GELU MLP,
        partial rotary (``rotary_pct``), biases on all linears. Pythia models.
      - ``"qwen2"``: sequential-residual blocks, RMSNorm, SwiGLU MLP, full rotary,
        QKV biases but bias-free o/gate/up/down projections, grouped-query attention.
      - ``"llama"``: identical wiring to qwen2 with no biases anywhere
        (Llama-2/3 models; beyond the reference's two families).
    """

    family: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    max_position_embeddings: int
    norm_eps: float
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    tie_word_embeddings: bool = False
    #: llama3 RoPE frequency rescaling, or None for vanilla RoPE. Tuple form
    #: ("llama3", factor, low_freq_factor, high_freq_factor,
    #: original_max_position_embeddings) — hashable for the frozen config.
    rope_scaling: Optional[tuple] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @property
    def qkv_bias(self) -> bool:
        return self.family in ("gpt_neox", "qwen2")

    def __post_init__(self):
        if self.family not in ("gpt_neox", "qwen2", "llama"):
            raise ValueError(f"unknown family: {self.family}")
        if self.hidden_size % self.num_heads:
            raise ValueError("num_heads must evenly divide hidden_size")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_kv_heads must evenly divide num_heads")


# EleutherAI/pythia-70m — facts per SURVEY.md section 2.1 (6 layers, d=512, 8 heads,
# FFN 2048 GELU, vocab 50304, LayerNorm, rotary_pct 0.25, window 2048).
PYTHIA_70M = ModelConfig(
    family="gpt_neox",
    vocab_size=50304,
    hidden_size=512,
    num_layers=6,
    num_heads=8,
    num_kv_heads=8,
    intermediate_size=2048,
    max_position_embeddings=2048,
    norm_eps=1e-5,
    rope_theta=10000.0,
    rotary_pct=0.25,
)

# Qwen/Qwen2-0.5B — 24 layers, d=896, 14 q heads / 2 kv heads (GQA), FFN 4864,
# vocab 151936, RMSNorm eps 1e-6 (SURVEY.md section 2.1 / notebook module dumps).
QWEN2_0_5B = ModelConfig(
    family="qwen2",
    vocab_size=151936,
    hidden_size=896,
    num_layers=24,
    num_heads=14,
    num_kv_heads=2,
    intermediate_size=4864,
    max_position_embeddings=131072,
    norm_eps=1e-6,
    rope_theta=1000000.0,
    tie_word_embeddings=True,
)

# Qwen/Qwen2-1.5B — the 3-device multi-hop split target (BASELINE.json configs[4]).
QWEN2_1_5B = ModelConfig(
    family="qwen2",
    vocab_size=151936,
    hidden_size=1536,
    num_layers=28,
    num_heads=12,
    num_kv_heads=2,
    intermediate_size=8960,
    max_position_embeddings=131072,
    norm_eps=1e-6,
    rope_theta=1000000.0,
    tie_word_embeddings=True,
)

# meta-llama/Llama-3.2-1B — beyond-parity family (edge-sized Llama). Ships
# llama3 RoPE rescaling (factor 32 over an 8192-token original window).
LLAMA_3_2_1B = ModelConfig(
    family="llama",
    vocab_size=128256,
    hidden_size=2048,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    intermediate_size=8192,
    max_position_embeddings=131072,
    norm_eps=1e-5,
    rope_theta=500000.0,
    tie_word_embeddings=True,
    rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192),
)


def tiny_config(family: str, *, num_layers: int = 4, hidden_size: int = 64,
                num_heads: int = 4, num_kv_heads: int | None = None,
                vocab_size: int = 256, intermediate_size: int | None = None) -> ModelConfig:
    """Small random-init config for tests (no pretrained weights needed)."""
    if num_kv_heads is None:
        num_kv_heads = 2 if family in ("qwen2", "llama") else num_heads
    if intermediate_size is None:
        intermediate_size = hidden_size * 4
    return ModelConfig(
        family=family,
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        num_layers=num_layers,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        intermediate_size=intermediate_size,
        max_position_embeddings=512,
        norm_eps=1e-5 if family == "gpt_neox" else 1e-6,
        rope_theta=10000.0 if family == "gpt_neox" else 1000000.0,
        rotary_pct=0.25 if family == "gpt_neox" else 1.0,
        tie_word_embeddings=family in ("qwen2", "llama"),
    )


PRESETS = {
    "pythia-70m": PYTHIA_70M,
    "qwen2-0.5b": QWEN2_0_5B,
    "qwen2-1.5b": QWEN2_1_5B,
    "llama-3.2-1b": LLAMA_3_2_1B,
    # CI/smoke-scale variants (random init, no pretrained weights needed)
    "tiny-neox": tiny_config("gpt_neox"),
    "tiny-qwen2": tiny_config("qwen2", num_layers=6),
    "tiny-llama": tiny_config("llama", num_layers=6),
}
