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
      - ``"lfm2_moe"``: LFM2's hybrid (Liquid AI's ``Lfm2Moe``): sequential
        residual, RMSNorm, no biases; each layer's mixer is a gated short
        convolution or grouped-query attention with RMSNorm over each head's
        dims on q and k (before RoPE), as ``layer_types`` says; the first
        ``num_dense_layers`` FFNs are SwiGLU MLPs, the rest sparse experts
        (``models/moe.py``). The expert layer holds ``num_experts`` experts,
        ids ``expert_offset`` onwards, of the ``router_experts`` it routes
        over (expert parallelism: a card's share).
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
    #: lfm2_moe: each layer's mixer, "conv" or "full_attention" (None: every
    #: layer attends)
    layer_types: Optional[tuple] = None
    #: lfm2_moe: the leading layers whose FFN is the dense SwiGLU MLP
    num_dense_layers: int = 0
    #: lfm2_moe: taps of the causal depthwise convolution (``conv_L_cache``)
    conv_kernel: int = 0
    #: sparse experts: held here, the id of the first held, routed over,
    #: chosen a token, and each expert's width
    num_experts: int = 0
    expert_offset: int = 0
    router_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def attention_layers(self) -> tuple:
        """Indices of the layers whose mixer is attention (all, for the
        dense families)."""
        if self.layer_types is None:
            return tuple(range(self.num_layers))
        return tuple(i for i, t in enumerate(self.layer_types) if t == "full_attention")

    @property
    def hybrid(self) -> bool:
        """True where layers differ in kind (a convolution or attention
        mixer, an MLP or sparse experts)."""
        return self.family == "lfm2_moe"

    def require_uniform(self, what: str) -> None:
        """A ValueError naming ``what``, a path that runs attention at every
        layer, where some layers are convolutions."""
        conv = [i for i, kind in enumerate(self.layer_types or ()) if kind == "conv"]
        if conv:
            raise ValueError(
                f"{what} runs attention at every layer: the convolution layers {conv} of "
                f"this {self.family} model would need a conv-state cache and a path of "
                f"their own there, which are not implemented")

    def is_moe_layer(self, idx: int) -> bool:
        return self.family == "lfm2_moe" and idx >= self.num_dense_layers

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @property
    def qkv_bias(self) -> bool:
        return self.family in ("gpt_neox", "qwen2")

    def __post_init__(self):
        if self.family not in ("gpt_neox", "qwen2", "llama", "lfm2_moe"):
            raise ValueError(f"unknown family: {self.family}")
        if self.family == "lfm2_moe":
            if self.layer_types is None or len(self.layer_types) != self.num_layers \
                    or set(self.layer_types) - {"conv", "full_attention"}:
                raise ValueError("lfm2_moe needs layer_types: 'conv' or 'full_attention' "
                                 "for each layer")
            if not (0 < self.num_experts_per_tok <= self.router_experts
                    and 0 < self.num_experts
                    and 0 <= self.expert_offset <= self.router_experts - self.num_experts):
                raise ValueError(
                    f"experts held {self.expert_offset} .. "
                    f"{self.expert_offset + self.num_experts - 1} of {self.router_experts}, "
                    f"{self.num_experts_per_tok} a token: not a share of the router's")
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


# LiquidAI/LFM2-8B-A1B (config.json, model_type lfm2_moe): 24 layers at hidden
# 2048, 18 gated short-conv and 6 GQA 32/8 attention layers (heads of 64, QK
# RMSNorm), dense SwiGLU 7168 in layers 0-1, 32 routed experts of 1792 top-4
# with a sigmoid router and expert bias in layers 2-23, vocab 65536, tied head
# (the family's default; the published config leaves it unstated).
_LFM2_TYPES = tuple("full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv"
                    for i in range(24))
LFM2_8B_A1B = ModelConfig(
    family="lfm2_moe",
    vocab_size=65536,
    hidden_size=2048,
    num_layers=24,
    num_heads=32,
    num_kv_heads=8,
    intermediate_size=7168,
    max_position_embeddings=128000,
    norm_eps=1e-5,
    rope_theta=1000000.0,
    tie_word_embeddings=True,
    layer_types=_LFM2_TYPES,
    num_dense_layers=2,
    conv_kernel=3,
    num_experts=32,
    router_experts=32,
    num_experts_per_tok=4,
    moe_intermediate_size=1792,
)
# One card's share of 2-way expert parallelism: experts 0-15 of every MoE
# layer held here, everything else replicated (the benchmark's cell).
LFM2_8B_A1B_EP2 = dataclasses.replace(LFM2_8B_A1B, num_experts=16)


def tiny_lfm2_config() -> ModelConfig:
    """The hybrid at test size: 6 layers (conv, conv, attn, conv, conv,
    attn), 2 dense, 8 routed experts top-2, all held, hidden 128, two heads
    of 64, vocab 256."""
    return ModelConfig(
        family="lfm2_moe", vocab_size=256, hidden_size=128, num_layers=6, num_heads=2,
        num_kv_heads=1, intermediate_size=256, max_position_embeddings=512, norm_eps=1e-5,
        rope_theta=1000000.0, tie_word_embeddings=True,
        layer_types=("conv", "conv", "full_attention", "conv", "conv", "full_attention"),
        num_dense_layers=2, conv_kernel=3, num_experts=8, router_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=64)


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

#: the families the JAX package has no counterpart of (``PRESETS`` holds
#: the shared ones, field for field the reference's)
PORT_PRESETS = {
    "lfm2-8b-a1b": LFM2_8B_A1B,
    "lfm2-8b-a1b-ep2": LFM2_8B_A1B_EP2,
    "tiny-lfm2": tiny_lfm2_config(),
}
