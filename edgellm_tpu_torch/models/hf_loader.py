"""Convert HuggingFace checkpoints (torch state_dicts) into the port's
parameter dict (PyTorch counterpart of ``edgellm_tpu/models/hf_loader.py``).

A torch state_dict (from a local checkpoint, or a randomly-initialized
``transformers`` model in offline tests) becomes one dict of fp32 tensors on
the requested device, each layer weight read into one stack along axis 0
and the layers handed out as views of it (``transformer.params_to``).

Layout notes:
- torch ``nn.Linear.weight`` is (out, in); we store (in, out) so the forward is
  ``x @ W``.
- GPT-NeoX fuses QKV with per-head interleaving: ``query_key_value.weight`` viewed
  as (num_heads, 3*head_dim, in) splits into q/k/v as the three head_dim-blocks of
  each head's rows (matches HF's ``qkv.view(..., num_heads, 3*head_size)`` split).
"""
from __future__ import annotations

import numpy as np
import torch

from .configs import ModelConfig


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(a, dtype=np.float32)
    # tensors read from a safetensors buffer are read-only views: own a copy
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _stack(sd, template: str, n: int, transform):
    return _t(np.stack([transform(_np(sd[template.format(i=i)])) for i in range(n)]))


def _split_neox_qkv(w: np.ndarray, cfg: ModelConfig):
    """(3D, in)-shaped fused weight -> (q, k, v) each (in, D)."""
    h, hd = cfg.num_heads, cfg.head_dim
    per_head = w.reshape(h, 3, hd, -1)
    return tuple(per_head[:, j].reshape(h * hd, -1).T for j in range(3))


def _split_neox_qkv_bias(b: np.ndarray, cfg: ModelConfig):
    h, hd = cfg.num_heads, cfg.head_dim
    per_head = b.reshape(h, 3, hd)
    return tuple(per_head[:, j].reshape(h * hd) for j in range(3))


def params_from_state_dict(cfg: ModelConfig, sd: dict, device="cuda",
                           dtype: torch.dtype = torch.float32) -> dict:
    """Build the port's parameter dict from a HF torch state_dict, on
    ``device`` in ``dtype`` (floating tensors)."""
    from .transformer import params_to

    params = _neox_params(cfg, sd) if cfg.family == "gpt_neox" else _qwen2_params(cfg, sd)
    return params_to(params, device=device, dtype=dtype)


def _neox_params(cfg: ModelConfig, sd: dict) -> dict:
    L = cfg.num_layers
    qs, ks, vs, qbs, kbs, vbs = [], [], [], [], [], []
    for i in range(L):
        w = _np(sd[f"gpt_neox.layers.{i}.attention.query_key_value.weight"])
        b = _np(sd[f"gpt_neox.layers.{i}.attention.query_key_value.bias"])
        q, k, v = _split_neox_qkv(w, cfg)
        qb, kb, vb = _split_neox_qkv_bias(b, cfg)
        qs.append(q); ks.append(k); vs.append(v)
        qbs.append(qb); kbs.append(kb); vbs.append(vb)
    lt = "gpt_neox.layers.{i}."
    layers = {
        "wq": _t(np.stack(qs)), "wk": _t(np.stack(ks)),
        "wv": _t(np.stack(vs)),
        "bq": _t(np.stack(qbs)), "bk": _t(np.stack(kbs)),
        "bv": _t(np.stack(vbs)),
        "wo": _stack(sd, lt + "attention.dense.weight", L, lambda w: w.T),
        "bo": _stack(sd, lt + "attention.dense.bias", L, lambda b: b),
        "ln1_scale": _stack(sd, lt + "input_layernorm.weight", L, lambda w: w),
        "ln1_bias": _stack(sd, lt + "input_layernorm.bias", L, lambda w: w),
        "ln2_scale": _stack(sd, lt + "post_attention_layernorm.weight", L, lambda w: w),
        "ln2_bias": _stack(sd, lt + "post_attention_layernorm.bias", L, lambda w: w),
        "w_in": _stack(sd, lt + "mlp.dense_h_to_4h.weight", L, lambda w: w.T),
        "b_in": _stack(sd, lt + "mlp.dense_h_to_4h.bias", L, lambda b: b),
        "w_out": _stack(sd, lt + "mlp.dense_4h_to_h.weight", L, lambda w: w.T),
        "b_out": _stack(sd, lt + "mlp.dense_4h_to_h.bias", L, lambda b: b),
    }
    params = {
        "embed": _t(_np(sd["gpt_neox.embed_in.weight"])),
        "layers": layers,
        "final_norm_scale": _t(_np(sd["gpt_neox.final_layer_norm.weight"])),
        "final_norm_bias": _t(_np(sd["gpt_neox.final_layer_norm.bias"])),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _t(_np(sd["embed_out.weight"]).T)
    return params


def _qwen2_params(cfg: ModelConfig, sd: dict) -> dict:
    """Qwen2 and Llama share HF key names; Llama simply has no QKV biases."""
    L = cfg.num_layers
    lt = "model.layers.{i}."
    layers = {
        "wq": _stack(sd, lt + "self_attn.q_proj.weight", L, lambda w: w.T),
        "wk": _stack(sd, lt + "self_attn.k_proj.weight", L, lambda w: w.T),
        "wv": _stack(sd, lt + "self_attn.v_proj.weight", L, lambda w: w.T),
        "wo": _stack(sd, lt + "self_attn.o_proj.weight", L, lambda w: w.T),
        "ln1_scale": _stack(sd, lt + "input_layernorm.weight", L, lambda w: w),
        "ln2_scale": _stack(sd, lt + "post_attention_layernorm.weight", L, lambda w: w),
        "w_gate": _stack(sd, lt + "mlp.gate_proj.weight", L, lambda w: w.T),
        "w_up": _stack(sd, lt + "mlp.up_proj.weight", L, lambda w: w.T),
        "w_down": _stack(sd, lt + "mlp.down_proj.weight", L, lambda w: w.T),
    }
    if cfg.qkv_bias:
        layers.update({
            "bq": _stack(sd, lt + "self_attn.q_proj.bias", L, lambda b: b),
            "bk": _stack(sd, lt + "self_attn.k_proj.bias", L, lambda b: b),
            "bv": _stack(sd, lt + "self_attn.v_proj.bias", L, lambda b: b),
        })
    params = {
        "embed": _t(_np(sd["model.embed_tokens.weight"])),
        "layers": layers,
        "final_norm_scale": _t(_np(sd["model.norm.weight"])),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _t(_np(sd["lm_head.weight"]).T)
    return params


def config_from_hf(hf_config) -> ModelConfig:
    """Map a transformers config object to a ModelConfig."""
    mt = hf_config.model_type
    if mt == "gpt_neox":
        if not getattr(hf_config, "use_parallel_residual", True):
            raise ValueError("gpt_neox with use_parallel_residual=False is not supported")
        if getattr(hf_config, "hidden_act", "gelu") != "gelu":
            raise ValueError(f"gpt_neox hidden_act={hf_config.hidden_act!r} not supported (gelu only)")
        if not getattr(hf_config, "attention_bias", True):
            raise ValueError("gpt_neox with attention_bias=False is not supported")
        if getattr(hf_config, "rope_scaling", None):
            raise ValueError("gpt_neox rope_scaling is not supported (vanilla RoPE only)")
        return ModelConfig(
            family="gpt_neox",
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            max_position_embeddings=hf_config.max_position_embeddings,
            norm_eps=hf_config.layer_norm_eps,
            rope_theta=getattr(hf_config, "rotary_emb_base", 10000.0),
            rotary_pct=hf_config.rotary_pct,
            tie_word_embeddings=hf_config.tie_word_embeddings,
        )
    if mt == "llama":
        scaling = getattr(hf_config, "rope_scaling", None)
        rope_scaling = None
        if scaling:
            kind = scaling.get("rope_type", scaling.get("type"))
            if kind != "llama3":
                raise ValueError(f"llama rope_scaling type {kind!r} is not "
                                 f"supported (llama3 or none)")
            rope_scaling = ("llama3", float(scaling["factor"]),
                            float(scaling["low_freq_factor"]),
                            float(scaling["high_freq_factor"]),
                            int(scaling["original_max_position_embeddings"]))
        if getattr(hf_config, "attention_bias", False):
            raise ValueError("llama with attention_bias=True is not supported")
        hd = getattr(hf_config, "head_dim", None)
        if hd and hd * hf_config.num_attention_heads != hf_config.hidden_size:
            raise ValueError("llama with head_dim != hidden_size/num_heads is "
                             "not supported")
        return ModelConfig(
            family="llama",
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            intermediate_size=hf_config.intermediate_size,
            max_position_embeddings=hf_config.max_position_embeddings,
            norm_eps=hf_config.rms_norm_eps,
            rope_theta=hf_config.rope_theta,
            tie_word_embeddings=hf_config.tie_word_embeddings,
            rope_scaling=rope_scaling,
        )
    if mt == "qwen2":
        if getattr(hf_config, "rope_scaling", None):
            raise ValueError("qwen2 rope_scaling is not supported (vanilla RoPE only)")
        if getattr(hf_config, "use_sliding_window", False):
            raise ValueError("qwen2 sliding-window attention is not supported")
        return ModelConfig(
            family="qwen2",
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            intermediate_size=hf_config.intermediate_size,
            max_position_embeddings=hf_config.max_position_embeddings,
            norm_eps=hf_config.rms_norm_eps,
            rope_theta=hf_config.rope_theta,
            tie_word_embeddings=hf_config.tie_word_embeddings,
        )
    raise ValueError(f"unsupported model_type: {mt}")
