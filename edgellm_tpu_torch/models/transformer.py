"""Transformer core shared by the GPT-NeoX (Pythia), Qwen2 and Llama families,
forward half: PyTorch counterpart of ``edgellm_tpu/models/transformer.py``.

Parameters are a plain dict of tensors with every layer stacked along a
leading axis (``params["layers"][name]`` is (L, ...)) and weights in the
``x @ W`` (in, out) layout, the JAX package's own layout, so one set of
weights drives both packages (``convert.params_from_jax_numpy``). The layer
loop is a Python loop over views of the stack.

The same forward captures the reduced attention statistics the importance
metrics read (per-head column means and last rows), through the K-stats
kernel on the card (``flash_attention.causal_attention_stats``), so no second
model and no (S, S) attention map in device memory. A
``boundary_fn(layer_idx, hidden) -> hidden`` hook sits after each block, the
reference's ``if i == layer_of_interest`` edit point.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .configs import ModelConfig
from .flash_attention import (attention_plain, causal_attention,
                              causal_attention_plain, causal_attention_stats,
                              kernel_plan)


class AttnStats(NamedTuple):
    """Per-layer reduced attention statistics.

    col_mean: (L, B, H, S) fp32 — mean over the query axis of the post-softmax
        attention map (the attention each key position receives, per head).
    last_row: (L, B, H, S) fp32 — final query row of the attention map.
    """

    col_mean: torch.Tensor
    last_row: torch.Tensor


def precompute_rope(cfg: ModelConfig, seq_len: int, device="cuda"):
    """cos/sin tables (S, rotary_dim), fp32, HF convention: emb = cat(freqs, freqs)."""
    rot = cfg.rotary_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    if cfg.rope_scaling is not None:
        inv_freq = _llama3_scale_freqs(inv_freq, cfg.rope_scaling)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _llama3_scale_freqs(inv_freq: torch.Tensor, scaling: tuple) -> torch.Tensor:
    """Llama-3.x RoPE frequency rescaling (transformers'
    ``_compute_llama3_parameters``); ``scaling`` = ("llama3", factor,
    low_freq_factor, high_freq_factor, original_max_position_embeddings)."""
    kind, factor, low_ff, high_ff, orig = scaling
    if kind != "llama3":
        raise ValueError(f"unsupported rope_scaling type {kind!r}")
    low_wavelen = orig / low_ff
    high_wavelen = orig / high_ff
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (orig / wavelen - low_ff) / (high_ff - low_ff)
    smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(wavelen > low_wavelen, inv_freq / factor,
                       torch.where(wavelen < high_wavelen, inv_freq, smoothed))


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 rot: int) -> torch.Tensor:
    """Rotary embedding on the first ``rot`` dims of the head dimension.
    x: (B, S, H, hd); cos/sin: (S, rot), cast to x's dtype first. Partial
    rotary (rot < hd) is the GPT-NeoX ``rotary_pct`` path."""
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    if rot == x.shape[-1]:
        return x * c + _rotate_half(x) * s
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x_rot = x_rot * c + _rotate_half(x_rot) * s
    return torch.cat([x_rot, x_pass], dim=-1)


def _layernorm(x, scale, bias, eps):
    """LayerNorm in fp32, cast back to x's dtype after the affine."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def _rmsnorm(x, scale, eps):
    """RMSNorm: normalized in fp32, cast to x's dtype BEFORE the scale."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _norm(cfg: ModelConfig, x, scale, bias):
    if cfg.family == "gpt_neox":
        return _layernorm(x, scale, bias, cfg.norm_eps)
    return _rmsnorm(x, scale, cfg.norm_eps)


def _stats_block_size(s: int, requested: Optional[int]) -> int:
    """Query-block length for the eager stats path: None auto-picks the
    largest of (128, 64, 32, 16, 8) that divides S; explicit sizes must
    divide S; 0 selects the single full-probabilities block."""
    if requested is not None:
        if requested == 0:
            return s
        if s % requested:
            raise ValueError(f"stats_block {requested} must divide seq len {s}")
        return requested
    for q in (128, 64, 32, 16, 8):
        if s % q == 0 and q < s:
            return q
    return s


def attention(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin,
              capture_stats: bool, stats_block: Optional[int] = None):
    """Causal self-attention with optional reduced-stat capture -> (out, stats).

    Shapes inside :func:`~.flash_attention.kernel_plan`'s envelope go through
    the kernels' wrappers (K-attn without stats, K-stats with them; the CPU
    takes their plain versions); other shapes, and every call with an
    explicit ``stats_block``, take the eager formulation, whose
    ``stats_block=0`` single block is the oracle in tests. Stats are
    (col_sum / S, last_row), each (B, H, S) fp32."""
    b, s, d = x.shape
    hd = cfg.head_dim
    h, kv = lp["wq"].shape[-1] // hd, lp["wk"].shape[-1] // hd

    q = (x @ lp["wq"]).reshape(b, s, h, hd)
    k = (x @ lp["wk"]).reshape(b, s, kv, hd)
    v = (x @ lp["wv"]).reshape(b, s, kv, hd)
    if "bq" in lp:
        q = q + lp["bq"].reshape(h, hd)
        k = k + lp["bk"].reshape(kv, hd)
        v = v + lp["bv"].reshape(kv, hd)
    q = apply_rotary(q, cos, sin, cfg.rotary_dim)
    k = apply_rotary(k, cos, sin, cfg.rotary_dim)

    plan = kernel_plan(s, h, kv, hd, itemsize=x.element_size())
    if not capture_stats:
        out = (causal_attention(q, k, v, plan=plan) if plan is not None
               else causal_attention_plain(q, k, v))
        stats = None
    elif stats_block is None and plan is not None:
        out, stats = causal_attention_stats(q, k, v, plan=plan)
    else:
        out, stats = attention_plain(q, k, v, q_blk=_stats_block_size(s, stats_block))
    out = out.reshape(b, s, h * hd) @ lp["wo"]
    if "bo" in lp:
        out = out + lp["bo"]
    return out, stats


def mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """GELU (exact) MLP for gpt_neox, SwiGLU for qwen2/llama."""
    if cfg.family == "gpt_neox":
        hidden = F.gelu(x @ lp["w_in"] + lp["b_in"], approximate="none")
        return hidden @ lp["w_out"] + lp["b_out"]
    return (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]


def block(cfg: ModelConfig, lp: dict, hidden: torch.Tensor, cos, sin,
          capture_stats: bool, stats_block: Optional[int] = None):
    """One decoder block -> (hidden, stats). GPT-NeoX: parallel residual;
    Qwen2/Llama: sequential."""
    if cfg.family == "gpt_neox":
        attn_in = _layernorm(hidden, lp["ln1_scale"], lp["ln1_bias"], cfg.norm_eps)
        attn_out, stats = attention(cfg, lp, attn_in, cos, sin, capture_stats, stats_block)
        mlp_in = _layernorm(hidden, lp["ln2_scale"], lp["ln2_bias"], cfg.norm_eps)
        return hidden + attn_out + mlp(cfg, lp, mlp_in), stats
    attn_in = _rmsnorm(hidden, lp["ln1_scale"], cfg.norm_eps)
    attn_out, stats = attention(cfg, lp, attn_in, cos, sin, capture_stats, stats_block)
    hidden = hidden + attn_out
    mlp_in = _rmsnorm(hidden, lp["ln2_scale"], cfg.norm_eps)
    return hidden + mlp(cfg, lp, mlp_in), stats


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(input_ids, params["embed"])


def _final_norm(cfg: ModelConfig, params: dict, hidden: torch.Tensor):
    return _norm(cfg, hidden, params["final_norm_scale"],
                 params.get("final_norm_bias", 0.0))


def unembed(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head -> fp32 logits (operands widened to fp32, so a
    bf16 model's logits accumulate like the reference's fp32-preferred dot)."""
    post = _final_norm(cfg, params, hidden)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return post.float() @ head.float()


def run_layers(cfg: ModelConfig, params: dict, hidden: torch.Tensor, *,
               start: int = 0, stop: Optional[int] = None,
               boundary_fn: Optional[Callable] = None,
               capture_stats: bool = False,
               collect_hidden: bool = False,
               stats_block: Optional[int] = None):
    """Run decoder layers [start, stop) over ``hidden`` -> (hidden, aux).

    ``boundary_fn`` receives the global layer index and the post-block hidden
    state. aux holds ``"stats"`` (:class:`AttnStats`, (L, B, H, S) each) with
    ``capture_stats`` and ``"hiddens"`` ((L, B, S, D), post-boundary_fn) with
    ``collect_hidden``."""
    stop = cfg.num_layers if stop is None else stop
    if not (0 <= start <= stop <= cfg.num_layers):
        raise ValueError(
            f"layer segment [{start}, {stop}) out of range for {cfg.num_layers} layers")
    cos, sin = precompute_rope(cfg, hidden.shape[1], device=hidden.device)
    layers = params["layers"]
    cols, lasts, hiddens = [], [], []
    for idx in range(start, stop):
        lp = {name: t[idx] for name, t in layers.items()}
        hidden, stats = block(cfg, lp, hidden, cos, sin, capture_stats, stats_block)
        if boundary_fn is not None:
            hidden = boundary_fn(idx, hidden)
        if capture_stats:
            cols.append(stats[0])
            lasts.append(stats[1])
        if collect_hidden:
            hiddens.append(hidden)
    aux = {}
    if capture_stats:
        aux["stats"] = AttnStats(col_mean=torch.stack(cols), last_row=torch.stack(lasts))
    if collect_hidden:
        aux["hiddens"] = torch.stack(hiddens)
    return hidden, aux


def _cast_params(params: dict, compute_dtype) -> dict:
    """Floating tensors cast to ``compute_dtype``; None keeps them as stored."""
    if compute_dtype is None:
        return params
    return params_to(params, dtype=compute_dtype)


def params_to(params: dict, device=None, dtype=None) -> dict:
    """The parameter dict with every tensor moved to ``device`` and every
    floating tensor cast to ``dtype`` (None keeps either as it is)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.to(device=device,
                    dtype=dtype if dtype is not None and t.is_floating_point() else None)

    return conv(params)


def forward(cfg: ModelConfig, params: dict, input_ids: torch.Tensor, *,
            boundary_fn: Optional[Callable] = None,
            capture_stats: bool = False,
            collect_hidden: bool = False,
            compute_dtype: Optional[torch.dtype] = None,
            stats_block: Optional[int] = None):
    """Full forward: ids -> (logits (B, S, V) fp32, aux)."""
    params = _cast_params(params, compute_dtype)
    hidden = embed(params, input_ids)
    hidden, aux = run_layers(cfg, params, hidden, boundary_fn=boundary_fn,
                             capture_stats=capture_stats,
                             collect_hidden=collect_hidden,
                             stats_block=stats_block)
    return unembed(cfg, params, hidden), aux


def run_layers_from_ids(cfg: ModelConfig, params: dict, input_ids: torch.Tensor, *,
                        capture_stats: bool = False,
                        compute_dtype: Optional[torch.dtype] = None,
                        stats_block: Optional[int] = None):
    """Prefix pass: embed -> all layers, collecting every post-block hidden
    state, without the final norm / unembed."""
    params = _cast_params(params, compute_dtype)
    hidden = embed(params, input_ids)
    return run_layers(cfg, params, hidden, capture_stats=capture_stats,
                      collect_hidden=True, stats_block=stats_block)


def nll_from_logits(logits: torch.Tensor, target_ids: torch.Tensor,
                    per_example: bool = False) -> torch.Tensor:
    """Shifted cross-entropy with -100 masking: logits[:, :-1] vs
    targets[:, 1:], mean over valid positions (of the batch, or per row)."""
    return _masked_ce(logits[:, :-1, :], target_ids[:, 1:], per_example)


def _masked_ce(logits: torch.Tensor, targets: torch.Tensor,
               per_example: bool) -> torch.Tensor:
    """Mean cross-entropy over positions where ``targets != -100``; logits and
    targets are already shift-aligned."""
    valid = targets != -100
    safe_targets = torch.where(valid, targets, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_nll = -torch.gather(logp, -1, safe_targets[..., None])[..., 0]
    tok_nll = torch.where(valid, tok_nll, 0.0)
    if per_example:
        return tok_nll.sum(dim=1) / valid.sum(dim=1).clamp(min=1)
    return tok_nll.sum() / valid.sum().clamp(min=1)


def _vocab_block_size(v: int, target: int = 8192) -> int:
    """Largest divisor of ``v`` at most ``target`` via the smallest block
    count; ``v`` itself when the vocab is small or has no useful divisor."""
    if v <= 2 * target:
        return v
    for nb in range(2, 129):
        if v % nb == 0 and v // nb <= target:
            return v // nb
    return v


def nll_tail(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
             target_ids: torch.Tensor, tail: int,
             per_example: bool = False,
             vocab_block: Optional[int] = None) -> torch.Tensor:
    """``nll_from_logits(unembed(hidden), target_ids)`` with the unembed
    restricted to the last ``tail`` scoring positions (exact whenever every
    earlier target is -100, as the sliding-window recipe guarantees).

    Large vocabularies stream in ``vocab_block``-column blocks with an online
    logsumexp, so the (rows, V) fp32 logits never exist; None auto-picks a
    divisor of V (~8k), 0 forces the single-block full-logits path."""
    s = hidden.shape[1]
    tail = min(int(tail), s - 1)
    h = hidden[:, s - 1 - tail: s - 1]
    tgt = target_ids[:, s - tail:]
    vb = (_vocab_block_size(cfg.vocab_size) if vocab_block is None
          else (cfg.vocab_size if vocab_block == 0 else vocab_block))
    if vb >= cfg.vocab_size:
        return _masked_ce(unembed(cfg, params, h), tgt, per_example)
    if cfg.vocab_size % vb:
        raise ValueError(f"vocab_block {vb} must divide vocab {cfg.vocab_size}")
    return _blocked_ce(cfg, params, h, tgt, per_example, vb)


def _blocked_ce(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
                targets: torch.Tensor, per_example: bool, vb: int) -> torch.Tensor:
    """Streaming cross-entropy: final norm -> per-block fp32 logits -> online
    (max, sum of exp, target logit). Head blocks are views of the head in
    its own layout (no transpose copy of a tied embedding)."""
    b, t, d = hidden.shape
    post = _final_norm(cfg, params, hidden).reshape(b * t, d).float()
    n = b * t
    tgt = targets.reshape(n)
    valid = tgt != -100
    safe_tgt = torch.where(valid, tgt, 0)
    m = torch.full((n,), -torch.inf, dtype=torch.float32, device=hidden.device)
    s_acc = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    t_logit = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    for i in range(cfg.vocab_size // vb):
        if cfg.tie_word_embeddings:
            piece = post @ params["embed"][i * vb:(i + 1) * vb].float().T
        else:
            piece = post @ params["lm_head"][:, i * vb:(i + 1) * vb].float()
        m_new = torch.maximum(m, piece.amax(dim=-1))
        s_acc = s_acc * torch.exp(m - m_new) + torch.exp(piece - m_new[:, None]).sum(dim=-1)
        local = safe_tgt - i * vb
        in_blk = (local >= 0) & (local < vb)
        val = torch.gather(piece, 1, local.clamp(0, vb - 1)[:, None])[:, 0]
        t_logit = torch.where(in_blk, val, t_logit)
        m = m_new
    tok_nll = torch.where(valid, torch.log(s_acc) + m - t_logit, 0.0).reshape(b, t)
    valid = valid.reshape(b, t)
    if per_example:
        return tok_nll.sum(dim=1) / valid.sum(dim=1).clamp(min=1)
    return tok_nll.sum() / valid.sum().clamp(min=1)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """Random init (tests, benchmarks, the CLI without --weights): N(0, 0.02)
    drawn in fp32 from ``generator`` on ``device`` (the generator must live
    there), then cast to ``dtype``; norms at 1, biases at 0."""
    def init(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    L, D, Fd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    layers = {
        "ln1_scale": const(1.0, L, D), "ln2_scale": const(1.0, L, D),
        "wq": init(L, D, H * hd), "wk": init(L, D, KV * hd), "wv": init(L, D, KV * hd),
        "wo": init(L, H * hd, D),
    }
    if cfg.qkv_bias:
        layers.update({"bq": const(0.0, L, H * hd), "bk": const(0.0, L, KV * hd),
                       "bv": const(0.0, L, KV * hd)})
    if cfg.family == "gpt_neox":
        layers.update({
            "ln1_bias": const(0.0, L, D), "ln2_bias": const(0.0, L, D),
            "bo": const(0.0, L, D),
            "w_in": init(L, D, Fd), "b_in": const(0.0, L, Fd),
            "w_out": init(L, Fd, D), "b_out": const(0.0, L, D),
        })
    else:
        layers.update({"w_gate": init(L, D, Fd), "w_up": init(L, D, Fd),
                       "w_down": init(L, Fd, D)})
    params = {"embed": init(cfg.vocab_size, D), "layers": layers,
              "final_norm_scale": const(1.0, D)}
    if cfg.family == "gpt_neox":
        params["final_norm_bias"] = const(0.0, D)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init(D, cfg.vocab_size)
    return params
