"""LRP attention-head relevance (the reference's ``lxt`` path) with autograd:
PyTorch counterpart of ``edgellm_tpu/importance/relevance.py``.

The semantics are the JAX package's, spelled with torch's autograd:

- **LRP rules as custom gradients**: the normalization layers propagate
  relevance as if the normalizer were a constant (the rsqrt factor is
  ``detach()``-ed, computed in fp32), and the SwiGLU elementwise product
  splits relevance equally between its factors (:func:`uniform_mul`, a
  ``torch.autograd.Function``).
- **retain_grad equivalent**: every layer adds a zero "offset" leaf to its
  post-softmax probabilities; one ``torch.autograd.grad`` against the
  offsets yields exactly ``dSeed/dA`` beside ``A`` from the same pass
  (``retain_grad`` would not survive the checkpoints' recomputation).
- **fp32 throughout**: the residual stream is fp32 whatever the parameters'
  dtype, and each weight is widened at its use (``.float()``), as the
  reference's fp32-stream products promote a bf16 weight.
- **Accumulation/normalization**: per (layer, head) relevance summed over
  chunks in float64 on the host, then normalized per layer to sum 1 (signed
  sums, zero sums guarded with a 1e-9 divisor).

Every layer is rematerialized in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``). The
products are plain PyTorch ops, as the reference's are plain XLA ops: the
probabilities must be materialized, so no fused attention stands in here.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.configs import ModelConfig
from ..models.transformer import apply_rotary, embed, precompute_rope


class _UniformMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return a * b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return 0.5 * g * b, 0.5 * g * a


def uniform_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise product with the LRP uniform rule: relevance splits 50/50
    between the factors (gradient*input of each factor gets half the output's)."""
    return _UniformMul.apply(a, b)


def _rmsnorm_lrp(x, scale, eps):
    xf = x.float()
    denom = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps).detach()
    return (xf * denom) * scale.float()


def _layernorm_lrp(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    denom = torch.rsqrt(xf.var(-1, keepdim=True, unbiased=False) + eps).detach()
    return (xf - mu) * denom * scale.float() + bias.float()


def _lrp_attention(cfg: ModelConfig, lp: dict, x, cos, sin, probs_offset):
    """Eager attention returning the (differentiable) probability tensor;
    ``probs_offset`` (B, H, S, S) is added to the post-softmax probabilities
    (the caller passes zeros and differentiates against them)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ lp["wq"].float()).reshape(b, s, h, hd)
    k = (x @ lp["wk"].float()).reshape(b, s, kv, hd)
    v = (x @ lp["wv"].float()).reshape(b, s, kv, hd)
    if "bq" in lp:
        q = q + lp["bq"].float().reshape(h, hd)
        k = k + lp["bk"].float().reshape(kv, hd)
        v = v + lp["bv"].float().reshape(kv, hd)
    q = apply_rotary(q, cos, sin, cfg.rotary_dim)
    k = apply_rotary(k, cos, sin, cfg.rotary_dim)
    rep = h // kv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(causal, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1) + probs_offset
    out = torch.einsum("bhst,bthd->bshd", probs.to(x.dtype), v).to(x.dtype)
    out = out.reshape(b, s, h * hd) @ lp["wo"].float()
    if "bo" in lp:
        out = out + lp["bo"].float()
    return out, probs


def _lrp_mlp(cfg: ModelConfig, lp: dict, x):
    if cfg.family == "gpt_neox":
        # no GELU rule in the reference's lxt patch list: the standard gradient
        hidden = F.gelu(x @ lp["w_in"].float() + lp["b_in"].float(), approximate="none")
        return hidden @ lp["w_out"].float() + lp["b_out"].float()
    gate = F.silu(x @ lp["w_gate"].float())
    return uniform_mul(gate, x @ lp["w_up"].float()) @ lp["w_down"].float()


def _lrp_block(cfg: ModelConfig, lp: dict, hidden, cos, sin, probs_offset):
    """One decoder block -> (hidden, probs). GPT-NeoX: parallel residual;
    Qwen2/Llama: sequential."""
    if cfg.family == "gpt_neox":
        attn_in = _layernorm_lrp(hidden, lp["ln1_scale"], lp["ln1_bias"], cfg.norm_eps)
        attn_out, probs = _lrp_attention(cfg, lp, attn_in, cos, sin, probs_offset)
        mlp_in = _layernorm_lrp(hidden, lp["ln2_scale"], lp["ln2_bias"], cfg.norm_eps)
        return hidden + attn_out + _lrp_mlp(cfg, lp, mlp_in), probs
    attn_in = _rmsnorm_lrp(hidden, lp["ln1_scale"], cfg.norm_eps)
    attn_out, probs = _lrp_attention(cfg, lp, attn_in, cos, sin, probs_offset)
    hidden = hidden + attn_out
    mlp_in = _rmsnorm_lrp(hidden, lp["ln2_scale"], cfg.norm_eps)
    return hidden + _lrp_mlp(cfg, lp, mlp_in), probs


def _lrp_layers(cfg: ModelConfig, params: dict, input_ids, probs_offsets: Sequence,
                last_position_only: bool):
    """-> (logits, list of L (B, H, S, S) probs); each layer rematerialized
    in the backward pass. ``last_position_only`` sends only the last
    position through the head (the head is per position: the same logits)."""
    cfg.require_uniform("LRP relevance")
    hidden = embed(params, input_ids).float()
    cos, sin = precompute_rope(cfg, input_ids.shape[1], device=input_ids.device)
    probs = []
    for idx, lp in enumerate(params["layers"]):
        hidden, p = checkpoint(_lrp_block, cfg, lp, hidden, cos, sin, probs_offsets[idx],
                               use_reentrant=False)
        probs.append(p)
    if last_position_only:
        hidden = hidden[:, -1:]
    if cfg.family == "gpt_neox":
        post = _layernorm_lrp(hidden, params["final_norm_scale"],
                              params["final_norm_bias"], cfg.norm_eps)
    else:
        post = _rmsnorm_lrp(hidden, params["final_norm_scale"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", post, head.float()), probs


def lrp_forward(cfg: ModelConfig, params: dict, input_ids: torch.Tensor, probs_offsets):
    """ids + per-layer probability offsets ((L, B, H, S, S), or a sequence of
    L (B, H, S, S)) -> (logits (B, S, V) fp32, stacked probs (L, B, H, S, S))."""
    logits, probs = _lrp_layers(cfg, params, input_ids, probs_offsets, False)
    return logits, torch.stack(probs)


def chunk_relevance(cfg: ModelConfig, params: dict, ids: torch.Tensor, *,
                    with_tokens: bool = False):
    """ids (B, S) -> per-(layer, head) relevance (L, H) fp32 for one chunk:
    ``sum(A * dSeed/dA)`` over batch, query and key, the seed being each
    row's max last-position logit with its own value as the cotangent (the
    reference's ``max_logits.backward(max_logits)``). ``with_tokens`` also
    returns each row's argmax token, the logit the seed picked."""
    b, s = ids.shape
    with torch.enable_grad():
        offsets = [torch.zeros((b, cfg.num_heads, s, s), device=ids.device,
                               requires_grad=True) for _ in range(cfg.num_layers)]
        logits, probs = _lrp_layers(cfg, params, ids, offsets, True)
        seed, tokens = logits[:, -1, :].max(dim=-1)
        grads = torch.autograd.grad(seed, offsets, grad_outputs=seed.detach())
    rel = torch.stack([(p.detach() * g).sum(dim=(0, 2, 3)) for p, g in zip(probs, grads)])
    return (rel, tokens) if with_tokens else rel


def run_relevance_extraction(
    cfg: ModelConfig,
    params,
    token_ids: np.ndarray,
    *,
    max_length: int,
    stride: int,
    max_chunks: Optional[int] = None,
    progress=None,
    window_batch: int = 1,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1000,
    metrics_path: Optional[str] = None,
    stats: Optional[dict] = None,
    device="cuda",
) -> np.ndarray:
    """Sliding-window accumulation of head relevance -> (L, H) weights,
    normalized per layer to sum 1: the ``head_weights`` input of
    ``weighted_importance``.

    Up to ``window_batch`` full-length windows run in one backward pass
    (relevance is a plain sum over windows and the seed is per row, so
    batching is exact); host accumulation runs one group behind device
    submission; an axes-validated checkpoint gives exact resume; chunk
    throughput lands in ``stats`` (pass a dict) and ``metrics_path``.
    ``params`` live on ``device``."""
    from ..eval.harness import ResumableDriver, _emit, _iter_window_groups, _run_pipelined

    device = torch.device(device)
    axes = {"experiment": "relevance",
            "model": {"family": cfg.family, "num_layers": cfg.num_layers,
                      "hidden_size": cfg.hidden_size, "num_heads": cfg.num_heads,
                      "vocab_size": cfg.vocab_size},
            "max_length": int(max_length), "stride": int(stride)}
    rd = ResumableDriver(checkpoint_path, axes, checkpoint_every)
    total = (np.asarray(rd.state["total"]) if rd.state is not None
             else np.zeros((cfg.num_layers, cfg.num_heads)))

    def submit_group(group):
        ids = torch.from_numpy(np.concatenate([c.input_ids for c in group]).astype(np.int64))
        return group, chunk_relevance(cfg, params, ids.to(device))

    def drain_group(rec):
        group, dev = rec
        total[...] += dev.cpu().numpy().astype(np.float64)
        if progress:
            progress(group[-1].index)
        if rd.advance(group):
            rd.save({"total": total.tolist()})
            _emit(metrics_path, {"chunk": group[-1].index, "chunks": rd.chunks,
                                 "it_per_s": rd.chunks / max(rd.wall(), 1e-9)})

    _run_pipelined(
        _iter_window_groups(token_ids, max_length, stride,
                            window_batch=window_batch,
                            start_chunk=rd.start_chunk,
                            max_count=rd.remaining(max_chunks)),
        submit_group, drain_group, device)
    wall = rd.wall()  # cumulative across resumes
    rd.save({"total": total.tolist()})
    if stats is not None:
        stats.update(chunks=rd.chunks, wall_s=wall,
                     it_per_s=rd.chunks / max(wall, 1e-9))
    _emit(metrics_path, {"final": True, "chunks": rd.chunks, "wall_s": wall,
                         "it_per_s": rd.chunks / max(wall, 1e-9)})
    layer_sum = total.sum(axis=1, keepdims=True)
    denom = np.where(layer_sum != 0, layer_sum, 1e-9)
    return total / denom
