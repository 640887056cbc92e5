"""Transformer core shared by the GPT-NeoX (Pythia), Qwen2 and Llama families,
forward and decode halves: PyTorch counterpart of
``edgellm_tpu/models/transformer.py``. The decode half (``KVCache``,
``prefill``, ``decode_step``, ``block_verify``) writes new cache rows in
place where the reference returns new arrays.

Parameters are a plain dict of tensors, weights in the ``x @ W`` (in, out)
layout, with ``params["layers"]`` one dict per layer for every family: the
layer loop reads ``layers[i]`` and a stage ``layers[a:b]``. The JAX package
and the checkpoints stack each layer weight along a leading (L, ...) axis;
:func:`layer_list`, the one place that knows that layout, turns such a
stack into per-layer views of the same tensors, and the producers and entry
points (:func:`init_params`, :func:`params_to`, the loaders, the long-lived
holders) call it, so one set of weights drives both packages
(``convert.params_from_jax_numpy``). Each block takes its layer's kind
from the config: a gated short convolution or attention as the mixer
(``layer_types``), sparse experts (``models/moe.py``) or the MLP as the FFN
(``is_moe_layer``). Attention statistics name the layers their rows hold
(:class:`AttnStats`), so a consumer finds a layer's row without knowing the
family.

The same forward captures the reduced attention statistics the importance
metrics read (per-head column means and last rows), through the K-stats
kernel on the card (``flash_attention.causal_attention_stats``), so no second
model and no (S, S) attention map in device memory. A
``boundary_fn(layer_idx, hidden) -> hidden`` hook sits after each block, the
reference's ``if i == layer_of_interest`` edit point. Every weight product
goes through :func:`linear`: on the card the fp32 ones take the 3xTF32 GEMM
(``gemm.py``) over planes :func:`prepared_planes` keeps beside the weights.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from ..lint import graph_contract
from ..obs.tracing import device_span
from . import gemm, moe
from .configs import ModelConfig
from .flash_attention import (attention_plain, causal_attention,
                              causal_attention_plain, causal_attention_stats,
                              decode_attention, kernel_plan, verify_attention)


class AttnStats(NamedTuple):
    """Per-layer reduced attention statistics.

    col_mean: (L, B, H, S) fp32 — mean over the query axis of the post-softmax
        attention map (the attention each key position receives, per head).
    last_row: (L, B, H, S) fp32 — final query row of the attention map.
    layers: the layer each row holds (a dense model's segment [a, b) holds
        a .. b - 1; a hybrid's only its attention layers).
    """

    col_mean: torch.Tensor
    last_row: torch.Tensor
    layers: tuple

    def row(self, layer: int) -> int:
        """The row holding ``layer``'s statistics; a ValueError for a layer
        without any (a convolution layer of a hybrid)."""
        if layer not in self.layers:
            raise ValueError(f"layer {layer} has no attention statistics: it is not an "
                             f"attention layer (attention layers here: {list(self.layers)})")
        return self.layers.index(layer)


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


#: root weight tensor -> {the weight's view: (its version when prepared, the
#: planes)}, for :func:`prepared_planes`
_PLANES = WeakTensorKeyDictionary()


def prepared_planes(w: torch.Tensor) -> tuple[gemm.Planes, int]:
    """The 3xTF32 kernel's planes of weight ``w`` (K, N) and the plane row of
    its first column -> (planes, n0). The one place the model prepares
    planes: once per weight per process, at the weight's first fp32 product
    on the card (a run's warm-up), never again while the weight is unchanged.

    Planes are kept beside the weight's root tensor (``w._base``, weakly:
    they go with the weights) and rebuilt when its ``_version`` has moved,
    so an in-place change to a weight is never read through stale planes. A
    K-major ``w`` whose columns are a row range of a 2-D (R, K) root (the
    tied head ``embed.T`` and its vocab blocks ``embed[a:b].T``) reads the
    root's planes, prepared once for every block, at its first row; any
    other view (a layer's (in, out) matrix in the stacked weights) has
    planes of its own."""
    k, _ = w.shape
    root = w if w._base is None else w._base
    if (w.stride(0) == 1 and w.stride(1) == k and root.dim() == 2
            and root.is_contiguous() and root.shape[1] == k):
        key, src, n0 = "rows", root, (w.storage_offset() - root.storage_offset()) // k
    else:
        key, src, n0 = (w.storage_offset(), tuple(w.shape), tuple(w.stride())), w.T, 0
    # an inference-mode tensor tracks no version: it is prepared once
    version = None if w.is_inference() else w._version
    kept = _PLANES.setdefault(root, {})
    hit = kept.get(key)
    if hit is None or hit[0] != version:
        hit = kept[key] = (version, gemm.prepare_planes(src))
    return hit[1], n0


def prepared_grouped_planes(w: torch.Tensor, glu: bool = False) -> gemm.GroupedPlanes:
    """The grouped kernel's planes of experts' weights ``w`` (E, K, N)
    (``glu``: a gate / up weight, for the silu(gate) * up epilogue), kept
    as :func:`prepared_planes` keeps a weight's: once per weight per
    process, rebuilt when the weight's ``_version`` moves."""
    root = w if w._base is None else w._base
    key = ("grouped", glu, w.storage_offset(), tuple(w.shape), tuple(w.stride()))
    version = None if w.is_inference() else w._version
    kept = _PLANES.setdefault(root, {})
    hit = kept.get(key)
    if hit is None or hit[0] != version:
        hit = kept[key] = (version, gemm.prepare_grouped_planes(w, glu))
    return hit[1]


#: root tensor -> {(a view's geometry, what was made of it): (the root's
#: version, the result's version, the result)}, for :func:`made_once`
_MADE = WeakTensorKeyDictionary()


def made_once(src: torch.Tensor, key: tuple, make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()``, a tensor made from ``src`` (a promoted or moved copy, a
    tensor-parallel cut), kept beside ``src``'s root and returned again for
    the same ``key`` while neither the root nor the result has changed. So
    a weight copied anew at every placement keeps one copy, and the GEMM
    planes of it (:func:`prepared_planes`) are prepared once a process. A
    result that shares the root's storage (a view, made for nothing) is not
    kept, nor an inference-mode source or result (no version to check)."""
    root = src if src._base is None else src._base
    if root.is_inference():
        return make()
    key = (src.storage_offset(), tuple(src.shape), tuple(src.stride())) + key
    kept = _MADE.setdefault(root, {})
    hit = kept.get(key)
    if hit is not None and hit[:2] == (root._version, hit[2]._version):
        return hit[2]
    made = make()
    if not made.is_inference() \
            and made.untyped_storage().data_ptr() != root.untyped_storage().data_ptr():
        kept[key] = (root._version, made._version, made)
    return made


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N): fp32 CUDA operands of at least
    ``gemm.MIN_ROWS`` rows and ``gemm.MIN_TILES`` output tiles take the
    3xTF32 kernel (``gemm.gemm_tf32x3``, over :func:`prepared_planes`);
    every other product keeps ``torch.matmul``, counted by reason in
    ``linear.routed`` ("cpu", "bf16", "small_m": ``gemm.route``)."""
    k, n = w.shape
    rows = x.numel() // x.shape[-1]
    reason = gemm.route(x.device.type, x.dtype, w.dtype, rows, n)
    if reason is not None:
        linear.routed[reason] += 1
        return x @ w
    planes, n0 = prepared_planes(w)
    return gemm.gemm_tf32x3(x.reshape(rows, k), planes, n0, n).reshape(*x.shape[:-1], n)


linear.routed = {"small_m": 0, "cpu": 0, "bf16": 0}


def project_qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor):
    """(B, S, D) -> pre-rotary q (B, S, H, hd), k and v (B, S, KV, hd); head
    counts come from the weight shapes."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h, kv = lp["wq"].shape[-1] // hd, lp["wk"].shape[-1] // hd
    q = linear(x, lp["wq"]).reshape(b, s, h, hd)
    k = linear(x, lp["wk"]).reshape(b, s, kv, hd)
    v = linear(x, lp["wv"]).reshape(b, s, kv, hd)
    if "bq" in lp:
        q = q + lp["bq"].reshape(h, hd)
        k = k + lp["bk"].reshape(kv, hd)
        v = v + lp["bv"].reshape(kv, hd)
    return q, k, v


def project_out(lp: dict, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) attention output -> (B, S, D): output projection + bias."""
    out = _out_partial(lp, out)
    return out + lp["bo"] if "bo" in lp else out


def _out_partial(lp: dict, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, D) through ``wo``, before the bias: a
    tensor-parallel shard's partial product of its local heads."""
    b, s = out.shape[:2]
    return linear(out.reshape(b, s, -1), lp["wo"])


def attention(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin,
              capture_stats: bool, stats_block: Optional[int] = None,
              return_kv: bool = False):
    """Causal self-attention with optional reduced-stat capture -> (out, stats)
    or, with ``return_kv``, (out, stats, (k, v)): the post-rotary K/V at
    ``num_kv_heads`` width that a prefill fills the decode cache from.

    Shapes inside :func:`~.flash_attention.kernel_plan`'s envelope go through
    the kernels' wrappers (K-attn without stats, K-stats with them; the CPU
    takes their plain versions); other shapes, and every call with an
    explicit ``stats_block``, take the eager formulation, whose
    ``stats_block=0`` single block is the oracle in tests. Stats are
    (col_sum / S, last_row), each (B, H, S) fp32."""
    out, stats, kv = _attention_core(cfg, lp, x, cos, sin, capture_stats, stats_block)
    out = project_out(lp, out)
    return (out, stats, kv) if return_kv else (out, stats)


def _attention_core(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin,
                    capture_stats: bool = False, stats_block: Optional[int] = None):
    """:func:`attention` before its output projection -> ((B, S, H, hd) out,
    stats or None, post-rotary (k, v)). Head counts come from the weight
    shapes, so a tensor-parallel shard attends over its own heads."""
    s = x.shape[1]
    q, k, v = project_qkv(cfg, lp, x)
    h, kv, hd = q.shape[2], k.shape[2], cfg.head_dim
    if cfg.hybrid:  # lfm2_moe: RMSNorm over each head's dims, before RoPE
        q = _rmsnorm(q, lp["q_norm"], cfg.norm_eps)
        k = _rmsnorm(k, lp["k_norm"], cfg.norm_eps)
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
    return out, stats, (k, v)


def mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """GELU (exact) MLP for gpt_neox, SwiGLU for qwen2/llama."""
    out = _mlp_partial(cfg, lp, x)
    return out + lp["b_out"] if cfg.family == "gpt_neox" else out


def _mlp_partial(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """The MLP's down projection before its output bias: a tensor-parallel
    shard's partial product of its own F columns."""
    if cfg.family == "gpt_neox":
        return linear(F.gelu(linear(x, lp["w_in"]) + lp["b_in"], approximate="none"),
                      lp["w_out"])
    return linear(F.silu(linear(x, lp["w_gate"])) * linear(x, lp["w_up"]), lp["w_down"])


def short_conv(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """LFM2's gated short convolution (``Lfm2ShortConv``): ``[B, C, x'] =
    split3(x conv_in)``, ``y = C * conv(B * x')``, the result ``y conv_out``;
    ``conv`` a causal depthwise convolution over time of ``conv_w`` (taps,
    D): position t sees t - taps + 1 .. t of its own row, zeros before it,
    channels apart, no bias. The split, the gates and the taps run inside
    the ``mix.conv`` span; the projections take :func:`linear`."""
    bcx = linear(x, lp["conv_in"])
    w = lp["conv_w"]
    taps, s = w.shape[0], x.shape[1]
    with device_span("mix.conv", x.device):
        b, c, xx = bcx.chunk(3, dim=-1)
        bx = b * xx
        y = bx * w[taps - 1]
        for j in range(1, taps):  # tap taps - 1 - j reads position t - j
            y = y + F.pad(bx, (0, 0, j, 0))[:, :s] * w[taps - 1 - j]
        y = c * y
    return linear(y, lp["conv_out"])


def _block_norm(cfg: ModelConfig, lp: dict, x: torch.Tensor, n: int) -> torch.Tensor:
    """The block's n-th pre-norm (1: attention, 2: MLP)."""
    if cfg.family == "gpt_neox":
        return _layernorm(x, lp[f"ln{n}_scale"], lp[f"ln{n}_bias"], cfg.norm_eps)
    return _rmsnorm(x, lp[f"ln{n}_scale"], cfg.norm_eps)


def block_with(cfg: ModelConfig, lp: dict, hidden: torch.Tensor, attn: Callable,
               ffn: Optional[Callable] = None):
    """One decoder block around an attention core: ``attn(normed)`` returns
    ``(attn_out, *extra)`` -> (hidden, *extra). GPT-NeoX: parallel residual;
    Qwen2/Llama: sequential. The prefill, decode, verify and paged blocks
    differ only in their attention core; ``ffn(normed)`` replaces the MLP
    (the tensor-parallel block's)."""
    ffn = ffn if ffn is not None else (lambda x: mlp(cfg, lp, x))
    attn_out, *extra = attn(_block_norm(cfg, lp, hidden, 1))
    if cfg.family == "gpt_neox":
        return (hidden + attn_out + ffn(_block_norm(cfg, lp, hidden, 2)), *extra)
    hidden = hidden + attn_out
    return (hidden + ffn(_block_norm(cfg, lp, hidden, 2)), *extra)


def block(cfg: ModelConfig, idx: int, lp: dict, hidden: torch.Tensor, cos, sin,
          capture_stats: bool, stats_block: Optional[int] = None,
          return_kv: bool = False):
    """Layer ``idx``'s decoder block -> (hidden, stats[, (k, v)]). A hybrid
    layer's kind is the config's: a convolution mixer where
    ``cfg.layer_types`` says "conv" (stats None), else attention; sparse
    experts where ``cfg.is_moe_layer``, else the MLP."""
    ffn = (lambda x: moe.moe_ffn(cfg, lp, x, prepared_grouped_planes, linear)) \
        if cfg.is_moe_layer(idx) else None
    if cfg.hybrid and cfg.layer_types[idx] == "conv":
        return block_with(cfg, lp, hidden, lambda x: (short_conv(cfg, lp, x), None), ffn)
    return block_with(cfg, lp, hidden, lambda x: attention(
        cfg, lp, x, cos, sin, capture_stats, stats_block, return_kv), ffn)


#: the column-split weights of the tensor-parallel block (the first matmul of
#: each Megatron pair: q / k / v head-contiguous, the MLP's up / gate
#: F-contiguous) and the row-split ones (the second, whose partial products
#: are summed); every other layer weight is replicated on each shard
TP_COL_SPLIT = frozenset({"wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up", "w_in", "b_in"})
TP_ROW_SPLIT = frozenset({"wo", "w_down", "w_out"})


def tp_shard_layers(layers: list, n_model: int) -> list:
    """Per-layer dicts -> each layer's ``n_model`` shard dicts:
    column-split weights cut along their last (output-feature) axis,
    row-split ones along their first (input-feature) axis, each cut
    contiguous: a copy made once while its source is unchanged
    (:func:`made_once`), or a view where the cut already is (a row cut, a
    bias); the rest shared by every shard."""
    def cut(name: str, t: torch.Tensor, m: int) -> torch.Tensor:
        axis = -1 if name in TP_COL_SPLIT else 0
        width = t.shape[axis] // n_model
        return made_once(t, ("tp", axis, n_model, m),
                         lambda: t.narrow(axis, m * width, width).contiguous())

    return [[{name: (cut(name, t, m) if name in TP_COL_SPLIT | TP_ROW_SPLIT else t)
              for name, t in lp.items()} for m in range(n_model)] for lp in layers]


def tp_sum(partials: list) -> torch.Tensor:
    """The row-split partial products summed in shard order, in their own
    dtype: the reference's ``psum`` over the "model" axis."""
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    return total


def block_tp(cfg: ModelConfig, shards: list, hidden: torch.Tensor, cos, sin) -> torch.Tensor:
    """One decoder block over its ``n_model`` tensor-parallel shards (one
    layer's shard dicts, :func:`tp_shard_layers`): each shard attends over
    its local heads (K-attn on the card) and multiplies by its rows of
    ``wo``; the partial products are summed (:func:`tp_sum`) and ``bo``
    added once. The MLP pairs the same way, ``b_out`` added after the sum.
    The shards run in turn on one device."""
    lp = shards[0]

    def attn(x):
        out = tp_sum([_out_partial(s, _attention_core(cfg, s, x, cos, sin)[0]) for s in shards])
        return (out + lp["bo"] if "bo" in lp else out,)

    def ffn(x):
        out = tp_sum([_mlp_partial(cfg, s, x) for s in shards])
        return out + lp["b_out"] if cfg.family == "gpt_neox" else out

    return block_with(cfg, lp, hidden, attn, ffn)[0]


def run_layers_tp(cfg: ModelConfig, layers: list, hidden: torch.Tensor) -> torch.Tensor:
    """Every layer of a stage over ``hidden``, each as its tensor-parallel
    shard dicts (:func:`tp_shard_layers`, :func:`block_tp`) -> the stage's
    output hidden."""
    cos, sin = precompute_rope(cfg, hidden.shape[1], device=hidden.device)
    for shards in layers:
        hidden = block_tp(cfg, shards, hidden, cos, sin)
    return hidden


def layer_list(layers) -> list:
    """A model's layers as one dict per layer: per-layer dicts as they are,
    a stacked dict ((L, ...) tensors: the JAX package's and the
    checkpoints' layout) as views ``t[i]`` of its tensors, no copy. The one
    place that knows the stacked layout."""
    if not isinstance(layers, dict):
        return layers
    n = len(next(iter(layers.values())))
    return [{name: t[i] for name, t in layers.items()} for i in range(n)]


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(input_ids, params["embed"])


def _final_norm(cfg: ModelConfig, params: dict, hidden: torch.Tensor):
    return _norm(cfg, hidden, params["final_norm_scale"],
                 params.get("final_norm_bias", 0.0))


def head_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, D) @ (D, V) -> fp32 (N, V), the reference's dot with
    ``preferred_element_type=float32``. On the card, bf16 operands go to a
    bf16 tensor-core GEMM with fp32 accumulation and fp32 output
    (``aten::mm.dtype``): a bf16 x bf16 product is exact in fp32, so it sums
    the same terms as the widened product in another order, and the logits
    are never rounded to bf16; a fp32 hidden against a bf16 head, which the
    reference promotes, takes cuBLAS's widened fp32 product (both counted
    "bf16" in ``linear.routed``). fp32 operands and every CPU tensor go
    through :func:`linear` (the 3xTF32 kernel on the card)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        linear.routed["bf16"] += 1
        return torch.mm(a, b, out_dtype=torch.float32)
    if a.is_cuda and not a.dtype == b.dtype == torch.float32:
        linear.routed["bf16"] += 1
        return a.float() @ b.float()
    return linear(a.float(), b.float())


def unembed(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head -> fp32 logits (:func:`head_matmul`)."""
    post = _final_norm(cfg, params, hidden)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return head_matmul(post.reshape(-1, post.shape[-1]), head).reshape(
        *post.shape[:-1], head.shape[-1])


def run_layers(cfg: ModelConfig, params: dict, hidden: torch.Tensor, *,
               start: int = 0, stop: Optional[int] = None, first: int = 0,
               boundary_fn: Optional[Callable] = None,
               capture_stats: bool = False,
               collect_hidden: bool = False,
               collect_kv: bool = False,
               stats_block: Optional[int] = None):
    """Run decoder layers [start, stop) over ``hidden`` -> (hidden, aux).

    ``params["layers"]`` holds layers ``first`` onwards (a pipeline stage's
    from its own first layer, the whole model's from 0); ``boundary_fn``
    receives the global layer index and the post-block hidden state. aux
    holds ``"stats"`` with ``capture_stats`` (:class:`AttnStats`, (L, B, H,
    S) each, one row per attention layer of the segment, ``layers`` naming
    them; None where the segment has none), ``"hiddens"`` ((L, B, S, D),
    post-boundary_fn) with ``collect_hidden``, and ``"kv"`` ((k, v), each
    (L, B, S, KV, hd), the post-rotary K/V a decode cache is prefilled from)
    with ``collect_kv``."""
    stop = cfg.num_layers if stop is None else stop
    if not (0 <= start <= stop <= cfg.num_layers):
        raise ValueError(
            f"layer segment [{start}, {stop}) out of range for {cfg.num_layers} layers")
    if collect_kv:
        cfg.require_uniform("a K/V cache prefill")
    cos, sin = precompute_rope(cfg, hidden.shape[1], device=hidden.device)
    layers = layer_list(params["layers"])[start - first:stop - first]
    cols, lasts, rows, hiddens, ks, vs = [], [], [], [], [], []
    for idx, lp in enumerate(layers, start):
        hidden, stats, *kv = block(cfg, idx, lp, hidden, cos, sin, capture_stats,
                                   stats_block, collect_kv)
        if collect_kv:
            ks.append(kv[0][0])
            vs.append(kv[0][1])
        if boundary_fn is not None:
            hidden = boundary_fn(idx, hidden)
        if capture_stats and stats is not None:
            cols.append(stats[0])
            lasts.append(stats[1])
            rows.append(idx)
        if collect_hidden:
            hiddens.append(hidden)
    aux = {}
    if capture_stats:
        aux["stats"] = AttnStats(col_mean=torch.stack(cols), last_row=torch.stack(lasts),
                                 layers=tuple(rows)) if rows else None
    if collect_hidden:
        aux["hiddens"] = torch.stack(hiddens)
    if collect_kv:
        aux["kv"] = (torch.stack(ks), torch.stack(vs))
    return hidden, aux


def _cast_params(params: dict, compute_dtype) -> dict:
    """Floating tensors cast to ``compute_dtype`` (None keeps them as
    stored), the layers one dict each (:func:`layer_list`)."""
    if compute_dtype is None:
        return {**params, "layers": layer_list(params["layers"])}
    return params_to(params, dtype=compute_dtype)


def params_to(params: dict, device=None, dtype=None) -> dict:
    """The parameter dict with every tensor moved to ``device`` and every
    floating tensor cast to ``dtype`` (None keeps either as it is), the
    layers one dict each (:func:`layer_list`)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return t.to(device=device,
                    dtype=dtype if dtype is not None and t.is_floating_point() else None)

    out = conv(params)
    if "layers" in out:  # a partial tree (an embedding alone) has none
        out["layers"] = layer_list(out["layers"])
    return out


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


# ---------------------------------------------------------------------------
# KV-cached incremental decode: prefill fills the cache for the prompt, then
# decode_step appends one position per call.
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer key/value cache for incremental decode.

    k, v: (L, B, capacity, KV, hd) post-rotary keys/values at
        ``num_kv_heads`` width (the decode attention re-broadcasts them per
        query group).
    length: number of valid positions, the next write slot (a host int).

    Unlike the reference's immutable arrays, :func:`decode_step` and
    :func:`block_verify` write the new rows into ``k``/``v`` in place and
    return a cache over the same tensors."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype: torch.dtype = torch.float32, device="cuda") -> KVCache:
    """An empty cache for ``batch`` sequences of up to ``capacity`` tokens."""
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def cache_state_dict(cache) -> dict:
    """A decode cache (a :class:`KVCache` or a ``{"k", "v", "length"}``
    dict) as host numpy arrays keyed ``k``/``v``/``length``."""
    if isinstance(cache, dict):
        k, v, length = cache["k"], cache["v"], cache["length"]
    else:
        k, v, length = cache.k, cache.v, cache.length
    host = lambda t: (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return {"k": host(k), "v": host(v), "length": np.asarray(int(length), np.int32)}


def cache_from_state_dict(state: dict, device="cuda") -> dict:
    """:func:`cache_state_dict` output back on ``device`` as the
    ``{"k", "v", "length"}`` dict (wrap in :class:`KVCache` for
    :func:`decode_step`)."""
    return {"k": torch.from_numpy(np.array(state["k"])).to(device),
            "v": torch.from_numpy(np.array(state["v"])).to(device),
            "length": int(state["length"])}


@graph_contract("transformer.prefill", hops=0,
                launches=lambda ctx: {"causal_attention": ctx["layers"]})
def prefill(cfg: ModelConfig, params: dict, input_ids: torch.Tensor, capacity: int, *,
            boundary_fn: Optional[Callable] = None,
            compute_dtype: Optional[torch.dtype] = None):
    """Full forward over the prompt that also fills the decode cache ->
    (logits (B, S, V) fp32, :class:`KVCache` with length S and the given
    ``capacity``, in the compute dtype)."""
    s = input_ids.shape[1]
    if not 0 < s <= capacity:
        raise ValueError(f"prompt length {s} must be in [1, capacity={capacity}]")
    params = _cast_params(params, compute_dtype)
    hidden, aux = run_layers(cfg, params, embed(params, input_ids),
                             boundary_fn=boundary_fn, collect_kv=True)
    logits = unembed(cfg, params, hidden)
    k, v = aux["kv"]  # (L, B, S, KV, hd) each
    shape = k.shape[:2] + (capacity,) + k.shape[3:]
    kc = k.new_zeros(shape)
    vc = v.new_zeros(shape)
    kc[:, :, :s] = k
    vc[:, :, :s] = v
    return logits, KVCache(kc, vc, s)


def _attention_decode(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos_t, sin_t,
                      k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int):
    """One layer's attention for one decode position: project the (B, 1, D)
    hidden, rotate at ``pos``, write the new K/V into this layer's
    (B, capacity, KV, hd) cache in place, attend against the first ``pos + 1``
    positions -> (out,)."""
    q, k, v = project_qkv(cfg, lp, x)
    q = apply_rotary(q, cos_t, sin_t, cfg.rotary_dim)
    k = apply_rotary(k, cos_t, sin_t, cfg.rotary_dim)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    return (project_out(lp, decode_attention(q, k_cache, v_cache, pos + 1)),)


def block_decode(cfg: ModelConfig, lp: dict, hidden: torch.Tensor, cos_t, sin_t,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """The cache-writing twin of :func:`block` for one decode position."""
    return block_with(cfg, lp, hidden, lambda x: _attention_decode(
        cfg, lp, x, cos_t, sin_t, k_cache, v_cache, pos))[0]


def _attention_verify(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos_t, sin_t,
                      k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int):
    """The K-position twin of :func:`_attention_decode`: rotate the (B, K, D)
    block at positions ``pos .. pos+K-1``, write its K rows into the cache
    in place, attend causally against the filled prefix -> (out,)."""
    kq = x.shape[1]
    q, k, v = project_qkv(cfg, lp, x)
    q = apply_rotary(q, cos_t, sin_t, cfg.rotary_dim)
    k = apply_rotary(k, cos_t, sin_t, cfg.rotary_dim)
    k_cache[:, pos:pos + kq] = k.to(k_cache.dtype)
    v_cache[:, pos:pos + kq] = v.to(v_cache.dtype)
    return (project_out(lp, verify_attention(q, k_cache, v_cache, pos)),)


def block_verify(cfg: ModelConfig, lp: dict, hidden: torch.Tensor, cos_t, sin_t,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """The cache-writing twin of :func:`block` for a K-position block (the
    suffix prefill of a prefix-sharing admit)."""
    return block_with(cfg, lp, hidden, lambda x: _attention_verify(
        cfg, lp, x, cos_t, sin_t, k_cache, v_cache, pos))[0]


@graph_contract("transformer.decode_step", hops=0, launches={})
def decode_step(cfg: ModelConfig, params: dict, cache: KVCache, token_ids: torch.Tensor, *,
                boundary_fn: Optional[Callable] = None,
                compute_dtype: Optional[torch.dtype] = None):
    """Append one position: (B,) or (B, 1) token ids -> (logits (B, V) fp32,
    cache with length + 1; the new rows are written in place). The RoPE
    tables cover the capacity and the row at ``cache.length`` is used."""
    cfg.require_uniform("decode_step")
    params = _cast_params(params, compute_dtype)
    if token_ids.dim() == 1:
        token_ids = token_ids[:, None]
    hidden = embed(params, token_ids)  # (B, 1, D)
    pos = int(cache.length)
    cos, sin = precompute_rope(cfg, cache.capacity, device=hidden.device)
    cos_t, sin_t = cos[pos:pos + 1], sin[pos:pos + 1]
    for idx, lp in enumerate(params["layers"]):
        hidden = block_decode(cfg, lp, hidden, cos_t, sin_t, cache.k[idx], cache.v[idx], pos)
        if boundary_fn is not None:
            hidden = boundary_fn(idx, hidden)
    logits = unembed(cfg, params, hidden)[:, -1]
    return logits, KVCache(cache.k, cache.v, pos + 1)


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
    """Streaming cross-entropy: final norm -> per-block fp32 logits
    (:func:`head_matmul`) -> online (max, sum of exp, target logit). Head
    blocks are views of the head in its own layout (no transpose copy of a
    tied embedding, no fp32 copy of a bf16 block on the card)."""
    b, t, d = hidden.shape
    post = _final_norm(cfg, params, hidden).reshape(b * t, d)
    n = b * t
    tgt = targets.reshape(n)
    valid = tgt != -100
    safe_tgt = torch.where(valid, tgt, 0)
    m = torch.full((n,), -torch.inf, dtype=torch.float32, device=hidden.device)
    s_acc = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    t_logit = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    for i in range(cfg.vocab_size // vb):
        if cfg.tie_word_embeddings:
            piece = head_matmul(post, params["embed"][i * vb:(i + 1) * vb].T)
        else:
            piece = head_matmul(post, params["lm_head"][:, i * vb:(i + 1) * vb])
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

    if cfg.hybrid:
        return _init_hybrid(cfg, init, const, generator, dtype, device)
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
    params = {"embed": init(cfg.vocab_size, D), "layers": layer_list(layers),
              "final_norm_scale": const(1.0, D)}
    if cfg.family == "gpt_neox":
        params["final_norm_bias"] = const(0.0, D)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init(D, cfg.vocab_size)
    return params


def _init_hybrid(cfg: ModelConfig, init, const, generator, dtype, device) -> dict:
    """:func:`init_params` for a hybrid family: one dict a layer, with the
    conv taps drawn as PyTorch's Conv1d draws them (U(+-1 / sqrt(taps)))
    and the expert bias at 0."""
    D, Fd, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    E, Fe = cfg.num_experts, cfg.moe_intermediate_size
    bound = 1.0 / math.sqrt(cfg.conv_kernel)
    layers = []
    for i, kind in enumerate(cfg.layer_types):
        lp = {"ln1_scale": const(1.0, D), "ln2_scale": const(1.0, D)}
        if kind == "conv":
            taps = torch.rand((cfg.conv_kernel, D), generator=generator, dtype=torch.float32,
                              device=device) * (2 * bound) - bound
            lp.update(conv_in=init(D, 3 * D), conv_w=taps.to(dtype), conv_out=init(D, D))
        else:
            lp.update(wq=init(D, cfg.num_heads * hd), wk=init(D, cfg.num_kv_heads * hd),
                      wv=init(D, cfg.num_kv_heads * hd), wo=init(cfg.num_heads * hd, D),
                      q_norm=const(1.0, hd), k_norm=const(1.0, hd))
        if cfg.is_moe_layer(i):
            lp.update(router=init(D, cfg.router_experts),
                      expert_bias=const(0.0, cfg.router_experts),
                      w13=init(E, D, 2 * Fe), w2=init(E, Fe, D))
        else:
            lp.update(w_gate=init(D, Fd), w_up=init(D, Fd), w_down=init(Fd, D))
        layers.append(lp)
    return {"embed": init(cfg.vocab_size, D), "layers": layers,
            "final_norm_scale": const(1.0, D)}
