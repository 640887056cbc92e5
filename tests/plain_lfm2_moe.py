"""A plain LFM2-MoE forward for the tests: PyTorch alone, in float32, no
kernels, no cache, no batching, the attention map written out. It imports
nothing of the port and no JAX. It follows Liquid AI's ``Lfm2Moe`` as Hugging
Face transformers' ``modeling_lfm2_moe.py`` writes it:

- block: ``h = x + mixer(RMSNorm(x))``, ``out = h + ffn(RMSNorm(h))``;
  RMSNorm(x) = x / sqrt(mean(x^2) + eps) * scale; the final RMSNorm after
  the last layer, then the LM head, tied to the embedding.
- conv mixer: ``[B, C, x'] = split3(n W_in)``, ``y = C * conv(B * x')``,
  ``conv`` causal and depthwise over time (``Conv1d(D, D, taps, groups=D,
  padding=taps - 1)`` cut to the sequence), no bias; output ``y W_out``.
- attention mixer: q, k, v without bias, RMSNorm over each head's dims on
  q and k, then RoPE (full rotary), causal GQA, ``W_o``.
- dense FFN (the first ``num_dense_layers``): ``w2(silu(w1 n) * w3 n)``.
- sparse FFN: ``s = sigmoid(n W_r)`` over all routed experts; the top k on
  ``s + expert_bias``; weights ``s`` there over (their sum + 1e-6), times the
  routed scale; each picked expert adds ``w * w2_e(silu(w1_e n) * w3_e n)``.

Departures: the layer computes only the experts it holds (ids ``offset`` ..
``offset + E - 1``, E the weights' first axis), one card's share of expert
parallelism; gate and up are one (D, 2F) matrix; the taps are (taps, D).

Weights are the port's layout (a list of per-layer dicts, ``x @ W``), so
one set drives both; the configuration is a plain dict.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(s, hd, theta):
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd))
    ang = torch.outer(torch.arange(s, dtype=torch.float32), inv)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None, :] + rot * sin[None, :, None, :]


def conv_mixer(lp, n):
    d, s = n.shape[-1], n.shape[1]
    bcx = n @ lp["conv_in"]
    b, c, x = bcx[..., :d], bcx[..., d:2 * d], bcx[..., 2 * d:]
    taps = lp["conv_w"].shape[0]
    y = F.conv1d((b * x).transpose(1, 2), lp["conv_w"].T[:, None, :], padding=taps - 1,
                 groups=d)[..., :s].transpose(1, 2)
    return (c * y) @ lp["conv_out"]


def attention(cfg, lp, n, stats):
    b, s, _ = n.shape
    h, kv, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    q = (n @ lp["wq"]).reshape(b, s, h, hd)
    k = (n @ lp["wk"]).reshape(b, s, kv, hd)
    v = (n @ lp["wv"]).reshape(b, s, kv, hd)
    q, k = rms(q, lp["q_norm"], cfg["eps"]), rms(k, lp["k_norm"], cfg["eps"])
    cos, sin = rope(s, hd, cfg["theta"])
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    kh = k.repeat_interleave(h // kv, dim=2).permute(0, 2, 3, 1)
    vh = v.repeat_interleave(h // kv, dim=2).permute(0, 2, 1, 3)
    scores = q.permute(0, 2, 1, 3) @ kh / math.sqrt(hd)
    pos = torch.arange(s)
    probs = torch.softmax(scores.masked_fill(pos[None, :] > pos[:, None], -math.inf), dim=-1)
    st = (probs.sum(dim=2) / s, probs[:, :, -1, :]) if stats else None
    out = (probs @ vh).permute(0, 2, 1, 3).reshape(b, s, h * hd)
    return out @ lp["wo"], st


def route(cfg, lp, n2):
    """n2 (T, D) -> (weights (T, k), picked experts (T, k))."""
    s = torch.sigmoid(n2 @ lp["router"])
    _, picked = torch.topk(s + lp["expert_bias"], cfg["top_k"], dim=-1)
    w = torch.gather(s, 1, picked)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
    return w * cfg["scale"], picked


def experts(cfg, lp, n, offset):
    """The held experts' part of the routed sum (no capacity)."""
    n2 = n.reshape(-1, n.shape[-1])
    w, picked = route(cfg, lp, n2)
    out = torch.zeros_like(n2)
    f = lp["w2"].shape[1]
    for e in range(lp["w13"].shape[0]):
        tok, slot = torch.nonzero(picked == offset + e, as_tuple=True)
        h = n2[tok] @ lp["w13"][e]
        y = (F.silu(h[:, :f]) * h[:, f:]) @ lp["w2"][e]
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out.reshape(n.shape)


def block(cfg, i, lp, x, stats=False, offset=0):
    n = rms(x, lp["ln1_scale"], cfg["eps"])
    if cfg["layer_types"][i] == "conv":
        out, st = conv_mixer(lp, n), None
    else:
        out, st = attention(cfg, lp, n, stats)
    x = x + out
    n = rms(x, lp["ln2_scale"], cfg["eps"])
    if i < cfg["dense"]:
        ffn = (F.silu(n @ lp["w_gate"]) * (n @ lp["w_up"])) @ lp["w_down"]
    else:
        ffn = experts(cfg, lp, n, offset)
    return x + ffn, st


def layers(cfg, params, x, start, stop, stats=False, hook=None, offset=0):
    """Blocks [start, stop) -> (x, {attention layer: (column means, last
    row)})."""
    out = {}
    for i in range(start, stop):
        x, st = block(cfg, i, params["layers"][i], x, stats, offset)
        if st is not None:
            out[i] = st
        if hook is not None:
            x = hook(i, x)
    return x, out


def logits(cfg, params, x):
    return rms(x, params["final_norm_scale"], cfg["eps"]) @ params["embed"].T


def forward(cfg, params, ids, stats=False, offset=0):
    x, st = layers(cfg, params, params["embed"][ids], 0, len(cfg["layer_types"]), stats,
                   offset=offset)
    return logits(cfg, params, x), st


def config_of(mc) -> dict:
    """The plain dict of a port config's fields this reference reads."""
    return {"heads": mc.num_heads, "kv_heads": mc.num_kv_heads, "head_dim": mc.head_dim,
            "eps": mc.norm_eps, "theta": mc.rope_theta, "layer_types": mc.layer_types,
            "dense": mc.num_dense_layers, "top_k": mc.num_experts_per_tok,
            "scale": 1.0}
