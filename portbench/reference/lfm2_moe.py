"""A plain LFM2-MoE decoder in float32 (Liquid AI's ``Lfm2Moe``, as
Hugging Face transformers' ``modeling_lfm2_moe.py`` writes it), with the
attention map written out, on the share of experts the configuration
holds. The same interface as ``model.Model`` (``embed``, ``layers(x,
start, stop, stats, hook)``, ``logits``, the "fp32" / "tf32" arithmetics),
and a ``token_sweep`` built on ``sweep.py``'s pieces.

The layer equations (n = RMSNorm(x), RMSNorm(x) = x / sqrt(mean(x^2) +
eps) * scale, eps ``norm_eps``):

- block: ``h = x + mixer(RMSNorm(x))``, ``out = h + ffn(RMSNorm(h))``; after
  the last layer the final RMSNorm, then the LM head, tied to the embedding.
- conv mixer (``layer_types`` "conv"): ``[B, C, x'] = split3(n W_in)``
  (2048 -> 6144, no bias), ``y = C * conv(B * x')`` with ``conv`` the
  causal depthwise convolution of ``conv_L_cache`` taps over time, each
  channel alone, no bias (position t sees t - 2 .. t of its window), and
  the output ``y W_out``.
- attention mixer ("full_attention"): q, k, v projections without bias,
  RMSNorm over each head's dims on q and on k, then RoPE (theta
  ``rope_theta``, full rotary), causal grouped-query attention with the map
  written out, and ``W_o``.
- FFN of the first ``num_dense_layers``: ``w2(silu(w1 n) * w3 n)``.
- FFN of the others: ``s = sigmoid(n W_r)`` over all ``router_experts``; the
  top ``num_experts_per_tok`` on ``s + expert_bias``; weights ``s`` at
  those, divided by (their sum + 1e-6), times ``routed_scaling_factor``;
  each picked expert adds ``w * w2_e(silu(w1_e n) * w3_e n)``; no capacity,
  nothing dropped.

Departures, all shared with the program: only the experts held here
(``num_experts`` of them, ids from ``expert_offset``) are computed, and
what the others would add is left out (one card's share of expert
parallelism); gate and up of an expert are one (D, 2F) matrix, gate first;
the conv taps are a (taps, D) matrix, tap taps - 1 at position t. Weights
are the benchmark's, a list of per-layer dicts in the ``x @ W`` layout
(``weights_lfm2.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .model import arithmetic, mm, window_nll
from .sweep import BATCH, importance, int4_least_important, windows


class Model:
    """The published LFM2-MoE forward over the benchmark's weights."""

    def __init__(self, cfg: dict, weights: dict, arith: str = "fp32"):
        if arith not in ("fp32", "tf32"):
            raise ValueError(f"the LFM2 reference takes fp32 or tf32, not {arith!r}")
        self.cfg, self.w, self.arith = cfg, weights, arith
        self.hd = cfg["head_dim"]
        self.h = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.eps = cfg["norm_eps"]
        #: a list to receive each MoE layer's (T, k) picks, or None
        self.routes = None

    def layer(self, i: int) -> dict:
        return {k: v.float() for k, v in self.w["layers"][i].items()}

    def rope(self, positions: torch.Tensor):
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, self.hd, 2, dtype=torch.float32, device=positions.device)
            / self.hd))
        ang = torch.outer(positions.float(), inv)
        ang = torch.cat([ang, ang], dim=-1)
        return torch.cos(ang), torch.sin(ang)

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.eps) * scale.float()

    @staticmethod
    def _rotate(x, cos, sin):
        half = x.shape[-1] // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return x * cos[None, :, None, :] + rot * sin[None, :, None, :]

    def conv(self, lp: dict, n: torch.Tensor) -> torch.Tensor:
        d = n.shape[-1]
        bcx = mm(n, lp["conv_in"], self.arith)
        b, c, x = bcx[..., :d], bcx[..., d:2 * d], bcx[..., 2 * d:]
        taps = lp["conv_w"].shape[0]
        # Conv1d(groups=D, padding=taps-1) over (B, D, S), cut to S
        y = F.conv1d((b * x).transpose(1, 2), lp["conv_w"].T[:, None, :], padding=taps - 1,
                     groups=d)[..., :n.shape[1]].transpose(1, 2)
        return mm(c * y, lp["conv_out"], self.arith)

    def attend(self, lp: dict, n: torch.Tensor, cos, sin, stats: bool):
        b, s, _ = n.shape
        a = self.arith
        q = mm(n, lp["wq"], a).reshape(b, s, self.h, self.hd)
        k = mm(n, lp["wk"], a).reshape(b, s, self.kv, self.hd)
        v = mm(n, lp["wv"], a).reshape(b, s, self.kv, self.hd)
        q, k = self.norm(q, lp["q_norm"]), self.norm(k, lp["k_norm"])
        q, k = self._rotate(q, cos, sin), self._rotate(k, cos, sin)
        g = self.h // self.kv
        kh = k.repeat_interleave(g, dim=2).permute(0, 2, 3, 1)
        vh = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
        scores = mm(q.permute(0, 2, 1, 3), kh, a) / math.sqrt(self.hd)
        pos = torch.arange(s, device=n.device)
        probs = torch.softmax(scores.masked_fill(pos[None, :] > pos[:, None], -math.inf), dim=-1)
        st = (probs.sum(dim=2) / s, probs[:, :, -1, :]) if stats else None
        out = mm(probs, vh, a).permute(0, 2, 1, 3).reshape(b, s, self.h * self.hd)
        return mm(out, lp["wo"], a), st

    def route(self, lp: dict, n2: torch.Tensor):
        """n2 (T, D) -> (weights (T, k), picked experts (T, k))."""
        s = torch.sigmoid(mm(n2, lp["router"], self.arith))
        _, picked = torch.topk(s + lp["expert_bias"], self.cfg["num_experts_per_tok"], dim=-1)
        if self.routes is not None:
            self.routes.append(picked)
        w = torch.gather(s, 1, picked)
        if self.cfg["norm_topk_prob"]:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
        return w * self.cfg["routed_scaling_factor"], picked

    def experts(self, lp: dict, n: torch.Tensor) -> torch.Tensor:
        """The held experts' part of the routed sum."""
        n2 = n.reshape(-1, n.shape[-1])
        w, picked = self.route(lp, n2)
        out = torch.zeros_like(n2)
        f = lp["w2"].shape[1]
        for e in range(lp["w13"].shape[0]):
            tok, slot = torch.nonzero(picked == self.cfg["expert_offset"] + e, as_tuple=True)
            if tok.numel() == 0:
                continue
            h = mm(n2[tok], lp["w13"][e], self.arith)
            y = mm(F.silu(h[:, :f]) * h[:, f:], lp["w2"][e], self.arith)
            out.index_add_(0, tok, y * w[tok, slot][:, None])
        return out.reshape(n.shape)

    def block(self, i: int, lp: dict, x: torch.Tensor, cos, sin, stats: bool = False):
        n = self.norm(x, lp["ln1_scale"])
        if self.cfg["layer_types"][i] == "conv":
            out, st = self.conv(lp, n), None
        else:
            out, st = self.attend(lp, n, cos, sin, stats)
        x = x + out
        n = self.norm(x, lp["ln2_scale"])
        if i < self.cfg["num_dense_layers"]:
            a = self.arith
            ffn = mm(F.silu(mm(n, lp["w_gate"], a)) * mm(n, lp["w_up"], a), lp["w_down"], a)
        else:
            ffn = self.experts(lp, n)
        return x + ffn, st

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w["embed"][ids].float()

    def layers(self, x: torch.Tensor, start: int, stop: int, stats: bool = False, hook=None):
        """Blocks [start, stop) over x -> (x, {attention layer: stats})."""
        cos, sin = self.rope(torch.arange(x.shape[1], device=x.device))
        out = {}
        for i in range(start, stop):
            x, st = self.block(i, self.layer(i), x, cos, sin, stats=stats)
            if st is not None:
                out[i] = st
            if hook is not None:
                x = hook(i, x)
        return x, out

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return mm(self.norm(x, self.w["final_norm_scale"]), self.w["embed"].float().T,
                  self.arith)


def token_sweep(cfg: dict, params: dict, ids: np.ndarray, mix: dict, *, first_chunk: int,
                chunks: int, head_weights=None, arith: str = "fp32", routes=None):
    """``sweep.token_sweep`` over this model -> (token-weighted NLL sums
    (methods, layers, ratios) float64, loss tokens). ``routes``, a list,
    receives the (T, k) picked experts of every MoE layer of the first
    batch's statistics forward, in layer order."""
    methods, layers, ratios = mix["methods"], mix["layers_of_interest"], mix["ratios"]
    s_len, stride = mix["max_length"], mix["stride"]
    total = np.zeros((len(methods), len(layers), len(ratios)))
    n_tokens = 0.0
    device = params["embed"].device
    ins, tgts, counts = windows(ids, s_len, stride, first_chunk, chunks)
    model = Model(cfg, params, arith)
    n_layers = cfg["num_hidden_layers"]
    with torch.inference_mode(), arithmetic(arith):
        for a in range(0, len(ins), BATCH):
            x_ids = torch.as_tensor(ins[a:a + BATCH], device=device)
            tgt = torch.as_tensor(tgts[a:a + BATCH], device=device)
            cnt = counts[a:a + BATCH]
            t_tgt = tgt[:, -stride:]
            kept = {}

            def keep(i, x):
                if i in layers:
                    kept[i] = x
                return x

            model.routes = routes if a == 0 else None
            x, stats = model.layers(model.embed(x_ids), 0, n_layers, stats=True, hook=keep)
            model.routes = None
            base = window_nll(model.logits(x[:, -stride - 1:-1]), t_tgt).cpu().numpy()
            for li, layer in enumerate(layers):
                for mi, method in enumerate(methods):
                    imp = importance(method, stats, layer, head_weights)
                    for ri, r in enumerate(ratios):
                        if float(r) == 0.0:
                            nll = base
                        else:
                            h = int4_least_important(kept[layer], imp, int(float(r) * s_len))
                            h, _ = model.layers(h, layer + 1, n_layers)
                            nll = window_nll(model.logits(h[:, -stride - 1:-1]),
                                             t_tgt).cpu().numpy()
                        total[mi, li, ri] += float(nll @ cnt)
            n_tokens += float(cnt.sum())
    return total, n_tokens
