"""A plain Qwen2 decoder in float32: the published block (RMSNorm, rotary
embedding, grouped-query attention with q/k/v biases, SwiGLU MLP, sequential
residual, tied or untied LM head), with the attention map written out, so
that its column means and last row come straight from the softmax.

Weights are the benchmark's dict in the ``x @ W`` layout, every layer
stacked along a leading axis; each layer is widened to float32 when it is
used. ``Arith`` names the arithmetic of every product: "fp32" (TF32 off, the
reference), "tf32" (the control of a float32 configuration) or "fp8" (both
operands rounded to float8 e4m3 with one scale a tensor, the control of a
bfloat16 configuration)."""
from __future__ import annotations

import contextlib
import math

import torch

ARITHS = ("fp32", "tf32", "fp8")


@contextlib.contextmanager
def arithmetic(arith: str):
    """TF32 off for "fp32" and "fp8", on for "tf32"; restored on exit."""
    if arith not in ARITHS:
        raise ValueError(f"unknown arithmetic {arith!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = arith == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one max-abs scale (448 at the max)."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def mm(a: torch.Tensor, b: torch.Tensor, arith: str) -> torch.Tensor:
    """a @ b in float32, the operands rounded to fp8 first under "fp8"."""
    if arith == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


class Model:
    """The published Qwen2 forward over the benchmark's weights."""

    def __init__(self, cfg: dict, weights: dict, arith: str = "fp32"):
        self.cfg, self.w, self.arith = cfg, weights, arith
        self.hd = cfg["head_dim"]
        self.h = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.eps = cfg["rms_norm_eps"]

    def layer(self, i: int) -> dict:
        return {k: v[i].float() for k, v in self.w["layers"].items()}

    def rope(self, positions: torch.Tensor):
        # float32 angles, as the published implementation computes them
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

    def block(self, lp: dict, x: torch.Tensor, cos, sin, stats: bool = False,
              past_k=None, past_v=None):
        """One block over x (B, S, D) at the positions cos / sin give ->
        (x, stats or None, (k, v) of these positions). With ``past_k`` /
        ``past_v`` (B, P, KV, hd) the queries also see P earlier positions."""
        b, s, _ = x.shape
        a = self.arith
        n = self.norm(x, lp["ln1_scale"])
        q = (mm(n, lp["wq"], a) + lp["bq"]).reshape(b, s, self.h, self.hd)
        k = (mm(n, lp["wk"], a) + lp["bk"]).reshape(b, s, self.kv, self.hd)
        v = (mm(n, lp["wv"], a) + lp["bv"]).reshape(b, s, self.kv, self.hd)
        q, k = self._rotate(q, cos, sin), self._rotate(k, cos, sin)
        kk = k if past_k is None else torch.cat([past_k, k], dim=1)
        vv = v if past_v is None else torch.cat([past_v, v], dim=1)
        t = kk.shape[1]
        g = self.h // self.kv
        kh = kk.repeat_interleave(g, dim=2).permute(0, 2, 3, 1)   # (B, H, hd, T)
        vh = vv.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)   # (B, H, T, hd)
        scores = mm(q.permute(0, 2, 1, 3), kh, a) / math.sqrt(self.hd)   # (B, H, S, T)
        qpos = torch.arange(t - s, t, device=x.device)[:, None]
        visible = torch.arange(t, device=x.device)[None, :] <= qpos
        probs = torch.softmax(scores.masked_fill(~visible, -math.inf), dim=-1)
        st = None
        if stats:
            st = (probs.sum(dim=2) / s, probs[:, :, -1, :])        # (B, H, T) each
        out = mm(probs, vh, a).permute(0, 2, 1, 3).reshape(b, s, self.h * self.hd)
        x = x + mm(out, lp["wo"], a)
        n = self.norm(x, lp["ln2_scale"])
        up = torch.nn.functional.silu(mm(n, lp["w_gate"], a)) * mm(n, lp["w_up"], a)
        x = x + mm(up, lp["w_down"], a)
        return x, st, (k, v)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w["embed"][ids].float()

    def layers(self, x: torch.Tensor, start: int, stop: int, stats: bool = False,
               hook=None):
        """Blocks [start, stop) over x -> (x, {layer: stats}). ``hook(i, x)``
        may replace the hidden after block i."""
        cos, sin = self.rope(torch.arange(x.shape[1], device=x.device))
        out = {}
        for i in range(start, stop):
            x, st, _ = self.block(self.layer(i), x, cos, sin, stats=stats)
            if stats:
                out[i] = st
            if hook is not None:
                x = hook(i, x)
        return x, out

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and LM head -> float32 logits."""
        head = (self.w["embed"].float().T if self.cfg["tie_word_embeddings"]
                else self.w["lm_head"].float())
        return mm(self.norm(x, self.w["final_norm_scale"]), head, self.arith)


def window_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-row mean NLL of shift-aligned logits (B, T, V) against targets
    (B, T), where -100 marks a position that is not scored."""
    valid = targets != -100
    logp = torch.log_softmax(logits.double(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, targets, 0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(dim=1) / valid.sum(dim=1).clamp(min=1)
