"""The token sweep, recomputed plainly, window by window, from the ids.

For each window: the full forward in float32 with the attention map
written out, every layer's column means and last row, the hidden after
each layer of interest, and the ratio-0 baseline from the final hidden.
For each (method, layer, ratio): importance at that layer (the head mean of
the column means, their head-weighted sum, the head mean of the last row,
or the running mean of the first over layers 0 .. layer); the
``int(ratio * S)`` least important positions (ties to the earlier
position) are quantized to symmetric int4 under one max-abs scale over the
window's quantized rows, the rest of the model runs from the next layer,
and the last ``stride`` targets are scored. Each window weighs its mean NLL
by its loss tokens (targets scored less one), as the published recipe
does."""
from __future__ import annotations

import numpy as np
import torch

from .model import Model, arithmetic, window_nll

#: windows a reference batch holds
BATCH = 8


def windows(ids: np.ndarray, max_length: int, stride: int, first: int, count: int):
    """Chunks ``first .. first + count - 1`` of the sliding-window recipe
    over ``ids``: (inputs (N, S), targets (N, S) with -100 where a position
    was scored by an earlier window, loss-token counts (N,))."""
    ins, tgts, counts = [], [], []
    for c in range(first, first + count):
        begin = c * stride
        end = min(begin + max_length, len(ids))
        prev_end = min(begin - stride + max_length, len(ids)) if c else 0
        x = ids[begin:end]
        t = x.astype(np.int64).copy()
        t[: len(x) - (end - prev_end)] = -100
        ins.append(x)
        tgts.append(t)
        counts.append(int((t != -100).sum()) - 1)
    return np.stack(ins), np.stack(tgts), np.asarray(counts, np.float64)


def importance(method: str, stats: dict, layer: int, head_weights=None) -> torch.Tensor:
    """(N, S) importance at ``layer`` from every layer's (column means, last
    row), each (N, H, S): the head mean of the column means, their sum
    weighted by the layer's head weights, the head mean of the last row, or
    the running mean of the first over layers 0 .. layer."""
    if method == "regular_importance":
        return stats[layer][0].mean(dim=1)
    if method == "weighted_importance":
        w = torch.as_tensor(head_weights[layer], device=stats[layer][0].device)
        return (stats[layer][0] * w[None, :, None]).sum(dim=1)
    if method == "last_row":
        return stats[layer][1].mean(dim=1)
    if method == "aggregate_till":
        return torch.stack([stats[i][0].mean(dim=1) for i in range(layer + 1)]).mean(dim=0)
    raise ValueError(f"the reference has no importance method {method!r}")


def int4_least_important(h: torch.Tensor, imp: torch.Tensor, k: int) -> torch.Tensor:
    """Quantize the k least important positions of each window of h
    (N, S, D) to symmetric int4, one max-abs scale a window over its
    quantized rows; the other positions pass unchanged."""
    order = torch.argsort(imp, dim=-1, stable=True)
    mask = torch.zeros_like(imp, dtype=torch.bool).scatter(-1, order[:, :k], True)
    m = mask[:, :, None]
    scale = torch.where(m, h.abs(), 0.0).amax(dim=(1, 2), keepdim=True)
    scale = torch.where(scale > 0, scale, 1.0)
    q = torch.round(torch.clamp(h / scale * 7.0, -8.0, 7.0)) / 7.0 * scale
    return torch.where(m, q, h)


def token_sweep(cfg: dict, params: dict, ids: np.ndarray, mix: dict, *, first_chunk: int,
                chunks: int, head_weights=None, arith: str = "fp32"):
    """-> (token-weighted NLL sums (methods, layers, ratios) float64, loss
    tokens) of chunks ``first_chunk ..`` of ``ids``."""
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
            tail = stride
            t_tgt = tgt[:, -tail:]
            kept = {}

            def keep(i, x):
                if i in layers:
                    kept[i] = x
                return x

            x, stats = model.layers(model.embed(x_ids), 0, n_layers, stats=True, hook=keep)
            base = window_nll(model.logits(x[:, -tail - 1:-1]), t_tgt).cpu().numpy()
            for li, layer in enumerate(layers):
                for mi, method in enumerate(methods):
                    imp = importance(method, stats, layer, head_weights)
                    for ri, r in enumerate(ratios):
                        if float(r) == 0.0:
                            nll = base
                        else:
                            h = int4_least_important(kept[layer], imp, int(float(r) * s_len))
                            h, _ = model.layers(h, layer + 1, n_layers)
                            nll = window_nll(model.logits(h[:, -tail - 1:-1]),
                                             t_tgt).cpu().numpy()
                        total[mi, li, ri] += float(nll @ cnt)
            n_tokens += float(cnt.sum())
    return total, n_tokens
