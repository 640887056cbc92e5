"""The split eval, recomputed plainly: each window's forward in float32,
each cut's hidden sent through its codec's round trip after the cut's
layer, every target of the window scored, and each window's mean NLL
weighed by its loss tokens."""
from __future__ import annotations

import numpy as np
import torch

from .codecs import ROUND_TRIPS
from .model import Model, arithmetic, window_nll
from .sweep import windows

BATCH = 4


def split_eval(cfg: dict, params: dict, ids: np.ndarray, mix: dict, *, chunks: int,
               arith: str = "fp32"):
    """-> (token-weighted NLL sum, loss tokens) of chunks 0 .. chunks - 1 of
    ``ids`` over the split at ``mix["cuts"]``."""
    cuts = {int(c): ROUND_TRIPS[name] for c, name in zip(mix["cuts"], mix["hop_codecs"])}
    ins, tgts, counts = windows(ids, mix["max_length"], mix["stride"], 0, chunks)
    model = Model(cfg, params, arith)
    device = params["embed"].device
    total = 0.0
    with torch.inference_mode(), arithmetic(arith):
        for a in range(0, len(ins), BATCH):
            x = model.embed(torch.as_tensor(ins[a:a + BATCH], device=device))
            x, _ = model.layers(x, 0, cfg["num_hidden_layers"],
                                hook=lambda i, h: cuts[i](h) if i in cuts else h)
            tgt = torch.as_tensor(tgts[a:a + BATCH], device=device)
            nll = window_nll(model.logits(x[:, :-1]), tgt[:, 1:]).cpu().numpy()
            total += float(nll @ counts[a:a + BATCH])
    return total, float(counts.sum())
