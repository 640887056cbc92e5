"""Served tokens judged by the plain reference: one float32 forward over a
prompt and the tokens served after it, read at every position that chose a
served token."""
from __future__ import annotations

import numpy as np
import torch

from .model import Model, arithmetic


def logits_at_served(cfg: dict, params: dict, prompt, tokens, arith: str = "fp32"):
    """(n, V) float32 logits of the positions that chose tokens 0 .. n-1:
    the last prompt position, then each served token but the last."""
    device = params["embed"].device
    seq = np.concatenate([np.asarray(prompt, np.int64), np.asarray(tokens[:-1], np.int64)])
    model = Model(cfg, params, arith)
    with torch.inference_mode(), arithmetic(arith):
        x, _ = model.layers(model.embed(torch.as_tensor(seq, device=device)[None]), 0,
                            cfg["num_hidden_layers"])
        return model.logits(x[0, len(prompt) - 1:])


def widest_gap(cfg: dict, params: dict, prompt, tokens, control=None) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position; with ``control`` (an arithmetic
    of ``model.py``), the gap of the token that the control puts first."""
    ref = logits_at_served(cfg, params, prompt, tokens)
    if control is None:
        chosen = torch.as_tensor(np.asarray(tokens, np.int64), device=ref.device)
    else:
        chosen = logits_at_served(cfg, params, prompt, tokens, control).argmax(dim=-1)
    best = ref.max(dim=-1).values
    return float((best - ref.gather(1, chosen[:, None])[:, 0]).max())
