"""Attention-statistic token-importance metrics, vectorized over layers
(PyTorch counterpart of ``edgellm_tpu/importance/metrics.py``).

Every metric consumes two reductions of the attention map captured by the
forward pass (:class:`~edgellm_tpu_torch.models.transformer.AttnStats`): the
column-wise mean (attention received per key position) and the last query
row. ``col_mean``/``last_row`` are (L, B, H, S); per-layer importance is
(L, B, S); single aggregated outputs are (B, S). Means and the running mean
add in the reference's order (``utils.ordered``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.ordered import ordered_cumsum, ordered_sum

#: methods accepted by ``importance_per_layer`` — the reference's four
ATTENTION_METHODS = (
    "regular_importance",
    "weighted_importance",
    "last_row",
    "aggregate_till",
)


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    return ordered_sum(x, dim=dim) * torch.tensor(np.float32(1.0 / x.shape[dim]),
                                                  device=x.device)


def regular_importance(col_mean: torch.Tensor) -> torch.Tensor:
    """Head-mean of the column-wise attention mean, per layer."""
    return _mean(col_mean, dim=2)


def weighted_importance(col_mean: torch.Tensor, head_weights: torch.Tensor) -> torch.Tensor:
    """Per-head column means combined with LRP head weights (L, H): a
    weighted sum over heads, no extra normalization."""
    return torch.einsum("lbhs,lh->lbs", col_mean, head_weights.to(col_mean.dtype))


def last_row_importance(last_row: torch.Tensor) -> torch.Tensor:
    """Head-mean of the final query row."""
    return _mean(last_row, dim=2)


def aggregate_till(col_mean: torch.Tensor) -> torch.Tensor:
    """Running mean of regular importance over layers 0..l."""
    reg = regular_importance(col_mean)
    counts = torch.arange(1, reg.shape[0] + 1, dtype=reg.dtype,
                          device=reg.device)[:, None, None]
    return ordered_cumsum(reg, dim=0) / counts


def importance_per_layer(stats, method: str,
                         head_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch one of the four reference methods -> (L, B, S) importance."""
    if method == "regular_importance":
        return regular_importance(stats.col_mean)
    if method == "weighted_importance":
        if head_weights is None:
            raise ValueError("weighted_importance requires head_weights (L, H)")
        return weighted_importance(stats.col_mean, head_weights)
    if method == "last_row":
        return last_row_importance(stats.last_row)
    if method == "aggregate_till":
        return aggregate_till(stats.col_mean)
    raise ValueError(f"unknown method {method!r}; options: {ATTENTION_METHODS}")


def aggregate_upto(col_mean: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of regular importance over layers 0..k inclusive."""
    return _mean(regular_importance(col_mean)[: k + 1], dim=0)


def maximum_aggregation(col_mean: torch.Tensor, k: int = None) -> torch.Tensor:
    """Elementwise max of per-layer regular importance over layers 0..k."""
    reg = regular_importance(col_mean)
    upto = reg if k is None else reg[: k + 1]
    return upto.amax(dim=0)


def ordering_from_importance(importance: torch.Tensor) -> torch.Tensor:
    """Ascending stable argsort — least-important positions first."""
    return torch.argsort(importance, dim=-1, stable=True)
