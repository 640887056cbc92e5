"""Jensen-Shannon similarity of per-layer token-importance distributions:
PyTorch counterpart of ``edgellm_tpu/analysis/distances.py``.

The analysis of the reference's ``distributions_distance_across_layers.ipynb``
(cells 10-18): for each corpus sample, every layer's regular-importance
distribution (head-mean column-mean of the attention map, a probability
distribution over positions), then the sample-averaged pairwise
Jensen-Shannon divergence between layers. The upper-triangular LxL matrix
says how transferable an importance ordering computed at one layer is to
another split point.

Each sample runs alone at its native length through the stats forward
(K-stats on the card, where :func:`~..models.flash_attention.kernel_plan`
admits the shape; its plain version elsewhere). The divergences are the
notebook's, in float64 on the host: base-2 KL with the ``p != 0`` guard
(cell 12) and JS against the 50/50 mixture (cell 13; the notebook's
"distance" is the divergence, not its square root).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..importance import regular_importance
from ..models.configs import ModelConfig
from ..models.transformer import run_layers_from_ids


def kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """Base-2 KL divergence with zero-p guard (notebook cell 12)."""
    p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p != 0, p * np.log2(p / q), 0.0)
    return float(np.sum(terms))


def jensen_shannon_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """JS divergence against the 50/50 mixture (notebook cell 13)."""
    m = 0.5 * (np.asarray(p, np.float64) + np.asarray(q, np.float64))
    return 0.5 * (kl_divergence(p, m) + kl_divergence(q, m))


def bucket_lengths(lengths: Sequence[int], max_buckets: int) -> list:
    """Pick <= max_buckets clip lengths (ascending) covering a ragged corpus.

    Quantile-spaced over the distinct lengths so short and long samples each
    get a nearby bucket; every sample is clipped DOWN to the largest bucket
    <= its length (samples shorter than the smallest bucket keep their native
    length)."""
    distinct = sorted(set(int(l) for l in lengths))
    if len(distinct) <= max_buckets:
        return distinct
    qs = np.linspace(0, len(distinct) - 1, max_buckets).round().astype(int)
    return [distinct[i] for i in sorted(set(qs))]


def layer_importance_distributions(cfg: ModelConfig, params,
                                   samples: Sequence[np.ndarray],
                                   max_compiles: int | None = None,
                                   device="cuda") -> list:
    """Per-sample regular-importance distributions: list over L layers of lists
    over samples of (S_i,) fp32 arrays (the notebook's ``all_distributions``).

    Samples run one at a time at their native lengths, like the notebook's
    per-line forwards. ``max_compiles`` (a name kept from the JAX package,
    where each distinct length compiles once) clips the samples down to at
    most that many bucket lengths (:func:`bucket_lengths`); clipping keeps
    the analysis exact for the analyzed prefix, since every layer of a
    sample sees the same tokens. ``params`` live on ``device``."""
    samples = [np.asarray(s).reshape(-1) for s in samples]
    if max_compiles is not None:
        buckets = bucket_lengths([s.shape[0] for s in samples], max_compiles)
        clipped = []
        for s in samples:
            fits = [b for b in buckets if b <= s.shape[0]]
            clipped.append(s[: fits[-1]] if fits else s)
        samples = clipped
    out = [[] for _ in range(cfg.num_layers)]
    with torch.no_grad():
        for ids in samples:
            ids_t = torch.from_numpy(ids.astype(np.int64)[None, :]).to(device)
            _, aux = run_layers_from_ids(cfg, params, ids_t, capture_stats=True)
            imp = regular_importance(aux["stats"].col_mean)[:, 0].cpu().numpy()  # (L, S)
            for layer in range(cfg.num_layers):
                out[layer].append(imp[layer])
    return out


def pairwise_layer_distances(distributions: list) -> np.ndarray:
    """Sample-averaged JS divergence between every layer pair -> (L, L) matrix,
    upper triangle filled, rest NaN (notebook cell 16)."""
    L = len(distributions)
    if L and not distributions[0]:
        raise ValueError("no usable samples: every corpus sample was filtered "
                         "out before the layer-importance pass")
    results = np.full((L, L), np.nan)
    for i in range(L):
        for j in range(i + 1, L):
            acc = 0.0
            for p, q in zip(distributions[i], distributions[j]):
                acc += jensen_shannon_divergence(p, q)
            results[i, j] = acc / len(distributions[i])
    return results


def save_heatmap(matrix: np.ndarray, path: str, title: str = "JS divergence "
                 "between layer importance distributions") -> None:
    """The notebook's cell-18 seaborn heatmap as a matplotlib artifact;
    raises ImportError where matplotlib does not import."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(1 + 0.5 * matrix.shape[0],) * 2)
    im = ax.imshow(matrix, cmap="viridis")
    fig.colorbar(im, ax=ax)
    for i in range(matrix.shape[0]):
        for j in range(matrix.shape[1]):
            if np.isfinite(matrix[i, j]):
                ax.text(j, i, f"{matrix[i, j]:.2f}", ha="center", va="center",
                        color="white", fontsize=7)
    ax.set_xlabel("layer")
    ax.set_ylabel("layer")
    ax.set_title(title, fontsize=9)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
