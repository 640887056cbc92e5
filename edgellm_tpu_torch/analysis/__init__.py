"""Cross-layer importance-distribution analysis (the reference's
``Notebooks/distributions_distance_across_layers.ipynb``)."""
from .distances import (
    kl_divergence,
    jensen_shannon_divergence,
    layer_importance_distributions,
    pairwise_layer_distances,
    bucket_lengths,
    save_heatmap,
)

__all__ = [
    "kl_divergence",
    "jensen_shannon_divergence",
    "layer_importance_distributions",
    "pairwise_layer_distances",
    "bucket_lengths",
    "save_heatmap",
]
