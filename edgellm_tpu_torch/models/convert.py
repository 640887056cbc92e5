"""Carry weights from the JAX package to the port.

Both packages keep one layout: a dict with every layer stacked along a
leading (L, ...) axis and weights as (in, out) for ``x @ W``. A JAX parameter
pytree handed over as numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) therefore maps key for key onto the port's parameters, and both
packages compute the same function on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs import ModelConfig


def params_from_jax_numpy(cfg: ModelConfig, tree: dict, device="cuda",
                          dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from a JAX parameter pytree of numpy arrays, on
    ``device``; ``dtype`` casts floating tensors (None keeps each array's own
    dtype; bfloat16 arrays, which numpy cannot hold, arrive as float32)."""
    def conv(name, a):
        if isinstance(a, dict):
            return {k: conv(k, v) for k, v in a.items()}
        arr = np.asarray(a)
        if arr.dtype.kind not in "fiub":  # ml_dtypes bfloat16 and friends
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))  # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    params = {k: conv(k, v) for k, v in tree.items()}
    _check_shapes(cfg, params)
    return params


def _check_shapes(cfg: ModelConfig, params: dict) -> None:
    L, D = cfg.num_layers, cfg.hidden_size
    want = {"embed": (cfg.vocab_size, D), "final_norm_scale": (D,)}
    for name, shape in want.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(params[name].shape)}")
    for name, t in params["layers"].items():
        if t.shape[0] != L:
            raise ValueError(f"layers/{name}: expected {L} stacked layers, got "
                             f"{tuple(t.shape)}")
