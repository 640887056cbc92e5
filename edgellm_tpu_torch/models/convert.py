"""Carry weights from the JAX package to the port.

Both packages keep weights as (in, out) for ``x @ W`` under the same names;
the JAX package stacks every layer weight along a leading (L, ...) axis,
the port holds one dict per layer (views of those stacks,
``transformer.layer_list``). A JAX parameter pytree handed over as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) therefore maps key
for key onto the port's parameters, and both packages compute the same
function on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs import ModelConfig
from .transformer import layer_list


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
    params["layers"] = layer_list(params["layers"])
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


def paged_cache_from_state(cfg: ModelConfig, state: dict, *, prefix_cache=None,
                           device="cuda"):
    """A :class:`~.paged_kv.PagedKVCache` holding a paged cache's
    ``state_dict()`` (host numpy arrays: the JAX package's, or the port's
    own; an fp pool in float32), with the geometry and the KV-at-rest tier
    read off the state: the pool, page table, lengths, free list, refcounts
    and prefix index carry across, so both packages can step the same pool
    and compare."""
    from .paged_kv import PagedKVCache

    tier = state.get("kv_codec", "fp")
    k = np.asarray(state["k"] if tier == "fp" else state["k_codes"])
    max_slots, pages_per_slot = np.asarray(state["page_table"]).shape
    cache = PagedKVCache(cfg, num_pages=k.shape[1], page_size=k.shape[2], max_slots=max_slots,
                         pages_per_slot=pages_per_slot, device=device,
                         prefix_cache=prefix_cache, kv_codec=tier)
    cache.load_state_dict(state)
    return cache
