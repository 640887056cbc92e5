"""Autoregressive generation over the KV-cached decode path, local half:
PyTorch counterpart of ``edgellm_tpu/serve/decode.py``'s ``generate``.

One prefill fills a contiguous cache, then one :func:`decode_step` per
token. Sampling is the reference's, bit for bit in its random bits
(:mod:`..utils.prng`): ``temperature == 0`` is greedy argmax;
``temperature > 0`` draws ``categorical(fold_in(key, t), logits / T)`` with
the caller's key folded with the step index ``t`` (token 0 comes from the
prefill with ``fold_in(key, 0)``), so a stream's tokens depend only on its
seed and step, never on what else runs beside it. ``generate`` is the
identity oracle of the continuous batcher's streams.

``generate_split``, the survivable loop and ``resume_split`` are not ported
yet. There is no jit here: PyTorch runs eagerly, so nothing compiles per
shape and there are no cache misses to count.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.transformer import (KVCache, _cast_params, block_verify, decode_step, embed,
                                  precompute_rope, prefill, unembed)
from ..utils import prng

__all__ = ["generate"]


def _sample(logits: torch.Tensor, key, temperature: float) -> torch.Tensor:
    """(B, V) fp32 logits -> (B,) int32 token ids; ``key`` is a (k1, k2)
    key pair (already folded with the step), one draw over the (B, V)
    shape as ``jax.random.categorical(key, logits / temperature)``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    keys = torch.tensor([key], dtype=torch.int64, device=logits.device)
    temp = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    return prng.categorical(keys, logits / temp).to(torch.int32)


def _fold(key, t: int):
    """``fold_in(key, t)`` of one (k1, k2) pair -> a (k1, k2) pair."""
    out = prng.fold_in(torch.tensor([key], dtype=torch.int64), torch.tensor([t]))
    return tuple(int(x) for x in out[0])


def _prefill_impl(cfg: ModelConfig, params: dict, prompt_ids: torch.Tensor, capacity: int,
                  compute_dtype) -> tuple[torch.Tensor, KVCache]:
    """Prompt prefill -> (last-position logits (B, V) fp32, filled cache)."""
    logits, cache = prefill(cfg, params, prompt_ids, capacity, compute_dtype=compute_dtype)
    return logits[:, -1], cache


def _prefill_suffix_impl(cfg: ModelConfig, params: dict, suffix_ids: torch.Tensor,
                         cache: KVCache, compute_dtype) -> tuple[torch.Tensor, KVCache]:
    """Prefill ONLY the unmatched suffix of a prompt whose prefix K/V rows
    are already in ``cache`` (rows ``0 .. cache.length``, gathered from
    shared pages by the prefix-cache admit): embed the (B, K) suffix, rotate
    at the absolute positions ``cache.length ..``, run :func:`block_verify`
    over the layers (write K rows in place, attend causally) -> ((B, K, V)
    fp32 logits, cache grown by K)."""
    params = _cast_params(params, compute_dtype)
    hidden = embed(params, suffix_ids)  # (B, K, D)
    pos = int(cache.length)
    kq = suffix_ids.shape[1]
    cos, sin = precompute_rope(cfg, cache.capacity, device=hidden.device)
    cos_t, sin_t = cos[pos:pos + kq], sin[pos:pos + kq]
    for idx in range(cfg.num_layers):
        lp = {name: t[idx] for name, t in params["layers"].items()}
        hidden = block_verify(cfg, lp, hidden, cos_t, sin_t, cache.k[idx], cache.v[idx], pos)
    return unembed(cfg, params, hidden), KVCache(cache.k, cache.v, pos + kq)


def _step_impl(cfg: ModelConfig, params: dict, cache: KVCache, token_ids: torch.Tensor,
               key, temperature: float, compute_dtype) -> tuple[torch.Tensor, KVCache]:
    logits, cache = decode_step(cfg, params, cache, token_ids, compute_dtype=compute_dtype)
    return _sample(logits, key, temperature), cache


def generate(cfg: ModelConfig, params: dict, prompt_ids, max_new_tokens: int, *,
             capacity: Optional[int] = None, temperature: float = 0.0,
             rng_key: Optional[tuple] = None, compute_dtype=None,
             stats: Optional[dict] = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` per batch row after a KV-cached prefill.

    prompt_ids: (B, S) int token ids (a tensor on the device the weights
    live on, or an array). Returns (B, max_new_tokens) int32. ``capacity``
    (default exactly prompt + new) bounds the cache; a prompt that would
    overflow it raises. ``rng_key`` is a :func:`..utils.prng.key` pair
    (default ``key(0)``). ``stats``, when given, gets the reference's timing
    keys (``decode_step_cache_misses`` is 0: nothing compiles)."""
    device = params["embed"].device
    prompt_ids = torch.as_tensor(np.asarray(prompt_ids) if not isinstance(
        prompt_ids, torch.Tensor) else prompt_ids).to(device=device, dtype=torch.long)
    if prompt_ids.dim() != 2:
        raise ValueError(f"prompt_ids must be (B, S), got {tuple(prompt_ids.shape)}")
    b, s = prompt_ids.shape
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    capacity = s + max_new_tokens if capacity is None else int(capacity)
    if s + max_new_tokens > capacity:
        raise ValueError(f"cache capacity overflow: prompt {s} + {max_new_tokens} new "
                         f"tokens > capacity {capacity}")
    temperature = float(temperature)
    if temperature < 0.0:
        raise ValueError("temperature must be >= 0")
    key = prng.key(0) if rng_key is None else tuple(rng_key)

    t0 = time.monotonic()
    last_logits, cache = _prefill_impl(cfg, params, prompt_ids, capacity, compute_dtype)
    tok = _sample(last_logits, _fold(key, 0), temperature)
    _sync(device)
    t1 = time.monotonic()
    toks = [tok]
    for t in range(1, max_new_tokens):
        tok, cache = _step_impl(cfg, params, cache, tok.long(), _fold(key, t), temperature,
                                compute_dtype)
        toks.append(tok)
    out = torch.stack(toks, dim=1)
    _sync(device)
    t2 = time.monotonic()
    if stats is not None:
        steps = max_new_tokens - 1
        stats.update(capacity=capacity, prefill_s=t1 - t0, decode_s=t2 - t1,
                     decode_steps=steps,
                     decode_tokens_per_s=(b * steps / (t2 - t1)) if steps else 0.0,
                     decode_step_cache_misses=0)
    return out


def _sync(device: Any) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
