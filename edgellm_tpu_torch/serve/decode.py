"""Autoregressive generation over the KV-cached decode path: PyTorch
counterpart of ``edgellm_tpu/serve/decode.py``'s ``generate`` and
``generate_split``.

One prefill fills a contiguous cache (``generate``) or the split runtime's
per-stage caches (``generate_split``: every emitted token crosses each cut
as a packed payload), then one decode step per token. Sampling is the
reference's, bit for bit in its random bits (:mod:`..utils.prng`):
``temperature == 0`` is greedy argmax; ``temperature > 0`` draws
``categorical(fold_in(key, t), logits / T)`` with the caller's key folded
with the step index ``t`` (token 0 comes from the prefill with
``fold_in(key, 0)``), so a stream's tokens depend only on its seed and step,
never on what else runs beside it. ``generate`` is the identity oracle of
the continuous batcher's streams.

``generate_split``'s ``speculative=`` hands the call to :mod:`.speculative`.
Not ported yet: the survivable loop (``recovery=``), ``resume_split`` and
the link-health observer (``link_health=``); each raises naming its
argument. There is no jit here: PyTorch runs eagerly, so
nothing compiles per shape and there are no cache misses to count.
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

__all__ = ["generate", "generate_split"]

_NOT_PORTED = "is not ported yet to edgellm_tpu_torch"


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


def _validate_decode_args(prompt_ids, max_new_tokens: int, capacity: Optional[int],
                          temperature: float, rng_key, device):
    """The reference's argument checks -> (prompt (B, S) int64 on ``device``,
    capacity, temperature, key pair)."""
    prompt_ids = torch.as_tensor(np.asarray(prompt_ids) if not isinstance(
        prompt_ids, torch.Tensor) else prompt_ids).to(device=device, dtype=torch.long)
    if prompt_ids.dim() != 2:
        raise ValueError(f"prompt_ids must be (B, S), got {tuple(prompt_ids.shape)}")
    s = prompt_ids.shape[1]
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
    return prompt_ids, capacity, temperature, key


def _decode_stats(stats: Optional[dict], capacity: int, b: int, steps: int,
                  t0: float, t1: float, t2: float) -> None:
    if stats is not None:
        stats.update(capacity=capacity, prefill_s=t1 - t0, decode_s=t2 - t1,
                     decode_steps=steps,
                     decode_tokens_per_s=(b * steps / (t2 - t1)) if steps else 0.0)


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
    prompt_ids, capacity, temperature, key = _validate_decode_args(
        prompt_ids, max_new_tokens, capacity, temperature, rng_key, device)
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
    _decode_stats(stats, capacity, prompt_ids.shape[0], max_new_tokens - 1, t0, t1, t2)
    if stats is not None:
        stats["decode_step_cache_misses"] = 0
    return out


def generate_split(rt: Any, placed_params: dict, prompt_ids, max_new_tokens: int, *,
                   capacity: Optional[int] = None, temperature: float = 0.0,
                   rng_key: Optional[tuple] = None, stats: Optional[dict] = None,
                   recovery: Any = None, raw_params: Optional[dict] = None,
                   link_health: Any = None, speculative: Any = None) -> torch.Tensor:
    """``generate`` over a :class:`~..parallel.split.SplitRuntime`: one split
    prefill (:meth:`~..parallel.split.SplitRuntime.prefill_decode`), then one
    ``rt.decode_step`` per token, each crossing every cut as a packed (B, 1,
    D) payload. Sampling is :func:`generate`'s: ``fold_in(key, t)`` for
    token t. ``placed_params`` comes from ``rt.place_params``; ``stats``
    gets the reference's keys (``capacity``, ``prefill_s``, ``decode_s``,
    ``decode_steps``, ``decode_tokens_per_s``).

    ``speculative``: an enabled :class:`~.speculative.SpecConfig` runs the
    draft / verify burst loop (needs ``raw_params``, the unplaced weights
    the stage-0 draft is sliced from); None or a disabled config is this
    loop."""
    if recovery is not None:
        raise ValueError(f"generate_split recovery= (the survivable loop) {_NOT_PORTED}")
    if link_health is not None:
        raise ValueError(f"generate_split link_health= {_NOT_PORTED}")
    if speculative is not None and speculative.enabled:
        from .speculative import generate_speculative

        return generate_speculative(rt, placed_params, prompt_ids, max_new_tokens,
                                    spec=speculative, capacity=capacity,
                                    temperature=temperature, rng_key=rng_key, stats=stats,
                                    raw_params=raw_params)
    device = rt.devices[0]
    prompt_ids, capacity, temperature, key = _validate_decode_args(
        prompt_ids, max_new_tokens, capacity, temperature, rng_key, device)
    t0 = time.monotonic()
    logits, cache = rt.prefill_decode(placed_params, prompt_ids, capacity)
    tok = _sample(logits[:, -1], _fold(key, 0), temperature)
    _sync(rt.devices[-1])
    t1 = time.monotonic()
    toks = [tok]
    for t in range(1, max_new_tokens):
        step_logits, cache = rt.decode_step(placed_params, cache, tok.long())
        tok = _sample(step_logits, _fold(key, t), temperature)
        toks.append(tok)
    out = torch.stack(toks, dim=1)
    _sync(rt.devices[-1])
    t2 = time.monotonic()
    _decode_stats(stats, capacity, prompt_ids.shape[0], max_new_tokens - 1, t0, t1, t2)
    return out


def _sync(device: Any) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
