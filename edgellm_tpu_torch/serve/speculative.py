"""Speculative decoding across the split boundary, stage-0 draft and k-token
batched verify: PyTorch counterpart of ``edgellm_tpu/serve/speculative.py``.

A vanilla decode token costs one round of boundary hops. Here a DRAFT, the
first ``draft_layers`` layers of the full model read out through the full
model's final norm and head, proposes k - 1 tokens on stage 0 with no hop,
and the split model VERIFIES the window in one
:meth:`~..parallel.split.SplitRuntime.verify_step`: each cut moves one
(1, k, D) block instead of k single-token payloads.

The burst (committed tokens ``c_0..c_{n-1}``; the target cache holds the
prompt and ``c_0..c_{n-2}``, the vanilla loop's invariant):

1. draft ``d_1..d_{k-1}`` by greedy argmax, feeding ``c_{n-1}`` first;
2. verify ``[c_{n-1}, d_1, .., d_{k-1}]`` in one pass: position j's logits
   are the distribution of global step ``n + j``;
3. accept: at ``temperature == 0`` draft j holds iff it equals the argmax of
   position j - 1, so greedy output equals the vanilla ``generate_split``'s
   token for token; above 0, residual resampling against the point-mass
   draft (accept ``d_j`` when ``uniform(fold_in(pkey, 1)) < p(d_j)``, else
   draw ``categorical(fold_in(pkey, 2), log p)`` with ``p(d_j)`` zeroed),
   ``pkey = fold_in(key, n + j - 1)``;
4. commit by rewriting ``length`` (rows past it are masked, so rollback
   moves no data), the draft cache too, plus one catch-up draft step after
   a fully accepted burst for the row its k - 1 steps never wrote.

Every burst emits 1..k tokens for one boundary round trip: ``hops_per_token``
is ``bursts / emitted``. Not ported yet: ``recovery=`` and
``resume_speculative`` (checkpoints, the watchdog).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.transformer import KVCache, decode_step, prefill
from ..utils import prng
from .decode import _fold, _sample, _sync, _validate_decode_args

__all__ = ["DRAFT_SOURCES", "MAX_SPEC_K", "SpecConfig", "draft_from_params",
           "generate_speculative", "spec_capacity"]

MAX_SPEC_K = 16  # verify window ceiling: beyond this the draft rarely holds
DRAFT_SOURCES = ("stage0",)
_NOT_PORTED = "is not ported yet to edgellm_tpu_torch"


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode knobs. ``k`` is the verify window: each burst
    drafts k - 1 tokens and verifies k positions in one split pass.
    ``draft_source`` ``"stage0"`` is the early-exit head over the first
    ``draft_layers`` layers (default: all that stage 0 owns, first cut + 1).
    ``enabled=False`` leaves ``generate_split`` on its vanilla loop."""

    enabled: bool = True
    k: int = 4
    draft_source: str = "stage0"
    draft_layers: Optional[int] = None

    def __post_init__(self):
        if not isinstance(self.k, int) or isinstance(self.k, bool):
            raise ValueError(f"k must be an int, got {self.k!r}")
        if not 1 <= self.k <= MAX_SPEC_K:
            raise ValueError(f"k must be in [1, {MAX_SPEC_K}], got {self.k}")
        if self.draft_source not in DRAFT_SOURCES:
            raise ValueError(f"unknown draft_source {self.draft_source!r}; "
                             f"supported: {DRAFT_SOURCES}")
        if self.draft_layers is not None and (
                not isinstance(self.draft_layers, int)
                or isinstance(self.draft_layers, bool) or self.draft_layers < 1):
            raise ValueError(f"draft_layers must be a positive int or None, got "
                             f"{self.draft_layers!r}")


def draft_from_params(cfg: ModelConfig, raw_params: dict, spec: SpecConfig,
                      cut: Optional[int] = None) -> tuple:
    """The stage-0 early-exit draft -> (draft_cfg, draft_params): the first
    ``draft_layers`` layers of the full model (views, no copy) with the full
    model's embedding, final norm and head. ``cut`` (the first split cut)
    bounds ``draft_layers``, so the draft needs no weight stage 0 lacks."""
    limit = (cut + 1) if cut is not None else cfg.num_layers
    n = spec.draft_layers if spec.draft_layers is not None else limit
    if not 1 <= n <= limit:
        raise ValueError(
            f"draft_layers={n} must be in [1, {limit}] — stage 0 owns "
            f"layers 0..{limit - 1} and the draft must run hop-free there")
    draft_params = {k: v for k, v in raw_params.items() if k != "layers"}
    draft_params["layers"] = {k: v[:n] for k, v in raw_params["layers"].items()}
    return dataclasses.replace(cfg, num_layers=n), draft_params


def spec_capacity(prompt_len: int, max_new_tokens: int, k: int) -> int:
    """Cache rows a speculative run can touch: the last burst may start with
    ``max_new_tokens - 1`` committed tokens and still write all k verify
    rows past the vanilla fill level."""
    return max(prompt_len + max_new_tokens, prompt_len + max_new_tokens + k - 2)


def generate_speculative(rt: Any, placed_params: dict, prompt_ids, max_new_tokens: int, *,
                         spec: SpecConfig, capacity: Optional[int] = None,
                         temperature: float = 0.0, rng_key: Optional[tuple] = None,
                         stats: Optional[dict] = None, recovery: Any = None,
                         raw_params: Optional[dict] = None) -> torch.Tensor:
    """``generate_split`` through the burst loop -> (1, max_new_tokens) int32
    (speculation is per stream: batch 1). Greedy output equals the vanilla
    loop's on the same seed and plan. ``raw_params`` (the unplaced weights)
    is required: the draft is sliced from it and runs where it lives.
    ``stats`` gets the vanilla keys (``decode_steps`` counts the tokens the
    bursts emitted) and ``speculative``: k, draft_layers, bursts, drafted,
    accepted, rejected, acceptance_rate, hops_per_token and
    ``draft_step_cache_misses`` (0: nothing compiles)."""
    if not spec.enabled:
        raise ValueError("generate_speculative called with spec.enabled=False; use "
                         "generate_split (which this disabled config leaves byte-identical)")
    if not hasattr(rt, "verify_step"):
        raise ValueError("speculative decoding needs the split runtime's k-token "
                         f"verify_step; {type(rt).__name__} has none")
    if raw_params is None:
        raise ValueError("speculative decoding needs raw_params= (the unplaced parameter "
                         "pytree) to slice out the stage-0 draft layers")
    if recovery is not None:
        raise ValueError(f"generate_speculative recovery= {_NOT_PORTED}")
    prompt_len = (prompt_ids.shape if isinstance(prompt_ids, torch.Tensor)
                  else np.shape(prompt_ids))[-1]
    need = spec_capacity(prompt_len, max_new_tokens, spec.k)
    if capacity is None:
        capacity = need
    elif capacity < need:
        raise ValueError(
            f"speculative cache overflow: the verify burst writes past the vanilla fill "
            f"level, needs capacity >= {need}, got {capacity}")
    prompt_ids, capacity, temperature, key = _validate_decode_args(
        prompt_ids, max_new_tokens, capacity, temperature, rng_key, rt.devices[0])
    if prompt_ids.shape[0] != 1:
        raise ValueError(f"speculative decoding is per-stream (batch=1), got batch "
                         f"{prompt_ids.shape[0]}; route batches through the batcher")
    cut = int(rt.split.cuts[0]) if rt.split.cuts else None
    draft_cfg, draft_params = draft_from_params(rt.cfg, raw_params, spec, cut)
    return _spec_loop(rt, placed_params, prompt_ids, max_new_tokens, capacity, temperature,
                      key, spec, draft_cfg, draft_params, stats)


def _accept(vlogits: torch.Tensor, feed: list, key, n: int, k: int,
            temperature: float) -> tuple:
    """One burst's accept pass over the verify logits (1, k, V) ->
    (emitted token ids, accepted drafts). Greedy: the argmax of every
    position, taken to the first draft that differs, and the bonus token
    after a full run. Sampled: residual resampling per position, the
    reference's keys and draws."""
    emitted: list = []
    if temperature == 0.0:
        greedy = vlogits[0].argmax(dim=-1).tolist()
        for j in range(1, k):
            emitted.append(greedy[j - 1])
            if greedy[j - 1] != feed[j]:
                return emitted, j - 1
        return emitted + [greedy[k - 1]], k - 1
    temp = torch.tensor(temperature, dtype=torch.float32, device=vlogits.device)
    for j in range(1, k):
        pkey = torch.tensor([_fold(key, n + j - 1)], dtype=torch.int64)
        x = vlogits[0, j - 1] / temp
        e = torch.exp(x - x.max())
        probs = e / e.sum()
        dj = feed[j]
        u = prng.uniform(prng.fold_in(pkey, torch.tensor([1])), 1)[0, 0]
        if float(u) < float(probs[dj]):
            emitted.append(dj)
            continue
        resid = probs.clone()
        resid[dj] = 0.0
        rkey = prng.fold_in(pkey, torch.tensor([2])).to(vlogits.device)
        emitted.append(int(prng.categorical(rkey, torch.log(resid))))
        return emitted, j - 1
    bonus = _sample(vlogits[:, k - 1], _fold(key, n + k - 1), temperature)
    return emitted + [int(bonus[0])], k - 1


def _spec_loop(rt, placed: dict, prompt_ids: torch.Tensor, max_new_tokens: int,
               capacity: int, temperature: float, key, spec: SpecConfig,
               draft_cfg: ModelConfig, draft_params: dict,
               stats: Optional[dict]) -> torch.Tensor:
    """The burst loop (the reference's ``_spec_loop`` without recovery)."""
    b, s = prompt_ids.shape
    k = spec.k
    draft_device = draft_params["embed"].device
    t0 = time.monotonic()
    logits, cache = rt.prefill_decode(placed, prompt_ids, capacity)
    tok = _sample(logits[:, -1], _fold(key, 0), temperature)
    # the draft prefill fills the stage-0 cache to the same level (its logits
    # are discarded: token 0 is the target's, as in the vanilla loop)
    _, dcache = prefill(draft_cfg, draft_params, prompt_ids.to(draft_device), capacity)
    toks = [int(tok[0])]
    _sync(rt.devices[-1])
    t1 = time.monotonic()

    n = len(toks)
    drafted = accepted = rejected = bursts = emitted_total = 0
    while n < max_new_tokens:
        feed = [toks[-1]]
        for _ in range(1, k):
            dlogits, dcache = decode_step(
                draft_cfg, draft_params, dcache,
                torch.tensor([feed[-1]], dtype=torch.long, device=draft_device))
            feed.append(int(dlogits.argmax(dim=-1)[0]))
        drafted += k - 1
        x = torch.tensor([feed], dtype=torch.long, device=rt.devices[0])
        vlogits, vcache = rt.verify_step(placed, cache, x)
        bursts += 1
        emitted, acc = _accept(vlogits, feed, key, n, k, temperature)
        rejected += (k - 1) - acc
        accepted += acc
        emitted = emitted[:max_new_tokens - n]  # budget clamp
        m = len(emitted)
        emitted_total += m
        toks.extend(emitted)
        n += m
        cache = {**vcache, "length": s + n - 1}
        if m == k:
            # fully accepted: one catch-up step writes the row of the last
            # fed token, which the k - 1 draft steps never wrote
            _, dcache = decode_step(
                draft_cfg, draft_params, dcache,
                torch.tensor([feed[k - 1]], dtype=torch.long, device=draft_device))
        dcache = KVCache(dcache.k, dcache.v, s + n - 1)
    out = torch.tensor([toks], dtype=torch.int32, device=rt.devices[-1])
    _sync(rt.devices[-1])
    t2 = time.monotonic()
    if stats is not None:
        stats.update(
            capacity=capacity, prefill_s=t1 - t0, decode_s=t2 - t1,
            decode_steps=emitted_total,
            decode_tokens_per_s=(emitted_total / (t2 - t1)) if emitted_total and t2 > t1
            else 0.0,
            speculative={
                "k": int(k), "draft_layers": int(draft_cfg.num_layers), "bursts": bursts,
                "drafted": drafted, "accepted": accepted, "rejected": rejected,
                "acceptance_rate": (accepted / drafted) if drafted else 0.0,
                "hops_per_token": (bursts / emitted_total) if emitted_total else 0.0,
                "draft_step_cache_misses": 0})
    return out
