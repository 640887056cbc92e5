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
is ``bursts / emitted``. Under a faulty link each verify burst is keyed by
the cache fill level, as a vanilla step is. ``recovery=`` checkpoints,
halts and guards the loop at burst boundaries (a stage failure is refused,
as in the reference: failover re-plans the runtime mid-run), and
:func:`resume_speculative` continues a checkpoint token for token.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.transformer import KVCache, decode_step, params_to, prefill
from ..obs import context as obs_context
from ..obs.latency import LatencyObserver
from ..obs.metrics import (get_registry, record_decode_stats, record_link_counters,
                           record_link_health, record_probe_decisions,
                           record_recovery_counters, record_spec_stats, record_wire_bytes)
from ..obs.tracing import span as obs_span
from ..obs.tracing import tracing_enabled
from ..utils import prng
from .decode import (_check_plan, _emit_hop_spans, _fold, _sample, _sync,
                     _validate_decode_args, _write_checkpoint, counter_delta,
                     load_resume_state)
from .recovery import (CheckpointError, DecodeCheckpoint, DecodeTimeout, RecoveryConfig,
                       RecoveryCounters, Watchdog)

__all__ = ["DRAFT_SOURCES", "MAX_SPEC_K", "SpecConfig", "draft_from_params",
           "generate_speculative", "resume_speculative", "spec_capacity"]

MAX_SPEC_K = 16  # verify window ceiling: beyond this the draft rarely holds
DRAFT_SOURCES = ("stage0",)


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
    cfg.require_uniform("the speculative draft")
    limit = (cut + 1) if cut is not None else cfg.num_layers
    n = spec.draft_layers if spec.draft_layers is not None else limit
    if not 1 <= n <= limit:
        raise ValueError(
            f"draft_layers={n} must be in [1, {limit}] — stage 0 owns "
            f"layers 0..{limit - 1} and the draft must run hop-free there")
    draft_params = params_to(raw_params)
    draft_params["layers"] = draft_params["layers"][:n]
    return dataclasses.replace(cfg, num_layers=n), draft_params


def spec_capacity(prompt_len: int, max_new_tokens: int, k: int) -> int:
    """Cache rows a speculative run can touch: the last burst may start with
    ``max_new_tokens - 1`` committed tokens and still write all k verify
    rows past the vanilla fill level."""
    return max(prompt_len + max_new_tokens, prompt_len + max_new_tokens + k - 2)


def generate_speculative(rt: Any, placed_params: dict, prompt_ids, max_new_tokens: int, *,
                         spec: SpecConfig, capacity: Optional[int] = None,
                         temperature: float = 0.0, rng_key: Optional[tuple] = None,
                         fault_step: int = 0, stats: Optional[dict] = None,
                         recovery: Optional[RecoveryConfig] = None,
                         raw_params: Optional[dict] = None,
                         link_health: Any = None,
                         observe: Optional[LatencyObserver] = None) -> torch.Tensor:
    """``generate_split`` through the burst loop -> (1, max_new_tokens) int32
    (speculation is per stream: batch 1). Greedy output equals the vanilla
    loop's on the same seed and plan. ``raw_params`` (the unplaced weights)
    is required: the draft is sliced from it and runs where it lives.
    ``stats`` gets the vanilla keys (``decode_steps`` counts the tokens the
    bursts emitted) and ``speculative``: k, draft_layers, bursts, drafted,
    accepted, rejected, acceptance_rate, hops_per_token and
    ``draft_step_cache_misses`` (0: nothing compiles). ``fault_step``,
    ``link_health``, ``recovery`` and ``observe`` are ``generate_split``'s
    (recovery at burst granularity; a stage failure is refused)."""
    if not spec.enabled:
        raise ValueError("generate_speculative called with spec.enabled=False; use "
                         "generate_split (which this disabled config leaves byte-identical)")
    if not hasattr(rt, "verify_step"):
        raise ValueError("speculative decoding needs the split runtime's k-token "
                         f"verify_step; {type(rt).__name__} has none")
    if raw_params is None:
        raise ValueError("speculative decoding needs raw_params= (the unplaced parameter "
                         "pytree) to slice out the stage-0 draft layers")
    if recovery is not None and recovery.stage_failure is not None:
        raise ValueError("speculative decoding does not compose with stage-failure "
                         "injection (failover re-plans the runtime mid-run); run failover "
                         "drills on the vanilla loop")
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
                      key, fault_step, spec, draft_cfg, draft_params, stats, recovery,
                      link_health=link_health, observe=observe)


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
        # the accept test reads one uniform and one probability a drafted
        # token on the host, as the reference's _accept does
        if float(u) < float(probs[dj]):  # graphlint: disable=EG005
            emitted.append(dj)
            continue
        resid = probs.clone()
        resid[dj] = 0.0
        rkey = prng.fold_in(pkey, torch.tensor([2])).to(vlogits.device)
        # the residual draw ends the burst: one sync at the first rejection
        emitted.append(int(prng.categorical(rkey, torch.log(resid))))  # graphlint: disable=EG005
        return emitted, j - 1
    bonus = _sample(vlogits[:, k - 1], _fold(key, n + k - 1), temperature)
    return emitted + [int(bonus[0])], k - 1


def _spec_loop(rt, placed: dict, prompt_ids: torch.Tensor, max_new_tokens: int,
               capacity: int, temperature: float, key, fault_step: int, spec: SpecConfig,
               draft_cfg: ModelConfig, draft_params: dict, stats: Optional[dict],
               rec: Optional[RecoveryConfig], link_health: Any = None, resume_state=None,
               resumed: bool = False,
               observe: Optional[LatencyObserver] = None) -> torch.Tensor:
    """The burst loop. ``resume_state`` = (last_done_step, toks, cache)
    continues a checkpointed run from the burst boundary at step
    ``last_done_step`` (the draft cache is rebuilt by a draft prefill over
    the committed prefix)."""
    b, s = prompt_ids.shape
    k = spec.k
    counters = RecoveryCounters()
    wd = (Watchdog(rec.deadline_s, clock=rec.clock)
          if rec is not None and rec.deadline_s is not None else None)
    run_meta = {"capacity": int(capacity), "temperature": float(temperature),
                "max_new_tokens": int(max_new_tokens), "fault_step": int(fault_step),
                "prompt_len": int(s), "batch": int(b),
                "speculative": {"k": int(k), "draft_source": spec.draft_source,
                                "draft_layers": int(draft_cfg.num_layers)}}
    counters0 = rt.link_counters()
    draft_device = draft_params["embed"].device
    halted_at = None
    if observe is not None:
        observe.start()
    if wd is not None:
        wd.arm()

    def checkpoint(toks, cache, t):
        _write_checkpoint(rec, rt, counters, prompt_ids, toks, cache, key, t, run_meta)

    t0 = time.monotonic()
    if resume_state is None:
        with obs_span("generate_spec.prefill", batch=b, prompt_len=s):
            logits, cache = rt.prefill_decode(placed, prompt_ids, capacity,
                                              fault_step=fault_step)
            tok = _sample(logits[:, -1], _fold(key, 0), temperature)
            # the draft prefill fills the stage-0 cache to the same level (its
            # logits are discarded: token 0 is the target's, as in the vanilla
            # loop)
            _, dcache = prefill(draft_cfg, draft_params, prompt_ids.to(draft_device), capacity)
            toks = [int(tok[0])]
            _sync(rt.devices[-1])
        if observe is not None:
            observe.first_token(tok)
        t1 = time.monotonic()
        if rec is not None and rec.halt_at_step == 0:
            checkpoint(toks, cache, 0)
            halted_at = 0
        elif rec is not None and rec.checkpoint_every and rec.checkpoint_path:
            checkpoint(toks, cache, 0)
    else:
        _, toks_in, cache = resume_state
        toks = [int(t.reshape(-1)[0]) for t in toks_in]
        fed = torch.cat([prompt_ids.cpu(), torch.tensor([toks[:-1]], dtype=torch.long)], 1)
        with obs_span("generate_spec.resume_draft_prefill", prefix_len=int(fed.shape[1])):
            _, dcache = prefill(draft_cfg, draft_params, fed.to(draft_device), capacity)
        t1 = t0

    n = len(toks)
    drafted = accepted = rejected = bursts = emitted_total = 0
    with obs_span("generate_spec.burst_loop", k=k, budget=max_new_tokens - n):
        while halted_at is None and n < max_new_tokens:
            t_prev = n - 1
            feed = [toks[-1]]
            for _ in range(1, k):
                dlogits, dcache = decode_step(
                    draft_cfg, draft_params, dcache,
                    torch.tensor([feed[-1]], dtype=torch.long, device=draft_device))
                # the greedy draft token feeds the next draft step from the
                # host: one sync a drafted token
                feed.append(int(dlogits.argmax(dim=-1)[0]))  # graphlint: disable=EG005
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
            if observe is not None:
                for e in emitted:
                    observe.token(e)
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
            # recovery hooks, at burst granularity
            t = n - 1
            if rec is not None:
                with obs_context.bind(spec_burst=bursts):
                    if rec.halt_at_step is not None and t >= rec.halt_at_step:
                        checkpoint(toks, cache, t)
                        halted_at = t
                        break
                    if (rec.checkpoint_every and rec.checkpoint_path
                            and t_prev // rec.checkpoint_every < t // rec.checkpoint_every):
                        checkpoint(toks, cache, t)
                    if wd is not None:
                        ckpt_fn = ((lambda: checkpoint(toks, cache, t)) if rec.checkpoint_path
                                   else None)
                        try:
                            wd.check(ckpt_fn)
                        except DecodeTimeout:
                            counters.watchdog_fires += 1
                            if stats is not None:
                                stats["recovery_counters"] = counters.as_dict()
                            raise
    out = torch.tensor([toks], dtype=torch.int32, device=rt.devices[-1])
    _sync(rt.devices[-1])
    t2 = time.monotonic()
    if resumed and halted_at is None:
        counters.resume_ok += 1
    spec_stats = {
        "k": int(k), "draft_layers": int(draft_cfg.num_layers), "bursts": bursts,
        "drafted": drafted, "accepted": accepted, "rejected": rejected,
        "acceptance_rate": (accepted / drafted) if drafted else 0.0,
        "hops_per_token": (bursts / emitted_total) if emitted_total else 0.0,
        "draft_step_cache_misses": 0}
    delta = counter_delta(rt, counters0)
    if link_health is not None:
        link_health.observe(delta)
    record_link_counters(delta)
    if link_health is not None:
        record_link_health(link_health.summary())
    record_spec_stats(spec_stats)
    if get_registry().enabled:
        record_wire_bytes(rt.verify_hop_bytes(b, k), kind="verify", steps=bursts)
        record_probe_decisions(rt.wire_summary(b, k))
    if tracing_enabled():
        # one hop round a burst: the k-token verify payload times the bursts
        _emit_hop_spans(rt, delta, [x * bursts for x in rt.verify_hop_bytes(b, k)],
                        link_tier=getattr(link_health, "tier", None),
                        spec_bursts=int(bursts))
    if stats is not None:
        stats.update(
            capacity=capacity, prefill_s=t1 - t0, decode_s=t2 - t1,
            decode_steps=emitted_total,
            decode_tokens_per_s=(emitted_total / (t2 - t1)) if emitted_total and t2 > t1
            else 0.0,
            speculative=spec_stats)
        if halted_at is not None:
            stats["halted_at_step"] = halted_at
        if rec is not None or resumed:
            stats["recovery_counters"] = counters.as_dict()
        if delta is not None:
            stats["link_counters"] = delta
        if link_health is not None:
            stats["link_health"] = link_health.summary()
        if observe is not None:
            stats.update(observe.summary())
        record_decode_stats(stats)
    if rec is not None or resumed:
        record_recovery_counters(counters)
    if observe is not None:
        observe.publish()
    return out


def resume_speculative(rt: Any, placed_params: dict, checkpoint_path: str, *,
                       spec: SpecConfig, stats: Optional[dict] = None,
                       recovery: Optional[RecoveryConfig] = None,
                       raw_params: Optional[dict] = None,
                       observe: Optional[LatencyObserver] = None) -> torch.Tensor:
    """Resume a checkpointed speculative generation -> the full (1, max_new)
    token matrix, equal to the uninterrupted run's (checkpoints land on
    burst boundaries, which depend only on the committed prefix). Checks
    the plan and model signature as ``resume_split`` does, plus the
    checkpoint's ``speculative`` block against ``spec``; a vanilla
    checkpoint resumes too (greedy identity does not care where the
    boundaries fall)."""
    if not spec.enabled:
        raise ValueError("resume_speculative called with spec.enabled=False; use "
                         "resume_split")
    if raw_params is None:
        raise ValueError("speculative resume needs raw_params= (the unplaced parameter "
                         "pytree) to rebuild the stage-0 draft")
    with obs_span("decode.checkpoint_resume", path=checkpoint_path):
        ckpt = DecodeCheckpoint.load(checkpoint_path)
    meta = ckpt.meta
    _check_plan(meta, rt, checkpoint_path,
                (("mode", "runtime mode", None), ("model", "model signature", None),
                 ("cuts", "split cuts", None), ("hop_codecs", "hop codecs", None)))
    cut = int(rt.split.cuts[0]) if rt.split.cuts else None
    draft_cfg, draft_params = draft_from_params(rt.cfg, raw_params, spec, cut)
    sm = meta.get("speculative")
    if sm is not None:
        got = {"k": int(spec.k), "draft_source": spec.draft_source,
               "draft_layers": int(draft_cfg.num_layers)}
        if {kk: sm.get(kk) for kk in got} != got:
            raise CheckpointError(
                f"checkpoint {checkpoint_path} was written with speculative config {sm!r}, "
                f"the resuming run has {got!r}; a window or draft mismatch breaks the "
                f"token-identical-resume guarantee")
    prompt_ids, key, step, toks, cache = load_resume_state(rt, placed_params, ckpt,
                                                           checkpoint_path)
    if recovery is not None and recovery.stage_failure is not None:
        raise ValueError("speculative decoding does not compose with stage-failure "
                         "injection; run failover drills on the vanilla loop")
    if stats is not None:
        stats["resumed_from_step"] = step
        if "link_counters" in meta:
            stats["checkpoint_link_counters"] = meta["link_counters"]
    return _spec_loop(rt, placed_params, prompt_ids, int(meta["max_new_tokens"]),
                      int(meta["capacity"]), float(meta["temperature"]), key,
                      int(meta["fault_step"]), spec, draft_cfg, draft_params, stats,
                      recovery, resume_state=(step, toks, cache), resumed=True,
                      observe=observe)
