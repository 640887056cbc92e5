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
Under a faulty link each call's per-hop counter delta lands in
``stats["link_counters"]`` (a ``link_health=`` tracker observes it).

Survivability (``recovery=`` on both loops, :mod:`.recovery`): the same
loop snapshots its generation state to an atomic
:class:`~.recovery.DecodeCheckpoint` (periodically, at ``halt_at_step`` or
on a watchdog timeout), survives a whole-stage loss by re-planning the
split onto the surviving stage devices and re-prefilling the generation
prefix there, and resumes from a checkpoint token for token
(:func:`resume_split`). With ``recovery=None`` the loop is the plain one.
There is no jit here: PyTorch runs eagerly, so nothing compiles per shape
and there are no cache misses to count.

On a pipelined runtime (``SplitRuntime(pipeline=...)``) every decode step
runs the µ-batch schedule; ``stats["pipeline"]`` holds its summary, the
wire bytes are the µ-batched ones (``pipelined_decode_hop_bytes``), and a
failover rebuilds the runtime with the same pipeline.

Observability, as the reference places it: ``generate*.prefill`` /
``generate*.decode_loop`` and ``decode.*`` spans, one ``split.hop`` span a
cut at call granularity (:func:`_emit_hop_spans`), the ``record_*``
adapters into the global registry, and ``observe=``, a
:class:`~..obs.latency.LatencyObserver` (one sync a sampled token). With
observability off every hook is a flag test: no sync, no extra kernel.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from ..lint import graph_contract
from ..models.configs import ModelConfig
from ..obs.latency import LatencyObserver
from ..obs.metrics import (get_registry, record_decode_stats, record_link_counters,
                           record_link_health, record_pipeline_stats, record_probe_decisions,
                           record_recovery_counters, record_wire_bytes)
from ..obs.tracing import span as obs_span
from ..obs.tracing import tracing_enabled
from ..models.transformer import (KVCache, _cast_params, block_verify, decode_step, embed,
                                  params_to, precompute_rope, prefill, unembed)
from ..utils import prng
from .recovery import (CheckpointError, DecodeCheckpoint, DecodeTimeout, LocalRuntime,
                       RecoveryConfig, RecoveryCounters, StageLostError, Watchdog,
                       runtime_plan_meta)

__all__ = ["generate", "generate_split", "resume_split"]


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


@graph_contract("decode.prefill", hops=0,
                launches=lambda ctx: {"causal_attention": ctx["layers"]})
def _prefill_impl(cfg: ModelConfig, params: dict, prompt_ids: torch.Tensor, capacity: int,
                  compute_dtype) -> tuple[torch.Tensor, KVCache]:
    """Prompt prefill -> (last-position logits (B, V) fp32, filled cache)."""
    logits, cache = prefill(cfg, params, prompt_ids, capacity, compute_dtype=compute_dtype)
    return logits[:, -1], cache


@graph_contract("decode.prefill_suffix", hops=0, launches={},
                in_place=lambda ctx: ctx.get("in_place_min", 2))
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
    for idx, lp in enumerate(params["layers"]):
        hidden = block_verify(cfg, lp, hidden, cos_t, sin_t, cache.k[idx], cache.v[idx], pos)
    return unembed(cfg, params, hidden), KVCache(cache.k, cache.v, pos + kq)


@graph_contract("decode.step", hops=0, launches={},
                in_place=lambda ctx: ctx.get("in_place_min", 2))
def _step_impl(cfg: ModelConfig, params: dict, cache: KVCache, token_ids: torch.Tensor,
               key, temperature: float, compute_dtype) -> tuple[torch.Tensor, KVCache]:
    logits, cache = decode_step(cfg, params, cache, token_ids, compute_dtype=compute_dtype)
    return _sample(logits, key, temperature), cache


def _emit_hop_spans(rt: Any, delta: Optional[dict], per_hop_bytes: Optional[list], *,
                    link_tier: Optional[int] = None, **extra: Any) -> None:
    """One zero-duration ``split.hop`` span a boundary cut, at call
    granularity: {hop, cut layer, codec, wire bytes, ladder outcome} plus
    the caller's extras (µ-batch count, spec bursts) and, through the bound
    trace context, the request labels. Gated on tracing, so disabled
    tracing skips the attribution arithmetic too; a runtime without a
    boundary (``LocalRuntime``) emits nothing."""
    if not tracing_enabled() or not hasattr(rt, "hop_attribution"):
        return
    for row in rt.hop_attribution(delta, per_hop_bytes, link_tier=link_tier):
        with obs_span("split.hop", **row, **extra):
            pass


def _microbatches(rt: Any) -> int:
    """The µ-batch count a runtime's decode steps run (1 unpipelined)."""
    return int(rt.pipeline.num_microbatches) if getattr(rt, "pipelined", False) else 1


def _step_hop_bytes(rt: Any, b: int) -> list:
    """The wire bytes one decode step of batch ``b`` moves a hop."""
    return (rt.pipelined_decode_hop_bytes(b) if getattr(rt, "pipelined", False)
            else rt.decode_hop_bytes(b))


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
             stats: Optional[dict] = None,
             recovery: Optional[RecoveryConfig] = None,
             observe: Optional[LatencyObserver] = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` per batch row after a KV-cached prefill.

    prompt_ids: (B, S) int token ids (a tensor on the device the weights
    live on, or an array). Returns (B, max_new_tokens) int32. ``capacity``
    (default exactly prompt + new) bounds the cache; a prompt that would
    overflow it raises. ``rng_key`` is a :func:`..utils.prng.key` pair
    (default ``key(0)``). ``stats``, when given, gets the reference's timing
    keys (``decode_step_cache_misses`` is 0: nothing compiles).

    ``recovery`` routes the call through the survivable loop on a
    :class:`~.recovery.LocalRuntime` (checkpoints, the watchdog; a stage
    failure does not apply on one device). ``observe``: a
    :class:`~..obs.latency.LatencyObserver` records TTFT and per-token
    latency (one sync a sampled token); its summary joins ``stats``."""
    device = params["embed"].device
    prompt_ids, capacity, temperature, key = _validate_decode_args(
        prompt_ids, max_new_tokens, capacity, temperature, rng_key, device)
    b, s = prompt_ids.shape
    if recovery is not None:
        return _survivable_loop(LocalRuntime(cfg, compute_dtype), params, prompt_ids,
                                max_new_tokens, capacity, temperature, key, 0, stats,
                                recovery, raw_params=params, observe=observe)
    if observe is not None:
        observe.start()
    t0 = time.monotonic()
    with obs_span("generate.prefill", batch=b, prompt_len=s):
        last_logits, cache = _prefill_impl(cfg, params, prompt_ids, capacity, compute_dtype)
        tok = _sample(last_logits, _fold(key, 0), temperature)
        _sync(device)
    if observe is not None:
        observe.first_token(tok)
    t1 = time.monotonic()
    toks = [tok]
    with obs_span("generate.decode_loop", steps=max_new_tokens - 1):
        for t in range(1, max_new_tokens):
            tok, cache = _step_impl(cfg, params, cache, tok.long(), _fold(key, t), temperature,
                                    compute_dtype)
            if observe is not None:
                observe.token(tok)
            toks.append(tok)
    out = torch.stack(toks, dim=1)
    _sync(device)
    t2 = time.monotonic()
    _decode_stats(stats, capacity, b, max_new_tokens - 1, t0, t1, t2)
    if stats is not None:
        stats["decode_step_cache_misses"] = 0
        if observe is not None:
            stats.update(observe.summary())
        record_decode_stats(stats)
    if observe is not None:
        observe.publish()
    return out


def generate_split(rt: Any, placed_params: dict, prompt_ids, max_new_tokens: int, *,
                   capacity: Optional[int] = None, temperature: float = 0.0,
                   rng_key: Optional[tuple] = None, fault_step: int = 0,
                   stats: Optional[dict] = None, recovery: Optional[RecoveryConfig] = None,
                   raw_params: Optional[dict] = None, link_health: Any = None,
                   speculative: Any = None,
                   observe: Optional[LatencyObserver] = None) -> torch.Tensor:
    """``generate`` over a :class:`~..parallel.split.SplitRuntime`: one split
    prefill (:meth:`~..parallel.split.SplitRuntime.prefill_decode`), then one
    ``rt.decode_step`` per token, each crossing every cut as a packed (B, 1,
    D) payload, under a faulty link a sealed, verified and retried one
    (each step keyed by the cache fill level; ``fault_step`` folds the
    prefill's key). Sampling is :func:`generate`'s: ``fold_in(key, t)`` for
    token t. ``placed_params`` comes from ``rt.place_params``; ``stats``
    gets the reference's keys (``capacity``, ``prefill_s``, ``decode_s``,
    ``decode_steps``, ``decode_tokens_per_s``) and, under a link,
    ``link_counters``: this call's per-hop delta.

    ``link_health`` (a :class:`~..codecs.fec.LinkHealth`) observes this
    call's delta and lands its summary in ``stats["link_health"]``.
    ``recovery`` routes the call through the survivable loop (checkpoints,
    the watchdog, stage-failure injection and failover, which needs
    ``raw_params``, the unplaced weights).

    ``speculative``: an enabled :class:`~.speculative.SpecConfig` runs the
    draft / verify burst loop (needs ``raw_params``, from which the stage-0
    draft is sliced); None or a disabled config is this loop.

    On a pipelined runtime each step runs the µ-batch schedule (the batch
    must split into its µ-batches) and ``stats["pipeline"]`` holds
    ``rt.pipeline_summary()``. ``observe``: as :func:`generate`."""
    if speculative is not None and speculative.enabled:
        from .speculative import generate_speculative

        return generate_speculative(rt, placed_params, prompt_ids, max_new_tokens,
                                    spec=speculative, capacity=capacity,
                                    temperature=temperature, rng_key=rng_key,
                                    fault_step=fault_step, stats=stats, recovery=recovery,
                                    raw_params=raw_params, link_health=link_health,
                                    observe=observe)
    device = rt.devices[0]
    prompt_ids, capacity, temperature, key = _validate_decode_args(
        prompt_ids, max_new_tokens, capacity, temperature, rng_key, device)
    b, s = prompt_ids.shape
    if recovery is not None:
        return _survivable_loop(rt, placed_params, prompt_ids, max_new_tokens, capacity,
                                temperature, key, fault_step, stats, recovery,
                                raw_params=raw_params, observe=observe)
    counters0 = rt.link_counters()
    if observe is not None:
        observe.start()
    t0 = time.monotonic()
    with obs_span("generate_split.prefill", batch=b, prompt_len=s):
        logits, cache = rt.prefill_decode(placed_params, prompt_ids, capacity,
                                          fault_step=fault_step)
        tok = _sample(logits[:, -1], _fold(key, 0), temperature)
        _sync(rt.devices[-1])
    if observe is not None:
        observe.first_token(tok)
    t1 = time.monotonic()
    toks = [tok]
    with obs_span("generate_split.decode_loop", steps=max_new_tokens - 1):
        for t in range(1, max_new_tokens):
            step_logits, cache = rt.decode_step(placed_params, cache, tok.long())
            tok = _sample(step_logits, _fold(key, t), temperature)
            if observe is not None:
                observe.token(tok)
            toks.append(tok)
    out = torch.stack(toks, dim=1)
    _sync(rt.devices[-1])
    t2 = time.monotonic()
    delta = counter_delta(rt, counters0)
    if link_health is not None:
        link_health.observe(delta)
    record_link_counters(delta)
    if link_health is not None:
        record_link_health(link_health.summary())
    pipelined = bool(getattr(rt, "pipelined", False))
    hop_bytes = (_step_hop_bytes(rt, b) if get_registry().enabled or tracing_enabled()
                 else None)
    if get_registry().enabled:
        record_wire_bytes(hop_bytes, kind="decode", steps=max_new_tokens - 1)
        if hasattr(rt, "wire_summary"):
            record_probe_decisions(rt.wire_summary(b, max(s, 1)))
    _emit_hop_spans(rt, delta, None if hop_bytes is None
                    else [x * (max_new_tokens - 1) for x in hop_bytes],
                    link_tier=getattr(link_health, "tier", None),
                    microbatches=_microbatches(rt))
    if pipelined:
        record_pipeline_stats(rt.pipeline_summary())
    _decode_stats(stats, capacity, b, max_new_tokens - 1, t0, t1, t2)
    if stats is not None:
        if pipelined:
            stats["pipeline"] = rt.pipeline_summary()
        if delta is not None:
            stats["link_counters"] = delta
        if link_health is not None:
            stats["link_health"] = link_health.summary()
        if observe is not None:
            stats.update(observe.summary())
        record_decode_stats(stats)
    if observe is not None:
        observe.publish()
    return out


def counter_delta(rt: Any, counters0: Optional[dict]) -> Optional[dict]:
    """The runtime's per-hop link counters since ``counters0`` (its
    ``link_counters()`` before the call) as int lists; None without a
    link."""
    counters1 = rt.link_counters()
    if counters1 is None:
        return None
    return {k: [int(x) for x in (v if counters0 is None else v - counters0[k])]
            for k, v in counters1.items()}


def _sync(device: Any) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the survivable loop: checkpoints, watchdog, stage failover, resume
# ---------------------------------------------------------------------------


def _host_tokens(toks: list) -> np.ndarray:
    """The sampled steps as one host (B, steps) int32 array."""
    return np.stack([np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t, np.int32)
                     .reshape(-1) for t in toks], axis=1)


def _write_checkpoint(rec: RecoveryConfig, rt, counters: RecoveryCounters, prompt_ids,
                      toks: list, cache, key, t: int, run_meta: dict) -> None:
    """Snapshot everything step t + 1 needs to the atomic checkpoint file:
    ``toks`` holds steps 0..t, the cache the prompt plus steps 0..t-1 (the
    loop state at the top of iteration t + 1). The leaves and meta are the
    reference's: ``rng_key`` as JAX's uint32 key words, ``cache/length``
    int32, the split cache in the padded per-stage layout."""
    with obs_span("decode.checkpoint_write", step=t):
        _write_checkpoint_impl(rec, rt, counters, prompt_ids, toks, cache, key, t, run_meta)


def _write_checkpoint_impl(rec: RecoveryConfig, rt, counters: RecoveryCounters, prompt_ids,
                           toks: list, cache, key, t: int, run_meta: dict) -> None:
    cs = rt.cache_state(cache)
    arrays = {"prompt_ids": np.asarray(prompt_ids.cpu(), np.int32),
              "tokens": _host_tokens(toks),
              "rng_key": np.asarray(key, np.uint32),
              "cache/k": cs["k"], "cache/v": cs["v"], "cache/length": cs["length"]}
    meta = {**runtime_plan_meta(rt), **run_meta, "step": int(t),
            "recovery_counters": counters.as_dict()}
    link = rt.link_counters()
    if link is not None:
        meta["link_counters"] = {k: [int(x) for x in v] for k, v in link.items()}
    DecodeCheckpoint(arrays, meta).save(rec.checkpoint_path)
    counters.checkpoints_written += 1


def _decode_failover(rt, raw_params, lost_stage: int, prompt_ids, toks: list,
                     capacity: int, fault_step: int, counters: RecoveryCounters,
                     rec: RecoveryConfig):
    """Re-plan the split onto the surviving stage(s) and rebuild the decode
    state there. The lost stage's KV cache cannot be recovered, so the
    whole generation prefix (prompt plus every sampled token) is re-prefilled
    on the new plan; its last-position logits are what the failed step would
    have produced -> (new_rt, new_placed, cache, last_logits)."""
    if not rec.replan or counters.failovers >= rec.max_failovers:
        raise StageLostError(lost_stage)
    if raw_params is None:
        raise ValueError("stage failover needs raw_params= (the unplaced parameter "
                         "pytree) to re-place weights onto the surviving devices")
    counters.failovers += 1
    with obs_span("decode.failover", lost_stage=lost_stage):
        return _decode_failover_impl(rt, raw_params, lost_stage, prompt_ids, toks, capacity,
                                     fault_step, counters)


def _decode_failover_impl(rt, raw_params, lost_stage: int, prompt_ids, toks: list,
                          capacity: int, fault_step: int, counters: RecoveryCounters):
    """The re-plan, re-place and re-prefill of :func:`_decode_failover`
    (apart, so its span covers exactly that work)."""
    survivors = [d for i, d in enumerate(rt.devices) if i != lost_stage]
    cfg = rt.cfg
    if len(survivors) >= 2:
        from ..parallel.split import SplitRuntime

        # faults, policy and the µ-batch schedule carry over, as the
        # reference carries them (its decode failover rebuilds without fec /
        # hedge); the batch is unchanged and the re-planned cuts reuse the
        # (batch-invariant) first codec, so the pipeline still validates
        new_rt = SplitRuntime(cfg, rt.split.replan(cfg.num_layers, len(survivors)),
                              survivors, faults=rt.faults, policy=rt.policy,
                              pipeline=getattr(rt, "pipeline", None))
    else:
        new_rt = LocalRuntime(cfg)  # one survivor: nothing left to cut
    counters.replans += 1
    new_placed = new_rt.place_params(params_to(raw_params, device=survivors[0]))
    prompt = prompt_ids.cpu().long()
    prefix = (prompt if not toks else
              torch.cat([prompt, torch.from_numpy(_host_tokens(toks)).long()], dim=1))
    logits, cache = new_rt.prefill_decode(new_placed, prefix.to(survivors[0]), capacity,
                                          fault_step=fault_step)
    counters.recompute_tokens += int(prefix.shape[0] * prefix.shape[1])
    return new_rt, new_placed, cache, logits[:, -1]


def _survivable_loop(rt, placed, prompt_ids: torch.Tensor, max_new_tokens: int,
                     capacity: int, temperature: float, key, fault_step: int,
                     stats: Optional[dict], rec: RecoveryConfig, raw_params: Optional[dict],
                     resume_state=None, resumed: bool = False,
                     observe: Optional[LatencyObserver] = None) -> torch.Tensor:
    """The decode loop with the reference's recovery orchestration around
    the runtime's calls. ``resume_state`` = (last_done_step, toks, cache)
    continues a checkpointed generation from step ``last_done_step + 1``."""
    counters = RecoveryCounters()
    wd = Watchdog(rec.deadline_s, clock=rec.clock) if rec.deadline_s is not None else None
    b, s = prompt_ids.shape
    sf = rec.stage_failure
    fail_pending = sf is not None
    run_meta = {"capacity": int(capacity), "temperature": float(temperature),
                "max_new_tokens": int(max_new_tokens), "fault_step": int(fault_step),
                "prompt_len": int(s), "batch": int(b)}
    counters0 = rt.link_counters()
    halted_at = None
    if observe is not None:
        observe.start()

    def post_step(t, toks, cache) -> bool:
        """The halt hook, the periodic checkpoint, the watchdog, in that
        order; True when the loop must stop (a simulated kill)."""
        if rec.halt_at_step is not None and rec.halt_at_step == t:
            _write_checkpoint(rec, rt, counters, prompt_ids, toks, cache, key, t, run_meta)
            return True
        if rec.checkpoint_every and rec.checkpoint_path and t % rec.checkpoint_every == 0:
            _write_checkpoint(rec, rt, counters, prompt_ids, toks, cache, key, t, run_meta)
        if wd is not None:
            ckpt_fn = ((lambda: _write_checkpoint(rec, rt, counters, prompt_ids, toks, cache,
                                                  key, t, run_meta))
                       if rec.checkpoint_path else None)
            try:
                wd.check(ckpt_fn)
            except DecodeTimeout:
                counters.watchdog_fires += 1
                if stats is not None:
                    stats["recovery_counters"] = counters.as_dict()
                raise
        return False

    t0 = time.monotonic()
    if wd is not None:
        wd.arm()
    if resume_state is None:
        if fail_pending and sf.at_step == 0:
            rt.mark_stage_lost(sf.stage)
        try:
            logits, cache = rt.prefill_decode(placed, prompt_ids, capacity,
                                              fault_step=fault_step)
            last = logits[:, -1]
        except StageLostError as e:
            fail_pending = False
            rt, placed, cache, last = _decode_failover(
                rt, raw_params, e.stage, prompt_ids, [], capacity, fault_step, counters, rec)
        tok = _sample(last, _fold(key, 0), temperature)
        _sync(tok.device)
        if observe is not None:
            observe.first_token(tok)
        t1 = time.monotonic()
        toks = [tok]
        start_t = 1
        if post_step(0, toks, cache):
            halted_at = 0
    else:
        last_done, toks, cache = resume_state
        tok = toks[-1]
        t1 = t0
        start_t = last_done + 1
    if halted_at is None:
        for t in range(start_t, max_new_tokens):
            if fail_pending and sf.at_step == t:
                rt.mark_stage_lost(sf.stage)
            try:
                step_logits, cache = rt.decode_step(placed, cache, tok.long())
                tok = _sample(step_logits, _fold(key, t), temperature)
            except StageLostError as e:
                fail_pending = False
                rt, placed, cache, last = _decode_failover(
                    rt, raw_params, e.stage, prompt_ids, toks, capacity, fault_step,
                    counters, rec)
                tok = _sample(last, _fold(key, t), temperature)
            if observe is not None:
                observe.token(tok)
            toks.append(tok)
            if post_step(t, toks, cache):
                halted_at = t
                break
    # assembled on the host: after a failover the prefix and the tail may
    # live on different devices
    out = torch.from_numpy(_host_tokens(toks)).to(tok.device)
    t2 = time.monotonic()
    if resumed and halted_at is None:
        counters.resume_ok += 1
    delta = None
    if stats is not None or tracing_enabled():
        # after a failover the runtime is new: absolute totals, not deltas
        delta = counter_delta(rt, None if counters.failovers else counters0)
    steps = len(toks) - (0 if resume_state is not None else 1)
    if stats is not None:
        stats.update(capacity=capacity, prefill_s=t1 - t0, decode_s=t2 - t1,
                     decode_steps=steps,
                     decode_tokens_per_s=(b * steps / (t2 - t1)) if steps and t2 > t1
                     else 0.0)
        if halted_at is not None:
            stats["halted_at_step"] = halted_at
        stats["recovery_counters"] = counters.as_dict()
        if delta is not None:
            stats["link_counters"] = delta
            record_link_counters(delta)
        if observe is not None:
            stats.update(observe.summary())
        record_decode_stats(stats)
    if tracing_enabled() and hasattr(rt, "hop_attribution"):
        _emit_hop_spans(rt, delta, [x * max(steps, 0) for x in _step_hop_bytes(rt, b)],
                        microbatches=_microbatches(rt), failovers=int(counters.failovers))
    record_recovery_counters(counters)
    if observe is not None:
        observe.publish()
    return out


def _check_plan(meta: dict, rt, path: str, keys) -> None:
    """Refuse a checkpoint whose plan / model signature is not ``rt``'s."""
    want = runtime_plan_meta(rt)
    for k, label, dflt in keys:
        if meta.get(k, dflt) != want.get(k, dflt):
            raise CheckpointError(
                f"checkpoint {path} was written for {label} {meta.get(k)!r}, the resuming "
                f"runtime has {want.get(k)!r}; rebuild the runtime to match (or re-plan "
                f"explicitly)")


def load_resume_state(rt, placed: dict, ckpt: DecodeCheckpoint, path: str) -> tuple:
    """A checkpoint's generation state on ``rt``'s devices -> (prompt_ids,
    key, step, toks, cache): the sampled steps as (B,) int32 tensors on the
    last stage's device, the cache restored bit for bit."""
    meta = ckpt.meta
    dev = rt.devices[0] if hasattr(rt, "devices") else placed["embed"].device
    last_dev = rt.devices[-1] if hasattr(rt, "devices") else dev
    prompt_ids = torch.from_numpy(np.asarray(ckpt.arrays["prompt_ids"])).long().to(dev)
    tokens = np.asarray(ckpt.arrays["tokens"])
    key = tuple(int(x) for x in np.asarray(ckpt.arrays["rng_key"], np.uint32))
    state = {"k": ckpt.arrays["cache/k"], "v": ckpt.arrays["cache/v"],
             "length": ckpt.arrays["cache/length"]}
    cache = rt.load_cache_state(state, placed)
    toks = [torch.from_numpy(tokens[:, i].astype(np.int32)).to(last_dev)
            for i in range(tokens.shape[1])]
    step = int(meta["step"])
    if len(toks) != step + 1:
        raise CheckpointError(f"checkpoint {path} is inconsistent: step {step} with "
                              f"{len(toks)} sampled tokens")
    return prompt_ids, key, step, toks, cache


def resume_split(rt: Any, placed_params: dict, checkpoint_path: str, *,
                 stats: Optional[dict] = None, recovery: Optional[RecoveryConfig] = None,
                 raw_params: Optional[dict] = None, speculative: Any = None,
                 observe: Optional[LatencyObserver] = None) -> torch.Tensor:
    """Resume a checkpointed generation -> the full (B, max_new) token
    matrix, the checkpointed prefix plus the tokens decoded here, equal to
    the uninterrupted same-seed run's. ``rt`` must match the checkpoint's
    plan and model signature (else :class:`~.recovery.CheckpointError`: a
    card checkpoint names the ``*_pallas`` twins, which a CPU runtime does
    not run); the KV cache is restored bit for bit. ``recovery`` re-arms
    checkpoints, the watchdog and failover for the resumed tail (its
    ``stage_failure`` steps are absolute). A :class:`~.recovery.LocalRuntime`
    resumes ``generate``'s checkpoints. ``speculative``: an enabled
    SpecConfig resumes through the burst loop
    (:func:`~.speculative.resume_speculative`)."""
    if speculative is not None and speculative.enabled:
        from .speculative import resume_speculative

        return resume_speculative(rt, placed_params, checkpoint_path, spec=speculative,
                                  stats=stats, recovery=recovery, raw_params=raw_params,
                                  observe=observe)
    with obs_span("decode.checkpoint_resume", path=checkpoint_path):
        ckpt = DecodeCheckpoint.load(checkpoint_path)
    meta = ckpt.meta
    _check_plan(meta, rt, checkpoint_path,
                (("mode", "runtime mode", None), ("model", "model signature", None),
                 ("cuts", "split cuts", None), ("hop_codecs", "hop codecs", None),
                 ("num_microbatches", "pipeline µ-batch count", 1)))
    prompt_ids, key, step, toks, cache = load_resume_state(rt, placed_params, ckpt,
                                                           checkpoint_path)
    rec = recovery if recovery is not None else RecoveryConfig()
    if stats is not None:
        stats["resumed_from_step"] = step
        if "link_counters" in meta:
            stats["checkpoint_link_counters"] = meta["link_counters"]
    return _survivable_loop(rt, placed_params, prompt_ids, int(meta["max_new_tokens"]),
                            int(meta["capacity"]), float(meta["temperature"]), key,
                            int(meta["fault_step"]), stats, rec, raw_params,
                            resume_state=(step, toks, cache), resumed=True, observe=observe)
