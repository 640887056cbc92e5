"""Continuous batching over the paged KV pool: PyTorch counterpart of
``edgellm_tpu/serve/batching.py``.

Many streams share one ragged decode step built on
:mod:`..models.paged_kv`: a fixed set of ``max_slots`` slots runs through
:func:`~..models.paged_kv.paged_decode_step` (K13 on the card;
:func:`~..models.paged_kv.paged_decode_step_quant`, K14, for the quantized
KV-at-rest tiers) every step, with the page table, lengths, last tokens,
per-slot keys, step indices and temperatures as small per-step inputs, so
admitting, evicting, finishing or growing a stream changes no shape.

- prompts prefill through ``decode._prefill_impl`` (the K-attn prompt pass on
  the card), token 0 is sampled with ``fold_in(key, 0)`` as in ``generate``,
  then the prompt's K/V is adopted into the stream's pages;
- the step samples each slot as ``decode._sample`` would alone:
  ``categorical(fold_in(key_i, t_i), logits_i / T_i)`` from the slot's own
  key, argmax for greedy slots, so a stream's tokens do not depend on what
  else is in the batch;
- when the pool runs out of pages the youngest running stream is evicted:
  its pages are gathered back to a contiguous host prefix (the packed codes
  and scales on a quantized tier) and re-adopted on re-admission, and its
  remaining tokens continue where they stopped;
- a :class:`~..models.paged_kv.PrefixCacheConfig` turns on prefix sharing:
  fresh admits map matched index pages with no prefill compute, only the
  unmatched suffix runs (``decode._prefill_suffix_impl``), and the first
  write into a shared page copy-on-write-forks it.

With ``split_runtime=`` (a :class:`~..parallel.split.SplitRuntime`) and
``placed_params=`` (its ``place_params`` tree) the ragged step runs through
the split pipeline instead: the host ``PagedKVCache`` is the allocator alone
(``materialize=False``), the pages live per stage
(``SplitRuntime.init_paged_pool``), prompts prefill through
``prefill_decode`` and are adopted with ``adopt_paged``, a prefix hit's
suffix runs through ``verify_step`` over the gathered rows, COW forks go to
``copy_paged_pages``, evictions gather with ``gather_paged(_packed)``, and
each step is one ``decode_step_paged`` (every cut moves the (max_slots, 1,
D) hidden through its hop) followed by the same per-slot sampler.

Per-stream checkpoints: :meth:`ContinuousBatcher.checkpoint_stream` writes
one stream's contiguous KV prefix (the split twin in the reference's
padded (n_stages, stage_size, n, KV, hd) layout; a quantized tier's codes
and row scales as they lie in the pool) as a
:class:`~.recovery.DecodeCheckpoint`, and :meth:`restore_stream` re-queues
it, bit for bit, in any pool geometry whose span covers it; another tier is
refused with :class:`~.recovery.CheckpointTierMismatchError`. With
``checkpoint_dir`` every eviction snapshots its stream there.

A pipelined split runtime (``SplitRuntime(pipeline=...)``) runs every
ragged step through the µ-batch schedule: ``max_slots`` must split into
its µ-batches and the pool must be fp (the reference has no quantized
pipelined step); stream checkpoints record ``num_microbatches`` (and a
running stream's ``microbatch``) and the report carries the pipeline's
summary. The ``batch.submit`` / ``batch.admit`` / ``batch.step`` spans and
the stream id bound around an eviction's checkpoint are the reference's; an
unservable growth and a stalled run are dumped by the armed flight recorder
before they raise.

The disaggregated-prefill hooks (``serve/disagg.py``'s staging workers):
:meth:`ContinuousBatcher.prefill_hold` admits one waiting stream now (the
fresh-admit prefill, token 0 from ``fold_in(key, 0)``) and pins its slot
with a migration hold instead of decoding; :meth:`ContinuousBatcher.
gather_rows` reads one page's rows in the pool's at-rest form (the split
runtime's per-stage layout in split mode); :meth:`ContinuousBatcher.
release_handoff` drops the hold and frees the slot. A stream adopted with
``resume_prefix`` re-publishes its prompt's pages into the prefix index.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.paged_kv import (OutOfPages, OutOfSlots, PagedKVCache, PrefixCacheConfig,
                               paged_decode_step, paged_decode_step_quant, resolve_kv_codec)
from ..models.transformer import KVCache, params_to
from ..obs import context as obs_context
from ..obs.flight import flight_dump_for
from ..obs.tracing import span as obs_span
from ..utils import prng
from ..utils.concurrency import guarded_by
from .decode import _prefill_impl, _prefill_suffix_impl, _sample, _fold
from .recovery import (CheckpointError, CheckpointTierMismatchError, DecodeCheckpoint,
                       Watchdog)

__all__ = ["BatchingConfig", "Stream", "ContinuousBatcher"]

def _fp_rows(a):
    """A checkpoint leaf as the adopt paths take it: bf16 rows (a CPU bf16
    tensor) widened to fp32 exactly, the rest as stored."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return a


@dataclass(frozen=True)
class BatchingConfig:
    """Pool geometry + scheduler knobs (the reference's fields and defaults).
    ``cache_dtype`` / ``compute_dtype`` are torch dtypes (None keeps the
    weights' dtype for compute)."""

    page_size: int = 16
    num_pages: int = 65          # includes the reserved trash page 0
    max_slots: int = 4
    pages_per_slot: int = 8
    compute_dtype: Any = None
    cache_dtype: Any = torch.float32
    checkpoint_dir: Optional[str] = None
    step_deadline_s: Optional[float] = None
    prefix_cache: Optional[PrefixCacheConfig] = None
    kv_codec: str = "fp"

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved), got "
                             f"{self.num_pages}")
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.pages_per_slot < 1:
            raise ValueError(f"pages_per_slot must be >= 1, got {self.pages_per_slot}")
        if self.step_deadline_s is not None and self.step_deadline_s <= 0:
            raise ValueError("step_deadline_s must be positive")
        if self.prefix_cache is not None and not isinstance(
                self.prefix_cache, PrefixCacheConfig):
            raise ValueError(f"prefix_cache must be a PrefixCacheConfig or None, got "
                             f"{type(self.prefix_cache).__name__}")
        resolve_kv_codec(self.kv_codec)

    @property
    def span(self) -> int:
        return self.pages_per_slot * self.page_size


def _model_sig(cfg: ModelConfig) -> dict:
    """The model signature ``recovery.runtime_plan_meta`` records, so a
    stream checkpoint refuses restore onto another model."""
    return {"family": cfg.family, "num_layers": cfg.num_layers,
            "hidden_size": cfg.hidden_size, "num_heads": cfg.num_heads,
            "vocab_size": cfg.vocab_size}


@dataclass
class Stream:
    """One request's host-side state across admit / evict / finish."""

    sid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    temperature: float
    rng_seed: int
    status: str = "waiting"       # waiting | running | finished
    slot: int = -1
    tokens: list = field(default_factory=list)  # sampled ids, host ints
    resume: Optional[dict] = None  # gathered payload for re-admit
    resume_prefix: bool = False   # re-publish the prompt's pages on adopt
    admit_seq: int = -1           # admission order; youngest = largest
    evictions: int = 0

    @property
    def t(self) -> int:
        """Next decode-step index == tokens sampled so far."""
        return len(self.tokens)

    @property
    def key(self) -> tuple:
        return prng.key(self.rng_seed)


def _batched_sample(logits: torch.Tensor, keys: np.ndarray, steps: np.ndarray,
                    temps: np.ndarray) -> torch.Tensor:
    """Per-slot ``decode._sample``: slot i's token equals
    ``_sample(logits[i:i+1], fold_in(key_i, step_i), temp_i)``. Greedy slots
    take the argmax; only the sampled slots draw noise, each from its own
    folded key. keys (B, 2), steps (B,), temps (B,) are host arrays."""
    toks = torch.argmax(logits, dim=-1)
    rows = np.nonzero(temps > 0.0)[0]
    if rows.size:
        dev = logits.device
        folded = prng.fold_in(torch.from_numpy(keys[rows]).to(dev),
                              torch.from_numpy(steps[rows].astype(np.int64)).to(dev))
        idx = torch.from_numpy(rows).to(dev)
        temp = torch.from_numpy(temps[rows].astype(np.float32)).to(dev)
        toks[idx] = prng.categorical(folded, logits[idx] / temp[:, None])
    return toks.to(torch.int32)


@guarded_by("_stats_lock", fields=["stats"])
class ContinuousBatcher:
    """Admit / evict streams mid-flight into one ragged decode step.

    :meth:`submit` queues a stream; :meth:`step` admits waiting streams into
    free slots (prefill + page adoption), runs ONE ragged step for every
    running slot, appends each slot's sampled token, retires finished
    streams, and, when the pool cannot cover a growth, evicts the youngest
    running stream back to the waiting queue with its gathered K/V prefix.
    :meth:`run` loops :meth:`step` to completion; ``results[sid]`` holds each
    finished stream's (max_new_tokens,) int32 tokens. The pool lives on the
    device of the weights (``params["embed"]``), or per stage on the split
    runtime's devices with ``split_runtime=``."""

    def __init__(self, cfg: ModelConfig, params: dict, bcfg: Optional[BatchingConfig] = None,
                 *, split_runtime: Any = None, placed_params: Any = None):
        cfg.require_uniform("the batcher's paged KV pool")
        self.cfg = cfg
        self.params = params_to(params)
        self.bcfg = bcfg if bcfg is not None else BatchingConfig()
        self.rt = split_runtime
        if split_runtime is not None:
            if placed_params is None:
                raise ValueError("split_runtime needs placed_params (the SplitRuntime's "
                                 "placed parameter tree)")
            if self.bcfg.compute_dtype is not None:
                raise ValueError("compute_dtype is a local-pool knob; the split runtime "
                                 "owns its own dtypes — leave it None")
            if getattr(split_runtime, "pipelined", False):
                m = split_runtime.pipeline.num_microbatches
                if self.bcfg.max_slots % m != 0:
                    raise ValueError(
                        f"max_slots={self.bcfg.max_slots} must be a multiple "
                        f"of num_microbatches={m}: every ragged decode step "
                        f"feeds the full slot set through the pipelined "
                        f"schedule, which splits it into {m} equal µ-batches")
                if self.bcfg.kv_codec != "fp":
                    raise ValueError(
                        f"kv_codec={self.bcfg.kv_codec!r} composes with the "
                        f"unpipelined split runtime only; the pipelined "
                        f"µ-batch schedule has no quantized paged step yet")
        self.placed = placed_params
        self.device = (split_runtime.devices[0] if split_runtime is not None
                       else params["embed"].device)
        # split mode: the host cache is the allocator only; the pages live
        # per stage and move through the runtime's paged scatter / gather
        self.pool = PagedKVCache(
            cfg, num_pages=self.bcfg.num_pages, page_size=self.bcfg.page_size,
            max_slots=self.bcfg.max_slots, pages_per_slot=self.bcfg.pages_per_slot,
            dtype=self.bcfg.cache_dtype, device=self.device,
            materialize=split_runtime is None,
            prefix_cache=self.bcfg.prefix_cache, kv_codec=self.bcfg.kv_codec)
        self._split_pool = (
            split_runtime.init_paged_pool(self.bcfg.num_pages, self.bcfg.page_size,
                                          dtype=self.bcfg.cache_dtype,
                                          kv_codec=self.bcfg.kv_codec)
            if split_runtime is not None else None)
        self._streams: dict[int, Stream] = {}
        self._waiting: deque[int] = deque()
        self._slot_to_sid: dict[int, int] = {}
        self._next_sid = 0
        self._admit_seq = 0
        self.results: dict[int, np.ndarray] = {}
        self._watchdog = (Watchdog(self.bcfg.step_deadline_s)
                          if self.bcfg.step_deadline_s is not None else None)
        self._stats_lock = threading.Lock()
        self.stats = {"steps": 0, "submitted": 0, "admitted": 0, "evicted": 0,
                      "finished": 0, "jit_misses": 0, "emitted_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "occ_sum": 0.0, "occ_max": 0.0, "slot_sum": 0.0,
                      "alloc_sum": 0.0, "alloc_n": 0}

    # -- submission --------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int, *, temperature: float = 0.0,
               rng_seed: int = 0) -> int:
        """Queue a stream; the argument semantics of ``generate`` with
        ``rng_key = prng.key(rng_seed)``. Returns the stream id."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if float(temperature) < 0.0:
            raise ValueError("temperature must be >= 0")
        need = prompt.size + max_new_tokens - 1  # the final token is not written
        if need > self.bcfg.span:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens needs "
                f"{need} cache positions > slot span {self.bcfg.span} "
                f"(pages_per_slot={self.bcfg.pages_per_slot} x "
                f"page_size={self.bcfg.page_size})")
        prng.key(rng_seed)  # refuse a seed outside the key range now
        sid = self._next_sid
        self._next_sid += 1
        self._streams[sid] = Stream(sid, prompt, int(max_new_tokens), float(temperature),
                                    int(rng_seed))
        self._waiting.append(sid)
        with self._stats_lock:
            self.stats["submitted"] += 1
        with obs_span("batch.submit", sid=sid, prompt_len=int(prompt.size),
                      max_new_tokens=int(max_new_tokens)):
            pass
        return sid

    def pop_result(self, sid: int) -> np.ndarray:
        """Return and forget a finished stream's tokens."""
        toks = self.results.pop(sid)
        self._streams.pop(sid, None)
        return toks

    def probe_prefix(self, prompt_ids) -> int:
        """Leading tokens of this prompt the pool's radix index already
        holds (a dry run; 0 with prefix sharing off)."""
        if self.pool.prefix is None:
            return 0
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        return int(self.pool.probe_prefix(prompt)["tokens"])

    def discard(self, sid: int) -> None:
        """Drop a stream in any state and forget its result (frees a running
        stream's slot and pages)."""
        st = self._streams.pop(sid, None)
        self.results.pop(sid, None)
        if st is None:
            return
        if st.status == "running":
            self.pool.free_slot(st.slot)
            del self._slot_to_sid[st.slot]
        elif st.status == "waiting":
            try:
                self._waiting.remove(sid)
            except ValueError:
                pass
        st.status = "discarded"

    # -- admission / eviction ----------------------------------------------

    def _cache_len(self, st: Stream) -> int:
        """Positions st's cache holds at the top of step t: the prompt plus
        the t - 1 tokens already fed back."""
        return st.prompt.size + max(st.t - 1, 0)

    def _num_microbatches(self) -> int:
        """The µ-batch count of the split runtime's schedule (1 without a
        pipeline or a split runtime)."""
        pipe = getattr(self.rt, "pipeline", None) if self.rt is not None else None
        return int(pipe.num_microbatches) if pipe is not None else 1

    def _microbatch_of(self, slot: int) -> int:
        """Which µ-batch a slot rides in under the pipelined split schedule
        (0 when pipelining is off or the pool is local): the label admit
        spans and stream checkpoints record."""
        m = self._num_microbatches()
        return int(slot // (self.bcfg.max_slots // m)) if m > 1 else 0

    def _try_admit(self, sid: int) -> bool:
        st = self._streams[sid]
        need_len = int(st.resume["length"]) if st.resume is not None else st.prompt.size
        # +1: the admitting step itself must be coverable; indexed pages map
        # in for free (minus a fork page when the match ends mid-page) and
        # index-only pages count as available
        need_pages = self.pool.pages_for(need_len + 1)
        if st.resume is None and self.pool.prefix is not None:
            pr = self.pool.probe_prefix(st.prompt, max_tokens=st.prompt.size - 1)
            need_pages = need_pages - pr["pages"] + pr["forks"]
        if need_pages > self.pool.num_free_pages + self.pool.reclaimable_index_pages:
            return False
        try:
            slot = self.pool.alloc_slot()
        except OutOfSlots:
            return False
        t0 = time.monotonic()
        try:
            tok0 = self._admit_fill(st, slot)
        except OutOfPages:
            self.pool.free_slot(slot)
            return False
        resumed = st.resume is not None
        if tok0 is not None:
            st.tokens.append(int(tok0[0]))
        st.status, st.slot = "running", slot
        st.admit_seq = self._admit_seq
        self._admit_seq += 1
        self._slot_to_sid[slot] = sid
        with self._stats_lock:
            self.stats["prefill_s"] += time.monotonic() - t0
            self.stats["admitted"] += 1
        with obs_span("batch.admit", sid=sid, slot=slot,
                      microbatch=self._microbatch_of(slot), resumed=resumed):
            pass
        if st.t >= st.max_new_tokens:  # max_new_tokens == 1: prefill is all
            self._finish(st)
        return True

    def _admit_fill(self, st: Stream, slot: int) -> Optional[torch.Tensor]:
        """Land one stream's K/V into ``slot``'s pages (resume payload, full
        prefill, or shared pages plus a suffix-only prefill) -> the sampled
        token 0 for fresh admits, None for resumes."""
        if st.resume is not None:
            need_len = int(st.resume["length"])
            packed = "k_codes" in st.resume
            if self.rt is not None:
                self.pool.ensure(slot, need_len)
                dest = self.pool._flat_indices(slot, need_len)
                if packed:
                    self._split_pool = self.rt.adopt_paged_rows_packed(
                        self._split_pool, st.resume["k_codes"], st.resume["v_codes"],
                        st.resume["k_scale"], st.resume["v_scale"], dest)
                else:
                    self._split_pool = self.rt.adopt_paged_rows(
                        self._split_pool, st.resume["k"], st.resume["v"], dest)
                self.pool.lengths[slot] = need_len
            elif packed:
                self.pool.adopt_packed(slot, st.resume["k_codes"], st.resume["v_codes"],
                                       st.resume["k_scale"], st.resume["v_scale"], need_len)
            else:
                self.pool.adopt(slot, st.resume["k"], st.resume["v"], need_len)
            st.resume = None
            if st.resume_prefix and self.pool.prefix is not None:
                # a migrated prefill: the payload's first prompt.size rows
                # are prompt K/V (the handoff is at t == 1), so the pages go
                # back into the radix index; generated rows never do
                self.pool.register_prefix(slot, st.prompt)
            return None
        s = st.prompt.size
        matched = 0
        if self.pool.prefix is not None:
            # claim at most s - 1 positions: a suffix token must run so that
            # token 0 has logits
            matched = self.pool.share_prefix(slot, st.prompt, max_tokens=s - 1)
        if matched > 0:
            tok0 = (self._prefill_suffix_split(st, slot, matched) if self.rt is not None
                    else self._prefill_suffix_local(st, slot, matched))
        elif self.rt is not None:
            # generate_split's prefill and token-0 key, then the per-stage
            # cache rows scatter into this slot's pages
            prompt = torch.from_numpy(st.prompt[None, :].astype(np.int64)).to(self.device)
            logits, cache = self.rt.prefill_decode(self.placed, prompt, self.bcfg.span)
            tok0 = _sample(logits[:, -1], _fold(st.key, 0), st.temperature)
            self.pool.ensure(slot, s)
            self._split_pool = self.rt.adopt_paged(
                self._split_pool, cache, 0, self.pool._flat_indices(slot, s), s)
            self.pool.lengths[slot] = s
        else:
            prompt = torch.from_numpy(st.prompt[None, :].astype(np.int64)).to(self.device)
            last_logits, cache = _prefill_impl(self.cfg, self.params, prompt, s,
                                               self.bcfg.compute_dtype)
            tok0 = _sample(last_logits, _fold(st.key, 0), st.temperature)
            self.pool.adopt(slot, cache.k[:, 0, :s], cache.v[:, 0, :s], s)
        if self.pool.prefix is not None:
            self.pool.register_prefix(slot, st.prompt)
        return tok0.cpu().numpy()

    def _prefill_suffix_local(self, st: Stream, slot: int, matched: int) -> torch.Tensor:
        """Prefix-hit admit: gather the ``matched`` shared rows into a
        contiguous cache, prefill only the suffix, and write the suffix rows
        back (COW-forking the shared tail page)."""
        s = st.prompt.size
        state = self.pool.gather_slot(slot)  # the matched prefix rows
        cdtype = (self.bcfg.compute_dtype if self.bcfg.compute_dtype is not None
                  else torch.float32)
        nl, _, kv, hd = state["k"].shape
        kc = torch.zeros((nl, 1, self.bcfg.span, kv, hd), dtype=cdtype, device=self.device)
        vc = torch.zeros_like(kc)
        kc[:, 0, :matched] = torch.from_numpy(state["k"]).to(kc)
        vc[:, 0, :matched] = torch.from_numpy(state["v"]).to(vc)
        suffix = torch.from_numpy(st.prompt[None, matched:].astype(np.int64)).to(self.device)
        logits, cache = _prefill_suffix_impl(self.cfg, self.params, suffix,
                                             KVCache(kc, vc, matched), self.bcfg.compute_dtype)
        tok0 = _sample(logits[:, -1], _fold(st.key, 0), st.temperature)
        self.pool.adopt_rows(slot, cache.k[:, 0, matched:s], cache.v[:, 0, matched:s],
                             matched, s)
        return tok0

    def _prefill_suffix_split(self, st: Stream, slot: int, matched: int) -> torch.Tensor:
        """The split twin of :meth:`_prefill_suffix_local`: the ``matched``
        rows gathered from the per-stage pools into per-stage contiguous
        caches (the pool dtype, fp32 on a quantized tier), ``verify_step``
        over the suffix tokens, the COW forks applied to the stage pools,
        and the suffix rows scattered into this slot's pages."""
        s = st.prompt.size
        rows = self.rt._gather_rows(self._split_pool, self.pool._flat_indices(slot, matched))
        ks, vs = [], []
        for k_rows, v_rows in rows:  # (layers_of_stage, matched, KV, hd)
            shape = (k_rows.shape[0], 1, self.bcfg.span) + tuple(k_rows.shape[2:])
            kc = torch.zeros(shape, dtype=k_rows.dtype, device=k_rows.device)
            vc = torch.zeros_like(kc)
            kc[:, 0, :matched] = k_rows
            vc[:, 0, :matched] = v_rows
            ks.append(kc)
            vs.append(vc)
        cache = {"k": ks, "v": vs, "length": matched, "capacity": self.bcfg.span}
        suffix = torch.from_numpy(st.prompt[None, matched:].astype(np.int64)).to(self.device)
        logits, cache = self.rt.verify_step(self.placed, cache, suffix)
        tok0 = _sample(logits[:, -1], _fold(st.key, 0), st.temperature)
        self._grow_writable(slot, s)
        self._split_pool = self.rt.adopt_paged(
            self._split_pool, cache, 0, self.pool._flat_indices(slot, s)[matched:], s,
            start=matched)
        self.pool.lengths[slot] = s
        return tok0

    def _gather_state(self, slot: int) -> dict:
        """One slot's contiguous K/V prefix as the resume payload (packed
        codes + scales on a quantized tier, so the round trip is exact);
        split: the (n_stages, stage_size, n, KV, hd) twin from the stage
        pools."""
        quant = self.bcfg.kv_codec != "fp"
        if self.rt is None:
            # bf16 rows widen to fp32 exactly
            return self.pool.gather_slot_packed(slot) if quant else self.pool.gather_slot(slot)
        n = int(self.pool.lengths[slot])
        idx = self.pool._flat_indices(slot, max(n, 1))
        if quant:
            kc, vc, ks, vs = self.rt.gather_paged_packed(self._split_pool, idx)
            return {"k_codes": kc[:, :, :n], "v_codes": vc[:, :, :n],
                    "k_scale": ks[:, :, :n], "v_scale": vs[:, :, :n],
                    "length": np.asarray(n, np.int32)}
        k_seq, v_seq = self.rt.gather_paged(self._split_pool, idx)
        return {"k": k_seq[:, :, :n], "v": v_seq[:, :, :n], "length": np.asarray(n, np.int32)}

    def evict(self, sid: int) -> None:
        """Push a running stream back to the waiting queue with its pages
        gathered to a contiguous prefix (re-admission resumes it)."""
        st = self._streams[sid]
        if st.status != "running":
            raise ValueError(f"stream {sid} is not running")
        st.resume = self._gather_state(st.slot)
        self.pool.free_slot(st.slot)
        del self._slot_to_sid[st.slot]
        st.status, st.slot = "waiting", -1
        st.evictions += 1
        self._waiting.appendleft(sid)  # resumed work goes to the head
        with self._stats_lock:
            self.stats["evicted"] += 1
        if self.bcfg.checkpoint_dir is not None:
            # bound, so the checkpoint-save span carries the stream id
            with obs_context.bind(sid=sid):
                self.checkpoint_stream(sid, os.path.join(self.bcfg.checkpoint_dir,
                                                         f"stream_{sid}.ckpt"))

    # -- disaggregated prefill handoff -------------------------------------

    def prefill_hold(self, sid: int) -> Optional[Stream]:
        """Admit waiting stream ``sid`` now (the fresh-admit prefill, token 0
        sampled with ``fold_in(key, 0)`` as colocated serving samples it),
        then pin its slot with a migration hold instead of decoding. Returns
        the Stream, or None when the pool cannot admit it now; a
        ``max_new_tokens == 1`` stream comes back ``finished`` with no held
        slot (token 0 is the whole answer)."""
        st = self._streams[sid]
        if st.status != "waiting":
            raise ValueError(f"stream {sid} is not waiting")
        if not self._try_admit(sid):
            return None
        self._waiting.remove(sid)
        if st.status == "running":
            self.pool.hold_slot(st.slot)
        return st

    def gather_rows(self, slot: int, start: int, stop: int) -> dict:
        """Rows ``[start, stop)`` of ``slot`` in the pool's at-rest form, as
        host arrays: one migrated page (packed codes and scales on a
        quantized tier; the (n_stages, stage_size, n, ...) layout in split
        mode). The chunks concatenated along the row axis are
        :meth:`_gather_state`'s arrays."""
        if self.rt is None:
            if self.bcfg.kv_codec != "fp":
                return self.pool.gather_slot_rows_packed(slot, start, stop)
            return self.pool.gather_slot_rows(slot, start, stop)
        idx = self.pool._flat_indices(slot, stop)[start:]
        if self.bcfg.kv_codec != "fp":
            kc, vc, ks, vs = self.rt.gather_paged_packed(self._split_pool, idx)
            return {"k_codes": kc, "v_codes": vc, "k_scale": ks, "v_scale": vs}
        k_seq, v_seq = self.rt.gather_paged(self._split_pool, idx)
        return {"k": k_seq, "v": v_seq}

    def release_handoff(self, sid: int) -> None:
        """Retire a handoff stream: drop the migration hold and free the
        staging slot (its pages landed in the decode pool, or the handoff
        was abandoned). The prompt's pages stay in the staging prefix index,
        where one is on."""
        st = self._streams.pop(sid)
        if st.status == "running":
            self.pool.release_slot_hold(st.slot)
            self.pool.free_slot(st.slot)
            del self._slot_to_sid[st.slot]
            st.status, st.slot = "finished", -1
        self.results.pop(sid, None)

    def _evict_for_pages(self, needed: int, protect: set) -> bool:
        """Evict youngest-admitted running streams (never ``protect``) until
        ``needed`` pages are free."""
        while self.pool.num_free_pages < needed:
            victims = [st for st in self._streams.values()
                       if st.status == "running" and st.sid not in protect]
            if not victims:
                return False
            self.evict(max(victims, key=lambda s: s.admit_seq).sid)
        return True

    def _finish(self, st: Stream) -> None:
        self.results[st.sid] = np.asarray(st.tokens, np.int32)
        self.pool.free_slot(st.slot)
        del self._slot_to_sid[st.slot]
        st.status, st.slot = "finished", -1
        with self._stats_lock:
            self.stats["finished"] += 1
            self.stats["emitted_tokens"] += len(st.tokens)

    # -- the ragged step ---------------------------------------------------

    def _running(self) -> list[Stream]:
        return [self._streams[sid] for sid in self._slot_to_sid.values()]

    def _grow_writable(self, slot: int, new_length: int) -> None:
        """Cover ``slot``'s positions up to ``new_length``: growth pages, and
        a COW fork of every shared page the writes land in (copied in the
        local pool, or routed to the stage pools in split mode)."""
        pairs = self.pool.ensure_writable(slot, new_length)
        if pairs and self.rt is not None:
            self._split_pool = self.rt.copy_paged_pages(
                self._split_pool, [o for o, _ in pairs], [n for _, n in pairs])

    def step(self) -> int:
        """Admit what fits, run ONE ragged step over every running slot,
        commit the sampled tokens. Returns the number of streams that
        advanced (0 = nothing running and nothing admittable)."""
        while self._waiting:  # FIFO admits, no overtaking
            if not self._try_admit(self._waiting[0]):
                break
            self._waiting.popleft()
        running = self._running()
        if not running:
            return 0
        for st in sorted(running, key=lambda s: s.admit_seq):
            if st.status != "running":
                continue  # evicted by a predecessor's growth
            try:
                self._grow_writable(st.slot, self._cache_len(st) + 1)
            except OutOfPages as e:
                need = max(1, self.pool.pages_for(self._cache_len(st) + 1)
                           - len(self.pool._slot_pages[st.slot]))
                if not self._evict_for_pages(need, {st.sid}):
                    # an unservable growth: the pool's state post-mortem
                    flight_dump_for(e, sid=st.sid, slot=st.slot,
                                    free_pages=self.pool.num_free_pages)
                    raise
                self._grow_writable(st.slot, self._cache_len(st) + 1)
        running = self._running()
        if not running:
            return 0
        if self._watchdog is not None:
            self._watchdog.arm()
        b = self.bcfg.max_slots
        token_ids = np.zeros((b,), np.int64)
        steps = np.zeros((b,), np.int64)
        temps = np.zeros((b,), np.float32)
        keys = np.zeros((b, 2), np.int64)
        for st in running:
            token_ids[st.slot] = st.tokens[-1]
            steps[st.slot] = st.t
            temps[st.slot] = st.temperature
            keys[st.slot] = st.key
        # the pool's lengths are the step's write / mask positions: slot i
        # holds prompt + t - 1 fed tokens; inactive slots write the trash page
        page_table, lengths = self.pool.device_tables()
        t0 = time.monotonic()
        tok_ids = torch.from_numpy(token_ids).to(self.device)
        if self.rt is not None:
            # one ragged split step: every cut moves ONE (max_slots, 1, D)
            # hidden through its hop, then the same per-slot sampler
            logits, self._split_pool = self.rt.decode_step_paged(
                self.placed, self._split_pool, page_table, lengths, tok_ids)
        elif self.bcfg.kv_codec != "fp":
            logits = paged_decode_step_quant(
                self.cfg, self.params, *self.pool.pool, page_table, lengths, tok_ids,
                kv_codec=self.bcfg.kv_codec, compute_dtype=self.bcfg.compute_dtype)[0]
        else:
            logits = paged_decode_step(self.cfg, self.params, *self.pool.pool, page_table,
                                       lengths, tok_ids,
                                       compute_dtype=self.bcfg.compute_dtype)[0]
        toks_host = _batched_sample(logits, keys, steps, temps).cpu().numpy()  # one sync
        step_s = time.monotonic() - t0
        with self._stats_lock:
            self.stats["decode_s"] += step_s
            self.stats["steps"] += 1
            step_no = int(self.stats["steps"]) - 1
        with obs_span("batch.step", step=step_no, running=len(running),
                      step_ms=round(step_s * 1e3, 3)):
            pass
        for st in running:
            st.tokens.append(int(toks_host[st.slot]))
            self.pool.lengths[st.slot] = self._cache_len(st)
            if st.t >= st.max_new_tokens:
                self._finish(st)
        occ = self.pool.unique_live_tokens / self.pool.token_capacity
        slot_util = len(self._slot_to_sid) / b
        reserved = (self.pool.num_pages - 1 - self.pool.num_free_pages) * self.pool.page_size
        alloc_util = self.pool.unique_live_tokens / reserved if reserved else None
        with self._stats_lock:
            self.stats["occ_sum"] += occ
            self.stats["occ_max"] = max(self.stats["occ_max"], occ)
            self.stats["slot_sum"] += slot_util
            if alloc_util is not None:
                self.stats["alloc_sum"] += alloc_util
                self.stats["alloc_n"] += 1
        if self._watchdog is not None:
            self._watchdog.check()
        return len(running)

    def run(self, max_steps: int = 100_000) -> dict[int, np.ndarray]:
        """Drive :meth:`step` until every submitted stream finished."""
        for _ in range(max_steps):
            if not self._waiting and not self._slot_to_sid:
                break
            if self.step() == 0 and self._waiting:
                exc = OutOfPages(
                    "no stream can make progress: the pool cannot hold even "
                    "one waiting stream — shrink prompts or grow the pool")
                flight_dump_for(exc, waiting=len(self._waiting),
                                free_pages=self.pool.num_free_pages)
                raise exc
        return self.results

    # -- checkpoint / restore ----------------------------------------------

    def checkpoint_stream(self, sid: int, path: str) -> str:
        """Snapshot one stream, running (pages gathered) or waiting with a
        resume payload, as a :class:`~.recovery.DecodeCheckpoint` with the
        reference's leaves and meta; restorable into any pool geometry whose
        span covers it (the payload is the contiguous prefix)."""
        st = self._streams[sid]
        if st.status == "running":
            state = self._gather_state(st.slot)
        elif st.resume is not None:
            state = st.resume
        else:
            raise CheckpointError(f"stream {sid} ({st.status}) has no cache state to snapshot")
        if "k_codes" in state:
            # a quantized tier: the codes and row scales as they lie in the
            # pool, so the restore scatters the same bytes back
            arrays = {f"cache/{k}": state[k] for k in ("k_codes", "v_codes", "k_scale",
                                                       "v_scale")}
        else:
            arrays = {"cache/k": state["k"], "cache/v": state["v"]}
        arrays.update({"cache/length": np.asarray(int(state["length"]), np.int32),
                       "prompt_ids": st.prompt[None, :].astype(np.int32),
                       "tokens": np.asarray(st.tokens, np.int32)[None, :]})
        meta = {"mode": self._ckpt_mode(), "model": _model_sig(self.cfg), "sid": int(sid),
                "step": int(st.t - 1), "rng_seed": int(st.rng_seed),
                "temperature": float(st.temperature),
                "max_new_tokens": int(st.max_new_tokens)}
        if self.bcfg.kv_codec != "fp":
            meta["kv_codec"] = self.bcfg.kv_codec
        if self.rt is not None:
            meta["cuts"] = [int(c) for c in self.rt.split.cuts]
            meta["hop_codecs"] = [c.name for c in self.rt.codecs]
            # the µ-batch count is a plan axis (checked on restore); a
            # running stream also records the µ-batch its slot rides in
            m = self._num_microbatches()
            meta["num_microbatches"] = m
            if st.status == "running" and m > 1:
                meta["microbatch"] = self._microbatch_of(st.slot)
        return DecodeCheckpoint(arrays, meta).save(path)

    def _ckpt_mode(self) -> str:
        return "paged" if self.rt is None else "paged_split"

    def restore_stream(self, path: str) -> int:
        """Re-queue a checkpointed stream; its remaining tokens come out
        equal to the uninterrupted run's (per-step keys depend only on the
        seed and the step index, and the KV prefix is restored bit for
        bit). A checkpoint of another mode, model, plan or tier is
        refused."""
        ckpt = DecodeCheckpoint.load(path)
        meta = ckpt.meta
        if meta.get("mode") != self._ckpt_mode():
            raise CheckpointError(f"{path} is a {meta.get('mode')!r} checkpoint, this "
                                  f"batcher restores {self._ckpt_mode()!r} stream snapshots")
        if meta.get("model") != _model_sig(self.cfg):
            raise CheckpointError(f"{path} was written for model {meta.get('model')!r}, this "
                                  f"batcher runs {_model_sig(self.cfg)!r}")
        ck = meta.get("kv_codec", "fp")
        if ck != self.bcfg.kv_codec:
            raise CheckpointTierMismatchError(
                offered=ck, pool=self.bcfg.kv_codec, where="restore_stream",
                detail=f"{path} stores {ck!r} KV pages; restore into a batcher built at "
                       f"the checkpoint's tier")
        if self.rt is not None:
            want = {"cuts": [int(c) for c in self.rt.split.cuts],
                    "hop_codecs": [c.name for c in self.rt.codecs],
                    "num_microbatches": self._num_microbatches()}
            for k, v in want.items():
                if meta.get(k, 1 if k == "num_microbatches" else None) != v:
                    raise CheckpointError(f"{path} {k}={meta.get(k)!r} does not match this "
                                          f"runtime's {k}={v!r}")
        sid = self.submit(ckpt.arrays["prompt_ids"][0], int(meta["max_new_tokens"]),
                          temperature=float(meta["temperature"]),
                          rng_seed=int(meta["rng_seed"]))
        st = self._streams[sid]
        st.tokens = [int(x) for x in ckpt.arrays["tokens"][0]]
        names = ("k_codes", "v_codes", "k_scale", "v_scale") if ck != "fp" else ("k", "v")
        st.resume = {k: _fp_rows(ckpt.arrays[f"cache/{k}"]) for k in names}
        st.resume["length"] = int(ckpt.arrays["cache/length"])
        return sid

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        """The reference's report keys. ``jit_misses`` counts compiles of
        the ragged step, which eager PyTorch does not have: always 0.
        ``mode`` is the name the reference's stream checkpoints give the
        pool ("paged", or "paged_split" over a split runtime, which adds the
        plan's ``cuts`` and ``hop_codecs`` as those checkpoints record
        them, and under a faulty link its per-hop ``link_counters``); a
        pipelined split runtime adds its ``pipeline`` summary."""
        with self._stats_lock:
            stats = dict(self.stats)
        n = stats["steps"]
        alloc_n = stats["alloc_n"]
        dec = stats["decode_s"]
        emitted = stats["emitted_tokens"]
        pipeline = (self.rt.pipeline_summary()
                    if getattr(self.rt, "pipelined", False) else None)
        return {
            **({"pipeline": pipeline} if pipeline is not None else {}),
            "streams": stats["submitted"],
            "finished": stats["finished"],
            "steps": n,
            "admitted": stats["admitted"],
            "evicted": stats["evicted"],
            "jit_misses": stats["jit_misses"],
            "prefill_s": stats["prefill_s"],
            "decode_s": dec,
            "decode_tokens_per_s": (emitted / dec) if dec > 0 else 0.0,
            "occupancy_mean": (stats["occ_sum"] / n) if n else 0.0,
            "occupancy_max": stats["occ_max"],
            "slot_util_mean": (stats["slot_sum"] / n) if n else 0.0,
            "alloc_util_mean": (stats["alloc_sum"] / alloc_n) if alloc_n else 0.0,
            "span": self.bcfg.span,
            "token_capacity": self.pool.token_capacity,
            **({"prefix": self.pool.prefix_report()}
               if self.pool.prefix is not None else {}),
            "mode": "paged" if self.rt is None else "paged_split",
            **({"cuts": [int(c) for c in self.rt.split.cuts],
                "hop_codecs": [c.name for c in self.rt.codecs]} if self.rt is not None else {}),
            # beyond the reference's keys: the split runtime's link counters
            **({"link_counters": {k: [int(x) for x in v]
                                  for k, v in self.rt.link_counters().items()}}
               if self.rt is not None and self.rt.link is not None else {}),
        }
