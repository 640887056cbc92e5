"""Disaggregated prefill / decode serving with verified KV-page migration:
PyTorch counterpart of ``edgellm_tpu/serve/disagg.py``.

The colocated :class:`~.batching.ContinuousBatcher` prefills and decodes on
one pool, so a long prompt stalls every decode step behind it. This module
splits the service:

- :class:`PrefillWorker`: a worker owning a private staging batcher (its own
  pool on the card). ``ContinuousBatcher.prefill_hold`` runs the colocated
  fresh-admit prefill (token 0 from the same ``fold_in(key, 0)``) and pins
  the slot with a migration hold instead of decoding.
- :class:`MigrationLink`: the boundary hop's ladder applied to KV pages.
  Each page's at-rest bytes (codes and scales on a quantized tier) are
  sealed (``codecs/wire_format.py``), FEC-framed when configured
  (``codecs/fec.py``), corrupted by the seeded fault injector
  (``codecs/faults.py``, keys ``fold_in(fold_in(fold_in(key(seed), send),
  attempt), route)``: JAX's bits through ``utils/prng.py``), then walked
  through detect, repair, retry and hedge. A page that never verifies
  raises :class:`MigrationError`: corrupt bytes are never adopted. Each
  transfer's wire bytes are held to :func:`migration_wire_nbytes`. The link
  runs on the host between decode steps, on the gathered host arrays, as
  the reference's does: no page crosses it inside a ragged step.
- :class:`DisaggServer`: the front. Prompts queue for the prefill workers;
  each finished prefill migrates page by page into a bounded handoff
  queue, and decode admission pulls from it. The adopt is the batcher's
  resume byte move (``adopt_packed`` / ``adopt_paged_rows_packed``), never
  a requantize, so disagg tokens equal colocated tokens (the handoff is at
  t == 1, before any decode step).

Failure matrix (every leg keeps accepted requests alive): a prefill worker
dying mid-migration re-drives the remaining pages from the server-held
prefill checkpoint (or re-prefills, counted in ``recompute_tokens``); a
transfer that never verifies falls the request back to a colocated prefill
and counts toward ``degrade_after``; a dead decode worker re-admits its
streams from stream checkpoints or the handoff records; a dead or slow link
degrades the front to colocated serving with a typed ``degrade_reason``.
On one card the prefill workers and the decode pool share the device and
run in turn.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..codecs.faults import FaultConfig, fault_key, fold, inject_faults
from ..codecs.fec import FECConfig, HedgeConfig, fec_decode, fec_encode
from ..codecs.wire_format import seal_payload, tree_nbytes, verify_payload
from ..obs.flight import flight_dump_for
from ..obs.metrics import get_registry
from ..obs.tracing import span as obs_span
from ..utils.clock import MONOTONIC, Clock
from .batching import BatchingConfig, ContinuousBatcher
from .overload import _linear_quantile

__all__ = [
    "DEGRADE_LINK_DEAD", "DEGRADE_LINK_SLOW", "DEGRADE_MIGRATION_FAILURES",
    "DEGRADE_REASONS", "DEGRADE_WORKERS_LOST", "DisaggConfig", "DisaggError",
    "DisaggServer", "Handoff", "MigrationError", "MigrationLink", "PrefillWorker",
    "PrefillWorkerLost", "migration_wire_nbytes",
]


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------


class DisaggError(RuntimeError):
    """Base type for disaggregated-serving failures."""


class MigrationError(DisaggError):
    """A KV-page transfer could not be delivered intact: the link is down,
    the wire-byte contract was violated, or every attempt (retries x hedge
    routes) failed integrity. The corrupt bytes were NOT adopted."""


class PrefillWorkerLost(DisaggError):
    """A prefill worker died; its staging pool is unreachable. In-flight
    handoffs re-drive from the prefill checkpoint or re-prefill."""


#: typed degrade reasons (``DisaggServer.degrade_reason`` is one of these or
#: None)
DEGRADE_LINK_DEAD = "migration_link_dead"
DEGRADE_LINK_SLOW = "migration_link_slow"
DEGRADE_MIGRATION_FAILURES = "migration_failures"
DEGRADE_WORKERS_LOST = "prefill_workers_lost"
DEGRADE_REASONS = (DEGRADE_LINK_DEAD, DEGRADE_LINK_SLOW,
                   DEGRADE_MIGRATION_FAILURES, DEGRADE_WORKERS_LOST)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Knobs of the disaggregated front (the reference's fields, defaults
    and messages).

    ``num_prefill_workers`` workers each hold ``prefill_batch`` staging
    slots; finished prefills wait in a handoff queue bounded at
    ``queue_bound`` (a full queue back-pressures the prefill pump). The
    ladder re-sends a failed page up to ``max_retries`` times
    (``hedge.routes`` copies an attempt when hedging); ``degrade_after``
    consecutive migration-fatal failures degrade the front to colocated
    serving. ``prefill_checkpoint`` keeps a server-held snapshot of every
    handoff, so a worker death mid-migration re-drives instead of
    re-prefilling. ``transfer_s_per_page`` models a page's wire time on the
    injected clock; with ``slow_link_p95_multiple`` > 0 the front degrades
    (``migration_link_slow``) once the windowed p95 transfer time reaches
    that multiple of the healthy baseline median."""

    enabled: bool = True
    num_prefill_workers: int = 2
    prefill_batch: int = 2
    queue_bound: int = 8
    max_retries: int = 2
    degrade_after: int = 3
    prefill_checkpoint: bool = True
    fec: Optional[FECConfig] = None
    hedge: Optional[HedgeConfig] = None
    faults: Optional[FaultConfig] = None
    link_seed: int = 0
    transfer_s_per_page: float = 0.0
    slow_link_p95_multiple: float = 0.0
    slow_link_min_samples: int = 8
    slow_link_window_s: float = 60.0

    def __post_init__(self):
        if not isinstance(self.enabled, bool):
            raise ValueError(f"enabled must be a boolean, got {self.enabled!r}")
        if not isinstance(self.prefill_checkpoint, bool):
            raise ValueError(f"prefill_checkpoint must be a boolean, got "
                             f"{self.prefill_checkpoint!r}")
        for f, lo in (("num_prefill_workers", 1), ("prefill_batch", 1),
                      ("queue_bound", 1), ("max_retries", 0),
                      ("degrade_after", 1)):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, int) or v < lo:
                raise ValueError(f"{f} must be an integer >= {lo}, got {v!r}")
        if isinstance(self.transfer_s_per_page, bool) or not isinstance(
                self.transfer_s_per_page, (int, float)) \
                or self.transfer_s_per_page < 0:
            raise ValueError(f"transfer_s_per_page must be a number >= 0, "
                             f"got {self.transfer_s_per_page!r}")
        if isinstance(self.slow_link_p95_multiple, bool) or not isinstance(
                self.slow_link_p95_multiple, (int, float)) \
                or (self.slow_link_p95_multiple != 0
                    and self.slow_link_p95_multiple <= 1.0):
            raise ValueError(f"slow_link_p95_multiple must be 0 (off) or "
                             f"> 1, got {self.slow_link_p95_multiple!r}")
        if isinstance(self.slow_link_min_samples, bool) or not isinstance(
                self.slow_link_min_samples, int) \
                or self.slow_link_min_samples < 2:
            raise ValueError(f"slow_link_min_samples must be an integer "
                             f">= 2, got {self.slow_link_min_samples!r}")
        if isinstance(self.slow_link_window_s, bool) or not isinstance(
                self.slow_link_window_s, (int, float)) \
                or self.slow_link_window_s <= 0:
            raise ValueError(f"slow_link_window_s must be a number > 0, "
                             f"got {self.slow_link_window_s!r}")
        if isinstance(self.link_seed, bool) or not isinstance(
                self.link_seed, int):
            raise ValueError(f"link_seed must be an integer, "
                             f"got {self.link_seed!r}")
        for f, t in (("fec", FECConfig), ("hedge", HedgeConfig),
                     ("faults", FaultConfig)):
            v = getattr(self, f)
            if v is not None and not isinstance(v, t):
                raise ValueError(f"{f} must be a {t.__name__} or None, "
                                 f"got {type(v).__name__}")


def migration_wire_nbytes(payload_nbytes: int, fec: Optional[FECConfig]) -> int:
    """Wire bytes of one migrated page chunk: the payload plus the 8-byte
    integrity sidecar, FEC-framed when parity is on. The link holds every
    wire tree it builds to this."""
    sealed = int(payload_nbytes) + 8
    if fec is not None and fec.enabled:
        return fec.wire_nbytes(sealed)
    return sealed


# ---------------------------------------------------------------------------
# the migration link: detect -> repair -> retry -> hedge, per page
# ---------------------------------------------------------------------------


def _host_tree(payload: dict) -> dict:
    """A page payload's host arrays as CPU tensors (wrapped, not copied,
    where already contiguous)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in payload.items()}


class MigrationLink:
    """Host-driven page transport over the boundary hop's primitives.

    :meth:`send` seals one page payload, frames it (FEC when configured),
    injects the seeded faults and walks the ladder; it never delivers
    unverified bytes: success returns the arrived payload as host numpy,
    exhaustion raises :class:`MigrationError`. The counters are the faulty
    link's words (pages, transmissions, wire_bytes, detected, repaired,
    retried, hedge_wins, failed)."""

    def __init__(self, *, fec: Optional[FECConfig] = None,
                 hedge: Optional[HedgeConfig] = None,
                 faults: Optional[FaultConfig] = None,
                 max_retries: int = 2, seed: int = 0,
                 clock: Clock = MONOTONIC, transfer_s: float = 0.0):
        self.fec = fec if (fec is not None and fec.enabled) else None
        self.hedge = hedge if (hedge is not None and hedge.enabled) else None
        self.faults = faults
        self.max_retries = int(max_retries)
        self.clock = clock
        #: modeled wire time a send, burned on a clock that can ``advance``
        #: (a FakeClock); :meth:`set_transfer_multiplier` inflates it
        self.transfer_s = float(transfer_s)
        self._transfer_mult = 1.0
        self.alive = True
        self.counters = {"pages": 0, "transmissions": 0, "wire_bytes": 0,
                         "detected": 0, "repaired": 0, "retried": 0,
                         "hedge_wins": 0, "failed": 0}
        self.seed = int(seed)
        self._sends = 0
        #: test hook: XOR one byte of this FEC chunk on the next
        #: transmission, then clear (the single-corrupt-chunk heal case)
        self.corrupt_chunk_once: Optional[int] = None

    def fail(self) -> None:
        """Chaos switch: every later :meth:`send` raises at once."""
        self.alive = False

    def set_transfer_multiplier(self, mult: float) -> None:
        """Gray-failure chaos switch: every later send's modeled wire time
        times ``mult``; the link stays up and delivers verified bytes."""
        if mult <= 0:
            raise ValueError(f"transfer multiplier must be > 0, got {mult!r}")
        self._transfer_mult = float(mult)

    def _burn_transfer_time(self) -> None:
        if self.transfer_s <= 0.0:
            return
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            advance(self.transfer_s * self._transfer_mult)

    def wire_nbytes(self, payload_nbytes: int) -> int:
        return migration_wire_nbytes(payload_nbytes, self.fec)

    def send(self, payload: dict, *, sid: int, page: int) -> dict:
        """One page chunk through the ladder -> the verified arrived payload
        as host numpy arrays; raises :class:`MigrationError` when the link
        is down or every attempt fails integrity."""
        if not self.alive:
            raise MigrationError(f"migration link is down (sid={sid} page={page})")
        self._burn_transfer_time()
        dev = _host_tree(payload)
        sealed = seal_payload(dev)
        declared = migration_wire_nbytes(tree_nbytes(dev), self.fec)
        send_key = fault_key(self.seed, self._sends)
        self._sends += 1
        routes = self.hedge.routes if self.hedge is not None else 1
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.counters["retried"] += 1
            for route in range(routes):
                wire = fec_encode(sealed, self.fec) if self.fec is not None else sealed
                measured = tree_nbytes(wire)
                if measured != declared:
                    self.counters["failed"] += 1
                    raise MigrationError(
                        f"migration wire-byte contract violated: built "
                        f"{measured} B, declared {declared} B "
                        f"(sid={sid} page={page})")
                key = fold(fold(send_key, attempt), route)
                if self.faults is not None and self.faults.enabled:
                    wire = inject_faults(wire, key, self.faults)
                if self.corrupt_chunk_once is not None and self.fec is not None:
                    c, self.corrupt_chunk_once = self.corrupt_chunk_once, None
                    chunks = wire["chunks"].clone()
                    chunks[c, 0] ^= 0xFF
                    wire = {"chunks": chunks, "words": wire["words"]}
                self.counters["transmissions"] += 1
                self.counters["wire_bytes"] += measured
                get_registry().counter(
                    "edgellm_disagg_wire_bytes_total",
                    "bytes pushed over the migration link").inc(measured)
                if self.fec is not None:
                    arrived, bad, repaired = fec_decode(wire, self.fec, sealed)
                else:
                    arrived, bad, repaired = wire, False, False
                # the migration link verifies host pages: no card sync
                ok = bool(verify_payload(arrived))  # graphlint: disable=EG005
                if bad or not ok:
                    self.counters["detected"] += 1
                if ok:
                    if repaired:
                        self.counters["repaired"] += 1
                    if route:
                        self.counters["hedge_wins"] += 1
                    self.counters["pages"] += 1
                    # host tensors to numpy: a view, no card sync
                    p = arrived["p"]
                    return {k: p[k].numpy() for k in p}  # graphlint: disable=EG005
        self.counters["failed"] += 1
        hedged = f" x {routes} hedge routes" if routes > 1 else ""
        raise MigrationError(
            f"page transfer failed integrity after "
            f"{self.max_retries + 1} attempt(s){hedged} "
            f"(sid={sid} page={page}); corrupt bytes are never adopted")


# ---------------------------------------------------------------------------
# prefill workers
# ---------------------------------------------------------------------------


class PrefillWorker:
    """One prefill worker: a private staging :class:`ContinuousBatcher` (the
    decode batcher's page geometry, tier and dtypes, so the staged bytes are
    the colocated pool's by the deterministic quantize-on-append) that
    admits prompts, samples token 0 and holds slots for migration.
    ``kill`` simulates the worker dying: every later access raises
    :class:`PrefillWorkerLost`."""

    def __init__(self, wid: int, batcher: ContinuousBatcher):
        self.wid = wid
        self.bat = batcher
        self.alive = True
        self.prefills = 0

    def kill(self) -> None:
        self.alive = False

    def _check(self) -> None:
        if not self.alive:
            raise PrefillWorkerLost(f"prefill worker {self.wid} is dead; its staging pool is "
                                    f"unreachable")

    def prefill(self, prompt: np.ndarray, max_new_tokens: int, temperature: float,
                rng_seed: int):
        """Submit and admit one prompt -> ``(staging_sid, Stream)`` with the
        slot held for migration, or None when the staging pool has no room
        now (the caller retries on the next pump)."""
        self._check()
        with obs_span("disagg.prefill", wid=self.wid, prompt_len=int(prompt.size)):
            sid = self.bat.submit(prompt, max_new_tokens, temperature=temperature,
                                  rng_seed=rng_seed)
            st = self.bat.prefill_hold(sid)
        if st is None:
            self.bat.discard(sid)
            return None
        self.prefills += 1
        return sid, st

    def snapshot(self, slot: int) -> dict:
        """The prefill checkpoint: the slot's whole at-rest payload, held by
        the server, so a worker death mid-migration re-drives from it."""
        self._check()
        return self.bat._gather_state(slot)

    def gather_page(self, slot: int, start: int, stop: int) -> dict:
        """One page's rows of the held staging slot; raises
        :class:`PrefillWorkerLost` once the worker is dead (a kill
        mid-migration lands between pages)."""
        self._check()
        return self.bat.gather_rows(slot, start, stop)

    def release(self, sid: int) -> None:
        """Retire a handoff (its pages landed, or it was abandoned); a dead
        worker's staging state is unreachable, so skipped."""
        if self.alive:
            self.bat.release_handoff(sid)


# ---------------------------------------------------------------------------
# the handoff record
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Handoff:
    """One migrated prefill: what decode admission needs, held by the
    server until the stream finishes (the decode-kill re-admission
    source)."""

    sid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    rng_seed: int
    tokens: list
    payload: Optional[dict]   # the verified arrived resume payload (host numpy)
    wid: int = -1
    pages: int = 0
    redriven_pages: int = 0


# ---------------------------------------------------------------------------
# the disaggregated server
# ---------------------------------------------------------------------------


class DisaggServer:
    """The disaggregated front, with the ``ContinuousBatcher`` surface
    (``submit`` / ``step`` / ``run`` / ``results`` / ``pop_result`` /
    ``discard`` / ``probe_prefix`` / ``report`` / ``bcfg`` / ``rt`` /
    ``pool``), so :meth:`~.frontend.ServeFront.drain_batched`, deadline
    admission included, drives it unchanged.

    ``submit`` queues the prompt; the prefill pump hands it to a live
    worker and migrates the finished pages through the
    :class:`MigrationLink` into the bounded handoff queue; decode admission
    pulls a handoff when the decode pool can take it and injects it as a
    resume payload. After a degrade every prompt goes straight to the decode
    batcher: the colocated path. ``split_runtime=`` / ``placed_params=``
    build the decode and staging batchers over a split runtime."""

    def __init__(self, cfg, params, bcfg: BatchingConfig,
                 dcfg: DisaggConfig = DisaggConfig(), *, split_runtime=None,
                 placed_params=None, clock: Clock = MONOTONIC):
        self.cfg, self.params = cfg, params
        self.bcfg, self.dcfg = bcfg, dcfg
        self.clock = clock
        self._rt_args = {"split_runtime": split_runtime, "placed_params": placed_params}
        self.decode = ContinuousBatcher(cfg, params, bcfg, **self._rt_args)
        staging_bcfg = dataclasses.replace(
            bcfg, max_slots=dcfg.prefill_batch,
            num_pages=dcfg.prefill_batch * bcfg.pages_per_slot + 1,
            checkpoint_dir=None, step_deadline_s=None)
        self.workers = [PrefillWorker(i, ContinuousBatcher(cfg, params, staging_bcfg,
                                                           **self._rt_args))
                        for i in range(dcfg.num_prefill_workers)]
        self.link = MigrationLink(fec=dcfg.fec, hedge=dcfg.hedge, faults=dcfg.faults,
                                  max_retries=dcfg.max_retries, seed=dcfg.link_seed,
                                  clock=clock, transfer_s=dcfg.transfer_s_per_page)
        # slow-link detection: a rolling (t, elapsed) window and the healthy
        # baseline median frozen from the first min_samples sends
        self._xfer_window: deque = deque()
        self._xfer_baseline: Optional[float] = None
        # the rows axis of every payload array: (L, n, ...) local,
        # (n_stages, stage_size, n, ...) split
        self._row_axis = 2 if self.decode.rt is not None else 1
        self.pending: deque = deque()       # our sids awaiting a worker
        self.queue: deque = deque()         # Handoffs awaiting a decode pull
        self.handoffs: dict = {}            # our sid -> Handoff (until finished)
        self._reqs: dict = {}               # our sid -> (prompt, n, t, seed)
        self._by_decode: dict = {}          # decode sid -> our sid
        self._to_decode: dict = {}          # our sid -> decode sid
        self.results: dict = {}
        self.degraded = False
        self.degrade_reason: Optional[str] = None
        self._consecutive_failures = 0
        self._rr = 0
        self._next_sid = 0
        self.stats = {"submitted": 0, "migrations": 0, "migrated_pages": 0,
                      "redriven_pages": 0, "recompute_tokens": 0,
                      "colocated_fallbacks": 0, "readmitted": 0, "prefills": 0}
        #: chaos hook, called ``(wid, sid, page_index)`` after each page
        #: lands: soak legs kill workers mid-migration through it
        self.page_hook: Optional[Callable[[int, int, int], None]] = None

    # -- batcher surface ---------------------------------------------------

    @property
    def rt(self):
        return self.decode.rt

    @property
    def pool(self):
        return self.decode.pool

    def probe_prefix(self, prompt_ids) -> int:
        return self.decode.probe_prefix(prompt_ids)

    def submit(self, prompt_ids, max_new_tokens: int, *, temperature: float = 0.0,
               rng_seed: int = 0) -> int:
        """Accept one request (the colocated batcher's checks). The sids are
        the server's own: results come back under them whichever decode
        stream served them."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if float(temperature) < 0.0:
            raise ValueError("temperature must be >= 0")
        need = prompt.size + max_new_tokens - 1
        if need > self.bcfg.span:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens needs "
                f"{need} cache positions > slot span {self.bcfg.span}")
        sid = self._next_sid
        self._next_sid += 1
        self._reqs[sid] = (prompt, int(max_new_tokens), float(temperature), int(rng_seed))
        self.stats["submitted"] += 1
        if self.degraded or not self.dcfg.enabled:
            self._submit_colocated(sid)
        else:
            self.pending.append(sid)
        return sid

    def pop_result(self, sid: int) -> np.ndarray:
        return self.results.pop(sid)

    def discard(self, sid: int) -> None:
        """Drop a request in any state (the batcher's orphan hatch)."""
        self._reqs.pop(sid, None)
        self.results.pop(sid, None)
        self.handoffs.pop(sid, None)
        try:
            self.pending.remove(sid)
        except ValueError:
            pass
        for i, h in enumerate(self.queue):
            if h.sid == sid:
                del self.queue[i]
                break
        dsid = self._to_decode.pop(sid, None)
        if dsid is not None:
            self._by_decode.pop(dsid, None)
            self.decode.discard(dsid)

    # -- internal plumbing -------------------------------------------------

    def _submit_colocated(self, sid: int) -> None:
        prompt, mnt, temp, seed = self._reqs[sid]
        dsid = self.decode.submit(prompt, mnt, temperature=temp, rng_seed=seed)
        self._by_decode[dsid] = sid
        self._to_decode[sid] = dsid

    def _degrade(self, reason: str) -> None:
        if self.degraded:
            return
        assert reason in DEGRADE_REASONS, reason
        self.degraded = True
        self.degrade_reason = reason
        with obs_span("disagg.degrade", reason=reason):
            pass
        get_registry().gauge("edgellm_disagg_degraded",
                             "1 after the front degraded to colocated serving").set(1.0)
        # nothing accepted is lost: queued handoffs still adopt (verified
        # already), pending prompts go to the colocated path
        while self.pending:
            sid = self.pending.popleft()
            self.stats["colocated_fallbacks"] += 1
            self._submit_colocated(sid)

    def _observe_transfer(self, elapsed_s: float) -> None:
        """Slow-link detection: freeze a healthy baseline median from the
        first ``slow_link_min_samples`` transfers, then degrade
        (``migration_link_slow``) once the window's p95 reaches
        ``slow_link_p95_multiple`` times it."""
        if self.dcfg.slow_link_p95_multiple == 0 or self.degraded:
            return
        now = self.clock()
        self._xfer_window.append((now, float(elapsed_s)))
        horizon = now - self.dcfg.slow_link_window_s
        while self._xfer_window and self._xfer_window[0][0] <= horizon:
            self._xfer_window.popleft()
        if len(self._xfer_window) < self.dcfg.slow_link_min_samples:
            return
        ordered = sorted(v for _, v in self._xfer_window)
        if self._xfer_baseline is None:
            self._xfer_baseline = _linear_quantile(ordered, 0.5)
            return
        if self._xfer_baseline <= 0.0:
            return  # instant transfers: nothing to compare against
        p95 = _linear_quantile(ordered, 0.95)
        if p95 >= self.dcfg.slow_link_p95_multiple * self._xfer_baseline:
            with obs_span("gray.demote", link="migration", p95_s=p95,
                          baseline_s=self._xfer_baseline):
                self._degrade(DEGRADE_LINK_SLOW)

    def _live_workers(self) -> list:
        return [w for w in self.workers if w.alive]

    def _count_recompute(self, n: int) -> None:
        if n <= 0:
            return
        self.stats["recompute_tokens"] += int(n)
        get_registry().counter("edgellm_disagg_recompute_tokens_total",
                               "tokens re-prefilled/re-decoded after a failure").inc(int(n))

    def _slice_rows(self, payload: dict, start: int, stop: int) -> dict:
        cut = (slice(None),) * self._row_axis + (slice(start, stop),)
        return {k: v[cut] for k, v in payload.items() if k != "length"}

    def _concat_rows(self, chunks: list, length: int) -> dict:
        out = {k: np.concatenate([c[k] for c in chunks], axis=self._row_axis)
               for k in chunks[0]}
        out["length"] = np.asarray(length, np.int32)
        return out

    def _migrate(self, worker: PrefillWorker, slot: int, sid: int, length: int) -> dict:
        """Ship the held slot page by page through the link. Raises
        :class:`PrefillWorkerLost` (the source unreadable between pages) or
        :class:`MigrationError` (the ladder exhausted)."""
        ps = self.bcfg.page_size
        chunks = []
        for p, start in enumerate(range(0, length, ps)):
            stop = min(start + ps, length)
            with obs_span("disagg.migrate_page", sid=sid, wid=worker.wid, page=p,
                          rows=stop - start):
                chunk = worker.gather_page(slot, start, stop)
                t0 = self.clock()
                chunks.append(self.link.send(chunk, sid=sid, page=p))
                self._observe_transfer(self.clock() - t0)
            if self.page_hook is not None:
                self.page_hook(worker.wid, sid, p)
        return self._concat_rows(chunks, length)

    def _redrive(self, snapshot: dict, sid: int, wid: int) -> dict:
        """Re-send every page from the server-held prefill checkpoint: the
        worker is gone, its finished work is not."""
        length = int(snapshot["length"])
        ps = self.bcfg.page_size
        chunks = []
        pages = 0
        for p, start in enumerate(range(0, length, ps)):
            stop = min(start + ps, length)
            with obs_span("disagg.migrate_page", sid=sid, wid=wid, page=p,
                          rows=stop - start, redriven=True):
                chunk = self._slice_rows(snapshot, start, stop)
                t0 = self.clock()
                chunks.append(self.link.send(chunk, sid=sid, page=p))
                self._observe_transfer(self.clock() - t0)
            pages += 1
        self.stats["redriven_pages"] += pages
        return self._concat_rows(chunks, length)

    def _handle_one(self, sid: int) -> str:
        """Prefill and migrate one pending prompt -> "done" (queued,
        finished, or fell back colocated), "blocked" (no staging room: stop
        pumping this cycle) or "retry" (again, e.g. on a surviving
        worker)."""
        prompt, mnt, temp, seed = self._reqs[sid]
        live = self._live_workers()
        if not live:
            self._degrade(DEGRADE_WORKERS_LOST)
            self.stats["colocated_fallbacks"] += 1
            self._submit_colocated(sid)
            return "done"
        worker = live[self._rr % len(live)]
        self._rr += 1
        try:
            got = worker.prefill(prompt, mnt, temp, seed)
        except PrefillWorkerLost:
            return "retry"
        if got is None:
            return "blocked"
        ssid, st = got
        self.stats["prefills"] += 1
        if st.status == "finished":
            # max_new_tokens == 1: token 0 is the whole answer, no pages
            self.results[sid] = np.asarray(st.tokens, np.int32)
            self._reqs.pop(sid, None)
            worker.release(ssid)
            return "done"
        length = int(worker.bat.pool.lengths[st.slot])  # == prompt.size
        snapshot = worker.snapshot(st.slot) if self.dcfg.prefill_checkpoint else None
        try:
            try:
                payload = self._migrate(worker, st.slot, sid, length)
            except PrefillWorkerLost as e:
                flight_dump_for(e, sid=sid, wid=worker.wid, phase="migration")
                if snapshot is None:
                    # no checkpoint: the prefill died with the worker;
                    # re-prefill from scratch, counted
                    self._count_recompute(prompt.size)
                    return "retry"
                payload = self._redrive(snapshot, sid, worker.wid)
        except MigrationError as e:
            # the ladder exhausted (or the link died mid-handoff): the
            # request falls back to a colocated prefill, the same tokens
            flight_dump_for(e, sid=sid, wid=worker.wid, phase="migration")
            self._consecutive_failures += 1
            worker.release(ssid)
            self.stats["colocated_fallbacks"] += 1
            self._count_recompute(prompt.size)
            self._submit_colocated(sid)
            if not self.link.alive:
                self._degrade(DEGRADE_LINK_DEAD)
            elif self._consecutive_failures >= self.dcfg.degrade_after:
                self._degrade(DEGRADE_MIGRATION_FAILURES)
            return "done"
        self._consecutive_failures = 0
        worker.release(ssid)
        h = Handoff(sid=sid, prompt=prompt, max_new_tokens=mnt, temperature=temp,
                    rng_seed=seed, tokens=list(st.tokens), payload=payload, wid=worker.wid,
                    pages=-(-length // self.bcfg.page_size))
        with obs_span("disagg.migrate", sid=sid, wid=worker.wid, pages=h.pages, rows=length):
            pass
        self.stats["migrations"] += 1
        self.stats["migrated_pages"] += h.pages
        reg = get_registry()
        reg.counter("edgellm_disagg_migrations_total",
                    "completed prefill->decode handoffs").inc()
        reg.counter("edgellm_disagg_pages_migrated_total",
                    "KV pages moved prefill->decode").inc(h.pages)
        self.queue.append(h)
        self.handoffs[sid] = h
        return "done"

    def _pump_prefill(self) -> int:
        """Drain pending prompts through the live workers into the bounded
        handoff queue -> the number of prompts handled."""
        moved = 0
        while self.pending and not self.degraded:
            if len(self.queue) >= self.dcfg.queue_bound:
                break  # back-pressure: decode must pull first
            # popped BEFORE handling: a failure inside may degrade the front,
            # which drains pending, and must not drain (or resubmit) this sid
            sid = self.pending.popleft()
            verdict = self._handle_one(sid)
            if verdict == "done":
                moved += 1
                continue
            self.pending.appendleft(sid)
            if verdict == "blocked":
                break
            # "retry": the same sid again, on the next live worker
        return moved

    def _decode_can_pull(self, h: Handoff) -> bool:
        pool = self.decode.pool
        if len(self.decode._slot_to_sid) >= self.bcfg.max_slots:
            return False
        free = pool.num_free_pages + pool.reclaimable_index_pages
        need = int(h.payload["length"]) if h.payload is not None else 0
        return free >= pool.pages_for(max(need, 1))

    def _pump_admit(self) -> int:
        """Decode admission: pull verified handoffs while the decode pool
        can take them (the injection is the batcher's byte-move resume)."""
        moved = 0
        while self.queue and self._decode_can_pull(self.queue[0]):
            self._inject_handoff(self.queue.popleft())
            moved += 1
        return moved

    def _inject_handoff(self, h: Handoff) -> None:
        with obs_span("disagg.adopt", sid=h.sid, pages=h.pages):
            dsid = self.decode.submit(h.prompt, h.max_new_tokens, temperature=h.temperature,
                                      rng_seed=h.rng_seed)
            st = self.decode._streams[dsid]
            st.tokens = list(h.tokens)
            st.resume = dict(h.payload)
            # the payload rows are prompt K/V alone (the handoff is at
            # t == 1): re-published, so the decode pool's index survives
            st.resume_prefix = True
        self._by_decode[dsid] = h.sid
        self._to_decode[h.sid] = dsid

    def _collect(self) -> None:
        for dsid in list(self.decode.results):
            our = self._by_decode.pop(dsid, None)
            toks = self.decode.pop_result(dsid)
            if our is None:
                continue
            self._to_decode.pop(our, None)
            self.handoffs.pop(our, None)
            self._reqs.pop(our, None)
            self.results[our] = toks

    # -- the drive loop ----------------------------------------------------

    def _unfinished(self) -> bool:
        return bool(self.pending or self.queue or self._by_decode
                    or self.decode._waiting or self.decode._slot_to_sid)

    def step(self) -> int:
        """One pump cycle: prefill pending prompts (bounded by the handoff
        queue), pull admissions into decode, run one ragged decode step ->
        a progress count (0: idle)."""
        moved = self._pump_prefill()
        moved += self._pump_admit()
        stepped = self.decode.step()
        self._collect()
        return moved + stepped

    def run(self, max_steps: int = 100_000) -> dict:
        """Drive :meth:`step` until every accepted request finished."""
        for _ in range(max_steps):
            if not self._unfinished():
                break
            if self.step() == 0 and self._unfinished():
                exc = DisaggError(
                    "disagg server stalled: pending work but no pump "
                    "progress (pool too small for a waiting stream?)")
                flight_dump_for(exc, pending=len(self.pending), queue=len(self.queue),
                                decode_waiting=len(self.decode._waiting))
                raise exc
        return self.results

    # -- failure injection -------------------------------------------------

    def kill_prefill_worker(self, wid: int) -> None:
        """Simulate prefill worker ``wid`` dying (mid-migration when armed
        from :attr:`page_hook`); the front degrades only when no worker
        survives."""
        with obs_span("disagg.kill", worker=f"prefill:{wid}"):
            self.workers[wid].kill()
        if not self._live_workers() and not self.degraded:
            self._degrade(DEGRADE_WORKERS_LOST)

    def fail_link(self) -> None:
        """Simulate the link dying: the front degrades to colocated serving,
        ``migration_link_dead``."""
        self.link.fail()
        self._degrade(DEGRADE_LINK_DEAD)

    def slow_link(self, mult: float) -> None:
        """Simulate the link going gray: later transfers take ``mult`` times
        the modeled wire time; the front degrades only when the detector's
        p95 crosses the configured multiple."""
        self.link.set_transfer_multiplier(mult)

    def kill_decode_worker(self) -> None:
        """Simulate the decode worker dying. Running streams re-admit from
        stream checkpoints (``bcfg.checkpoint_dir``, the same tokens);
        otherwise, and for handoffs admitted but not yet stepped, the
        server-held handoff re-injects and decode replays (counted in
        ``recompute_tokens``); colocated streams resubmit from scratch."""
        with obs_span("disagg.kill", worker="decode"):
            pass
        old = self.decode
        ckpt_dir = self.bcfg.checkpoint_dir
        self._collect()  # finished results before the worker goes
        saved, replay, fresh = {}, [], []
        for dsid, our in list(self._by_decode.items()):
            st = old._streams.get(dsid)
            if st is None or st.status == "finished":
                continue
            if st.status == "running" and ckpt_dir is not None:
                saved[our] = old.checkpoint_stream(
                    dsid, os.path.join(ckpt_dir, f"disagg_{our}.ckpt"))
            elif our in self.handoffs:
                replay.append((our, st.t))
            else:
                fresh.append((our, st.status, st.t))
        self.decode = ContinuousBatcher(self.cfg, self.params, self.bcfg, **self._rt_args)
        self._by_decode, self._to_decode = {}, {}
        for our, path in saved.items():
            with obs_span("disagg.readmit", sid=our, how="checkpoint"):
                dsid = self.decode.restore_stream(path)
            self._by_decode[dsid] = our
            self._to_decode[our] = dsid
            self.stats["readmitted"] += 1
        for our, t in replay:
            h = self.handoffs[our]
            with obs_span("disagg.readmit", sid=our, how="handoff"):
                self._inject_handoff(h)
            # decode progress past the handoff replays deterministically
            self._count_recompute(t - len(h.tokens))
            self.stats["readmitted"] += 1
        for our, status, t in fresh:
            prompt = self._reqs[our][0]
            with obs_span("disagg.readmit", sid=our, how="resubmit"):
                self._submit_colocated(our)
            if status == "running":
                self._count_recompute(int(prompt.size) + max(t - 1, 0))
            self.stats["readmitted"] += 1

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        rep = self.decode.report()
        live = len(self._live_workers())
        reg = get_registry()
        reg.gauge("edgellm_disagg_prefill_workers", "live prefill workers").set(live)
        reg.gauge("edgellm_disagg_queue_depth",
                  "handoffs awaiting decode pull").set(len(self.queue))
        reg.gauge("edgellm_disagg_degraded",
                  "1 after the front degraded to colocated serving").set(float(self.degraded))
        reg.counter("edgellm_disagg_migrations_total",
                    "completed prefill->decode handoffs").inc(0)
        link = dict(self.link.counters)
        rep["disagg"] = {
            "enabled": self.dcfg.enabled,
            "degraded": self.degraded,
            "degrade_reason": self.degrade_reason,
            "prefill_workers": len(self.workers),
            "live_prefill_workers": live,
            "queue_depth": len(self.queue),
            "pending": len(self.pending),
            "wire_bytes": link["wire_bytes"],
            "link": link,
            "transfer_baseline_s": self._xfer_baseline,
            "transfer_window": len(self._xfer_window),
            **dict(self.stats),
        }
        return rep
