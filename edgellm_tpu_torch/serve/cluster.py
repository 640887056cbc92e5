"""Cluster-scale replica router: prefix-affinity placement, per-replica
failure isolation, the drain / respawn lifecycle and the gray-failure plane.
PyTorch-package counterpart of ``edgellm_tpu/serve/cluster.py`` (pure host
Python, as there: the replicas' kernels run inside their fronts).

One :class:`~.frontend.ServeFront` is one replica: a batcher, its paged
pool on the card, and the overload control plane around them. This module
makes N of those a service:

    ClusterFront.submit(Request)
      -- probe every live replica's radix index (`probe_prefix`) -->
         route to the longest shared prefix (>= min_affinity_tokens),
         least-loaded fallback, deterministic (load, id) tiebreak
      -- per-replica CircuitBreaker + RetryBudget gate the candidates -->
         replica.front.submit_ex(...)

    ClusterFront.drain()
      -- round-robin replica drains; every absorbed record feeds that
         replica's breaker -->
         replica-fatal failure (stage_lost / watchdog / wedged batcher)
           -> kill: flight-dump once, drain the queue + checkpoint the
             mid-flight streams (DecodeCheckpoint), re-admit elsewhere
             token-identically (counting recompute tokens), respawn from a
             clean plan after exponential backoff + jitter, re-admit to the
             rotation only after half-open probe requests succeed

Design rules:

- **Zero accepted loss.** Work a replica accepted is never dropped by the
  router: a dead replica's queue re-admits on survivors under the same
  seed, mid-flight streams resume from their checkpoint, and when no
  survivor can take a request it parks until one can. Only *fresh* submits
  are refused (``no_live_replica``) when the whole fleet is down.
- **One sick replica cannot poison the fleet.** Routing consults each
  replica's own breaker and retry budget.
- **Determinism.** Everything runs on the injected clock; respawn jitter
  comes from ``numpy.random.default_rng(jitter_seed)`` (the reference's
  draws, so respawn times equal its); candidate iteration is sorted by
  replica id. The same seed replays the same routing decisions.
- **The gray plane** (``ClusterConfig.gray``): a :class:`~.overload.
  StragglerDetector` over every completed leg's latency demotes slow
  replicas in the placement sort, and a request running past the healthy
  fleet's latency quantile is hedged on a second replica, first finisher
  wins, the loser cancelled or its late record swallowed (exactly once).

Replicas share whatever device their fronts were built on; a fleet on one
card runs its replicas in turn (the drain's round-robin). A real
``ServeFront`` has no ``cancel`` / ``checkpoint_inflight`` /
``restore_inflight``: the router reaches them through ``getattr``, so a
losing hedge leg there decodes to its end and is discarded, and a killed
replica's queue re-admits from scratch.

The simulated replica (:class:`SimReplicaFront`) duck-types the slice of
the ``ServeFront`` surface the router uses and decodes with a pure
crc-chain token function on the virtual clock, byte for byte the
reference's: the scale vehicle of ``run_cluster_soak``.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import struct
import threading
import zlib
from typing import Any, Callable, Optional

import numpy as np

from ..obs.flight import FlightRecorder, flight_dump_for
from ..obs.metrics import get_registry
from ..obs.tracing import span as obs_span
from ..utils.clock import MONOTONIC, Clock
from ..utils.concurrency import guarded_by
from .frontend import Request, RequestRecord
from .overload import (COMPLETED, FAILED, FAILED_OVER, REJECTED, SHED,
                       TIMED_OUT, BreakerConfig, CircuitBreaker,
                       DeadlineExpired, RetryBudget, RetryBudgetConfig,
                       ServeFrontConfigError, StragglerConfig,
                       StragglerDetector)
from .recovery import DecodeCheckpoint

__all__ = [
    "AutoscalerConfig", "ClusterConfig", "ClusterConfigError", "ClusterFront",
    "GrayConfig", "Replica", "ReplicaLostError", "RespawnConfig",
    "SimReplicaConfig", "SimReplicaFront", "drive_cluster",
    "sim_reference_tokens",
    "REPLICA_LIVE", "REPLICA_DEAD", "REPLICA_PROBING",
]

REPLICA_LIVE = "live"
REPLICA_DEAD = "dead"
REPLICA_PROBING = "probing"

#: record reasons that indict the replica, not the request — the router
#: kills and re-admits instead of failing the work
_REPLICA_FATAL_PREFIXES = ("stage_lost", "batcher:")
_REPLICA_FATAL_REASONS = ("watchdog",)


class ClusterConfigError(ServeFrontConfigError):
    """A ClusterConfig (or its nested blocks) failed validation."""


class ReplicaLostError(RuntimeError):
    """A replica left the rotation (chaos kill, fatal failure record). The
    router raises nothing — this type exists so the flight recorder has a
    typed failure instance to dump exactly once per kill."""

    def __init__(self, replica_id: int, reason: str):
        super().__init__(f"replica {replica_id} lost: {reason}")
        self.replica_id = replica_id
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class RespawnConfig:
    """Dead-replica resurrection policy: exponential backoff with seeded
    jitter on the injected clock, then ``half_open_probes`` live requests
    must complete before the replica rejoins the rotation (the breaker
    half-open discipline, applied to a whole replica)."""

    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    jitter_frac: float = 0.1
    jitter_seed: int = 0
    half_open_probes: int = 2

    def __post_init__(self):
        if self.backoff_base_s <= 0 or self.backoff_max_s <= 0:
            raise ClusterConfigError(
                f"backoff_base_s/backoff_max_s must be > 0, got "
                f"{self.backoff_base_s!r}/{self.backoff_max_s!r}")
        if self.backoff_factor < 1.0:
            raise ClusterConfigError(
                f"backoff_factor must be >= 1, got {self.backoff_factor!r}")
        if not 0.0 <= self.jitter_frac <= 1.0:
            raise ClusterConfigError(
                f"jitter_frac must be in [0, 1], got {self.jitter_frac!r}")
        if self.half_open_probes < 1:
            raise ClusterConfigError(
                f"half_open_probes must be >= 1, got "
                f"{self.half_open_probes!r}")


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Simulated autoscaler bounds: driven by the published
    ``edgellm_cluster_pressure`` gauge (mean per-replica ``load_fraction`` —
    queue fullness or brownout ladder position), with min-dwell hysteresis
    so the fleet cannot flap."""

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_pressure: float = 0.75
    scale_down_pressure: float = 0.15
    min_dwell_s: float = 30.0

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ClusterConfigError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas!r}/{self.max_replicas!r}")
        if not (0.0 <= self.scale_down_pressure
                < self.scale_up_pressure <= 1.0):
            raise ClusterConfigError(
                f"need 0 <= scale_down_pressure < scale_up_pressure <= 1, "
                f"got {self.scale_down_pressure!r}/"
                f"{self.scale_up_pressure!r}")
        if self.min_dwell_s < 0:
            raise ClusterConfigError(
                f"min_dwell_s must be >= 0, got {self.min_dwell_s!r}")


@dataclasses.dataclass(frozen=True)
class GrayConfig:
    """The gray-failure plane's policy bundle: straggler demotion, request
    hedging, and deadline propagation. A replica whose windowed p95 service
    latency reaches ``p95_multiple`` × the pooled fleet median is demoted
    in the placement sort (it still serves, but loses every tie); a request
    still running after the fleet's ``hedge_delay_quantile`` latency is
    re-placed on a second replica and the first finisher wins, with the
    loser cancelled or discarded exactly-once. ``max_hedge_fraction``
    bounds hedge dispatches relative to primary placements so the backup
    traffic cannot itself brown the fleet out."""

    enabled: bool = False
    p95_multiple: float = 3.0
    hedge_delay_quantile: float = 0.95
    min_dwell_s: float = 5.0
    max_hedge_fraction: float = 0.25
    min_samples: int = 8
    window_s: float = 120.0

    def __post_init__(self):
        if not isinstance(self.enabled, bool):
            raise ClusterConfigError(
                f"enabled must be a bool, got {self.enabled!r}")
        if self.p95_multiple <= 1.0:
            raise ClusterConfigError(
                f"p95_multiple must be > 1, got {self.p95_multiple!r}")
        if not 0.0 < self.hedge_delay_quantile < 1.0:
            raise ClusterConfigError(
                f"hedge_delay_quantile must be in (0, 1), got "
                f"{self.hedge_delay_quantile!r}")
        if self.min_dwell_s < 0:
            raise ClusterConfigError(
                f"min_dwell_s must be >= 0, got {self.min_dwell_s!r}")
        if not 0.0 <= self.max_hedge_fraction <= 1.0:
            raise ClusterConfigError(
                f"max_hedge_fraction must be in [0, 1], got "
                f"{self.max_hedge_fraction!r}")
        if isinstance(self.min_samples, bool) or not isinstance(
                self.min_samples, int) or self.min_samples < 1:
            raise ClusterConfigError(
                f"min_samples must be an int >= 1, got "
                f"{self.min_samples!r}")
        if self.window_s <= 0:
            raise ClusterConfigError(
                f"window_s must be > 0, got {self.window_s!r}")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """The router's frozen policy bundle. ``min_affinity_tokens`` is the
    prefix-affinity threshold (a shorter match routes least-loaded instead);
    ``max_readmissions`` bounds failure-driven bounces per request before it
    fails terminally (admission refusals on survivors park instead — they
    never lose accepted work). ``flight_dir`` arms one flight recorder per
    replica; ``checkpoint_dir`` spools mid-flight DecodeCheckpoints during a
    replica drain."""

    num_replicas: int = 2
    min_affinity_tokens: int = 4
    probe_prefix: bool = True
    max_readmissions: int = 3
    breaker: BreakerConfig = dataclasses.field(default_factory=BreakerConfig)
    retry_budget: RetryBudgetConfig = dataclasses.field(
        default_factory=RetryBudgetConfig)
    respawn: RespawnConfig = dataclasses.field(default_factory=RespawnConfig)
    autoscaler: AutoscalerConfig = dataclasses.field(
        default_factory=AutoscalerConfig)
    gray: GrayConfig = dataclasses.field(default_factory=GrayConfig)
    flight_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None

    def __post_init__(self):
        if self.num_replicas < 1:
            raise ClusterConfigError(
                f"num_replicas must be >= 1, got {self.num_replicas!r}")
        if self.min_affinity_tokens < 1:
            raise ClusterConfigError(
                f"min_affinity_tokens must be >= 1, got "
                f"{self.min_affinity_tokens!r}")
        if self.max_readmissions < 0:
            raise ClusterConfigError(
                f"max_readmissions must be >= 0, got "
                f"{self.max_readmissions!r}")
        for field, cls in (("breaker", BreakerConfig),
                           ("retry_budget", RetryBudgetConfig),
                           ("respawn", RespawnConfig),
                           ("autoscaler", AutoscalerConfig),
                           ("gray", GrayConfig)):
            if not isinstance(getattr(self, field), cls):
                raise ClusterConfigError(
                    f"{field} must be a {cls.__name__}, got "
                    f"{type(getattr(self, field)).__name__}")


class Replica:
    """One replica's router-side state: the front, its breaker + retry
    budget, the lifecycle machine (live → dead → probing → live), and
    lifetime counters."""

    def __init__(self, replica_id: int, front: Any, breaker: CircuitBreaker,
                 budget: RetryBudget,
                 flight: Optional[FlightRecorder] = None):
        self.id = replica_id
        self.generation = 0
        self.front = front
        self.breaker = breaker
        self.budget = budget
        self.flight = flight
        self.state = REPLICA_LIVE
        self.died_at: Optional[float] = None
        self.respawn_at: Optional[float] = None
        self.backoff_attempt = 0
        self.probes_sent = 0
        self.probes_ok = 0
        # lifetime counters (survive respawns)
        self.placed = 0
        self.completed = 0
        self.failures = 0
        self.kills = 0
        self.respawns = 0

    def summary(self) -> dict:
        return {
            "state": self.state, "generation": self.generation,
            "placed": self.placed, "completed": self.completed,
            "failures": self.failures, "kills": self.kills,
            "respawns": self.respawns,
            "queue_depth": (self.front.queue_depth
                            if self.front is not None else None),
            "respawn_at": self.respawn_at,
            "breaker": self.breaker.summary(),
            "retry_budget": self.budget.summary(),
            "disagg": self.disagg_state(),
        }

    def disagg_state(self) -> Optional[dict]:
        """The front's disaggregation state (degraded flag + typed reason),
        or ``None`` when the replica serves a plain colocated batcher."""
        probe = getattr(self.front, "disagg_state", None)
        return probe() if callable(probe) else None

    def _disagg_penalty(self) -> int:
        """1 when this replica's disagg front has degraded to colocated
        serving, else 0 — folded into the placement sort keys so healthy
        disaggregated peers win ties and absorb new load first."""
        st = self.disagg_state()
        return 1 if (st is not None and st["degraded"]) else 0


@dataclasses.dataclass
class _Placement:
    """Router-side bookkeeping for one accepted request."""

    crid: int                       # cluster-level request id
    req: Request
    replica_id: int
    local_rid: int
    submitted_at: float
    generation: int = 0             # replica generation the leg was placed on
    resubmits: int = 0
    recompute_tokens: int = 0       # tokens regenerated after scratch readmits
    # hedge leg (gray-failure plane): a second, concurrently running copy
    # of the same request on another replica — first finisher wins
    hedge_replica_id: Optional[int] = None
    hedge_local_rid: Optional[int] = None
    hedge_generation: Optional[int] = None
    hedged_at: Optional[float] = None


@guarded_by("_lock", fields=["_seq", "_loose"])
class ClusterFront:
    """N replicas behind a prefix-affine, failure-isolating router.

    ``factory(replica_id, generation) -> front`` builds a replica front —
    a :class:`~.frontend.ServeFront` (batcher + paged pool on the card;
    ``run.py`` builds these) or a :class:`SimReplicaFront`
    (the soak's scale vehicle). A respawn calls the factory again with a
    bumped generation: a *clean plan*, no state carried over.

    Threading contract: ``submit`` is thread-safe for id minting and the
    loose-record buffer (the declared lock); routing + drain are
    single-threaded, like ``ServeFront.drain``.
    """

    def __init__(self, factory: Callable[[int, int], Any],
                 config: Optional[ClusterConfig] = None, *,
                 clock: Clock = MONOTONIC):
        self.cfg = config if config is not None else ClusterConfig()
        self.factory = factory
        self.clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self.replicas: dict[int, Replica] = {}
        self._next_replica_id = self.cfg.num_replicas
        self._placements: dict[int, _Placement] = {}
        self._local_index: dict = {}  # (replica, generation, local_rid) -> crid
        self._parked: list = []       # [(crid, resume_payload | None)]
        self._loose: list = []        # terminal records minted outside drains
        self._jitter_rng = np.random.default_rng(self.cfg.respawn.jitter_seed)
        self._last_scale_at = self.clock()
        self.kills: list = []
        self.autoscale_events: list = []
        self.totals = {"placed": 0, "affinity": 0, "least_loaded": 0,
                       "probe": 0, "readmitted": 0, "recompute_tokens": 0,
                       "no_replica_rejects": 0, "parked_total": 0,
                       "hedges": 0, "hedge_wins_primary": 0,
                       "hedge_wins_hedge": 0, "hedge_cancelled": 0,
                       "hedge_discarded": 0, "hedge_refused": 0,
                       "deadline_expired": 0}
        gray = self.cfg.gray
        self._straggler: Optional[StragglerDetector] = (
            StragglerDetector(
                StragglerConfig(p95_multiple=gray.p95_multiple,
                                window_s=gray.window_s,
                                min_samples=gray.min_samples,
                                min_dwell_s=gray.min_dwell_s),
                clock=self.clock)
            if gray.enabled else None)
        self._gray_flagged: set = set()
        # losing hedge legs whose front could not cancel them: their late
        # records are swallowed on arrival (exactly-once accounting)
        self._hedge_discard: set = set()
        for i in range(self.cfg.num_replicas):
            self.replicas[i] = self._new_replica(i)

    # -- replica construction / lifecycle ----------------------------------

    def _new_replica(self, replica_id: int) -> Replica:
        flight = None
        if self.cfg.flight_dir is not None:
            flight = FlightRecorder(
                os.path.join(self.cfg.flight_dir, f"replica{replica_id}"),
                clock=self.clock)
        return Replica(
            replica_id, self.factory(replica_id, 0),
            CircuitBreaker(f"replica{replica_id}", self.cfg.breaker,
                           clock=self.clock),
            RetryBudget(self.cfg.retry_budget, clock=self.clock),
            flight=flight)

    def kill_replica(self, replica_id: int, reason: str = "chaos") -> None:
        """Operator/chaos entry point: drain + kill one replica now (same
        path a replica-fatal failure record takes)."""
        r = self.replicas.get(replica_id)
        if r is None or r.state == REPLICA_DEAD:
            return
        self._kill(r, reason)

    def _kill(self, r: Replica, reason: str) -> None:
        now = self.clock()
        with obs_span("cluster.kill", replica=r.id, reason=reason):
            # exactly one post-mortem per induced failure: the exception
            # instance carries the recorder latch
            exc = ReplicaLostError(r.id, reason)
            if r.flight is not None:
                # NB: "reason" is dump()'s positional (the exception type
                # name) — the kill cause rides as kill_reason
                r.flight.dump_for(exc, replica=r.id, kill_reason=reason,
                                  generation=r.generation)
            else:
                flight_dump_for(exc, replica=r.id, kill_reason=reason,
                                generation=r.generation)
            front = r.front
            r.state = REPLICA_DEAD   # before re-placement: never a candidate
            r.kills += 1
            r.failures += 1
            r.died_at = now
            r.backoff_attempt += 1
            rs = self.cfg.respawn
            backoff = min(rs.backoff_base_s
                          * rs.backoff_factor ** (r.backoff_attempt - 1),
                          rs.backoff_max_s)
            backoff *= 1.0 + rs.jitter_frac * float(self._jitter_rng.random())
            r.respawn_at = now + backoff
            r.breaker.trip()
            self.kills.append({"replica": r.id, "at_s": now,
                               "reason": reason, "respawn_at": r.respawn_at})
            if front is None:
                return
            r.front = None
            # 1) queued work: nothing computed yet — re-admit from scratch,
            #    token-identical under the same seed, zero recompute
            for local_rid, req in front.drain_pending():
                crid = self._local_index.pop(
                    (r.id, r.generation, local_rid), None)
                if crid is not None and not self._detach_leg(crid, r.id):
                    self._readmit(crid, resume=None)
            # 2) mid-flight work: checkpoint via DecodeCheckpoint and resume
            #    elsewhere (or re-run from scratch, counting the tokens the
            #    dead replica had already produced as recompute)
            ckpt = getattr(front, "checkpoint_inflight", None)
            if ckpt is not None:
                for item in ckpt(self.cfg.checkpoint_dir):
                    crid = self._local_index.pop(
                        (r.id, r.generation, item["local_rid"]), None)
                    if crid is not None and not self._detach_leg(crid, r.id):
                        self._readmit(crid, resume=item)

    def _respawn(self, r: Replica) -> None:
        with obs_span("cluster.respawn", replica=r.id,
                      generation=r.generation + 1):
            r.generation += 1
            r.front = self.factory(r.id, r.generation)
            r.breaker.reset()
            r.budget = RetryBudget(self.cfg.retry_budget, clock=self.clock)
            r.state = REPLICA_PROBING
            r.probes_sent = 0
            r.probes_ok = 0
            r.respawns += 1
            r.respawn_at = None

    def _tick(self) -> None:
        """Lifecycle pass: due respawns, parked re-placement, gauges,
        autoscale. Called from submit and drain — cheap when idle."""
        now = self.clock()
        for rid in sorted(self.replicas):
            r = self.replicas[rid]
            if (r.state == REPLICA_DEAD and r.respawn_at is not None
                    and now >= r.respawn_at):
                self._respawn(r)
        if self._parked:
            # swap the list out before iterating: a failed re-placement
            # re-parks through _absorb, which appends to self._parked — and
            # appending to the list under iteration would retry the same
            # request forever inside this loop
            parked, self._parked = self._parked, []
            # starvation guard: cluster ids mint in arrival order, so the
            # oldest parked request gets first claim on freed capacity no
            # matter how it bounced back into the park list
            parked.sort(key=lambda item: item[0])
            for crid, resume in parked:
                target, _ = self._place(self._placements[crid].req)
                if target is not None:
                    # don't bounce off a saturated survivor every tick —
                    # stay parked until someone has room
                    lf = getattr(target.front, "load_fraction", None)
                    if lf is not None and lf() >= 1.0:
                        target = None
                if target is None:
                    self._parked.append((crid, resume))
                else:
                    self._readmit_to(target, crid, resume)
        if self._straggler is not None:
            self._gray_tick(now)
        self._publish()
        if self.cfg.autoscaler.enabled:
            self._autoscale(now)

    # -- placement ----------------------------------------------------------

    def _candidates(self) -> list:
        """Replicas that may take a fresh placement, sorted by id. A probing
        replica with probe quota left comes FIRST — it needs live traffic to
        prove itself (the half-open discipline)."""
        probing, live = [], []
        for rid in sorted(self.replicas):
            r = self.replicas[rid]
            if r.front is None:
                continue
            if (r.state == REPLICA_PROBING
                    and r.probes_sent < self.cfg.respawn.half_open_probes):
                probing.append(r)
            elif r.state == REPLICA_LIVE:
                if r.breaker.state == "open":
                    continue
                if r.budget.exhausted():
                    r.budget.deny()
                    continue
                live.append(r)
        return probing + live

    def _place(self, req: Request) -> tuple:
        """Pick a replica for this request; returns (Replica | None, how).

        Order: half-open probes first, then longest shared prefix at or
        above ``min_affinity_tokens`` (ties: least-loaded, then lowest id),
        then least-loaded (same tiebreak). Deterministic for a fixed fleet
        state — the soak replays its routing."""
        cands = self._candidates()
        if not cands:
            return None, "no_live_replica"
        first = cands[0]
        if first.state == REPLICA_PROBING:
            return first, "probe"
        if self.cfg.probe_prefix:
            best = None
            for r in cands:
                shared = r.front.probe_prefix(req.prompt_ids)
                if shared >= self.cfg.min_affinity_tokens:
                    # a degraded disagg replica still wins on a strong
                    # prefix hit (the shared KV outweighs colocated
                    # throughput) but loses every tie to a healthy peer;
                    # a flagged straggler is demoted the same way
                    key = (-shared,
                           r._disagg_penalty() + self._gray_penalty(r),
                           r.front.queue_depth, r.id)
                    if best is None or key < best[0]:
                        best = (key, r)
            if best is not None:
                return best[1], "affinity"
        r = min(cands, key=lambda c: (c._disagg_penalty()
                                      + self._gray_penalty(c),
                                      c.front.queue_depth, c.id))
        return r, "least_loaded"

    def _gray_penalty(self, r: Replica) -> int:
        """1 when the straggler detector currently flags this replica (it
        loses every placement tie, like a degraded disagg front), else 0.
        Zero-cost identity when the gray plane is disabled: the sort keys
        collapse to the pre-gray ordering."""
        if self._straggler is None:
            return 0
        return 1 if r.id in self._gray_flagged else 0

    def submit(self, req: Request) -> int:
        """Route one request onto the fleet; returns the cluster request id.
        With no routable replica the request is refused with a terminal
        ``no_live_replica`` record (flushed by the next :meth:`drain`)."""
        self._tick()
        now = self.clock()
        with self._lock:
            self._seq += 1
            crid = self._seq
        target, how = self._place(req)
        if target is None:
            self.totals["no_replica_rejects"] += 1
            rec = self._refusal_record(crid, req, now)
            with self._lock:
                self._loose.append(rec)
            return crid
        if target.state == REPLICA_PROBING:
            target.probes_sent += 1
        self.totals["placed"] += 1
        self.totals[how if how in ("affinity", "least_loaded", "probe")
                    else "least_loaded"] += 1
        target.placed += 1
        local_rid, refusal = self._submit_to(target, req)
        self._placements[crid] = _Placement(
            crid=crid, req=req, replica_id=target.id, local_rid=local_rid,
            submitted_at=now, generation=target.generation)
        self._local_index[(target.id, target.generation, local_rid)] = crid
        if refusal is not None:
            # replica-level admission refusal, already terminal there —
            # absorb it through the normal path so breakers/probes see it
            final = self._absorb(target, refusal)
            if final is not None:
                with self._lock:
                    self._loose.append(final)
        reg = get_registry()
        if reg.enabled:
            reg.counter("edgellm_cluster_placements_total",
                        "router placements by policy").inc(policy=how)
        return crid

    def _submit_to(self, r: Replica, req: Request) -> tuple:
        sub_ex = getattr(r.front, "submit_ex", None)
        if sub_ex is not None:
            return sub_ex(req)
        return r.front.submit(req), None

    def _refusal_record(self, crid: int, req: Request,
                        now: float) -> RequestRecord:
        prompt = np.asarray(req.prompt_ids)
        b = 1 if prompt.ndim <= 1 else int(prompt.shape[0])
        s = int(prompt.size) // max(b, 1)
        return RequestRecord(
            request_id=crid, outcome=REJECTED, reason="no_live_replica",
            backend=None, priority=req.priority, submitted_at=now,
            started_at=None, finished_at=None, queue_wait_s=None, ttft_s=None,
            service_s=None, latency_s=None, deadline_s=req.deadline_s,
            deadline_met=None, prompt_tokens=s,
            requested_tokens=req.max_new_tokens, granted_tokens=None,
            capacity=None, batch=b, plan={"replica": None},
            brownout_level=0, retries_charged=0, jit_misses=None,
            tokens=None, recovery=None)

    # -- re-admission -------------------------------------------------------

    def _readmit(self, crid: int, resume: Optional[dict]) -> None:
        """Re-place one accepted request after its replica died. Bounded by
        ``max_readmissions`` for failure bounces; parks when no survivor can
        take it (accepted work is never dropped)."""
        pl = self._placements[crid]
        pl.resubmits += 1
        self.totals["readmitted"] += 1
        if pl.resubmits > self.cfg.max_readmissions:
            rec = dataclasses.replace(
                self._refusal_record(crid, pl.req, self.clock()),
                outcome=FAILED, reason="readmission_exhausted",
                submitted_at=pl.submitted_at,
                recovery={"readmissions": pl.resubmits,
                          "recompute_tokens": pl.recompute_tokens})
            del self._placements[crid]
            with self._lock:
                self._loose.append(rec)
            return
        target, _ = self._place(pl.req)
        if target is None:
            self.totals["parked_total"] += 1
            self._parked.append((crid, resume))
            return
        self._readmit_to(target, crid, resume)

    def _readmit_to(self, target: Replica, crid: int,
                    resume: Optional[dict]) -> None:
        pl = self._placements[crid]
        now = self.clock()
        remaining = self._remaining_deadline(pl, now)
        if remaining is not None and remaining <= 0.0:
            # deadline audit: admission checks the wait at enqueue, but a
            # park (or a kill + backoff) can eat the whole budget before
            # placement ever happens — finish timed_out here instead of
            # dispatching work nobody can use
            self._expire_placement(crid, now)
            return
        restore = getattr(target.front, "restore_inflight", None)
        if resume is not None and restore is not None:
            # checkpointed stream resumes where it stopped: token-identical
            # continuation, zero recompute
            local_rid = restore(resume)
            refusal = None
        else:
            if resume is not None:
                # scratch re-run: the tokens the dead replica already
                # produced are recomputed on the survivor
                pl.recompute_tokens += int(resume.get("tokens_done", 0))
                self.totals["recompute_tokens"] += int(
                    resume.get("tokens_done", 0))
            # deadline propagation: the survivor sees only the budget that
            # is still left, so its own admission/queue checks refuse work
            # that can no longer finish in time
            local_rid, refusal = self._submit_to(
                target, self._effective_req(pl, now))
        if target.state == REPLICA_PROBING:
            target.probes_sent += 1
        target.placed += 1
        pl.replica_id = target.id
        pl.local_rid = local_rid
        pl.generation = target.generation
        self._local_index[(target.id, target.generation, local_rid)] = crid
        if refusal is not None:
            final = self._absorb(target, refusal)
            if final is not None:
                with self._lock:
                    self._loose.append(final)

    def _remaining_deadline(self, pl: _Placement,
                            now: float) -> Optional[float]:
        if pl.req.deadline_s is None:
            return None
        return pl.req.deadline_s - (now - pl.submitted_at)

    def _effective_req(self, pl: _Placement, now: float) -> Request:
        """The request with its deadline decremented by the budget already
        spent at this router (park→place→queue→…): what a downstream stage
        may still burn. ``_finalize`` restores the original deadline on the
        way out, so records always carry the caller's contract."""
        remaining = self._remaining_deadline(pl, now)
        if remaining is None:
            return pl.req
        return dataclasses.replace(pl.req, deadline_s=remaining)

    def _expire_placement(self, crid: int, now: float) -> None:
        """Finish an accepted-but-expired request as ``timed_out`` with the
        typed ``deadline_expired`` reason (:class:`DeadlineExpired`)."""
        pl = self._placements.pop(crid)
        self.totals["deadline_expired"] += 1
        rec = dataclasses.replace(
            self._refusal_record(crid, pl.req, now),
            outcome=TIMED_OUT, reason=DeadlineExpired.reason,
            submitted_at=pl.submitted_at,
            queue_wait_s=now - pl.submitted_at, deadline_met=False,
            recovery=({"readmissions": pl.resubmits,
                       "recompute_tokens": pl.recompute_tokens}
                      if pl.resubmits else None))
        reg = get_registry()
        if reg.enabled:
            reg.counter("edgellm_gray_deadline_expired_total",
                        "requests refused after their deadline budget "
                        "expired pre-dispatch").inc()
        with self._lock:
            self._loose.append(rec)

    # -- drain / absorption -------------------------------------------------

    def drain(self, max_requests: Optional[int] = None) -> list:
        """Round-robin the live fleet until ``max_requests`` cluster-level
        terminal records are collected or nothing makes progress. Returns
        the records (request ids are CLUSTER ids; ``plan["replica"]`` names
        the serving replica)."""
        self._tick()
        out: list = []

        def flush_loose() -> None:
            with self._lock:
                while self._loose and (max_requests is None
                                       or len(out) < max_requests):
                    out.append(self._loose.pop(0))

        flush_loose()
        while max_requests is None or len(out) < max_requests:
            progress = False
            for rid in list(sorted(self.replicas)):
                r = self.replicas.get(rid)
                if r is None or r.front is None or r.state == REPLICA_DEAD:
                    continue
                if getattr(r.front, "batcher", None) is not None:
                    # a continuous-batching replica serves its whole queue
                    # through ONE ragged-step event loop — fairness is the
                    # round-robin over replicas, not over requests; overflow
                    # past the caller's cap parks in the loose buffer
                    recs = r.front.drain_batched()
                else:
                    recs = r.front.drain(max_requests=1)
                if recs:
                    progress = True
                    for rec in recs:
                        final = self._absorb(r, rec)
                        if final is not None:
                            out.append(final)
            self._tick()
            flush_loose()
            if not progress:
                break
        if max_requests is not None and len(out) > max_requests:
            # a batched replica drain can overshoot the cap in one pass
            with self._lock:
                self._loose[:0] = out[max_requests:]
            out = out[:max_requests]
        return out

    def _absorb(self, r: Replica, rec: RequestRecord
                ) -> Optional[RequestRecord]:
        """Fold one replica-local record into router state. Returns the
        finalized cluster-level record, or None when the record was
        absorbed (a replica-fatal failure whose request re-admitted)."""
        key = (r.id, r.generation, rec.request_id)
        crid = self._local_index.pop(key, None)
        if crid is None:
            if key in self._hedge_discard:
                # the losing leg of a settled hedge finished late on a
                # front without cancel support: exactly-once accounting
                # swallows its record here, never surfacing a duplicate
                self._hedge_discard.discard(key)
                self.totals["hedge_discarded"] += 1
                return None
            # not ours (e.g. a stream the replica served before adoption) —
            # surface verbatim rather than silently dropping
            return rec
        pl = self._placements[crid]
        hedged = pl.hedge_replica_id is not None
        from_hedge_leg = (hedged and r.id == pl.hedge_replica_id
                          and rec.request_id == pl.hedge_local_rid)
        r.budget.charge(rec.retries_charged)
        if rec.outcome in (COMPLETED, FAILED_OVER):
            r.breaker.record_success()
            r.completed += 1
            self._probe_result(r, ok=True)
            self._observe_latency(r, rec)
            if hedged:
                # first finisher wins: cancel/discard the other leg
                self._settle_hedge(pl, winner_hedge=from_hedge_leg)
            return self._finalize(r, rec, pl)
        if rec.outcome == FAILED:
            replica_fatal = (rec.reason.startswith(_REPLICA_FATAL_PREFIXES)
                             or rec.reason in _REPLICA_FATAL_REASONS)
            r.breaker.record_failure()
            r.failures += 1
            self._probe_result(r, ok=False)
            if replica_fatal:
                if r.state != REPLICA_DEAD:
                    self._kill(r, rec.reason)
                # _kill's drain may already have detached/promoted legs of
                # this placement; only readmit when no leg still covers it
                if hedged and self._detach_leg(crid, r.id):
                    return None
                self._readmit(crid, resume=None)
                return None
            if hedged:
                # one leg failed non-fatally; the other may still finish
                # clean — drop this leg only (the breaker already saw it)
                self._detach_leg(crid, r.id)
                return None
            return self._finalize(r, rec, pl)
        if rec.outcome == TIMED_OUT:
            # legs carry decremented deadlines, so one leg expiring means
            # the request's global budget is gone — settle the other leg
            # and finish timed_out
            if hedged:
                self._settle_hedge(pl, winner_hedge=from_hedge_leg)
            return self._finalize(r, rec, pl)
        # REJECTED / SHED
        if hedged:
            # an admission refusal on one leg of a still-covered request:
            # detach the refused leg, let the other run
            self._detach_leg(crid, r.id)
            return None
        if rec.outcome in (REJECTED, SHED) and pl.resubmits > 0:
            # a survivor's admission control refused re-admitted work: park
            # and retry later — accepted work is never lost to a refusal
            self.totals["parked_total"] += 1
            self._parked.append((crid, None))
            return None
        return self._finalize(r, rec, pl)

    # -- the gray-failure plane ---------------------------------------------

    def _observe_latency(self, r: Replica, rec: RequestRecord) -> None:
        """Feed one completed leg's end-to-end latency into the straggler
        detector (keyed by replica id)."""
        if self._straggler is None:
            return
        sample = rec.latency_s if rec.latency_s is not None else rec.service_s
        if sample is not None:
            self._straggler.observe(r.id, float(sample))

    def _gray_tick(self, now: float) -> None:
        """Refresh the straggler verdict set (spanned on every flip) and run
        one hedge pass over still-running placements."""
        flagged = set(self._straggler.stragglers())
        reg = get_registry()
        for rid in sorted(flagged - self._gray_flagged):
            with obs_span("gray.demote", replica=rid, direction="demote"):
                if reg.enabled:
                    reg.counter("edgellm_gray_demotions_total",
                                "straggler demotions (replica flagged "
                                "slow)").inc()
        for rid in sorted(self._gray_flagged - flagged):
            with obs_span("gray.demote", replica=rid, direction="promote"):
                pass
        self._gray_flagged = flagged
        self._hedge_tick(now)

    def _hedge_tick(self, now: float) -> None:
        """Hedge requests that have been running longer than the fleet's
        ``hedge_delay_quantile`` latency: re-place a second copy on another
        replica, first finisher wins. Bounded by ``max_hedge_fraction`` of
        primary placements; silent until the detector has samples."""
        gray = self.cfg.gray
        delay = self._straggler.fleet_quantile(gray.hedge_delay_quantile,
                                               exclude=self._gray_flagged)
        if delay is None:
            return
        parked = {crid for crid, _ in self._parked}
        for crid in sorted(self._placements):
            pl = self._placements.get(crid)
            if pl is None or pl.hedge_replica_id is not None:
                continue
            if crid in parked:
                continue   # not running anywhere: a park, not a straggle
            if now - pl.submitted_at <= delay:
                continue
            if (self.totals["hedges"] + 1
                    > gray.max_hedge_fraction
                    * max(self.totals["placed"], 1)):
                return     # hedge budget spent for now
            self._hedge(pl, now)

    def _hedge(self, pl: _Placement, now: float) -> None:
        remaining = self._remaining_deadline(pl, now)
        if remaining is not None and remaining <= 0.0:
            return   # budget already gone: the running leg times out alone
        cands = [c for c in self._candidates()
                 if c.state == REPLICA_LIVE and c.id != pl.replica_id
                 and c.id not in self._gray_flagged]
        ready = []
        for c in cands:
            lf = getattr(c.front, "load_fraction", None)
            if lf is None or lf() < 1.0:
                ready.append(c)
        if not ready:
            return
        target = min(ready, key=lambda c: (c._disagg_penalty(),
                                           c.front.queue_depth, c.id))
        with obs_span("cluster.hedge", crid=pl.crid,
                      primary=pl.replica_id, target=target.id):
            local_rid, refusal = self._submit_to(
                target, self._effective_req(pl, now))
            if refusal is not None:
                self.totals["hedge_refused"] += 1
                return
            target.placed += 1
            pl.hedge_replica_id = target.id
            pl.hedge_local_rid = local_rid
            pl.hedge_generation = target.generation
            pl.hedged_at = now
            self._local_index[(target.id, target.generation,
                               local_rid)] = pl.crid
            self.totals["hedges"] += 1
            reg = get_registry()
            if reg.enabled:
                reg.counter("edgellm_gray_hedges_total",
                            "hedge legs dispatched").inc()

    def _settle_hedge(self, pl: _Placement, winner_hedge: bool) -> None:
        """One leg of a hedged placement went terminal: cancel the loser
        where the front supports it, otherwise mark its key for discard so
        its late record is swallowed (exactly-once)."""
        if winner_hedge:
            loser_key = (pl.replica_id, pl.generation, pl.local_rid)
            self.totals["hedge_wins_hedge"] += 1
            win_leg = "hedge"
        else:
            loser_key = (pl.hedge_replica_id, pl.hedge_generation,
                         pl.hedge_local_rid)
            self.totals["hedge_wins_primary"] += 1
            win_leg = "primary"
        if self._local_index.pop(loser_key, None) is not None:
            loser = self.replicas.get(loser_key[0])
            cancel = (getattr(loser.front, "cancel", None)
                      if loser is not None and loser.front is not None
                      else None)
            if cancel is not None and cancel(loser_key[2]):
                self.totals["hedge_cancelled"] += 1
            else:
                self._hedge_discard.add(loser_key)
        if winner_hedge:
            # promote the winning hedge leg so _finalize and any later
            # bookkeeping see a coherent single-leg placement
            pl.replica_id = pl.hedge_replica_id
            pl.local_rid = pl.hedge_local_rid
            pl.generation = pl.hedge_generation
        pl.hedge_replica_id = None
        pl.hedge_local_rid = None
        pl.hedge_generation = None
        pl.hedged_at = None
        reg = get_registry()
        if reg.enabled:
            reg.counter("edgellm_gray_hedge_wins_total",
                        "settled hedges by winning leg").inc(leg=win_leg)

    def _detach_leg(self, crid: int, replica_id: int) -> bool:
        """Drop one leg of a hedged placement (its replica died, scaled
        away, or refused the work). Returns True when the other leg still
        covers the request — the caller must NOT readmit. False when the
        placement was not hedged (single-leg: normal recovery applies)."""
        pl = self._placements.get(crid)
        if pl is None or pl.hedge_replica_id is None:
            return False
        if replica_id == pl.hedge_replica_id:
            pass                       # hedge leg lost: primary covers
        elif replica_id == pl.replica_id:
            # primary lost: the hedge leg is the request now
            pl.replica_id = pl.hedge_replica_id
            pl.local_rid = pl.hedge_local_rid
            pl.generation = pl.hedge_generation
        else:
            return False
        pl.hedge_replica_id = None
        pl.hedge_local_rid = None
        pl.hedge_generation = None
        pl.hedged_at = None
        return True

    def _probe_result(self, r: Replica, ok: bool) -> None:
        if r.state != REPLICA_PROBING:
            return
        if not ok:
            # a failed probe re-opens: another backoff round (longer — the
            # attempt counter is still climbing)
            if r.state != REPLICA_DEAD:
                self._kill(r, "probe_failed")
            return
        r.probes_ok += 1
        if r.probes_ok >= self.cfg.respawn.half_open_probes:
            r.state = REPLICA_LIVE
            r.backoff_attempt = 0

    def _finalize(self, r: Replica, rec: RequestRecord,
                  pl: _Placement) -> RequestRecord:
        del self._placements[pl.crid]
        plan = dict(rec.plan) if rec.plan else {}
        plan["replica"] = r.id
        recovery = rec.recovery
        if pl.resubmits:
            recovery = dict(recovery or {})
            recovery["readmissions"] = pl.resubmits
            recovery["recompute_tokens"] = pl.recompute_tokens
        return dataclasses.replace(
            rec, request_id=pl.crid, plan=plan, recovery=recovery,
            submitted_at=pl.submitted_at,
            # a readmitted/hedged leg ran under a decremented deadline;
            # the cluster record restores the caller's original contract
            deadline_s=pl.req.deadline_s)

    # -- autoscaler ---------------------------------------------------------

    def _fleet_pressure(self) -> float:
        loads = []
        for r in self.replicas.values():
            if r.state != REPLICA_LIVE or r.front is None:
                continue
            lf = getattr(r.front, "load_fraction", None)
            # host-side router bookkeeping: load_fraction is a plain
            # python float, not a device value
            loads.append(float(lf()) if lf is not None else 0.0)
        if not loads:
            return 1.0   # a fleet with zero live replicas is saturated
        return float(sum(loads) / len(loads))

    def _publish(self) -> None:
        reg = get_registry()
        if not reg.enabled:
            return
        live = sum(1 for r in self.replicas.values()
                   if r.state == REPLICA_LIVE)
        reg.gauge("edgellm_cluster_replicas",
                  "replicas in the fleet (any state)").set(
            len(self.replicas))
        reg.gauge("edgellm_cluster_live_replicas",
                  "replicas currently serving").set(live)
        reg.gauge("edgellm_cluster_parked",
                  "accepted requests waiting for a routable replica").set(
            len(self._parked))
        reg.gauge("edgellm_cluster_pressure",
                  "mean live-replica load fraction").set(
            self._fleet_pressure())
        if self._straggler is not None:
            reg.gauge("edgellm_gray_stragglers",
                      "replicas currently flagged slow").set(
                len(self._gray_flagged))
            delay = self._straggler.fleet_quantile(
                self.cfg.gray.hedge_delay_quantile,
                exclude=self._gray_flagged)
            if delay is not None:
                reg.gauge("edgellm_gray_hedge_delay_s",
                          "current hedge trigger delay (fleet latency "
                          "quantile)").set(delay)

    def _autoscale(self, now: float) -> None:
        """Simulated autoscaler, driven by the published
        ``edgellm_cluster_pressure`` gauge when observability is armed (the
        locally computed value otherwise — same number, no scrape loop)."""
        reg = get_registry()
        if reg.enabled:
            pressure = reg.gauge("edgellm_cluster_pressure",
                                 "mean live-replica load fraction").value()
        else:
            pressure = self._fleet_pressure()
        if now - self._last_scale_at < self.cfg.autoscaler.min_dwell_s:
            return
        live = [r for r in self.replicas.values()
                if r.state == REPLICA_LIVE and r.front is not None]
        asc = self.cfg.autoscaler
        if pressure >= asc.scale_up_pressure and len(live) < asc.max_replicas:
            with obs_span("cluster.autoscale", direction="up"):
                rid = self._next_replica_id
                self._next_replica_id += 1
                self.replicas[rid] = self._new_replica(rid)
                self._last_scale_at = now
                self.autoscale_events.append(
                    {"at_s": now, "direction": "up", "replica": rid,
                     "pressure": pressure})
        elif (pressure <= asc.scale_down_pressure
              and len(live) > asc.min_replicas):
            with obs_span("cluster.autoscale", direction="down"):
                victim = min(live, key=lambda r: (r.front.queue_depth, -r.id))
                front = victim.front
                victim.state = REPLICA_DEAD
                victim.front = None
                victim.respawn_at = None   # scaled away, not respawning
                for local_rid, req in front.drain_pending():
                    crid = self._local_index.pop(
                        (victim.id, victim.generation, local_rid), None)
                    if crid is not None and not self._detach_leg(
                            crid, victim.id):
                        self._readmit(crid, resume=None)
                ckpt = getattr(front, "checkpoint_inflight", None)
                if ckpt is not None:
                    for item in ckpt(self.cfg.checkpoint_dir):
                        crid = self._local_index.pop(
                            (victim.id, victim.generation,
                             item["local_rid"]), None)
                        if crid is not None and not self._detach_leg(
                                crid, victim.id):
                            self._readmit(crid, resume=item)
                del self.replicas[victim.id]
                self._last_scale_at = now
                self.autoscale_events.append(
                    {"at_s": now, "direction": "down", "replica": victim.id,
                     "pressure": pressure})

    # -- introspection ------------------------------------------------------

    @property
    def pending(self) -> int:
        """Accepted requests not yet terminal (in a queue, mid-flight, or
        parked)."""
        return len(self._placements)

    @property
    def busy(self) -> bool:
        return any(getattr(r.front, "busy", False)
                   for r in self.replicas.values() if r.front is not None)

    def next_event_s(self) -> Optional[float]:
        """The next scheduled instant anywhere in the fleet — the earliest
        pending respawn or simulated-replica phase completion. The soak
        loop advances the virtual clock here when a drain pass returns
        nothing (real replica fronts expose no ``next_event_s`` and do
        their work on the spot instead)."""
        times = [r.respawn_at for r in self.replicas.values()
                 if r.state == REPLICA_DEAD and r.respawn_at is not None]
        for r in self.replicas.values():
            if r.state == REPLICA_DEAD or r.front is None:
                continue
            nxt = getattr(r.front, "next_event_s", None)
            if nxt is not None:
                t = nxt()
                if t is not None:
                    times.append(t)
        return min(times) if times else None

    def flight_dumps(self) -> list:
        """Every per-replica post-mortem artifact path, in replica order."""
        out = []
        for rid in sorted(self.replicas):
            fl = self.replicas[rid].flight
            if fl is not None:
                out.extend(fl.dumps())
        return out

    def report(self) -> dict:
        rep = {
            "replicas": {rid: self.replicas[rid].summary()
                         for rid in sorted(self.replicas)},
            "totals": dict(self.totals),
            "pending": self.pending,
            "parked": len(self._parked),
            "kills": list(self.kills),
            "autoscale_events": list(self.autoscale_events),
            "pressure": self._fleet_pressure(),
            "gray": (None if self._straggler is None else {
                "flagged": sorted(self._gray_flagged),
                "hedge_delay_s": self._straggler.fleet_quantile(
                    self.cfg.gray.hedge_delay_quantile,
                    exclude=self._gray_flagged),
                "detector": self._straggler.summary(),
            }),
        }
        # counters in record_cluster_stats carry running totals: the
        # end-of-run consumer absorbs the final report exactly once
        return rep

    def health_summary(self) -> dict:
        states = {rid: self.replicas[rid].state
                  for rid in sorted(self.replicas)}
        live = sum(1 for s in states.values() if s == REPLICA_LIVE)
        return {
            "status": ("ok" if live == len(states) and states
                       else "degraded" if live else "down"),
            "replicas": states,
            "live": live,
            "pending": self.pending,
            "parked": len(self._parked),
        }


# ---------------------------------------------------------------------------
# the simulated replica: the 10⁶-request scale vehicle
# ---------------------------------------------------------------------------


def _crc(data: bytes, start: int = 0) -> int:
    return zlib.crc32(data, start) & 0xFFFFFFFF


def sim_reference_tokens(prompt: np.ndarray, n: int, *,
                         temperature: float = 0.0, rng_seed: int = 0,
                         vocab_size: int = 50_000,
                         start: int = 0, chain: Optional[int] = None
                         ) -> tuple:
    """The sim engine's pure decode function: a crc32 chain over (prompt,
    temperature bucket, seed, step). Deterministic and fault-free by
    construction — the identity replay recomputes it per completed request.
    Greedy (``temperature == 0``) depends only on the prompt; a sampled
    request folds in its recorded seed, mirroring the real stack's
    seed-pinned sampling streams. Returns ``(tokens[start:n], chain)`` so a
    checkpointed stream resumes the chain mid-sequence bit-identically."""
    if chain is None:
        h = _crc(np.ascontiguousarray(prompt, dtype=np.int64).tobytes())
        if temperature > 0.0:
            h = _crc(struct.pack("<dq", float(temperature), int(rng_seed)), h)
        for t in range(start):
            h = _crc(struct.pack("<q", t), h)
    else:
        h = int(chain)
    out = np.empty(max(n - start, 0), np.int32)
    for i, t in enumerate(range(start, n)):
        h = _crc(struct.pack("<q", t), h)
        out[i] = h % vocab_size
    return out, h


@dataclasses.dataclass(frozen=True)
class SimReplicaConfig:
    """One simulated replica's capacity model. ``chunk_tokens`` is the
    scheduler quantum — each ``drain`` call advances the running stream by
    at most this many tokens, so chaos lands mid-request and the
    DecodeCheckpoint drain path is real, not theoretical."""

    vocab_size: int = 50_000
    prefill_s_per_token: float = 1e-4
    decode_s_per_token: float = 2e-3
    chunk_tokens: int = 4
    max_queue_depth: int = 64
    prefix_block: int = 4
    index_capacity: int = 50_000
    # gray plane: refuse work whose (decremented) deadline has already
    # passed at prefill/decode chunk boundaries instead of burning tokens.
    # Off by default so a gray-disabled fleet behaves bit-identically.
    deadline_propagation: bool = False

    def __post_init__(self):
        if not isinstance(self.deadline_propagation, bool):
            raise ClusterConfigError(
                f"deadline_propagation must be a bool, got "
                f"{self.deadline_propagation!r}")
        if self.chunk_tokens < 1:
            raise ClusterConfigError(
                f"chunk_tokens must be >= 1, got {self.chunk_tokens!r}")
        if self.max_queue_depth < 1:
            raise ClusterConfigError(
                f"max_queue_depth must be >= 1, got "
                f"{self.max_queue_depth!r}")
        if self.prefix_block < 1:
            raise ClusterConfigError(
                f"prefix_block must be >= 1, got {self.prefix_block!r}")


@dataclasses.dataclass
class _SimStream:
    rid: int
    req: Request
    prompt: np.ndarray
    submitted_at: float
    started_at: Optional[float]     # None while prefill is in flight
    tokens: list
    chain: Optional[int]


class SimReplicaFront:
    """A deterministic stand-in replica: the ``ServeFront`` surface the
    router touches (submit_ex / drain / drain_pending / probe_prefix /
    queue_depth / busy / load_fraction / checkpoint_inflight /
    restore_inflight) over a discrete-event decode that produces
    :func:`sim_reference_tokens`.

    The front never advances the clock: each phase (prefill, then one
    decode chunk at a time) is *scheduled* to complete at ``_busy_until``
    on the shared virtual timeline, and ``drain`` applies whatever is due
    at the current instant. The caller advances the clock to
    :meth:`next_event_s` — so N replicas genuinely serve in parallel
    (fleet capacity scales with N), which is the property the equal-
    capacity goodput gate measures. Memory is O(queue depth), never
    O(requests served)."""

    def __init__(self, cfg: Optional[SimReplicaConfig] = None, *,
                 clock: Any, replica_id: int = 0):
        self.cfg = cfg if cfg is not None else SimReplicaConfig()
        self.clock = clock
        self.replica_id = replica_id
        self._seq = 0
        self._queue: collections.deque = collections.deque()
        self._restored: collections.deque = collections.deque()
        self._current: Optional[_SimStream] = None
        self._busy_until: Optional[float] = None
        self._fault_reason: Optional[str] = None
        self._corrupt_rate = 0.0
        self._service_mult = 1.0
        self._prefix_index: dict = {}   # crc(prefix block chain) -> True
        self.served = 0

    # -- the ServeFront surface the router uses -----------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue) + len(self._restored)

    @property
    def busy(self) -> bool:
        return (self._current is not None or bool(self._queue)
                or bool(self._restored))

    def load_fraction(self) -> float:
        return min(1.0, self.queue_depth / self.cfg.max_queue_depth)

    def submit(self, req: Request) -> int:
        rid, _ = self.submit_ex(req)
        return rid

    def submit_ex(self, req: Request) -> tuple:
        self._seq += 1
        rid = self._seq
        if len(self._queue) >= self.cfg.max_queue_depth:
            return rid, self._record(rid, req, REJECTED, "queue_full",
                                     self.clock(), None, None)
        self._queue.append((rid, req, self.clock()))
        return rid, None

    def drain_pending(self) -> list:
        out = [(rid, req) for rid, req, _ in self._queue]
        out.extend((st.rid, st.req) for st in self._restored)
        self._queue.clear()
        self._restored.clear()
        return out

    def next_event_s(self) -> Optional[float]:
        """When the scheduled phase completes — the instant the caller
        should advance the virtual clock to. None when idle."""
        return self._busy_until if self._current is not None else None

    def probe_prefix(self, prompt_ids) -> int:
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        block = self.cfg.prefix_block
        matched = 0
        h = 0
        for k in range(block, len(prompt) + 1, block):
            h = _crc(prompt[k - block:k].tobytes(), h)
            if h not in self._prefix_index:
                break
            matched = k
        return matched

    def _index_prefix(self, prompt: np.ndarray) -> None:
        if len(self._prefix_index) >= self.cfg.index_capacity:
            self._prefix_index.clear()   # bounded: reset beats unbounded
        block = self.cfg.prefix_block
        h = 0
        for k in range(block, len(prompt) + 1, block):
            h = _crc(prompt[k - block:k].astype(np.int64).tobytes(), h)
            self._prefix_index[h] = True

    # -- chaos knobs --------------------------------------------------------

    def inject_fault(self, reason: str = "stage_lost:0") -> None:
        """Arm a replica-fatal failure: the next drain chunk fails its
        stream with this reason (the router's kill path takes over)."""
        self._fault_reason = reason

    def set_corrupt_rate(self, rate: float) -> None:
        """Link-corruption burst: completing requests fail terminally with
        ``substituted_payload`` at this seeded per-request rate."""
        self._corrupt_rate = float(rate)

    def set_service_multiplier(self, mult: float) -> None:
        """Gray-failure slowdown: stretch every subsequently *scheduled*
        prefill/decode phase by this factor. The replica stays alive and
        passes every health check — it is merely slow, which is the point."""
        if mult <= 0:
            raise ValueError(f"service multiplier must be > 0, got {mult!r}")
        self._service_mult = float(mult)

    # -- hedge support ------------------------------------------------------

    def cancel(self, rid: int) -> bool:
        """Abandon one queued or mid-flight stream (the losing leg of a
        settled hedge). True when found and dropped; False when the stream
        already went terminal (the router discards its record instead)."""
        for i, (qrid, _req, _at) in enumerate(self._queue):
            if qrid == rid:
                del self._queue[i]
                return True
        for i, st in enumerate(self._restored):
            if st.rid == rid:
                del self._restored[i]
                return True
        if self._current is not None and self._current.rid == rid:
            self._current = None
            self._busy_until = None
            return True
        return False

    # -- virtual-time decode ------------------------------------------------

    def _chunk_of(self, st: _SimStream) -> int:
        return min(self.cfg.chunk_tokens,
                   st.req.max_new_tokens - len(st.tokens))

    def _expired_record(self, st: _SimStream,
                        now: float) -> Optional[RequestRecord]:
        """With deadline propagation armed: refuse to schedule the next
        phase of a stream whose (decremented) deadline has already passed —
        a ``timed_out``/``deadline_expired`` terminal instead of tokens
        nobody can use."""
        if (not self.cfg.deadline_propagation
                or st.req.deadline_s is None
                or now - st.submitted_at < st.req.deadline_s):
            return None
        self._current = None
        self._busy_until = None
        return self._record(st.rid, st.req, TIMED_OUT,
                            DeadlineExpired.reason, st.submitted_at,
                            st.started_at, None, tokens_done=len(st.tokens))

    def drain(self, max_requests: Optional[int] = None) -> list:
        """Apply whatever is due at the current virtual instant: start a
        stream when idle, complete the scheduled prefill/decode chunk when
        its time has passed. At most one terminal record per call; []
        means blocked on virtual time (:meth:`next_event_s` says until
        when) or empty. Chunked on purpose — a kill between chunk
        boundaries lands mid-request."""
        del max_requests  # at most one record per call regardless
        while True:
            if self._current is None:
                self._busy_until = None
                nxt = self._pop_admissible()
                if nxt is None:
                    return []
                if isinstance(nxt, RequestRecord):
                    return [nxt]   # expired in queue
                self._current = nxt
                continue           # phase scheduled; due-check next pass
            st = self._current
            if self._fault_reason is not None:
                reason = self._fault_reason
                self._fault_reason = None
                self._current = None
                self._busy_until = None
                return [self._record(st.rid, st.req, FAILED, reason,
                                     st.submitted_at, st.started_at, None,
                                     tokens_done=len(st.tokens))]
            if self.clock() < self._busy_until - 1e-12:
                return []          # scheduled phase not due yet
            due_at = self._busy_until
            if st.started_at is None:
                # prefill completed: index the prompt, schedule first chunk
                st.started_at = due_at
                self._index_prefix(st.prompt)
                expired = self._expired_record(st, due_at)
                if expired is not None:
                    return [expired]
                self._busy_until = (due_at + self.cfg.decode_s_per_token
                                    * self._chunk_of(st)
                                    * self._service_mult)
                continue
            # decode chunk completed: append exactly the scheduled tokens
            k = self._chunk_of(st)
            toks, st.chain = sim_reference_tokens(
                st.prompt, len(st.tokens) + k,
                temperature=st.req.temperature, rng_seed=st.req.rng_seed,
                vocab_size=self.cfg.vocab_size, start=len(st.tokens),
                chain=st.chain)
            st.tokens.extend(int(t) for t in toks)
            if len(st.tokens) < st.req.max_new_tokens:
                expired = self._expired_record(st, due_at)
                if expired is not None:
                    return [expired]
                self._busy_until = (due_at + self.cfg.decode_s_per_token
                                    * self._chunk_of(st)
                                    * self._service_mult)
                continue
            self._current = None
            self._busy_until = None
            self.served += 1
            # seeded per-request corruption draw: deterministic chaos
            u = (_crc(struct.pack("<Q", st.chain)) + 0.5) / 2.0 ** 32
            if self._corrupt_rate > 0.0 and u < self._corrupt_rate:
                return [self._record(st.rid, st.req, FAILED,
                                     "substituted_payload", st.submitted_at,
                                     st.started_at, None,
                                     tokens_done=len(st.tokens))]
            return [self._record(st.rid, st.req, COMPLETED, "",
                                 st.submitted_at, st.started_at,
                                 np.asarray(st.tokens, np.int32))]

    def _pop_admissible(self):
        """Next stream to run: restored streams first (they were already
        admitted once, and resume decoding directly), then the FIFO queue
        with deadline expiry. Schedules the stream's next phase on the
        virtual timeline."""
        if self._restored:
            st = self._restored.popleft()
            self._busy_until = (self.clock() + self.cfg.decode_s_per_token
                                * self._chunk_of(st)
                                * self._service_mult)
            return st
        while self._queue:
            rid, req, sub_at = self._queue.popleft()
            wait = self.clock() - sub_at
            if req.deadline_s is not None and wait >= req.deadline_s:
                return self._record(rid, req, TIMED_OUT, "expired_in_queue",
                                    sub_at, None, None)
            prompt = np.asarray(req.prompt_ids, np.int32).reshape(-1)
            self._busy_until = (self.clock()
                                + self.cfg.prefill_s_per_token * prompt.size
                                * self._service_mult)
            return _SimStream(rid=rid, req=req, prompt=prompt,
                              submitted_at=sub_at, started_at=None,
                              tokens=[], chain=None)
        return None

    # -- checkpoint / restore (the replica-drain hatch) ---------------------

    def checkpoint_inflight(self, ckpt_dir: Optional[str] = None) -> list:
        """DecodeCheckpoint the mid-flight stream out of this front (the
        real CRC-framed container — spooled to ``ckpt_dir`` when given, held
        in memory otherwise). Clears the stream; the router re-admits it."""
        if self._current is None:
            return []
        st = self._current
        self._current = None
        ck = DecodeCheckpoint(
            arrays={"prompt_ids": st.prompt,
                    "tokens": np.asarray(st.tokens, np.int32)},
            meta={"kind": "sim_stream", "rid": int(st.rid),
                  "chain": int(st.chain) if st.chain is not None else None,
                  "temperature": float(st.req.temperature),
                  "rng_seed": int(st.req.rng_seed),
                  "max_new_tokens": int(st.req.max_new_tokens),
                  "submitted_at": float(st.submitted_at),
                  "replica": int(self.replica_id)})
        item = {"local_rid": st.rid, "req": st.req,
                "tokens_done": len(st.tokens)}
        if ckpt_dir is not None:
            os.makedirs(ckpt_dir, exist_ok=True)
            path = os.path.join(
                ckpt_dir, f"replica{self.replica_id}-r{st.rid}.ckpt")
            ck.save(path)
            item["path"] = path
        else:
            item["ckpt"] = ck
        return [item]

    def restore_inflight(self, item: dict) -> int:
        """Resume a checkpointed stream: the crc chain continues exactly
        where the dead replica stopped — token-identical, zero recompute."""
        ck = (DecodeCheckpoint.load(item["path"]) if "path" in item
              else item["ckpt"])
        if ck.meta.get("kind") != "sim_stream":
            raise ValueError(
                f"not a sim stream checkpoint: {ck.meta.get('kind')!r}")
        self._seq += 1
        rid = self._seq
        req = item["req"]
        st = _SimStream(
            rid=rid, req=req,
            prompt=np.asarray(ck.arrays["prompt_ids"], np.int32),
            submitted_at=float(ck.meta["submitted_at"]),
            started_at=self.clock(),
            tokens=[int(t) for t in ck.arrays["tokens"]],
            chain=(int(ck.meta["chain"])
                   if ck.meta["chain"] is not None else None))
        self._restored.append(st)
        return rid

    # -- records ------------------------------------------------------------

    def _record(self, rid: int, req: Request, outcome: str, reason: str,
                submitted_at: float, started_at: Optional[float],
                tokens: Optional[np.ndarray],
                tokens_done: int = 0) -> RequestRecord:
        now = self.clock()
        wait = (started_at - submitted_at if started_at is not None
                else now - submitted_at)
        service = now - started_at if started_at is not None else None
        latency = now - submitted_at if tokens is not None else None
        deadline_met = None
        if req.deadline_s is not None and latency is not None:
            deadline_met = latency <= req.deadline_s
        prompt_tokens = int(np.asarray(req.prompt_ids).size)
        return RequestRecord(
            request_id=rid, outcome=outcome, reason=reason, backend="sim",
            priority=req.priority, submitted_at=submitted_at,
            started_at=started_at,
            finished_at=now if tokens is not None else None,
            queue_wait_s=wait, ttft_s=(wait if tokens is not None else None),
            service_s=service, latency_s=latency, deadline_s=req.deadline_s,
            deadline_met=deadline_met, prompt_tokens=prompt_tokens,
            requested_tokens=req.max_new_tokens,
            granted_tokens=(req.max_new_tokens if tokens is not None
                            else None),
            capacity=None, batch=1,
            plan={"mode": "sim", "replica_gen": self.replica_id},
            brownout_level=0, retries_charged=0, jit_misses=0,
            tokens=(tokens[None, :] if tokens is not None else None),
            recovery=({"tokens_done": tokens_done} if tokens_done else None))

    def report(self) -> dict:
        return {"served": self.served, "queue_depth": self.queue_depth,
                "index_entries": len(self._prefix_index)}


def drive_cluster(cluster: ClusterFront, clock: Any, *,
                  max_records: Optional[int] = None) -> list:
    """Drain a simulated fleet to idle: alternate ``cluster.drain`` with
    advancing the virtual clock to :meth:`ClusterFront.next_event_s`
    (ClusterFront itself never moves the clock). Returns the terminal
    records collected. Stops when the fleet is idle with nothing scheduled
    — parked work with no pending respawn is left parked (the caller reads
    ``cluster.report()`` for it)."""
    out: list = []
    stalls = 0
    while max_records is None or len(out) < max_records:
        recs = cluster.drain(
            max_requests=(None if max_records is None
                          else max_records - len(out)))
        out.extend(recs)
        if recs:
            stalls = 0
            continue
        ev = cluster.next_event_s()
        if ev is None or not (cluster.pending or cluster.busy):
            break
        if ev > clock():
            clock.set_time(ev)
            stalls = 0
        else:
            stalls += 1      # an event that is due but yields nothing twice
            if stalls > 2:   # over means a wedged fleet — stop, don't spin
                break
    return out
