"""Overload protection for the serving front: admission, budgets, breakers,
brownout. PyTorch-package counterpart of ``edgellm_tpu/serve/overload.py``
(pure host Python, as there).

The host-side control plane :class:`~.frontend.ServeFront` composes, each
controller driven by the shared :class:`~..utils.clock.Clock` protocol so
tests run them on a :class:`~..utils.clock.FakeClock`:

- :class:`AdmissionController`: a bounded queue plus a deadline-feasibility
  check priced by an EWMA latency model (seconds per prompt token, seconds
  per generated token), refusing at submit with typed errors;
- :class:`RetryBudget`: a leaky bucket over observed ladder retries;
- :class:`CircuitBreaker`: closed -> open -> half-open, per guarded resource;
- :class:`BrownoutController`: staged quality degradation under queue
  pressure with dwell hysteresis in both directions;
- :class:`StragglerDetector`: the gray-failure eye, windowed per-key
  latency samples judged against the pooled fleet median, with min-sample
  and min-dwell hysteresis; re-promotion needs fresh measurements.

Every controller owns a ``threading.Lock`` (``@guarded_by``): the front
reads them from a scrape thread while the decode thread mutates them.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Optional

from ..utils.clock import MONOTONIC, Clock
from ..utils.concurrency import guarded_by

__all__ = [
    "COMPLETED", "REJECTED", "SHED", "TIMED_OUT", "FAILED_OVER", "FAILED",
    "QUEUED", "OUTCOMES",
    "AdmissionError", "QueueFull", "DeadlineInfeasible", "DeadlineExpired",
    "CircuitOpen", "RetryBudgetExhausted", "ServeFrontConfigError",
    "AdmissionConfig", "AdmissionController",
    "RetryBudgetConfig", "RetryBudget",
    "BreakerConfig", "CircuitBreaker",
    "BrownoutConfig", "BrownoutController",
    "StragglerConfig", "StragglerDetector",
]


# ---------------------------------------------------------------------------
# outcome taxonomy (the per-request records the front emits)
# ---------------------------------------------------------------------------

#: the request finished and its tokens are exact (no substitutions, no
#: failovers) — by construction token-identical to the same-seed direct call
COMPLETED = "completed"
#: refused at submit with a typed reason (queue full, infeasible deadline,
#: open circuit, dry retry budget)
REJECTED = "rejected"
#: dropped by policy under overload (brownout priority shed, or a queued
#: request whose deadline became infeasible before it reached the front)
SHED = "shed"
#: the per-request watchdog fired, or the deadline expired in the queue
TIMED_OUT = "timed_out"
#: the request finished, but only by routing around a failure (stage loss
#: re-plan, or a re-run on a fallback path)
FAILED_OVER = "failed_over"
#: the request ran but its output is not trustworthy (the link ladder
#: substituted a payload) or every path was exhausted
FAILED = "failed"
#: non-terminal: admitted, waiting in the queue for ``drain``
QUEUED = "queued"

#: every terminal outcome, in severity order
OUTCOMES = (COMPLETED, FAILED_OVER, SHED, TIMED_OUT, REJECTED, FAILED)


# ---------------------------------------------------------------------------
# typed admission errors (reason strings land in the outcome records)
# ---------------------------------------------------------------------------


class ServeFrontConfigError(ValueError):
    """A serving-front config field is out of range (raised with the field
    named, so ``run.py`` can surface it verbatim)."""


class AdmissionError(RuntimeError):
    """A request was refused before any device work. ``reason`` is the
    machine-readable tag the front stores in the outcome record."""

    reason = "rejected"


class QueueFull(AdmissionError):
    """The bounded submit queue is at capacity."""

    reason = "queue_full"


class DeadlineInfeasible(AdmissionError):
    """The priced service time (plus the current backlog) cannot fit inside
    the request's deadline — finishing late would waste the compute."""

    reason = "deadline_infeasible"


class DeadlineExpired(AdmissionError):
    """The request's remaining deadline budget reached zero while it was
    parked, queued, or mid-flight. Deadline propagation decrements
    ``Request.deadline_s`` through park → place → queue → prefill →
    migration → decode, and every downstream stage refuses expired work
    with this typed reason instead of burning tokens on an answer nobody
    can use (the record finishes ``timed_out``)."""

    reason = "deadline_expired"


class CircuitOpen(AdmissionError):
    """Every route to the model is behind an open circuit breaker."""

    reason = "circuit_open"


class RetryBudgetExhausted(AdmissionError):
    """The process-wide retry budget is dry and the only available path is
    the faulted link that drained it."""

    reason = "retry_budget_exhausted"


# ---------------------------------------------------------------------------
# admission: bounded queue + deadline feasibility from measured latency
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Queue bound and the latency model's priors.

    ``init_prefill_s_per_token`` / ``init_decode_s_per_token`` seed the EWMA
    before the first measurement (deliberately pessimistic defaults: a cold
    model should shed load, not promise deadlines it has never measured);
    ``ewma_alpha`` is the update weight of each new measurement;
    ``safety_factor`` inflates the estimate before comparing against the
    deadline, absorbing jitter the EWMA smooths away."""

    max_queue_depth: int = 64
    init_prefill_s_per_token: float = 2e-3
    init_decode_s_per_token: float = 2e-2
    ewma_alpha: float = 0.3
    safety_factor: float = 1.2

    def __post_init__(self):
        if (isinstance(self.max_queue_depth, bool)
                or not isinstance(self.max_queue_depth, int)
                or self.max_queue_depth < 1):
            raise ValueError(f"max_queue_depth must be an integer >= 1, "
                             f"got {self.max_queue_depth!r}")
        for f, lo in (("init_prefill_s_per_token", 0.0),
                      ("init_decode_s_per_token", 0.0),
                      ("ewma_alpha", 0.0), ("safety_factor", 1.0)):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{f} must be a number, got {v!r}")
            if v <= lo if f != "safety_factor" else v < lo:
                raise ValueError(f"{f} must be > {lo}, got {v!r}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], "
                             f"got {self.ewma_alpha!r}")


@guarded_by("_lock", fields=["_prefill_s_tok", "_decode_s_tok", "admitted",
                             "rejected_queue_full", "rejected_deadline",
                             "measurements"])
class AdmissionController:
    """Prices requests with a measured latency model and refuses infeasible
    or over-capacity work with typed errors.

    The front calls :meth:`admit` at submit time (raises — the front turns
    the typed error into a ``rejected`` record) and :meth:`record` after
    every completed generation so the price tracks the deployed reality
    (codec tier, batch shape, current hardware) instead of a config
    constant."""

    def __init__(self, config: Optional[AdmissionConfig] = None):
        self.cfg = config if config is not None else AdmissionConfig()
        self._lock = threading.Lock()
        self._prefill_s_tok = self.cfg.init_prefill_s_per_token
        self._decode_s_tok = self.cfg.init_decode_s_per_token
        self.admitted = 0
        self.rejected_queue_full = 0
        self.rejected_deadline = 0
        self.measurements = 0

    def _estimate_s_locked(self, prompt_tokens: int, new_tokens: int) -> float:
        return (prompt_tokens * self._prefill_s_tok
                + new_tokens * self._decode_s_tok)

    def estimate_s(self, prompt_tokens: int, new_tokens: int) -> float:
        """Priced service time for one request at the current EWMA rates."""
        with self._lock:
            return self._estimate_s_locked(prompt_tokens, new_tokens)

    def _feasible_locked(self, prompt_tokens: int, new_tokens: int,
                         deadline_s: Optional[float],
                         backlog_s: float) -> bool:
        if deadline_s is None:
            return True
        est = backlog_s + self._estimate_s_locked(prompt_tokens, new_tokens)
        return est * self.cfg.safety_factor <= deadline_s

    def feasible(self, prompt_tokens: int, new_tokens: int,
                 deadline_s: Optional[float],
                 backlog_s: float = 0.0) -> bool:
        """Whether queue backlog + priced service time fits the deadline."""
        with self._lock:
            return self._feasible_locked(prompt_tokens, new_tokens,
                                         deadline_s, backlog_s)

    def admit(self, prompt_tokens: int, new_tokens: int,
              queue_depth: int, deadline_s: Optional[float],
              backlog_s: float = 0.0) -> None:
        """Raise the typed refusal, or count the admission."""
        with self._lock:
            if queue_depth >= self.cfg.max_queue_depth:
                self.rejected_queue_full += 1
                raise QueueFull(
                    f"queue at capacity "
                    f"({queue_depth}/{self.cfg.max_queue_depth})")
            if not self._feasible_locked(prompt_tokens, new_tokens,
                                         deadline_s, backlog_s):
                self.rejected_deadline += 1
                est = backlog_s + self._estimate_s_locked(prompt_tokens,
                                                          new_tokens)
                raise DeadlineInfeasible(
                    f"estimated {est:.3f}s (x{self.cfg.safety_factor:g} "
                    f"safety) cannot fit the {deadline_s:g}s deadline")
            self.admitted += 1

    def record(self, prompt_tokens: int, prefill_s: float,
               decode_steps: int, decode_s: float) -> None:
        """Fold one generation's measured walls into the EWMA price."""
        a = self.cfg.ewma_alpha
        with self._lock:
            if prompt_tokens > 0 and prefill_s > 0:
                self._prefill_s_tok += a * (prefill_s / prompt_tokens
                                            - self._prefill_s_tok)
            if decode_steps > 0 and decode_s > 0:
                self._decode_s_tok += a * (decode_s / decode_steps
                                           - self._decode_s_tok)
            self.measurements += 1

    def summary(self) -> dict:
        with self._lock:
            return {
                "admitted": self.admitted,
                "rejected_queue_full": self.rejected_queue_full,
                "rejected_deadline": self.rejected_deadline,
                "measurements": self.measurements,
                "prefill_s_per_token": self._prefill_s_tok,
                "decode_s_per_token": self._decode_s_tok,
            }


# ---------------------------------------------------------------------------
# retry budget: a process-wide leaky bucket over observed ladder retries
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryBudgetConfig:
    """``capacity`` retries may be spent instantly; the bucket refills at
    ``refill_per_s`` (0 = a hard lifetime cap)."""

    capacity: int = 256
    refill_per_s: float = 4.0

    def __post_init__(self):
        if (isinstance(self.capacity, bool)
                or not isinstance(self.capacity, int) or self.capacity < 1):
            raise ValueError(f"capacity must be an integer >= 1, "
                             f"got {self.capacity!r}")
        if (isinstance(self.refill_per_s, bool)
                or not isinstance(self.refill_per_s, (int, float))
                or self.refill_per_s < 0):
            raise ValueError(f"refill_per_s must be a number >= 0, "
                             f"got {self.refill_per_s!r}")


@guarded_by("_lock", fields=["_level", "_last", "spent", "denied"])
class RetryBudget:
    """Meters ladder retries across every request the front serves.

    The graph's retries are statically unrolled, so they cannot be
    interrupted mid-call; the enforceable contract is *routing*: the front
    calls :meth:`charge` with each call's observed ``retried`` total, and
    :meth:`exhausted` before dispatching onto a faulted path. Once the
    bucket is dry, faulted-path work is refused (typed
    :class:`RetryBudgetExhausted`) until refill — so the total retry spend
    is bounded by ``capacity + refill + one call's overdraft``, never by
    the (unbounded) arrival rate."""

    def __init__(self, config: Optional[RetryBudgetConfig] = None,
                 clock: Clock = MONOTONIC):
        self.cfg = config if config is not None else RetryBudgetConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._level = float(self.cfg.capacity)
        self._last: Optional[float] = None
        self.spent = 0
        self.denied = 0

    def _refill_locked(self) -> None:
        now = self.clock()
        if self._last is not None and self.cfg.refill_per_s > 0:
            self._level = min(float(self.cfg.capacity),
                              self._level
                              + (now - self._last) * self.cfg.refill_per_s)
        self._last = now

    @property
    def available(self) -> float:
        """Retries the bucket will currently fund (floored at 0)."""
        with self._lock:
            self._refill_locked()
            return max(self._level, 0.0)

    def exhausted(self) -> bool:
        return self.available < 1.0

    def charge(self, retries: int) -> None:
        """Debit observed retries (post-hoc; may overdraft one call)."""
        if retries < 0:
            raise ValueError(f"cannot charge {retries} retries")
        if retries == 0:
            return
        with self._lock:
            self._refill_locked()
            self._level -= retries
            self.spent += int(retries)

    def deny(self) -> None:
        """Count a routing refusal caused by an empty bucket."""
        with self._lock:
            self.denied += 1

    def summary(self) -> dict:
        with self._lock:
            self._refill_locked()
            return {
                "capacity": self.cfg.capacity,
                "refill_per_s": self.cfg.refill_per_s,
                "available": max(self._level, 0.0),
                "spent": self.spent,
                "denied": self.denied,
            }


# ---------------------------------------------------------------------------
# circuit breaker: closed -> open -> half-open, injectable clock
# ---------------------------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """``failure_threshold`` consecutive failures open the circuit;
    ``reset_timeout_s`` later, ``half_open_probes`` trial requests may pass —
    one success closes it, one failure re-opens it. ``burn_threshold`` maps
    a :class:`~edgellm_tpu.codecs.fec.LinkHealth` burn rate onto the
    success/failure signal for link breakers."""

    failure_threshold: int = 3
    reset_timeout_s: float = 30.0
    half_open_probes: int = 1
    burn_threshold: float = 1.0

    def __post_init__(self):
        for f in ("failure_threshold", "half_open_probes"):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(f"{f} must be an integer >= 1, got {v!r}")
        for f in ("reset_timeout_s", "burn_threshold"):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, (int, float)) or v <= 0:
                raise ValueError(f"{f} must be a number > 0, got {v!r}")


@guarded_by("_lock", fields=["_state", "_failures", "_opened_at", "_probes",
                             "opens", "total_failures"])
class CircuitBreaker:
    """One guarded resource (a stage, a link, a whole backend).

    States: *closed* (healthy — every request passes, consecutive failures
    counted), *open* (sick — every request refused until
    ``reset_timeout_s`` elapses on the injected clock), *half-open*
    (probing — up to ``half_open_probes`` requests pass; the first success
    closes, the first failure re-opens and re-arms the timeout)."""

    def __init__(self, name: str, config: Optional[BreakerConfig] = None,
                 clock: Clock = MONOTONIC):
        self.name = name
        self.cfg = config if config is not None else BreakerConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probes = 0
        self.opens = 0
        self.total_failures = 0

    def _state_locked(self) -> str:
        """The open -> half-open clock transition; caller holds the lock.
        The scrape thread calls this through :meth:`summary` concurrently
        with decode-thread ``allow``/``record_failure`` — the transition
        mutating ``_state``/``_probes`` is exactly why reads lock."""
        if (self._state == OPEN and self._opened_at is not None
                and self.clock() - self._opened_at >= self.cfg.reset_timeout_s):
            self._state = HALF_OPEN
            self._probes = self.cfg.half_open_probes
        return self._state

    @property
    def state(self) -> str:
        """Current state; lazily transitions open -> half-open on the clock
        (there is no background thread to do it eagerly)."""
        with self._lock:
            return self._state_locked()

    def allow(self) -> bool:
        """May a request pass right now? Half-open passes consume a probe."""
        with self._lock:
            s = self._state_locked()
            if s == CLOSED:
                return True
            if s == HALF_OPEN and self._probes > 0:
                self._probes -= 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state_locked() == HALF_OPEN:
                self._state = CLOSED
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self.total_failures += 1
            s = self._state_locked()
            if s == HALF_OPEN:
                self._open_locked()
                return
            if s == CLOSED:
                self._failures += 1
                if self._failures >= self.cfg.failure_threshold:
                    self._open_locked()

    def trip(self) -> None:
        """Open unconditionally (a stage marked dead needs no vote)."""
        with self._lock:
            if self._state_locked() != OPEN:
                self._open_locked()

    def _open_locked(self) -> None:
        self._state = OPEN
        self._opened_at = self.clock()
        self._failures = 0
        self.opens += 1

    def reset(self) -> None:
        """Back to fresh-closed (a respawned replica starts with a clean
        failure record); ``opens``/``total_failures`` survive as lifetime
        counters so the reset is visible in the summary, not erased."""
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._opened_at = None
            self._probes = 0

    def observe_burn(self, burn_rate: float) -> None:
        """Fold a LinkHealth burn-rate reading into the failure signal."""
        if burn_rate >= self.cfg.burn_threshold:
            self.record_failure()
        else:
            self.record_success()

    def summary(self) -> dict:
        with self._lock:
            return {"state": self._state_locked(), "opens": self.opens,
                    "consecutive_failures": self._failures,
                    "total_failures": self.total_failures}


# ---------------------------------------------------------------------------
# brownout: staged quality degradation under load, with dwell hysteresis
# ---------------------------------------------------------------------------

#: what each brownout level turns off, cumulatively
BROWNOUT_LEVELS = (
    "normal",            # 0: full quality
    "tier_down",         # 1: boundary codec one tier lower
    "hedging_off",       # 2: + no hedged duplicate transmissions
    "token_cap",         # 3: + max_new_tokens shrunk
    "shed_low_priority", # 4: + lowest-priority requests shed at submit
)


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Load thresholds (queue fullness in [0, 1]) with rate + time
    hysteresis, mirroring :class:`~edgellm_tpu.codecs.fec.LinkHealthConfig`:
    ``degrade_load`` must sit strictly above ``promote_load`` (the rate
    band) and ``min_dwell_s`` is the clock floor between level switches."""

    degrade_load: float = 0.8
    promote_load: float = 0.4
    min_dwell_s: float = 0.0
    max_level: int = len(BROWNOUT_LEVELS) - 1
    token_cap_factor: float = 0.5
    shed_below_priority: int = 1

    def __post_init__(self):
        for f in ("degrade_load", "promote_load"):
            v = getattr(self, f)
            if (isinstance(v, bool) or not isinstance(v, (int, float))
                    or not 0.0 < v <= 1.0):
                raise ValueError(f"{f} must be in (0, 1], got {v!r}")
        if self.promote_load >= self.degrade_load:
            raise ValueError(
                f"promote_load ({self.promote_load}) must be below "
                f"degrade_load ({self.degrade_load}) — no hysteresis band")
        if (isinstance(self.min_dwell_s, bool)
                or not isinstance(self.min_dwell_s, (int, float))
                or self.min_dwell_s < 0):
            raise ValueError(f"min_dwell_s must be a number >= 0, "
                             f"got {self.min_dwell_s!r}")
        if (isinstance(self.max_level, bool)
                or not isinstance(self.max_level, int)
                or not 1 <= self.max_level <= len(BROWNOUT_LEVELS) - 1):
            raise ValueError(f"max_level must be an integer in "
                             f"[1, {len(BROWNOUT_LEVELS) - 1}], "
                             f"got {self.max_level!r}")
        if (isinstance(self.token_cap_factor, bool)
                or not isinstance(self.token_cap_factor, (int, float))
                or not 0.0 < self.token_cap_factor <= 1.0):
            raise ValueError(f"token_cap_factor must be in (0, 1], "
                             f"got {self.token_cap_factor!r}")
        if (isinstance(self.shed_below_priority, bool)
                or not isinstance(self.shed_below_priority, int)):
            raise ValueError(f"shed_below_priority must be an integer, "
                             f"got {self.shed_below_priority!r}")


@guarded_by("_lock", fields=["level", "switches", "observations", "sheds",
                             "_last_switch"])
class BrownoutController:
    """Walks the brownout ladder one level per dwell as load crosses the
    hysteresis band; the front consults the properties on every dispatch.

    ``observe(load)`` once per submit/drain tick with the queue fullness.
    ``load >= degrade_load`` steps the level up (more degraded),
    ``load <= promote_load`` steps it back down — each switch arming the
    ``min_dwell_s`` clock so recovering load cannot flap the service
    between quality modes."""

    def __init__(self, config: Optional[BrownoutConfig] = None,
                 clock: Clock = MONOTONIC):
        self.cfg = config if config is not None else BrownoutConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self.level = 0
        self.switches = 0
        self.observations = 0
        self.sheds = 0
        self._last_switch: Optional[float] = None

    def observe(self, load: float) -> int:
        """Fold one load reading (queue fullness in [0, 1]) into the level."""
        with self._lock:
            self.observations += 1
            now = self.clock()
            dwell_ok = (self._last_switch is None
                        or now - self._last_switch >= self.cfg.min_dwell_s)
            if (load >= self.cfg.degrade_load and dwell_ok
                    and self.level < self.cfg.max_level):
                self.level += 1
                self.switches += 1
                self._last_switch = now
            elif (load <= self.cfg.promote_load and dwell_ok
                  and self.level > 0):
                self.level -= 1
                self.switches += 1
                self._last_switch = now
            return self.level

    # -- what the current level turns off ---------------------------------

    @property
    def mode(self) -> str:
        return BROWNOUT_LEVELS[self.level]

    @property
    def tier_bias(self) -> int:
        """Extra codec-ladder steps to apply on top of LinkHealth's tier."""
        return 1 if self.level >= 1 else 0

    @property
    def hedging_enabled(self) -> bool:
        return self.level < 2

    def token_cap(self, requested: int) -> int:
        """The granted ``max_new_tokens`` for a request asking for
        ``requested`` at the current level."""
        if self.level < 3:
            return requested
        return max(1, int(requested * self.cfg.token_cap_factor))

    def should_shed(self, priority: int) -> bool:
        """At the shed level, drop requests below the priority floor."""
        with self._lock:
            if self.level >= 4 and priority < self.cfg.shed_below_priority:
                self.sheds += 1
                return True
            return False

    def summary(self) -> dict:
        with self._lock:
            return {"level": self.level, "mode": BROWNOUT_LEVELS[self.level],
                    "switches": self.switches,
                    "observations": self.observations,
                    "sheds": self.sheds}


# ---------------------------------------------------------------------------
# straggler detection: windowed quantiles vs the fleet median, with dwell
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    """Gray-failure thresholds. A key is flagged when its windowed
    ``quantile`` (p95 by default) is at least ``p95_multiple`` times the
    pooled fleet median, judged only with ``min_samples`` fresh samples in
    the key's window and at least two measured keys (one peer alone has no
    fleet to be slower than). ``min_dwell_s`` is the hysteresis floor
    between verdict flips in either direction; samples expire after
    ``window_s`` and each key's window is bounded at ``max_samples``."""

    p95_multiple: float = 3.0
    quantile: float = 0.95
    window_s: float = 120.0
    max_samples: int = 256
    min_samples: int = 8
    min_dwell_s: float = 5.0

    def __post_init__(self):
        for f, lo in (("p95_multiple", 1.0), ("window_s", 0.0)):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, (int, float)) or v <= lo:
                raise ValueError(f"{f} must be a number > {lo}, got {v!r}")
        if (isinstance(self.quantile, bool)
                or not isinstance(self.quantile, (int, float))
                or not 0.0 < self.quantile < 1.0):
            raise ValueError(f"quantile must be in (0, 1), "
                             f"got {self.quantile!r}")
        for f in ("max_samples", "min_samples"):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(f"{f} must be an integer >= 1, got {v!r}")
        if self.min_samples > self.max_samples:
            raise ValueError(
                f"min_samples ({self.min_samples}) cannot exceed "
                f"max_samples ({self.max_samples})")
        if (isinstance(self.min_dwell_s, bool)
                or not isinstance(self.min_dwell_s, (int, float))
                or self.min_dwell_s < 0):
            raise ValueError(f"min_dwell_s must be a number >= 0, "
                             f"got {self.min_dwell_s!r}")


def _linear_quantile(ordered: list, q: float) -> float:
    """numpy's default (linear-interpolation) quantile over a sorted list —
    kept bit-compatible with ``np.quantile(..., method="linear")`` so the
    detector's window math is testable against the numpy reference without
    importing numpy into this pure-host module."""
    n = len(ordered)
    if n == 1:
        return float(ordered[0])
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(ordered[lo] * (1.0 - frac) + ordered[hi] * frac)


@guarded_by("_lock", fields=["_samples", "_flagged", "_last_flip",
                             "observed", "demotions", "promotions"])
class StragglerDetector:
    """Flags the peers that are *slow*, not dead.

    ``observe(key, latency_s)`` feeds one measured latency (a completed
    request's service time, one migration-page transfer, ...) into the
    key's window on the injected clock. Verdicts are recomputed lazily on
    read (:meth:`is_straggler` / :meth:`stragglers` / :meth:`summary`):

    - **flag** a key whose windowed ``cfg.quantile`` is >=
      ``cfg.p95_multiple`` x the pooled fleet median, once it has
      ``cfg.min_samples`` in-window samples and a fleet (>= 2 keys) exists;
    - **re-promote** the key when fresh measurements bring the quantile
      back under the threshold — a flagged key with an empty window stays
      flagged (re-promotion requires re-measure, never just elapsed time);
    - both flips honor ``cfg.min_dwell_s`` so a borderline peer cannot flap
      in and out of the rotation.

    :meth:`fleet_quantile` exposes the pooled windowed quantile — the
    hedge-delay source (hedge a request once it has been outstanding longer
    than the fleet's observed q-th percentile)."""

    def __init__(self, config: Optional[StragglerConfig] = None,
                 clock: Clock = MONOTONIC):
        self.cfg = config if config is not None else StragglerConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._samples: dict = {}     # key -> deque[(t, latency_s)]
        self._flagged: dict = {}     # key -> flagged_at
        self._last_flip: dict = {}   # key -> last verdict flip time
        self.observed = 0
        self.demotions = 0
        self.promotions = 0

    # -- sample intake ------------------------------------------------------

    def observe(self, key, latency_s: float) -> None:
        """Record one measured latency for ``key`` at the current time."""
        if latency_s < 0:
            raise ValueError(f"latency_s must be >= 0, got {latency_s!r}")
        with self._lock:
            now = self.clock()
            dq = self._samples.setdefault(key, collections.deque())
            dq.append((now, float(latency_s)))
            while len(dq) > self.cfg.max_samples:
                dq.popleft()
            self.observed += 1
            self._expire_locked(now)

    def _expire_locked(self, now: float) -> None:
        horizon = now - self.cfg.window_s
        for key in list(self._samples):
            dq = self._samples[key]
            while dq and dq[0][0] <= horizon:
                dq.popleft()
            if not dq:
                del self._samples[key]

    # -- windowed quantile math --------------------------------------------

    def quantile(self, key, q: Optional[float] = None) -> Optional[float]:
        """The key's windowed q-th quantile (``cfg.quantile`` by default),
        or None with no in-window samples."""
        with self._lock:
            self._expire_locked(self.clock())
            dq = self._samples.get(key)
            if not dq:
                return None
            vals = sorted(v for _, v in dq)
            return _linear_quantile(vals, self.cfg.quantile if q is None
                                    else q)

    def sample_count(self, key) -> int:
        with self._lock:
            self._expire_locked(self.clock())
            dq = self._samples.get(key)
            return len(dq) if dq else 0

    def fleet_quantile(self, q: Optional[float] = None, *,
                       exclude: Any = ()) -> Optional[float]:
        """The q-th quantile pooled over every key's window, or None when
        nothing has been measured recently. ``exclude`` drops the named
        keys from the pool — the hedge delay derives from HEALTHY peers,
        so a straggler's inflated tail cannot push the trigger past every
        deadline and disarm hedging exactly when it is needed."""
        with self._lock:
            self._expire_locked(self.clock())
            vals = sorted(v for key, dq in self._samples.items()
                          if key not in exclude for _, v in dq)
            if not vals:
                return None
            return _linear_quantile(vals, self.cfg.quantile if q is None
                                    else q)

    # -- verdicts -----------------------------------------------------------

    def _update_locked(self, now: float) -> None:
        self._expire_locked(now)
        pooled = sorted(v for dq in self._samples.values() for _, v in dq)
        if not pooled:
            return   # flagged keys stay flagged: no fresh fleet to re-judge
        med = _linear_quantile(pooled, 0.5)
        for key in sorted(set(self._samples) | set(self._flagged),
                          key=repr):
            dq = self._samples.get(key)
            if dq is None or len(dq) < self.cfg.min_samples:
                continue   # too few fresh samples: verdict stands as-is
            last = self._last_flip.get(key)
            if last is not None and now - last < self.cfg.min_dwell_s:
                continue
            p = _linear_quantile(sorted(v for _, v in dq),
                                 self.cfg.quantile)
            slow = (len(self._samples) >= 2
                    and p >= self.cfg.p95_multiple * med)
            if slow and key not in self._flagged:
                self._flagged[key] = now
                self._last_flip[key] = now
                self.demotions += 1
            elif not slow and key in self._flagged:
                del self._flagged[key]
                self._last_flip[key] = now
                self.promotions += 1

    def is_straggler(self, key) -> bool:
        with self._lock:
            self._update_locked(self.clock())
            return key in self._flagged

    def stragglers(self) -> tuple:
        """Currently flagged keys, sorted for deterministic iteration."""
        with self._lock:
            self._update_locked(self.clock())
            return tuple(sorted(self._flagged, key=repr))

    def summary(self) -> dict:
        with self._lock:
            self._update_locked(self.clock())
            return {
                "keys": len(self._samples),
                "flagged": sorted(self._flagged, key=repr),
                "observed": self.observed,
                "demotions": self.demotions,
                "promotions": self.promotions,
            }
