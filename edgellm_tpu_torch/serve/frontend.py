"""The overload-robust serving front: PyTorch counterpart of
``edgellm_tpu/serve/frontend.py``.

    submit(Request) -- admission --> bounded priority queue
        -- drain()          --> one generate_split / generate call a request
        -- drain_batched()  --> ContinuousBatcher (one ragged step for every
                                admitted stream)
                      --> RequestRecord (typed outcome)

Every refusal happens at submit with a typed reason (``queue_full``,
``deadline_infeasible``, brownout ``brownout_shed``) and lands in a
:class:`RequestRecord`; a rejected request costs no device work. Queued
requests whose deadline expired are ``timed_out``, a closed local breaker
refuses with ``circuit_open``, and a prompt that does not fit the batcher's
slot span is ``rejected`` with ``exceeds_slot_span``. Each completed
stream's tokens are those of its solo ``generate`` run.

The per-request route (``drain``) serves each request with one call: on the
installed :class:`~..parallel.split.SplitRuntime` (``generate_split``, with
``speculative`` the draft / verify burst loop) while the split's breakers
and, under a faulty link, the retry budget allow it, else on the
single-device ``generate`` (``local_fallback``). Each call's link retries
are charged to the retry budget, a substituted payload fails the request,
and the per-hop burn rates drive the ``link<i>`` breakers. A
``split_ladder`` of same-topology runtimes is walked by ``link_health.tier
+ brownout.tier_bias``. A lost stage trips its breaker and re-plans the
split onto the surviving stage devices (faults, policy, FEC and hedge
carried over); ``checkpoint_dir`` / ``step_deadline_s`` arm each call's
recovery (checkpoints ``req<rid>.ckpt``, the watchdog; no mid-call
re-plan).

Observability, as the reference places it: ``submit`` and ``_execute``
bind the request id (``r<rid>``) into the trace context around the
``serve.submit`` / ``serve.execute`` spans, so every span the decode loops
open carries it; each terminal record publishes ``serve_*`` metrics into
the global registry when it is enabled, and a batched drain publishes the
prefix-cache counters. The armed flight recorder tracks every admitted
request (``note_request`` / ``end_request``), folds the front's
control-plane state into each artifact (:meth:`ServeFront._flight_context`)
and dumps a stage loss on the retry ladder once;
:meth:`ServeFront.start_obs_server` serves the live endpoint with
:meth:`ServeFront.health_summary` as ``/healthz``.

``drain_batched`` drives a :class:`~.disagg.DisaggServer` as it drives a
batcher (the record's plan mode "disagg", or "disagg_split" over a split
runtime, with the migration scoreboard); :meth:`ServeFront.disagg_state`
and the report's ``"disagg"`` entry carry its degrade state.
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import threading
from typing import Any, Optional

import numpy as np

from ..obs import context as obs_context
from ..obs.flight import flight_dump_for, get_flight_recorder
from ..obs.metrics import Histogram, get_registry, record_prefix_stats
from ..obs.server import ObsServer
from ..obs.tracing import span as obs_span
from ..utils.clock import MONOTONIC, Clock
from ..utils.concurrency import guarded_by
from ..utils import prng
from .decode import generate, generate_split
from .overload import (COMPLETED, FAILED, FAILED_OVER, REJECTED, SHED, TIMED_OUT,
                       AdmissionConfig, AdmissionController, AdmissionError, BreakerConfig,
                       BrownoutConfig, BrownoutController, CircuitBreaker, RetryBudget,
                       RetryBudgetConfig, ServeFrontConfigError)
from .recovery import DecodeTimeout, RecoveryConfig, StageLostError

__all__ = ["Request", "RequestRecord", "ServeFrontConfig", "ServeFront"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One unit of admitted work: ``prompt_ids`` (S,) or (B, S) token ids;
    ``priority`` orders the queue (higher first); ``deadline_s`` is relative
    to submit time (None = best effort); ``rng_seed`` pins the sampling
    stream."""

    prompt_ids: Any
    max_new_tokens: int = 16
    priority: int = 1
    deadline_s: Optional[float] = None
    temperature: float = 0.0
    rng_seed: int = 0

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")


@dataclasses.dataclass
class RequestRecord:
    """The per-request outcome record (the reference's fields)."""

    request_id: int
    outcome: str
    reason: str
    backend: Optional[str]          # "split" | "local" | "batched" | None (never ran)
    priority: int
    submitted_at: float
    started_at: Optional[float]
    finished_at: Optional[float]
    queue_wait_s: Optional[float]
    ttft_s: Optional[float]
    service_s: Optional[float]
    latency_s: Optional[float]
    deadline_s: Optional[float]
    deadline_met: Optional[bool]
    prompt_tokens: int
    requested_tokens: int
    granted_tokens: Optional[int]
    capacity: Optional[int]
    batch: int
    plan: Optional[dict]
    brownout_level: int
    retries_charged: int
    jit_misses: Optional[int]
    tokens: Optional[np.ndarray]    # (B, granted_tokens) or None
    recovery: Optional[dict]

    def as_dict(self) -> dict:
        """JSON-safe view (tokens elided to their shape)."""
        d = dataclasses.asdict(self)
        d["tokens"] = None if self.tokens is None else list(np.asarray(self.tokens).shape)
        return d


@dataclasses.dataclass(frozen=True)
class ServeFrontConfig:
    """Everything the front's controllers need (the reference's fields).
    ``capacity_round`` buckets each per-request cache capacity;
    ``local_fallback`` lets the per-request route serve on the single-device
    ``generate`` when the split's breakers refuse; ``replan_on_stage_loss``
    re-plans the split onto the surviving stages. ``checkpoint_dir`` /
    ``checkpoint_every`` / ``step_deadline_s`` arm the per-request route's
    recovery."""

    admission: AdmissionConfig = dataclasses.field(default_factory=AdmissionConfig)
    breaker: BreakerConfig = dataclasses.field(default_factory=BreakerConfig)
    brownout: BrownoutConfig = dataclasses.field(default_factory=BrownoutConfig)
    retry_budget: RetryBudgetConfig = dataclasses.field(default_factory=RetryBudgetConfig)
    capacity_round: int = 16
    max_new_tokens_cap: Optional[int] = None
    step_deadline_s: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    local_fallback: bool = True
    replan_on_stage_loss: bool = True
    record_history: bool = True

    def __post_init__(self):
        if (isinstance(self.capacity_round, bool)
                or not isinstance(self.capacity_round, int) or self.capacity_round < 1):
            raise ServeFrontConfigError(
                f"capacity_round must be an integer >= 1, got {self.capacity_round!r}")
        if self.max_new_tokens_cap is not None and self.max_new_tokens_cap < 1:
            raise ServeFrontConfigError(
                f"max_new_tokens_cap must be >= 1 or None, got {self.max_new_tokens_cap!r}")
        if self.step_deadline_s is not None and self.step_deadline_s <= 0:
            raise ServeFrontConfigError(
                f"step_deadline_s must be > 0 or None, got {self.step_deadline_s!r}")
        if self.checkpoint_every < 0:
            raise ServeFrontConfigError(
                f"checkpoint_every must be >= 0, got {self.checkpoint_every!r}")


@dataclasses.dataclass
class _Pending:
    """Internal queue entry: the request plus everything priced at submit."""

    rid: int
    req: Request
    prompt: np.ndarray              # always (B, S)
    granted: int
    est_s: float
    submitted_at: float


def _round_up(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


@guarded_by("_submit_lock", fields=["_seq", "_queue", "_backlog_s", "_inflight_rids",
                                    "_agg", "records"])
class ServeFront:
    """The serving front: ``submit`` admits, :meth:`drain` (one generate
    call a request, on ``split_runtime`` when given) or
    :meth:`drain_batched` (the continuous batcher) executes, every terminal
    state becomes a :class:`RequestRecord` in ``records``. ``speculative``
    (a :class:`~.speculative.SpecConfig`) runs every split-served request
    through the draft / verify burst loop. ``split_ladder``: same-topology
    runtimes at decreasing fidelity, served from index ``link_health.tier +
    brownout.tier_bias`` (clamped); with one ``split_runtime`` the tier
    signals are reported, not actuated."""

    def __init__(self, model_cfg: Any, params: dict, *, split_runtime: Any = None,
                 split_ladder: Any = None, config: Optional[ServeFrontConfig] = None,
                 link_health: Any = None, compute_dtype: Any = None, batcher: Any = None,
                 speculative: Any = None, clock: Clock = MONOTONIC):
        if split_runtime is not None and split_ladder is not None:
            raise ServeFrontConfigError("pass split_runtime OR split_ladder, not both")
        self.link_health = link_health
        self.batcher = batcher
        self.speculative = speculative
        self.model_cfg = model_cfg
        self.config = config if config is not None else ServeFrontConfig()
        self.clock = clock
        self.compute_dtype = compute_dtype
        self._params = params
        self.admission = AdmissionController(self.config.admission)
        self.budget = RetryBudget(self.config.retry_budget, clock=clock)
        self.brownout = BrownoutController(self.config.brownout, clock=clock)
        self._queue: list = []      # heap of (-priority, deadline, rid, _Pending)
        self._backlog_s = 0.0
        self._seq = 0
        self._submit_lock = threading.Lock()
        self._obs_server: Optional[ObsServer] = None
        fl = get_flight_recorder()
        if fl is not None:
            fl.set_context_provider(self._flight_context)
        self.records: list[RequestRecord] = []
        self._agg: dict = {"requests": 0, "finished": 0, "tokens_out": 0, "met": 0,
                           "with_deadline": 0, "outcomes": {}, "reasons": {},
                           "link_counters": {}}
        # the report's percentiles: call-private histograms (the registry's
        # series are published in _finish when the registry is enabled)
        self._ttft_hist = Histogram("serve_ttft_s", lo=1e-6, hi=1e4, n_buckets=400)
        self._latency_hist = Histogram("serve_latency_s", lo=1e-6, hi=1e4, n_buckets=400)
        self._inflight_rids: set = set()
        self.failovers = 0
        self._plans: dict = {}
        self._rt = None
        self._placed = None
        self._split_names: tuple = ()
        self._ladder = None
        self._ladder_idx = 0
        self._ladder_placed: dict = {}
        self._breakers = {"local": CircuitBreaker("local", self.config.breaker, clock=clock)}
        if split_ladder is not None:
            if not split_ladder:
                raise ServeFrontConfigError("split_ladder may not be empty")
            self._ladder = tuple(split_ladder)
            self._install_runtime(self._ladder[0])
        elif split_runtime is not None:
            self._install_runtime(split_runtime)

    # -- runtime management ------------------------------------------------

    def set_split_runtime(self, rt: Any, *, keep_breakers: bool = False) -> None:
        """Swap the split backend (the soak's corruption burst on and off).
        Clears any ladder; ``keep_breakers`` keeps the breakers' state across
        the swap (same topology)."""
        self._ladder = None
        self._ladder_placed = {}
        self._install_runtime(rt, keep_breakers=keep_breakers)

    def _install_runtime(self, rt: Any, *, keep_breakers: bool = False) -> None:
        """Serve on ``rt``: its placed weights, and fresh closed breakers for
        the split, each stage and each link (kept with ``keep_breakers`` when
        the topology is the same)."""
        self._rt = rt
        self._placed = rt.place_params(self._params)
        names = (["split"] + [f"stage{i}" for i in range(rt.split.n_stages)]
                 + [f"link{i}" for i in range(len(rt.split.cuts))])
        if keep_breakers and self._split_names == tuple(names):
            return
        for n in self._split_names:
            self._breakers.pop(n, None)
        self._split_names = tuple(names)
        for n in names:
            self._breakers[n] = CircuitBreaker(n, self.config.breaker, clock=self.clock)

    def _walk_ladder(self) -> None:
        """Serve from the ladder entry the tier signals point at."""
        if self._ladder is None:
            return
        base = self.link_health.tier if self.link_health is not None else 0
        idx = min(base + self.brownout.tier_bias, len(self._ladder) - 1)
        if idx == self._ladder_idx and self._rt is self._ladder[idx]:
            return
        self._ladder_idx = idx
        rt = self._ladder[idx]
        if idx in self._ladder_placed:
            self._rt, self._placed = rt, self._ladder_placed[idx]  # same topology: breakers stay
        else:
            self._install_runtime(rt, keep_breakers=True)
            self._ladder_placed[idx] = self._placed

    @property
    def split_runtime(self) -> Any:
        return self._rt

    @property
    def params(self) -> dict:
        """The raw (unplaced) weights the front serves with."""
        return self._params

    @property
    def breakers(self) -> dict:
        return dict(self._breakers)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def probe_prefix(self, prompt_ids) -> int:
        """Leading tokens of this prompt the batcher's pool already holds."""
        return 0 if self.batcher is None else self.batcher.probe_prefix(prompt_ids)

    def load_fraction(self) -> float:
        """Load pressure in [0, 1]: queue fullness or the brownout level."""
        depth = len(self._queue) / self.admission.cfg.max_queue_depth
        level = self.brownout.level / max(1, self.brownout.cfg.max_level)
        return float(min(1.0, max(depth, level)))

    # -- submit ------------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Admit (or reject / shed, recorded) one request; returns its id."""
        rid, _ = self.submit_ex(req)
        return rid

    def submit_ex(self, req: Request) -> tuple:
        """:meth:`submit` plus the submit-time refusal: ``(rid, record)``,
        ``record`` the terminal :class:`RequestRecord` of a rejected or shed
        request, None for a queued one."""
        now = self.clock()
        with self._submit_lock:
            self._seq += 1
            rid = self._seq
        fl = get_flight_recorder()
        if fl is not None:
            fl.note_request(f"r{rid}", priority=int(req.priority),
                            prompt=int(np.asarray(req.prompt_ids).size),
                            max_new_tokens=int(req.max_new_tokens))
        with obs_context.bind(rid=f"r{rid}"):
            with obs_span("serve.submit", priority=int(req.priority)):
                return rid, self._submit_impl(rid, req, now)

    def _submit_impl(self, rid: int, req: Request, now: float) -> Optional[RequestRecord]:
        depth = len(self._queue)
        self.brownout.observe(depth / self.admission.cfg.max_queue_depth)
        prompt = np.asarray(req.prompt_ids)
        if prompt.ndim == 1:
            prompt = prompt[None, :]
        if prompt.ndim != 2:
            raise ValueError(f"prompt_ids must be (S,) or (B, S), got {prompt.shape}")
        b, s = prompt.shape
        requested = req.max_new_tokens
        if self.config.max_new_tokens_cap is not None:
            requested = min(requested, self.config.max_new_tokens_cap)
        granted = self.brownout.token_cap(requested)
        if self.brownout.should_shed(req.priority):
            return self._finish(rid, req, b, s, SHED, "brownout_shed", now)
        try:
            self.admission.admit(s, granted, depth, req.deadline_s, backlog_s=self._backlog_s)
        except AdmissionError as e:
            return self._finish(rid, req, b, s, REJECTED, e.reason, now)
        est = self.admission.estimate_s(s, granted)
        pend = _Pending(rid=rid, req=req, prompt=prompt, granted=granted, est_s=est,
                        submitted_at=now)
        deadline_key = now + req.deadline_s if req.deadline_s is not None else float("inf")
        with self._submit_lock:
            heapq.heappush(self._queue, (-req.priority, deadline_key, rid, pend))
            self._backlog_s += est
        return None

    # -- drain -------------------------------------------------------------

    def _pop_pending(self) -> Optional[_Pending]:
        with self._submit_lock:
            if not self._queue:
                return None
            _, _, _, pend = heapq.heappop(self._queue)
            self._backlog_s = max(0.0, self._backlog_s - pend.est_s)
            self._inflight_rids.add(pend.rid)
            return pend

    def drain_pending(self) -> list:
        """Pop every queued request as ``[(rid, Request)]`` without recording
        a terminal outcome."""
        out: list = []
        with self._submit_lock:
            while self._queue:
                _, _, _, pend = heapq.heappop(self._queue)
                out.append((pend.rid, pend.req))
            self._backlog_s = 0.0
        fl = get_flight_recorder()
        if fl is not None:
            for rid, _ in out:
                fl.end_request(f"r{rid}")
        return out

    def drain(self, max_requests: Optional[int] = None) -> list:
        """Execute queued requests in (priority, deadline) order, one
        generate call each; returns the records produced by this call."""
        out: list = []
        while max_requests is None or len(out) < max_requests:
            pend = self._pop_pending()
            if pend is None:
                break
            self.brownout.observe(len(self._queue) / self.admission.cfg.max_queue_depth)
            out.append(self._execute(pend))
        return out

    def _execute(self, p: _Pending) -> RequestRecord:
        """One request's terminal execution, bound to its trace context:
        every hop span the decode loops emit below carries the request id."""
        with obs_context.bind(rid=f"r{p.rid}"):
            with obs_span("serve.execute", priority=int(p.req.priority)):
                return self._execute_impl(p)

    def _execute_impl(self, p: _Pending) -> RequestRecord:
        now = self.clock()
        wait = now - p.submitted_at
        b, s = p.prompt.shape
        d = p.req.deadline_s
        if d is not None and wait >= d:
            return self._finish(p.rid, p.req, b, s, TIMED_OUT, "expired_in_queue",
                                p.submitted_at, queue_wait_s=wait)
        if d is not None and not self.admission.feasible(s, p.granted, d - wait):
            return self._finish(p.rid, p.req, b, s, SHED, "deadline_infeasible_in_queue",
                                p.submitted_at, queue_wait_s=wait)
        self._walk_ladder()
        backend, route_note = self._choose_route()
        if backend is None:
            return self._finish(p.rid, p.req, b, s, REJECTED, route_note or "circuit_open",
                                p.submitted_at, queue_wait_s=wait)
        capacity = _round_up(s + p.granted, self.config.capacity_round)
        try:
            toks, stats, retries = self._run(p, backend, capacity)
            attempt2 = False
        except StageLostError as e:
            # the post-mortem before routing around (once an instance)
            flight_dump_for(e, rid=p.rid, backend=backend)
            self._on_stage_loss(e.stage)
            backend, _ = self._choose_route()
            if backend is None:
                return self._finish(p.rid, p.req, b, s, FAILED, f"stage_lost:{e.stage}",
                                    p.submitted_at, queue_wait_s=wait, backend=None,
                                    started_at=now)
            try:
                toks, stats, retries = self._run(p, backend, capacity)
                attempt2 = True
                route_note = f"stage_lost:{e.stage}"
            except (StageLostError, DecodeTimeout) as e2:
                flight_dump_for(e2, rid=p.rid, backend=backend)
                reason = (f"stage_lost:{e2.stage}" if isinstance(e2, StageLostError)
                          else "watchdog")
                return self._finish(p.rid, p.req, b, s, FAILED, reason, p.submitted_at,
                                    queue_wait_s=wait, backend=backend, started_at=now)
        except DecodeTimeout:
            self._breakers["split" if backend == "split" else "local"].record_failure()
            return self._finish(p.rid, p.req, b, s, TIMED_OUT, "watchdog", p.submitted_at,
                                queue_wait_s=wait, backend=backend, started_at=now)
        lc = stats.get("link_counters")
        substituted = sum(lc.get("substituted", ())) if lc else 0
        service = stats.get("prefill_s", 0.0) + stats.get("decode_s", 0.0)
        self.admission.record(s, stats.get("prefill_s", 0.0), stats.get("decode_steps", 0),
                              stats.get("decode_s", 0.0))
        if backend == "split":
            if substituted:
                self._breakers["split"].record_failure()
            else:
                self._breakers["split"].record_success()
                for i in range(self._rt.split.n_stages):
                    self._breakers[f"stage{i}"].record_success()
            self._observe_link_burn(lc)
        else:
            self._breakers["local"].record_success()
        if substituted:
            outcome, reason = FAILED, "substituted_payload"
        elif attempt2:
            outcome, reason = FAILED_OVER, route_note
        else:
            outcome, reason = COMPLETED, (route_note or "")
        plan = ({"mode": "split", "cuts": list(self._rt.split.cuts),
                 "hop_codecs": list(self._rt.split.hop_codecs)}
                if backend == "split" else {"mode": "local"})
        key = (b, capacity)
        self._plans[key] = self._plans.get(key, 0) + 1
        return self._finish(
            p.rid, p.req, b, s, outcome, reason, p.submitted_at, queue_wait_s=wait,
            backend=backend, started_at=now, ttft_s=wait + stats.get("prefill_s", 0.0),
            service_s=service, latency_s=wait + service, granted_tokens=p.granted,
            capacity=capacity, plan=plan, retries_charged=retries,
            jit_misses=stats.get("decode_step_cache_misses"), tokens=np.asarray(toks.cpu()),
            recovery=stats.get("recovery_counters"))

    # -- routing + backends ------------------------------------------------

    def _choose_route(self):
        """Pick a backend the breakers and the retry budget will fund ->
        (backend, note): the note names why the split was skipped."""
        note = None
        if self._rt is not None:
            if all(self._breakers[n].allow() for n in self._split_names):
                if self._rt.faults is not None and self.budget.exhausted():
                    self.budget.deny()
                    note = "retry_budget_exhausted"
                else:
                    return "split", None
            else:
                note = "circuit_open"
            if self.config.local_fallback and self._breakers["local"].allow():
                return "local", note
            return None, note
        if self._breakers["local"].allow():
            return "local", None
        return None, "circuit_open"

    def _recovery_cfg(self, rid: int) -> Optional[RecoveryConfig]:
        """The call's recovery, or None (the plain loops) when nothing is
        configured. ``replan=False``: a mid-call re-plan would be invisible
        to the front's routing, so a stage loss propagates here."""
        ckpt_dir = self.config.checkpoint_dir
        if ckpt_dir is None and self.config.step_deadline_s is None:
            return None
        path = os.path.join(ckpt_dir, f"req{rid}.ckpt") if ckpt_dir is not None else None
        return RecoveryConfig(checkpoint_path=path,
                              checkpoint_every=self.config.checkpoint_every if path else 0,
                              deadline_s=self.config.step_deadline_s, replan=False,
                              clock=self.clock)

    def _run(self, p: _Pending, backend: str, capacity: int):
        """One generation attempt -> (tokens, stats, retries charged)."""
        stats: dict = {}
        key = prng.key(p.req.rng_seed)
        rec = self._recovery_cfg(p.rid)
        if backend == "split":
            if self.speculative is not None and self.speculative.enabled:
                # a verify burst may write k - 1 draft rows past the vanilla
                # high-water mark
                capacity = max(capacity, p.prompt.shape[1] + p.granted + self.speculative.k - 2)
            toks = generate_split(self._rt, self._placed, p.prompt, p.granted,
                                  capacity=capacity, temperature=p.req.temperature,
                                  rng_key=key, fault_step=p.rid, stats=stats, recovery=rec,
                                  raw_params=self._params, link_health=self.link_health,
                                  speculative=self.speculative)
        else:
            toks = generate(self.model_cfg, self._params, p.prompt, p.granted,
                            capacity=capacity, temperature=p.req.temperature, rng_key=key,
                            compute_dtype=self.compute_dtype, stats=stats, recovery=rec)
        lc = stats.get("link_counters")
        retries = int(sum(lc.get("retried", ()))) if lc else 0
        self.budget.charge(retries)
        if lc:
            with self._submit_lock:
                totals = self._agg["link_counters"]
                for k, v in lc.items():
                    totals[k] = totals.get(k, 0) + int(sum(v))
        return toks, stats, retries

    def _on_stage_loss(self, stage: int) -> None:
        """Trip the breakers, then route around: re-plan the split onto the
        surviving stages' devices (>= 2 left; the link's faults, policy, FEC
        and hedge carried over) or leave the open breakers to force the
        local fallback. The re-planned runtime persists for later
        requests."""
        self.failovers += 1
        if f"stage{stage}" in self._breakers:
            self._breakers[f"stage{stage}"].trip()
        self._breakers["split"].record_failure()
        if not self.config.replan_on_stage_loss or self._rt is None:
            return
        devices = list(self._rt.devices)
        if not (0 <= stage < len(devices)) or len(devices) - 1 < 2:
            return
        from ..parallel.split import SplitRuntime

        survivors = devices[:stage] + devices[stage + 1:]
        rt = self._rt
        new_split = rt.split.replan(rt.cfg.num_layers, len(survivors))
        new_rt = SplitRuntime(rt.cfg, new_split, survivors, faults=rt.faults,
                              policy=rt.policy, fec=rt.fec, hedge=rt.hedge)
        self._ladder = None
        self._ladder_placed = {}
        self._install_runtime(new_rt)

    def _observe_link_burn(self, lc: Optional[dict]) -> None:
        """Per-hop burn rates -> the ``link<i>`` breakers, priced with the
        link SLO's error budget (0.02 without a tracker)."""
        if lc is None:
            return
        budget = self.link_health.cfg.error_budget if self.link_health is not None else 0.02
        hops, det, rep = lc.get("hops", ()), lc.get("detected", ()), lc.get("repaired", ())
        for i, h in enumerate(hops):
            name = f"link{i}"
            if name not in self._breakers or not h:
                continue
            unrepaired = (det[i] if i < len(det) else 0) - (rep[i] if i < len(rep) else 0)
            self._breakers[name].observe_burn((unrepaired / h) / budget)

    def drain_batched(self, max_requests: Optional[int] = None,
                      max_steps: int = 100_000) -> list:
        """Execute queued requests through the continuous batcher: one ragged
        decode step serves every admitted stream. Admission, brownout,
        deadline expiry and the local breaker apply as in the reference."""
        if self.batcher is None:
            raise ServeFrontConfigError(
                "drain_batched needs a continuous batcher: "
                "ServeFront(..., batcher=ContinuousBatcher(...))")
        out: list = []
        inflight: dict = {}   # sid -> (pend, queue_wait_s, started_at)
        while max_requests is None or len(out) + len(inflight) < max_requests:
            pend = self._pop_pending()
            if pend is None:
                break
            self.brownout.observe(len(self._queue) / self.admission.cfg.max_queue_depth)
            now = self.clock()
            wait = now - pend.submitted_at
            b, s = pend.prompt.shape
            d = pend.req.deadline_s
            if d is not None and wait >= d:
                out.append(self._finish(pend.rid, pend.req, b, s, TIMED_OUT,
                                        "expired_in_queue", pend.submitted_at,
                                        queue_wait_s=wait))
                continue
            if b != 1:  # the batcher serves single streams: one-shot route
                out.append(self._execute(pend))
                continue
            if not self._breakers["local"].allow():
                out.append(self._finish(pend.rid, pend.req, b, s, REJECTED, "circuit_open",
                                        pend.submitted_at, queue_wait_s=wait))
                continue
            try:
                sid = self.batcher.submit(pend.prompt[0], pend.granted,
                                          temperature=pend.req.temperature,
                                          rng_seed=pend.req.rng_seed)
            except ValueError:
                # prompt + granted tokens exceed the batcher's slot span: a
                # per-request shape problem, rejected, and the drain goes on
                out.append(self._finish(pend.rid, pend.req, b, s, REJECTED,
                                        "exceeds_slot_span", pend.submitted_at,
                                        queue_wait_s=wait))
                continue
            inflight[sid] = (pend, wait, now)
        if not inflight:
            return out
        t0 = self.clock()
        try:
            results = self.batcher.run(max_steps)
            failure = None
        except Exception as e:  # noqa: BLE001 — a wedged pool / watchdog
            results = self.batcher.results
            failure = e
        wall = self.clock() - t0
        rep = self.batcher.report()
        plan = {"mode": "batched", "page_size": self.batcher.bcfg.page_size,
                "num_pages": self.batcher.bcfg.num_pages,
                "max_slots": self.batcher.bcfg.max_slots}
        if rep.get("prefix"):
            # once a drain (the counters carry running totals)
            record_prefix_stats(rep["prefix"])
            plan["prefix"] = {"hit_rate": rep["prefix"]["hit_rate"],
                              "saved_tokens": rep["prefix"]["saved_tokens"],
                              "shared_pages": rep["prefix"]["shared_pages"]}
        if getattr(self.batcher, "rt", None) is not None:
            # a split-driven batcher: the plan its ragged steps ran on
            plan["mode"] = "batched_split"
            plan["cuts"] = [int(c) for c in self.batcher.rt.split.cuts]
            plan["hop_codecs"] = [c.name for c in self.batcher.rt.codecs]
        if rep.get("disagg"):
            # a disaggregated front: the migration scoreboard, so a degrade
            # is attributable to the drain it happened in
            plan["mode"] = "disagg_split" if plan["mode"] == "batched_split" else "disagg"
            plan["disagg"] = {"degraded": rep["disagg"]["degraded"],
                              "degrade_reason": rep["disagg"]["degrade_reason"],
                              "migrations": rep["disagg"]["migrations"],
                              "recompute_tokens": rep["disagg"]["recompute_tokens"]}
        for sid in sorted(inflight):
            pend, wait, started = inflight[sid]
            b, s = pend.prompt.shape
            toks = results.get(sid)
            self.batcher.discard(sid)
            if toks is None:
                self._breakers["local"].record_failure()
                reason = (f"batcher:{type(failure).__name__}" if failure is not None
                          else "batcher:incomplete")
                out.append(self._finish(pend.rid, pend.req, b, s, FAILED, reason,
                                        pend.submitted_at, queue_wait_s=wait,
                                        backend="batched", started_at=started))
                continue
            self._breakers["local"].record_success()
            # service / latency are whole-batch wall time: streams share the
            # step loop
            out.append(self._finish(
                pend.rid, pend.req, b, s, COMPLETED, "", pend.submitted_at,
                queue_wait_s=wait, backend="batched", started_at=started,
                service_s=wall, latency_s=wait + wall, granted_tokens=pend.granted,
                capacity=self.batcher.bcfg.span, plan=plan,
                jit_misses=rep.get("jit_misses"), tokens=np.asarray(toks)[None, :]))
        return out

    # -- records + reporting -----------------------------------------------

    def _finish(self, rid: int, req: Request, batch: int, prompt_tokens: int, outcome: str,
                reason: str, submitted_at: float, *, queue_wait_s: Optional[float] = None,
                backend: Optional[str] = None, started_at: Optional[float] = None,
                ttft_s: Optional[float] = None, service_s: Optional[float] = None,
                latency_s: Optional[float] = None, granted_tokens: Optional[int] = None,
                capacity: Optional[int] = None, plan: Optional[dict] = None,
                retries_charged: int = 0, jit_misses: Optional[int] = None,
                tokens: Optional[np.ndarray] = None,
                recovery: Optional[dict] = None) -> RequestRecord:
        deadline_met = None
        if req.deadline_s is not None and latency_s is not None:
            deadline_met = latency_s <= req.deadline_s
        finished_at = (started_at + service_s
                       if started_at is not None and service_s is not None else None)
        rec = RequestRecord(
            request_id=rid, outcome=outcome, reason=reason, backend=backend,
            priority=req.priority, submitted_at=submitted_at, started_at=started_at,
            finished_at=finished_at, queue_wait_s=queue_wait_s, ttft_s=ttft_s,
            service_s=service_s, latency_s=latency_s, deadline_s=req.deadline_s,
            deadline_met=deadline_met, prompt_tokens=prompt_tokens,
            requested_tokens=req.max_new_tokens, granted_tokens=granted_tokens,
            capacity=capacity, batch=batch, plan=plan, brownout_level=self.brownout.level,
            retries_charged=retries_charged, jit_misses=jit_misses, tokens=tokens,
            recovery=recovery)
        if outcome in (COMPLETED, FAILED_OVER):
            if ttft_s is not None:
                self._ttft_hist.observe(ttft_s)
            if latency_s is not None:
                self._latency_hist.observe(latency_s)
        with self._submit_lock:
            agg = self._agg
            agg["requests"] += 1
            agg["outcomes"][outcome] = agg["outcomes"].get(outcome, 0) + 1
            if reason:
                agg["reasons"][reason] = agg["reasons"].get(reason, 0) + 1
            if outcome in (COMPLETED, FAILED_OVER):
                agg["finished"] += 1
                if granted_tokens is not None:
                    agg["tokens_out"] += batch * granted_tokens
                if deadline_met is not None:
                    agg["with_deadline"] += 1
                    agg["met"] += int(deadline_met)
            if self.config.record_history:
                self.records.append(rec)
            self._inflight_rids.discard(rid)
        fl = get_flight_recorder()
        if fl is not None:
            fl.end_request(f"r{rid}")
        reg = get_registry()
        if reg.enabled:
            reg.counter("serve_requests_total", "terminal serve outcomes").inc(outcome=outcome)
            if ttft_s is not None:
                reg.histogram("serve_ttft_s", "submit -> first token",
                              lo=1e-4, hi=120.0).observe(ttft_s)
            if latency_s is not None:
                reg.histogram("serve_latency_s", "submit -> last token",
                              lo=1e-4, hi=600.0).observe(latency_s)
            if retries_charged:
                reg.counter("serve_retries_charged_total",
                            "ladder retries charged to the retry budget").inc(retries_charged)
            reg.gauge("serve_brownout_level", "current brownout level").set(self.brownout.level)
            reg.gauge("serve_queue_depth", "queued requests").set(len(self._queue))
        return rec

    def report(self) -> dict:
        """Aggregate view over every terminal record so far (the reference's
        keys): outcome / reason counts, SLO attainment, TTFT / latency
        percentiles, controller summaries, breaker states."""

        def pct(hist):
            if hist.count == 0:
                return None
            return {"p50": float(hist.quantile(0.50)), "p95": float(hist.quantile(0.95)),
                    "p99": float(hist.quantile(0.99))}

        with self._submit_lock:
            agg = {**self._agg, "outcomes": dict(self._agg["outcomes"]),
                   "reasons": dict(self._agg["reasons"]),
                   "link_counters": dict(self._agg["link_counters"])}
            depth = len(self._queue)
        return {
            "requests": agg["requests"], "finished": agg["finished"],
            "tokens_out": agg["tokens_out"], "outcomes": agg["outcomes"],
            "reasons": agg["reasons"],
            "slo_attainment": ((agg["met"] / agg["with_deadline"])
                               if agg["with_deadline"] else None),
            "ttft_s": pct(self._ttft_hist), "latency_s": pct(self._latency_hist),
            "queue_depth": depth, "failovers": self.failovers,
            "admission": self.admission.summary(), "retry_budget": self.budget.summary(),
            "brownout": self.brownout.summary(),
            "breakers": {n: b.summary() for n, b in sorted(self._breakers.items())},
            "plans": {f"{b}x{c}": n for (b, c), n in sorted(self._plans.items())},
            **({"prefix": self.batcher.pool.prefix_report()}
               if self.batcher is not None and self.batcher.pool.prefix is not None else {}),
            # beyond the reference's keys: the link counters of every split
            # call this front made, summed over hops and requests
            **({"link_counters": agg["link_counters"]} if agg["link_counters"] else {}),
            **({"link_health": self.link_health.summary()}
               if self.link_health is not None else {}),
            # present only when this front drains a disaggregated server
            **({"disagg": self.disagg_state()} if self.disagg_state() is not None else {}),
        }

    def disagg_state(self) -> Optional[dict]:
        """A disaggregated batcher's degrade state, or None for a colocated
        front (a degraded disagg front still answers, token for token, at
        colocated throughput)."""
        b = self.batcher
        if b is None or not hasattr(b, "degrade_reason"):
            return None
        return {"degraded": bool(b.degraded), "degrade_reason": b.degrade_reason}

    # -- live telemetry ----------------------------------------------------

    def _flight_context(self) -> dict:
        """What the flight recorder folds into every artifact: the front's
        control-plane state at dump time."""
        ctx: dict = {"queue_depth": len(self._queue), "brownout": self.brownout.summary(),
                     "failovers": self.failovers,
                     "breakers": {n: b.summary() for n, b in sorted(self._breakers.items())}}
        if self.link_health is not None:
            ctx["link_health"] = self.link_health.summary()
        return ctx

    def health_summary(self) -> dict:
        """Degraded whenever a breaker left the closed state or brownout is
        active; one consistent snapshot under the submit lock."""
        with self._submit_lock:
            breakers = {n: b.summary() for n, b in sorted(self._breakers.items())}
            open_names = [n for n, s in breakers.items() if s.get("state") != "closed"]
            level = self.brownout.level
            health = {"status": "degraded" if open_names or level else "ok",
                      "open_breakers": open_names, "brownout_level": level,
                      "queue_depth": len(self._queue), "inflight": len(self._inflight_rids),
                      "records": self._agg["requests"], "failovers": self.failovers}
            if self.link_health is not None:
                health["link_health"] = self.link_health.summary()
            return health

    def start_obs_server(self, port: int = 0) -> int:
        """Serve the live endpoint for this front (``/healthz`` is
        :meth:`health_summary`) and point the armed flight recorder at the
        front's context -> the bound port (``port=0``: the OS picks)."""
        if self._obs_server is None:
            self._obs_server = ObsServer(port, health_fn=self.health_summary)
            self._obs_server.start()
        fl = get_flight_recorder()
        if fl is not None:
            fl.set_context_provider(self._flight_context)
        port_ = self._obs_server.port
        assert port_ is not None  # started above
        return port_

    def stop_obs_server(self) -> None:
        if self._obs_server is not None:
            self._obs_server.stop()
            self._obs_server = None

    # -- graphlint hook ----------------------------------------------------

    def step_trace_spec(self, batch: int, prompt_len: int, max_new_tokens: int,
                        temperature: float = 0.0) -> dict:
        """The decode-step parameters this front would run for a request of
        the given shape: what the ``frontend.decode-step-identity`` lint
        contract holds against direct ``generate``. ``uses_survivable_loop``
        is False iff the front runs the untouched direct loop (default
        config)."""
        requested = max_new_tokens
        if self.config.max_new_tokens_cap is not None:
            requested = min(requested, self.config.max_new_tokens_cap)
        granted = self.brownout.token_cap(requested)
        return {
            "granted_tokens": granted,
            "capacity": _round_up(prompt_len + granted, self.config.capacity_round),
            "temperature": float(temperature),
            "compute_dtype": self.compute_dtype,
            "uses_survivable_loop": self._recovery_cfg(0) is not None,
        }
