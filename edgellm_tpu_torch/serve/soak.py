"""The deterministic soak of the serving front: PyTorch counterpart of
``edgellm_tpu/serve/soak.py``'s :class:`SoakConfig` and :func:`run_soak`.

An open-loop workload (seeded Poisson arrivals on a virtual clock) pushed
through a :class:`~.frontend.ServeFront`'s per-request route, and an
artifact out the other side: goodput, SLO attainment, reject and shed
rates, p99 TTFT, the retry-budget account, and an identity audit of every
``completed`` request against a replay on a clean runtime of the same plan.

- Time is a :class:`~..utils.clock.FakeClock`: arrivals, deadlines and
  breaker timeouts live on the virtual timeline, and after each served
  request the clock advances by its *measured* service time.
- The workload is ``numpy.default_rng(seed)``: interarrival gaps, prompts
  and priorities replay bit for bit from ``SoakConfig.seed``, the
  reference's draws in the reference's order.
- Chaos is scheduled by arrival index: the kill (``kill_stage``) fires just
  before request ``int(n * kill_at_frac)`` is submitted, marking the stage
  lost on the front's runtime (the front then re-plans onto the
  survivors); ``burst_runtime=`` (a same-topology runtime with a corrupting
  link) is swapped in over the ``[burst_start_frac, burst_end_frac)``
  arrival window with the breakers kept, and the original restored after
  it unless a re-plan happened in between.

The identity audit replays each completed request on a clean runtime of the
plan that served it (its stage devices captured when the plan first
served); under a faulty link a substituted hop can make a request differ
from that replay, in the reference as in the port. The artifact's
``flight_dumps`` lists the armed flight recorder's artifacts (None when
none is armed).

:func:`run_cluster_soak` is the replica router's chaos soak
(:class:`ClusterSoakConfig`): every request regenerated from its arrival
index by a crc32 draw, replica kills, gray slowdowns and a corruption
burst scheduled by arrival index, aggregates folded as records drain (flat
memory), and each completed request replayed against the sim replica's
crc chain; the artifact is the reference's, key for key.

:func:`run_disagg_soak` is the disaggregated server's chaos soak
(:class:`DisaggSoakConfig`): requests regenerated from their index, kills
of a prefill worker mid-migration (through ``page_hook``), of a given
worker, of the decode worker and of the link scheduled by arrival index, a
seeded bit-flip window on the migration link, and the identity audit of
every completed request against a fault-free colocated batcher.
"""
from __future__ import annotations

import dataclasses
import math
import struct
import zlib
from typing import Any, Optional

import numpy as np

from ..obs.flight import get_flight_recorder
from ..obs.metrics import Histogram
from ..utils import prng
from ..utils.clock import FakeClock
from .decode import generate, generate_split
from .frontend import Request, ServeFront
from .overload import COMPLETED, FAILED_OVER, REJECTED, SHED, TIMED_OUT

__all__ = ["ClusterSoakConfig", "DisaggSoakConfig", "SoakConfig", "run_cluster_soak",
           "run_disagg_soak", "run_soak"]


@dataclasses.dataclass(frozen=True)
class SoakConfig:
    """The replayable soak definition. ``arrival_rate`` is requests per
    virtual second; ``deadline_s`` applies to every request (None = best
    effort); ``shared_prefix_len`` opens every prompt with the same seeded
    token block (a system prompt). ``kill_stage`` / ``kill_at_frac``
    schedule the stage kill; the burst window is actuated by ``run_soak``'s
    ``burst_runtime``; ``verify_identity`` replays every completed request
    on a clean runtime."""

    n_requests: int = 32
    arrival_rate: float = 2.0
    seed: int = 0
    prompt_len: int = 8
    shared_prefix_len: int = 0
    max_new_tokens: int = 8
    deadline_s: Optional[float] = 60.0
    temperature: float = 0.7
    priority_levels: int = 2
    kill_stage: Optional[int] = None
    kill_at_frac: float = 0.5
    burst_start_frac: float = 0.15
    burst_end_frac: float = 0.35
    verify_identity: bool = True

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if self.arrival_rate <= 0:
            raise ValueError("arrival_rate must be > 0")
        for f in ("kill_at_frac", "burst_start_frac", "burst_end_frac"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v!r}")
        if self.burst_end_frac < self.burst_start_frac:
            raise ValueError("burst_end_frac must be >= burst_start_frac")
        if self.priority_levels < 1:
            raise ValueError("priority_levels must be >= 1")
        if not 0 <= self.shared_prefix_len <= self.prompt_len:
            raise ValueError(
                f"shared_prefix_len must be in [0, prompt_len="
                f"{self.prompt_len}], got {self.shared_prefix_len}")


def _plan_key(plan: Optional[dict]) -> tuple:
    if plan is None or plan.get("mode") != "split":
        return ("local",)
    return ("split", tuple(plan["cuts"]), tuple(plan["hop_codecs"]))


class _IdentityVerifier:
    """Streaming identity audit: each completed record is replayed on a
    clean same-plan runtime as it drains, and only counters survive.
    ``plan_devices`` maps split plan keys to the (SplitConfig, stage
    devices) that served them (captured when each plan first serves)."""

    #: keep at most this many mismatching request ids for the artifact
    MAX_MISMATCH_IDS = 32

    def __init__(self, front: ServeFront, plan_devices: dict):
        self.front = front
        self.plan_devices = plan_devices
        self._ref_runners: dict = {}
        self.checked = 0
        self.matched = 0
        self.mismatched_ids: list = []

    def check(self, r: Any, prompt: np.ndarray, temperature: float) -> None:
        from ..parallel.split import SplitConfig, SplitRuntime

        if r.outcome != COMPLETED or r.tokens is None:
            return
        key = _plan_key(r.plan)
        if key not in self._ref_runners:
            if key[0] == "local":
                self._ref_runners[key] = None
            else:
                split, devices = self.plan_devices[key]
                clean = SplitRuntime(self.front.model_cfg,
                                     SplitConfig(cuts=split.cuts, hop_codecs=split.hop_codecs),
                                     devices)
                self._ref_runners[key] = (clean, clean.place_params(self.front.params))
        runner = self._ref_runners[key]
        rng = prng.key(0)  # the soak submits every request with seed 0
        if runner is None:
            ref = generate(self.front.model_cfg, self.front.params, prompt, r.granted_tokens,
                           capacity=r.capacity, temperature=temperature, rng_key=rng,
                           compute_dtype=self.front.compute_dtype)
        else:
            clean, placed = runner
            # the replay runs the decode algorithm the front ran (a
            # speculative front samples through residual resampling), with
            # the front's capacity bump: the record keeps the bucketed value
            spec = self.front.speculative
            spec_kw: dict = {}
            cap = r.capacity
            if spec is not None and spec.enabled:
                spec_kw = {"speculative": spec, "raw_params": self.front.params}
                cap = max(cap, prompt.shape[1] + r.granted_tokens + spec.k - 2)
            ref = generate_split(clean, placed, prompt, r.granted_tokens, capacity=cap,
                                 temperature=temperature, rng_key=rng,
                                 fault_step=r.request_id, **spec_kw)
        self.checked += 1
        if np.array_equal(np.asarray(ref.cpu()), r.tokens):
            self.matched += 1
        elif len(self.mismatched_ids) < self.MAX_MISMATCH_IDS:
            self.mismatched_ids.append(r.request_id)

    def summary(self) -> dict:
        return {"checked": self.checked, "matched": self.matched,
                "ok": self.checked == self.matched,
                "mismatched_ids": list(self.mismatched_ids)}


def run_soak(front: ServeFront, soak: SoakConfig, *, clock: FakeClock,
             burst_runtime: Any = None) -> dict:
    """Run one deterministic soak through ``front.drain`` -> the artifact
    dict (the reference's keys). ``front`` must be freshly built on
    ``clock``: the soak owns the virtual timeline, and the artifact's rates
    assume the front's records are this soak's. ``burst_runtime``: a
    same-topology split runtime with burst-level corruption, swapped in
    over the burst window (breaker state kept)."""
    if not isinstance(clock, FakeClock):
        raise TypeError("run_soak needs the front's FakeClock — the soak owns the "
                        "virtual timeline")
    rng = np.random.default_rng(soak.seed)
    n = soak.n_requests
    arrive_t = clock.now + np.cumsum(rng.exponential(1.0 / soak.arrival_rate, n))
    vocab = front.model_cfg.vocab_size
    prompts = rng.integers(0, vocab, (n, soak.prompt_len), dtype=np.int32)
    if soak.shared_prefix_len:
        # drawn AFTER the matrix, as in the reference
        prompts[:, :soak.shared_prefix_len] = rng.integers(
            0, vocab, soak.shared_prefix_len, dtype=np.int32)
    priorities = rng.integers(0, soak.priority_levels, n)

    kill_idx = int(n * soak.kill_at_frac) if soak.kill_stage is not None else None
    burst_on_idx = int(n * soak.burst_start_frac) if burst_runtime is not None else None
    burst_off_idx = int(n * soak.burst_end_frac) if burst_runtime is not None else None
    normal_rt = front.split_runtime
    failovers_at_burst_on = 0
    kill_at_s: Optional[float] = None
    burst_window_s: list = []
    first_done_after_kill: Optional[float] = None

    submitted: dict = {}       # in-flight request id -> (prompt, temperature)
    plan_devices: dict = {}    # split plan key -> (SplitConfig, stage devices)
    verifier = _IdentityVerifier(front, plan_devices) if soak.verify_identity else None
    max_call = 0               # largest retries_charged on any one record
    start_s = clock.now

    def fire_events(i: int) -> None:
        nonlocal kill_at_s, failovers_at_burst_on
        if burst_on_idx is not None and i == burst_on_idx:
            failovers_at_burst_on = front.failovers
            burst_window_s.append(clock.now)
            front.set_split_runtime(burst_runtime, keep_breakers=True)
        if burst_off_idx is not None and i == burst_off_idx:
            burst_window_s.append(clock.now)
            if front.failovers == failovers_at_burst_on:
                front.set_split_runtime(normal_rt, keep_breakers=True)
        if kill_idx is not None and i == kill_idx:
            kill_at_s = clock.now
            if front.split_runtime is not None:
                front.split_runtime.mark_stage_lost(soak.kill_stage)

    i = 0
    while i < n or front.queue_depth:
        if front.queue_depth == 0 and i < n and clock.now < arrive_t[i]:
            clock.set_time(float(arrive_t[i]))
        while i < n and arrive_t[i] <= clock.now:
            fire_events(i)
            rid, refusal = front.submit_ex(Request(
                prompt_ids=prompts[i], max_new_tokens=soak.max_new_tokens,
                priority=int(priorities[i]), deadline_s=soak.deadline_s,
                temperature=soak.temperature, rng_seed=0))
            if refusal is None:
                submitted[rid] = (prompts[i][None, :], soak.temperature)
            i += 1
        for rec in front.drain(max_requests=1):
            if rec.service_s is not None:
                clock.advance(rec.service_s)
            if rec.plan is not None and rec.plan.get("mode") == "split":
                key = _plan_key(rec.plan)
                if key not in plan_devices:
                    rt = front.split_runtime
                    plan_devices[key] = (rt.split, rt.devices)
            max_call = max(max_call, rec.retries_charged)
            if (kill_at_s is not None and rec.outcome in (COMPLETED, FAILED_OVER)
                    and rec.finished_at is not None and rec.finished_at > kill_at_s):
                first_done_after_kill = (rec.finished_at if first_done_after_kill is None
                                         else min(first_done_after_kill, rec.finished_at))
            meta = submitted.pop(rec.request_id, None)
            if verifier is not None and meta is not None:
                verifier.check(rec, meta[0], meta[1])
    span_s = max(clock.now - start_s, 1e-9)
    # recovery time: the kill -> the first request finishing cleanly after it
    recovery_s = None
    if kill_at_s is not None and first_done_after_kill is not None:
        recovery_s = first_done_after_kill - kill_at_s

    report = front.report()
    outcomes = report["outcomes"]
    budget = report["retry_budget"]
    budget_bound = budget["capacity"] + budget["refill_per_s"] * span_s + max_call
    fl = get_flight_recorder()
    return {
        "soak": dataclasses.asdict(soak),
        "virtual_span_s": span_s,
        "requests": n,
        "outcomes": outcomes,
        "goodput_tokens_per_s": report["tokens_out"] / span_s,
        "slo_attainment": report["slo_attainment"],
        "reject_rate": outcomes.get(REJECTED, 0) / n,
        "shed_rate": outcomes.get(SHED, 0) / n,
        "p99_ttft_s": (report["ttft_s"] or {}).get("p99"),
        "p99_latency_s": (report["latency_s"] or {}).get("p99"),
        "kill": (None if kill_at_s is None else
                 {"stage": soak.kill_stage, "at_s": kill_at_s, "recovery_s": recovery_s}),
        "burst": (None if not burst_window_s else
                  {"start_s": burst_window_s[0],
                   "end_s": burst_window_s[1] if len(burst_window_s) > 1 else None}),
        "retry_budget": {**budget, "max_single_call": max_call,
                         "within_budget": budget["spent"] <= budget_bound},
        "token_identity": verifier.summary() if verifier is not None else None,
        # every artifact the armed recorder wrote (one a failure instance),
        # None without a recorder
        "flight_dumps": list(fl.dumps()) if fl is not None else None,
        "report": report,
    }


# ---------------------------------------------------------------------------
# workload draws addressed by index (the cluster and disaggregated soaks)
# ---------------------------------------------------------------------------


def _draw(seed: int, i: int, salt: int) -> int:
    """One deterministic 32-bit workload draw addressed by (seed, index,
    stream): a request is regenerated from its index alone."""
    return zlib.crc32(struct.pack("<qqq", seed, i, salt)) & 0xFFFFFFFF


def _u01(seed: int, i: int, salt: int) -> float:
    return (_draw(seed, i, salt) + 0.5) / 2.0 ** 32


@dataclasses.dataclass(frozen=True)
class ClusterSoakConfig:
    """The replayable cluster-soak definition — the million-request shape.

    Prompts open with one of ``num_prefix_groups`` shared prefixes (the
    "system prompt" population the router's prefix affinity should exploit)
    followed by per-request suffix tokens. ``sampled_frac`` of requests
    sample at ``sample_temperature`` with a per-index recorded seed; the
    rest are greedy — both replay token-identically from the index.
    Chaos: ``kills`` schedules replica kills by arrival fraction,
    ``burst_start_frac``/``burst_end_frac`` bound a link-corruption window
    (``burst_corrupt_rate`` per completing request, seeded) across the
    fleet. ``goodput_bucket_s`` is the resolution of the tokens-per-virtual-
    second series the outage-window goodput gate reads."""

    n_requests: int = 1000
    arrival_rate: float = 200.0
    seed: int = 0
    vocab_size: int = 50_000
    prompt_len: int = 16
    shared_prefix_len: int = 8
    num_prefix_groups: int = 32
    max_new_tokens: int = 16
    deadline_s: Optional[float] = 120.0
    sampled_frac: float = 0.5
    sample_temperature: float = 0.7
    priority_levels: int = 2
    #: ((arrival_frac, replica_id), ...) — each kills that replica just
    #: before the request at ``floor(n * frac)`` is submitted
    kills: tuple = ()
    #: ((arrival_frac, replica_id, service_multiplier), ...) — gray
    #: failures: just before the request at ``floor(n * frac)`` is
    #: submitted, the replica starts serving every phase ``multiplier`` ×
    #: slower. Re-asserted per arrival, so a respawn inherits the slowdown
    #: — gray hardware stays gray across process restarts. Firing AFTER the
    #: fleet has warmed up captures the nasty case: prefix affinity keeps
    #: routing a slow replica's groups at it no matter how its queue grows.
    slowdowns: tuple = ()
    burst_start_frac: float = 0.0
    burst_end_frac: float = 0.0
    burst_corrupt_rate: float = 0.0
    verify_identity: bool = True
    goodput_bucket_s: float = 1.0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if self.arrival_rate <= 0:
            raise ValueError("arrival_rate must be > 0")
        if not 0 <= self.shared_prefix_len <= self.prompt_len:
            raise ValueError(
                f"shared_prefix_len must be in [0, prompt_len="
                f"{self.prompt_len}], got {self.shared_prefix_len}")
        if self.num_prefix_groups < 1:
            raise ValueError("num_prefix_groups must be >= 1")
        if not 0.0 <= self.sampled_frac <= 1.0:
            raise ValueError(
                f"sampled_frac must be in [0, 1], got {self.sampled_frac!r}")
        for f in ("burst_start_frac", "burst_end_frac"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v!r}")
        if self.burst_end_frac < self.burst_start_frac:
            raise ValueError("burst_end_frac must be >= burst_start_frac")
        if not 0.0 <= self.burst_corrupt_rate <= 1.0:
            raise ValueError(
                f"burst_corrupt_rate must be in [0, 1], got "
                f"{self.burst_corrupt_rate!r}")
        for frac, _rid in self.kills:
            if not 0.0 <= frac <= 1.0:
                raise ValueError(
                    f"kill fraction must be in [0, 1], got {frac!r}")
        for frac, _rid, mult in self.slowdowns:
            if not 0.0 <= frac <= 1.0:
                raise ValueError(
                    f"slowdown fraction must be in [0, 1], got {frac!r}")
            if mult < 1.0:
                raise ValueError(
                    f"slowdown multiplier must be >= 1, got {mult!r}")
        if self.goodput_bucket_s <= 0:
            raise ValueError("goodput_bucket_s must be > 0")
        if self.priority_levels < 1:
            raise ValueError("priority_levels must be >= 1")


def _cluster_prompt(soak: ClusterSoakConfig, i: int) -> np.ndarray:
    """Request ``i``'s prompt, regenerated from the index (never stored):
    a shared prefix drawn from one of ``num_prefix_groups`` seeded blocks +
    an affine per-request suffix."""
    h = _draw(soak.seed, i, 1)
    group = _draw(soak.seed, h % soak.num_prefix_groups, 2)
    pre = (group + 7919
           * np.arange(soak.shared_prefix_len, dtype=np.int64)
           ) % soak.vocab_size
    suf_len = soak.prompt_len - soak.shared_prefix_len
    suf = (h + 104729 * (np.arange(suf_len, dtype=np.int64) + 1)
           ) % soak.vocab_size
    return np.concatenate([pre, suf]).astype(np.int32)


def _cluster_request(soak: ClusterSoakConfig, i: int) -> Request:
    sampled = _u01(soak.seed, i, 3) < soak.sampled_frac
    return Request(
        prompt_ids=_cluster_prompt(soak, i),
        max_new_tokens=soak.max_new_tokens,
        priority=_draw(soak.seed, i, 5) % soak.priority_levels,
        deadline_s=soak.deadline_s,
        temperature=soak.sample_temperature if sampled else 0.0,
        rng_seed=_draw(soak.seed, i, 4) if sampled else 0)


def run_cluster_soak(cluster: Any, soak: ClusterSoakConfig, *,
                     clock: FakeClock) -> dict:
    """Push the seeded open-loop workload through a
    :class:`~.cluster.ClusterFront` of simulated replicas
    (each advances the shared FakeClock by its virtual service time) while
    scheduled replica kills and link-corruption bursts fire; returns the
    artifact dict.

    Memory is flat in ``n_requests``: every per-request quantity is either
    regenerated from its arrival index (prompts, temperatures, seeds — see
    :func:`_draw`) or folded into a running aggregate (outcome counts,
    log-bucketed TTFT/latency histograms, per-virtual-second goodput
    buckets) the moment its record drains. The identity audit replays each
    completed request against the pure
    :func:`~.cluster.sim_reference_tokens` chain — the
    fault-free same-plan reference — as it completes."""
    from .cluster import sim_reference_tokens

    if not isinstance(clock, FakeClock):
        raise TypeError("run_cluster_soak needs the cluster's FakeClock — "
                        "the soak owns the virtual timeline")
    n = soak.n_requests
    kill_sched = sorted((int(n * frac), int(rid))
                        for frac, rid in soak.kills)
    slow_sched = sorted((int(n * frac), int(rid), float(mult))
                        for frac, rid, mult in soak.slowdowns)
    active_slowdowns: dict = {}    # replica_id -> multiplier
    burst_on_idx = (int(n * soak.burst_start_frac)
                    if soak.burst_corrupt_rate > 0
                    and soak.burst_end_frac > soak.burst_start_frac
                    else None)
    burst_off_idx = (int(n * soak.burst_end_frac)
                     if burst_on_idx is not None else None)
    burst_active = False
    burst_window_s: list = []

    outcomes: dict = {}
    reasons: dict = {}
    tokens_out = 0
    met = with_deadline = 0
    ttft_hist = Histogram("serve_ttft_s", lo=1e-6, hi=1e4, n_buckets=400)
    latency_hist = Histogram("serve_latency_s", lo=1e-6, hi=1e4,
                             n_buckets=400)
    goodput_buckets: dict = {}     # int bucket -> tokens completed in it
    checked = matched = 0
    mismatched_ids: list = []
    pending_meta: dict = {}        # cluster rid -> arrival index (in-flight)
    kill_events: list = []         # [{replica, at_s, recovery_s}]
    start_s = clock.now

    def apply_burst() -> None:
        """(Re)assert the corruption rate on every live front — respawned
        replicas join the burst too."""
        rate = soak.burst_corrupt_rate if burst_active else 0.0
        for r in cluster.replicas.values():
            set_rate = getattr(r.front, "set_corrupt_rate", None)
            if set_rate is not None:
                set_rate(rate)

    def apply_slowdowns() -> None:
        """(Re)assert active gray-failure service multipliers — a respawned
        replica inherits its slowdown (the hardware is gray, not the
        process)."""
        for rid, mult in active_slowdowns.items():
            r = cluster.replicas.get(rid)
            if r is None or r.front is None:
                continue
            set_mult = getattr(r.front, "set_service_multiplier", None)
            if set_mult is not None:
                set_mult(mult)

    def fire_events(i: int) -> None:
        nonlocal burst_active
        while kill_sched and kill_sched[0][0] == i:
            _, rid = kill_sched.pop(0)
            cluster.kill_replica(rid, "chaos")
            kill_events.append({"replica": rid, "at_s": clock.now,
                                "recovery_s": None})
        while slow_sched and slow_sched[0][0] <= i:
            _, rid, mult = slow_sched.pop(0)
            active_slowdowns[rid] = mult
        if burst_on_idx is not None and i == burst_on_idx:
            burst_active = True
            burst_window_s.append(clock.now)
        if burst_off_idx is not None and i == burst_off_idx:
            burst_active = False
            burst_window_s.append(clock.now)

    def absorb(rec: Any) -> None:
        nonlocal tokens_out, met, with_deadline, checked, matched
        outcomes[rec.outcome] = outcomes.get(rec.outcome, 0) + 1
        if rec.reason:
            reasons[rec.reason] = reasons.get(rec.reason, 0) + 1
        idx = pending_meta.pop(rec.request_id, None)
        if rec.outcome not in (COMPLETED, FAILED_OVER):
            return
        granted = rec.granted_tokens or 0
        tokens_out += rec.batch * granted
        if rec.ttft_s is not None:
            ttft_hist.observe(rec.ttft_s)
        if rec.latency_s is not None:
            latency_hist.observe(rec.latency_s)
        if rec.deadline_s is not None and rec.deadline_met is not None:
            with_deadline += 1
            met += int(rec.deadline_met)
        if rec.finished_at is not None:
            b = int((rec.finished_at - start_s) / soak.goodput_bucket_s)
            goodput_buckets[b] = (goodput_buckets.get(b, 0)
                                  + rec.batch * granted)
            for ev in kill_events:
                if (ev["recovery_s"] is None
                        and rec.finished_at > ev["at_s"]):
                    ev["recovery_s"] = rec.finished_at - ev["at_s"]
        if (soak.verify_identity and rec.outcome == COMPLETED
                and rec.tokens is not None and idx is not None):
            ref, _ = sim_reference_tokens(
                _cluster_prompt(soak, idx), granted,
                temperature=(soak.sample_temperature
                             if _u01(soak.seed, idx, 3) < soak.sampled_frac
                             else 0.0),
                rng_seed=(_draw(soak.seed, idx, 4)
                          if _u01(soak.seed, idx, 3) < soak.sampled_frac
                          else 0),
                vocab_size=soak.vocab_size)
            checked += 1
            if np.array_equal(np.asarray(rec.tokens).reshape(-1), ref):
                matched += 1
            elif len(mismatched_ids) < 32:
                mismatched_ids.append(rec.request_id)

    i = 0
    next_t = clock.now
    while i < n or cluster.pending or cluster.busy:
        while i < n and next_t <= clock.now:
            fire_events(i)
            apply_burst()
            apply_slowdowns()
            crid = cluster.submit(_cluster_request(soak, i))
            pending_meta[crid] = i
            gap = -math.log(_u01(soak.seed, i, 0)) / soak.arrival_rate
            next_t += gap
            i += 1
        recs = cluster.drain(max_requests=8)
        for rec in recs:
            absorb(rec)
        if not recs:
            # nothing drained: jump the virtual clock to whatever happens
            # next — the next arrival or the next scheduled respawn
            targets = [next_t] if i < n else []
            ev = cluster.next_event_s()
            if ev is not None:
                targets.append(ev)
            if targets and min(targets) > clock.now:
                clock.set_time(min(targets))
            elif i >= n:
                break  # idle fleet, nothing scheduled: drained dry
    span_s = max(clock.now - start_s, 1e-9)

    report = cluster.report()

    def pct(h: Histogram, q: float) -> Optional[float]:
        return float(h.quantile(q)) if h.count else None

    return {
        "soak": dataclasses.asdict(soak),
        "virtual_span_s": span_s,
        "requests": n,
        "outcomes": outcomes,
        "reasons": reasons,
        "goodput_tokens_per_s": tokens_out / span_s,
        "slo_attainment": (met / with_deadline) if with_deadline else None,
        # fleet-level SLO: deadline-met completions over ALL submitted
        # requests, so a timed-out request counts as a miss instead of
        # silently leaving the denominator — the gray bench gates on this
        "slo_goodput": met / n,
        "reject_rate": outcomes.get(REJECTED, 0) / n,
        "shed_rate": outcomes.get(SHED, 0) / n,
        "timeout_rate": outcomes.get(TIMED_OUT, 0) / n,
        "p99_ttft_s": pct(ttft_hist, 0.99),
        "p99_latency_s": pct(latency_hist, 0.99),
        "kills": kill_events,
        "burst": (None if not burst_window_s else
                  {"start_s": burst_window_s[0],
                   "end_s": (burst_window_s[1]
                             if len(burst_window_s) > 1 else None),
                   "corrupt_rate": soak.burst_corrupt_rate}),
        "goodput_buckets": {"width_s": soak.goodput_bucket_s,
                            "tokens": goodput_buckets},
        "token_identity": {"checked": checked, "matched": matched,
                           "ok": checked == matched,
                           "mismatched_ids": mismatched_ids},
        "readmitted": report["totals"]["readmitted"],
        "recompute_tokens": report["totals"]["recompute_tokens"],
        "parked_total": report["totals"]["parked_total"],
        "hedges": report["totals"].get("hedges", 0),
        "hedge_wins": (report["totals"].get("hedge_wins_primary", 0)
                       + report["totals"].get("hedge_wins_hedge", 0)),
        "hedge_discarded": report["totals"].get("hedge_discarded", 0),
        "hedge_fraction": (report["totals"].get("hedges", 0)
                           / max(report["totals"].get("placed", 0), 1)),
        "deadline_expired": report["totals"].get("deadline_expired", 0),
        "gray": report.get("gray"),
        "respawns": sum(r["respawns"]
                        for r in report["replicas"].values()),
        "flight_dumps": cluster.flight_dumps(),
        "report": report,
    }


# ---------------------------------------------------------------------------
# the disaggregated prefill / decode chaos soak
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DisaggSoakConfig:
    """Replayable chaos soak of a :class:`~.disagg.DisaggServer` (the
    reference's fields, defaults and messages): the real server, so every
    leg of the failure matrix runs for real.

    ``kills`` fires just before request ``int(n * frac)`` is submitted;
    targets: ``"prefill"`` arms a mid-migration kill (the worker that just
    moved a page dies before its next one), ``"prefill:<i>"`` kills worker
    ``i`` now, ``"decode"`` kills the decode worker and ``"link"`` fails
    the migration link. ``[burst_start_frac, burst_end_frac)`` bounds a
    seeded bit-flip window on the link at ``burst_bitflip_rate``. The
    identity audit replays every completed request on a fault-free
    colocated batcher."""

    n_requests: int = 16
    seed: int = 0
    vocab_size: int = 128
    min_prompt_len: int = 3
    max_prompt_len: int = 18
    max_new_tokens: int = 6
    sampled_frac: float = 0.5
    sample_temperature: float = 0.7
    #: ((arrival_frac, target), ...), targets as above
    kills: tuple = ()
    burst_start_frac: float = 0.0
    burst_end_frac: float = 0.0
    burst_bitflip_rate: float = 0.0
    verify_identity: bool = True
    #: pump the server this many times between arrivals, so chaos lands on
    #: a busy front (prefills in flight, the queue non-empty)
    steps_per_arrival: int = 1

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if not 1 <= self.min_prompt_len <= self.max_prompt_len:
            raise ValueError(
                f"need 1 <= min_prompt_len <= max_prompt_len, got "
                f"[{self.min_prompt_len}, {self.max_prompt_len}]")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 0.0 <= self.sampled_frac <= 1.0:
            raise ValueError(f"sampled_frac must be in [0, 1], got {self.sampled_frac!r}")
        for f in ("burst_start_frac", "burst_end_frac"):
            if not 0.0 <= getattr(self, f) <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {getattr(self, f)!r}")
        if self.burst_end_frac < self.burst_start_frac:
            raise ValueError("burst_end_frac must be >= burst_start_frac")
        if not 0.0 <= self.burst_bitflip_rate <= 1.0:
            raise ValueError(f"burst_bitflip_rate must be in [0, 1], got "
                             f"{self.burst_bitflip_rate!r}")
        for frac, target in self.kills:
            if not 0.0 <= frac <= 1.0:
                raise ValueError(f"kill fraction must be in [0, 1], got {frac!r}")
            if target not in ("prefill", "decode", "link") and not (
                    isinstance(target, str) and target.startswith("prefill:")):
                raise ValueError(
                    f"unknown kill target {target!r}; expected 'prefill', "
                    f"'prefill:<i>', 'decode', or 'link'")
        if self.steps_per_arrival < 0:
            raise ValueError("steps_per_arrival must be >= 0")


def _disagg_request(soak: DisaggSoakConfig, i: int) -> tuple:
    """Request ``i`` regenerated from its index: (prompt, max_new_tokens,
    temperature, rng_seed)."""
    span = soak.max_prompt_len - soak.min_prompt_len + 1
    ln = soak.min_prompt_len + _draw(soak.seed, i, 11) % span
    toks = (_draw(soak.seed, i, 12) + 104729 * (np.arange(ln, dtype=np.int64) + 1)
            ) % (soak.vocab_size - 1) + 1
    sampled = _u01(soak.seed, i, 13) < soak.sampled_frac
    return (toks.astype(np.int32), soak.max_new_tokens,
            soak.sample_temperature if sampled else 0.0,
            _draw(soak.seed, i, 14) if sampled else 0)


def run_disagg_soak(server: Any, soak: DisaggSoakConfig, *,
                    reference_factory: Any = None) -> dict:
    """Drive the seeded workload through a real DisaggServer while the
    scheduled chaos fires, then audit: no accepted request lost, and every
    completed request's tokens equal to a fault-free colocated batcher's
    (``reference_factory()``). Returns the artifact (the reference's keys);
    an identity mismatch raises nothing: gate on
    ``artifact["token_identity"]["ok"]``."""
    from ..codecs.faults import FaultConfig

    n = soak.n_requests
    kill_sched = sorted(((int(n * frac), target) for frac, target in soak.kills),
                        key=lambda kv: kv[0])
    burst_on = (int(n * soak.burst_start_frac)
                if soak.burst_bitflip_rate > 0 and soak.burst_end_frac > soak.burst_start_frac
                else None)
    burst_off = int(n * soak.burst_end_frac) if burst_on is not None else None
    saved_faults = server.link.faults
    kill_events: list = []
    armed_midmig = {"want": 0}

    def page_hook(wid: int, sid: int, page: int) -> None:
        # an armed "prefill" kill fires on the worker that just moved a
        # page: it dies mid-migration, between two page transfers
        if armed_midmig["want"] > 0 and server.workers[wid].alive:
            armed_midmig["want"] -= 1
            server.kill_prefill_worker(wid)
            kill_events.append({"target": f"prefill:{wid}", "mid_migration": True,
                                "at_index": None})

    server.page_hook = page_hook

    def fire_events(i: int) -> None:
        while kill_sched and kill_sched[0][0] <= i:
            _, target = kill_sched.pop(0)
            if target == "prefill":
                armed_midmig["want"] += 1
            elif target.startswith("prefill:"):
                server.kill_prefill_worker(int(target.split(":", 1)[1]))
                kill_events.append({"target": target, "mid_migration": False,
                                    "at_index": i})
            elif target == "decode":
                server.kill_decode_worker()
                kill_events.append({"target": "decode", "mid_migration": False,
                                    "at_index": i})
            else:  # "link"
                server.fail_link()
                kill_events.append({"target": "link", "mid_migration": False,
                                    "at_index": i})
        if burst_on is not None and i == burst_on:
            server.link.faults = FaultConfig(bitflip_rate=soak.burst_bitflip_rate,
                                             seed=soak.seed + 17)
        if burst_off is not None and i == burst_off:
            server.link.faults = saved_faults

    sids = []
    for i in range(n):
        fire_events(i)
        prompt, mnt, temp, seed = _disagg_request(soak, i)
        sids.append(server.submit(prompt, mnt, temperature=temp, rng_seed=seed))
        for _ in range(soak.steps_per_arrival):
            server.step()
    if burst_off is not None and server.link.faults is not saved_faults:
        server.link.faults = saved_faults  # the window ran past the last arrival
    server.run()
    server.page_hook = None

    completed = sum(1 for s in sids if s in server.results)
    checked = matched = 0
    mismatched: list = []
    if soak.verify_identity and reference_factory is not None:
        ref = reference_factory()
        ref_ids = []
        for i in range(n):
            prompt, mnt, temp, seed = _disagg_request(soak, i)
            ref_ids.append(ref.submit(prompt, mnt, temperature=temp, rng_seed=seed))
        ref_res = ref.run()
        for i, (s, r) in enumerate(zip(sids, ref_ids)):
            if s not in server.results:
                continue
            checked += 1
            if np.array_equal(server.results[s], ref_res[r]):
                matched += 1
            elif len(mismatched) < 32:
                mismatched.append(i)

    rep = server.report()
    return {
        "soak": dataclasses.asdict(soak),
        "requests": n,
        "completed": completed,
        "accepted_lost": n - completed,
        "kills": kill_events,
        "burst": (None if burst_on is None else
                  {"start_index": burst_on, "end_index": burst_off,
                   "bitflip_rate": soak.burst_bitflip_rate}),
        "token_identity": {"checked": checked, "matched": matched, "ok": checked == matched,
                           "mismatched_indices": mismatched},
        "disagg": rep["disagg"],
        "report": rep,
    }
