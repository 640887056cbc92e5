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
from that replay, in the reference as in the port. Not ported: the flight
recorder (the artifact's ``flight_dumps`` is None).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ..utils import prng
from ..utils.clock import FakeClock
from .decode import generate, generate_split
from .frontend import Request, ServeFront
from .overload import COMPLETED, FAILED_OVER, REJECTED, SHED

__all__ = ["SoakConfig", "run_soak"]


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
        "flight_dumps": None,
        "report": report,
    }
