"""Deterministic-schedule race harness: threadlint's dynamic side (the
reference's ``edgellm_tpu/lint/schedules.py``; pure Python, kept as the
port's own copy).

The static rules (EG101-EG104) prove lock discipline; this module
*executes* the discovered critical sections under controlled thread
interleavings, so a racy schedule is a replayable artifact instead of a
once-a-month CI flake.

How it works: scenario threads run under a cooperative scheduler that
allows exactly ONE thread to run at a time.  Locks are replaced
(``instrument(sched, obj, "_lock")``) with :class:`SchedLock`, whose
``acquire``/``release`` yield control back to the scheduler at every
boundary — each yield is a *choice point* where any runnable thread may
be scheduled next.  A schedule is the sequence of choices, so:

- **Replay**: ``run_schedule(make_scenario, decisions=[1, 0, ...])``
  replays one exact interleaving (decisions index the runnable set at
  each choice point).
- **Deadlock as a value**: when no thread is runnable but some are
  blocked on locks, the run returns ``Outcome(deadlocked=True)`` with
  the tid -> lock wait map — no timeouts, no hangs.
- **Exhaustive bounded search**: :func:`explore` enumerates schedules by
  iterative context bounding (branch on every choice point, bounding the
  number of *preemptions* — switches away from a still-runnable
  thread), the Musuvathi/Qadeer CHESS result that most real races and
  deadlocks show up within 2 preemptions.

The EG102 ``Histogram.merge_from`` cross-merge deadlock is reachable
here in a 2-thread, 2-preemption search pre-fix, and provably absent
from the full bounded interleaving set post-fix (see
``tests/test_torch_lint_schedules.py``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple, Union)

__all__ = ["SchedLock", "Scheduler", "Outcome", "run_schedule", "explore",
           "instrument"]

#: harness self-defence: a cv.wait longer than this means the harness
#: itself (not the scenario) wedged — raise instead of hanging the test
_WAIT_S = 30.0
#: runaway-scenario guard: more yields than this in one run is a bug
_MAX_STEPS = 20_000

Scenario = Union[Sequence[Callable[[], None]],
                 Tuple[Sequence[Callable[[], None]], Callable[[], None]]]


class _Abandon(BaseException):
    """Raised inside parked workers to unwind them after a verdict."""


@dataclass
class Outcome:
    """Result of running one scenario under one schedule."""
    deadlocked: bool
    errors: List[Tuple[int, BaseException]]
    blocked: Dict[int, str]                      # tid -> lock name waited on
    schedule: List[int]                          # chosen tid per step
    choice_points: List[Tuple[Tuple[int, ...], int]]  # (runnable tids, idx)

    @property
    def ok(self) -> bool:
        return not self.deadlocked and not self.errors


class _Worker:
    __slots__ = ("tid", "fn", "thread", "state", "waiting_on", "error")

    def __init__(self, tid: int, fn: Callable[[], None]) -> None:
        self.tid = tid
        self.fn = fn
        self.thread: Optional[threading.Thread] = None
        self.state = "new"            # new|ready|running|blocked|done
        self.waiting_on: Optional["SchedLock"] = None
        self.error: Optional[BaseException] = None


class SchedLock:
    """Drop-in for ``threading.Lock`` whose acquire/release are scheduler
    yield points.  Non-reentrant, like the real thing.  Compatible with
    ``acquire_in_order`` (plain acquire/release, stable ``id()``)."""

    def __init__(self, sched: "Scheduler", name: str) -> None:
        self._sched = sched
        self.name = name
        self._owner: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._sched._lock_acquire(self)
        return True

    def release(self) -> None:
        self._sched._lock_release(self)

    def locked(self) -> bool:
        return self._owner is not None

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class Scheduler:
    """Cooperative turn-passing scheduler: one runnable thread at a time,
    every lock boundary a choice point."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._workers: List[_Worker] = []
        self._turn: Optional[int] = None
        self._abandoned = False
        self._local = threading.local()

    # -- worker side --------------------------------------------------------

    def _current(self) -> Optional[_Worker]:
        tid = getattr(self._local, "tid", None)
        return self._workers[tid] if tid is not None else None

    def _park(self, me: _Worker, state: str,
              waiting_on: Optional[SchedLock] = None) -> None:
        """Give up the turn and wait to be scheduled again.  Caller must
        NOT hold self._cv."""
        with self._cv:
            me.state = state
            me.waiting_on = waiting_on
            self._turn = None
            self._cv.notify_all()
            while self._turn != me.tid:
                if self._abandoned:
                    raise _Abandon()
                if not self._cv.wait(_WAIT_S):
                    raise RuntimeError(
                        f"schedule harness wedged: worker {me.tid} waited "
                        f">{_WAIT_S}s for a turn")
            me.state = "running"
            me.waiting_on = None

    def _lock_acquire(self, lock: SchedLock) -> None:
        me = self._current()
        if me is None:
            # main thread touching an instrumented object outside run():
            # single-threaded by construction, just take the lock
            lock._owner = -1
            return
        self._park(me, "ready")          # pre-acquire preemption point
        while True:
            with self._cv:
                if lock._owner == me.tid:
                    raise RuntimeError(
                        f"self-deadlock: worker {me.tid} re-acquired "
                        f"non-reentrant {lock.name}")
                if lock._owner is None:
                    lock._owner = me.tid
                    return
            self._park(me, "blocked", waiting_on=lock)

    def _lock_release(self, lock: SchedLock) -> None:
        me = self._current()
        if me is None:
            lock._owner = None
            return
        with self._cv:
            lock._owner = None
        self._park(me, "ready")          # post-release preemption point

    def _worker_main(self, worker: _Worker) -> None:
        self._local.tid = worker.tid
        try:
            self._park(worker, "ready")  # all workers park before step 0
            worker.fn()
        except _Abandon:
            pass
        except BaseException as e:       # noqa: BLE001 - reported in Outcome
            worker.error = e
        finally:
            with self._cv:
                worker.state = "done"
                if self._turn == worker.tid:
                    self._turn = None
                self._cv.notify_all()

    # -- controller side ----------------------------------------------------

    def _runnable(self) -> List[int]:
        out = []
        for w in self._workers:
            if w.state == "ready":
                out.append(w.tid)
            elif (w.state == "blocked" and w.waiting_on is not None
                  and w.waiting_on._owner is None):
                out.append(w.tid)
        return out

    def run(self, fns: Sequence[Callable[[], None]],
            decisions: Sequence[int] = ()) -> Outcome:
        """Run ``fns`` as scheduler-controlled threads under one schedule.

        ``decisions[i]`` picks (by index into the sorted runnable set) the
        thread scheduled at choice point ``i``; once decisions run out the
        default policy keeps the previous thread running when it can
        (fewest preemptions first).
        """
        self._workers = [_Worker(tid, fn) for tid, fn in enumerate(fns)]
        for w in self._workers:
            w.thread = threading.Thread(
                target=self._worker_main, args=(w,),
                name=f"sched-worker-{w.tid}", daemon=True)
            w.thread.start()

        schedule: List[int] = []
        choice_points: List[Tuple[Tuple[int, ...], int]] = []
        deadlocked = False
        blocked: Dict[int, str] = {}
        prev: Optional[int] = None
        step = 0
        with self._cv:
            while True:
                while (self._turn is not None
                       or any(w.state in ("new", "running")
                              for w in self._workers)):
                    if not self._cv.wait(_WAIT_S):
                        raise RuntimeError(
                            "schedule harness wedged waiting for workers "
                            "to park")
                if all(w.state == "done" for w in self._workers):
                    break
                runnable = self._runnable()
                if not runnable:
                    deadlocked = True
                    blocked = {
                        w.tid: w.waiting_on.name
                        for w in self._workers
                        if w.state == "blocked" and w.waiting_on is not None}
                    break
                idx = decisions[step] if step < len(decisions) else None
                if idx is None or not (0 <= idx < len(runnable)):
                    idx = (runnable.index(prev) if prev in runnable else 0)
                chosen = runnable[idx]
                choice_points.append((tuple(runnable), idx))
                schedule.append(chosen)
                prev = chosen
                step += 1
                if step > _MAX_STEPS:
                    raise RuntimeError(
                        f"scenario exceeded {_MAX_STEPS} schedule steps")
                self._turn = chosen
                self._cv.notify_all()
            # verdict reached: unwind any parked workers
            self._abandoned = True
            self._cv.notify_all()
        for w in self._workers:
            assert w.thread is not None
            w.thread.join(timeout=_WAIT_S)
        errors = [(w.tid, w.error) for w in self._workers
                  if w.error is not None]
        return Outcome(deadlocked=deadlocked, errors=errors, blocked=blocked,
                       schedule=schedule, choice_points=choice_points)


def instrument(sched: Scheduler, obj: Any, attr: str = "_lock") -> Any:
    """Replace ``obj.<attr>`` with a scheduler-controlled lock."""
    setattr(obj, attr, SchedLock(sched, f"{type(obj).__name__}.{attr}"))
    return obj


def run_schedule(make_scenario: Callable[[Scheduler], Scenario],
                 decisions: Sequence[int] = ()) -> Outcome:
    """Build a fresh scenario and run it under one schedule.

    ``make_scenario(sched)`` must construct fresh objects, instrument
    their locks, and return either a list of thread bodies or a
    ``(bodies, verify)`` tuple; ``verify()`` runs after an ok schedule
    (raise/assert inside it to fail the test)."""
    sched = Scheduler()
    scenario = make_scenario(sched)
    verify: Optional[Callable[[], None]] = None
    if (isinstance(scenario, tuple) and len(scenario) == 2
            and callable(scenario[1])):
        fns, verify = scenario[0], scenario[1]
    else:
        fns = scenario  # type: ignore[assignment]
    outcome = sched.run(list(fns), decisions=decisions)
    if outcome.ok and verify is not None:
        verify()
    return outcome


def _preemptions(
        choice_points: Sequence[Tuple[Tuple[int, ...], int]]) -> int:
    count = 0
    prev: Optional[int] = None
    for runnable, idx in choice_points:
        chosen = runnable[idx]
        if prev is not None and prev != chosen and prev in runnable:
            count += 1
        prev = chosen
    return count


def explore(make_scenario: Callable[[Scheduler], Scenario],
            max_preemptions: int = 2,
            max_schedules: int = 2000) -> List[Outcome]:
    """Iterative-context-bounded exhaustive exploration.

    Runs the scenario under every schedule whose preemption count is
    <= ``max_preemptions`` (deduplicated by decision prefix), up to
    ``max_schedules`` runs.  Returns every Outcome; callers assert
    ``not any(o.deadlocked for o in outcomes)`` (or hunt for one).
    """
    results: List[Outcome] = []
    seen: Set[Tuple[int, ...]] = set()
    frontier: List[Tuple[int, ...]] = [()]
    while frontier and len(results) < max_schedules:
        prefix = frontier.pop()
        if prefix in seen:
            continue
        seen.add(prefix)
        out = run_schedule(make_scenario, decisions=prefix)
        results.append(out)
        base = [idx for _, idx in out.choice_points]
        for i in range(len(prefix), len(out.choice_points)):
            runnable, chosen_idx = out.choice_points[i]
            for alt in range(len(runnable)):
                if alt == chosen_idx:
                    continue
                cand = tuple(base[:i]) + (alt,)
                if cand in seen:
                    continue
                hypo = list(out.choice_points[:i]) + [(runnable, alt)]
                if _preemptions(hypo) <= max_preemptions:
                    frontier.append(cand)
    return results
