"""The port's deterministic-schedule race harness (``edgellm_tpu_torch.lint.
schedules``, its own copy of the reference's): it finds the old
``merge_from`` shape's ABBA deadlock within two preemptions and replays it,
and it clears the port's shipped critical sections over every bounded
interleaving: ``obs/metrics.py``'s id()-ordered ``Histogram.merge_from``, a
registry ``inc`` against a snapshot scrape, and a flight-recorder append
against a dump."""
import threading

from edgellm_tpu_torch.lint.schedules import explore, instrument, run_schedule
from edgellm_tpu_torch.obs.flight import FlightRecorder, load_flight
from edgellm_tpu_torch.obs.metrics import Histogram, MetricsRegistry


def _two_histograms(sched):
    a = Histogram("a", lo=0.1, hi=10.0, n_buckets=4)
    b = Histogram("b", lo=0.1, hi=10.0, n_buckets=4)
    a.observe(1.0)
    b.observe(2.0)
    instrument(sched, a)
    instrument(sched, b)
    return a, b


def _unordered_merge(dst, src):
    """The pre-fix merge_from: source-order lock acquisition (the EG102
    seed), kept here so the deadlock stays demonstrable."""
    with dst._lock:
        with src._lock:
            dst.count += src.count
            dst.sum += src.sum


def test_harness_finds_old_merge_from_deadlock():
    def scenario(sched):
        a, b = _two_histograms(sched)
        return [lambda: _unordered_merge(a, b), lambda: _unordered_merge(b, a)]

    outcomes = explore(scenario, max_preemptions=2)
    dead = [o for o in outcomes if o.deadlocked]
    assert dead, "bounded search failed to reach the known ABBA deadlock"
    first = dead[0]
    assert set(first.blocked) == {0, 1}
    assert all(name == "Histogram._lock" for name in first.blocked.values())
    replay = run_schedule(scenario, decisions=[idx for _, idx in first.choice_points])
    assert replay.deadlocked and replay.schedule == first.schedule


def test_shipped_merge_from_is_deadlock_free():
    """obs/metrics.py's merge_from takes both locks through
    acquire_in_order: no deadlocking schedule within three preemptions,
    and every schedule conserves the observations."""
    def scenario(sched):
        a, b = _two_histograms(sched)

        def verify():
            assert a.count + b.count == 5, (a.count, b.count)

        return ([lambda: a.merge_from(b), lambda: b.merge_from(a)], verify)

    outcomes = explore(scenario, max_preemptions=3)
    assert len(outcomes) > 1
    assert not any(o.deadlocked or o.errors for o in outcomes), \
        [(o.blocked, o.errors) for o in outcomes if not o.ok]


def test_registry_inc_vs_snapshot():
    def scenario(sched):
        reg = MetricsRegistry(enabled=True)
        c = reg.counter("tl_sched_total", "seed")
        instrument(sched, reg)
        instrument(sched, c)
        seen = []

        def verify():
            def total(snap):
                vals = snap["tl_sched_total"]["values"]
                return sum(vals.values()) if isinstance(vals, dict) else vals

            assert total(reg.snapshot()) == 2.0
            assert all(total(s) in (0.0, 1.0, 2.0) for s in seen), seen

        return ([lambda: (c.inc(), c.inc()), lambda: seen.append(reg.snapshot())],
                verify)

    outcomes = explore(scenario, max_preemptions=2)
    assert len(outcomes) > 1
    assert not any(o.deadlocked or o.errors for o in outcomes), \
        [(o.blocked, o.errors) for o in outcomes if not o.ok]


def test_flight_append_vs_dump(tmp_path):
    def scenario(sched):
        rec = FlightRecorder(str(tmp_path), capacity=8)
        instrument(sched, rec)
        paths = []

        def verify():
            assert paths and load_flight(paths[-1])["reason"] == "sched_race"

        return ([lambda: rec.note_counters("race", {"n": 1}),
                 lambda: paths.append(rec.dump("sched_race"))], verify)

    outcomes = explore(scenario, max_preemptions=2)
    assert len(outcomes) > 1
    assert not any(o.deadlocked or o.errors for o in outcomes), \
        [(o.blocked, o.errors) for o in outcomes if not o.ok]


def test_self_deadlock_is_an_error_not_a_hang():
    def scenario(sched):
        class Box:
            def __init__(self):
                self._lock = threading.Lock()

        box = instrument(sched, Box())

        def hog():
            with box._lock:
                with box._lock:
                    pass

        return [hog]

    out = run_schedule(scenario)
    assert not out.deadlocked
    assert len(out.errors) == 1 and "self-deadlock" in str(out.errors[0][1])
