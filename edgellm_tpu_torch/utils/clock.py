"""One clock protocol for every host-side time consumer (the reference's
``edgellm_tpu/utils/clock.py``): a clock is a zero-arg callable returning
monotonic seconds.

- :class:`Clock`: the protocol; :data:`MONOTONIC` is ``time.monotonic``.
- :class:`FakeClock`: the deterministic double. It starts at 0.0 (or
  ``start``) and moves only by :meth:`~FakeClock.advance` /
  :meth:`~FakeClock.set_time`, never backwards. The serve CLI runs its
  seeded arrivals on one.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

__all__ = ["Clock", "MONOTONIC", "FakeClock"]


@runtime_checkable
class Clock(Protocol):
    """Zero-arg callable returning monotonic seconds."""

    def __call__(self) -> float: ...


#: the production clock: monotonic, immune to wall-clock steps
MONOTONIC: Clock = time.monotonic


class FakeClock:
    """A clock that only moves when told to."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a monotonic clock by {dt}")
        self._now += float(dt)
        return self._now

    def set_time(self, t: float) -> float:
        if t < self._now:
            raise ValueError(
                f"cannot move a monotonic clock backwards "
                f"({self._now} -> {t}); use a fresh FakeClock")
        self._now = float(t)
        return self._now

