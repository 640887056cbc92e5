"""The part of ``edgellm_tpu/serve/recovery.py`` the continuous batcher and
the serving front import: the typed failure errors and the per-step
:class:`Watchdog`. ``DecodeCheckpoint``, ``LocalRuntime`` and the survivable
decode loop are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..models.paged_kv import KVTierMismatchError
from ..utils.clock import MONOTONIC, Clock

__all__ = ["CheckpointError", "CheckpointTierMismatchError", "DecodeTimeout",
           "StageLostError", "Watchdog"]


class CheckpointError(RuntimeError):
    """A decode checkpoint could not be written or restored."""


class CheckpointTierMismatchError(KVTierMismatchError, CheckpointError):
    """A checkpoint's KV pages are at another ``kv_codec`` tier than the
    restoring pool (both audiences catch it; restore never transcodes)."""


class DecodeTimeout(TimeoutError):
    """The host-side watchdog deadline expired mid-loop."""


class StageLostError(RuntimeError):
    """A pipeline stage is dark: every call into the runtime fails until the
    caller fails over."""

    def __init__(self, stage: int):
        super().__init__(
            f"pipeline stage {stage} is dark (marked lost); fail over to a "
            f"re-planned runtime or restore from a checkpoint")
        self.stage = int(stage)


class Watchdog:
    """Per-step deadline on a monotonic clock. ``check`` at loop boundaries
    re-arms within the deadline; past it, it runs ``checkpoint_fn`` (errors
    swallowed) and raises :class:`DecodeTimeout`."""

    def __init__(self, deadline_s: float, clock: Clock = MONOTONIC):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self._clock = clock
        self._armed_at: Optional[float] = None

    def arm(self) -> None:
        self._armed_at = self._clock()

    def expired(self) -> bool:
        return (self._armed_at is not None
                and self._clock() - self._armed_at > self.deadline_s)

    def check(self, checkpoint_fn: Optional[Callable[[], None]] = None,
              what: str = "decode step") -> None:
        if self._armed_at is None:
            self.arm()
            return
        elapsed = self._clock() - self._armed_at
        if elapsed <= self.deadline_s:
            self.arm()
            return
        if checkpoint_fn is not None:
            try:
                checkpoint_fn()
            except Exception:  # noqa: BLE001 — best-effort by contract
                pass
        raise DecodeTimeout(
            f"{what} exceeded the {self.deadline_s:g}s deadline "
            f"(elapsed {elapsed:.3f}s); a best-effort checkpoint was "
            f"attempted — resume from it instead of re-running")
