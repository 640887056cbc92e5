"""The soak definition of ``edgellm_tpu/serve/soak.py``: :class:`SoakConfig`,
which the serve CLI reads from ``serving.soak`` (seeded open-loop arrivals,
prompt shape, shared system prompt, deadline, temperature). ``run_soak`` and
its identity verifier drive the per-request route and are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SoakConfig"]


@dataclasses.dataclass(frozen=True)
class SoakConfig:
    """The replayable soak definition. ``arrival_rate`` is requests per
    virtual second; ``deadline_s`` applies to every request (None = best
    effort); ``shared_prefix_len`` opens every prompt with the same seeded
    token block (a system prompt). The chaos fields (``kill_stage``, the
    burst window) and ``verify_identity`` belong to ``run_soak``."""

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
