"""Per-token latency SLOs for the decode loops: TTFT and inter-token
latency histograms, measured without serializing the launch stream
(PyTorch counterpart of ``edgellm_tpu/obs/latency.py``).

CUDA launches return before the card finishes, so a host clock around each
step measures *enqueue* latency, and a synchronisation after every
operation would serialize the stream the decode loop keeps deep. The
boundary is the **sampled token**: the (B,) token tensor each step must
produce before the next step embeds it. :meth:`LatencyObserver.token`
synchronises once on exactly that tensor's device, one sync per sampled
token and never one per operation, so the latency it records is the
token's wall clock.

``generate`` / ``generate_split`` accept ``observe=LatencyObserver(...)``;
with ``observe=None`` (the default) the loops are untouched.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

from . import metrics as _metrics

__all__ = ["LatencyObserver"]


def _block(x: Any) -> None:
    """Wait until the sampled token exists: one synchronisation of its CUDA
    device; a CPU tensor or a host array is already there."""
    import torch

    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class LatencyObserver:
    """Accumulates TTFT and per-token latency for one or more generate calls.

    Protocol (driven by the decode loops):

    - :meth:`start` at the top of a call, before the prefill;
    - :meth:`first_token` with the prefill-sampled token: waits for it,
      records time-to-first-token;
    - :meth:`token` with each decode step's sampled token: waits for it,
      records the inter-token gap;
    - :meth:`summary` for the ``{ttft_s, p50/p95/p99, ...}`` dict the
      caller folds into ``stats``; :meth:`publish` mirrors both histograms
      into the global registry (gated on ``registry.enabled``).

    Histograms span 10µs-100s with ~3%-wide log buckets.
    """

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None) -> None:
        self._registry = registry
        self._ttft = _metrics.Histogram(
            "edgellm_decode_ttft_seconds",
            "prefill start to first sampled token",
            lo=1e-5, hi=1e2, n_buckets=480)
        self._tok = _metrics.Histogram(
            "edgellm_decode_token_latency_seconds",
            "gap between consecutive sampled tokens",
            lo=1e-5, hi=1e2, n_buckets=480)
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None

    def start(self) -> None:
        self._t_start = time.monotonic()
        self._t_last = None

    def first_token(self, sampled: Any) -> None:
        _block(sampled)
        now = time.monotonic()
        if self._t_start is not None:
            self._ttft.observe(now - self._t_start)
        self._t_last = now

    def token(self, sampled: Any) -> None:
        _block(sampled)
        now = time.monotonic()
        if self._t_last is not None:
            self._tok.observe(now - self._t_last)
        self._t_last = now

    @property
    def ttft(self) -> _metrics.Histogram:
        return self._ttft

    @property
    def token_latency(self) -> _metrics.Histogram:
        return self._tok

    def summary(self) -> Dict[str, float]:
        """The SLO block ``generate`` folds into its stats dict."""
        out: Dict[str, float] = {}
        tp = self._ttft.percentiles()
        if self._ttft.count:
            out["ttft_s"] = tp["mean"]
            out["ttft_p50_s"] = tp["p50"]
        kp = self._tok.percentiles()
        if self._tok.count:
            out["token_latency_p50_s"] = kp["p50"]
            out["token_latency_p95_s"] = kp["p95"]
            out["token_latency_p99_s"] = kp["p99"]
            out["token_latency_mean_s"] = kp["mean"]
            if kp["mean"] and not math.isnan(kp["mean"]):
                out["tokens_per_s_observed"] = 1.0 / kp["mean"]
        return out

    def publish(self) -> None:
        """Mirror the private histograms into the (global or injected)
        registry, so exporters and ``--metrics-out`` see them; a disabled
        registry records nothing."""
        reg = (self._registry if self._registry is not None
               else _metrics.get_registry())
        if not reg.enabled:
            return
        for h in (self._ttft, self._tok):
            dst = reg.histogram(h.name, h.help, lo=h.edges[1],
                                hi=h.edges[-1],
                                n_buckets=len(h.edges) - 2)
            if dst is not h:
                dst.merge_from(h)
