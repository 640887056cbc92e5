"""Observability (PyTorch counterpart of ``edgellm_tpu/obs``): the metrics
registry, the span tracer and the per-token latency SLOs.

- :mod:`.metrics`: typed ``Counter`` / ``Gauge`` / ``Histogram``, a
  process-global named registry, Prometheus text and JSON exporters, and
  the adapters that absorb the stack's counter sources;
- :mod:`.tracing`: thread-safe host spans on a monotonic clock, exported as
  Chrome trace-event JSON, and :func:`~.tracing.trace_capture`, a
  ``torch.profiler`` capture in which every span is a ``record_function``
  range;
- :mod:`.latency`: TTFT and per-token latency histograms for the decode
  loops, one synchronisation per sampled token;
- :mod:`.context`: the request-scoped labels spans inherit; :mod:`.names`:
  the registered metric and span names.

Everything is host-side: with observability disabled (the default) the
serve and split stacks run the same operations, with no host sync and no
extra kernel, and give the same tokens and logits. Still to port: the
flight recorder and the live endpoint (the ``flight_recorder`` and
``obs_port`` fields, which :func:`enable` refuses).
"""
from __future__ import annotations

import dataclasses

from . import context, latency, metrics, names, tracing
from .context import TraceContext
from .latency import LatencyObserver
from .metrics import Counter, CounterSource, Gauge, Histogram, MetricsRegistry, get_registry
from .tracing import Tracer, get_tracer, span, trace_capture

NOT_PORTED_MSG = "is not ported yet to edgellm_tpu_torch"


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """Which pillars to arm when observability is requested (the params.json
    ``"observability"`` object and the ``--metrics-out`` / ``--trace-out``
    flags resolve to one of these); the reference's fields and defaults.
    The three pillars default on; the flight recorder and the live endpoint
    are opt-in and not ported yet."""

    metrics: bool = True
    tracing: bool = True
    latency: bool = True
    #: False = off; True = record into ``flight_recorder/``; a string names
    #: the artifact directory (not ported yet)
    flight_recorder: bool | str = False
    #: None = no live endpoint; 0 = an OS-assigned port; else the port (not
    #: ported yet)
    obs_port: int | None = None

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            if f.name in ("flight_recorder", "obs_port"):
                continue
            v = getattr(self, f.name)
            if not isinstance(v, bool):
                raise ValueError(f"observability.{f.name} must be a boolean, "
                                 f"got {v!r}")
        fr = self.flight_recorder
        if not isinstance(fr, (bool, str)):
            raise ValueError(f"observability.flight_recorder must be a "
                             f"boolean or a directory path, got {fr!r}")
        p = self.obs_port
        if p is not None and (isinstance(p, bool) or not isinstance(p, int)
                              or not 0 <= p <= 65535):
            raise ValueError(f"observability.obs_port must be null or an "
                             f"integer in [0, 65535], got {p!r}")

    def unported(self) -> list:
        """The fields set to a part not ported yet (the flight recorder, the
        live endpoint)."""
        return [name for name, on in (("flight_recorder", bool(self.flight_recorder)),
                                      ("obs_port", self.obs_port is not None)) if on]


def enable(config: ObservabilityConfig | None = None) -> None:
    """Arm the global registry and tracer per ``config`` (default:
    everything). A config that asks for the flight recorder or the live
    endpoint raises: neither is ported yet."""
    cfg = config if config is not None else ObservabilityConfig()
    bad = cfg.unported()
    if bad:
        raise ValueError(f"observability.{bad[0]} {NOT_PORTED_MSG}")
    metrics.get_registry().enabled = cfg.metrics
    tracing.configure(enabled=cfg.tracing)


def disable() -> None:
    """Back to the default: metrics and tracing off."""
    metrics.get_registry().enabled = False
    tracing.configure(enabled=False)


def enabled() -> bool:
    return metrics.get_registry().enabled or tracing.tracing_enabled()


__all__ = [
    "Counter", "CounterSource", "Gauge", "Histogram", "LatencyObserver",
    "MetricsRegistry", "ObservabilityConfig", "TraceContext", "Tracer",
    "context", "disable", "enable", "enabled", "get_registry", "get_tracer",
    "latency", "metrics", "names", "span", "trace_capture", "tracing",
]
