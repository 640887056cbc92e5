"""Observability (PyTorch counterpart of ``edgellm_tpu/obs``): the metrics
registry, the span tracer and the per-token latency SLOs.

- :mod:`.metrics`: typed ``Counter`` / ``Gauge`` / ``Histogram``, a
  process-global named registry, Prometheus text and JSON exporters, and
  the adapters that absorb the stack's counter sources;
- :mod:`.tracing`: thread-safe spans on the clock ``torch.profiler``
  stamps its events on (µs since the Unix epoch), exported as Chrome
  trace-event JSON; a span is live while tracing is enabled or any
  ``torch.profiler`` capture records, and appears in the capture as a CPU
  range; :func:`~.tracing.device_span` also times its body on a CUDA
  stream; :func:`~.tracing.trace_capture` is the ``--profile`` capture;
- :mod:`.latency`: TTFT and per-token latency histograms for the decode
  loops, one synchronisation per sampled token;
- :mod:`.context`: the request-scoped labels spans inherit; :mod:`.names`:
  the registered metric and span names;
- :mod:`.flight`: the failure flight recorder, a bounded ring of spans and
  counter deltas dumped as a CRC-framed artifact once a typed failure;
- :mod:`.server`: the live endpoint (``/metrics``, ``/healthz``,
  ``/snapshot.json``, ``/trace``) on a loopback daemon thread.

Everything is host-side but a device span's two timing events on the
stream: with observability disabled (the default) and no capture
recording, the serve and split stacks run the same operations, with no
host sync and no extra kernel, and give the same tokens and logits; live
spans add no kernel and no sync either.
"""
from __future__ import annotations

import dataclasses

from . import context, flight, latency, metrics, names, server, tracing
from .context import TraceContext
from .flight import (FlightRecorder, configure_flight, flight_dump_for, get_flight_recorder,
                     load_flight)
from .latency import LatencyObserver
from .metrics import Counter, CounterSource, Gauge, Histogram, MetricsRegistry, get_registry
from .server import ObsServer
from .tracing import Tracer, device_span, get_tracer, span, trace_capture


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """Which pillars to arm when observability is requested (the params.json
    ``"observability"`` object and the ``--metrics-out`` / ``--trace-out``
    flags resolve to one of these); the reference's fields and defaults.
    The three pillars default on; the flight recorder and the live endpoint
    are opt-in."""

    metrics: bool = True
    tracing: bool = True
    latency: bool = True
    #: False = off; True = record into ``flight_recorder/`` under the cwd; a
    #: string names the artifact directory
    flight_recorder: bool | str = False
    #: None = no live endpoint; 0 = an OS-assigned port; else the port
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


def enable(config: ObservabilityConfig | None = None) -> None:
    """Arm the global registry and tracer per ``config`` (default:
    everything); the opt-in extras also arm the flight recorder (unless one
    is configured already) and start the live endpoint."""
    cfg = config if config is not None else ObservabilityConfig()
    metrics.get_registry().enabled = cfg.metrics
    tracing.configure(enabled=cfg.tracing)
    if cfg.flight_recorder and flight.get_flight_recorder() is None:
        out_dir = (cfg.flight_recorder if isinstance(cfg.flight_recorder, str)
                   else "flight_recorder")
        flight.configure_flight(FlightRecorder(out_dir))
    if cfg.obs_port is not None:
        server.start_global(cfg.obs_port)


def disable() -> None:
    """Back to the default: metrics and tracing off, the flight recorder
    detached, the live endpoint stopped."""
    metrics.get_registry().enabled = False
    tracing.configure(enabled=False)
    flight.configure_flight(None)
    server.stop_global()


def enabled() -> bool:
    return metrics.get_registry().enabled or tracing.tracing_enabled()


__all__ = [
    "Counter", "CounterSource", "FlightRecorder", "Gauge", "Histogram",
    "LatencyObserver", "MetricsRegistry", "ObservabilityConfig", "ObsServer",
    "TraceContext", "Tracer", "configure_flight", "context", "device_span", "disable",
    "enable", "enabled", "flight", "flight_dump_for", "get_flight_recorder",
    "get_registry", "get_tracer", "latency", "load_flight", "metrics",
    "names", "server", "span", "trace_capture", "tracing",
]
