"""The live telemetry endpoint (PyTorch counterpart of
``edgellm_tpu/obs/server.py``): a stdlib ``http.server`` on a daemon thread
serving the obs state while a run is in flight.

- ``/metrics``: the registry's Prometheus text (``text/plain;
  version=0.0.4``);
- ``/healthz``: a JSON liveness summary, the serve front's
  ``health_summary`` when one is attached (``{"status": "ok"}`` without),
  ``{"status": "error", ...}`` when that provider raises;
- ``/snapshot.json``: the registry's JSON snapshot, and the flight
  recorder's live rings when one is configured;
- ``/trace``: the tracer's Chrome trace so far;
- anything else: 404.

The server binds ``127.0.0.1`` (``port=0``: the OS picks), silences request
logging, counts every scrape in ``edgellm_obs_scrapes_total`` and builds
each body from one snapshot under the collectors' own locks.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from . import flight as _flight
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["ObsServer", "get_global", "start_global", "stop_global"]

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObsServer:
    """One background HTTP server over the (default: global) obs state."""

    def __init__(self, port: int = 0, *, host: str = "127.0.0.1",
                 registry: Optional["_metrics.MetricsRegistry"] = None,
                 tracer: Optional["_tracing.Tracer"] = None,
                 health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 flight: Optional["_flight.FlightRecorder"] = None) -> None:
        self._registry = registry
        self._tracer = tracer
        self.health_fn = health_fn
        self._flight = flight
        self._host = host
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # resolved at each request, so a server started before obs.enable()
    # serves the armed global collectors
    def _reg(self) -> "_metrics.MetricsRegistry":
        return self._registry or _metrics.get_registry()

    def _trc(self) -> "_tracing.Tracer":
        return self._tracer or _tracing.get_tracer()

    def _fl(self) -> Optional["_flight.FlightRecorder"]:
        return self._flight or _flight.get_flight_recorder()

    @property
    def port(self) -> Optional[int]:
        """The bound port (``port=0`` resolved), or None before start()."""
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        return f"http://{self._host}:{self.port}" if self._httpd else None

    # -- endpoint bodies ----------------------------------------------------

    def _count_scrape(self, endpoint: str) -> None:
        reg = self._reg()
        if reg.enabled:
            reg.counter("edgellm_obs_scrapes_total",
                        "live-endpoint scrapes served").inc(endpoint=endpoint)

    def render(self, path: str) -> Optional[tuple]:
        """(status, content type, body bytes) of one GET; None: 404."""
        if path == "/metrics":
            self._count_scrape("metrics")
            return 200, _PROM_CONTENT_TYPE, self._reg().to_prometheus().encode("utf-8")
        if path == "/healthz":
            self._count_scrape("healthz")
            health: Dict[str, Any] = {"status": "ok"}
            if self.health_fn is not None:
                try:
                    health = dict(self.health_fn())
                except Exception as e:  # the provider broke: report it, stay up
                    health = {"status": "error", "error": repr(e)}
            return 200, "application/json", json.dumps(
                health, sort_keys=True, default=repr).encode("utf-8")
        if path == "/snapshot.json":
            self._count_scrape("snapshot")
            snap: Dict[str, Any] = {"metrics": json.loads(self._reg().to_json())}
            fl = self._fl()
            if fl is not None:
                snap["flight"] = fl.snapshot()
            return 200, "application/json", json.dumps(
                snap, sort_keys=True, default=repr).encode("utf-8")
        if path == "/trace":
            self._count_scrape("trace")
            return 200, "application/json", json.dumps(
                self._trc().to_chrome_trace()).encode("utf-8")
        return None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server's API)
                try:
                    out = server.render(self.path.split("?", 1)[0])
                except Exception as e:  # a scrape never kills the thread
                    body = repr(e).encode("utf-8")
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if out is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                status, ctype, body = out
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:
                pass  # the serve loop owns stdout

        self._httpd = ThreadingHTTPServer((self._host, self._requested_port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        name="edgellm-obs-server", daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None


_SERVER: Optional[ObsServer] = None


def start_global(port: int, **kwargs: Any) -> ObsServer:
    """Start (or return) the process-global server: the ``--obs-port`` and
    ``"observability": {"obs_port": ...}`` path."""
    global _SERVER
    if _SERVER is None:
        _SERVER = ObsServer(port, **kwargs)
        _SERVER.start()
    return _SERVER


def get_global() -> Optional[ObsServer]:
    """The running process-global server, or None (a serve front built
    later attaches its health provider to it)."""
    return _SERVER


def stop_global() -> None:
    global _SERVER
    if _SERVER is not None:
        _SERVER.stop()
        _SERVER = None
