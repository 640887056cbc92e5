"""Host-side span tracing: nested spans on a monotonic clock, exported as
Chrome trace-event JSON (load the file at https://ui.perfetto.dev), bridged
into ``torch.profiler`` so host spans line up with the device timeline
(PyTorch counterpart of ``edgellm_tpu/obs/tracing.py``).

- **Thread-safe, nesting-aware.** Each thread keeps its own open-span stack
  (``threading.local``); finished spans append to one locked list. Chrome's
  viewer infers nesting from ``ts`` / ``dur`` on the same ``tid``, which the
  per-thread stack discipline guarantees.
- **Disabled is near-free.** :func:`span` hands back a shared
  ``nullcontext`` when tracing is off: no allocation, no clock read, no
  lock. The serve loops call it unconditionally.
- **Device bridge.** While a :func:`trace_capture` runs, each span also
  enters ``torch.profiler.record_function(name)``, so the capture's trace
  shows the host spans as ranges beside the kernels they launched. Outside
  a capture the bridge is not entered (a ``record_function`` costs a
  dispatcher call even with no profiler listening).
- **trace_capture(dir)** runs a ``torch.profiler`` capture (CPU and, where
  a card is present, CUDA activities) around its body and writes its
  Chrome trace into ``dir``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from . import context as _context
from ..utils.concurrency import guarded_by

__all__ = [
    "Span", "Tracer", "capture_active", "configure", "get_tracer", "span",
    "trace_capture", "tracing_enabled",
]


class Span:
    """One finished (or open) span: name, µs timestamps, attributes."""

    __slots__ = ("name", "ts_us", "dur_us", "tid", "args")

    def __init__(self, name: str, ts_us: float, tid: int,
                 args: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.ts_us = ts_us
        self.dur_us: float = 0.0
        self.tid = tid
        self.args: Dict[str, Any] = dict(args) if args else {}

    def to_event(self) -> Dict[str, Any]:
        """Chrome trace-event 'X' (complete) event."""
        ev: Dict[str, Any] = {"name": self.name, "ph": "X",
                              "ts": self.ts_us, "dur": self.dur_us,
                              "pid": os.getpid(), "tid": self.tid}
        if self.args:
            ev["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                              else repr(v)) for k, v in self.args.items()}
        return ev


#: the directory of the torch.profiler capture running now, or None
_CAPTURE: Dict[str, Optional[str]] = {"dir": None}


def capture_active() -> bool:
    """True while :func:`trace_capture` records."""
    return _CAPTURE["dir"] is not None


def _device_annotation(name: str) -> contextlib.AbstractContextManager:
    if not capture_active():
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


@guarded_by("_lock", fields=["_spans"])
class Tracer:
    """Collects spans process-wide; one instance behind :func:`get_tracer`."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._stack = threading.local()
        self._t0 = time.monotonic()
        #: closed-span hook; exceptions are swallowed (observation must
        #: never take serving down)
        self._sink: Optional[Callable[[Span], None]] = None

    def _now_us(self) -> float:
        return (time.monotonic() - self._t0) * 1e6

    def set_sink(self, sink: Optional[Callable[[Span], None]]) -> None:
        self._sink = sink

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Optional[Span]]:
        if not self.enabled:
            yield None
            return
        stack = getattr(self._stack, "open", None)
        if stack is None:
            stack = self._stack.open = []
        labels = _context.current_labels()
        if labels:  # ambient request labels; explicit span kwargs win
            labels.update(attrs)
            attrs = labels
        s = Span(name, self._now_us(), threading.get_ident(), attrs)
        stack.append(s)
        try:
            with _device_annotation(name):
                yield s
        finally:
            s.dur_us = self._now_us() - s.ts_us
            stack.pop()
            with self._lock:
                self._spans.append(s)
            sink = self._sink
            if sink is not None:
                try:
                    sink(s)
                except Exception:  # pragma: no cover - defensive
                    pass

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Perfetto-loadable trace object."""
        with self._lock:
            events = [s.to_event() for s in self._spans]
        events.sort(key=lambda e: (e["tid"], e["ts"]))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        """Write the Chrome trace-event JSON atomically (.part -> rename)."""
        tmp = path + ".part"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
        os.replace(tmp, path)


_TRACER = Tracer()
_NULL = contextlib.nullcontext()  # shared: span() when disabled allocates nothing


def get_tracer() -> Tracer:
    return _TRACER


def configure(*, enabled: bool) -> None:
    _TRACER.enabled = enabled


def tracing_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **attrs: Any) -> contextlib.AbstractContextManager:
    """Module-level span on the global tracer; the form call sites use::

        with obs.span("decode.checkpoint_write", step=k):
            ...
    """
    if not _TRACER.enabled:
        return _NULL
    return _TRACER.span(name, **attrs)


@contextlib.contextmanager
def trace_capture(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` run of the body into ``log_dir`` (None:
    a no-op): CPU activity, and CUDA activity where a card is present, with
    every span opened meanwhile as a ``record_function`` range. The Chrome
    trace lands in ``log_dir/torch_trace.json`` when the body ends, also
    when it raises. A capture inside a capture raises."""
    if not log_dir:
        yield
        return
    if capture_active():
        raise RuntimeError(f"a trace capture into {_CAPTURE['dir']} is already running")
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    _CAPTURE["dir"] = log_dir
    try:
        yield
    finally:
        _CAPTURE["dir"] = None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "torch_trace.json"))
