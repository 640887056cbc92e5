"""Host-side span tracing: nested spans on the clock ``torch.profiler``
stamps its events on, exported as Chrome trace-event JSON (load the file at
https://ui.perfetto.dev) and seen in any ``torch.profiler`` capture as CPU
ranges (PyTorch counterpart of ``edgellm_tpu/obs/tracing.py``).

- **Thread-safe, nesting-aware.** Each thread keeps its own open-span stack
  (``threading.local``); finished spans append to one locked list. Chrome's
  viewer infers nesting from ``ts`` / ``dur`` on the same ``tid``, which the
  per-thread stack discipline guarantees.
- **Live while observed.** A span is live while tracing is enabled or a
  ``torch.profiler`` capture records in the process: :func:`trace_capture`
  (``--profile``), a benchmark's traced slice or an operator's own capture.
  A live span is kept by the tracer. With nothing live, :func:`span` and
  :func:`device_span` hand back a shared ``nullcontext``: one flag read, no
  allocation, no clock read, no lock. The serve loops call them
  unconditionally.
- **The capture's clock.** ``ts`` is µs since the Unix epoch, read from the
  monotonic clock anchored to the epoch once at import: the base the
  profiler stamps its events on, so a span's ``ts`` in the export and its
  range in the capture's trace agree.
- **CPU ranges only.** While a capture records, a live span also opens a
  function-scope profiler range of its name (``_RecordFunctionFast``).
  Never a user annotation: the profiler mirrors those as device-side rows,
  which would change the capture's device operations.
- **Device time.** :func:`device_span` on a CUDA device also records a
  timing event on the device's current stream at entry and at exit;
  :attr:`Span.device_ms` reads the time between them when it is read (the
  exporter, a reader, the flight recorder), never synchronising: None until
  the card has passed the exit event, and None off CUDA.
- **trace_capture(dir)** runs a ``torch.profiler`` capture (CPU and, where
  a card is present, CUDA activities) around its body and writes its
  Chrome trace into ``dir``.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from . import context as _context
from ..utils.concurrency import guarded_by

__all__ = [
    "Span", "Tracer", "configure", "device_span", "get_tracer", "span",
    "trace_capture", "tracing_enabled",
]

#: Unix-epoch ns at monotonic ns 0, read once: the profiler's event base
_EPOCH_NS = time.time_ns() - time.monotonic_ns()


def _now_us() -> float:
    return (_EPOCH_NS + time.monotonic_ns()) / 1e3


def _capturing() -> bool:
    """True while a ``torch.profiler`` capture records in this process
    (the profiler's own flag; False where torch is not loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def _cpu_range(name: str) -> contextlib.AbstractContextManager:
    """A function-scope profiler range: a CPU event of the capture with no
    device-side row."""
    import torch

    return torch._C._profiler._RecordFunctionFast(name)


def _cuda_stream(device):
    """The current stream of ``device`` (a torch device or a device string)
    when it is a CUDA device, else None."""
    if device is None:
        return None
    import torch

    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def _timing_event(stream):
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class Span:
    """One finished (or open) span: name, µs timestamps on the Unix-epoch
    clock, attributes, and for a device span its stream's timing events."""

    __slots__ = ("name", "ts_us", "dur_us", "tid", "args", "_events", "_device_ms")

    def __init__(self, name: str, ts_us: float, tid: int,
                 args: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.ts_us = ts_us
        self.dur_us: float = 0.0
        self.tid = tid
        self.args: Dict[str, Any] = dict(args) if args else {}
        self._events: Optional[tuple] = None
        self._device_ms: Optional[float] = None

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's entry and exit on its device's
        stream; None for a host span, off CUDA, or while the card has not
        passed the exit event (an event query, never a synchronisation)."""
        if self._device_ms is None and self._events is not None:
            start, end = self._events
            if end.query():
                self._device_ms = start.elapsed_time(end)
                self._events = None
        return self._device_ms

    def to_event(self) -> Dict[str, Any]:
        """Chrome trace-event 'X' (complete) event."""
        ev: Dict[str, Any] = {"name": self.name, "ph": "X",
                              "ts": self.ts_us, "dur": self.dur_us,
                              "pid": os.getpid(), "tid": self.tid}
        args = dict(self.args)
        if self.device_ms is not None:
            args["device_ms"] = self.device_ms
        if args:
            ev["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                              else repr(v)) for k, v in args.items()}
        return ev


@guarded_by("_lock", fields=["_spans"])
class Tracer:
    """Collects spans process-wide; one instance behind :func:`get_tracer`."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._stack = threading.local()
        #: closed-span hook; exceptions are swallowed (observation must
        #: never take serving down)
        self._sink: Optional[Callable[[Span], None]] = None

    def set_sink(self, sink: Optional[Callable[[Span], None]]) -> None:
        self._sink = sink

    def span(self, name: str, **attrs: Any) -> contextlib.AbstractContextManager:
        """A host span, live while tracing is enabled or a capture records;
        yields the :class:`Span`, or None when not live."""
        return self._span(name, None, attrs)

    def device_span(self, name: str, device, **attrs: Any) -> contextlib.AbstractContextManager:
        """:meth:`span` that also times its body on ``device``'s current
        stream when that is a CUDA device (:attr:`Span.device_ms`)."""
        return self._span(name, device, attrs)

    @contextlib.contextmanager
    def _span(self, name: str, device, attrs: Dict[str, Any]) -> Iterator[Optional[Span]]:
        capturing = _capturing()
        if not (self.enabled or capturing):
            yield None
            return
        stack = getattr(self._stack, "open", None)
        if stack is None:
            stack = self._stack.open = []
        labels = _context.current_labels()
        if labels:  # ambient request labels; explicit span kwargs win
            labels.update(attrs)
            attrs = labels
        s = Span(name, _now_us(), threading.get_ident(), attrs)
        stack.append(s)
        try:
            with _cpu_range(name) if capturing else _NULL:
                stream = _cuda_stream(device)
                start = _timing_event(stream) if stream is not None else None
                try:
                    yield s
                finally:
                    if start is not None:
                        s._events = (start, _timing_event(stream))
        finally:
            s.dur_us = _now_us() - s.ts_us
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
_NULL = contextlib.nullcontext()  # shared: span() when not live allocates nothing


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
    if not (_TRACER.enabled or _capturing()):
        return _NULL
    return _TRACER.span(name, **attrs)


def device_span(name: str, device, **attrs: Any) -> contextlib.AbstractContextManager:
    """:func:`span` whose body is also timed on ``device``'s current stream
    (a torch device or a device string) when that is a CUDA device: a timing event at entry and one at exit, read as
    :attr:`Span.device_ms`. The form the sweep and split paths use::

        with obs.device_span("eval.suffix", hidden.device, layer=l):
            ...
    """
    if not (_TRACER.enabled or _capturing()):
        return _NULL
    return _TRACER.device_span(name, device, **attrs)


@contextlib.contextmanager
def trace_capture(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` run of the body into ``log_dir`` (None:
    a no-op): CPU activity, and CUDA activity where a card is present, with
    every span opened meanwhile as a CPU range on the capture's clock. The
    Chrome trace lands in ``log_dir/torch_trace.json`` when the body ends,
    also when it raises. A capture while another records raises."""
    if not log_dir:
        yield
        return
    if _capturing():
        raise RuntimeError(f"a torch.profiler capture is already recording; "
                           f"cannot start another into {log_dir}")
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "torch_trace.json"))
