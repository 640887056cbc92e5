"""The failure flight recorder (PyTorch counterpart of
``edgellm_tpu/obs/flight.py``, the same artifact byte for byte): a bounded
ring of recent spans and counter deltas, dumped as a CRC-framed post-mortem
artifact when a typed failure fires.

The recorder keeps the last N closed spans (fed by the tracer's sink) and
the last N counter deltas in memory; on a failure it writes one artifact
holding the failure, both rings, a registry snapshot, the active-request
table and whatever the context provider contributes (the serve front
installs one reporting breakers, brownout and link health).

- **Framing** is ``DecodeCheckpoint``'s: ``magic(8) | u32 version | u64
  payload_len | u32 crc32(payload)`` (``struct "<8sIQI"``, magic
  ``EDGEFLTR``, version 1), then ``json.dumps(payload, sort_keys=True,
  default=repr)`` as UTF-8, written to ``.part``, fsynced and
  ``os.replace``d to ``flight-{seq:04d}-{reason}.bin``.
- **Exactly once**: :meth:`FlightRecorder.dump_for` marks the exception
  instance, so the raise site and every catch site may all call it and one
  artifact results.
- **Determinism**: with an injected clock (a ``FakeClock``) and the same
  spans and counters the artifact's bytes are the reference recorder's,
  span timestamps and durations apart. Values are plain Python before
  they are written: a tensor or numpy value in an ``extra`` or a counter
  delta is unboxed (``tolist``) rather than left to ``repr``.
"""
from __future__ import annotations

import collections
import json
import os
import struct
import threading
import zlib
from typing import Any, Callable, Deque, Dict, List, Optional

from . import metrics as _metrics
from . import tracing as _tracing
from ..utils.concurrency import guarded_by

__all__ = [
    "FlightArtifactError", "FlightRecorder", "configure_flight",
    "flight_dump_for", "get_flight_recorder", "load_flight",
]

_MAGIC = b"EDGEFLTR"
_VERSION = 1
#: magic(8) | u32 version | u64 payload_len | u32 crc32(payload)
_HEADER = struct.Struct("<8sIQI")

_DUMPED_MARK = "_edgellm_flight_dumped"


class FlightArtifactError(RuntimeError):
    """A flight artifact failed its frame checks (magic / version / CRC)."""


def _plain(v: Any) -> Any:
    """``v`` as the JSON the reference writes for Python values: tensors and
    numpy values unboxed through ``tolist``, containers walked."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if not isinstance(v, (str, bytes)) and hasattr(v, "tolist"):
        return v.tolist()
    return v


def _ints(v: Any) -> Any:
    """A counter delta value: an int, or a list of ints per hop."""
    v = _plain(v)
    return [int(x) for x in v] if isinstance(v, list) else int(v)


@guarded_by("_lock", fields=["_spans", "_counters", "_active", "_dump_paths", "_seq"])
class FlightRecorder:
    """Bounded in-memory rings and one-shot post-mortem dumps."""

    def __init__(self, out_dir: str, *, capacity: int = 256,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if capacity <= 0:
            raise ValueError(f"flight capacity must be positive, got {capacity}")
        self.out_dir = out_dir
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: Deque[Dict[str, Any]] = collections.deque(maxlen=capacity)
        self._counters: Deque[Dict[str, Any]] = collections.deque(maxlen=capacity)
        self._active: Dict[str, Dict[str, Any]] = {}
        self._context_fn: Optional[Callable[[], Dict[str, Any]]] = None
        self._dump_paths: List[str] = []
        self._seq = 0

    # -- ring feeds ---------------------------------------------------------

    def record_span(self, span: "_tracing.Span") -> None:
        """Tracer sink: one closed span into the ring."""
        ev = span.to_event()
        with self._lock:
            self._spans.append(ev)

    def note_counters(self, kind: str, delta: Dict[str, Any]) -> None:
        """One counter delta (e.g. a decode call's per-hop fault counters)."""
        flat = {k: _ints(v) for k, v in delta.items()}
        with self._lock:
            self._counters.append({"kind": kind, "delta": flat, "t": self._now()})

    def note_request(self, rid: str, **meta: Any) -> None:
        with self._lock:
            self._active[rid] = _plain(dict(meta))

    def end_request(self, rid: str) -> None:
        with self._lock:
            self._active.pop(rid, None)

    def set_context_provider(self, fn: Optional[Callable[[], Dict[str, Any]]]) -> None:
        """Install the serve front's live-state contributor, merged into
        every dump."""
        self._context_fn = fn

    def _now(self) -> Optional[float]:
        return self._clock() if self._clock is not None else None

    # -- dumping ------------------------------------------------------------

    def dump_for(self, exc: BaseException, **extra: Any) -> Optional[str]:
        """Dump once for this failure *instance*: the raise site and every
        catch site may call this and one artifact results."""
        with self._lock:
            if getattr(exc, _DUMPED_MARK, False):
                return None
            try:
                setattr(exc, _DUMPED_MARK, True)
            except AttributeError:  # a __slots__ exception: no mark possible
                pass
        failure = {"type": type(exc).__name__, "message": str(exc)}
        for attr in ("stage", "at_step"):
            v = getattr(exc, attr, None)
            if isinstance(v, (int, str)):
                failure[attr] = v
        return self.dump(type(exc).__name__, failure=failure, **extra)

    def dump(self, reason: str, *, failure: Optional[Dict[str, Any]] = None,
             **extra: Any) -> str:
        """Write one CRC-framed post-mortem artifact; returns its path."""
        ctx: Dict[str, Any] = {}
        if self._context_fn is not None:
            try:
                ctx = _plain(dict(self._context_fn()))
            except Exception:  # the provider must not take the dump down
                ctx = {"context_provider_error": True}
        reg = _metrics.get_registry()
        with self._lock:
            self._seq += 1
            seq = self._seq
            payload_obj: Dict[str, Any] = {
                "reason": reason,
                "seq": seq,
                "t": self._now(),
                "failure": failure,
                "spans": list(self._spans),
                "counters": list(self._counters),
                "active_requests": {k: dict(v) for k, v in self._active.items()},
                "context": ctx,
                "registry": json.loads(reg.to_json()) if reg.enabled else {},
            }
            payload_obj.update(_plain(extra))
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
        path = os.path.join(self.out_dir, f"flight-{seq:04d}-{safe}.bin")
        os.makedirs(self.out_dir, exist_ok=True)
        payload = json.dumps(payload_obj, sort_keys=True, default=repr).encode("utf-8")
        header = _HEADER.pack(_MAGIC, _VERSION, len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with self._lock:
            self._dump_paths.append(path)
        if reg.enabled:
            reg.counter("edgellm_flight_dumps_total",
                        "flight-recorder post-mortem artifacts written").inc(reason=reason)
        return path

    def dumps(self) -> List[str]:
        """Paths of every artifact this recorder has written, in order."""
        with self._lock:
            return list(self._dump_paths)

    def snapshot(self) -> Dict[str, Any]:
        """The live rings as JSON-able state (``/snapshot.json``)."""
        with self._lock:
            return {"spans": list(self._spans), "counters": list(self._counters),
                    "active_requests": {k: dict(v) for k, v in self._active.items()},
                    "dumps": list(self._dump_paths)}


def load_flight(path: str) -> Dict[str, Any]:
    """Read one artifact back, verifying magic, version and CRC."""
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) != _HEADER.size:
            raise FlightArtifactError(f"{path}: truncated header")
        magic, version, n, crc = _HEADER.unpack(head)
        if magic != _MAGIC:
            raise FlightArtifactError(f"{path}: bad magic {magic!r}")
        if version != _VERSION:
            raise FlightArtifactError(f"{path}: unsupported version {version}")
        payload = f.read(n)
    if len(payload) != n:
        raise FlightArtifactError(f"{path}: truncated payload ({len(payload)} of {n} bytes)")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FlightArtifactError(f"{path}: CRC mismatch")
    obj = json.loads(payload.decode("utf-8"))
    if not isinstance(obj, dict):
        raise FlightArtifactError(f"{path}: payload is not an object")
    return obj


_RECORDER: Optional[FlightRecorder] = None


def configure_flight(recorder: Optional[FlightRecorder]) -> None:
    """Install (or remove, with None) the process-global recorder and hook it
    into the global tracer's span sink."""
    global _RECORDER
    _RECORDER = recorder
    _tracing.get_tracer().set_sink(recorder.record_span if recorder is not None else None)


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def flight_dump_for(exc: BaseException, **extra: Any) -> Optional[str]:
    """What the failure sites call unconditionally: a no-op without a
    recorder, and never raising (a dump must not mask the failure)."""
    rec = _RECORDER
    if rec is None:
        return None
    try:
        return rec.dump_for(exc, **extra)
    except Exception:
        return None
