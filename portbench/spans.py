"""The program's spans in the traced slice, as the ``program_span`` readers
take them.

The port's tracer (``edgellm_tpu_torch/obs/tracing.py``) keeps a span while
tracing is on or a ``torch.profiler`` capture records. The benchmark keeps
tracing off, so the tracer holds exactly the spans of the traced slice,
which ends in ``torch.cuda.synchronize()``: every device span's
``device_ms`` is readable by then. A program without these spans (an older
commit) leaves none of their names, and every reader then reads None.

Self time follows ``choosing-metrics`` §4: a span's duration less what its
direct children cover (spans of one thread nest, so the children of one
parent do not overlap).
"""
from __future__ import annotations

from typing import Iterable, List, Optional


def taken() -> list:
    """The spans the program's tracer kept."""
    from edgellm_tpu_torch.obs.tracing import get_tracer

    return get_tracer().spans()


def named(spans: Iterable, *names: str) -> list:
    return [s for s in spans if s.name in names]


def host_s(spans: List) -> Optional[float]:
    """Σ host seconds of ``spans``; None when there are none."""
    return sum(s.dur_us for s in spans) / 1e6 if spans else None


def device_s(spans: List) -> Optional[float]:
    """Σ device seconds of ``spans``; None when there are none or one has
    no device time (a host span, a span off CUDA, a program whose spans
    carry none)."""
    ms = [getattr(s, "device_ms", None) for s in spans]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / 1e3


def _within(child, parent) -> bool:
    return (child is not parent and child.tid == parent.tid and parent.ts_us <= child.ts_us
            and child.ts_us + child.dur_us <= parent.ts_us + parent.dur_us)


def children(spans: List, parent) -> list:
    """The spans directly inside ``parent``: on its thread, within its
    interval, and inside no other span that is."""
    inner = [s for s in spans if _within(s, parent)]
    return [s for s in inner if not any(_within(s, o) for o in inner)]


def self_s(spans: List, parent, of: tuple) -> float:
    """``parent``'s seconds less those of its direct children named in
    ``of``."""
    return (parent.dur_us - sum(k.dur_us for k in children(spans, parent)
                                if k.name in of)) / 1e6


def device_ms_per_chunk(t, *names: str) -> Optional[float]:
    """Σ device ms of the spans named, per chunk of the traced call; None
    without a traced call, its chunk count or device times."""
    chunks = t.counters.get("chunks")
    sec = device_s(named(taken(), *names)) if t.taken and chunks else None
    return None if sec is None else 1e3 * sec / chunks
