"""Request-scoped trace context, propagated host-side through the serve
stack (PyTorch counterpart of ``edgellm_tpu/obs/context.py``).

A :class:`TraceContext` names where in the serving hierarchy an observation
happened: which request (``rid``), which batcher stream/slot (``sid`` /
``slot``), which pipeline µ-batch (``microbatch``), which speculative burst
(``spec_burst``). The context rides a :mod:`contextvars` variable, so it

- follows the host thread that opened it (``ServeFront.submit`` →
  ``_execute`` → ``generate_split`` → hop accounting) with zero plumbing
  through the call signatures, and
- is isolated per thread — a multi-threaded front never cross-labels
  requests.

Every span the :mod:`~.tracing` tracer opens while a context
is bound inherits the context's non-``None`` fields as span args (explicit
span kwargs win on collision). The whole mechanism is host-side Python and
touches no tensor.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import Any, Dict, Iterator, Optional

__all__ = ["TraceContext", "bind", "current", "current_labels", "next_rid"]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The request-scoped labels. All fields optional: deeper layers refine
    the binding (the batcher knows the slot, the spec loop the burst)."""

    rid: Optional[str] = None         #: serve-front request id
    sid: Optional[int] = None         #: batcher stream id
    slot: Optional[int] = None        #: batcher slot index
    microbatch: Optional[int] = None  #: pipeline µ-batch index
    spec_burst: Optional[int] = None  #: speculative burst index

    def labels(self) -> Dict[str, Any]:
        """The non-``None`` fields, as span-arg / metric-label material."""
        return {f.name: v for f in dataclasses.fields(self)
                if (v := getattr(self, f.name)) is not None}


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("edgellm_trace_context", default=None)

_RID_COUNTER = itertools.count()


def current() -> Optional[TraceContext]:
    """The bound context of this thread/task, or None outside any bind."""
    return _CURRENT.get()


def current_labels() -> Dict[str, Any]:
    """``current().labels()`` or ``{}`` — the tracer's merge source."""
    ctx = _CURRENT.get()
    return ctx.labels() if ctx is not None else {}


@contextlib.contextmanager
def bind(**fields: Any) -> Iterator[TraceContext]:
    """Bind (or refine) the current context for the ``with`` body.

    Fields given here override the enclosing binding's; unset fields are
    inherited, so ``bind(rid=...)`` at the front composes with a later
    ``bind(spec_burst=...)`` deep in the spec loop::

        with context.bind(rid=rid):
            ...
            with context.bind(spec_burst=b):   # rid still attached
                ...
    """
    base = _CURRENT.get()
    ctx = (dataclasses.replace(base, **fields) if base is not None
           else TraceContext(**fields))
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def next_rid(prefix: str = "r") -> str:
    """A process-unique request id (``r0``, ``r1``, ...) for callers that
    arrive without one — eval chunks, ad-hoc generate calls."""
    return f"{prefix}{next(_RID_COUNTER)}"
