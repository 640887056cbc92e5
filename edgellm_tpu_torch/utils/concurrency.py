"""Concurrency contracts for the host serve plane (the reference's
``edgellm_tpu/utils/concurrency.py``): ``@guarded_by("_lock", fields=[...])``
declares which attributes of a class may only be written while
``self._lock`` is held. It only attaches ``__guarded_by__`` metadata (zero
runtime cost). ``acquire_in_order(*locks)`` takes several locks in one
global order (ascending ``id()``), so two threads taking the same pair
(``a.merge_from(b)`` racing ``b.merge_from(a)``) cannot deadlock.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

__all__ = ["guarded_by", "acquire_in_order"]


def guarded_by(lock_attr: str, *, fields: Sequence[str]) -> Callable[[type], type]:
    """Class decorator declaring a lock-discipline contract (metadata only)."""
    contract: Dict[str, Any] = {"lock": lock_attr, "fields": tuple(fields)}

    def _decorate(cls: type) -> type:
        setattr(cls, "__guarded_by__", contract)
        return cls

    return _decorate



@contextmanager
def acquire_in_order(*locks: Any) -> Iterator[None]:
    """Acquire ``locks`` in ascending ``id()`` order (a lock given twice
    once), release in reverse."""
    unique: Dict[int, Any] = {}
    for lock in locks:
        unique.setdefault(id(lock), lock)
    taken: List[Any] = []
    ordered: Tuple[Any, ...] = tuple(unique[key] for key in sorted(unique))
    try:
        for lock in ordered:
            lock.acquire()
            taken.append(lock)
        yield
    finally:
        for lock in reversed(taken):
            lock.release()
