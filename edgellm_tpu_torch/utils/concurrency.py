"""Concurrency contracts for the host serve plane (the reference's
``edgellm_tpu/utils/concurrency.py``): ``@guarded_by("_lock", fields=[...])``
declares which attributes of a class may only be written while
``self._lock`` is held. It only attaches ``__guarded_by__`` metadata (zero
runtime cost).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

__all__ = ["guarded_by"]


def guarded_by(lock_attr: str, *, fields: Sequence[str]) -> Callable[[type], type]:
    """Class decorator declaring a lock-discipline contract (metadata only)."""
    contract: Dict[str, Any] = {"lock": lock_attr, "fields": tuple(fields)}

    def _decorate(cls: type) -> type:
        setattr(cls, "__guarded_by__", contract)
        return cls

    return _decorate

