"""Typed metrics: Counter and Gauge in a named registry, with the adapters
``--fault-report`` prints through (PyTorch counterpart of the parts of
``edgellm_tpu/obs/metrics.py`` it calls).

A metric has a name, a help string and one value per label set (a frozen
``{label: value}`` mapping; the empty label set is a plain scalar). A
registry is created ``enabled=False`` unless told otherwise, and every
adapter records nothing into a disabled one. Names follow the reference's
catalog: ``edgellm_link_<counter>_total`` (per-hop link-ladder counters,
label ``hop``), ``edgellm_link_health_*`` (burn rate, windowed rates,
tier) and ``edgellm_recovery_<field>_total`` (the recovery counters).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "MetricsRegistry", "format_table", "record_link_counters",
           "record_link_health", "record_recovery_counters"]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Mapping[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus escaping for quoted label values: backslash, double quote,
    newline (the escapes first)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key) + "}"


class _Metric:
    """Shared name / help / values plumbing; subclasses define the semantics."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def items(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())


class Counter(_Metric):
    """Monotonically increasing count; a negative ``inc`` raises."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    """A value that goes both ways (rates, tiers, sizes)."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class MetricsRegistry:
    """Named metric store. ``enabled`` gates every adapter; creation is
    get-or-create, so call sites never race on registration."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, cls: type, name: str, help: str) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Any:
        return self._metrics.get(name)


def record_link_counters(delta: Optional[Mapping[str, Sequence[int]]],
                         registry: MetricsRegistry) -> None:
    """Absorb a per-hop link counter dict (``COUNTER_KEYS`` plus the
    self-healing extras) as ``edgellm_link_<key>_total{hop=i}``; zero
    entries are not recorded."""
    if not registry.enabled or not delta:
        return
    for key, per_hop in delta.items():
        c = registry.counter(f"edgellm_link_{key}_total", f"per-hop link-ladder counter {key!r}")
        if isinstance(per_hop, (str, bytes)) or not hasattr(per_hop, "__iter__"):
            vals = [per_hop]  # a scalar total: a single-hop figure
        else:
            vals = list(per_hop)
        for hop, v in enumerate(vals):
            if int(v):
                c.inc(int(v), hop=hop)


def record_link_health(summary: Optional[Mapping[str, Any]],
                       registry: MetricsRegistry) -> None:
    """Absorb a ``LinkHealth.summary()`` dict as ``edgellm_link_health_*``
    gauges (its numeric fields)."""
    if not registry.enabled or not summary:
        return
    for key, v in summary.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        registry.gauge(f"edgellm_link_health_{key}",
                       f"windowed link-SLO field {key!r}").set(float(v))


def record_recovery_counters(counters: Optional[Any], registry: MetricsRegistry) -> None:
    """Absorb a :class:`~..serve.recovery.RecoveryCounters` (or its
    ``as_dict()`` form) as ``edgellm_recovery_<field>_total``; zero fields
    are not recorded."""
    if not registry.enabled or counters is None:
        return
    d = counters.as_dict() if hasattr(counters, "as_dict") else dict(counters)
    for key, v in d.items():
        if int(v):
            registry.counter(f"edgellm_recovery_{key}_total",
                             f"recovery orchestration counter {key!r}").inc(int(v))


def format_table(registry: MetricsRegistry, title: str = "metrics") -> str:
    """One aligned name / value table over the whole registry."""
    rows: List[Tuple[str, str]] = []
    for name in registry.names():
        for key, v in registry.get(name).items():
            rows.append((f"{name}{_label_str(key)}", f"{v:.6g}"))
    if not rows:
        return f"{title}: (empty)"
    w = max(len(r[0]) for r in rows)
    body = "\n".join(f"  {n.ljust(w)}  {v.rjust(12)}" for n, v in rows)
    return f"{title}:\n{body}"
