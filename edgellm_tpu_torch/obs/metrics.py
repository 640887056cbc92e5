"""Typed metrics: Counter, Gauge and Histogram in a named registry, the
exporters, and the adapters that absorb the stack's counter sources
(PyTorch counterpart of ``edgellm_tpu/obs/metrics.py``).

A metric has a name, a help string and one value per label set (a frozen
``{label: value}`` mapping; the empty label set is a plain scalar).
Histograms use log-spaced fixed bucket edges with positional interpolation
inside the landing bucket, so p50/p95/p99 are exact up to one bucket's
relative width.

The process-global registry (:func:`get_registry`) starts **disabled**:
every adapter gates itself on ``registry.enabled``, so with observability
off (the default) recording is one attribute check and nothing is stored.
``edgellm_tpu_torch.obs.enable()`` (or the CLI's ``--metrics-out`` /
params.json ``"observability"``) arms it.

Exporters: :meth:`MetricsRegistry.to_prometheus` emits the text exposition
format (``# HELP`` / ``# TYPE`` and samples, histograms as cumulative
``_bucket{le=...}`` series), byte for byte the reference's text for the
same operations; :meth:`MetricsRegistry.snapshot` is the JSON form.

Names (:mod:`.names`): ``edgellm_link_<counter>_total`` (per-hop link
counters, label ``hop``), ``edgellm_link_health_*``,
``edgellm_recovery_<counter>_total``,
``edgellm_decode_jit_cache_misses_total``, ``edgellm_wire_bytes_total``
(labels ``hop``, ``kind``), ``edgellm_decode_ttft_seconds`` /
``edgellm_decode_token_latency_seconds`` (histograms),
``edgellm_spec_*`` (speculative decode), ``edgellm_pipeline_*`` (µ-batch
pipelined decode, label ``stage``), ``edgellm_fused_*`` (fused-hop plan
decisions, labels ``hop``, ``codec``, ``mode``, ``reason``),
``edgellm_cluster_*`` (the replica router's fleet gauges and its kill /
respawn / readmission / recompute / autoscale counters,
:func:`record_cluster_stats`).
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Protocol, \
    Sequence, Tuple, runtime_checkable

from ..utils.concurrency import acquire_in_order, guarded_by

__all__ = [
    "Counter", "CounterSource", "Gauge", "Histogram", "MetricsRegistry",
    "format_table", "get_registry", "record_cluster_stats", "record_decode_stats",
    "record_link_counters", "record_link_health", "record_pipeline_stats",
    "record_prefix_stats", "record_probe_decisions",
    "record_recovery_counters", "record_spec_stats", "record_wire_bytes",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Mapping[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping for quoted label values: backslash,
    double-quote, and newline (in that order — escaping the escapes first)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """``# HELP`` line escaping: backslash and newline only (quotes are
    legal in help text)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"'
                          for k, v in key) + "}"


@guarded_by("_lock", fields=["_values"])
class _Metric:
    """Shared name/help/values plumbing; subclasses define the semantics."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def items(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "help": self.help,
                "values": {_label_str(k) or "": v for k, v in self.items()}}


class Counter(_Metric):
    """Monotonically increasing count. ``inc`` with a negative amount is a
    programming error and raises — a counter that can go down is a gauge."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
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


@guarded_by("_lock", fields=["_counts", "count", "sum", "_min", "_max"])
class Histogram:
    """Log-spaced fixed-bucket histogram with interpolated quantiles.

    ``lo``/``hi`` bound the log-spaced range with ``n_buckets`` geometric
    buckets between them; values below ``lo`` land in an underflow bucket
    ``[0, lo)``, values at/above ``hi`` in an overflow bucket clamped by the
    tracked max. ``quantile(q)`` finds the landing bucket by cumulative rank
    (numpy's ``linear`` positional convention) and interpolates
    geometrically inside it — log-spaced buckets make relative (not
    absolute) error uniform across the range, which is the right shape for
    latency distributions spanning decades.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *, lo: float = 1e-5,
                 hi: float = 1e3, n_buckets: int = 200) -> None:
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")
        self.name = name
        self.help = help
        # bucket b spans [edges[b], edges[b+1]); bucket 0 is [0, lo)
        ratio = (hi / lo) ** (1.0 / n_buckets)
        self.edges: List[float] = [0.0] + [lo * ratio ** i
                                           for i in range(n_buckets)] + [hi]
        self._counts = [0] * (len(self.edges))  # last slot = overflow [hi, inf)
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            b = bisect.bisect_right(self.edges, v) - 1 if v >= 0 else 0
            self._counts[min(b, len(self._counts) - 1)] += 1
            self.count += 1
            self.sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (0 <= q <= 1); NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return math.nan
            rank = q * (self.count - 1)  # numpy 'linear' position
            cum = 0
            for b, c in enumerate(self._counts):
                if c == 0:
                    continue
                if rank < cum + c:  # rank lands in this bucket
                    lob = self.edges[b]
                    hib = (self.edges[b + 1] if b + 1 < len(self.edges)
                           else max(self._max, self.edges[-1]))
                    # clamp by the observed extremes: a single-value bucket
                    # must not report wider than what was actually seen
                    lob = max(lob, self._min) if b == 0 or lob == 0.0 else lob
                    hib = min(hib, self._max) if self._max > lob else hib
                    frac = (rank - cum + 0.5) / c  # midpoint-rank position
                    if lob <= 0.0:
                        return lob + (hib - lob) * frac  # linear near zero
                    return lob * (hib / lob) ** frac  # geometric in-bucket
                cum += c
            return self._max

    def percentiles(self) -> Dict[str, float]:
        """The SLO trio plus count/mean — the block bench artifacts embed."""
        mean = self.sum / self.count if self.count else math.nan
        return {"count": self.count, "mean": mean,
                "min": self._min if self.count else math.nan,
                "max": self._max if self.count else math.nan,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def merge_from(self, other: "Histogram") -> None:
        """Fold another histogram with identical bucket edges into this one
        (used to publish a call-private observer into the registry)."""
        if other.edges != self.edges:
            raise ValueError(f"cannot merge {other.name}: bucket edges differ")
        # id()-ordered acquisition: A.merge_from(B) racing B.merge_from(A)
        # takes the pair in the same global order on both threads, so the
        # source-order ABBA deadlock cannot happen
        with acquire_in_order(self._lock, other._lock):
            for b, c in enumerate(other._counts):
                self._counts[b] += c
            self.count += other.count
            self.sum += other.sum
            self._min = min(self._min, other._min)
            self._max = max(self._max, other._max)

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """[(upper edge, cumulative count)] in Prometheus ``le`` form."""
        out, cum = [], 0
        with self._lock:
            for b, c in enumerate(self._counts):
                cum += c
                le = (self.edges[b + 1] if b + 1 < len(self.edges)
                      else math.inf)
                out.append((le, cum))
        return out

    def snapshot(self) -> Dict[str, Any]:
        p = self.percentiles()
        return {"kind": self.kind, "help": self.help,
                **{k: (None if isinstance(v, float) and math.isnan(v) else v)
                   for k, v in p.items()},
                "sum": self.sum}


@runtime_checkable
class CounterSource(Protocol):
    """Any runtime that can report per-hop fault counters and per-step
    decode wire bytes: ``SplitRuntime``, ``SplitRingRuntime`` and
    ``LocalRuntime`` satisfy it structurally (``LocalRuntime`` reports
    ``None`` / ``[]``: nothing crosses a wire; ``SplitRingRuntime`` ``[]``
    decode bytes: it has no decode surface)."""

    def link_counters(self, reset: bool = False) -> Optional[dict]:
        """Accumulated per-hop counters ``{name: (n_hops,) ints}``, or None
        when the link machinery is not in the graph."""
        ...

    def decode_hop_bytes(self, batch: int) -> list:
        """Per-hop wire bytes one decode step moves at this batch."""
        ...


@guarded_by("_lock", fields=["_metrics"])
class MetricsRegistry:
    """Process-wide named metric store. ``enabled`` gates every adapter (and
    should gate ad-hoc recording too); metric creation is get-or-create so
    call sites never race on registration."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, cls: type, name: str, help: str, **kwargs: Any) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", *, lo: float = 1e-5,
                  hi: float = 1e3, n_buckets: int = 200) -> Histogram:
        return self._get(Histogram, name, help, lo=lo, hi=hi,
                         n_buckets=n_buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Any:
        return self._metrics.get(name)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def _items(self) -> List[Tuple[str, Any]]:
        """Consistent name->metric view; per-metric state is read under
        each metric's own lock *after* the registry lock is released (no
        nested acquisition, no torn scrape on a concurrent clear())."""
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able ``{name: {kind, help, values|percentiles}}``."""
        return {name: m.snapshot() for name, m in self._items()}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, one block per metric family.

        Hardened per the format spec: label values escape backslash /
        double-quote / newline, ``# HELP`` text escapes backslash / newline,
        and ``# HELP``/``# TYPE`` are emitted exactly once per family even
        if a family ever gains multiple sample series (histogram ``_bucket``
        / ``_sum`` / ``_count`` already share one family header)."""
        lines: List[str] = []
        emitted_headers: set = set()
        for name, m in self._items():
            if name not in emitted_headers:
                emitted_headers.add(name)
                if m.help:
                    lines.append(f"# HELP {name} {_escape_help(m.help)}")
                lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for le, cum in m.bucket_counts():
                    le_s = "+Inf" if math.isinf(le) else repr(le)
                    lines.append(f'{name}_bucket{{le="{le_s}"}} {cum}')
                lines.append(f"{name}_sum {m.sum!r}")
                lines.append(f"{name}_count {m.count}")
            else:
                for key, v in m.items():
                    lines.append(f"{name}{_label_str(key)} {v!r}")
        return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every adapter and exporter shares."""
    return _REGISTRY


# ---------------------------------------------------------------------------
# adapters: the scattered legacy sources, absorbed into one registry
# ---------------------------------------------------------------------------


def record_link_counters(delta: Optional[Mapping[str, Sequence[int]]],
                         registry: Optional[MetricsRegistry] = None) -> None:
    """Absorb a FaultyLink-style per-hop counter dict (``COUNTER_KEYS`` plus
    the self-healing extras) as ``edgellm_link_<key>_total{hop=i}``."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or not delta:
        return
    for key, per_hop in delta.items():
        c = reg.counter(f"edgellm_link_{key}_total",
                        f"per-hop link-ladder counter {key!r}")
        if isinstance(per_hop, (str, bytes)) or not hasattr(per_hop,
                                                            "__iter__"):
            vals = [per_hop]  # scalar total: a single-hop figure
        else:
            vals = list(per_hop)  # list/tuple or numpy (n_hops,) array
        for hop, v in enumerate(vals):
            if int(v):
                c.inc(int(v), hop=hop)


def record_recovery_counters(counters: Optional[Any],
                             registry: Optional[MetricsRegistry] = None
                             ) -> None:
    """Absorb a :class:`~edgellm_tpu_torch.serve.recovery.RecoveryCounters` (or its
    ``as_dict()`` form) as ``edgellm_recovery_<field>_total``."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or counters is None:
        return
    d = counters.as_dict() if hasattr(counters, "as_dict") else dict(counters)
    for key, v in d.items():
        if int(v):
            reg.counter(f"edgellm_recovery_{key}_total",
                        f"recovery orchestration counter {key!r}").inc(int(v))


def record_link_health(summary: Optional[Mapping[str, Any]],
                       registry: Optional[MetricsRegistry] = None) -> None:
    """Absorb a :meth:`~edgellm_tpu_torch.codecs.fec.LinkHealth.summary` dict as
    ``edgellm_link_health_*`` gauges (rates, burn, tier, window fill)."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or not summary:
        return
    for key, v in summary.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        reg.gauge(f"edgellm_link_health_{key}",
                  f"windowed link-SLO field {key!r}").set(float(v))


def record_decode_stats(stats: Optional[Mapping[str, Any]],
                        registry: Optional[MetricsRegistry] = None) -> None:
    """Absorb a ``generate``/``generate_split`` stats dict: jit-miss count,
    decoded tokens, decode/prefill walls."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or not stats:
        return
    misses = stats.get("decode_step_cache_misses")
    if misses:
        reg.counter("edgellm_decode_jit_cache_misses_total",
                    "per-step executables compiled (0 on a warm shape)"
                    ).inc(int(misses))
    steps = stats.get("decode_steps")
    if steps:
        reg.counter("edgellm_decode_steps_total",
                    "decode-loop steps executed").inc(int(steps))
    prefill_s = stats.get("prefill_s")
    if prefill_s is not None:
        reg.gauge("edgellm_decode_prefill_s",
                  "last call's prefill wall clock").set(float(prefill_s))
    decode_s = stats.get("decode_s")
    if decode_s is not None:
        reg.gauge("edgellm_decode_decode_s",
                  "last call's decode-loop wall clock").set(float(decode_s))


def record_prefix_stats(report: Optional[Mapping[str, Any]],
                        registry: Optional[MetricsRegistry] = None) -> None:
    """Absorb a :meth:`~edgellm_tpu_torch.models.paged_kv.PagedKVCache.
    prefix_report` dict as ``edgellm_prefix_*`` series: hit/miss/saved-token/
    COW-fork counters (incremented with the report's running totals — call
    once per drain, not per step) plus hit-rate and shared/index page-count
    gauges — the numbers that say whether the radix index is earning its
    pinned pages."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or not report or not report.get("enabled"):
        return
    hits = report.get("hits")
    if hits:
        reg.counter("edgellm_prefix_hits_total",
                    "admits that mapped shared prefix pages").inc(int(hits))
    misses = report.get("misses")
    if misses:
        reg.counter("edgellm_prefix_misses_total",
                    "admits with no usable indexed prefix").inc(int(misses))
    saved = report.get("saved_tokens")
    if saved:
        reg.counter("edgellm_prefix_saved_tokens_total",
                    "prefill token positions skipped via shared pages"
                    ).inc(int(saved))
    forks = report.get("cow_forks")
    if forks:
        reg.counter("edgellm_prefix_cow_forks_total",
                    "copy-on-write page forks").inc(int(forks))
    rate = report.get("hit_rate")
    if rate is not None:
        reg.gauge("edgellm_prefix_hit_rate",
                  "prefix-index hits / lookups").set(float(rate))
    reg.gauge("edgellm_prefix_shared_pages",
              "pages currently referenced more than once").set(
        float(report.get("shared_pages", 0)))
    reg.gauge("edgellm_prefix_index_pages",
              "pages currently pinned by the radix index").set(
        float(report.get("index_pages", 0)))


def record_wire_bytes(per_hop_bytes: Optional[Iterable[float]],
                      kind: str = "forward", steps: int = 1,
                      registry: Optional[MetricsRegistry] = None) -> None:
    """Absorb the split/ring runtimes' per-hop wire-byte accounting
    (``hop_bytes``/``decode_hop_bytes``) as
    ``edgellm_wire_bytes_total{hop, kind}`` — ``steps`` multiplies a
    per-step figure into a per-call total."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or per_hop_bytes is None:
        return
    c = reg.counter("edgellm_wire_bytes_total",
                    "bytes moved across boundary hops")
    for hop, b in enumerate(per_hop_bytes):
        total = float(b) * int(steps)
        if total:
            c.inc(total, hop=hop, kind=kind)


def record_pipeline_stats(summary: Optional[Mapping[str, Any]],
                          registry: Optional[MetricsRegistry] = None) -> None:
    """Absorb a :meth:`~edgellm_tpu_torch.parallel.split.SplitRuntime.
    pipeline_summary` dict as ``edgellm_pipeline_*`` gauges: µ-batch count,
    per-stage occupancy (label ``stage``), and the analytic schedule bubble
    fraction — plus ``edgellm_pipeline_bubble_fraction_measured`` when the
    caller attaches a timed value, so bubble regressions surface in scraped
    metrics."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or not summary:
        return
    reg.gauge("edgellm_pipeline_microbatches",
              "µ-batches per pipelined step (1 = sequential schedule)").set(
        float(summary.get("num_microbatches", 1)))
    reg.gauge("edgellm_pipeline_bubble_fraction",
              "analytic pipeline bubble fraction (n-1)/(M+n-1)").set(
        float(summary.get("bubble_fraction_schedule", 0.0)))
    if summary.get("bubble_fraction_measured") is not None:
        reg.gauge("edgellm_pipeline_bubble_fraction_measured",
                  "measured steady-state bubble fraction (1 - t_seq/(n*t_pipe))"
                  ).set(float(summary["bubble_fraction_measured"]))
    occ = reg.gauge("edgellm_pipeline_stage_occupancy",
                    "fraction of unroll steps each stage computes")
    for stage, frac in enumerate(summary.get("stage_occupancy", ())):
        occ.set(float(frac), stage=stage)


def record_spec_stats(stats: Optional[Mapping[str, Any]],
                      registry: Optional[MetricsRegistry] = None) -> None:
    """Absorb a speculative-decode stats dict (``generate_speculative``'s
    ``stats["speculative"]``): drafted/accepted/rejected/burst counters plus
    acceptance-rate and hops-per-token gauges — the two numbers that say
    whether speculation is paying for its drafts."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or not stats:
        return
    for key in ("drafted", "accepted", "rejected", "bursts"):
        v = stats.get(key)
        if v:
            reg.counter(f"edgellm_spec_{key}_total",
                        f"speculative-decode counter {key!r}").inc(int(v))
    ar = stats.get("acceptance_rate")
    if ar is not None:
        reg.gauge("edgellm_spec_acceptance_rate",
                  "accepted drafts / drafted tokens, last run").set(float(ar))
    hpt = stats.get("hops_per_token")
    if hpt is not None:
        reg.gauge("edgellm_spec_hops_per_token",
                  "boundary hop rounds per emitted token, last run "
                  "(< 1.0 means speculation amortized the link)"
                  ).set(float(hpt))


def record_probe_decisions(rows: Optional[Sequence[Mapping[str, Any]]],
                           registry: Optional[MetricsRegistry] = None
                           ) -> None:
    """Absorb ``SplitRuntime.wire_summary`` rows' fused-hop plan decisions,
    plus the probe cache's measured-win verdict per codec, so
    ``--metrics-out`` says WHY a hop did or didn't fuse instead of that
    living only in a side artifact: ``edgellm_fused_hop_active
    {hop, codec}`` is 1/0, ``edgellm_fused_hop_decision{hop, codec, mode,
    reason}`` is an info-style gauge carrying the plan's reason string, and
    ``edgellm_fused_probe_win{codec}`` is 1 for a measured win, -1 for a
    measured loss, 0 for no probe data."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or not rows:
        return
    from ..codecs import probe_cache

    active = reg.gauge("edgellm_fused_hop_active",
                       "1 when this hop crosses as one fused sealed buffer, "
                       "0 on the unfused encode/ppermute/decode ladder")
    decision = reg.gauge("edgellm_fused_hop_decision",
                         "info-style record (value always 1) of each hop's "
                         "fuse/no-fuse decision and its reason")
    win = reg.gauge("edgellm_fused_probe_win",
                    "probe-cache verdict per codec: 1 measured win, "
                    "-1 measured loss, 0 no data")
    for row in rows:
        hop = row.get("hop", 0)
        codec = row.get("codec", "?")
        fused = row.get("fused")
        active.set(1.0 if fused else 0.0, hop=hop, codec=codec)
        if fused:
            decision.set(1.0, hop=hop, codec=codec,
                         mode=fused.get("mode", "?"),
                         reason=fused.get("reason", "?"))
        else:
            decision.set(1.0, hop=hop, codec=codec, mode="off",
                         reason="no fused plan (gate ladder refused)")
        w = probe_cache.measured_win(f"fused_hop:{codec}")
        win.set(0.0 if w is None else (1.0 if w else -1.0), codec=codec)


def record_cluster_stats(report: Optional[Mapping[str, Any]],
                         registry: Optional[MetricsRegistry] = None) -> None:
    """Absorb a :meth:`~..serve.cluster.ClusterFront.report` dict
    as ``edgellm_cluster_*`` series: fleet-size/pressure/parked gauges plus
    kill/respawn/readmission/recompute counters (incremented with the
    report's running totals — call once per report, not per drain tick)."""
    reg = registry if registry is not None else _REGISTRY
    if not reg.enabled or not report:
        return
    replicas = report.get("replicas", {})
    live = sum(1 for r in replicas.values() if r.get("state") == "live")
    reg.gauge("edgellm_cluster_replicas",
              "replicas in the fleet (any state)").set(float(len(replicas)))
    reg.gauge("edgellm_cluster_live_replicas",
              "replicas currently serving").set(float(live))
    reg.gauge("edgellm_cluster_parked",
              "accepted requests waiting for a routable replica").set(
        float(report.get("parked", 0)))
    pressure = report.get("pressure")
    if pressure is not None:
        reg.gauge("edgellm_cluster_pressure",
                  "mean live-replica load fraction").set(float(pressure))
    kills = report.get("kills")
    if kills:
        reg.counter("edgellm_cluster_kills_total",
                    "replicas removed by fault or chaos").inc(len(kills))
    respawns = sum(r.get("respawns", 0) for r in replicas.values())
    if respawns:
        reg.counter("edgellm_cluster_respawns_total",
                    "replica respawns from a clean plan").inc(int(respawns))
    totals = report.get("totals", {})
    if totals.get("readmitted"):
        reg.counter("edgellm_cluster_readmitted_total",
                    "accepted requests re-placed after a replica loss").inc(
            int(totals["readmitted"]))
    if totals.get("recompute_tokens"):
        reg.counter("edgellm_cluster_recompute_tokens_total",
                    "tokens regenerated after scratch re-admissions").inc(
            int(totals["recompute_tokens"]))
    events = report.get("autoscale_events")
    if events:
        c = reg.counter("edgellm_cluster_autoscale_events_total",
                        "autoscaler scale decisions")
        for ev in events:
            c.inc(direction=ev.get("direction", "?"))


def format_table(registry: Optional[MetricsRegistry] = None,
                 title: str = "metrics") -> str:
    """One aligned name/value table over the whole registry — the unified
    ``--fault-report`` output (replaces three hand-formatted tables)."""
    reg = registry if registry is not None else _REGISTRY
    rows: List[Tuple[str, str]] = []
    for name in reg.names():
        m = reg.get(name)
        if isinstance(m, Histogram):
            p = m.percentiles()
            for k in ("count", "p50", "p95", "p99"):
                v = p[k]
                if isinstance(v, float) and math.isnan(v):
                    continue
                rows.append((f"{name}.{k}", f"{v:.6g}"))
        else:
            for key, v in m.items():
                rows.append((f"{name}{_label_str(key)}", f"{v:.6g}"))
    if not rows:
        return f"{title}: (empty)"
    w = max(len(r[0]) for r in rows)
    body = "\n".join(f"  {n.ljust(w)}  {v.rjust(12)}" for n, v in rows)
    return f"{title}:\n{body}"
