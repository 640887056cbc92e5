"""The registered metric and span names and templates (PyTorch
counterpart of ``edgellm_tpu/obs/names.py``: its tables, and beside them
the port's own spans): the one vocabulary every
``registry.counter/gauge/histogram(...)`` and ``span(...)`` /
``device_span(...)`` call site draws from.

A typo'd metric name is an error nowhere: the registry creates the series
and nothing scrapes it. So every *literal* name passed to a metric factory
or a span must appear here, and every f-string name must match a
registered ``*`` template (the hole is the runtime key, e.g. the
fault-counter key in ``edgellm_link_*_total``); the port's tests read its
sources and hold every call site to these tables. The tables are the
reference's whole, the names of parts still to port included, and
:data:`PORT_SPAN_NAMES`, the spans only the port opens (the sweep's and
the split's phases that the benchmark's per-layer metrics read), joins
:data:`SPAN_NAMES`.

Stdlib-only, importing nothing else of the package.
"""
from __future__ import annotations

from fnmatch import fnmatchcase
from typing import FrozenSet, Tuple

__all__ = [
    "METRIC_NAMES", "METRIC_TEMPLATES", "PORT_SPAN_NAMES", "SPAN_NAMES", "SPAN_TEMPLATES",
    "metric_registered", "span_registered",
]

#: every literal metric family name in the package (registry factories and
#: direct Counter/Gauge/Histogram constructions)
METRIC_NAMES: FrozenSet[str] = frozenset({
    # serve front (pre-date the edgellm_ prefix; renaming would break the
    # serve-report consumers, so they are registered as-is)
    "serve_requests_total",
    "serve_ttft_s",
    "serve_latency_s",
    "serve_retries_charged_total",
    "serve_brownout_level",
    "serve_queue_depth",
    # decode loop
    "edgellm_decode_jit_cache_misses_total",
    "edgellm_decode_steps_total",
    "edgellm_decode_prefill_s",
    "edgellm_decode_decode_s",
    "edgellm_decode_ttft_seconds",
    "edgellm_decode_token_latency_seconds",
    # boundary wire
    "edgellm_wire_bytes_total",
    # pipelined decode
    "edgellm_pipeline_microbatches",
    "edgellm_pipeline_bubble_fraction",
    "edgellm_pipeline_bubble_fraction_measured",
    "edgellm_pipeline_stage_occupancy",
    # speculative decode
    "edgellm_spec_acceptance_rate",
    "edgellm_spec_hops_per_token",
    # prefix-sharing paged KV cache
    "edgellm_prefix_hits_total",
    "edgellm_prefix_misses_total",
    "edgellm_prefix_saved_tokens_total",
    "edgellm_prefix_cow_forks_total",
    "edgellm_prefix_hit_rate",
    "edgellm_prefix_shared_pages",
    "edgellm_prefix_index_pages",
    # fused-hop probe provenance
    "edgellm_fused_hop_active",
    "edgellm_fused_hop_decision",
    "edgellm_fused_probe_win",
    # tracing plane
    "edgellm_flight_dumps_total",
    "edgellm_obs_scrapes_total",
    # cluster router (serve/cluster.py)
    "edgellm_cluster_replicas",
    "edgellm_cluster_live_replicas",
    "edgellm_cluster_pressure",
    "edgellm_cluster_parked",
    "edgellm_cluster_placements_total",
    "edgellm_cluster_kills_total",
    "edgellm_cluster_respawns_total",
    "edgellm_cluster_readmitted_total",
    "edgellm_cluster_recompute_tokens_total",
    "edgellm_cluster_autoscale_events_total",
    # disaggregated prefill/decode (serve/disagg.py)
    "edgellm_disagg_migrations_total",
    "edgellm_disagg_pages_migrated_total",
    "edgellm_disagg_wire_bytes_total",
    "edgellm_disagg_recompute_tokens_total",
    "edgellm_disagg_readmitted_total",
    "edgellm_disagg_prefill_workers",
    "edgellm_disagg_queue_depth",
    "edgellm_disagg_degraded",
    # gray-failure plane (serve/overload.py StragglerDetector +
    # serve/cluster.py hedging + deadline propagation)
    "edgellm_gray_stragglers",
    "edgellm_gray_hedge_delay_s",
    "edgellm_gray_hedges_total",
    "edgellm_gray_hedge_wins_total",
    "edgellm_gray_deadline_expired_total",
    "edgellm_gray_demotions_total",
})

#: templates for adapter families whose middle segment is a runtime key
#: (fault-counter names, recovery counters, link-health gauges); an f-string
#: call site is checked against these with its holes as ``*``
METRIC_TEMPLATES: Tuple[str, ...] = (
    "edgellm_link_*_total",
    "edgellm_recovery_*_total",
    "edgellm_link_health_*",
    "edgellm_spec_*_total",
)

#: every literal span name of the reference
SPAN_NAMES: FrozenSet[str] = frozenset({
    # serve/decode.py
    "generate.prefill",
    "generate.decode_loop",
    "generate_split.prefill",
    "generate_split.decode_loop",
    "decode.checkpoint_write",
    "decode.checkpoint_resume",
    "decode.failover",
    # serve/speculative.py
    "generate_spec.prefill",
    "generate_spec.resume_draft_prefill",
    "generate_spec.burst_loop",
    # serve/recovery.py
    "recovery.checkpoint_save",
    "recovery.checkpoint_load",
    # serve/frontend.py + serve/batching.py (request-scoped tracing plane)
    "serve.submit",
    "serve.execute",
    "batch.submit",
    "batch.admit",
    "batch.step",
    # per-cut boundary-hop attribution (decode, speculative, eval)
    "split.hop",
    # eval/split_eval.py
    "eval.checkpoint_write",
    "eval.failover",
    "eval.submit_group",
    "eval.drain_group",
    "eval.time_hops",
    "eval.time_decode_hops",
    # lint graph-layer probe
    "lint.obs-identity-probe",
    # serve/cluster.py replica lifecycle (rare paths only — the router's
    # per-request hot path stays span-free for the 10⁶-request soak)
    "cluster.kill",
    "cluster.respawn",
    "cluster.autoscale",
    # serve/disagg.py migration lifecycle (per-page hop attribution rides
    # on disagg.migrate_page's sid/wid/page attrs)
    "disagg.prefill",
    "disagg.migrate",
    "disagg.migrate_page",
    "disagg.adopt",
    "disagg.degrade",
    "disagg.kill",
    "disagg.readmit",
    # gray-failure plane: hedges and straggler verdict flips are rare by
    # construction (bounded by max_hedge_fraction / dwell hysteresis), so
    # spanning them keeps the per-request hot path span-free
    "cluster.hedge",
    "gray.demote",
})

#: the spans only the port opens, at the layer boundaries of the token
#: sweep and the split eval (each read by a per-layer metric of the
#: benchmark, ``portbench/metrics/``)
PORT_SPAN_NAMES: FrozenSet[str] = frozenset({
    # eval/harness.py, eval/split_eval.py: one entry call
    "eval.call",
    # eval/harness.py: the token sweep's phases of a window group
    "eval.stats_forward",
    "eval.importance",
    "eval.codec",
    "eval.suffix",
    "eval.nll_tail",
    # parallel/split.py SplitRuntime.forward and the stage unrolls
    "split.stage",
    "split.cross",
    "split.unembed",
    # eval/split_eval.py: the NLL of the split's logits
    "eval.nll",
    # models/moe.py: the sparse-expert layer's phases
    "moe.route",
    "moe.experts",
    "moe.combine",
    # models/transformer.py short_conv: the gated convolution between its
    # projections
    "mix.conv",
})
#: every span name: the reference's and the port's own
SPAN_NAMES = SPAN_NAMES | PORT_SPAN_NAMES

#: span-name templates (none yet: span names are all static); kept so spans
#: and metrics are checked alike
SPAN_TEMPLATES: Tuple[str, ...] = ()


def _registered(pattern: str, names: FrozenSet[str],
                templates: Tuple[str, ...]) -> bool:
    if "*" in pattern:
        # an f-string call site: its hole pattern must be a registered
        # template verbatim — matching a template *partially* would let
        # ``f"edgellm_link_{x}z_total"`` slip through
        return pattern in templates
    return pattern in names or any(fnmatchcase(pattern, t)
                                   for t in templates)


def metric_registered(name_or_pattern: str) -> bool:
    """True when a literal metric name (or the ``*``-holed pattern of an
    f-string call site) is in the registered vocabulary."""
    return _registered(name_or_pattern, METRIC_NAMES, METRIC_TEMPLATES)


def span_registered(name_or_pattern: str) -> bool:
    """Span-name twin of :func:`metric_registered`."""
    return _registered(name_or_pattern, SPAN_NAMES, SPAN_TEMPLATES)
