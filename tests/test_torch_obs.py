"""The port's ``obs`` package held against the JAX package's on the CPU:
metrics (counter, gauge, histogram quantiles, the Prometheus and JSON
exporters, the ``record_*`` adapters), the span tracer (nesting, threads,
the Chrome trace schema, the trace context), ``LatencyObserver``,
``ObservabilityConfig``, the names every call site of the port uses, and
the serve loops' hooks (the same tokens with observability on and off).

The reference's modules are host-side Python: both packages run the same
operations on the same inputs and the outputs are compared exactly (the
quantiles to the last bit, the exporters' text byte for byte).
"""
import json
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from edgellm_tpu.obs import ObservabilityConfig as JObservabilityConfig
from edgellm_tpu.obs import context as jcontext
from edgellm_tpu.obs import latency as jlatency
from edgellm_tpu.obs import metrics as jm
from edgellm_tpu.obs import names as jnames
from edgellm_tpu.obs import tracing as jtracing
from edgellm_tpu_torch import obs
from edgellm_tpu_torch.obs import context as tcontext
from edgellm_tpu_torch.obs import latency as tlatency
from edgellm_tpu_torch.obs import metrics as tm
from edgellm_tpu_torch.obs import names as tnames
from edgellm_tpu_torch.obs import tracing as ttracing

REPO = Path(__file__).resolve().parent.parent
BOTH = [(jm, "reference"), (tm, "port")]


@pytest.fixture
def armed():
    """The port's global registry and tracer armed and empty for the test,
    disarmed and emptied after it."""
    obs.get_registry().clear()
    obs.get_tracer().clear()
    obs.enable()
    yield
    obs.disable()
    obs.get_registry().clear()
    obs.get_tracer().clear()


# ---------- metrics ----------

VALUES = {
    "latencies": [3e-4, 1.2e-3, 1.2e-3, 0.05, 0.7, 2.5, 9.0, 1e-6, 0.0, 1500.0],
    "one": [0.25],
    "decades": list(np.logspace(-5, 3, 57)),
    "negative": [-1.0, 0.5, 2.0],
}


@pytest.mark.parametrize("name", sorted(VALUES))
@pytest.mark.parametrize("buckets", [(1e-5, 1e3, 200), (1e-4, 120.0, 64)])
def test_histogram_quantiles_match_reference(name, buckets):
    lo, hi, n = buckets
    hists = [m.Histogram("h", "x", lo=lo, hi=hi, n_buckets=n) for m, _ in BOTH]
    for v in VALUES[name]:
        for h in hists:
            h.observe(v)
    want, got = hists
    assert got.edges == want.edges
    for q in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q), q
    assert got.percentiles() == want.percentiles()
    assert got.bucket_counts() == want.bucket_counts()
    assert got.snapshot() == want.snapshot()


def test_histogram_merge_and_refusals_match_reference():
    for m, _ in BOTH:
        a = m.Histogram("a", lo=1e-3, hi=10, n_buckets=20)
        b = m.Histogram("b", lo=1e-3, hi=10, n_buckets=20)
        for v in (0.01, 0.3, 4.0):
            a.observe(v)
            b.observe(v * 2)
        a.merge_from(b)
        a.merge_from(a)  # the same lock twice: taken once
        assert a.count == 12
        with pytest.raises(ValueError, match="bucket edges differ"):
            a.merge_from(m.Histogram("c", lo=1e-3, hi=10, n_buckets=21))
        with pytest.raises(ValueError, match="need 0 < lo < hi"):
            m.Histogram("d", lo=2.0, hi=1.0)
        with pytest.raises(ValueError, match="q must be in"):
            a.quantile(1.5)
        assert np.isnan(m.Histogram("e").quantile(0.5))
        c = m.Counter("c_total")
        with pytest.raises(ValueError, match="cannot decrease"):
            c.inc(-1)
        reg = m.MetricsRegistry(enabled=True)
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered as Counter"):
            reg.gauge("x")


def _operations(m):
    """One fixed sequence of registry operations -> the registry."""
    reg = m.MetricsRegistry(enabled=True)
    reg.counter("serve_requests_total", "terminal \\ serve\noutcomes").inc(outcome="completed")
    reg.counter("serve_requests_total").inc(2, outcome='we"ird\\label\n')
    g = reg.gauge("serve_queue_depth", "queued requests")
    g.set(3)
    g.inc(0.5)
    g.set(7, stage=1)
    h = reg.histogram("serve_ttft_s", "submit -> first token", lo=1e-4, hi=120.0)
    for v in (1e-5, 0.002, 0.002, 0.3, 7.0, 500.0):
        h.observe(v)
    reg.histogram("edgellm_decode_ttft_seconds", "empty", lo=1e-5, hi=1e2, n_buckets=480)
    m.record_link_counters({"hops": [4, 4], "retried": np.array([1, 0]), "detected": 3},
                           registry=reg)
    return reg


def test_exporters_match_reference_byte_for_byte():
    want, got = _operations(jm), _operations(tm)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.to_json() == want.to_json()
    assert got.to_json(indent=1) == want.to_json(indent=1)
    assert got.snapshot() == want.snapshot()
    assert tm.format_table(got) == jm.format_table(want)
    assert got.names() == want.names()
    got.clear()
    assert got.names() == [] and tm.format_table(got, "t") == "t: (empty)"


ADAPTER_INPUTS = [
    ("record_decode_stats", ({"decode_step_cache_misses": 2, "decode_steps": 11,
                              "prefill_s": 0.25, "decode_s": 1.5},), {}),
    ("record_decode_stats", ({"decode_steps": 0, "prefill_s": 0.1},), {}),
    ("record_prefix_stats", ({"enabled": True, "hits": 3, "misses": 1, "saved_tokens": 40,
                              "cow_forks": 2, "hit_rate": 0.75, "shared_pages": 5,
                              "index_pages": 9},), {}),
    ("record_prefix_stats", ({"enabled": False, "hits": 3},), {}),
    ("record_wire_bytes", ([904.0, 0.0, 452.5],), {"kind": "decode", "steps": 7}),
    ("record_wire_bytes", ([100, 200],), {}),
    ("record_pipeline_stats", ({"num_microbatches": 4, "bubble_fraction_schedule": 1 / 3,
                                "stage_occupancy": [2 / 3] * 3},), {}),
    ("record_pipeline_stats", ({"num_microbatches": 2, "bubble_fraction_schedule": 0.5,
                                "bubble_fraction_measured": 0.41,
                                "stage_occupancy": [0.5, 0.5]},), {}),
    ("record_spec_stats", ({"drafted": 12, "accepted": 5, "rejected": 7, "bursts": 4,
                            "acceptance_rate": 5 / 12, "hops_per_token": 0.4},), {}),
    ("record_link_counters", ({"hops": [3, 3], "retried": [1, 0], "substituted": [0, 0]},),
     {}),
    ("record_link_health", ({"burn_rate": 1.5, "tier": 1, "window_fill": 4, "ok": True,
                             "note": "x"},), {}),
    ("record_recovery_counters", ({"failovers": 1, "replans": 1, "recompute_tokens": 0},), {}),
]


@pytest.mark.parametrize("name,args,kw", ADAPTER_INPUTS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(ADAPTER_INPUTS)])
def test_record_adapters_match_reference(name, args, kw):
    """Each adapter on the same input gives the reference's snapshot, twice
    in a row (counters add up); a disabled registry records nothing."""
    regs = []
    for m, _ in BOTH:
        reg = m.MetricsRegistry(enabled=True)
        for _ in range(2):
            getattr(m, name)(*args, registry=reg, **kw)
        regs.append(reg)
        off = m.MetricsRegistry()
        getattr(m, name)(*args, registry=off, **kw)
        assert off.names() == []
    assert regs[1].to_prometheus() == regs[0].to_prometheus()


def test_record_probe_decisions_matches_reference(monkeypatch, tmp_path):
    """``wire_summary`` rows (one fused, one not) with an empty probe
    cache: the reference's gauges."""
    monkeypatch.setenv("EDGELLM_PROBE_CACHE", str(tmp_path / "none.json"))
    rows = [{"hop": 0, "codec": "int8_per_token", "fused": {"mode": "wire", "reason": "forced"}},
            {"hop": 1, "codec": "int4_per_token", "fused": None}]
    regs = []
    for m, _ in BOTH:
        reg = m.MetricsRegistry(enabled=True)
        m.record_probe_decisions(rows, registry=reg)
        regs.append(reg)
    assert regs[1].to_prometheus() == regs[0].to_prometheus()


def test_global_registry_and_counter_source():
    assert tm.get_registry() is obs.get_registry() and not tm.get_registry().enabled
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
    from edgellm_tpu_torch.models import PRESETS
    from edgellm_tpu_torch.serve.recovery import LocalRuntime

    rt = SplitRuntime(PRESETS["tiny-qwen2"], SplitConfig((1,), ("fp32",)), ["cpu"] * 2)
    assert isinstance(rt, tm.CounterSource)
    assert isinstance(LocalRuntime(PRESETS["tiny-qwen2"]), tm.CounterSource)
    assert not isinstance(object(), tm.CounterSource)


# ---------- tracing and context ----------

def _trace_run(tracing, context):
    """Nested spans, a bound context, explicit kwargs over it, two threads
    -> [(name, args, depth, thread)] in each thread's order."""
    tr = tracing.Tracer(enabled=True)
    with context.bind(rid="r7", slot=2):
        with tr.span("serve.execute", priority=1):
            with tr.span("split.hop", hop=0, slot=5, obj=[1, 2]):
                pass
            with context.bind(spec_burst=3):
                with tr.span("generate_spec.burst_loop", k=4):
                    pass

    def worker():
        with context.bind(rid="r9"):
            with tr.span("batch.step", step=1):
                pass

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    trace = tr.to_chrome_trace()
    tids = {e["tid"] for e in trace["traceEvents"]}
    assert len(tids) == 2
    out = []
    for ev in trace["traceEvents"]:
        assert set(ev) >= {"name", "ph", "ts", "dur", "pid", "tid"} and ev["ph"] == "X"
        encl = [o for o in trace["traceEvents"] if o is not ev and o["tid"] == ev["tid"]
                and o["ts"] <= ev["ts"] and ev["ts"] + ev["dur"] <= o["ts"] + o["dur"]]
        out.append((ev["name"], ev.get("args"), len(encl),
                    ev["tid"] == threading.get_ident()))
    return sorted(out, key=lambda r: (not r[3], r[2], r[0])), trace["displayTimeUnit"]


def test_span_nesting_threads_and_schema_match_reference():
    assert _trace_run(ttracing, tcontext) == _trace_run(jtracing, jcontext)


def test_disabled_tracer_records_nothing_and_export(tmp_path):
    tr = ttracing.Tracer()
    with tr.span("split.hop", hop=0) as s:
        assert s is None
    assert tr.spans() == []
    assert not ttracing.tracing_enabled()
    assert ttracing.span("split.hop") is ttracing.span("batch.step")  # one shared null
    tr = ttracing.Tracer(enabled=True)
    with tr.span("eval.drain_group", chunk=3):
        pass
    path = tmp_path / "t.json"
    tr.export(str(path))
    data = json.loads(path.read_text())
    assert [e["name"] for e in data["traceEvents"]] == ["eval.drain_group"]
    assert data["traceEvents"][0]["args"] == {"chunk": 3}
    assert not (tmp_path / "t.json.part").exists()


def test_context_matches_reference():
    for ctx in (tcontext, jcontext):
        assert ctx.current() is None and ctx.current_labels() == {}
    with tcontext.bind(rid="r1", microbatch=2) as a, jcontext.bind(rid="r1", microbatch=2) as b:
        assert a.labels() == b.labels() == {"rid": "r1", "microbatch": 2}
        with tcontext.bind(sid=4), jcontext.bind(sid=4):
            assert tcontext.current_labels() == jcontext.current_labels()
    assert [f.name for f in __import__("dataclasses").fields(tcontext.TraceContext)] == [
        f.name for f in __import__("dataclasses").fields(jcontext.TraceContext)]
    assert re.fullmatch(r"q\d+", tcontext.next_rid("q"))


def test_trace_capture_writes_record_function_ranges(tmp_path):
    """A capture's torch.profiler trace holds every span opened in it as a
    range, with tracing on or off; outside a capture and with tracing off
    no span is live."""
    tr = ttracing.get_tracer()
    tr.clear()
    ttracing.configure(enabled=True)
    try:
        with obs.trace_capture(str(tmp_path)):
            with ttracing.span("eval.submit_group", chunk=0):
                torch.ones(4) + 1
            with pytest.raises(RuntimeError, match="already recording"):
                with obs.trace_capture(str(tmp_path / "inner")):
                    pass
    finally:
        ttracing.configure(enabled=False)
    with obs.trace_capture(str(tmp_path / "off")):
        with ttracing.span("eval.drain_group", chunk=0) as live:
            assert live is not None
    assert ttracing.span("eval.drain_group") is ttracing.span("eval.submit_group")
    assert [s.name for s in tr.spans()] == ["eval.submit_group", "eval.drain_group"]
    tr.clear()
    for sub, name in (("", "eval.submit_group"), ("off", "eval.drain_group")):
        names = {e.get("name") for e in
                 json.loads((tmp_path / sub / "torch_trace.json").read_text())["traceEvents"]}
        assert name in names
    with obs.trace_capture(None):
        pass


# ---------- latency ----------

def test_latency_observer_summary_matches_reference(monkeypatch):
    """The same clock readings: the same TTFT and per-token histograms,
    summary and published series."""
    ticks = [10.0, 10.25, 10.30, 10.31, 10.5, 10.5004, 11.0]
    results = []
    for mod, m in ((jlatency, jm), (tlatency, tm)):
        seq = iter(ticks)
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(seq))
        reg = m.MetricsRegistry(enabled=True)
        ob = mod.LatencyObserver(registry=reg)
        ob.start()
        ob.first_token(np.zeros(2, np.int32))
        for _ in range(5):
            ob.token(np.zeros(2, np.int32))
        ob.publish()
        results.append((ob.summary(), reg.to_prometheus()))
        monkeypatch.undo()
    assert results[1] == results[0]


# ---------- config and names ----------

@pytest.mark.parametrize("kw", [{}, {"metrics": False}, {"tracing": 1}, {"latency": "yes"},
                                {"flight_recorder": 3}, {"obs_port": True},
                                {"obs_port": 70000}, {"obs_port": 0},
                                {"flight_recorder": "dir"}])
def test_observability_config_matches_reference(kw):
    """The reference's fields, defaults and messages; ``enable`` arms what
    the config names: the pillars, the flight recorder (its directory) and
    the live endpoint, and ``disable`` takes them down."""
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(obs.ObservabilityConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JObservabilityConfig)])
    try:
        want = JObservabilityConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            obs.ObservabilityConfig(**kw)
        assert str(got.value) == str(e)
        return
    cfg = obs.ObservabilityConfig(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    obs.enable(cfg)
    try:
        assert obs.get_registry().enabled == cfg.metrics
        assert ttracing.tracing_enabled() == cfg.tracing
        rec = obs.get_flight_recorder()
        assert (rec is not None) == bool(cfg.flight_recorder)
        if isinstance(cfg.flight_recorder, str):
            assert rec.out_dir == cfg.flight_recorder
        assert (obs.server.get_global() is not None) == (cfg.obs_port is not None)
    finally:
        obs.disable()
    assert obs.get_flight_recorder() is None and obs.server.get_global() is None


def test_names_tables_are_the_references():
    """The reference's tables, and beside its spans exactly the port's own:
    the sweep's and the split's phases the benchmark reads."""
    assert tnames.METRIC_NAMES == jnames.METRIC_NAMES
    assert tnames.METRIC_TEMPLATES == jnames.METRIC_TEMPLATES
    assert jnames.SPAN_NAMES <= tnames.SPAN_NAMES
    assert tnames.SPAN_NAMES - jnames.SPAN_NAMES == tnames.PORT_SPAN_NAMES == {
        "eval.call", "eval.stats_forward", "eval.importance", "eval.codec", "eval.suffix",
        "eval.nll_tail", "split.stage", "split.cross", "split.unembed", "eval.nll",
        "moe.route", "moe.experts", "moe.combine", "mix.conv"}
    for pat in ("edgellm_link_*_total", "edgellm_link_x_total", "edgellm_nope", "split.hop",
                "edgellm_link_*z_total"):
        assert tnames.metric_registered(pat) == jnames.metric_registered(pat)
        assert tnames.span_registered(pat) == jnames.span_registered(pat)


_SPAN = re.compile(r"""(?:obs_span|device_span|\bspan)\(\s*(f?)["']([^"']+)["']""")
_METRIC = re.compile(r"""\.(?:counter|gauge|histogram)\(\s*(f?)["']([^"']+)["']""")
_CTOR = re.compile(r"""\b(?:Counter|Gauge|Histogram)\(\s*(f?)["']([^"']+)["']""")


def test_every_span_and_metric_literal_of_the_port_is_registered():
    """Every literal span / metric name at a call site in the port's
    sources is registered in its ``obs/names.py`` (an f-string's holes as
    ``*``)."""
    found = {"span": set(), "metric": set()}
    for path in sorted((REPO / "edgellm_tpu_torch").rglob("*.py")):
        text = path.read_text()
        for kind, pat in (("span", _SPAN), ("metric", _METRIC), ("metric", _CTOR)):
            for fstr, name in pat.findall(text):
                if fstr:
                    name = re.sub(r"\{[^}]*\}", "*", name)
                found[kind].add(name)
    found["span"].discard("name")  # the tracer's own parameter in docstrings
    assert {"split.hop", "generate_split.prefill", "serve.execute", "batch.step",
            "eval.submit_group", "recovery.checkpoint_save", "eval.call",
            "split.cross"} <= found["span"]
    assert {"serve_requests_total", "edgellm_wire_bytes_total",
            "edgellm_pipeline_stage_occupancy", "edgellm_link_*_total"} <= found["metric"]
    for name in found["span"]:
        assert tnames.span_registered(name), name
    for name in found["metric"]:
        assert tnames.metric_registered(name), name


# ---------- the hooks ----------

def test_tokens_identical_with_and_without_observing(armed):
    """generate_split, pipelined and over a faulty link, with metrics,
    tracing and a LatencyObserver armed gives the tokens and link counters
    of the unobserved run; the hooks publish the pipeline, wire, decode and
    latency series and one ``split.hop`` span a cut with the µ-batch count."""
    from edgellm_tpu_torch.codecs.faults import FaultConfig, LinkPolicy
    from edgellm_tpu_torch.models import PRESETS, init_params
    from edgellm_tpu_torch.parallel import PipelineConfig, SplitConfig, SplitRuntime
    from edgellm_tpu_torch.serve.decode import generate_split

    cfg = PRESETS["tiny-qwen2"]
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 6))

    def run():
        rt = SplitRuntime(cfg, SplitConfig((1, 3), ("int8_per_token",) * 2), ["cpu"] * 3,
                          pipeline=PipelineConfig(2), faults=FaultConfig(drop_rate=0.2, seed=3),
                          policy=LinkPolicy(max_retries=4))
        return rt, rt.place_params(params)

    observer = obs.LatencyObserver()
    with tcontext.bind(rid="r5"):
        rt, placed = run()
        stats: dict = {}
        on = generate_split(rt, placed, ids, 6, stats=stats, observe=observer)
    obs.disable()
    rt_off, placed_off = run()
    off = generate_split(rt_off, placed_off, ids, 6)
    np.testing.assert_array_equal(on.numpy(), off.numpy())
    for k, v in rt.link_counters().items():
        np.testing.assert_array_equal(v, rt_off.link_counters()[k])
    assert stats["token_latency_p50_s"] > 0 and observer.token_latency.count == 5
    reg = obs.get_registry()
    for name in ("edgellm_pipeline_microbatches", "edgellm_pipeline_stage_occupancy",
                 "edgellm_wire_bytes_total", "edgellm_decode_steps_total",
                 "edgellm_decode_ttft_seconds", "edgellm_link_hops_total"):
        assert reg.get(name) is not None, name
    assert reg.get("edgellm_wire_bytes_total").value(hop=0, kind="decode") == 5 * sum(
        rt.pipelined_decode_hop_bytes(4)[:1])
    hops = [s for s in obs.get_tracer().spans() if s.name == "split.hop"]
    assert [s.args["hop"] for s in hops] == [0, 1]
    assert all(s.args["microbatches"] == 2 and s.args["rid"] == "r5" for s in hops)
    names = {s.name for s in obs.get_tracer().spans()}
    assert {"generate_split.prefill", "generate_split.decode_loop"} <= names
