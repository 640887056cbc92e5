"""The ``program_span`` readers: each on a hand-built span list (self time
with nested children, None when their spans are absent or carry no device
time), the host readers on the program's own spans of a traced CPU call,
and on the card each cell's ``--trace 1`` run reporting every one of them
(``python -m pytest -m cuda portbench/tests`` there)."""
from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.tests.conftest import small_ctx

READERS = ["enqueue_share.sweep", "driver_self_share.sweep", "stats_fwd_ms.sweep",
           "select_ms.sweep", "suffix_ms.sweep", "head_ms.sweep", "stage_ms.split",
           "hop_ms.split"]


def _span(name, ts, dur, device_ms=None, tid=1):
    return types.SimpleNamespace(name=name, ts_us=float(ts), dur_us=float(dur), tid=tid,
                                 device_ms=device_ms)


def _table_spans():
    """One call of two groups (µs): the call's own edges 100 + 60 + 40 +
    100 = 300 of 1000; a checkpoint inside the last drain and one at the
    call's end are not group time, and the leaves nest in the submits."""
    return [
        _span("eval.call", 0, 1000),
        _span("eval.submit_group", 100, 200, device_ms=0.4),
        _span("eval.stats_forward", 110, 80, device_ms=0.1),
        _span("eval.importance", 190, 10, device_ms=0.02),
        _span("eval.codec", 200, 20, device_ms=0.03),
        _span("eval.suffix", 220, 40, device_ms=0.2),
        _span("eval.nll_tail", 260, 30, device_ms=0.05),
        _span("eval.submit_group", 360, 200, device_ms=0.6),
        _span("eval.stats_forward", 370, 80, device_ms=0.15),
        _span("eval.importance", 450, 10, device_ms=0.02),
        _span("eval.codec", 460, 20, device_ms=0.03),
        _span("eval.suffix", 480, 40, device_ms=0.3),
        _span("eval.nll_tail", 520, 30, device_ms=0.1),
        _span("eval.drain_group", 560, 100),
        _span("eval.drain_group", 700, 200),
        _span("eval.checkpoint_write", 800, 50),
        _span("eval.checkpoint_write", 950, 30),
        _span("serve.submit", 100, 50, tid=2),  # another thread: never a child
    ]


def _split_spans():
    """One call of one group: three stages, two hops, the head, the NLL."""
    return [
        _span("eval.call", 0, 500),
        _span("eval.submit_group", 50, 300, device_ms=0.9),
        *[_span("split.stage", 60 + 60 * i, 30, device_ms=0.2) for i in range(3)],
        *[_span("split.cross", 90 + 60 * i, 20, device_ms=0.01) for i in range(2)],
        _span("split.unembed", 250, 40, device_ms=0.25),
        _span("eval.nll", 290, 20, device_ms=0.05),
        _span("eval.drain_group", 360, 40),
    ]


def _trace(chunks=2):
    t = harness.Trace()
    t.taken = True
    t.counters["chunks"] = chunks
    return t


def _read(name, t):
    return harness.load_metric(name).read(t, None)


def test_self_time_leaves_out_direct_children_only():
    got = _table_spans()
    call = got[0]
    assert [s.name for s in spans.children(got, call)] == [
        "eval.submit_group", "eval.submit_group", "eval.drain_group", "eval.drain_group",
        "eval.checkpoint_write"]
    assert spans.self_s(got, call, of=("eval.submit_group", "eval.drain_group")) == \
        pytest.approx(300 / 1e6)
    assert spans.self_s(got, call, of=("eval.submit_group", "eval.drain_group",
                                       "eval.checkpoint_write")) == pytest.approx(270 / 1e6)
    leaves = ("eval.stats_forward", "eval.importance", "eval.codec", "eval.suffix",
              "eval.nll_tail")
    assert spans.self_s(got, got[1], of=leaves) == pytest.approx((200 - 180) / 1e6)


def test_table_readers_on_hand_built_spans(monkeypatch):
    monkeypatch.setattr(spans, "taken", _table_spans)
    t = _trace(chunks=2)
    assert _read("enqueue_share.sweep", t) == pytest.approx(100 * 400e-6 / 1.0e-3)
    assert _read("driver_self_share.sweep", t) == pytest.approx(30.0)
    assert _read("stats_fwd_ms.sweep", t) == pytest.approx(0.25 / 2)
    assert _read("select_ms.sweep", t) == pytest.approx(0.10 / 2)
    assert _read("suffix_ms.sweep", t) == pytest.approx(0.5 / 2)
    assert _read("head_ms.sweep", t) == pytest.approx(0.15 / 2)
    assert _read("stage_ms.split", t) is None and _read("hop_ms.split", t) is None


def test_split_readers_on_hand_built_spans(monkeypatch):
    monkeypatch.setattr(spans, "taken", _split_spans)
    t = _trace(chunks=4)
    assert _read("enqueue_share.sweep", t) == pytest.approx(100 * 300e-6 / 0.9e-3)
    assert _read("driver_self_share.sweep", t) == pytest.approx(100 * 160 / 500)
    assert _read("stage_ms.split", t) == pytest.approx(0.6 / 4)
    assert _read("hop_ms.split", t) == pytest.approx(0.02 / 4)
    assert _read("head_ms.sweep", t) == pytest.approx(0.3 / 4)
    for name in ("stats_fwd_ms.sweep", "select_ms.sweep", "suffix_ms.sweep"):
        assert _read(name, t) is None, name


def test_readers_read_none_without_their_spans(monkeypatch):
    monkeypatch.setattr(spans, "taken", list)
    for name in READERS:
        assert _read(name, _trace()) is None, name
    monkeypatch.setattr(spans, "taken", _table_spans)
    for name in READERS:
        assert _read(name, harness.Trace()) is None, name  # no traced slice
    host_only = lambda: [types.SimpleNamespace(**{**vars(s), "device_ms": None})
                         for s in _table_spans()]
    monkeypatch.setattr(spans, "taken", host_only)
    assert _read("driver_self_share.sweep", _trace()) == pytest.approx(30.0)
    for name in set(READERS) - {"driver_self_share.sweep"}:
        assert _read(name, _trace()) is None, name
    monkeypatch.setattr(spans, "taken", lambda: [types.SimpleNamespace(
        name=s.name, ts_us=s.ts_us, dur_us=s.dur_us, tid=s.tid) for s in _table_spans()])
    assert _read("stats_fwd_ms.sweep", _trace()) is None  # spans with no device_ms at all


def test_host_readers_on_a_traced_cpu_call():
    """The tiny table under a bare CPU capture, as the benchmark's slice
    takes it: the program's spans give the driver's self share; off CUDA no
    span has device time, so the device readers read None."""
    from edgellm_tpu_torch.obs import tracing

    ctx = small_ctx("table-fp32")
    kind = harness.load_kind(ctx.mix["kind"])
    st = kind.setup(ctx)
    tracing.get_tracer().clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            res, _ = kind._call(ctx, st, 1)
        t = _trace(chunks=res.chunks)
        share = _read("driver_self_share.sweep", t)
        assert 0.0 < share < 100.0
        for name in set(READERS) - {"driver_self_share.sweep"}:
            assert _read(name, t) is None, name
    finally:
        tracing.get_tracer().clear()
        kind.release(st)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["table-fp32.qwen2-0.5b", "split4-fp32.qwen2-1.5b"])
def test_traced_run_reports_every_span_metric(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")
    bench = harness.load_benchmark()
    want = {m["name"] for m in bench["per_layer"]
            if m["source"] == "program_span" and cell in m["workloads"]}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 77), "--seconds", "4", "--trace", "1"],
                         cwd=harness.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and want and want <= set(line["metrics"]), (want, line["metrics"])
