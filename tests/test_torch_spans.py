"""The port's spans under a ``torch.profiler`` capture with tracing off: a
span is kept by the tracer and shows in the capture as a CPU range (never a
user annotation), stamped on the capture's clock; ``device_span`` times its
body on a CUDA stream (``device_ms`` None off CUDA); and the token sweep and
the split eval open exactly their span trees, with the same NLLs and hop
bytes as with nothing live.

The last test is marked ``cuda`` and skips without a card. On a machine
with a card but no JAX: ``python -m pytest --noconftest tests/test_torch_spans.py``.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from edgellm_tpu_torch.eval.harness import run_token_sweep
from edgellm_tpu_torch.eval.split_eval import run_split_eval
from edgellm_tpu_torch.models import PRESETS, init_params
from edgellm_tpu_torch.obs import tracing

SWEEP = dict(methods=["regular_importance", "last_row"], layers_of_interest=[4, 1],
             ratios=[0, 0.5, 1.0], max_length=64, stride=32, window_batch=4, max_chunks=8)
SPLIT = dict(cuts=[1, 3], hop_codecs=["int8_per_token", "int4_per_token"], max_length=64,
             stride=32, window_batch=4, max_chunks=8, time_hops=False)


@pytest.fixture
def tracer():
    """The global tracer, off and empty for the test and after it."""
    tr = tracing.get_tracer()
    tr.clear()
    assert not tracing.tracing_enabled()
    yield tr
    tr.clear()


@pytest.fixture(scope="module")
def model():
    cfg = PRESETS["tiny-qwen2"]
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, 400)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), ids


def _parents(spans):
    """{span: its innermost enclosing span on the same thread, or None}."""
    out = {}
    for s in spans:
        encl = [p for p in spans if p is not s and p.tid == s.tid and p.ts_us <= s.ts_us
                and s.ts_us + s.dur_us <= p.ts_us + p.dur_us]
        out[s] = min(encl, key=lambda p: p.dur_us) if encl else None
    return out


def _tree(spans):
    """Counter of (span name, its parent's name)."""
    par = _parents(spans)
    return collections.Counter((s.name, par[s].name if par[s] else None) for s in spans)


def test_span_under_a_bare_capture_is_a_cpu_range(tracer):
    assert tracing.span("eval.call") is tracing.span("split.stage")  # the shared null
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("eval.call", entry="x") as s:
            assert s is not None
            torch.ones(4) + 1
    assert [(t.name, t.args) for t in tracer.spans()] == [("eval.call", {"entry": "x"})]
    got = [e for e in prof.events() if e.name == "eval.call"]
    assert len(got) == 1 and got[0].device_type == torch.autograd.DeviceType.CPU
    assert not got[0].is_user_annotation
    assert tracing.span("eval.call") is tracing.span("split.stage")
    assert tracing.device_span("eval.suffix", "cpu") is tracing.span("eval.call")


def test_span_ts_is_on_the_capture_clock(tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with tracing.span("eval.drain_group", chunk=i):
                torch.ones(4) + 1
    mine = sorted(s.ts_us * 1e3 for s in tracer.spans())
    theirs = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "eval.drain_group")
    assert len(mine) == len(theirs) == 5
    assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1e6


def test_device_span_on_cpu_has_no_device_ms(tracer):
    tracing.configure(enabled=True)
    try:
        with tracing.device_span("split.stage", torch.device("cpu"), stage=0) as s:
            torch.ones(4) + 1
    finally:
        tracing.configure(enabled=False)
    assert s.device_ms is None and "device_ms" not in s.to_event()["args"]
    assert [t.name for t in tracer.spans()] == ["split.stage"]


def test_token_sweep_span_tree(tracer, model):
    """Three window groups (chunk 0 alone: it scores its whole window), two
    methods, two layers, one ratio-0 baseline and two ranked ratios."""
    cfg, params, ids = model
    off = run_token_sweep(cfg, params, ids, device="cpu", **SWEEP)
    assert tracer.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = run_token_sweep(cfg, params, ids, device="cpu", **SWEEP)
    assert np.array_equal(on.total_nll, off.total_nll) and on.n_tokens == off.n_tokens
    groups, pairs = 3, 2 * 2  # (layer, method) pairs
    assert _tree(tracer.spans()) == {
        ("eval.call", None): 1,
        ("eval.submit_group", "eval.call"): groups,
        ("eval.drain_group", "eval.call"): groups,
        ("eval.stats_forward", "eval.submit_group"): groups,
        ("eval.importance", "eval.submit_group"): groups,
        ("eval.codec", "eval.submit_group"): groups * pairs,
        ("eval.suffix", "eval.submit_group"): groups * pairs,
        ("eval.nll_tail", "eval.submit_group"): groups * (pairs + 1),
    }
    subs = [s for s in tracer.spans() if s.name == "eval.submit_group"]
    assert [s.args["chunk"] for s in subs] == [0, 1, 5]
    assert all(s.device_ms is None for s in tracer.spans())


@pytest.mark.parametrize("pipeline", [None, {"num_microbatches": 2}])
def test_split_eval_span_tree(tracer, model, pipeline):
    """Two window groups of four through three stages and two cuts: one
    ``split.cross`` a cut and one ``split.stage`` a stage, each µ-batch its
    own under a pipeline."""
    cfg, params, ids = model
    off = run_split_eval(cfg, params, ids, device="cpu", pipeline=pipeline, **SPLIT)
    assert tracer.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = run_split_eval(cfg, params, ids, device="cpu", pipeline=pipeline, **SPLIT)
    assert on["total_nll"] == off["total_nll"]
    assert on["measured_hop_bytes_total"] == off["measured_hop_bytes_total"]
    groups, m = 2, (pipeline or {}).get("num_microbatches", 1)
    assert _tree(tracer.spans()) == {
        ("eval.call", None): 1,
        ("eval.submit_group", "eval.call"): groups,
        ("eval.drain_group", "eval.call"): groups,
        ("eval.checkpoint_write", "eval.call"): 1,
        ("split.stage", "eval.submit_group"): groups * 3 * m,
        ("split.cross", "eval.submit_group"): groups * 2 * m,
        ("split.unembed", "eval.submit_group"): groups,
        ("eval.nll", "eval.submit_group"): groups,
    }
    stages = [s for s in tracer.spans() if s.name == "split.stage"]
    assert collections.Counter(s.args["stage"] for s in stages) == {0: 2 * m, 1: 2 * m, 2: 2 * m}
    if m > 1:
        assert {s.args["microbatch"] for s in stages} == {0, 1}
    crosses = [s for s in tracer.spans() if s.name == "split.cross"]
    assert collections.Counter((s.args["hop"], s.args["codec"]) for s in crosses) == {
        (0, "int8_per_token"): 2 * m, (1, "int4_per_token"): 2 * m}
    assert all(s.args["tier"] == 0 for s in tracer.spans() if s.name == "eval.submit_group")


@pytest.mark.cuda
def test_device_span_times_the_stream_without_a_sync(tracer):
    """On the card: live device spans under a CUDA capture sync nothing
    (sync debug mode "error"), add no device row, and read ``device_ms``
    once the stream has passed them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans time a CUDA stream")
    x = torch.randn(512, 512, device="cuda")

    def work(spans: bool):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                if spans:
                    with tracing.device_span("split.stage", x.device, stage=0):
                        y = x @ x
                    with tracing.device_span("split.cross", "cuda", hop=0, codec="fp32"):
                        y = y + 1
                else:
                    y = (x @ x) + 1
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA), y

    plain, y0 = work(False)
    assert tracer.spans() == []
    spanned, y1 = work(True)
    assert spanned == plain and torch.equal(y0, y1)
    got = {s.name: s.device_ms for s in tracer.spans()}
    assert set(got) == {"split.stage", "split.cross"} and all(v > 0 for v in got.values())
