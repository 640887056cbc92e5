"""At the tiny preset on the CPU, what each kind's timed calls produce
agrees with the plain reference, and the check reads it so."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests.conftest import small_ctx

KINDS = {"table-fp32": "sweep", "sweep-bf16": "sweep", "split4-fp32": "split",
         "serve-closed": "serve_closed"}


def run_window(traffic: str, seed: int = 2 ** 33 + 7, seconds: float = 1.0):
    ctx = small_ctx(traffic, seed, seconds)
    kind = harness.load_kind(ctx.mix["kind"])
    st = kind.setup(ctx)
    win = kind.window(ctx, st, seconds, None)
    kind.release(st)
    return ctx, kind, win


@pytest.mark.parametrize("traffic", sorted(KINDS))
def test_program_agrees_with_reference(traffic):
    ctx, kind, win = run_window(traffic)
    assert win.attempted >= 1
    read = kind.readings(ctx, win)
    for name, value in read.items():
        tol = 0.0 if name in ("loss_tokens_gap", "hop_bytes_gap", "short_requests") else 1e-5
        assert value <= tol, (traffic, name, value)


def test_window_reports_its_end_to_end_metrics():
    _, _, win = run_window("serve-closed", seconds=2.0)
    assert set(win.metrics) == {"decode_tokens_per_s"}
    assert win.counters["ttft_p95_ms"] > 0 and win.counters["tpot_p95_ms"] > 0
    assert all(v > 0 for v in win.metrics.values())
    _, _, win = run_window("split4-fp32")
    assert win.metrics["scored_tokens_per_s"] > 0
