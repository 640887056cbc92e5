"""On the card, at each cell's own size: a short window of the program
reads ``correct`` true, the control (the reference one arithmetic step
below the configuration's, in the program's place) fails at least one of
the cell's limits, and the serve cell's KV-pool fault fails too. Needs a
card; skips here. ``python -m pytest -m cuda portbench/tests`` on the card."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.calibrate import CONTROL

CELLS = ["table-fp32.qwen2-0.5b", "split4-fp32.qwen2-1.5b", "serve-closed.qwen2-0.5b"]
SEED = 2 ** 31 + 4242


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels of the port run only there")


def _cell_ctx(name: str, seconds: float) -> tuple:
    from portbench.run import _caches

    _caches()
    bench = harness.load_benchmark()
    names = {c["name"] for c in bench["workloads"]}
    if name not in names:
        pytest.skip(f"{name} is not a cell of BENCHMARK.json")
    cell = harness.find_cell(bench, name)
    mix = harness.load_json("traffic", cell["traffic"])
    ctx = harness.Ctx(cell=name, cfg=harness.load_json("configs", cell["config"]), mix=mix,
                      seed=SEED, seconds=seconds, trace=False)
    return ctx, harness.load_kind(mix["kind"])


def _window(ctx, kind, seconds: float):
    st = kind.setup(ctx)
    win = kind.window(ctx, st, seconds, None)
    kind.release(st)
    return win


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name):
    _card()
    ctx, kind = _cell_ctx(name, 8.0)
    win = _window(ctx, kind, 8.0)
    limits = harness.load_limits(name)
    assert all(c.ok for c in kind.check(ctx, win))
    control = kind.readings(ctx, win, control=CONTROL[ctx.mix["dtype"]])
    assert any(v > limits[k] for k, v in control.items()), control


@pytest.mark.cuda
def test_serve_pool_left_unchanged_fails(monkeypatch):
    _card()
    from edgellm_tpu_torch.serve import batching

    step = batching.paged_decode_step

    def pool_unchanged(cfg, params, pool_k, pool_v, *a, **kw):
        keep_k, keep_v = pool_k.clone(), pool_v.clone()
        out = step(cfg, params, pool_k, pool_v, *a, **kw)
        pool_k.copy_(keep_k)
        pool_v.copy_(keep_v)
        return out

    ctx, kind = _cell_ctx("serve-closed.qwen2-0.5b", 8.0)
    monkeypatch.setattr(batching, "paged_decode_step", pool_unchanged)
    win = _window(ctx, kind, 8.0)
    assert not all(c.ok for c in kind.check(ctx, win))
