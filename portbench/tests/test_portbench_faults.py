"""A run with the timed path broken underneath reads ``correct`` false:
the harness's look for a chip is skipped (the tiny preset on the CPU),
everything else runs as in a run, against each cell's own limits. For each
fault the cell's kind can have: an answer or a token altered where it is
produced, half of a batch left out, the exchange between the split's
stages left out. A decode step that leaves the KV pool unchanged moves the
tiny model's flat logits too little to read, so that fault is held at the
cell's own size on the card (``test_portbench_card.py``)."""
from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import small_ctx

CELLS = {"table-fp32": "table-fp32.qwen2-0.5b", "split4-fp32": "split4-fp32.qwen2-1.5b",
         "serve-closed": "serve-closed.qwen2-0.5b"}


def correct(traffic: str, seconds: float = 1.0) -> bool:
    ctx = small_ctx(traffic, seconds=seconds)
    ctx.cell = CELLS[traffic]
    kind = harness.load_kind(ctx.mix["kind"])
    st = kind.setup(ctx)
    win = kind.window(ctx, st, seconds, None)
    kind.release(st)
    checks = kind.check(ctx, win)
    return bool(checks) and all(c.ok for c in checks)


def _alter_nll(monkeypatch, module):
    orig = module.nll_tail if hasattr(module, "nll_tail") else module.nll_from_logits
    name = "nll_tail" if hasattr(module, "nll_tail") else "nll_from_logits"
    monkeypatch.setattr(module, name, lambda *a, **kw: orig(*a, **kw) + 1e-2)


def _half_groups(monkeypatch, module):
    orig = module._iter_window_groups

    def half(*a, **kw):
        for group in orig(*a, **kw):
            yield group[: max(1, len(group) // 2)]
    monkeypatch.setattr(module, "_iter_window_groups", half)


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_sound_run_is_correct(traffic):
    assert correct(traffic, seconds=2.0 if traffic == "serve-closed" else 1.0)


def test_sweep_faults_fail(monkeypatch):
    traffic = "table-fp32"
    from edgellm_tpu_torch.eval import harness as ev

    with monkeypatch.context() as m:
        _alter_nll(m, ev)
        assert not correct(traffic)
    with monkeypatch.context() as m:
        _half_groups(m, ev)
        assert not correct(traffic)


def test_split_faults_fail(monkeypatch):
    from edgellm_tpu_torch.codecs import packing
    from edgellm_tpu_torch.eval import split_eval

    with monkeypatch.context() as m:
        _alter_nll(m, split_eval)
        assert not correct("split4-fp32")
    with monkeypatch.context() as m:
        _half_groups(m, split_eval)
        assert not correct("split4-fp32")
    # the exchange left out: every hop hands its hidden on as it is
    ident = packing.get_wire_codec("fp32")
    with monkeypatch.context() as m:
        m.setattr(split_eval, "parse_hop_codec", lambda spec, n_seq=1: ident)
        assert not correct("split4-fp32")


def test_serve_faults_fail(monkeypatch):
    from edgellm_tpu_torch.serve import batching

    orig = batching._batched_sample

    def worst_token(logits, keys, steps, temps):   # a token altered where it is drawn
        toks = orig(logits, keys, steps, temps)
        return torch.where(torch.as_tensor(temps == 0.0, device=logits.device),
                           logits.argmin(dim=-1).to(toks.dtype), toks)

    def half_batch(logits, keys, steps, temps):    # half of the slots left out
        toks = orig(logits, keys, steps, temps)
        toks[toks.shape[0] // 2:] = 0
        return toks

    for fault in (worst_token, half_batch):
        with monkeypatch.context() as m:
            m.setattr(batching, "_batched_sample", fault)
            assert not correct("serve-closed", seconds=2.0)
