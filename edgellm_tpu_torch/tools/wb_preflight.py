"""Window-batch preflight: pick the largest batch that fits, before the
sweep runs into an out-of-memory (PyTorch counterpart of
``edgellm_tpu/tools/wb_preflight.py``).

The reference sizes the batch from XLA's ahead-of-time memory analysis of
the sweep's executables, which allocates nothing. torch has none, so the
port probes: it runs the sweep's two big calls, the stats forward and the
ratio-batched suffix sweep (and the baseline tail scorer where the codec
scores ratio 0 from the stats forward's continuation), at window batch 1
and 2 on the card, reads each call's peak (``analysis/aot.py``), and fits
the peak as linear in the batch: ``peak(W) = a + b * W``, where ``a`` holds
the resident weights and ``b`` a window's activations. On top of the worst
call the sweep keeps TWO boundary-hidden stacks alive (the drained group's
and the in-flight next group's, from the submit / drain double buffering)
plus the captured stats, which are added analytically as the reference
adds them. ``budget_frac`` absorbs what the estimate cannot see (allocator
slack, fragmentation, the small calls). The budget is the card's
``total_memory`` x ``budget_frac``; ``BENCH_HBM_GB`` overrides the card's
size, as in the reference.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..analysis.aot import call_total_bytes, is_over_hbm

__all__ = ["estimate_sweep_peak_bytes", "largest_fitting_window_batch",
           "largest_fitting_relevance_batch", "preflight_token_sweep_batch", "is_over_hbm"]

#: the probe batches the linear fit is read from
PROBE_BATCHES = (1, 2)


def _budget_bytes(hbm_bytes: Optional[int], budget_frac: float, device="cuda") -> int:
    if hbm_bytes is None:
        hbm_bytes = int(float(os.environ.get("BENCH_HBM_GB", "0")) * 2 ** 30)
        if not hbm_bytes:
            hbm_bytes = torch.cuda.get_device_properties(torch.device(device)).total_memory
    return int(hbm_bytes * budget_frac)


def _probe_params(cfg, params, dtype, device) -> dict:
    if params is not None:
        return params
    from ..models import init_params

    return init_params(cfg, torch.Generator(device=device).manual_seed(0), dtype=dtype,
                       device=device)


def _linear(points: dict) -> Optional[tuple]:
    """{batch: peak bytes or None} at :data:`PROBE_BATCHES` -> (a, b) of
    ``a + b * W``, or None when a probe ran out of memory."""
    if any(v is None for v in points.values()):
        return None
    (w1, p1), (w2, p2) = sorted(points.items())
    slope = (p2 - p1) / (w2 - w1)
    return p1 - slope * w1, slope


def probe_sweep_costs(cfg, max_length: int, tail: int, layer: int, codec: str,
                      n_ratios: int, dtype, layers: Optional[Sequence[int]] = None, *,
                      params: Optional[dict] = None, device="cuda",
                      peak_reader: Optional[Callable] = None) -> dict:
    """Each of the sweep's big calls run at :data:`PROBE_BATCHES` ->
    {"stats_call", "suffix_call", "base_call"}: each a linear fit (a, b)
    of its peak bytes in the window batch (None when a probe ran out of
    memory; ``base_call`` (0, 0) where no baseline scorer runs).
    ``peak_reader(call)`` reads a call's peak bytes (default: the card's
    allocator)."""
    from ..eval.harness import DEDUP_ZERO_CODECS, _stats_forward, _suffix_sweep
    from ..models.transformer import nll_tail

    layers = tuple(int(x) for x in (layers if layers is not None else (layer,)))
    params = _probe_params(cfg, params, dtype, device)
    want_final = codec in DEDUP_ZERO_CODECS
    gen = np.random.default_rng(0)
    s, d = max_length, cfg.hidden_size
    ratios = torch.linspace(0.25, 0.75, n_ratios, device=device)
    ks = [int(float(r) * s) for r in ratios.tolist()]
    points: dict = {"stats_call": {}, "suffix_call": {}, "base_call": {}}
    for w in PROBE_BATCHES:
        ids = torch.as_tensor(gen.integers(0, cfg.vocab_size, (w, s)), device=device)
        targets = torch.as_tensor(gen.integers(0, cfg.vocab_size, (w, s)), device=device)
        hidden = torch.randn((w, s, d), device=device).to(dtype)
        imp = torch.rand((w, s), device=device)
        with torch.inference_mode():
            points["stats_call"][w] = call_total_bytes(
                lambda: _stats_forward(cfg, params, ids, layers, want_final=want_final),
                device, peak_reader)
            points["suffix_call"][w] = call_total_bytes(
                lambda: _suffix_sweep(cfg, params, layer, codec, tail, hidden, targets, imp,
                                      ratios, ks), device, peak_reader)
            points["base_call"][w] = (call_total_bytes(
                lambda: nll_tail(cfg, params, hidden, targets, tail, per_example=True),
                device, peak_reader) if want_final else 0)
        del ids, targets, hidden, imp
    return {name: _linear(p) for name, p in points.items()}


def _at(fit: Optional[tuple], w: int) -> float:
    return float("inf") if fit is None else fit[0] + fit[1] * w


def estimate_from_costs(cfg, costs: dict, window_batch: int, max_length: int, dtype,
                        layers: Sequence[int]) -> dict:
    """The sweep's estimated peak at ``window_batch`` from
    :func:`probe_sweep_costs`' fits (bytes): the worst call plus the live
    group state its arguments do not hold, as the reference adds it."""
    layers = tuple(int(x) for x in layers)
    w, s, d = window_batch, max_length, cfg.hidden_size
    stats, suffix, base = (_at(costs[k], w) for k in ("stats_call", "suffix_call", "base_call"))
    itemsize = torch.empty((), dtype=dtype).element_size()
    hiddens_stack = len(set(layers)) * w * s * d * itemsize  # collected boundaries
    stats_buf = 2 * (max(layers) + 1) * w * cfg.num_heads * s * 4  # col_mean + last_row
    # the suffix sees one (W, S, D) slice as an argument while BOTH groups'
    # stacks are alive (submit / drain double buffering)
    peak = max(stats + hiddens_stack, suffix + 2 * hiddens_stack + 2 * stats_buf,
               base + 2 * hiddens_stack + 2 * stats_buf)
    return {"stats_call": stats, "suffix_call": suffix, "base_call": base,
            "hiddens_stack": hiddens_stack, "peak": peak}


def estimate_sweep_peak_bytes(cfg, window_batch: int, max_length: int, tail: int, layer: int,
                              codec: str, n_ratios: int, dtype,
                              layers: Optional[Sequence[int]] = None, **probe) -> dict:
    """Estimated device-memory peak of the token sweep at one window batch
    (bytes), from probes at batch 1 and 2 (:func:`probe_sweep_costs`;
    ``probe`` its keywords). ``layers`` is the full ``layers_of_interest``
    tuple (defaults to ``(layer,)``)."""
    layers = tuple(layers) if layers is not None else (layer,)
    costs = probe_sweep_costs(cfg, max_length, tail, layer, codec, n_ratios, dtype, layers,
                              **probe)
    return estimate_from_costs(cfg, costs, window_batch, max_length, dtype, layers)


def preflight_token_sweep_batch(cfg, requested: int, *, max_length: int, stride: int,
                                layers_of_interest: Sequence[int], ratios: Sequence[float],
                                dtype, codec: str = "int4_token_select",
                                hbm_bytes: Optional[int] = None, budget_frac: float = 0.8,
                                **probe) -> int:
    """Sweep-shaped wrapper around :func:`largest_fitting_window_batch`,
    shared by the CLI and the chip run: sizes the EARLIEST split layer
    (longest suffix, biggest call) and counts the ratio axis the way
    run_token_sweep batches it (nonzero ratios only for dedup codecs)."""
    from ..eval.harness import DEDUP_ZERO_CODECS

    n_ratios = (sum(1 for r in ratios if float(r) != 0.0)
                if codec in DEDUP_ZERO_CODECS else len(ratios))
    wb, _ = largest_fitting_window_batch(
        cfg, requested, max_length=max_length, tail=stride + 1,
        layer=min(int(x) for x in layers_of_interest), codec=codec,
        n_ratios=max(n_ratios, 1), dtype=dtype, hbm_bytes=hbm_bytes,
        budget_frac=budget_frac, layers=tuple(int(x) for x in layers_of_interest), **probe)
    return wb


def largest_fitting_relevance_batch(cfg, requested: int, *, max_length: int, dtype,
                                    hbm_bytes: Optional[int] = None, budget_frac: float = 0.8,
                                    min_window_batch: int = 1, params: Optional[dict] = None,
                                    device="cuda", peak_reader: Optional[Callable] = None) -> int:
    """Largest window batch whose LRP backward fits: its peak probed at
    batch 1 and 2 and fitted linearly (the (L, W, H, S, S) probabilities
    and their cotangents dominate), then halved from ``requested``."""
    from ..importance.relevance import chunk_relevance

    budget = _budget_bytes(hbm_bytes, budget_frac, device)
    params = _probe_params(cfg, params, dtype, device)
    gen = np.random.default_rng(0)
    points = {}
    for w in PROBE_BATCHES:
        ids = torch.as_tensor(gen.integers(0, cfg.vocab_size, (w, max_length)), device=device)
        points[w] = call_total_bytes(lambda: chunk_relevance(cfg, params, ids), device,
                                     peak_reader)
    fit = _linear(points)
    wb = requested
    while wb > min_window_batch:
        if _at(fit, wb) <= budget:
            return wb
        wb = max(wb // 2, min_window_batch)
    return wb


def largest_fitting_window_batch(cfg, requested: int, *, max_length: int, tail: int,
                                 layer: int, codec: str, n_ratios: int, dtype,
                                 hbm_bytes: Optional[int] = None, budget_frac: float = 0.8,
                                 min_window_batch: int = 1,
                                 layers: Optional[Sequence[int]] = None, **probe) -> tuple:
    """Halve ``requested`` until the estimated peak fits -> (wb, estimate).
    The probes run once; each candidate reads the fit."""
    layers = tuple(layers) if layers is not None else (layer,)
    budget = _budget_bytes(hbm_bytes, budget_frac, probe.get("device", "cuda"))
    costs = probe_sweep_costs(cfg, max_length, tail, layer, codec, n_ratios, dtype, layers,
                              **probe)
    wb = requested
    while True:
        est = estimate_from_costs(cfg, costs, wb, max_length, dtype, layers)
        if est["peak"] <= budget or wb <= min_window_batch:
            return wb, est
        wb = max(wb // 2, min_window_batch)
