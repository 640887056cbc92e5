"""The real split: ``eval.split_eval.run_split_eval`` over a synthetic corpus,
the model cut after each layer of ``cuts`` and every cut crossed as a
packed payload through its hop codec (``time_hops=False``: no extra hop
timing, only the work the user asked for).

The window is a run of calls, each over the next ``chunks_per_call`` chunks
of the corpus. Every window of a call is full length (the first one scores
all of its positions, which costs nothing more here: the split scores the
whole window's logits anyway), and the rate counts one stride a chunk.

``correct``: one call drawn from the seed is recomputed by the plain
reference (each stage's layers, both hops' round trips, the NLL of every
window) and its mean NLL and per-hop payload bytes compared.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness, weights
from portbench.kinds.sweep import DTYPES, AttentionBounds, port_config
from portbench.reference import codecs as ref_codecs
from portbench.reference import split as ref_split
from portbench.yardstick import codecs as yc
from portbench.yardstick import flops as yf

CODEC_KERNELS = ("int4_encode", "int4_decode", "int8_affine_encode", "int8_affine_decode")


def slice_tokens(mix: dict, call: int, n_corpus: int) -> tuple[int, int]:
    """[begin, end) of call ``call``'s slice: chunks 0 .. C - 1, all full."""
    c, stride = mix["chunks_per_call"], mix["stride"]
    span = mix["max_length"] + (c - 1) * stride
    calls = (n_corpus - span) // (c * stride) + 1
    begin = (call % calls) * c * stride
    return begin, begin + span


def setup(ctx: harness.Ctx) -> dict:
    from edgellm_tpu_torch.eval.split_eval import run_split_eval

    cfg, mix = ctx.cfg, ctx.mix
    st = {"pc": port_config(cfg), "run": run_split_eval,
          "params": weights.make_weights(cfg, ctx.seed, DTYPES[mix["dtype"]], ctx.device),
          "ids": weights.corpus(ctx.seed, mix["corpus_tokens"], cfg["vocab_size"])}
    _call(ctx, st, 0, chunks=mix["window_batch"])   # warm-up: one group
    return st


def _call(ctx, st, call: int, chunks=None) -> tuple[dict, int]:
    mix = ctx.mix
    begin, end = slice_tokens(mix, call, len(st["ids"]))
    res = st["run"](st["pc"], st["params"], st["ids"][begin:end], cuts=mix["cuts"],
                    hop_codecs=mix["hop_codecs"], max_length=mix["max_length"],
                    stride=mix["stride"], max_chunks=chunks or mix["chunks_per_call"],
                    time_hops=False, window_batch=mix["window_batch"], device=ctx.device)
    return res, begin


def window(ctx, st, seconds: float, tracer) -> harness.Window:
    mix = ctx.mix
    calls = []
    traced_call = 1 if tracer is not None else -1
    t0 = time.perf_counter()
    j = 0
    while True:
        t = time.perf_counter()
        if j == traced_call:
            with tracer.slice() as trace, AttentionBounds(trace.counters, mix["dtype"]):
                res, begin = _call(ctx, st, j)
            trace.counters["chunks"] = res["chunks"]
        else:
            res, begin = _call(ctx, st, j)
        calls.append({"call": j, "chunks": res["chunks"], "seconds": time.perf_counter() - t,
                      "traced": j == traced_call, "total_nll": float(res["total_nll"]),
                      "n_tokens": float(res["n_tokens"]),
                      "hop_bytes": [int(b) for b in res["measured_hop_bytes_total"]]})
        j += 1
        if time.perf_counter() - t0 >= seconds and j > traced_call:
            break
    elapsed = time.perf_counter() - t0
    plain = [c for c in calls if not c["traced"]]
    counters = {"dtype": mix["dtype"],
                "chunk_flops": yf.split_window_flops(ctx.cfg, mix["max_length"]),
                "window_chunks": sum(c["chunks"] for c in plain),
                "window_seconds": sum(c["seconds"] for c in plain)}
    return harness.Window(
        metrics={"scored_tokens_per_s":
                 sum(c["chunks"] for c in calls) * mix["stride"] / elapsed},
        counters=counters, answers=calls, attempted=len(calls))


def codec_bound_s(ctx, trace) -> float:
    """The least time of the wire codec launches the slice recorded: each
    launch over one window group's (W * S, D) rows."""
    from portbench.yardstick.peaks import PEAK_BYTES_PER_S

    mix = ctx.mix
    n, d = mix["window_batch"] * mix["max_length"], ctx.cfg["hidden_size"]
    item = torch.finfo(DTYPES[mix["dtype"]]).bits // 8
    total = 0.0
    for name, (calls, _) in trace.rows.items():
        for k in CODEC_KERNELS:
            if k in name:
                total += calls * yc.codec_bytes(k, n, d, item) / PEAK_BYTES_PER_S
    return total


def release(st: dict):
    st.clear()


def sampled_calls(ctx, win: harness.Window) -> list:
    """The calls the check recomputes: ``check_calls`` of them drawn from
    the seed (all of them in a shorter window)."""
    calls = win.answers
    k = min(ctx.mix["check_calls"], len(calls))
    return [calls[i] for i in sorted(weights.rng(ctx.seed, 3).choice(len(calls), k, replace=False))]


def inputs(ctx) -> tuple:
    """Weights and ids made anew from the seed, for the reference."""
    mix = ctx.mix
    return (weights.make_weights(ctx.cfg, ctx.seed, DTYPES[mix["dtype"]], ctx.device),
            weights.corpus(ctx.seed, mix["corpus_tokens"], ctx.cfg["vocab_size"]))


def reference(ctx, call: dict, params, ids, arith: str = "fp32") -> dict:
    mix = ctx.mix
    begin, end = slice_tokens(mix, call["call"], len(ids))
    nll, tokens = ref_split.split_eval(ctx.cfg, params, ids[begin:end], mix,
                                       chunks=call["chunks"], arith=arith)
    per_token = [ref_codecs.payload_bytes(c, ctx.cfg["hidden_size"]) for c in mix["hop_codecs"]]
    return {"total_nll": nll, "n_tokens": tokens,
            "hop_bytes": [call["chunks"] * mix["max_length"] * b for b in per_token]}


def gaps(got: list, want: list) -> dict:
    """The numbers compared over the sampled calls: loss tokens and hop
    bytes (exact, the widest gap), and the mean over the calls of each
    call's mean-NLL gap (nats). One call's gap swings with the int4 hop:
    a difference far below float32 rounding moves a code across a rounding
    boundary, and the call's NLL with it, so the mean over several calls is
    what separates the program from the control (PERF.md)."""
    nll = [abs(g["total_nll"] / max(g["n_tokens"], 1.0) - w["total_nll"] / max(w["n_tokens"], 1.0))
           for g, w in zip(got, want)]
    return {"loss_tokens_gap": max(abs(g["n_tokens"] - w["n_tokens"]) for g, w in zip(got, want)),
            "hop_bytes_gap": max(float(np.abs(np.subtract(g["hop_bytes"], w["hop_bytes"])).max())
                                 for g, w in zip(got, want)),
            "mean_nll_gap": float(np.mean(nll))}


def readings(ctx, win: harness.Window, control=None) -> dict:
    """The numbers compared for the sampled calls: the program's outputs
    against the reference, or with ``control`` (an arithmetic of
    ``reference/model.py``) the reference in that arithmetic against
    itself in float32."""
    calls = sampled_calls(ctx, win)
    params, ids = inputs(ctx)
    want = [reference(ctx, c, params, ids) for c in calls]
    got = calls if control is None else [reference(ctx, c, params, ids, control) for c in calls]
    return gaps(got, want)


def check(ctx, win: harness.Window) -> list:
    limits = harness.load_limits(ctx.cell)
    return [harness.Check(k, v, limits.get(k, float("nan")))
            for k, v in readings(ctx, win).items()]
