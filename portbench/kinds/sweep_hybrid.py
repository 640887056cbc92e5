"""The token sweep over a hybrid sparse-expert model (LFM2-MoE), as a
researcher runs it: ``eval.harness.run_token_sweep`` over a synthetic
corpus, (method x attention layer x ratio), each call over the next
``chunks_per_call`` chunks resumed at chunk 1 of its slice, as
``kinds/sweep.py`` runs the dense table (its slicing, resume and gaps are
reused from there).

The traced call sums the roofline bound of the grouped expert products
from the rows each one ran (``yardstick/moe.py``). The expert layer's
counters (``moe.read_counters``) are kept over the check's own forward of
the sampled call's first reference batch, inside ``moe.counting`` (so the
timed calls run without them), and join the window's counters: rows routed
to the held experts, rows of each layer call's busiest held expert, and
dropped rows, held rows whose result no product wrote (the products'
outputs start as NaN there).

``correct``: one call drawn from the seed is recomputed by the plain
reference (``reference/lfm2_moe.py``, float32, TF32 off) and its table of
mean NLLs compared entry by entry; the share of (token, MoE layer) top-k
sets that the program and the reference pick differently in the first
reference batch's statistics forward is reported beside it
(``route_flip_share``, not limited: near-tie flips are the expected source
of the gap).
"""
from __future__ import annotations

import sys
import tempfile
import time

import torch

from portbench import harness, weights, weights_lfm2
from portbench.reference import lfm2_moe as ref_lfm2
from portbench.yardstick import flops_lfm2
from portbench.yardstick import moe as ymoe
from portbench.yardstick.peaks import bound_s

_sweep = harness.load_kind("sweep")
DTYPES = _sweep.DTYPES
#: the numbers a run is held to (``limits/<cell>.json``)
COMPARED = ("loss_tokens_gap", "mean_nll_gap")


def port_config(cfg: dict):
    """The port's preset for a configuration file, held to its widths and
    its layer pattern and expert share."""
    from edgellm_tpu_torch.models.configs import PORT_PRESETS

    pc = PORT_PRESETS[cfg["preset"]]
    # the router's renormalisation and 1.0 scale are constants of moe.route
    got = (pc.family, pc.hidden_size, pc.num_layers, pc.num_heads, pc.num_kv_heads,
           pc.head_dim, pc.intermediate_size, pc.vocab_size, pc.tie_word_embeddings,
           list(pc.layer_types), pc.num_dense_layers, pc.conv_kernel, pc.num_experts,
           pc.expert_offset, pc.router_experts, pc.num_experts_per_tok,
           pc.moe_intermediate_size, pc.norm_eps, pc.rope_theta, True, 1)
    want = (cfg["model_type"], cfg["hidden_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"],
            cfg["intermediate_size"], cfg["vocab_size"], cfg["tie_word_embeddings"],
            cfg["layer_types"], cfg["num_dense_layers"], cfg["conv_L_cache"],
            cfg["num_experts"], cfg["expert_offset"], cfg["router_experts"],
            cfg["num_experts_per_tok"], cfg["moe_intermediate_size"], cfg["norm_eps"],
            cfg["rope_theta"], cfg["norm_topk_prob"], cfg["routed_scaling_factor"])
    if got != want:
        raise SystemExit(f"portbench: preset {cfg['preset']} is {got}, the file says {want}")
    return pc


def setup(ctx: harness.Ctx) -> dict:
    from edgellm_tpu_torch.eval.harness import run_token_sweep

    mix, cfg = ctx.mix, ctx.cfg
    st = {"pc": port_config(cfg), "run": run_token_sweep,
          "params": weights_lfm2.make_weights(cfg, ctx.seed, DTYPES[mix["dtype"]], ctx.device),
          "ids": weights.corpus(ctx.seed, mix["corpus_tokens"], cfg["vocab_size"]),
          "hw": None, "dir": tempfile.mkdtemp(prefix="portbench-hybrid-")}
    # warm-up: one call of one window group, every shape of the timed calls
    _sweep._call(ctx, st, 0, chunks=mix["window_batch"])
    return st


def chunk_flops(ctx) -> float:
    mix = ctx.mix
    return flops_lfm2.sweep_chunk_flops(ctx.cfg, mix["max_length"], mix["stride"],
                                        len(mix["methods"]), mix["layers_of_interest"],
                                        mix["ratios"])


class ExpertBounds:
    """Records the row offsets of every grouped expert product of the traced
    call (device tensors, read after the slice): :meth:`bound_s` sums their
    roofline bound from the rows each ran."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from edgellm_tpu_torch.models import moe

        self.moe, self.saved = moe, moe.experts_ffn

        def ffn(x, planes13, planes2, offsets, fill=None):
            self.calls.append((offsets, planes13.hi.shape[0], planes13.k, planes2.k))
            return self.saved(x, planes13, planes2, offsets, fill)

        moe.experts_ffn = ffn
        return self

    def __exit__(self, *exc):
        self.moe.experts_ffn = self.saved
        return False

    def bound_s(self, dtype: str) -> float:
        total = 0.0
        for offsets, experts, d, f in self.calls:
            off = offsets.tolist()
            nb, nf = ymoe.experts_bytes_flops(off[-1] - off[0], experts, d, f)
            total += bound_s(nb, nf, dtype)
        return total


def window(ctx, st, seconds: float, tracer) -> harness.Window:
    mix = ctx.mix
    calls, counters = [], {"dtype": mix["dtype"]}
    traced_call = 1 if tracer is not None else -1
    t0 = time.perf_counter()
    j = 0
    while True:
        t = time.perf_counter()
        if j == traced_call:
            experts = ExpertBounds()
            with tracer.slice() as trace, _sweep.AttentionBounds(trace.counters, mix["dtype"]), \
                    experts:
                res, begin = _sweep._call(ctx, st, j)
            trace.counters["chunks"] = res.chunks
        else:
            res, begin = _sweep._call(ctx, st, j)
        dt = time.perf_counter() - t
        calls.append({"call": j, "begin": begin, "chunks": res.chunks, "seconds": dt,
                      "traced": j == traced_call, "total_nll": res.total_nll.copy(),
                      "n_tokens": float(res.n_tokens)})
        j += 1
        if time.perf_counter() - t0 >= seconds and j > traced_call:
            break
    elapsed = time.perf_counter() - t0
    chunks = sum(c["chunks"] for c in calls)
    plain = [c for c in calls if not c["traced"]]
    counters.update(
        chunk_flops=chunk_flops(ctx), window_chunks=sum(c["chunks"] for c in plain),
        window_seconds=sum(c["seconds"] for c in plain))
    if tracer is not None:
        trace.counters["experts_bound_s"] = experts.bound_s(mix["dtype"])
    return harness.Window(
        metrics={"scored_tokens_per_s": chunks * mix["stride"] / elapsed},
        counters=counters, answers=calls, attempted=len(calls))


release = _sweep.release
sampled_call = _sweep.sampled_call


def reference(ctx, call: dict, params: dict, arith: str = "fp32", routes=None) -> tuple:
    """The plain reference's (NLL sums, loss tokens) of one call's chunks."""
    mix = ctx.mix
    ids = weights.corpus(ctx.seed, mix["corpus_tokens"], ctx.cfg["vocab_size"])
    begin, end = _sweep.slice_tokens(mix, call["call"], len(ids))
    return ref_lfm2.token_sweep(ctx.cfg, params, ids[begin:end], mix, first_chunk=1,
                                chunks=call["chunks"], arith=arith, routes=routes)


def program_routes(ctx, call: dict, params: dict) -> tuple:
    """The port's (T, k) picks at every MoE layer of a full forward over
    the reference's first batch of the call's windows, and the expert
    layer's counters over that forward."""
    from edgellm_tpu_torch.models import moe
    from edgellm_tpu_torch.models.transformer import embed, run_layers

    mix = ctx.mix
    ids = weights.corpus(ctx.seed, mix["corpus_tokens"], ctx.cfg["vocab_size"])
    begin, end = _sweep.slice_tokens(mix, call["call"], len(ids))
    ins, _, _ = ref_lfm2.windows(ids[begin:end], mix["max_length"], mix["stride"], 1,
                                 min(call["chunks"], ref_lfm2.BATCH))
    x_ids = torch.as_tensor(ins, device=params["embed"].device)
    picks, saved = [], moe.route

    def keep(*args, **kw):
        w, p = saved(*args, **kw)
        picks.append(p)
        return w, p

    moe.route = keep
    moe.read_counters(reset=True)
    try:
        with torch.inference_mode(), moe.counting():
            run_layers(port_config(ctx.cfg), params, embed(params, x_ids), capture_stats=True)
    finally:
        moe.route = saved
    return picks, moe.read_counters(reset=True)


def route_flip_share(got: list, want: list) -> float:
    """Share of (token, MoE layer) top-k sets that differ."""
    flips = total = 0
    for g, w in zip(got, want):
        g, w = g.sort(dim=-1).values, w.to(g.device).sort(dim=-1).values
        flips += int((g != w).any(dim=-1).sum())
        total += g.shape[0]
    return flips / max(total, 1)


def readings(ctx, win: harness.Window, control=None) -> dict:
    """The numbers compared for the sampled call: the program's outputs
    against the reference, or with ``control`` (an arithmetic of
    ``reference/lfm2_moe.py``) the reference in that arithmetic against
    itself in float32; the program's route-flip share and the expert
    layer's counters beside them."""
    mix = ctx.mix
    call = sampled_call(ctx, win)
    params = weights_lfm2.make_weights(ctx.cfg, ctx.seed, DTYPES[mix["dtype"]], ctx.device)
    routes = []
    want = reference(ctx, call, params, routes=routes)
    if control is not None:
        return _sweep.gaps(reference(ctx, call, params, control), want)
    out = _sweep.gaps((call["total_nll"], call["n_tokens"]), want)
    picks, counts = program_routes(ctx, call, params)
    out["route_flip_share"] = route_flip_share(picks, routes)
    return {**out, **counts}


def check(ctx, win: harness.Window) -> list:
    limits = harness.load_limits(ctx.cell)
    from edgellm_tpu_torch.models import moe

    got = readings(ctx, win)
    win.counters.update({k: got[k] for k in moe.COUNTER_NAMES})
    print(f"check route_flip_share: {got['route_flip_share']!r} (not limited)", file=sys.stderr)
    return [harness.Check(k, got[k], limits.get(k, float("nan"))) for k in COMPARED]
