"""The token sweep, as a researcher runs it: ``eval.harness.run_token_sweep``
over a synthetic corpus, (method x layer x ratio) at the mix's window,
stride and window batch.

The window is a run of calls, each over the next ``chunks_per_call`` chunks
of the corpus, resumed from the program's own checkpoint at chunk 1 of its
slice, so that every chunk scores one stride as in the middle of a long run
and no call pays the corpus's first whole-window chunk. The rate is the
chunks completed times the stride over the whole window.

``correct``: one call drawn from the seed is recomputed by the plain
reference (statistics forward, importance, the simulated int4 codec at the
boundary, the suffix and the scored tail) and its table of mean NLLs
compared entry by entry.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import harness, weights
from portbench.reference import sweep as ref_sweep
from portbench.yardstick import attention as ya
from portbench.yardstick import flops as yf
from portbench.yardstick.peaks import bound_s

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_config(cfg: dict):
    """The port's preset for a configuration file, held to its widths."""
    from edgellm_tpu_torch.models.configs import PRESETS

    pc = PRESETS[cfg["preset"]]
    got = (pc.hidden_size, pc.num_layers, pc.num_heads, pc.num_kv_heads, pc.head_dim,
           pc.intermediate_size, pc.vocab_size, pc.tie_word_embeddings)
    want = (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"], cfg["intermediate_size"],
            cfg["vocab_size"], cfg["tie_word_embeddings"])
    if got != want:
        raise SystemExit(f"portbench: preset {cfg['preset']} is {got}, the file says {want}")
    return pc


def slice_tokens(mix: dict, call: int, n_corpus: int) -> tuple[int, int]:
    """[begin, end) of call ``call``'s corpus slice: chunk 0 of the slice is
    skipped, chunks 1 .. C are scored."""
    span = mix["max_length"] + mix["chunks_per_call"] * mix["stride"]
    step = mix["chunks_per_call"] * mix["stride"]
    calls = (n_corpus - span) // step + 1
    begin = (call % calls) * step
    return begin, begin + span


def setup(ctx: harness.Ctx) -> dict:
    from edgellm_tpu_torch.eval.harness import run_token_sweep

    mix, cfg = ctx.mix, ctx.cfg
    st = {"pc": port_config(cfg), "run": run_token_sweep,
          "params": weights.make_weights(cfg, ctx.seed, DTYPES[mix["dtype"]], ctx.device),
          "ids": weights.corpus(ctx.seed, mix["corpus_tokens"], cfg["vocab_size"]),
          "hw": head_weights(ctx),
          "dir": tempfile.mkdtemp(prefix="portbench-sweep-")}
    # warm-up: one call of one window group, every shape of the timed calls
    _call(ctx, st, 0, chunks=mix["window_batch"])
    return st


def head_weights(ctx):
    """Per-layer head weights (L, H) drawn from the seed, where a method
    reads them (``weighted_importance``; LRP makes them in a real run)."""
    if "weighted_importance" not in ctx.mix["methods"]:
        return None
    shape = (ctx.cfg["num_hidden_layers"], ctx.cfg["num_attention_heads"])
    return weights.rng(ctx.seed, 4).random(shape).astype(np.float32)


def _axes(mix: dict) -> dict:
    return {"methods": list(mix["methods"]), "layers_of_interest": list(mix["layers_of_interest"]),
            "ratios": list(mix["ratios"])}


def _call(ctx, st, call: int, chunks=None):
    """One call of the entry over call ``call``'s slice -> (SweepResult,
    slice begin)."""
    mix = ctx.mix
    begin, end = slice_tokens(mix, call, len(st["ids"]))
    shape = (len(mix["methods"]), len(mix["layers_of_interest"]), len(mix["ratios"]))
    path = os.path.join(st["dir"], "resume.json")
    with open(path, "w") as f:   # resume at chunk 1 of the slice
        json.dump({"next_chunk": 1, "axes": _axes(mix), "chunks": 0, "wall_s": 0.0,
                   "total_nll": np.zeros(shape).tolist(), "n_tokens": 0.0}, f)
    res = st["run"](st["pc"], st["params"], st["ids"][begin:end],
                    methods=mix["methods"], layers_of_interest=mix["layers_of_interest"],
                    ratios=mix["ratios"], max_length=mix["max_length"], stride=mix["stride"],
                    window_batch=mix["window_batch"], head_weights=st["hw"],
                    max_chunks=chunks or mix["chunks_per_call"],
                    checkpoint_path=path, checkpoint_every=1 << 30, device=ctx.device)
    return res, begin


def chunk_flops(ctx) -> float:
    mix = ctx.mix
    return yf.sweep_chunk_flops(ctx.cfg, mix["max_length"], mix["stride"], len(mix["methods"]),
                                mix["layers_of_interest"], mix["ratios"])


class AttentionBounds:
    """Wraps K-attn and K-stats in the traced slice: each call's roofline
    bound is summed from its shapes (``kattn_bound_s``, ``kstats_bound_s``)."""

    def __init__(self, counters: dict, dtype: str):
        self.c, self.dtype = counters, dtype

    def __enter__(self):
        from edgellm_tpu_torch.models import transformer as tr

        self.tr = tr
        self.saved = (tr.causal_attention, tr.causal_attention_stats)
        tr.causal_attention = self._wrap(self.saved[0], "kattn_bound_s", False)
        tr.causal_attention_stats = self._wrap(self.saved[1], "kstats_bound_s", True)
        return self

    def __exit__(self, *exc):
        self.tr.causal_attention, self.tr.causal_attention_stats = self.saved
        return False

    def _wrap(self, fn, key: str, stats: bool):
        def call(q, k, v, **kw):
            b, s, h, hd = q.shape
            nb, nf = ya.causal_attention_bytes_flops(b, s, h, k.shape[2], hd,
                                                     q.element_size(), stats=stats)
            self.c[key] = self.c.get(key, 0.0) + bound_s(nb, nf, self.dtype)
            return fn(q, k, v, **kw)
        return call


def window(ctx, st, seconds: float, tracer) -> harness.Window:
    mix = ctx.mix
    calls, counters = [], {"dtype": mix["dtype"]}
    traced_call = 1 if tracer is not None else -1
    t0 = time.perf_counter()
    j = 0
    while True:
        t = time.perf_counter()
        if j == traced_call:
            with tracer.slice() as trace, AttentionBounds(trace.counters, mix["dtype"]):
                res, begin = _call(ctx, st, j)
            trace.counters["chunks"] = res.chunks
        else:
            res, begin = _call(ctx, st, j)
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
    return harness.Window(
        metrics={"scored_tokens_per_s": chunks * mix["stride"] / elapsed},
        counters=counters, answers=calls, attempted=len(calls))


def release(st: dict):
    shutil.rmtree(st.pop("dir"), ignore_errors=True)
    st.clear()


def sampled_call(ctx, win: harness.Window) -> dict:
    """The call the check recomputes, drawn from the seed."""
    calls = win.answers
    return calls[int(weights.rng(ctx.seed, 3).integers(0, len(calls)))]


def reference(ctx, call: dict, arith: str = "fp32") -> tuple:
    """The plain reference's (NLL sums, loss tokens) of one call's chunks,
    from weights and ids made anew from the seed."""
    mix = ctx.mix
    params = weights.make_weights(ctx.cfg, ctx.seed, DTYPES[mix["dtype"]], ctx.device)
    ids = weights.corpus(ctx.seed, mix["corpus_tokens"], ctx.cfg["vocab_size"])
    begin, end = slice_tokens(mix, call["call"], len(ids))
    return ref_sweep.token_sweep(ctx.cfg, params, ids[begin:end], mix, first_chunk=1,
                                 chunks=call["chunks"], head_weights=head_weights(ctx),
                                 arith=arith)


def gaps(got: tuple, want: tuple) -> dict:
    """The numbers compared: the loss-token count (exact) and the widest gap
    between two tables of mean NLL (nats)."""
    (g_nll, g_tok), (w_nll, w_tok) = got, want
    gap = np.abs(g_nll / max(g_tok, 1.0) - w_nll / max(w_tok, 1.0))
    return {"loss_tokens_gap": abs(g_tok - w_tok), "mean_nll_gap": float(gap.max())}


def readings(ctx, win: harness.Window, control=None) -> dict:
    """The numbers compared for the sampled call: the program's outputs
    against the reference, or with ``control`` (an arithmetic of
    ``reference/model.py``) the reference in that arithmetic against
    itself in float32."""
    call = sampled_call(ctx, win)
    want = reference(ctx, call)
    got = ((call["total_nll"], call["n_tokens"]) if control is None
           else reference(ctx, call, control))
    return gaps(got, want)


def check(ctx, win: harness.Window) -> list:
    limits = harness.load_limits(ctx.cell)
    return [harness.Check(k, v, limits.get(k, float("nan")))
            for k, v in readings(ctx, win).items()]
