"""Batched serving in a closed loop: ``serve.batching.ContinuousBatcher``
with ``submit`` / ``step`` on the real clock, one client a slot, each
client sending its next request as soon as its last one completes.

Requests are drawn in rounds: round k gives every client one request, and
the multiset of sizes in a round is fixed by the mix alone (prompt and
output lengths log-normal, clipped; a fixed share greedy, the rest sampled
at the mix's temperature), so every seed asks for the same work. The seed
decides which client gets which size in each round, the prompts' ids and
the sampling seeds. Round 0's outputs are drawn from the residual of the
length-biased output distribution, so completions are staggered from the
start. Set-up admits round 0 and warms the step; the window then measures
``decode_tokens_per_s``: every token the streams produced inside the
window, over the window. Beside it, as per-layer readings (their spread
between runs needs a bound past the 25 % a bound may take, PERF.md): the
95th percentiles of the time to the first token, over the requests whose
first token came in the window, from the client's submit to the end of the
``step()`` that returned it, and of the time per output token, over the
requests completed in the window, (last token - first token) / (tokens -
1).

``correct``: after the window, greedy requests that finished, drawn from
the seed with the longest of them always in, are run once through the
plain reference over prompt and served tokens; the widest gap by which a
served token's logit lies below the reference's best is compared.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness, weights
from portbench.kinds.sweep import DTYPES, AttentionBounds, port_config
from portbench.reference import serve as ref_serve
from portbench.yardstick import attention as ya
from portbench.yardstick import flops as yf
from portbench.yardstick.peaks import bound_s

#: the stream of the fixed size tables (the same for every seed)
SIZES_STREAM = 0


def _lognormal(rng, spec: dict, n: int) -> np.ndarray:
    x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.round(x), spec["min"], spec["max"]).astype(np.int64)


def _residual(rng, spec: dict, n: int) -> np.ndarray:
    """Residual lengths of a length-biased draw: what is left of the
    requests in flight when a steady loop is looked at."""
    pool = _lognormal(rng, spec, 64 * n)
    picked = rng.choice(pool, size=n, p=pool / pool.sum())
    return np.maximum(1 + np.floor(rng.random(n) * picked).astype(np.int64), spec["min"])


class Requests:
    """Each client's requests, round by round."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.clients = mix["clients"]
        self.rounds: list = []
        self.next_round = [0] * self.clients

    def _round(self, k: int):
        while len(self.rounds) <= k:
            r = len(self.rounds)
            n, mix = self.clients, self.mix
            fixed = weights.rng(SIZES_STREAM, 100 + r)
            prompts = _lognormal(fixed, mix["prompt_len"], n)
            outs = (_residual(fixed, mix["output_len"], n) if r == 0
                    else _lognormal(fixed, mix["output_len"], n))
            greedy = np.arange(n) < round(mix["greedy_share"] * n)
            own = weights.rng(self.seed, 10_000 + r)
            perm = own.permutation(n)
            self.rounds.append({"prompt": prompts[perm], "out": outs[perm],
                                "greedy": greedy[own.permutation(n)],
                                "rng_seed": own.integers(0, 2 ** 31 - 1, size=n),
                                "ids_rng": own})
        return self.rounds[k]

    def next(self, client: int) -> dict:
        k = self.next_round[client]
        self.next_round[client] += 1
        rd = self._round(k)
        if "ids" not in rd:
            rd["ids"] = [rd["ids_rng"].integers(0, self.vocab, size=int(p)) for p in rd["prompt"]]
        return {"client": client, "round": k, "prompt": rd["ids"][client],
                "max_new_tokens": int(rd["out"][client]),
                "temperature": 0.0 if rd["greedy"][client] else float(self.mix["temperature"]),
                "rng_seed": int(rd["rng_seed"][client])}


def batching_config(mix: dict):
    from edgellm_tpu_torch.serve.batching import BatchingConfig

    slots, pps = mix["max_slots"], mix["pages_per_slot"]
    return BatchingConfig(page_size=mix["page_size"], num_pages=slots * pps + 1,
                          max_slots=slots, pages_per_slot=pps,
                          cache_dtype=DTYPES[mix["dtype"]], compute_dtype=None)


class Loop:
    """The clients around one batcher: submit, step, and the timestamps."""

    def __init__(self, ctx, batcher, requests: Requests):
        self.ctx, self.b, self.req = ctx, batcher, requests
        self.live: dict = {}        # sid -> request record
        self.done: list = []
        self.totals = {"tokens": 0, "steps": 0, "step_s": 0.0, "flops": 0.0, "slots": 0.0}
        self.step_times: list = []

    def submit(self, client: int, now: float):
        r = self.req.next(client)
        sid = self.b.submit(r["prompt"], r["max_new_tokens"], temperature=r["temperature"],
                            rng_seed=r["rng_seed"])
        r.update(sid=sid, submit=now, first=None)
        self.live[sid] = r

    def step(self):
        cfg, pool, tot = self.ctx.cfg, self.b.pool, self.totals
        waiting = [sid for sid, r in self.live.items() if r["first"] is None]
        t = time.perf_counter()
        advanced = self.b.step()
        now = time.perf_counter()
        tot["step_s"] += now - t
        tot["steps"] += 1
        self.step_times.append(now - t)
        # the caches each decoding stream attended to: the running ones as
        # they stand now, the finished ones at their last length
        lens = [int(pool.lengths[slot]) - 1 for slot in self.b._slot_to_sid]
        tot["slots"] += len(lens) / self.ctx.mix["max_slots"]
        admitted = 0
        for sid in waiting:
            st = self.b._streams.get(sid)
            if st is None or st.status != "waiting":
                self.live[sid]["first"] = now
                admitted += 1
                tot["flops"] += yf.prefill_flops(cfg, len(self.live[sid]["prompt"]))
        for sid in [s for s in self.live if s in self.b.results]:
            r = self.live.pop(sid)
            toks = self.b.pop_result(sid)
            r.update(end=now, n=len(toks), tokens=toks)
            self.done.append(r)
            lens.append(len(r["prompt"]) + len(toks) - 2)
            self.submit(r["client"], now)
        tot["flops"] += yf.decode_flops(cfg, lens[:advanced])
        tot["tokens"] += advanced + admitted


def setup(ctx: harness.Ctx) -> dict:
    from edgellm_tpu_torch.serve.batching import ContinuousBatcher

    cfg, mix = ctx.cfg, ctx.mix
    params = weights.make_weights(cfg, ctx.seed, DTYPES[mix["dtype"]], ctx.device)
    batcher = ContinuousBatcher(port_config(cfg), params, batching_config(mix))
    loop = Loop(ctx, batcher, Requests(mix, ctx.seed, cfg["vocab_size"]))
    now = time.perf_counter()
    for c in range(mix["clients"]):
        loop.submit(c, now)
    # round 0 admitted (its prefills) and the step warm before the window
    for _ in range(mix["warm_steps"]):
        loop.step()
    return {"loop": loop, "params": params}


class K13Bounds:
    """Wraps the paged decode attention (K13) in the traced slice: each
    call's bound from the pool's host lengths at the call (the rows every
    running slot attends to, its new one included)."""

    def __init__(self, counters: dict, batcher, cfg: dict, itemsize: int):
        self.c, self.b, self.cfg, self.item = counters, batcher, cfg, itemsize

    def __enter__(self):
        from edgellm_tpu_torch.models import paged_kv

        self.mod, self.saved = paged_kv, paged_kv.paged_decode_attention

        def call(q, k_pages, v_pages, page_table, lengths, **kw):
            lens = self.b.pool.lengths
            live = int(sum(int(l) + 1 for l in lens if l > 0))
            nb, nf = ya.paged_decode_bytes_flops(
                live, q.shape[0], self.cfg["num_attention_heads"],
                self.cfg["num_key_value_heads"], self.cfg["head_dim"], self.item)
            self.c["k13_bound_s"] = self.c.get("k13_bound_s", 0.0) + bound_s(nb, nf, "bfloat16")
            return self.saved(q, k_pages, v_pages, page_table, lengths, **kw)

        paged_kv.paged_decode_attention = call
        return self

    def __exit__(self, *exc):
        self.mod.paged_decode_attention = self.saved
        return False


def _ttft_ms(reqs) -> list:
    return [(r["first"] - r["submit"]) * 1e3 for r in reqs]


def _tpot_ms(reqs) -> list:
    return [(r["end"] - r["first"]) * 1e3 / (r["n"] - 1) for r in reqs]


def _p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95)) if values else None


def window(ctx, st, seconds: float, tracer) -> harness.Window:
    loop, mix = st["loop"], ctx.mix
    start = dict(loop.totals)
    done_before = len(loop.done)
    first_step = len(loop.step_times)
    traced, in_slice, span = False, None, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if tracer is not None and not traced and time.perf_counter() - t0 >= seconds / 3:
            traced = True
            item = torch.finfo(DTYPES[mix["dtype"]]).bits // 8
            before = dict(loop.totals)
            span = [time.perf_counter(), None]
            with tracer.slice() as trace, AttentionBounds(trace.counters, mix["dtype"]), \
                    K13Bounds(trace.counters, loop.b, ctx.cfg, item):
                for _ in range(mix["traced_steps"]):
                    loop.step()
            span[1] = time.perf_counter()
            in_slice = {k: loop.totals[k] - before[k] for k in before}
            continue
        loop.step()
    elapsed = time.perf_counter() - t0
    tot = {k: loop.totals[k] - start[k] for k in start}
    firsts = [r for r in loop.done[done_before:] + list(loop.live.values())
              if r["first"] is not None and r["first"] >= t0]
    finished = loop.done[done_before:]
    completed = [r for r in finished if r["n"] > 1 and r["first"] >= t0]
    ttft, tpot = _ttft_ms(firsts), _tpot_ms(completed)
    # the tails of a traced run leave out every request the slice touched
    clear = (lambda r: True) if span is None else (  # noqa: E731
        lambda r: r.get("end", float("inf")) < span[0] or r["submit"] > span[1])
    # the per-layer readings over the untraced part of the window
    plain = dict(tot)
    if in_slice:
        plain = {k: tot[k] - in_slice[k] for k in tot}
        plain["seconds"] = elapsed - in_slice["step_s"]
    else:
        plain["seconds"] = elapsed
    counters = {"dtype": mix["dtype"], "max_slots": mix["max_slots"],
                "window_steps": plain["steps"], "window_step_s": plain["step_s"],
                "window_flops": plain["flops"], "window_seconds": plain["seconds"],
                "slot_share": plain["slots"] / max(plain["steps"], 1),
                "ttft_n": len(ttft), "tpot_n": len(tpot),
                "ttft_p95_ms": _p95(_ttft_ms([r for r in firsts if clear(r)])),
                "tpot_p95_ms": _p95(_tpot_ms([r for r in completed if clear(r)]))}
    st_ms = np.asarray(loop.step_times[first_step:]) * 1e3
    if st_ms.size:
        counters["step_ms_quantiles"] = [float(x)
                                         for x in np.percentile(st_ms, [10, 50, 90, 99, 100])]
    return harness.Window(
        metrics={"decode_tokens_per_s": tot["tokens"] / elapsed},
        counters=counters, answers=finished,
        attempted=len(finished) + len(loop.live), failed=0)


def release(st: dict):
    st.clear()


def sampled_requests(ctx, win: harness.Window) -> list:
    """Finished greedy requests to check: the longest, then others drawn
    from the seed, up to the mix's ``check_tokens`` served tokens."""
    greedy = [r for r in win.answers if r["temperature"] == 0.0]
    if not greedy:
        return []
    greedy.sort(key=lambda r: -r["n"])
    picked, rest = [greedy[0]], greedy[1:]
    order = weights.rng(ctx.seed, 3).permutation(len(rest))
    total = greedy[0]["n"]
    for i in order:
        if total >= ctx.mix["check_tokens"]:
            break
        picked.append(rest[i])
        total += rest[i]["n"]
    return picked


def readings(ctx, win: harness.Window, control=None) -> dict:
    """The widest gap (logits) between the reference's best token and the
    served token (the token the control puts first, with ``control``),
    over the sampled greedy requests; and the share of sampled requests
    that finished with fewer tokens than they asked for (exact)."""
    picked = sampled_requests(ctx, win)
    if not picked:
        return {"served_logit_gap": float("nan"), "short_requests": float("nan")}
    params = weights.make_weights(ctx.cfg, ctx.seed, DTYPES[ctx.mix["dtype"]], ctx.device)
    gap = max(ref_serve.widest_gap(ctx.cfg, params, r["prompt"], r["tokens"], control)
              for r in picked)
    short = sum(1 for r in picked if r["n"] != r["max_new_tokens"])
    return {"served_logit_gap": gap, "short_requests": float(short)}


def check(ctx, win: harness.Window) -> list:
    limits = harness.load_limits(ctx.cell)
    return [harness.Check(k, v, limits.get(k, float("nan")))
            for k, v in readings(ctx, win).items()]
