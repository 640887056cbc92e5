#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``edgellm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR] [--chunks N]

from the repository root, on a machine with a CUDA card and ``nvcc``
(``/usr/local/cuda``). Phases, each of which fails the run on a fault:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``edgellm_tpu_torch/csrc`` with nvcc
   for ``sm_90a`` (one process per source, in parallel);
3. each kernel against its plain PyTorch version: the attention kernels at
   the sweep's shapes (Qwen2-0.5B, bf16 and fp32) and at the blocked
   envelope's (Pythia-70M at S=2048, Qwen2-1.5B hd=128), with stated
   tolerances; the codec kernels K1-K7 (K2 also with a (1, D) scale, through
   the int4_per_channel twin) and the fused hop K8 bit for bit at N = 4096 x
   D = 896 and 1536, and N = 1 and 511, K8's buffer byte for byte against the
   wire path's, and a flipped byte failing K8's verify;
4. timing with CUDA events: kernel, plain version, one PyTorch library call
   where one computes the same function, and the roofline bound;
5. the main path at full Qwen2-0.5B width and depth: ``run_token_sweep``,
   4 methods x layer 11 x 5 ratios, window 512, stride 32, window batch 8,
   bf16 random weights from ``--seed``, with every kernel's launch count;
   then chunk 0 and one group again, timed alone and under torch.profiler:
   device time by kernel, the card's idle share, attention FLOP/s;
6. the split main path, configs/split1_qwen_int8.json's split (Qwen2-0.5B at
   full width and depth, cut 11, int8_per_token, window 512, stride 32) through
   ``run_split_eval`` at window batch 8, ``--chunks`` chunks, time_hops on:
   s/chunk, tokens/s, peak memory, bytes/token and per-hop ms, every
   kernel's launches against the count the groups and time_hops imply, and
   one group under torch.profiler;
7. the selective split (split2's ``selective_int4:0.25:bf16``, whose
   importance pass runs K-stats), split1's cut with ``int8_per_channel``,
   ``int4_per_channel`` and ``ternary_max`` (K5-K7), configs/
   split10_qwen_fused.json with ``fused_hops`` forced to "wire" (K3 + K4)
   and "remote" (K8 alone) and as committed ("auto": no fusion on the card),
   one fused group under torch.profiler, and the three-stage multi-hop split
   (configs/split4_qwen15_multihop.json: Qwen2-1.5B, cuts 9 and 18,
   int8_per_token + int4_per_token), 9 chunks each, launches counted;
8. split cross-checks at Qwen2-0.5B width, 3 layers, fp32: an fp32-codec
   split against the unsplit model; the int8, selective, two-hop,
   per-channel and ternary splits on the card (kernels) against the CPU
   (plain versions); fused "wire" and "remote" int8 hops against the
   separate hop on the card (the same bytes decoded: identical PPL);
9. the token sweep at Qwen2 widths, 2 layers, 2 chunks, fp32, once on the card
   through the kernels and once on the CPU through the plain versions, PPL
   tables compared;
10. a JSON line of every kernel (launches summed over the counted paths,
   and by path), the ``nvidia-smi`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without a result where ``torch.cuda.is_available()`` is
false or the package is not beside it. ``--out DIR`` also writes the detail
(timings, profiles, compiler output) to ``DIR/chip_smoke_detail.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

#: kernel vs plain tolerances, (atol, rtol) as in torch.testing.assert_close:
#: fp32 differs only by summation order and the online (kernel) vs two-pass
#: (plain) softmax; in bf16 the plain version rounds the probabilities to bf16
#: before PV and the kernel keeps them fp32, and either output may land one
#: bf16 step from the other; the stats are fp32 in both from the same inputs
OUT_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
STATS_TOL = (1e-5, 0.0)
#: CUDA-vs-CPU PPL agreement of the 2-layer cross-check: the forwards agree
#: to ~1e-6, but a rank flip between two tokens whose importance differs by
#: less than that moves a token across the quantization boundary
CROSS_RTOL = 1e-3

#: split-eval PPL of an fp32 cut against the unsplit model (the same math,
#: other batch composition)
SPLIT_RTOL = 1e-5
#: split-eval PPL on the card (kernels) against the CPU (plain versions): the
#: payloads are bit-exact, the forwards differ by summation order; readings
#: on the H100 were 2.7e-7 to 3.2e-5 (the two-hop split the largest)
SPLIT_CROSS_RTOL = 1e-4

KERNELS = {
    "causal_attention": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/causal_attention.cu",
        "replaces": "edgellm_tpu/models/flash_attention.py:272",
        "also_replaces": "edgellm_tpu/models/flash_attention.py:380"},
    "causal_attention_stats": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/attention_stats.cu",
        "replaces": "edgellm_tpu/models/flash_attention.py:290",
        "also_replaces": "edgellm_tpu/models/flash_attention.py:403"},
    "int4_encode": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/int4_codec.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:98"},
    "int4_decode": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/int4_codec.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:122",
        "also_replaces": "edgellm_tpu/codecs/pallas_kernels.py:309"},
    "int8_affine_encode": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/int8_affine_codec.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:163"},
    "int8_affine_decode": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/int8_affine_codec.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:189"},
    "chan_int8_encode": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/channel_codec.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:235"},
    "chan_int8_decode": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/channel_codec.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:256"},
    "chan_int4_encode": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/channel_codec.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:288"},
    "ternary_encode": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/channel_codec.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:348"},
    "ternary_decode": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/channel_codec.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:369"},
    "remote_hop": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/remote_hop.cu",
        "replaces": "edgellm_tpu/codecs/pallas_kernels.py:876"},
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def close(got, want, tol) -> tuple[float, bool]:
    """(max |got - want|, every element within atol + rtol * |want|)."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * want.float().abs()).all())


def kernel_checks(detail: dict) -> dict:
    """Phases 3 and 4: each kernel against its plain version and timed, at
    every shape -> {kernel name: its row at the main path's shape}."""
    import torch
    import torch.nn.functional as F

    from edgellm_tpu_torch.models import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [  # (label, b, s, h, kv, hd, kernels, main-path row)
        ("qwen2-0.5b", 8, 512, 14, 2, 64, ("causal_attention", "causal_attention_stats"), True),
        ("qwen2-0.5b", 32, 512, 14, 2, 64, ("causal_attention",), True),
        ("pythia-70m", 4, 2048, 8, 8, 64, ("causal_attention", "causal_attention_stats"), False),
        ("qwen2-1.5b", 8, 512, 12, 2, 128, ("causal_attention", "causal_attention_stats"), False),
    ]
    rows, main = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for label, b, s, h, kv, hd, names, on_main in shapes:
            q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(dtype)
            for name in names:
                stats = name == "causal_attention_stats"
                kern = fa.causal_attention_stats if stats else fa.causal_attention
                plain = fa.causal_attention_stats_plain if stats else fa.causal_attention_plain
                got, want = kern(q, k, v), plain(q, k, v)
                torch.cuda.synchronize()
                if stats:
                    out_err, ok = close(got[0], want[0], OUT_TOL[dname])
                    checks = [close(g, w, STATS_TOL) for g, w in zip(got[1], want[1])]
                    st_err = max(e for e, _ in checks)
                    ok = ok and all(c for _, c in checks)
                else:
                    (out_err, ok), st_err = close(got, want, OUT_TOL[dname]), None
                nbytes, flops = fa.causal_attention_bytes_flops(
                    b, s, h, kv, hd, q.element_size(), stats=stats)
                bound, bound_by = fa.bound_ms(nbytes, flops, dtype)
                iters = max(3, min(50, int(2e11 / max(flops, 1))))
                k_ms = time_ms(lambda: kern(q, k, v), iters)
                p_ms = time_ms(lambda: plain(q, k, v), max(2, iters // 5), warmup=1)
                lib_ms = None
                if not stats:
                    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), iters)
                row = {"kernel": name, "shape": label, "dtype": dname,
                       "b": b, "s": s, "h": h, "kv": kv, "hd": hd,
                       "max_abs_err": out_err, "stats_max_abs_err": st_err,
                       "tolerance": OUT_TOL[dname],
                       "stats_tolerance": STATS_TOL if stats else None,
                       "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "bound_by": bound_by,
                       "roofline_share": bound / k_ms,
                       "tflops": flops / (k_ms * 1e-3) / 1e12}
                rows.append(row)
                log(json.dumps(row))
                if not ok:
                    raise SystemExit(f"{name} disagrees with its plain version at "
                                     f"{label} {dname}: {row}")
                if on_main and dname == "bfloat16" and name not in main:
                    # the suffix's B=32 launches dominate K-attn on the main path
                    if name == "causal_attention_stats" or b == 32:
                        main[name] = row
    detail["kernel_rows"] = rows
    return main


def main_path(args, detail: dict) -> dict:
    """Phase 5: the full-width, full-depth Qwen2-0.5B token sweep."""
    import torch

    from edgellm_tpu_torch.eval import run_token_sweep
    from edgellm_tpu_torch.models import PRESETS, init_params
    from edgellm_tpu_torch.models import flash_attention as fa
    from edgellm_tpu_torch.utils.flops import token_sweep_flops_per_chunk

    cfg = PRESETS["qwen2-0.5b"]
    methods = ["regular_importance", "weighted_importance", "last_row", "aggregate_till"]
    ratios = [0.0, 0.25, 0.5, 0.75, 1.0]
    layer, window, stride, wb = 11, 512, 32, 8
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                         dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(args.seed)
    corpus = rng.integers(0, cfg.vocab_size, window + stride * (args.chunks + 2))
    hw = rng.random((cfg.num_layers, cfg.num_heads)).astype(np.float32)
    hw /= hw.sum(axis=1, keepdims=True)
    kw = dict(methods=methods, layers_of_interest=[layer], ratios=ratios,
              max_length=window, stride=stride, head_weights=hw, window_batch=wb,
              device="cuda")
    torch.cuda.synchronize()
    log(f"main path: qwen2-0.5b bf16 random weights (seed {args.seed}) in "
        f"{time.monotonic() - t0:.1f} s")
    run_token_sweep(cfg, params, corpus, max_chunks=1 + wb, **kw)  # warm-up

    torch.cuda.reset_peak_memory_stats()
    fa.causal_attention.launches = 0
    fa.causal_attention_stats.launches = 0
    t0 = time.monotonic()
    result = run_token_sweep(cfg, params, corpus, max_chunks=args.chunks, **kw)
    wall = time.monotonic() - t0
    launches = {"causal_attention": fa.causal_attention.launches,
                "causal_attention_stats": fa.causal_attention_stats.launches}
    peak = torch.cuda.max_memory_allocated()
    log(result.table())
    ppl = result.ppl()
    n_groups = 1 + math.ceil((result.chunks - 1) / wb)  # chunk 0 runs alone
    suffix_layers = cfg.num_layers - layer - 1
    want = {"causal_attention_stats": (layer + 1) * n_groups,
            "causal_attention": (suffix_layers + len(methods) * suffix_layers) * n_groups}
    s_chunk = wall / result.chunks
    # int4_token_select is a DEDUP_ZERO_CODECS codec: ratio 0 is one shared baseline
    n_zero = sum(1 for r in ratios if r == 0.0)
    model_flops = token_sweep_flops_per_chunk(cfg, window, tail=stride,
                                              n_methods=len(methods),
                                              layers_of_interest=[layer],
                                              n_ratios=len(ratios), n_zero_ratios=n_zero)
    summary = {"chunks": result.chunks, "wall_s": wall, "s_per_chunk": s_chunk,
               "scored_tokens_per_s": result.n_tokens / wall, "window_batch": wb,
               "model_tflops_per_s": model_flops / s_chunk / 1e12,
               "max_memory_allocated_bytes": peak, "launches": launches,
               "launches_expected": want, "groups": n_groups,
               "ppl": ppl.tolist()}
    log(json.dumps({"main_path": summary}))
    detail["main_path"] = summary
    if ppl.shape != (len(methods), 1, len(ratios)) or not np.isfinite(ppl).all():
        raise SystemExit(f"main path PPL table is not finite {ppl.shape}: {ppl}")
    if result.chunks != args.chunks:
        raise SystemExit(f"main path ran {result.chunks} chunks, wanted {args.chunks}")
    if not all(launches.values()) or launches != want:
        raise SystemExit(f"kernel launches {launches} != expected {want}")
    # attention calls per window: the stats prefix, its full-depth
    # continuation, one suffix per (method, nonzero ratio)
    n_nz = len(ratios) - n_zero
    attn_calls = (layer + 1) + suffix_layers + len(methods) * n_nz * suffix_layers
    per_call = fa.causal_attention_bytes_flops(1, window, cfg.num_heads, cfg.num_kv_heads,
                                               cfg.head_dim, 2)[1]
    detail["main_path"]["profile"] = profile_group(cfg, params, corpus, kw,
                                                   attn_calls * per_call)
    return launches


def device_time(run, chunks: int) -> tuple[dict, list]:
    """Where ``run()`` (``chunks`` chunks, already warm) spends the card's
    time: its unprofiled wall time, then device time by kernel under
    torch.profiler (kernels only), and the card's idle share between the two
    -> (summary with the top 25 kernels, every kernel row)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        run()
        torch.cuda.synchronize()
    rows = [{"name": ev.key[:120], "device_ms": ev.self_device_time_total / 1e3,
             "calls": ev.count}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    return {"chunks": chunks, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if busy else None, "top": rows[:25]}, rows


def log_profile(tag: str, out: dict, n_rows: int):
    log(json.dumps({tag: {k: v for k, v in out.items() if k != "top"}}))
    for r in out["top"][:n_rows]:
        log(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d}  {r['name'][:90]}")


def profile_group(cfg, params, corpus, kw, attn_flops_per_window: float) -> dict:
    """Where chunk 0 and one steady group of the main path spend the card's
    time (:func:`device_time`), and the two attention kernels' achieved
    FLOP/s on the attention work of those chunks."""
    from edgellm_tpu_torch.eval import run_token_sweep

    n = 1 + kw["window_batch"]
    out, rows = device_time(lambda: run_token_sweep(cfg, params, corpus, max_chunks=n, **kw), n)
    attn = {k: sum(r["device_ms"] for r in rows if k in r["name"])
            for k in ("attn_fwd_kernel", "attn_col_kernel")}
    attn_ms = sum(attn.values())
    out["attention_kernel_ms"] = attn
    out["attention_tflops_per_s"] = (attn_flops_per_window * n / (attn_ms * 1e-3) / 1e12
                                     if attn_ms else None)
    log_profile("profile_one_group", out, 12)
    return out


def cross_check(args, detail: dict):
    """Phase 9: CUDA through the kernels vs CPU through the plain versions."""
    import torch

    from edgellm_tpu_torch.eval import run_token_sweep
    from edgellm_tpu_torch.models import PRESETS, init_params

    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), device="cpu")
    rng = np.random.default_rng(args.seed + 1)
    corpus = rng.integers(0, cfg.vocab_size, 512 + 32 * 4)
    hw = rng.random((cfg.num_layers, cfg.num_heads)).astype(np.float32)
    hw /= hw.sum(axis=1, keepdims=True)
    kw = dict(methods=["regular_importance", "weighted_importance", "last_row",
                       "aggregate_till"],
              layers_of_interest=[0], ratios=[0.0, 0.25, 0.5, 0.75, 1.0],
              max_length=512, stride=32, head_weights=hw, window_batch=8, max_chunks=2)
    t0 = time.monotonic()
    on_card = run_token_sweep(cfg, params, corpus, device="cuda", **kw)
    t1 = time.monotonic()
    on_cpu = run_token_sweep(cfg, params, corpus, device="cpu", **kw)
    t2 = time.monotonic()
    a, b = on_card.ppl(), on_cpu.ppl()
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    row = {"cuda_s": t1 - t0, "cpu_s": t2 - t1, "max_rel_diff": rel, "rtol": CROSS_RTOL,
           "ppl_cuda": a.tolist(), "ppl_cpu": b.tolist(), "chunks": on_card.chunks}
    log(json.dumps({"cross_check": row}))
    detail["cross_check"] = row
    if on_card.chunks != 2 or not np.isfinite(a).all() or rel > CROSS_RTOL:
        raise SystemExit(f"CUDA and CPU PPL tables disagree: {row}")


def _wrappers() -> dict:
    """Every kernel wrapper of the port by its KERNELS name."""
    from edgellm_tpu_torch.codecs import codec_kernels as ck
    from edgellm_tpu_torch.codecs import fused_hop as fh
    from edgellm_tpu_torch.models import flash_attention as fa

    return {"causal_attention": fa.causal_attention,
            "causal_attention_stats": fa.causal_attention_stats,
            "int4_encode": ck.int4_encode, "int4_decode": ck.int4_decode,
            "int8_affine_encode": ck.int8_affine_encode,
            "int8_affine_decode": ck.int8_affine_decode,
            "chan_int8_encode": ck.chan_int8_encode, "chan_int8_decode": ck.chan_int8_decode,
            "chan_int4_encode": ck.chan_int4_encode, "ternary_encode": ck.ternary_encode,
            "ternary_decode": ck.ternary_decode, "remote_hop": fh.remote_hop}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def codec_bytes(kernel: str, n: int, d: int) -> int:
    """Bytes a codec kernel must move at (N, D): each input read once, each
    output written once (the payload and its float32 scales or the (1, D)
    channel scale, the float32 activation; K8 reads the activation and
    writes the sealed buffer, the decoded activation and its flag)."""
    act, chan = 4 * n * d, 4 * d
    return {"int4_encode": act + n * d // 2 + 4 * n, "int4_decode": act + n * d // 2 + 4 * n,
            "int8_affine_encode": act + n * d + 8 * n, "int8_affine_decode": act + n * d + 8 * n,
            "chan_int8_encode": act + chan + n * d, "chan_int8_decode": act + chan + n * d,
            "chan_int4_encode": act + chan + n * d // 2,
            "ternary_encode": act + chan + n * d // 4, "ternary_decode": act + chan + n * d // 4,
            "remote_hop": 2 * act + (8 + 8 * n + n * d) + 4}[kernel]


def codec_checks(detail: dict) -> dict:
    """Phases 3 and 4 for K1-K8 (and K2 with a (1, D) channel scale, alone
    and as the int4_per_channel twin's decode): each against its plain
    version on the card, bit for bit (K8's sealed buffer byte for byte
    against the wire path's), timed beside the bound, and K8's receive over a
    flipped byte failing its verify -> {kernel name: its row at the split
    path's shape (N=4096, D=896)}."""
    import torch

    from edgellm_tpu_torch.codecs import codec_kernels as ck
    from edgellm_tpu_torch.codecs import fused_hop as fh
    from edgellm_tpu_torch.codecs.packing import get_wire_codec, sanitize_hidden
    from edgellm_tpu_torch.models import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    twin4 = get_wire_codec("int4_per_channel_pallas")
    rows, main, flips = [], {}, []
    for n, d in ((4096, 896), (4096, 1536), (1, 896), (511, 896)):
        x = torch.randn((n, d), generator=gen, device="cuda") * 3
        x[0] = 0.0
        x[n // 2] = 1.5  # a constant row: scale 0 for the affine codec
        x[(3 * n) // 4, :3] = torch.tensor([float("nan"), float("inf"), float("-inf")],
                                           device="cuda")
        x = sanitize_hidden(x)  # the codecs see saturated rows, never NaN / Inf
        packed, scale = ck.int4_encode_plain(x)
        q, sc, mn = ck.int8_affine_encode_plain(x)
        chan = torch.rand((1, d), generator=gen, device="cuda") + 0.5
        # the twins' (1, D) scales: the channel abs-max, ternary_mean's mean
        cmax = x.abs().amax(dim=0, keepdim=True)
        cscale = torch.where(cmax > 0, cmax, 1.0)
        mscale = x.mean(dim=0, keepdim=True) + 1e-8
        q8 = ck.chan_int8_encode_plain(x, cscale)
        crumbs = ck.ternary_encode_plain(x, cscale)
        p4 = twin4.encode(x[None])
        cases = [  # (kernel, label, kernel call, plain call)
            ("int4_encode", "", lambda: ck.int4_encode(x), lambda: ck.int4_encode_plain(x)),
            ("int4_decode", "", lambda: ck.int4_decode(packed, scale),
             lambda: ck.int4_decode_plain(packed, scale)),
            ("int4_decode", " (1,D) scale", lambda: ck.int4_decode(packed, chan),
             lambda: ck.int4_decode_plain(packed, chan)),
            ("int4_decode", " int4_per_channel_pallas", lambda: twin4.decode(p4)[0],
             lambda: ck.int4_decode_plain(p4["packed"][0], p4["scale"].reshape(1, d))),
            ("int8_affine_encode", "", lambda: ck.int8_affine_encode(x),
             lambda: ck.int8_affine_encode_plain(x)),
            ("int8_affine_decode", "", lambda: ck.int8_affine_decode(q, sc, mn),
             lambda: ck.int8_affine_decode_plain(q, sc, mn)),
            ("chan_int8_encode", "", lambda: ck.chan_int8_encode(x, cscale),
             lambda: ck.chan_int8_encode_plain(x, cscale)),
            ("chan_int8_decode", "", lambda: ck.chan_int8_decode(q8, cscale),
             lambda: ck.chan_int8_decode_plain(q8, cscale)),
            ("chan_int4_encode", "", lambda: ck.chan_int4_encode(x, cscale),
             lambda: ck.chan_int4_encode_plain(x, cscale)),
            ("ternary_encode", "", lambda: ck.ternary_encode(x, cscale),
             lambda: ck.ternary_encode_plain(x, cscale)),
            ("ternary_encode", " mean scale", lambda: ck.ternary_encode(x, mscale),
             lambda: ck.ternary_encode_plain(x, mscale)),
            ("ternary_decode", "", lambda: ck.ternary_decode(crumbs, cscale),
             lambda: ck.ternary_decode_plain(crumbs, cscale)),
            ("remote_hop", "", lambda: fh.remote_hop(x), lambda: fh.remote_hop_plain(x)),
        ]
        for name, label, kern, plain in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            if name == "remote_hop":  # (decoded, ok, buffer): the verify passed too
                exact = exact and bool(got[1])
            nbytes = codec_bytes(name, n, d)
            if name == "int4_decode" and label:  # a (1, D) scale instead of (N, 1)
                nbytes += 4 * d - 4 * n
            bound, bound_by = fa.bound_ms(float(nbytes), 0.0, torch.float32)
            k_ms, p_ms = time_ms(kern, 50), time_ms(plain, 20)
            row = {"kernel": name + label, "n": n, "d": d, "exact": exact,
                   "max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
                   "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
                   "bytes": nbytes, "roofline_share": bound / k_ms}
            rows.append(row)
            log(json.dumps(row))
            if not exact:
                raise SystemExit(f"{name}{label} is not bit-exact against its plain "
                                 f"version at N={n}, D={d}: {row}")
            if (n, d) == (4096, 896) and not label:
                main[name] = row
        # K8's receive over the arrived buffer: intact -> ok and the same
        # decode; one flipped payload byte -> not ok, and the hop keeps the
        # hidden (the select of fused_remote_hop)
        out, ok, buf = fh.remote_hop(x)
        again, ok_again = fh.remote_hop_receive(buf, n, d)
        bad = buf.clone()
        bad[8 + 4 * n + (n * d) // 2] ^= 0x10
        dec_bad, ok_bad = fh.remote_hop_receive(bad, n, d)
        kept = torch.where(ok_bad, dec_bad, x)
        flip = {"n": n, "d": d, "intact_ok": bool(ok_again),
                "intact_same_decode": torch.equal(again, out), "flipped_ok": bool(ok_bad),
                "flipped_keeps_hidden": torch.equal(kept, x)}
        flips.append(flip)
        log(json.dumps({"remote_hop_verify": flip}))
        if not (flip["intact_ok"] and flip["intact_same_decode"] and not flip["flipped_ok"]
                and flip["flipped_keeps_hidden"]):
            raise SystemExit(f"K8's verify failed its check at N={n}, D={d}: {flip}")
    detail["codec_rows"] = rows
    detail["remote_hop_verify"] = flips
    return main


def _split_run(args, detail: dict, cfg, params, chunks: int, label: str, expect_fn, *,
               wb: int = 8, time_hops: bool = True, **split_kw) -> dict:
    """One split-eval main path: warm-up, then every count set to 0, the run,
    the counts read and held against ``expect_fn(n_groups)``."""
    import torch

    from edgellm_tpu_torch.eval import run_split_eval

    window, stride = 512, 32
    rng = np.random.default_rng(args.seed)
    corpus = rng.integers(0, cfg.vocab_size, window + stride * (chunks + 2))
    kw = dict(max_length=window, stride=stride, window_batch=wb, device="cuda", **split_kw)
    run_split_eval(cfg, params, corpus, max_chunks=min(chunks, wb), time_hops=False, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.monotonic()
    result = run_split_eval(cfg, params, corpus, max_chunks=chunks, time_hops=time_hops, **kw)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_counts()
    n_groups = math.ceil(chunks / wb)  # every window is full length
    want = expect_fn(n_groups)
    summary = {
        "path": label, "chunks": result["chunks"], "groups": n_groups, "window_batch": wb,
        "wall_s": wall, "eval_wall_s": result["wall_s"],
        "s_per_chunk": result["wall_s"] / result["chunks"],
        "tokens_per_s": result["tokens_per_s"],
        "scored_tokens_per_s": result["scored_tokens_per_s"], "ppl": result["ppl"],
        "hop_codecs": result["hop_codecs"],
        "bytes_per_token_per_hop": result["bytes_per_token_per_hop"],
        "measured_hop_bytes_total": result["measured_hop_bytes_total"],
        "per_hop_ms": result.get("per_hop_ms"),
        "per_decode_hop_ms": result.get("per_decode_hop_ms"),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_expected": want}
    log(json.dumps({"split_path": summary}))
    detail.setdefault("split_paths", {})[label] = summary
    if result["chunks"] != chunks or not np.isfinite(result["ppl"]):
        raise SystemExit(f"{label}: {result['chunks']} chunks, PPL {result['ppl']}")
    if launches != want:
        raise SystemExit(f"{label}: kernel launches {launches} != expected {want}")
    return launches


def _expected(n_layers: int, hops: dict, stats_layers: int = 0, hop_iters: int = 0):
    """Launch counts of a split run of ``n_groups`` groups: one K-attn per
    layer per group, one K-stats per importance-pass layer per group, one
    encode and one decode per kernel-backed hop per group, plus
    ``hop_iters`` of each from time_hops / time_decode_hops."""
    def expect(n_groups: int) -> dict:
        want = dict.fromkeys(KERNELS, 0)
        want["causal_attention"] = n_layers * n_groups
        want["causal_attention_stats"] = stats_layers * n_groups
        for kernel, count in hops.items():
            want[kernel] = count * (n_groups + hop_iters)
        return want
    return expect


#: time_hops / time_decode_hops: (warm-up 1 + 20 iterations) each
HOP_ITERS = 2 * (1 + 20)


@contextlib.contextmanager
def fused_hops(mode: str):
    """A config's ``fused_hops`` value onto the EDGELLM_FUSED_HOP gate, as the
    CLI maps it ("auto" clears it), for the runtimes built inside."""
    from edgellm_tpu_torch.run import FUSED_HOP_ENV

    saved = os.environ.pop("EDGELLM_FUSED_HOP", None)
    if mode != "auto":
        os.environ["EDGELLM_FUSED_HOP"] = FUSED_HOP_ENV[mode]
    try:
        yield
    finally:
        os.environ.pop("EDGELLM_FUSED_HOP", None)
        if saved is not None:
            os.environ["EDGELLM_FUSED_HOP"] = saved


def split_paths(args, detail: dict) -> dict:
    """Phases 6 and 7: the split main path (configs/split1_qwen_int8.json at full
    Qwen2-0.5B width and depth), the selective split (split2's codec, which
    adds the importance pass), split1's cut with the per-channel and ternary
    codecs (K5-K7), configs/split10_qwen_fused.json's fused hops (forced
    "wire", forced "remote", and "auto" as committed) and the three-stage
    multi-hop split (configs/split4_qwen15_multihop.json, Qwen2-1.5B) ->
    launches by path."""
    import torch

    from edgellm_tpu_torch.models import PRESETS, init_params

    out = {}
    cfg = PRESETS["qwen2-0.5b"]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                         dtype=torch.bfloat16, device="cuda")
    out["split1"] = _split_run(
        args, detail, cfg, params, args.chunks, "split1 qwen2-0.5b cut 11 int8_per_token",
        _expected(cfg.num_layers, {"int8_affine_encode": 1, "int8_affine_decode": 1},
                  hop_iters=HOP_ITERS),
        cuts=[11], hop_codecs=["int8_per_token"])
    detail["split_paths"]["split1 qwen2-0.5b cut 11 int8_per_token"]["profile"] = \
        profile_split_group(cfg, params, "profile_split_group", cuts=[11],
                            hop_codecs=["int8_per_token"])
    out["split2"] = _split_run(
        args, detail, cfg, params, 9, "split2 qwen2-0.5b cut 11 selective_int4:0.25:bf16",
        _expected(cfg.num_layers, {}, stats_layers=cfg.num_layers), time_hops=False,
        cuts=[11], hop_codecs=["selective_int4:0.25:bf16"],
        importance_method="regular_importance")
    for codec, hops in (("int8_per_channel", {"chan_int8_encode": 1, "chan_int8_decode": 1}),
                        ("int4_per_channel", {"chan_int4_encode": 1, "int4_decode": 1}),
                        ("ternary_max", {"ternary_encode": 1, "ternary_decode": 1})):
        out[f"split1 {codec}"] = _split_run(
            args, detail, cfg, params, 9, f"split1 qwen2-0.5b cut 11 {codec}",
            _expected(cfg.num_layers, hops, hop_iters=HOP_ITERS),
            cuts=[11], hop_codecs=[codec])
    with open("configs/split10_qwen_fused.json") as f:
        split10 = json.load(f)
    separate = {"int8_affine_encode": 1, "int8_affine_decode": 1}
    for mode, hops in (("wire", separate), ("remote", {"remote_hop": 1}),
                       (split10["fused_hops"], separate)):
        label = f"split10 qwen2-0.5b cut 11 int8_per_token fused_hops {mode}"
        with fused_hops(mode):  # time_hops off: it times the separate hop
            out[f"split10 {mode}"] = _split_run(
                args, detail, cfg, params, 9, label, _expected(cfg.num_layers, hops),
                time_hops=False, cuts=split10["cuts"], hop_codecs=split10["hop_codecs"])
            if mode == "remote":
                detail["split_paths"][label]["profile"] = profile_split_group(
                    cfg, params, "profile_split10_remote_group", cuts=split10["cuts"],
                    hop_codecs=split10["hop_codecs"])
    del params
    torch.cuda.empty_cache()
    cfg = PRESETS["qwen2-1.5b"]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                         dtype=torch.bfloat16, device="cuda")
    out["split4"] = _split_run(
        args, detail, cfg, params, 9, "split4 qwen2-1.5b cuts 9,18 int8+int4",
        _expected(cfg.num_layers, {"int8_affine_encode": 1, "int8_affine_decode": 1,
                                   "int4_encode": 1, "int4_decode": 1},
                  hop_iters=HOP_ITERS),
        cuts=[9, 18], hop_codecs=["int8_per_token", "int4_per_token"])
    del params
    torch.cuda.empty_cache()
    return out


def profile_split_group(cfg, params, tag: str, **split) -> dict:
    """Where one group (8 windows) of a split path spends the card's time
    (:func:`device_time`)."""
    from edgellm_tpu_torch.eval import run_split_eval

    corpus = np.random.default_rng(5).integers(0, cfg.vocab_size, 512 + 32 * 9)
    kw = dict(max_length=512, stride=32, window_batch=8, max_chunks=8, time_hops=False,
              device="cuda", **split)
    run_split_eval(cfg, params, corpus, **kw)  # warm-up at this corpus's shapes
    out, _ = device_time(lambda: run_split_eval(cfg, params, corpus, **kw), 8)
    log_profile(tag, out, 15)
    return out


def split_cross_checks(args, detail: dict):
    """Phase 8: at Qwen2-0.5B width and 3 layers (two cuts need three), fp32:
    an fp32-codec split equals the unsplit model; the int8, selective,
    two-hop, per-channel and ternary splits on the card (kernels) equal the
    same runs on the CPU (plain versions); and the fused "wire" and "remote"
    int8 hops on the card give the separate hop's PPL exactly (they decode
    the same bytes)."""
    import torch

    from edgellm_tpu_torch.eval import run_split_eval
    from edgellm_tpu_torch.models import PRESETS, init_params

    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=3)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), device="cpu")
    corpus = np.random.default_rng(args.seed + 2).integers(0, cfg.vocab_size, 512 + 32 * 4)
    kw = dict(max_length=512, stride=32, window_batch=4, max_chunks=4, time_hops=False)
    cases = {"fp32": dict(cuts=[0], hop_codecs=["fp32"]),
             "int8": dict(cuts=[0], hop_codecs=["int8_per_token"]),
             "selective": dict(cuts=[1], hop_codecs=["selective_int4:0.25:bf16"],
                               importance_method="last_row"),
             "two_hop": dict(cuts=[0, 1], hop_codecs=["int8_per_token", "int4_per_token"]),
             **{codec: dict(cuts=[0], hop_codecs=[codec])
                for codec in ("int8_per_channel", "int4_per_channel", "ternary_mean",
                              "ternary_max")}}
    rows = {}
    unsplit = run_split_eval(cfg, params, corpus, cuts=[], hop_codecs=[], device="cuda", **kw)
    for name, case in cases.items():
        card = run_split_eval(cfg, params, corpus, device="cuda", **case, **kw)
        rows[name] = {"ppl_cuda": card["ppl"], "hop_codecs": card["hop_codecs"],
                      "bytes_cuda": card["measured_hop_bytes_total"]}
        if name == "fp32":
            rel = abs(card["ppl"] - unsplit["ppl"]) / unsplit["ppl"]
            rows[name].update(ppl_unsplit=unsplit["ppl"], rel=rel, rtol=SPLIT_RTOL)
            ok = rel <= SPLIT_RTOL
        else:
            cpu = run_split_eval(cfg, params, corpus, device="cpu", **case, **kw)
            rel = abs(card["ppl"] - cpu["ppl"]) / cpu["ppl"]
            rows[name].update(ppl_cpu=cpu["ppl"], rel=rel, rtol=SPLIT_CROSS_RTOL,
                              bytes_cpu=cpu["measured_hop_bytes_total"])
            ok = (rel <= SPLIT_CROSS_RTOL
                  and cpu["measured_hop_bytes_total"] == card["measured_hop_bytes_total"])
        log(json.dumps({"split_cross_check": {name: rows[name]}}))
        if not ok or not np.isfinite(card["ppl"]):
            raise SystemExit(f"split cross-check {name} failed: {rows[name]}")
    separate = rows["int8"]
    for mode in ("wire", "remote"):
        with fused_hops(mode):
            fused = run_split_eval(cfg, params, corpus, device="cuda", **cases["int8"], **kw)
        name = f"int8 fused {mode}"
        rows[name] = {"ppl_cuda": fused["ppl"], "ppl_separate": separate["ppl_cuda"],
                      "diff": fused["ppl"] - separate["ppl_cuda"],
                      "bytes_cuda": fused["measured_hop_bytes_total"]}
        log(json.dumps({"split_cross_check": {name: rows[name]}}))
        if (fused["ppl"] != separate["ppl_cuda"]
                or fused["measured_hop_bytes_total"] != separate["bytes_cuda"]):
            raise SystemExit(f"split cross-check {name} failed: {rows[name]}")
    detail["split_cross_check"] = rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="directory for chip_smoke_detail.json")
    ap.add_argument("--chunks", type=int, default=17,
                    help="chunks of the main-path sweep (chunk 0 + full groups of 8)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs "
              "a CUDA card", file=sys.stderr)
        return 2
    from edgellm_tpu_torch.utils import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    detail: dict = {"card": smi, "torch": torch.__version__}

    built = cuda_build.build_all()
    log(f"build: {len(built['libs'])} kernel libraries in {built['seconds']:.1f} s")
    for name, text in built["log"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    detail["build"] = {"seconds": built["seconds"], "log": built["log"]}

    t0 = time.monotonic()
    main_rows = kernel_checks(detail)
    codec_rows = codec_checks(detail)
    t1 = time.monotonic()
    by_path = {"token_sweep": main_path(args, detail)}
    t2 = time.monotonic()
    by_path.update(split_paths(args, detail))
    t3 = time.monotonic()
    split_cross_checks(args, detail)
    cross_check(args, detail)
    detail["phase_s"] = {"kernels": t1 - t0, "token_sweep": t2 - t1, "split_paths": t3 - t2,
                         "cross_checks": time.monotonic() - t3}
    log(json.dumps({"phase_s": detail["phase_s"]}))

    kernels = []
    for name, meta in KERNELS.items():
        counts = {path: got.get(name, 0) for path, got in by_path.items()}
        if name in main_rows:
            r = main_rows[name]
            shape = f"{r['shape']} B={r['b']} S={r['s']} {r['dtype']}"
        else:
            r = codec_rows[name]
            shape = f"qwen2-0.5b split N={r['n']} D={r['d']} float32"
        kernels.append({"name": name, **meta, "launches": sum(counts.values()),
                        "launches_by_path": counts,
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": shape})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_detail.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
