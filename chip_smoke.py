#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``edgellm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR] [--chunks N]

from the repository root, on a machine with a CUDA card and ``nvcc``
(``/usr/local/cuda``). Phases, each of which fails the run on a fault:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the sweep from ``edgellm_tpu_torch/csrc`` with nvcc
   for ``sm_90a`` (one process per source, in parallel);
3. each kernel against its plain PyTorch version at the sweep's shapes
   (Qwen2-0.5B, bf16 and fp32) and at the blocked envelope's (Pythia-70M at
   S=2048, Qwen2-1.5B hd=128), with stated tolerances;
4. timing with CUDA events: kernel, plain version, one PyTorch library call
   where one computes the same function, and the roofline bound;
5. the main path at full Qwen2-0.5B width and depth: ``run_token_sweep``,
   4 methods x layer 11 x 5 ratios, window 512, stride 32, window batch 8,
   bf16 random weights from ``--seed``, with every kernel's launch count;
   then chunk 0 and one group again, timed alone and under torch.profiler:
   device time by kernel, the card's idle share, attention FLOP/s;
6. the same sweep at Qwen2 widths, 2 layers, 2 chunks, fp32, once on the card
   through the kernels and once on the CPU through the plain versions, PPL
   tables compared;
7. a JSON line of every kernel, the ``nvidia-smi`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without a result where ``torch.cuda.is_available()`` is
false or the package is not beside it. ``--out DIR`` also writes the detail
(timings, profiles, compiler output) to ``DIR/chip_smoke_detail.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
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

KERNELS = {
    "causal_attention": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/causal_attention.cu",
        "replaces": "edgellm_tpu/models/flash_attention.py:272",
        "also_replaces": "edgellm_tpu/models/flash_attention.py:380"},
    "causal_attention_stats": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/attention_stats.cu",
        "replaces": "edgellm_tpu/models/flash_attention.py:290",
        "also_replaces": "edgellm_tpu/models/flash_attention.py:403"},
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


def profile_group(cfg, params, corpus, kw, attn_flops_per_window: float) -> dict:
    """Where chunk 0 and one steady group of the main path spend the card's
    time: device time by kernel (torch.profiler, kernels only), the card's
    idle share against the same work's unprofiled wall time, and the two
    attention kernels' achieved FLOP/s on the attention work of those chunks."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from edgellm_tpu_torch.eval import run_token_sweep

    n = 1 + kw["window_batch"]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    run_token_sweep(cfg, params, corpus, max_chunks=n, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        run_token_sweep(cfg, params, corpus, max_chunks=n, **kw)
        torch.cuda.synchronize()
    rows = [{"name": ev.key[:120], "device_ms": ev.self_device_time_total / 1e3,
             "calls": ev.count}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    attn = {k: sum(r["device_ms"] for r in rows if k in r["name"])
            for k in ("attn_fwd_kernel", "attn_col_kernel")}
    attn_ms = sum(attn.values())
    out = {"chunks": n, "wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms if busy else None,
           "attention_kernel_ms": attn,
           "attention_tflops_per_s": (attn_flops_per_window * n / (attn_ms * 1e-3) / 1e12
                                      if attn_ms else None),
           "top": rows[:25]}
    log(json.dumps({"profile_one_group": {k: v for k, v in out.items() if k != "top"}}))
    for r in rows[:12]:
        log(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d}  {r['name'][:90]}")
    return out


def cross_check(args, detail: dict):
    """Phase 6: CUDA through the kernels vs CPU through the plain versions."""
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

    main_rows = kernel_checks(detail)
    launches = main_path(args, detail)
    cross_check(args, detail)

    kernels = []
    for name, meta in KERNELS.items():
        r = main_rows[name]
        kernels.append({"name": name, **meta, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": f"{r['shape']} B={r['b']} S={r['s']} {r['dtype']}"})
    if args.out:
        import os

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
