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
   tolerances, and at the bf16 kernels' tile edges (S = 1, 63, 64, 65, 100,
   127, 128, 129) and the serve prefill lengths (12, 72), both head dims and
   dtypes, the stats deterministic; the codec kernels K1-K7 (K2 also with a
   (1, D) scale, through the int4_per_channel twin; K3 also saturating
   float32, bf16 and fp16 hiddens with NaN, +-Inf and 1e30 in the kernel)
   and the fused hop K8 bit for bit at N = 4096 x D = 896 and 1536, and
   N = 1 and 511 (K8 also saturating float32, bf16 and fp16 hiddens in the
   kernel), K8's buffer byte for byte against the wire path's, a flipped
   byte failing K8's verify, and one ``fused_remote_hop`` call of a bf16
   (8, 512, 896) hidden two kernels on the card (K8 and the select); fp32
   K-stats also at inputs scaled until |q.k| / sqrt(hd) reaches 30, each
   last row summing to 1 within 1e-4;
4. timing: each kernel's device time (torch.profiler) beside the call's
   CUDA-event time (the codecs' host-bound where the events read over twice
   the device), the plain version, one PyTorch library call where one
   computes the same function, and the roofline bound; K3 / K4 at N = 4096
   also from a cold L2; fp32 K-attn also at the serve prefills' shapes
   (B = 1, S = 12, 72, 512), and at every fp32 shape two launches bit for
   bit equal; fp32 K-stats' column pass also alone beside its forward;
5. the main path at full Qwen2-0.5B width and depth: ``run_token_sweep``,
   4 methods x layer 11 x 5 ratios, window 512, stride 32, window batch 8,
   bf16 random weights from ``--seed``, with every kernel's launch count;
   the bf16 LM head checked (bf16-operand GEMMs with fp32 output, logits
   within the fp32 summation bound of the widened product, NLL against the
   widened product's);
   then chunk 0 and one group again, timed alone and under torch.profiler:
   device time by kernel, the card's idle share, attention FLOP/s and the
   LM head's device time;
6. the split main path, configs/split1_qwen_int8.json's split (Qwen2-0.5B at
   full width and depth, cut 11, int8_per_token, window 512, stride 32) through
   ``run_split_eval`` at window batch 8, ``--chunks`` chunks, time_hops on:
   s/chunk, tokens/s, peak memory, bytes/token and per-hop ms, every
   kernel's launches against the count the groups and time_hops imply
   (K-attn's fp32 launches apart: the stage behind the unfused hop computes
   in fp32), and one group under torch.profiler;
7. the selective split (split2's ``selective_int4:0.25:bf16``, whose
   importance pass runs K-stats), split1's cut with ``int8_per_channel``,
   ``int4_per_channel`` and ``ternary_max`` (K5-K7), configs/
   split10_qwen_fused.json with ``fused_hops`` forced to "wire" (K3 + K4)
   and "remote" (K8 alone) and as committed ("auto": no fusion on the card),
   one fused group under torch.profiler, and the three-stage multi-hop split
   (configs/split4_qwen15_multihop.json: Qwen2-1.5B, cuts 9 and 18,
   int8_per_token + int4_per_token), 9 chunks each, launches counted (fp32
   K-attn: the layers behind an unfused hop x groups);
8. split cross-checks at Qwen2-0.5B width, 3 layers, fp32: an fp32-codec
   split against the unsplit model; the int8, selective, two-hop,
   per-channel and ternary splits on the card (kernels) against the CPU
   (plain versions); fused "wire" and "remote" int8 hops against the
   separate hop on the card (the same bytes decoded: identical PPL);
9. the token sweep at Qwen2 widths, 2 layers, 2 chunks, fp32, once on the card
   through the kernels and once on the CPU through the plain versions, PPL
   tables compared;
10. the paged decode kernels K13 (fp32 and bf16) and K14 (int8 and int4)
   against their plain versions at Qwen2-0.5B and Qwen2-1.5B heads: 32
   slots of ragged lengths up to a 2048 span (some on the trash page), and
   each serve path's own geometry (split9, split13, split14 and the large
   split9 of phase 11: slots, page size, pages per slot, pool pages), each
   twice and bit for bit equal; timed (CUDA events and device time) beside
   their bound, their split count and the SDPA yardstick over the gathered
   span;
11. the batched serve paths at full Qwen2-0.5B width and depth, fp32 random
   weights, through the CLI's ``run_serve``: configs/split9_qwen_paged.json,
   split13_qwen_prefix.json (prefix sharing) and split14_qwen_kvq.json
   (int4 pages, K14) as committed, and a larger geometry of split9's shape
   (64 requests of 512 prompt tokens, 64 new, 32 slots, a 0.5 GB pool):
   outcomes, steps, decode tokens/s, ms per step, peak memory, every
   kernel's launches against the count the steps imply (K-attn: 24 fp32
   launches a prefill); one steady group of
   the large geometry's steps under torch.profiler;
12. the sweep as the CLI runs it: ``edgellm_tpu_torch.run.main`` on
   configs/qwen_baseline_table.json (Qwen2-0.5B, full width and depth) and
   configs/pythia_last_row.json (Pythia-70M, S = 2048), fp32 random weights
   from ``--seed`` (the CLI's default), a synthetic corpus, 9 chunks each:
   s/chunk, tokens/s, peak memory, a finite PPL table, every kernel's
   launches against the count the groups imply (fp32 K-stats 24 and 6 a
   group, fp32 K-attn the suffix passes), one group under torch.profiler
   with the column pass, the forward and the LM head named;
13. serve cross-checks at Qwen2-0.5B width, 3 layers, fp32: the paged step
   on the card (K13 / K14) against the CPU (plain versions) under teacher
   forcing, greedy batched streams identical on the card and the CPU, and
   on the card batched streams against each stream alone through
   ``generate`` (tokens) and the contiguous decode step (logits);
14. the paper's remaining experiments through ``run.main`` at full
   Qwen2-0.5B width and depth, fp32 random weights from ``--seed``:
   ``relevance`` (configs/relevance.json, 9 chunks, window batch 8) writes
   (24, 14) head weights, each row summing to 1 (it/s, wall, peak memory,
   no kernel launched: plain torch ops, as in the reference);
   configs/split3_qwen_lxt_sweep.json reads them (``--head-weights``, as
   phase 12: a finite (4, 5, 5) PPL table, 24 fp32 K-stats and 152 fp32
   K-attn a group); ``distances`` on an ``.npz`` of one sample at each of
   the lengths 2, 12, 63, 65, 127, 129, 300, 512 and 1024 (a (24, 24)
   matrix, 24 fp32 K-stats a sample, the heatmap's state as the CLI printed
   it); then the card against the CPU at 3 layers: ``chunk_relevance`` for 2
   windows of 512 (the argmax tokens identical, then rtol 1e-3, atol 1e-6 *
   max |R|) and the distance matrix (1e-5 absolute);
15. split decode and the per-request serve route at full Qwen2-0.5B width
   and depth, fp32 random weights from ``--seed``: ``run.main`` on
   configs/split11_qwen_spec.json (cut 11, int8_per_token, speculative k =
   4, 24 requests at T = 0.7) and on the same params without
   ``speculative`` (the vanilla per-request split route), each with every
   request completed, the identity replay green, each call's speculative
   stats consistent, per-request service ms, and K3 / K4 and fp32 K-attn
   launched exactly as the counted calls imply (cuts x (prefills + decode
   steps + verify bursts); 24 a split prefill, 12 a draft prefill, 24 a
   local prefill); ``generate_split`` under ``fused_hops`` "remote" (K8,
   1 + steps a call) and "wire" against the separate hop (tokens equal,
   teacher-forced logits within 1e-5); K3 / K4 device ms at the path's N =
   1, 4, 8; one decode hop's events against its device time; one decode
   step and one verify burst profiled (device ms by kind, idle share); and
   the card against the CPU at 3 layers (teacher-forced decode and verify
   logits within 1e-4 fp32 / 1e-3 int8 hop, greedy tokens identical);
16. the split-paged batcher and the KV-at-rest PPL harness at full
   Qwen2-0.5B width and depth, fp32 random weights from ``--seed``:
   ``run.main`` on split9, split9 under ``fused_hops`` "remote" (K8),
   split13 (prefix hits through ``verify_step``) and split14 (int4 stage
   pools, K14), each with cut 11 (int8_per_token) added inline, and the
   large split9 geometry with it (K3 / K4 at N = 32): every request
   completed, mode "paged_split", decode tokens/s, ms a step, peak memory
   and every kernel's launches against the count the run implies (24 K13 /
   K14 a ragged step, 24 fp32 K-attn a split prefill, each cut one hop a
   step, prefill and prefix-hit suffix; the warm batcher's share apart);
   ten steady ragged steps of the large geometry profiled beside the local
   step's (device ms by kind, idle share); a three-stage run (cuts 7 and
   15, fp32 hops) whose greedy streams equal ``generate``'s; the card
   against the CPU at 3 layers (teacher-forced logits within 1e-4 over an
   fp32 hop and fp pages, 2e-2 with an int8 hop or quantized pages, where
   a code on a rounding boundary may sit a step from the CPU's; greedy
   batched streams identical, and
   on the card equal to ``generate_split`` alone); ``run_kv_tier_sweep``
   over the fp, int8 and int4 tiers (window 128, stride 64, window batch 4,
   8 chunks; K13 / K14 24 a position a tier), then at 3 layers card against
   CPU (PPL within rtol 1e-3); K13 / K14 at that geometry and K3 / K4 / K8
   at N = 32 timed on the device;
17. the boundary link at full Qwen2-0.5B width and depth, fp32 random
   weights from ``--seed``: the codec and fused-hop probes
   (``edgellm_tpu_torch.tools.pallas_probe``) into the phase's own probe
   cache (every row's ratio, parity and decision; a parity miss or another
   fingerprint in the cache fails; a twin that reads slower than its plain
   codec is reported, and runs all the same);
   configs/split10_qwen_fused.json through ``run.main`` under "auto" (its
   hop runs the cache's verdict for ``fused_hop:int8_per_token``) beside
   "off", "wire" and "remote", in three rounds, with the s/chunk the
   probe's per-hop difference predicts; configs/split7_qwen_lossy.json and
   split6_qwen_chaos.json through ``run.main --fault-report`` (24 chunks,
   window batch 4), beside a clean split1 and a zero-rate faults run (the
   same PPL bit for bit): K3 / K4 (K1 / K2 at the int4 tier) launched once
   a hop encoded / a copy sent, split6's trail stepping, counters and tier
   trail equal at 13 layers on the card and the CPU (PPL within 1e-4),
   one group of each profiled; ``run_fault_sweep`` over drop rates 0,
   0.05 and 0.2 on split1's cut (24 chunks, one window a forward, no
   retry), its rate-0 point the clean split's. Every
   earlier phase reads an empty probe cache this run wrote;
18. a JSON line of every kernel (launches summed over the counted paths,
   and by path; K-attn's also by dtype and path; K-stats' fp32 column pass
   apart; ``ms`` its device time, ``event_ms`` the call's CUDA-event time),
   the ``nvidia-smi`` line, and
   as the last line ``{"ok": true, "device": {...}}``.

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
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

#: kernel vs plain tolerances, (atol, rtol) as in torch.testing.assert_close:
#: fp32 differs only by summation order and the online (kernel) vs two-pass
#: (plain) softmax; in bf16 both round the probabilities to bf16 before PV
#: (the kernel the unnormalized, the plain version the normalized ones) and
#: an output may land one bf16 step from the other: the H100 read 1.5625e-2
#: at most (one step at |out| in [2, 4)) at every shape and tile edge; the
#: stats are fp32 in both from the same inputs
OUT_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1.6e-2, 0.0)}
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

#: K13 / K14 against their plain versions, (atol, rtol): fp32 as OUT_TOL
#: (online vs two-pass softmax); in bf16 the plain version rounds the
#: probabilities to bf16 before PV and the two outputs land at most one bf16
#: step apart (rtol above 2^-7; the H100 read 7.8e-3 at most, one step at
#: |out| in [1, 2)); K14 dequantizes the same codes the same way as its
#: plain version, then K13's fp32 math
PAGED_TOL = {"float32": OUT_TOL["float32"], "bfloat16": (1.2e-2, 1.2e-2),
             "quant": (1e-5, 1e-5)}
#: teacher-forced paged-step logits, (atol, rtol): the card (K-attn prefill,
#: K13) against the CPU (plain versions) or against the contiguous decode
#: step differ by summation order and the online softmax; on a quantized
#: tier a row that rounds on a .5 boundary may also move one code by a step
PAGED_CROSS_TOL = {"fp": (1e-4, 1e-4), "quant": (1e-3, 1e-3)}

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
    "paged_decode_attention": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/paged_decode.cu",
        "replaces": "edgellm_tpu/models/flash_attention.py:783"},
    "paged_decode_attention_quant": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/paged_decode.cu",
        "replaces": "edgellm_tpu/models/flash_attention.py:937"},
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


def device_ms(fn, iters: int, tries: int = 5, flush=None) -> float:
    """Device time of one ``fn()`` in ms: the kernels it launches, summed
    under torch.profiler over ``iters`` warm calls; the host's launch time
    between them is left out. The trace is held to the kernels one profiled
    call launches: each must be recorded ``iters`` times that often, since a
    record the profiler dropped would lower the time. A short trace is
    profiled again, up to ``tries`` times, then the run fails. With
    ``flush`` (a tensor larger than the 50 MB L2) every call follows a write
    of it, so ``fn`` finds its inputs in device memory, not in L2 (a cold
    reading); the write's own kernel is left out of the sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(n: int, call) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        return {ev.key: (ev.count, ev.self_device_time_total) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA}

    fn()
    torch.cuda.synchronize()
    call = fn if flush is None else lambda: (flush.zero_(), fn())  # noqa: E731
    for _ in range(tries):
        one, many = trace(1, fn), trace(iters, call)
        skip = set() if flush is None else set(trace(1, flush.zero_))
        if skip & set(one):
            raise SystemExit(f"device_ms: the flush's kernel {skip} is also fn's")
        if flush is not None and not skip:  # the flush's record was dropped
            continue
        want = {k: c * iters for k, (c, _) in one.items()}
        got = {k: c for k, (c, _) in many.items() if k not in skip}
        if one and got == want:
            return sum(t for k, (_, t) in many.items() if k not in skip) / 1e3 / iters
        log(f"  device_ms: the trace of {iters} calls holds {got}, wanted {want}; "
            f"profiling again")
    raise SystemExit(f"device_ms: the profiler dropped kernel records in {tries} tries")


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
                # fp32 K-attn: key splits merged in split order, no atomics
                repeat = (dname != "float32" or stats
                          or torch.equal(got, kern(q, k, v)))
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
                k_dev = device_ms(lambda: kern(q, k, v), iters)
                col = col_pass_reads(q, k, v, iters) if stats and dname == "float32" else {}
                lib_ms = lib_dev = None
                if not stats:
                    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        qt, kt, vt, is_causal=True, enable_gqa=True)
                    lib_ms, lib_dev = time_ms(sdpa, iters), device_ms(sdpa, iters)
                row = {"kernel": name, "shape": label, "dtype": dname,
                       "b": b, "s": s, "h": h, "kv": kv, "hd": hd,
                       "max_abs_err": out_err, "stats_max_abs_err": st_err,
                       "repeatable": repeat, "tolerance": OUT_TOL[dname],
                       "stats_tolerance": STATS_TOL if stats else None,
                       "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                       "kernel_device_ms": k_dev, "library_device_ms": lib_dev,
                       "bound_ms": bound, "bound_by": bound_by,
                       "roofline_share": bound / k_ms,
                       "tflops": flops / (k_ms * 1e-3) / 1e12, **col}
                rows.append(row)
                log(json.dumps(row))
                if dname == "bfloat16":
                    log(f"  {name} {label} bf16 B={b} S={s}: {k_ms:.4f} ms ({k_dev:.4f} on "
                        f"the device), bound {bound:.5f} ms, share of bound "
                        f"{bound / k_ms:.3f}, SDPA {lib_ms} ({lib_dev} on the device)")
                if not ok or not repeat:
                    raise SystemExit(f"{name} disagrees with its plain version (or two "
                                     f"launches differ) at {label} {dname}: {row}")
                if on_main and dname == "bfloat16" and name not in main:
                    # the suffix's B=32 launches dominate K-attn on the main path
                    if name == "causal_attention_stats" or b == 32:
                        main[name] = row
                if on_main and dname == "float32" and stats:
                    main["causal_attention_stats float32"] = row  # the CLI's fp32 sweep
    detail["kernel_rows"] = rows
    detail["scaled_stats_rows"] = scaled_stats_checks(gen)
    detail["edge_rows"] = edge_checks(gen)
    detail["serve_prefill_rows"] = serve_prefill_reads(gen)
    return main


def col_pass_reads(q, k, v, iters: int) -> dict:
    """fp32 K-stats' column pass apart from its forward: the forward with the
    LSE and the column pass each timed on the device (torch.profiler, their
    own kernels), the column pass's bound (the QK^T products over the
    visible pairs at the 3xTF32 rate; q, K, the LSE and the two outputs)."""
    import torch

    from edgellm_tpu_torch.models import flash_attention as fa

    b, s, h, hd = q.shape
    kv = k.shape[2]
    lse = fa._launch_fwd(q, k, v, with_lse=True)[1]
    nbytes, flops = fa.column_pass_bytes_flops(b, s, h, kv, hd, 4)
    bound, bound_by = fa.bound_ms(nbytes, flops, torch.float32)
    ms = device_ms(lambda: fa._launch_col(q, k, lse), iters)
    out = {"col_device_ms": ms, "forward_lse_device_ms":
           device_ms(lambda: fa._launch_fwd(q, k, v, with_lse=True), iters),
           "col_bound_ms": bound, "col_bound_by": bound_by, "col_roofline_share": bound / ms}
    log(json.dumps({"fp32_column_pass": {"b": b, "s": s, "h": h, "kv": kv, "hd": hd, **out}}))
    return out


#: |q.k| / sqrt(hd) the scaled stats check reaches: rows whose top key
#: takes p near 1, as real checkpoints' attention sinks (N(0, 0.02) random
#: weights never give them)
SCALED_TOP = 30.0


def scaled_stats_checks(gen) -> list:
    """fp32 K-stats against its plain version at the kernel phase's stats
    shapes with q and K scaled until the largest visible |q.k| / sqrt(hd) is
    :data:`SCALED_TOP`; each last row sums to 1 within 1e-4, and two launches
    are bit for bit equal."""
    import torch

    from edgellm_tpu_torch.models import flash_attention as fa

    rows = []
    for b, s, h, kv, hd in ((8, 512, 14, 2, 64), (4, 2048, 8, 8, 64), (8, 512, 12, 2, 128),
                            (2, 129, 14, 2, 64), (2, 72, 12, 2, 128)):
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device="cuda") for n in (h, kv, kv))
        sc = torch.einsum("bqhd,bthd->bhqt", q, k.repeat_interleave(h // kv, dim=2)) / hd ** 0.5
        peak = torch.where(torch.ones(s, s, dtype=torch.bool, device="cuda").tril(), sc,
                           0).abs().max()
        f = (SCALED_TOP / peak).sqrt()
        q, k = q * f, k * f
        del sc
        got, again = fa.causal_attention_stats(q, k, v)[1], fa.causal_attention_stats(q, k, v)[1]
        want = fa.causal_attention_stats_plain(q, k, v)[1]
        checks = [close(g, w, STATS_TOL) for g, w in zip(got, want)]
        ones = (got[1].sum(dim=-1) - 1).abs().max().item()
        row = {"b": b, "s": s, "h": h, "kv": kv, "hd": hd, "top": SCALED_TOP,
               "last_row_max": got[1].max().item(),
               "stats_max_abs_err": max(e for e, _ in checks), "last_row_sum_err": ones,
               "deterministic": all(torch.equal(a, g) for a, g in zip(again, got))}
        rows.append(row)
        log(json.dumps({"scaled_stats": row}))
        if not (all(c for _, c in checks) and ones <= 1e-4 and row["deterministic"]):
            raise SystemExit(f"fp32 K-stats fails at scaled inputs: {row}")
    return rows


def serve_prefill_reads(gen) -> list:
    """fp32 K-attn at the serve paths' prefill shapes (Qwen2-0.5B heads,
    B = 1, S = 12, 72 and 512: split9's, split13's and the large split9's
    prompts; the last cut into key splits), checked against its plain
    version, two launches bit for bit equal, and timed beside its bound and
    SDPA."""
    import torch
    import torch.nn.functional as F

    from edgellm_tpu_torch.models import flash_attention as fa

    rows = []
    for s in (12, 72, 512):
        q, k, v = (torch.randn((1, s, n, 64), generator=gen, device="cuda") for n in (14, 2, 2))
        got, again = fa.causal_attention(q, k, v), fa.causal_attention(q, k, v)
        err, ok = close(got, fa.causal_attention_plain(q, k, v), OUT_TOL["float32"])
        ok = ok and torch.equal(got, again)
        nbytes, flops = fa.causal_attention_bytes_flops(1, s, 14, 2, 64, 4)
        bound, bound_by = fa.bound_ms(nbytes, flops, torch.float32)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        run = lambda: fa.causal_attention(q, k, v)  # noqa: E731
        row = {"kernel": "causal_attention", "dtype": "float32", "b": 1, "s": s,
               "splits": fa.attn_split_plan(1, s, 14, 2, fa._sm_count(q.device),
                                            fa._f32_tile(fa._lib("causal_attention"), 64))[0],
               "max_abs_err": err, "repeatable": bool(torch.equal(got, again)),
               "kernel_ms": time_ms(run, 50),
               "kernel_device_ms": device_ms(run, 50), "library_ms": time_ms(sdpa, 50),
               "library_device_ms": device_ms(sdpa, 50), "bound_ms": bound,
               "bound_by": bound_by}
        rows.append(row)
        log(json.dumps({"serve_prefill_k_attn": row}))
        if not ok:
            raise SystemExit(f"fp32 K-attn disagrees with its plain version or with "
                             f"itself: {row}")
    return rows


#: the bf16 kernels' tile edges (64-key stages, 64- and 128-row query blocks)
#: and the serve prefills' lengths (split9's 12-token prompts, split13's 72)
EDGE_S = (1, 63, 64, 65, 100, 127, 128, 129, 12, 72)


def edge_checks(gen) -> list:
    """K-attn and K-stats against their plain versions at every length of
    :data:`EDGE_S`, hd 64 (Qwen2-0.5B heads) and 128 (Qwen2-1.5B), bf16 and
    fp32, the stats twice and bit for bit equal; checked, not timed."""
    import torch

    from edgellm_tpu_torch.models import flash_attention as fa

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for b, h, kv, hd in ((2, 14, 2, 64), (2, 12, 2, 128)):
            for s in EDGE_S:
                q, k, v = (torch.randn((b, s, n, hd), generator=gen, device="cuda").to(dtype)
                           for n in (h, kv, kv))
                out = fa.causal_attention(q, k, v)
                out_s, stats = fa.causal_attention_stats(q, k, v)
                again = fa.causal_attention_stats(q, k, v)[1]
                want, want_stats = fa.causal_attention_stats_plain(q, k, v)
                torch.cuda.synchronize()
                checks = [close(out, want, OUT_TOL[dname]), close(out_s, want, OUT_TOL[dname])]
                stat_checks = [close(g, w, STATS_TOL) for g, w in zip(stats, want_stats)]
                det = all(torch.equal(a, g) for a, g in zip(again, stats))
                row = {"s": s, "hd": hd, "dtype": dname, "b": b, "h": h, "kv": kv,
                       "max_abs_err": max(e for e, _ in checks),
                       "stats_max_abs_err": max(e for e, _ in stat_checks),
                       "deterministic": det}
                rows.append(row)
                if not (det and all(c for _, c in checks + stat_checks)):
                    raise SystemExit(f"attention kernels disagree with their plain versions "
                                     f"at a tile edge: {row}")
    worst = {d: max(r["max_abs_err"] for r in rows if r["dtype"] == d)
             for d in ("bfloat16", "float32")}
    log(json.dumps({"edge_checks": {"lengths": EDGE_S, "cases": len(rows),
                                    "max_abs_err": worst,
                                    "stats_max_abs_err": max(r["stats_max_abs_err"]
                                                             for r in rows)}}))
    return rows


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
    reset_counts()
    t0 = time.monotonic()
    result = run_token_sweep(cfg, params, corpus, max_chunks=args.chunks, **kw)
    wall = time.monotonic() - t0
    launches = {k: n for k, n in read_counts().items()
                if k.startswith("causal_attention")}
    peak = torch.cuda.max_memory_allocated()
    log(result.table())
    ppl = result.ppl()
    n_groups = 1 + math.ceil((result.chunks - 1) / wb)  # chunk 0 runs alone
    suffix_layers = cfg.num_layers - layer - 1
    want = {k: n for k, n in want_counts(
        0, causal_attention_stats=(layer + 1) * n_groups,
        causal_attention=(suffix_layers + len(methods) * suffix_layers) * n_groups).items()
        if k.startswith("causal_attention")}  # a bf16 model: no fp32 launch
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
    if not (launches["causal_attention"] and launches["causal_attention_stats"]) \
            or launches != want:
        raise SystemExit(f"kernel launches {launches} != expected {want}")
    # attention calls per window: the stats prefix, its full-depth
    # continuation, one suffix per (method, nonzero ratio)
    n_nz = len(ratios) - n_zero
    attn_calls = (layer + 1) + suffix_layers + len(methods) * n_nz * suffix_layers
    per_call = fa.causal_attention_bytes_flops(1, window, cfg.num_heads, cfg.num_kv_heads,
                                               cfg.head_dim, 2)[1]
    detail["main_path"]["head_check"] = head_check(cfg, params, args.seed)
    detail["main_path"]["profile"] = profile_group(cfg, params, corpus, kw,
                                                   attn_calls * per_call)
    return launches


def head_check(cfg, params, seed: int) -> dict:
    """The main path's bf16 LM head on the card: ``unembed`` and the
    vocab-streamed ``nll_tail`` reach only bf16-operand GEMMs with fp32
    output (``aten::mm.dtype``, none in fp32); the logits lie within the
    fp32 summation-order bound 2 * D * 2^-24 * (|post| @ |head|) of the
    widened fp32 product (the same exact products in another order); the
    NLL of one suffix batch's scoring tail (32 windows x 33 rows, as the
    sweep's) within 1e-5 of the widened product's, and timed."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from edgellm_tpu_torch.models import transformer as tr

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    hidden = torch.randn((32, 64, cfg.hidden_size), generator=gen, device="cuda").to(
        torch.bfloat16)
    targets = torch.randint(0, cfg.vocab_size, (32, 64), generator=gen, device="cuda")
    aten = torch.ops.aten
    gemms = {aten.mm.default, aten.mm.dtype, aten.addmm.default, aten.bmm.default,
             aten.matmul.default}

    class Seen(TorchDispatchMode):
        ops: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in gemms:
                Seen.ops.append((str(func), [str(a.dtype) for a in args
                                             if isinstance(a, torch.Tensor)]))
            return func(*args, **(kwargs or {}))

    with Seen():
        logits = tr.unembed(cfg, params, hidden[:2])
        nll = tr.nll_tail(cfg, params, hidden, targets, 33, per_example=True)
    post = tr._final_norm(cfg, params, hidden[:2]).reshape(-1, cfg.hidden_size).float()
    head = (params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]).float()
    bound = 2 * cfg.hidden_size * 2.0 ** -24 * (post.abs() @ head.abs())
    diff = (logits.reshape(-1, cfg.vocab_size) - post @ head).abs()
    tail = tr._final_norm(cfg, params, hidden[:, -34:-1]).reshape(-1, cfg.hidden_size)
    nll_wide = tr._masked_ce((tail.float() @ head).reshape(32, 33, -1), targets[:, -33:], True)
    bf16_ms = time_ms(lambda: tr.nll_tail(cfg, params, hidden, targets, 33), 5)
    row = {"gemms": sorted(set(f for f, _ in Seen.ops)),
           "operand_dtypes": sorted(set(tuple(d) for _, d in Seen.ops)),
           "max_abs_diff": diff.max().item(), "max_diff_over_bound": (diff / bound).max().item(),
           "nll_max_rel_diff": ((nll - nll_wide).abs() / nll_wide.abs()).max().item(),
           "nll_tail_ms": bf16_ms}
    log(json.dumps({"head_check": row}))
    if (any(f != "aten.mm.dtype" or d != ["torch.bfloat16"] * 2 for f, d in Seen.ops)
            or not Seen.ops or not bool((diff <= bound).all())
            or row["nll_max_rel_diff"] > 1e-5):
        raise SystemExit(f"the bf16 LM head is not a bf16-operand GEMM with fp32 output "
                         f"within the summation bound: {row}")
    return row


def device_time(run, chunks: int) -> tuple[dict, list]:
    """Where ``run()`` (``chunks`` chunks, already warm) spends the card's
    time: its unprofiled wall time, then device time by kernel under
    torch.profiler (kernels only), and the card's idle share between the two
    -> (summary with the top 25 kernels and the device time of the kernels
    launched inside each ``record_function`` range, every kernel row)."""
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
    range_names = ("lm_head",)  # record_function ranges: on the device timeline, not kernels
    rows = [{"name": ev.key[:120], "device_ms": ev.self_device_time_total / 1e3,
             "calls": ev.count}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and ev.key not in range_names]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    ranges = {ev.key: ev.device_time_total / 1e3 for ev in prof.key_averages()
              if ev.key in range_names}
    return {"chunks": chunks, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if busy else None, "range_device_ms": ranges,
            "top": rows[:25]}, rows


def log_profile(tag: str, out: dict, n_rows: int):
    log(json.dumps({tag: {k: v for k, v in out.items() if k != "top"}}))
    for r in out["top"][:n_rows]:
        log(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d}  {r['name'][:90]}")


@contextlib.contextmanager
def lm_head_range():
    """Wrap the model's LM-head product in a ``record_function("lm_head")``
    range, so a profile reads its device time."""
    import torch

    from edgellm_tpu_torch.models import transformer as tr

    orig = tr.head_matmul

    def head(a, b):
        with torch.profiler.record_function("lm_head"):
            return orig(a, b)

    tr.head_matmul = head
    try:
        yield
    finally:
        tr.head_matmul = orig


def profile_group(cfg, params, corpus, kw, attn_flops_per_window: float) -> dict:
    """Where chunk 0 and one steady group of the main path spend the card's
    time (:func:`device_time`), the two attention kernels' achieved FLOP/s
    on the attention work of those chunks, and the LM head's device time
    (bf16 operands into fp32)."""
    from edgellm_tpu_torch.eval import run_token_sweep

    n = 1 + kw["window_batch"]
    group = lambda: run_token_sweep(cfg, params, corpus, max_chunks=n, **kw)  # noqa: E731
    with lm_head_range():
        out, rows = device_time(group, n)
    attn = {k: sum(r["device_ms"] for r in rows if k in r["name"])
            for k in ("attn_fwd_wgmma", "attn_col_wgmma")}  # the bf16 kernels
    if not all(attn.values()):
        raise SystemExit(f"the profile shows no bf16 attention kernel: {attn}")
    attn_ms = sum(attn.values())
    out["attention_kernel_ms"] = attn
    out["attention_share"] = attn_ms / out["device_busy_ms"]
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
            "ternary_decode": ck.ternary_decode, "remote_hop": fh.remote_hop,
            "paged_decode_attention": fa.paged_decode_attention,
            "paged_decode_attention_quant": fa.paged_decode_attention_quant}


#: K-attn's launches by dtype, beside its total (fp32: the split stages
#: behind an unfused hop and the serve prefills; bf16: the rest)
ATTN_BY_DTYPE = ("causal_attention float32", "causal_attention bfloat16")


def reset_counts():
    from edgellm_tpu_torch.models import flash_attention as fa

    for fn in _wrappers().values():
        fn.launches = 0
    for fn in (fa.causal_attention, fa.causal_attention_stats):
        for dtype in fn.launches_by_dtype:
            fn.launches_by_dtype[dtype] = 0


def read_counts() -> dict:
    """Every wrapper's launches by its KERNELS name, and K-attn's by dtype
    (:data:`ATTN_BY_DTYPE`)."""
    from edgellm_tpu_torch.models import flash_attention as fa

    counts = {name: fn.launches for name, fn in _wrappers().items()}
    counts.update({f"causal_attention {d}": n
                   for d, n in fa.causal_attention.launches_by_dtype.items()})
    return counts


def want_counts(fp32_attn: int = 0, **launches) -> dict:
    """Expected counts: every kernel 0 unless given, K-attn's fp32 share
    ``fp32_attn`` of its total and the rest bf16."""
    want = dict.fromkeys(KERNELS, 0)
    want.update(launches)
    want["causal_attention float32"] = fp32_attn
    want["causal_attention bfloat16"] = want["causal_attention"] - fp32_attn
    return want


def codec_bytes(kernel: str, n: int, d: int, itemsize: int = 4) -> int:
    """Bytes a codec kernel must move at (N, D): each input read once, each
    output written once (the payload and its float32 scales or the (1, D)
    channel scale, the float32 activation; K8 reads the activation and
    writes the sealed buffer, the decoded activation and its flag byte).
    ``itemsize``: bytes an element of K3's and K8's input hidden takes (2 for
    a bf16 or fp16 hidden, which they read as it is; K8's decode is written
    in the hidden's dtype)."""
    act, chan = 4 * n * d, 4 * d
    return {"int4_encode": act + n * d // 2 + 4 * n, "int4_decode": act + n * d // 2 + 4 * n,
            "int8_affine_encode": itemsize * n * d + n * d + 8 * n,
            "int8_affine_decode": act + n * d + 8 * n,
            "chan_int8_encode": act + chan + n * d, "chan_int8_decode": act + chan + n * d,
            "chan_int4_encode": act + chan + n * d // 2,
            "ternary_encode": act + chan + n * d // 4, "ternary_decode": act + chan + n * d // 4,
            "remote_hop": 2 * itemsize * n * d + (8 + 8 * n + n * d) + 1}[kernel]


#: the codec rows the kernels line takes where not the plain float32 call:
#: the split paths run K3 and K8 on the model's bf16 hidden, saturated in
#: the kernel
MAIN_CODEC_LABEL = {"int8_affine_encode": " bfloat16 saturating",
                    "remote_hop": " bfloat16 saturating"}

#: a call whose CUDA-event time exceeds its device time by more than this
#: is host-bound: the events time the wrapper's launches, not the kernel
HOST_BOUND = 2.0


def _same(got, want) -> bool:
    """Bit for bit equal (a NaN equal to a NaN), dtype and shape too."""
    return (got.dtype == want.dtype and got.shape == want.shape
            and bool(((got == want) | ((got != got) & (want != want))).all()))


def codec_checks(detail: dict) -> dict:
    """Phases 3 and 4 for K1-K8 (and K2 with a (1, D) channel scale, alone
    and as the int4_per_channel twin's decode; K3 also saturating a float32,
    bf16 and fp16 hidden in the kernel): each against its plain version on
    the card, bit for bit (K8's sealed buffer byte for byte against the wire
    path's), timed on the device (torch.profiler, :func:`device_ms`) beside
    the call's CUDA-event time (host-bound where it is over
    :data:`HOST_BOUND` times the device's) and the bound, K3 and K4 at
    N = 4096 also from a cold L2; and K8's receive over a flipped byte
    failing its verify -> {kernel name: its row at the split path's shape
    (N=4096, D=896; K3's on a bf16 hidden, :data:`MAIN_CODEC_LABEL`)}."""
    import torch

    from edgellm_tpu_torch.codecs import codec_kernels as ck
    from edgellm_tpu_torch.codecs import fused_hop as fh
    from edgellm_tpu_torch.codecs.packing import SATURATE_MAG, get_wire_codec, sanitize_hidden
    from edgellm_tpu_torch.models import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    twin4 = get_wire_codec("int4_per_channel_pallas")
    flush = torch.empty((64 << 20,), dtype=torch.float32, device="cuda")  # 256 MB > L2
    rows, main, flips = [], {}, []
    for n, d in ((4096, 896), (4096, 1536), (1, 896), (511, 896)):
        x = torch.randn((n, d), generator=gen, device="cuda") * 3
        x[0] = 0.0
        x[n // 2] = 1.5  # a constant row: scale 0 for the affine codec
        x[(3 * n) // 4, :3] = torch.tensor([float("nan"), float("inf"), float("-inf")],
                                           device="cuda")
        # K3's saturating entry: the hidden unsaturated, in each dtype, with a
        # value above max_mag besides NaN and +-Inf (fp16 rounds both to Inf)
        raw = x.clone()
        raw[n // 4, 1] = 1.0001e30
        raw = {dt: raw.to(dt) for dt in (torch.float32, torch.bfloat16, torch.float16)}
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
            *[("int8_affine_encode", f" {str(dt)[6:]} saturating",
               lambda h=h: ck.int8_affine_encode(h, max_mag=SATURATE_MAG),
               lambda h=h: ck.int8_affine_encode_plain(sanitize_hidden(h).float()))
              for dt, h in raw.items()],
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
            *[("remote_hop", f" {str(dt)[6:]} saturating",
               lambda h=h: fh.remote_hop(h, max_mag=SATURATE_MAG),
               lambda h=h: fh.remote_hop_plain(h, max_mag=SATURATE_MAG))
              for dt, h in raw.items()],
        ]
        for name, label, kern, plain in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max((g.float() - w.float()).abs().nan_to_num().max().item()
                      for g, w in zip(got, want))
            exact = all(_same(g, w) for g, w in zip(got, want))
            if name == "remote_hop":  # (decoded, ok, buffer): the verify passed too
                exact = exact and bool(got[1])
            itemsize = 2 if label.startswith((" bfloat16", " float16")) else 4
            nbytes = codec_bytes(name, n, d, itemsize)
            if name == "int4_decode" and label:  # a (1, D) scale instead of (N, 1)
                nbytes += 4 * d - 4 * n
            bound, bound_by = fa.bound_ms(float(nbytes), 0.0, torch.float32)
            ev_ms, p_ms = time_ms(kern, 50), time_ms(plain, 20)
            k_dev = device_ms(kern, 50)
            cold = (device_ms(kern, 20, flush=flush)
                    if name.startswith("int8_affine") and n == 4096 else None)
            row = {"kernel": name + label, "n": n, "d": d, "exact": exact,
                   "dtype": label.split()[0] if itemsize == 2 else "float32",
                   "max_abs_err": err, "kernel_ms": k_dev, "kernel_cold_ms": cold,
                   "event_ms": ev_ms, "host_bound": ev_ms > HOST_BOUND * k_dev,
                   "plain_ms": p_ms, "library_ms": None, "bound_ms": bound,
                   "bound_by": bound_by, "bytes": nbytes, "roofline_share": bound / k_dev,
                   "cold_roofline_share": bound / cold if cold else None}
            rows.append(row)
            log(json.dumps(row))
            if not exact:
                raise SystemExit(f"{name}{label} is not bit-exact against its plain "
                                 f"version at N={n}, D={d}: {row}")
            if (n, d) == (4096, 896) and label == MAIN_CODEC_LABEL.get(name, ""):
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
    detail["fused_remote_hop"] = fused_remote_hop_reads()
    return main


def fused_remote_hop_reads() -> dict:
    """One ``fused_remote_hop`` call on a split10 group's hidden, (8, 512,
    896) in bf16 (the split paths' dtype) with NaN, +-Inf and 1e30 in it: the
    kernels it puts on the card (at most 2: K8 and the select), its device
    time beside its bound (the hidden read, the result and the wire buffer
    written), and its result bit for bit the fused "wire" hop's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from edgellm_tpu_torch.codecs import fused_hop as fh
    from edgellm_tpu_torch.codecs.packing import get_wire_codec
    from edgellm_tpu_torch.models import flash_attention as fa

    b, s, d = 8, 512, 896
    h = torch.randn((b, s, d), generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda") * 3
    h[0, 1, :3] = torch.tensor([float("nan"), float("inf"), float("-inf")], device="cuda")
    h[1, 2, 5] = 1.0001e30
    h = h.to(torch.bfloat16)
    codec = get_wire_codec("int8_per_token_pallas")
    call = lambda: fh.fused_remote_hop(codec, h, h.device)  # noqa: E731
    got = call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = {ev.key[:80]: ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    nbytes = 2 * 2 * b * s * d + fh.remote_hop_nbytes(b * s, d)
    bound, bound_by = fa.bound_ms(float(nbytes), 0.0, torch.float32)
    row = {"shape": [b, s, d], "dtype": "bfloat16", "kernels": kernels,
           "n_kernels": sum(kernels.values()), "device_ms": device_ms(call, 50),
           "event_ms": time_ms(call, 50), "bound_ms": bound, "bound_by": bound_by,
           "same_as_wire": _same(got, fh.fused_wire_hop(codec, h, h.device))}
    log(json.dumps({"fused_remote_hop": row}))
    if row["n_kernels"] > 2 or not row["same_as_wire"]:
        raise SystemExit(f"a fused remote hop is not K8 and the select, or differs from the "
                         f"wire hop: {row}")
    return row


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


def _expected(n_layers: int, hops: dict, stats_layers: int = 0, hop_iters: int = 0,
              fp32_layers: int = 0):
    """Launch counts of a split run of ``n_groups`` groups: one K-attn per
    layer per group, ``fp32_layers`` of them in fp32 (the stages behind an
    unfused hop compute in fp32: :func:`_fp32_layers`), one K-stats per
    importance-pass layer per group, one encode and one decode per
    kernel-backed hop per group, plus ``hop_iters`` of each from time_hops /
    time_decode_hops."""
    def expect(n_groups: int) -> dict:
        return want_counts(fp32_layers * n_groups, causal_attention=n_layers * n_groups,
                           causal_attention_stats=stats_layers * n_groups,
                           **{kernel: count * (n_groups + hop_iters)
                              for kernel, count in hops.items()})
    return expect


def _fp32_layers(cfg, cuts, fused: bool = False) -> int:
    """Layers after the first cut: a bf16 model's stages behind a separate
    (unfused) hop compute in fp32, as the reference promotes the hidden
    (parallel/split.py); behind fused hops they stay bf16."""
    return 0 if fused else cfg.num_layers - (cuts[0] + 1)


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
                  hop_iters=HOP_ITERS, fp32_layers=_fp32_layers(cfg, [11])),
        cuts=[11], hop_codecs=["int8_per_token"])
    detail["split_paths"]["split1 qwen2-0.5b cut 11 int8_per_token"]["profile"] = \
        profile_split_group(cfg, params, "profile_split_group", cuts=[11],
                            hop_codecs=["int8_per_token"])
    out["split2"] = _split_run(
        args, detail, cfg, params, 9, "split2 qwen2-0.5b cut 11 selective_int4:0.25:bf16",
        _expected(cfg.num_layers, {}, stats_layers=cfg.num_layers,
                  fp32_layers=_fp32_layers(cfg, [11])), time_hops=False,
        cuts=[11], hop_codecs=["selective_int4:0.25:bf16"],
        importance_method="regular_importance")
    for codec, hops in (("int8_per_channel", {"chan_int8_encode": 1, "chan_int8_decode": 1}),
                        ("int4_per_channel", {"chan_int4_encode": 1, "int4_decode": 1}),
                        ("ternary_max", {"ternary_encode": 1, "ternary_decode": 1})):
        out[f"split1 {codec}"] = _split_run(
            args, detail, cfg, params, 9, f"split1 qwen2-0.5b cut 11 {codec}",
            _expected(cfg.num_layers, hops, hop_iters=HOP_ITERS,
                      fp32_layers=_fp32_layers(cfg, [11])),
            cuts=[11], hop_codecs=[codec])
    with open("configs/split10_qwen_fused.json") as f:
        split10 = json.load(f)
    separate = {"int8_affine_encode": 1, "int8_affine_decode": 1}
    for mode, hops in (("wire", separate), ("remote", {"remote_hop": 1}),
                       (split10["fused_hops"], separate)):
        label = f"split10 qwen2-0.5b cut 11 int8_per_token fused_hops {mode}"
        with fused_hops(mode):  # time_hops off: it times the separate hop
            out[f"split10 {mode}"] = _split_run(
                args, detail, cfg, params, 9, label,
                _expected(cfg.num_layers, hops, fp32_layers=_fp32_layers(
                    cfg, split10["cuts"], fused=mode in ("wire", "remote"))),
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
                  hop_iters=HOP_ITERS, fp32_layers=_fp32_layers(cfg, [9, 18])),
        cuts=[9, 18], hop_codecs=["int8_per_token", "int4_per_token"])
    del params
    torch.cuda.empty_cache()
    return out


#: the CLI sweeps of the fp32 phase: (params file, --model, --head-weights
#: file or None); the CLI's defaults otherwise (fp32 random weights from
#: --seed, a synthetic corpus, window batch 8)
CLI_SWEEPS = (("configs/qwen_baseline_table.json", "qwen2-0.5b", None),
              ("configs/pythia_last_row.json", "pythia-70m", None))
#: chunk 0 alone, then one group of 8
CLI_CHUNKS = 9


def _cli_expected(cfg, params_json: dict, n_groups: int) -> dict:
    """The launches a token-sweep config implies (eval/harness.py): each
    group's stats prefix runs K-stats on every layer up to the deepest layer
    of interest; each (method, layer of interest) runs one suffix pass over
    the layers after it (every nonzero ratio batched into it; ratio 0 is the
    prefix's own tail, and its continuation past the deepest layer) -> K-attn.
    The CLI's weights are fp32: every attention launch is fp32."""
    layers = params_json["layers_of_interest"]
    deepest = max(layers)
    n_methods = len(params_json["methods"])
    zero = any(float(r) == 0.0 for r in params_json["ratios"])
    suffix = sum(cfg.num_layers - 1 - layer for layer in layers) * n_methods
    tail = cfg.num_layers - 1 - deepest if zero else 0  # the ratio-0 continuation
    attn = (suffix + tail) * n_groups
    return want_counts(attn, causal_attention=attn,
                       causal_attention_stats=(deepest + 1) * n_groups)


def cli_sweeps(args, detail: dict, sweeps=CLI_SWEEPS) -> dict:
    """The fp32 phase: ``edgellm_tpu_torch.run.main`` as a user runs it, on
    each of ``sweeps`` (by default configs/qwen_baseline_table.json,
    Qwen2-0.5B at full width and depth: 24 K-stats a group, and
    configs/pythia_last_row.json, Pythia-70M at S = 2048: the blocked
    envelope, 6 a group), with its ``--head-weights`` where given, fp32
    random weights from ``--seed``, a synthetic corpus, :data:`CLI_CHUNKS`
    chunks: s/chunk, scored tokens/s, peak memory, a finite PPL table of the
    config's shape, every kernel's launches against the count the groups
    imply (all fp32), and one group under torch.profiler with the column
    pass, the forward and the LM head named -> launches by path."""
    import argparse as ap
    import tempfile

    import torch

    from edgellm_tpu_torch import run
    from edgellm_tpu_torch.eval import run_token_sweep
    from edgellm_tpu_torch.models import flash_attention as fa

    out = {}
    for path, model, head_weights in sweeps:
        with open(path) as f:
            params_json = json.load(f)
        hw_args = ["--head-weights", head_weights] if head_weights else []
        label = f"cli {os.path.basename(path)[:-5]} {model} fp32"
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.monotonic()
            rc = run.main(["--params", path, "--model", model, "--max-chunks",
                           str(CLI_CHUNKS), "--seed", str(args.seed), "--output-dir", tmp]
                          + hw_args)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = read_counts()
            stats_by_dtype = dict(fa.causal_attention_stats.launches_by_dtype)
            with open(os.path.join(tmp, "avg_ppl_results.json")) as f:
                result = json.load(f)
        cfg, params = run._load_model(ap.Namespace(weights=None, model=model, seed=args.seed),
                                      torch.device("cuda"))
        n_groups = 1 + math.ceil((result["chunks"] - 1) / 8)  # chunk 0 runs alone
        want = _cli_expected(cfg, params_json, n_groups)
        ppl = np.asarray(result["ppl"])
        shape = (len(params_json["methods"]), len(params_json["layers_of_interest"]),
                 len(params_json["ratios"]))
        summary = {"path": label, "rc": rc, "chunks": result["chunks"], "groups": n_groups,
                   "wall_s": wall, "eval_wall_s": result["wall_s"],
                   "s_per_chunk": result["wall_s"] / result["chunks"],
                   "scored_tokens_per_s": result["n_tokens"] / result["wall_s"],
                   "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "params_dtype": str(params["embed"].dtype), "ppl": ppl.tolist(),
                   "head_weights": head_weights,
                   "launches": launches, "launches_expected": want,
                   "stats_launches_by_dtype": stats_by_dtype}
        log(json.dumps({"cli_sweep": summary}))
        detail.setdefault("cli_sweeps", {})[label] = summary
        if rc != 0 or result["chunks"] != CLI_CHUNKS or ppl.shape != shape \
                or not np.isfinite(ppl).all():
            raise SystemExit(f"{label}: rc {rc}, {result['chunks']} chunks, PPL {ppl}")
        if launches != want or stats_by_dtype["float32"] != want["causal_attention_stats"] \
                or summary["params_dtype"] != "torch.float32":
            raise SystemExit(f"{label}: kernel launches {launches} (stats by dtype "
                             f"{stats_by_dtype}) != expected {want}")
        out[label] = launches
        # one group (chunk 0 and 8 windows) again, timed alone and profiled
        corpus = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, 4096)
        kw = dict(methods=params_json["methods"],
                  layers_of_interest=params_json["layers_of_interest"],
                  ratios=params_json["ratios"], max_length=params_json["max_length"],
                  stride=params_json["stride"], window_batch=8, max_chunks=CLI_CHUNKS,
                  device="cuda")
        if head_weights:
            with open(head_weights) as f:
                kw["head_weights"] = np.asarray(json.load(f))
        group = lambda: run_token_sweep(cfg, params, corpus, **kw)  # noqa: E731
        with lm_head_range():
            prof, rows = device_time(group, CLI_CHUNKS)
        named = {k: sum(r["device_ms"] for r in rows if k in r["name"])
                 for k in ("attn_col_tf32", "attn_fwd_tf32", "attn_fwd_merge")}
        prof["named_device_ms"] = {**named, "lm_head": prof["range_device_ms"].get("lm_head")}
        prof["launches_in_profile"] = {r["name"][:60]: r["calls"] for r in rows
                                       if "attn_" in r["name"]}
        log_profile(f"profile_{label.replace(' ', '_')}", prof, 12)
        summary["profile"] = prof
        if not (named["attn_col_tf32"] and named["attn_fwd_tf32"]):
            raise SystemExit(f"{label}: the profile shows no fp32 attention kernel: {named}")
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


def _paged_case(b: int, h: int, kv: int, hd: int, ps: int, pps: int, num_pages: int, dtype,
                kv_codec: str, seed: int):
    """Paged-attention inputs on the card: a pool of ``num_pages`` random
    pages, b slots of ragged lengths from 1 to the full span, the last
    quarter of the slots inactive (an all-zero row on the trash page, length
    1). Slots take distinct pages where the pool holds them all, else pages
    drawn with repeats (slots sharing pages, as prefix sharing makes them)
    -> (args, kwargs) of the kernel wrapper and its plain version."""
    import torch

    from edgellm_tpu_torch.models import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    k = torch.randn((num_pages, ps, kv, hd), generator=gen, device="cuda")
    v = torch.randn((num_pages, ps, kv, hd), generator=gen, device="cuda")
    q = torch.randn((b, 1, h, hd), generator=gen, device="cuda").to(dtype)
    lengths = rng.integers(1, pps * ps + 1, size=b)
    lengths[0], lengths[min(1, b - 1)] = 1, pps * ps
    live = b - b // 4 if b > 3 else b
    if num_pages > b * pps:
        pages = rng.permutation(np.arange(1, num_pages))[:b * pps].reshape(b, pps)
    else:
        pages = rng.integers(1, num_pages, size=(b, pps))
    table = np.where(np.arange(pps)[None, :] * ps < lengths[:, None], pages, 0)
    table[live:], lengths[live:] = 0, 1
    t = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()
    if kv_codec == "fp":
        k, v = k.to(dtype), v.to(dtype)
        return (q, k, v, t(table), t(lengths)), {"plan": fa.paged_plan(q, k, t(table))}
    kc, ks = fa.quantize_kv_rows(k, kv_codec)
    vc, vs = fa.quantize_kv_rows(v, kv_codec)
    return (q, kc, vc, ks, vs, t(table), t(lengths)), {
        "kv_codec": kv_codec, "plan": fa.paged_plan(q, kc, t(table), kv_codec)}


def paged_sdpa(args, kv_codec: str):
    """The library yardstick of K13 / K14 (timed only, never the port's
    path): ``scaled_dot_product_attention`` with ``enable_gqa`` over each
    slot's span already gathered (and dequantized) in q's dtype, with a
    per-slot length mask -> a call that computes the same function."""
    import torch
    import torch.nn.functional as F

    from edgellm_tpu_torch.models import flash_attention as fa

    if kv_codec == "fp":
        q, kp, vp, table, lengths = args
        k, v = fa._gather_span(kp, table), fa._gather_span(vp, table)
    else:
        q, kc, vc, ks, vs, table, lengths = args
        k = fa.dequantize_kv_rows(fa._gather_span(kc, table), fa._gather_span(ks, table),
                                  kv_codec, q.dtype)
        v = fa.dequantize_kv_rows(fa._gather_span(vc, table), fa._gather_span(vs, table),
                                  kv_codec, q.dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)


def paged_checks(detail: dict) -> dict:
    """Phase 10: K13 and K14 against their plain versions, twice and bit for
    bit equal, and timed with CUDA events and on the device (torch.profiler:
    the split kernel and the merge) beside their bound (the live K/V rows of every slot read once, q read,
    the output written, over 3.35 TB/s; or 4 * H * hd FLOPs a live row over
    the peak of q's type), the split count and the SDPA yardstick
    (:func:`paged_sdpa`), at the 2048 span and at each serve path's own
    geometry (slots, page size, pages per slot and pool pages of its
    ``batching`` block, split14's pool from its byte budget) -> {kernel: its
    row at the shape of the serve path it runs on: K13 fp32 at the large
    split9 geometry, K14 int4 at split14's}."""
    import torch

    from edgellm_tpu_torch.models import PRESETS
    from edgellm_tpu_torch.models import flash_attention as fa
    from edgellm_tpu_torch.run import batching_config

    cfg = PRESETS["qwen2-0.5b"]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = [  # (label, b, h, kv, hd, ps, pps, num_pages, main-path (kernel, tier))
        ("qwen2-0.5b span 2048", 32, 14, 2, 64, 16, 128, 32 * 128 + 1, None),
        ("qwen2-1.5b span 2048", 32, 12, 2, 128, 16, 128, 32 * 128 + 1, None)]
    for label, params, main_row in (
            ("split9 large", LARGE_SERVE, ("paged_decode_attention", "fp")),
            ("split9", "split9_qwen_paged", None),
            ("split13", "split13_qwen_prefix", None),
            ("split14", "split14_qwen_kvq",
             ("paged_decode_attention_quant", "int4_per_channel"))):
        if isinstance(params, str):
            params = json.load(open(f"configs/{params}.json"))
        bc = batching_config(cfg, params)
        shapes.append((f"qwen2-0.5b {label} geometry span {bc.pages_per_slot * bc.page_size}",
                       bc.max_slots, h, kv, hd, bc.page_size, bc.pages_per_slot,
                       bc.num_pages, main_row))
    cases = [("paged_decode_attention", torch.float32, "fp"),
             ("paged_decode_attention", torch.bfloat16, "fp"),
             ("paged_decode_attention_quant", torch.float32, "int8_per_channel"),
             ("paged_decode_attention_quant", torch.float32, "int4_per_channel")]
    rows, main = [], {}
    for label, b, h, kv, hd, ps, pps, num_pages, main_row in shapes:
        for name, dtype, kv_codec in cases:
            dname = str(dtype).split(".")[-1]
            args, kw = _paged_case(b, h, kv, hd, ps, pps, num_pages, dtype, kv_codec,
                                   seed=b + hd + ps + pps)
            kern = getattr(fa, name)
            plain = getattr(fa, name + "_plain")
            pkw = {k: v for k, v in kw.items() if k != "plan"}
            got, again, want = kern(*args, **kw), kern(*args, **kw), plain(*args, **pkw)
            torch.cuda.synchronize()
            tol = PAGED_TOL["quant" if kv_codec != "fp" else dname]
            err, ok = close(got, want, tol)
            q, pages, lengths = args[0], args[1], args[-1]
            nbytes = fa.paged_decode_bytes(q, pages, lengths, kv_codec)
            flops = 4.0 * h * hd * float(lengths.long().sum().item())
            bound, bound_by = fa.bound_ms(nbytes, flops, dtype)
            k_ms = time_ms(lambda: kern(*args, **kw), 50)
            k_dev = device_ms(lambda: kern(*args, **kw), 50)
            p_ms = time_ms(lambda: plain(*args, **pkw), 10)
            sdpa = paged_sdpa(args, kv_codec)
            lib_ms, lib_dev = time_ms(sdpa, 50), device_ms(sdpa, 50)
            row = {"kernel": name, "shape": label, "dtype": dname, "kv_codec": kv_codec,
                   "b": b, "h": h, "kv": kv, "hd": hd, "page_size": ps, "pages_per_slot": pps,
                   "num_pages": num_pages,
                   "splits": fa.paged_split_plan(b, h, kv, ps, pps, fa._sm_count(q.device))[0],
                   "live_rows": int(lengths.long().sum().item()), "max_abs_err": err,
                   "tolerance": tol, "repeatable": torch.equal(got, again),
                   "kernel_ms": k_ms, "kernel_device_ms": k_dev, "plain_ms": p_ms,
                   "library_ms": lib_ms, "library_device_ms": lib_dev,
                   "library": "SDPA (enable_gqa) over the gathered span, length mask",
                   "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                   "roofline_share": bound / k_ms, "device_roofline_share": bound / k_dev}
            rows.append(row)
            log(json.dumps(row))
            log(f"  {name} {label} {dname} {kv_codec}: {k_ms:.4f} ms ({k_dev:.4f} on the "
                f"device), {row['splits']} splits, bound {bound:.5f} ms, SDPA {lib_ms:.4f} "
                f"({lib_dev:.4f} on the device)")
            if not ok or not row["repeatable"]:
                raise SystemExit(f"{name} disagrees with its plain version or with itself at "
                                 f"{label} {dname} {kv_codec}: {row}")
            # the serve paths run fp32 q: K13 over fp pages, K14 over split14's int4
            if main_row == (name, kv_codec) and dname == "float32":
                main[name] = row
    detail["paged_rows"] = rows
    return main


#: the larger geometry of split9's shape the serve phase adds: 64 requests
#: of 512 prompt tokens and 64 new ones on 32 slots of 40 pages of 16, a
#: 1281-page fp32 pool (about 0.5 GB at Qwen2-0.5B), best effort (no
#: deadline: the admission price of 64 queued 512-token requests exceeds
#: split9's 120 s)
LARGE_SERVE = {
    "experiment": "serve",
    "serving": {"admission": {"max_queue_depth": 64}, "capacity_round": 16,
                "soak": {"n_requests": 64, "arrival_rate": 2.0, "prompt_len": 512,
                         "max_new_tokens": 64, "deadline_s": None}},
    "batching": {"page_size": 16, "num_pages": 1281, "max_slots": 32, "pages_per_slot": 40},
}


def serve_paths(args, detail: dict) -> dict:
    """Phase 11: the batched serve paths at full Qwen2-0.5B width and depth
    through ``run_serve`` (what ``python -m edgellm_tpu_torch.run`` calls),
    every count set to 0 just before each path and read just after ->
    launches by path. run_serve warms its batcher first (one prefill and one
    step of the soak's prompt shape), so each count holds one more prefill
    and one more step than the path's report."""
    import torch

    from edgellm_tpu_torch.models import PRESETS, init_params
    from edgellm_tpu_torch.run import run_serve

    cfg = PRESETS["qwen2-0.5b"]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                         device="cuda")
    out_dir = os.path.join(args.out or ".", "serve")
    os.makedirs(out_dir, exist_ok=True)
    cases = [(name, json.load(open(f"configs/{name}_qwen_{suffix}.json")))
             for name, suffix in (("split9", "paged"), ("split13", "prefix"),
                                  ("split14", "kvq"))]
    cases.append(("split9 large", LARGE_SERVE))
    paths = {}
    for label, p in cases:
        kv_codec = p.get("kv_at_rest", {}).get("codec", "fp")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.monotonic()
        summary = run_serve(cfg, params, p,
                            lambda f: os.path.join(out_dir, label.replace(" ", "_") + "_" + f))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_counts()
        rep = summary["_batcher"]
        hits = rep.get("prefix", {}).get("hits", 0)
        prefills = rep["admitted"] - rep["evicted"] - hits
        attn = "paged_decode_attention" if kv_codec == "fp" else "paged_decode_attention_quant"
        # fp32 weights: every prefill layer launches fp32 K-attn
        want = want_counts(cfg.num_layers * (prefills + 1),
                           causal_attention=cfg.num_layers * (prefills + 1),
                           **{attn: cfg.num_layers * (rep["steps"] + 1)})
        n = p["serving"]["soak"]["n_requests"]
        row = {"path": label, "kv_codec": kv_codec, "requests": summary["requests"],
               "outcomes": summary["outcomes"], "batched_steps": rep["steps"],
               "admitted": rep["admitted"], "evicted": rep["evicted"], "prefills": prefills,
               "decode_tokens_per_s": rep["decode_tokens_per_s"],
               "ms_per_step": 1e3 * rep["decode_s"] / max(rep["steps"], 1),
               "prefill_s": rep["prefill_s"], "decode_s": rep["decode_s"], "wall_s": wall,
               "occupancy_mean": summary["occupancy_mean"],
               "prefix_hit_rate": summary.get("prefix_hit_rate"),
               "prefill_tokens_saved": summary.get("prefill_tokens_saved"),
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches, "launches_expected": want}
        log(json.dumps({"serve_path": row}))
        detail.setdefault("serve_paths", {})[label] = row
        if summary["requests"] != n or summary["outcomes"] != {"completed": n}:
            raise SystemExit(f"{label}: not every request completed: {row}")
        if launches != want:
            raise SystemExit(f"{label}: kernel launches {launches} != expected {want}")
        if label == "split13" and not hits:
            raise SystemExit(f"split13: the prefix index never hit: {row}")
        paths[label] = launches
    detail["serve_paths"]["split9 large"]["profile"] = profile_serve_steps(cfg, params)
    del params
    torch.cuda.empty_cache()
    return paths


def profile_serve_steps(cfg, params, n_steps: int = 10) -> dict:
    """Where one steady group of ``n_steps`` ragged steps of the large
    geometry spends the card's time (:func:`device_time`): 32 running
    slots of 512-token prompts, sampled at temperature 0.7."""
    from edgellm_tpu_torch.run import batching_config
    from edgellm_tpu_torch.serve import ContinuousBatcher

    b = ContinuousBatcher(cfg, params, batching_config(cfg, LARGE_SERVE))
    rng = np.random.default_rng(11)
    for i in range(32):
        b.submit(rng.integers(1, cfg.vocab_size, 512), 64, temperature=0.7, rng_seed=i)
    for _ in range(3):  # admit every slot, then a few steady steps
        b.step()
    out, rows = device_time(lambda: [b.step() for _ in range(n_steps)], n_steps)
    out["steps"] = out.pop("chunks")
    paged = sum(r["device_ms"] for r in rows if "paged_" in r["name"])
    out["paged_decode_device_ms"] = paged
    out["paged_decode_share"] = paged / out["device_busy_ms"]
    log_profile("profile_serve_steps", out, 15)
    return out


def _forced_logits_paged(cfg, params, prompts, forced, device, kv_codec: str):
    """Teacher-forced logits of the ragged paged step: each prompt prefilled
    and adopted into its own slot, then every step fed ``forced[:, t]``
    -> (T, B, V) fp32 on the CPU."""
    import torch

    from edgellm_tpu_torch.models.paged_kv import PagedKVCache, paged_decode_step, \
        paged_decode_step_quant
    from edgellm_tpu_torch.serve.decode import _prefill_impl

    b, steps = forced.shape
    # the committed serve configs' page size, 8
    pool = PagedKVCache(cfg, num_pages=1 + b * 16, page_size=8, max_slots=b, pages_per_slot=16,
                        device=device, kv_codec=kv_codec)
    for p in prompts:
        slot = pool.alloc_slot()
        ids = torch.from_numpy(p[None].astype(np.int64)).to(device)
        _, cache = _prefill_impl(cfg, params, ids, len(p), None)
        pool.adopt(slot, cache.k[:, 0], cache.v[:, 0], len(p))
    out = []
    for t in range(steps):
        for slot in range(b):
            pool.ensure_writable(slot, int(pool.lengths[slot]) + 1)
        table, lengths = pool.device_tables()
        toks = torch.from_numpy(forced[:, t].astype(np.int64)).to(device)
        if kv_codec == "fp":
            logits = paged_decode_step(cfg, params, *pool.pool, table, lengths, toks)[0]
        else:
            logits = paged_decode_step_quant(cfg, params, *pool.pool, table, lengths, toks,
                                             kv_codec=kv_codec)[0]
        out.append(logits.cpu())
        pool.lengths += 1
    return torch.stack(out)


def _forced_logits_alone(cfg, params, prompt, forced_row, device):
    """The same forcing through one stream's contiguous cache (prefill +
    ``decode_step``, no kernel in the decode attention) -> (T, V)."""
    import torch

    from edgellm_tpu_torch.models.transformer import decode_step
    from edgellm_tpu_torch.serve.decode import _prefill_impl

    ids = torch.from_numpy(prompt[None].astype(np.int64)).to(device)
    _, cache = _prefill_impl(cfg, params, ids, len(prompt) + len(forced_row), None)
    out = []
    for tok in forced_row:
        logits, cache = decode_step(cfg, params, cache,
                                    torch.tensor([int(tok)], device=device))
        out.append(logits[0].cpu())
    return torch.stack(out)


def serve_cross_checks(args, detail: dict):
    """Phase 12 at Qwen2-0.5B width, 3 layers, fp32: the teacher-forced
    paged step on the card (K13 / K14) against the CPU (plain versions) for
    every tier; on the card, the paged step (K13) against each stream's
    contiguous decode step (they are not bit-identical on the card: K13 is
    the online-softmax recurrence, as the reference's kernel is at
    flash_attention.py:707-711); greedy batched streams identical on the
    card and the CPU, and on the card identical to each stream alone
    through ``generate``."""
    import torch

    from edgellm_tpu_torch.models import PRESETS, init_params, params_to
    from edgellm_tpu_torch.serve import BatchingConfig, ContinuousBatcher, generate

    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=3)
    cpu = init_params(cfg, torch.Generator().manual_seed(args.seed), device="cpu")
    card = params_to(cpu, device="cuda")
    rng = np.random.default_rng(args.seed + 3)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 37, 64, 100)]
    forced = rng.integers(1, cfg.vocab_size, (len(prompts), 6))
    rows = {}

    def check(name, got, want, tol):
        diff = (got - want).abs()
        row = {"max_abs_diff": diff.max().item(),
               "max_rel_diff": (diff / want.abs().clamp(min=1e-6)).max().item(),
               "tolerance": tol, "max_abs_logit": want.abs().max().item()}
        rows[name] = row
        log(json.dumps({"serve_cross_check": {name: row}}))
        if not bool((diff <= tol[0] + tol[1] * want.abs()).all()):
            raise SystemExit(f"serve cross-check {name} failed: {row}")

    on_card = {}
    for kv_codec in ("fp", "int8_per_channel", "int4_per_channel"):
        tol = PAGED_CROSS_TOL["fp" if kv_codec == "fp" else "quant"]
        on_card[kv_codec] = _forced_logits_paged(cfg, card, prompts, forced, "cuda", kv_codec)
        want = _forced_logits_paged(cfg, cpu, prompts, forced, "cpu", kv_codec)
        check(f"paged step {kv_codec} card vs cpu", on_card[kv_codec], want, tol)
    alone = torch.stack([_forced_logits_alone(cfg, card, p, f, "cuda")
                         for p, f in zip(prompts, forced)], dim=1)
    check("paged step (K13) vs contiguous decode step, card", on_card["fp"], alone,
          PAGED_CROSS_TOL["fp"])

    bcfg = BatchingConfig(page_size=8, num_pages=80, max_slots=4, pages_per_slot=16)
    reqs = [rng.integers(1, cfg.vocab_size, int(n)) for n in rng.integers(3, 100, 6)]
    streams = {}
    for dev, params in (("cuda", card), ("cpu", cpu)):
        b = ContinuousBatcher(cfg, params, bcfg)
        sids = [b.submit(r, 8) for r in reqs]
        res = b.run()
        streams[dev] = [res[s] for s in sids]
    solo = [generate(cfg, card, r[None], 8)[0].cpu().numpy() for r in reqs]
    same_cpu = sum(np.array_equal(a, c) for a, c in zip(streams["cuda"], streams["cpu"]))
    same_solo = sum(np.array_equal(a, c) for a, c in zip(streams["cuda"], solo))
    rows["greedy streams"] = {"streams": len(reqs), "card_equals_cpu": same_cpu,
                              "batched_equals_generate_on_card": same_solo}
    log(json.dumps({"serve_cross_check": {"greedy streams": rows["greedy streams"]}}))
    detail["serve_cross_check"] = rows
    if same_cpu != len(reqs) or same_solo != len(reqs):
        raise SystemExit(f"greedy batched streams differ: {rows['greedy streams']}")


#: the paper's remaining experiments as the CLI runs them: LRP relevance
#: writes the head weights the weighted sweep reads
RELEVANCE_CONFIG = "configs/relevance.json"
WEIGHTED_SWEEP = "configs/split3_qwen_lxt_sweep.json"
#: the distance analysis's native sample lengths: fp32 K-stats' tile edges
#: (64 / 128 rows), the whole plan's S <= 512 and the blocked plan's 1024
#: (fp32 Qwen2-0.5B, dh 896, takes the blocked plan at every length)
DIST_LENGTHS = (2, 12, 63, 65, 127, 129, 300, 512, 1024)
#: relevance card vs CPU, (rtol, atol as a share of max |R|): the same fp32
#: products in another summation order through a backward pass, compared
#: only once both picked the same argmax tokens (the seed is discontinuous)
REL_CROSS_TOL = (1e-3, 1e-6)
#: the distance matrix card (K-stats) vs CPU (plain version), absolute
DIST_CROSS_ATOL = 1e-5


def _cli_run(argv) -> tuple[int, list]:
    """``edgellm_tpu_torch.run.main(argv)`` with its standard output caught ->
    (exit code, its lines)."""
    import io

    from edgellm_tpu_torch import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def _cli_json_line(argv) -> tuple[int, dict]:
    """``edgellm_tpu_torch.run.main(argv)`` with its standard output caught
    -> (exit code, its last line as JSON), the line logged."""
    rc, lines = _cli_run(argv)
    log(f"  cli printed: {lines[-1]}")
    return rc, json.loads(lines[-1])


def experiment_paths(args, detail: dict) -> dict:
    """Phase 14: the paper's remaining experiments through the CLI at full
    Qwen2-0.5B width and depth, fp32 random weights from ``--seed``:
    ``relevance`` (configs/relevance.json, :data:`CLI_CHUNKS` chunks, window
    batch 8; plain torch ops, no kernel launched) writes the (24, 14) head
    weights; configs/split3_qwen_lxt_sweep.json reads them (``cli_sweeps``:
    24 fp32 K-stats and 152 fp32 K-attn a group); ``distances`` on an
    ``.npz`` of one sample per :data:`DIST_LENGTHS` length (24 fp32 K-stats a
    sample); then the card against the CPU at 3 layers: ``chunk_relevance``
    for 2 windows of 512 (argmax tokens, then relevance) and the distance
    matrix -> launches by path."""
    import dataclasses
    import tempfile

    import torch

    from edgellm_tpu_torch import run
    from edgellm_tpu_torch.analysis import (layer_importance_distributions,
                                            pairwise_layer_distances)
    from edgellm_tpu_torch.importance.relevance import (chunk_relevance,
                                                        run_relevance_extraction)
    from edgellm_tpu_torch.models import PRESETS, init_params, params_to
    from edgellm_tpu_torch.models import flash_attention as fa

    out, rows = {}, {}
    base = ["--model", "qwen2-0.5b", "--seed", str(args.seed)]
    with tempfile.TemporaryDirectory() as tmp:
        label = "cli relevance qwen2-0.5b fp32"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.monotonic()
        rc, printed = _cli_json_line(["--params", RELEVANCE_CONFIG, "--max-chunks",
                                      str(CLI_CHUNKS), "--output-dir", tmp] + base)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_counts()
        hw_path = os.path.join(tmp, "attention_head_weights.json")
        with open(hw_path) as f:
            weights = np.asarray(json.load(f))
        row_sums = weights.sum(axis=1)
        rows[label] = {"rc": rc, "printed": printed, "wall_s": wall,
                       "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                       "shape": list(weights.shape),
                       "row_sum_max_dev": float(np.abs(row_sums - 1).max()),
                       "launches": launches}
        log(json.dumps({"relevance": rows[label]}))
        if rc != 0 or weights.shape != (24, 14) or not np.isfinite(weights).all() \
                or printed["chunks"] != CLI_CHUNKS or np.abs(row_sums - 1).max() > 1e-6:
            raise SystemExit(f"{label}: rc {rc}, {printed}, weights {weights.shape}, "
                             f"row sums {row_sums}")
        if launches != want_counts():
            raise SystemExit(f"{label}: the plain-torch path launched kernels: {launches}")
        out[label] = launches
        # one group (8 windows) again, timed alone and profiled: device time
        # by kind (fp32 GEMMs, softmax and the rest)
        cfg, params = run._load_model(argparse.Namespace(weights=None, model="qwen2-0.5b",
                                                         seed=args.seed), torch.device("cuda"))
        corpus = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, 4096)
        prof, prof_rows = device_time(lambda: run_relevance_extraction(
            cfg, params, corpus, max_length=512, stride=32, max_chunks=8, window_batch=8,
            device="cuda"), 8)
        prof["device_ms_by_kind"] = {
            kind: sum(r["device_ms"] for r in prof_rows if match(r["name"].lower()))
            for kind, match in (("gemm", lambda n: "gemm" in n),
                                ("softmax", lambda n: "softmax" in n),
                                ("other", lambda n: "gemm" not in n and "softmax" not in n))}
        log_profile("profile_relevance_group", prof, 12)
        rows[label]["profile"] = prof
        del params
        torch.cuda.empty_cache()
        out.update(cli_sweeps(args, detail, ((WEIGHTED_SWEEP, "qwen2-0.5b", hw_path),)))

    rng = np.random.default_rng(args.seed)
    samples = [rng.integers(0, PRESETS["qwen2-0.5b"].vocab_size, n) for n in DIST_LENGTHS]
    with tempfile.TemporaryDirectory() as tmp:
        label = "cli distances qwen2-0.5b fp32"
        npz = os.path.join(tmp, "samples.npz")
        np.savez(npz, **{f"s{n}": s for n, s in zip(DIST_LENGTHS, samples)})
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.monotonic()
        rc, printed = _cli_json_line(
            ["--params", json.dumps({"experiment": "distances", "max_length": 512}),
             "--corpus", npz, "--output-dir", tmp] + base)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_counts()
        stats_by_dtype = dict(fa.causal_attention_stats.launches_by_dtype)
        with open(os.path.join(tmp, "layer_distances.json")) as f:
            matrix = np.array([[np.nan if v is None else v for v in row]
                               for row in json.load(f)["matrix"]])
        heatmap_written = os.path.exists(os.path.join(tmp, "layer_distances.png"))
    want = want_counts(causal_attention_stats=24 * len(samples))
    upper = np.triu(np.ones((24, 24), dtype=bool), 1)
    rows[label] = {"rc": rc, "printed": printed, "wall_s": wall, "launches": launches,
                   "launches_expected": want, "stats_launches_by_dtype": stats_by_dtype,
                   "heatmap_written": heatmap_written, "lengths": list(DIST_LENGTHS)}
    log(json.dumps({"distances": rows[label]}))
    if rc != 0 or matrix.shape != (24, 24) or not np.isfinite(matrix[upper]).all() \
            or not np.isnan(matrix[~upper]).all() or printed["n_samples"] != len(samples) \
            or heatmap_written != (printed["heatmap"] is not None):
        raise SystemExit(f"{label}: rc {rc}, {printed}, matrix {matrix.shape}, "
                         f"heatmap written {heatmap_written}")
    if launches != want or stats_by_dtype["float32"] != want["causal_attention_stats"]:
        raise SystemExit(f"{label}: kernel launches {launches} (stats by dtype "
                         f"{stats_by_dtype}) != expected {want}")
    out[label] = launches

    # the card against the CPU at Qwen2-0.5B width, 3 layers
    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=3)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                         device="cuda")
    params_cpu = params_to(params, device="cpu")
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512)))
    rel, tokens = chunk_relevance(cfg, params, ids.cuda(), with_tokens=True)
    rel_cpu, tokens_cpu = chunk_relevance(cfg, params_cpu, ids, with_tokens=True)
    rel = rel.cpu()
    rtol, atol = REL_CROSS_TOL[0], REL_CROSS_TOL[1] * rel_cpu.abs().max().item()
    rel_err = (rel - rel_cpu).abs()
    cross = {"relevance tokens": [tokens.tolist(), tokens_cpu.tolist()],
             "relevance max_abs_err": rel_err.max().item(),
             "relevance max_rel_err": (rel_err / rel_cpu.abs().clamp_min(atol)).max().item()}
    if not torch.equal(tokens.cpu(), tokens_cpu):
        raise SystemExit(f"relevance: the seeds' argmax tokens differ: {cross}")
    if not bool((rel_err <= atol + rtol * rel_cpu.abs()).all()):
        raise SystemExit(f"relevance card vs CPU beyond rtol {rtol}, atol {atol}: {cross}")
    dist = pairwise_layer_distances(layer_importance_distributions(cfg, params, samples))
    dist_cpu = pairwise_layer_distances(layer_importance_distributions(
        cfg, params_cpu, samples, device="cpu"))
    cross["distances max_abs_err"] = float(np.nanmax(np.abs(dist - dist_cpu)))
    log(json.dumps({"experiment_cross_check": cross}))
    if not (np.isnan(dist) == np.isnan(dist_cpu)).all() \
            or cross["distances max_abs_err"] > DIST_CROSS_ATOL:
        raise SystemExit(f"distances card vs CPU beyond {DIST_CROSS_ATOL}: {cross}")
    detail["experiments"] = {**rows, "cross_check": cross}
    del params, params_cpu
    torch.cuda.empty_cache()
    return out


#: the per-request split route's config: Qwen2-0.5B, cut 11, int8_per_token,
#: speculative k = 4 with a stage-0 draft, 24 seeded requests at T = 0.7
SPLIT11_CONFIG = "configs/split11_qwen_spec.json"
#: teacher-forced split-decode and verify logits, card vs CPU (absolute, as
#: phase 13 holds serve): an fp32 hop, and an int8 hop, where a row that
#: rounds on a .5 boundary may move one code by a step
SPLIT_DECODE_TOL = {"fp32": 1e-4, "int8_per_token": 1e-3}
#: fused vs separate hop's teacher-forced logits on the card: both decode the
#: same bytes
FUSED_DECODE_ATOL = 1e-5


@contextlib.contextmanager
def split_call_log():
    """Count the split decode calls made inside: ``prefill_decode``,
    ``decode_step`` and ``verify_step`` of every ``SplitRuntime``, the local
    ``generate`` prefills (``decode._prefill_impl``), and the ``speculative``
    stats of every burst-loop call (a stats dict is handed to calls made
    without one) -> the log dict."""
    from edgellm_tpu_torch.parallel.split import SplitRuntime
    from edgellm_tpu_torch.serve import decode, speculative

    log_ = {"prefill_decode": 0, "decode_step": 0, "verify_step": 0, "local_prefill": 0,
            "spec_calls": []}
    saved = {name: getattr(SplitRuntime, name)
             for name in ("prefill_decode", "decode_step", "verify_step")}
    real_prefill, real_loop = decode._prefill_impl, speculative._spec_loop

    def counted(name):
        def call(self, *a, **kw):
            log_[name] += 1
            return saved[name](self, *a, **kw)
        return call

    def local_prefill(*a, **kw):
        log_["local_prefill"] += 1
        return real_prefill(*a, **kw)

    def spec_loop(*a):
        a = list(a)
        stats = a[-1] if a[-1] is not None else {}
        a[-1] = stats
        out = real_loop(*a)
        log_["spec_calls"].append(stats["speculative"])
        return out

    for name in saved:
        setattr(SplitRuntime, name, counted(name))
    decode._prefill_impl, speculative._spec_loop = local_prefill, spec_loop
    try:
        yield log_
    finally:
        for name, fn in saved.items():
            setattr(SplitRuntime, name, fn)
        decode._prefill_impl, speculative._spec_loop = real_prefill, real_loop


@contextlib.contextmanager
def attention_range():
    """Wrap the decode and verify attention (plain torch) in a
    ``record_function("attention")`` range, so a profile reads their
    device time apart."""
    import torch

    from edgellm_tpu_torch.models import transformer as tr

    saved = tr.decode_attention, tr.verify_attention

    def ranged(fn):
        def call(*a, **kw):
            with torch.profiler.record_function("attention"):
                return fn(*a, **kw)
        return call

    tr.decode_attention, tr.verify_attention = map(ranged, saved)
    try:
        yield
    finally:
        tr.decode_attention, tr.verify_attention = saved


def profile_kinds(run, n_calls: int) -> dict:
    """Where ``n_calls`` warm calls of ``run()`` spend the card's time: the
    unprofiled wall, then under torch.profiler the kernels' device time, the
    idle share, and device ms by kind: attention (every kernel inside the
    decode / verify attention's range), GEMMs (cuBLAS kernels outside it, the
    LM head included), codecs (K3 / K4 / K8) and the rest; and each codec
    kernel's device ms a launch (its recorded time over its recorded
    launches, so a record the profiler drops does not bias it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_calls):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with attention_range(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                    acc_events=True) as prof:
        for _ in range(n_calls):
            run()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    is_gemm = lambda n: any(t in n.lower() for t in ("gemm", "gemv", "xmma", "cutlass"))  # noqa: E731
    is_codec = lambda n: "int8_affine" in n or "remote_hop" in n  # noqa: E731
    in_attention: dict = {}
    for ev in prof.events():
        if ev.name != "attention":
            continue
        stack = [ev]
        while stack:
            e = stack.pop()
            for k in e.kernels:
                in_attention[k.name] = in_attention.get(k.name, 0.0) + k.duration / 1e3
            stack.extend(e.cpu_children)
    kinds = {"attention": 0.0, "gemms": 0.0, "codecs": 0.0, "rest": 0.0}
    rows, busy, n_kernels, codec_ms = [], 0.0, 0, {}
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0
                or ev.key == "attention"):
            continue
        ms = ev.self_device_time_total / 1e3
        rows.append({"name": ev.key[:120], "device_ms": ms, "calls": ev.count})
        busy += ms
        n_kernels += ev.count
        att = min(in_attention.get(ev.key, 0.0), ms)
        kinds["attention"] += att
        kind = ("gemms" if is_gemm(ev.key) else "codecs" if is_codec(ev.key) else "rest")
        kinds[kind] += ms - att
        if kind == "codecs":
            codec_ms[ev.key] = {"ms_per_launch": ms / ev.count, "launches": ev.count}
    rows.sort(key=lambda r: -r["device_ms"])
    return {"calls": n_calls, "wall_ms_per_call": wall_ms / n_calls,
            "device_busy_ms_per_call": busy / n_calls,
            "kernels_per_call": n_kernels / n_calls,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "device_ms_by_kind_per_call": {k: v / n_calls for k, v in kinds.items()},
            "codec_kernels": codec_ms, "top": rows[:15]}


def _split11_cli(base_argv, p: dict, label: str, rows: dict) -> tuple[dict, dict, dict]:
    """One run of ``run.main`` on a split11 params dict (written to a file,
    as a user passes it) inside :func:`split_call_log` -> (printed line,
    serve_report.json, call log); the counts are set to 0 just before."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.json")
        with open(path, "w") as f:
            json.dump(p, f)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with split_call_log() as calls:
            reset_counts()
            t0 = time.monotonic()
            rc, printed = _cli_json_line(["--params", path, "--output-dir", tmp] + base_argv)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = read_counts()
        with open(os.path.join(tmp, "serve_report.json")) as f:
            report = json.load(f)
    recs = [r for r in report["records"] if r["outcome"] == "completed"]
    decode_s = [r["service_s"] - (r["ttft_s"] - r["queue_wait_s"]) for r in recs]
    service_ms = sorted(1e3 * r["service_s"] for r in recs)
    rows[label] = {
        "rc": rc, "printed": printed, "wall_s": wall, "launches": launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "calls": {k: v for k, v in calls.items() if k != "spec_calls"},
        "service_ms_median": service_ms[len(service_ms) // 2] if service_ms else None,
        "service_ms_min_max": [service_ms[0], service_ms[-1]] if service_ms else None,
        "decode_tokens_per_s_median": float(np.median(
            [(r["granted_tokens"] - 1) / d for r, d in zip(recs, decode_s) if d > 0]))
        if recs else None}
    return printed, report, calls


def split_decode_paths(args, detail: dict) -> dict:
    """Phase 15: split decode and the per-request serve route at full
    Qwen2-0.5B width and depth, fp32 weights from ``--seed``: (a)
    configs/split11_qwen_spec.json through ``run.main``, (b) the same
    without ``speculative`` (the vanilla per-request split route), each with
    every request terminal, the identity audit green, every kernel's
    launches against the count the calls imply, and per-request service ms;
    (c) ``generate_split`` under ``fused_hops`` "remote" (K8) and "wire"
    against the separate hop, tokens and teacher-forced logits; then (e) the
    card against the CPU at 3 layers and (f) readings: K3 / K4 at the
    path's N = 1, 4, 8, one decode hop's events against its device time, and
    one decode step and one verify burst profiled -> launches by path."""
    import torch

    from edgellm_tpu_torch.codecs import codec_kernels as ck
    from edgellm_tpu_torch.codecs.packing import SATURATE_MAG, sanitize_hidden
    from edgellm_tpu_torch.models import PRESETS, init_params, params_to
    from edgellm_tpu_torch.models import flash_attention as fa
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
    from edgellm_tpu_torch.parallel import split as split_mod
    from edgellm_tpu_torch.serve.decode import generate_split
    from edgellm_tpu_torch.serve.speculative import SpecConfig

    cfg = PRESETS["qwen2-0.5b"]
    p11 = json.load(open(SPLIT11_CONFIG))
    n_cuts, k = len(p11["cuts"]), p11["speculative"]["k"]
    draft_layers = p11["cuts"][0] + 1
    base = ["--model", "qwen2-0.5b", "--seed", str(args.seed)]
    out, rows = {}, {}

    # (a), (b): the CLI, speculative and vanilla
    vanilla = {key: v for key, v in p11.items() if key != "speculative"}
    for label, p in (("split11 speculative", p11), ("split11 vanilla", vanilla)):
        printed, report, calls = _split11_cli(base, p, label, rows)
        n = p["serving"]["soak"]["n_requests"]
        row = rows[label]
        spec = calls["spec_calls"]
        bursts = sum(c["bursts"] for c in spec)
        hops = calls["prefill_decode"] + calls["decode_step"] + calls["verify_step"]
        want = want_counts(
            24 * calls["prefill_decode"] + draft_layers * len(spec) + 24 * calls["local_prefill"],
            causal_attention=(24 * calls["prefill_decode"] + draft_layers * len(spec)
                              + 24 * calls["local_prefill"]),
            int8_affine_encode=n_cuts * hops, int8_affine_decode=n_cuts * hops)
        row["launches_expected"] = want
        row["spec"] = {"calls": len(spec), "bursts": bursts,
                       "drafted": sum(c["drafted"] for c in spec),
                       "accepted": sum(c["accepted"] for c in spec),
                       "hops_per_token": [c["hops_per_token"] for c in spec]}
        log(json.dumps({"split_decode_path": {key: v for key, v in row.items()
                                              if key != "printed"}}))
        if row["rc"] != 0 or printed["requests"] != n or printed["outcomes"] != {"completed": n}:
            raise SystemExit(f"{label}: not every request completed: {printed}")
        if printed["token_identity_ok"] is not True:
            raise SystemExit(f"{label}: the identity replay mismatched request(s) "
                             f"{report['token_identity']['mismatched_ids']}: {printed}")
        if report["token_identity"]["checked"] != n:
            raise SystemExit(f"{label}: the audit checked {report['token_identity']}")
        if label == "split11 speculative":
            bad = [c for c in spec if c["drafted"] != (k - 1) * c["bursts"]
                   or not 0 < c["hops_per_token"] <= 1.0]
            # warm call + n requests + n replays, each one burst loop
            if len(spec) != 2 * n + 1 or bad or calls["verify_step"] != bursts \
                    or calls["decode_step"] != 0 or calls["prefill_decode"] != len(spec):
                raise SystemExit(f"{label}: inconsistent speculative stats {bad} or "
                                 f"calls {row['calls']} for {len(spec)} spec calls")
        elif spec or calls["verify_step"] or calls["decode_step"] != calls["prefill_decode"] * (
                p["serving"]["soak"]["max_new_tokens"] - 1):
            raise SystemExit(f"{label}: calls {row['calls']} do not match the vanilla loop")
        if row["launches"] != want:
            raise SystemExit(f"{label}: kernel launches {row['launches']} != expected {want}")
        out[label] = row["launches"]

    # (c): fused "remote" (K8) and "wire" against the separate hop
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                         device="cuda")
    rng = np.random.default_rng(args.seed + 15)
    prompts = rng.integers(0, cfg.vocab_size, (3, 1, 8))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4))).cuda()
    new = p11["serving"]["soak"]["max_new_tokens"]
    cut = SplitConfig(tuple(p11["cuts"]), tuple(p11["hop_codecs"]))
    fused_rows, tokens, forced_logits = {}, {}, {}
    for mode in ("off", "remote", "wire"):
        with fused_hops(mode):
            rt = SplitRuntime(cfg, cut)
        placed = rt.place_params(params)
        reset_counts()
        toks = [generate_split(rt, placed, pr, new, capacity=32).cpu() for pr in prompts]
        logits, cache = rt.prefill_decode(placed, torch.from_numpy(prompts[0]).cuda(), 32)
        steps = [logits[:, -1]]
        for t in range(forced.shape[1]):
            step, cache = rt.decode_step(placed, cache, forced[:, t])
            steps.append(step)
        torch.cuda.synchronize()
        launches = read_counts()
        tokens[mode] = torch.cat(toks)
        forced_logits[mode] = torch.stack(steps).cpu()
        hops = len(prompts) * new + 1 + forced.shape[1]
        want = want_counts(24 * (len(prompts) + 1), causal_attention=24 * (len(prompts) + 1),
                           **({"remote_hop": n_cuts * hops} if mode == "remote" else
                              {"int8_affine_encode": n_cuts * hops,
                               "int8_affine_decode": n_cuts * hops}))
        fused_rows[mode] = {"plans": [None if pl is None else pl.mode for pl in rt.fused_plans],
                            "launches": launches, "launches_expected": want}
        if mode != "off":
            fused_rows[mode]["tokens_equal_separate"] = torch.equal(tokens[mode], tokens["off"])
            fused_rows[mode]["forced_logits_max_abs_diff"] = (
                forced_logits[mode] - forced_logits["off"]).abs().max().item()
        log(json.dumps({"split_decode_fused": {mode: fused_rows[mode]}}))
        if fused_rows[mode]["plans"] != [None if mode == "off" else mode] * n_cuts:
            raise SystemExit(f"fused_hops {mode}: plan {fused_rows[mode]['plans']}")
        if launches != want:
            raise SystemExit(f"fused_hops {mode}: kernel launches {launches} != {want}")
        if mode != "off" and (not fused_rows[mode]["tokens_equal_separate"]
                              or fused_rows[mode]["forced_logits_max_abs_diff"]
                              > FUSED_DECODE_ATOL):
            raise SystemExit(f"fused_hops {mode} differs from the separate hop: "
                             f"{fused_rows[mode]}")
        out[f"generate_split fused {mode}"] = launches
    rows["fused"] = fused_rows

    # (f): K3 / K4 at the path's N, one decode hop, a decode step and a burst
    d = cfg.hidden_size
    rt = SplitRuntime(cfg, cut)
    placed = rt.place_params(params)
    ids = torch.from_numpy(prompts[0]).cuda()
    _, cache = rt.prefill_decode(placed, ids, 32)
    tok, burst = forced[:, 0], forced[:, :k]
    reads = {"profile prefill S=8": profile_kinds(
                 lambda: rt.prefill_decode(placed, ids, 32), 20),
             "profile decode step": profile_kinds(
                 lambda: rt.decode_step(placed, cache, tok), 20),
             "profile verify burst k=4": profile_kinds(
                 lambda: rt.verify_step(placed, cache, burst), 20)}
    hidden = torch.randn((1, 1, d), device="cuda")
    hop = lambda: split_mod._hop(rt.codecs[0], hidden, None, rt.devices[1])  # noqa: E731
    hop_profile = profile_kinds(hop, 200)
    hop_events = rt.time_decode_hops(iters=200)[0]
    reads["decode hop (1, 1, 896)"] = {
        "device_ms": hop_profile["device_busy_ms_per_call"],
        "kernels_per_hop": hop_profile["kernels_per_call"], "event_ms": hop_events,
        "events_over_device": hop_events / hop_profile["device_busy_ms_per_call"]}
    # each codec kernel bit for bit against its plain version at the path's
    # N, its device ms a launch read from the path's own profile above
    for n, source in ((1, "profile decode step"), (4, "profile verify burst k=4"),
                      (8, "profile prefill S=8")):
        x = torch.randn((n, d), device="cuda") * 3
        q, sc, mn = ck.int8_affine_encode(x, max_mag=SATURATE_MAG)
        for name, kern, plain in (
                ("int8_affine_encode", lambda x=x: ck.int8_affine_encode(x, max_mag=SATURATE_MAG),
                 lambda x=x: ck.int8_affine_encode_plain(sanitize_hidden(x).float())),
                ("int8_affine_decode", lambda q=q, sc=sc, mn=mn: ck.int8_affine_decode(q, sc, mn),
                 lambda q=q, sc=sc, mn=mn: ck.int8_affine_decode_plain(q, sc, mn))):
            got, want_ = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want_ = want_ if isinstance(want_, tuple) else (want_,)
            if not all(_same(g, w) for g, w in zip(got, want_)):
                raise SystemExit(f"{name} at N={n} differs from its plain version")
            rows_ = [r for key, r in reads[source]["codec_kernels"].items()
                     if key.split("(")[0].split("::")[-1].startswith(name)]
            if len(rows_) != 1:
                raise SystemExit(f"{source}: no single {name} kernel in "
                                 f"{reads[source]['codec_kernels']}")
            k_dev = rows_[0]["ms_per_launch"]
            bound, bound_by = fa.bound_ms(float(codec_bytes(name, n, d)), 0.0, torch.float32)
            reads[f"{name} N={n}"] = {"kernel_ms": k_dev, "event_ms": time_ms(kern, 200),
                                      "plain_ms": time_ms(plain, 50), "bound_ms": bound,
                                      "bound_by": bound_by, "roofline_share": bound / k_dev,
                                      "read_from": source}
    for key, r in reads.items():
        log(json.dumps({"split_decode_read": {key: {kk: v for kk, v in r.items()
                                                    if kk != "top"}}}))
        for t in r.get("top", [])[:8]:
            log(f"  {t['device_ms']:10.4f} ms  {t['calls']:6d}  {t['name'][:90]}")
    rows["reads"] = reads
    del params, placed, cache
    torch.cuda.empty_cache()

    # (e): the card against the CPU at Qwen2-0.5B width, 3 layers, cut 1
    small = dataclasses.replace(cfg, num_layers=3)
    cpu = init_params(small, torch.Generator().manual_seed(args.seed), device="cpu")
    card = params_to(cpu, device="cuda")
    ids = rng.integers(0, small.vocab_size, (2, 14))
    cross = {}
    for codec, tol in SPLIT_DECODE_TOL.items():
        got = {}
        for dev, params_ in (("cuda", card), ("cpu", cpu)):
            rt = SplitRuntime(small, SplitConfig((1,), (codec,)), [dev, dev])
            placed = rt.place_params(params_)
            tids = torch.from_numpy(ids).to(dev)
            pre, cache = rt.prefill_decode(placed, tids[:, :8], 24)
            steps = []
            for t in range(8, 11):
                step, cache = rt.decode_step(placed, cache, tids[:, t])
                steps.append(step)
            burst, _ = rt.verify_step(placed, cache, tids[:, 11:14])
            toks = generate_split(rt, placed, ids[:1, :8], 12, capacity=24)
            spec_toks = generate_split(rt, placed, ids[:1, :8], 12, capacity=24,
                                       speculative=SpecConfig(k=4), raw_params=params_)
            got[dev] = (torch.cat([pre[:, -1:], torch.stack(steps, 1), burst], 1).cpu(),
                        toks.cpu(), spec_toks.cpu())
        diff = (got["cuda"][0] - got["cpu"][0]).abs().max().item()
        cross[codec] = {"max_abs_diff": diff, "tolerance": tol,
                        "greedy_tokens_equal": torch.equal(got["cuda"][1], got["cpu"][1]),
                        "spec_tokens_equal": torch.equal(got["cuda"][2], got["cpu"][2]),
                        "spec_equals_vanilla": torch.equal(got["cuda"][2], got["cuda"][1])}
        log(json.dumps({"split_decode_cross_check": {codec: cross[codec]}}))
        if diff > tol or not all(v for kk, v in cross[codec].items() if kk.endswith("equal")
                                 or kk == "spec_equals_vanilla"):
            raise SystemExit(f"split decode card vs CPU ({codec}) failed: {cross[codec]}")
    rows["cross_check"] = cross
    detail["split_decode"] = rows
    del card
    torch.cuda.empty_cache()
    return out


#: the cut phase 16 adds to the committed batched serve configs (none ships
#: cuts beside batching): split1's boundary
SPLIT_PAGED_CUT = {"cuts": [11], "hop_codecs": ["int8_per_token"]}
#: teacher-forced split paged logits, card against CPU, (atol = rtol): an
#: fp32 hop over fp pages differs only by summation order and K13's online
#: softmax (1e-4); an int8 hop or quantized pages put a code a step from the
#: CPU's wherever the value sits on a rounding boundary, and the 4 streams'
#: 230 hop tokens (206 of them prefill) hold several such codes. On the H100
#: an int8 hop over fp pages read 2.3e-3, over int4 pages 1.4e-3, and over
#: int8 pages 9.6e-3 (a hop code moves a K row, which moves its page codes),
#: so these cases are held within 2e-2, the share within 1e-3 recorded
SPLIT_PAGED_CROSS_TOL = {"fp": 1e-4, "quant": 2e-2}
#: item 30 (the KV-at-rest PPL harness) at full Qwen2-0.5B: kept short, it
#: runs one ragged step a position
KV_TIER_FULL = dict(max_length=128, stride=64, window_batch=4, max_chunks=8, page_size=16)
KV_TIER_SMALL = dict(max_length=64, stride=32, window_batch=2, max_chunks=3, page_size=16)
KV_TIER_RTOL = 1e-3
KV_TIERS = ("fp", "int8_per_channel", "int4_per_channel")


def _split_serve_cli(base_argv, p: dict, label: str) -> tuple[dict, dict, dict, float]:
    """One ``run.main`` of a serve params dict (inline JSON, as README shows)
    with the fused-hop gate restored after -> (printed line, the batcher's
    report, launches, wall s); the counts are set to 0 just before."""
    import tempfile

    import torch

    saved = os.environ.pop("EDGELLM_FUSED_HOP", None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.monotonic()
            rc, printed = _cli_json_line(["--params", json.dumps(p), "--output-dir", tmp]
                                         + base_argv)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = read_counts()
            with open(os.path.join(tmp, "serve_report.json")) as f:
                report = json.load(f)
    finally:
        os.environ.pop("EDGELLM_FUSED_HOP", None)
        if saved is not None:
            os.environ["EDGELLM_FUSED_HOP"] = saved
    if rc != 0:
        raise SystemExit(f"{label}: run.main exited {rc}")
    return printed, report["batcher"], launches, wall


def _split_serve_expected(cfg, rep: dict, n_cuts: int, kv_codec: str, remote: bool) -> tuple:
    """The launches a split-paged serve run implies, and the warm batcher's
    share (one prefill and one step) apart: 24 K13 / K14 a ragged step and
    24 fp32 K-attn a split prefill (a prefix hit's suffix runs verify_step's
    plain attention, a resume adopts rows); each cut one hop (K3 + K4, or K8
    under "remote") a step, a prefill and a prefix hit's suffix."""
    hits = rep.get("prefix", {}).get("hits", 0)
    prefills = rep["admitted"] - rep["evicted"] - hits
    attn = "paged_decode_attention" if kv_codec == "fp" else "paged_decode_attention_quant"

    def counts(steps, prefills, hits):
        hops = n_cuts * (steps + prefills + hits)
        codec = ({"remote_hop": hops} if remote else
                 {"int8_affine_encode": hops, "int8_affine_decode": hops})
        return want_counts(cfg.num_layers * prefills, causal_attention=cfg.num_layers * prefills,
                           **{attn: cfg.num_layers * steps}, **codec)

    warm = counts(1, 1, 0)
    want = counts(rep["steps"] + 1, prefills + 1, hits)
    return want, {k: v for k, v in warm.items() if v}, prefills, hits


def _step_kinds(b, n_steps: int) -> dict:
    """A steady group of ``n_steps`` ragged steps of batcher ``b`` under
    :func:`device_time`: wall and device busy a step, the idle share, and
    device ms a step by kind (GEMMs, K13 / K14, the codecs, the rest)."""
    is_gemm = lambda n: any(t in n.lower() for t in ("gemm", "gemv", "xmma", "cutlass"))  # noqa: E731
    out, rows = device_time(lambda: [b.step() for _ in range(n_steps)], n_steps)
    kinds = dict.fromkeys(("gemms", "paged_attention", "codecs", "rest"), 0.0)
    for r in rows:
        n = r["name"]
        kind = ("paged_attention" if "paged_" in n else "gemms" if is_gemm(n)
                else "codecs" if "int8_affine" in n or "remote_hop" in n else "rest")
        kinds[kind] += r["device_ms"] / n_steps
    out["steps"] = out.pop("chunks")
    out["wall_ms_per_step"] = out["wall_ms"] / n_steps
    out["device_busy_ms_per_step"] = out["device_busy_ms"] / n_steps
    out["device_ms_by_kind_per_step"] = kinds
    out["kernels_per_step"] = sum(r["calls"] for r in rows) / n_steps
    return out


def _large_batcher(cfg, params, split: bool):
    """The large split9 geometry with 32 running slots of 512-token prompts
    at T = 0.7, admitted and three steps in: over a cut-11 int8 split
    runtime (the separate hop) or the local pool."""
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
    from edgellm_tpu_torch.run import batching_config
    from edgellm_tpu_torch.serve import ContinuousBatcher

    kw = {}
    if split:
        with fused_hops("off"):
            rt = SplitRuntime(cfg, SplitConfig(tuple(SPLIT_PAGED_CUT["cuts"]),
                                               tuple(SPLIT_PAGED_CUT["hop_codecs"])))
        kw = dict(split_runtime=rt, placed_params=rt.place_params(params))
    b = ContinuousBatcher(cfg, params, batching_config(cfg, LARGE_SERVE), **kw)
    rng = np.random.default_rng(11)
    for i in range(32):
        b.submit(rng.integers(1, cfg.vocab_size, 512), 64, temperature=0.7, rng_seed=i)
    for _ in range(3):
        b.step()
    return b


def _device_ms_per_call(fn, iters: int) -> tuple[float, dict]:
    """Device ms of one ``fn()`` from ``iters`` warm calls under
    torch.profiler (events accumulated): each kernel's recorded time over
    its recorded launches, summed over the kernels one call launches (each
    once), so a record the profiler drops does not bias it -> (ms, the
    launches recorded by kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(ev.key, ev.count, ev.self_device_time_total) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.count]
    if not rows:
        raise SystemExit("device time: the profiler recorded no kernel")
    return sum(t / c for _, c, t in rows) / 1e3, {k[:60]: c for k, c, _ in rows}


def _split_paged_forced(cfg, params, dev, codec: str, kv_codec: str, prompts, forced):
    """Teacher-forced logits of the split ragged step at cut 1 (page size 8,
    the committed serve configs'): each prompt prefilled with
    ``prefill_decode`` and adopted into its own slot, then every step fed
    ``forced[:, t]`` -> (T, B, V) fp32 on the CPU."""
    import torch

    from edgellm_tpu_torch.models.paged_kv import PagedKVCache
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime

    with fused_hops("off"):
        rt = SplitRuntime(cfg, SplitConfig((1,), (codec,)), [dev, dev])
    placed = rt.place_params(params)
    b, steps = forced.shape
    host = PagedKVCache(cfg, num_pages=1 + b * 16, page_size=8, max_slots=b, pages_per_slot=16,
                        device=dev, materialize=False, kv_codec=kv_codec)
    pool = rt.init_paged_pool(1 + b * 16, 8, kv_codec=kv_codec)
    for p in prompts:
        slot = host.alloc_slot()
        _, cache = rt.prefill_decode(placed, torch.from_numpy(p[None].astype(np.int64)).to(dev),
                                     128)
        host.ensure(slot, len(p))
        pool = rt.adopt_paged(pool, cache, 0, host._flat_indices(slot, len(p)), len(p))
        host.lengths[slot] = len(p)
    out = []
    for t in range(steps):
        for slot in range(b):
            host.ensure_writable(slot, int(host.lengths[slot]) + 1)
        table, lengths = host.device_tables()
        logits, pool = rt.decode_step_paged(
            placed, pool, table, lengths, torch.from_numpy(forced[:, t].astype(np.int64)).to(dev))
        out.append(logits.cpu())
        host.lengths += 1
    return torch.stack(out)


def split_paged_paths(args, detail: dict) -> dict:
    """Phase 16: the split-paged batcher and the KV-at-rest PPL harness at
    full Qwen2-0.5B width and depth, fp32 weights from ``--seed``: (a)
    ``run.main`` on split9, split9 under fused "remote", split13 and split14,
    each with cut 11 (int8_per_token) added inline, and the large split9
    geometry with it; (b) ten steady ragged steps of the large geometry
    profiled, split and local; (c) a three-stage run (cuts 7 and 15, fp32
    hops) against ``generate``; (d) the card against the CPU at 3 layers;
    (e) ``run_kv_tier_sweep`` over the three tiers, then at 3 layers card
    against CPU; (f) K13 / K14 at item 30's geometry and K3 / K4 / K8 at N
    = 32 -> launches by path."""
    import torch

    from edgellm_tpu_torch.codecs import codec_kernels as ck
    from edgellm_tpu_torch.codecs import fused_hop as fh
    from edgellm_tpu_torch.codecs.packing import SATURATE_MAG
    from edgellm_tpu_torch.eval import run_kv_tier_sweep
    from edgellm_tpu_torch.eval.harness import _iter_window_groups
    from edgellm_tpu_torch.models import PRESETS, init_params, params_to
    from edgellm_tpu_torch.models import flash_attention as fa
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
    from edgellm_tpu_torch.serve import BatchingConfig, ContinuousBatcher, generate
    from edgellm_tpu_torch.serve.decode import generate_split

    cfg = PRESETS["qwen2-0.5b"]
    base = ["--model", "qwen2-0.5b", "--seed", str(args.seed)]
    out, rows = {}, {}

    # (a): run.main on the committed batched configs with a cut
    cases = []
    for name, suffix in (("split9", "paged"), ("split13", "prefix"), ("split14", "kvq")):
        p = {**json.load(open(f"configs/{name}_qwen_{suffix}.json")), **SPLIT_PAGED_CUT}
        cases.append((f"{name} cut", p))
        if name == "split9":
            cases.append(("split9 cut remote", {**p, "fused_hops": "remote"}))
    cases.append(("split9 large cut", {**LARGE_SERVE, **SPLIT_PAGED_CUT}))
    for label, p in cases:
        printed, rep, launches, wall = _split_serve_cli(base, p, label)
        kv_codec = p.get("kv_at_rest", {}).get("codec", "fp")
        remote = p.get("fused_hops") == "remote"
        want, warm, prefills, hits = _split_serve_expected(cfg, rep, len(p["cuts"]), kv_codec,
                                                           remote)
        n = p["serving"]["soak"]["n_requests"]
        row = {"path": label, "kv_codec": kv_codec, "fused_hops": p.get("fused_hops"),
               "printed": printed, "mode": rep["mode"], "batched_steps": rep["steps"],
               "admitted": rep["admitted"], "evicted": rep["evicted"], "prefills": prefills,
               "prefix_hits": hits, "decode_tokens_per_s": rep["decode_tokens_per_s"],
               "ms_per_step": 1e3 * rep["decode_s"] / max(rep["steps"], 1),
               "prefill_s": rep["prefill_s"], "decode_s": rep["decode_s"], "wall_s": wall,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches, "launches_expected": want,
               "warm_batcher_launches": warm}
        log(json.dumps({"split_paged_path": {k: v for k, v in row.items() if k != "printed"}}))
        rows[label] = row
        if printed["requests"] != n or printed["outcomes"] != {"completed": n}:
            raise SystemExit(f"{label}: not every request completed: {printed}")
        if printed["mode"] != "batched_split" or rep["mode"] != "paged_split" \
                or rep["cuts"] != p["cuts"]:
            raise SystemExit(f"{label}: not the split-paged batcher: {printed}, {rep['mode']}")
        if label.startswith("split13") and hits < 1:
            raise SystemExit(f"{label}: the prefix index never hit: {rep.get('prefix')}")
        if launches != want:
            raise SystemExit(f"{label}: kernel launches {launches} != expected {want}")
        out[label] = launches

    # (b): ten steady steps of the large geometry, split and local
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                         device="cuda")
    profiles = {}
    for label, split in (("split cut 11", True), ("local", False)):
        b = _large_batcher(cfg, params, split)
        profiles[label] = _step_kinds(b, 10)
        log_profile(f"profile_split_paged_steps {label}", profiles[label], 12)
        del b
        torch.cuda.empty_cache()
    rows["profile large geometry"] = profiles

    # (c): three stages (cuts 7 and 15, lossless fp32 hops) against generate
    with fused_hops("off"):
        rt3 = SplitRuntime(cfg, SplitConfig((7, 15), ("fp32", "fp32")))
    rng = np.random.default_rng(args.seed + 17)
    reqs = [rng.integers(1, cfg.vocab_size, n) for n in (5, 17, 40, 64)]
    b = ContinuousBatcher(cfg, params, BatchingConfig(page_size=16, num_pages=40, max_slots=4,
                                                      pages_per_slot=8),
                          split_runtime=rt3, placed_params=rt3.place_params(params))
    sids = [b.submit(r, 8) for r in reqs]
    res = b.run()
    same = sum(np.array_equal(res[sid], generate(cfg, params, r[None], 8)[0].cpu().numpy())
               for sid, r in zip(sids, reqs))
    rows["three stages"] = {"cuts": [7, 15], "streams": len(reqs), "equal_generate": same,
                            "steps": b.report()["steps"]}
    log(json.dumps({"split_paged_three_stages": rows["three stages"]}))
    if same != len(reqs):
        raise SystemExit(f"three-stage split-paged streams differ from generate: "
                         f"{rows['three stages']}")
    del b, rt3

    # (f): K13 / K14 at item 30's geometry, K3 / K4 / K8 at N = 32
    d = cfg.hidden_size
    reads = {}
    pps = -(-KV_TIER_FULL["max_length"] // KV_TIER_FULL["page_size"])
    w = KV_TIER_FULL["window_batch"]
    for name, kv_codec in (("paged_decode_attention", "fp"),
                           ("paged_decode_attention_quant", "int8_per_channel"),
                           ("paged_decode_attention_quant", "int4_per_channel")):
        a, kw = _paged_case(w, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                            KV_TIER_FULL["page_size"], pps, 1 + w * pps, torch.float32,
                            kv_codec, seed=30)
        kern = getattr(fa, name)
        nbytes = fa.paged_decode_bytes(a[0], a[1], a[-1], kv_codec)
        flops = 4.0 * cfg.num_heads * cfg.head_dim * float(a[-1].long().sum().item())
        bound, bound_by = fa.bound_ms(nbytes, flops, torch.float32)
        k_dev, recorded = _device_ms_per_call(lambda: kern(*a, **kw), 50)
        reads[f"{name} {kv_codec} item 30"] = {
            "slots": w, "page_size": KV_TIER_FULL["page_size"], "pages_per_slot": pps,
            "kernel_device_ms": k_dev, "recorded": recorded, "bound_ms": bound,
            "bound_by": bound_by, "roofline_share": bound / k_dev}
    x = torch.randn((32, d), device="cuda") * 3
    q, sc, mn = ck.int8_affine_encode(x, max_mag=SATURATE_MAG)
    for name, call in (
            ("int8_affine_encode", lambda: ck.int8_affine_encode(x, max_mag=SATURATE_MAG)),
            ("int8_affine_decode", lambda: ck.int8_affine_decode(q, sc, mn)),
            ("remote_hop", lambda: fh.remote_hop(x, max_mag=SATURATE_MAG))):
        k_dev, recorded = _device_ms_per_call(call, 100)
        bound, bound_by = fa.bound_ms(float(codec_bytes(name, 32, d)), 0.0, torch.float32)
        reads[f"{name} N=32"] = {"kernel_device_ms": k_dev, "recorded": recorded,
                                 "event_ms": time_ms(call, 100), "bound_ms": bound,
                                 "bound_by": bound_by, "roofline_share": bound / k_dev}
    for key, r in reads.items():
        log(json.dumps({"split_paged_read": {key: r}}))
    rows["reads"] = reads

    # (e): item 30 at full Qwen2-0.5B width and depth
    corpus = np.random.default_rng(args.seed + 30).integers(0, cfg.vocab_size, 1024)
    groups = list(_iter_window_groups(corpus, KV_TIER_FULL["max_length"],
                                      KV_TIER_FULL["stride"],
                                      window_batch=KV_TIER_FULL["window_batch"],
                                      max_count=KV_TIER_FULL["max_chunks"]))
    positions = sum(g[0].input_ids.shape[1] - 1 for g in groups)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    sweep = run_kv_tier_sweep(cfg, params, corpus, tiers=KV_TIERS, device="cuda",
                              **KV_TIER_FULL)
    wall = time.monotonic() - t0
    launches = read_counts()
    want = want_counts(paged_decode_attention=cfg.num_layers * positions,
                       paged_decode_attention_quant=2 * cfg.num_layers * positions)
    kv_rows = [{**r, "ms_per_position": 1e3 * r["wall_s"] / positions} for r in sweep]
    rows["kv tier sweep"] = {"groups": len(groups), "positions_per_tier": positions,
                             "wall_s": wall, "rows": kv_rows, "launches": launches,
                             "launches_expected": want,
                             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    log(json.dumps({"kv_tier_sweep": rows["kv tier sweep"]}))
    bad = [r for r in sweep if not (np.isfinite(r["ppl"]) and np.isfinite(r["ppl_delta_vs_fp"])
                                    and r["kv_page_bytes"] > 0)]
    if bad or launches != want:
        raise SystemExit(f"kv tier sweep: rows {bad} or launches {launches} != {want}")
    out["kv tier sweep"] = launches
    del params
    torch.cuda.empty_cache()

    # (d) and (e) at 3 layers: the card against the CPU
    small = dataclasses.replace(cfg, num_layers=3)
    cpu = init_params(small, torch.Generator().manual_seed(args.seed), device="cpu")
    card = params_to(cpu, device="cuda")
    rng = np.random.default_rng(args.seed + 31)
    prompts = [rng.integers(1, small.vocab_size, n) for n in (5, 37, 64, 100)]
    forced = rng.integers(1, small.vocab_size, (len(prompts), 6))
    cross = {}
    for codec, kv_codec in (("fp32", "fp"), ("int8_per_token", "fp"),
                            ("fp32", "int8_per_channel"),
                            ("int8_per_token", "int8_per_channel"),
                            ("int8_per_token", "int4_per_channel")):
        tol = SPLIT_PAGED_CROSS_TOL["fp" if (codec, kv_codec) == ("fp32", "fp") else "quant"]
        got = _split_paged_forced(small, card, "cuda", codec, kv_codec, prompts, forced)
        want_ = _split_paged_forced(small, cpu, "cpu", codec, kv_codec, prompts, forced)
        err = (got - want_).abs()
        diff = err.max().item()
        cross[f"{codec} {kv_codec}"] = {
            "max_abs_diff": diff, "tolerance": tol,
            "share_within_1e-3": (err <= 1e-3 + 1e-3 * want_.abs()).float().mean().item()}
        log(json.dumps({"split_paged_cross_check": {f"{codec} {kv_codec}":
                                                    cross[f"{codec} {kv_codec}"]}}))
        if not bool(((got - want_).abs() <= tol + tol * want_.abs()).all()):
            raise SystemExit(f"split paged step card vs CPU ({codec}, {kv_codec}) failed: "
                             f"{diff}")
    bcfg = BatchingConfig(page_size=8, num_pages=80, max_slots=4, pages_per_slot=16)
    reqs = [rng.integers(1, small.vocab_size, int(n)) for n in rng.integers(3, 100, 6)]
    streams = {}
    for dev, p in (("cuda", card), ("cpu", cpu)):
        with fused_hops("off"):
            rt = SplitRuntime(small, SplitConfig((1,), ("int8_per_token",)), [dev, dev])
        placed = rt.place_params(p)
        b = ContinuousBatcher(small, p, bcfg, split_runtime=rt, placed_params=placed)
        sids = [b.submit(r, 8) for r in reqs]
        res = b.run()
        streams[dev] = [res[sid] for sid in sids]
        if dev == "cuda":
            solo = [generate_split(rt, placed, r[None], 8, capacity=128)[0].cpu().numpy()
                    for r in reqs]
    same_cpu = sum(np.array_equal(a, c) for a, c in zip(streams["cuda"], streams["cpu"]))
    same_solo = sum(np.array_equal(a, c) for a, c in zip(streams["cuda"], solo))
    cross["greedy streams"] = {"streams": len(reqs), "card_equals_cpu": same_cpu,
                               "batched_equals_generate_split_on_card": same_solo}
    log(json.dumps({"split_paged_cross_check": {"greedy streams": cross["greedy streams"]}}))
    if same_cpu != len(reqs) or same_solo != len(reqs):
        raise SystemExit(f"greedy split batched streams differ: {cross['greedy streams']}")
    corpus = np.random.default_rng(args.seed + 32).integers(0, small.vocab_size, 256)
    ppl = {dev: run_kv_tier_sweep(small, p, corpus, tiers=KV_TIERS, device=dev, **KV_TIER_SMALL)
           for dev, p in (("cuda", card), ("cpu", cpu))}
    for g, w_ in zip(ppl["cuda"], ppl["cpu"]):
        rel = abs(g["ppl"] - w_["ppl"]) / w_["ppl"]
        cross[f"kv tier {g['kv_codec']} ppl"] = {"card": g["ppl"], "cpu": w_["ppl"],
                                                 "rel_diff": rel, "rtol": KV_TIER_RTOL}
        log(json.dumps({"kv_tier_cross_check": cross[f"kv tier {g['kv_codec']} ppl"]}))
        if rel > KV_TIER_RTOL or g["n_tokens"] != w_["n_tokens"]:
            raise SystemExit(f"kv tier {g['kv_codec']} card vs CPU: {g} vs {w_}")
    rows["cross_check"] = cross
    detail["split_paged"] = rows
    del card
    torch.cuda.empty_cache()
    return out


#: phase 17's faulty-link runs: chunks and window batch (6 groups, so
#: split6's streak controller steps down twice and every tier runs), and
#: the depth at which the card is held against the CPU (cut 11 needs 13)
LINK_CHUNKS, LINK_WB, LINK_CROSS_LAYERS = 24, 4, 13
#: the fault sweep on split1's cut: drop rates and chunks, one window a
#: forward and no retry, so each chunk's hop is one draw of the drop rate
SWEEP_RATES, SWEEP_CHUNKS = (0.0, 0.05, 0.2), 24
LINK_CONFIGS = ("configs/split7_qwen_lossy.json", "configs/split6_qwen_chaos.json")
#: split10 under each ``fused_hops``: chunks a run (5 window groups of 8)
#: and rounds, the modes' order reversed every other round
SPLIT10_CHUNKS, SPLIT10_ROUNDS = 33, 3
#: the CLI's synthetic corpus (``--synthetic-corpus-len``'s default), which
#: the phase's direct runs draw again from ``--seed``
CLI_CORPUS_LEN = 4096


@contextlib.contextmanager
def probe_cache_file(path: str):
    """``EDGELLM_PROBE_CACHE`` pointed at ``path`` (a file this script wrote
    or none yet) for the runtimes built inside."""
    saved = os.environ.get("EDGELLM_PROBE_CACHE")
    os.environ["EDGELLM_PROBE_CACHE"] = path
    try:
        yield
    finally:
        os.environ.pop("EDGELLM_PROBE_CACHE", None)
        if saved is not None:
            os.environ["EDGELLM_PROBE_CACHE"] = saved


def _copies_sent(counters: dict, routes: int) -> int:
    """Copies a faulty link sent (and decoded): every route of every attempt
    made, an attempt after the first being a retry."""
    return routes * (sum(counters["hops"]) + sum(counters["retried"]))


def _link_expected(by_tier: list, n_groups: int, n_layers: int, routes: int) -> dict:
    """The launches of a faulty-link split run through the CLI (fp32): each
    tier's encode kernel once a hop it carried, its decode kernel once a copy
    sent (the int8 tier K3 / K4, the int4 tier K1 / K2, ternary_per_token
    none: it has no twin), time_hops' and time_decode_hops' hops on tier 0,
    and every K-attn fp32."""
    kernels = [("int8_affine_encode", "int8_affine_decode"), ("int4_encode", "int4_decode"),
               (None, None)]
    want = dict(causal_attention=n_layers * n_groups)
    for tier, (enc, dec) in zip(by_tier, kernels):
        if tier is None or enc is None:
            continue
        want[enc] = want.get(enc, 0) + sum(tier["counters"]["hops"])
        want[dec] = want.get(dec, 0) + _copies_sent(tier["counters"], routes)
    want["int8_affine_encode"] = want.get("int8_affine_encode", 0) + HOP_ITERS
    want["int8_affine_decode"] = want.get("int8_affine_decode", 0) + HOP_ITERS
    return want_counts(want["causal_attention"], **want)


def _int8_hop_counts(mode, n_groups: int) -> dict:
    """The int8_per_token hop's launches over ``n_groups`` groups through
    the CLI: K8 once a group under a "remote" plan, else the twin's K3 and
    K4 (the separate and the "wire" hop alike), and time_hops' separate
    hops (K3 + K4) whatever the plan."""
    hop = {"int8_affine_encode": HOP_ITERS, "int8_affine_decode": HOP_ITERS}
    if mode == "remote":
        hop["remote_hop"] = n_groups
    else:
        hop = {k: v + n_groups for k, v in hop.items()}
    return hop


def _plan_mode(params_json: dict):
    """The mode the gate plans for a config's first hop on the card (None:
    the separate hop), with ``fused_hops`` applied as the CLI applies it."""
    from edgellm_tpu_torch import run
    from edgellm_tpu_torch.codecs.fused_hop import fused_hop_plan
    from edgellm_tpu_torch.parallel.split import apply_default_codec_backend

    run.apply_fused_hops(params_json)
    try:
        codec = apply_default_codec_backend(params_json["hop_codecs"][:1], "cuda")[0]
        return fused_hop_plan(codec, device="cuda")
    finally:
        os.environ.pop("EDGELLM_FUSED_HOP", None)


def boundary_link_paths(args, detail: dict, cache_path: str) -> dict:
    """Phase 17: the boundary link on the card, fp32 random weights from
    ``--seed`` at full Qwen2-0.5B width and depth. (1) The codec and
    fused-hop probes (``tools/pallas_probe.py``) into the phase's own probe
    cache ``cache_path``: every row's ratio, parity and decision; a parity
    miss or an entry of another fingerprint fails, a twin slower than its
    plain codec is reported (it runs all the same). (2)
    configs/split10_qwen_fused.json through ``run.main`` under "auto",
    whose hop must run the cache's verdict for ``fused_hop:int8_per_token``
    (K8 on a win, K3 / K4 otherwise), beside forced "off", "wire" and
    "remote", :data:`SPLIT10_ROUNDS` rounds of each, against the s/chunk
    the probe's per-hop difference predicts. (3) configs/split7_qwen_lossy.json
    and split6_qwen_chaos.json through ``run.main`` with
    ``--fault-report`` (:data:`LINK_CHUNKS` chunks, window batch
    :data:`LINK_WB`), a clean split1 run and a faults config of zero rates
    beside them: counters and tier trail equal a CPU run of the same code
    (at :data:`LINK_CROSS_LAYERS` layers, on the card and the CPU: the
    counters do not depend on depth, the PPL within rtol 1e-4), split6's
    trail steps, K3 / K4 (and K1 / K2) launched once a hop encoded / a copy
    sent at their tier, the zero-rate run's PPL the clean one's bit for
    bit; s/chunk, wire bytes per token with the FEC overhead and one
    profiled group's idle share. (4) ``run_fault_sweep`` over drop rates
    :data:`SWEEP_RATES` on split1's cut, its rate-0 point the clean split's
    -> launches by path."""
    import argparse as ap
    import dataclasses as dc

    import torch

    from edgellm_tpu_torch import run
    from edgellm_tpu_torch.codecs import probe_cache
    from edgellm_tpu_torch.codecs.fec import FECConfig
    from edgellm_tpu_torch.eval import run_fault_sweep, run_split_eval
    from edgellm_tpu_torch.models import PRESETS, params_to
    from edgellm_tpu_torch.tools import pallas_probe

    out, rows = {}, {}
    cfg = PRESETS["qwen2-0.5b"]
    base = ["--model", "qwen2-0.5b", "--seed", str(args.seed)]
    fp = probe_cache.fingerprint("cuda")

    # (1) the probes, into this phase's cache
    if os.path.exists(cache_path):
        os.remove(cache_path)
    with probe_cache_file(cache_path):
        t0 = time.monotonic()
        codecs = pallas_probe.probe_all(device="cuda", reps=15, iters=40)
        hops = pallas_probe.probe_fused_hops(device="cuda", reps=15, iters=40)
        probe_s = time.monotonic() - t0
        for row in codecs["codecs"] + hops["hops"]:
            log(json.dumps({"probe_row": row}))
        with open(cache_path) as f:
            cache = json.load(f)
        auto_win = probe_cache.measured_win("fused_hop:int8_per_token", fp)
    losses = [r["codec"] for r in codecs["codecs"] if r.get("measured_win") is False]
    parity = [h["codec"] for h in hops["hops"] if not h["fused_equals_fallback"]]
    rows["probe"] = {"seconds": probe_s, "fingerprint": fp, "cache": cache,
                     "codecs": codecs["codecs"], "hops": hops["hops"], "twin_losses": losses}
    log(json.dumps({"probe_cache": cache}))
    if losses:  # a finding: the twins run on the card whatever they read
        log(f"  kernel twin(s) {losses} read under WIN_MARGIN against their plain codecs; "
            f"they run all the same")
    if list(cache) != [fp] or any(not k.startswith("fused_hop:") for k in cache[fp]["speedups"]):
        raise SystemExit(f"probe cache holds other entries than {fp}'s fused hops: {cache}")
    if parity:
        raise SystemExit(f"fused hop(s) {parity} differ from the separate hop")

    # (2) split10 under "auto" follows the cache, beside the forced modes, in
    # rounds: the s/chunk each plan gives against the probe's prediction
    with open("configs/split10_qwen_fused.json") as f:
        split10 = json.load(f)
    n_groups = math.ceil(SPLIT10_CHUNKS / 8)
    split10_argv = ["--max-chunks", str(SPLIT10_CHUNKS)] + base
    auto_mode = "remote" if auto_win else None
    hop8 = next(h for h in hops["hops"] if h["codec"] == "int8_per_token")
    # a plan changes one hop a group: the probe's per-hop wall difference
    # spread over the run's chunks
    predicted = (hop8["fallback_us"] - hop8["fused_us"]) * 1e-6 * n_groups / SPLIT10_CHUNKS
    modes = ("auto", "off", "wire", "remote")
    walls = {m: [] for m in modes}
    with probe_cache_file(cache_path):
        with tempfile.TemporaryDirectory() as tmp:  # warm the process at this shape, uncounted
            _cli_run(["--params", json.dumps({**split10, "fused_hops": "off"}),
                      "--output-dir", tmp] + split10_argv)
            os.environ.pop("EDGELLM_FUSED_HOP", None)
        for rnd in range(SPLIT10_ROUNDS):
            for mode in (modes if rnd % 2 == 0 else modes[::-1]):
                p = {**split10, "fused_hops": mode}
                label = f"link split10 fused_hops {mode}"
                plan = _plan_mode(p)
                with tempfile.TemporaryDirectory() as tmp:
                    reset_counts()
                    rc, lines = _cli_run(["--params", json.dumps(p), "--output-dir", tmp]
                                         + split10_argv)
                    launches = read_counts()
                    os.environ.pop("EDGELLM_FUSED_HOP", None)
                res = json.loads(lines[-1])
                ran = None if plan is None else plan.mode
                want = want_counts(cfg.num_layers * n_groups,
                                   causal_attention=cfg.num_layers * n_groups,
                                   **_int8_hop_counts(ran, n_groups))
                walls[mode].append(res["wall_s"] / res["chunks"])
                log(f"  split10 fused_hops {mode} round {rnd}: plan {ran or 'separate'}, "
                    f"{walls[mode][-1]:.5f} s/chunk")
                if mode == "auto" and ran != auto_mode:
                    raise SystemExit(f"auto ran {ran}, the cache's verdict is {auto_mode} "
                                     f"(fused_hop:int8_per_token win {auto_win})")
                if rc != 0 or res["chunks"] != SPLIT10_CHUNKS or not np.isfinite(res["ppl"]) \
                        or launches != want:
                    raise SystemExit(f"{label}: rc {rc}, {res['chunks']} chunks, launches "
                                     f"{launches} != expected {want}")
                if rnd == 0:
                    rows[label] = {"rc": rc, "plan": None if plan is None else dc.asdict(plan),
                                   "ppl": res["ppl"], "launches": launches,
                                   "launches_expected": want}
                    out[label] = launches
                rows[label]["s_per_chunk"] = walls[mode]
    med = {m: statistics.median(v) for m, v in walls.items()}
    rows["split10 plans"] = {
        "median_s_per_chunk": med, "measured_off_minus_remote": med["off"] - med["remote"],
        "predicted_off_minus_remote": predicted,
        "spread_s_per_chunk": {m: max(v) - min(v) for m, v in walls.items()}}
    log(json.dumps({"split10_plans": rows["split10 plans"]}))
    log(f"  'auto' on this card: fused_hop:int8_per_token ratio "
        f"{cache[fp]['speedups'].get('fused_hop:int8_per_token')}, win {auto_win}, "
        f"plan {auto_mode or 'separate'}")

    # (3) the faulty link through the CLI, at full depth
    corpus = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, CLI_CORPUS_LEN)
    link_argv = ["--max-chunks", str(LINK_CHUNKS), "--window-batch", str(LINK_WB)] + base
    groups = math.ceil(LINK_CHUNKS / LINK_WB)
    results = {}
    with probe_cache_file(cache_path):
        with open("configs/split1_qwen_int8.json") as f:
            split1 = json.load(f)
        runs = [("split1 clean", split1, False),
                ("split1 zero-rate faults", {**split1, "faults": {"drop_rate": 0.0,
                                                                  "bitflip_rate": 0.0}}, False)]
        for path in LINK_CONFIGS:
            with open(path) as f:
                runs.append((os.path.basename(path)[:-5], json.load(f), True))
        for name, p, report in runs:
            label = f"link {name}"
            with tempfile.TemporaryDirectory() as tmp:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                rc, lines = _cli_run(["--params", json.dumps(p), "--output-dir", tmp]
                                     + link_argv + (["--fault-report"] if report else []))
                torch.cuda.synchronize()
                launches = read_counts()
            res = json.loads(lines[0])
            results[name] = res
            row = {"rc": rc, "chunks": res["chunks"], "groups": groups,
                   "s_per_chunk": res["wall_s"] / res["chunks"], "ppl": res["ppl"],
                   "bytes_per_token_per_hop": res["bytes_per_token_per_hop"],
                   "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "launches": launches}
            if report:
                for line in lines[1:]:
                    log(f"  {name}: {line}")
                by_tier = res["link_by_tier"]
                routes = p["hedge"].get("routes", 2) if "hedge" in p else 1
                want = _link_expected(by_tier, groups, cfg.num_layers, routes)
                seq = 512
                payload = res["bytes_per_token_per_hop"][0] * seq  # (1, 512, D) int8 payload
                sealed = payload + 8
                fec = FECConfig(**p["fec"]) if "fec" in p else None
                wire = fec.wire_nbytes(sealed) if fec else sealed
                sent = sum(_copies_sent(t["counters"], routes) for t in by_tier if t)
                row.update({
                    "link_counters": res["link_counters"], "tier_switches": res["tier_switches"],
                    "final_tier": res["final_tier"], "degraded_chunks": res["degraded_chunks"],
                    "link_health": res.get("link_health"), "link_by_tier": by_tier,
                    "wire_bytes_per_token_per_copy": wire / seq,
                    "fec_overhead": fec.overhead(sealed) if fec else 0.0,
                    "copies_sent": sent, "launches_expected": want})
                if launches != want:
                    raise SystemExit(f"{label}: kernel launches {launches} != expected {want}")
            else:  # no link: the gate plans the hop ("auto": the cache's verdict)
                plan = _plan_mode(p)
                row["plan"] = None if plan is None else plan.mode
                want = want_counts(cfg.num_layers * groups,
                                   causal_attention=cfg.num_layers * groups,
                                   **_int8_hop_counts(row["plan"], groups))
                row["launches_expected"] = want
                if launches != want:
                    raise SystemExit(f"{label}: kernel launches {launches} != expected {want}")
            rows[label] = row
            log(json.dumps({"link_path": {k: v for k, v in row.items()
                                          if k not in ("link_by_tier", "launches_expected")}}))
            if rc != 0 or res["chunks"] != LINK_CHUNKS or not np.isfinite(res["ppl"]):
                raise SystemExit(f"{label}: rc {rc}, {res['chunks']} chunks, PPL {res['ppl']}")
            out[label] = launches
    if results["split1 zero-rate faults"]["total_nll"] != results["split1 clean"]["total_nll"]:
        raise SystemExit("a faults config of zero rates does not give the clean split's PPL: "
                         f"{results['split1 zero-rate faults']['ppl']} vs "
                         f"{results['split1 clean']['ppl']}")
    if not results["split6_qwen_chaos"]["tier_switches"]:
        raise SystemExit("split6's tier trail never stepped: K1 / K2 did not run")

    # the same configs at LINK_CROSS_LAYERS layers, on the card and the CPU
    full_cfg, full_params = run._load_model(
        ap.Namespace(weights=None, model="qwen2-0.5b", seed=args.seed), torch.device("cuda"))
    cut_cfg = dc.replace(full_cfg, num_layers=LINK_CROSS_LAYERS)
    cut_params = {**{k: v for k, v in full_params.items() if k != "layers"},
                  "layers": {k: v[:LINK_CROSS_LAYERS] for k, v in full_params["layers"].items()}}
    del full_params
    cross = {}
    with probe_cache_file(cache_path):
        for path in LINK_CONFIGS:
            name = os.path.basename(path)[:-5]
            with open(path) as f:
                p = json.load(f)
            kw = dict(cuts=p["cuts"], hop_codecs=p["hop_codecs"], max_length=p["max_length"],
                      stride=p["stride"], window_batch=LINK_WB, max_chunks=LINK_CHUNKS,
                      time_hops=False, **{k: p.get(k) for k in run.LINK_KEYS})
            t0 = time.monotonic()
            on_card = run_split_eval(cut_cfg, cut_params, corpus, device="cuda", **kw)
            t1 = time.monotonic()
            on_cpu = run_split_eval(cut_cfg, params_to(cut_params, device="cpu"), corpus,
                                    device="cpu", **kw)
            t2 = time.monotonic()
            rel = abs(on_card["ppl"] - on_cpu["ppl"]) / on_cpu["ppl"]
            full = results[name]
            cross[name] = {"layers": LINK_CROSS_LAYERS, "card_s": t1 - t0, "cpu_s": t2 - t1,
                           "card_ppl": on_card["ppl"], "cpu_ppl": on_cpu["ppl"], "rel": rel,
                           "link_counters": on_cpu["link_counters"],
                           "tier_switches": on_cpu["tier_switches"]}
            log(json.dumps({"link_cross_check": {name: cross[name]}}))
            for key in ("link_counters", "tier_switches", "final_tier", "degraded_chunks",
                        "link_health"):
                if not on_card.get(key) == on_cpu.get(key) == full.get(key):
                    raise SystemExit(f"{name}: {key} differ: card {on_card.get(key)}, CPU "
                                     f"{on_cpu.get(key)}, full depth {full.get(key)}")
            if rel > SPLIT_CROSS_RTOL:
                raise SystemExit(f"{name}: card PPL {on_card['ppl']} vs CPU {on_cpu['ppl']} "
                                 f"(rel {rel:.3g} > {SPLIT_CROSS_RTOL})")
    rows["cross_checks"] = cross
    del cut_params
    torch.cuda.empty_cache()

    # one group of each link config at full depth profiled: the idle share
    full_cfg, full_params = run._load_model(
        ap.Namespace(weights=None, model="qwen2-0.5b", seed=args.seed), torch.device("cuda"))
    with probe_cache_file(cache_path):
        for path in LINK_CONFIGS:
            name = os.path.basename(path)[:-5]
            with open(path) as f:
                p = json.load(f)
            kw = dict(cuts=p["cuts"], hop_codecs=p["hop_codecs"], max_length=p["max_length"],
                      stride=p["stride"], window_batch=LINK_WB, max_chunks=LINK_WB,
                      time_hops=False, device="cuda", **{k: p.get(k) for k in run.LINK_KEYS})
            run_split_eval(full_cfg, full_params, corpus, **kw)  # warm
            prof, _ = device_time(lambda: run_split_eval(full_cfg, full_params, corpus, **kw),
                                  LINK_WB)
            log_profile(f"profile_link_{name}_group", prof, 12)
            rows[f"link {name}"]["profile"] = prof

    # (4) the fault sweep on split1's cut, full depth
    kw = dict(cuts=[11], hop_codecs=["int8_per_token"], max_length=512, stride=32,
              window_batch=1, max_chunks=SWEEP_CHUNKS, time_hops=False, device="cuda")
    with probe_cache_file(cache_path):
        reset_counts()
        sweep = run_fault_sweep(full_cfg, full_params, corpus, rates=SWEEP_RATES,
                                knob="drop_rate", seed=0, link_policy={"max_retries": 0}, **kw)
        launches = read_counts()
        clean = run_split_eval(full_cfg, full_params, corpus, **kw)
    curve = [{"drop_rate": r["fault_rate"], "ppl": r["ppl"],
              "s_per_chunk": r["wall_s"] / r["chunks"],
              "link_counters": r.get("link_counters")} for r in sweep]
    log(json.dumps({"fault_sweep": curve}))
    rows["fault_sweep"] = {"curve": curve, "clean_ppl": clean["ppl"], "launches": launches}
    if sweep[0]["total_nll"] != clean["total_nll"]:
        raise SystemExit(f"fault sweep: the rate-0 point {sweep[0]['ppl']} is not the clean "
                         f"split's {clean['ppl']}")
    out["link fault sweep split1 drop"] = launches
    del full_params
    torch.cuda.empty_cache()
    detail["boundary_link"] = rows
    return out


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
    # every phase reads a probe cache this run wrote, never a stale one: an
    # empty cache before phase 17 (no data: no fusion under "auto"), phase
    # 17's own probe after it; no override of the gate
    probe_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(probe_dir, exist_ok=True)
    empty_cache = os.path.join(probe_dir, "probe_cache_empty.json")
    if os.path.exists(empty_cache):
        os.remove(empty_cache)
    os.environ["EDGELLM_PROBE_CACHE"] = empty_cache
    if os.environ.pop("EDGELLM_FUSED_HOP", None) is not None:
        log("EDGELLM_FUSED_HOP was set: cleared, so the gate decides from this run's probe "
            "cache")

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
    paged_rows = paged_checks(detail)
    t1 = time.monotonic()
    by_path = {"token_sweep": main_path(args, detail)}
    t2 = time.monotonic()
    by_path.update(split_paths(args, detail))
    t3 = time.monotonic()
    by_path.update(serve_paths(args, detail))
    by_path.update(cli_sweeps(args, detail))
    t4 = time.monotonic()
    split_cross_checks(args, detail)
    cross_check(args, detail)
    serve_cross_checks(args, detail)
    t5 = time.monotonic()
    by_path.update(experiment_paths(args, detail))
    t6 = time.monotonic()
    by_path.update(split_decode_paths(args, detail))
    t7 = time.monotonic()
    by_path.update(split_paged_paths(args, detail))
    t8 = time.monotonic()
    by_path.update(boundary_link_paths(args, detail,
                                       os.path.join(probe_dir, "probe_cache_phase17.json")))
    detail["phase_s"] = {"kernels": t1 - t0, "token_sweep": t2 - t1, "split_paths": t3 - t2,
                         "serve_paths": t4 - t3, "cross_checks": t5 - t4,
                         "experiments": t6 - t5, "split_decode": t7 - t6,
                         "split_paged": t8 - t7, "boundary_link": time.monotonic() - t8}
    log(json.dumps({"phase_s": detail["phase_s"]}))

    kernels = []
    for name, meta in KERNELS.items():
        counts = {path: got.get(name, 0) for path, got in by_path.items()}
        if name in main_rows:
            r = main_rows[name]
            shape = f"{r['shape']} B={r['b']} S={r['s']} {r['dtype']}"
        elif name in paged_rows:
            r = paged_rows[name]
            shape = (f"{r['shape']} B={r['b']} ps={r['page_size']} pps={r['pages_per_slot']} "
                     f"{r['dtype']} {r['kv_codec']}")
        else:
            r = codec_rows[name]
            shape = f"qwen2-0.5b split N={r['n']} D={r['d']} {r['dtype']}"
        extra = {}
        if name == "causal_attention":  # fp32 beside bf16 launches, by path
            extra["launches_by_dtype_by_path"] = {
                path: {d.split()[-1]: got.get(d, 0) for d in ATTN_BY_DTYPE}
                for path, got in by_path.items()}
        if name == "causal_attention_stats":  # the CLI's fp32 sweep: its column pass apart
            f = main_rows["causal_attention_stats float32"]
            extra["float32"] = {
                "shape": f"{f['shape']} B={f['b']} S={f['s']} float32",
                "launches": sum(n for path, n in counts.items() if path.startswith("cli ")),
                "ms": f["kernel_device_ms"], "plain_ms": f["plain_ms"],
                "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
                "max_abs_err": f["stats_max_abs_err"], "column_pass_ms": f["col_device_ms"],
                "column_pass_bound_ms": f["col_bound_ms"],
                "column_pass_bound_by": f["col_bound_by"],
                "forward_lse_ms": f["forward_lse_device_ms"], "library_ms": None}
        # ms, library_ms: device times (torch.profiler); event_ms: the call's
        # CUDA-event time (a codec row's kernel_ms is its device time already)
        kernels.append({"name": name, **meta, "launches": sum(counts.values()),
                        "launches_by_path": counts, **extra,
                        "max_abs_err": r["max_abs_err"],
                        "ms": r.get("kernel_device_ms", r["kernel_ms"]),
                        "event_ms": r.get("event_ms", r["kernel_ms"]),
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_device_ms", r["library_ms"]),
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
