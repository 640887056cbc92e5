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
   dtypes, the stats deterministic, and at the tensor-parallel shards' heads
   of phase 23 (:data:`TP_SHAPES`: 7 over 1 at hd 64, 6 over 1 at hd 128, 2
   over 2 at S = 2048); the codec kernels K1-K7 (K2 also with a
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
   the 3xTF32 GEMM (``gemm_paths``) at the fp32 cells' MLP, q / k / v and
   head-block shapes: device ms over 50 warm calls beside its bound
   (164.9 TFLOP/s), its plain version and cuBLAS fp32, its widest error
   against float64 at most twice cuBLAS's and its output near its plain
   version's; the crossover against cuBLAS (decode rows up to 64 output
   tiles); one fp32 table group and one split4 group with every product
   but the narrow ones below ``gemm.MIN_TILES`` on the kernel, and an fp32
   decode with every product routed to torch.matmul;
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
   group, fp32 K-attn the suffix passes, and the memory preflight's probes
   at window batch 1 and 2), one group under torch.profiler with the
   column pass, the forward and the LM head named;
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
   and depth (the two CLI runs at 13 layers, the shallowest cut 11 allows),
   fp32 random weights from ``--seed``: ``run.main`` on
   configs/split11_qwen_spec.json (cut 11, int8_per_token, speculative k =
   4, 24 requests at T = 0.7) and on the same params without
   ``speculative`` (the vanilla per-request split route), each with every
   request completed, the identity replay green, each call's speculative
   stats consistent, per-request service ms, and K3 / K4 and fp32 K-attn
   launched exactly as the counted calls imply (cuts x (prefills + decode
   steps + verify bursts); 13 a split prefill, 12 a draft prefill, 13 a
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
18. survivable serving at full Qwen2-0.5B width and depth, fp32 random
   weights from ``--seed``: configs/split8_qwen_serve.json through
   ``run.main --serve-report`` (every request accounted for, the kill of
   stage 1 and the failover onto cut 11 printed, K-attn / K3 / K4 launched
   exactly as the logged calls and the link's counters imply), the same
   soak at 6 layers on the card and the CPU (outcomes, reasons, link
   counters, identity counts and tokens equal);
   configs/split6_qwen_failover.json through ``run.main --fault-report``
   (24 chunks, window batch 4: one failover and re-plan onto cut 11, K3 /
   K4 two a group before the loss and one after), card against CPU at 17
   layers (PPL within rtol 1e-4); ``generate_split``'s recovery drills on
   split8's cuts with fp32 hops over its link (periodic checkpoints, halt
   and ``resume_split``, a ``StageFailure`` at step 3, the speculative
   resume: the uninterrupted tokens); split9 with cut 11 and split8's link
   inline (its counters the CPU's) and an int4 stream of split14's tier
   checkpointed and restored (pages bit for bit, K14 launched, the
   uninterrupted tokens); ms a decode step with and without the link, in
   turns, its idle share and kernels a step;
19. the µ-batch pipeline and observability at full Qwen2-0.5B width and
   depth, fp32 random weights from ``--seed``:
   configs/split12_qwen_pipeline.json (cuts 9 and 18, two int8_per_token
   hops, four µ-batches) through ``run.main`` beside the same split with
   ``pipeline`` removed, in turns (s/chunk, PPL within 1e-4, one group of
   each profiled, K-attn 24 · M and K3 / K4 2 · M a group), with split6's
   link inline (``--fault-report``; the (M, 2) µ-batch counters summing to
   the link counters), under fused "remote" (K8 2 · M a group), one
   pipelined forward with int4_per_token hops (K1 / K2); pipelined
   ``generate_split`` at B = M = 4 (the unpipelined tokens, and at 6 layers
   the CPU's); split9 with cut 11 and two µ-batches through ``run.main``
   (every request completed, K13 24 · M a ragged step, the unpipelined
   batcher's tokens); split12 with ``--metrics-out``, ``--trace-out``,
   ``--trace-report`` and ``--profile`` (the Prometheus text parses, the
   trace holds the reference's span names, the profile holds them as
   ranges, result and launches equal the unobserved run's) and a decode
   step timed in turns with observability on and off (tokens and launches
   equal, the overhead reported);
20. the fleet's first pieces at full Qwen2-0.5B width and depth, fp32
   random weights from ``--seed``: configs/split16_qwen_disagg.json through
   ``run.main`` (two prefill workers x two staging slots, int8 pages, FEC
   on the migration link; mode "disagg_batched", every request completed,
   3 pages a request, the link's wire bytes the sum of
   ``migration_wire_nbytes`` over the pages, the colocated batcher's tokens,
   24 fp32 K-attn a prefill with none for an adopted stream and 24 K14 a
   ragged step), disagg and colocated in turns (ms a decode step, wall a
   request: on one card the prefill workers and the decode pool share the
   device and run in turn); split16 with cut 11 (mode
   "disagg_batched_split", K3 / K4 once a hop, K14 12 a stage a step, the
   colocated split-paged batcher's tokens); ``run_disagg_soak`` with a
   prefill worker killed mid-migration, the decode worker killed, the link
   failed and a bit-flip window (the identity audit passing), with the
   flight recorder and the live endpoint armed (one artifact a
   migration-fatal failure, read back; /metrics, /healthz, /snapshot.json
   and /trace answering on 127.0.0.1, /metrics the registry's text, a 404
   for any other path); the soak at 2 layers on the card and the CPU
   (kills, identity counts and the disagg report equal);
21. the replica router and the gray plane at full Qwen2-0.5B width and
   depth, fp32 random weights from ``--seed`` (the replicas share the card
   and drain in turn): configs/split15_qwen_cluster.json and
   configs/split17_qwen_gray.json through ``run.main`` (every request
   completed, mode "cluster_batched", placements by kind, K-attn and K13
   exactly as every replica's prefills and ragged steps and the warm
   batcher's imply; split17's ``gray`` report equal to a 2-layer CPU run's,
   the whole fleet report too), split15 with cut 11 (K3 / K4 once a hop)
   and over split16's ``disagg`` block with int8 pages (K14 a step, one
   migration a request); the real-model kill drill of the reference bench
   (2 replicas, 12 requests with a shared prefix, half sampled through
   recorded seeds, replica 0 killed at request 6, against a 1-replica fleet:
   zero accepted loss, every stream identical, one flight dump, re-admitted
   work, the dead replica's pool freed, peak memory; card against CPU at 2
   layers); the simulated chaos soak (4 replicas, two kills, a corruption
   burst) and the 600-request gray soak hedged and unhedged, host only;
22. long context at full Qwen2-0.5B width and depth, S = 2048 in four
   sequence shards (the stage x seq runtime; the shards run in turn on the
   one card), fp32 random weights from ``--seed``: K1-K4 at the ring's
   shapes against their plain versions; configs/split5_qwen_ring_long.json
   and split5b_qwen_ring_selective.json through ``run.main`` (2 chunks:
   PPL, bytes per token, s/chunk, K1 / K2 exactly 4 a group and 4 a timed
   hop for split5, no kernel for split5b) and split5 with n_seq 1 (the dense
   split: PPL within 1e-4 relative, the same bytes per token); the ring
   codec's global mode against the dense ``selective_int4`` bit for bit and
   ``importance_sp`` against the dense K-stats importance; a 2-layer ring
   forward and ``importance_sp`` on the card against the CPU; the ring under
   the link with an int8_per_token hop (a zero-rate link bit for bit the
   link-free logits, drop_rate 0.5 seed 11 counters the CPU's, K3 / K4 once
   a shard's hop encoded / a copy sent); ``tools/ring_mode_gap.measure`` at
   split5b's shape (|dNLL| per ratio);
23. the "data" and "model" mesh axes and the offline tools at full
   Qwen2-0.5B width and depth, fp32 random weights from ``--seed``, through
   ``run.main`` (:func:`mesh_paths`): split1 as shipped and with inline
   ``n_model`` 2, ``n_data`` 2 and both (PPL within 1e-4 of the plain run,
   equal bytes per token, K-attn exactly layers x groups x n_data x
   n_model and K3 / K4 n_data a group, s/chunk and peak memory), split2's
   selective hop at ``n_data`` 2 (K-stats counted), split4 (Qwen2-1.5B) at
   ``n_model`` 2 and split0 (Pythia-70M) at 4 beside their plain runs,
   ``--distributed`` in two processes on the card (gloo for the host
   gather; the ranks' line the one-process run's, only rank 0 writing),
   the memory preflight (the token sweep with ``BENCH_HBM_GB`` below
   window batch 8's estimate: the batch chosen, its estimate and the
   measured peak under the budget) and the refusals exiting non-zero;
24. graphlint on the card (:func:`lint_paths`): ``python3 -m
   edgellm_tpu_torch.run --lint`` as a subprocess (exit 0 or the run
   fails), each contract clean with its launches beside the declared ones
   and its host_sync check, the lattice's rows at exact launches, each
   config's footprint beside its ``aot_peak_bytes``, the wall time; then
   ``--device cpu --graph-only``, whose clean contracts must be the card's;
25. a JSON line of every kernel (launches summed over the counted paths,
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
import shutil
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
    "gemm_tf32x3": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/gemm_tf32x3.cu",
        "replaces": None, "note": "replaces no TPU kernel: the JAX package leaves the "
                                  "model's dots to XLA"},
    "grouped_gemm_tf32x3": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/gemm_tf32x3.cu",
        "replaces": None, "note": "replaces no TPU kernel: the JAX package has no sparse "
                                  "experts (LFM2-MoE, models/moe.py)"},
    "gather_rows": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/moe_rows.cu",
        "replaces": None, "note": "replaces no TPU kernel: the expert layer's gather of the "
                                  "held pairs' rows (models/moe.py)"},
    "combine_rows": {
        "route": "cuda", "source": "edgellm_tpu_torch/csrc/moe_rows.cu",
        "replaces": None, "note": "replaces no TPU kernel: the expert layer's weighted "
                                  "combine over the held pairs (models/moe.py)"},
}
#: kernels whose launches every path reads but none predicts: the 3xTF32
#: GEMM takes a product by its rows and output tiles (``gemm.route``), which
#: change with every prompt length and batch; :func:`gemm_paths` holds whole
#: fp32 groups of both benchmark configurations and an fp32 decode to it
READ_ONLY_KERNELS = ("gemm_tf32x3",)


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
    ] + [(label, b, s, h, kv, hd, ("causal_attention", "causal_attention_stats"), False)
         for label, b, s, h, kv, hd in TP_SHAPES]  # phase 23's tensor-parallel shards
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
    from portbench.yardstick.flops import sweep_chunk_flops

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
    with open("portbench/configs/qwen2-0.5b.json") as f:
        model_flops = sweep_chunk_flops(json.load(f), window, stride, len(methods), [layer],
                                        ratios)
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
            or launches_differ(launches, want):
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


#: the 3xTF32 GEMM's shapes, (label, M, N, K): the MLP, q / k and head-block
#: products of the fp32 table (qwen2-0.5b: suffix 16384 rows, tail 10824)
#: and of the fp32 split (qwen2-1.5b: 4096 rows; its head is one unembed
#: over the whole vocabulary)
GEMM_SHAPES = [
    ("qwen2-0.5b gate/up", 16384, 4864, 896), ("qwen2-0.5b down", 16384, 896, 4864),
    ("qwen2-0.5b q/o", 16384, 896, 896), ("qwen2-0.5b k/v", 16384, 128, 896),
    ("qwen2-0.5b head block", 10824, 4748, 896),
    ("qwen2-1.5b gate/up", 4096, 8960, 1536), ("qwen2-1.5b down", 4096, 1536, 8960),
    ("qwen2-1.5b q/o", 4096, 1536, 1536), ("qwen2-1.5b k/v", 4096, 256, 1536),
    ("qwen2-1.5b head block", 4096, 4748, 1536),
    ("qwen2-1.5b unembed", 4096, 151936, 1536),
]
#: rows of the crossover reading at every (N, K) of :data:`GEMM_SHAPES`: a
#: decode step's (1 and 8 streams), the short prefills' and one row tile
GEMM_CROSSOVER_ROWS = (1, 8, 64, 128, 256, 512, 1024)
#: output tiles of the crossover reading around the routing's limit: at each
#: (N, K), the fewest whole row tiles that reach each count
GEMM_CROSSOVER_TILES = (24, 28, 30, 32, 34, 36, 38, 40, 48, 64)
#: the kernel against its plain version on the same inputs: within this many
#: times cuBLAS fp32's widest error against float64 (the two sum the same
#: TF32 products in other orders)
GEMM_PLAIN_TOL = 3
#: tokens of the fp32 decode run that holds the routing's cuBLAS side
GEMM_DECODE_TOKENS = 16
#: the 3xTF32 bound: three TF32 products a product, 494.7 TFLOP/s / 3
GEMM_PEAK_FLOPS = 494.7e12 / 3


def _widest_error(got, a, w, block: int = 16384) -> float:
    """max |got - a @ w| against the float64 product, by column blocks."""
    a64, err = a.double(), 0.0
    for j in range(0, w.shape[1], block):
        ref = a64 @ w[:, j:j + block].double()
        err = max(err, (got[:, j:j + block].double() - ref).abs().max().item())
    return err


def _crossover_rows(n: int) -> list:
    """The crossover's rows at N output columns: :data:`GEMM_CROSSOVER_ROWS`
    and, for each of :data:`GEMM_CROSSOVER_TILES`, the fewest whole row
    tiles that reach it."""
    from edgellm_tpu_torch.models import gemm

    cols = -(-n // gemm.TILE_N)
    tiles = {gemm.TILE_M * -(-t // cols) for t in GEMM_CROSSOVER_TILES}
    return sorted(set(GEMM_CROSSOVER_ROWS) | tiles)


def gemm_paths(args, detail: dict) -> tuple:
    """The 3xTF32 GEMM -> (its row at qwen2-0.5b's gate / up shape, launch
    counts by path). At every shape of :data:`GEMM_SHAPES`: its device ms
    over 50 warm calls beside its bound, its plain version's and cuBLAS
    fp32's; its widest error against float64 at most twice cuBLAS's, and
    its output within :data:`GEMM_PLAIN_TOL` times cuBLAS's error of the
    plain version's on the same inputs. The crossover against cuBLAS (rows
    of :func:`_crossover_rows`), and the output tiles from which the kernel
    won at every (N, K). Then one fp32 table group (qwen2-0.5b) and one fp32
    split4 group (qwen2-1.5b): every product takes the kernel but the
    narrow k / v products the routing leaves to torch.matmul (the table's
    statistics forward's: 32 tiles); and an fp32 qwen2-0.5b decode, the routing's
    other side: every product routed to torch.matmul, beside one step's
    products timed through the kernel and through cuBLAS."""
    import torch

    from edgellm_tpu_torch.eval import run_token_sweep
    from edgellm_tpu_torch.eval.split_eval import run_split_eval
    from edgellm_tpu_torch.models import PRESETS, gemm, init_params
    from edgellm_tpu_torch.models import transformer as tr
    from edgellm_tpu_torch.serve.decode import generate

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for label, m, n, k in GEMM_SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        planes, n0 = tr.prepared_planes(w)
        got = gemm.gemm_tf32x3(a, planes, n0, n)
        torch.cuda.synchronize()
        err = _widest_error(got, a, w)
        lib_err = _widest_error(a @ w, a, w)
        plain_diff = (got - gemm.gemm_tf32x3_plain(a, planes, n0, n)).abs().max().item()
        torch.cuda.synchronize()
        del got
        iters = 10 if n > 100000 else 50
        ms = device_ms(lambda: gemm.gemm_tf32x3(a, planes, n0, n), iters)
        lib_ms = device_ms(lambda: a @ w, iters)
        plain_ms = time_ms(lambda: gemm.gemm_tf32x3_plain(a, planes, n0, n), 3, warmup=1)
        flops = 2.0 * m * n * k
        bound_ms = flops / GEMM_PEAK_FLOPS * 1e3
        # kernel_ms, library_ms: CUDA-event times of a call, as the other rows'
        row = {"shape": label, "m": m, "n": n, "k": k, "kernel_device_ms": ms,
               "kernel_ms": time_ms(lambda: gemm.gemm_tf32x3(a, planes, n0, n), iters),
               "tflops_per_s": flops / ms / 1e9, "bound_ms": bound_ms,
               "bound_by": "operations", "share": bound_ms / ms, "plain_ms": plain_ms,
               "library_device_ms": lib_ms, "library_ms": time_ms(lambda: a @ w, iters),
               "library_tflops_per_s": flops / lib_ms / 1e9,
               "max_abs_err": err, "library_max_abs_err": lib_err,
               "plain_max_abs_diff": plain_diff}
        log(json.dumps({"gemm": row}))
        rows.append(row)
        if err > 2 * lib_err or plain_diff > GEMM_PLAIN_TOL * lib_err:
            raise SystemExit(f"gemm {label}: error {err} (cuBLAS {lib_err}), "
                             f"{plain_diff} from the plain version")
        del a, w, planes
        torch.cuda.empty_cache()

    crossover = []
    for _, _, n, k in GEMM_SHAPES[:4] + GEMM_SHAPES[5:9]:
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        planes, n0 = tr.prepared_planes(w)
        for m in _crossover_rows(n):
            a = torch.randn((m, k), generator=gen, device="cuda")
            crossover.append({"m": m, "n": n, "k": k,
                              "tiles": -(-m // gemm.TILE_M) * -(-n // gemm.TILE_N),
                              "route": gemm.route("cuda", a.dtype, w.dtype, m, n) or "kernel",
                              "kernel_device_ms": device_ms(
                                  lambda: gemm.gemm_tf32x3(a, planes, n0, n), 20),
                              "library_device_ms": device_ms(lambda: a @ w, 20)})
            log(json.dumps({"gemm_crossover": crossover[-1]}))
    # the fewest tiles from which the kernel won at every (N, K), of at
    # least one row tile; and the points the routing sends to the slower side
    lost = [r["tiles"] for r in crossover if r["m"] >= gemm.MIN_ROWS
            and r["kernel_device_ms"] >= r["library_device_ms"]]
    wins_from = min((r["tiles"] for r in crossover if r["tiles"] > max(lost, default=0)),
                    default=None)
    slower = [r for r in crossover if (r["route"] == "kernel")
              != (r["kernel_device_ms"] < r["library_device_ms"])]
    detail["gemm"] = {"rows": rows, "crossover": crossover,
                      "kernel_wins_from_tiles": wins_from, "min_tiles": gemm.MIN_TILES,
                      "routed_to_the_slower_side": slower}
    log(json.dumps({"gemm_routing": {k: detail["gemm"][k] for k in (
        "kernel_wins_from_tiles", "min_tiles", "routed_to_the_slower_side")}}))

    # a cell's chunks are whole groups of 8 windows: the table's counts are
    # those of chunks 0-8 less those of chunk 0 (a corpus's first window,
    # which runs alone); split4 batches its first window with the group
    counts, by_path = {}, {}
    rng = np.random.default_rng(args.seed)
    table = {"methods": ["regular_importance", "last_row"],
             "layers_of_interest": [22, 18, 3, 23, 11], "ratios": [0, 0.25, 0.5, 0.75, 1]}
    for label, model, run, chunks in (
            ("table-fp32", "qwen2-0.5b", lambda cfg, params, ids, n: run_token_sweep(
                cfg, params, ids, max_length=512, stride=32, window_batch=8, max_chunks=n,
                device="cuda", **table), (1, 9)),
            ("split4-fp32", "qwen2-1.5b", lambda cfg, params, ids, n: run_split_eval(
                cfg, params, ids, cuts=[9, 18], hop_codecs=["int8_per_token", "int4_per_token"],
                max_length=512, stride=32, window_batch=8, max_chunks=n, time_hops=False,
                device="cuda"), (0, 8))):
        cfg = PRESETS[model]
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                             dtype=torch.float32, device="cuda")
        ids = rng.integers(0, cfg.vocab_size, 512 + 32 * 10)
        torch.cuda.reset_peak_memory_stats()
        seen = []
        for n in chunks:
            routed = dict(tr.linear.routed)
            reset_counts()
            if n:
                run(cfg, params, ids, n)
            torch.cuda.synchronize()
            seen.append((read_counts(), {r: tr.linear.routed[r] - routed[r] for r in routed}))
        (l0, r0), (l1, r1) = seen
        by_path[f"gemm {label} group"] = {kernel: l1[kernel] - l0[kernel] for kernel in l1}
        # below the routing's limit in a group: the k / v products of 8
        # windows of 512 rows, the table's statistics forward's (every layer
        # to the deepest of interest) and split4's (every layer)
        narrow = gemm.route("cuda", torch.float32, torch.float32, 8 * 512,
                            cfg.num_kv_heads * cfg.head_dim) == "small_m"
        layers = max(table["layers_of_interest"]) + 1 if label == "table-fp32" \
            else cfg.num_layers
        counts[label] = {"launches": by_path[f"gemm {label} group"]["gemm_tf32x3"],
                         "routed": {r: r1[r] - r0[r] for r in r1},
                         "routed_expected": {"small_m": 2 * layers * narrow, "cpu": 0, "bf16": 0},
                         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        log(json.dumps({"gemm_counts": {label: counts[label]}}))
        if not counts[label]["launches"] \
                or counts[label]["routed"] != counts[label]["routed_expected"]:
            raise SystemExit(f"gemm {label}: products routed to torch.matmul {counts[label]}")
        if label == "table-fp32":
            counts["decode-fp32"] = _gemm_decode(cfg, params, rng, generate, by_path)
        del params
        torch.cuda.empty_cache()
    detail["gemm"]["counts"] = counts
    return next(r for r in rows if r["shape"] == "qwen2-0.5b gate/up"), by_path


#: the LFM2 cell's grouped expert products: (label, K, N, glu) over 16 held
#: experts, rows as a statistics forward of 16 windows routes them (top-4 of
#: 32 on uniform scores: ~1024 an expert); the gate / up product over glu
#: planes, storing silu(gate) * up (N / 2 features), as the layer runs it
MOE_SHAPES = (("lfm2 experts gate/up", 2048, 3584, True),
              ("lfm2 experts down", 1792, 2048, False))
MOE_TOKENS, MOE_HELD, MOE_ROUTED, MOE_TOP_K = 16 * 512, 16, 32, 4
#: tiny-lfm2 logits, card against CPU: fp32 in another order (1e-5 read)
MOE_CROSS_TOL = 1e-4
#: the fused gate / up against the unfused launch and F.silu(g) * u, in fp32
#: ulps of the unfused value: the same column sums, SiLU with IEEE expf and
#: division on both sides
MOE_GLU_ULPS = 4


def _silu_up(h):
    """silu(gate) * up of a gate / up product (M, 2F), gate then up."""
    import torch.nn.functional as F

    f = h.shape[1] // 2
    return F.silu(h[:, :f]) * h[:, f:]


def _ulps_apart(got, want) -> float:
    """The widest |got - want| in fp32 ulps of |want| (at least the smallest
    normal's)."""
    import torch

    unit = torch.finfo(torch.float32).eps * want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return ((got - want).abs() / unit).max().item() if want.numel() else 0.0


def moe_rows_paths(experts, seed: int) -> dict:
    """The expert layer's gather and combine (``csrc/moe_rows.cu``) at the
    LFM2 cell's T (``experts`` (T, k), the statistics forward's picks over
    32 experts, the first :data:`MOE_HELD` held), each -> its row: device ms
    over 20 warm calls beside its bytes bound, the plain version's time and
    the PyTorch passes' it replaced (``library``). The gather's rows and
    pair rows equal ``index_select``'s and the scatter's; the combine lies
    within one fp32 ulp of the terms an add of the gather / multiply /
    where / sum, with a NaN planted in every row past the held pairs'
    (never read)."""
    import torch

    from edgellm_tpu_torch.models import flash_attention as fa
    from edgellm_tpu_torch.models import moe

    t, k = experts.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((t, 2048), generator=gen, device="cuda")
    d = x.shape[1]
    order, offsets = moe.dispatch(experts, 0, MOE_HELD)
    local = experts.reshape(-1)
    held = local < MOE_HELD
    n = offsets[-1].item()

    def old_gather():
        rows = x.index_select(0, order // k)
        pos = torch.empty_like(order)
        pos[order] = torch.arange(order.numel(), device=order.device)
        return rows, pos

    rows, pos = moe.gather_rows(x, order, offsets, k)
    old_rows, old_pos = old_gather()
    gather_ok = bool(torch.equal(rows[:n], old_rows[:n]) and torch.equal(
        pos.long()[held], old_pos[held]) and (pos[~held] == -1).all())
    y = torch.randn((t * k, d), generator=gen, device="cuda")
    y[n:] = math.nan
    w = torch.rand((t, k), generator=gen, device="cuda")
    w = w / w.sum(dim=-1, keepdim=True)

    def old_combine():
        picked = y.index_select(0, old_pos).reshape(t, k, d)
        return torch.where(held.reshape(t, k)[..., None], picked * w[..., None], 0.0).sum(dim=1)

    got = moe.combine_rows(y, pos, w, torch.float32)
    picked = y.index_select(0, old_pos).reshape(t, k, d)
    terms = torch.where(held.reshape(t, k)[..., None], picked * w[..., None], 0.0)
    want = terms.sum(dim=1)
    tol = k * torch.finfo(torch.float32).eps * terms.abs().sum(dim=1)
    combine_err = (got - want).abs().max().item()
    combine_ok = bool(((got - want).abs() <= tol).all() and not got.isnan().any())
    torch.cuda.synchronize()
    del picked, terms, want, old_rows
    shape = f"lfm2 cell T={t} k={k} D={d}, {n} of {t * k} pairs held"
    out = {}
    for name, fn, plain, lib, nbytes, err in (
            ("gather_rows", lambda: moe.gather_rows(x, order, offsets, k),
             lambda: moe.gather_rows_plain(x, order, offsets, k), old_gather,
             2 * 4 * n * d + 12 * t * k, 0.0 if gather_ok else math.inf),
            ("combine_rows", lambda: moe.combine_rows(y, pos, w, torch.float32),
             lambda: moe.combine_rows_plain(y, pos, w, torch.float32), old_combine,
             4 * n * d + 8 * t * k + 4 * t * d, combine_err)):
        ms = device_ms(fn, 20)
        bound, bound_by = fa.bound_ms(float(nbytes), 0.0, torch.float32)
        row = {"shape": shape, "pairs": t * k, "held_pairs": n, "d": d,
               "kernel_device_ms": ms, "kernel_ms": time_ms(fn, 20),
               "bound_ms": bound, "bound_by": bound_by,
               "plain_ms": time_ms(plain, 2, warmup=1),
               "library_device_ms": device_ms(lib, 20), "library_ms": time_ms(lib, 20),
               "max_abs_err": err}
        row["share"] = row["bound_ms"] / ms
        log(json.dumps({"moe_rows": {name: row}}))
        out[name] = row
    if not (gather_ok and combine_ok):
        raise SystemExit(f"moe rows: gather equal to index_select / scatter: {gather_ok}, "
                         f"combine within an ulp an add of the old passes (widest "
                         f"{combine_err}) with no NaN: {combine_ok}")
    return out


def moe_paths(args, detail: dict) -> tuple:
    """The grouped 3xTF32 GEMM, the gather and combine, and the hybrid
    model -> (the grouped kernel's row at the LFM2 cell's gate / up shape,
    the gather's and combine's rows by name, launch counts by path). At
    each of :data:`MOE_SHAPES`: device ms over 20 warm calls beside its
    bound, its plain version's and a per-expert cuBLAS fp32 loop's (then
    SiLU·up for the gate / up); each expert's widest error against float64
    at most 3x cuBLAS fp32's, the held rows within :data:`GEMM_PLAIN_TOL`
    times that error of the plain version over the same planes, and the rows
    past the held experts' (pairs routed to the other card) left as the
    output held them (NaN). The gate / up over glu planes also lies within
    :data:`MOE_GLU_ULPS` of the unfused launch followed by PyTorch's SiLU·up,
    beside whose device ms it is timed. Then :func:`moe_rows_paths`, and the
    ``tiny-lfm2`` model (hidden 128, heads of 64, so the kernels launch): a
    forward on the card against the CPU, its launches exactly 2 grouped, one
    gather and one combine a MoE layer and K-attn once an attention layer;
    and the ``moe.experts`` graph contract executed on the card: no host
    sync, those launches."""
    import torch

    from edgellm_tpu_torch.lint.entrypoints import run_moe_contract
    from edgellm_tpu_torch.models import PORT_PRESETS, gemm, init_params
    from edgellm_tpu_torch.models import transformer as tr

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    picks = torch.rand((MOE_TOKENS, MOE_ROUTED), generator=gen, device="cuda").topk(
        MOE_TOP_K, dim=-1).indices
    flat = picks.flatten()
    counts = torch.zeros(MOE_ROUTED, dtype=torch.int64, device="cuda").scatter_add_(
        0, flat, torch.ones_like(flat))[:MOE_HELD]
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    off = offsets.tolist()
    rows = []
    for label, k, n, glu in MOE_SHAPES:
        a = torch.randn((MOE_TOKENS * MOE_TOP_K, k), generator=gen, device="cuda")
        w = torch.randn((MOE_HELD, k, n), generator=gen, device="cuda") * 0.02
        planes = gemm.prepare_grouped_planes(w, glu)
        cols = planes.rows

        def ref(e, lib=False):  # expert e's rows: a @ w (cuBLAS fp32 or float64)
            r0, r1 = off[e], off[e + 1]
            h = a[r0:r1] @ w[e] if lib else a[r0:r1].double() @ w[e].double()
            return _silu_up(h) if glu else h

        # rows past the held experts' (pairs routed elsewhere) stay unwritten
        got = gemm.grouped_gemm_tf32x3(a, planes, offsets, a.new_full((a.shape[0], cols),
                                                                      math.nan))
        torch.cuda.synchronize()
        err = lib_err = 0.0
        for e in range(MOE_HELD):
            if off[e + 1] > off[e]:
                want = ref(e)
                err = max(err, (got[off[e]:off[e + 1]].double() - want).abs().max().item())
                lib_err = max(lib_err, (ref(e, lib=True).double() - want).abs().max().item())
        plain = gemm.grouped_gemm_tf32x3_plain(a, planes, offsets)
        plain_diff = (got[:off[-1]] - plain[:off[-1]]).abs().max().item()
        outside_unwritten = bool(got[off[-1]:].isnan().all())
        fused = {}
        if glu:  # against the unfused launch and PyTorch's SiLU·up on its output
            unfused = gemm.prepare_grouped_planes(w)
            ulps = _ulps_apart(got[:off[-1]], _silu_up(
                gemm.grouped_gemm_tf32x3(a, unfused, offsets)[:off[-1]]))
            fused = {"unfused_max_ulps": ulps, "unfused_device_ms": device_ms(
                lambda: _silu_up(gemm.grouped_gemm_tf32x3(a, unfused, offsets)), 20)}
            del unfused
        torch.cuda.synchronize()
        del got, plain

        def loop():
            for e in range(MOE_HELD):
                ref(e, lib=True)

        ms = device_ms(lambda: gemm.grouped_gemm_tf32x3(a, planes, offsets), 20)
        flops = 2.0 * off[-1] * k * n
        bound_ms = flops / GEMM_PEAK_FLOPS * 1e3
        row = {"shape": label, "experts": MOE_HELD, "m": off[-1], "n": n, "k": k,
               "glu": glu, "out_cols": cols,
               "rows_min": min(counts.tolist()), "rows_max": max(counts.tolist()),
               "kernel_device_ms": ms,
               "kernel_ms": time_ms(lambda: gemm.grouped_gemm_tf32x3(a, planes, offsets), 20),
               "tflops_per_s": flops / ms / 1e9, "bound_ms": bound_ms, "bound_by": "operations",
               "share": bound_ms / ms,
               "plain_ms": time_ms(lambda: gemm.grouped_gemm_tf32x3_plain(a, planes, offsets),
                                   2, warmup=1),
               "library_device_ms": device_ms(loop, 20), "library_ms": time_ms(loop, 20),
               "max_abs_err": err, "library_max_abs_err": lib_err,
               "plain_max_abs_diff": plain_diff, "rows_outside": a.shape[0] - off[-1],
               "outside_unwritten": outside_unwritten, **fused}
        row["library_tflops_per_s"] = flops / row["library_device_ms"] / 1e9
        log(json.dumps({"moe_gemm": row}))
        rows.append(row)
        if err > 3 * lib_err or plain_diff > GEMM_PLAIN_TOL * lib_err \
                or not outside_unwritten or a.shape[0] == off[-1] \
                or fused.get("unfused_max_ulps", 0.0) > MOE_GLU_ULPS:
            raise SystemExit(f"grouped gemm {label}: error {err} (cuBLAS {lib_err}), "
                             f"{plain_diff} from the plain version, rows past the held "
                             f"experts' unwritten: {outside_unwritten}, {fused}")
        del a, w, planes
        torch.cuda.empty_cache()
    tail = moe_rows_paths(picks, args.seed + 1)

    cfg = PORT_PRESETS["tiny-lfm2"]
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), device="cpu")
    ids = torch.from_numpy(np.random.default_rng(args.seed).integers(0, cfg.vocab_size,
                                                                    (4, 128)))
    want, _ = tr.forward(cfg, params, ids)
    on_card = tr.params_to(params, device="cuda")
    tr.forward(cfg, on_card, ids.cuda())  # planes, warm
    torch.cuda.synchronize()
    reset_counts()
    got, _ = tr.forward(cfg, on_card, ids.cuda())
    torch.cuda.synchronize()
    launches = read_counts()
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    attn = len(cfg.attention_layers)
    expect = want_counts(attn, causal_attention=attn, grouped_gemm_tf32x3=2 * moe_layers,
                         gather_rows=moe_layers, combine_rows=moe_layers)
    diff = (got.cpu() - want).abs().max().item()
    findings, contract = run_moe_contract("cuda")
    detail["moe"] = {"rows": rows, "tail": tail, "forward_max_abs_diff": diff,
                     "launches": launches, "contract": contract,
                     "contract_findings": [f.format() for f in findings]}
    log(json.dumps({"moe_model": {k: detail["moe"][k] for k in (
        "forward_max_abs_diff", "contract", "contract_findings")}}))
    if launches_differ(launches, expect) or diff > MOE_CROSS_TOL:
        raise SystemExit(f"tiny-lfm2 on the card: launches {launches} (want {expect}), "
                         f"logits {diff} from the CPU's")
    if findings or not contract.get("host_sync", {}).get("checked"):
        raise SystemExit(f"moe.experts contract on the card: {detail['moe']['contract_findings']}"
                         f" {contract}")
    return rows[0], tail, {"moe tiny-lfm2 forward": launches}


def _gemm_decode(cfg, params, rng, generate, by_path: dict) -> dict:
    """The routing's cuBLAS side on fp32 ``params``: a B = 1 decode of
    :data:`GEMM_DECODE_TOKENS` tokens after an 8-token prompt, every product
    routed to torch.matmul ("small_m") and none to the kernel; beside it one
    decode step's products (7 a layer and the unembed, M = 1) timed through
    the kernel and through cuBLAS, device ms summed over the step."""
    import torch

    from edgellm_tpu_torch.models import gemm
    from edgellm_tpu_torch.models import transformer as tr

    prompt = rng.integers(0, cfg.vocab_size, (1, 8))
    generate(cfg, params, prompt, 2)  # warm-up
    torch.cuda.synchronize()
    routed = dict(tr.linear.routed)
    reset_counts()
    t0 = time.monotonic()
    generate(cfg, params, prompt, GEMM_DECODE_TOKENS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    by_path["gemm decode-fp32"] = launches = read_counts()
    row = {"tokens": GEMM_DECODE_TOKENS, "wall_ms_per_token": wall * 1e3 / GEMM_DECODE_TOKENS,
           "launches": launches["gemm_tf32x3"],
           "routed": {r: tr.linear.routed[r] - routed[r] for r in routed}}
    layer = [(params["layers"][0][name], cfg.num_layers)
             for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    kernel_ms = lib_ms = 0.0
    for w, layers in layer + [(head, 1)]:
        k, n = w.shape
        a = torch.randn((1, k), device="cuda")
        planes, n0 = tr.prepared_planes(w)
        kernel_ms += layers * device_ms(lambda: gemm.gemm_tf32x3(a, planes, n0, n), 20)
        lib_ms += layers * device_ms(lambda: a @ w, 20)
    row.update(step_products_kernel_device_ms=kernel_ms, step_products_library_device_ms=lib_ms)
    log(json.dumps({"gemm_decode": row}))
    if row["launches"] or not row["routed"]["small_m"] or row["routed"]["bf16"]:
        raise SystemExit(f"gemm decode: fp32 decode products not all left to cuBLAS: {row}")
    return row


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
    from edgellm_tpu_torch.models import gemm, moe

    return {"causal_attention": fa.causal_attention,
            "causal_attention_stats": fa.causal_attention_stats,
            "int4_encode": ck.int4_encode, "int4_decode": ck.int4_decode,
            "int8_affine_encode": ck.int8_affine_encode,
            "int8_affine_decode": ck.int8_affine_decode,
            "chan_int8_encode": ck.chan_int8_encode, "chan_int8_decode": ck.chan_int8_decode,
            "chan_int4_encode": ck.chan_int4_encode, "ternary_encode": ck.ternary_encode,
            "ternary_decode": ck.ternary_decode, "remote_hop": fh.remote_hop,
            "paged_decode_attention": fa.paged_decode_attention,
            "paged_decode_attention_quant": fa.paged_decode_attention_quant,
            "gemm_tf32x3": gemm.gemm_tf32x3,
            "grouped_gemm_tf32x3": gemm.grouped_gemm_tf32x3,
            "gather_rows": moe.gather_rows, "combine_rows": moe.combine_rows}


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
    want = dict.fromkeys((k for k in KERNELS if k not in READ_ONLY_KERNELS), 0)
    want.update(launches)
    want["causal_attention float32"] = fp32_attn
    want["causal_attention bfloat16"] = want["causal_attention"] - fp32_attn
    return want


def launches_differ(got: dict, want: dict) -> bool:
    """Whether two launch counts differ in a kernel a path predicts (every
    one but :data:`READ_ONLY_KERNELS`)."""
    def held(counts):
        return {k: v for k, v in counts.items() if k not in READ_ONLY_KERNELS}

    return held(got) != held(want)


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
    if launches_differ(launches, want):
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
    Before the sweep the CLI's memory preflight (a window batch above 1 on
    the card) probes the stats prefix with its continuation and the
    earliest layer's suffix once at each of its probe batches. The CLI's
    weights are fp32: every attention launch is fp32."""
    from edgellm_tpu_torch.tools.wb_preflight import PROBE_BATCHES

    layers = params_json["layers_of_interest"]
    deepest = max(layers)
    n_methods = len(params_json["methods"])
    zero = any(float(r) == 0.0 for r in params_json["ratios"])
    suffix = sum(cfg.num_layers - 1 - layer for layer in layers) * n_methods
    tail = cfg.num_layers - 1 - deepest if zero else 0  # the ratio-0 continuation
    probes = len(PROBE_BATCHES)
    attn = (suffix + tail) * n_groups + probes * (
        cfg.num_layers - 1 - min(layers) + cfg.num_layers - 1 - deepest)
    return want_counts(attn, causal_attention=attn,
                       causal_attention_stats=(deepest + 1) * (n_groups + probes))


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
        if launches_differ(launches, want) \
                or stats_by_dtype["float32"] != want["causal_attention_stats"] \
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
        if launches_differ(launches, want):
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
        if launches_differ(launches, want_counts()):
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
    if launches_differ(launches, want) \
            or stats_by_dtype["float32"] != want["causal_attention_stats"]:
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
#: the depth of phase 15's two split11 runs through ``run.main`` (cut 11
#: needs 13 layers), registered for the run as a preset of Qwen2-0.5B's
#: width: the shallowest split11, to keep the whole smoke run near its
#: length before phase 21
SPLIT11_LAYERS = 13
SPLIT11_PRESET = f"qwen2-0.5b-{SPLIT11_LAYERS}l"
#: teacher-forced split-decode and verify logits, card vs CPU (absolute, as
#: phase 13 holds serve): an fp32 hop, and an int8 hop, where a row that
#: rounds on a .5 boundary may move one code by a step
SPLIT_DECODE_TOL = {"fp32": 1e-4, "int8_per_token": 1e-3}
#: fused vs separate hop's teacher-forced logits on the card: both decode the
#: same bytes
FUSED_DECODE_ATOL = 1e-5


@contextlib.contextmanager
def split_call_log():
    """Count the split decode calls made inside that returned:
    ``prefill_decode``, ``decode_step``, ``verify_step`` and
    ``decode_step_paged`` of every ``SplitRuntime`` (a call that raised,
    such as one into a dark stage, launched nothing and is not counted), with
    the int8 per-token hops they encoded and the copies they decoded (under
    a faulty link from the runtime's counters: a hop encodes once and
    decodes ``1 + retried`` copies; else one of each a cut), the local ``generate``
    prefills (``decode._prefill_impl``), and the ``speculative`` stats of
    every burst-loop call (a stats dict is handed to calls made without
    one) -> the log dict."""
    import inspect

    from edgellm_tpu_torch.parallel.split import SplitRuntime
    from edgellm_tpu_torch.serve import decode, speculative

    log_ = {"prefill_decode": 0, "decode_step": 0, "verify_step": 0, "decode_step_paged": 0,
            "local_prefill": 0, "encodes": 0, "decodes": 0, "spec_calls": []}
    saved = {name: getattr(SplitRuntime, name)
             for name in ("prefill_decode", "decode_step", "verify_step", "decode_step_paged")}
    real_prefill, real_loop = decode._prefill_impl, speculative._spec_loop
    loop_sig = inspect.signature(real_loop)

    def counted(name):
        def call(self, *a, **kw):
            before = self.link_counters()
            out = saved[name](self, *a, **kw)
            log_[name] += 1
            after = self.link_counters()
            for i, codec in enumerate(self.codecs):
                if not codec.name.startswith("int8_per_token"):
                    continue  # K3 / K4 run only under the int8 per-token hops
                hops = 1 if before is None else int(after["hops"][i] - before["hops"][i])
                retried = 0 if before is None else int(after["retried"][i]
                                                       - before["retried"][i])
                log_["encodes"] += hops
                log_["decodes"] += hops + retried
            return out
        return call

    def local_prefill(*a, **kw):
        log_["local_prefill"] += 1
        return real_prefill(*a, **kw)

    def spec_loop(*a, **kw):
        bound = loop_sig.bind(*a, **kw)
        if bound.arguments.get("stats") is None:
            bound.arguments["stats"] = {}
        out = real_loop(*bound.args, **bound.kwargs)
        log_["spec_calls"].append(bound.arguments["stats"]["speculative"])
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
    Qwen2-0.5B width, fp32 weights from ``--seed``: (a)
    configs/split11_qwen_spec.json through ``run.main`` at
    :data:`SPLIT11_LAYERS` layers (a preset registered for the run), (b) the
    same without ``speculative`` (the vanilla per-request split route), each with
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
    base = ["--model", SPLIT11_PRESET, "--seed", str(args.seed)]
    out, rows = {}, {}

    # (a), (b): the CLI, speculative and vanilla, at SPLIT11_LAYERS layers
    vanilla = {key: v for key, v in p11.items() if key != "speculative"}
    L = SPLIT11_LAYERS
    for label, p in (("split11 speculative", p11), ("split11 vanilla", vanilla)):
        PRESETS[SPLIT11_PRESET] = dataclasses.replace(cfg, num_layers=L)
        try:
            printed, report, calls = _split11_cli(base, p, label, rows)
        finally:
            del PRESETS[SPLIT11_PRESET]
        rows[label]["layers"] = L
        n = p["serving"]["soak"]["n_requests"]
        row = rows[label]
        spec = calls["spec_calls"]
        bursts = sum(c["bursts"] for c in spec)
        hops = calls["prefill_decode"] + calls["decode_step"] + calls["verify_step"]
        want = want_counts(
            L * calls["prefill_decode"] + draft_layers * len(spec) + L * calls["local_prefill"],
            causal_attention=(L * calls["prefill_decode"] + draft_layers * len(spec)
                              + L * calls["local_prefill"]),
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
        if launches_differ(row["launches"], want):
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
        if launches_differ(launches, want):
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


def _split_serve_expected(cfg, rep: dict, n_cuts: int, kv_codec: str, remote: bool,
                          m: int = 1) -> tuple:
    """The launches a split-paged serve run implies, and the warm batcher's
    share (one prefill and one step) apart: 24 K13 / K14 a ragged step and
    24 fp32 K-attn a split prefill (a prefix hit's suffix runs verify_step's
    plain attention, a resume adopts rows); each cut one hop (K3 + K4, or K8
    under "remote") a step, a prefill and a prefix hit's suffix. Under a
    pipeline of ``m`` µ-batches a ragged step runs K13 and each cut's hop
    once a µ-batch (the prefills stay sequential)."""
    hits = rep.get("prefix", {}).get("hits", 0)
    prefills = rep["admitted"] - rep["evicted"] - hits
    attn = "paged_decode_attention" if kv_codec == "fp" else "paged_decode_attention_quant"

    def counts(steps, prefills, hits):
        hops = n_cuts * (m * steps + prefills + hits)
        codec = ({"remote_hop": hops} if remote else
                 {"int8_affine_encode": hops, "int8_affine_decode": hops})
        return want_counts(cfg.num_layers * prefills, causal_attention=cfg.num_layers * prefills,
                           **{attn: cfg.num_layers * m * steps}, **codec)

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
        if launches_differ(launches, want):
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
        plain = getattr(fa, name + "_plain")
        pkw = {k: v for k, v in kw.items() if k != "plan"}
        sdpa = paged_sdpa(a, kv_codec)  # the library yardstick, as phase 10's
        reads[f"{name} {kv_codec} item 30"] = {
            "slots": w, "page_size": KV_TIER_FULL["page_size"], "pages_per_slot": pps,
            "kernel_device_ms": k_dev, "recorded": recorded, "bound_ms": bound,
            "bound_by": bound_by, "roofline_share": bound / k_dev,
            "plain_ms": time_ms(lambda: plain(*a, **pkw), 10),
            "library_event_ms": time_ms(sdpa, 50),
            "library": "SDPA (enable_gqa) over the gathered span, length mask"}
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
    if bad or launches_differ(launches, want):
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
                        or launches_differ(launches, want):
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
                if launches_differ(launches, want):
                    raise SystemExit(f"{label}: kernel launches {launches} != expected {want}")
            else:  # no link: the gate plans the hop ("auto": the cache's verdict)
                plan = _plan_mode(p)
                row["plan"] = None if plan is None else plan.mode
                want = want_counts(cfg.num_layers * groups,
                                   causal_attention=cfg.num_layers * groups,
                                   **_int8_hop_counts(row["plan"], groups))
                row["launches_expected"] = want
                if launches_differ(launches, want):
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
    cut_params = {**full_params, "layers": full_params["layers"][:LINK_CROSS_LAYERS]}
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


#: phase 18's shipped configs, and the split eval's chunks and window batch
#: (the loss at chunk 4 lands on the second of six groups)
SPLIT8_CONFIG, SPLIT6F_CONFIG = "configs/split8_qwen_serve.json", "configs/split6_qwen_failover.json"
SURV_CHUNKS, SURV_WB = 24, 4
#: split8 replayed card against CPU at Qwen2-0.5B width and this depth, its
#: cuts moved inside (a soak's virtual clock follows the measured service
#: time: at equal depth both devices serve in tens of ms, so the same
#: requests meet the kill and the breakers on both)
SURV_SMALL_LAYERS, SURV_SMALL_CUTS = 6, [1, 3]
#: split6's failover card against CPU: 17 layers hold cut 15, 5 chunks two
#: groups (four windows before the loss, one after)
SURV_CROSS_LAYERS, SURV_CROSS_CHUNKS = 17, 5
#: split9 with the link: the CPU's counters at this depth, its one cut moved
#: inside (the counters depend on the keys, the schedule and the payload
#: width, not on the depth or where the one cut sits)
SURV_SPLIT9_CPU_LAYERS, SURV_SPLIT9_CPU_CUTS = 4, [1]
#: split8's plan for the recovery drills (fp32 hops, so a re-planned split
#: decodes the same tokens as the lost one) and split8's link
SURV_DRILL_PLAN = ((11, 17), ("fp32", "fp32"))
#: decode steps a wall reading of phase 18 times (four readings, in turns)
STEP_READS = 20


def _surv_counts(calls: dict, n_layers: int, draft_layers: int = 0) -> dict:
    """The launches a logged run of split calls implies (fp32): K-attn at
    every layer of each split and local prefill (``draft_layers`` of each
    burst loop's draft prefill), K3 once a hop encoded, K4 once a copy
    decoded, K13 at every layer of each ragged step."""
    attn = (n_layers * (calls["prefill_decode"] + calls["local_prefill"])
            + draft_layers * len(calls["spec_calls"]))
    return want_counts(attn, causal_attention=attn, int8_affine_encode=calls["encodes"],
                       int8_affine_decode=calls["decodes"],
                       paged_decode_attention=n_layers * calls["decode_step_paged"])


def _small_model(cfg, params, n_layers: int):
    """The first ``n_layers`` of a model (views of the same weights)."""
    small = dataclasses.replace(cfg, num_layers=n_layers)
    return small, {**params, "layers": params["layers"][:n_layers]}


def survivable_paths(args, detail: dict, device: str = "cuda",
                     model: str = "qwen2-0.5b") -> dict:
    """Phase 18: survivable serving, fp32 weights from ``--seed`` (the CLI's
    default), full Qwen2-0.5B width and depth. (1) configs/split8_qwen_serve.json
    as shipped through ``run.main --serve-report``: every request accounted
    for, the kill of stage 1 at request 12 and the failover onto cut 11
    printed, K-attn / K3 / K4 launched exactly as the logged calls and the
    link's counters imply; the same soak at :data:`SURV_SMALL_LAYERS` layers
    on the card and the CPU with the same weights: outcomes, reasons, link
    counters, identity counts and every request's tokens equal. (2)
    configs/split6_qwen_failover.json as shipped through ``run.main
    --fault-report`` (:data:`SURV_CHUNKS` chunks, window batch
    :data:`SURV_WB`): the recovery block (one failover and re-plan onto cut
    11), K3 / K4 two a group before the loss and one after; card against CPU
    at :data:`SURV_CROSS_LAYERS` layers (recovery block equal, PPL within
    :data:`SPLIT_CROSS_RTOL`). (3) ``generate_split`` with a
    ``RecoveryConfig`` over split8's cuts and link (fp32 hops): periodic
    checkpoints, ``halt_at_step`` then ``resume_split``, a ``StageFailure``
    at step 3, the speculative halt and resume, each with the uninterrupted
    run's tokens. (4) split9 with cut 11 and split8's link inline through
    ``run.main`` (mode "batched_split"), its counters equal a CPU run at
    :data:`SURV_SPLIT9_CPU_LAYERS` layers; a stream checkpointed at split14's int4 tier and
    restored into a fresh batcher: pages bit for bit, K14 launched, the
    uninterrupted tokens. (5) readings: ms a decode step with and without
    the link, idle share, copies a hop -> launches by path."""
    import argparse as ap
    import tempfile

    import torch

    from edgellm_tpu_torch import run
    from edgellm_tpu_torch.codecs.faults import FaultConfig, LinkPolicy
    from edgellm_tpu_torch.eval import run_split_eval
    from edgellm_tpu_torch.models import PRESETS, params_to
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
    from edgellm_tpu_torch.serve import batching as sb
    from edgellm_tpu_torch.serve import recovery as rc_mod
    from edgellm_tpu_torch.serve.decode import generate_split, resume_split
    from edgellm_tpu_torch.serve.speculative import SpecConfig
    from edgellm_tpu_torch.utils import prng

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out, rows, part_s = {}, {}, {}
    t_part = [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        part_s[name] = now - t_part[0]
        t_part[0] = now
    cfg = PRESETS[model]
    layers = cfg.num_layers
    base = ["--model", model, "--seed", str(args.seed), "--device", device]
    with open(SPLIT8_CONFIG) as f:
        p8 = json.load(f)
    if model != "qwen2-0.5b":  # a CPU rehearsal at tiny depth
        p8["cuts"] = SURV_SMALL_CUTS
    link = dict(faults=FaultConfig(**p8["faults"]), policy=LinkPolicy(**p8["link_policy"]))
    _, params = run._load_model(ap.Namespace(weights=None, model=model, seed=args.seed),
                                torch.device(device))

    # (1) split8 as shipped, through the CLI
    with tempfile.TemporaryDirectory() as tmp, split_call_log() as calls:
        path = os.path.join(tmp, "split8.json")
        with open(path, "w") as f:
            json.dump(p8, f)
        sync()
        reset_counts()
        t0 = time.monotonic()
        code, lines = _cli_run(["--params", path, "--output-dir", tmp, "--serve-report"] + base)
        sync()
        wall = time.monotonic() - t0
        launches = read_counts()
        with open(os.path.join(tmp, "serve_report.json")) as f:
            art = json.load(f)
    printed, report = json.loads(lines[0]), art["report"]
    want = _surv_counts(calls, layers)
    for line in lines[1:]:
        log(f"  split8: {line}")
    plan_line = next((line for line in lines if line.startswith("  plan ")), "")
    replanned = f"cuts={[round(cfg.num_layers / 2) - 1]}"
    row = {"rc": code, "wall_s": wall, "printed": printed, "kill": art["kill"],
           "failovers": report["failovers"], "reasons": report["reasons"],
           "link_counters": report.get("link_counters"), "identity": art["token_identity"],
           "calls": {k: v for k, v in calls.items() if k != "spec_calls"},
           "launches": launches, "launches_expected": want, "plan_line": plan_line}
    lc = report.get("link_counters") or {}
    row["copies_per_hop"] = (lc["hops"] + lc["retried"]) / lc["hops"] if lc.get("hops") else None
    rows["split8"] = row
    log(json.dumps({"survivable_split8": {k: v for k, v in row.items()
                                          if k not in ("launches_expected",)}}))
    if code != 0 or printed["requests"] != 24 or sum(printed["outcomes"].values()) != 24:
        raise SystemExit(f"split8: rc {code}, not every request accounted for: {printed}")
    if report["failovers"] < 1 or (art["kill"] or {}).get("stage") != 1 \
            or replanned not in plan_line:
        raise SystemExit(f"split8: no kill / failover onto {replanned}: kill {art['kill']}, "
                         f"failovers {report['failovers']}, plan {plan_line!r}")
    if not lc.get("hops"):
        raise SystemExit(f"split8: the front counted no link hops: {report}")
    if on_card and launches_differ(launches, want):
        raise SystemExit(f"split8: kernel launches {launches} != expected {want}")
    out["split8 serve"] = launches
    lap("split8 cli")

    # split8 at SURV_SMALL_LAYERS layers on the card and the CPU, same weights
    small_cfg, small = _small_model(cfg, params, SURV_SMALL_LAYERS)
    p_small = {**p8, "cuts": SURV_SMALL_CUTS}
    replays = {}
    for dev in ((device, "cpu") if on_card else ("cpu",)):
        with tempfile.TemporaryDirectory() as tmp:
            res = run.run_serve_requests(small_cfg, params_to(small, device=dev), p_small,
                                         lambda name, tmp=tmp: os.path.join(tmp, name))
        a = res["_artifact"]
        replays[dev] = {"outcomes": a["outcomes"], "reasons": a["report"]["reasons"],
                        "failovers": a["report"]["failovers"],
                        "link_counters": a["report"].get("link_counters"),
                        "identity": {k: a["token_identity"][k] for k in ("checked", "matched")},
                        "tokens": a["tokens"]}
    first = replays[device]
    rows["split8 small card vs cpu"] = {d: {k: v for k, v in r.items() if k != "tokens"}
                                        for d, r in replays.items()}
    log(json.dumps({"survivable_split8_cross": rows["split8 small card vs cpu"]}))
    for key in first:
        if replays["cpu"][key] != first[key]:
            raise SystemExit(f"split8 at {SURV_SMALL_LAYERS} layers: {key} differ, card "
                             f"{first[key]} vs CPU {replays['cpu'][key]}")
    del small
    lap("split8 card vs cpu")

    # (2) split6 failover as shipped, through the CLI
    with open(SPLIT6F_CONFIG) as f:
        p6 = json.load(f)
    if model != "qwen2-0.5b":
        p6["cuts"] = SURV_SMALL_CUTS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "split6.json")
        with open(path, "w") as f:
            json.dump(p6, f)
        sync()
        reset_counts()
        t0 = time.monotonic()
        code, lines = _cli_run(["--params", path, "--output-dir", tmp,
                                "--max-chunks", str(SURV_CHUNKS), "--window-batch", str(SURV_WB),
                                "--fault-report"] + base)
        sync()
        wall = time.monotonic() - t0
        launches = read_counts()
    res6 = json.loads(lines[0])
    groups = math.ceil(SURV_CHUNKS / SURV_WB)
    lost_group = p6["stage_failure"]["at_step"] // SURV_WB
    hops = 2 * lost_group + 1 * (groups - lost_group) + HOP_ITERS
    want = want_counts(layers * groups, causal_attention=layers * groups,
                       int8_affine_encode=hops, int8_affine_decode=hops)
    rec = res6.get("recovery") or {}
    rows["split6 failover"] = {"rc": code, "wall_s": wall, "chunks": res6["chunks"],
                               "ppl": res6["ppl"], "recovery": rec, "report": lines[1:],
                               "launches": launches, "launches_expected": want,
                               "s_per_chunk": res6["wall_s"] / max(res6["chunks"], 1)}
    log(json.dumps({"survivable_split6": rows["split6 failover"]}))
    counters = rec.get("counters", {})
    if code != 0 or res6["chunks"] != SURV_CHUNKS or not np.isfinite(res6["ppl"]) \
            or counters.get("failovers") != 1 or counters.get("replans") != 1 \
            or rec.get("replanned_cuts") != [round(cfg.num_layers / 2) - 1]:
        raise SystemExit(f"split6 failover: rc {code}, {res6['chunks']} chunks, recovery {rec}")
    if on_card and launches_differ(launches, want):
        raise SystemExit(f"split6 failover: kernel launches {launches} != expected {want}")
    out["split6 failover"] = launches
    lap("split6 cli")
    cross_cfg, cross = _small_model(cfg, params, min(SURV_CROSS_LAYERS, layers))
    corpus = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, CLI_CORPUS_LEN)
    kw = dict(cuts=p6["cuts"], hop_codecs=p6["hop_codecs"], max_length=p6["max_length"], stride=p6["stride"],
              window_batch=SURV_WB, max_chunks=SURV_CROSS_CHUNKS, time_hops=False,
              deadline_s=p6["deadline"], stage_failure=p6["stage_failure"],
              recovery=p6["recovery"])
    got = {dev: run_split_eval(cross_cfg, params_to(cross, device=dev), corpus, device=dev, **kw)
           for dev in ((device, "cpu") if on_card else ("cpu",))}
    rel = abs(got[device]["ppl"] - got["cpu"]["ppl"]) / got["cpu"]["ppl"]
    rows["split6 failover card vs cpu"] = {
        "layers": cross_cfg.num_layers, "card_ppl": got[device]["ppl"],
        "cpu_ppl": got["cpu"]["ppl"], "rel": rel, "recovery": got["cpu"]["recovery"]}
    log(json.dumps({"survivable_split6_cross": rows["split6 failover card vs cpu"]}))
    # the re-planned codecs by the names each device runs (the twin's on the
    # card), the rest of the block exactly
    plain = lambda r: {**r, "failover_hop_codecs": [  # noqa: E731
        c.replace("_pallas", "") for c in r["failover_hop_codecs"]]}
    if plain(got[device]["recovery"]) != plain(got["cpu"]["recovery"]) \
            or rel > SPLIT_CROSS_RTOL or got[device]["n_tokens"] != got["cpu"]["n_tokens"]:
        raise SystemExit(f"split6 failover card vs CPU: {rows['split6 failover card vs cpu']}, "
                         f"card recovery {got[device]['recovery']}")
    del cross
    lap("split6 card vs cpu")

    # (3) generate_split's recovery drills over split8's cuts and link
    drill = SplitConfig(SURV_DRILL_PLAN[0] if model == "qwen2-0.5b" else tuple(SURV_SMALL_CUTS),
                        SURV_DRILL_PLAN[1])
    rng = np.random.default_rng(args.seed + 18)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8))
    new = p8["serving"]["soak"]["max_new_tokens"]
    kw = dict(capacity=24, temperature=0.7, rng_key=prng.key(3), raw_params=params)
    drills = {}
    with tempfile.TemporaryDirectory() as tmp, split_call_log() as calls:
        reset_counts()
        rt = SplitRuntime(cfg, drill, [device] * 3, **link)
        placed = rt.place_params(params)
        clean = generate_split(rt, placed, prompt, new, **kw).cpu()
        stats = {}
        periodic = generate_split(rt, placed, prompt, new, stats=stats, **kw,
                                  recovery=rc_mod.RecoveryConfig(
                                      checkpoint_path=os.path.join(tmp, "p.ckpt"),
                                      checkpoint_every=3)).cpu()
        halt_path = os.path.join(tmp, "h.ckpt")
        part = generate_split(rt, placed, prompt, new, **kw, recovery=rc_mod.RecoveryConfig(
            checkpoint_path=halt_path, halt_at_step=3)).cpu()
        resumed = resume_split(rt, placed, halt_path).cpu()
        drills["periodic"] = torch.equal(periodic, clean)
        drills["halt_prefix"] = torch.equal(part, clean[:, :4])
        drills["resume"] = torch.equal(resumed, clean)
        ck = rc_mod.DecodeCheckpoint.load(halt_path)
        drills["checkpoint_codecs"] = ck.meta["hop_codecs"]
        drills["checkpoints_written"] = stats["recovery_counters"]["checkpoints_written"]
        fail_rt = SplitRuntime(cfg, drill, [device] * 3, **link)
        fstats = {}
        failed = generate_split(fail_rt, fail_rt.place_params(params), prompt, new, stats=fstats,
                                **kw, recovery=rc_mod.RecoveryConfig(
                                    stage_failure=rc_mod.StageFailure(stage=2, at_step=3))).cpu()
        drills["stage_failure"] = torch.equal(failed, clean)
        drills["recovery_counters"] = fstats["recovery_counters"]
        spec = SpecConfig(k=4)
        skw = {**kw, "speculative": spec}
        spec_clean = generate_split(rt, placed, prompt[:1], new, **skw).cpu()
        spec_path = os.path.join(tmp, "s.ckpt")
        generate_split(rt, placed, prompt[:1], new, **skw, recovery=rc_mod.RecoveryConfig(
            checkpoint_path=spec_path, halt_at_step=3))
        spec_resumed = resume_split(rt, placed, spec_path, speculative=spec,
                                    raw_params=params).cpu()
        drills["spec_resume"] = torch.equal(spec_resumed, spec_clean)
        sync()
        launches = read_counts()
    want = _surv_counts(calls, layers, draft_layers=drill.cuts[0] + 1)
    drills.update(launches=launches, launches_expected=want,
                  calls={k: v for k, v in calls.items() if k != "spec_calls"})
    rows["recovery drills"] = drills
    log(json.dumps({"survivable_drills": {k: v for k, v in drills.items()
                                          if k != "launches_expected"}}))
    if not all(drills[k] for k in ("periodic", "halt_prefix", "resume", "stage_failure",
                                   "spec_resume")) \
            or drills["recovery_counters"]["failovers"] != 1 \
            or drills["recovery_counters"]["recompute_tokens"] != 2 * (8 + 3):
        raise SystemExit(f"recovery drills: {drills}")
    if on_card and launches_differ(launches, want):
        raise SystemExit(f"recovery drills: kernel launches {launches} != expected {want}")
    out["generate_split recovery"] = launches
    del rt, fail_rt, placed
    lap("recovery drills")

    # (4) split9 with cut 11 and split8's link inline, through the CLI; the
    # counters against the CPU's with the same weights
    with open("configs/split9_qwen_paged.json") as f:
        p9 = json.load(f)
    p9.update(cuts=[round(cfg.num_layers / 2) - 1], hop_codecs=["int8_per_token"],
              faults=p8["faults"], link_policy=p8["link_policy"])
    with tempfile.TemporaryDirectory() as tmp, split_call_log() as calls:
        sync()
        reset_counts()
        code, lines = _cli_run(["--params", json.dumps(p9), "--output-dir", tmp] + base)
        sync()
        launches = read_counts()
        with open(os.path.join(tmp, "serve_report.json")) as f:
            rep9 = json.load(f)["batcher"]
    want = _surv_counts(calls, layers)
    lap("split9 cli")
    cpu_cfg, cpu_params = _small_model(cfg, params, min(SURV_SPLIT9_CPU_LAYERS, layers))
    with tempfile.TemporaryDirectory() as tmp:
        cpu9 = run.run_serve(cpu_cfg, params_to(cpu_params, device="cpu"),
                             {**p9, "cuts": SURV_SPLIT9_CPU_CUTS},
                             lambda name: os.path.join(tmp, name))["_batcher"]
    lap("split9 cpu")
    rows["split9 link"] = {"rc": code, "printed": json.loads(lines[-1]),
                           "link_counters": rep9.get("link_counters"),
                           "cpu_link_counters": cpu9.get("link_counters"), "steps": rep9["steps"],
                           "launches": launches, "launches_expected": want}
    log(json.dumps({"survivable_split9_link": {k: v for k, v in rows["split9 link"].items()
                                               if k != "launches_expected"}}))
    if code != 0 or json.loads(lines[-1])["outcomes"] != {"completed": 24} \
            or not rep9.get("link_counters") or rep9["link_counters"] != cpu9["link_counters"]:
        raise SystemExit(f"split9 with the link: {rows['split9 link']}")
    if on_card and launches_differ(launches, want):
        raise SystemExit(f"split9 with the link: kernel launches {launches} != expected {want}")
    out["split9 link serve"] = launches

    # a stream at split14's int4 tier checkpointed and restored (K14)
    with open("configs/split14_qwen_kvq.json") as f:
        p14 = json.load(f)
    p14.update(cuts=p9["cuts"], hop_codecs=p9["hop_codecs"])
    bcfg = run.batching_config(cfg, p14)
    srt = SplitRuntime(cfg, SplitConfig(tuple(p14["cuts"]), tuple(p14["hop_codecs"])),
                       [device] * 2, **link)
    splaced = srt.place_params(params)
    prompts = [rng.integers(1, cfg.vocab_size, 72).astype(np.int32) for _ in range(3)]

    def batcher():
        b = sb.ContinuousBatcher(cfg, params, bcfg, split_runtime=srt, placed_params=splaced)
        return b, [b.submit(pr, 8, temperature=0.7, rng_seed=40 + i)
                   for i, pr in enumerate(prompts)]

    b, sids = batcher()
    want_toks = b.run()
    b, sids = batcher()
    for _ in range(3):
        b.step()
    state = b._gather_state(b._streams[sids[1]].slot)
    with tempfile.TemporaryDirectory() as tmp:
        path = b.checkpoint_stream(sids[1], os.path.join(tmp, "stream.ckpt"))
        other = sb.ContinuousBatcher(cfg, params, bcfg, split_runtime=srt,
                                     placed_params=splaced)
        sid = other.restore_stream(path)
    reset_counts()
    other.step()
    sync()
    step_launches = read_counts()
    n = int(state["length"])
    idx = other.pool._flat_indices(other._streams[sid].slot, n)
    restored = srt.gather_paged_packed(other._split_pool, idx)
    pages_equal = all(np.array_equal(g[:, :, :n], state[k]) for g, k in
                      zip(restored, ("k_codes", "v_codes", "k_scale", "v_scale")))
    tokens_equal = np.array_equal(other.run()[sid], want_toks[sids[1]])
    rows["int4 stream restore"] = {"pages_equal": pages_equal, "tokens_equal": tokens_equal,
                                   "length": n, "step_launches": step_launches}
    log(json.dumps({"survivable_int4_restore": rows["int4 stream restore"]}))
    if not (pages_equal and tokens_equal) or (
            on_card and step_launches["paged_decode_attention_quant"] != layers):
        raise SystemExit(f"int4 stream restore: {rows['int4 stream restore']}")
    out["int4 stream restore step"] = step_launches
    del b, other, srt, splaced
    lap("int4 restore")

    # (5) a decode step with and without split8's link, one call: the wall
    # of STEP_READS steps in turns (clean, link, link, clean), then one
    # short profile of each for the idle share and the kernels a step
    if on_card:
        plan = SplitConfig(tuple(p8["cuts"]), tuple(p8["hop_codecs"]))
        ids = torch.from_numpy(prompt[:1]).to(device)
        tok = ids[:, -1]
        reads, steps = {}, {}
        for name, kw_rt in (("clean", {}), ("link", link)):
            rt = SplitRuntime(cfg, plan, [device] * 3, **kw_rt)
            placed = rt.place_params(params)
            _, cache = rt.prefill_decode(placed, ids, 24)
            steps[name] = (lambda rt=rt, placed=placed, cache=cache:
                           rt.decode_step(placed, cache, tok))
            steps[name]()  # warm
            reads[name] = {"wall_ms_per_step": []}
        for name in ("clean", "link", "link", "clean"):
            sync()
            t0 = time.monotonic()
            for _ in range(STEP_READS):
                steps[name]()
            sync()
            reads[name]["wall_ms_per_step"].append((time.monotonic() - t0) * 1e3 / STEP_READS)
        for name in ("clean", "link"):
            prof = profile_kinds(steps[name], 5)
            reads[name].update({k: prof[k] for k in (
                "device_busy_ms_per_call", "kernels_per_call", "idle_share",
                "device_ms_by_kind_per_call")}, profiled_wall_ms_per_call=prof["wall_ms_per_call"])
            log(json.dumps({"survivable_step_read": {name: reads[name]}}))
        rows["decode step reads"] = reads
        lap("decode step reads")
    rows["part_s"] = part_s
    log(json.dumps({"survivable_part_s": part_s}))
    detail["survivable"] = rows
    del params
    if on_card:
        torch.cuda.empty_cache()
    return out


#: phase 19's shipped config and its split eval: 21 chunks at window batch
#: 8 are groups of 8, 8 and 5 (the tail padded to 8: 2 rows a µ-batch)
SPLIT12_CONFIG = "configs/split12_qwen_pipeline.json"
PIPE_CHUNKS, PIPE_WB = 21, 8
#: pipelined generate_split: batch, µ-batches, prompt and new tokens; the
#: card against the CPU at this depth (split12's cuts moved inside)
PIPE_DECODE = dict(batch=4, m=4, prompt=8, new=12)
PIPE_SMALL_LAYERS, PIPE_SMALL_CUTS = 6, [1, 3]
#: the split-paged batcher with a pipeline: split9's geometry (max_slots 6)
#: with split1's cut and two µ-batches
PIPE_SERVE = {"cuts": [11], "hop_codecs": ["int8_per_token"], "pipeline": {"num_microbatches": 2}}
#: the span names a split eval's trace holds: the reference's, and the
#: port's own phases of the call (``obs/names.py`` PORT_SPAN_NAMES)
EVAL_SPANS = {"eval.submit_group", "eval.drain_group", "eval.checkpoint_write",
              "eval.time_hops", "eval.time_decode_hops", "split.hop",
              "eval.call", "split.stage", "split.cross", "split.unembed", "eval.nll"}
#: decode steps a wall reading of phase 19 times (four readings, in turns)
PIPE_STEP_READS = 12


def _prom_parse(text: str) -> dict:
    """Prometheus text -> {family: kind}; raises on a line that does not
    parse (a sample outside a declared family, a value that is no float)."""
    kinds: dict = {}
    for line in text.strip().splitlines():
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, fam, kind = line.split()
            kinds[fam] = kind
            continue
        name, value = line.split("{")[0].split()[0], line.rsplit(" ", 1)[1]
        float(value)
        if not any(name == f or name.startswith(f + "_") for f in kinds):
            raise SystemExit(f"metrics: sample {line!r} outside a declared family")
    return kinds


def pipeline_paths(args, detail: dict, device: str = "cuda",
                   model: str = "qwen2-0.5b") -> dict:
    """Phase 19: the µ-batch pipeline and the observability it reports
    through, fp32 weights from ``--seed`` (the CLI's default), full
    Qwen2-0.5B width and depth. (1) configs/split12_qwen_pipeline.json as
    shipped through ``run.main`` (:data:`PIPE_CHUNKS` chunks, window batch
    :data:`PIPE_WB`: 2 rows a µ-batch) and beside it the same cuts and
    codecs with ``pipeline`` removed, in turns (pipelined, plain, plain,
    pipelined): s/chunk, PPL within :data:`SPLIT_CROSS_RTOL`, launches
    exactly 24 · M K-attn and 2 · M K3 / K4 a group (1 · 24 and 2 unpipelined)
    plus the timed hops, bytes per token per hop, the summary, and one
    group of each profiled (idle share). (2) split12 with split6's link
    inline through ``--fault-report``: the (M, 2) µ-batch counters sum to
    ``link_counters``. (3) ``fused_hops: "remote"``: K8 2 · M a group; one
    pipelined forward with ``int4_per_token`` hops: K1 / K2 2 · M. (4)
    ``generate_split`` at B = 4, M = 4 on split12's cuts, greedy: tokens
    equal the unpipelined run's and, at :data:`PIPE_SMALL_LAYERS` layers,
    the CPU's; ms a step of both in turns. (5) split9's batcher with cut 11
    and two µ-batches through ``run.main``: every request completed,
    launches exactly as counted (K13 24 · M a ragged step), tokens equal
    the unpipelined batcher's. (6) split12 with ``--metrics-out``,
    ``--trace-out``, ``--trace-report`` and ``--profile``: the Prometheus
    text parses, the trace holds the reference's span names, the profile
    holds them as ranges, the result and launches equal the unobserved
    run's; a decode step timed in turns with observability on and off
    (tokens and launches a gate, the overhead reported) -> launches by
    path."""
    import argparse as ap
    import tempfile

    import torch

    from edgellm_tpu_torch import obs, run
    from edgellm_tpu_torch.models import PRESETS
    from edgellm_tpu_torch.parallel import PipelineConfig, SplitConfig, SplitRuntime
    from edgellm_tpu_torch.serve.decode import generate_split

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out, rows, part_s = {}, {}, {}
    t_part = [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        part_s[name] = now - t_part[0]
        t_part[0] = now
    cfg = PRESETS[model]
    layers = cfg.num_layers
    base = ["--model", model, "--seed", str(args.seed), "--device", device]
    with open(SPLIT12_CONFIG) as f:
        p12 = json.load(f)
    if model != "qwen2-0.5b":  # a CPU rehearsal at tiny depth
        p12.update(cuts=PIPE_SMALL_CUTS, max_length=64)
    m = p12["pipeline"]["num_microbatches"]
    n_cuts = len(p12["cuts"])
    plain12 = {k: v for k, v in p12.items() if k != "pipeline"}
    n_groups = math.ceil(PIPE_CHUNKS / PIPE_WB)
    hop_iters = HOP_ITERS * n_cuts
    eval_argv = ["--max-chunks", str(PIPE_CHUNKS), "--window-batch", str(PIPE_WB)] + base

    def split_cli(p, label, extra=()):
        """One split eval through ``run.main`` with the counts set to 0 just
        before (the fused-hop gate restored after: the CLI sets it from
        ``fused_hops``) -> (result, launches, other printed lines)."""
        with tempfile.TemporaryDirectory() as tmp, fused_hops("auto"):
            sync()
            reset_counts()
            code, lines = _cli_run(["--params", json.dumps(p), "--output-dir", tmp]
                                   + eval_argv + list(extra))
            sync()
            launches = read_counts()
        if code != 0:
            raise SystemExit(f"{label}: run.main exited {code}")
        return json.loads(lines[0]), launches, lines[1:]

    def eval_counts(per_group_m: int, codec: str = "int8") -> dict:
        hops = n_cuts * per_group_m * n_groups
        codecs = ({"remote_hop": hops, "int8_affine_encode": hop_iters,
                   "int8_affine_decode": hop_iters} if codec == "remote" else
                  {"int8_affine_encode": hops + hop_iters,
                   "int8_affine_decode": hops + hop_iters})
        attn = layers * per_group_m * n_groups
        return want_counts(attn, causal_attention=attn, **codecs)

    # (1) split12 as shipped and without its pipeline, in turns
    split_cli(p12, "split12 warm-up")
    runs = {"pipelined": [], "plain": []}
    for name in ("pipelined", "plain", "plain", "pipelined"):
        res, launches, _ = split_cli(p12 if name == "pipelined" else plain12, f"split12 {name}")
        want = eval_counts(m if name == "pipelined" else 1)
        runs[name].append({"s_per_chunk": res["wall_s"] / res["chunks"], "ppl": res["ppl"],
                           "total_nll": res["total_nll"], "launches": launches,
                           "result": res})
        if on_card and launches_differ(launches, want):
            raise SystemExit(f"split12 {name}: kernel launches {launches} != expected {want}")
    pipe, plain = runs["pipelined"][0]["result"], runs["plain"][0]["result"]
    rel = abs(pipe["ppl"] - plain["ppl"]) / plain["ppl"]
    row = {"s_per_chunk": {k: [r["s_per_chunk"] for r in v] for k, v in runs.items()},
           "ppl": {k: [r["ppl"] for r in v] for k, v in runs.items()},
           "ppl_rel_diff": rel, "chunks": pipe["chunks"], "groups": n_groups,
           "pad_fraction": pipe["pad_fraction"], "pipeline": pipe.get("pipeline"),
           "bytes_per_token_per_hop": {"pipelined": pipe["bytes_per_token_per_hop"],
                                       "plain": plain["bytes_per_token_per_hop"]},
           "measured_hop_bytes_total": {"pipelined": pipe["measured_hop_bytes_total"],
                                        "plain": plain["measured_hop_bytes_total"]},
           "per_hop_ms": pipe.get("per_hop_ms"),
           "launches": {k: v[0]["launches"] for k, v in runs.items()}}
    _, params = run._load_model(ap.Namespace(weights=None, model=model, seed=args.seed),
                                torch.device(device))
    if on_card:
        for name, split_kw in (("pipelined", {"pipeline": PipelineConfig(m)}),
                               ("plain", {})):
            with fused_hops("off"):
                prof = profile_split_group(cfg, params, f"pipeline_group_{name}",
                                           cuts=p12["cuts"], hop_codecs=p12["hop_codecs"],
                                           **split_kw)
            row.setdefault("group_profile", {})[name] = {
                k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share")}
    rows["split12"] = row
    log(json.dumps({"pipeline_split12": {k: v for k, v in row.items() if k != "launches"}}))
    if (pipe.get("pipeline") or {}).get("num_microbatches") != m or not rel <= SPLIT_CROSS_RTOL:
        raise SystemExit(f"split12: pipeline {pipe.get('pipeline')}, PPL {pipe['ppl']} against "
                         f"{plain['ppl']} unpipelined (rel {rel:.3e} > {SPLIT_CROSS_RTOL})")
    out["split12 pipelined"] = runs["pipelined"][0]["launches"]
    out["split12 unpipelined"] = runs["plain"][0]["launches"]
    lap("split12")

    # (2) split12 with split6's link inline, --fault-report
    with open("configs/split6_qwen_chaos.json") as f:
        p6 = json.load(f)
    p_link = {**p12, "faults": p6["faults"], "link_policy": p6["link_policy"]}
    res, launches, report = split_cli(p_link, "split12 link", ["--fault-report"])
    mb, lc = res.get("microbatch_counters") or {}, res.get("link_counters") or {}
    sums_ok = bool(mb) and all(np.asarray(mb[k]).shape == (m, n_cuts)
                               and np.asarray(mb[k]).sum(axis=0).tolist() == lc[k] for k in lc)
    rows["split12 link"] = {"microbatch_counters": mb, "link_counters": lc,
                            "tier_switches": res.get("tier_switches"), "ppl": res["ppl"],
                            "s_per_chunk": res["wall_s"] / res["chunks"], "sums_equal": sums_ok}
    log(json.dumps({"pipeline_link": rows["split12 link"]}))
    for line in report:
        log(f"  split12 link: {line}")
    if not sums_ok or not any("fault report" in line for line in report):
        raise SystemExit(f"split12 link: µ-batch counters {mb} do not sum to {lc}")
    out["split12 link"] = launches
    lap("split12 link")

    # (3) fused "remote" hops; one pipelined forward with int4 hops (K1 / K2)
    res, launches, _ = split_cli({**p12, "fused_hops": "remote"}, "split12 remote")
    want = eval_counts(m, "remote")
    rows["split12 remote"] = {"ppl": res["ppl"], "s_per_chunk": res["wall_s"] / res["chunks"],
                              "launches": launches}
    log(json.dumps({"pipeline_remote": rows["split12 remote"]}))
    if not abs(res["ppl"] - pipe["ppl"]) <= SPLIT_CROSS_RTOL * pipe["ppl"] or (
            on_card and launches_differ(launches, want)):
        raise SystemExit(f"split12 remote: PPL {res['ppl']}, launches {launches} != {want}")
    out["split12 remote"] = launches
    ids = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (PIPE_WB, p12["max_length"]))).to(device)
    with fused_hops("off"):
        rt4 = SplitRuntime(cfg, SplitConfig(tuple(p12["cuts"]), ("int4_per_token",) * n_cuts),
                           [device] * (n_cuts + 1), pipeline=PipelineConfig(m))
        placed = rt4.place_params(params)
        rt4.forward(placed, ids[:m])  # warm
        sync()
        reset_counts()
        logits = rt4.forward(placed, ids)
        sync()
        launches = read_counts()
    want = want_counts(layers * m, causal_attention=layers * m, int4_encode=n_cuts * m,
                       int4_decode=n_cuts * m)
    if not bool(torch.isfinite(logits).all()) or (on_card and launches_differ(launches, want)):
        raise SystemExit(f"pipelined int4 forward: launches {launches} != expected {want}")
    out["pipelined int4 forward"] = launches
    del rt4, placed, logits
    lap("remote and int4")

    # (4) pipelined generate_split, B = 4, M = 4, greedy
    b, new = PIPE_DECODE["batch"], PIPE_DECODE["new"]
    plan = SplitConfig(tuple(p12["cuts"]), tuple(p12["hop_codecs"]))
    prompt = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (b, PIPE_DECODE["prompt"])).astype(np.int32)
    decode_rts = {}
    toks = {}
    with fused_hops("off"):
        for name, pc in (("pipelined", PipelineConfig(PIPE_DECODE["m"])), ("plain", None)):
            rt = SplitRuntime(cfg, plan, [device] * (n_cuts + 1), pipeline=pc)
            decode_rts[name] = (rt, rt.place_params(params))
        generate_split(*decode_rts["pipelined"], prompt, 3)  # warm
        sync()
        reset_counts()
        stats: dict = {}
        toks["pipelined"] = generate_split(*decode_rts["pipelined"], prompt, new, stats=stats)
        sync()
        launches = read_counts()
        toks["plain"] = generate_split(*decode_rts["plain"], prompt, new)
        small, small_params = _small_model(cfg, params, PIPE_SMALL_LAYERS)
        small_plan = SplitConfig(tuple(PIPE_SMALL_CUTS), plan.hop_codecs)
        for dev in (device, "cpu"):
            rt = SplitRuntime(small, small_plan, [dev] * 3,
                              pipeline=PipelineConfig(PIPE_DECODE["m"]))
            sp = {k: (v.to(dev) if not isinstance(v, dict) else {kk: vv.to(dev)
                                                                  for kk, vv in v.items()})
                  for k, v in small_params.items()}
            toks[f"small {dev}"] = generate_split(rt, rt.place_params(sp), prompt, new)
    mb_hops = n_cuts * PIPE_DECODE["m"] * (new - 1) + n_cuts
    want = want_counts(layers, causal_attention=layers, int8_affine_encode=mb_hops,
                       int8_affine_decode=mb_hops)
    same = {k: bool(np.array_equal(toks["pipelined"].cpu().numpy(), v.cpu().numpy()))
            for k, v in toks.items() if k == "plain"}
    same["small card vs cpu"] = bool(np.array_equal(toks[f"small {device}"].cpu().numpy(),
                                                    toks["small cpu"].cpu().numpy()))
    decode_row = {"tokens_equal": same, "pipeline": stats.get("pipeline"), "launches": launches,
                  "launches_expected": want}
    log(json.dumps({"pipeline_decode": decode_row}))
    if not all(same.values()) or (on_card and launches_differ(launches, want)):
        raise SystemExit(f"pipelined generate_split: {decode_row}")
    out["generate_split pipelined"] = launches
    lap("generate_split")

    # (5) split9's batcher with cut 11 and two µ-batches through run.main
    with open("configs/split9_qwen_paged.json") as f:
        p9 = json.load(f)
    p9.update(PIPE_SERVE)
    if model != "qwen2-0.5b":
        p9["cuts"] = [2]
    kept: dict = {}
    real_serve = run.run_serve

    def keep_serve(*a, **kw):
        kept.update(real_serve(*a, **kw))
        return kept

    run.run_serve = keep_serve
    try:
        with tempfile.TemporaryDirectory() as tmp:
            sync()
            reset_counts()
            t0 = time.monotonic()
            code, lines = _cli_run(["--params", json.dumps(p9), "--output-dir", tmp] + base)
            sync()
            wall = time.monotonic() - t0
            launches = read_counts()
    finally:
        run.run_serve = real_serve
    if code != 0:
        raise SystemExit(f"split9 pipelined serve: run.main exited {code}")
    printed, rep = json.loads(lines[-1]), kept["_batcher"]
    m9 = PIPE_SERVE["pipeline"]["num_microbatches"]
    want, warm, prefills, hits = _split_serve_expected(cfg, rep, 1, "fp", False, m=m9)
    with tempfile.TemporaryDirectory() as tmp:
        plain9 = run.run_serve(cfg, params, {k: v for k, v in p9.items() if k != "pipeline"},
                               lambda f: os.path.join(tmp, f))
    got_t = {r.request_id: np.asarray(r.tokens).tolist() for r in kept["_records"]}
    want_t = {r.request_id: np.asarray(r.tokens).tolist() for r in plain9["_records"]}
    serve_row = {"printed": printed, "steps": rep["steps"], "prefills": prefills,
                 "pipeline": rep.get("pipeline"), "wall_s": wall,
                 "ms_per_step": 1e3 * rep["decode_s"] / max(rep["steps"], 1),
                 "unpipelined_ms_per_step": 1e3 * plain9["_batcher"]["decode_s"]
                 / max(plain9["_batcher"]["steps"], 1),
                 "tokens_equal_unpipelined": got_t == want_t, "launches": launches,
                 "launches_expected": want}
    log(json.dumps({"pipeline_serve": serve_row}))
    n_req = p9["serving"]["soak"]["n_requests"]
    if printed["outcomes"] != {"completed": n_req} or got_t != want_t or (
            on_card and launches_differ(launches, want)):
        raise SystemExit(f"split9 pipelined serve: {serve_row}")
    out["split9 pipelined serve"] = {k: v - warm.get(k, 0) for k, v in launches.items()}
    rows["split9 pipelined"] = serve_row
    del kept, plain9
    lap("split9 pipelined")

    # (6) observability: split12 with every obs flag, then a decode step
    # with observability on and off in turns
    with tempfile.TemporaryDirectory() as tmp:
        obs.get_registry().clear()
        obs.get_tracer().clear()
        flags = ["--metrics-out", os.path.join(tmp, "m.prom"),
                 "--trace-out", os.path.join(tmp, "t.json"), "--trace-report",
                 "--profile", os.path.join(tmp, "prof")]
        res, launches, lines = split_cli(p12, "split12 observed", flags)
        with open(os.path.join(tmp, "m.prom")) as f:
            kinds = _prom_parse(f.read())
        with open(os.path.join(tmp, "t.json")) as f:
            spans = {e["name"] for e in json.load(f)["traceEvents"]}
        with open(os.path.join(tmp, "prof", "torch_trace.json")) as f:
            ranges = {e.get("name") for e in json.load(f)["traceEvents"]}
        prof_mb = os.path.getsize(os.path.join(tmp, "prof", "torch_trace.json")) / 2**20
    obs.get_registry().clear()
    obs.get_tracer().clear()
    unobserved = runs["pipelined"][0]
    obs_row = {"metric_families": kinds, "spans": sorted(spans),
               "profile_ranges_found": sorted(EVAL_SPANS & ranges), "profile_mb": prof_mb,
               "report": [line for line in lines if line.startswith("trace report")],
               "total_nll_equal": res["total_nll"] == unobserved["total_nll"],
               "launches_equal": launches == unobserved["launches"]}
    log(json.dumps({"pipeline_obs_cli": obs_row}))
    if (spans != EVAL_SPANS or not EVAL_SPANS <= ranges
            or kinds.get("edgellm_wire_bytes_total") != "counter"
            or not obs_row["total_nll_equal"] or not obs_row["launches_equal"]
            or not obs_row["report"] or obs.enabled()):
        raise SystemExit(f"split12 observed: {obs_row}")
    out["split12 observed"] = launches

    rt, placed = decode_rts["pipelined"]
    ids = torch.from_numpy(prompt).to(device)
    tok = ids[:, -1]
    reads = {"off": [], "on": []}
    step_toks, step_launches = {}, {}

    def steps(observed: bool) -> float:
        """PIPE_STEP_READS decode steps of one cache (the same position
        rewritten), observed as the decode loop observes a step: the
        sampled token through a LatencyObserver, metrics and tracing armed
        -> ms a step."""
        observer = obs.LatencyObserver() if observed else None
        if observed:
            obs.enable()
        try:
            sync()
            t0 = time.monotonic()
            with obs.span("generate_split.decode_loop", steps=PIPE_STEP_READS):
                for _ in range(PIPE_STEP_READS):
                    logits, _ = rt.decode_step(placed, cache, tok)
                    nxt = torch.argmax(logits, dim=-1)
                    if observer is not None:
                        observer.token(nxt)
            sync()
            ms = (time.monotonic() - t0) * 1e3 / PIPE_STEP_READS
        finally:
            obs.disable()
        step_toks.setdefault(observed, nxt.cpu().numpy())
        return ms

    with fused_hops("off"):
        _, cache = rt.prefill_decode(placed, ids, PIPE_DECODE["prompt"] + 4)
        for observed in (False, True):
            reset_counts()
            steps(observed)  # warm, and the launches of one reading
            sync()
            step_launches[observed] = read_counts()
        for name in ("off", "on", "on", "off"):
            reads[name].append(steps(name == "on"))
        # the unpipelined step beside it, one reading
        prt, pplaced = decode_rts["plain"]
        _, pcache = prt.prefill_decode(pplaced, ids, PIPE_DECODE["prompt"] + 4)
        sync()
        t0 = time.monotonic()
        for _ in range(PIPE_STEP_READS):
            prt.decode_step(pplaced, pcache, tok)
        sync()
        plain_ms = (time.monotonic() - t0) * 1e3 / PIPE_STEP_READS
    obs.get_registry().clear()
    obs.get_tracer().clear()
    off_ms, on_ms = statistics.median(reads["off"]), statistics.median(reads["on"])
    step_row = {"ms_per_step_off": reads["off"], "ms_per_step_on": reads["on"],
                "overhead": on_ms / off_ms - 1, "budget": 0.03,
                "unpipelined_ms_per_step": plain_ms,
                "tokens_equal": bool(np.array_equal(step_toks[False], step_toks[True])),
                "launches_equal": step_launches[False] == step_launches[True],
                "launches_a_reading": step_launches[True]}
    rows["decode step obs"] = step_row
    log(json.dumps({"pipeline_obs_step": step_row}))
    if not step_row["tokens_equal"] or not step_row["launches_equal"]:
        raise SystemExit(f"observed decode step: {step_row}")
    lap("observability")
    rows["part_s"] = part_s
    log(json.dumps({"pipeline_part_s": part_s}))
    detail["pipeline"] = rows
    del params, decode_rts
    if on_card:
        torch.cuda.empty_cache()
    return out


#: phase 20's shipped config; the cut its split run adds (split1's boundary,
#: the hop held separate so K3 / K4 run once a hop whatever the probe cache
#: says)
SPLIT16_CONFIG = "configs/split16_qwen_disagg.json"
DISAGG_CUT = {"cuts": [11], "hop_codecs": ["int8_per_token"], "fused_hops": "off"}
#: phase 20's chaos soak (the reference test's legs, prompts inside split16's
#: 32-position span): a prefill worker killed mid-migration, the decode worker
#: killed, the link failed, and a bit-flip window hot enough that no page
#: verifies (every migration in it fails, falls back colocated and leaves
#: one flight artifact)
DISAGG_SOAK = dict(n_requests=12, seed=7, min_prompt_len=3, max_prompt_len=24,
                   max_new_tokens=6,
                   kills=((0.2, "prefill"), (0.5, "decode"), (0.85, "link")),
                   burst_start_frac=0.3, burst_end_frac=0.5, burst_bitflip_rate=1e-3)
DISAGG_SOAK_SERVER = dict(num_prefill_workers=3, queue_bound=4, degrade_after=50)
#: the soak's card-against-CPU depth
DISAGG_SMALL_LAYERS = 2
#: the endpoint's routes phase 20 scrapes
OBS_ROUTES = ("/metrics", "/healthz", "/snapshot.json", "/trace")


def disagg_paths(args, detail: dict, device: str = "cuda",
                 model: str = "qwen2-0.5b") -> dict:
    """Phase 20: the fleet's first pieces, fp32 weights from ``--seed`` (the
    CLI's default), full Qwen2-0.5B width and depth. (a)
    configs/split16_qwen_disagg.json as shipped through ``run.main``: every
    request completed, mode "disagg_batched", 3 pages a request migrated,
    the link's wire bytes the sum of ``migration_wire_nbytes`` over the
    pages, every request's tokens those of a colocated ``ContinuousBatcher``
    on the card, launches exactly 24 fp32 K-attn a prefill (the staging
    prefills, the colocated fallbacks and the warm batcher's, none for an
    adopted stream) and 24 K14 a ragged step; then disagg and colocated in
    turns (ms a decode step, wall a request). (b) split16 with cut 11
    (mode "disagg_batched_split"): K3 / K4 once a hop, K14 12 a stage a
    step, the colocated split-paged batcher's tokens. (c) ``run_disagg_soak``
    with every chaos leg, its identity audit passing; at
    :data:`DISAGG_SMALL_LAYERS` layers the same soak on the card and the
    CPU with equal kills, identity counts and ``disagg`` report. (d) during
    (c) the flight recorder and the live endpoint armed: one artifact a
    migration-fatal failure, each read back; the four routes answer 200 on
    127.0.0.1, ``/metrics`` the registry's text of that instant, and an
    unknown path 404 -> launches by path."""
    import tempfile
    import urllib.error
    import urllib.request

    import torch

    from edgellm_tpu_torch import obs
    from edgellm_tpu_torch import run
    from edgellm_tpu_torch.codecs.fec import FECConfig
    from edgellm_tpu_torch.models import PRESETS, init_params, params_to
    from edgellm_tpu_torch.models.paged_kv import resolve_kv_codec
    from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
    from edgellm_tpu_torch.serve import ContinuousBatcher
    from edgellm_tpu_torch.serve import disagg as dg
    from edgellm_tpu_torch.serve import soak as sk

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out, rows, part_s = {}, {}, {}
    t_part = [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        part_s[name] = now - t_part[0]
        t_part[0] = now
    cfg = PRESETS[model]
    n_layers = cfg.num_layers
    base = ["--model", model, "--seed", str(args.seed), "--device", device]
    with open(SPLIT16_CONFIG) as f:
        p16 = json.load(f)
    if model != "qwen2-0.5b":  # a CPU rehearsal: the cut inside the tiny model
        p16["serving"]["soak"]["n_requests"] = 6
    cut = dict(DISAGG_CUT, cuts=[11] if model == "qwen2-0.5b" else [2])
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                         device=device)
    bcfg = run.batching_config(cfg, p16)
    n_req = p16["serving"]["soak"]["n_requests"]

    def cli(p, label):
        """``run.main`` on ``p`` with the counts set to 0 just before -> (the
        printed line, serve_report.json, launches, wall s, the requests the
        server took by sid, its tokens by sid)."""
        reqs, results = {}, {}
        real_submit, real_run = dg.DisaggServer.submit, dg.DisaggServer.run

        def submit(self, prompt_ids, max_new_tokens, **kw):
            sid = real_submit(self, prompt_ids, max_new_tokens, **kw)
            reqs[sid] = (np.asarray(prompt_ids, np.int32).copy(), int(max_new_tokens), kw)
            return sid

        def run_all(self, *a, **kw):
            res = real_run(self, *a, **kw)
            results.update({sid: np.asarray(t).copy() for sid, t in res.items()})
            return res

        dg.DisaggServer.submit, dg.DisaggServer.run = submit, run_all
        try:
            with tempfile.TemporaryDirectory() as tmp:
                sync()
                reset_counts()
                t0 = time.monotonic()
                rc, printed = _cli_json_line(["--params", json.dumps(p), "--output-dir", tmp]
                                             + base)
                sync()
                wall = time.monotonic() - t0
                launches = read_counts()
                with open(os.path.join(tmp, "serve_report.json")) as f:
                    report = json.load(f)
        finally:
            dg.DisaggServer.submit, dg.DisaggServer.run = real_submit, real_run
        if rc != 0:
            raise SystemExit(f"{label}: run.main exited {rc}")
        return printed, report, launches, wall, reqs, results

    def colocated(reqs, split_kw=None):
        """The same requests on a colocated batcher of split16's geometry ->
        (tokens by the server's sid, its report, wall s)."""
        b = ContinuousBatcher(cfg, params, bcfg, **(split_kw or {}))
        sync()
        t0 = time.monotonic()
        ids = {sid: b.submit(pr, n, **kw) for sid, (pr, n, kw) in sorted(reqs.items())}
        res = b.run()
        sync()
        return {sid: res[i] for sid, i in ids.items()}, b.report(), time.monotonic() - t0

    def expected(rep, n_cuts):
        """24 fp32 K-attn a prefill (the staging workers', the colocated
        fallbacks', the warm batcher's one), 24 K14 a ragged step (the warm
        batcher's one too), one K3 / K4 a cut a prefill and a step."""
        d = rep["disagg"]
        prefills = d["prefills"] + d["colocated_fallbacks"] + 1
        steps = rep["steps"] + 1
        hops = n_cuts * (prefills + steps)
        codec = {"int8_affine_encode": hops, "int8_affine_decode": hops} if n_cuts else {}
        return want_counts(n_layers * prefills, causal_attention=n_layers * prefills,
                           paged_decode_attention_quant=n_layers * steps, **codec)

    codec = resolve_kv_codec(bcfg.kv_codec)
    row_bytes = 2 * n_layers * cfg.num_kv_heads * (codec.code_lanes(cfg.head_dim) + 4)
    fec = FECConfig(**p16["disagg"]["fec"])
    ps = bcfg.page_size

    def wire_bytes(prompt_len):
        return sum(dg.migration_wire_nbytes(min(ps, prompt_len - a) * row_bytes, fec)
                   for a in range(0, prompt_len, ps))

    # (a) split16 as shipped, (b) with cut 11
    for label, p, n_cuts in (("split16", p16, 0), ("split16 cut 11", {**p16, **cut}, 1)):
        printed, report, launches, wall, reqs, toks = cli(p, label)
        rep, d = report["batcher"], report["batcher"]["disagg"]
        split_kw = None
        if n_cuts:
            with fused_hops("off"):
                rt = SplitRuntime(cfg, SplitConfig(tuple(p["cuts"]), tuple(p["hop_codecs"])),
                                  [params["embed"].device] * 2)
            split_kw = dict(split_runtime=rt, placed_params=rt.place_params(params))
        want_toks, col_rep, col_wall = colocated(reqs, split_kw)
        pages = sum(-(-pr.size // ps) for pr, _, _ in reqs.values())
        want = expected(rep, n_cuts)
        row = {"path": label, "printed": printed, "mode": report["mode"],
               "decode_steps": rep["steps"], "ms_per_decode_step":
                   1e3 * rep["decode_s"] / max(rep["steps"], 1),
               "colocated_decode_steps": col_rep["steps"],
               "colocated_ms_per_decode_step":
                   1e3 * col_rep["decode_s"] / max(col_rep["steps"], 1),
               "wall_s": wall, "colocated_wall_s": col_wall, "disagg": d,
               "pages": pages, "wire_bytes_expected": sum(
                   wire_bytes(pr.size) for pr, _, _ in reqs.values()),
               "bytes_a_page_chunk": {r: dg.migration_wire_nbytes(r * row_bytes, fec)
                                      for r in sorted({min(ps, pr.size - a)
                                                       for pr, _, _ in reqs.values()
                                                       for a in range(0, pr.size, ps)})},
               "tokens_equal_colocated": sorted(toks) == sorted(want_toks) and all(
                   np.array_equal(toks[s], want_toks[s]) for s in want_toks),
               "launches": launches, "launches_expected": want}
        log(json.dumps({"disagg_path": {k: v for k, v in row.items() if k != "printed"}}))
        rows[label] = row
        mode = "disagg_batched_split" if n_cuts else "disagg_batched"
        if printed["outcomes"] != {"completed": n_req} or printed["mode"] != mode \
                or printed["disagg_migrations"] != n_req or printed["disagg_degraded"]:
            raise SystemExit(f"{label}: {printed}")
        if d["migrated_pages"] != pages or d["link"]["transmissions"] != pages \
                or d["link"]["wire_bytes"] != row["wire_bytes_expected"]:
            raise SystemExit(f"{label}: {pages} pages of {row['wire_bytes_expected']} wire "
                             f"bytes expected, the link says {d['link']}")
        if not row["tokens_equal_colocated"]:
            raise SystemExit(f"{label}: disagg tokens differ from the colocated batcher's")
        if on_card and launches_differ(launches, want):
            raise SystemExit(f"{label}: kernel launches {launches} != expected {want}")
        out[label] = launches
        turn_reqs = reqs if not n_cuts else turn_reqs
        lap(label)

    # (a) in turns: disagg, colocated, colocated, disagg on (a)'s requests
    turns = {"disagg": [], "colocated": []}
    for name in ("disagg", "colocated", "colocated", "disagg"):
        if name == "colocated":
            _, rep_t, wall_t = colocated(turn_reqs)
        else:
            srv = dg.DisaggServer(cfg, params, bcfg, run._disagg_config(p16["disagg"]))
            sync()
            t0 = time.monotonic()
            for sid in sorted(turn_reqs):
                pr, n, kw = turn_reqs[sid]
                srv.submit(pr, n, **kw)
            srv.run()
            sync()
            wall_t = time.monotonic() - t0
            rep_t = srv.report()
        turns[name].append({"ms_per_decode_step": 1e3 * rep_t["decode_s"] / max(rep_t["steps"], 1),
                            "decode_steps": rep_t["steps"],
                            "wall_ms_per_request": 1e3 * wall_t / len(turn_reqs)})
    rows["turns"] = turns
    log(json.dumps({"disagg_turns": turns}))
    lap("turns")

    # (c) + (d): the chaos soak with the recorder and the endpoint armed
    dcfg = dg.DisaggConfig(fec=fec, **DISAGG_SOAK_SERVER)

    def soak(c, prm):
        srv = dg.DisaggServer(c, prm, bcfg, dcfg)
        return sk.run_disagg_soak(
            srv, sk.DisaggSoakConfig(vocab_size=c.vocab_size, **DISAGG_SOAK),
            reference_factory=lambda: ContinuousBatcher(c, prm, bcfg))

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, b""

    fr_dir = tempfile.mkdtemp(prefix="flight_")
    obs.enable(obs.ObservabilityConfig(flight_recorder=fr_dir, obs_port=0))
    try:
        sync()
        reset_counts()
        art = soak(cfg, params)
        sync()
        launches = read_counts()
        srv = obs.server.get_global()
        status = {}
        status["/metrics"], body = get(srv.url + "/metrics")
        metrics_equal = body.decode() == obs.get_registry().to_prometheus()
        for route in OBS_ROUTES[1:] + ("/no-such-route",):
            status[route], _ = get(srv.url + route)
        dumps = obs.get_flight_recorder().dumps()
        reasons = [obs.load_flight(path)["reason"] for path in dumps]
    finally:
        obs.disable()
        obs.get_registry().clear()
        obs.get_tracer().clear()
        shutil.rmtree(fr_dir, ignore_errors=True)
    d = art["disagg"]
    soak_row = {"completed": art["completed"], "accepted_lost": art["accepted_lost"],
                "kills": art["kills"], "burst": art["burst"],
                "token_identity": art["token_identity"], "disagg": d,
                "flight_dumps": len(dumps), "flight_reasons": reasons,
                "endpoint_status": status, "metrics_equal_registry": metrics_equal,
                "launches": launches}
    log(json.dumps({"disagg_soak": soak_row}))
    rows["soak"] = soak_row
    targets = {k["target"].split(":")[0] for k in art["kills"]}
    if art["accepted_lost"] or not art["token_identity"]["ok"] \
            or art["token_identity"]["checked"] != art["requests"]:
        raise SystemExit(f"disagg soak: {soak_row}")
    if targets != {"prefill", "decode", "link"} or not any(
            k["mid_migration"] for k in art["kills"]) or d["degrade_reason"] != "migration_link_dead":
        raise SystemExit(f"disagg soak: a chaos leg did not fire: {art['kills']}, {d}")
    # one artifact a migration-fatal failure: each exhausted ladder (the
    # link's "failed") and each worker lost mid-migration
    if reasons.count("MigrationError") != d["link"]["failed"] or d["link"]["failed"] < 1 \
            or set(reasons) - {"MigrationError", "PrefillWorkerLost"}:
        raise SystemExit(f"disagg soak: flight artifacts {reasons} for {d['link']['failed']} "
                         f"failed migrations")
    if any(status[r] != 200 for r in OBS_ROUTES) or status["/no-such-route"] != 404 \
            or not metrics_equal:
        raise SystemExit(f"obs endpoint: {status}, /metrics equal: {metrics_equal}")
    out["disagg soak"] = launches
    lap("soak")

    # (c) at DISAGG_SMALL_LAYERS layers: the card against the CPU
    small_cfg, small = _small_model(cfg, params, DISAGG_SMALL_LAYERS)
    arts = {dev: soak(small_cfg, params_to(small, device=dev))
            for dev in ((device, "cpu") if on_card else ("cpu",))}
    keep = ("completed", "accepted_lost", "kills", "burst", "disagg")
    cross = {"equal": all(arts[device][k] == arts["cpu"][k] for k in keep),
             "identity": {dev: a["token_identity"] for dev, a in arts.items()},
             "disagg": arts["cpu"]["disagg"]}
    rows["soak card vs cpu"] = cross
    log(json.dumps({"disagg_soak_card_vs_cpu": cross}))
    if not cross["equal"] or not all(a["token_identity"]["ok"] for a in arts.values()):
        raise SystemExit(f"disagg soak card vs CPU: {[{k: a[k] for k in keep} for a in arts.values()]}")
    lap("soak card vs cpu")
    rows["part_s"] = part_s
    log(json.dumps({"disagg_part_s": part_s}))
    detail["disagg"] = rows
    del params
    if on_card:
        torch.cuda.empty_cache()
    return out


#: phase 21's shipped configs; split16's blocks the disagg leg takes over split15
SPLIT15_CONFIG = "configs/split15_qwen_cluster.json"
SPLIT17_CONFIG = "configs/split17_qwen_gray.json"
#: the kill drill (the reference bench's real leg, fp32): requests, prompt /
#: new / shared-prefix tokens, the request before which replica 0 dies
DRILL = dict(n=12, prompt_len=16, new_tokens=8, shared_len=8, kill_at=6)
#: the simulated soaks (host only): the bench's chaos soak at a request
#: count that keeps it near a minute, and its gray soak as shipped
SIM_CHAOS = dict(n_requests=20_000, arrival_rate=80.0, prompt_len=16, shared_prefix_len=8,
                 num_prefix_groups=32, max_new_tokens=16, deadline_s=120.0, sampled_frac=0.5,
                 sample_temperature=0.7, kills=((0.3, 0), (0.6, 1)), burst_start_frac=0.45,
                 burst_end_frac=0.55, burst_corrupt_rate=0.05)
SIM_GRAY = dict(n_requests=600, arrival_rate=30.0, seed=7, deadline_s=0.5,
                slowdowns=((0.3, 0, 20.0),))
#: the card-against-CPU depth of the gray report and the kill drill
CLUSTER_SMALL_LAYERS = 2


def _batcher_counts(n_layers: int, rep: dict, n_cuts: int = 0, kv_codec: str = "fp",
                    staging_hits: int = 0) -> dict:
    """The launches one replica's batcher report implies: L fp32 K-attn a
    prefill (a prefix hit's suffix takes the plain attention; a disagg
    server counts its staging prefills, less the ``staging_hits`` its
    workers' own prefix indexes served, and its colocated fallbacks), L K13
    (K14 on quantized pages) a ragged step, each cut one K3 + K4 hop a step,
    a prefill and a prefix hit."""
    d = rep.get("disagg")
    hits = rep.get("prefix", {}).get("hits", 0) if rep.get("prefix") else 0
    prefills = (d["prefills"] - staging_hits + d["colocated_fallbacks"] if d
                else rep["admitted"] - rep["evicted"] - hits)
    paged = "paged_decode_attention" if kv_codec == "fp" else "paged_decode_attention_quant"
    hops = n_cuts * (rep["steps"] + prefills + hits)
    return {"causal_attention": n_layers * prefills, "causal_attention float32":
            n_layers * prefills, paged: n_layers * rep["steps"],
            **({"int8_affine_encode": hops, "int8_affine_decode": hops} if n_cuts else {})}


def _sum_counts(parts) -> dict:
    want = dict.fromkeys(list(KERNELS) + list(ATTN_BY_DTYPE), 0)
    for part in parts:
        for k, v in part.items():
            want[k] += v
    want["causal_attention bfloat16"] = want["causal_attention"] \
        - want["causal_attention float32"]
    return want


def cluster_paths(args, detail: dict, device: str = "cuda",
                  model: str = "qwen2-0.5b") -> dict:
    """Phase 21: the replica router and the gray plane, fp32 weights from
    ``--seed`` (the CLI's default), full Qwen2-0.5B width and depth. Every
    fleet's replicas share the one device and drain in turn (the router's
    round-robin). (a) configs/split15_qwen_cluster.json and
    configs/split17_qwen_gray.json through ``run.main``, the counts set to 0
    just before each: every request completed, mode "cluster_batched",
    placements by kind, launches exactly what every replica's batcher
    report and the warm batcher imply; split17's ``gray`` report (and the
    whole fleet report, which the fake clock makes model-independent)
    equal to a :data:`CLUSTER_SMALL_LAYERS`-layer CPU run's. (b) split15
    with cut 11 (mode "cluster_batched_split", K3 / K4 once a hop) and (c)
    over split16's ``disagg`` block with int8 ``kv_at_rest`` pages (mode
    "disagg_cluster_batched", K14 a step, one migration a request). (d) the
    kill drill: 2 replicas, replica 0 killed before request 6, against a
    1-replica fleet (zero accepted loss, every stream identical, one flight
    dump, re-admissions, the dead pool freed, peak memory), and at
    :data:`CLUSTER_SMALL_LAYERS` layers the card against the CPU. (e) the
    simulated chaos and gray soaks, host only -> launches by path."""
    import gc
    import resource

    import torch

    from edgellm_tpu_torch import run
    from edgellm_tpu_torch.models import PRESETS, init_params, params_to
    from edgellm_tpu_torch.serve import (BatchingConfig, ClusterConfig, ClusterFront,
                                         ClusterSoakConfig, ContinuousBatcher, GrayConfig,
                                         Request, RespawnConfig, ServeFront, SimReplicaConfig,
                                         SimReplicaFront, run_cluster_soak)
    from edgellm_tpu_torch.utils.clock import FakeClock

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out, rows, part_s = {}, {}, {}
    t_part = [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        part_s[name] = now - t_part[0]
        t_part[0] = now
    cfg = PRESETS[model]
    n_layers = cfg.num_layers
    base = ["--model", model, "--seed", str(args.seed), "--device", device]
    with open(SPLIT15_CONFIG) as f:
        p15 = json.load(f)
    with open(SPLIT17_CONFIG) as f:
        p17 = json.load(f)
    with open(SPLIT16_CONFIG) as f:
        p16 = json.load(f)
    cut = dict(DISAGG_CUT, cuts=[11] if model == "qwen2-0.5b" else [2])
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                         device=device)
    small_cfg, small = _small_model(cfg, params, CLUSTER_SMALL_LAYERS)
    small_cpu = params_to(small, device="cpu")

    def cli(p, label):
        """``run.main`` on ``p``, the counts set to 0 just before -> (the
        printed line, cluster_report.json, launches, wall s, the router)."""
        kept = {}
        real = run.run_cluster

        def keep(*a, **kw):
            kept.update(real(*a, **kw))
            return kept

        run.run_cluster = keep
        try:
            with tempfile.TemporaryDirectory() as tmp:
                sync()
                reset_counts()
                t0 = time.monotonic()
                rc, printed = _cli_json_line(["--params", json.dumps(p), "--output-dir", tmp]
                                             + base)
                sync()
                wall = time.monotonic() - t0
                launches = read_counts()
                with open(os.path.join(tmp, "cluster_report.json")) as f:
                    report = json.load(f)
        finally:
            run.run_cluster = real
        if rc != 0:
            raise SystemExit(f"{label}: run.main exited {rc}")
        return printed, report, launches, wall, kept["_cluster"]

    # (a) split15 and split17 as shipped, (b) cut 11, (c) over split16's disagg
    legs = (("split15", p15, 0, "cluster_batched"), ("split17", p17, 0, "cluster_batched"),
            ("split15 cut 11", {**p15, **cut}, 1, "cluster_batched_split"),
            ("split15 disagg", {**p15, "disagg": p16["disagg"],
                                "kv_at_rest": p16["kv_at_rest"]}, 0, "disagg_cluster_batched"))
    for label, p, n_cuts, mode in legs:
        printed, report, launches, wall, cluster = cli(p, label)
        reps = {rid: r.front.batcher.report() for rid, r in sorted(cluster.replicas.items())}
        # a disagg replica's prefill workers each keep a prefix index of their own
        staging_hits = {rid: sum((w.bat.report().get("prefix") or {}).get("hits", 0)
                                 for w in getattr(r.front.batcher, "workers", ()))
                        for rid, r in cluster.replicas.items()}
        kv_codec = p.get("kv_at_rest", {}).get("codec", "fp")
        want = _sum_counts([_batcher_counts(n_layers, b, n_cuts, kv_codec, staging_hits[rid])
                            for rid, b in reps.items()]
                           + [_batcher_counts(n_layers, {"steps": 1, "admitted": 1,
                                                         "evicted": 0}, n_cuts, kv_codec)])
        rep = report["cluster"]
        n = p["serving"]["soak"]["n_requests"]
        row = {"path": label, "printed": printed, "mode": report["mode"], "wall_s": wall,
               "replicas_ran": "in turn on one device", "totals": rep["totals"],
               "replicas": {rid: {"placed": r["placed"], "completed": r["completed"],
                                  "disagg": r["disagg"]} for rid, r in rep["replicas"].items()},
               "batchers": {rid: {k: b.get(k) for k in ("admitted", "evicted", "steps",
                                                        "decode_s", "prefill_s")}
                            | {"prefix_hits": (b.get("prefix") or {}).get("hits"),
                               "staging_prefix_hits": staging_hits[rid],
                               "disagg_prefills": (b.get("disagg") or {}).get("prefills"),
                               "migrations": (b.get("disagg") or {}).get("migrations")}
                            for rid, b in reps.items()},
               "gray": rep["gray"], "launches": launches, "launches_expected": want}
        log(json.dumps({"cluster_path": {k: v for k, v in row.items() if k != "printed"}}))
        rows[label] = row
        if printed["outcomes"] != {"completed": n} or printed["mode"] != mode \
                or printed["replicas"] != p["cluster"]["num_replicas"] or rep["pending"]:
            raise SystemExit(f"{label}: {printed}")
        if "disagg" in p and sum(b["disagg"]["migrations"] for b in reps.values()) != n:
            raise SystemExit(f"{label}: {n} migrations expected: {row['batchers']}")
        if on_card and launches_differ(launches, want):
            raise SystemExit(f"{label}: kernel launches {launches} != expected {want}")
        if label == "split17":
            with tempfile.TemporaryDirectory() as tmp:
                small_sum = run.run_cluster(small_cfg, small_cpu, p,
                                            lambda f: os.path.join(tmp, f))
            small_rep = json.loads(json.dumps(small_sum["_report"], default=float))
            row["gray_equal_cpu_small"] = small_rep["gray"] == rep["gray"]
            row["report_equal_cpu_small"] = small_rep == rep
            log(json.dumps({"cluster_gray_vs_cpu": {
                "card": rep["gray"], "cpu_2_layers": small_rep["gray"],
                "report_equal": row["report_equal_cpu_small"]}}))
            if sorted(rep["gray"]) != ["detector", "flagged", "hedge_delay_s"] \
                    or rep["gray"]["detector"]["observed"] != n \
                    or not row["gray_equal_cpu_small"] or not row["report_equal_cpu_small"]:
                raise SystemExit(f"split17: the gray report {rep['gray']} against the "
                                 f"CPU's {small_rep['gray']}")
        out[f"cluster {label}"] = launches
        del cluster
        lap(label)

    # (d) the kill drill: a 2-replica fleet, replica 0 killed before request 6
    def drill(c, prm, dev, n_replicas, kill_at, flight_dir, count=False):
        d = DRILL
        pps = -(-(d["prompt_len"] + d["new_tokens"]) // 8)
        bcfg = BatchingConfig(page_size=8, max_slots=4, num_pages=1 + 4 * pps,
                              pages_per_slot=pps)
        rng = np.random.default_rng(args.seed)
        shared = rng.integers(1, c.vocab_size, size=d["shared_len"]).astype(np.int32)
        prompts = []
        for _ in range(d["n"]):
            pr = rng.integers(1, c.vocab_size, size=d["prompt_len"]).astype(np.int32)
            pr[:d["shared_len"]] = shared
            prompts.append(pr)
        gaps = rng.exponential(0.5, size=d["n"])
        mem = {}
        on_dev = torch.device(dev).type == "cuda"

        def allocated():
            gc.collect()
            return torch.cuda.memory_allocated() if on_dev else None

        if count:
            sync()
            reset_counts()
        if on_dev:
            torch.cuda.reset_peak_memory_stats()
        warm = ContinuousBatcher(c, prm, bcfg)
        warm.submit(np.ones((d["prompt_len"],), np.int32), 2, temperature=0.7)
        warm.run()
        reps = [warm.report()]   # every batcher's report: the warm one, the dead one, the live
        del warm
        clock = FakeClock()
        fronts = []

        def factory(rid, gen):
            fronts.append((rid, gen))
            return ServeFront(c, prm, clock=clock, batcher=ContinuousBatcher(c, prm, bcfg))

        mem["before_fleet"] = allocated()
        cluster = ClusterFront(factory, ClusterConfig(
            num_replicas=n_replicas, min_affinity_tokens=d["shared_len"],
            flight_dir=flight_dir, respawn=RespawnConfig(backoff_base_s=0.5, jitter_frac=0.0)),
            clock=clock)
        mem["fleet"] = allocated()
        by_req, records = {}, []
        for i in range(d["n"]):
            if kill_at is not None and i == kill_at:
                reps.append(cluster.replicas[0].front.batcher.report())
                cluster.kill_replica(0, "chaos")
                mem["after_kill"] = allocated()
            clock.advance(float(gaps[i]))
            sampled = i % 2 == 1
            by_req[cluster.submit(Request(
                prompt_ids=prompts[i].copy(), max_new_tokens=d["new_tokens"],
                temperature=0.7 if sampled else 0.0, rng_seed=100 + i if sampled else 0,
                deadline_s=600.0))] = i
        mem["after_respawn"] = allocated()
        while True:
            recs = cluster.drain()
            if recs:
                records.extend(recs)
                continue
            if not cluster.pending:
                break
            ev = cluster.next_event_s()
            if ev is None:
                break
            clock.set_time(max(ev, clock.now))
        sync()
        if count:
            mem["launches"] = read_counts()
        if on_dev:
            mem["peak"] = torch.cuda.max_memory_allocated()
        reps.extend(r.front.batcher.report() for _, r in sorted(cluster.replicas.items())
                    if r.front is not None)
        toks = {by_req[r.request_id]: (r.outcome, None if r.tokens is None
                                       else np.asarray(r.tokens).reshape(-1).tolist())
                for r in records}
        return {"tokens": toks, "report": json.loads(json.dumps(cluster.report(), default=float)),
                "pending": cluster.pending, "dumps": cluster.flight_dumps(),
                "fronts_built": fronts, "batcher_reports": reps, "mem": mem}

    fr_dir = tempfile.mkdtemp(prefix="cluster_flight_")
    try:
        chaos = drill(cfg, params, device, 2, DRILL["kill_at"], os.path.join(fr_dir, "chaos"),
                      count=True)
        alone = drill(cfg, params, device, 1, None, os.path.join(fr_dir, "alone"))
        small_runs = {dev: drill(small_cfg, prm, dev, 2, DRILL["kill_at"],
                                 os.path.join(fr_dir, f"small_{dev}"))
                      for dev, prm in (((device, small), ("cpu", small_cpu)) if on_card
                                       else (("cpu", small_cpu),))}
    finally:
        shutil.rmtree(fr_dir, ignore_errors=True)
    launches = chaos["mem"].pop("launches")
    want = _sum_counts(_batcher_counts(n_layers, rep) for rep in chaos["batcher_reports"])
    mem = chaos["mem"]
    pool = mem["fleet"] - mem["before_fleet"] if on_card else None
    n = DRILL["n"]
    cross = {k: small_runs[device][k] == small_runs["cpu"][k]
             for k in ("tokens", "report", "pending")}
    drill_row = {
        "replicas_ran": "in turn on one device",
        "completed": sum(o == "completed" for o, _ in chaos["tokens"].values()),
        "accepted_lost": chaos["pending"] + n - len(chaos["tokens"]),
        "streams_identical": chaos["tokens"] == alone["tokens"],
        "flight_dumps": len(chaos["dumps"]), "readmitted": chaos["report"]["totals"]["readmitted"],
        "kills": chaos["report"]["kills"], "fronts_built": chaos["fronts_built"],
        "totals": chaos["report"]["totals"], "memory_bytes": mem,
        "pool_bytes_per_replica": None if pool is None else pool // 2,
        "dead_pool_freed": None if pool is None else (
            mem["after_kill"] == mem["fleet"] - pool // 2
            and mem["after_respawn"] <= mem["fleet"]),
        "card_vs_cpu_2_layers": cross, "launches": launches, "launches_expected": want}
    log(json.dumps({"cluster_kill_drill": drill_row}))
    rows["kill drill"] = drill_row
    if drill_row["completed"] != n or drill_row["accepted_lost"] \
            or not drill_row["streams_identical"] or drill_row["flight_dumps"] != 1 \
            or drill_row["readmitted"] < 1:
        raise SystemExit(f"kill drill: {drill_row}")
    if on_card and (launches_differ(launches, want) or not drill_row["dead_pool_freed"]):
        raise SystemExit(f"kill drill: launches {launches} against {want}, memory {mem}")
    if not all(cross.values()):
        raise SystemExit(f"kill drill card vs CPU at {CLUSTER_SMALL_LAYERS} layers: {cross}")
    out["cluster kill drill"] = launches
    lap("kill drill")

    # (e) the simulated soaks: host code on the virtual clock, no device work
    def sim_soak(n_replicas, soak, gray=None, flight_dir=None):
        clock = FakeClock()
        scfg = SimReplicaConfig(deadline_propagation=gray is not None and gray.enabled)
        cluster = ClusterFront(
            lambda rid, gen: SimReplicaFront(scfg, clock=clock, replica_id=rid),
            ClusterConfig(num_replicas=n_replicas, flight_dir=flight_dir,
                          gray=gray or GrayConfig(),
                          respawn=RespawnConfig(backoff_base_s=0.5, jitter_seed=args.seed)),
            clock=clock)
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.monotonic()
        art = run_cluster_soak(cluster, soak, clock=clock)
        wall = time.monotonic() - t0
        art["host_wall_s"] = wall
        art["requests_per_s_host"] = soak.n_requests / wall
        art["maxrss_growth_kib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0
        art["pending"] = cluster.pending
        return art

    fr_dir = tempfile.mkdtemp(prefix="cluster_sim_")
    try:
        n_chaos = SIM_CHAOS["n_requests"] if model == "qwen2-0.5b" else 2000
        sim_chaos = sim_soak(4, ClusterSoakConfig(**{**SIM_CHAOS, "n_requests": n_chaos},
                                              seed=args.seed), flight_dir=fr_dir)
    finally:
        shutil.rmtree(fr_dir, ignore_errors=True)
    armed = GrayConfig(enabled=True, min_dwell_s=0.5, min_samples=8, window_s=30.0,
                       max_hedge_fraction=0.4)
    hedged = sim_soak(3, ClusterSoakConfig(**SIM_GRAY), gray=armed)
    unhedged = sim_soak(3, ClusterSoakConfig(**SIM_GRAY))
    sim_row = {
        "host_only": "simulated replicas on the virtual clock; no device work",
        "chaos": {k: sim_chaos[k] for k in ("requests", "outcomes", "token_identity", "readmitted",
                                        "respawns", "host_wall_s", "requests_per_s_host",
                                        "maxrss_growth_kib", "pending")}
        | {"kills": len(sim_chaos["kills"]), "flight_dumps": len(sim_chaos["flight_dumps"])},
        "gray": {leg: {k: a[k] for k in ("outcomes", "slo_goodput", "hedges", "hedge_fraction",
                                         "deadline_expired", "token_identity", "host_wall_s",
                                         "requests_per_s_host", "pending")}
                 for leg, a in (("hedged", hedged), ("unhedged", unhedged))},
        "hedged_over_unhedged_slo_goodput":
            hedged["slo_goodput"] / max(unhedged["slo_goodput"], 1e-9)}
    sim_row["chaos"]["token_identity"] = {k: v for k, v in sim_chaos["token_identity"].items()
                                          if k != "mismatched_ids"}
    log(json.dumps({"cluster_sim_soaks": sim_row}))
    rows["sim soaks"] = sim_row
    ti = sim_chaos["token_identity"]
    if not ti["ok"] or not ti["checked"] or sim_chaos["pending"] \
            or sum(sim_chaos["outcomes"].values()) != n_chaos \
            or len(sim_chaos["flight_dumps"]) != 2 or sim_chaos["respawns"] != 2:
        raise SystemExit(f"simulated chaos soak: {sim_row['chaos']}")
    if not hedged["token_identity"]["ok"] or hedged["pending"] \
            or hedged["outcomes"].get("failed", 0) \
            or sum(hedged["outcomes"].values()) != SIM_GRAY["n_requests"]:
        raise SystemExit(f"gray soak: {sim_row['gray']}")
    lap("sim soaks")
    rows["part_s"] = part_s
    log(json.dumps({"cluster_part_s": part_s}))
    detail["cluster"] = rows
    del params, small, small_cpu
    if on_card:
        torch.cuda.empty_cache()
    return out


#: phase 22's shipped configs; the depth and length of its card-against-CPU
#: checks; the chunks each CLI run takes
SPLIT5_CONFIG = "configs/split5_qwen_ring_long.json"
SPLIT5B_CONFIG = "configs/split5b_qwen_ring_selective.json"
RING_SMALL_LAYERS = 2
RING_CROSS_SEQ = 512
RING_CHUNKS = 2
#: split5 over the ring against the dense split (n_seq 1) on the card, PPL
#: relative: the same int4 hop bytes, attention summed blockwise (plain
#: float32) against K-attn's 3xTF32 tiles; a code that sits on an int4
#: rounding boundary may move a step (the card's splits read 3.21e-5
#: against the CPU)
RING_DENSE_RTOL = 1e-4
#: importance_sp (plain float32 blocks) against the dense K-stats
#: importance at full depth on the card, absolute (importance lies in [0, 1])
RING_IMP_ATOL = 1e-4
#: the card against the CPU at 2 layers: logits (atol, rtol) as the
#: other card-vs-CPU forwards (PAGED_CROSS_TOL's fp tolerance); the
#: statistics' importance as K-stats against its plain version (STATS_TOL)
RING_CROSS_TOL = (1e-4, 1e-4)
#: the reference test's bound on the local mode's |dNLL| against global
RING_DNLL_MAX = 0.02


def long_context_paths(args, detail: dict, device: str = "cuda",
                       model: str = "qwen2-0.5b") -> dict:
    """Phase 22: long context, the stage x seq runtime, fp32 random weights
    from ``--seed`` (the CLI's default), full Qwen2-0.5B width and depth,
    S = 2048 in 4 sequence shards (the shards run in turn on the one
    device). (0) K1-K4 at the ring's shapes (one shard's rows, and a group
    of two windows') against their plain versions, bit for bit. (a)
    configs/split5_qwen_ring_long.json and split5b_qwen_ring_selective.json
    through ``run.main`` as shipped, :data:`RING_CHUNKS` chunks (one group),
    split5 once before to warm up, the counts set to 0 just before each run:
    PPL, bytes per token, s/chunk, K1 / K2 exactly 4 a group plus 4 a timed
    hop (split5), no kernel (split5b: the ring's attention and the selective
    codec are plain ops); split5 again with n_seq 1 (the dense split:
    K-attn 24 a group, K1 / K2 one a group and a timed hop), its PPL within
    :data:`RING_DENSE_RTOL` and its bytes per token equal. (b) the ring
    codec's global mode against the dense
    ``selective_int4`` on one importance vector (the decoded boundary bit for
    bit) and ``importance_sp`` against the dense K-stats importance. (c) a
    :data:`RING_SMALL_LAYERS`-layer ring forward and ``importance_sp`` on the
    card and on the CPU. (d) the ring under the link with an int8_per_token
    hop: a zero-rate link's logits bit for bit the link-free ones; at
    drop_rate 0.5, seed 11, six fault steps, the counters a CPU run's and K3
    / K4 once a shard's hop encoded / a copy sent. (e)
    ``tools/ring_mode_gap.measure`` at split5b's shape (bf16 weights, 2
    windows): |dNLL| per ratio -> launches by path.
    ``long_context_paths(args, {}, device="cpu", model="tiny-qwen2")``
    rehearses it on the CPU (cut 2, S = 64)."""
    import gc

    import torch

    from edgellm_tpu_torch.codecs import codec_kernels as ck
    from edgellm_tpu_torch.codecs.faults import FaultConfig, LinkPolicy
    from edgellm_tpu_torch.codecs.packing import SATURATE_MAG, selective_int4
    from edgellm_tpu_torch.codecs.ring_codecs import ring_selective_int4
    from edgellm_tpu_torch.eval.split_eval import _importance
    from edgellm_tpu_torch.models import PRESETS, init_params, params_to
    from edgellm_tpu_torch.models.flash_attention import kernel_plan
    from edgellm_tpu_torch.parallel import SplitRingRuntime, forward_sp, importance_sp
    from edgellm_tpu_torch.tools.ring_mode_gap import measure

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    full = model == "qwen2-0.5b"
    cfg = PRESETS[model]
    n_seq, card = 4, detail.get("card", "a CPU rehearsal")
    seq, cut, stride = (2048, 11, 128) if full else (64, 2, 16)
    cross_seq = RING_CROSS_SEQ if full else seq
    rows, out, part_s = {}, {}, {}
    t_part = [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        part_s[name] = now - t_part[0]
        t_part[0] = now

    # (0) the codec kernels at the shapes the ring's hops give them
    gen = torch.Generator(device=device).manual_seed(args.seed)
    kernel_rows = []
    for n in (seq // n_seq, 2 * seq // n_seq):
        x = torch.randn((n, cfg.hidden_size), generator=gen, device=device)
        enc, enc_plain = ck.int4_encode(x), ck.int4_encode_plain(x)
        dec, dec_plain = ck.int4_decode(*enc), ck.int4_decode_plain(*enc_plain)
        q8, q8_plain = (ck.int8_affine_encode(x, max_mag=SATURATE_MAG),
                        ck.int8_affine_encode_plain(x))
        d8, d8_plain = ck.int8_affine_decode(*q8), ck.int8_affine_decode_plain(*q8_plain)
        same = {"int4_encode": all(_same(a, b) for a, b in zip(enc, enc_plain)),
                "int4_decode": _same(dec, dec_plain),
                "int8_affine_encode": all(_same(a, b) for a, b in zip(q8, q8_plain)),
                "int8_affine_decode": _same(d8, d8_plain)}
        kernel_rows.append({"n": n, "d": cfg.hidden_size, "bit_for_bit": same})
        if not all(same.values()):
            raise SystemExit(f"phase 22 kernels at N={n}: {same}")
    lap("kernels")

    # (a) split5, split5b and split5 dense through run.main
    base = ["--model", model, "--seed", str(args.seed), "--device", device,
            "--max-chunks", str(RING_CHUNKS)]
    with open(SPLIT5_CONFIG) as f:
        p5 = json.load(f)
    with open(SPLIT5B_CONFIG) as f:
        p5b = json.load(f)
    if not full:  # the cut inside the tiny model, a short window
        p5.update(cuts=[cut], max_length=seq, stride=stride)
        p5b.update(cuts=[cut], max_length=seq, stride=stride)

    def cli(p, label):
        with tempfile.TemporaryDirectory() as tmp:
            sync()
            reset_counts()
            t0 = time.monotonic()
            rc, printed = _cli_json_line(["--params", json.dumps(p), "--output-dir", tmp]
                                         + base)
            sync()
            wall = time.monotonic() - t0
            launches = read_counts()
        if rc != 0 or printed["chunks"] != RING_CHUNKS or not np.isfinite(printed["ppl"]):
            raise SystemExit(f"{label}: run.main exited {rc}: {printed}")
        return printed, launches, wall

    groups, hop_iters = 1, 1 + 20  # the CLI's window batch 8 takes both chunks
    n_layers = cfg.num_layers
    attn = n_layers * groups if kernel_plan(seq, cfg.num_heads, cfg.num_kv_heads,
                                            cfg.head_dim, 4) else 0
    ring_want = want_counts(0, int4_encode=n_seq * (groups + hop_iters),
                            int4_decode=n_seq * (groups + hop_iters))
    # the first ring run pays the plain ops' first calls at these shapes
    # (4.79 s/chunk against 0.32 for split5b after it, on the H100): warm up
    legs = (("split5 ring warm-up", p5, ring_want), ("split5 ring", p5, ring_want),
            ("split5b ring", p5b, want_counts(0)),
            ("split5 dense", {**p5, "n_seq": 1},
             want_counts(attn, causal_attention=attn,
                         int4_encode=groups + 2 * hop_iters, int4_decode=groups + 2 * hop_iters)))
    for label, p, want in legs:
        printed, launches, wall = cli(p, label)
        if not on_card:
            want = want_counts(0)
        row = {"path": label, "card": card, "n_seq": p["n_seq"],
               "shards_ran": "in turn on one device", "ppl": printed["ppl"],
               "chunks": printed["chunks"], "mesh": printed["mesh"],
               "hop_codecs": printed["hop_codecs"],
               "bytes_per_token_per_hop": printed["bytes_per_token_per_hop"],
               "s_per_chunk": printed["wall_s"] / printed["chunks"], "wall_s": wall,
               "per_hop_ms": printed.get("per_hop_ms"), "pad_fraction": printed["pad_fraction"],
               "launches": {k: v for k, v in launches.items() if v},
               "launches_expected": {k: v for k, v in want.items() if v}}
        log(json.dumps({"long_context": row}))
        rows[label] = row
        if "warm-up" not in label:
            out[label] = launches
        if launches_differ(launches, want):
            raise SystemExit(f"{label}: kernel launches {launches} != expected {want}")
    ring, dense = rows["split5 ring"], rows["split5 dense"]
    rel = abs(ring["ppl"] - dense["ppl"]) / dense["ppl"]
    rows["ring_vs_dense"] = {"ppl_rel_diff": rel, "rtol": RING_DENSE_RTOL,
                             "bytes_equal": ring["bytes_per_token_per_hop"]
                             == dense["bytes_per_token_per_hop"]}
    log(f"  split5 ring vs dense ({card}): PPL {ring['ppl']} vs {dense['ppl']} (rel "
        f"{rel:.3e}), s/chunk {ring['s_per_chunk']:.4f} vs {dense['s_per_chunk']:.4f}, "
        f"split5b s/chunk {rows['split5b ring']['s_per_chunk']:.4f}")
    if rel > RING_DENSE_RTOL or not rows["ring_vs_dense"]["bytes_equal"]:
        raise SystemExit(f"split5 ring vs dense: {rows['ring_vs_dense']}")
    lap("cli")

    # (b) the ring codec against the dense codec; ring against K-stats importance
    h = torch.randn((1, seq, cfg.hidden_size), generator=gen, device=device)
    imp = torch.round(torch.rand((seq,), generator=gen, device=device) * 64) / 64  # ties
    dense_codec = selective_int4(0.25, "bf16")
    want_h = dense_codec.decode(dense_codec.encode(h, imp))
    ring_codec = ring_selective_int4(0.25, "bf16", n_seq=n_seq, mode="global")
    pays = ring_codec.encode(list(torch.chunk(h, n_seq, dim=1)), list(torch.chunk(imp, n_seq)))
    got_h = torch.cat([ring_codec.decode(p) for p in pays], dim=1)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                         device=device)
    ids = torch.as_tensor(np.random.default_rng(args.seed).integers(0, cfg.vocab_size,
                                                                    (1, seq)), device=device)
    with torch.inference_mode():
        imp_ring = importance_sp(cfg, params, ids, n_seq, "last_row", device=device)
        imp_dense = _importance(cfg, params, ids, "last_row", None)
    imp_err = float((imp_ring - imp_dense).abs().max())
    rows["codec_and_importance"] = {"global_decode_bit_for_bit": _same(got_h, want_h),
                                    "importance_max_abs_diff": imp_err,
                                    "importance_atol": RING_IMP_ATOL, "layers": n_layers}
    log(json.dumps({"long_context": rows["codec_and_importance"]}))
    if not _same(got_h, want_h) or imp_err > RING_IMP_ATOL:
        raise SystemExit(f"ring codec / importance: {rows['codec_and_importance']}")
    lap("codec_importance")

    # (c) the card against the CPU at 2 layers
    small_cfg, small = _small_model(cfg, params, RING_SMALL_LAYERS)
    small_cpu = params_to(small, device="cpu")
    ids_x = ids[:, :cross_seq]
    with torch.inference_mode():
        got = [forward_sp(small_cfg, small, ids_x, n_seq, device=device).cpu(),
               importance_sp(small_cfg, small, ids_x, n_seq, "last_row", device=device).cpu()]
        want = [forward_sp(small_cfg, small_cpu, ids_x.cpu(), n_seq, device="cpu"),
                importance_sp(small_cfg, small_cpu, ids_x.cpu(), n_seq, "last_row",
                              device="cpu")]
    logit_err, imp_x_err = (float((a - b).abs().max()) for a, b in zip(got, want))
    ok = (torch.allclose(got[0], want[0], atol=RING_CROSS_TOL[0], rtol=RING_CROSS_TOL[1])
          and imp_x_err <= STATS_TOL[0])
    rows["card_vs_cpu"] = {"layers": RING_SMALL_LAYERS, "seq": cross_seq,
                           "logits_max_abs_diff": logit_err, "logits_tol": RING_CROSS_TOL,
                           "importance_max_abs_diff": imp_x_err, "importance_atol": STATS_TOL[0]}
    log(json.dumps({"long_context": rows["card_vs_cpu"]}))
    if not ok:
        raise SystemExit(f"ring card vs CPU: {rows['card_vs_cpu']}")
    lap("card_vs_cpu")

    # (d) the ring under the link
    def ring_rt(cfg_, dev, **link):
        return SplitRingRuntime(cfg_, (cut,), ("int8_per_token",), n_seq, dev, **link)

    with torch.inference_mode():
        free = ring_rt(cfg, device)
        logits0 = free.forward(free.place_params(params), ids)
        zero = ring_rt(cfg, device, faults=FaultConfig(byte_budget=10**9),
                       policy=LinkPolicy(max_retries=1))
        logits1 = zero.forward(zero.place_params(params), ids, fault_step=2)
        zero_ok = _same(logits1, logits0) and zero.link_counters()["hops"].tolist() == [n_seq]
        del logits0, logits1
        faulty = dict(faults=FaultConfig(drop_rate=0.5, seed=11), policy=LinkPolicy(max_retries=3))
        rt_f = ring_rt(cfg, device, **faulty)
        placed = rt_f.place_params(params)
        sync()
        reset_counts()
        for step in range(6):
            logits_f = rt_f.forward(placed, ids, fault_step=step)
        sync()
        link_launches = read_counts()
        finite = bool(torch.isfinite(logits_f).all())
        del logits_f, placed
        rt_c = SplitRingRuntime(small_cfg, (0,), ("int8_per_token",), n_seq, "cpu", **faulty)
        placed_c = rt_c.place_params(small_cpu)
        for step in range(6):
            rt_c.forward(placed_c, ids[:, :64].cpu(), fault_step=step)
    counters = {k: v.tolist() for k, v in rt_f.link_counters().items()}
    cpu_counters = {k: v.tolist() for k, v in rt_c.link_counters().items()}
    copies = counters["hops"][0] + counters["retried"][0]
    want = want_counts(0, int8_affine_encode=6 * n_seq, int8_affine_decode=copies) \
        if on_card else want_counts(0)
    rows["link"] = {"zero_rate_bit_for_bit": zero_ok, "counters": counters,
                    "cpu_counters": cpu_counters, "finite": finite,
                    "launches": {k: v for k, v in link_launches.items() if v}}
    log(json.dumps({"long_context": rows["link"]}))
    out["ring link"] = link_launches
    if not zero_ok or counters != cpu_counters or not finite \
            or launches_differ(link_launches, want):
        raise SystemExit(f"ring under the link: {rows['link']} (launches expected {want})")
    del params, small, free, zero, rt_f
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    lap("link")

    # (e) the local mode's gap against the global mode at split5b's shape
    gap = (measure(device=device) if full else
           measure(model, seq=seq, cut=cut, windows=1, device=device))
    worst = {r: max(g["dnll"] for g in gap if g["ratio"] == r) for r in (0.25, 0.5)}
    rows["ring_mode_gap"] = {"card": card, "records": gap, "worst_dnll_by_ratio": worst}
    log(json.dumps({"long_context": {"ring_mode_gap_worst_dnll": worst, "card": card}}))
    if not all(np.isfinite(g["dnll"]) and g["dnll"] <= RING_DNLL_MAX for g in gap):
        raise SystemExit(f"ring_mode_gap: {gap}")
    lap("ring_mode_gap")
    rows["kernels"] = kernel_rows
    rows["part_s"] = part_s
    detail["long_context"] = rows
    return out


#: phase 23's configs; the chunks of its Qwen2-0.5B runs (one group of 8
#: windows and one of 1, padded to the data axis) and of its other shapes
SPLIT1_CONFIG = "configs/split1_qwen_int8.json"
SPLIT2_CONFIG = "configs/split2_qwen_mixed48.json"
SPLIT4_CONFIG = "configs/split4_qwen15_multihop.json"
SPLIT0_CONFIG = "configs/split0_pythia_noquant.json"
BASELINE_TABLE_CONFIG = "configs/qwen_baseline_table.json"
MESH_CHUNKS, MESH_SMALL_CHUNKS = 9, 2
#: the tensor-parallel shard shapes phase 3 holds K-attn and K-stats at
#: (label, b, s, h, kv, hd): Qwen2-0.5B's 14 over 2 heads in two shards,
#: Qwen2-1.5B's 12 over 2 in two, Pythia-70M's 8 over 8 in four
TP_SHAPES = (("qwen2-0.5b tp2", 8, 512, 7, 1, 64), ("qwen2-1.5b tp2", 2, 512, 6, 1, 128),
             ("pythia-70m tp4", 2, 2048, 2, 2, 64))
#: a mesh run against the plain split on the card, PPL relative: the same
#: windows through the same kernels, but a data group is a smaller batch
#: (cuBLAS may take another GEMM for it) and the shards' partial products
#: sum the output projections in another order; the int8 hop can then move
#: a code on a rounding boundary a step (the splits' card-vs-CPU bound)
MESH_RTOL = SPLIT_CROSS_RTOL
#: a tensor-parallel run over fp32 hops against the plain one: only the
#: shards' sums of the output projections differ (the CPU read 9.5e-7 at
#: Qwen2-1.5B's split4 cuts)
MESH_FP32_RTOL = 1e-5
#: split4's shipped int8 + int4 hops under tensor parallelism: an element
#: within the forward's rounding difference of an int4 code boundary moves
#: a whole int4 step (1/7 of its token's largest value), and 2 chunks score
#: 544 tokens; such moves read 1.46e-4 on the CPU (and 9.5e-7 over fp32
#: hops), so the TP math is held by the fp32-hop twin above
MESH_INT4_RTOL = 1e-3
#: the two-process run against the one-process run at n_data 2: each rank
#: runs its data group's rows through the same shapes and kernels, and the
#: gathered NLLs sum in the same order
DIST_RTOL = 1e-6
#: the codec kernels a hop codec launches on the card (its twin's encode
#: and decode)
HOP_KERNELS = {"int8_per_token": ("int8_affine_encode", "int8_affine_decode"),
               "int4_per_token": ("int4_encode", "int4_decode")}


def _mesh_want(cfg, p: dict, n_groups: int, n_data: int = 1, n_model: int = 1) -> dict:
    """The launches of a split CLI run over the mesh: K-attn (fp32: the
    CLI's weights) once a layer a data group a model shard a group; K-stats
    once a layer a group for an importance codec (the importance pass runs
    unsplit); each kernel hop's encode and decode once a data group a
    group, plus time_hops' :data:`HOP_ITERS`."""
    attn = cfg.num_layers * n_groups * n_data * n_model
    hops: dict = {}
    for codec in p["hop_codecs"]:
        for kernel in HOP_KERNELS.get(codec, ()):
            hops[kernel] = hops.get(kernel, 0) + n_groups * n_data + HOP_ITERS
    stats = cfg.num_layers * n_groups if "importance_method" in p else 0
    return want_counts(attn, causal_attention=attn, causal_attention_stats=stats, **hops)


def mesh_paths(args, detail: dict, device: str = "cuda", model: str = "qwen2-0.5b") -> dict:
    """Phase 23: the "data" and "model" mesh axes and the offline tools,
    fp32 random weights from ``--seed`` (the CLI's default), every run
    through ``run.main``. (a) configs/split1_qwen_int8.json at full
    Qwen2-0.5B width and depth (cut 11, int8_per_token, window 512, stride
    32, window batch 8, :data:`MESH_CHUNKS` chunks) as shipped and with
    inline ``n_model`` 2, ``n_data`` 2 and both: PPL within
    :data:`MESH_RTOL` of the plain run, bytes per token equal, s/chunk,
    peak memory, K-attn exactly layers x groups x n_data x n_model and K3 /
    K4 exactly n_data a group (plus time_hops'). (b) split2's selective hop
    at n_data 2 beside n_data 1 (K-stats 24 a group). (c)
    configs/split4_qwen15_multihop.json at n_model 2 (hd 128, three stages;
    as shipped within :data:`MESH_INT4_RTOL` and over fp32 hops within
    :data:`MESH_FP32_RTOL`) and configs/split0_pythia_noquant.json at
    n_model 4 (GPT-NeoX, S = 2048, an fp32 hop: :data:`MESH_FP32_RTOL`),
    :data:`MESH_SMALL_CHUNKS` chunks each, beside their plain runs.
    (d) ``--distributed``: two processes on the card (gloo for the host
    gather, each its data group on the card) at split1's n_data 2, each
    with a timeout of its own: both ranks print the same result, the
    one-process n_data 2 run's within :data:`DIST_RTOL`, and only rank 0's
    directory holds the checkpoint and the metrics. (e) the memory
    preflight: configs/qwen_baseline_table.json with ``BENCH_HBM_GB`` set
    between the estimates at window batch 4 and 8, so 8 does not fit: the
    batch the CLI chose, the estimate at it and the run's measured peak,
    which must be under the budget. (f) the refusals exit non-zero with the
    reference's messages: int4_global at n_data 2 and a pipeline at
    n_model 2 -> launches by path. ``mesh_paths(args, {}, device="cpu",
    model="tiny-qwen2")`` rehearses it on the CPU (cut 2, S = 64)."""
    import gc

    import torch

    from edgellm_tpu_torch import run
    from edgellm_tpu_torch.models import PRESETS
    from edgellm_tpu_torch.tools.wb_preflight import (_budget_bytes, estimate_from_costs,
                                                      probe_sweep_costs)

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    full = model == "qwen2-0.5b"
    cfg = PRESETS[model]
    card = detail.get("card", "a CPU rehearsal")
    rows, out, part_s = {}, {}, {}
    t_part = [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        part_s[name] = now - t_part[0]
        t_part[0] = now

    def load(path, **tiny):
        with open(path) as f:
            p = json.load(f)
        return p if full else {**p, **tiny}

    tiny_split = dict(cuts=[2], max_length=64, stride=16)
    split1, split2 = load(SPLIT1_CONFIG, **tiny_split), load(SPLIT2_CONFIG, **tiny_split)

    def cli(p, label, model_=model, chunks=MESH_CHUNKS):
        with tempfile.TemporaryDirectory() as tmp:
            sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.monotonic()
            rc, printed = _cli_json_line(
                ["--params", json.dumps(p), "--output-dir", tmp, "--model", model_,
                 "--seed", str(args.seed), "--device", device, "--window-batch", "8",
                 "--max-chunks", str(chunks)])
            sync()
            wall = time.monotonic() - t0
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated() if on_card else None
        if rc != 0 or printed["chunks"] != chunks or not np.isfinite(printed["ppl"]):
            raise SystemExit(f"{label}: run.main exited {rc}: {printed}")
        return printed, launches, wall, peak

    def leg(label, p, cfg_, plain_ppl=None, model_=model, chunks=MESH_CHUNKS,
            rtol=MESH_RTOL):
        n_data, n_model = p.get("n_data", 1), p.get("n_model", 1)
        printed, launches, wall, peak = cli(p, label, model_, chunks)
        n_groups = math.ceil(chunks / 8)
        want = _mesh_want(cfg_, p, n_groups, n_data, n_model) if on_card else want_counts(0)
        rel = None if plain_ppl is None else abs(printed["ppl"] - plain_ppl) / plain_ppl
        row = {"path": label, "card": card, "mesh": printed["mesh"], "ppl": printed["ppl"],
               "ppl_rel_diff_to_plain": rel, "chunks": printed["chunks"], "groups": n_groups,
               "bytes_per_token_per_hop": printed["bytes_per_token_per_hop"],
               "s_per_chunk": printed["wall_s"] / printed["chunks"], "wall_s": wall,
               "max_memory_allocated_bytes": peak, "per_hop_ms": printed.get("per_hop_ms"),
               "launches": {k: v for k, v in launches.items() if v},
               "launches_expected": {k: v for k, v in want.items() if v}}
        log(json.dumps({"mesh_path": row}))
        rows[label] = row
        out[label] = launches
        want_mesh = {"stage": len(p["cuts"]) + 1, "data": n_data, "model": n_model}
        if launches_differ(launches, want) or printed["mesh"] != want_mesh:
            raise SystemExit(f"{label}: launches {launches} != expected {want}, or mesh "
                             f"{printed['mesh']} != {want_mesh}")
        row["ppl_rtol"] = rtol
        if rel is not None and rel > rtol:
            raise SystemExit(f"{label}: PPL {printed['ppl']} against the plain {plain_ppl} "
                             f"(rel {rel:.3e} > {rtol})")
        return printed

    # (a) split1 plain (after a warm-up run), then over each mesh
    cli(split1, "split1 warm-up")
    plain = leg("split1 plain", split1, cfg)
    for axes in ({"n_model": 2}, {"n_data": 2}, {"n_data": 2, "n_model": 2}):
        tag = " ".join(f"{k} {v}" for k, v in axes.items())
        got = leg(f"split1 {tag}", {**split1, **axes}, cfg, plain["ppl"])
        if got["bytes_per_token_per_hop"] != plain["bytes_per_token_per_hop"]:
            raise SystemExit(f"split1 {tag}: bytes per token {got['bytes_per_token_per_hop']}"
                             f" != the plain {plain['bytes_per_token_per_hop']}")
    log(f"  split1 over the mesh ({card}): s/chunk " + ", ".join(
        f"{k[7:]} {r['s_per_chunk']:.4f}" for k, r in rows.items()) + "; peak GB " + ", ".join(
        f"{k[7:]} {(r['max_memory_allocated_bytes'] or 0) / 2**30:.2f}" for k, r in rows.items()))
    lap("split1")

    # (b) the selective split at n_data 2
    sel = leg("split2 plain", split2, cfg)
    leg("split2 n_data 2", {**split2, "n_data": 2}, cfg, sel["ppl"])
    lap("split2")

    # (c) the other two shapes: Qwen2-1.5B at n_model 2 (as shipped and over
    # fp32 hops), Pythia-70M at 4 (split0's hop is fp32)
    others = ((SPLIT4_CONFIG, "qwen2-1.5b", 2, dict(cuts=[1, 3], max_length=64, stride=16)),
              (SPLIT0_CONFIG, "pythia-70m", 4, dict(cuts=[1], max_length=64, stride=16)))
    for path, name, n_model, tiny in others:
        p = load(path, **tiny)
        model_ = name if full else ("tiny-qwen2" if "qwen" in name else "tiny-neox")
        cfg_ = PRESETS[model_]
        tag = os.path.basename(path)[:-5]
        twins = [(p, MESH_INT4_RTOL if "int4_per_token" in p["hop_codecs"] else MESH_FP32_RTOL)]
        if any(c != "fp32" for c in p["hop_codecs"]):
            twins.append(({**p, "hop_codecs": ["fp32"] * len(p["cuts"])}, MESH_FP32_RTOL))
        for q, rtol in twins:
            hops = "" if q is p else " fp32 hops"
            base_run = leg(f"{tag}{hops} plain", q, cfg_, model_=model_,
                           chunks=MESH_SMALL_CHUNKS)
            leg(f"{tag}{hops} n_model {n_model}", {**q, "n_model": n_model}, cfg_,
                base_run["ppl"], model_=model_, chunks=MESH_SMALL_CHUNKS, rtol=rtol)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    lap("other_shapes")

    # (d) --distributed: two processes on the one card at split1's n_data 2
    one = rows["split1 n_data 2"]
    with tempfile.TemporaryDirectory() as tmp:
        argv = lambda r: [sys.executable, "-m", "edgellm_tpu_torch.run",  # noqa: E731
                          "--distributed", "--params", json.dumps({**split1, "n_data": 2}),
                          "--model", model, "--seed", str(args.seed), "--device", device,
                          "--window-batch", "8", "--max-chunks", str(MESH_CHUNKS),
                          "--output-dir", os.path.join(tmp, f"r{r}")]
        t0 = time.monotonic()
        done = _spawn_ranks(argv, tmp)
        wall = time.monotonic() - t0
        lines = [json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
                 for text in done]
        wrote = {r: sorted(os.listdir(os.path.join(tmp, f"r{r}"))) for r in (0, 1)}
    keys = ("ppl", "n_tokens", "chunks", "measured_hop_bytes_total", "mesh")
    same = all(lines[0][k] == lines[1][k] for k in keys)
    rel = abs(lines[0]["ppl"] - one["ppl"]) / one["ppl"]
    rows["distributed"] = {"card": card, "processes": 2, "wall_s": wall,
                           "ppl_by_rank": [ln["ppl"] for ln in lines],
                           "one_process_ppl": one["ppl"], "ppl_rel_diff": rel,
                           "ranks_equal": same, "files_by_rank": wrote,
                           "s_per_chunk_by_rank": [ln["wall_s"] / ln["chunks"] for ln in lines]}
    log(json.dumps({"mesh_path": {"distributed": rows["distributed"]}}))
    writer = {"split_checkpoint.json", "split_metrics.jsonl"}
    if (not same or rel > DIST_RTOL or not writer <= set(wrote[0])
            or writer & set(wrote[1]) or lines[0]["mesh"] != one["mesh"]):
        raise SystemExit(f"--distributed: {rows['distributed']}")
    lap("distributed")

    # (e) the memory preflight on the token sweep
    sweep = load(BASELINE_TABLE_CONFIG, layers_of_interest=[1, 3], max_length=64, stride=16)
    import argparse as ap

    t_cfg, t_params = run._load_model(ap.Namespace(weights=None, model=model, seed=args.seed),
                                      torch.device(device))
    reader = None if on_card else (lambda call: (call(), 0)[1])  # the CPU has no peak stats
    layers = tuple(sweep["layers_of_interest"])
    costs = probe_sweep_costs(t_cfg, sweep["max_length"], sweep["stride"] + 1, min(layers),
                              "int4_token_select",
                              sum(1 for r in sweep["ratios"] if float(r) != 0.0),
                              torch.float32, layers, params=t_params, device=device,
                              peak_reader=reader)
    est = {wb: estimate_from_costs(t_cfg, costs, wb, sweep["max_length"], torch.float32,
                                   layers)["peak"] for wb in (1, 2, 4, 8)}
    frac = 0.8
    hbm_gb = (est[4] + est[8]) / 2 / frac / 2 ** 30
    del t_params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    os.environ["BENCH_HBM_GB"] = repr(hbm_gb)
    try:
        budget = _budget_bytes(None, frac, device) if on_card else None
        with tempfile.TemporaryDirectory() as tmp:
            sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            rc, printed = _cli_run(["--params", json.dumps(sweep), "--model", model, "--seed",
                                    str(args.seed), "--device", device, "--window-batch", "8",
                                    "--max-chunks", str(MESH_CHUNKS), "--output-dir", tmp])
            sync()
            measured = torch.cuda.max_memory_allocated() if on_card else None
    finally:
        del os.environ["BENCH_HBM_GB"]
    chose = [ln for ln in printed if "exceeds the memory budget" in ln]
    wb = int(chose[0].rsplit(" ", 1)[1]) if chose else 8
    row = {"card": card, "bench_hbm_gb": hbm_gb, "budget_frac": frac, "budget_bytes": budget,
           "estimate_bytes_by_batch": est, "chosen_window_batch": wb, "printed": chose,
           "estimate_at_chosen": est.get(wb), "measured_peak_bytes": measured,
           "estimate_error": (None if measured is None or wb not in est
                              else (est[wb] - measured) / measured)}
    rows["preflight"] = row
    log(json.dumps({"mesh_path": {"preflight": row}}))
    if rc != 0 or (on_card and (wb != 4 or measured > budget)):
        raise SystemExit(f"the preflight: rc {rc}, {row}")
    lap("preflight")

    # (f) the refusals exit non-zero, with the reference's words
    refusals = (({**split1, "hop_codecs": ["int4_global"], "n_data": 2},
                 "compute scales over the batch axis and would diverge"),
                ({**split1, "n_model": 2, "pipeline": {"num_microbatches": 2}},
                 "micro-batch pipelining supports stage-only meshes"))
    for p, words in refusals:
        with tempfile.TemporaryDirectory() as tmp:
            try:
                rc, msg = _cli_run(["--params", json.dumps(p), "--output-dir", tmp, "--model",
                                    model, "--device", device, "--max-chunks", "1"])[0], ""
            except (ValueError, SystemExit) as e:
                rc, msg = 1, str(e)
        rows.setdefault("refusals", []).append({"params": p, "message": msg})
        if rc == 0 or words not in msg:
            raise SystemExit(f"refusal of {p}: exit {rc}, {msg!r}")
    log(json.dumps({"mesh_path": {"refusals": rows["refusals"]}}))
    lap("refusals")
    rows["part_s"] = part_s
    detail["mesh"] = rows
    return out


def _spawn_ranks(argv_of, out_dir: str, nprocs: int = 2, timeout: int = 300) -> list:
    """Start one process per rank from the repository root with the env://
    rendezvous variables (a free localhost port), its output to a file;
    each waits at most ``timeout`` seconds, a rank still running is killed,
    and every rank must exit 0 -> each rank's output."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(nprocs),
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w+") for r in range(nprocs)]
    procs = [subprocess.Popen(argv_of(r), env={**env, "RANK": str(r)}, cwd=root,
                              stdout=logs[r], stderr=subprocess.STDOUT, text=True)
             for r in range(nprocs)]
    texts = []
    try:
        for proc in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc in procs:  # no rank outlives the phase
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log_f in logs:
            log_f.seek(0)
            texts.append(log_f.read())
            log_f.close()
    for r, (proc, text) in enumerate(zip(procs, texts)):
        if proc.returncode != 0:
            raise SystemExit(f"--distributed rank {r} exited {proc.returncode}:\n{text[-3000:]}")
    return texts


#: the lattice rows phase 24 holds to exact launches (config, entry point)
#: and the arithmetic behind them, at the lint's card geometry: K-attn and
#: K13 / K14 once a layer, K-stats once a stats layer (the tiny model's
#: clamped layer 3: layers 0-3), each hop codec's kernels once a hop
def _lint_lattice_launches(layers: int) -> dict:
    from edgellm_tpu_torch.lint.contracts import hop_launches

    return {("split4_qwen15_multihop", "split.forward"): {
                "causal_attention": layers,
                **hop_launches(["int8_per_token", "int4_per_token"])},
            ("qwen_token_sweep", "eval.stats_forward"): {"causal_attention_stats": layers},
            ("split9_qwen_paged", "batched.step"): {"paged_decode_attention": layers},
            ("split14_qwen_kvq", "batched.step_quant"): {
                "paged_decode_attention_quant": layers}}


def lint_paths(args, detail: dict) -> dict:
    """Phase 24: ``python3 -m edgellm_tpu_torch.run --lint`` on the card as
    a user runs it (a subprocess; a non-zero exit fails the run), its
    report and capability matrix read back: every contract clean with
    host_sync checked, its launches beside the declared ones, the lattice's
    exact rows (:func:`_lint_lattice_launches`), each config's footprint
    beside its budget; then ``python -m edgellm_tpu_torch.lint --device cpu
    --graph-only``, whose clean contracts must be the card's -> the card
    lint's launches, by kernel."""
    from edgellm_tpu_torch.lint.entrypoints import CARD_GEOMETRY

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "chip_smoke", "lint")
    os.makedirs(out_dir, exist_ok=True)
    card_json, cpu_json = (os.path.join(out_dir, f"{n}.json") for n in ("card", "cpu"))
    matrix_json = os.path.join(out_dir, "capability_matrix.json")
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("EDGELLM_FUSED_HOP", None)
    runs = {"card": ["-m", "edgellm_tpu_torch.run", "--lint", "--json", card_json,
                     "--matrix", matrix_json],
            "cpu": ["-m", "edgellm_tpu_torch.lint", "--device", "cpu", "--graph-only",
                    "--json", cpu_json]}
    for path in (card_json, cpu_json, matrix_json):
        if os.path.exists(path):
            os.remove(path)
    # the two runs side by side: the card's and the host's, each its own process
    t0 = time.monotonic()
    procs = {label: subprocess.Popen([sys.executable, *argv], cwd=root, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
             for label, argv in runs.items()}
    walls, texts = {}, {}
    try:
        for label, proc in procs.items():
            texts[label] = proc.communicate(timeout=600)
            walls[label] = time.monotonic() - t0
    finally:
        for proc in procs.values():  # no lint outlives the phase
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for label, proc in procs.items():
        out_text, err_text = texts[label]
        last = out_text.strip().splitlines()[-1][:300] if out_text.strip() else ""
        log(f"lint {label}: exit {proc.returncode} after {walls[label]:.2f} s: {last}")
        if proc.returncode != 0:
            raise SystemExit(f"lint ({label}) exited {proc.returncode}:\n"
                             f"{out_text[-4000:]}\n{err_text[-2000:]}")
    with open(card_json) as f:
        card = json.load(f)
    with open(cpu_json) as f:
        cpu = json.load(f)
    with open(matrix_json) as f:
        matrix = json.load(f)
    contracts = card["details"]["contracts"]
    bad = []
    for name in sorted(set(contracts) | set(card["checked_contracts"]) - {
            c for c in card["checked_contracts"] if c.startswith("lattice.")}):
        d = contracts.get(name, {})
        sync = d.get("host_sync")
        log(f"lint contract {name}: {'clean' if name in card['checked_contracts'] else 'FINDING'}"
            + (f"; launches {d['launches']} declared {d.get('launches_declared')}"
               if "launches_declared" in d else "")
            + (f"; host_sync checked, syncs at {sync.get('syncs') or 'none'}"
               + (f" (declared {sync['declared']})" if sync.get("declared") else "")
               if sync and sync.get("checked") else "")
            + ("; host_sync NOT checked" if sync and not sync.get("checked") else ""))
        if name not in card["checked_contracts"]:
            bad.append(f"{name} not clean")
        if sync is not None and not sync.get("checked"):
            bad.append(f"{name}: host_sync not checked on the card")
        if "launches_declared" in d and d["launches"] != d["launches_declared"]:
            bad.append(f"{name}: launches {d['launches']} != {d['launches_declared']}")
    layers = CARD_GEOMETRY["num_layers"]
    for (config, entry), want in _lint_lattice_launches(layers).items():
        got = matrix["configs"][config]["entrypoints"][entry].get("launches")
        log(f"lint lattice {config} {entry}: launches {got} declared {want}")
        if got != want:
            bad.append(f"lattice {config} {entry}: launches {got} != {want}")
    budget = card["details"].get("budget", {})
    for name, row in sorted(budget.items()):
        log(f"lint budget {name}: port {row['port_bytes']} B (increment + arguments at "
            f"the reference's geometry) / aot_peak_bytes {row['aot_peak_bytes']}")
        if row["port_bytes"] is None or row["port_bytes"] > row["aot_peak_bytes"]:
            bad.append(f"budget {name}: {row}")
    card_graph = {c for c in card["checked_contracts"] if not c.startswith("lattice.")}
    if set(cpu["checked_contracts"]) != card_graph or cpu["findings"]:
        bad.append(f"CPU clean set {sorted(cpu['checked_contracts'])} != card's "
                   f"{sorted(card_graph)} or CPU findings {cpu['findings']}")
    launches = card["details"].get("launches_total", {})
    row = {"wall_s": walls, "contracts_clean": len(card_graph),
           "lattice_clean": len(card["checked_contracts"]) - len(card_graph),
           "skipped_card": card["skipped"], "skipped_cpu": cpu["skipped"],
           "launches_total": launches, "budget": budget,
           "sync_sites": {n: d["host_sync"]["syncs"] for n, d in contracts.items()
                          if d.get("host_sync", {}).get("syncs")}}
    detail["lint"] = row
    log(json.dumps({"lint": row}))
    if bad:
        raise SystemExit(f"phase 24 lint: {bad}")
    out = {name: launches.get(name, 0) for name in KERNELS}
    out["causal_attention float32"] = out["causal_attention"]  # the lint model is fp32
    return {"lint": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="directory for chip_smoke_detail.json")
    ap.add_argument("--chunks", type=int, default=17,
                    help="chunks of the main-path sweep (chunk 0 + full groups of 8)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.monotonic()

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
    gemm_row, gemm_counts = gemm_paths(args, detail)
    moe_row, moe_tail_rows, moe_counts = moe_paths(args, detail)
    codec_rows = codec_checks(detail)
    paged_rows = paged_checks(detail)
    t1 = time.monotonic()
    by_path = {"token_sweep": main_path(args, detail), **gemm_counts, **moe_counts}
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
    t9 = time.monotonic()
    by_path.update(survivable_paths(args, detail))
    t10 = time.monotonic()
    by_path.update(pipeline_paths(args, detail))
    t11 = time.monotonic()
    by_path.update(disagg_paths(args, detail))
    t12 = time.monotonic()
    by_path.update(cluster_paths(args, detail))
    t13 = time.monotonic()
    by_path.update(long_context_paths(args, detail))
    t14 = time.monotonic()
    by_path.update(mesh_paths(args, detail))
    t15 = time.monotonic()
    by_path.update(lint_paths(args, detail))
    detail["phase_s"] = {"kernels": t1 - t0, "token_sweep": t2 - t1, "split_paths": t3 - t2,
                         "serve_paths": t4 - t3, "cross_checks": t5 - t4,
                         "experiments": t6 - t5, "split_decode": t7 - t6,
                         "split_paged": t8 - t7, "boundary_link": t9 - t8,
                         "survivable": t10 - t9, "pipeline": t11 - t10,
                         "disagg": t12 - t11, "cluster": t13 - t12,
                         "long_context": t14 - t13, "mesh": t15 - t14,
                         "lint": time.monotonic() - t15,
                         "total": time.monotonic() - t_start}
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
        elif name == "gemm_tf32x3":  # library_ms: cuBLAS fp32 at the same shape
            r = gemm_row
            shape = f"{r['shape']} M={r['m']} N={r['n']} K={r['k']} float32"
        elif name == "grouped_gemm_tf32x3":  # library_ms: a per-expert cuBLAS fp32 loop
            r = moe_row                         # then SiLU·up
            shape = (f"{r['shape']} E={r['experts']} M={r['m']} (rows {r['rows_min']}-"
                     f"{r['rows_max']} an expert) N={r['n']} K={r['k']} float32, "
                     f"silu(gate) * up stored ({r['out_cols']} a row)")
        elif name in moe_tail_rows:  # library_ms: the PyTorch passes it replaced
            r = moe_tail_rows[name]
            shape = f"{r['shape']} float32"
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
