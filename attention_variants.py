#!/usr/bin/env python3
"""Design variants of K-attn's bf16 kernel, timed side by side on one card.

    python3 attention_variants.py [--out DIR]

from the repository root, on a machine with a CUDA card and ``nvcc``. Each
variant is a text edit of ``edgellm_tpu_torch/csrc/causal_attention.cu``,
built with the port's nvcc flags into ``build/variants/<name>/`` and called
through the unchanged wrapper (``flash_attention.causal_attention``). For
each of the kernel phase's bf16 shapes it prints one JSON line: every
variant's device time in ms (torch.profiler, the kernels alone) and its
largest difference from the plain version, beside SDPA's device time.

Variants:

- ``committed``: the source as it is;
- ``rows128``: 128 query rows (two consumer warpgroups) a block at hd 64 too;
- ``exact_exp2``: ``exp2f`` in place of ``ex2.approx``;
- ``rows128_exact_exp2``: both;
- ``ring_only`` / ``ring_only_rows128``: the consumers wait for each stage
  and release it and compute nothing: the copy ring alone (not checked).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROWS128 = ("static constexpr int kQRows = HD == 64 ? 64 : 128;",
           "static constexpr int kQRows = 128;")
EXACT_EXP2 = ("fast_exp2(", "exp2f(")
RING_ONLY = ("  if (!active) {  // every row", "  if (true) {  // every row")
VARIANTS = {
    "committed": [],
    "rows128": [ROWS128],
    "exact_exp2": [EXACT_EXP2],
    "rows128_exact_exp2": [ROWS128, EXACT_EXP2],
    "ring_only": [RING_ONLY],
    "ring_only_rows128": [RING_ONLY, ROWS128],
}
SHAPES = [  # (label, b, s, h, kv, hd), as chip_smoke.py's kernel phase
    ("qwen2-0.5b", 32, 512, 14, 2, 64), ("qwen2-0.5b", 8, 512, 14, 2, 64),
    ("pythia-70m", 4, 2048, 8, 8, 64), ("qwen2-1.5b", 8, 512, 12, 2, 128)]


def build(cuda_build) -> dict:
    """Every variant's shared library, compiled in parallel -> {name: CDLL}."""
    src = (cuda_build.CSRC / "causal_attention.cu").read_text()
    root = cuda_build.BUILD_ROOT.parent / "variants"
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "causal_attention.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
             "-o", str(out / "lib.so"), str(out / "causal_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in log.splitlines()
                if "registers" in line and "Used" in line]
        print(json.dumps({"variant": name, "registers": regs}), flush=True)
        libs[name] = ctypes.CDLL(str(root / name / "lib.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="directory for attention_variants.json")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import device_ms
    from edgellm_tpu_torch.models import flash_attention as fa
    from edgellm_tpu_torch.utils import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    libs = build(cuda_build)
    committed_library = cuda_build.library
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    try:
        for label, b, s, h, kv, hd in SHAPES:
            q, k, v = (torch.randn((b, s, n, hd), generator=gen, device="cuda")
                       .to(torch.bfloat16) for n in (h, kv, kv))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row = {"shape": label, "b": b, "s": s, "hd": hd, "sdpa_device_ms": device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True), 20)}
            want = fa.causal_attention_plain(q, k, v).float()
            for name, lib in libs.items():
                cuda_build.library = (
                    lambda n, lib=lib: lib if n == "causal_attention" else committed_library(n))
                err = (fa.causal_attention(q, k, v).float() - want).abs().max().item()
                row[name] = {"device_ms": device_ms(lambda: fa.causal_attention(q, k, v), 20),
                             "max_abs_err": None if name.startswith("ring_only") else err}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        cuda_build.library = committed_library
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "attention_variants.json"), "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
