"""K-attn (and with ``--stats`` K-stats) on the card against
``torch.nn.functional.scaled_dot_product_attention(is_causal=True)`` at the
reference's five sweep shapes, bf16 (PyTorch counterpart of
``edgellm_tpu/tools/attn_probe.py``).

    python -m edgellm_tpu_torch.tools.attn_probe [--stats] [--shape NAME]

Each shape is timed as interleaved (kernel, SDPA) pairs with CUDA events,
the speedup the median of per-pair ratios, TFLOP/s by the full-square count
``4 B H S^2 hd``. It prints one JSON row a shape and records nothing: SDPA
is a yardstick here, never the port of a kernel, and no dispatch reads
these rows.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .pallas_probe import paired_medians

#: (name, batch, heads, kv_heads, seq, head_dim): the reference's sweep shapes
SHAPES = [
    ("pythia-70m_s2048", 8, 8, 8, 2048, 64),
    ("qwen2-0.5b_s2048", 8, 14, 2, 2048, 64),
    ("llama-3.2-1b_s512", 32, 32, 8, 512, 64),
    ("qwen2-0.5b_s512", 64, 14, 2, 512, 64),
    ("qwen2-1.5b_s512", 32, 12, 2, 512, 128),
]


def probe_shape(name: str, b: int, h: int, kv: int, s: int, hd: int, *, reps: int = 3,
                iters: int = 10, stats: bool = False, seed: int = 0, device="cuda") -> dict:
    """Kernel against SDPA at one shape -> a result row."""
    from ..models import flash_attention as fa

    plan = fa.kernel_plan(s, h, kv, hd)
    if plan is None:
        return {"shape": name, "plan": None}
    gen = np.random.default_rng(seed)

    def rand(heads):
        return torch.from_numpy(gen.normal(size=(b, s, heads, hd)).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)

    q, k, v = rand(h), rand(kv), rand(kv)

    def kernel(x):
        if stats:
            return fa.causal_attention_stats(*x, plan=plan)
        return fa.causal_attention(*x, plan=plan)

    def sdpa(x):
        qq, kk, vv = (t.transpose(1, 2) for t in x)
        return torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                                enable_gqa=kv != h)

    k_ms, x_ms, ratio = paired_medians(kernel, sdpa, [(q, k, v)], reps=reps, iters=iters)
    flops = 4.0 * b * h * s * s * hd
    return {"shape": name, "dims": [b, h, kv, s, hd], "plan": [plan[0], plan[1]],
            "stats": stats, "kernel_us": round(k_ms * 1e3, 1), "sdpa_us": round(x_ms * 1e3, 1),
            "kernel_tflops": round(flops / (k_ms * 1e-3) / 1e12, 1),
            "sdpa_tflops": round(flops / (x_ms * 1e-3) / 1e12, 1),
            "speedup_vs_sdpa": round(ratio, 3)}


def probe_all(*, stats: bool = False, shapes=None, device="cuda") -> list:
    out = []
    for args in (shapes or SHAPES):
        out.append(probe_shape(*args, stats=stats, device=device))
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--stats", action="store_true", help="time K-stats instead of K-attn")
    ap.add_argument("--shape", default=None, help="probe only the named shape")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shapes = [t for t in SHAPES if args.shape is None or t[0] == args.shape]
    probe_all(stats=args.stats, shapes=shapes, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
