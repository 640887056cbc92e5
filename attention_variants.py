#!/usr/bin/env python3
"""Design variants of K-attn's kernels, timed side by side on one card.

    python3 attention_variants.py [--dtype bfloat16|float32] [--parent DIR] [--out DIR]

from the repository root, on a machine with a CUDA card and ``nvcc``. Each
variant is a text edit of ``edgellm_tpu_torch/csrc/causal_attention.cu``,
built with the port's nvcc flags into ``build/variants/<name>/`` and called
through the unchanged wrapper (``flash_attention.causal_attention``). For
each shape it prints one JSON line: every variant's device time in ms
(torch.profiler, the kernels alone, ``chip_smoke.device_ms``) and its largest
difference from the plain version, beside SDPA's device time and the bound.

bf16 variants (the default dtype), at the kernel phase's bf16 shapes:

- ``committed``: the source as it is;
- ``rows128``: 128 query rows (two consumer warpgroups) a block at hd 64 too;
- ``exact_exp2``: ``exp2f`` in place of ``ex2.approx``;
- ``rows128_exact_exp2``: both;
- ``ring_only`` / ``ring_only_rows128``: the consumers wait for each stage
  and release it and compute nothing: the copy ring alone (not checked).

fp32 variants (``--dtype float32``), at every fp32 caller's shape, each read
twice (the variants in order, then reversed):

- ``committed``: the source as it is (3xTF32 on ``wgmma``: q K^T from
  shared memory, P V with P from registers; GQA rows; key splits; at hd 64
  128 rows x 64 keys a block, at hd 128 64 x 32);
- ``fma``: the same grid, ring and tiles, both products as fp32 FMA on the
  CUDA cores (operands hi + lo from the same shared tiles, P passed within
  each quad by shuffles);
- ``pv_mma_sync``: P V as warp-level ``mma.sync.m16n8k8`` 3xTF32 products
  (each warp loading its V fragments from the same V^T tiles) in place of
  ``wgmma``;
- ``no_split``: the committed library with every launch one split (the plan
  patched in Python; no merge kernel);
- ``rows64``: hd 64 blocks of 64 query rows (one warpgroup) over the same
  64-key tiles (hd 128 unchanged);
- ``rows64_keys32``: hd 64 tiles of 64 rows x 32 keys, two blocks an SM
  (hd 128 unchanged);
- ``copies``: the products removed (q loaded, the ring, the hi / lo split,
  the softmax on zero scores, the output written): the copies alone (not
  checked);
- ``parent`` (with ``--parent DIR``, a checkout of the tree before the fp32
  redesign): its SIMT body, built from ``DIR/edgellm_tpu_torch/csrc`` and
  called through its own C interface.

fp32 K-stats' column pass (``--dtype float32``; ``--part stats`` alone), at
the sweep's stats shapes, the column pass alone over the LSE of this tree's
forward (the forward with the LSE timed beside it), each read twice (the
variants in order, then reversed), each held to the plain version's stats:

- ``committed``: ``csrc/attention_stats.cu`` as it is (3xTF32 on ``wgmma``,
  128 keys of one head a block);
- ``expf``: ``expf`` in place of ``ex2.approx``;
- timed, not checked: ``no_exp``, p = s * scale - lse, no exponential;
  ``no_split``, q's split stores left out (the products read stale tiles);
  ``no_products``, no ``wgmma``; ``no_epilogue``, no exponentials, sums or
  stores after the products; ``no_mask``, every tile through the unmasked
  loop; ``no_last``, the last row not written; ``no_lse``, one LSE value a
  tile for every query; ``sum_only``, p = s; ``half_tile``, the unmasked
  loop over half the tile's queries;
- ``keys64``: 64 keys a block (one consumer warpgroup of 128 threads), two
  blocks an SM;
- ``parent`` (with ``--parent DIR``): the older tree's column pass, through
  the same C interface.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
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

# --- fp32 -------------------------------------------------------------------

#: reading one fp32 value of a shared tile by its shared address
_LD = """  auto ld = [](uint32_t base, uint32_t off) {
    return *reinterpret_cast<const float*>(__cvta_shared_to_generic(base + off));
  };"""
#: both products as fp32 FMA on the CUDA cores (operands hi + lo from the
#: same shared tiles), in the wgmma accumulator's layout
FMA_QK = """template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[F32Tile<HD>::kKeys / 2], uint32_t q_hi,
                                        uint32_t q_lo, uint32_t k_hi, uint32_t k_lo) {
""" + _LD + """
  // q_hi / q_lo start at this warpgroup's 64 rows; rA is a row among them
  const int lane = threadIdx.x % 32, rA = threadIdx.x % 128 / 32 * 16 + lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < F32Tile<HD>::kKeys / 2; ++i) s[i] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const uint32_t oa = sw128_offset(rA, d / 4, F32Tile<HD>::kRows) + 4 * (d % 4);
    const uint32_t ob = sw128_offset(rA + 8, d / 4, F32Tile<HD>::kRows) + 4 * (d % 4);
    const float xa = ld(q_hi, oa) + ld(q_lo, oa), xb = ld(q_hi, ob) + ld(q_lo, ob);
#pragma unroll
    for (int n = 0; n < F32Tile<HD>::kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t ok =
            sw128_offset(8 * n + 2 * t4 + e, d / 4, F32Tile<HD>::kKeys) + 4 * (d % 4);
        const float y = ld(k_hi, ok) + ld(k_lo, ok);
        s[4 * n + e] = fmaf(xa, y, s[4 * n + e]);
        s[4 * n + 2 + e] = fmaf(xb, y, s[4 * n + 2 + e]);
      }
  }
}"""
FMA_PV = """template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        const float (&s)[F32Tile<HD>::kKeys / 2], uint32_t vt_hi,
                                        uint32_t vt_lo) {
""" + _LD + """
  const int lane = threadIdx.x % 32, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < F32Tile<HD>::kKeys / 8; ++j)
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {  // P of keys 8j + 2tt, + 1 from the quad's lane tt
      const int src = (lane & ~3) | tt, key = 8 * j + 2 * tt;
      const float pa0 = __shfl_sync(0xffffffffu, s[4 * j], src);
      const float pa1 = __shfl_sync(0xffffffffu, s[4 * j + 1], src);
      const float pb0 = __shfl_sync(0xffffffffu, s[4 * j + 2], src);
      const float pb1 = __shfl_sync(0xffffffffu, s[4 * j + 3], src);
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * nb + 2 * t4 + c;
          const uint32_t o0 = vt_offset<HD>(col, key), o1 = vt_offset<HD>(col, key + 1);
          const float y0 = ld(vt_hi, o0) + ld(vt_lo, o0), y1 = ld(vt_hi, o1) + ld(vt_lo, o1);
          o[4 * nb + c] = fmaf(pa1, y1, fmaf(pa0, y0, o[4 * nb + c]));
          o[4 * nb + 2 + c] = fmaf(pb1, y1, fmaf(pb0, y0, o[4 * nb + 2 + c]));
        }
    }
}"""
#: PV as warp-level mma.sync.m16n8k8 (3xTF32) from V^T's shared tiles, each
#: warp loading its own B fragments
MMA_PV = """__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        const float (&s)[F32Tile<HD>::kKeys / 2], uint32_t vt_hi,
                                        uint32_t vt_lo) {
""" + _LD.replace("const float*>", "const uint32_t*>") + """
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < F32Tile<HD>::kKeys / 8; ++j) {
    const float p[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = split_tf32(p[i]);
      ph[i] = __float_as_uint(x.x);
      pl[i] = __float_as_uint(x.y);
    }
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      const uint32_t o0 = vt_offset<HD>(8 * nb + g, 8 * j + 2 * t4);
      const uint32_t o1 = vt_offset<HD>(8 * nb + g, 8 * j + 2 * t4 + 1);
      float c[4] = {o[4 * nb], o[4 * nb + 1], o[4 * nb + 2], o[4 * nb + 3]};
      mma_tf32(c, pl, ld(vt_hi, o0), ld(vt_hi, o1));
      mma_tf32(c, ph, ld(vt_lo, o0), ld(vt_lo, o1));
      mma_tf32(c, ph, ld(vt_hi, o0), ld(vt_hi, o1));
#pragma unroll
      for (int i = 0; i < 4; ++i) o[4 * nb + i] = c[i];
    }
  }
}"""
NO_QK = """template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[F32Tile<HD>::kKeys / 2], uint32_t q_hi,
                                        uint32_t q_lo, uint32_t k_hi, uint32_t k_lo) {
#pragma unroll
  for (int i = 0; i < F32Tile<HD>::kKeys / 2; ++i) s[i] = 0.f;
}"""
NO_PV = """template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        const float (&s)[F32Tile<HD>::kKeys / 2], uint32_t vt_hi,
                                        uint32_t vt_lo) {}"""
TILE64 = "template <> struct F32Tile<64> { static constexpr int kRows = 128, kKeys = 64; };"
F32_VARIANTS = {  # name: (source edits, function replacements, one split)
    "committed": ([], {}, False),
    "fma": ([], {"qk_tile": FMA_QK, "pv_tile": FMA_PV}, False),
    "pv_mma_sync": ([], {"pv_tile": MMA_PV}, False),
    "no_split": ([], {}, True),
    "rows64": ([(TILE64, TILE64.replace("kRows = 128", "kRows = 64"))], {}, False),
    "rows64_keys32": ([(TILE64, TILE64.replace("kRows = 128, kKeys = 64",
                                                "kRows = 64, kKeys = 32"))], {}, False),
    "copies": ([], {"qk_tile": NO_QK, "pv_tile": NO_PV}, False),
}
EXP = "return fast_exp2(fmaf(sv, scale, -lq) * kLog2e);"
SPLIT_STORE = "      store_split4(hi, hi + L::kQTile, sw128_offset(e / CH, e % CH, kRows), xq[v]);"
COL_VARIANTS = {  # name: source edits of attention_stats.cu
    "committed": [],
    "expf": [(EXP, "return expf(fmaf(sv, scale, -lq));")],
    "no_exp": [(EXP, "return fmaf(sv, scale, -lq);")],
    "no_split": [(SPLIT_STORE, "")],
    "no_products": [("wgmma_tf32_ss(sc,", "if (false) wgmma_tf32_ss(sc,")],
    "no_epilogue": [("    sum_p(sc, i);\n", "")],
    "no_mask": [("    if (q0 >= wkey0 + 63 && q0 + kRows < S) {", "    if (true) {")],
    "no_last": [("        if (has_last && cq == S - 1 - q0 && key < S) last[bh * S + key] = p;\n", "")],
    "no_lse": [("        const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);",
                "        const float2 lq = make_float2(ls[0], ls[1]);")],
    "sum_only": [("return fast_exp2(fmaf(sv, scale, -lq) * kLog2e);", "return sv;")],
    "half_tile": [("      for (int j = 0; j < kRows / 8; ++j) {\n        const float2 lq",
                   "      for (int j = 0; j < kRows / 16; ++j) {\n        const float2 lq")],
    "keys64": [("  static constexpr int kKeys = 128;", "  static constexpr int kKeys = 64;"),
               ("  static constexpr int kThreads = 256;", "  static constexpr int kThreads = 128;"),
               ("__launch_bounds__(ColF32<HD>::kThreads, 1)",
                "__launch_bounds__(ColF32<HD>::kThreads, 2)")],
}
#: variants that leave out part of the work: timed, not checked
COL_UNCHECKED = ("no_exp", "no_split", "no_products", "no_epilogue", "no_mask", "no_last",
                 "no_lse", "sum_only", "half_tile")
COL_SHAPES = [  # (label, b, s, h, kv, hd): the sweeps' fp32 stats prefixes
    ("qwen2-0.5b", 8, 512, 14, 2, 64), ("qwen2-1.5b", 8, 512, 12, 2, 128),
    ("pythia-70m", 4, 2048, 8, 8, 64)]
F32_SHAPES = [  # (label, b, s, h, kv, hd): every fp32 caller's shape
    ("split9 prefill", 1, 12, 14, 2, 64), ("split13 prefill", 1, 72, 14, 2, 64),
    ("split9 large prefill", 1, 512, 14, 2, 64), ("split1 stage 1", 8, 512, 14, 2, 64),
    ("split4 stages 1-2", 8, 512, 12, 2, 128), ("qwen2-0.5b", 32, 512, 14, 2, 64)]


def replace_function(text: str, name: str, new: str) -> str:
    """``text`` with the template function ``name`` (from its ``template``
    line to its closing brace) replaced by ``new``."""
    m = re.search(r"template <int HD>\n__device__ __forceinline__ void " + name + r"\(", text)
    if m is None:
        raise SystemExit(f"function {name} is not in the source")
    depth, i = 0, text.index("{", m.end())
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[:m.start()] + new + text[i + 1:]
        i += 1


def _compile(cuda_build, name: str, text: str, include: str,
             source: str = "causal_attention.cu"):
    out = cuda_build.BUILD_ROOT.parent / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / source).write_text(text)
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(include),
         "-o", str(out / "lib.so"), str(out / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(cuda_build, procs: dict) -> dict:
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in log.splitlines()
                if "registers" in line and "Used" in line]
        print(json.dumps({"variant": name, "registers": regs}), flush=True)
        libs[name] = ctypes.CDLL(str(cuda_build.BUILD_ROOT.parent / "variants" / name / "lib.so"))
    return libs


def build_col(cuda_build, parent=None) -> dict:
    """The column pass's variant libraries (attention_stats.cu edited, and
    the parent's), compiled in parallel -> {name: CDLL}."""
    src = (cuda_build.CSRC / "attention_stats.cu").read_text()
    procs = {}
    for name, edits in COL_VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        procs["col_" + name] = _compile(cuda_build, "col_" + name, text, cuda_build.CSRC,
                                        "attention_stats.cu")
    if parent:
        csrc = os.path.join(parent, "edgellm_tpu_torch", "csrc")
        text = open(os.path.join(csrc, "attention_stats.cu")).read()
        procs["col_parent"] = _compile(cuda_build, "col_parent", text, csrc, "attention_stats.cu")
    return {name[4:]: lib for name, lib in _wait(cuda_build, procs).items()}


def _col_call(lib, q, k, lse):
    """A library's column pass through its C interface -> a call returning
    (col, last)."""
    import torch

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.edgellm_attn_col.argtypes = [ptr] * 5 + [i32] * 6 + [i64] * 5 + [ptr]
    lib.edgellm_attn_col.restype = i32
    b, s, h, hd = q.shape

    def run():
        col = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        last = torch.empty_like(col)
        err = lib.edgellm_attn_col(q.data_ptr(), k.data_ptr(), lse.data_ptr(), col.data_ptr(),
                                   last.data_ptr(), b, s, h, k.shape[2], hd, 0, q.stride(0), q.stride(1), k.stride(0),
                                   k.stride(1), k.stride(2),
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"column pass launch failed: {err}")
        return col, last
    return run


def col_rows(cuda_build, fa, device_ms, gen, parent=None) -> list:
    """The column pass's variants at :data:`COL_SHAPES`, in turns."""
    import torch

    libs = build_col(cuda_build, parent)
    rows = []
    for label, b, s, h, kv, hd in COL_SHAPES:
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device="cuda") for n in (h, kv, kv))
        lse = fa._launch_fwd(q, k, v, with_lse=True)[1]
        want = fa.causal_attention_stats_plain(q, k, v)[1]
        nbytes, flops = fa.column_pass_bytes_flops(b, s, h, kv, hd, 4)
        bound, bound_by = fa.bound_ms(nbytes, flops, torch.float32)
        calls = {name: _col_call(lib, q, k, lse) for name, lib in libs.items()}
        row = {"shape": label, "b": b, "s": s, "h": h, "kv": kv, "hd": hd,
               "bound_ms": bound, "bound_by": bound_by,
               "forward_lse_device_ms": device_ms(lambda: fa._launch_fwd(q, k, v, True), 20)}
        order = list(calls)
        for names in (order, order[::-1]):
            for name in names:
                got = calls[name]()
                err = max((g - w).abs().max().item() for g, w in zip(got, want))
                entry = row.setdefault(name, {"device_ms": [], "max_abs_err": None})
                entry["device_ms"].append(device_ms(calls[name], 20))
                if name not in COL_UNCHECKED:
                    entry["max_abs_err"] = err
        for name in order:
            entry = row[name]
            entry["device_ms_mean"] = sum(entry["device_ms"]) / len(entry["device_ms"])
            entry["share"] = bound / entry["device_ms_mean"]
        rows.append(row)
        print(json.dumps({"column_pass": row}), flush=True)
    return rows


def build(cuda_build, dtype: str, parent=None) -> dict:
    """Every variant's shared library, compiled in parallel -> {name: CDLL}."""
    src = (cuda_build.CSRC / "causal_attention.cu").read_text()
    procs = {}
    table = VARIANTS if dtype == "bfloat16" else F32_VARIANTS
    for name, spec in table.items():
        edits, funcs = (spec, {}) if dtype == "bfloat16" else spec[:2]
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        for fn, body in funcs.items():
            text = replace_function(text, fn, body)
        procs[name] = _compile(cuda_build, name, text, cuda_build.CSRC)
    if parent:
        csrc = os.path.join(parent, "edgellm_tpu_torch", "csrc")
        text = open(os.path.join(csrc, "causal_attention.cu")).read()
        procs["parent"] = _compile(cuda_build, "parent", text, csrc)
    return _wait(cuda_build, procs)


def _parent_call(lib, q, k, v):
    """The parent tree's K-attn through its own C interface (no split plan,
    no workspace) -> a call that returns its output."""
    import torch

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.edgellm_attn_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [i64] * 10 + [ptr]
    lib.edgellm_attn_fwd.restype = i32
    b, s, h, hd = q.shape

    def run():
        out = torch.empty_like(q)
        err = lib.edgellm_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b, s, h,
            k.shape[2], hd, 0 if q.dtype == torch.float32 else 1, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K-attn launch failed: {err}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--parent", help="a checkout of the tree before the fp32 redesign: its "
                    "K-attn is timed beside the variants")
    ap.add_argument("--out", help="directory for attention_variants[_float32].json")
    ap.add_argument("--part", choices=("all", "forward", "stats"), default="all",
                    help="float32: K-attn's variants, the column pass's, or both")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import device_ms
    from edgellm_tpu_torch.models import flash_attention as fa
    from edgellm_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    col = []
    if args.dtype == "float32" and args.part != "forward":
        col = col_rows(cuda_build, fa, device_ms, gen, args.parent)
    if args.part == "stats":
        libs, todo = {}, []
    else:
        libs = build(cuda_build, args.dtype, args.parent)
        todo = SHAPES if args.dtype == "bfloat16" else F32_SHAPES
    committed_library, committed_plan = cuda_build.library, fa.attn_split_plan
    one_split = lambda b, s, h, kv, sms=None, tile=fa.ATTN_F32_TILES[64]: (  # noqa: E731
        1, -(-s // tile[1]))
    rows = []
    try:
        for label, b, s, h, kv, hd in todo:
            q, k, v = (torch.randn((b, s, n, hd), generator=gen, device="cuda")
                       .to(dtype) for n in (h, kv, kv))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            nbytes, flops = fa.causal_attention_bytes_flops(b, s, h, kv, hd, q.element_size())
            bound, bound_by = fa.bound_ms(nbytes, flops, dtype)
            row = {"shape": label, "b": b, "s": s, "h": h, "kv": kv, "hd": hd,
                   "bound_ms": bound, "bound_by": bound_by,
                   "sdpa_device_ms": device_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True), 20)}
            want = fa.causal_attention_plain(q, k, v).float()
            order = list(libs)
            for rnd, names in enumerate((order, order[::-1]) if args.dtype == "float32"
                                        else (order,)):
                for name in names:
                    lib = libs[name]
                    cuda_build.library = (
                        lambda n, lib=lib: lib if n == "causal_attention" else committed_library(n))
                    fa.attn_split_plan = (one_split if name == "no_split" else committed_plan)
                    call = (_parent_call(lib, q, k, v) if name == "parent"
                            else lambda: fa.causal_attention(q, k, v))
                    try:
                        err = (call().float() - want).abs().max().item()
                        ms = device_ms(call, 20)
                    except RuntimeError as exc:  # a variant the shape does not fit
                        row.setdefault(name, {"error": str(exc)[:120]})
                        continue
                    entry = row.setdefault(name, {"device_ms": [], "max_abs_err": None})
                    entry["device_ms"].append(ms)
                    if not name.startswith(("ring_only", "copies")):
                        entry["max_abs_err"] = err
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        cuda_build.library, fa.attn_split_plan = committed_library, committed_plan
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        suffix = "" if args.dtype == "bfloat16" else "_float32"
        with open(os.path.join(args.out, f"attention_variants{suffix}.json"), "w") as f:
            json.dump({"card": smi, "rows": rows, "column_pass": col}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
