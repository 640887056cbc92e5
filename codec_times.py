#!/usr/bin/env python3
"""The int8 hop codec, K3 and K4, timed on one card, with an older tree's beside them.

    python3 codec_times.py [--parent DIR] [--out DIR]

from the repository root, on a machine with a CUDA card and ``nvcc``. Every
time is device time (torch.profiler, the kernels alone,
``chip_smoke.device_ms``), each output held bit for bit against the plain
version first:

- K3 (``int8_affine_encode``, float32 rows) and K4 (``int8_affine_decode``)
  at N = 4096 x D = 896 (Qwen2-0.5B's split hop) and 1536 (Qwen2-1.5B's),
  and one row of 896: warm (50 calls in a row, the inputs in L2) and cold
  (a 256 MB buffer written before each call, its kernel left out);
- the ``int8_per_token`` twin's whole encode of a (8, 512, 896) hidden (a
  split1 group's hop) in bf16 (the split path's) and float32: its kernels a
  call and their time;
- the hop ``parallel/split.py::measure_hop_times`` times for split1's
  ``per_hop_ms`` (encode -> copy of each payload leaf -> decode, float32
  (1, 512, 896)): CUDA events around 20 hops, and its device time;
- K8 (``fused_hop.remote_hop``, the fused hop in one kernel) on float32
  rows at N = 4096 x D = 896 and 1536 and one row of 896, its buffer and
  decode held byte for byte against the wire path first; and one
  ``fused_remote_hop`` call of a split10 group's bf16 (8, 512, 896) hidden:
  its kernels a call and their time.

With ``--parent DIR`` (an unpacked older tree) its
``edgellm_tpu_torch/csrc/int8_affine_codec.cu`` is built with the port's
nvcc flags into ``build/variants/parent_codec/`` and called through its own
C interface (float32 rows only); its twin encode is what that tree ran:
``sanitize_hidden``, a float32 copy, then its K3. Its
``edgellm_tpu_torch/csrc/remote_hop.cu`` likewise (``parent_k8``, a memset
of its accumulators before each launch), and its fused hop is what that
tree ran: ``sanitize_hidden``, a float32 copy, K8, the cast back and the
select. Each measurement is read in turns: parent, this tree, this tree,
parent. ``--part k8`` reads K8 alone.

``--k8-variants`` also builds text edits of this tree's ``remote_hop.cu``
(into ``build/variants/k8_<name>/``) and times K8 on float32 rows at N =
4096 through each, in order and reversed, by CUDA events around 200
launches on preallocated buffers (a variant's module shares the committed
one's kernel names, and torch.profiler drops its records):
``committed``; ``readback_cv``, the arrived bytes read with
``ld.global.cv`` in place of ``.cg``; ``no_finish``, no block sums, atomics
or ticket (the verify flag unset: timed, not checked).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

SHAPES = [(4096, 896), (4096, 1536), (1, 896)]
TWIN_SHAPE = (8, 512, 896)  # a split1 group's hop
HOP_SHAPE = (1, 512, 896)  # split_eval's per_hop_ms


def build_parent(cuda_build, parent: str, source: str = "int8_affine_codec") -> ctypes.CDLL:
    csrc = os.path.join(parent, "edgellm_tpu_torch", "csrc")
    out = cuda_build.BUILD_ROOT.parent / "variants" / f"parent_{source}"
    out.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", csrc, "-o",
                           str(out / "lib.so"), os.path.join(csrc, f"{source}.cu")],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed for the parent's {source}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out / "lib.so"))


def parent_k8(lib):
    """The parent's K8 through its C interface (float32 rows in; a memset of
    its accumulators on the stream, then the kernel) -> (out, ok, buf)."""
    import torch

    from edgellm_tpu_torch.codecs import fused_hop as fh

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.edgellm_remote_hop.argtypes = [ptr] * 5 + [i64, i32, ptr]
    lib.edgellm_remote_hop.restype = i32

    def hop(x):
        n, d = x.shape
        buf = torch.empty((fh.remote_hop_nbytes(n, d),), dtype=torch.uint8, device=x.device)
        out = torch.empty((n, d), dtype=torch.float32, device=x.device)
        ok = torch.empty((1,), dtype=torch.int32, device=x.device)
        acc = torch.empty((4,), dtype=torch.int32, device=x.device)
        err = lib.edgellm_remote_hop(x.data_ptr(), buf.data_ptr(), out.data_ptr(), ok.data_ptr(),
                                     acc.data_ptr(), n, d, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K8 launch failed: CUDA error {err}")
        return out, ok[0] != 0, buf
    return hop


def parent_codec(lib):
    """The parent's K3 and K4 through its C interface (float32 rows in)."""
    import torch

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.edgellm_int8_affine_encode, lib.edgellm_int8_affine_decode):
        fn.argtypes, fn.restype = [ptr] * 4 + [i64, i32, ptr], i32

    def launch(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent codec launch failed: CUDA error {err}")

    def encode(x):
        n, d = x.shape
        q = torch.empty((n, d), dtype=torch.int8, device=x.device)
        scale, mn = (torch.empty((n, 1), dtype=torch.float32, device=x.device) for _ in "sm")
        launch(lib.edgellm_int8_affine_encode, x.data_ptr(), q.data_ptr(), scale.data_ptr(),
               mn.data_ptr(), n, d)
        return q, scale, mn

    def decode(q, scale, mn):
        n, d = q.shape
        out = torch.empty((n, d), dtype=torch.float32, device=q.device)
        launch(lib.edgellm_int8_affine_decode, q.data_ptr(), scale.data_ptr(), mn.data_ptr(),
               out.data_ptr(), n, d)
        return out

    return encode, decode


def kernels_per_call(fn) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)


def event_ms(fn, iters: int = 20) -> float:
    """CUDA events around ``iters`` calls after one warm-up, as
    ``measure_hop_times`` times a hop."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", help="an unpacked older tree: its K3 / K4 timed in turns")
    ap.add_argument("--out", help="directory for codec_times.json")
    ap.add_argument("--part", choices=("all", "k8"), default="all",
                    help="every reading, or K8's alone")
    ap.add_argument("--k8-variants", action="store_true",
                    help="also read K8's design variants (text edits of remote_hop.cu)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("codec_times: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import codec_bytes, device_ms
    from edgellm_tpu_torch.codecs import codec_kernels as ck
    from edgellm_tpu_torch.codecs import fused_hop as fh
    from edgellm_tpu_torch.codecs.packing import get_wire_codec, sanitize_hidden
    from edgellm_tpu_torch.models import flash_attention as fa
    from edgellm_tpu_torch.parallel import split
    from edgellm_tpu_torch.utils import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    cuda_build.build_all()
    twin = get_wire_codec("int8_per_token_pallas")
    versions = {"this": {
        "encode": ck.int8_affine_encode, "decode": ck.int8_affine_decode,
        "twin_encode": twin.encode,
        "hop": lambda h: split._hop(twin, h, None, h.device),
        "k8": fh.remote_hop, "fused": lambda codec, h: fh.fused_remote_hop(codec, h, h.device)}}
    if args.parent:
        enc, dec = parent_codec(build_parent(cuda_build, args.parent))

        def parent_twin_encode(h, enc=enc):
            q, scale, mn = enc(sanitize_hidden(h).float().reshape(-1, h.shape[-1]).contiguous())
            b, s, d = h.shape
            return {"q": q.reshape(b, s, d), "scale": scale.reshape(b, s, 1),
                    "mn": mn.reshape(b, s, 1)}

        def parent_hop(h, enc=parent_twin_encode, dec=dec):
            moved = {k: v.to(h.device, copy=True) for k, v in enc(h).items()}
            b, s, d = moved["q"].shape
            return dec(moved["q"].reshape(b * s, d), moved["scale"].reshape(b * s, 1),
                       moved["mn"].reshape(b * s, 1)).reshape(b, s, d)

        k8 = parent_k8(build_parent(cuda_build, args.parent, "remote_hop"))

        def parent_fused(codec, h, k8=k8):  # the parent's fused_remote_hop
            b, s, d = h.shape
            out, ok, _ = k8(sanitize_hidden(h).float().reshape(b * s, d).contiguous())
            return torch.where(ok, out.reshape(b, s, d).to(h.dtype), h)

        versions["parent"] = {"encode": enc, "decode": dec, "twin_encode": parent_twin_encode,
                              "hop": parent_hop, "k8": k8, "fused": parent_fused}
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty((64 << 20,), dtype=torch.float32, device="cuda")  # 256 MB > L2
    rows = []

    def read(label: str, nbytes: float, calls: dict, cold: bool = True, hop: bool = False):
        bound = fa.bound_ms(float(nbytes), 0.0, torch.float32)[0]
        row = {"what": label, "bytes": nbytes, "bound_ms": bound}
        for name in order:
            fn = calls[name]
            entry = row.setdefault(name, {"device_ms": [], "cold_ms": [], "event_ms": [],
                                          "kernels_per_call": kernels_per_call(fn)})
            entry["device_ms"].append(device_ms(fn, 50))
            if cold:
                entry["cold_ms"].append(device_ms(fn, 20, flush=flush))
            if hop:
                entry["event_ms"].append(event_ms(fn))
        for name in row:
            if isinstance(row[name], dict):
                e = row[name]
                for k in ("device_ms", "cold_ms", "event_ms"):
                    e[k + "_mean"] = sum(e[k]) / len(e[k]) if e[k] else None
                e["share"] = bound / e["device_ms_mean"]
                e["cold_share"] = bound / e["cold_ms_mean"] if e["cold_ms"] else None
        rows.append(row)
        print(json.dumps(row), flush=True)

    k8_rows(args, versions, read, gen)
    if args.k8_variants:
        rows.extend(k8_variant_rows(cuda_build, gen))
    if args.part == "k8":
        write(args, smi, rows, None)
        return 0
    for n, d in SHAPES:
        x = sanitize_hidden(torch.randn((n, d), generator=gen, device="cuda") * 3)
        x[n // 2] = 1.5  # a constant row
        want = ck.int8_affine_encode_plain(x)
        for name, v in versions.items():  # bit for bit first
            got = v["encode"](x)
            if not all(torch.equal(g, w) for g, w in zip(got, want)) or not torch.equal(
                    v["decode"](*want), ck.int8_affine_decode_plain(*want)):
                raise SystemExit(f"{name}'s K3 / K4 differ from the plain versions at "
                                 f"N={n}, D={d}")
        read(f"K3 float32 N={n} D={d}", codec_bytes("int8_affine_encode", n, d),
             {k: (lambda v=v: v["encode"](x)) for k, v in versions.items()})
        read(f"K4 N={n} D={d}", codec_bytes("int8_affine_decode", n, d),
             {k: (lambda v=v: v["decode"](*want)) for k, v in versions.items()})
    b, s, d = TWIN_SHAPE
    h32 = torch.randn(TWIN_SHAPE, generator=gen, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        h = h32.to(dtype)
        want = twin.encode(h.cpu())
        for name, v in versions.items():
            got = v["twin_encode"](h)
            if not all(torch.equal(got[k].cpu(), want[k]) for k in want):
                raise SystemExit(f"{name}'s twin encode differs from the CPU's on {dtype}")
        read(f"twin encode {str(dtype)[6:]} B={b} S={s} D={d}",
             codec_bytes("int8_affine_encode", b * s, d, h.element_size()),
             {k: (lambda v=v, h=h: v["twin_encode"](h)) for k, v in versions.items()},
             cold=False)
    b, s, d = HOP_SHAPE
    h32 = torch.randn(HOP_SHAPE, generator=gen, device="cuda")
    payload = b * s * (d + 8)  # encode -> copy (payload read and written) -> decode
    read(f"hop float32 B={b} S={s} D={d}",
         codec_bytes("int8_affine_encode", b * s, d) + 2 * payload
         + codec_bytes("int8_affine_decode", b * s, d),
         {k: (lambda v=v: v["hop"](h32)) for k, v in versions.items()}, cold=False, hop=True)
    per_hop = split.measure_hop_times([twin], type("Cfg", (), {"hidden_size": d}), b, s,
                                      ["cuda", "cuda"])
    print(json.dumps({"measure_hop_times_ms": per_hop}), flush=True)
    write(args, smi, rows, per_hop)
    return 0


K8_VARIANTS = {  # name: source edits of remote_hop.cu
    "committed": [],
    "readback_cv": [("ld.global.cg.u32", "ld.global.cv.u32"),
                    ("ld.global.cg.v2.u32", "ld.global.cv.v2.u32")],
    "no_finish": [("  finish(buf, ok, acc, sent, got, true);\n}\n\ntemplate <typename T>\n"
                   "__global__ void __launch_bounds__(kCodecThreads)\nremote_hop_scalar",
                   "  (void)sent;\n  (void)got;\n}\n\ntemplate <typename T>\n"
                   "__global__ void __launch_bounds__(kCodecThreads)\nremote_hop_scalar")],
}


def k8_variant_rows(cuda_build, gen) -> list:
    """K8's design variants on float32 rows at :data:`SHAPES`, device ms in
    order and reversed; the exact ones held to the wire path first."""
    import torch

    from chip_smoke import codec_bytes, time_ms
    from edgellm_tpu_torch.codecs import fused_hop as fh
    from edgellm_tpu_torch.codecs.packing import sanitize_hidden
    from edgellm_tpu_torch.models import flash_attention as fa

    src = (cuda_build.CSRC / "remote_hop.cu").read_text()
    procs = {}
    for name, edits in K8_VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"K8 variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        out = cuda_build.BUILD_ROOT.parent / "variants" / f"k8_{name}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "remote_hop.cu").write_text(text)
        procs[name] = (out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
             str(out / "lib.so"), str(out / "remote_hop.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for K8 variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / "lib.so"))
        libs[name].edgellm_remote_hop.argtypes = fh.ck._SIGNATURES["remote_hop"][
            "edgellm_remote_hop"][0]
    rows = []
    for n, d in SHAPES[:2]:
        x = sanitize_hidden(torch.randn((n, d), generator=gen, device="cuda") * 3)
        want = fh.remote_hop_plain(x)
        buf = torch.empty_like(want[2])
        out = torch.empty_like(x)
        ok = torch.zeros((), dtype=torch.bool, device=x.device)
        acc = fh._accumulators(x.device)

        def call(lib):  # the kernel alone on preallocated buffers: the queue stays full
            lib.edgellm_remote_hop(x.data_ptr(), 0, buf.data_ptr(), out.data_ptr(),
                                   ok.data_ptr(), acc.data_ptr(), n, d, 0.0, 0,
                                   torch.cuda.current_stream().cuda_stream)
        bound = fa.bound_ms(float(codec_bytes("remote_hop", n, d)), 0.0, torch.float32)[0]
        row = {"what": f"K8 variants float32 N={n} D={d} (CUDA events, 200 launches)",
               "bound_ms": bound}
        for name in list(libs) + list(libs)[::-1]:
            ok.zero_()
            call(libs[name])
            torch.cuda.synchronize()
            exact = bool(ok) and torch.equal(out, want[0]) and torch.equal(buf, want[2])
            if name != "no_finish" and not exact:
                raise SystemExit(f"K8 variant {name} differs from the wire path at N={n}")
            entry = row.setdefault(name, {"event_ms": [], "exact": exact})
            entry["event_ms"].append(time_ms(lambda: call(libs[name]), 200))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def write(args, smi: str, rows: list, per_hop):
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "codec_times.json"), "w") as f:
            json.dump({"card": smi, "rows": rows, "measure_hop_times_ms": per_hop}, f, indent=1)


def k8_rows(args, versions: dict, read, gen):
    """K8 at :data:`SHAPES` on float32 rows, and one fused "remote" hop of a
    bf16 (8, 512, 896) hidden, each checked against the wire path, then read
    in turns (``versions[name]["k8"]`` / ``["fused"]``)."""
    import torch

    from chip_smoke import codec_bytes
    from edgellm_tpu_torch.codecs import fused_hop as fh
    from edgellm_tpu_torch.codecs.packing import get_wire_codec, sanitize_hidden

    for n, d in SHAPES:
        x = sanitize_hidden(torch.randn((n, d), generator=gen, device="cuda") * 3)
        x[n // 2] = 1.5  # a constant row
        want = fh.remote_hop_plain(x)
        for name, v in versions.items():
            out, ok, buf = v["k8"](x)
            if not (bool(ok) and torch.equal(out, want[0]) and torch.equal(buf, want[2])):
                raise SystemExit(f"{name}'s K8 differs from the wire path at N={n}, D={d}")
        read(f"K8 float32 N={n} D={d}", codec_bytes("remote_hop", n, d),
             {k: (lambda v=v: v["k8"](x)) for k, v in versions.items()}, cold=False)
    b, s, d = TWIN_SHAPE
    h = (torch.randn(TWIN_SHAPE, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    codec = get_wire_codec("int8_per_token_pallas")
    want = fh.fused_wire_hop(codec, h, h.device)
    for name, v in versions.items():
        if not torch.equal(v["fused"](codec, h), want):
            raise SystemExit(f"{name}'s fused remote hop differs from the wire hop")
    read(f"fused_remote_hop bfloat16 B={b} S={s} D={d}",
         2 * 2 * b * s * d + fh.remote_hop_nbytes(b * s, d),
         {k: (lambda v=v: v["fused"](codec, h)) for k, v in versions.items()}, cold=False)


if __name__ == "__main__":
    sys.exit(main())
