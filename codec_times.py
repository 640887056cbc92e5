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
  (1, 512, 896)): CUDA events around 20 hops, and its device time.

With ``--parent DIR`` (an unpacked older tree) its
``edgellm_tpu_torch/csrc/int8_affine_codec.cu`` is built with the port's
nvcc flags into ``build/variants/parent_codec/`` and called through its own
C interface (float32 rows only); its twin encode is what that tree ran:
``sanitize_hidden``, a float32 copy, then its K3. Each measurement is read
in turns: parent, this tree, this tree, parent.
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


def build_parent(cuda_build, parent: str) -> ctypes.CDLL:
    csrc = os.path.join(parent, "edgellm_tpu_torch", "csrc")
    out = cuda_build.BUILD_ROOT.parent / "variants" / "parent_codec"
    out.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", csrc, "-o",
                           str(out / "lib.so"), os.path.join(csrc, "int8_affine_codec.cu")],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed for the parent's K3 / K4:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out / "lib.so"))


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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("codec_times: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import codec_bytes, device_ms
    from edgellm_tpu_torch.codecs import codec_kernels as ck
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
        "hop": lambda h: split._hop(twin, h, None, h.device)}}
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

        versions["parent"] = {"encode": enc, "decode": dec, "twin_encode": parent_twin_encode,
                              "hop": parent_hop}
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
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "codec_times.json"), "w") as f:
            json.dump({"card": smi, "rows": rows, "measure_hop_times_ms": per_hop}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
