"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: the weights and the traffic are made from the seed, the cell's
shapes are warmed up (``setup_s`` ends here), the window is measured for
``--seconds`` (with ``--trace 1`` one steady slice of it under
torch.profiler, whose readings give the per-layer metrics), the peak device
memory is read, the program's state is dropped, and what the timed calls
produced is compared with the plain reference. The last line of standard
output is one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error and the last key of that object.

With no card, or fewer than the cell asks for, it exits 2 and prints no
result. It exits 3 with no result if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import harness

#: top-level module names that must not be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "edgellm_tpu")


def _caches():
    """Keep every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels build into ``build/kernels/``), and keep the
    fused-hop gate off the user's cache and off (every hop runs its codec's
    encode, copy and decode)."""
    base = harness.REPO / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ["EDGELLM_PROBE_CACHE"] = str(base / "probe_cache.json")
    os.environ["EDGELLM_FUSED_HOP"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def main(argv=None) -> int:
    t_start = harness.process_start_s()
    args = parse(argv)
    _caches()
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    kind = harness.load_kind(mix["kind"])
    e2e, per_layer = harness.cell_metrics(bench, cell["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = harness.Ctx(cell=cell["name"], cfg=cfg, mix=mix, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace))
    state = kind.setup(ctx)
    setup_s = time.time() - t_start
    tracer = harness.Tracer() if args.trace else None
    win = kind.window(ctx, state, args.seconds, tracer)
    device = device_info(cell["chips"])
    kind.release(state)
    del state
    torch.cuda.empty_cache()
    checks = kind.check(ctx, win)

    metrics, extra = {}, {}
    if args.trace:
        trace = tracer.reduce()
        trace.counters.update(win.counters)
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        for m in per_layer:
            reader = harness.load_metric(m["name"])
            value = reader.read(trace, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = harness.breakdown(trace)
    else:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else win.metrics.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    print(json.dumps({"window_counters": win.counters}, default=str), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    correct = all(c.ok for c in checks) and bool(checks)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})", file=sys.stderr)
    line = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
            "metrics": metrics, "device": device, **extra,
            "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks}}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
