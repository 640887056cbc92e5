"""Readings that limits are set from, on the card, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 11 12 13 --seconds 4 \
        [--control] [--out chiprun_out/calib.jsonl]

For each seed it runs the cell's set-up and a short window as a run does,
then compares the sampled call or requests with the reference (the
program's readings: the lower ones) and, with ``--control``, the reference
computed in the arithmetic one step below the configuration's (TF32 for a
float32 cell, float8 operands for a bfloat16 one) against the reference
itself, at the same inputs (the control's readings: the upper ones). The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness
from portbench.run import _caches

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _caches()
    import torch

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    kind = harness.load_kind(mix["kind"])
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        ctx = harness.Ctx(cell=cell["name"], cfg=cfg, mix=mix, seed=seed,
                          seconds=args.seconds, trace=False)
        t0 = time.perf_counter()
        state = kind.setup(ctx)
        setup = time.perf_counter() - t0
        win = kind.window(ctx, state, args.seconds, None)
        kind.release(state)
        del state
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rec = {"cell": cell["name"], "seed": seed, "setup_s": setup, "metrics": win.metrics,
               "program": kind.readings(ctx, win)}
        rec["reference_s"] = time.perf_counter() - t1
        if args.control:
            rec["control"] = kind.readings(ctx, win, control=CONTROL[mix["dtype"]])
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
