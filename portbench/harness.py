"""What every cell shares: finding a cell's files by name, the traced slice
of a window and its reduction, and the result line.

A kind module (``kinds/<kind>.py``) gives four functions:

- ``setup(ctx) -> state``: weights, inputs and the program's objects, with
  every shape of the cell's traffic warmed up;
- ``window(ctx, state, seconds, tracer) -> Window``: the measured window;
  with ``--trace 1`` it runs one steady slice of it under ``tracer``;
- ``release(state)``: drop the program's state, so that the reference runs
  in the memory it leaves;
- ``check(ctx, win) -> [Check]``: the comparison with the plain reference.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time
from pathlib import Path
from typing import Any, Callable

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent

#: kernel names of cuBLAS / cuBLASLt matrix products
GEMM_MARKS = ("gemm", "gemv", "xmma", "cutlass", "nvjet")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in GEMM_MARKS)


def load_benchmark(root: Path = REPO) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """``<root>/<kind>/<name>.json``: a configuration or a traffic mix."""
    path = root / kind / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"portbench: no {kind} file {path.relative_to(root.parent)}")
    with open(path) as f:
        return json.load(f)


def load_limits(cell: str, root: Path = ROOT) -> dict:
    """``<root>/limits/<cell>.json``: each compared number's limit (a missing
    file or key leaves the number unlimited, and the run not correct)."""
    path = root / "limits" / f"{cell}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return {k: v for k, v in json.load(f).items() if isinstance(v, (int, float))}


def load_kind(kind: str, root: Path = ROOT):
    """The driver module ``<root>/kinds/<kind>.py``."""
    return _module(root / "kinds" / f"{kind}.py", f"portbench_kind_{kind}")


def load_metric(name: str, root: Path = ROOT):
    """The reader ``<root>/metrics/<name>.py`` of a per-layer metric."""
    return _module(root / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_"))


def _module(path: Path, modname: str):
    if not path.exists():
        raise SystemExit(f"portbench: no file {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports: those
    that list it, or that list no cells and move a metric it reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


@dataclasses.dataclass
class Ctx:
    """One run's settings: the cell, its configuration and mix, the seed."""

    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: Any = "cuda"


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit (the run
    fails it when ``value > limit``)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What a kind's window returns: the end-to-end readings, the counts the
    per-layer readers use, the answers to check, and the attempted / failed
    counts of the entry's calls or requests."""

    metrics: dict
    counters: dict
    answers: Any
    attempted: int
    failed: int = 0


class Trace:
    """The traced slice, reduced: kernel rows by name, the device operations
    in the order they ran, busy and window seconds, the idle gaps by what
    the host was doing, and the kind's counters over the slice."""

    def __init__(self):
        self.rows: dict = {}        # kernel name -> [calls, device seconds]
        self.ops: list = []         # (start us, name, device seconds), in order
        self.busy_s = 0.0
        self.window_s = 0.0
        self.gaps: dict = {}        # host op -> idle device seconds
        self.counters: dict = {}
        self.taken = False

    @property
    def kernels(self) -> int:
        return sum(c for c, _ in self.rows.values())

    def device_s(self, pred: Callable[[str], bool]) -> float:
        return sum(t for name, (_, t) in self.rows.items() if pred(name))

    def attention_s(self) -> tuple[float, float]:
        """(K-attn seconds, K-stats seconds). A K-stats call runs its forward
        (``attn_fwd*``) and then its column pass (``attn_col*``) before the
        next matrix product; a K-attn call runs the forward alone. So a run
        of forward kernels belongs to K-stats when a column pass follows it
        before any GEMM, and to K-attn otherwise."""
        kattn = kstats = pending = 0.0
        for _, name, sec in self.ops:
            if "attn_col" in name:
                kstats += pending + sec
                pending = 0.0
            elif "attn_fwd" in name:
                pending += sec
            elif is_gemm(name):
                kattn += pending
                pending = 0.0
        return kattn + pending, kstats


class Tracer:
    """Profiles one steady slice of a window with torch.profiler (CPU and
    CUDA activities, no chrome trace written) and reduces it to a
    :class:`Trace`."""

    def __init__(self):
        self.trace = Trace()
        self.pending = None

    def slice(self):
        return _Slice(self)

    def reduce(self) -> "Trace":
        """Reduce the profiled slice (after the window has closed, so that
        the reduction's own time is not the window's)."""
        if self.pending is not None:
            prof, wall = self.pending
            self.pending = None
            reduce_profile(prof, self.trace, wall)
        return self.trace


class _Slice:
    def __init__(self, tracer: Tracer):
        self.tracer = tracer

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self.tracer.trace

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.tracer.pending = (self.prof, wall)
        return False


def reduce_profile(prof, out: Trace, wall_s: float):
    """Kernel rows, the ordered device operations, busy seconds and idle
    gaps of a profile."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            dev.append(ev)
        elif ev.device_type == DeviceType.CPU:
            cpu.append(ev)
    for ev in dev:
        sec = (ev.time_range.end - ev.time_range.start) / 1e6
        row = out.rows.setdefault(ev.name, [0, 0.0])
        row[0] += 1
        row[1] += sec
        out.ops.append((ev.time_range.start, ev.name, sec))
    out.ops.sort()
    # busy: the union of device intervals; gaps: the holes between them,
    # each charged to the innermost host op running at its midpoint
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, holes, cur_s, cur_e = 0.0, [], None, None
    for s, e in iv:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            holes.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    out.busy_s = busy / 1e6
    out.window_s = wall_s
    out.gaps = _charge_gaps(holes, cpu)
    out.taken = True


def _charge_gaps(holes: list, cpu: list) -> dict:
    import bisect

    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu),
                   key=lambda t: t[0])
    starts = [s for s, _, _ in spans]
    gaps: dict = {}
    for a, b in holes:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        label = "host (no op)"
        # the innermost op holding mid: the latest-starting one that still runs
        for j in range(i - 1, max(i - 4096, -1), -1):
            _, e, name = spans[j]
            if e >= mid:
                label = name
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return gaps


def breakdown(trace: Trace) -> dict:
    ops = sorted(((n, t) for n, (_, t) in trace.rows.items()), key=lambda r: -r[1])[:10]
    gaps = sorted(trace.gaps.items(), key=lambda r: -r[1])[:10]
    return {"device_ops": [[n[:120], t] for n, t in ops],
            "idle_gaps": [[n[:120], t] for n, t in gaps]}


def process_start_s() -> float:
    """Seconds on ``time.time()``'s clock at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()
