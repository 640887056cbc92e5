"""Build the hand-written CUDA kernels under ``edgellm_tpu_torch/csrc`` and
load them with ``ctypes``.

Every ``csrc/*.cu`` is one shared library with a plain C interface, compiled
by ``nvcc`` for Hopper (``sm_90a``) at first use. The sources compile in
parallel (one ``nvcc`` per source, all started together) into
``build/kernels/<hash>/`` at the repository root, keyed by a hash of every
``csrc`` file and the flags, so an edited kernel rebuilds and an unchanged one
loads from disk. Nothing here runs at import: the CPU tests import every
module, and a machine without a card usually has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the "
                       "CUDA kernels of edgellm_tpu_torch cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that is not built yet -> ``{"libs": {name:
    path}, "seconds": wall time, "log": {name: compiler output}}``. Raises
    with the compiler's output if any source fails."""
    t0 = time.monotonic()
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, log, running = {}, {}, []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        libs[src.stem] = lib
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:
        text, _ = proc.communicate()
        log[src.stem] = text
        if proc.returncode:
            failed.append(f"nvcc failed for {src.name} (exit {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {"libs": libs, "seconds": time.monotonic() - t0, "log": log}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        libs = build_all()["libs"]
        if name not in libs:
            raise KeyError(f"no CUDA source csrc/{name}.cu (have {sorted(libs)})")
        _loaded[name] = ctypes.CDLL(str(libs[name]))
    return _loaded[name]
