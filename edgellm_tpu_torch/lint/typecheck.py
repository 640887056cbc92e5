"""Optional layer: scoped ``mypy --strict`` over the port's typed public
surfaces (the reference's ``edgellm_tpu/lint/typecheck.py``).

mypy is not a runtime dependency of the package: when it isn't importable
the layer records a skip note instead of failing. The reference keeps its
mypy settings in ``pyproject.toml``'s ``[tool.mypy]``, which belongs to it;
the port passes its flags on the command line and converts the output to
findings.
"""
from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
from typing import List, Tuple

from .report import Finding

#: the port's counterparts of the reference's TYPED_MODULES
TYPED_MODULES = (
    "edgellm_tpu_torch/serve/decode.py",
    "edgellm_tpu_torch/serve/recovery.py",
    "edgellm_tpu_torch/parallel/split.py",
    "edgellm_tpu_torch/codecs/faults.py",
    "edgellm_tpu_torch/obs/metrics.py",
)

#: the strictness the reference's [tool.mypy] sets, as flags
MYPY_FLAGS = ("--strict", "--allow-untyped-calls", "--allow-any-generics",
              "--allow-subclassing-any", "--no-warn-return-any",
              "--follow-imports=silent", "--ignore-missing-imports",
              "--no-error-summary")

_LINE_RE = re.compile(r"^(?P<path>[^:]+):(?P<line>\d+):(?:\d+:)?\s*"
                      r"error:\s*(?P<msg>.*)$")


def mypy_available() -> bool:
    return importlib.util.find_spec("mypy") is not None


def run_typecheck(repo_root: str) -> Tuple[List[Finding], List[str]]:
    """(findings, skip notes). Runs ``python -m mypy`` on TYPED_MODULES with
    :data:`MYPY_FLAGS`; absent mypy degrades to a recorded skip."""
    if not mypy_available():
        return [], ["typecheck: mypy not installed (pip install mypy to "
                    "enable)"]
    targets = [os.path.join(repo_root, m) for m in TYPED_MODULES]
    missing = [t for t in targets if not os.path.exists(t)]
    if missing:
        return [], [f"typecheck: missing targets {missing}"]
    proc = subprocess.run(
        [sys.executable, "-m", "mypy", *MYPY_FLAGS, *targets],
        cwd=repo_root, capture_output=True, text=True, timeout=600)
    findings: List[Finding] = []
    for line in proc.stdout.splitlines():
        m = _LINE_RE.match(line.strip())
        if m:
            findings.append(Finding(
                layer="typecheck", rule="MYPY", where=m.group("path"),
                line=int(m.group("line")), message=m.group("msg")))
    if proc.returncode not in (0, 1):  # 1 = type errors; anything else broke
        findings.append(Finding(
            layer="typecheck", rule="MYPY", where="mypy", line=0,
            message=f"mypy crashed (exit {proc.returncode}): "
                    f"{proc.stderr.strip()[:500]}"))
    return findings, []
