"""Without a card the measurement path fails and prints no result."""
from __future__ import annotations

import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.parametrize("cell", ["table-fp32.qwen2-0.5b", "split4-fp32.qwen2-1.5b"])
def test_no_card_exits_nonzero_without_a_result(cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=harness.REPO, capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(harness.REPO / "build")})
    assert out.returncode != 0
    assert "correct" not in out.stdout
