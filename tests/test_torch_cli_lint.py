"""``run.py --lint`` on the port: it runs the port's graphlint gate with
``jax`` and ``edgellm_tpu`` poisoned in the process (exit 0 on the CPU, the
report and the capability matrix passed through), it refuses to stand in
for a card run when none exists, and the lint CLI's exclusivity errors are
the reference's."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from edgellm_tpu.lint.__main__ import main as ref_lint_main
from edgellm_tpu_torch import run as trun
from edgellm_tpu_torch.lint.__main__ import main as port_lint_main

REPO = Path(__file__).resolve().parent.parent


def test_lint_on_the_cpu_with_jax_and_reference_poisoned(tmp_path):
    report, matrix = tmp_path / "lint.json", tmp_path / "matrix.json"
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["edgellm_tpu"] = None
from edgellm_tpu_torch import run
sys.exit(run.main(["--lint", "--device", "cpu", "--json", {str(report)!r},
                   "--matrix", {str(matrix)!r}]))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "graphlint: 0 violation(s), 70 graph contract(s) clean" in proc.stdout
    doc = json.loads(report.read_text())
    assert {"ok", "findings", "checked_contracts", "skipped"} <= set(doc)
    assert doc["ok"] is True and doc["findings"] == []
    checked = doc["checked_contracts"]
    assert len([c for c in checked if not c.startswith("lattice.")]) == 40
    assert len([c for c in checked if c.startswith("lattice.config:")]) == 28
    assert {"lattice.readme-parity", "lattice.pairwise-compat"} <= set(checked)
    assert doc["skipped"][0].startswith("graph host_sync: not measured on the cpu")
    assert any(s.startswith("lattice budget:") for s in doc["skipped"])
    assert json.loads(matrix.read_text())["schema"] == "edgellm.capability_matrix/v1"


def test_lint_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --lint runs on it")
    with pytest.raises(SystemExit, match="--device cuda, but torch finds no CUDA device"):
        trun.main(["--lint"])
    with pytest.raises(SystemExit, match="--device cuda, but torch finds no CUDA device"):
        port_lint_main(["--graph-only"])
    # the layers that only parse source need no device
    assert port_lint_main(["--ast-only", "--no-mypy"]) == 0


def test_lint_argv_passes_the_device_and_report_paths():
    assert trun._lint_argv(["--lint"]) == ["--no-mypy"]
    assert trun._lint_argv(["--lint", "--device", "cpu", "--json", "r.json",
                            "--matrix=m.json", "--seed", "3"]) == [
        "--no-mypy", "--device", "cpu", "--json", "r.json", "--matrix=m.json"]


def test_help_lists_lint(capsys):
    with pytest.raises(SystemExit) as e:
        trun.main(["--help"])
    assert e.value.code == 0 and "--lint" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--ast-only", "--graph-only"],
    ["--thread-only", "--lattice-only"],
    ["--ast-only", "--thread-only", "--graph-only"],
    ["--lattice-only", "edgellm_tpu_torch/run.py"],
])
def test_exclusivity_errors_are_the_reference_s(argv, capsys):
    def error_line(main) -> tuple:
        with pytest.raises(SystemExit) as e:
            main(argv)
        err = capsys.readouterr().err.strip().splitlines()[-1]
        return e.value.code, err.split(": error: ", 1)[1]

    assert error_line(port_lint_main) == error_line(ref_lint_main)
