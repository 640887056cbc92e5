"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port (top-level names compared whole)."""
from __future__ import annotations

import json
import subprocess
import sys

from portbench import harness

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         cwd=harness.REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_kinds_load_no_jax():
    kinds = "; ".join(f"import portbench.kinds.{k}" for k in ("sweep", "split", "serve_closed"))
    names = _top_level("import portbench.run, portbench.calibrate; " + kinds
                       + "; import edgellm_tpu_torch.eval.harness, "
                       "edgellm_tpu_torch.eval.split_eval, edgellm_tpu_torch.serve.batching")
    assert "edgellm_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "edgellm_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = _top_level("import portbench.reference.sweep, portbench.reference.split, "
                       "portbench.reference.serve, portbench.yardstick.flops, "
                       "portbench.yardstick.attention, portbench.yardstick.codecs, "
                       "portbench.weights")
    assert not names & {"jax", "jaxlib", "flax", "edgellm_tpu", "edgellm_tpu_torch"}


def test_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "edgellm_tpu_torch_like", sys)
    assert "edgellm_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "edgellm_tpu.models", sys)
    assert run.forbidden_modules() == ["edgellm_tpu"]
