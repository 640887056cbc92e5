"""graphlint on the port: static and executed analysis of
``edgellm_tpu_torch`` (the reference's ``edgellm_tpu/lint``, the same rule
ids and contract names). Five layers behind one CLI
(``python -m edgellm_tpu_torch.lint``, ``run.py --lint``):

- **AST rules** (:mod:`.ast_rules`): EG005, a per-token host sync in a
  decode loop in torch's vocabulary, and EG007, an unregistered metric or
  span name. The reference's EG001-EG004 and EG006 police tracing under
  ``jax.jit`` and have no eager-torch meaning.
- **Thread/lock discipline** (:mod:`.threadlint`): EG101-EG104 over the
  host serve plane, with torch's blocking calls in EG103; the
  deterministic-schedule harness (:mod:`.schedules`) is its dynamic side.
- **Graph contracts** (:mod:`.contracts` + :mod:`.entrypoints`): production
  entry points declare their properties with :func:`graph_contract`; the
  lint executes each once at lint geometry and checks the bytes and dtypes
  that cross every cut, no f64, no host sync on the card, caches updated in
  place, the kernel launches on the card, and that a disabled feature
  changes nothing.
- **Config lattice** (:mod:`.lattice`): every ``configs/*.json`` validates
  against the port's CLI, runs its entry points once at lint geometry,
  keeps its caches in place and its measured footprint under its
  ``budget`` block (on the card), and keeps a README row; the feature
  pairs are fuzzed against the reference's refusal oracle and the result
  lands in ``capability_matrix.json``.
- **Scoped typecheck** (:mod:`.typecheck`): ``mypy --strict`` where mypy
  is installed.

This ``__init__`` stays import-light on purpose: production modules import
:func:`graph_contract` from here at module import time.
"""
from .contracts import GRAPH_CONTRACTS, GraphContract, graph_contract
from .report import Finding, LintReport

__all__ = ["GRAPH_CONTRACTS", "GraphContract", "graph_contract", "Finding",
           "LintReport"]
