"""Shared finding type and report serialization for every lint layer (the
reference's ``edgellm_tpu/lint/report.py``, the same JSON and SARIF layout).

Every rule (AST, thread, graph contract, lattice or typecheck) reports the
same flat :class:`Finding` record, so the CLI merges the layers into one
JSON report and one exit code, and CI can archive a single artifact.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation.

    layer: "ast" | "thread" | "graph" | "lattice" | "typecheck".
    rule: stable rule id (``EG00x`` for AST rules, ``EG1xx`` for thread
        rules, ``GC-*`` for graph contracts, ``LL-*`` for the config
        lattice, ``MYPY`` for the typechecker).
    where: file path (AST/thread/typecheck), contract name (graph layer)
        or config path (lattice).
    line: 1-based source line, or 0 when the finding has no source anchor
        (graph contracts point at an executed call, not a line).
    message: human-readable description of the violation.
    """

    layer: str
    rule: str
    where: str
    line: int
    message: str

    def format(self) -> str:
        anchor = f"{self.where}:{self.line}" if self.line else self.where
        return f"[{self.rule}] {anchor}: {self.message}"


@dataclasses.dataclass
class LintReport:
    """The merged result of every layer the CLI ran."""

    findings: list  # list[Finding]
    checked_contracts: list  # contract names that were verified clean
    skipped: list  # layer-level skips, e.g. "typecheck: mypy not installed"
    #: what the executing layers read (per contract: hops, bytes, launches
    #: beside the declared ones, the host-sync verdict; per config: the
    #: measured footprint beside its budget); written under "details" when
    #: present, so the reference's keys keep their layout
    details: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> str:
        doc = {
            "ok": self.ok,
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "checked_contracts": list(self.checked_contracts),
            "skipped": list(self.skipped),
        }
        if self.details:
            doc["details"] = self.details
        return json.dumps(doc, indent=2, sort_keys=True)

    def summary(self) -> str:
        lines = [f.format() for f in self.findings]
        lines.append(
            f"graphlint: {len(self.findings)} violation(s), "
            f"{len(self.checked_contracts)} graph contract(s) clean"
            + (f", skipped: {'; '.join(self.skipped)}" if self.skipped else ""))
        return "\n".join(lines)


#: SARIF severity per layer — everything graphlint emits is a build-breaker
_SARIF_LEVEL = "error"


def to_sarif(report: "LintReport") -> str:
    """Render the merged report as SARIF 2.1.0 (one run, driver=graphlint).

    Covers every layer: AST rules, thread rules, graph contracts and the
    scoped typechecker all share the flat :class:`Finding` shape, so each
    becomes one SARIF ``result``. Findings with ``line == 0`` (graph
    contracts anchor to executed calls, not source lines) omit the
    ``region`` block but keep the artifact URI.
    """
    rule_ids = sorted({f.rule for f in report.findings})
    results = []
    for f in report.findings:
        loc: dict = {
            "physicalLocation": {
                "artifactLocation": {"uri": f.where},
            },
        }
        if f.line:
            loc["physicalLocation"]["region"] = {"startLine": f.line}
        results.append({
            "ruleId": f.rule,
            "level": _SARIF_LEVEL,
            "message": {"text": f.message},
            "locations": [loc],
            "properties": {"layer": f.layer},
        })
    doc = {
        "$schema": ("https://json.schemastore.org/sarif-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "graphlint",
                    "rules": [{"id": rid} for rid in rule_ids],
                },
            },
            "results": results,
            "properties": {
                "checked_contracts": list(report.checked_contracts),
                "skipped": list(report.skipped),
            },
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True)


def sort_findings(findings: list) -> list:
    return sorted(findings, key=lambda f: (f.layer, f.where, f.line, f.rule))


def merge(*finding_lists: list) -> list:
    out: list = []
    for fl in finding_lists:
        out.extend(fl)
    return sort_findings(out)


def load_report(path: str) -> Optional[dict]:
    """Parse a previously-written JSON report (CI tooling convenience)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
