"""graphlint CLI on the port: ``python -m edgellm_tpu_torch.lint`` (the
reference's ``python -m edgellm_tpu.lint``, the same flags, plus
``--device``).

Exit 0 when every layer is clean, 1 when any finding survives. ``--json``
writes the merged machine-readable report (the CI artifact), ``--sarif`` the
same as SARIF 2.1.0.

The graph and lattice layers execute the port's entry points: on the card
(``--device cuda``, the default, as the CLI's) unless ``--device cpu``.
``--device cuda`` without a card is an error, not a CPU run. The AST and
thread layers only parse source.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m edgellm_tpu_torch.lint",
        description="graphlint on the port: AST rules (EG005, EG007), "
                    "thread/lock-discipline rules (EG1xx), executed graph "
                    "contracts and the config lattice. The reference's "
                    "EG001-EG004 and EG006 concern tracing under jax.jit "
                    "and have no counterpart in eager torch")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the merged JSON report here")
    ap.add_argument("--sarif", metavar="PATH", default=None,
                    help="also write the report as SARIF 2.1.0 (all layers)")
    ap.add_argument("--ast-only", action="store_true",
                    help="run only the AST rule layer (parses source, runs "
                         "nothing)")
    ap.add_argument("--graph-only", action="store_true",
                    help="run only the graph-contract layer")
    ap.add_argument("--thread-only", action="store_true",
                    help="run only the thread/lock-discipline layer "
                         "(EG1xx; parses source, runs nothing)")
    ap.add_argument("--lattice-only", action="store_true",
                    help="run only the config-lattice verifier (latticelint:"
                         " each config's entry points run once, in-place "
                         "caches, budget + pairwise compat)")
    ap.add_argument("--matrix", metavar="PATH", default=None,
                    help="where the lattice layer writes the capability "
                         "matrix (capability_matrix.json)")
    ap.add_argument("--no-mypy", action="store_true",
                    help="skip the scoped mypy --strict layer")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="list every '# graphlint: disable=' marker with "
                         "file:line (audit trail for silenced findings)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the graph and lattice layers run on "
                         "(default: cuda; --device cpu without a card)")
    ap.add_argument("paths", nargs="*",
                    help="AST/thread-lint these files instead of the package "
                         "(graph layer always targets the real package)")
    args = ap.parse_args(argv)
    only_flags = [args.ast_only, args.graph_only, args.thread_only,
                  args.lattice_only]
    if sum(only_flags) > 1:
        ap.error("--ast-only, --graph-only, --thread-only and "
                 "--lattice-only are mutually exclusive")
    if args.lattice_only and args.paths:
        ap.error("--lattice-only lints configs/, not source paths")

    from .report import LintReport, merge, to_sarif

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = os.path.dirname(pkg_root)
    runs_graph = not (args.ast_only or args.thread_only or args.lattice_only)
    runs_lattice = not (args.ast_only or args.thread_only or args.graph_only
                        or args.paths)
    if runs_graph or runs_lattice:
        from .entrypoints import check_device

        check_device(args.device)  # before any layer spends time
    findings_by_layer = []
    checked: list = []
    skipped: list = []
    details: dict = {}

    if not (args.graph_only or args.thread_only or args.lattice_only):
        from .ast_rules import iter_package_files, lint_paths

        targets = args.paths or list(iter_package_files(pkg_root))
        findings_by_layer.append(lint_paths(targets))

        if not args.no_mypy and not args.paths:
            from .typecheck import run_typecheck

            ty_findings, ty_skips = run_typecheck(repo_root)
            findings_by_layer.append(ty_findings)
            skipped.extend(ty_skips)

    if not (args.ast_only or args.graph_only or args.lattice_only):
        from .threadlint import lint_files as thread_lint_files
        from .threadlint import lint_package as thread_lint_package

        if args.paths:
            findings_by_layer.append(thread_lint_files(args.paths))
        else:
            findings_by_layer.append(thread_lint_package(pkg_root))

    if runs_graph:
        from .entrypoints import run_graph_checks

        g_findings, g_checked, g_skips, g_details = run_graph_checks(args.device)
        findings_by_layer.append(g_findings)
        checked.extend(g_checked)
        skipped.extend(g_skips)
        details["contracts"] = g_details

    if runs_lattice:
        from .lattice import run_lattice_checks, write_matrix

        l_findings, l_checked, l_skips, matrix = run_lattice_checks(
            device=args.device)
        findings_by_layer.append(l_findings)
        checked.extend(l_checked)
        skipped.extend(l_skips)
        details["budget"] = {name: {"port_bytes": row.get("peak_bytes"),
                                    "aot_peak_bytes": row.get("budget_bytes")}
                             for name, row in matrix["configs"].items()
                             if row.get("budget_bytes") is not None}
        if args.matrix:
            write_matrix(matrix, args.matrix)

    if (runs_graph or runs_lattice) and args.device.startswith("cuda"):
        from .contracts import kernel_launches

        # every kernel this process launched: the contracts', the lattice's
        # and its footprint readings' (the card's launch counters)
        details["launches_total"] = {k: n for k, n in kernel_launches().items() if n}

    if args.show_suppressed:
        from .ast_rules import collect_suppressions, iter_package_files

        sup_targets = args.paths or list(iter_package_files(pkg_root))
        marks = collect_suppressions(sup_targets)
        print(f"suppressions: {len(marks)} marker(s)")
        for path, line, rules in marks:
            what = "all rules" if rules is None else ",".join(sorted(rules))
            print(f"  {path}:{line}: disable={what}")

    report = LintReport(findings=merge(*findings_by_layer),
                        checked_contracts=checked, skipped=skipped,
                        details=details)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            f.write(report.to_json() + "\n")
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as f:
            f.write(to_sarif(report) + "\n")
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
