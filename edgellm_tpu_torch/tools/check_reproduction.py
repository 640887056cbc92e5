"""North-star checker: compare a sweep result against the reference anchors
(PyTorch port's copy of ``edgellm_tpu/tools/check_reproduction.py``: the
same anchors, rows and exit codes).

``python -m edgellm_tpu_torch.tools.check_reproduction out_sweep/avg_ppl_results.json``
prints one row per golden cell (got / want / delta / verdict) and exits 0 only
when every STABLE anchor matches within ±0.1 PPL — the BASELINE.md north star
— so the REPRODUCING.md §3 validation is a single command the day real
checkpoints and the WikiText-2 test tokens appear.

Expected values are the reference's own numbers, derived from the NLL dumps in
the reference's ``Notebooks/qwen2-0.5B_experiment.ipynb`` cell 12 (1,000
chunks — run the sweep with ``--max-chunks 1000``; see BASELINE.md for the
derivation). Collapse cells (quantization destroyed the model; the reference
records 2.1e3-9.8e6) are checked to a factor of 2 — their exact values are
noise amplification, but the collapse itself must reproduce.
"""
from __future__ import annotations

import json
import sys

#: (method, split layer, ratio, expected PPL, kind); kind "abs" = ±0.1 PPL,
#: "collapse" = within 2x (the cell's defining property is the blow-up).
#: ratio-0.0 cells are the fp baseline: method-independent by construction.
GOLDEN = [
    ("last_row", 3, 0.0, 13.31, "abs"),
    ("last_row", 3, 0.25, 13.40, "abs"),
    ("last_row", 3, 0.5, 13.71, "abs"),
    ("last_row", 3, 0.75, 14.80, "abs"),
    ("last_row", 11, 0.25, 13.41, "abs"),
    ("last_row", 11, 0.5, 13.73, "abs"),
    ("last_row", 11, 0.75, 14.58, "abs"),
    ("last_row", 22, 0.25, 16.33, "abs"),
    ("last_row", 22, 0.5, 24.63, "abs"),
    ("last_row", 22, 0.75, 48.18, "abs"),
    ("regular_importance", 3, 0.25, 14.06, "abs"),
    ("regular_importance", 3, 0.5, 15.01, "abs"),
    ("regular_importance", 3, 0.75, 16.82, "abs"),
    ("regular_importance", 18, 0.25, 24.52, "abs"),
    ("regular_importance", 18, 0.5, 36.76, "abs"),
    ("regular_importance", 18, 0.75, 50.60, "abs"),
    ("regular_importance", 23, 0.25, 2141.0, "collapse"),
    ("last_row", 18, 1.0, 9.8e6, "collapse"),
    ("last_row", 3, 1.0, 8.7e6, "collapse"),
    ("last_row", 11, 1.0, 304e3, "collapse"),
]

ABS_TOL = 0.1  # the BASELINE.md north star
COLLAPSE_FACTOR = 2.0


def check(result: dict, golden=None) -> tuple:
    """-> (rows, n_failed). ``result`` is a SweepResult.to_json() dict; golden
    cells whose (method, layer, ratio) the sweep didn't run are skipped."""
    golden = GOLDEN if golden is None else golden
    axes, ppl = result["axes"], result["ppl"]
    # channel sweeps have no ratio axis, initial sweeps no method axis; their
    # results share the avg_ppl_results.json filename, so fall through to the
    # "no golden cells" guidance instead of a KeyError
    methods = axes.get("methods") or []
    layers = [int(l) for l in axes.get("layers_of_interest", [])
              if not isinstance(l, str)]  # initial sweeps mix in magic strings
    ratios = [float(r) for r in axes.get("ratios", [])]
    rows, failed = [], 0
    for method, layer, ratio, want, kind in golden:
        if method not in methods or layer not in layers or ratio not in ratios:
            continue
        got = float(ppl[methods.index(method)][layers.index(layer)]
                    [ratios.index(ratio)])
        if kind == "abs":
            ok = abs(got - want) <= ABS_TOL
        else:
            ok = want / COLLAPSE_FACTOR <= got <= want * COLLAPSE_FACTOR
        failed += not ok
        rows.append({"method": method, "layer": layer, "ratio": ratio,
                     "got": got, "want": want, "kind": kind, "ok": bool(ok)})
    return rows, failed


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        return 2
    with open(argv[0]) as f:
        result = json.load(f)
    rows, failed = check(result)
    if not rows:
        print("no golden cells match this sweep's axes — run "
              "configs/qwen_baseline_table.json (layers [22, 18, 3, 23, 11], "
              "ratios [0, 0.25, 0.5, 0.75, 1])")
        return 2
    for r in rows:
        mark = "ok  " if r["ok"] else "FAIL"
        tol = f"±{ABS_TOL}" if r["kind"] == "abs" else f"x{COLLAPSE_FACTOR}"
        print(f"{mark} {r['method']:<20} layer {r['layer']:>2} "
              f"r={r['ratio']:<4} got {r['got']:<12.4g} "
              f"want {r['want']:<10.4g} ({tol})")
    print(f"{len(rows) - failed}/{len(rows)} anchors reproduced"
          + ("" if not failed else f"; {failed} FAILED"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
