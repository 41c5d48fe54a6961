"""CLI: ``python -m repro_torch.analysis.lint src/repro_torch [--format json]
[--baseline lint_baseline_torch.json]``.

Exit codes: 0 clean (or within baseline), 1 findings over baseline,
2 bad usage.  ``--write-baseline`` regenerates the baseline from the
current findings -- use it once after fixing a rule's sites, then commit
the shrunken file (the baseline may shrink, never grow).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.lint import (RULES, baseline_diff, load_baseline,
                                 run_lint, write_baseline)
from repro_torch.analysis.lint.findings import counts_by_code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="step-hazard linter, page-ledger protocol checker, and "
                    "op-registry contract checker (the PyTorch port)")
    ap.add_argument("paths", nargs="+",
                    help="files or directories of .py files to lint")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", metavar="FILE",
                    help="accepted per-rule finding counts; fail only on "
                         "counts above the baseline")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write current per-rule counts to FILE and exit 0")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip pass 3 (keeps the run purely static; no "
                         "repro_torch.ops import needed)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, (title, hint) in sorted(RULES.items()):
            print(f"{code}  {title}\n       {hint}")
        return 0

    findings = run_lint(args.paths,
                        include_contracts=not args.no_contracts)
    counts = counts_by_code(findings)

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"wrote baseline ({sum(counts.values())} finding(s), "
              f"{len(counts)} rule(s)) to {args.write_baseline}")
        return 0

    regressions, ratchet_room = {}, {}
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"error: cannot read baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        regressions, ratchet_room = baseline_diff(findings, baseline)
        failing = bool(regressions)
    else:
        failing = bool(findings)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.as_dict() for f in findings],
            "counts": counts,
            "regressions": regressions,
            "ratchet_room": ratchet_room,
            "ok": not failing,
        }, indent=2, sort_keys=True))
        return 1 if failing else 0

    for f in findings:
        print(f.render())
    n = len(findings)
    print(f"\n{n} finding(s) across {len(counts)} rule(s)"
          + (f" (baseline: {args.baseline})" if args.baseline else ""))
    if regressions:
        for code, over in sorted(regressions.items()):
            print(f"  REGRESSION {code}: {over} new finding(s) over "
                  f"baseline")
    if ratchet_room:
        room = ", ".join(f"{c}-{n}" for c, n in sorted(ratchet_room.items()))
        print(f"  ratchet room (shrink the baseline): {room}")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
