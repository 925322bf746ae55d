"""CLI: ``python -m repro_torch.analysis [paths] [options]``.

Exit status 0 when every error-severity finding is covered by the baseline
(the checked-in baseline is empty — the repo is clean), 1 otherwise.  This
is the CI gate.

    python -m repro_torch.analysis src/repro_torch             # gate (default paths)
    python -m repro_torch.analysis --describe            # learned concurrency model
    python -m repro_torch.analysis --json findings.json  # machine-readable output
    python -m repro_torch.analysis --update-baseline     # re-grandfather findings
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.report import dump_baseline, load_baseline
from repro_torch.analysis.run import analyze_paths

_DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="concurrency & lifecycle verifier for the control plane")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to analyze (default: src/repro_torch)")
    ap.add_argument("--baseline", default=_DEFAULT_BASELINE,
                    help="baseline JSON of grandfathered findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: any error finding fails")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline with the current findings")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write all findings (and the model) to this file")
    ap.add_argument("--describe", action="store_true",
                    help="print the learned concurrency model and exit 0")
    args = ap.parse_args(argv)

    paths = args.paths or None
    if not paths:
        for cand in ("src/repro_torch", os.path.join(
                os.path.dirname(__file__), "..")):
            if os.path.isdir(cand):
                paths = [os.path.normpath(cand)]
                break
    report, model = analyze_paths(paths)

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"findings": [x.to_dict() for x in report.findings],
                       "model": model}, f, indent=2, sort_keys=True)
            f.write("\n")

    if args.describe:
        print(json.dumps(model, indent=2, sort_keys=True))
        return 0

    if args.update_baseline:
        dump_baseline(args.baseline, report.errors())
        print(f"baseline updated: {len(report.errors())} findings "
              f"-> {args.baseline}")
        return 0

    baseline = [] if args.no_baseline else load_baseline(args.baseline)
    new = report.new_findings(baseline)
    for f in report.findings:
        marker = "" if f in new or f.severity != "error" else " (baseline)"
        print(f.render() + marker)
    n_warn = len(report.findings) - len(report.errors())
    print(f"{len(report.errors())} error(s) "
          f"({len(new)} new, {len(report.errors()) - len(new)} baselined), "
          f"{n_warn} warning(s) over {len(paths or [])} path(s)")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
