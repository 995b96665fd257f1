"""``python -m repro_torch.analysis`` — run the port's analysis suite.

Exit status is nonzero iff any finding survives (or ``--device cuda``
finds no card), so the module doubles as a gate.  ``--json``
additionally writes ``ANALYSIS_report.json`` (findings plus per-rule
proof-obligation counts).
"""
from __future__ import annotations

import argparse
import sys

from .report import Report

PASSES = ("contracts", "hazards", "kernels", "lint")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Plan/kernel contract auditor + the port's lint")
    ap.add_argument("--json", nargs="?", const="ANALYSIS_report.json",
                    metavar="PATH", default=None,
                    help="write a machine-readable report "
                         "(default: ANALYSIS_report.json)")
    ap.add_argument("--only", choices=PASSES, action="append",
                    help="run a subset of passes (repeatable)")
    ap.add_argument("--selftest", action="store_true",
                    help="also run the seeded-violation self-test "
                         "(every planted bug must be flagged)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernel audit runs the wrappers: cuda "
                         "launches the CUDA kernels, cpu their plain "
                         "versions (default: cuda)")
    args = ap.parse_args(argv)
    passes = tuple(args.only) if args.only else PASSES
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("analysis: --device cuda needs a CUDA device (use "
                  "--device cpu for the plain versions)", file=sys.stderr)
            return 2

    rep = Report()
    if "contracts" in passes:
        from .contracts import run_contracts
        run_contracts(report=rep)
    if "hazards" in passes:
        from .hazards import run_hazards
        run_hazards(report=rep)
    if "kernels" in passes:
        from .kernel_audit import run_kernel_audit
        run_kernel_audit(report=rep, device=args.device)
    if "lint" in passes:
        from .lint import run_lint
        run_lint(report=rep)
    if args.selftest:
        from .selftest import run_selftest
        run_selftest(report=rep)

    print(rep.summary())
    if args.json:
        path = rep.write_json(args.json)
        print(f"report written to {path}")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
