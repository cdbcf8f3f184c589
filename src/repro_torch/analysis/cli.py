"""``python -m repro_torch.analysis``: the port's analysis gate.

The port's counterpart of the JAX package's `analysis/cli.py`. Usage::

    python -m repro_torch.analysis src/repro_torch        # lint, exit 1 on findings
    python -m repro_torch.analysis src/repro_torch --kernel-contracts
                                              # + KC001/KC002/KC004/KC005
    python -m repro_torch.analysis --contract-report-out contracts.json
    python -m repro_torch.analysis --dead-code            # import-graph report
    python -m repro_torch.analysis --bytecode-guard       # no tracked .pyc
    python -m repro_torch.analysis --write-baseline
    python -m repro_torch.analysis --list-rules

The default path is ``src/repro_torch`` and the default baseline
``src/repro_torch/analysis/baseline.json`` (the JAX package's
``analysis-baseline.json`` is its own). Exit codes: 0 clean, 1 findings
(lint violations, kernel-contract errors, tracked bytecode), 2
configuration error (unreadable/unjustified baseline). Linting alone
imports no torch; the contract gate imports the launchers for their plan
functions but never initializes CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis import deadcode, lint, rules

DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"
DEFAULT_PATH = "src/repro_torch"


def bytecode_guard(root: str) -> List[str]:
    """Return tracked bytecode paths (``*.pyc`` / ``__pycache__``) — must be
    empty.  Folded in from the old inline CI step."""
    try:
        proc = subprocess.run(
            ["git", "ls-files", "--", "*.pyc", "**/__pycache__/**"],
            cwd=root,
            capture_output=True,
            text=True,
            timeout=30,
            check=False,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    if proc.returncode != 0:
        return []
    return [ln for ln in proc.stdout.splitlines() if ln.strip()]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="host-sync linter, quarantine gate, dead-code report, "
                    "CUDA kernel contracts",
    )
    parser.add_argument("paths", nargs="*", default=None, help=f"files/dirs to lint (default: {DEFAULT_PATH})")
    parser.add_argument("--root", default=".", help="repo root for relative paths and git")
    parser.add_argument("--baseline", default=None, help=f"baseline file (default: <root>/{DEFAULT_BASELINE})")
    parser.add_argument("--write-baseline", action="store_true", help="write current findings to the baseline and exit")
    parser.add_argument("--dead-code", action="store_true", help="print the import-graph dead-code report")
    parser.add_argument("--bytecode-guard", action="store_true", help="fail if compiled bytecode is tracked by git")
    parser.add_argument("--no-bytecode-guard", action="store_true", help="skip the bytecode guard during linting")
    parser.add_argument("--json", action="store_true", dest="as_json", help="machine-readable output")
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalog and exit")
    parser.add_argument("--kernel-contracts", action="store_true",
                        help="also run the KC001/KC002/KC004/KC005 "
                             "kernel-contract gate (registry coverage + "
                             "reference instantiations and plans)")
    parser.add_argument("--contract-report-out", default=None, metavar="PATH",
                        help="write the JSON contract report for the default "
                             "benchmark plans to PATH (implies "
                             "--kernel-contracts)")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid, title in sorted(rules.rule_catalog().items()):
            print(f"{rid}  {title}")
        return 0

    root = os.path.abspath(args.root)
    paths = list(args.paths) if args.paths else [os.path.join(root, DEFAULT_PATH)]

    if args.bytecode_guard and not (args.dead_code or args.write_baseline):
        tracked = bytecode_guard(root)
        # pure guard invocation: report and exit
        if not args.paths:
            if tracked:
                for p in tracked:
                    print(f"{p}: BC001 compiled bytecode tracked by git")
                return 1
            print("bytecode-guard: clean")
            return 0

    sources = lint.load_sources(paths, root)

    if args.dead_code:
        report = deadcode.dead_code_report(sources)
        if args.as_json:
            print(json.dumps(report.to_json(), indent=2))
        else:
            for section, mods in (
                ("bfs-core", report.bfs_core),
                ("shared", report.shared),
                ("template-only (quarantined)", report.template_only),
                ("unreachable from any entrypoint", report.unreachable),
            ):
                print(f"# {section}: {len(mods)}")
                for m in mods:
                    print(f"  {m}")
        return 0

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    try:
        baseline = lint.load_baseline(baseline_path)
    except (lint.BaselineError, ValueError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    result = lint.run_lint(
        paths,
        root=root,
        baseline=baseline,
        project_rules=[deadcode.QuarantineGate()],
    )

    if args.write_baseline:
        lint.save_baseline(baseline_path, result.findings, sources)
        print(
            f"wrote {len(result.findings)} entr{'y' if len(result.findings) == 1 else 'ies'} "
            f"to {baseline_path}; fill in every 'reason' before committing"
        )
        return 0

    tracked: List[str] = []
    if not args.no_bytecode_guard:
        tracked = bytecode_guard(root)

    kc_errors: List[lint.Finding] = []
    kc_warnings: List[lint.Finding] = []
    kc_reports: Optional[dict] = None
    if args.kernel_contracts or args.contract_report_out:
        # Lazy: the contract verifier imports the launchers (and torch);
        # plain lint runs must not pay for it.
        from repro_torch.analysis import kernel_contracts as kc
        kc_errors, kc_warnings = kc.run_gate(sources)
        if args.contract_report_out:
            kc_reports = kc.default_plan_reports()
            with open(args.contract_report_out, "w", encoding="utf-8") as fh:
                json.dump(kc_reports, fh, indent=2, sort_keys=True)
                fh.write("\n")

    if args.as_json:
        payload = {
            "findings": [f.to_json() for f in result.findings],
            "errors": [f.to_json() for f in result.errors],
            "suppressed": len(result.suppressed),
            "baselined": len(result.baselined),
            "tracked_bytecode": tracked,
        }
        if args.kernel_contracts or args.contract_report_out:
            payload["kernel_contracts"] = {
                "errors": [f.to_json() for f in kc_errors],
                "warnings": [f.to_json() for f in kc_warnings],
                "plans": kc_reports,
            }
        print(json.dumps(payload, indent=2))
    else:
        for f in result.errors + result.findings + kc_errors:
            print(f.format())
        for f in kc_warnings:
            print(f"{f.format()} [warning]")
        for p in tracked:
            print(f"{p}: BC001 compiled bytecode tracked by git")
        if kc_reports is not None:
            for name, rep in sorted(kc_reports.items()):
                verdict = "fits" if rep["feasible"] else "OVER BUDGET"
                print(f"contract-report {name}: {verdict} "
                      f"(peak {rep['peak_kernel_bytes']} B of "
                      f"{rep['budget_bytes']} B)")
            print(f"contract-report written to {args.contract_report_out}")
        n = (len(result.findings) + len(result.errors) + len(tracked)
             + len(kc_errors))
        status = "clean" if n == 0 else f"{n} problem(s)"
        print(
            f"analysis: {status} "
            f"({len(result.suppressed)} suppressed, {len(result.baselined)} baselined)"
        )
    return 0 if result.ok and not tracked and not kc_errors else 1


if __name__ == "__main__":
    sys.exit(main())
