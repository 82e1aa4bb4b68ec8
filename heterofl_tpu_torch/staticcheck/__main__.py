"""``python -m heterofl_tpu_torch.staticcheck [--json] [--out PATH]
[--device cpu|cuda] [--flagship] [--diff-baseline | --update-baseline]
[--lint-only]``.

Runs the lint of the package's source (pure AST, about a second), then the
runtime audit of the round programs on ``--device`` (:mod:`.audit`; the
CPU at test widths by default, the headline's full widths with
``--flagship``).  Exits 0 when both are clean, 1 on any finding, 2 when
``--diff-baseline`` finds a regression against the device's section of
``baseline.json``; ``--update-baseline`` re-pins that section from a
green audit.  The report is written only where ``--out`` says.
``--device cuda`` without a CUDA device raises, as the entries do.
"""

from __future__ import annotations

import argparse
import sys
from datetime import datetime, timezone


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m heterofl_tpu_torch.staticcheck",
                                     description="the port's lint and runtime audit")
    parser.add_argument("--json", action="store_true",
                        help="print the whole report as JSON (default: the findings and "
                             "one summary line)")
    parser.add_argument("--out", default=None, help="write the JSON report here")
    parser.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    parser.add_argument("--flagship", action="store_true",
                        help="audit at the headline's full ResNet-18 widths (FLOP-share "
                             "tolerance 2%%)")
    ratchet = parser.add_mutually_exclusive_group()
    ratchet.add_argument("--diff-baseline", action="store_true",
                         help="diff the audit against the device's baseline section; "
                              "exit 2 on a regression")
    ratchet.add_argument("--update-baseline", action="store_true",
                         help="re-pin the device's baseline section from this (green) audit")
    parser.add_argument("--lint-only", action="store_true",
                        help="the lint alone (no device, no audit)")
    parser.add_argument("--baseline", default=None, help="baseline path (default: the "
                        "package's staticcheck/baseline.json)")
    args = parser.parse_args(argv)
    if args.lint_only and (args.diff_baseline or args.update_baseline):
        parser.error("--diff-baseline/--update-baseline need the audit (drop --lint-only)")

    from .report import AuditReport
    from .rules import lint_package

    report = AuditReport()
    baseline_path = args.baseline
    if not args.lint_only:
        from .audit import run_audit
        from .ratchet import BASELINE_PATH, load_baseline

        baseline_path = baseline_path or BASELINE_PATH
        try:
            section = load_baseline(baseline_path, args.device)
        except (OSError, ValueError):
            section = None
        report = run_audit(args.device, flagship=args.flagship,
                           budget=None if args.update_baseline else section)
    report.add_lint(lint_package())
    report.generated_at = datetime.now(timezone.utc).isoformat()
    report.config["argv"] = list(sys.argv[1:] if argv is None else argv)

    if args.diff_baseline:
        from .ratchet import diff_reports

        if section is None:
            report.ratchet = {"checked": True, "ok": False, "regressions": [{
                "program": "<baseline>", "metric": "load", "baseline": None,
                "current": None, "tolerance": 0.0,
                "message": f"{baseline_path} has no {args.device!r} section: run "
                           f"--update-baseline on a green tree and commit the file"}]}
        else:
            report.ratchet = diff_reports(report.to_dict(), section)
    if args.update_baseline:
        from .ratchet import write_baseline

        if report.ok:
            write_baseline(report.to_dict(), args.device, baseline_path)
        else:
            print("staticcheck: refusing to pin a baseline from a failing audit",
                  file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report.to_json() + "\n")

    regressed = bool(report.ratchet.get("checked") and not report.ratchet.get("ok"))
    if args.json:
        print(report.to_json())
    else:
        for f in report.all_findings():
            print(f)
        for reg in report.ratchet.get("regressions", []):
            print(f"{reg['program']}: [ratchet:{reg['metric']}] {reg['baseline']} -> "
                  f"{reg['current']}: {reg['message']}")
        verdict = "OK" if report.ok else "FAILED"
        if report.ok and regressed:
            verdict = "RATCHET REGRESSED"
        print(f"staticcheck: {verdict} -- {len(report.programs)} programs audited on "
              f"{args.device}, {len(report.all_findings())} finding(s), "
              f"{len(report.ratchet.get('regressions', []))} ratchet regression(s)")
    if not report.ok:
        return 1
    return 2 if regressed else 0


if __name__ == "__main__":
    sys.exit(main())
