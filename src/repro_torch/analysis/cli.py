"""``python -m repro_torch.analysis`` — the port's analysis gate.

Counterpart of ``repro/analysis/cli.py`` for the layers the port has.
Exit codes are the reference's: 0 = clean (after baseline
suppression), 1 = findings, 2 = usage/configuration error (a layer that
cannot run here, such as the launch budget without CUDA, is one).

Typical invocations::

    python -m repro_torch.analysis --dead-modules     # unreferenced modules
    python -m repro_torch.analysis --lock-log run.jsonl  # offline lockdep
    python -m repro_torch.analysis --launch-budget    # on a card
    python -m repro_torch.analysis --lock-log run.jsonl --format json

The reference's AST lint (source paths) and its other trace rules
(RECOMPILE, DTYPE-WIDE) have no port yet (ROADMAP item A16): their
flags exit 2 saying so.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.findings import Baseline, Finding, findings_json

UNPORTED = ("the reference's AST lint and its RECOMPILE / DTYPE-WIDE "
            "trace rules are not ported to repro_torch yet (ROADMAP A16)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static and on-card analysis of the PyTorch port")
    p.add_argument("paths", nargs="*",
                   help="source paths for the AST lint (not ported: exits 2)")
    p.add_argument("--baseline", metavar="JSON",
                   help="committed baseline of accepted findings to subtract")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="stdout format (default: text)")
    p.add_argument("--dead-modules", action="store_true",
                   help="print the unreferenced-module report of "
                        "repro_torch and exit (report only, never fails)")
    p.add_argument("--lock-log", metavar="JSONL",
                   help="offline lockdep: check a recorded acquisition log "
                        "for lock-order cycles")
    p.add_argument("--launch-budget", action="store_true",
                   help="count the kernel launches of one fused draw and "
                        "one captured agent step on the card against the "
                        "committed budget (needs CUDA)")
    # the reference's trace-layer flags: refused, naming the item
    p.add_argument("--no-trace", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--bench", help=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.paths or args.no_trace or args.bench:
        print(f"error: {UNPORTED}", file=sys.stderr)
        return 2

    if args.dead_modules:
        from repro_torch.analysis.deadcode import (dead_module_report,
                                                   render_report)

        src = Path(__file__).resolve().parents[2]  # .../src
        report = dead_module_report(str(src), repo_root=str(src.parent))
        print(json.dumps(report, indent=1) if args.format == "json"
              else render_report(report))
        return 0

    if not (args.lock_log or args.launch_budget):
        print("error: nothing to check (give --lock-log, --launch-budget "
              "or --dead-modules)", file=sys.stderr)
        return 2

    findings: list[Finding] = []
    extra: dict = {}
    if args.lock_log:
        from repro_torch.analysis.locks import check_log

        try:
            findings.extend(check_log(args.lock_log))
        except OSError as e:
            print(f"error: cannot read lock log: {e}", file=sys.stderr)
            return 2
    if args.launch_budget:
        from repro_torch.analysis.launches import check_launch_budget

        got, counts, skipped = check_launch_budget()
        if skipped is not None:
            print(f"error: launch budget skipped: {skipped}",
                  file=sys.stderr)
            return 2
        findings.extend(got)
        extra["launch_counts"] = counts

    suppressed = 0
    if args.baseline:
        try:
            bl = Baseline.load(args.baseline)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: cannot load baseline: {e}", file=sys.stderr)
            return 2
        kept = bl.filter(findings)
        suppressed = len(findings) - len(kept)
        findings = kept

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    payload = {**findings_json(findings, suppressed=suppressed), **extra}
    if args.format == "json":
        print(json.dumps(payload, indent=1))
    else:
        for f in findings:
            print(f.render())
        if "launch_counts" in extra:
            print("kernel launches: " + ", ".join(
                f"{k} {v['nodes']['kernel']}"
                for k, v in extra["launch_counts"].items()))
        print(f"{len(findings)} finding(s), {suppressed} baselined")
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
