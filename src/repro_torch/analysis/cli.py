"""``python -m repro_torch.analysis`` — the port's analysis gate.

Counterpart of ``repro/analysis/cli.py``.  Exit codes are the
reference's: 0 = clean (after noqa and baseline suppression), 1 =
findings, 2 = usage/configuration error (a layer that cannot run here,
such as the launch budget without CUDA, is one).

Typical invocations::

    python -m repro_torch.analysis src/repro_torch tests/test_torch_*.py \\
        examples/torch_*.py chip_smoke.py \\
        --baseline analysis-baseline-torch.json   # the gate
    python -m repro_torch.analysis src/repro_torch --no-trace  # AST only
    python -m repro_torch.analysis --write-baseline analysis-baseline-torch.json \\
        src/repro_torch ...                       # accept current findings
    python -m repro_torch.analysis --dead-modules     # unreferenced modules
    python -m repro_torch.analysis --lock-log run.jsonl  # offline lockdep
    python -m repro_torch.analysis --launch-budget    # on a card
    python -m repro_torch.analysis src/repro_torch --format prom  # dashboards

Source paths run the AST lint (:mod:`repro_torch.analysis.lint`) and,
without ``--no-trace``, the trace rules
(:mod:`repro_torch.analysis.trace_lint`: RECOMPILE, whose card half runs
where CUDA is and is reported as skipped elsewhere, and DTYPE-WIDE).
The reference's DONATED-USE rule has no torch meaning (no buffer
donation) and is not emitted.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

from repro_torch.analysis.findings import Baseline, Finding, findings_json

BENCH_REFUSED = (
    "--bench is not read: the port's launch budget is committed in "
    "repro_torch/analysis/launches.py (BUDGETS, kernel nodes of a CUDA "
    "graph, checked by --launch-budget), and BENCH_sampling.json's jaxpr "
    "dispatch counts are another quantity")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static and on-card analysis of the PyTorch port "
                    "(rules: PRNG-REUSE, WALL-CLOCK, HOST-SYNC, "
                    "TRACED-BRANCH, PARSE-ERROR, RECOMPILE, DTYPE-WIDE, "
                    "DISPATCH-BUDGET, LOCK-ORDER; the reference's "
                    "DONATED-USE has no torch meaning: PyTorch has no "
                    "buffer donation)")
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint (e.g. src/repro_torch "
                        "tests/test_torch_*.py)")
    p.add_argument("--baseline", metavar="JSON",
                   help="committed baseline of accepted findings to subtract")
    p.add_argument("--write-baseline", metavar="JSON",
                   help="write current findings as the new baseline and exit 0")
    p.add_argument("--out", metavar="JSON",
                   help="also write the machine-readable findings JSON here")
    p.add_argument("--format", choices=("text", "json", "prom"),
                   default="text", help="stdout format (default: text)")
    p.add_argument("--no-trace", action="store_true",
                   help="skip the trace rules (RECOMPILE, DTYPE-WIDE): AST "
                        "lint only")
    p.add_argument("--bench", metavar="JSON",
                   help="not read by the port (exits 2 with the reason)")
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
    return p


def _emit_prom(findings: list[Finding]) -> str:
    """Per-rule finding counts in the obs Prometheus text format, every
    rule of ``ALL_RULES`` at 0 when it has none (a stable series set)."""
    from repro_torch.analysis import ALL_RULES
    from repro_torch.obs.exporters import prometheus_text
    from repro_torch.obs.metrics import Registry

    reg = Registry(enabled=True)
    counts = Counter(f.rule for f in findings)
    for rule in sorted(set(ALL_RULES) | set(counts)):
        c = reg.counter(
            "analysis.findings." + rule.lower().replace("-", "_"),
            help=f"non-suppressed {rule} findings in the last analysis run")
        for _ in range(counts.get(rule, 0)):
            c.add()
    return prometheus_text(reg)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.bench:
        print(f"error: {BENCH_REFUSED}", file=sys.stderr)
        return 2

    if args.dead_modules:
        from repro_torch.analysis.deadcode import (dead_module_report,
                                                   render_report)

        src = Path(__file__).resolve().parents[2]  # .../src
        report = dead_module_report(str(src), repo_root=str(src.parent))
        print(json.dumps(report, indent=1) if args.format == "json"
              else render_report(report))
        return 0

    if not (args.paths or args.lock_log or args.launch_budget):
        print("error: nothing to check (give source paths, --lock-log, "
              "--launch-budget or --dead-modules)", file=sys.stderr)
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
    if args.paths:
        from repro_torch.analysis.lint import run_lint

        findings.extend(run_lint(args.paths))
        if not args.no_trace:
            from repro_torch.analysis.trace_lint import run_trace_checks

            exempt, recapture = {}, {}
            findings.extend(run_trace_checks(exempt, recapture))
            extra["xla_float_f64_outputs"] = exempt
            extra["recompile_card"] = recapture
    if args.launch_budget:
        from repro_torch.analysis.launches import check_launch_budget

        got, counts, skipped = check_launch_budget()
        if skipped is not None:
            print(f"error: launch budget skipped: {skipped}",
                  file=sys.stderr)
            return 2
        findings.extend(got)
        extra["launch_counts"] = counts

    if args.write_baseline:
        Baseline.from_findings(findings).save(args.write_baseline)
        print(f"wrote baseline with {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

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
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")

    if args.format == "json":
        print(json.dumps(payload, indent=1))
    elif args.format == "prom":
        sys.stdout.write(_emit_prom(findings))
    else:
        for f in findings:
            print(f.render())
        if "recompile_card" in extra:
            card = extra["recompile_card"]
            print("RECOMPILE card half: " + (
                f"skipped ({card['skipped']})" if "skipped" in card
                else "; ".join(f"{k}: {v}" for k, v in card.items())))
        if "launch_counts" in extra:
            print("kernel launches: " + ", ".join(
                f"{k} {v['nodes']['kernel']}"
                for k, v in extra["launch_counts"].items()))
        print(f"{len(findings)} finding(s), {suppressed} baselined")
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
