"""``python -m repro_torch.obs.report <metrics.jsonl>`` — run summary.

Renders the last snapshot of a JSONL metrics log as a table (plus the
event timeline with ``--events``): the quick "how healthy was this
run" view without loading anything heavier than the log itself.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.exporters import read_jsonl


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render(records: list[dict], show_events: bool = False) -> str:
    snapshots = [r for r in records if r.get("kind") == "snapshot"]
    events = [r for r in records if r.get("kind") == "event"]
    lines: list[str] = []
    if not snapshots and not events:
        return "empty metrics log\n"
    if snapshots:
        last = snapshots[-1]
        lines.append(f"snapshots: {len(snapshots)}   "
                     f"last ts: {last.get('ts', '?')}")
        lines.append("")
        metrics = last.get("metrics", {})
        width = max((len(k) for k in metrics), default=10)
        for name in sorted(metrics):
            v = metrics[name]
            if isinstance(v, dict):
                body = "  ".join(f"{k}={_fmt_val(x)}"
                                 for k, x in v.items() if x is not None)
            else:
                body = _fmt_val(v)
            lines.append(f"  {name:<{width}}  {body}")
    if events:
        lines.append("")
        lines.append(f"events: {len(events)}")
        if show_events:
            for e in events:
                fields = {k: v for k, v in e.items()
                          if k not in ("kind", "schema", "ts", "event")}
                body = "  ".join(f"{k}={_fmt_val(v)}"
                                 for k, v in fields.items())
                lines.append(f"  [{e.get('ts', 0):.3f}] "
                             f"{e.get('event', '?')}  {body}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarise a JSONL metrics log (either package's).")
    ap.add_argument("path", help="metrics JSONL file")
    ap.add_argument("--events", action="store_true",
                    help="also print the event timeline")
    args = ap.parse_args(argv)
    try:
        records = read_jsonl(args.path)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(render(records, show_events=args.events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
