"""Run one cell and print its result.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout.  The run:

1. refuses (exit 2, no result) without as many CUDA devices as the cell
   asks for, and (exit 3) where the program's package is missing;
2. builds the cell's driver and warms up (``setup_s``: process start to
   the first timed operation);
3. times the window (``harness.window``), under torch.profiler with
   ``--trace 1``;
4. reads the peak of device memory, refuses (exit 4, no result) if JAX,
   its libraries or the JAX package were loaded, frees the program's
   state and holds what the timed path produced against the plain
   reference, each number against the cell's limit for it;
5. prints the checks as the last lines of standard error, and as the
   last line of standard output one JSON object: ``correct``,
   ``attempted``, ``failed``, the cell's end-to-end metrics (or, traced,
   its per-layer ones), ``device``, with a trace ``breakdown``, and last
   ``checks``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import warnings
from pathlib import Path

import torch

from perfbench.harness.catalog import Catalog
from perfbench.harness.window import Observation, run_window, sync

BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(names=None) -> list[str]:
    """Top-level names of loaded modules (``names``, else
    ``sys.modules``) that the run may not hold, compared whole
    (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


class Refused(Exception):
    """A run that may print no result; ``code`` is its exit code."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def run_cell(catalog: Catalog, name: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t_start: float,
             config: dict | None = None, cell: dict | None = None) -> dict:
    """One run of cell ``name``; ``config`` and ``cell`` stand in for the
    files (the tests' small sizes)."""
    wl = catalog.workload(name)
    config = config if config is not None else catalog.config(wl["config"])
    cell = cell if cell is not None else catalog.cell(name)
    drv = catalog.driver(cell["driver"]).Driver(config, cell, seed, device,
                                                seconds)
    drv.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    length = min(seconds, cell["trace_seconds"]) if traced else seconds
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        window_s, issue, trace = run_window(drv, device, length, traced)
    done = drv.finish()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    drv.release()
    values = drv.check()
    limits = cell["limits"]
    if set(values) != set(limits):
        raise ValueError(f"checks {sorted(values)} but limits for "
                         f"{sorted(limits)}")
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    obs = Observation(config=config, cell=cell, catalog=catalog,
                      setup_s=setup_s, window_s=window_s,
                      units=done["units"], latencies_ms=done["latencies_ms"],
                      phases_ms=done["phases_ms"],
                      host_issue_s=issue, precision=drv.precision,
                      trace=trace)
    metrics = {}
    for m in catalog.metrics_of(name, traced):
        v = catalog.reader(m["name"]).read(obs)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return {"correct": correct, "attempted": done["attempted"],
            "setup_log": str(drv.setup_log),
            "failed": drv.failed, "metrics": metrics,
            "memory_peak_bytes": peak, "trace": trace, "checks": checks}


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    try:
        if not (root / "src" / "repro_torch").is_dir():
            raise Refused(3, "the program (src/repro_torch) is not in this "
                          "checkout")
        catalog = Catalog(root)
        chips = catalog.workload(args.workload)["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(2, f"cell {args.workload} needs {chips} CUDA "
                          f"device(s), found "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        out = run_cell(catalog, args.workload, args.seed, args.seconds,
                       bool(args.trace), device, t_start)
        found = banned_modules()
        if found:
            raise Refused(4, f"loaded in the measuring process: {found}")
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr, flush=True)
        return e.code
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": dev}
    if out["trace"] is not None:
        dev.update(busy_s=out["trace"].busy_s,
                   window_s=out["trace"].window_s)
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = out["checks"]
    print(json.dumps(result), flush=True)
    print(f"set-up {out['metrics'].get('setup_s', {}).get('value', '')}: "
          f"{out['setup_log']}", file=sys.stderr, flush=True)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    return 0
