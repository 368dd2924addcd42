"""Readings that set a cell's limits: the program's, the control's and
the planted faults', seed by seed, in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--variants control,half,altered]

For each seed: the cell's set-up and a window of ``--seconds`` as a run
makes them, then the check of what the program produced (the lower
reading) and of each variant put in the program's place: ``control``
(the reference in the nearest precision below the configuration's) and,
for the trainer's cell, the faults ``half`` (the mean over half of each
batch), ``altered`` (one drawn row changed) and ``env_altered`` (one
stored reward changed).  One JSON line a seed.
The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench.harness.catalog import Catalog  # noqa: E402
from perfbench.harness.window import run_window, sync  # noqa: E402


def readings(catalog: Catalog, name: str, seed: int, seconds: float,
             variants: list[str], device: torch.device) -> dict:
    wl = catalog.workload(name)
    cell = catalog.cell(name)
    drv = catalog.driver(cell["driver"]).Driver(
        catalog.config(wl["config"]), cell, seed, device, seconds)
    drv.setup()
    sync(device)
    run_window(drv, device, seconds, False)
    done = drv.finish()
    drv.release()
    out = {"seed": seed, "attempted": done["attempted"],
           "program": drv.check()}
    for v in variants:
        out[v] = drv.check(v)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variants", default="control")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    catalog = Catalog(ROOT)
    variants = [v for v in args.variants.split(",") if v]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(catalog, args.workload, seed, args.seconds, variants,
                     torch.device("cuda", 0))
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
