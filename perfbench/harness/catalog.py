"""Find the benchmark's parts by name.

``BENCHMARK.json`` at the root of a checkout names the cells, the
configurations and the metrics.  Everything that belongs to one of them
is a file of its own, so a later change adds a cell, a configuration or
a metric by adding files and entries, never by editing one:

* ``perfbench/configs/<config>.json``: a configuration's sizes, its
  ``source``, what was ``assumed`` and what was ``reduced``;
* ``perfbench/cells/<cell>.json``: a cell's traffic, which names its
  ``driver``;
* ``perfbench/drivers/<driver>.py``: the program's entry that one kind
  of traffic drives, and the check against the plain reference: a class
  ``Driver(config, cell, seed, device, seconds)`` with ``setup()`` (all
  that precedes the window, warm-up included), ``step()`` (issue one
  unit of work without synchronising; False when there is no more),
  ``finish()`` (``attempted``, ``units``, ``latencies_ms``,
  ``phases_ms``), ``release()`` (drop the program's state, keep what it
  produced) and ``check(variant=None)`` (each number compared), and the
  attributes ``annotations``, ``precision``, ``failed``, ``setup_log``;
* ``perfbench/metrics/<metric>.py``: one metric's reader, ``read(obs)``;
* ``perfbench/rooflines/<name>.py``: the least bytes and operations of a
  kernel or a path, ``counts(config, cell)``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType


def _load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as a module named ``name`` (a name may hold
    dots, so it is not imported by package path)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    key = f"perfbench_part.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


class Catalog:
    """The benchmark of the checkout at ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.base = self.root / "perfbench"
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, kind: str, name: str) -> dict:
        for e in self.manifest[kind]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {kind[:-1]} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        """The configuration's file, as a dict."""
        entry = self._entry("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def cell(self, name: str) -> dict:
        """The cell's traffic file, as a dict."""
        traffic = json.loads((self.base / "cells" / f"{name}.json")
                             .read_text())
        want = self.workload(name)["traffic"]
        if traffic.get("traffic") != want:
            raise ValueError(f"cells/{name}.json describes traffic "
                             f"{traffic.get('traffic')!r}, BENCHMARK.json "
                             f"says {want!r}")
        return traffic

    def driver(self, name: str) -> ModuleType:
        return _load_module(self.base / "drivers" / f"{name}.py",
                            f"drivers.{name}")

    def reader(self, metric: str) -> ModuleType:
        return _load_module(self.base / "metrics" / f"{metric}.py",
                            f"metrics.{metric}")

    def roofline(self, name: str) -> ModuleType:
        return _load_module(self.base / "rooflines" / f"{name}.py",
                            f"rooflines.{name}")

    def metrics_of(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics,
        or with a trace its per-layer ones (by their ``workloads`` key,
        else by the end-to-end metric they move)."""
        e2e = [m for m in self.manifest["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.manifest["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
