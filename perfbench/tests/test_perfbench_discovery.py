"""A cell, a configuration, a driver, a roofline and metrics placed as
files beside BENCHMARK.json entries are found and run without an edit
to any file the benchmark already has."""
import json
import time

import torch
from perfbench_testkit import ROOT

from perfbench.harness.catalog import Catalog
from perfbench.harness.main import run_cell

DRIVER = '''
import torch


class Driver:
    annotations = ()
    precision = "float32"
    failed = 0
    setup_log = ""

    def __init__(self, config, cell, seed, device, seconds):
        self.n, self.dev, self.work = 0, device, cell["units_a_step"]

    def setup(self):
        self.x = torch.ones(self.work, device=self.dev)

    def step(self):
        self.x = self.x * 1.0
        self.n += 1
        return self.n < 50

    def finish(self):
        return {"attempted": self.n, "latencies_ms": [], "phases_ms": {},
                "units": {"toy_units": self.n * self.work}}

    def release(self):
        self.x = None

    def check(self, variant=None):
        return {"toy_gap": 0.0}
'''


def _plant(tmp_path):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "toy", "source": "https://example.org/toy",
        "file": "perfbench/configs/toy.json", "reduced": [], "why": "a test"})
    manifest["workloads"].append({
        "name": "toy.cell", "config": "toy", "traffic": "toy-traffic",
        "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({
        "name": "toy_rate", "unit": "units/s", "better": "higher",
        "bound": 0.05, "source": "host_clock", "workloads": ["toy.cell"]})
    manifest["per_layer"].append({
        "name": "toy_share", "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "toy", "moves": "toy_rate",
        "workloads": ["toy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    base = tmp_path / "perfbench"
    for d in ("configs", "cells", "drivers", "metrics", "rooflines"):
        (base / d).mkdir(parents=True)
    (base / "configs" / "toy.json").write_text(
        json.dumps({"name": "toy", "reduced": [], "size": 3}))
    (base / "cells" / "toy.cell.json").write_text(json.dumps({
        "traffic": "toy-traffic", "driver": "toy", "units_a_step": 7,
        "trace_seconds": 0.05, "limits": {"toy_gap": 0.0}}))
    (base / "drivers" / "toy.py").write_text(DRIVER)
    (base / "rooflines" / "toy.py").write_text(
        "def counts(config, cell):\n"
        "    return {'bytes': config['size'] * 1e9, 'flops': 0}\n")
    (base / "metrics" / "toy_rate.py").write_text(
        "def read(obs):\n"
        "    return obs.units['toy_units'] / obs.window_s\n")
    (base / "metrics" / "toy_share.py").write_text(
        "from perfbench.harness.peaks import least_seconds\n\n\n"
        "def read(obs):\n"
        "    c = obs.catalog.roofline('toy').counts(obs.config, obs.cell)\n"
        "    return 100 * least_seconds(c) / obs.trace.window_s\n")
    for name in ("setup_s",):
        (base / "metrics" / f"{name}.py").write_text(
            (ROOT / "perfbench" / "metrics" / f"{name}.py").read_text())
    return Catalog(tmp_path)


def test_found_by_name(tmp_path):
    cat = _plant(tmp_path)
    assert cat.config("toy")["size"] == 3
    assert cat.cell("toy.cell")["driver"] == "toy"
    assert sorted(m["name"] for m in cat.metrics_of("toy.cell", False)) == [
        "setup_s", "toy_rate"]
    assert [m["name"] for m in cat.metrics_of("toy.cell", True)] == [
        "toy_share"]
    # the cells already there are untouched by the new entries
    assert "toy_rate" not in {m["name"] for m in cat.metrics_of(
        "dqn-cartpole.captured", False)}


def test_runs_without_edits(tmp_path):
    cat = _plant(tmp_path)
    cpu = torch.device("cpu")
    out = run_cell(cat, "toy.cell", 1, 0.05, False, cpu, time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"toy_rate", "setup_s"}
    traced = run_cell(cat, "toy.cell", 1, 0.05, True, cpu,
                      time.perf_counter())
    assert set(traced["metrics"]) == {"toy_share"}
    assert traced["metrics"]["toy_share"]["value"] > 0
