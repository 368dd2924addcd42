"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and limits, and a file for every configuration, cell, driver and
metric it names."""
import json
import re

import pytest
from perfbench_testkit import CELLS, ROOT, catalog  # noqa: F401

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and (ROOT / p).is_dir()
               for p in MANIFEST["paths"])
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


def test_run_seconds_fit_the_check():
    """A full check of 24 cells fits its 43,200 seconds."""
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_config(entry, catalog):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["why"])
    assert _line(entry["source"]) and entry["source"].startswith("https://")
    assert entry["file"].startswith("perfbench/configs/")
    cfg = catalog.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("entry", MANIFEST["workloads"],
                         ids=lambda e: e["name"])
def test_workload(entry, catalog):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    cell = catalog.cell(entry["name"])
    assert (ROOT / "perfbench" / "drivers" / f"{cell['driver']}.py").is_file()
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
    e2e = {m["name"] for m in catalog.metrics_of(entry["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert catalog.metrics_of(entry["name"], True)


def test_cells_are_listed():
    assert [w["name"] for w in MANIFEST["workloads"]] == list(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric, catalog):
    e2e = metric in MANIFEST["end_to_end"]
    keys = ({"name", "unit", "better", "bound", "source"} if e2e else
            {"name", "unit", "better", "source", "layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = metric.get("workloads", list(CELLS))
    assert set(cells) <= set(CELLS)
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
        for c in cells:  # each cell it lists reports what it moves
            assert metric["moves"] in {
                m["name"] for m in catalog.metrics_of(c, False)}
        if metric["name"].endswith("roofline"):
            assert metric["unit"] == "%"
    assert callable(catalog.reader(metric["name"]).read)


def test_setup_bound():
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


def test_layers_named_alike():
    """One layer, one name: a layer's metrics give it letter for letter."""
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(sum(m["layer"] == l for m in MANIFEST["per_layer"]) >= 1
               for l in layers)
    assert len({l.lower() for l in layers}) == len(layers)
